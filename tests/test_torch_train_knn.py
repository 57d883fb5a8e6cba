"""One training step of ed3dgs_torch at the nersemble config's reg_coef = 1
(the KNN embedding regulariser on, kernels K6/K7 in their plain versions)
against ed3dgs_tpu's `make_train_step`, both on the CPU.

Each package builds its own graph cache with its own `update_knn_cache`
from the same cloud; the test first holds the two caches together (the
alive rows' neighbour sets, the Morton order, the drops and which edges
keep a weight, exactly; the weights exp(-2000 d2) at rtol 1e-6, since the
two packages' exp differ in the last bit), then the step at
tests/test_torch_train.py's bounds: loss and every metric (emb_loss
included) at rtol 1e-5, every gradient leaf and the screen-space gradient
vs_grad at 1e-5 of the leaf's largest value, the aux update with integers
and counts exactly and the accumulated norm of vs_grad at rtol 1e-5 or
vs_grad's bound (1e-5 of its largest value: the per-Gaussian norm of a
gradient held at that bound; with the tongue terms' larger gradients a
Gaussian at a quarter of the largest value is 1.6e-5 apart).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.ops.knn import knn as jknn
from ed3dgs_tpu.train import trainer as jtrainer

from ed3dgs_torch.ops.knn import far_shell
from ed3dgs_torch.ops.knn import knn as tknn
from ed3dgs_torch.train import trainer

from test_torch_train import (CAP, ITERATION, REL, assert_grads_match, batch_np, cameras,
                              jax_problem, jax_step, torch_batch, torch_side)


def rank_weights(jgraph, K):
    """The JAX graph's effective weights in rank order [Cp, K]."""
    Cp = jgraph.pi.shape[0]
    na = Cp // 256
    K1p = jgraph.aux_a.shape[0] // na
    return np.asarray(jgraph.aux_a).reshape(na, K1p, 256).transpose(0, 2, 1).reshape(
        Cp, K1p)[:, 1:K + 1]


def assert_caches_agree(jcache, tcache, jparams, taux, tongue_enabled):
    """The alive rows' neighbour sets, then the prepared graphs, exactly."""
    xyz = torch.as_tensor(np.asarray(jparams.xyz))
    tongue = torch.round(taux.tongue_class[:, 0]) > 0.5
    shell = far_shell(CAP, "cpu")
    masks = [(taux.alive & ~tongue, shell, jcache.graph, tcache.graph)]
    if tongue_enabled:
        masks.append((taux.alive & tongue, -shell, jcache.t_graph, tcache.t_graph))
    for mask, sh, jg, tg in masks:
        assert int(mask.sum()) > trainer.KNN_K
        pts = torch.where(mask[:, None], xyz, sh)
        _, jidx = jknn(jnp.asarray(pts.numpy()), k=trainer.KNN_K)
        _, tidx = tknn(pts, k=trainer.KNN_K)
        m = mask.numpy()
        assert [set(r) for r in np.asarray(jidx)[m]] == [set(r) for r in tidx.numpy()[m]]
        np.testing.assert_array_equal(tg.pi.numpy(), np.asarray(jg.pi))
        np.testing.assert_array_equal(tg.overflow.numpy(), np.asarray(jg.overflow))
        assert int(tg.n_far) == int(jg.n_far)
        jw = rank_weights(jg, trainer.KNN_K)
        np.testing.assert_array_equal(tg.w.numpy() > 0, jw > 0)
        np.testing.assert_allclose(tg.w.numpy(), jw, rtol=1e-6, atol=0)
        assert float(tg.w.max()) > 0


def run_steps(monkeypatch, jit=False, **over):
    """One step in each package on tests/test_torch_train.py's problem with
    the TrainSetup overrides `over` (`jit`: the JAX step compiled); returns
    both packages' results."""
    tongue = over.get("tongue_enabled", False)
    fields, jstate, jaux = jax_problem()
    batch = batch_np(cameras(), tongue=tongue)
    jcache = jtrainer.update_knn_cache(jstate.params["gaussians"], jaux, tongue_enabled=tongue)
    jout = jax_step(jstate, jaux, batch, monkeypatch, knn=jcache, jit=jit, **over)
    tstate, taux, setup, optimizer = torch_side(fields, jstate, **over)
    tcache = trainer.update_knn_cache(tstate.params["gaussians"], taux, tongue_enabled=tongue)
    assert_caches_agree(jcache, tcache, jstate.params["gaussians"], taux, tongue)
    tout = trainer.make_loss_and_grads(setup)(tstate.params, taux, torch_batch(batch), tcache,
                                              ITERATION)
    tstep = trainer.make_train_step(setup, optimizer)(tstate, taux, torch_batch(batch), tcache)
    return jout, tout, tstep


def check_metrics(jmetrics, metrics, step_metrics, loss):
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(v), rtol=REL, atol=1e-7,
                                   err_msg=k)
        np.testing.assert_array_equal(step_metrics[k].numpy(), metrics[k].numpy())
    assert float(loss) == float(metrics["loss"])


def check_aux(jaux, taux):
    for name in jaux._fields:
        a, b = np.asarray(getattr(jaux, name)), getattr(taux, name).numpy()
        if a.dtype.kind in "bi" or name in ("denom", "max_radii2d"):
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:   # the accumulated norm of vs_grad: vs_grad's bound
            np.testing.assert_allclose(b, a, rtol=REL, atol=REL * np.abs(a).max(),
                                       err_msg=name)


@pytest.fixture(scope="module")
def knn_steps():
    mp = pytest.MonkeyPatch()
    try:
        return run_steps(mp, reg_coef=1.0)
    finally:
        mp.undo()


def test_knn_step_loss_and_metrics_match_jax(knn_steps):
    (_, _, jmetrics, _, _), (loss, metrics, *_), (_, _, step_metrics) = knn_steps
    check_metrics(jmetrics, metrics, step_metrics, loss)
    assert float(metrics["emb_loss"]) > 0


def test_knn_step_gradients_match_jax(knn_steps):
    (_, _, _, jgrads, jvs), (_, _, tgrads, tvs, *_), _ = knn_steps
    assert_grads_match(jgrads, tgrads)
    assert np.abs(tvs.numpy() - jvs).max() <= REL * np.abs(jvs).max()
    assert np.abs(jgrads["gaussians/embedding"]).max() > 0


def test_knn_step_aux_update_matches_jax(knn_steps):
    (_, jaux, _, _, _), _, (tstate, taux, _) = knn_steps
    check_aux(jaux, taux)
    assert tstate.iteration == ITERATION + 1
