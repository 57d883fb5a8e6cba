"""Densification (clone and split) of ed3dgs_torch against ed3dgs_tpu's, both
on the CPU, with the JAX package's random draws handed to the port: JAX's
`densify(key)` splits the key into (ka, kb) and draws child A's and child
B's offsets as normal(ka/kb, (C, 3)); the test draws the same two arrays and
passes them as `noise`, so the only difference between the packages is
where the noise comes from.

Bounds: alive mask, reset mask, tongue class, the clone and split counts
and the zeroed statistics exactly; parameters at rtol 1e-5 (the children's
rotated offsets are summed in another order); through `make_densify_step`,
the Adam moments exactly (they are zeroed or carried, not computed).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.config.params import OptimizationConfig as JOpt
from ed3dgs_tpu.data.scene import flatten_pytree
from ed3dgs_tpu.models import gaussians as jgm
from ed3dgs_tpu.tools.train import save_checkpoint
from ed3dgs_tpu.train import densify as jdensify
from ed3dgs_tpu.train import trainer as jtrainer

from ed3dgs_torch import convert
from ed3dgs_torch.config.params import OptimizationConfig
from ed3dgs_torch.models import gaussians as tgm
from ed3dgs_torch.train import densify as tdensify
from ed3dgs_torch.train import optim, trainer

from test_torch_train_state import jax_state_one_update_on

REL = 1e-5


def jax_noise(key, C):
    ka, kb = jax.random.split(key)
    return np.stack([np.asarray(jax.random.normal(ka, (C, 3))),
                     np.asarray(jax.random.normal(kb, (C, 3)))])


def hot_cloud(C=256, n=150, seed=0):
    """A cloud whose screen-space statistics make ~half its alive Gaussians
    hot, with small (clone) and large (split) scales mixed."""
    rng = np.random.default_rng(seed)
    alive = np.zeros(C, bool)
    alive[rng.permutation(C)[:n]] = True             # free slots scattered
    f = {
        "xyz": rng.uniform(-1, 1, (C, 3)), "features_dc": rng.normal(size=(C, 1, 3)),
        "features_rest": rng.normal(size=(C, 15, 3)),
        "scaling": rng.normal(-3.0, 0.6, (C, 3)), "rotation": rng.normal(size=(C, 4)),
        "opacity": rng.normal(size=(C, 1)), "embedding": rng.normal(size=(C, 32)),
        "alive": alive, "tongue_class": (rng.uniform(size=(C, 1)) > 0.7),
        "filter_3d": rng.uniform(1e-3, 1e-2, (C, 1)),
        "max_radii2d": rng.integers(0, 9, C),
        "xyz_grad_accum": rng.uniform(0, 1e-3, C) * alive,
        "denom": rng.integers(0, 4, C) * alive,
    }
    f = {k: np.asarray(v, bool if k == "alive" else np.float32) for k, v in f.items()}
    jp = jgm.GaussianParams(**{k: jnp.asarray(f[k]) for k in jgm.GaussianParams._fields})
    ja = jgm.GaussianAux(**{k: jnp.asarray(f[k]) for k in jgm.GaussianAux._fields})
    tp, ta = tgm.from_numpy(f, device="cpu")
    return (jp, ja), (tp, ta)


def assert_params_match(tparams, jparams):
    for name in jparams._fields:
        np.testing.assert_allclose(getattr(tparams, name).numpy(),
                                   np.asarray(getattr(jparams, name)),
                                   rtol=REL, atol=1e-7, err_msg=name)


def assert_aux_match(taux, jaux):
    for name in jaux._fields:
        np.testing.assert_array_equal(getattr(taux, name).numpy(),
                                      np.asarray(getattr(jaux, name)), err_msg=name)


@pytest.mark.parametrize("max_gaussians,splits_capped", [(200, True), (256, False)])
def test_densify_matches_jax(max_gaussians, splits_capped):
    (jp, ja), (tp, ta) = hot_cloud()
    kw = dict(grad_threshold=2e-4, percent_dense=0.01, scene_extent=5.0,
              max_gaussians=max_gaussians)
    key = jax.random.PRNGKey(7)
    want = jdensify.densify(jp, ja, key, **kw)
    got = tdensify.densify(tp, ta, noise=torch.as_tensor(jax_noise(key, 256)), **kw)
    n_clone, n_split = int(want.n_cloned), int(want.n_split)
    assert (int(got.n_cloned), int(got.n_split)) == (n_clone, n_split)
    assert n_clone > 0 and n_split > 0
    # the budget caps the splits: fewer than the hot, large Gaussians
    grads = np.where(np.asarray(ja.denom) > 0,
                     np.asarray(ja.xyz_grad_accum) / np.maximum(np.asarray(ja.denom), 1), 0)
    n_large = int(((grads >= 2e-4) & np.asarray(ja.alive)
                   & (np.exp(np.asarray(jp.scaling)).max(1) > 0.05)).sum())
    assert (n_split < n_large) == splits_capped
    np.testing.assert_array_equal(got.reset_mask.numpy(), np.asarray(want.reset_mask))
    assert_aux_match(got.aux, want.aux)
    assert_params_match(got.params, want.params)
    assert int(got.aux.alive.sum()) == int(ja.alive.sum()) + n_clone + n_split


def test_densify_draws_from_the_generator():
    """Without `noise` the children's offsets come from the generator: the
    same seed gives the same cloud, another seed another one."""
    _, (tp, ta) = hot_cloud(seed=1)
    kw = dict(grad_threshold=2e-4, percent_dense=0.01, scene_extent=5.0, max_gaussians=256)
    a, b, c = (tdensify.densify(tp, ta, torch.Generator().manual_seed(s), **kw)
               for s in (3, 3, 4))
    assert int(a.n_split) > 0
    assert torch.equal(a.params.xyz, b.params.xyz)
    assert not torch.equal(a.params.xyz, c.params.xyz)


@pytest.fixture(scope="module")
def one_update(tmp_path_factory):
    """JAX's state one update into training, and the port's copy of it
    (carried across by a JAX checkpoint)."""
    _, s1, a1 = jax_state_one_update_on()
    it = int(s1.iteration)
    path = tmp_path_factory.mktemp("densify_step")
    save_checkpoint(str(path), it, s1, a1)
    tstate, taux = convert.load_checkpoint(str(path / f"chkpnt{it}.npz"), device="cpu")
    return s1, a1, tstate, taux


def _densify_step_against_jax(one_update, graph):
    s1, a1, tstate, taux = one_update
    it = int(s1.iteration)
    jopt, opt = JOpt(max_number_gaussians=230), OptimizationConfig(max_number_gaussians=230)
    key = jax.random.PRNGKey(3)
    thr = 4e-4
    js, ja, jn_c, jn_s = jtrainer.make_densify_step(jopt, 0.01, 5.0)(s1, a1, key, thr)
    ts, ta, tn_c, tn_s = trainer.make_densify_step(opt, 0.01, 5.0, graph=graph)(
        tstate, taux, None, thr, noise=torch.as_tensor(jax_noise(key, taux.alive.shape[0])))
    assert (int(tn_c), int(tn_s)) == (int(jn_c), int(jn_s))
    assert int(tn_c) > 0 and int(tn_s) > 0
    assert_aux_match(ta, ja)
    assert_params_match(ts.params["gaussians"], js.params["gaussians"])
    assert ts.iteration == it
    jflat = flatten_pytree(js.opt_state)
    zeroed = 0
    for g, st in ts.opt_state.items():
        prefix = f"inner_states/{g}/inner_state/0/"
        assert st.count == int(jflat[prefix + "count"])
        for part in ("mu", "nu"):
            for k, v in getattr(st, part).items():
                want = jflat[f"{prefix}{part}/{k}"]
                np.testing.assert_array_equal(v.numpy(), want, err_msg=f"{g} {part} {k}")
                before = getattr(tstate.opt_state[g], part)[k]
                zeroed += int(((before != 0) & (v == 0)).sum())
    assert zeroed > 0
    # the deformation network is untouched
    for k, v in optim.flatten_params(ts.params["deform"]).items():
        np.testing.assert_array_equal(v.numpy(), flatten_pytree(js.params["deform"])[k])


def test_make_densify_step_matches_jax(one_update):
    """Through the densify step of both trainers (the port's default, the
    graphed step's path, run eagerly on the CPU), from the same state one
    update into training: parameters, aux, the counts, and every Adam
    moment (zeroed at the touched slots)."""
    _densify_step_against_jax(one_update, graph=True)


def test_eager_densify_step_matches_jax(one_update):
    """The same through the eager densify step (graph=False)."""
    _densify_step_against_jax(one_update, graph=False)


def _step_tensors(state, aux, n_c, n_s) -> dict:
    out = {f"params/{k}": v for k, v in optim.flatten_params(state.params).items()}
    for g, st in state.opt_state.items():
        out.update({f"mu/{g}/{k}": v for k, v in st.mu.items()})
        out.update({f"nu/{g}/{k}": v for k, v in st.nu.items()})
        out[f"count/{g}"] = torch.tensor(st.count)
    out.update({f"aux/{k}": v for k, v in aux._asdict().items()})
    out.update(n_cloned=n_c, n_split=n_s, iteration=torch.tensor(state.iteration))
    return {k: v.clone() for k, v in out.items()}


def test_graphed_densify_equals_the_eager_step(one_update):
    """The graphed densify step (its static buffers, the threshold read
    from the device, the noise drawn from the caller's generator before the
    step) equals the eager one bit for bit over two calls with different
    thresholds, each path with a generator of the same seed; fresh
    densification statistics come in between, as training steps would
    leave them. The returned tensors are the static buffers: the second
    call writes into the first call's results."""
    _, _, tstate, taux = one_update
    opt = OptimizationConfig(max_number_gaussians=256)
    eager = trainer.make_densify_step(opt, 0.01, 5.0, graph=False)
    graphed = trainer.make_densify_step(opt, 0.01, 5.0)
    assert isinstance(graphed, trainer.GraphedDensifyStep)
    rng = np.random.default_rng(4)
    accum = torch.as_tensor(rng.uniform(0, 1e-3, taux.alive.shape[0]).astype(np.float32))
    gens = [torch.Generator().manual_seed(11) for _ in range(2)]
    e, g = (tstate, taux), (tstate, taux)
    for call, thr in enumerate((8e-4, 3e-4)):
        es, ea, en_c, en_s = eager(e[0], e[1], gens[0], thr)
        gs, ga, gn_c, gn_s = graphed(g[0], g[1], gens[1], thr)
        want, got = _step_tensors(es, ea, en_c, en_s), _step_tensors(gs, ga, gn_c, gn_s)
        assert int(want["n_cloned"]) > 0 and int(want["n_split"]) > 0, call
        differ = [k for k in want if not torch.equal(want[k], got[k])]
        assert not differ, (call, differ[:8])
        if call == 0:
            assert ga.alive.data_ptr() == graphed.static["aux"].alive.data_ptr()
        # the statistics a few steps would leave on the densified cloud
        e = (es, ea._replace(xyz_grad_accum=accum * ea.alive, denom=ea.alive.to(torch.float32)))
        g = (gs, ga._replace(xyz_grad_accum=accum * ga.alive, denom=ga.alive.to(torch.float32)))
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
