"""COLMAP point-cloud supervision in ed3dgs_torch against ed3dgs_tpu, both on
the CPU: `colmap_pcd_loss` on its own against the JAX loss jitted as the
JAX trainer runs it (its value and its gradient, including the even split
of a tie between two Gaussians at the same position, which `torch.amin`
gives as `jnp.min` does), and one training
step with `colmap_supervision` on against JAX `make_train_step` (jitted, as
the JAX trainer runs it) on tests/test_torch_train.py's problem with a GT
cloud sampled near the Gaussians.

Bounds: the loss on its own at rtol 1e-5, and its gradient no further from
the float64 gradient than twice the JAX package's own distance from it
(both form it as the difference of two ~4e6 mm^2 float32 terms; ties
split exactly evenly in both); the step at
tests/test_torch_train.py's bounds (loss and every metric, pcd_loss
included, at rtol 1e-5; every gradient leaf and vs_grad at 1e-5 of the
leaf's largest value)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ed3dgs_tpu.train.losses import colmap_pcd_loss as j_pcd_loss

from ed3dgs_torch.train import trainer
from ed3dgs_torch.train.losses import colmap_pcd_loss

from test_torch_train import (ITERATION, N, REL, assert_grads_match, batch_np, cameras,
                              jax_problem, jax_step, torch_batch, torch_cache, torch_side)
from test_torch_train_knn import check_aux, check_metrics
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

DEFORM_FROM = 5000          # < ITERATION: the term is live


def exact_gradient(p, g, alive):
    """d(colmap_pcd_loss)/d(positions) in float64 from the float32 inputs:
    each point's nearest alive Gaussians (ties split evenly), 1/2 where the
    distance is exactly 0 (the max(d, 0) tie), 2000^2/1000 (g - p) / P."""
    pm, gm = p.astype(np.float64) * 1000, g.astype(np.float64) * 1000
    d2 = ((pm[:, None, :] - gm[None, :, :]) ** 2).sum(-1)
    d2[:, ~alive] = np.inf
    dmin = d2.min(1)
    near = d2 == dmin[:, None]
    w = near / near.sum(1, keepdims=True) * np.where(dmin > 0, 1.0, 0.5)[:, None] / len(p)
    return 1000 * 2 * (w.sum(0)[:, None] * gm - w.T @ pm)


@pytest.mark.parametrize("P,chunk", [(600, 500), (512, 128)])
def test_pcd_loss_and_gradient_match_jax(P, chunk):
    """P not a multiple of the chunk (600 in chunks of gcd 100) and one that
    is; dead slots excluded; Gaussians 0 and 1 at the same position."""
    rng = np.random.default_rng(P)
    C = 160
    g = rng.normal(0, 0.3, (C, 3)).astype(np.float32) + np.float32([0, 0, 2])
    g[1] = g[0]
    p = (g[rng.integers(0, 120, P)] + rng.normal(0, 0.01, (P, 3))).astype(np.float32)
    p[:20] = g[0]                                    # points exactly at the tied pair
    alive = np.arange(C) < 120
    # jitted, as the JAX trainer's step evaluates it (XLA fuses the squared
    # norms into multiply-add chains there; op by op it sums them plainly)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda x: j_pcd_loss(jnp.asarray(p), x, jnp.asarray(alive), chunk=chunk)))(
            jnp.asarray(g))
    tg = torch.as_tensor(g).requires_grad_(True)
    tl = colmap_pcd_loss(torch.as_tensor(p), tg, torch.as_tensor(alive), chunk=chunk)
    (grad,) = torch.autograd.grad(tl, tg)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=REL)
    # The gradient of a Gaussian is 2000 (g - p) / P summed over its nearest
    # points, formed in float32 as the difference of two ~4e6 mm^2 terms
    # (|g|^2 and 2 p.g): both packages carry a rounding error of ~1e-5 of
    # its largest value there, in different places. Each is held to the
    # float64 gradient: the port's error at most twice the JAX package's.
    jg = np.asarray(jg)
    want = exact_gradient(p, g, alive)
    err_port, err_jax = np.abs(grad.numpy() - want).max(), np.abs(jg - want).max()
    assert err_port <= 2 * err_jax, (err_port, err_jax)
    assert err_jax <= 1e-4 * np.abs(want).max()
    assert float(grad[120:].abs().max()) == 0.0            # dead slots get nothing
    np.testing.assert_array_equal(grad[0].numpy(), grad[1].numpy())   # the tie, split evenly
    np.testing.assert_array_equal(jg[0], jg[1])


def pcd_batch():
    """tests/test_torch_train.py's batch plus a GT cloud of 600 points (not a
    multiple of the 500-point chunk) within ~1 cm of the alive Gaussians."""
    fields, _, _ = jax_problem()
    rng = np.random.default_rng(8)
    pts = fields["xyz"][rng.integers(0, N, 600)] + rng.normal(0, 0.01, (600, 3))
    return {**batch_np(cameras()), "pcd_points": pts.astype(np.float32), "pcd_valid": True}


@pytest.fixture(scope="module")
def pcd_steps():
    mp = pytest.MonkeyPatch()
    over = dict(colmap_supervision=True, deform_from_iter=DEFORM_FROM)
    try:
        fields, jstate, jaux = jax_problem()
        batch = pcd_batch()
        jout = jax_step(jstate, jaux, batch, mp, jit=True, **over)
    finally:
        mp.undo()
    tstate, taux, setup, optimizer = torch_side(fields, jstate, **over)
    cache = torch_cache(tstate, taux, setup)
    tout = trainer.make_loss_and_grads(setup)(tstate.params, taux, torch_batch(batch), cache,
                                              ITERATION)
    tstep = trainer.make_train_step(setup, optimizer)(tstate, taux, torch_batch(batch), cache)
    return jout, tout, tstep, (tstate, taux, setup, cache, batch)


def test_pcd_step_loss_and_metrics_match_jax(pcd_steps):
    (_, _, jmetrics, _, _), (loss, metrics, *_), (_, _, step_metrics), _ = pcd_steps
    check_metrics(jmetrics, metrics, step_metrics, loss)
    assert float(metrics["pcd_loss"]) > 0


def test_pcd_step_gradients_match_jax(pcd_steps):
    (_, _, _, jgrads, jvs), (_, _, tgrads, tvs, *_), _, _ = pcd_steps
    assert_grads_match(jgrads, tgrads)
    assert np.abs(tvs.numpy() - jvs).max() <= REL * np.abs(jvs).max()


def test_pcd_step_aux_update_matches_jax(pcd_steps):
    (_, jaux, _, _, _), _, (tstate, taux, _), _ = pcd_steps
    check_aux(jaux, taux)
    assert tstate.iteration == ITERATION + 1


def test_pcd_term_is_gated(pcd_steps):
    """No GT cloud for the frame (pcd_valid False), or the iteration not
    past deform_from_iter: the term is 0 and the loss is the one without."""
    _, (loss, metrics, *_), _, (tstate, taux, setup, cache, batch) = pcd_steps
    fn = trainer.make_loss_and_grads(setup)
    without = trainer.make_loss_and_grads(dataclasses.replace(setup, colmap_supervision=False))
    want = without(tstate.params, taux, torch_batch(batch), cache, ITERATION)[0]
    assert float(metrics["pcd_loss"]) > 0 and float(loss) != float(want)
    off = fn(tstate.params, taux, torch_batch({**batch, "pcd_valid": False}), cache, ITERATION)
    early = fn(tstate.params, taux, torch_batch(batch), cache, DEFORM_FROM)
    for out in (off, early):
        assert float(out[1]["pcd_loss"]) == 0.0
    assert float(off[0]) == float(want)
