"""The port's sharded step with the tongue and COLMAP terms on, on four gloo
ranks of the CPU at data=2 x gauss=2, against the JAX package's
`make_sharded_train_step` with the same terms on the same mesh (the 8
virtual devices of tests/conftest.py), from the same state: the problem of
tests/test_torch_parallel_step.py with every term live (SSIM, temporal TV,
depth-normal, COLMAP and the tongue terms, whose sub-renders of the last
camera run on the last data row; `torch_parallel_ranks.full_problem`).

Bounds: tests/test_torch_parallel_step.py `_hold` (loss rel 2e-4, PSNR rel
2e-3, xyz atol 5e-5, the deformation `weight` atol 5e-6, `denom` atol
1e-6), and rel 2e-4 on each term.

The graphed sharded step's path (run eagerly on the CPU) must equal the
eager one (graph=False) bit for bit, with the same collectives, across
tools.train's densify event on the mesh (the whole cloud gathered, a
densify that gives tongue children, the KNN cache rebuilt, so that the
tongue graph's in-edge count changes) and across both COLMAP keys. Under
the strip exchange, each tongue sub-render's send demand must be no larger
than the main render's for the same camera: the step drops the
sub-renders' demand (as the JAX step does), which is safe only so. One
world runs every case; it must finish within 120 s.
"""

from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ed3dgs_tpu.parallel import make_mesh
from ed3dgs_tpu.parallel.sharded import (make_sharded_train_step, shard_batch,
                                         shard_knn_cache, shard_train_state)
from ed3dgs_tpu.train.trainer import make_train_step, update_knn_cache

from ed3dgs_torch.parallel.multihost import spawn_world
import torch_parallel_ranks as ranks
from test_torch_parallel_step import _hold, _jax_problem

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

TERMS = ("ssim", "tv_loss", "depth_normal", "pcd_loss", "emb_loss", "opacity_mean",
         "tongue_l1", "tongue_emb", "tongue_rgb", "wo_tongue_rgb")


def _jax_full_step(state, aux, setup, opt_cfg, optimizer, batch, port):
    """JAX's sharded step at data=2 x gauss=2 on the every-term problem."""
    ex = ranks.full_extras(port)
    full = replace(setup, tongue_enabled=True, colmap_supervision=True, lambda_dssim=0.2,
                   coef_tv_temporal=0.01, radegs_from_iter=0)
    aux_f = aux._replace(tongue_class=jnp.asarray(ex["tongue_class"]))
    batch_f = dict(batch, use_ssim=jnp.asarray(True), pcd_valid=jnp.asarray(True),
                   tongue_gt=jnp.asarray(ex["tongue_gt"]),
                   pcd_points=jnp.asarray(ex["pcd_points"]))
    state_f = state._replace(iteration=jnp.asarray(ranks.FULL_ITERATION,
                                                   jnp.asarray(state.iteration).dtype))
    cache = jax.jit(update_knn_cache, static_argnums=(2,))(state.params["gaussians"], aux_f,
                                                           True)
    mesh = make_mesh(data=2, gauss=2)
    raw = make_train_step(full, opt_cfg, optimizer, jit=False)
    st_s, ax_s = shard_train_state(mesh, state_f, aux_f)
    step = make_sharded_train_step(raw, mesh, state_f, aux_f, batch_f, cache)
    s, a, m = step(st_s, ax_s, shard_batch(mesh, batch_f), shard_knn_cache(mesh, cache))
    return {"xyz": np.asarray(s.params["gaussians"].xyz),
            "weight": np.asarray(s.params["deform"]["weight"]),
            "denom": np.asarray(a.denom), "loss": float(m["loss"]), "psnr": float(m["psnr"]),
            "terms": {k: float(m[k]) for k in TERMS}}


@pytest.fixture(scope="module")
def results():
    state, aux, setup, opt_cfg, optimizer, batch, port = _jax_problem()
    # the ranks run while JAX builds its KNN cache and compiles its step
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn_world, ranks.parallel_tongue_rank, 4, args=(port,),
                            deadline_s=120)
        jax_full = _jax_full_step(state, aux, setup, opt_cfg, optimizer, batch, port)
        return world.result(), jax_full


@pytest.mark.parametrize("comms", ["gspmd", "strip"])
def test_tongue_and_colmap_sharded_step_matches_jax(results, comms):
    """Every rank's gathered state after one step with every term live, and
    each term, against JAX's sharded step with the same terms."""
    world, jax_full = results
    for term in ("pcd_loss", "tongue_l1", "tongue_emb", "tongue_rgb", "wo_tongue_rgb"):
        assert jax_full["terms"][term] > 0, term
    for rank, res in enumerate(world):
        got = res[f"full_{comms}"]
        _hold(got, jax_full, f"rank {rank} {comms} vs JAX's sharded step, every term")
        for k in TERMS:
            assert got["terms"][k] == pytest.approx(jax_full["terms"][k], rel=2e-4), (rank, k)


@pytest.mark.parametrize("comms", ["gspmd", "strip"])
def test_graphed_tongue_step_equals_eager_across_a_refresh(results, comms):
    """The graphed path against graph=False over 2 steps, tools.train's
    densify and KNN refresh on the mesh (the tongue graph's in-edges
    change), and 2 steps with pcd_valid on, then off: every tensor bit for
    bit, the densify's too, and the same collectives a step."""
    world, _ = results
    for rank, res in enumerate(world):
        assert res[f"graph_differ_{comms}"] == [[]] * 5, (rank, comms)
        eager, graphed = res[f"graph_ledgers_{comms}"]
        assert graphed == eager, (rank, comms)
        assert all(len(step) > 0 for step in graphed), (rank, comms)
        refresh = res[f"refresh_{comms}"]
        assert refresh["born_tongue"] > 0, (rank, comms, refresh)
        before, after = refresh["in_edges"]
        assert before != after, (rank, comms, refresh)
        metrics = res[f"graph_metrics_{comms}"]
        for m in metrics:
            for k in ("tongue_l1", "tongue_emb", "tongue_rgb", "wo_tongue_rgb"):
                assert m[k] > 0, (rank, comms, k)
        assert [m["pcd_loss"] > 0 for m in metrics] == [True, True, True, False], (rank, comms)
    assert len({tuple(r[f"refresh_{comms}"]["in_edges"]) for r in world}) == 1


def test_strip_sub_renders_demand_no_more_than_the_main_render(results):
    """Under strip the step drops each tongue sub-render's send demand: for
    the last camera the tongue-only and tongue-free renders each send no
    more rows to any strip than the main render of that camera, which the
    step reports (and grows its buffers for)."""
    world, _ = results
    for rank, res in enumerate(world):
        d = res["send_demand"]
        assert d["main"] > 0 and d["only"] > 0 and d["without"] > 0, (rank, d)
        assert d["only"] <= d["main"] and d["without"] <= d["main"], (rank, d)
        assert d["main"] <= res["full_strip_overflow"], (rank, d)
