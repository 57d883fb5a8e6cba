"""The port's sharded training step (ed3dgs_torch.parallel.sharded) on four
gloo ranks of the CPU at data=2 x gauss=2, both comms, against the port's
single-process step and the JAX package's `make_sharded_train_step` on the
same mesh (the 8 virtual devices of tests/conftest.py), from the same state:
the problem of tests/test_parallel.py with float32 activations (the bf16
network is held to JAX's in tests/test_torch_deformation.py). The JAX cloud
and deformation weights are carried to the port with convert.py.

Bounds, those of tests/test_parallel.py:70-79: loss rel 2e-4, PSNR rel
2e-3, xyz atol 5e-5, the deformation `weight` atol 5e-6, `denom` atol 1e-6.
One world runs every case (tests/torch_parallel_ranks.py); it must finish
within 120 s, and its collectives time out after 60 s. A second problem
turns every global and last-camera term on (SSIM, temporal TV,
depth-normal, COLMAP, tongue) and holds the sharded step to the port's
single step alone.

The graphed sharded step (the default, `make_sharded_train_step(...,
graph=True)`: a CUDA graph per key on the card, the same static-buffer
path run eagerly on the CPU) must equal the eager one (graph=False) bit
for bit on every state tensor and metric over three steps, with each
comms, and leave the same collectives in the ledger; its first step keeps
the bounds against JAX's sharded step. In a world of two ranks whose keys
differ, the key check raises on both before the step runs.
"""

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ed3dgs_tpu.config.params import DeformHiddenConfig, OptimizationConfig
from ed3dgs_tpu.data.cameras import look_at_camera
from ed3dgs_tpu.data.scene import flatten_pytree
from ed3dgs_tpu.models import gaussians as jgm
from ed3dgs_tpu.ops.rasterize import RasterConfig
from ed3dgs_tpu.parallel import make_mesh
from ed3dgs_tpu.parallel.sharded import (make_sharded_train_step, shard_batch,
                                         shard_knn_cache, shard_train_state)
from ed3dgs_tpu.train.trainer import (TrainSetup, init_train_state, make_train_step,
                                      update_knn_cache)

from ed3dgs_torch.parallel.multihost import spawn_world
import torch_parallel_ranks as ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

BATCH, N, CAP, W, H = 4, 96, 128, 48, 48
HIDDEN = dict(net_width=32, defor_depth=1, bf16_activations=False)


def _jax_problem():
    """tests/test_parallel.py's build_problem, float32 activations."""
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-0.7, 0.7, N), rng.uniform(-0.7, 0.7, N),
                    rng.uniform(1.9, 2.5, N)], 1).astype(np.float32)
    cols = rng.uniform(0.1, 0.9, (N, 3)).astype(np.float32)
    params, aux = jgm.create_from_points(pts, cols, capacity=CAP)
    hidden = DeformHiddenConfig(**HIDDEN)
    opt_cfg = OptimizationConfig()
    fov = math.radians(60.0)
    cams = [look_at_camera((0.2 * i - 0.3, 0.1 * i, 0), (0, 0, 2.2), (0, -1, 0), fov, fov,
                           W, H).matrices() for i in range(BATCH)]
    raster = dict(width=W, height=H, focal_x=cams[0].focal_x, focal_y=cams[0].focal_y,
                  pair_capacity=1 << 13, chunk=32)
    rcfg = RasterConfig(backend="xla", max_per_tile=128, **raster)
    state, optimizer = init_train_state(params, hidden, opt_cfg, 1.0)
    setup_kw = dict(batch_size=BATCH, disable_filter3d=True, radegs_from_iter=10 ** 9,
                    batch_mode="vmap")
    setup = TrainSetup(raster=rcfg, hidden=hidden, **setup_kw)
    batch = {
        "gt_image": rng.uniform(0, 1, (BATCH, 3, H, W)).astype(np.float32),
        "viewmatrix": np.stack([c.world_view for c in cams]).astype(np.float32),
        "projmatrix": np.stack([c.full_proj for c in cams]).astype(np.float32),
        "campos": np.stack([c.campos for c in cams]).astype(np.float32),
        "time": np.zeros(BATCH, np.float32),
        "cam_no": np.zeros(BATCH, np.int32),
    }
    jbatch = {**{k: jnp.asarray(v) for k, v in batch.items()}, "use_ssim": jnp.asarray(False)}
    port = dict(
        fields={**{k: np.asarray(getattr(params, k)) for k in params._fields},
                **{k: np.asarray(getattr(aux, k)) for k in aux._fields}},
        hidden=HIDDEN, iteration=0, raster=raster, setup=setup_kw,
        deform=flatten_pytree(state.params["deform"]),
        batch={**batch, "cam_no": batch["cam_no"].astype(np.int64), "use_ssim": False})
    return state, aux, setup, opt_cfg, optimizer, jbatch, port


@pytest.fixture(scope="module")
def results():
    state, aux, setup, opt_cfg, optimizer, batch, port = _jax_problem()
    # the ranks run while JAX builds its KNN cache and compiles its step
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn_world, ranks.parallel_step_rank, 4, args=(port,),
                            deadline_s=120)
        cache = jax.jit(update_knn_cache)(state.params["gaussians"], aux)
        jax_sharded = _jax_sharded_step(state, aux, setup, opt_cfg, optimizer, batch, cache)
        return world.result(), jax_sharded


def _jax_sharded_step(state, aux, setup, opt_cfg, optimizer, batch, cache):
    raw = make_train_step(setup, opt_cfg, optimizer, jit=False)
    mesh = make_mesh(data=2, gauss=2)
    state_s, aux_s = shard_train_state(mesh, state, aux)
    step = make_sharded_train_step(raw, mesh, state, aux, batch, cache)
    s, a, m = step(state_s, aux_s, shard_batch(mesh, batch), shard_knn_cache(mesh, cache))
    jax_sharded = {"xyz": np.asarray(s.params["gaussians"].xyz),
                   "weight": np.asarray(s.params["deform"]["weight"]),
                   "denom": np.asarray(a.denom), "loss": float(m["loss"]),
                   "psnr": float(m["psnr"])}
    return jax_sharded


def _hold(got, want, what):
    assert got["loss"] == pytest.approx(want["loss"], rel=2e-4), what
    assert got["psnr"] == pytest.approx(want["psnr"], rel=2e-3), what
    np.testing.assert_allclose(got["xyz"], want["xyz"], atol=5e-5, err_msg=what)
    np.testing.assert_allclose(got["weight"], want["weight"], atol=5e-6, err_msg=what)
    np.testing.assert_allclose(got["denom"], want["denom"], atol=1e-6, err_msg=what)


@pytest.mark.parametrize("comms", ["gspmd", "strip"])
def test_sharded_step_matches_single_step_and_jax(results, comms):
    """Every rank's gathered state after one step equals the single-process
    step's and JAX's sharded step's; the metrics come back global (the
    batch's four l1 terms on every rank)."""
    world, jax_sharded = results
    single = world[0]["single"]
    assert float(np.abs(single["denom"]).sum()) > 0
    for rank, res in enumerate(world):
        _hold(res[comms], single, f"rank {rank} {comms} vs the port's single step")
        _hold(res[comms], jax_sharded, f"rank {rank} {comms} vs JAX's sharded step")
        np.testing.assert_allclose(res[comms]["l1_items"], single["l1_items"], rtol=1e-5)


@pytest.mark.parametrize("comms", ["gspmd", "strip"])
def test_every_loss_term_on_the_mesh_matches_the_single_step(results, comms):
    """With SSIM, temporal TV, depth-normal, COLMAP and tongue terms all
    live (global terms on data rank 0, the last camera's on data rank 1, TV
    reaching the replicated network once), one sharded step equals the
    port's single step, each metric too."""
    world, _ = results
    single = world[0]["full_single"]
    for term in ("tv_loss", "depth_normal", "pcd_loss", "tongue_l1", "tongue_rgb"):
        assert single["terms"][term] > 0, term
    for rank, res in enumerate(world):
        _hold(res[f"full_{comms}"], single, f"rank {rank} {comms}, every term")
        for k, v in res[f"full_{comms}_terms"].items():
            assert v == pytest.approx(single["terms"][k], rel=2e-4, abs=1e-7), (rank, k)


def test_three_steps_stay_sharded(results):
    world, _ = results
    for res in world:
        assert res["three"]["rows"] == res["three"]["aux_rows"] == CAP // 2
        assert np.isfinite(res["three"]["loss"])
    assert len({res["three"]["loss"] for res in world}) == 1


def test_vmap_renders_as_scan_bit_for_bit(results):
    """The port has no vmap: batch_mode="vmap" renders camera by camera, as
    "scan" does, to the same bits."""
    world, _ = results
    assert all(res["vmap_equals_scan"] for res in world)


def test_gspmd_step_collectives(results):
    """tests/test_hlo_collectives.py's contract for the GSPMD step: gradient
    all-reduces, no all-to-all, no all-gather past the local cameras'
    projected payload (B_local x C x 128 lanes x f32, x 2 slack), and all
    communication within 64 times that."""
    world, _ = results
    payload_bound = (BATCH // 2) * CAP * 128 * 4 * 2
    for res in world:
        recs = res["ledger_gspmd"]
        assert any(r["kind"] == "all_reduce" and r["tag"] == "grad" for r in recs)
        assert any(r["kind"] == "all_reduce" and r["axis"] == "world" and r["tag"] == "grad"
                   for r in recs)          # the replicated network's gradient
        assert not any(r["kind"] == "all_to_all" for r in recs)
        assert max(r["bytes"] for r in recs if r["kind"] == "all_gather") <= payload_bound
        assert sum(r["bytes"] for r in recs) < 64 * payload_bound


def test_strip_step_collectives(results):
    """The strip step exchanges each local camera's payload in one
    all_to_all (and one back in the backward), and never all-gathers it."""
    world, _ = results
    for res in world:
        recs = res["ledger_strip"]
        fwd = [r for r in recs if r["kind"] == "all_to_all" and not r["backward"]]
        bwd = [r for r in recs if r["kind"] == "all_to_all" and r["backward"]]
        assert len(fwd) == len(bwd) == BATCH // 2
        assert not any(r["kind"] == "all_gather" and r["tag"] == "payload" for r in recs)
        assert sum(r["tag"] == "strip_image" for r in recs) == BATCH // 2


@pytest.mark.parametrize("comms", ["gspmd", "strip"])
def test_graphed_sharded_step_equals_the_eager_step(results, comms):
    """Three graphed sharded steps against three eager ones from the same
    shards: every state tensor (parameters, Adam moments and counts, aux)
    and every metric bit for bit, the same collectives a step (kind, axis,
    bytes, tag, direction), and the first step within the bounds of JAX's
    sharded step."""
    world, jax_sharded = results
    for rank, res in enumerate(world):
        assert res[f"graph_differ_{comms}"] == [[], [], []], (rank, comms)
        ledgers = res[f"graph_ledgers_{comms}"]
        assert ledgers[True] == ledgers[False], (rank, comms)
        assert all(len(step) > 0 for step in ledgers[True]), (rank, comms)
        _hold(res[f"graph_{comms}"], jax_sharded, f"rank {rank} graphed {comms} vs JAX")
        np.testing.assert_allclose(res[f"graph_{comms}"]["l1_items"],
                                   world[0]["single"]["l1_items"], rtol=1e-5)


@pytest.mark.parametrize("comms", ["gspmd", "strip"])
def test_capacity_change_keeps_the_ranks_keys_equal(results, comms):
    """A replay checks no key, so the ranks must rebuild their steps at the
    same call: tools.train does so on the pair demand and the strip
    overflow that the step reports, which come back equal on all four
    ranks, and the step rebuilt on larger capacities runs its first call
    (the key check) on one key hash everywhere."""
    world, _ = results
    got = [res[f"capacity_{comms}"] for res in world]
    assert len({tuple(g["seen"]) for g in got}) == 1, got
    assert got[0]["seen"][0] > 0, got
    assert len({g["key"] for g in got}) == 1, got


def test_ranks_with_different_keys_raise_before_the_step():
    """Two gloo ranks at gauss=2 whose SSIM gates differ: the graphed
    step's key check raises on both, each naming its own key and the other
    rank, and neither ran a collective of the step."""
    *_, port = _jax_problem()
    world = spawn_world(ranks.key_mismatch_rank, 2, args=(port,), deadline_s=60)
    for rank, (msg, records) in enumerate(world):
        assert msg is not None, rank
        assert f"rank {rank} holds key" in msg and f"ranks [{1 - rank}]" in msg, msg
        assert f"use_ssim={rank == 1}" in msg, msg
        assert records == [], rank
