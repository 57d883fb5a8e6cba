"""The port's strip exchange (ed3dgs_torch.parallel.tile_sharded) on four
gloo ranks of the CPU, on the scene of tests/test_tile_sharded.py: against
the port's single-process `rasterize` and the JAX package's
`tile_sharded_rasterize` on `make_mesh(1, 4)` (the 8 virtual devices of
tests/conftest.py, "xla" backend as the JAX tests run it).

Bounds, those of tests/test_tile_sharded.py: every output channel atol
2e-5, rtol 1e-4; the gradients of means, opacity and SH atol 3e-5, rtol
1e-3. The pack's backward (K3 over the pack's pair CSR) is held to a
float64 index_add of the same cotangent rows. One world runs every case
(tests/torch_parallel_ranks.py) and must finish within 120 s.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.core.projection import project_gaussians as j_project
from ed3dgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ed3dgs_tpu.parallel import make_mesh
from ed3dgs_tpu.parallel import tile_sharded as jts

from ed3dgs_torch.parallel import tile_sharded as pts
from ed3dgs_torch.parallel.multihost import spawn_world
import torch_parallel_ranks as ranks

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")

W, H = ranks.TS_W, ranks.TS_H
ATOL, RTOL = 2e-5, 1e-4


def _jax_args(sc, cam):
    return dict(viewmatrix=jnp.asarray(cam.world_view), projmatrix=jnp.asarray(cam.full_proj),
                campos=jnp.asarray(cam.campos), width=W, height=H, tan_fovx=cam.tan_fovx,
                tan_fovy=cam.tan_fovy, focal_x=cam.focal_x, focal_y=cam.focal_y,
                kernel_size=0.1, sh_degree=3, mask=jnp.asarray(sc["mask"]))


def _jax_strip(sc, cam):
    """JAX tile_sharded_rasterize's outputs and the gradients of the test's
    loss, on a 1 x 4 mesh."""
    cfg = JRasterConfig(width=W, height=H, focal_x=cam.focal_x, focal_y=cam.focal_y,
                        pair_capacity=1 << 11, max_per_tile=160, chunk=32, backend="xla")
    mesh = make_mesh(data=1, gauss=4)
    args = _jax_args(sc, cam)
    means, scales, q, opac, shs = (jnp.asarray(sc[k]) for k in ("means", "scales", "q",
                                                                "opac", "shs"))
    tongue = jnp.asarray(sc["tongue"])
    out, _ = jax.jit(lambda p: jts.tile_sharded_rasterize(p, tongue, jnp.ones(3), cfg, mesh))(
        j_project(means, scales, q, opac, shs, **args))
    sc3 = ranks.strip_scene(seed=3)
    args3 = _jax_args(sc3, cam)
    tgt = jnp.asarray(np.random.default_rng(1).uniform(0, 1, (3, H, W)).astype(np.float32))

    def loss(means, opac, shs):
        proj = j_project(means, jnp.asarray(sc3["scales"]), jnp.asarray(sc3["q"]), opac, shs,
                         **args3)
        o, _ = jts.tile_sharded_rasterize(proj, jnp.asarray(sc3["tongue"]), jnp.zeros(3), cfg,
                                          mesh)
        return (jnp.mean(jnp.abs(o.color - tgt)) + 0.1 * jnp.mean(o.expected_depth)
                + 0.1 * jnp.mean(o.normal))

    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *(jnp.asarray(sc3[k]) for k in ("means", "opac", "shs")))
    return ({f: np.asarray(getattr(out, f)) for f in out._fields if f != "tile_overflow"},
            [np.asarray(g) for g in grads])


@pytest.fixture(scope="module")
def results():
    sc, cam = ranks.strip_scene(), ranks.strip_camera()
    # the ranks run while JAX compiles its strip render
    with ThreadPoolExecutor(1) as pool:
        world = pool.submit(spawn_world, ranks.tile_sharded_rank, 4, deadline_s=120)
        jax_out, jax_grads = _jax_strip(sc, cam)
        single, single_grads, batched = ranks.single_strip_reference()
        return world.result(), single, single_grads, batched, jax_out, jax_grads


def test_strip_render_matches_single_device_and_jax(results):
    world, single, _, _, jax_out, _ = results
    for rank, res in enumerate(world):
        for name, ref in single.items():
            np.testing.assert_allclose(res["out"][name], ref, atol=ATOL, rtol=RTOL,
                                       err_msg=f"rank {rank} {name} vs the port's rasterize")
            np.testing.assert_allclose(res["out"][name], jax_out[name], atol=ATOL, rtol=RTOL,
                                       err_msg=f"rank {rank} {name} vs JAX")
        assert res["overflow"] <= 2 * 128 // 4 * 4     # within the default capacity
        assert not res["tile_overflow"]


def test_strip_gradients_match(results):
    world, _, single_grads, _, _, jax_grads = results
    for i, name in enumerate(("means", "opacity", "shs")):
        got = np.concatenate([res["grads"][i] for res in world])   # each rank's rows
        np.testing.assert_allclose(got, single_grads[i], atol=3e-5, rtol=1e-3,
                                   err_msg=f"grad {name} vs the port's rasterize")
        np.testing.assert_allclose(got, jax_grads[i], atol=3e-5, rtol=1e-3,
                                   err_msg=f"grad {name} vs JAX")
        assert float(np.abs(got).max()) > 0


def test_strip_overflow_reported(results):
    """Demand past send_capacity=4 is reported, not hidden."""
    world, *_ = results
    assert all(res["overflow_cap4"] > 4 for res in world)


def test_batched_strip_exchange_matches_single_device(results):
    """batched_strip_rasterize at data=2 x gauss=2: rank (d, g) renders
    camera d of two."""
    world, _, _, batched, _, _ = results
    for rank, res in enumerate(world):
        ref = batched[rank // 2]
        for name, want in ref.items():
            np.testing.assert_allclose(res["batched"][name], want, atol=ATOL, rtol=RTOL,
                                       err_msg=f"rank {rank} camera {rank // 2} {name}")
        assert res["batched_overflow"] <= 2 * 128 // 2


def test_strip_render_collectives(results):
    """One all_to_all a camera (the exchange), the strips' all-gather, and
    no all-gather of the payload."""
    world, *_ = results
    for res in world:
        recs = res["ledger"]
        assert [r["tag"] for r in recs if r["kind"] == "all_to_all"] == ["payload"]
        assert not any(r["kind"] == "all_gather" and r["tag"] == "payload" for r in recs)
        assert [r["tag"] for r in recs if r["kind"] == "all_gather"] == ["strip_image"]


def _pack_case(seed, n=40, g=4, strip_rows=1, cap=16):
    rng = np.random.default_rng(seed)
    y0 = rng.integers(0, g * strip_rows, n)
    y1 = np.minimum(y0 + rng.integers(0, 3, n), g * strip_rows)
    payload = rng.normal(size=(n, 26)).astype(np.float32)
    extra = rng.normal(size=(n, 5)).astype(np.float32)
    depth = rng.uniform(1, 3, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.2
    return payload, extra, depth, valid, y0.astype(np.int32), y1.astype(np.int32)


@pytest.mark.parametrize("cap", [4, 16, 64])
def test_pack_forward_matches_jax_and_backward_matches_index_add(cap):
    """The pack's buffers equal JAX `_pack_for_strips`'s bit for bit (the
    overflow demand too; cap 4 drops splats); its gradient, K3 over the
    pack's pair CSR, equals a float64 index_add of the cotangent rows into
    each buffer row's source splat."""
    g, strip_rows = 4, 1
    payload, extra, depth, valid, y0, y1 = _pack_case(cap, cap=cap)
    rows = np.concatenate([payload, extra], 1)
    jbufs, jcounts = jax.jit(jts._pack_for_strips, static_argnums=(5, 6, 7))(
        jnp.asarray(rows), jnp.asarray(depth), jnp.asarray(valid), jnp.asarray(y0),
        jnp.asarray(y1), g, strip_rows, cap)
    tp = torch.as_tensor(payload).requires_grad_(True)
    bufs, demand = pts._pack_for_strips(tp, torch.as_tensor(extra), torch.as_tensor(depth),
                                        torch.as_tensor(valid), torch.as_tensor(y0),
                                        torch.as_tensor(y1), g, strip_rows, cap)
    np.testing.assert_array_equal(bufs.detach().numpy(), np.asarray(jbufs).reshape(g * cap, -1))
    assert int(demand) == int(np.max(np.asarray(jcounts)))

    ct = torch.as_tensor(np.random.default_rng(9).normal(size=tuple(bufs.shape))
                         .astype(np.float32))
    (grad,) = torch.autograd.grad((bufs * ct).sum(), tp)
    # the reference: which source row fills each buffer row, by value
    src = np.full(g * cap, -1)
    b = bufs.detach().numpy()
    for k in range(g * cap):
        hit = np.flatnonzero((rows == b[k]).all(1))
        if b[k].any():
            src[k] = hit[0]
    ref = torch.zeros((payload.shape[0], 26), dtype=torch.float64)
    live = torch.as_tensor(src >= 0)
    ref.index_add_(0, torch.as_tensor(src[src >= 0]), ct[live, :26].double())
    np.testing.assert_allclose(grad.numpy(), ref.float().numpy(), rtol=1e-6, atol=0)
    assert int(live.sum()) > 0


def test_pack_budget_grows_with_the_capacity():
    """Found in the JAX package (ROADMAP.md, Queue 3): its pack's pair budget
    is max(2n, 64g) whatever the send capacity, so 300 splats (266 valid)
    that each meet all 4 strips (1,064 pairs) keep only the shallowest 150
    in every buffer, and report a demand of 1,064 that no capacity ever
    satisfies.
    The port's budget grows to g * cap: at cap 300 every buffer holds every
    valid splat in depth order, and the demand it reports fits the
    capacity."""
    n, g, cap = 300, 4, 300
    rng = np.random.default_rng(11)
    payload = rng.normal(size=(n, 26)).astype(np.float32)
    extra = rng.normal(size=(n, 5)).astype(np.float32)
    depth = rng.uniform(1, 3, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.1
    y0, y1 = np.zeros(n, np.int32), np.full(n, g, np.int32)
    rows = np.concatenate([payload, extra], 1)
    jbufs, jcounts = jax.jit(jts._pack_for_strips, static_argnums=(5, 6, 7))(
        jnp.asarray(rows), jnp.asarray(depth), jnp.asarray(valid), jnp.asarray(y0),
        jnp.asarray(y1), g, 1, cap)
    jfilled = (np.abs(np.asarray(jbufs)).sum(-1) > 0).sum(1)
    assert list(jfilled) == [150] * g
    assert int(np.max(np.asarray(jcounts))) == 4 * int(valid.sum()) > cap

    bufs, demand = pts._pack_for_strips(
        torch.as_tensor(payload), torch.as_tensor(extra), torch.as_tensor(depth),
        torch.as_tensor(valid), torch.as_tensor(y0), torch.as_tensor(y1), g, 1, cap)
    want = rows[np.flatnonzero(valid)[np.argsort(depth[valid], kind="stable")]]
    got = bufs.numpy().reshape(g, cap, -1)
    for d in range(g):
        np.testing.assert_array_equal(got[d, :len(want)], want)
        assert not got[d, len(want):].any()
    assert int(demand) == int(valid.sum()) <= cap
