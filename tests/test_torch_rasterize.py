"""The forward rasterizer of ed3dgs_torch against ed3dgs_tpu's "pallas"
backend, both on the CPU.

The plain version of kernel K1 (`rasterize_forward` on CPU tensors) is held
against `rasterize_pallas_forward(interpret=True)` on the same gathered pair
rows, and the port's `rasterize()` against JAX `rasterize(backend="pallas",
interpret=True)` on the same projected Gaussians. Tolerance atol 1e-5 (the
JAX package's own interpret-mode bound, tests/test_rasterize_pallas.py):
both follow the chunked blend, and differ only in float association (the
TPU kernel's log-step scans and matmul accumulation)."""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.core.projection import project_gaussians as j_project
from ed3dgs_tpu.data.cameras import look_at_camera
from ed3dgs_tpu.ops import binning as j_binning
from ed3dgs_tpu.ops import rasterize_pallas as j_rp
from ed3dgs_tpu.ops.rasterize import RasterConfig as JRasterConfig
from ed3dgs_tpu.ops.rasterize import rasterize as j_rasterize

from ed3dgs_torch.core.projection import ProjectedGaussians
from ed3dgs_torch.ops import rasterize_cuda
from ed3dgs_torch.ops.rasterize import RasterConfig, rasterize

ATOL = 1e-5
W, H = 48, 40          # neither a multiple of 16


def scene(n, seed, stack=0):
    """Random splats in front of the camera; `stack` of them piled nearly
    opaque on one spot, so transmittance falls below the 1e-4 stop inside a
    tile and across chunk boundaries."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                      rng.uniform(1.5, 4, n)], 1).astype(np.float32)
    scales = np.exp(rng.normal(-2.5, 0.5, (n, 3))).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, n).astype(np.float32)
    if stack:
        means[:stack, :2] = rng.normal(0, 0.02, (stack, 2))
        scales[:stack] = 0.15
        opac[:stack] = rng.uniform(0.6, 0.99, stack)
    shs = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    tongue = (rng.uniform(0, 1, n) > 0.7).astype(np.float32)
    return means, scales, q, opac, shs, tongue


def camera():
    fov = math.radians(60.0)
    return look_at_camera((0, 0, 0), (0, 0, 1), (0, -1, 0), fov, fov * H / W,
                          W, H).matrices()


def project_jax(cam, means, scales, q, opac, shs):
    return j_project(
        jnp.asarray(means), jnp.asarray(scales), jnp.asarray(q), jnp.asarray(opac),
        jnp.asarray(shs), viewmatrix=jnp.asarray(cam.world_view),
        projmatrix=jnp.asarray(cam.full_proj), campos=jnp.asarray(cam.campos),
        width=W, height=H, tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy,
        focal_x=cam.focal_x, focal_y=cam.focal_y, kernel_size=0.1, sh_degree=3)


def to_torch(proj):
    return ProjectedGaussians(**{f: torch.as_tensor(np.array(getattr(proj, f)))
                                 for f in ProjectedGaussians._fields})


CASES = {"open": dict(n=200, seed=0, stack=0, chunk=32),
         "stack32": dict(n=300, seed=1, stack=90, chunk=32),
         "stack16": dict(n=150, seed=2, stack=40, chunk=16)}


@pytest.mark.parametrize("case", ["open", "stack32"])
def test_plain_forward_blend_matches_pallas_interpret(case):
    case = CASES[case]
    cam = camera()
    means, scales, q, opac, shs, tongue = scene(case["n"], case["seed"], case["stack"])
    chunk = case["chunk"]
    proj = project_jax(cam, means, scales, q, opac, shs)
    gx, gy = j_binning.tile_grid(W, H)
    bins = j_binning.bin_gaussians(proj, width=W, height=H, pair_capacity=1 << 13)
    payload = j_binning.build_gaussian_payload(proj, jnp.asarray(tongue), pad=False)
    rows = np.array(payload[bins.order][bins.pair_gauss])          # [K, 26]
    padded = jnp.pad(jnp.asarray(rows), ((0, chunk), (0, j_binning.PAYLOAD_PAD - 26)))
    kw = dict(grid_x=gx, width=W, height=H, focal_x=cam.focal_x, focal_y=cam.focal_y,
              chunk=chunk)
    want = np.asarray(j_rp.rasterize_pallas_forward(
        padded, bins.tile_start, bins.tile_count, num_tiles=gx * gy,
        interpret=True, **kw))
    got = rasterize_cuda.rasterize_forward(
        torch.as_tensor(rows), torch.as_tensor(np.array(bins.tile_start)),
        torch.as_tensor(np.array(bins.tile_count)), grid_y=gy, **kw).numpy()
    assert got.shape == want.shape == (gy, 8, 24, 256)
    assert rasterize_cuda.OUT_CHANNELS == j_rp.OUT_CHANNELS
    # tile columns gx..8 are never written by either kernel
    np.testing.assert_allclose(got[:, :gx], want[:, :gx], rtol=0, atol=ATOL)
    if case["stack"]:
        t_final = got[:, :gx, rasterize_cuda.OUT_CHANNELS["t_final"]]
        assert t_final.min() < 1e-3   # the early stop is exercised


@pytest.mark.parametrize("case", ["open", "stack16"])
def test_rasterize_matches_jax_pallas(case):
    case = CASES[case]
    cam = camera()
    means, scales, q, opac, shs, tongue = scene(case["n"], case["seed"], case["stack"])
    proj = project_jax(cam, means, scales, q, opac, shs)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    kw = dict(width=W, height=H, focal_x=cam.focal_x, focal_y=cam.focal_y,
              pair_capacity=1 << 12, chunk=case["chunk"])
    jo = j_rasterize(proj, jnp.asarray(tongue), jnp.asarray(bg),
                     JRasterConfig(backend="pallas", interpret=True, **kw))
    to = rasterize(to_torch(proj), torch.as_tensor(tongue), torch.as_tensor(bg),
                   RasterConfig(**kw))
    for name in to._fields:
        a, b = np.asarray(getattr(jo, name)), getattr(to, name).numpy()
        assert a.shape == b.shape, name
        if name == "tile_overflow":
            assert bool(b) is bool(a) is False
        else:
            assert np.all(np.isfinite(b)), name
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL, err_msg=name)


def test_tile_overflow_is_reported():
    """chunk 4 caps a tile at 4*512 = 2048 pairs; 2200 splats on one tile
    exceed it. The flag is the JAX package's `max(tile_count) > chunk*512`."""
    n = 2200
    rng = np.random.default_rng(3)
    means = np.stack([rng.uniform(-0.01, 0.01, n), rng.uniform(-0.01, 0.01, n),
                      rng.uniform(2.0, 2.4, n)], 1).astype(np.float32)
    scales = np.full((n, 3), 0.004, np.float32)
    q = np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1))
    opac = np.full(n, 0.5, np.float32)
    shs = np.zeros((n, 16, 3), np.float32)
    cam = camera()
    proj = project_jax(cam, means, scales, q, opac, shs)
    jb = j_binning.bin_gaussians(proj, width=W, height=H, pair_capacity=1 << 13)
    want = int(jnp.max(jb.tile_count)) > 4 * 512
    cfg = RasterConfig(width=W, height=H, focal_x=cam.focal_x, focal_y=cam.focal_y,
                       pair_capacity=1 << 13, chunk=4)
    out = rasterize(to_torch(proj), torch.zeros(n), torch.ones(3), cfg)
    assert want and bool(out.tile_overflow)
    assert torch.isfinite(out.color).all()


def _box_rows(seed):
    """[K, 26] pair rows for the screen-box test: random splats (positive
    definite conics from covariances of 0.3 to 30 px, any orientation,
    opacities over (0, 1)) and adversarial ones: circles whose pass edge
    falls exactly on a warp block's pixel boundary, opacities at and around
    1/255, zero, indefinite and nearly degenerate conics on either side of
    the box's 1e-3 determinant threshold, and very thin, huge and tiny
    splats."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    amin = f32(1.0) / f32(255.0)
    rows = []

    def add(mx, my, a, b, c, opc):
        r = np.zeros(26, f32)
        r[0:6] = mx, my, a, b, c, opc
        rows.append(r)

    for _ in range(1500):
        s = np.exp(rng.uniform(np.log(0.3), np.log(30.0), 2))
        th = rng.uniform(0, np.pi)
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        inv = np.linalg.inv(R @ np.diag(s * s) @ R.T + 0.1 * np.eye(2))
        add(rng.uniform(-8, 72), rng.uniform(-8, 72), inv[0, 0], inv[0, 1], inv[1, 1],
            rng.uniform(0.0, 1.0))
    for opc in (0.99, 0.5, 0.02):
        r2 = 2.0 * np.log(opc * 255.0)
        for k in (1, 4, 8, 16):
            # q = r2 exactly at the integer offset k from an integer centre
            add(8.0, 12.0, r2 / k ** 2, 0.0, r2 / k ** 2, opc)
            add(31.0, 15.0, r2 / k ** 2, 0.0, 4 * r2 / k ** 2, opc)
    for opc in (amin, np.nextafter(amin, f32(1)), np.nextafter(amin, f32(0)),
                amin * f32(1.0001), amin * f32(1.01), amin * f32(0.999)):
        for conic in ((0.5, 0.0, 0.5), (1e-4, 0.0, 1e-4), (0.02, 0.01, 0.03)):
            add(20.3, 19.7, *conic, opc)
    for conic in ((0.0, 0.0, 0.0), (0.05, 0.1, 0.05), (-0.1, 0.0, 0.1), (0.1, 0.0, -0.1),
                  (0.0, 0.02, 0.0)):
        add(24.0, 24.0, *conic, 0.9)
    for rho in (0.9994, 0.9995, 0.99951, 0.9996, 0.999):
        # det / (a c) = 1 - rho^2 around the box's threshold
        for a, c in ((1.0, 1.0), (0.01, 0.04), (2.0, 0.005)):
            add(30.5, 29.5, a, rho * np.sqrt(a * c), c, 0.95)
            add(30.5, 29.5, a, -rho * np.sqrt(a * c), c, 0.95)
    for s in (0.05, 200.0):
        add(17.0, 40.0, 1.0 / s ** 2, 0.0, 1.0 / s ** 2, 0.8)
    return torch.as_tensor(np.stack(rows))


def test_cull_box_holds_every_passing_pixel():
    """The kernels' warps skip rows that cannot pass at their pixels:
    cull_box_plain (the box's float32 copy) must hold every pixel at which
    the blend's pass test (`_splat_alphas`) passes, on a 144 x 144 pixel
    window around every splat, and meets_block_plain (the per-warp test)
    must keep every 8x4 block of that window where some pixel passes."""
    rows = _box_rows(0)
    box = rasterize_cuda.cull_box_plain(rows)
    xs = torch.arange(-40, 104, dtype=torch.float32)
    pyf, pxf = torch.meshgrid(xs, xs, indexing="ij")
    pxf, pyf = pxf.reshape(1, -1), pyf.reshape(1, -1)
    n_pass = n_culled_out = 0
    for b0 in range(0, rows.shape[0], 128):
        block = rows[b0:b0 + 128][None]
        inrow = torch.ones(block.shape[:2], dtype=torch.bool)
        passes = rasterize_cuda._splat_alphas(block, inrow, pxf, pyf)["passes"][0]
        bx = box[b0:b0 + 128]
        inside = ((pxf >= bx[:, 0:1]) & (pxf <= bx[:, 1:2])
                  & (pyf >= bx[:, 2:3]) & (pyf <= bx[:, 3:4]))
        assert not bool((passes & ~inside).any())
        n_pass += int(passes.sum())
        n_culled_out += int((~inside).sum())
    # not vacuous: many pixels pass, and the boxes exclude most of the window
    assert n_pass > 100_000 and n_culled_out > 0.5 * rows.shape[0] * pxf.shape[1]
    # the kernels' per-warp test (box, then the pass ellipse against the
    # warp's 8x4 block): where it says no, no pixel of the block passes
    n_missed = 0
    blocks = [(bx, by) for by in range(-40, 104, 4) for bx in range(-40, 104, 8)]
    for b0 in range(0, rows.shape[0], 128):
        block = rows[b0:b0 + 128][None]
        inrow = torch.ones(block.shape[:2], dtype=torch.bool)
        passes = rasterize_cuda._splat_alphas(block, inrow, pxf, pyf)["passes"][0]
        passes = passes.reshape(-1, 36, 4, 18, 8).any(dim=4).any(dim=2)   # [C, by, bx]
        for i, (bx, by) in enumerate(blocks):
            meets = rasterize_cuda.meets_block_plain(rows[b0:b0 + 128], bx, by)
            hit = passes[:, i // 18, i % 18]
            assert not bool((hit & ~meets).any())
            n_missed += int((~meets).sum())
    # the ellipse test rejects blocks the box alone keeps
    in_box = sum(int(((bxs[:, 1] >= bx) & (bxs[:, 0] <= bx + 7) & (bxs[:, 3] >= by)
                      & (bxs[:, 2] <= by + 3)).sum())
                 for bxs in [rasterize_cuda.cull_box_plain(rows)] for bx, by in blocks)
    assert rows.shape[0] * len(blocks) - n_missed < 0.95 * in_box
    # the box is tight: a circle of pass radius 8 spans 8 + at most 2 pixels
    r2 = 2.0 * np.log(0.99 * 255.0)
    circle = torch.tensor([[8.0, 12.0, r2 / 64, 0.0, r2 / 64, 0.99] + [0.0] * 20])
    x0, x1, y0, y1 = rasterize_cuda.cull_box_plain(circle)[0].tolist()
    assert 8 - 11 <= x0 <= 8 - 8 and 8 + 8 <= x1 <= 8 + 11 and 12 - 11 <= y0 and y1 <= 12 + 11
    # the edge cases' boxes: empty below 1/255, the whole plane where the
    # conic is not positive definite or nearly degenerate
    far = rasterize_cuda.BOX_FAR
    special = torch.zeros((4, 26))
    special[:, 0:6] = torch.tensor([[5.0, 5.0, 0.5, 0.0, 0.5, 0.003],
                                    [5.0, 5.0, 0.0, 0.0, 0.0, 0.5],
                                    [5.0, 5.0, 0.05, 0.1, 0.05, 0.5],
                                    [5.0, 5.0, 1.0, 0.99999, 1.0, 0.5]])
    got = rasterize_cuda.cull_box_plain(special).tolist()
    assert got[0][0] > got[0][1] and got[0][2] > got[0][3]
    assert got[1] == got[2] == got[3] == [-far, far, -far, far]
