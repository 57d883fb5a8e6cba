"""The rasterizer's gradient in ed3dgs_torch against ed3dgs_tpu's "pallas"
backend, both on the CPU.

The plain version of kernel K2 (`rasterize_backward` on CPU tensors) is held
against `rasterize_pallas_backward(interpret=True)` on the same pair rows,
forward output and cotangent: live-chunk counts exactly, the written rows at
atol 1e-5 (the JAX package's interpret-mode bound,
tests/test_rasterize_pallas.py:77) and, in every column, at 1e-5 of the
column's largest value (measured: at most 9.0e-7 of it; the two sum in
other orders). The whole rasterizer gradient is held to the JAX package's in
test_torch_rasterize_grad.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.ops import binning as j_binning
from ed3dgs_tpu.ops import rasterize_pallas as j_rp

from ed3dgs_torch.ops import rasterize_cuda

from test_torch_rasterize import CASES, H, W, camera, project_jax, scene

ATOL = 1e-5
REL = 1e-5


def pallas_inputs(case):
    cam = camera()
    means, scales, q, opac, shs, tongue = scene(case["n"], case["seed"], case["stack"])
    chunk = case["chunk"]
    proj = project_jax(cam, means, scales, q, opac, shs)
    gx, gy = j_binning.tile_grid(W, H)
    bins = j_binning.bin_gaussians(proj, width=W, height=H, pair_capacity=1 << 13)
    payload = j_binning.build_gaussian_payload(proj, jnp.asarray(tongue), pad=False)
    rows = np.array(payload[bins.order][bins.pair_gauss])
    padded = jnp.pad(jnp.asarray(rows), ((0, chunk), (0, j_binning.PAYLOAD_PAD - 26)))
    kw = dict(grid_x=gx, width=W, height=H, focal_x=cam.focal_x, focal_y=cam.focal_y,
              chunk=chunk)
    packed = j_rp.rasterize_pallas_forward(padded, bins.tile_start, bins.tile_count,
                                           num_tiles=gx * gy, interpret=True, **kw)
    # N(0, 0.01^2) on every channel: gradient rows up to ~2 (a loss's mean
    # over the 48x40 pixels gives cotangents of ~2e-4 and far smaller rows)
    cot = np.random.default_rng(case["seed"] + 5).normal(
        0, 0.01, size=packed.shape).astype(np.float32)
    return cam, bins, rows, padded, packed, cot, kw, gy


@pytest.mark.parametrize("case", ["open", "stack32", "stack16"])
def test_plain_backward_blend_matches_pallas_interpret(case):
    case = CASES[case]
    cam, bins, rows, padded, packed, cot, kw, gy = pallas_inputs(case)
    gx, chunk = kw["grid_x"], kw["chunk"]
    want, want_live = j_rp.rasterize_pallas_backward(
        padded, bins.tile_start, bins.tile_count, packed, jnp.asarray(cot),
        num_tiles=gx * gy, interpret=True, **kw)
    want, want_live = np.asarray(want), np.asarray(want_live)[:gx * gy, 0]
    got, live = rasterize_cuda.rasterize_backward(
        torch.as_tensor(rows), torch.as_tensor(np.array(bins.tile_start)),
        torch.as_tensor(np.array(bins.tile_count)), torch.as_tensor(np.array(packed)),
        torch.as_tensor(cot), grid_y=gy, **kw)
    assert got.shape == (rows.shape[0], 26)
    np.testing.assert_array_equal(live.numpy(), want_live)
    # the rows the TPU kernel writes: each tile's first live chunks, inside
    # its count (it leaves the rest of a tile's rows unwritten; the port
    # writes zeros there)
    start, count = np.array(bins.tile_start), np.array(bins.tile_count)
    written = np.concatenate([
        np.arange(s, s + min(n, c * chunk)) for s, n, c in zip(start, count, want_live)])
    assert written.size == count.sum() > 0
    got, want = got.numpy()[written], want[written, :26]
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    col_max = np.abs(want).max(0)
    assert np.all(np.abs(got - want).max(0) <= REL * col_max)
    assert col_max.min() > 1e-3        # every column carries a gradient
