"""Tile binning in ed3dgs_torch against ed3dgs_tpu on the CPU.

The plain version of kernel K4 (`fused_bin_scans` on CPU tensors) against
the Pallas kernel in interpret mode, and the port's `bin_rows` against the
JAX `bin_rows` with the fused scan (interpret mode) and without it. Every
output is an integer and must match exactly."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.ops import binning as j_binning
from ed3dgs_tpu.ops.binning_scan import fused_bin_scans as j_fused_bin_scans

from ed3dgs_torch.ops import binning
from ed3dgs_torch.ops.binning_scan import fused_bin_scans

FIELDS = ("order", "pair_gauss", "pair_tile", "pair_perm", "seg_starts",
          "seg_ends", "tile_start", "tile_count", "num_pairs")


def random_rows(rng, n, grid_x, grid_y, max_span=4):
    depth = rng.uniform(0.5, 5.0, n).astype(np.float32)
    depth[: n // 10] = depth[n // 10: 2 * (n // 10)]      # depth ties: stable order
    valid = rng.uniform(size=n) > 0.2
    rmin = np.stack([rng.integers(0, grid_x, n), rng.integers(0, grid_y, n)], 1)
    spanx = rng.integers(1, max_span, n)
    spany = rng.integers(1, max_span, n)
    rmax = np.stack([np.minimum(rmin[:, 0] + spanx, grid_x),
                     np.minimum(rmin[:, 1] + spany, grid_y)], 1)
    tiles = np.where(valid, (rmax[:, 0] - rmin[:, 0]) * (rmax[:, 1] - rmin[:, 1]), 0)
    return (depth, valid, tiles.astype(np.int32), rmin.astype(np.int32),
            rmax.astype(np.int32))


def assert_bins_equal(jb, tb):
    for name in FIELDS:
        a, b = np.asarray(getattr(jb, name)), getattr(tb, name).numpy()
        assert b.dtype == np.int32, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    assert tb.grid == jb.grid


@pytest.mark.parametrize("K,grid_x,num_tiles,seed", [
    (1024, 7, 35, 0), (4096, 51, 1785, 1), (128 * 37, 13, 169, 2)])
def test_plain_scan_matches_pallas_interpret(K, grid_x, num_tiles, seed):
    """K4's plain version against the Pallas kernel on random delta streams
    whose prefix sums stay in int32 (as bin_rows' words do)."""
    rng = np.random.default_rng(seed)
    b = num_tiles.bit_length()
    rank_bits = 17
    dv = rng.integers(-2000, 6000, K).astype(np.int32)
    dpk = rng.integers(-(1 << 12), 1 << 14, K).astype(np.int32)
    for total in (0, K // 3, K):
        want = np.asarray(j_fused_bin_scans(
            jnp.asarray(dv), jnp.asarray(dpk), jnp.int32(total), grid_x=grid_x,
            num_tiles=num_tiles, rank_bits=rank_bits, b=b, interpret=True))
        got = fused_bin_scans(torch.as_tensor(dv), torch.as_tensor(dpk),
                              torch.tensor(total, dtype=torch.int32), grid_x=grid_x,
                              num_tiles=num_tiles, rank_bits=rank_bits, b=b)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fused_scan", [True, None])
@pytest.mark.parametrize("n,gx,gy,cap", [
    (300, 7, 5, 2048),      # room to spare
    (1000, 11, 9, 8192),
    (2000, 13, 13, 1024),   # capacity overflow: deepest pairs dropped
])
def test_bin_rows_matches_jax(fused_scan, n, gx, gy, cap):
    rng = np.random.default_rng(n)
    rows = random_rows(rng, n, gx, gy)
    jb = j_binning.bin_rows(*(jnp.asarray(x) for x in rows), grid_x=gx, grid_y=gy,
                            pair_capacity=cap, fused_scan=fused_scan)
    tb = binning.bin_rows(*(torch.as_tensor(x) for x in rows), grid_x=gx, grid_y=gy,
                          pair_capacity=cap)
    assert_bins_equal(jb, tb)
    if cap == 1024:
        assert int(tb.num_pairs) > cap


@pytest.mark.parametrize("n,gx,gy,cap", [
    (400, 9, 6, 1000),        # capacity not a multiple of 128
    (300, 130, 130, 2048),    # 16900 tiles: (tile, rank) no longer packs in 31 bits
])
def test_bin_rows_refused_shapes_match_jax(n, gx, gy, cap):
    """Shapes the delta-encoded path refuses take the cummax-fill
    formulation in both packages, with the tile id sorted alone where the
    packed key would not fit."""
    rng = np.random.default_rng(5)
    rows = random_rows(rng, n, gx, gy)
    jb = j_binning.bin_rows(*(jnp.asarray(x) for x in rows), grid_x=gx, grid_y=gy,
                            pair_capacity=cap, fused_scan=True)
    tb = binning.bin_rows(*(torch.as_tensor(x) for x in rows), grid_x=gx, grid_y=gy,
                          pair_capacity=cap)
    assert_bins_equal(jb, tb)


def test_payload_layout_matches_jax():
    assert binning.PAYLOAD_FIELDS == j_binning.PAYLOAD_FIELDS
    assert binning.ONES_COL == j_binning.ONES_COL == 25
    assert binning.PAYLOAD_WIDTH == 26
    assert binning.PAYLOAD_SLICES == j_binning.PAYLOAD_SLICES
    assert binning.tile_grid(802, 550) == j_binning.tile_grid(802, 550) == (51, 35)


def test_bin_rows_at_the_widest_packed_key_matches_jax(monkeypatch):
    """chip_smoke.py 5c's DyNeRF bit widths: 200,704 rows (the 200,000-
    Gaussian cap rounded to 1024: an 18-bit rank) on the 100x75 grid of a
    1600x1200 frame (13 tile bits), so K4's packed key takes all 31 bits;
    most rows lie off screen (no tiles), the rest reach the grid's last
    tiles, and K is a small multiple of 128 that the pairs overflow. The
    port takes the K4 path there, and bins exactly as the JAX package."""
    n, gx, gy, cap = 200_704, 100, 75, 128 * 100
    rng = np.random.default_rng(31)
    depth, valid, tiles, rmin, rmax = random_rows(rng, n, gx, gy, max_span=6)
    valid &= rng.uniform(size=n) < 0.03            # ~97% off screen
    valid[-64:] = True                             # the highest rows too
    rmin[-8:] = (gx - 1, gy - 1)                   # the last tile
    rmax[-8:] = (gx, gy)
    tiles = np.where(valid, (rmax[:, 0] - rmin[:, 0]) * (rmax[:, 1] - rmin[:, 1]),
                     0).astype(np.int32)
    rows = (depth, valid, tiles, rmin, rmax)
    seen = []
    scan = binning.fused_bin_scans

    def k4(*a, **kw):
        seen.append(kw)
        return scan(*a, **kw)
    monkeypatch.setattr(binning, "fused_bin_scans", k4)
    tb = binning.bin_rows(*(torch.as_tensor(x) for x in rows), grid_x=gx, grid_y=gy,
                          pair_capacity=cap)
    assert [(kw["rank_bits"], kw["b"]) for kw in seen] == [(18, 13)]
    assert 18 + 13 == 31 and int(tb.num_pairs) > cap
    jb = j_binning.bin_rows(*(jnp.asarray(x) for x in rows), grid_x=gx, grid_y=gy,
                            pair_capacity=cap, fused_scan=True)
    assert_bins_equal(jb, tb)
    assert int(np.asarray(tb.pair_tile).max()) == gx * gy - 1
