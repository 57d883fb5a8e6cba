"""Fused pair-slot scan for tile binning: kernel K4 (port of
ed3dgs_tpu/ops/binning_scan.py, `fused_bin_scans`), and kernel X2, which
writes the two delta streams K4 scans.

bin_rows delta-encodes two per-slot words over the [K] pair buffer; their
inclusive prefix sums give, per pair slot p,

  v  = (rank << b) | (seg_start mod 2^b)    (owning gaussian rank, first slot)
  pk = (tile_base << 9) | rect_w            (owner's tile rect)

and the decode packs the sort key `tile << rank_bits | rank`, where the tile
is the k-th of the owner's rect in row-major order, k = (p - v) mod 2^b.
Slots at or past `total` get tile `num_tiles`.

The deltas sit at each Gaussian rank's first slot: the rank's word less
the word of the previous rank that has a slot. `boundary_deltas` (X2)
finds that previous rank for every row with one exclusive max-scan (the
JAX package's three `jax.lax.cummax`, ed3dgs_tpu/ops/binning.py:150-153).

On CUDA tensors `fused_bin_scans` and `boundary_deltas` launch
csrc/binning_scan.cu, each one single-pass scan with a decoupled look-back;
on CPU tensors they run `fused_bin_scans_plain` and `boundary_deltas_plain`.
"""

from __future__ import annotations

import torch

from . import cuda_lib

SCAN_TILE = 4096   # slots per CTA of K4 (256 threads x 16); see csrc
ROW_TILE = 1024    # rows per CTA of X2 (256 threads x 4)


def _scatter_add(K: int, pos: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """zeros([K]).at[pos].add(vals, mode="drop"): positions >= K land in one
    extra slot that is cut off."""
    buf = torch.zeros(K + 1, dtype=torch.int32, device=vals.device)
    buf.index_add_(0, torch.clamp_max(pos, K).to(torch.int64), vals.to(torch.int32))
    return buf[:K]


def _decode(v, pk, total, *, grid_x, num_tiles, rank_bits, b):
    p = torch.arange(v.shape[0], dtype=torch.int32, device=v.device)
    rank = v >> b
    k = (p - v) & ((1 << b) - 1)
    rw = torch.clamp_min(pk & 0x1FF, 1)
    q = torch.div(k, rw, rounding_mode="floor")
    r = k - q * rw
    tile = torch.where(p < total, (pk >> 9) + q * grid_x + r,
                       torch.full_like(p, num_tiles))
    return (tile << rank_bits) | rank


def fused_bin_scans_plain(dv, dpk, total, *, grid_x: int, num_tiles: int,
                          rank_bits: int, b: int):
    """Plain PyTorch version of K4: torch.cumsum + decode. The partial sums
    are exact int32 words (see bin_rows), so summing in int64 and narrowing
    gives the kernel's int32 result."""
    v = torch.cumsum(dv, 0).to(torch.int32)
    pk = torch.cumsum(dpk, 0).to(torch.int32)
    return _decode(v, pk, total, grid_x=grid_x, num_tiles=num_tiles,
                   rank_bits=rank_bits, b=b)


def fused_bin_scans(dv, dpk, total, *, grid_x: int, num_tiles: int,
                    rank_bits: int, b: int) -> torch.Tensor:
    """dv, dpk: [K] int32 delta streams; total: 0-d int32 tensor (true pair
    count, read on the device — no host sync). Returns the packed sort key
    [K] int32."""
    K = dv.shape[0]
    if K % 128:
        raise ValueError(f"pair capacity {K} must be a multiple of 128")
    if not dv.is_cuda:
        return fused_bin_scans_plain(dv, dpk, total, grid_x=grid_x,
                                     num_tiles=num_tiles, rank_bits=rank_bits, b=b)
    for name, t in (("dv", dv), ("dpk", dpk)):
        cuda_lib.check_cuda(t, name, torch.int32, 1)
    total = total.reshape(1)
    cuda_lib.check_cuda(total, "total", torch.int32, 1)
    if dpk.shape[0] != K:
        raise ValueError("dv and dpk must have the same length")
    key = torch.empty_like(dv)
    # the tile and done counters, then each tile's two aggregates: zeroed,
    # and left zeroed by the kernel
    tiles = (K + SCAN_TILE - 1) // SCAN_TILE
    scratch = cuda_lib.zeroed("binning_scan", 8 * (2 + 2 * tiles), dv)
    with torch.cuda.device(dv.device):
        err = cuda_lib.kernels("binning_scan", dv).ed3dgs_fused_bin_scans(
            dv.data_ptr(), dpk.data_ptr(), total.data_ptr(), key.data_ptr(),
            scratch.data_ptr(), K, grid_x, num_tiles, rank_bits, b,
            cuda_lib.stream_of(dv))
    cuda_lib.check_launch(err, "fused_bin_scans")
    cuda_lib.count_launch(fused_bin_scans)
    return key


fused_bin_scans.launches = 0


def boundary_deltas_plain(rows, offsets, *, pair_capacity: int, grid_x: int, b: int):
    """Plain PyTorch version of X2: three torch.cummax scans, each giving
    every row the word of the last valid row before it (the words grow with
    the row index in their high bits), and scatter-adds of the deltas at
    the rows' first slots, slots at or past the capacity dropped."""
    K = pair_capacity
    i32 = torch.int32
    tiles = rows[:, 0]
    valid_t = tiles > 0
    pos = torch.where(valid_t, offsets - tiles, torch.full_like(tiles, K))
    gidx = torch.arange(rows.shape[0], dtype=i32, device=rows.device)
    mask_b = (1 << b) - 1
    minus1 = torch.full((1,), -1, dtype=i32, device=rows.device)

    def prev_of(packed):
        pv = torch.cummax(torch.where(valid_t, packed, torch.full_like(packed, -1)), 0).values
        return torch.cat([minus1, pv[:-1]])

    v = (gidx << b) | (pos & mask_b)
    dv = _scatter_add(K, pos, v - torch.clamp_min(prev_of(v), 0))
    base_g = rows[:, 2] * grid_x + rows[:, 1]
    rw_g = torch.clamp_min(rows[:, 3] - rows[:, 1], 1)
    pk20 = (base_g << 9) | rw_g
    pb = prev_of((gidx << b) | base_g)
    pw = prev_of((gidx << 9) | rw_g)
    zero = torch.zeros_like(pb)
    prev_pk = (torch.where(pb >= 0, (pb & mask_b) << 9, zero)
               | torch.where(pw >= 0, pw & 0x1FF, zero))
    dpk = _scatter_add(K, pos, pk20 - prev_pk)
    return dv, dpk


def boundary_deltas(rows, offsets, *, pair_capacity: int, grid_x: int, b: int) -> tuple:
    """rows: [N, 5] int32, each row's tile count, rect_min and rect_max in
    depth order; offsets: [N] int32, the inclusive scan of the tile counts.
    Returns bin_rows' delta streams dv, dpk ([K] int32 each, K =
    pair_capacity) for `fused_bin_scans`, b its tile-offset bits."""
    N = rows.shape[0]
    if max(N - 1, 0).bit_length() + max(b, 9) > 31:
        raise ValueError(f"{N} rows and {b} offset bits do not pack into an int32 word")
    if not rows.is_cuda:
        return boundary_deltas_plain(rows, offsets, pair_capacity=pair_capacity,
                                     grid_x=grid_x, b=b)
    cuda_lib.check_cuda(rows, "rows", torch.int32, 2)
    cuda_lib.check_cuda(offsets, "offsets", torch.int32, 1)
    if rows.shape[1] != 5 or offsets.shape[0] != N:
        raise ValueError(f"rows must be [N, 5] and offsets [N]; got {tuple(rows.shape)} and "
                         f"{tuple(offsets.shape)}")
    if N == 0:
        out = torch.zeros(2, pair_capacity, dtype=torch.int32, device=rows.device)
        return out[0], out[1]
    # the kernel writes every slot
    out = torch.empty(2, pair_capacity, dtype=torch.int32, device=rows.device)
    # the tile and done counters, then each tile's word: zeroed, and left
    # zeroed by the kernel
    tiles = (N + ROW_TILE - 1) // ROW_TILE
    scratch = cuda_lib.zeroed("boundary_deltas", 8 * (2 + tiles), rows)
    with torch.cuda.device(rows.device):
        err = cuda_lib.kernels("binning_scan", rows).ed3dgs_boundary_deltas(
            rows.data_ptr(), offsets.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            scratch.data_ptr(), N, pair_capacity, grid_x, b, cuda_lib.stream_of(rows))
    cuda_lib.check_launch(err, "boundary_deltas")
    cuda_lib.count_launch(boundary_deltas)
    return out[0], out[1]


boundary_deltas.launches = 0
