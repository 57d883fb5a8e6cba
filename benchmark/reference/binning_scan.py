"""Fused pair-slot scan for tile binning: kernel K4 (port of
ed3dgs_tpu/ops/binning_scan.py, `fused_bin_scans`).

bin_rows delta-encodes two per-slot words over the [K] pair buffer; their
inclusive prefix sums give, per pair slot p,

  v  = (rank << b) | (seg_start mod 2^b)    (owning gaussian rank, first slot)
  pk = (tile_base << 9) | rect_w            (owner's tile rect)

and the decode packs the sort key `tile << rank_bits | rank`, where the tile
is the k-th of the owner's rect in row-major order, k = (p - v) mod 2^b.
Slots at or past `total` get tile `num_tiles`.

Frozen copy of the plain version (`fused_bin_scans_plain`), on any device.
"""

from __future__ import annotations

import torch

SCAN_TILE = 4096   # slots per CTA (256 threads x 16); see csrc


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
    """dv, dpk: [K] int32 delta streams; total: 0-d int32 tensor. Returns
    the packed sort key [K] int32."""
    if dv.shape[0] % 128:
        raise ValueError(f"pair capacity {dv.shape[0]} must be a multiple of 128")
    return fused_bin_scans_plain(dv, dpk, total, grid_x=grid_x, num_tiles=num_tiles,
                                 rank_bits=rank_bits, b=b)
