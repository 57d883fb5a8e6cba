"""Tile binning: (Gaussian, tile) pair expansion + sort (port of
ed3dgs_tpu/ops/binning.py).

Static shapes, as in the JAX package: depth-sort the Gaussians once (stable,
invalid to the back), scan tiles_touched, invert the pair mapping over a
fixed [K] pair buffer, stable-sort one packed (tile << rank_bits | rank) key,
and find per-tile ranges with searchsorted. Pairs are generated in depth
order, so the stable sort keeps each tile's list depth-ordered.

Capacity overflow (more real pairs than `pair_capacity`) drops the deepest
pairs and reports the true count in `num_pairs`.

The sorts and searchsorted are library calls standing in for XLA's sort and
search, not for Pallas kernels; the scans run in kernel K4
(ops/binning_scan.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import ProjectedGaussians
from .binning_scan import fused_bin_scans
from .common import TILE


class BinnedPairs(NamedTuple):
    order: torch.Tensor       # [N] int32 gaussian index by depth rank
    pair_gauss: torch.Tensor  # [K] int32: sorted-order gaussian rank per pair
    pair_tile: torch.Tensor   # [K] int32 tile id per pair (T = sentinel/padding)
    pair_perm: torch.Tensor   # [K] int32: pre-sort slot of each sorted pair
    seg_starts: torch.Tensor  # [N] int32: gaussian-rank CSR over pre-sort slots
    seg_ends: torch.Tensor    # [N] int32 (clamped to K; empty for 0-tile rows)
    tile_start: torch.Tensor  # [T] int32 start offset into the pair list
    tile_count: torch.Tensor  # [T] int32 number of pairs per tile
    num_pairs: torch.Tensor   # [] int32 true number of pairs (may exceed K)
    grid: tuple               # (grid_x, grid_y)


def tile_grid(width: int, height: int) -> tuple:
    return ((width + TILE - 1) // TILE, (height + TILE - 1) // TILE)


def bin_gaussians(proj: ProjectedGaussians, *, width: int, height: int,
                  pair_capacity: int) -> BinnedPairs:
    grid_x, grid_y = tile_grid(width, height)
    return bin_rows(proj.depth, proj.valid, proj.tiles_touched,
                    proj.rect_min, proj.rect_max,
                    grid_x=grid_x, grid_y=grid_y, pair_capacity=pair_capacity)


def _scatter_add(K: int, pos: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """zeros([K]).at[pos].add(vals, mode="drop"): positions >= K land in one
    extra slot that is cut off."""
    buf = torch.zeros(K + 1, dtype=torch.int32, device=vals.device)
    buf.index_add_(0, torch.clamp_max(pos, K).to(torch.int64), vals.to(torch.int32))
    return buf[:K]


def _scatter_max(K: int, fill: int, pos: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """full([K], fill).at[pos].max(vals, mode="drop")."""
    buf = torch.full((K + 1,), fill, dtype=torch.int32, device=vals.device)
    buf.scatter_reduce_(0, torch.clamp_max(pos, K).to(torch.int64),
                        vals.to(torch.int32), reduce="amax")
    return buf[:K]


def _cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0).to(torch.int32)


def _cummax32(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def bin_rows(depth, valid, tiles_touched, rect_min, rect_max, *,
             grid_x: int, grid_y: int, pair_capacity: int) -> BinnedPairs:
    """bin_gaussians over bare per-splat arrays and an explicit tile grid.
    The rects must be clamped to [0, grid) and agree with tiles_touched."""
    num_tiles = grid_x * grid_y
    N = depth.shape[0]
    K = pair_capacity
    dev = depth.device
    i32 = torch.int32
    if not (grid_x <= 511 and grid_y < 2048):
        raise ValueError("image too large for the packed tile-rect word")

    sort_key = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    order = torch.sort(sort_key, stable=True).indices

    stacked = torch.cat([tiles_touched.to(i32)[:, None], rect_min.to(i32),
                         rect_max.to(i32)], dim=1)[order]   # [N, 5]
    order = order.to(i32)
    tiles_sorted = stacked[:, 0]
    offsets = _cumsum32(tiles_sorted)           # inclusive scan
    total = offsets[-1]
    excl = offsets - tiles_sorted

    gidx = torch.arange(N, dtype=i32, device=dev)
    kfill = torch.full_like(excl, K)
    pos = torch.where(tiles_sorted > 0, excl, kfill)   # zero-tile rows dropped
    pos_end = torch.where(tiles_sorted > 0, offsets, kfill)
    p = torch.arange(K, dtype=i32, device=dev)

    rmin = stacked[:, 1:3]
    rmax = stacked[:, 3:5]
    rw_g = torch.clamp_min(rmax[:, 0] - rmin[:, 0], 1)

    rank_bits = max(17, (N - 1).bit_length())
    single_key = num_tiles + 1 <= (1 << (31 - rank_bits))
    seg_bits = num_tiles.bit_length()   # tiles/gaussian <= num_tiles < 2^b
    if single_key and K % 128 == 0 and rank_bits + max(seg_bits, 9) <= 31:
        # delta-encoded path: segments are contiguous over [0, total), so
        # each per-slot word is the cumsum of per-boundary deltas (the
        # previous boundary's word comes from a cummax over the monotone
        # high bits); kernel K4 runs both cumsums + decode + key pack
        valid_t = tiles_sorted > 0
        mask_b = (1 << seg_bits) - 1
        minus1 = torch.full((1,), -1, dtype=i32, device=dev)

        def prev_of(packed):
            pv = _cummax32(torch.where(valid_t, packed, torch.full_like(packed, -1)))
            return torch.cat([minus1, pv[:-1]])

        v = (gidx << seg_bits) | (pos & mask_b)
        dv = _scatter_add(K, pos, v - torch.clamp_min(prev_of(v), 0))
        base_g = rmin[:, 1] * grid_x + rmin[:, 0]
        pk20 = (base_g << 9) | rw_g
        pb = prev_of((gidx << seg_bits) | base_g)
        pw = prev_of((gidx << 9) | rw_g)
        zero = torch.zeros_like(pb)
        prev_pk = (torch.where(pb >= 0, (pb & mask_b) << 9, zero)
                   | torch.where(pw >= 0, pw & 0x1FF, zero))
        dpk = _scatter_add(K, pos, pk20 - prev_pk)
        packed_key = fused_bin_scans(dv, dpk, total, grid_x=grid_x,
                                     num_tiles=num_tiles, rank_bits=rank_bits,
                                     b=seg_bits)
        key_sorted, perm = torch.sort(packed_key, stable=True)
        tile_sorted = key_sorted >> rank_bits
        rank_sorted = key_sorted & ((1 << rank_bits) - 1)
    else:
        # cummax-fill path, for shapes the delta-encoded path refuses
        starts = _scatter_max(K, -1, pos, gidx)
        sstart = _scatter_max(K, 0, pos, pos)
        rank_c = torch.clamp_min(_cummax32(starts), 0)
        seg_start = _cummax32(sstart)
        k = p - seg_start
        # boxcar rect reconstruction: +packed at each first slot, -packed one
        # past the last, inclusive cumsum telescopes to the owner's word
        packed_g = rmin[:, 0] | (rmin[:, 1] << 11) | (rw_g << 22)
        pk = _cumsum32(_scatter_add(K, torch.cat([pos, pos_end]),
                                    torch.cat([packed_g, -packed_g])))
        rw = torch.clamp_min((pk >> 22) & 0x1FF, 1)
        ti = (pk & 0x7FF) + torch.remainder(k, rw)
        tj = ((pk >> 11) & 0x7FF) + torch.div(k, rw, rounding_mode="floor")
        tile_id = torch.where(p < total, tj * grid_x + ti,
                              torch.full_like(p, num_tiles))
        if single_key:
            key_sorted, perm = torch.sort((tile_id << rank_bits) | rank_c, stable=True)
            tile_sorted = key_sorted >> rank_bits
            rank_sorted = key_sorted & ((1 << rank_bits) - 1)
        else:  # huge scenes: sort the tile id alone, ranks ride along
            tile_sorted, perm = torch.sort(tile_id, stable=True)
            rank_sorted = rank_c[perm]

    # per-tile ranges (identifyTileRanges): num_tiles+1 binary searches
    bounds = torch.searchsorted(
        tile_sorted, torch.arange(num_tiles + 1, dtype=i32, device=dev)).to(i32)
    return BinnedPairs(
        order=order,
        pair_gauss=rank_sorted,
        pair_tile=tile_sorted,
        pair_perm=perm.to(i32),
        seg_starts=torch.clamp_max(excl, K),
        seg_ends=torch.clamp_max(offsets, K),
        tile_start=bounds[:num_tiles],
        tile_count=bounds[1:] - bounds[:-1],
        num_pairs=total,
        grid=(grid_x, grid_y),
    )


# Payload layout of the flat per-pair feature rows read by the blend kernel.
PAYLOAD_FIELDS = (
    ("mean2d", 2), ("conic", 3), ("opacity", 1), ("rgb", 3), ("tongue", 1),
    ("view_point", 3), ("camera_planes", 6), ("ray_plane", 2), ("ts", 1),
    ("normal", 3),
)
PAYLOAD_DIM = sum(d for _, d in PAYLOAD_FIELDS)  # 25
ONES_COL = PAYLOAD_DIM  # constant-1 column: sum(w) accumulates like a channel
PAYLOAD_WIDTH = PAYLOAD_DIM + 1  # 26; the TPU's 128-lane padding is not kept


def payload_slices():
    out, off = {}, 0
    for name, d in PAYLOAD_FIELDS:
        out[name] = slice(off, off + d)
        off += d
    return out


PAYLOAD_SLICES = payload_slices()


def build_gaussian_payload(proj: ProjectedGaussians, tongue: torch.Tensor) -> torch.Tensor:
    """Per-gaussian feature rows [N, 26] in original gaussian order (the JAX
    package's `build_gaussian_payload(pad=False)`)."""
    cols = [
        proj.mean2d,
        proj.conic,
        proj.opacity[:, None],
        proj.rgb,
        tongue.reshape(-1, 1),
        proj.view_point,
        proj.camera_planes,
        proj.ray_plane,
        proj.ts[:, None],
        proj.normal,
        torch.ones_like(proj.ts[:, None]),  # ONES_COL
    ]
    return torch.cat([c.to(torch.float32) for c in cols], dim=-1).contiguous()
