"""Differentiable rasterizer API (port of ed3dgs_tpu/ops/rasterize.py with its
"pallas" backend).

`rasterize(proj, tongue, bg, cfg)` -> RasterOutputs, differentiable with
respect to every float field of `proj` and `tongue`: depth sort and tile
binning (kernel K4), the per-pair payload gather and the tile blend (K1), the
relayout to [C, H, W] (K5a), then `color + t_final * bg`.

The gradient follows the JAX package's custom_vjp wiring, with no float
scatter-add anywhere (the reference's atomics, and autograd's index backward,
would make it run-dependent):
  * `unpack` (ops/relayout.py): the image cotangent is packed back into
    tiles by K5b;
  * `_ExpandRaster`: the pair gather and K1 as one unit. Its backward runs
    K2 (which writes a row for every pair of every tile, zero outside the
    tile's live chunks), and sums each Gaussian's rows with K3, reading them
    in pre-sort order (where each Gaussian's pairs are contiguous) through
    the inverse of the bijection `pair_perm`;
  * `_PermuteRows`: the depth-order permute, whose backward is the
    inverse-permutation gather.
The port has one backend: the CUDA kernels for CUDA tensors, their plain
PyTorch versions for CPU tensors.

Each stage runs under a `torch.profiler.record_function` span
(ed3dgs.bin / .gather / .blend / .relayout; render() adds ed3dgs.deform and
.project), so a profiler trace attributes device time to the stage; with no
profiler running, a span only enters and leaves a host-side scope.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from .projection import ProjectedGaussians
from .binning import bin_rows, build_gaussian_payload, tile_grid
from .common import RasterOutputs
from .rasterize_plain import MAX_CHUNKS, OUT_CHANNELS, rasterize_backward, rasterize_forward
from .relayout import unpack
from .segment_sum import segment_sum_rows_gathered


@dataclass(frozen=True)
class RasterConfig:
    width: int
    height: int
    focal_x: float
    focal_y: float
    pair_capacity: int = 1 << 20
    chunk: int = 128


def _inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv with inv[perm[i]] = i, for a bijection perm (an integer store of
    distinct targets: exact and deterministic)."""
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


class _PermuteRows(torch.autograd.Function):
    """x[order] for a permutation `order` (the depth sort's); the backward is
    the inverse-permutation gather, not autograd's scatter-add."""

    @staticmethod
    def forward(ctx, x, order):
        ctx.save_for_backward(order)
        return x[order.long()]

    @staticmethod
    def backward(ctx, ct):
        (order,) = ctx.saved_tensors
        return ct[_inverse_permutation(order).long()], None


class _ExpandRaster(torch.autograd.Function):
    """Pair gather + K1, differentiable in the depth-sorted payload rows."""

    @staticmethod
    def forward(ctx, payload_sorted, bins, kw):
        with record_function("ed3dgs.gather"):
            # one row per (tile, gaussian) pair, in tile order
            pair_payload = payload_sorted[bins.pair_gauss.long()]
        with record_function("ed3dgs.blend"):
            packed = rasterize_forward(pair_payload, bins.tile_start, bins.tile_count, **kw)
        ctx.save_for_backward(pair_payload, packed)
        ctx.bins, ctx.kw = bins, kw
        return packed

    @staticmethod
    def backward(ctx, cot):
        pair_payload, packed = ctx.saved_tensors
        return sorted_payload_grad(pair_payload, packed, cot, ctx.bins, ctx.kw), None, None


def sorted_payload_grad(pair_payload, packed, cot, bins, kw) -> torch.Tensor:
    """The gradient of the blend with respect to the depth-sorted payload
    rows [N, 26]: K2, then K3 over its rows un-permuted. K2 writes every row
    of every tile, and the segments K3 sums cover exactly those rows."""
    with record_function("ed3dgs.blend_backward"):
        dpay, _ = rasterize_backward(pair_payload, bins.tile_start, bins.tile_count,
                                     packed, cot.contiguous(), **kw)
    with record_function("ed3dgs.segment_sum"):
        # pre-sort order: slot pair_perm[r] takes sorted row r; K3 reads each
        # slot's row of dpay through the inverse permutation
        return segment_sum_rows_gathered(dpay, _inverse_permutation(bins.pair_perm),
                                         bins.seg_starts, bins.seg_ends)


def rasterize_rows(payload, depth, valid, rect_min, rect_max, tiles_touched, bg,
                   cfg: RasterConfig, *, grid_x: int, grid_y: int, half_w=None,
                   half_h=None) -> RasterOutputs:
    """Rasterize bare splat rows ([N, 26] payload, see build_gaussian_payload)
    over an explicit tile grid. Rays leave from pixel (half_w, half_h), the
    image centre by default; a strip of a larger image (parallel/
    tile_sharded.py) passes the full image's centre in its own rows."""
    with record_function("ed3dgs.bin"):
        bins = bin_rows(depth.detach(), valid, tiles_touched, rect_min, rect_max,
                        grid_x=grid_x, grid_y=grid_y, pair_capacity=cfg.pair_capacity)
    with record_function("ed3dgs.gather"):
        payload_sorted = _PermuteRows.apply(payload, bins.order)
    kw = dict(grid_x=grid_x, grid_y=grid_y, width=cfg.width, height=cfg.height,
              focal_x=cfg.focal_x, focal_y=cfg.focal_y, chunk=cfg.chunk, half_w=half_w,
              half_h=half_h)
    packed = _ExpandRaster.apply(payload_sorted, bins, kw)
    with record_function("ed3dgs.relayout"):
        # padded tile columns hold garbage: slice before any arithmetic
        img = unpack(packed)[:, :cfg.height, :cfg.width]
    ch = {k: img[s] for k, s in OUT_CHANNELS.items()}
    return RasterOutputs(
        color=ch["color"] + ch["t_final"] * bg[:, None, None],
        alpha=ch["weight"],
        expected_coord=ch["coord"],
        median_coord=ch["mcoord"],
        expected_depth=ch["depth"],
        median_depth=ch["mdepth"],
        normal=ch["normal"],
        tongue=ch["tongue"],
        # the blend caps each tile at chunk*512 pairs: surface truncation
        tile_overflow=torch.max(bins.tile_count) > cfg.chunk * MAX_CHUNKS,
    )


def rasterize(proj: ProjectedGaussians, tongue: torch.Tensor, bg: torch.Tensor,
              cfg: RasterConfig) -> RasterOutputs:
    grid_x, grid_y = tile_grid(cfg.width, cfg.height)
    return rasterize_rows(build_gaussian_payload(proj, tongue), proj.depth,
                          proj.valid, proj.rect_min, proj.rect_max,
                          proj.tiles_touched, bg, cfg, grid_x=grid_x, grid_y=grid_y)
