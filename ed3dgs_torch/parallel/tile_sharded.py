"""The strip exchange: Gaussian-sharded projection in, strip-sharded blend
(port of ed3dgs_tpu/parallel/tile_sharded.py).

The image's tile rows are split into horizontal strips, one per rank of the
mesh's "gauss" axis, and each rank blends only its own strip:

  1. every rank holds its shard of the projected Gaussians (deformation and
     projection need no communication along the Gaussian axis);
  2. for each destination strip it packs the payload rows of its splats
     whose tile rect meets that strip into a fixed-capacity send buffer
     (`_PackForStrips`). The packing bins the splats with `bin_rows`, the
     strip as the "tile" (kernel K4 runs its scan), so each destination's
     buffer holds its shallowest splats first and an overflow drops the
     deepest, reported in `send_overflow`; unlike the JAX package's, the
     pack's pair budget grows with the capacity, so a grown capacity stops
     the dropping;
  3. ONE `all_to_all` over the gauss group swaps the [g, cap, 31] buffers;
  4. each rank re-bins the received splats into its strip's tiles (the
     depth sort of the merged set restores the global front-to-back order)
     and blends them with `rasterize_rows` in strip-local pixels: K4, K1 and
     K5a forward, K5b, K2 and K3 backward, as on one device. The strip keeps
     the full image's ray origin (half_w, half_h);
  5. the strips are gathered over the gauss group into the whole image on
     every rank (the loss is replicated there, and SSIM's windows cross the
     strips' edges), and the padded bottom rows are cropped.

The gradient goes back the same way: the strip gather's backward keeps this
rank's strip of the cotangent, the exchange's is the reverse all_to_all,
and the pack's is kernel K3 over the pack's own pair CSR (no float
scatter-add, so the gradient is deterministic, as everywhere in the port).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from ..ops.binning import PAYLOAD_SLICES, bin_rows, build_gaussian_payload, tile_grid
from ..ops.common import TILE, RasterOutputs
from ..ops.rasterize import RasterConfig, _inverse_permutation, rasterize_rows
from ..ops.segment_sum import segment_sum_rows_gathered
from . import comm
from .mesh import Mesh

EXTRA = 5            # depth, rect_min (x, y), rect_max (x, y) beside the payload
_CHANNELS = tuple(f for f in RasterOutputs._fields if f != "tile_overflow")


def strip_rows_for(cfg: RasterConfig, num_strips: int) -> int:
    """Tile rows per strip (the image's tile grid split along y)."""
    _, grid_y = tile_grid(cfg.width, cfg.height)
    return -(-grid_y // num_strips)


def _pack_pair_capacity(n: int, g: int, cap: int) -> int:
    """The pack's pair budget: the JAX package's max(2n, 64g), raised to
    g * cap, every pair the send buffers can hold, and rounded up to a
    multiple of 128 so that K4 carries the pack's scans. (The JAX budget
    does not grow with the capacity, so there a shard whose splats meet more
    than max(2n, 64g) strips keeps dropping its deepest pairs however large
    the capacity grows: ROADMAP.md, Queue 3.)"""
    return -(-max(2 * n, g * 64, g * cap) // 128) * 128


class _PackForStrips(torch.autograd.Function):
    """[n, 26] payload and [n, 5] depth/rect rows -> [g * cap, 31] send
    buffers, destination-major, rows past a destination's count zero.
    Differentiable in the payload; the backward sums each splat's rows of
    the cotangent with K3 over the pack's pair CSR."""

    @staticmethod
    def forward(ctx, payload, extra, bins, cap: int, g: int):
        K = bins.pair_gauss.shape[0]
        j = torch.arange(cap, dtype=torch.int32, device=payload.device)
        slots = torch.clamp(bins.tile_start[:, None] + j[None, :], 0, K - 1)
        in_range = j[None, :] < torch.clamp_max(bins.tile_count, cap)[:, None]
        src = bins.order[bins.pair_gauss[slots].long()].long()          # [g, cap]
        rows = torch.cat([payload, extra], dim=1)
        bufs = torch.where(in_range[..., None], rows[src], torch.zeros((), device=rows.device))
        ctx.bins, ctx.cap, ctx.g = bins, cap, g
        return bufs.reshape(g * cap, rows.shape[1])

    @staticmethod
    def backward(ctx, ct):
        bins, cap, g = ctx.bins, ctx.cap, ctx.g
        F = ct.shape[1] - EXTRA
        # sorted pair p of strip t sits at slot j = p - tile_start[t] of t's buffer
        p = torch.arange(bins.pair_tile.shape[0], dtype=torch.int32, device=ct.device)
        t = bins.pair_tile
        live = t < g
        tt = torch.clamp_max(t, g - 1).long()
        jj = p - bins.tile_start[tt]
        idx = torch.where(live & (jj < cap), tt * cap + jj, torch.full_like(jj, g * cap))
        ct_rows = torch.cat([ct[:, :F], torch.zeros((1, F), dtype=ct.dtype, device=ct.device)])
        # K3: per depth rank, its pre-sort pair slots, read through the
        # inverse pair permutation, as the blend's backward reads K2's rows
        by_rank = segment_sum_rows_gathered(ct_rows.contiguous(),
                                            (idx.long()[_inverse_permutation(bins.pair_perm).long()]
                                             ).to(torch.int32),
                                            bins.seg_starts, bins.seg_ends)
        return by_rank[_inverse_permutation(bins.order).long()], None, None, None, None


def _pack_for_strips(payload, extra, depth, valid, ry0, ry1, g: int, strip_rows: int,
                     cap: int):
    """Send buffers [g * cap, 31] and the demand to report: the largest
    per-destination count, or the pack's whole pair demand where that
    passed the pack's pair budget (then some pairs were dropped)."""
    n = payload.shape[0]
    d0 = torch.clamp(torch.div(ry0, strip_rows, rounding_mode="floor"), 0, g)
    d1 = torch.clamp(-torch.div(-ry1, strip_rows, rounding_mode="floor"), 0, g)
    nd = torch.where(valid, torch.clamp_min(d1 - d0, 0), torch.zeros_like(d0)).to(torch.int32)
    zeros = torch.zeros_like(d0)
    k = _pack_pair_capacity(n, g, cap)
    bins = bin_rows(depth, valid & (nd > 0), nd, torch.stack([zeros, d0], 1),
                    torch.stack([zeros + 1, d1], 1), grid_x=1, grid_y=g, pair_capacity=k)
    bufs = _PackForStrips.apply(payload, extra, bins, cap, g)
    counts = torch.maximum(bins.tile_count,
                           torch.where(bins.num_pairs > k, bins.num_pairs,
                                       torch.zeros_like(bins.num_pairs)))
    return bufs, torch.max(counts)


def _gather_strips(out: RasterOutputs, mesh: Mesh, height: int) -> RasterOutputs:
    """The whole image on every rank of the gauss group, cropped to `height`."""
    sizes = [getattr(out, f).shape[0] for f in _CHANNELS]
    strip = torch.cat([getattr(out, f) for f in _CHANNELS]).transpose(0, 1).contiguous()
    full = comm.all_gather_rows(strip, mesh, "gauss", "strip_image")   # [G*Hs, 16, W]
    chans = torch.split(full.transpose(0, 1)[:, :height], sizes)
    return RasterOutputs(*chans, tile_overflow=out.tile_overflow)


def _strip_raster(payload, depth, valid, rect_min, rect_max, bg, *, cfg: RasterConfig,
                  mesh: Mesh, grid_x: int, strip_rows: int, cap: int):
    """One camera on one rank: pack -> all_to_all -> strip-local re-bin and
    blend -> the gathered image. Returns (RasterOutputs, this rank's send
    demand, its strip's tile overflow)."""
    F = payload.shape[1]
    g, my = mesh.size("gauss"), mesh.index("gauss")
    depth = depth.detach()
    extra = torch.cat([depth[:, None], rect_min.to(torch.float32),
                       rect_max.to(torch.float32)], dim=1)
    send, demand = _pack_for_strips(payload, extra, depth, valid, rect_min[:, 1],
                                    rect_max[:, 1], g, strip_rows, cap)
    recv = comm.all_to_all(send, mesh, "gauss", "payload")
    r_payload = recv[:, :F]
    r_depth = recv[:, F].detach()
    r_rmin = recv[:, F + 1:F + 3].detach().to(torch.int32)
    r_rmax = recv[:, F + 3:F + 5].detach().to(torch.int32)

    # strip-local rects; buffer rows never written (zeros) get no tiles
    y0t = my * strip_rows
    lmin_y = torch.clamp(r_rmin[:, 1] - y0t, 0, strip_rows)
    lmax_y = torch.clamp(r_rmax[:, 1] - y0t, 0, strip_rows)
    tiles = (r_rmax[:, 0] - r_rmin[:, 0]) * (lmax_y - lmin_y)
    lrect_min = torch.stack([r_rmin[:, 0], lmin_y], 1)
    lrect_max = torch.stack([r_rmax[:, 0], lmax_y], 1)

    # mean2d to strip-local pixels; rays keep the full image's origin. The
    # shift's one-hot is made on the device: a captured step copies nothing
    # from the host
    y0p = float(y0t * TILE)
    shift = (torch.arange(F, device=payload.device)
             == PAYLOAD_SLICES["mean2d"].start + 1).to(torch.float32)
    r_payload = r_payload - shift * y0p
    out = rasterize_rows(r_payload, r_depth, tiles > 0, lrect_min, lrect_max, tiles, bg,
                         replace(cfg, height=strip_rows * TILE), grid_x=grid_x,
                         grid_y=strip_rows, half_w=cfg.width / 2.0,
                         half_h=cfg.height / 2.0 - y0p)
    return _gather_strips(out, mesh, cfg.height), demand, out.tile_overflow


def _default_capacity(n: int) -> int:
    # the JAX package's max(64, ceil(2N / g)) for the global N = g * n
    return max(64, 2 * n)


def tile_sharded_rasterize(proj, tongue: torch.Tensor, bg: torch.Tensor, cfg: RasterConfig,
                           mesh: Mesh, *, send_capacity: int | None = None):
    """rasterize() of one camera over the mesh's gauss axis. `proj` and
    `tongue` are this rank's rows. Returns (RasterOutputs, overflow): the
    whole [C, H, W] image on every rank of the gauss group, and the largest
    per-(source, destination) splat demand over the group; past
    `send_capacity` the deepest splats were dropped, and the caller should
    render again with a larger capacity (the contract of
    BinnedPairs.num_pairs)."""
    grid_x, _ = tile_grid(cfg.width, cfg.height)
    n = proj.depth.shape[0]
    cap = _default_capacity(n) if send_capacity is None else send_capacity
    out, demand, tile_ovf = _strip_raster(
        build_gaussian_payload(proj, tongue), proj.depth, proj.valid & (proj.tiles_touched > 0),
        proj.rect_min, proj.rect_max, bg, cfg=cfg, mesh=mesh, grid_x=grid_x,
        strip_rows=strip_rows_for(cfg, mesh.size("gauss")), cap=cap)
    stats = comm.all_reduce_(torch.stack([demand.to(torch.int32), tile_ovf.to(torch.int32)]),
                             mesh, "gauss", "max", "metric")
    return out._replace(tile_overflow=stats[1] > 0), stats[0]


def batched_strip_rasterize(payload_b, depth_b, valid_b, rect_min_b, rect_max_b,
                            bg: torch.Tensor, cfg: RasterConfig, mesh: Mesh, *,
                            send_capacity: int | None = None):
    """The strip exchange for this rank's cameras of a batch ([B_local, n,
    ...] rows of its Gaussian shard, payloads as build_gaussian_payload
    gives them): one exchange a camera, in turn (the JAX package's
    `lax.map` over the local cameras). Returns (RasterOutputs [B_local, C,
    H, W], overflow), the overflow and tile overflow reduced over the whole
    mesh, as tile_sharded_rasterize reports them."""
    grid_x, _ = tile_grid(cfg.width, cfg.height)
    n = payload_b.shape[1]
    cap = _default_capacity(n) if send_capacity is None else send_capacity
    strip_rows = strip_rows_for(cfg, mesh.size("gauss"))
    outs, demands, tile_ovfs = [], [], []
    for b in range(payload_b.shape[0]):
        out, demand, tile_ovf = _strip_raster(
            payload_b[b], depth_b[b], valid_b[b], rect_min_b[b], rect_max_b[b], bg, cfg=cfg,
            mesh=mesh, grid_x=grid_x, strip_rows=strip_rows, cap=cap)
        outs.append(out)
        demands.append(demand.to(torch.int32))
        tile_ovfs.append(tile_ovf.to(torch.int32))
    stats = comm.all_reduce_(torch.stack([torch.stack(demands).max(),
                                          torch.stack(tile_ovfs).max()]),
                             mesh, "world", "max", "metric")
    out = RasterOutputs(*(torch.stack([getattr(o, f) for o in outs]) for f in _CHANNELS),
                        tile_overflow=stats[1] > 0)
    return out, stats[0]
