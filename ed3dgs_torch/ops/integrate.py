"""Opacity integration at query 3D points (mesh-extraction support; port of
ed3dgs_tpu/ops/integrate.py).

The counterpart of the reference integrate path (forward.cu:1028-1543,
rasterizer_impl.cu:580-851): for every query point, blend the depth-sorted
Gaussians of the point's pixel tile using the 3D ray-space inverse
covariance, producing the accumulated opacity integral `alpha_integrated`
along the point's camera ray (plus the pixel's colour, the SDF to the median
Gaussian's depth plane and the projection metadata). No Pallas kernel stands
behind it in the JAX package; the tiles are binned by `bin_gaussians`, whose
scans run in kernel K4 on the card.

Pass 1 is the reference's 5-subpixel-corner prefilter (forward.cu:1233-1287):
it walks the point's tile list evaluating the 2D conic alpha at the pixel
centre and the four half-pixel corners, each with its own transmittance that
only updates while `T*(1-alpha) >= 1e-4`; a splat is "used" if any of the five
updates. That recurrence is data-dependent (a skipped splat leaves T as it
was), so it is a walk over the tile slots. The JAX package scans each chunk
of points over all `max_per_tile` slots; here one walk takes every point at
once, with [P, 5] state tensors, and stops after the largest slot count among
the tiles the valid points fall in (a slot past its tile's count changes
nothing, and an invalid point's outputs are zeroed), so eager PyTorch
launches ~30 small kernels a slot instead of a loop per chunk. Pass 2 blends
the used splats with the 3D ray-space alpha at the point's exact position
(forward.cu:1455-1487), in chunks of points whose [chunk, slots] gathers fit
in memory, with the exclusive transmittance formed as the JAX package forms
it, `cumprod(1 - a) / (1 - a)`.

Degenerate covariances: see core/projection.py `compute_invraycov`; the
`well_conditioned` gating of the blend (forward.cu:1472-1480) is the
reference's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.projection import RayProjectedGaussians
from .binning import bin_gaussians
from .common import ALPHA_MAX, ALPHA_MIN, TILE

# pass 2 gathers [chunk, slots] rows: the chunk is sized to this many
# (point, slot) elements
PASS2_ELEMENTS = 1 << 23


class IntegrateOutputs(NamedTuple):
    alpha_integrated: torch.Tensor   # [P] accumulated alpha along the point ray
    color_integrated: torch.Tensor   # [P, 3] blended RGB of the point's pixel
    point_coordinate: torch.Tensor   # [P, 2] pixel coordinates
    point_depth: torch.Tensor        # [P] camera distance
    point_sdf: torch.Tensor          # [P] median-gaussian depth - point depth
    point_valid: torch.Tensor        # [P] in frustum and on screen


def project_points(points3d, *, viewmatrix, width, height, focal_x, focal_y):
    """preprocessPointsCUDA (forward.cu:1028-1071)."""
    V = viewmatrix.to(torch.float32)
    p_view = points3d @ V[:3, :3].T + V[:3, 3]
    z = p_view[:, 2]
    in_front = z > 0.2
    zs = z + 1e-7
    px = focal_x * p_view[:, 0] / zs + width / 2.0
    py = focal_y * p_view[:, 1] / zs + height / 2.0
    on_screen = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    depth = torch.sqrt(torch.sum(p_view * p_view, dim=-1))
    return torch.stack([px, py], -1), depth, in_front & on_screen


def _tile_of(point_xy, grid_x: int, grid_y: int) -> torch.Tensor:
    """The 16x16 tile of each point's pixel, clipped to the grid. The
    coordinate is bounded before its integer cast, so an off-screen point
    saturates instead of wrapping; on-screen points are unaffected."""
    pix = torch.floor(torch.clamp(point_xy, -(1 << 24), 1 << 24)).to(torch.int32)
    tx = torch.clamp(torch.div(pix[:, 0], TILE, rounding_mode="floor"), 0, grid_x - 1)
    ty = torch.clamp(torch.div(pix[:, 1], TILE, rounding_mode="floor"), 0, grid_y - 1)
    return (tx + grid_x * ty).long()


def integrate_points(
    proj: RayProjectedGaussians,
    points3d: torch.Tensor,
    *,
    viewmatrix: torch.Tensor,
    width: int,
    height: int,
    focal_x: float,
    focal_y: float,
    pair_capacity: int = 1 << 20,
    max_per_tile: int = 1024,
    bg: Optional[torch.Tensor] = None,
) -> IntegrateOutputs:
    """proj must be built with compute_invraycov=True.

    `bg` composites into color_integrated (forward.cu:1527: C + T*bg per
    channel); defaults to black like the reference's mesh tools."""
    assert hasattr(proj, "invraycov"), "project with compute_invraycov=True"
    dev = points3d.device
    f32 = dict(dtype=torch.float32, device=dev)
    bins = bin_gaussians(proj, width=width, height=height, pair_capacity=pair_capacity)
    grid_x, grid_y = bins.grid

    point_xy, point_depth, point_valid = project_points(
        points3d, viewmatrix=viewmatrix, width=width, height=height,
        focal_x=focal_x, focal_y=focal_y)
    tile = _tile_of(point_xy, grid_x, grid_y)

    # per-gaussian fields in depth-rank order, packed for one gather a slot:
    # pass 1 reads xy 0:2, opacity 2, conic 3:6, rgb 6:9, ts 9, ray plane 10:12
    order = bins.order.long()
    table1 = torch.cat([proj.mean2d, proj.opacity[:, None], proj.conic, proj.rgb,
                        proj.ts[:, None], proj.ray_plane], dim=1)[order].to(torch.float32)
    # pass 2 reads xy 0:2, opacity 2, ts 3, ray plane 4:6, invraycov 6:12
    table2 = torch.cat([proj.mean2d, proj.opacity[:, None], proj.ts[:, None],
                        proj.ray_plane, proj.invraycov], dim=1)[order].to(torch.float32)
    g_well = proj.well_conditioned[order]
    if bg is None:
        bg = torch.zeros(3, **f32)

    L = max_per_tile
    count = torch.clamp_max(bins.tile_count, L)
    P = points3d.shape[0]
    count_p = count[tile]                                    # [P]
    # the walk's length: the largest slot count a valid point's tile has
    L_eff = int(torch.max(torch.where(point_valid, count_p, torch.zeros_like(count_p)))) \
        if P else 0
    slot = torch.arange(max(L_eff, 1), dtype=torch.int64, device=dev)
    slots = torch.clamp(bins.tile_start.long()[:, None] + slot[None, :], 0,
                        bins.pair_gauss.shape[0] - 1)
    tile_ranks = bins.pair_gauss.long()[slots]               # [T, L_eff]

    # ---- pass 1: 5-corner pixel prefilter (forward.cu:1233-1287) ----------
    # pixel-center subpixel offsets (forward.cu:1191-1193)
    off_x = torch.tensor([0.0, -0.5, 0.5, -0.5, 0.5], **f32)
    off_y = torch.tensor([0.0, -0.5, -0.5, 0.5, 0.5], **f32)
    pixf = torch.floor(point_xy) + 0.5                        # [P, 2]
    cx = pixf[:, 0:1] + off_x                                 # [P, 5]
    cy = pixf[:, 1:2] + off_y
    T = torch.ones((P, 5), **f32)
    C = torch.zeros((P, 3), **f32)
    mid_ts = torch.zeros((P,), **f32)
    mid_rp = torch.zeros((P, 2), **f32)
    mid_xy = torch.zeros((P, 2), **f32)
    used = torch.zeros((L_eff, P), dtype=torch.bool, device=dev)
    zero = torch.zeros((), **f32)
    for s in range(L_eff):
        f = table1[tile_ranks[:, s][tile]]                   # [P, 12]
        live = (s < count_p)[:, None]
        cdx = f[:, 0:1] - cx
        cdy = f[:, 1:2] - cy
        cpow = (-0.5 * (f[:, 3:4] * cdx * cdx + f[:, 5:6] * cdy * cdy)
                - f[:, 4:5] * cdx * cdy)
        calpha = torch.clamp_max(f[:, 2:3] * torch.exp(cpow), ALPHA_MAX)
        cpass = live & (cpow <= 0.0) & (calpha >= ALPHA_MIN)
        # the centre corner also runs the reference's pixel blend
        # (forward.cu:1264-1283): C += rgb*a*T, and the median gaussian (the
        # last centre-updating splat with pre-update T > 0.5), whose depth
        # plane defines point_sdf (forward.cu:1530-1535)
        test = T * (1.0 - calpha)
        upd = cpass & (test >= 1e-4)
        upd0 = upd[:, 0:1]
        C = C + torch.where(upd0, f[:, 6:9] * (calpha[:, 0:1] * T[:, 0:1]), zero)
        take_mid = upd0 & (T[:, 0:1] > 0.5)
        mid_ts = torch.where(take_mid[:, 0], f[:, 9], mid_ts)
        mid_rp = torch.where(take_mid, f[:, 10:12], mid_rp)
        mid_xy = torch.where(take_mid, f[:, 0:2], mid_xy)
        T = torch.where(upd, test, T)
        used[s] = torch.any(upd, dim=1)
    color = C + T[:, 0:1] * bg[None, :]
    d_mid = mid_xy - point_xy                                 # exact point position
    sdf = (mid_ts + mid_rp[:, 0] * d_mid[:, 0] + mid_rp[:, 1] * d_mid[:, 1]) - point_depth

    # ---- pass 2: 3D ray-space blend of used splats (:1455-1487) -----------
    alpha_integrated = torch.zeros((P,), **f32)
    chunk = max(1, PASS2_ELEMENTS // max(L_eff, 1))
    for c0 in range(0, P if L_eff else 0, chunk):
        ranks = tile_ranks[tile[c0:c0 + chunk]]               # [pc, L_eff]
        g = table2[ranks]                                     # [pc, L_eff, 12]
        well = g_well[ranks]
        pxy = point_xy[c0:c0 + chunk, None, :]
        pd = point_depth[c0:c0 + chunk, None]
        d0 = g[..., 0] - pxy[..., 0]
        d1 = g[..., 1] - pxy[..., 1]
        ts = g[..., 3]
        depth = ts + g[..., 4] * d0 + g[..., 5] * d1
        dz = torch.where(well, ts - torch.minimum(pd, depth), ts)
        icr = g[..., 6:12]
        power = -0.5 * (
            icr[..., 0] * d0 ** 2 + icr[..., 3] * d1 ** 2 + icr[..., 5] * dz ** 2
            + 2.0 * (icr[..., 1] * d0 * d1 + icr[..., 2] * d0 * dz + icr[..., 4] * d1 * dz))
        alpha = torch.clamp_max(g[..., 2] * torch.exp(power), ALPHA_MAX)
        alpha = torch.where(~well & (pd < depth), zero, alpha)
        passes = used[:, c0:c0 + chunk].T & (alpha >= ALPHA_MIN)
        a = torch.where(passes, alpha, zero)
        om = 1.0 - a
        p_excl = torch.cumprod(om, dim=1) / om
        alpha_integrated[c0:c0 + chunk] = torch.sum(a * p_excl, dim=1)

    alpha_integrated = torch.where(point_valid, alpha_integrated, zero)
    color_integrated = torch.where(point_valid[:, None], color, zero)
    # the reference writes sdf only for projected points with positive depth
    # (forward.cu:1530-1535); others keep the buffer's initial value 0
    point_sdf = torch.where(point_valid & (point_depth > 0), sdf, zero)
    return IntegrateOutputs(alpha_integrated, color_integrated, point_xy,
                            point_depth, point_sdf, point_valid)


def sample_mask_bilinear(mask: torch.Tensor, point_xy: torch.Tensor) -> torch.Tensor:
    """grid_sample(align_corners=False, zeros padding) of a [1, H, W] mask at
    pixel coordinates, matching evaluage_cull_alpha's validity test
    (mesh_extract_tetrahedra.py:46-57: normalized coords (2*px+1)/(W-1)-1 then
    torch grid_sample align_corners=False => source pixel coordinate
    ((x+1)*W-1)/2)."""
    H, W = mask.shape[-2], mask.shape[-1]
    gx = (point_xy[:, 0] * 2.0 + 1.0) / (W - 1) - 1.0
    gy = (point_xy[:, 1] * 2.0 + 1.0) / (H - 1) - 1.0
    sx = ((gx + 1.0) * W - 1.0) / 2.0
    sy = ((gy + 1.0) * H - 1.0) / 2.0
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    flat = mask.reshape(H, W)

    def fetch(xi, yi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xi_c = torch.clamp(xi, 0, W - 1).long()
        yi_c = torch.clamp(yi, 0, H - 1).long()
        return torch.where(inb, flat[yi_c, xi_c], torch.zeros((), dtype=flat.dtype,
                                                               device=flat.device))

    return ((1 - fx) * (1 - fy) * fetch(x0, y0)
            + fx * (1 - fy) * fetch(x0 + 1, y0)
            + (1 - fx) * fy * fetch(x0, y0 + 1)
            + fx * fy * fetch(x0 + 1, y0 + 1))
