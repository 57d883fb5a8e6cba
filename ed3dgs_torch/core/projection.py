"""Per-Gaussian projection: EWA splatting + RaDe-GS geometry (port of
ed3dgs_tpu/core/projection.py).

The counterpart of the reference preprocess kernel (forward.cu:307-545 with
computeCov2D :77-264), elementwise over the Gaussian axis: frustum validity,
pixel-space center, the 2D covariance with the mip-splatting low-pass and its
opacity compensation, inverse conic, radius and 16x16 tile rectangle, the
RaDe-GS camera planes, ray plane and splat normal, and SH -> RGB.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .camera_math import ndc_to_pixel
from .quaternion import build_covariance_3d, sym3_congruence, sym3_matvec
from .sh import sh_to_rgb
from .sym3 import sym3_pseudo_inverse_min

TILE = 16  # BLOCK_X = BLOCK_Y (reference config.h:16-17)
NEAR_PLANE = 0.2
ALPHA_MIN = 1.0 / 255.0  # blend skip threshold; must match ops.common.ALPHA_MIN


class ProjectedGaussians(NamedTuple):
    """Per-Gaussian screen-space payload (all [N, ...], float32 unless noted)."""

    valid: torch.Tensor          # [N] bool: survives culling, nonzero extent
    mean2d: torch.Tensor         # [N, 2] pixel-space center
    depth: torch.Tensor          # [N] view-space z (sort key)
    view_point: torch.Tensor     # [N, 3] view-space position
    conic: torch.Tensor          # [N, 3] inverse 2D covariance (a, b, c)
    opacity: torch.Tensor        # [N] opacity * low-pass compensation coef
    radius: torch.Tensor         # [N] int32 screen-space radius (pixels)
    rect_min: torch.Tensor       # [N, 2] int32 tile rect (x, y) inclusive start
    rect_max: torch.Tensor       # [N, 2] int32 tile rect exclusive end
    tiles_touched: torch.Tensor  # [N] int32
    camera_planes: torch.Tensor  # [N, 6] d(cam xyz)/d(pixel xy)
    ray_plane: torch.Tensor      # [N, 2] d(ray depth)/d(pixel xy)
    normal: torch.Tensor         # [N, 3] camera-space splat normal
    ts: torch.Tensor             # [N] distance camera->gaussian
    rgb: torch.Tensor            # [N, 3] SH-evaluated color
    cov3d: torch.Tensor          # [N, 6] packed world covariance


# The integrate path's projection (`compute_invraycov=True`): every field of
# ProjectedGaussians, then the ray-space inverse covariance [N, 6] and
# whether the world covariance was well conditioned [N] bool.
RayProjectedGaussians = NamedTuple("RayProjectedGaussians", [
    *ProjectedGaussians.__annotations__.items(),
    ("invraycov", torch.Tensor), ("well_conditioned", torch.Tensor)])


def _where0(mask, x):
    return torch.where(mask, x, torch.zeros_like(x))


def _tile_index(x: torch.Tensor, hi: int) -> torch.Tensor:
    """clip(int32(x), 0, hi) with int32's truncation toward zero; the float
    is bounded first so out-of-range values saturate instead of wrapping."""
    return torch.clamp(x, -1.0, hi + 1.0).to(torch.int32).clamp(0, hi)


def project_gaussians(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    shs: Optional[torch.Tensor],
    *,
    viewmatrix: torch.Tensor,
    projmatrix: torch.Tensor,
    campos: torch.Tensor,
    width: int,
    height: int,
    tan_fovx: float,
    tan_fovy: float,
    focal_x: float,
    focal_y: float,
    kernel_size: float = 0.0,
    sh_degree: int = 3,
    colors_precomp: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    mean2d_offset: Optional[torch.Tensor] = None,
    compute_invraycov: bool = False,
) -> ProjectedGaussians:
    """Project N Gaussians into one camera. means3d [N,3], scales [N,3]
    (activated), quats [N,4] (unit), opacities [N], shs [N,K,3].

    `compute_invraycov` returns a RayProjectedGaussians instead, with the
    integrate path's ray-space inverse covariance `invraycov` [N, 6] and
    `well_conditioned` [N] (whether the world covariance's smallest
    eigenvalue cleared the pseudo-inverse's threshold; ops/integrate.py)."""
    f32 = torch.float32
    means3d = means3d.to(f32)
    V = viewmatrix.to(f32)
    P = projmatrix.to(f32)
    R_cw = V[:3, :3]

    # --- view transform + frustum cull (forward.cu:350-358)
    p_view = means3d @ R_cw.T + V[:3, 3]
    in_frustum = p_view[:, 2] > NEAR_PLANE

    p_hom = means3d @ P[:3, :3].T + P[:3, 3]
    w_hom = means3d @ P[3, :3] + P[3, 3]
    p_w = 1.0 / (w_hom + 1e-7)
    p_proj = p_hom * p_w[:, None]

    cov3d = build_covariance_3d(scales, quats)

    # --- EWA 2D covariance with the fov-clamped view point (forward.cu:85-118)
    tz = p_view[:, 2]
    safe_tz = torch.where(torch.abs(tz) > 1e-8, tz, torch.full_like(tz, 1e-8))
    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    u = torch.clamp(p_view[:, 0] / safe_tz, -limx, limx)
    v = torch.clamp(p_view[:, 1] / safe_tz, -limy, limy)
    tx, ty = u * tz, v * tz

    Sigma_cam = sym3_congruence(R_cw, cov3d)
    inv_tz = 1.0 / safe_tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz * inv_tz
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz * inv_tz
    s00, s01, s02 = Sigma_cam[:, 0], Sigma_cam[:, 1], Sigma_cam[:, 2]
    s11, s12, s22 = Sigma_cam[:, 3], Sigma_cam[:, 4], Sigma_cam[:, 5]
    c00 = j00 * j00 * s00 + 2.0 * j00 * j02 * s02 + j02 * j02 * s22
    c01 = j00 * j11 * s01 + j00 * j12 * s02 + j02 * j11 * s12 + j02 * j12 * s22
    c11 = j11 * j11 * s11 + 2.0 * j11 * j12 * s12 + j12 * j12 * s22

    det0 = torch.clamp_min(c00 * c11 - c01 * c01, 1e-6)
    ck00, ck11 = c00 + kernel_size, c11 + kernel_size
    det1 = torch.clamp_min(ck00 * ck11 - c01 * c01, 1e-6)
    coef = torch.sqrt(det0 / (det1 + 1e-6) + 1e-6)
    coef = torch.where((det0 <= 1e-6) | (det1 <= 1e-6), torch.zeros_like(coef), coef)

    # --- conic + radius + tile rect (forward.cu:384-403)
    det = ck00 * ck11 - c01 * c01
    nonzero_det = det != 0.0
    det_inv = 1.0 / torch.where(nonzero_det, det, torch.ones_like(det))
    conic = torch.stack([ck11 * det_inv, -c01 * det_inv, ck00 * det_inv], dim=-1)
    mid = 0.5 * (ck00 + ck11)
    lam_max = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam_max))
    mean2d = torch.stack([ndc_to_pixel(p_proj[:, 0], width),
                          ndc_to_pixel(p_proj[:, 1], height)], dim=-1)
    if mean2d_offset is not None:
        mean2d = mean2d + mean2d_offset
    grid_x = (width + TILE - 1) // TILE
    grid_y = (height + TILE - 1) // TILE
    # tile rect = axis-aligned bbox of the exact level set {alpha >= 1/255}:
    # q(d) <= cmax = ln(255 * op_eff), half-extents sqrt(2*cmax*Sigma_ii)
    op_eff = opacities.to(f32) * coef
    cmax = torch.log(torch.clamp_min(op_eff, 1e-12) * (1.0 / ALPHA_MIN))
    safe_c = 2.0 * torch.clamp_min(cmax, 0.0)
    ex = torch.sqrt(safe_c * torch.clamp_min(ck00, 0.0)) * (1.0 + 1e-6) + 0.3
    ey = torch.sqrt(safe_c * torch.clamp_min(ck11, 0.0)) * (1.0 + 1e-6) + 0.3
    rmin_x = _tile_index((mean2d[:, 0] - ex) / TILE, grid_x)
    rmin_y = _tile_index((mean2d[:, 1] - ey) / TILE, grid_y)
    rmax_x = _tile_index((mean2d[:, 0] + ex + TILE - 1) / TILE, grid_x)
    rmax_y = _tile_index((mean2d[:, 1] + ey + TILE - 1) / TILE, grid_y)
    tiles = (rmax_x - rmin_x) * (rmax_y - rmin_y)
    tiles = torch.where(cmax > 0.0, tiles, torch.zeros_like(tiles))

    valid = in_frustum & nonzero_det & (tiles > 0)
    if mask is not None:
        valid = valid & mask
    radius_i = _where0(valid, radius).to(torch.int32)
    tiles = _where0(valid, tiles)

    # --- RaDe-GS plane/normal geometry (forward.cu:135-262)
    sigma_inv, well = sym3_pseudo_inverse_min(cov3d)
    cov_cam_inv = sym3_congruence(R_cw, sigma_inv)
    ones = torch.ones_like(u)
    uvh = torch.stack([u, v, ones], dim=-1)
    uvh_m = torch.stack(sym3_matvec(cov_cam_inv, u, v, ones), dim=-1)
    uvh_sq = torch.sum(uvh_m * uvh_m, dim=-1, keepdim=True)
    geom_ok = (uvh_sq[:, 0] > 1e-30) & torch.isfinite(uvh_sq[:, 0])
    uvh_norm = torch.sqrt(torch.where(uvh_sq > 1e-30, uvh_sq, torch.ones_like(uvh_sq)))
    uvh_mn = uvh_m / uvh_norm

    u2, v2, uv = u * u, v * v, u * v
    nl = u2 + v2 + 1.0
    # safe-where: a gaussian exactly at the camera center has l == 0
    l2 = tx * tx + ty * ty + tz * tz
    l_ok = l2 > 1e-16
    l = torch.where(l_ok, torch.sqrt(torch.where(l_ok, l2, torch.ones_like(l2))),
                    torch.ones_like(l2))
    vbn = torch.clamp_min(torch.sum(uvh_mn * uvh, dim=-1), 1e-7)
    pv = uvh_mn / vbn[:, None]
    plane0 = (v2 + 1.0) * pv[:, 0] - uv * pv[:, 1] - u * pv[:, 2]
    plane1 = -uv * pv[:, 0] + (u2 + 1.0) * pv[:, 1] - v * pv[:, 2]

    inv_nl = 1.0 / nl
    cp = torch.stack([
        (-(v2 + 1.0) * tz + plane0 * tx) * inv_nl / focal_x,
        (uv * tz + plane1 * tx) * inv_nl / focal_y,
        (uv * tz + plane0 * ty) * inv_nl / focal_x,
        (-(u2 + 1.0) * tz + plane1 * ty) * inv_nl / focal_y,
        (tx + plane0 * tz) * inv_nl / focal_x,
        (ty + plane1 * tz) * inv_nl / focal_y,
    ], dim=-1)
    ray_plane = torch.stack([plane0 * l * inv_nl / focal_x,
                             plane1 * l * inv_nl / focal_y], dim=-1)
    factor_normal = l * inv_nl
    rn0, rn1, rn2 = -plane0 * factor_normal, -plane1 * factor_normal, -1.0
    cn0 = rn0 * inv_tz + rn2 * tx / l
    cn1 = rn1 * inv_tz + rn2 * ty / l
    cn2 = -rn0 * tx * inv_tz * inv_tz - rn1 * ty * inv_tz * inv_tz + rn2 * tz / l
    cn = torch.stack([cn0, cn1, cn2], dim=-1)
    cn_sq = torch.sum(cn * cn, dim=-1, keepdim=True)
    cn_norm = torch.sqrt(torch.where(cn_sq > 1e-30, cn_sq, torch.ones_like(cn_sq)))
    normal = cn / cn_norm

    geom_mask = geom_ok[:, None]
    cp = _where0(geom_mask, cp)
    ray_plane = _where0(geom_mask, ray_plane)
    normal = _where0(geom_mask, normal)

    ts2 = torch.sum(p_view * p_view, dim=-1)
    ts_ok = ts2 > 1e-16
    ts = _where0(ts_ok, torch.sqrt(torch.where(ts_ok, ts2, torch.ones_like(ts2))))

    if compute_invraycov:
        # integrate path (forward.cu:187-234): the 3D inverse covariance in
        # (pixel-x, pixel-y, ray-depth) space,
        #   invraycov = S . nJif . Sigma_cam^-1 . nJif^T . S,
        # with nJif the full inverse ray Jacobian and S = diag(1/fx, 1/fy, 1).
        # For an ill-conditioned covariance the reference writes an
        # uninitialised matrix (forward.cu:201-235); as in the JAX package,
        # the same closed form runs on the pseudo-inverse instead, which is
        # deterministic, and `well_conditioned` gates the blend.
        fac = tz * inv_nl
        nJif = torch.stack([
            torch.stack([(v2 + 1.0) * fac, -uv * fac, -u * fac], -1),
            torch.stack([-uv * fac, (u2 + 1.0) * fac, -v * fac], -1),
            torch.stack([u * tz / l, v * tz / l, tz / l], -1),
        ], dim=-2)  # [N, 3, 3]
        xx, xy, xz, yy, yz, zz = cov_cam_inv.unbind(-1)
        sig = torch.stack([torch.stack([xx, xy, xz], -1), torch.stack([xy, yy, yz], -1),
                           torch.stack([xz, yz, zz], -1)], dim=-2)
        icr = torch.einsum("nij,njk,nlk->nil", nJif, sig, nJif)
        sdiag = torch.tensor([1.0 / focal_x, 1.0 / focal_y, 1.0], dtype=f32,
                             device=icr.device)
        icr = icr * sdiag[None, :, None] * sdiag[None, None, :]
        invraycov = torch.stack([icr[:, 0, 0], icr[:, 0, 1], icr[:, 0, 2],
                                 icr[:, 1, 1], icr[:, 1, 2], icr[:, 2, 2]], dim=-1)

    if colors_precomp is not None:
        rgb = colors_precomp.to(f32)
    else:
        rgb = sh_to_rgb(sh_degree, shs.to(f32), means3d, campos.to(f32))

    proj = ProjectedGaussians(
        valid=valid,
        mean2d=mean2d,
        depth=p_view[:, 2],
        view_point=p_view,
        conic=conic,
        opacity=opacities.to(f32) * coef,
        radius=radius_i,
        rect_min=torch.stack([rmin_x, rmin_y], dim=-1),
        rect_max=torch.stack([rmax_x, rmax_y], dim=-1),
        tiles_touched=tiles,
        camera_planes=cp,
        ray_plane=ray_plane,
        normal=normal,
        ts=ts,
        rgb=rgb,
        cov3d=cov3d,
    )
    if compute_invraycov:
        return RayProjectedGaussians(*proj, invraycov, well)
    return proj
