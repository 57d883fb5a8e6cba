"""Deform -> activate -> project -> blend for one camera: a frozen copy of
ed3dgs_torch/render/__init__.py (`project_for_render`, `render`,
`assemble_outputs`) on one device, over the plain blend."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from . import gaussians as gm
from .deformation import deform_forward
from .projection import project_gaussians
from .rasterize import RasterConfig, rasterize


class RenderSettings(NamedTuple):
    """Per-camera inputs."""

    viewmatrix: torch.Tensor   # [4,4]
    projmatrix: torch.Tensor   # [4,4]
    campos: torch.Tensor       # [3]
    time: torch.Tensor         # scalar
    cam_no: Optional[torch.Tensor] = None  # scalar int, or None (eval)


def project_for_render(
    params: gm.GaussianParams,
    aux: gm.GaussianAux,
    deform_params,
    hidden_cfg,
    settings: RenderSettings,
    raster_cfg: RasterConfig,
    *,
    iteration=0,
    sh_degree: int = 3,
    kernel_size: float = 0.0,
    disable_filter3d: bool = True,
    num_down_emb_c: int = 30,
    num_down_emb_f: int = 30,
    tongue_filter: Optional[str] = None,  # None | "only" | "without"
    mean2d_offset: Optional[torch.Tensor] = None,
    active_sh_degree=None,
):
    """Deform -> activate -> project one camera. Returns
    (proj, shs_f, xyz_f, extras). `mean2d_offset` [N, 2] is added to the
    pixel-space centres: the trainer passes zeros and reads their gradient,
    the screen-space gradient that densification accumulates."""
    shs = gm.get_features(params)
    with record_function("ed3dgs.deform"):
        (xyz_f, scales_f, rot_f, opac_f, shs_f), extras = deform_forward(
            deform_params, hidden_cfg,
            params.xyz, params.scaling, params.rotation, params.opacity, shs,
            params.embedding, settings.time, iteration, cam_no=settings.cam_no,
            num_down_emb_c=num_down_emb_c, num_down_emb_f=num_down_emb_f,
        )
    with record_function("ed3dgs.project"):
        # safe normalize: dead slots may carry zero quaternions
        rot_sq = torch.sum(rot_f * rot_f, dim=-1, keepdim=True)
        rot_act = rot_f / torch.sqrt(torch.where(rot_sq < 1e-24, torch.ones_like(rot_sq), rot_sq))

        if active_sh_degree is not None:
            # oneupSHdegree (gaussian_model.py:146-148): zeroing the bands above
            # the active degree is exactly truncated SH evaluation; the
            # coefficients of bands 0..d are the first (d + 1)^2
            keep = torch.arange(shs_f.shape[1], device=shs_f.device) < (active_sh_degree + 1) ** 2
            shs_f = shs_f * keep.to(shs_f.dtype)[None, :, None]
        if disable_filter3d:
            scales_act = torch.exp(scales_f)
            opac_act = torch.sigmoid(opac_f)
        else:
            scales_act, opac_act = gm.apply_3d_filter(opac_f, scales_f, aux.filter_3d)

        mask = aux.alive
        if tongue_filter == "only":
            mask = mask & (torch.round(aux.tongue_class[:, 0]) > 0.5)
        elif tongue_filter == "without":
            mask = mask & ~(torch.round(aux.tongue_class[:, 0]) > 0.5)

        proj = project_gaussians(
            xyz_f, scales_act, rot_act, opac_act[:, 0], shs_f,
            viewmatrix=settings.viewmatrix, projmatrix=settings.projmatrix,
            campos=settings.campos, width=raster_cfg.width, height=raster_cfg.height,
            tan_fovx=raster_cfg.width / (2.0 * raster_cfg.focal_x),
            tan_fovy=raster_cfg.height / (2.0 * raster_cfg.focal_y),
            focal_x=raster_cfg.focal_x, focal_y=raster_cfg.focal_y,
            kernel_size=kernel_size, sh_degree=sh_degree, mask=mask,
            mean2d_offset=mean2d_offset,
        )
    return proj, shs_f, xyz_f, extras


def render(
    params: gm.GaussianParams,
    aux: gm.GaussianAux,
    deform_params,
    hidden_cfg,
    settings: RenderSettings,
    raster_cfg: RasterConfig,
    bg: torch.Tensor,
    *,
    iteration=0,
    sh_degree: int = 3,
    kernel_size: float = 0.0,
    disable_filter3d: bool = True,
    num_down_emb_c: int = 30,
    num_down_emb_f: int = 30,
    tongue_filter: Optional[str] = None,  # None | "only" | "without"
    mean2d_offset: Optional[torch.Tensor] = None,
    active_sh_degree=None,
) -> dict:
    """One render (reference gaussian_renderer.render :8-142); tongue_filter
    rasterizes only the (non-)tongue subset of the deformed cloud."""
    proj, shs_f, xyz_f, extras = project_for_render(
        params, aux, deform_params, hidden_cfg, settings, raster_cfg,
        iteration=iteration, sh_degree=sh_degree, kernel_size=kernel_size,
        disable_filter3d=disable_filter3d,
        num_down_emb_c=num_down_emb_c, num_down_emb_f=num_down_emb_f,
        tongue_filter=tongue_filter, mean2d_offset=mean2d_offset,
        active_sh_degree=active_sh_degree)
    out = rasterize(proj, aux.tongue_class[:, 0], bg, raster_cfg)
    return assemble_outputs(out, proj, shs_f, xyz_f, extras)


def assemble_outputs(out, proj, shs_f, xyz_f, extras, send_overflow=None):
    """RasterOutputs + projection residues -> the reference's output dict."""
    return {
        "render": out.color,
        # true (tile, gaussian) pair demand of this view, for sizing
        # pair_capacity
        "num_pairs": torch.sum(torch.where(proj.valid, proj.tiles_touched,
                                           torch.zeros_like(proj.tiles_touched)),
                               dtype=torch.int32),
        # the strip exchange's largest per-(source, destination) splat demand
        # (render with a mesh); None on one device
        "send_overflow": send_overflow,
        "tile_overflow": out.tile_overflow,
        "mask": out.alpha,
        "expected_coord": out.expected_coord,
        "median_coord": out.median_coord,
        "expected_depth": out.expected_depth,
        "median_depth": out.median_depth,
        "viewspace_points": proj.mean2d,
        "visibility_filter": proj.radius > 0,
        "radii": proj.radius,
        "normal": out.normal,
        "sh_coefs_final": shs_f,
        "extras": extras,
        "deformed_gaussian_positions": xyz_f,
        "tongue_mask": out.tongue,
    }
