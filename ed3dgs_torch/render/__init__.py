"""High-level renderer: deform -> activate -> project -> blend (port of
ed3dgs_tpu/render/__init__.py).

API parity with the reference gaussian_renderer.render / render_tongue /
render_without_tongue (gaussian_renderer/__init__.py:8-431): returns the same
output dictionary keys. Everything runs on the device of the parameters.
With `mesh`, one camera is rendered by the ranks of the mesh's gauss axis
together, through the strip exchange (parallel/tile_sharded.py).

The deformation and the projection are the tracer's stages "deform" and
"project" (utils/trace.py): stamped on the card inside an open region (the
train step, a frame), a profiler scope "ed3dgs.deform" / ".project" while a
profiler runs.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config.params import DeformHiddenConfig
from ..core.projection import project_gaussians
from ..data.cameras import CameraMatrices
from ..device import resolve_device
from ..models import gaussians as gm
from ..models.deformation import deform_forward
from ..ops.rasterize import RasterConfig, rasterize
from ..parallel import comm
from ..parallel.tile_sharded import tile_sharded_rasterize
from ..utils import trace


class RenderSettings(NamedTuple):
    """Per-camera inputs."""

    viewmatrix: torch.Tensor   # [4,4]
    projmatrix: torch.Tensor   # [4,4]
    campos: torch.Tensor       # [3]
    time: torch.Tensor         # scalar
    cam_no: Optional[torch.Tensor] = None  # scalar int, or None (eval)


def settings_from_camera(cam: CameraMatrices, time=0.0, cam_no=None,
                         device="cuda") -> RenderSettings:
    dev = resolve_device(device)
    return RenderSettings(
        viewmatrix=torch.as_tensor(cam.world_view, device=dev),
        projmatrix=torch.as_tensor(cam.full_proj, device=dev),
        campos=torch.as_tensor(cam.campos, device=dev),
        time=torch.tensor(time, dtype=torch.float32, device=dev),
        cam_no=None if cam_no is None else torch.tensor(cam_no, dtype=torch.int64,
                                                         device=dev),
    )


def raster_config_from_camera(cam: CameraMatrices, **kw) -> RasterConfig:
    return RasterConfig(width=cam.width, height=cam.height,
                        focal_x=cam.focal_x, focal_y=cam.focal_y, **kw)


def project_for_render(
    params: gm.GaussianParams,
    aux: gm.GaussianAux,
    deform_params,
    hidden_cfg: DeformHiddenConfig,
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
    with trace.stage("deform"):
        (xyz_f, scales_f, rot_f, opac_f, shs_f), extras = deform_forward(
            deform_params, hidden_cfg,
            params.xyz, params.scaling, params.rotation, params.opacity, shs,
            params.embedding, settings.time, iteration, cam_no=settings.cam_no,
            num_down_emb_c=num_down_emb_c, num_down_emb_f=num_down_emb_f,
        )
    with trace.stage("project"):
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
    hidden_cfg: DeformHiddenConfig,
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
    mesh=None,
    send_capacity: Optional[int] = None,
) -> dict:
    """One render (reference gaussian_renderer.render :8-142). tongue_filter
    implements render_tongue / render_without_tongue (:145-431): the whole
    cloud is deformed, then only the (non-)tongue subset is rasterized.

    mesh: a parallel.mesh.Mesh. params and aux are then this rank's rows of
    the gauss shard; the camera is rendered by the gauss group together
    (tile_sharded_rasterize), every rank gets the whole image, and
    "send_overflow" holds the largest per-(source, destination) splat
    demand: past `send_capacity` (default max(64, 2 * local rows)) the
    deepest splats were dropped. "num_pairs" is the whole view's demand."""
    proj, shs_f, xyz_f, extras = project_for_render(
        params, aux, deform_params, hidden_cfg, settings, raster_cfg,
        iteration=iteration, sh_degree=sh_degree, kernel_size=kernel_size,
        disable_filter3d=disable_filter3d,
        num_down_emb_c=num_down_emb_c, num_down_emb_f=num_down_emb_f,
        tongue_filter=tongue_filter, mean2d_offset=mean2d_offset,
        active_sh_degree=active_sh_degree)
    if mesh is None:
        out = rasterize(proj, aux.tongue_class[:, 0], bg, raster_cfg)
        return assemble_outputs(out, proj, shs_f, xyz_f, extras)
    out, send_overflow = tile_sharded_rasterize(proj, aux.tongue_class[:, 0], bg, raster_cfg,
                                                mesh, send_capacity=send_capacity)
    r = assemble_outputs(out, proj, shs_f, xyz_f, extras, send_overflow)
    comm.all_reduce_(r["num_pairs"], mesh, "gauss", "sum", "metric")
    return r


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
