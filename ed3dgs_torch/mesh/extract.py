"""Tetrahedra mesh extraction orchestration, GOF-style (port of
ed3dgs_tpu/mesh/extract.py).

Reference parity: mesh_extract_tetrahedra.py:22-186 — per timestep:
deform -> 3D-filtered scales -> tetra points -> Delaunay -> multi-view
integrated-alpha SDF (0.5 - min over views, mask-culled) -> marching
tetrahedra -> binary search along crossing edges -> distance/scale face
filter -> ply export.

The deformation, projection, alpha-mask renders (K1, K4, K5a on the card)
and the opacity integration (ops/integrate.py, K4 for its binning) run on
the parameters' device; the tetrahedra, the Delaunay triangulation and the
marching run on the host. One difference from the JAX package, which
renders the masks with its "xla" backend at `max_per_tile=1024`: the port
has one backend, whose tiles hold up to `chunk * 512` pairs (65,536 at the
default chunk), so a tile with more than 1024 pairs keeps them all here
(tests/test_torch_mesh.py).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..config.params import DeformHiddenConfig
from ..core.projection import project_gaussians
from ..data.ply import write_mesh_ply
from ..models import gaussians as gm
from ..models.deformation import deform_forward
from ..ops.integrate import integrate_points, sample_mask_bilinear
from ..ops.rasterize import RasterConfig, rasterize
from .marching_tets import marching_tetrahedra
from .tetra import delaunay_tets, get_tetra_points


def deformed_gaussians(params, aux, dparams, hidden: DeformHiddenConfig,
                       timestep: float, num_down_emb: int, loaded_iter: int):
    """Deform the cloud at a timestep with eval-mode offsets and apply the
    fused 3D filter (mesh_extract_tetrahedra.py:68-86)."""
    shs = gm.get_features(params)
    (xyz, scales_raw, rot_raw, opac_raw, shs_f), _ = deform_forward(
        dparams, hidden, params.xyz, params.scaling, params.rotation,
        params.opacity, shs, params.embedding, timestep, loaded_iter,
        cam_no=None, num_down_emb_c=num_down_emb, num_down_emb_f=num_down_emb)
    scales_f, opac_f = gm.apply_3d_filter(opac_raw, scales_raw, aux.filter_3d)
    return xyz, scales_f, rot_raw, opac_f, shs_f


def evaluate_sdf(points: np.ndarray, views, render_alpha_fn, integrate_fn):
    """0.5 - min over views of integrated alpha, with rendered-mask culling
    (evaluage_cull_alpha, mesh_extract_tetrahedra.py:38-62). Points never seen
    by a valid pixel get SDF -100 (outside)."""
    P = points.shape[0]
    final = np.ones(P, np.float32)
    weight = np.zeros(P, np.int32)
    for view in views:
        out = integrate_fn(points, view)
        alpha = out.alpha_integrated.cpu().numpy()
        mask_img = render_alpha_fn(view)          # [1, H, W] tensor
        prob = sample_mask_bilinear(mask_img, out.point_coordinate).cpu().numpy()
        valid = (prob > 0.5) & out.point_valid.cpu().numpy()
        final = np.where(valid, np.minimum(alpha, final), final)
        weight = np.where(valid, weight + 1, weight)
    return np.where(weight > 0, 0.5 - final, -100.0).astype(np.float32)


def extract_mesh_at_timestep(
    params, aux, dparams, hidden: DeformHiddenConfig, views,
    *,
    timestep: float,
    width: int, height: int, focal_x: float, focal_y: float,
    kernel_size: float = 0.0,
    num_down_emb: int = 30,
    loaded_iter: int = 10 ** 9,
    n_binary_steps: int = 8,
    pair_capacity: int = 1 << 20,
    max_per_tile: int = 1024,
    sh_degree: int = 3,
    stats: Optional[dict] = None,
):
    """Full extraction for one timestep; returns (vertices, faces).
    `max_per_tile` bounds the integration's walk. With `stats`, it
    fills in the tetra point count, the tetrahedra, the SDF evaluations
    (each one integration and one mask render per view), the views, and the
    seconds of the Delaunay triangulation, of the SDF evaluations and of the
    whole."""
    t_start = time.perf_counter()
    dev = params.xyz.device
    with torch.no_grad():
        xyz, scales_f, rot_raw, opac_f, shs_f = deformed_gaussians(
            params, aux, dparams, hidden, timestep, num_down_emb, loaded_iter)
    alive = aux.alive.cpu().numpy()
    xyz_np = xyz.cpu().numpy()[alive]
    scales_np = scales_f.cpu().numpy()[alive]
    rot_np = rot_raw.cpu().numpy()[alive]

    points, point_scales = get_tetra_points(xyz_np, rot_np, scales_np, device=dev)
    t0 = time.perf_counter()
    tets = delaunay_tets(points)
    t_delaunay = time.perf_counter() - t0

    # per-view projection (gaussians deformed once per timestep)
    rot_sq = torch.sum(rot_raw * rot_raw, dim=-1, keepdim=True)
    rot_act = rot_raw / torch.sqrt(torch.where(rot_sq < 1e-24, torch.ones_like(rot_sq), rot_sq))
    f32 = dict(dtype=torch.float32, device=dev)

    def proj_for(view):
        m = view.matrices()
        with torch.no_grad():
            return project_gaussians(
                xyz, scales_f, rot_act, opac_f[:, 0], shs_f,
                viewmatrix=torch.as_tensor(m.world_view, **f32),
                projmatrix=torch.as_tensor(m.full_proj, **f32),
                campos=torch.as_tensor(m.campos, **f32), width=width, height=height,
                tan_fovx=m.tan_fovx, tan_fovy=m.tan_fovy,
                focal_x=m.focal_x, focal_y=m.focal_y, kernel_size=kernel_size,
                sh_degree=sh_degree, mask=aux.alive,
                compute_invraycov=True), m

    proj_cache = {}

    def get_proj(view):
        key = id(view)
        if key not in proj_cache:
            proj_cache[key] = proj_for(view)
        return proj_cache[key]

    def render_alpha_fn(view):
        proj, m = get_proj(view)
        cfg = RasterConfig(width=width, height=height, focal_x=m.focal_x,
                           focal_y=m.focal_y, pair_capacity=pair_capacity)
        with torch.no_grad():
            alpha = rasterize(proj, aux.tongue_class[:, 0], torch.zeros(3, **f32), cfg).alpha
        gt_mask = view.alpha_mask
        if gt_mask is not None:
            alpha = alpha * torch.as_tensor(np.asarray(gt_mask), **f32)
        return alpha

    def integrate_fn(pts, view):
        proj, m = get_proj(view)
        with torch.no_grad():
            return integrate_points(
                proj, torch.as_tensor(pts, **f32),
                viewmatrix=torch.as_tensor(m.world_view, **f32),
                width=width, height=height, focal_x=m.focal_x, focal_y=m.focal_y,
                pair_capacity=pair_capacity, max_per_tile=max_per_tile)

    t0 = time.perf_counter()
    sdf = evaluate_sdf(points, views, render_alpha_fn, integrate_fn)
    t_sdf = time.perf_counter() - t0
    evaluations = 1
    edge_verts, faces = marching_tetrahedra(points, tets, sdf)
    if len(faces) == 0:
        vertices, faces = np.zeros((0, 3), np.float32), faces
    else:
        left = points[edge_verts[:, 0]].copy()
        right = points[edge_verts[:, 1]].copy()
        left_sdf = sdf[edge_verts[:, 0]].copy()
        right_sdf = sdf[edge_verts[:, 1]].copy()
        left_scale = point_scales[edge_verts[:, 0], 0]
        right_scale = point_scales[edge_verts[:, 1], 0]
        distance = np.linalg.norm(left - right, axis=1)
        scale = left_scale + right_scale

        for _ in range(n_binary_steps):
            mid = (left + right) / 2.0
            t0 = time.perf_counter()
            mid_sdf = evaluate_sdf(mid, views, render_alpha_fn, integrate_fn)
            t_sdf += time.perf_counter() - t0
            evaluations += 1
            low = ((mid_sdf < 0) & (left_sdf < 0)) | ((mid_sdf > 0) & (left_sdf > 0))
            left_sdf = np.where(low, mid_sdf, left_sdf)
            right_sdf = np.where(low, right_sdf, mid_sdf)
            left = np.where(low[:, None], mid, left)
            right = np.where(low[:, None], right, mid)
        vertices = (left + right) / 2.0

        # distance/scale face filter (mesh_extract_tetrahedra.py:132-139)
        vert_ok = distance <= scale
        face_ok = vert_ok[faces].all(axis=1)
        faces = faces[face_ok]
        used = np.unique(faces)
        remap = np.full(len(vertices), -1, np.int64)
        remap[used] = np.arange(len(used))
        vertices, faces = vertices[used].astype(np.float32), remap[faces]
    if stats is not None:
        stats.update(tetra_points=int(len(points)), tets=int(len(tets)),
                     sdf_evaluations=evaluations, views=len(views),
                     delaunay_s=t_delaunay, sdf_s=t_sdf,
                     total_s=time.perf_counter() - t_start)
    return vertices, faces


def export_mesh(path: str, vertices: np.ndarray, faces: np.ndarray):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_mesh_ply(path, vertices, faces)
