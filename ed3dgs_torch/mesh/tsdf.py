"""TSDF fusion of rendered depth maps -> triangle mesh (port of
ed3dgs_tpu/mesh/tsdf.py; the reference mesh_extract_tsdf_fusion.py:31-106).

A dense voxel grid (bounds from the unprojected depths), weighted TSDF and
colour integration, and surface extraction by splitting voxels into
tetrahedra for the marching-tetrahedra module. The grid's fields are tensors
on the caller's device and `integrate` runs there, in the dtypes of the
numpy original: the voxel centres and the projection in float64 (each
product and sum its own operation, so the card and the CPU round them
alike), the weights and colours in float32. `extract_surface` reads the
fields back and runs on the host. For scenes past a few hundred voxels a
side use the block-hashed `mesh/tsdf_sparse.py`.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .marching_tets import marching_tetrahedra

# 6-tet decomposition of a unit cube (corner indices of the 2x2x2 cell)
_CUBE_TETS = np.array([
    [0, 1, 3, 7], [0, 1, 7, 5], [0, 5, 7, 4],
    [0, 3, 2, 7], [0, 2, 6, 7], [0, 6, 4, 7],
])


class TsdfVolume(NamedTuple):
    origin: torch.Tensor     # [3] float64
    voxel_size: float
    dims: tuple              # (nx, ny, nz)
    tsdf: torch.Tensor       # [nx, ny, nz] float32
    weight: torch.Tensor
    color: torch.Tensor      # [nx, ny, nz, 3]


def create_volume(bounds_min, bounds_max, voxel_size, device="cpu") -> TsdfVolume:
    lo = np.asarray(bounds_min, np.float64)
    dims = tuple(int(np.ceil((hi - a) / voxel_size)) + 1 for a, hi in zip(lo, bounds_max))
    f32 = dict(dtype=torch.float32, device=device)
    return TsdfVolume(
        origin=torch.as_tensor(lo, device=device), voxel_size=float(voxel_size),
        dims=dims, tsdf=torch.zeros(dims, **f32), weight=torch.zeros(dims, **f32),
        color=torch.zeros(dims + (3,), **f32))


def rigid_apply(pts: torch.Tensor, m: np.ndarray) -> torch.Tensor:
    """pts [N, 3] float64 @ m[:3, :3].T + m[:3, 3], row by row: each product
    and each sum is its own rounding (no matmul), the same on every device."""
    m = np.asarray(m, np.float64)
    cols = [pts[:, 0] * float(m[r, 0]) + pts[:, 1] * float(m[r, 1])
            + pts[:, 2] * float(m[r, 2]) + float(m[r, 3]) for r in range(3)]
    return torch.stack(cols, 1)


def project_voxels(pts, depth, world_view, focal_x, focal_y, depth_max, trunc):
    """The projective TSDF observation of world points `pts` [N, 3] float64
    in one z-depth map: (ok [N] bool, sdf [N] float64, the pixel rows and
    columns [N], clipped)."""
    h, w = depth.shape
    cam = rigid_apply(pts, world_view)
    z = cam[:, 2]
    zs = torch.clamp_min(z, 1e-8)
    px = cam[:, 0] / zs * focal_x + w / 2.0
    py = cam[:, 1] / zs * focal_y + h / 2.0
    xi = torch.round(px).to(torch.int64)             # ties to even, as np.round
    yi = torch.round(py).to(torch.int64)
    ok = (z > 0.01) & (z < depth_max) & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    xi_c, yi_c = xi.clamp(0, w - 1), yi.clamp(0, h - 1)
    d = depth[yi_c, xi_c]
    sdf = d.double() - z
    ok &= (d > 0) & (sdf > -trunc)
    return ok, sdf, yi_c, xi_c


def voxel_grid(vol: TsdfVolume) -> torch.Tensor:
    """World centres of every voxel, [nx*ny*nz, 3] float64, i-major."""
    nx, ny, nz = vol.dims
    dev = vol.origin.device
    ii, jj, kk = torch.meshgrid(torch.arange(nx, device=dev), torch.arange(ny, device=dev),
                                torch.arange(nz, device=dev), indexing="ij")
    return vol.origin + torch.stack([ii, jj, kk], -1).reshape(-1, 3).double() * vol.voxel_size


def _device_of(x):
    return x.device if torch.is_tensor(x) else torch.device("cpu")


def _as_device(x, device):
    return None if x is None else torch.as_tensor(x, device=device)


def integrate(vol: TsdfVolume, depth, color, world_view: np.ndarray, focal_x: float,
              focal_y: float, depth_max: float = 8.0, trunc_mult: float = 8.0) -> TsdfVolume:
    """Fuse one (masked) z-depth map + colour image into the volume."""
    dev = vol.tsdf.device
    depth, color = _as_device(depth, dev), _as_device(color, dev)
    trunc = trunc_mult * vol.voxel_size
    ok, sdf, yi_c, xi_c = project_voxels(voxel_grid(vol), depth, world_view, focal_x,
                                         focal_y, depth_max, trunc)
    tsdf_new = torch.clamp(sdf / trunc, -1.0, 1.0)                      # float64

    tsdf = vol.tsdf.reshape(-1)
    wgt = vol.weight.reshape(-1)
    col = vol.color.reshape(-1, 3)
    wn = ok.to(torch.float32)
    tot = wgt + wn
    tot_safe = torch.clamp_min(tot, 1e-8)
    tsdf_out = (tsdf * wgt + tsdf_new * wn) / tot_safe                  # float64
    if color is not None:
        col_out = (col * wgt[:, None] + color[yi_c, xi_c] * wn[:, None]) / tot_safe[:, None]
    else:
        col_out = col * wgt[:, None] / tot_safe[:, None]
    return vol._replace(
        tsdf=torch.where(wn > 0, tsdf_out, tsdf.double()).reshape(vol.dims).float(),
        weight=tot.reshape(vol.dims),
        color=torch.where(wn[:, None] > 0, col_out, col).reshape(vol.dims + (3,)).float())


def interpolate_surface(verts, sdf, color, edge_verts, faces):
    """Vertices and colours at the zero crossing of each marched edge
    (host numpy, float64 interpolation) -> (vertices, faces, colours)."""
    if len(faces) == 0:
        e = np.zeros((0, 3), np.float32)
        return e, faces, e
    s0, s1 = sdf[edge_verts[:, 0]], sdf[edge_verts[:, 1]]
    t = (s0 / (s0 - s1))[:, None]
    v0, v1 = verts[edge_verts[:, 0]], verts[edge_verts[:, 1]]
    v = v0 + t * (v1 - v0)
    c = color[edge_verts[:, 0]] + t * (color[edge_verts[:, 1]] - color[edge_verts[:, 0]])
    return v.astype(np.float32), faces, np.clip(c, 0, 1).astype(np.float32)


def extract_surface(vol: TsdfVolume, min_weight: float = 1.0):
    """Zero-crossing surface of the fused TSDF -> (vertices, faces, colours),
    on the host."""
    nx, ny, nz = vol.dims
    verts = voxel_grid(vol).cpu().numpy()

    def vid(i, j, k):
        return (i * ny + j) * nz + k

    ci, cj, ck = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    ci, cj, ck = ci.reshape(-1), cj.reshape(-1), ck.reshape(-1)
    corners = np.stack([vid(ci + (c >> 2 & 1), cj + (c >> 1 & 1), ck + (c & 1))
                        for c in range(8)], axis=1)  # [cells, 8]
    tets = corners[:, _CUBE_TETS].reshape(-1, 4)

    sdf = vol.tsdf.reshape(-1).cpu().numpy().astype(np.float64)
    seen = vol.weight.reshape(-1).cpu().numpy() >= min_weight
    # unobserved voxels are "far outside" so no surface crosses them
    sdf = np.where(seen, sdf, -1.0)
    # drop tets touching unobserved space to avoid hallucinated walls
    tet_ok = seen[tets].all(axis=1)
    edge_verts, faces = marching_tetrahedra(verts, tets[tet_ok], sdf)
    return interpolate_surface(verts, sdf, vol.color.reshape(-1, 3).cpu().numpy(),
                               edge_verts, faces)


def unproject_depth(depth: torch.Tensor, world_view: np.ndarray, focal_x: float,
                    focal_y: float, depth_max: Optional[float] = None) -> torch.Tensor:
    """World points [N, 3] float64 of a depth map's pixels with depth > 0
    (and < depth_max where given), row-major, at pixel centres."""
    h, w = depth.shape
    valid = depth > 0
    if depth_max is not None:
        valid &= depth < depth_max
    ys, xs = torch.nonzero(valid, as_tuple=True)
    z = depth[ys, xs].double()
    x = (xs.double() + 0.5 - w / 2.0) / focal_x * z
    y = (ys.double() + 0.5 - h / 2.0) / focal_y * z
    # np.linalg.inv of the float32 matrix, as the numpy original inverts it
    return rigid_apply(torch.stack([x, y, z], 1), np.linalg.inv(world_view))


def auto_bounds(depths, world_views, focals, voxel_size: float):
    """Bounds of the unprojected depths, padded by two voxels."""
    pts = [unproject_depth(d, wv, fx, fy) for d, wv, (fx, fy)
           in zip(depths, world_views, focals)]
    pts = torch.cat([p for p in pts if len(p)])
    return (pts.amin(0).cpu().numpy() - 2 * voxel_size,
            pts.amax(0).cpu().numpy() + 2 * voxel_size)


def fuse_volume(depths: List, colors: List[Optional[object]], world_views: List[np.ndarray],
                focals, *, voxel_size: float, depth_max: float = 8.0,
                bounds=None) -> TsdfVolume:
    """Auto bounds from the unprojected depths, then every view fused, on the
    first depth map's device (numpy depths: the CPU)."""
    device = _device_of(depths[0])
    depths = [_as_device(d, device) for d in depths]
    lo, hi = auto_bounds(depths, world_views, focals, voxel_size) if bounds is None else bounds
    vol = create_volume(lo, hi, voxel_size, device=device)
    for depth, color, wv, (fx, fy) in zip(depths, colors, world_views, focals):
        vol = integrate(vol, depth, color, wv, fx, fy, depth_max=depth_max)
    return vol


def fuse_depths(depths, colors, world_views, focals, *, voxel_size: float,
                depth_max: float = 8.0, bounds=None):
    """`fuse_volume`, then its surface -> (vertices, faces, colours)."""
    return extract_surface(fuse_volume(depths, colors, world_views, focals,
                                       voxel_size=voxel_size, depth_max=depth_max,
                                       bounds=bounds))
