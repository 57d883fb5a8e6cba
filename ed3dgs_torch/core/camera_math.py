"""Camera matrix construction and depth->normal geometry (port of
ed3dgs_tpu/core/camera_math.py).

Math convention throughout: p_cam = W2V[:3,:3] @ p + W2V[:3,3] and
full_proj = proj @ world_view. Host-side matrices are float32 numpy;
per-pixel geometry is torch on the caller's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve_device

NEAR_PLANE = 0.2  # reference cuda_rasterizer/auxiliary.h:21
FAR_PLANE = 100.0


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: int) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray, translate=(0.0, 0.0, 0.0),
                  scale: float = 1.0) -> np.ndarray:
    """World->view 4x4. `R` is the cam->world rotation (COLMAP loaders), so
    the view matrix uses R^T (reference getWorld2View2)."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = np.asarray(t)
    Rt[3, 3] = 1.0
    c2w = np.linalg.inv(Rt)
    c2w[:3, 3] = (c2w[:3, 3] + np.asarray(translate)) * scale
    return np.linalg.inv(c2w).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """GL-style perspective with the reference's depth mapping."""
    return projection_matrix_cv(znear, zfar, fovx, fovy, 0.0, 0.0)


def projection_matrix_cv(znear: float, zfar: float, fovx: float, fovy: float,
                         cx: float = 0.0, cy: float = 0.0) -> np.ndarray:
    """Principal-point-shifted perspective; cx, cy in [-0.5, 0.5] image-ratio
    units (Technicolor path)."""
    tan_half_fovy = math.tan(fovy / 2.0)
    tan_half_fovx = math.tan(fovx / 2.0)
    top = tan_half_fovy * znear
    bottom = -top
    right = tan_half_fovx * znear
    left = -right
    dx = (2.0 * tan_half_fovx * znear) * cx
    dy = (2.0 * tan_half_fovy * znear) * cy
    left += dx
    right += dx
    top += dy
    bottom += dy
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = (zfar + znear) / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P.astype(np.float32)


def ndc_to_pixel(v: torch.Tensor, size) -> torch.Tensor:
    """NDC [-1,1] -> continuous pixel coordinate (auxiliary.h:57-60)."""
    return ((v + 1.0) * size - 1.0) * 0.5


def _pixel_grid(width, height, focal_x, focal_y, offset, device):
    xs = (torch.arange(width, dtype=torch.float32, device=device) + offset
          - width / 2.0) / focal_x
    ys = (torch.arange(height, dtype=torch.float32, device=device) + offset
          - height / 2.0) / focal_y
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    return u, v


def camera_rays_z(width: int, height: int, focal_x: float, focal_y: float,
                  device="cuda") -> torch.Tensor:
    """Per-pixel ray-length factor ln = sqrt(u^2+v^2+1) (forward.cu:590-591).
    Returns [H, W] on `device` (the GPU unless the caller asks for the CPU)."""
    u, v = _pixel_grid(width, height, focal_x, focal_y, 0.0, resolve_device(device))
    return torch.sqrt(u * u + v * v + 1.0)


def depths_to_points(depth: torch.Tensor, width: int, height: int,
                     focal_x: float, focal_y: float) -> torch.Tensor:
    """Unproject a z-depth map to camera-space points [3, H, W] (pixel
    centers at +0.5, principal point at W/2, H/2)."""
    u, v = _pixel_grid(width, height, focal_x, focal_y, 0.5, depth.device)
    rays = torch.stack([u, v, torch.ones_like(u)], dim=0)
    return depth.reshape(1, height, width) * rays


def points_to_normal(points: torch.Tensor) -> torch.Tensor:
    """Finite-difference cross-product normals [3, H, W]; border zero."""
    dx = points[:, 2:, 1:-1] - points[:, :-2, 1:-1]
    dy = points[:, 1:-1, 2:] - points[:, 1:-1, :-2]
    n = torch.linalg.cross(dx, dy, dim=0)
    # double-where safe normalize: flat pixels have a zero cross product
    d2 = torch.sum(n * n, dim=0, keepdim=True)
    ok = d2 > 1e-24
    n = torch.where(ok, n / torch.sqrt(torch.where(ok, d2, torch.ones_like(d2))),
                    torch.zeros_like(n))
    return torch.nn.functional.pad(n, (1, 1, 1, 1))


def depth_to_normal(depth: torch.Tensor, width: int, height: int,
                    focal_x: float, focal_y: float) -> torch.Tensor:
    """Depth map [H, W] -> camera-space normal map [3, H, W]."""
    return points_to_normal(depths_to_points(depth, width, height, focal_x, focal_y))
