"""Tetrahedra point generation + Delaunay (host side; port of
ed3dgs_tpu/mesh/tetra.py).

Reference parity: utils/mesh_extraction_utils.py:10-63 (statistical outlier
removal, per-Gaussian box corners at 3x the 3D-filtered scale, plus centers)
and tetra_triangulation's CGAL Delaunay (src/triangulation.cpp:28-69) —
replaced by scipy.spatial.Delaunay, which is equally exact for these point
counts. The outlier test's neighbours come from the port's exact k-NN
(ops/knn.py, the JAX package's result bit for bit), on the device the
caller names.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.quaternion import quat_to_rotmat
from ..ops.knn import knn

# unit box corner signs (trimesh.creation.box scaled by 2 => corners at +-1)
_BOX = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                dtype=np.float32)


def statistical_outlier_mask(points: np.ndarray, nb_neighbors: int = 20,
                             std_ratio: float = 1.0, device="cpu") -> np.ndarray:
    """Open3D remove_statistical_outlier semantics: keep points whose mean
    distance to their k neighbors is below mean + std_ratio * std."""
    d2, _ = knn(torch.as_tensor(np.asarray(points, np.float32), device=device),
                k=nb_neighbors)
    mean_d = torch.mean(torch.sqrt(torch.clamp_min(d2, 0.0)), dim=1).cpu().numpy()
    mu, sigma = mean_d.mean(), mean_d.std()
    return mean_d <= mu + std_ratio * sigma


def get_tetra_points(xyz: np.ndarray, rotations_raw: np.ndarray,
                     scales_filtered: np.ndarray, device="cpu"):
    """Per-Gaussian box corners at 3x scale (rotated) + centers.

    Returns (points [M,3], point_scales [M,1]) like the reference
    (mesh_extraction_utils.py:10-63)."""
    keep = statistical_outlier_mask(xyz, device=device)
    xyz = xyz[keep]
    rot = rotations_raw[keep]
    scale = scales_filtered[keep] * 3.0

    q = rot / np.maximum(np.linalg.norm(rot, axis=1, keepdims=True), 1e-12)
    R = quat_to_rotmat(torch.as_tensor(q)).numpy()
    # scale first, then rotate: c = R @ (box * scale)
    corners = np.einsum("nij,nkj->nki", R, _BOX[None] * scale[:, None, :])
    corners = corners + xyz[:, None, :]
    points = np.concatenate([corners.reshape(-1, 3), xyz], axis=0)
    smax = scale.max(axis=1, keepdims=True)
    point_scales = np.concatenate(
        [np.repeat(smax, 8, axis=0), smax], axis=0)
    return points.astype(np.float32), point_scales.astype(np.float32)


def delaunay_tets(points: np.ndarray) -> np.ndarray:
    """Delaunay tetrahedralization -> [T, 4] int32 (cpp.triangulate parity)."""
    from scipy.spatial import Delaunay
    return Delaunay(points).simplices.astype(np.int32)
