"""Gaussian-ellipsoid visualisation mesh (port of
ed3dgs_tpu/mesh/gaussians_viz.py; the reference gaussians_to_mesh.py:23-104).

Every Gaussian above the opacity threshold becomes an icosphere transformed
by R @ diag(scale * factor), coloured by its (SH-DC) colour, over the whole
cloud at once on the cloud's device. The icosphere is built on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.quaternion import quat_to_rotmat


def icosphere(subdiv: int = 1):
    t = (1 + 5 ** 0.5) / 2
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], float)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    for _ in range(subdiv):
        vlist = [tuple(v) for v in verts]
        cache = {}
        out_faces = []

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = (np.array(vlist[i]) + np.array(vlist[j])) / 2
                m /= np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(tuple(m))
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            out_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = np.array(out_faces)
        verts = np.array(vlist)
    return verts, faces


def gaussians_to_mesh(positions, scales, rotations_raw, colors, opacities,
                      *, scale_factor: float = 1.5,
                      opacity_threshold: float = 0.01,
                      max_n_gaussians=None, subdiv: int = 1,
                      random_colors: bool = False, seed: int = 0):
    """Tensors (or arrays) of one cloud -> (vertices [V,3] float32, faces
    [F,3] int64, vertex colours [V,3] float32), numpy on the host. The
    ellipsoids are formed on the inputs' device in float64, each product
    and sum its own rounding (the same on every device)."""
    positions, scales, rotations_raw, colors, opacities = (
        torch.as_tensor(x) for x in (positions, scales, rotations_raw, colors, opacities))
    opacities = opacities.reshape(-1)
    if max_n_gaussians:
        positions, scales = positions[:max_n_gaussians], scales[:max_n_gaussians]
        rotations_raw = rotations_raw[:max_n_gaussians]
        colors, opacities = colors[:max_n_gaussians], opacities[:max_n_gaussians]
    keep = opacities >= opacity_threshold
    positions, scales = positions[keep], scales[keep]
    rotations_raw, colors = rotations_raw[keep], colors[keep]
    n = len(positions)
    if n == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64),
                np.zeros((0, 3), np.float32))

    base_v, base_f = icosphere(subdiv)
    q = rotations_raw / torch.clamp_min(
        torch.linalg.norm(rotations_raw, dim=1, keepdim=True), 1e-12)
    M = (quat_to_rotmat(q) * (scales * scale_factor)[:, None, :]).double()  # R @ diag(s)
    bv = torch.as_tensor(base_v, device=M.device)
    verts = positions[:, None, :].double() + sum(                           # [n, K, 3]
        M[:, None, :, j] * bv[None, :, None, j] for j in range(3))
    faces = base_f[None] + (np.arange(n) * len(base_v))[:, None, None]
    if random_colors:
        colors = np.random.default_rng(seed).uniform(0, 1, (n, 3))
    else:
        colors = colors.cpu().numpy()
    vcols = np.repeat(np.clip(colors, 0, 1), len(base_v), axis=0)
    return (verts.reshape(-1, 3).float().cpu().numpy(),
            faces.reshape(-1, 3).astype(np.int64), vcols.astype(np.float32))
