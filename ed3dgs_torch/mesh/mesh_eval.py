"""Mesh-vs-point-cloud evaluation (port of ed3dgs_tpu/mesh/mesh_eval.py).

Reference parity: evaluate_pointcloud_mesh.py:107-168 — for every GT point,
the closest point on the mesh (distance, mm-scaled by the caller) and the
cosine similarity between the GT point normal and the face normal at the
closest point. The reference uses point_cloud_utils' closest_points_on_mesh;
here it is an exact closest-point-on-triangle computation (Ericson's region
test) in float64, blocked over points x faces, on the device the caller
names: the JAX package's numpy arithmetic, operation for operation, in
torch, so that a mesh of a few hundred thousand faces is measured on the
card in seconds rather than on the host in minutes.
"""

from __future__ import annotations

import numpy as np
import torch


def _closest_point_on_triangles(p, a, b, c):
    """Closest point on each triangle (a, b, c) for each query p.

    p: [P, 3]; a/b/c: [F, 3] float64 tensors. Returns [P, F, 3]; callers
    block over F."""
    ab = b - a
    ac = c - a
    ap = p[:, None, :] - a[None, :, :]

    d1 = torch.einsum("fk,pfk->pf", ab, ap)
    d2 = torch.einsum("fk,pfk->pf", ac, ap)
    bp = p[:, None, :] - b[None, :, :]
    d3 = torch.einsum("fk,pfk->pf", ab, bp)
    d4 = torch.einsum("fk,pfk->pf", ac, bp)
    cp = p[:, None, :] - c[None, :, :]
    d5 = torch.einsum("fk,pfk->pf", ab, cp)
    d6 = torch.einsum("fk,pfk->pf", ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    def safe(x):
        return torch.where(torch.abs(x) > 1e-30, x, torch.full_like(x, 1e-30))

    v_ab = torch.clamp(d1 / safe(d1 - d3), 0, 1)
    w_ac = torch.clamp(d2 / safe(d2 - d6), 0, 1)
    w_bc = torch.clamp((d4 - d3) / safe((d4 - d3) + (d5 - d6)), 0, 1)

    denom = safe(va + vb + vc)
    v = vb / denom
    w = vc / denom

    # region selection
    reg_a = (d1 <= 0) & (d2 <= 0)
    reg_b = (d3 >= 0) & (d4 <= d3)
    reg_c = (d6 >= 0) & (d5 <= d6)
    reg_ab = (~reg_a) & (~reg_b) & (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    reg_ac = (~reg_a) & (~reg_c) & (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    reg_bc = (~reg_b) & (~reg_c) & (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    A = a[None]
    q = A + v[..., None] * ab[None] + w[..., None] * ac[None]  # inside default
    q = torch.where(reg_bc[..., None], b[None] + w_bc[..., None] * (c - b)[None], q)
    q = torch.where(reg_ac[..., None], A + w_ac[..., None] * ac[None], q)
    q = torch.where(reg_ab[..., None], A + v_ab[..., None] * ab[None], q)
    q = torch.where(reg_c[..., None], c[None].expand_as(q), q)
    q = torch.where(reg_b[..., None], b[None].expand_as(q), q)
    q = torch.where(reg_a[..., None], A.expand_as(q), q)
    return q


def closest_points_on_mesh(points: np.ndarray, vertices: np.ndarray,
                           faces: np.ndarray, point_block: int = 512,
                           face_block: int = 4096, device="cpu"):
    """(distances [P] float32, closest_face [P] int64, closest_point [P,3]
    float32) as numpy arrays, computed in float64 on `device`."""
    dev = torch.device(device)
    P = len(points)
    best_d = np.full(P, np.inf, np.float32)
    best_f = np.zeros(P, np.int64)
    best_q = np.zeros((P, 3), np.float32)
    f64 = dict(dtype=torch.float64, device=dev)
    tri = torch.as_tensor(np.asarray(vertices)[np.asarray(faces)], **f64)   # [F, 3, 3]
    pts = torch.as_tensor(np.asarray(points), **f64)
    for ps in range(0, P, point_block):
        p = pts[ps:ps + point_block]
        rows = torch.arange(len(p), device=dev)
        bd = torch.full((len(p),), float("inf"), **f64)
        bf = torch.zeros(len(p), dtype=torch.int64, device=dev)
        bq = torch.zeros((len(p), 3), **f64)
        for fs in range(0, len(faces), face_block):
            t = tri[fs:fs + face_block]
            q = _closest_point_on_triangles(p, t[:, 0], t[:, 1], t[:, 2])
            d = torch.linalg.vector_norm(p[:, None, :] - q, dim=2)
            am = torch.argmin(d, dim=1)
            dm = d[rows, am]
            upd = dm < bd
            bd = torch.where(upd, dm, bd)
            bf = torch.where(upd, am + fs, bf)
            bq = torch.where(upd[:, None], q[rows, am], bq)
        best_d[ps:ps + point_block] = bd.cpu().numpy()
        best_f[ps:ps + point_block] = bf.cpu().numpy()
        best_q[ps:ps + point_block] = bq.cpu().numpy()
    return best_d, best_f, best_q


def face_normals(vertices: np.ndarray, faces: np.ndarray) -> np.ndarray:
    tri = vertices[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)


def evaluate_mesh_against_pointcloud(vertices, faces, gt_points,
                                     gt_normals=None, scale_mm=1000.0, device="cpu"):
    """Mean closest distance (scaled, e.g. to mm) + mean |normal cosine|
    (reference evaluate_pointcloud_mesh.py:118-135)."""
    d, f, _q = closest_points_on_mesh(gt_points, vertices, faces, device=device)
    mean_dist = float(np.mean(d) * scale_mm)
    normal_sim = None
    if gt_normals is not None and len(faces):
        fn = face_normals(vertices, faces)[f]
        gn = gt_normals / np.maximum(
            np.linalg.norm(gt_normals, axis=1, keepdims=True), 1e-12)
        normal_sim = float(np.mean(np.abs(np.sum(fn * gn, axis=1))))
    return mean_dist, normal_sim
