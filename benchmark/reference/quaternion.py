"""Quaternion / rotation / covariance helpers (port of
ed3dgs_tpu/core/quaternion.py).

Quaternions are (w, x, y, z); Sigma = R diag(s)^2 R^T (reference
forward.cu:270-304 computeCov3D). Symmetric 3x3 matrices are packed as
(xx, xy, xz, yy, yz, zz) and handled entrywise.
"""

from __future__ import annotations

import torch


def quat_rotmat_entries(q: torch.Tensor):
    """Unit quaternion (w,x,y,z) [..., 4] -> the 9 rotation-matrix entries
    r00..r22 (row-major) as separate [...] tensors."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return (1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y),
            2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x),
            2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y))


def build_covariance_3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """World covariance R S^2 R^T, packed [..., 6]; scales [..., 3] activated,
    quats [..., 4] unit."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = quat_rotmat_entries(quats)
    a = scales[..., 0] * scales[..., 0]
    b = scales[..., 1] * scales[..., 1]
    c = scales[..., 2] * scales[..., 2]
    return torch.stack([
        a * r00 * r00 + b * r01 * r01 + c * r02 * r02,
        a * r00 * r10 + b * r01 * r11 + c * r02 * r12,
        a * r00 * r20 + b * r01 * r21 + c * r02 * r22,
        a * r10 * r10 + b * r11 * r11 + c * r12 * r12,
        a * r10 * r20 + b * r11 * r21 + c * r12 * r22,
        a * r20 * r20 + b * r21 * r21 + c * r22 * r22,
    ], dim=-1)


def sym3_congruence(Rm: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """R S R^T for one [3, 3] matrix and packed symmetric [N, 6] S."""
    xx, xy, xz, yy, yz, zz = (p[..., i] for i in range(6))

    def mv(a):  # S @ R[a, :]
        r0, r1, r2 = Rm[a, 0], Rm[a, 1], Rm[a, 2]
        return (xx * r0 + xy * r1 + xz * r2,
                xy * r0 + yy * r1 + yz * r2,
                xz * r0 + yz * r1 + zz * r2)

    def dot(a, m):
        return Rm[a, 0] * m[0] + Rm[a, 1] * m[1] + Rm[a, 2] * m[2]

    m0, m1, m2 = mv(0), mv(1), mv(2)
    return torch.stack([dot(0, m0), dot(0, m1), dot(0, m2),
                        dot(1, m1), dot(1, m2), dot(2, m2)], dim=-1)


def sym3_matvec(p: torch.Tensor, vx, vy, vz):
    """Packed symmetric [N, 6] @ per-row vector -> three [N] tensors."""
    xx, xy, xz, yy, yz, zz = (p[..., i] for i in range(6))
    return (xx * vx + xy * vy + xz * vz,
            xy * vx + yy * vy + yz * vz,
            xz * vx + yz * vy + zz * vz)
