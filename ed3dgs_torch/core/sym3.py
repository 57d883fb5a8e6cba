"""Closed-form symmetric 3x3 eigen-analysis (port of ed3dgs_tpu/core/sym3.py).

The trigonometric closed form (Eberly): branch-free, elementwise over the
Gaussian axis, with the reference's ill-conditioned fallback
(forward.cu:135-155) for the RaDe-GS plane/normal geometry.
"""

from __future__ import annotations

import torch

_TWO_PI_3 = 2.0943951023931953  # 2*pi/3


def sym3_eigenvalues(p: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of packed symmetric matrices [..., 6], descending [..., 3]."""
    a00, a01, a02, a11, a12, a22 = (p[..., i] for i in range(6))
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    pm = torch.sqrt(torch.clamp_min(p2 / 6.0, 0.0))
    safe_pm = torch.clamp_min(pm, 1e-30)
    b00, b11, b22 = (a00 - q) / safe_pm, (a11 - q) / safe_pm, (a22 - q) / safe_pm
    b01, b02, b12 = a01 / safe_pm, a02 / safe_pm, a12 / safe_pm
    detb = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * pm * torch.cos(phi)
    e3 = q + 2.0 * pm * torch.cos(phi + _TWO_PI_3)
    e2 = 3.0 * q - e1 - e3
    return torch.stack([e1, e2, e3], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def sym3_eigenvector(p: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """A unit eigenvector [..., 3] for eigenvalue lam [...]: the largest cross
    product of rows of (A - lam I)."""
    a00, a01, a02, a11, a12, a22 = (p[..., i] for i in range(6))
    r0 = torch.stack([a00 - lam, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - lam, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - lam], dim=-1)
    c01 = _cross(r0, r1)
    c02 = _cross(r0, r2)
    c12 = _cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best12 = (n12 >= n01) & (n12 >= n02)
    best02 = (n02 >= n01) & ~best12
    v = torch.where(best12[..., None], c12, torch.where(best02[..., None], c02, c01))
    norm = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v / torch.clamp_min(norm, 1e-30)


def sym3_inverse(p: torch.Tensor, det_eps: float = 0.0) -> torch.Tensor:
    """Adjugate inverse of packed symmetric matrices -> packed [..., 6]."""
    a00, a01, a02, a11, a12, a22 = (p[..., i] for i in range(6))
    c00 = a11 * a22 - a12 * a12
    c01 = a02 * a12 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c11 = a00 * a22 - a02 * a02
    c12 = a01 * a02 - a00 * a12
    c22 = a00 * a11 - a01 * a01
    det = a00 * c00 + a01 * c01 + a02 * c02
    tiny = torch.where(det >= 0, torch.full_like(det, 1e-30), torch.full_like(det, -1e-30))
    inv_det = 1.0 / torch.where(torch.abs(det) > det_eps, det, tiny)
    return torch.stack([c00, c01, c02, c11, c12, c22], dim=-1) * inv_det[..., None]


def sym3_pseudo_inverse_min(p: torch.Tensor, min_eig_threshold: float = 1e-8):
    """(Pseudo-)inverse of a world covariance: the true inverse where the
    minimum eigenvalue exceeds the threshold, else the outer product of the
    min-eigenvalue eigenvector (forward.cu:151-155), with gradients stopped
    through that degenerate branch. Returns (packed [..., 6], well [...])."""
    p_ng = p.detach()
    eigs = sym3_eigenvalues(p_ng)
    min_eig = eigs[..., 2]
    well = min_eig > min_eig_threshold
    # safe input: the unselected branch must stay finite forward and backward
    # (the packed identity 1, 0, 0, 1, 0, 1, made on the device: a copy
    # from host memory would make the host wait)
    k = torch.arange(6, device=p.device)
    identity6 = ((k == 0) | (k == 3) | (k == 5)).to(p.dtype)
    p_safe = torch.where(well[..., None], p, identity6)
    inv = sym3_inverse(p_safe)
    v = sym3_eigenvector(p_ng, min_eig)
    outer = torch.stack([
        v[..., 0] * v[..., 0], v[..., 0] * v[..., 1], v[..., 0] * v[..., 2],
        v[..., 1] * v[..., 1], v[..., 1] * v[..., 2], v[..., 2] * v[..., 2],
    ], dim=-1)
    return torch.where(well[..., None], inv, outer), well
