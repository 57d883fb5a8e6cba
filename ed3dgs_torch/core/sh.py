"""Spherical-harmonics evaluation (degrees 0..3) for view-dependent color.

Port of ed3dgs_tpu/core/sh.py. Semantics match the reference kernel
`computeColorFromSH` (diff-gaussian-rasterization forward.cu:23-74):
RGB = clamp(SH(dir) + 0.5, min=0).
"""

from __future__ import annotations

import torch

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
SH_C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)


def eval_sh(deg: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Evaluate the SH basis (degree <= 3) at unit directions.

    sh: [..., K, 3] with K >= (deg+1)**2; dirs: [..., 3]. Returns [..., 3]
    raw colors (before the +0.5 offset and the clamp).
    """
    result = SH_C0 * sh[..., 0, :]
    if deg > 0:
        x = dirs[..., 0:1]
        y = dirs[..., 1:2]
        z = dirs[..., 2:3]
        result = (
            result
            - SH_C1 * y * sh[..., 1, :]
            + SH_C1 * z * sh[..., 2, :]
            - SH_C1 * x * sh[..., 3, :]
        )
        if deg > 1:
            xx, yy, zz = x * x, y * y, z * z
            xy, yz, xz = x * y, y * z, x * z
            result = (
                result
                + SH_C2[0] * xy * sh[..., 4, :]
                + SH_C2[1] * yz * sh[..., 5, :]
                + SH_C2[2] * (2.0 * zz - xx - yy) * sh[..., 6, :]
                + SH_C2[3] * xz * sh[..., 7, :]
                + SH_C2[4] * (xx - yy) * sh[..., 8, :]
            )
            if deg > 2:
                result = (
                    result
                    + SH_C3[0] * y * (3.0 * xx - yy) * sh[..., 9, :]
                    + SH_C3[1] * xy * z * sh[..., 10, :]
                    + SH_C3[2] * y * (4.0 * zz - xx - yy) * sh[..., 11, :]
                    + SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy) * sh[..., 12, :]
                    + SH_C3[4] * x * (4.0 * zz - xx - yy) * sh[..., 13, :]
                    + SH_C3[5] * z * (xx - yy) * sh[..., 14, :]
                    + SH_C3[6] * x * (xx - 3.0 * yy) * sh[..., 15, :]
                )
    return result


def sh_to_rgb(deg: int, sh: torch.Tensor, means: torch.Tensor,
              campos: torch.Tensor) -> torch.Tensor:
    """SH -> clamped RGB exactly as the reference preprocess does.
    sh [N, K, 3], means [N, 3] world centers, campos [3]. Returns [N, 3]."""
    d = means - campos[None, :]
    # safe-where normalize: a (dead/culled) gaussian exactly at the camera
    # center has d == 0; norm's backward is NaN there and would poison the
    # whole gradient through any shared upstream (e.g. the deform MLP)
    d2 = torch.sum(d * d, dim=-1, keepdim=True)
    ok = d2 > 1e-24
    d = torch.where(ok, d / torch.sqrt(torch.where(ok, d2, torch.ones_like(d2))),
                    torch.zeros_like(d))
    return torch.clamp_min(eval_sh(deg, sh, d) + 0.5, 0.0)


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse DC mapping (reference utils/sh_utils.py:113)."""
    return (rgb - 0.5) / SH_C0


def sh_to_rgb_dc(sh_dc: torch.Tensor) -> torch.Tensor:
    """DC-only SH to RGB (reference utils/sh_utils.py:116)."""
    return sh_dc * SH_C0 + 0.5
