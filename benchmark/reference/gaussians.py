"""Fixed-capacity Gaussian cloud: parameters, activations and the RaDe-GS
3D filter (a frozen copy of ed3dgs_torch/models/gaussians.py's)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch



class GaussianParams(NamedTuple):
    """Learnable per-Gaussian parameters (raw / pre-activation), capacity C."""

    xyz: torch.Tensor            # [C, 3]
    features_dc: torch.Tensor    # [C, 1, 3]
    features_rest: torch.Tensor  # [C, 15, 3]
    scaling: torch.Tensor        # [C, 3] log-scales
    rotation: torch.Tensor       # [C, 4] unnormalized quaternions (w,x,y,z)
    opacity: torch.Tensor        # [C, 1] logit-opacity
    embedding: torch.Tensor      # [C, E] per-gaussian latent


class GaussianAux(NamedTuple):
    """Non-learnable per-Gaussian state."""

    alive: torch.Tensor           # [C] bool
    tongue_class: torch.Tensor    # [C, 1] float 0/1
    filter_3d: torch.Tensor       # [C, 1] RaDe-GS 3D low-pass scale
    max_radii2d: torch.Tensor     # [C] float
    xyz_grad_accum: torch.Tensor  # [C] densification stat
    denom: torch.Tensor           # [C]


# --- activations (scene/gaussian_model.py:30-46) ---------------------------

def get_features(params: GaussianParams) -> torch.Tensor:
    return torch.cat([params.features_dc, params.features_rest], dim=1)


def apply_3d_filter(opacity_raw, scaling_raw, filter_3d):
    """Fused 3D-filter scale/opacity correction
    (apply_scaling_n_opacity_with_3D_filter, scene/gaussian_model.py:594-603)."""
    opacity = torch.sigmoid(opacity_raw)
    scales = torch.exp(scaling_raw)
    s2 = scales * scales
    # the products written out, (x * y) * z as jnp.prod's pairwise tree
    # forms them (and its gradient); torch.prod's backward reads on the host
    # whether a factor is zero, a wait a captured step cannot make
    det1 = s2[..., 0] * s2[..., 1] * s2[..., 2]
    s2f = s2 + filter_3d * filter_3d
    det2 = s2f[..., 0] * s2f[..., 1] * s2f[..., 2]
    coef = torch.sqrt(det1 / det2)
    return torch.sqrt(s2f), opacity * coef[..., None]


# --- RaDe-GS 3D filter (scene/gaussian_model.py:538-592) -------------------

def compute_3d_filter(xyz: torch.Tensor, alive: torch.Tensor, view_mats: torch.Tensor,
                      focals_x: torch.Tensor, focals_y: torch.Tensor, widths: torch.Tensor,
                      heights: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian screen-space low-pass scale from the closest camera that
    sees it. view_mats: [M, 4, 4] world->view matrices (math convention);
    focals_x/focals_y, widths/heights: [M]. Returns [C, 1] filter scale
    (distance / focal * sqrt(0.2)); unseen slots get the farthest seen
    distance."""
    R = view_mats[:, :3, :3]
    t = view_mats[:, :3, 3]
    cam_xyz = torch.einsum("mij,nj->mni", R, xyz) + t[:, None, :]
    x, y, z = cam_xyz[..., 0], cam_xyz[..., 1], cam_xyz[..., 2]
    valid_depth = z > 0.2
    zc = torch.clamp_min(z, 0.001)
    px = x / zc * focals_x[:, None] + widths[:, None] / 2.0
    py = y / zc * focals_y[:, None] + heights[:, None] / 2.0
    in_screen = ((px >= -0.15 * widths[:, None]) & (px <= 1.15 * widths[:, None])
                 & (py >= -0.15 * heights[:, None]) & (py <= 1.15 * heights[:, None]))
    valid = valid_depth & in_screen & alive[None, :]
    dist = torch.where(valid, z, torch.full_like(z, 1e5)).amin(dim=0)
    seen = valid.any(dim=0)
    max_seen = torch.where(seen, dist, torch.full_like(dist, -float("inf"))).amax()
    dist = torch.where(seen, dist, max_seen)
    focal = focals_x.amax()
    return (dist / focal * math.sqrt(0.2))[:, None]
