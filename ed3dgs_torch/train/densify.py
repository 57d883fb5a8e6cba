"""Densification statistics (port of ed3dgs_tpu/train/densify.py,
`add_densification_stats`). Clone and split themselves, which draw random
children and trigger a KNN refresh, are not ported yet (ROADMAP.md)."""

from __future__ import annotations

import torch

from ..models.gaussians import GaussianAux


def add_densification_stats(aux: GaussianAux, viewspace_grad: torch.Tensor,
                            visible: torch.Tensor, radii: torch.Tensor) -> GaussianAux:
    """train.py:405-407: max-radii update and screen-space gradient-norm
    accumulation over the visible, alive Gaussians. viewspace_grad [C, 2]."""
    vis = visible & aux.alive
    norm = torch.linalg.vector_norm(viewspace_grad[:, :2], dim=-1)
    return aux._replace(
        max_radii2d=torch.where(vis, torch.maximum(aux.max_radii2d, radii.to(torch.float32)),
                                aux.max_radii2d),
        xyz_grad_accum=torch.where(vis, aux.xyz_grad_accum + norm, aux.xyz_grad_accum),
        denom=torch.where(vis, aux.denom + 1.0, aux.denom),
    )
