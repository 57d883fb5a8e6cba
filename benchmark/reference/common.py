"""Shared types/constants for the rasterizer (port of ed3dgs_tpu/ops/common.py)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

TILE = 16
ALPHA_MIN = 1.0 / 255.0       # skip threshold (forward.cu:693)
ALPHA_MAX = 0.99              # clamp (forward.cu:692)
T_STOP = 1e-4                 # early-stop transmittance (forward.cu:696)
MEDIAN_T = 0.5                # median crossing (forward.cu:708)
NORMALIZE_EPS = 1e-12         # auxiliary.h:23


class RasterOutputs(NamedTuple):
    """Rendered channels in [C, H, W] layout, matching the reference autograd
    9-tuple (diff_gaussian_rasterization/__init__.py:110-113)."""

    color: torch.Tensor           # [3, H, W] alpha-blended RGB + T*bg
    alpha: torch.Tensor           # [1, H, W] accumulated blend weight
    expected_coord: torch.Tensor  # [3, H, W] weight-normalized expected cam coord
    median_coord: torch.Tensor    # [3, H, W] coord at the T=0.5 crossing splat
    expected_depth: torch.Tensor  # [1, H, W] weight-normalized expected z-depth
    median_depth: torch.Tensor    # [1, H, W] z-depth at the T=0.5 crossing splat
    normal: torch.Tensor          # [3, H, W] normalized accumulated splat normal
    tongue: torch.Tensor          # [1, H, W] blended tongue-class channel
    # [] bool: some tile's splat demand exceeded the per-tile cap, so the
    # image dropped splats
    tile_overflow: Optional[torch.Tensor] = None


