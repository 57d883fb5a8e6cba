"""Fixed-capacity Gaussian cloud: parameters, activations and ply loading
(port of ed3dgs_tpu/models/gaussians.py).

The cloud keeps the JAX package's fixed capacity C with an `alive` mask, so a
checkpoint and its tensors have the same shapes in both packages.
Densification (train/densify.py) fills free slots instead of reallocating.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.sh import rgb_to_sh
from ..data import ply as plyio
from ..device import resolve_device
from ..ops.knn import mean_sqdist_3nn
from ..utils import trace


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

def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def get_scaling(params: GaussianParams) -> torch.Tensor:
    return torch.exp(params.scaling)


def get_opacity(params: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(params.opacity)


def get_rotation(params: GaussianParams) -> torch.Tensor:
    sq = torch.sum(params.rotation * params.rotation, dim=-1, keepdim=True)
    return params.rotation / torch.sqrt(torch.where(sq < 1e-24, torch.ones_like(sq), sq))


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


# --- construction from host arrays ------------------------------------------

def from_numpy(fields: dict, *, capacity: Optional[int] = None, device="cuda"):
    """(params, aux) from numpy arrays named after the GaussianParams and
    GaussianAux fields. `alive` defaults to all-true; the aux statistics
    default to zeros. Rows are zero-padded to `capacity` (log-scales with
    -10, alive with False), as the JAX package pads its cloud."""
    dev = resolve_device(device)
    n = np.asarray(fields["xyz"]).shape[0]
    C = capacity or n
    if n > C:
        raise ValueError(f"cloud ({n}) exceeds capacity ({C})")

    def pad(x, fill=0.0, dtype=torch.float32):
        x = np.asarray(x)
        x = np.pad(x, [(0, C - n)] + [(0, 0)] * (x.ndim - 1), constant_values=fill)
        return torch.as_tensor(x, dtype=dtype, device=dev)

    params = GaussianParams(
        xyz=pad(fields["xyz"]), features_dc=pad(fields["features_dc"]),
        features_rest=pad(fields["features_rest"]),
        scaling=pad(fields["scaling"], -10.0), rotation=pad(fields["rotation"]),
        opacity=pad(fields["opacity"]), embedding=pad(fields["embedding"]))
    zeros_c = np.zeros(n, np.float32)
    aux = GaussianAux(
        alive=pad(fields.get("alive", np.ones(n, bool)), False, torch.bool),
        tongue_class=pad(fields.get("tongue_class", np.zeros((n, 1), np.float32))),
        filter_3d=pad(fields.get("filter_3d", np.zeros((n, 1), np.float32))),
        max_radii2d=pad(fields.get("max_radii2d", zeros_c)),
        xyz_grad_accum=pad(fields.get("xyz_grad_accum", zeros_c)),
        denom=pad(fields.get("denom", zeros_c)),
    )
    return params, aux


def create_from_points(points: np.ndarray, colors: np.ndarray, *, capacity: int,
                       embedding_dim: int = 32, sh_degree: int = 3,
                       tongue_mask_loss_enabled: bool = False, device="cuda"):
    """Initialize from a point cloud (create_from_pcd,
    scene/gaussian_model.py:150-192): SH DC from colors, log-scales from the
    3-NN mean squared distance (clamped to <= 1.0), identity rotations,
    opacity 0.1, zero embeddings; tongue class = pure-red input points."""
    dev = resolve_device(device)
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"init cloud ({n}) exceeds capacity ({capacity})")
    C = capacity
    pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
    d2 = torch.clamp_min(mean_sqdist_3nn(pts), 1e-7)
    scales = torch.clamp_max(torch.log(torch.sqrt(d2)), 1.0)[:, None].repeat(1, 3)

    def pad(x, fill=0.0):
        return torch.cat([x, torch.full((C - n, *x.shape[1:]), fill, dtype=x.dtype, device=dev)])

    fused_color = rgb_to_sh(torch.as_tensor(np.asarray(colors, np.float32), device=dev))
    params = GaussianParams(
        xyz=pad(pts),
        features_dc=pad(fused_color[:, None, :]),
        features_rest=torch.zeros((C, (sh_degree + 1) ** 2 - 1, 3), device=dev),
        scaling=pad(scales, fill=-10.0),
        rotation=torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=dev).repeat(C, 1),
        opacity=pad(torch.full((n, 1), float(inverse_sigmoid(torch.tensor(0.1))), device=dev)),
        embedding=torch.zeros((C, embedding_dim), device=dev),
    )
    red = np.all(np.asarray(colors) == np.array([1.0, 0, 0]), axis=1)
    tongue = torch.zeros((C, 1), device=dev)
    if tongue_mask_loss_enabled and red.any():
        tongue[:n, 0] = torch.as_tensor(red, dtype=torch.float32, device=dev)
    zeros_c = torch.zeros(C, device=dev)
    aux = GaussianAux(
        alive=torch.arange(C, device=dev) < n, tongue_class=tongue,
        filter_3d=torch.zeros((C, 1), device=dev),
        max_radii2d=zeros_c, xyz_grad_accum=zeros_c.clone(), denom=zeros_c.clone())
    return params, aux


def num_alive(aux: GaussianAux) -> torch.Tensor:
    return torch.sum(aux.alive.to(torch.int32))


# --- RaDe-GS 3D filter (scene/gaussian_model.py:538-592) -------------------

def compute_3d_filter(xyz: torch.Tensor, alive: torch.Tensor, view_mats: torch.Tensor,
                      focals_x: torch.Tensor, focals_y: torch.Tensor, widths: torch.Tensor,
                      heights: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian screen-space low-pass scale from the closest camera that
    sees it. view_mats: [M, 4, 4] world->view matrices (math convention);
    focals_x/focals_y, widths/heights: [M]. Returns [C, 1] filter scale
    (distance / focal * sqrt(0.2)); unseen slots get the farthest seen
    distance. Traced as the region and host span "filter3d"
    (utils/trace.py)."""
    with trace.span("filter3d"), trace.region("filter3d", xyz.device):
        return _filter_3d(xyz, alive, view_mats, focals_x, focals_y, widths, heights)


def _filter_3d(xyz, alive, view_mats, focals_x, focals_y, widths, heights):
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


# --- ply checkpoint I/O (scene/gaussian_model.py:231-347) ------------------

def save_ply(path: str, params: GaussianParams, aux: GaussianAux):
    """Write the alive Gaussians in the reference's attribute layout
    (channel-major feature flattening), the JAX package's `save_ply` file,
    so a model loads in either implementation."""
    host = lambda t: t.detach().cpu().numpy()  # noqa: E731
    alive = host(aux.alive)
    xyz = host(params.xyz)[alive]
    n = xyz.shape[0]
    f_dc = host(params.features_dc)[alive].transpose(0, 2, 1).reshape(n, -1)
    f_rest = host(params.features_rest)[alive].transpose(0, 2, 1).reshape(n, -1)
    names = ["x", "y", "z", "nx", "ny", "nz", "f_dc", "f_rest", "opacity",
             "scale", "rot", "embedding", "tongue_class", "filter_3D"]
    arrays = [xyz[:, 0], xyz[:, 1], xyz[:, 2],
              np.zeros(n), np.zeros(n), np.zeros(n),
              f_dc, f_rest,
              host(params.opacity)[alive],
              host(params.scaling)[alive],
              host(params.rotation)[alive],
              host(params.embedding)[alive],
              host(aux.tongue_class)[alive],
              host(aux.filter_3d)[alive]]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plyio.write_ply(path, names, arrays)


def load_ply(path: str, *, capacity: Optional[int] = None, sh_degree: int = 3,
             device="cuda"):
    """Load a Gaussian checkpoint ply -> (params, aux). Reads files written by
    ed3dgs_tpu (models/gaussians.py save_ply) or by the reference CUDA code."""
    data = plyio.read_ply(path)["vertex"]
    names = data.dtype.names
    n = len(data)

    def grab(prefix, count):
        cols = sorted((x for x in names if x.startswith(prefix)),
                      key=lambda s: int(s.split("_")[-1]))
        if len(cols) != count:
            raise ValueError(f"{path}: expected {count} '{prefix}*' columns, "
                             f"found {len(cols)}")
        return np.stack([data[c] for c in cols], axis=1).astype(np.float32)

    k = (sh_degree + 1) ** 2
    emb_cols = [x for x in names if x.startswith("embedding_")]
    fields = {
        "xyz": np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float32),
        "features_dc": grab("f_dc_", 3).reshape(n, 3, 1).transpose(0, 2, 1),
        "features_rest": grab("f_rest_", 3 * (k - 1)).reshape(n, 3, k - 1).transpose(0, 2, 1),
        "scaling": grab("scale_", 3),
        "rotation": grab("rot_", 4),
        "opacity": np.asarray(data["opacity"], np.float32)[:, None],
        "embedding": (grab("embedding_", len(emb_cols)) if emb_cols
                      else np.zeros((n, 32), np.float32)),
    }
    if "tongue_class" in names:
        fields["tongue_class"] = np.asarray(data["tongue_class"], np.float32)[:, None]
    if "filter_3D" in names:
        fields["filter_3d"] = np.asarray(data["filter_3D"], np.float32)[:, None]
    return from_numpy(fields, capacity=capacity, device=device)
