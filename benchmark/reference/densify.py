"""Densification: statistics, clone and split (port of
ed3dgs_tpu/train/densify.py).

Reference semantics (scene/gaussian_model.py:452-518, train.py:403-436):
  * stats: accumulate ||d mean2d||_2 per visible Gaussian, denom += 1;
  * clone: grad >= threshold and max(scale) <= percent_dense * extent
    -> duplicate the Gaussian verbatim;
  * split: grad >= threshold and max(scale) > percent_dense * extent
    -> two children drawn from N(mean, Sigma) with scales / (0.8*2), the
    parent removed.

The cloud has a fixed capacity with an alive mask, as in the JAX package:
clone children go to free slots (lowest first), a split writes child A over
the parent's slot and child B to the next free slot, and selections are
capped by the free-slot budget under `max_gaussians`. Sources and
destinations are taken in the JAX package's order (stable argsorts), and
every write goes through a permutation of the slots, so no two writes meet
and no float scatter-add is needed. The Adam moments of every touched slot
are zeroed by the caller through the returned reset mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .quaternion import quat_rotmat_entries
from .gaussians import GaussianAux, GaussianParams


class DensifyResult(NamedTuple):
    params: GaussianParams
    aux: GaussianAux
    reset_mask: torch.Tensor   # [C] slots whose Adam moments must be zeroed
    n_cloned: torch.Tensor     # [] int
    n_split: torch.Tensor      # [] int


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


def _select(active: torch.Tensor, new: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    return torch.where(active.reshape((-1,) + (1,) * (new.dim() - 1)), new, cur)


def _masked_scatter(params: GaussianParams, src_idx, dst_idx, active) -> GaussianParams:
    """params[dst_idx[i]] <- params[src_idx[i]] where active[i]; dst_idx is
    a permutation of the slots."""
    def scatter(leaf):
        out = leaf.clone()
        out[dst_idx] = _select(active, leaf[src_idx], leaf[dst_idx])
        return out
    return GaussianParams(*(scatter(leaf) for leaf in params))


def _set_at(x: torch.Tensor, idx: torch.Tensor, active: torch.Tensor, new: torch.Tensor):
    """x.at[idx].set(where(active, new, x[idx])) for a permutation idx."""
    out = x.clone()
    out[idx] = _select(active, new, x[idx])
    return out


def densify(params: GaussianParams, aux: GaussianAux,
            generator: Optional[torch.Generator] = None, *, grad_threshold: float,
            percent_dense: float, scene_extent: float, max_gaussians: int,
            noise: Optional[torch.Tensor] = None) -> DensifyResult:
    """Clone and split the hot Gaussians. The split children's offsets come
    from `noise` [2, C, 3] (child A, child B) when given, else from two
    standard-normal draws of `generator`, child A first."""
    C = aux.alive.shape[0]
    dev = aux.alive.device
    grads = torch.where(aux.denom > 0, aux.xyz_grad_accum / aux.denom,
                        torch.zeros_like(aux.denom))
    scales = torch.exp(params.scaling)
    max_scale = scales.amax(dim=1)
    hot = (grads >= grad_threshold) & aux.alive
    clone_mask = hot & (max_scale <= percent_dense * scene_extent)
    split_mask = hot & (max_scale > percent_dense * scene_extent)

    n_alive = aux.alive.to(torch.int64).sum()
    # global cap (train.py:412): never beyond max_number_gaussians or capacity
    budget = torch.clamp_min(min(max_gaussians, C) - n_alive, 0)

    slot = torch.arange(C, device=dev)
    free_order = torch.argsort(aux.alive.to(torch.int32), stable=True)
    clone_order = torch.argsort((~clone_mask).to(torch.int32), stable=True)
    n_clone = torch.minimum(clone_mask.to(torch.int64).sum(), budget)
    clone_active = slot < n_clone
    clone_dst = free_order
    params = _masked_scatter(params, clone_order, clone_dst, clone_active)
    new_alive = _set_at(aux.alive, clone_dst, clone_active, torch.ones_like(aux.alive))
    tongue = _set_at(aux.tongue_class, clone_dst, clone_active, aux.tongue_class[clone_order])

    # splits: child B goes to the next free slots after the clones
    budget2 = budget - n_clone
    split_dst = torch.argsort(new_alive.to(torch.int32), stable=True)
    split_src = torch.argsort((~split_mask).to(torch.int32), stable=True)
    n_split = torch.minimum(split_mask.to(torch.int64).sum(), budget2)
    split_active = slot < n_split

    # both children ~ N(mean, R diag(s) sample) (gaussian_model.py:462-467)
    if noise is None:
        noise = torch.randn((2, C, 3), generator=generator, device=dev)
    q = params.rotation / torch.clamp_min(
        torch.linalg.vector_norm(params.rotation, dim=-1, keepdim=True), 1e-12)
    R = torch.stack(quat_rotmat_entries(q), dim=-1).reshape(C, 3, 3)
    src_R = R[split_src]
    src_scales = scales[split_src]
    src_xyz = params.xyz[split_src]
    samp_a = torch.einsum("nij,nj->ni", src_R, noise[0] * src_scales)
    samp_b = torch.einsum("nij,nj->ni", src_R, noise[1] * src_scales)
    new_scaling_src = torch.log(src_scales / (0.8 * 2.0))

    # child B into a free slot: every field from the parent, then position
    # and scale
    params = _masked_scatter(params, split_src, split_dst, split_active)
    params = params._replace(
        xyz=_set_at(params.xyz, split_dst, split_active, src_xyz + samp_b),
        scaling=_set_at(params.scaling, split_dst, split_active, new_scaling_src))
    # child A overwrites the parent slot
    params = params._replace(
        xyz=_set_at(params.xyz, split_src, split_active, src_xyz + samp_a),
        scaling=_set_at(params.scaling, split_src, split_active, new_scaling_src))
    alive2 = _set_at(new_alive, split_dst, split_active, torch.ones_like(new_alive))
    tongue = _set_at(tongue, split_dst, split_active, tongue[split_src])

    # touched slots -> Adam moment reset: clone targets, child B slots, and
    # split parents (pruned and re-added in the reference)
    reset = torch.zeros(C, dtype=torch.bool, device=dev)
    reset = _set_at(reset, clone_dst, clone_active, torch.ones_like(reset))
    reset = _set_at(reset, split_dst, split_active, torch.ones_like(reset))
    reset = reset | (split_mask & (torch.cumsum(split_mask.to(torch.int64), 0) <= n_split))

    zeros = torch.zeros(C, dtype=torch.float32, device=dev)
    aux = aux._replace(alive=alive2, tongue_class=tongue, max_radii2d=zeros,
                       xyz_grad_accum=zeros.clone(), denom=zeros.clone())
    return DensifyResult(params, aux, reset, n_clone, n_split)
