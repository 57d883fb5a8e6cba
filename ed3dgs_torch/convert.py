"""Weights across: the JAX package's parameters and checkpoints <-> the
port's tensors.

The JAX package keeps the Gaussian cloud as `GaussianParams`/`GaussianAux`
NamedTuples and the deformation network as a nested dict pytree, saved as
`point_cloud.ply` + `deformation.npz` (ed3dgs_tpu/data/scene.py:56-65) with
keys in the `flatten_pytree` scheme ("coarse/feature/0/w", "weight", ...),
and its whole training state as `chkpnt<N>.npz` (`save_checkpoint`,
ed3dgs_tpu/tools/train.py:616-623): "params/...", the optax state
"opt_state/inner_states/<group>/inner_state/0/{count,mu/...,nu/...}" and
"aux/...". Everything here takes numpy arrays or files, so it needs neither
JAX nor the JAX package. `checkpoint_arrays` writes the port's training
state back in that layout, so either package resumes the other's
checkpoints.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

from .device import resolve_device
from .models import gaussians as gm

# (GaussianParams, GaussianAux) from numpy arrays named after the JAX
# package's GaussianParams and GaussianAux fields
gaussians_from_numpy = gm.from_numpy


def unflatten(flat: Mapping[str, np.ndarray]):
    """Invert flatten_pytree: {"a/0/b": x} -> {"a": [{"b": x}]}. A level whose
    keys are all integers 0..n-1 becomes a list."""
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        parts = key.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            idx = sorted(int(k) for k in node)
            if idx == list(range(len(idx))):
                return [node[str(i)] for i in idx]
        return node

    return listify(tree)


def deform_from_flat(flat: Mapping[str, np.ndarray], device="cuda"):
    """Deformation parameters as the port's nested dict of float32 tensors,
    from the flattened JAX pytree."""
    dev = resolve_device(device)
    tensors = {k: torch.as_tensor(np.array(v, np.float32), device=dev)
               for k, v in flat.items()}
    return unflatten(tensors)


def load_model(model_dir: str, iteration: int, *, capacity=None, sh_degree: int = 3,
               device="cuda"):
    """Read a model either package saved (`Scene.save`):
    <model_dir>/point_cloud/iteration_<iteration>/{point_cloud.ply,
    deformation.npz}. Returns (params, aux, deform_params)."""
    from .data.scene import read_deformation

    dev = resolve_device(device)
    it_dir = os.path.join(model_dir, "point_cloud", f"iteration_{iteration}")
    params, aux = gm.load_ply(os.path.join(it_dir, "point_cloud.ply"),
                              capacity=capacity, sh_degree=sh_degree, device=dev)
    return params, aux, deform_from_flat(read_deformation(it_dir), device=dev)


def load_checkpoint(path: str, device="cuda"):
    """A JAX `chkpnt<N>.npz` -> (TrainState, GaussianAux): parameters, both
    Adam moments and each group's update count, the aux statistics, and the
    iteration it was saved at (the next step runs at iteration + 1, as the
    JAX package's `load_checkpoint` resumes)."""
    from .train.optim import GROUPS, AdamState, TrainState, unflatten_params

    dev = resolve_device(device)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    iteration = int(flat.pop("iteration"))

    def tensors(prefix):
        return {k[len(prefix):]: torch.as_tensor(np.array(v), device=dev)
                for k, v in flat.items() if k.startswith(prefix)}

    params = unflatten_params(tensors("params/"))
    opt_state = {}
    for g in GROUPS:
        adam = f"opt_state/inner_states/{g}/inner_state/0/"
        opt_state[g] = AdamState(int(flat[adam + "count"]), tensors(adam + "mu/"),
                                 tensors(adam + "nu/"))
    aux = gm.GaussianAux(**tensors("aux/"))
    return TrainState(params, opt_state, iteration), aux


# optax keeps a second count (scale_by_schedule's) in the groups whose
# learning rate follows a schedule; both counts rise with every update
SCHEDULED_GROUPS = ("xyz", "deformation")


def checkpoint_arrays(state, aux) -> dict:
    """The JAX package's `chkpnt<N>.npz` arrays of a port TrainState and
    GaussianAux: {"iteration": int64, "params/...", the optax state
    "opt_state/inner_states/<group>/inner_state/0/{count (int32), mu/...,
    nu/...}" (and ".../inner_state/1/count" for the scheduled groups),
    "aux/..."}."""
    from .data.scene import flatten_pytree
    from .train.optim import flatten_params

    flat = {"iteration": np.asarray(int(state.iteration), np.int64)}
    flat.update({f"params/{k}": v for k, v in flatten_pytree(flatten_params(state.params)).items()})
    for g, st in state.opt_state.items():
        adam = f"opt_state/inner_states/{g}/inner_state/"
        flat[adam + "0/count"] = np.asarray(st.count, np.int32)
        flat.update({f"{adam}0/mu/{k}": v for k, v in flatten_pytree(st.mu).items()})
        flat.update({f"{adam}0/nu/{k}": v for k, v in flatten_pytree(st.nu).items()})
        if g in SCHEDULED_GROUPS:
            flat[adam + "1/count"] = np.asarray(st.count, np.int32)
    flat.update({f"aux/{k}": v for k, v in flatten_pytree(aux._asdict()).items()})
    return flat


# --- the Gaussian rows of a whole training state -----------------------------

def map_state_rows(state, aux, fn):
    """(state, aux) with `fn` applied to every tensor whose leading axis is
    the Gaussian capacity: the cloud's parameters, their Adam moments and
    every aux array. The deformation network and its moments, and the
    update counts, are kept as they are."""
    from .models.gaussians import GaussianParams
    from .train.optim import TrainState

    def rows(d):
        return {p: fn(t) if p.startswith("gaussians/") else t for p, t in d.items()}

    params = dict(state.params)
    params["gaussians"] = GaussianParams(*(fn(t) for t in state.params["gaussians"]))
    opt_state = {g: st._replace(mu=rows(st.mu), nu=rows(st.nu))
                 for g, st in state.opt_state.items()}
    return (TrainState(params, opt_state, state.iteration),
            type(aux)(*(fn(t) for t in aux)))


def shard_state(state, aux, index: int, count: int):
    """Rank `index` of `count`'s rows of (state, aux): rows [index * C /
    count, (index + 1) * C / count) of every capacity-leading tensor (C a
    multiple of count), the rest whole."""
    C = aux.alive.shape[0]
    if C % count:
        raise ValueError(f"capacity {C} does not split into {count} equal shards")
    per = C // count
    return map_state_rows(state, aux, lambda t: t[index * per:(index + 1) * per])


def unshard_state(shards):
    """The whole (state, aux) from the list of every shard's (state, aux),
    in shard order: the inverse of shard_state, so a sharded run's
    checkpoint is the file a single-process run writes."""
    merged = iter([torch.cat(ts) for ts in zip(*(_rows_in_order(s, a) for s, a in shards))])
    return map_state_rows(*shards[0], lambda t: next(merged))


def _rows_in_order(state, aux) -> list:
    """The capacity-leading tensors of (state, aux), in map_state_rows's order."""
    out = []
    map_state_rows(state, aux, lambda t: out.append(t) or t)
    return out
