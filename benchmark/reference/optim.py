"""Per-group Adam with exponential learning-rate schedules: a frozen copy
of ed3dgs_torch/train/optim.py (optax's update, operation for operation, in
float32; 9 groups, b1 0.9, b2 0.999, eps 1e-15; each group's own count feeds
its bias correction and its schedule)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .deformation import mlp_param_labels
from .gaussians import GaussianParams

GROUPS = ("xyz", "deformation", "offsets", "f_dc", "f_rest", "opacity", "scaling",
          "rotation", "embedding")
B1, B2, EPS = 0.9, 0.999, 1e-15


def _f32(x) -> torch.Tensor:
    """A 0-d float32 CPU tensor: the schedule and bias-correction scalars are
    computed in float32 as optax computes them, and a CPU scalar enters a
    CUDA kernel as an argument, without a copy or a sync."""
    return torch.tensor(x, dtype=torch.float32)


def _bias_correction(decay: float, count: int) -> torch.Tensor:
    """1 - decay**count in float32, with the power rounded once from float64
    (as XLA evaluates optax's jitted `decay**count`): near count 1,
    1 - b2**count cancels, and one float32 rounding more in the power moves
    the Adam update by 1e-5."""
    return 1 - (_f32(decay).double() ** count).float()


def expon_lr_schedule(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                      max_steps=1_000_000):
    """get_expon_lr_func (utils/general_utils.py:32-79): count -> learning
    rate, a 0-d float32 tensor."""
    if lr_init == 0.0 and lr_final == 0.0:
        return lambda step: _f32(0.0)
    log_init, log_final = torch.log(_f32(lr_init)), torch.log(_f32(lr_final))

    def schedule(step):
        step = _f32(step)
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
        else:
            delay = 1.0
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        return delay * torch.exp(log_init * (1 - t) + log_final * t)

    return schedule


def constant_lr(lr):
    return lambda step: _f32(lr)


class AdamState(NamedTuple):
    count: int          # updates applied to this group
    mu: dict            # path -> first moment
    nu: dict            # path -> second moment


class TrainState(NamedTuple):
    params: dict        # {"gaussians": GaussianParams, "deform": nested dict}
    opt_state: dict     # group -> AdamState
    iteration: int


# --- parameter paths ----------------------------------------------------------

def flatten_params(tree, prefix: str = "") -> dict:
    """{"gaussians": GaussianParams, "deform": {...}} -> {path: tensor}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_params(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):
        for k in tree._fields:
            out.update(flatten_params(getattr(tree, k), f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_params(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def unflatten(flat: dict):
    """{"a/0/b": x} -> {"a": [{"b": x}]}: a level whose keys are all
    integers 0..n-1 becomes a list."""
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


def unflatten_params(flat: dict) -> dict:
    """Inverse of flatten_params for the train state's parameters."""
    tree = unflatten(flat)
    return {"gaussians": GaussianParams(**tree["gaussians"]), "deform": tree["deform"]}


def param_labels(params) -> dict:
    """The optimizer group of every parameter, in the structure of `params`."""
    gauss = GaussianParams(xyz="xyz", features_dc="f_dc", features_rest="f_rest",
                           scaling="scaling", rotation="rotation", opacity="opacity",
                           embedding="embedding")
    return {"gaussians": gauss, "deform": mlp_param_labels(params["deform"])}


# --- the optimizer --------------------------------------------------------------

class Optimizer:
    """optax.multi_transform of one Adam per group: `init(params)` ->
    opt_state, `update(grads, opt_state, params)` -> (params, opt_state),
    both functional. grads is {path: tensor}, as flatten_params gives."""

    def __init__(self, schedules: dict):
        self.schedules = schedules

    def init(self, params) -> dict:
        labels = flatten_params(param_labels(params))
        flat = flatten_params(params)
        return {g: AdamState(0, {p: torch.zeros_like(flat[p]) for p in flat if labels[p] == g},
                             {p: torch.zeros_like(flat[p]) for p in flat if labels[p] == g})
                for g in GROUPS}

    def update(self, grads: dict, opt_state: dict, params, table=None):
        """With `table` (`update_table`'s values on the parameters' device),
        the schedule and bias corrections are read from it, not computed
        from the counts: a captured graph replays that read with the values
        written before each replay."""
        flat = flatten_params(params)
        new_flat, new_state = dict(flat), {}
        on_card = table is not None and table.is_cuda
        for i, g in enumerate(GROUPS):
            st = opt_state[g]
            count_inc = st.count + 1
            if table is None:
                step = -self.schedules[g](st.count)
                bc1, bc2 = _bias_correction(B1, count_inc), _bias_correction(B2, count_inc)
            else:
                step, bc1, bc2 = table[i].unbind()
            mu, nu = {}, {}
            for p in st.mu:
                grad = grads[p]
                mu[p] = (1 - B1) * grad + B1 * st.mu[p]
                nu[p] = (1 - B2) * grad ** 2 + B2 * st.nu[p]
                if on_card:
                    upd = (mu[p] * bc1) / (torch.sqrt(nu[p] * bc2 + 0.0) + EPS)
                else:
                    upd = (mu[p] / bc1) / (torch.sqrt(nu[p] / bc2 + 0.0) + EPS)
                new_flat[p] = flat[p] + step * upd
            new_state[g] = AdamState(count_inc, mu, nu)
        return unflatten_params(new_flat), new_state


def build_optimizer(opt, spatial_lr_scale: float) -> Optimizer:
    """The 9 reference parameter groups (scene/gaussian_model.py:199-209)."""
    return Optimizer({
        "xyz": expon_lr_schedule(
            opt.position_lr_init * spatial_lr_scale,
            opt.position_lr_final * spatial_lr_scale,
            lr_delay_mult=opt.position_lr_delay_mult,
            max_steps=opt.position_lr_max_steps),
        "deformation": expon_lr_schedule(
            opt.deformation_lr_init * spatial_lr_scale,
            opt.deformation_lr_final * spatial_lr_scale,
            lr_delay_mult=opt.deformation_lr_delay_mult,
            max_steps=opt.deformation_lr_max_steps),
        "offsets": constant_lr(opt.offsets_lr),
        "f_dc": constant_lr(opt.feature_lr),
        "f_rest": constant_lr(opt.feature_lr / opt.feature_lr_div_factor),
        "opacity": constant_lr(opt.opacity_lr),
        "scaling": constant_lr(opt.scaling_lr),
        "rotation": constant_lr(opt.rotation_lr),
        "embedding": constant_lr(opt.feature_lr),
    })


