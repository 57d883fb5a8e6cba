"""Per-group Adam with exponential learning-rate schedules (port of
ed3dgs_tpu/train/optim.py, which builds it from optax).

The 9 reference parameter groups (scene/gaussian_model.py:199-209) with the
reference's learning rates, Adam b1 0.9, b2 0.999, eps 1e-15, and the
Plenoxels log-lerp schedule for positions and the deformation network
(utils/general_utils.py:32-79). The update is optax's, operation for
operation, in float32: each group keeps its own update count, which both its
bias correction and its schedule read (optax's `scale_by_adam` and
`scale_by_schedule` counts), not the trainer's iteration.

Parameters are `{"gaussians": GaussianParams, "deform": nested dict}`; the
optimizer addresses them by path ("gaussians/xyz",
"deform/coarse/feature/0/w"), the key scheme of the JAX package's
checkpoints. The Adam arithmetic is plain PyTorch: the JAX package leaves it
to XLA, not to a Pallas kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config.params import OptimizationConfig
from ..convert import unflatten
from ..models.deformation import mlp_param_labels
from ..models.gaussians import GaussianParams

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

    def update_table(self, opt_state: dict, device) -> torch.Tensor:
        """The scalars of the next update, [9 groups, 3] float32 on the CPU:
        each group's step (minus its learning rate) and its two bias
        corrections, as `update` computes them from the counts, bit for bit.
        For a CUDA `device` the corrections are their float32 reciprocals:
        PyTorch's CUDA division by a 0-d CPU tensor multiplies by the
        divisor's reciprocal, formed in float32 on the host, and `update`
        multiplies by the table's entries there (so a captured update that
        reads the table on the card computes what the eager one does)."""
        rows = []
        for g in GROUPS:
            count = opt_state[g].count
            row = [-self.schedules[g](count), _bias_correction(B1, count + 1),
                   _bias_correction(B2, count + 1)]
            if torch.device(device).type == "cuda":
                row[1:] = [1.0 / x for x in row[1:]]
            rows.append(torch.stack(row))
        return torch.stack(rows)

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


def build_optimizer(opt: OptimizationConfig, spatial_lr_scale: float) -> Optimizer:
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


def reset_moments_at(opt_state: dict, slot_mask: torch.Tensor) -> dict:
    """Zero the Adam moments at the Gaussian slots densification touched
    (the optimizer surgery of scene/gaussian_model.py:349-423): every moment
    whose leading dimension is the cloud's capacity. slot_mask [C] bool."""
    C = slot_mask.shape[0]

    def zero(x):
        if x.dim() >= 1 and x.shape[0] == C:
            return torch.where(slot_mask.reshape((C,) + (1,) * (x.dim() - 1)),
                               torch.zeros_like(x), x)
        return x

    return {g: st._replace(mu={p: zero(v) for p, v in st.mu.items()},
                           nu={p: zero(v) for p, v in st.nu.items()})
            for g, st in opt_state.items()}
