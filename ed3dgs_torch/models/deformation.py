"""Per-Gaussian embedding deformation network (E-D3DGS), port of
ed3dgs_tpu/models/deformation.py.

Two cascaded towers (coarse then fine), each a feature MLP over
[temporal embedding ++ per-Gaussian embedding] with five delta heads
(position/scale/rotation/opacity/SH). The learned temporal table is sampled
in the closed form of the reference's F.interpolate(align_corners=True) +
F.grid_sample(reflection) pipeline (scene/deformation.py:53-67).

Parameters are a nested dict of tensors with the JAX package's structure
(`{"weight", "offsets", "coarse": {"feature": [...], "heads": {...}},
"fine": ...}`), so checkpoints carry across key for key (see convert.py).
The MLP products are plain `torch.matmul`, as the JAX package leaves them to
XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config.params import DeformHiddenConfig
from ..device import resolve_device

HEADS = ("pos", "scale", "rot", "opacity", "sh")
HEAD_DIMS = {"pos": 3, "scale": 3, "rot": 4, "opacity": 1, "sh": 48}


def _linear_init(rng, fan_in, fan_out, dev):
    """torch.nn.Linear default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for
    weight and bias. Weights are stored [fan_in, fan_out] (x @ w)."""
    bound = 1.0 / math.sqrt(fan_in)
    w = rng.uniform(-bound, bound, (fan_in, fan_out)).astype(np.float32)
    b = rng.uniform(-bound, bound, (fan_out,)).astype(np.float32)
    return {"w": torch.as_tensor(w, device=dev), "b": torch.as_tensor(b, device=dev)}


def init_tower(rng: np.random.Generator, cfg: DeformHiddenConfig, dev):
    in_dim = cfg.temporal_embedding_dim + cfg.gaussian_embedding_dim
    W = cfg.net_width
    feature = [_linear_init(rng, in_dim, W, dev)]
    for _ in range(cfg.defor_depth - 1):
        feature.append(_linear_init(rng, W, W, dev))
    heads = {name: [_linear_init(rng, W, W, dev),
                    _linear_init(rng, W, HEAD_DIMS[name], dev)]
             for name in HEADS}
    return {"feature": feature, "heads": heads}


def init_deform_params(cfg: DeformHiddenConfig, seed: int = 0, device="cuda"):
    """Random parameters with the JAX package's init distributions
    (init_deform_params), drawn from a numpy generator seeded with `seed`.
    The numbers differ from jax.random's; load weights through convert.py
    to match a JAX model."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    if cfg.zero_temporal:
        weight = np.zeros((cfg.max_embeddings, cfg.temporal_embedding_dim), np.float32)
    else:
        weight = (rng.standard_normal((cfg.max_embeddings, cfg.temporal_embedding_dim))
                  * (0.01 / math.sqrt(cfg.temporal_embedding_dim))).astype(np.float32)
    return {
        "weight": torch.as_tensor(weight, device=dev),
        "offsets": torch.zeros((cfg.max_cameras, 1), dtype=torch.float32, device=dev),
        "coarse": init_tower(rng, cfg, dev),
        "fine": init_tower(rng, cfg, dev),
    }


def _abs(x):
    """|x| whose gradient at 0 is +1, as JAX's `abs` and the reference's
    grid_sample reflection (`reflect_coordinates_set_grad`) take it;
    `torch.abs` gives 0 there, which stops the time offset's gradient at
    t = 0 and t = 1."""
    return torch.where(x >= 0, x, -x)


def _reflect(x, size):
    """Reflection padding coordinate map with align_corners=True semantics:
    reflect about 0 and size-1 (period 2*(size-1))."""
    span = torch.clamp_min(size - 1.0, 1e-12)
    x = _abs(x)
    x = torch.remainder(x, 2.0 * span)
    return span - _abs(x - span)


def device_scalar(x, device) -> torch.Tensor:
    """x as a 0-d float32 tensor on `device`: a tensor cast where it lies, a
    Python number filled in on the device. A copy from host memory would
    make the host wait for the card, and a captured graph cannot hold one."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def temporal_embedding(weight: torch.Tensor, t: torch.Tensor, cur_emb) -> torch.Tensor:
    """Closed form of get_temporal_embed (scene/deformation.py:53-67).
    weight [max_emb, D]; t scalar time; cur_emb current embedding count
    (int or 0-d tensor). Returns [D]."""
    max_emb = weight.shape[0]
    cur = device_scalar(cur_emb, weight.device)
    top = torch.clamp_min(cur - 1.0, 0.0)
    # grid_sample y coordinate (align_corners): y = t*(cur-1), reflected
    y = _reflect(t * (cur - 1.0), cur)
    y0 = torch.minimum(torch.clamp_min(torch.floor(y), 0.0), top)
    f = y - y0
    # resized table row j sits at source coordinate j*(max_emb-1)/(cur-1)
    scale = (max_emb - 1.0) / torch.clamp_min(cur - 1.0, 1e-12)

    def resized_row(j):
        u = torch.clamp(j * scale, 0.0, max_emb - 1.0)
        u0 = torch.clamp(torch.floor(u), 0.0, max_emb - 1.0)
        g = u - u0
        i0 = u0.to(torch.int64).reshape(1)
        i1 = torch.clamp_max(i0 + 1, max_emb - 1)
        # index_select: indexing by a 0-d tensor reads the index on the host
        return (1.0 - g) * weight.index_select(0, i0)[0] + g * weight.index_select(0, i1)[0]

    r0 = resized_row(y0)
    r1 = resized_row(torch.minimum(y0 + 1.0, top))
    return (1.0 - f) * r0 + f * r1


def _dot(h, layer, dtype):
    """Linear layer at the tower's activation dtype: bf16 operands with an
    f32-accumulated product, rounded back to the activation dtype."""
    w = layer["w"].to(dtype)
    b = layer["b"].to(dtype)
    return torch.matmul(h, w).to(dtype) + b


def _run_feature(layers, h, dtype):
    h = _dot(h.to(dtype), layers[0], dtype)
    for layer in layers[1:]:
        h = _dot(torch.relu(h), layer, dtype)
    return h


def _run_head(head, h, dtype):
    x = _dot(torch.relu(h), head[0], dtype)
    return _dot(torch.relu(x), head[1], dtype).to(torch.float32)


def _tower_deform(tower, cfg, emb_t, embedding, xyz, scales, rotations, opacity,
                  sh, coef, coef_c, coef_o, coef_s):
    """query_time + deform for one tower (scene/deformation.py:72-106)."""
    n = xyz.shape[0]
    dt = torch.bfloat16 if cfg.bf16_activations else torch.float32
    h = torch.cat([emb_t[None, :].expand(n, emb_t.shape[0]), embedding], dim=-1)
    h = _run_feature(tower["feature"], h, dt)
    xyz = xyz + _run_head(tower["heads"]["pos"], h, dt) * coef
    if not cfg.no_ds:
        scales = scales + _run_head(tower["heads"]["scale"], h, dt) * coef * coef_s
    if not cfg.no_dr:
        rotations = rotations + _run_head(tower["heads"]["rot"], h, dt) * coef
    if not cfg.no_do:
        opacity = opacity + _run_head(tower["heads"]["opacity"], h, dt) * coef * coef_o
    if not cfg.no_dc:
        dc = _run_head(tower["heads"]["sh"], h, dt).reshape(n, 16, 3)
        sh = sh + dc * coef_c
    return xyz, scales, rotations, opacity, sh


def c2f_num_embeddings(cfg: DeformHiddenConfig, iteration, num_down_emb, device="cpu"):
    """int_lininterp of the embedding count (scene/deformation.py:69-70,80)."""
    it = torch.clamp(device_scalar(iteration, device), 0.0, cfg.c2f_temporal_iter)
    val = num_down_emb + (cfg.max_embeddings - num_down_emb) * it / cfg.c2f_temporal_iter
    return torch.floor(val).to(torch.int32)


def deform_forward(
    params,
    cfg: DeformHiddenConfig,
    xyz: torch.Tensor,          # [N, 3] raw positions
    scales: torch.Tensor,       # [N, 3] raw (log) scales
    rotations: torch.Tensor,    # [N, 4] raw quaternions
    opacity: torch.Tensor,      # [N, 1] raw (logit) opacity
    sh: torch.Tensor,           # [N, 16, 3]
    embedding: torch.Tensor,    # [N, E] per-gaussian embeddings
    time,                       # scalar time in [0,1]
    iteration,                  # a number or a 0-d tensor (on the device: no host copy)
    cam_no: Optional[torch.Tensor] = None,  # scalar int, or None in eval mode
    num_down_emb_c: int = 30,
    num_down_emb_f: int = 30,
):
    """Full cascade forward (scene/deformation.py:108-141). Returns
    (xyz, scales, rotations, opacity, sh) and extras = (coarse outputs,
    original inputs)."""
    dev = xyz.device
    offsets = params["offsets"][:, 0]
    if cam_no is None:
        # eval: mean of nonzero offsets, nan -> 0 (scene/deformation.py:112-114)
        cnt = torch.sum((offsets != 0.0).to(torch.float32))
        offset = torch.where(cnt > 0, torch.sum(offsets) / torch.clamp_min(cnt, 1.0),
                             torch.zeros_like(cnt))
    else:
        offset = offsets.index_select(0, cam_no.reshape(1).to(torch.int64))[0]
    t = device_scalar(time, dev) + offset

    it = device_scalar(iteration, dev)
    if cfg.use_anneal:
        coef = torch.clamp(it / 1000.0, 0.0, 1.0)
        coef_c = torch.clamp((it - cfg.deform_from_iter) / 1000.0, 0.0, 1.0)
        coef_o = coef_s = coef_c
    else:
        coef = coef_c = coef_o = coef_s = 1.0

    orig = (xyz, scales, rotations, opacity, sh)

    if cfg.no_coarse_deform:
        sub = orig
    else:
        if cfg.use_coarse_temporal_embedding:
            n_emb_c = num_down_emb_c
        elif cfg.no_c2f_temporal_embedding:
            n_emb_c = cfg.max_embeddings
        else:
            n_emb_c = c2f_num_embeddings(cfg, iteration, num_down_emb_c, dev)
        emb_c = temporal_embedding(params["weight"], t, n_emb_c)
        sub = _tower_deform(params["coarse"], cfg, emb_c, embedding, *orig,
                            coef, coef_c, coef_o, coef_s)

    if cfg.no_fine_deform:
        final = sub
    else:
        if cfg.no_c2f_temporal_embedding:
            n_emb_f = cfg.max_embeddings
        else:
            n_emb_f = c2f_num_embeddings(cfg, iteration, num_down_emb_f, dev)
        emb_f = temporal_embedding(params["weight"], t, n_emb_f)
        final = _tower_deform(params["fine"], cfg, emb_f, embedding, *sub,
                              coef, coef_c, coef_o, coef_s)

    return final, (sub, orig)


def mlp_param_labels(params):
    """Label tree for per-group learning rates, the structure of `params`:
    'offsets' for the per-camera time offsets, 'deformation' for everything
    else (the reference's get_mlp_parameters excludes offsets,
    scene/deformation.py:143-148)."""
    def label(node, group):
        if isinstance(node, dict):
            return {k: label(v, group) for k, v in node.items()}
        if isinstance(node, list):
            return [label(v, group) for v in node]
        return group
    return {k: label(v, "offsets" if k == "offsets" else "deformation")
            for k, v in params.items()}
