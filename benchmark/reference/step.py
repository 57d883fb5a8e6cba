"""The plain reference of the training step and the served frame, on one
device, from the same inputs the program gets.

It works out again everything the program's set-up derives: the 3D filter
of the cloud, the embedding regulariser's k-NN graph with the edges its
capacity buckets drop at the configuration's coverage target, the Adam
state. One step is the program's loss (L1,
the gated SSIM, the opacity mean, the KNN embedding regulariser, the
temporal TV, depth-normal on the last camera), its gradient by autograd
through the plain blend, the 9-group Adam update and the densification
statistics; the densify event is `densify.densify` with the noise given.

`lower_precision(cfg)` under `tf32()` computes the reference one step below
the precision the configuration states (the control of the benchmark's
comparison): the deformation MLP's bf16 operands rounded to float8 (e4m3,
one scale per tensor, as an fp8 GEMM takes them) and float32 matmuls in
TF32.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import NamedTuple

import torch

from . import gaussians as gm
from . import losses as L
from .densify import add_densification_stats, densify
from .knn import far_shell, knn_plain
from .knn_graph import KNN_CAPS_DEFAULT, effective_weights
from .optim import AdamState, build_optimizer, flatten_params, unflatten_params
from .rasterize import RasterConfig
from .render import RenderSettings, render

KNN_K = 20              # neighbours per Gaussian (the reference train.py o3d_knn(..., 20))
KNN_EPS = 1e-20         # the regulariser's sqrt epsilon


@contextlib.contextmanager
def tf32(on: bool = True):
    """float32 matmuls in TF32 while it is open (the control's float32)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def lower_precision(cfg: "StepConfig") -> "StepConfig":
    """The configuration one precision step down for the MLP: its bf16
    operands rounded to float8 (run it under `tf32()` for the float32
    matmuls)."""
    return cfg._replace(hidden=SimpleNamespace(**vars(cfg.hidden), fp8_operands=True))


class StepConfig(NamedTuple):
    """What one step reads of the configuration (the cell's config file)."""

    raster: RasterConfig
    hidden: object              # the deformation network's settings (attributes)
    opt: object                 # the optimisation settings (attributes)
    white_background: bool
    kernel_size: float
    sh_degree: int
    extent: float               # the scene extent (position and deformation lr scale)


def filter_3d(xyz, alive, view_mats, focals_x, focals_y, widths, heights):
    return gm.compute_3d_filter(xyz, alive, view_mats, focals_x, focals_y, widths, heights)


def knn_graph(xyz, alive, caps: dict, coverage_target: float, k: int = KNN_K):
    """(idx, w, coef) of the alive points' k-NN graph: dead slots parked on
    the far shell, weights exp(-2000 d^2) flushed below float32's smallest
    normal, each alive point's coefficient 1 / (alive * k); the edges that
    the graph's capacity buckets at `coverage_target` cannot hold weigh 0
    (knn_graph.py; `caps` carries the buckets from refresh to refresh)."""
    pts = torch.where(alive[:, None], xyz, far_shell(alive.shape[0], alive.device))
    d2, idx = knn_plain(pts, k=k)
    w = torch.exp(-2000.0 * torch.clamp_min(d2, 0.0))
    w = torch.where(alive[:, None] & (w >= torch.finfo(torch.float32).tiny), w,
                    torch.zeros_like(w))
    m = alive.to(torch.float32)
    coef = m / torch.clamp_min(torch.sum(m) * k, 1.0)
    w, _ = effective_weights(idx, w, coef, pts, alive, caps, coverage_target)
    return idx, w, coef


def knn_loss(emb, graph):
    """sum_ik coef_i sqrt(|e_i - e_j|^2 w_ik + eps), over every edge."""
    idx, w, coef = graph
    d2 = torch.sum((emb[:, None, :] - emb[idx.long()]) ** 2, dim=-1)
    return torch.sum(coef[:, None] * torch.sqrt(d2 * w + KNN_EPS))


def _render_kw(cfg: StepConfig, iteration):
    h = cfg.hidden
    return dict(iteration=iteration, sh_degree=cfg.sh_degree, kernel_size=cfg.kernel_size,
                disable_filter3d=False, num_down_emb_c=h.min_embeddings,
                num_down_emb_f=h.min_embeddings)


def frame(params, aux, dparams, cfg: StepConfig, view, proj, campos, time):
    """One served frame's image [3, H, W] (no camera id: eval mode)."""
    dev = params.xyz.device
    s = RenderSettings(view, proj, campos, torch.tensor(float(time), device=dev), None)
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=dev)
    with torch.no_grad():
        return render(params, aux, dparams, cfg.hidden, s, cfg.raster, bg,
                      **_render_kw(cfg, 10 ** 9))["render"]


def loss_and_grads(params: dict, aux, batch: dict, graph, iteration: int, cfg: StepConfig):
    """(loss, l1_items, {path: gradient}, viewspace gradient [C, 2], radii,
    visible) of one step at `iteration`; batch as the program's step takes it."""
    opt = cfg.opt
    flat = flatten_params(params)
    leaves = {p: t.detach().requires_grad_(True) for p, t in flat.items()}
    tree = unflatten_params(leaves)
    gp, dp = tree["gaussians"], tree["deform"]
    C = aux.alive.shape[0]
    B = batch["gt_image"].shape[0]
    offsets = torch.zeros((B, C, 2), device=aux.alive.device, requires_grad=True)
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=aux.alive.device)
    active_sh = min(iteration // 1000, cfg.sh_degree)
    renders = []
    for b in range(B):
        s = RenderSettings(batch["viewmatrix"][b], batch["projmatrix"][b], batch["campos"][b],
                           batch["time"][b], batch["cam_no"][b])
        renders.append(render(gp, aux, dp, cfg.hidden, s, cfg.raster, bg,
                              mean2d_offset=offsets[b], active_sh_degree=active_sh,
                              **_render_kw(cfg, iteration)))
    image = torch.stack([r["render"] for r in renders])
    gt = batch["gt_image"]
    l1_items = L.l1_loss(image, gt, keepdim=True)
    loss = torch.mean(l1_items)
    if batch["use_ssim"]:
        loss = loss + opt.lambda_dssim * ((1.0 - L.ssim(image, gt)) / 2.0)
    if opt.opacity_l1_coef_fine > 0:
        loss = loss + opt.opacity_l1_coef_fine * L.opacity_mean_loss(gp.opacity, aux.alive)
    loss = loss + opt.reg_coef * knn_loss(gp.embedding, graph)
    if opt.coef_tv_temporal_embedding > 0:
        loss = loss + opt.coef_tv_temporal_embedding * L.temporal_tv_loss(dp["weight"])
    if iteration >= opt.radegs_regularization_from_iter:
        r, rc = renders[-1], cfg.raster
        loss = loss + opt.lambda_depth_normal * L.depth_normal_loss(
            r["normal"], r["expected_depth"], r["median_depth"], rc.width, rc.height,
            rc.focal_x, rc.focal_y)
    grads = torch.autograd.grad(loss, [*leaves.values(), offsets], allow_unused=True)
    g = {p: torch.zeros_like(leaves[p]) if d is None else d for p, d in zip(leaves, grads)}
    radii = torch.stack([r["radii"] for r in renders]).amax(dim=0)
    visible = torch.stack([r["visibility_filter"] for r in renders]).any(dim=0)
    return loss.detach(), l1_items.detach(), g, grads[-1].sum(dim=0), radii, visible


class Trainer:
    """The reference's training state: parameters, Adam state, aux."""

    def __init__(self, params: dict, aux, cfg: StepConfig):
        self.cfg = cfg
        self.optimizer = build_optimizer(cfg.opt, cfg.extent)
        self.params, self.aux = params, aux
        self.opt_state = self.optimizer.init(params)

    def step(self, batch: dict, graph, iteration: int) -> dict:
        """One step; returns its loss and each leaf's gradient."""
        loss, _, grads, vs_grad, radii, visible = loss_and_grads(
            self.params, self.aux, batch, graph, iteration, self.cfg)
        self.params, self.opt_state = self.optimizer.update(grads, self.opt_state, self.params)
        self.aux = add_densification_stats(self.aux, vs_grad, visible, radii)
        return {"loss": loss, "grads": grads}

    def densify(self, grad_threshold: float, noise):
        """A densify event: clone and split, then zero the touched slots'
        moments."""
        opt = self.cfg.opt
        res = densify(self.params["gaussians"], self.aux, grad_threshold=grad_threshold,
                      percent_dense=opt.percent_dense, scene_extent=self.cfg.extent,
                      max_gaussians=opt.max_number_gaussians, noise=noise)
        self.params = dict(self.params, gaussians=res.params)
        self.aux = res.aux
        C = res.reset_mask.shape[0]

        def zero(x):
            if x.dim() >= 1 and x.shape[0] == C:
                m = res.reset_mask.reshape((C,) + (1,) * (x.dim() - 1))
                return torch.where(m, torch.zeros_like(x), x)
            return x
        self.opt_state = {g: AdamState(s.count, {p: zero(v) for p, v in s.mu.items()},
                                       {p: zero(v) for p, v in s.nu.items()})
                          for g, s in self.opt_state.items()}
        return int(res.n_cloned), int(res.n_split)
