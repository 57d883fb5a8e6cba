"""The training step (port of ed3dgs_tpu/train/trainer.py: `TrainSetup`,
`make_train_step`, `init_train_state`).

One step renders the batch's cameras one after another (the JAX package's
`lax.map` "scan" mode), assembles the loss (L1, gated SSIM, opacity mean,
temporal TV, depth-normal on the last camera behind `radegs_from_iter`),
backpropagates through the blend kernels, the projection and the
deformation network in one autograd pass that also reads the gradient of
zero screen-space offsets (the densification statistic), applies the 9-group
Adam update and accumulates the densification statistics.

Not ported yet, and refused with NotImplementedError rather than skipped:
the KNN embedding regulariser (`reg_coef != 0`, kernels K6/K7 and the graph
cache), the tongue losses, COLMAP point-cloud supervision, the strip-exchange
comms and the vmapped batch. ROADMAP.md names the slice that brings each.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config.params import DeformHiddenConfig, OptimizationConfig
from ..models import gaussians as gm
from ..models.deformation import init_deform_params
from ..ops.rasterize import RasterConfig
from ..render import RenderSettings, render
from . import losses as L
from .densify import add_densification_stats
from .optim import TrainState, build_optimizer, flatten_params, unflatten_params

NEXT_SLICE = "slice 3 of the port (ROADMAP.md, Queue 1 item 7)"


@dataclass(frozen=True)
class TrainSetup:
    """Static configuration of the train step."""

    raster: RasterConfig
    hidden: DeformHiddenConfig
    batch_size: int
    white_background: bool = True
    kernel_size: float = 0.0
    disable_filter3d: bool = False
    use_coord_map: bool = False
    tongue_enabled: bool = False
    # loss coefficients (from OptimizationConfig)
    lambda_dssim: float = 0.0
    opacity_l1_coef: float = 0.0001
    reg_coef: float = 1.0
    coef_tv_temporal: float = 0.0
    lambda_depth_normal: float = 0.05
    radegs_from_iter: int = 15_000
    num_down_emb: int = 30
    sh_degree: int = 3
    colmap_supervision: bool = False
    batch_mode: str = "scan"
    comms: str = "gspmd"


def check_supported(setup: TrainSetup):
    """Raise for every part of the JAX step this slice does not carry."""
    if setup.reg_coef != 0:
        raise NotImplementedError(
            f"reg_coef={setup.reg_coef}: the KNN embedding regulariser (kernels K6, K7, "
            f"prepare_knn_graph, refresh_knn_cache) comes with {NEXT_SLICE}; "
            "pass reg_coef=0")
    if setup.tongue_enabled:
        raise NotImplementedError(f"tongue losses come with {NEXT_SLICE}")
    if setup.colmap_supervision:
        raise NotImplementedError(f"COLMAP point-cloud supervision comes with {NEXT_SLICE}")
    if setup.comms != "gspmd":
        raise NotImplementedError(
            f"comms={setup.comms!r}: the strip exchange comes with the multi-device "
            "slice (ROADMAP.md, Queue 1 item 12)")
    if setup.batch_mode != "scan":
        raise NotImplementedError(
            f"batch_mode={setup.batch_mode!r}: the port renders a batch one camera "
            "after another; the vmapped batch comes with the multi-device slice "
            "(ROADMAP.md, Queue 1 item 12)")


def _render_one(params, aux, dparams, setup: TrainSetup, settings, iteration, offset):
    # oneupSHdegree every 1000 iterations (train.py:129-130)
    bg = torch.full((3,), 1.0 if setup.white_background else 0.0, device=params.xyz.device)
    return render(params, aux, dparams, setup.hidden, settings, setup.raster, bg,
                  iteration=iteration, sh_degree=setup.sh_degree,
                  kernel_size=setup.kernel_size, disable_filter3d=setup.disable_filter3d,
                  num_down_emb_c=setup.num_down_emb, num_down_emb_f=setup.num_down_emb,
                  mean2d_offset=offset,
                  active_sh_degree=min(iteration // 1000, setup.sh_degree))


def make_loss_and_grads(setup: TrainSetup):
    """(params, aux, batch, iteration) -> (loss, metrics, grads, vs_grad,
    radii, visible): the step's forward and backward without the update.
    grads is {path: tensor} over every parameter (zeros where the loss does
    not reach); vs_grad [C, 2] is the gradient of the zero screen-space
    offsets, summed over the batch."""
    check_supported(setup)
    B = setup.batch_size

    def loss_fn(params, offsets, aux, batch, iteration):
        gparams: gm.GaussianParams = params["gaussians"]
        dparams = params["deform"]
        reg_kick_on = iteration >= setup.radegs_from_iter
        renders = []
        for b in range(B):
            settings = RenderSettings(batch["viewmatrix"][b], batch["projmatrix"][b],
                                      batch["campos"][b], batch["time"][b],
                                      batch["cam_no"][b])
            renders.append(_render_one(gparams, aux, dparams, setup, settings, iteration,
                                       offsets[b]))
        image = torch.stack([r["render"] for r in renders])           # [B, 3, H, W]
        gt = batch["gt_image"]
        zero = torch.zeros((), device=image.device)
        l1_items = L.l1_loss(image, gt, keepdim=True)
        l1 = torch.mean(l1_items)
        loss = l1

        use_ssim = bool(batch["use_ssim"])
        ssim_val = L.ssim(image, gt) if use_ssim else torch.ones((), device=image.device)
        if use_ssim:
            loss = loss + setup.lambda_dssim * ((1.0 - ssim_val) / 2.0)

        opa_loss = L.opacity_mean_loss(gparams.opacity, aux.alive)
        if setup.opacity_l1_coef > 0:
            loss = loss + setup.opacity_l1_coef * opa_loss

        tv_loss = zero
        if setup.coef_tv_temporal > 0:
            tv_loss = L.temporal_tv_loss(dparams["weight"])
            loss = loss + setup.coef_tv_temporal * tv_loss

        # depth-normal on the LAST batch entry only (train.py:247-271)
        r_last = renders[-1]
        dn = zero
        if reg_kick_on:
            rc = setup.raster
            dn = (L.coord_normal_loss(r_last["normal"], r_last["expected_coord"],
                                      r_last["median_coord"])
                  if setup.use_coord_map else
                  L.depth_normal_loss(r_last["normal"], r_last["expected_depth"],
                                      r_last["median_depth"], rc.width, rc.height,
                                      rc.focal_x, rc.focal_y))
            loss = loss + setup.lambda_depth_normal * dn

        radii = torch.stack([r["radii"] for r in renders]).amax(dim=0)
        visible = torch.stack([r["visibility_filter"] for r in renders]).any(dim=0)
        metrics = {
            "loss": loss, "l1": l1, "l1_items": l1_items,
            "psnr": torch.mean(L.psnr(image, gt)),
            "ssim": ssim_val, "emb_loss": zero, "tv_loss": tv_loss,
            "opacity_mean": opa_loss, "depth_normal": dn, "pcd_loss": zero,
            "num_pairs": torch.stack([r["num_pairs"] for r in renders]).amax(),
            "tile_overflow": torch.stack([r["tile_overflow"] for r in renders]).any(),
            "send_overflow": torch.zeros((), dtype=torch.int32, device=image.device),
        }
        return loss, metrics, radii, visible

    def loss_and_grads(params, aux, batch, iteration: int):
        flat = flatten_params(params)
        leaves = {p: t.detach().requires_grad_(True) for p, t in flat.items()}
        C = aux.alive.shape[0]
        offsets = torch.zeros((B, C, 2), dtype=torch.float32, device=aux.alive.device,
                              requires_grad=True)
        loss, metrics, radii, visible = loss_fn(unflatten_params(leaves), offsets, aux,
                                                batch, iteration)
        grads = torch.autograd.grad(loss, [*leaves.values(), offsets], allow_unused=True)
        g = {p: torch.zeros_like(leaves[p]) if d is None else d
             for p, d in zip(leaves, grads)}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, g, grads[-1].sum(dim=0), radii, visible

    return loss_and_grads


def make_train_step(setup: TrainSetup, optimizer):
    """The train step: (state, aux, batch) -> (state, aux, metrics), with
    `optimizer` from `init_train_state` (it holds the lr schedules). Batch
    entries (leading dim B): gt_image [B,3,H,W], viewmatrix [B,4,4],
    projmatrix [B,4,4], campos [B,3], time [B], cam_no [B]; use_ssim, a bool
    (the host-computed periodic SSIM gate, train.py:199)."""
    loss_and_grads = make_loss_and_grads(setup)

    def train_step(state: TrainState, aux: gm.GaussianAux, batch):
        iteration = int(state.iteration)
        _, metrics, grads, vs_grad, radii, visible = loss_and_grads(
            state.params, aux, batch, iteration)
        params, opt_state = optimizer.update(grads, state.opt_state, state.params)
        aux2 = add_densification_stats(aux, vs_grad, visible, radii)
        return TrainState(params, opt_state, iteration + 1), aux2, metrics

    return train_step


def init_train_state(params: gm.GaussianParams, hidden: DeformHiddenConfig,
                     opt_cfg: OptimizationConfig, spatial_lr_scale: float, seed: int = 0):
    """A fresh TrainState on the cloud's device: random deformation weights
    from a numpy seed (the numbers differ from jax.random's; carry a JAX
    model across with convert.py), zero moments. Returns (state, optimizer)."""
    dparams = init_deform_params(hidden, seed=seed, device=params.xyz.device)
    all_params = {"gaussians": params, "deform": dparams}
    optimizer = build_optimizer(opt_cfg, spatial_lr_scale)
    return TrainState(all_params, optimizer.init(all_params), 0), optimizer
