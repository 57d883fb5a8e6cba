"""The training step, the KNN graph cache and the densify step (port of
ed3dgs_tpu/train/trainer.py: `TrainSetup`, `update_knn_cache`,
`refresh_knn_cache`, `make_train_step`, `make_densify_step`,
`init_train_state`).

One step renders the batch's cameras one after another (the JAX package's
`lax.map` "scan" mode), assembles the loss (L1, gated SSIM, opacity mean,
the KNN embedding regulariser, temporal TV, depth-normal on the last camera
behind `radegs_from_iter`, and with `tongue_enabled` the tongue mask, KNN
and colour terms), backpropagates through the blend kernels, the
projection, the deformation network and the KNN loss kernels in one
autograd pass that also reads the gradient of zero screen-space offsets
(the densification statistic), applies the 9-group Adam update and
accumulates the densification statistics.

The KNN regulariser runs on a graph cache (`KnnCache`) rebuilt on the
densification cadence by `refresh_knn_cache`, which grows the graph's
capacity buckets until its dropped edges fit the coverage target. The JAX
package also pins the far list's memory layout after each refresh
(`_pin_row_major`); that is an XLA layout choice for the TPU with no
counterpart here.

With `colmap_supervision`, the step adds 0.01 x the chamfer term of the
batch's sampled GT cloud (`pcd_points`, `pcd_valid`) to the last camera's
deformed positions, after `deform_from_iter`.

With `mesh` (parallel/mesh.py) the step runs on one rank's shards of a
data x gauss mesh (parallel/sharded.py): `comms="gspmd"` gathers the
projected splat rows over the gauss group and blends whole images,
`comms="strip"` exchanges them strip by strip (parallel/tile_sharded.py).
`batch_mode="vmap"` is accepted for the JAX package's configurations: the
port has no vmap, so it renders camera by camera, as "scan" does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from ..config.params import DeformHiddenConfig, OptimizationConfig
from ..models import gaussians as gm
from ..models.deformation import init_deform_params
from ..ops import knn_loss
from ..ops.knn import far_shell
from ..ops.knn import knn as knn_op
from ..ops.rasterize import RasterConfig
from ..ops.binning import build_gaussian_payload
from ..parallel import comm
from ..parallel import sharded as psh
from ..parallel.tile_sharded import batched_strip_rasterize
from ..render import RenderSettings, assemble_outputs, project_for_render, render
from ..utils import trace
from ..utils.graphs import GraphedFunction, PinnedScalars, agree_on_key
from . import losses as L
from .densify import add_densification_stats, densify
from .optim import (GROUPS, AdamState, TrainState, build_optimizer, flatten_params,
                    reset_moments_at, unflatten_params)

KNN_K = 20              # neighbours per Gaussian (train.py:222 o3d_knn(..., 20))


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
    # COLMAP point-cloud supervision (train.py:273-295): chamfer of GT cloud
    # samples to the deformed Gaussians, active after deform_from_iter
    colmap_supervision: bool = False
    deform_from_iter: int = 0
    # "scan" and "vmap" both render the batch camera by camera: the JAX
    # package's vmap keeps B a batch axis for GSPMD, which the port's
    # explicit sharding does not need
    batch_mode: str = "scan"
    # with `mesh`: "gspmd" gathers the projected splat rows over the gauss
    # group, "strip" exchanges them strip by strip (parallel/tile_sharded.py)
    comms: str = "gspmd"
    mesh: Optional[object] = None          # parallel.mesh.Mesh, or None for one process
    send_capacity: Optional[int] = None    # per-(source, destination) strip buffer rows


def check_supported(setup: TrainSetup):
    """Raise for a configuration the step cannot run: an unknown comms or
    batch mode, the strip exchange without a mesh, or a batch that the
    mesh's data axis does not divide."""
    if setup.comms not in ("gspmd", "strip"):
        raise ValueError(f"comms={setup.comms!r}: want 'gspmd' or 'strip'")
    if setup.batch_mode not in ("scan", "vmap"):
        raise ValueError(f"batch_mode={setup.batch_mode!r}: want 'scan' or 'vmap'")
    if setup.comms == "strip" and setup.mesh is None:
        raise ValueError("comms='strip' exchanges splats between the ranks of a mesh: "
                         "pass TrainSetup.mesh")
    if setup.mesh is not None and setup.batch_size % setup.mesh.shape["data"]:
        raise ValueError(f"batch_size {setup.batch_size} (batch_mode={setup.batch_mode!r}) "
                         f"does not split over the mesh's data axis "
                         f"({setup.mesh.shape['data']})")


# --- the KNN graph cache ------------------------------------------------------

class KnnCache(NamedTuple):
    graph: knn_loss.KnnGraph     # the non-tongue embedding graph
    t_graph: knn_loss.KnnGraph   # the tongue graph (the same graph when tongue is off)


def _masked_coef(mask, k):
    m = mask.to(torch.float32)
    return m / torch.clamp_min(torch.sum(m) * k, 1.0)


def _graph_inputs(xyz, mask, shell, k):
    """(idx, w, coef, pts, pts_valid) of the masked points' graph, the rest
    parked on `shell`. Weights below float32's smallest normal are flushed
    to zero, as the JAX package's arithmetic (XLA on the CPU and the TPU)
    flushes them."""
    pts = torch.where(mask[:, None], xyz, shell)
    d2, idx = knn_op(pts, k=k)
    w = torch.exp(-2000.0 * torch.clamp_min(d2, 0.0))
    w = torch.where(mask[:, None] & (w >= torch.finfo(torch.float32).tiny), w,
                    torch.zeros_like(w))
    return idx, w, _masked_coef(mask, k), pts, mask


def _cache_inputs(params, aux, tongue_enabled, k):
    """The graph inputs of the cache: the main graph's, and the tongue
    graph's or None. Dead slots (and, for the main graph, tongue Gaussians)
    are parked on a far shell at ~1e3, which keeps them out of the live
    points' neighbourhoods and clusters them into their own Morton blocks;
    the tongue graph parks the rest on the mirrored shell."""
    tongue = torch.round(aux.tongue_class[:, 0]) > 0.5
    shell = far_shell(aux.alive.shape[0], aux.alive.device)
    main = _graph_inputs(params.xyz, aux.alive & ~tongue, shell, k)
    return main, (_graph_inputs(params.xyz, aux.alive & tongue, -shell, k)
                  if tongue_enabled else None)


def _prepare_cache(inputs, spill_a, spill_b, far_capacity) -> KnnCache:
    def prepare(idx, w, coef, pts, valid):
        return knn_loss.prepare_knn_graph(idx, w, coef, pts, pts_valid=valid, spill_a=spill_a,
                                          spill_b=spill_b, far_capacity=far_capacity)
    main, tongue = inputs
    graph = prepare(*main)
    return KnnCache(graph, graph if tongue is None else prepare(*tongue))


def update_knn_cache(params: gm.GaussianParams, aux: gm.GaussianAux,
                     tongue_enabled: bool = False, k: int = KNN_K,
                     spill_a: int = 512, spill_b: int = 768,
                     far_capacity: int = 1 << 19) -> KnnCache:
    """Recompute the embedding regulariser's neighbourhood graph
    (train.py:217-229) on the cloud's device and prepare it for the fused
    loss (ops/knn_loss.py) at the given capacity buckets."""
    return _prepare_cache(_cache_inputs(params, aux, tongue_enabled, k), spill_a, spill_b,
                          far_capacity)


# Default and ceiling capacity buckets of the KNN graph for
# refresh_knn_cache. At the ceiling the graph degrades deterministically
# (overflowing edges dropped from the loss and both gradient halves).
KNN_CAPS_DEFAULT = {"spill_a": 256, "spill_b": 768, "far": 1 << 19}
KNN_CAPS_MAX = {"spill_a": 4096, "spill_b": 8192, "far": 1 << 21}


def _snug_far(demand: int) -> int:
    """The 2^17-granular far bucket that holds 1.25x the demand."""
    return -(-int(demand * 1.25) // (1 << 17)) << 17


def refresh_knn_cache(params: gm.GaussianParams, aux: gm.GaussianAux,
                      caps: Optional[dict] = None, *, tongue_enabled: bool = False,
                      coverage_target: float = 0.95, k: int = KNN_K,
                      quiet: bool = True) -> KnnCache:
    """Build the KNN cache at adaptively sized capacity buckets, as the JAX
    package does: grow the buckets (doubling, the far bucket straight to a
    snug size, up to KNN_CAPS_MAX) until the dropped-edge count fits
    `(1 - coverage_target) * alive * k`, then shrink an oversized far
    bucket after three refreshes in a row that did not need it.
    coverage_target=1.0 demands the exact graph. `caps` is MUTATED, so a
    caller keeps the bucket state across refreshes. Traced as the region
    and host span "knn_refresh" (utils/trace.py)."""
    with trace.span("knn_refresh"), trace.region("knn_refresh", aux.alive.device):
        return _refresh_knn_cache(params, aux, caps, tongue_enabled, coverage_target, k, quiet)


def _refresh_knn_cache(params, aux, caps, tongue_enabled, coverage_target, k, quiet):
    caps = caps if caps is not None else dict(KNN_CAPS_DEFAULT)
    caps.setdefault("_far_quiet", 0)
    edges = int(aux.alive.sum()) * k
    budget = (1.0 - coverage_target) * max(edges, 1)
    # the neighbours do not depend on the buckets: search once, prepare per bucket
    inputs = _cache_inputs(params, aux, tongue_enabled, k)
    while True:
        cache = _prepare_cache(inputs, caps["spill_a"], caps["spill_b"], caps["far"])
        ovf = (cache.graph.overflow + cache.t_graph.overflow).tolist()
        if sum(ovf) <= budget:
            break
        grew = False
        for i, name in enumerate(("spill_a", "spill_b")):
            # while the total exceeds the budget, some bucket exceeds a third
            if ovf[i] > budget / 3 and caps[name] < KNN_CAPS_MAX[name]:
                caps[name] *= 2
                grew = True
        if ovf[2] > budget / 3 and caps["far"] < KNN_CAPS_MAX["far"]:
            # the far demand is exact at build time: jump to the snug bucket
            demand = max(int(cache.graph.n_far), int(cache.t_graph.n_far))
            caps["far"] = min(max(_snug_far(demand), caps["far"] + (1 << 17)),
                              KNN_CAPS_MAX["far"])
            grew = True
        if not grew:
            print(f"[knn] WARNING: dropped-edge count {sum(ovf)} exceeds the coverage "
                  f"budget {budget:.0f} at the bucket ceiling {caps}; the KNN "
                  f"regularizer runs on a deterministically truncated graph")
            break
        if not quiet:
            print(f"[knn] overflow {ovf} over budget {budget:.0f}; growing buckets to "
                  f"{caps}", flush=True)
    demand = max(int(cache.graph.n_far), int(cache.t_graph.n_far))
    want = max(1 << 15, _snug_far(max(demand, 1)))
    if want < caps["far"]:
        caps["_far_quiet"] += 1
        if caps["_far_quiet"] >= 3:
            caps["far"] = want
            caps["_far_quiet"] = 0
            if not quiet:
                print(f"[knn] far bucket -> {want} (demand {demand})", flush=True)
            # the shrunk bucket holds the demand: it drops no more than before
            return _prepare_cache(inputs, caps["spill_a"], caps["spill_b"], caps["far"])
    else:
        caps["_far_quiet"] = 0
    return cache


# --- the train step -------------------------------------------------------------

def _background(setup: TrainSetup, device):
    return torch.full((3,), 1.0 if setup.white_background else 0.0, device=device)


class StepBranches(NamedTuple):
    """The Python branches of one step, each a value of the iteration or
    the batch: the part of a captured step's key that is not a shape (the
    JAX step keeps them on the device, `trainer.py:242,270,359,382,395`)."""

    active_sh_degree: int   # oneupSHdegree every 1000 iterations (train.py:129-130)
    use_ssim: bool          # the host's periodic SSIM gate (train.py:199)
    depth_normal: bool      # the depth-normal term, from radegs_from_iter on
    colmap: bool            # COLMAP supervision, after deform_from_iter on a frame with a cloud


def step_branches(setup: TrainSetup, iteration: int, batch) -> StepBranches:
    return StepBranches(
        active_sh_degree=min(iteration // 1000, setup.sh_degree),
        use_ssim=bool(batch["use_ssim"]),
        depth_normal=iteration >= setup.radegs_from_iter,
        colmap=(setup.colmap_supervision and iteration > setup.deform_from_iter
                and bool(batch["pcd_valid"])))


def _project_kw(setup: TrainSetup, iteration, active_sh_degree: int):
    """`iteration` is what the deformation reads: a number, or a 0-d tensor
    on the device in a captured step."""
    return dict(iteration=iteration, sh_degree=setup.sh_degree,
                kernel_size=setup.kernel_size, disable_filter3d=setup.disable_filter3d,
                num_down_emb_c=setup.num_down_emb, num_down_emb_f=setup.num_down_emb,
                active_sh_degree=active_sh_degree)


def _render_one(params, aux, dparams, setup: TrainSetup, settings, it, active_sh, offset,
                tongue_filter=None):
    """One camera's render; on a mesh, of this rank's rows together with
    its gauss group's (gathered, or through the strip exchange)."""
    bg = _background(setup, params.xyz.device)
    kw = dict(_project_kw(setup, it, active_sh), tongue_filter=tongue_filter,
              mean2d_offset=offset)
    if setup.mesh is None or setup.comms == "strip":
        return render(params, aux, dparams, setup.hidden, settings, setup.raster, bg,
                      mesh=setup.mesh, send_capacity=setup.send_capacity, **kw)
    proj, shs_f, xyz_f, extras = project_for_render(params, aux, dparams, setup.hidden,
                                                    settings, setup.raster, **kw)
    out, num_pairs = psh.gathered_rasterize(proj, aux.tongue_class[:, 0], bg, setup.raster,
                                            setup.mesh)
    return dict(assemble_outputs(out, proj, shs_f, xyz_f, extras), num_pairs=num_pairs)


def _settings(batch, b):
    return RenderSettings(batch["viewmatrix"][b], batch["projmatrix"][b], batch["campos"][b],
                          batch["time"][b], batch["cam_no"][b])


def _strip_render_batch(gparams, aux, dparams, setup: TrainSetup, batch, offsets, it,
                        active_sh):
    """This rank's cameras through the strip exchange (--comms strip): each
    camera projected on this rank's rows, then one exchange a camera
    (parallel/tile_sharded.py: batched_strip_rasterize). Returns (the
    renders, one dict a camera, and the send overflow)."""
    projs, xyzs = [], []
    for b in range(offsets.shape[0]):
        proj, _, xyz_f, _ = project_for_render(
            gparams, aux, dparams, setup.hidden, _settings(batch, b), setup.raster,
            mean2d_offset=offsets[b], **_project_kw(setup, it, active_sh))
        projs.append(proj)
        xyzs.append(xyz_f)
    tongue = aux.tongue_class[:, 0]
    out, send_ovf = batched_strip_rasterize(
        torch.stack([build_gaussian_payload(p, tongue) for p in projs]),
        torch.stack([p.depth for p in projs]),
        torch.stack([p.valid & (p.tiles_touched > 0) for p in projs]),
        torch.stack([p.rect_min for p in projs]), torch.stack([p.rect_max for p in projs]),
        _background(setup, gparams.xyz.device), setup.raster, setup.mesh,
        send_capacity=setup.send_capacity)
    num_pairs = torch.stack([torch.sum(torch.where(p.valid, p.tiles_touched,
                                                   torch.zeros_like(p.tiles_touched)),
                                       dtype=torch.int32) for p in projs])
    comm.all_reduce_(num_pairs, setup.mesh, "gauss", "sum", "metric")
    renders = [{
        "render": out.color[b], "radii": p.radius, "visibility_filter": p.radius > 0,
        "expected_depth": out.expected_depth[b], "median_depth": out.median_depth[b],
        "normal": out.normal[b], "expected_coord": out.expected_coord[b],
        "median_coord": out.median_coord[b], "tongue_mask": out.tongue[b],
        "num_pairs": num_pairs[b], "tile_overflow": out.tile_overflow,
        "deformed_gaussian_positions": xyzs[b]} for b, p in enumerate(projs)]
    return renders, send_ovf


def _tongue_terms(setup: TrainSetup, gparams, aux, dparams, batch, knn_cache, r_last,
                  it, active_sh, rows):
    """The tongue losses of the last camera (train.py, tongue_mask_loss):
    the blended tongue channel against the tongue mask, the KNN term on the
    tongue graph, and the colour of the tongue-only and tongue-free renders
    inside and outside the mask: {name: term}, added to the loss in order
    with weights 5, reg_coef, 1 and 0.5."""
    gt = batch["gt_image"]
    gt_tongue = batch["tongue_gt"][-1]                                   # [1, H, W]
    t_l1 = L.l1_loss(gt_tongue[None], r_last["tongue_mask"][None], keepdim=True).mean()
    t_emb = knn_loss.knn_loss_fused(rows(gparams.embedding), knn_cache.t_graph, KNN_K)
    settings = _settings(batch, gt.shape[0] - 1)
    gt_mean = torch.mean(gt_tongue)
    r_tongue = _render_one(gparams, aux, dparams, setup, settings, it, active_sh, None, "only")
    t_rgb = torch.mean(torch.abs(gt[-1] * gt_tongue - r_tongue["render"] * gt_tongue))
    t_rgb = torch.where(gt_mean > 0.005, t_rgb / torch.clamp_min(gt_mean, 1e-8),
                        torch.zeros_like(t_rgb))
    r_wo = _render_one(gparams, aux, dparams, setup, settings, it, active_sh, None,
                       "without")
    inv = 1.0 - gt_tongue
    wo_rgb = torch.mean(torch.abs(gt[-1] * inv - r_wo["render"] * inv))
    wo_rgb = wo_rgb / torch.clamp_min(torch.mean(inv), 1e-8)
    return {"tongue_l1": t_l1, "tongue_emb": t_emb, "tongue_rgb": t_rgb,
            "wo_tongue_rgb": wo_rgb}


def make_loss_and_grads(setup: TrainSetup):
    """(params, aux, batch, knn_cache, iteration) -> (loss, metrics, grads,
    vs_grad, radii, visible): the step's forward and backward without the
    update. grads is {path: tensor} over every parameter (zeros where the
    loss does not reach); vs_grad [C, 2] is the gradient of the zero
    screen-space offsets, summed over the batch. On a mesh, params, aux and
    batch are this rank's shards, and every output is what the whole mesh
    computes (gradients summed, metrics global; parallel/sharded.py)."""
    check_supported(setup)
    B = setup.batch_size
    mesh = setup.mesh
    # global terms on the first data rank, the last camera's on the rank
    # that holds the global batch's last camera; the temporal TV reaches the
    # replicated network directly, so one rank of the world adds its gradient
    first = mesh is None or mesh.d == 0
    last = mesh is None or mesh.d == mesh.shape["data"] - 1
    tv_add_grad = mesh is None or mesh.g == 0

    def rows(x):
        """A per-Gaussian tensor of this rank's rows -> the whole cloud's."""
        return x if mesh is None else comm.all_gather_rows(x, mesh, "gauss", "state")

    def loss_fn(params, offsets, aux, batch, knn_cache, br: StepBranches, it):
        gparams: gm.GaussianParams = params["gaussians"]
        dparams = params["deform"]
        sh = br.active_sh_degree
        n_cam = offsets.shape[0]
        send_ovf = None
        if setup.comms == "strip":
            renders, send_ovf = _strip_render_batch(gparams, aux, dparams, setup, batch,
                                                    offsets, it, sh)
        else:
            renders = [_render_one(gparams, aux, dparams, setup, _settings(batch, b),
                                   it, sh, offsets[b]) for b in range(n_cam)]
        with trace.stage("loss"):
            return loss_terms(renders, gparams, aux, dparams, batch, knn_cache, br, it,
                              send_ovf)

    def loss_terms(renders, gparams, aux, dparams, batch, knn_cache, br: StepBranches, it,
                   send_ovf):
        """The batch's loss and the step's metrics from its renders."""
        sh = br.active_sh_degree
        n_cam = len(renders)
        image = torch.stack([r["render"] for r in renders])           # [B, 3, H, W]
        gt = batch["gt_image"]
        zero = torch.zeros((), device=image.device)
        # this rank's cameras' share of the global batch mean
        w = n_cam / B
        l1_items = L.l1_loss(image, gt, keepdim=True)
        l1 = torch.mean(l1_items) * w
        loss = l1

        ssim_val = (L.ssim(image, gt) * w if br.use_ssim
                    else torch.full((), w, device=image.device))
        if br.use_ssim:
            loss = loss + setup.lambda_dssim * ((w - ssim_val) / 2.0)

        opa_loss = emb_loss = tv_loss = zero
        if first:
            opa_loss = L.opacity_mean_loss(rows(gparams.opacity), rows(aux.alive))
            if setup.opacity_l1_coef > 0:
                loss = loss + setup.opacity_l1_coef * opa_loss
            emb_loss = knn_loss.knn_loss_fused(rows(gparams.embedding), knn_cache.graph, KNN_K)
            loss = loss + setup.reg_coef * emb_loss
            if setup.coef_tv_temporal > 0:
                tv_loss = L.temporal_tv_loss(dparams["weight"])
                tv_term = setup.coef_tv_temporal * tv_loss
                loss = loss + (tv_term if tv_add_grad else tv_term.detach())

        # depth-normal on the LAST batch entry only (train.py:247-271)
        r_last = renders[-1]
        dn = pcd_loss = zero
        if last and br.depth_normal:
            rc = setup.raster
            dn = (L.coord_normal_loss(r_last["normal"], r_last["expected_coord"],
                                      r_last["median_coord"])
                  if setup.use_coord_map else
                  L.depth_normal_loss(r_last["normal"], r_last["expected_depth"],
                                      r_last["median_depth"], rc.width, rc.height,
                                      rc.focal_x, rc.focal_y))
            loss = loss + setup.lambda_depth_normal * dn

        # COLMAP point-cloud supervision on the last batch entry's deformed
        # positions (train.py:273-295), skipped before deform_from_iter or
        # when the host found no GT cloud for the frame
        if last and br.colmap:
            pcd_loss = L.colmap_pcd_loss(batch["pcd_points"],
                                         rows(r_last["deformed_gaussian_positions"]),
                                         rows(aux.alive))
            loss = loss + 0.01 * pcd_loss  # closest_distance_coef (train.py:294)

        tongue_metrics = {}
        if setup.tongue_enabled:
            if last:
                tongue_metrics = _tongue_terms(setup, gparams, aux, dparams, batch, knn_cache,
                                               r_last, it, sh, rows)
            else:
                tongue_metrics = {k: zero for k in ("tongue_l1", "tongue_emb", "tongue_rgb",
                                                    "wo_tongue_rgb")}
            for name, weight in (("tongue_l1", 5.0), ("tongue_emb", setup.reg_coef),
                                 ("tongue_rgb", 1.0), ("wo_tongue_rgb", 0.5)):
                loss = loss + weight * tongue_metrics[name]

        radii = torch.stack([r["radii"] for r in renders]).amax(dim=0)
        visible = torch.stack([r["visibility_filter"] for r in renders]).any(dim=0)
        metrics = {
            "loss": loss, "l1": l1, "l1_items": l1_items,
            "psnr": torch.mean(L.psnr(image, gt)) * w,
            "ssim": ssim_val, "emb_loss": emb_loss, "tv_loss": tv_loss,
            "opacity_mean": opa_loss, "depth_normal": dn, "pcd_loss": pcd_loss,
            "num_pairs": torch.stack([r["num_pairs"] for r in renders]).amax(),
            "tile_overflow": torch.stack([r["tile_overflow"] for r in renders]).any(),
            "send_overflow": (torch.zeros((), dtype=torch.int32, device=image.device)
                              if send_ovf is None else send_ovf.to(torch.int32)),
            **tongue_metrics,
        }
        return loss, metrics, radii, visible

    def loss_and_grads(params, aux, batch, knn_cache: KnnCache, iteration: int,
                       device_iteration: Optional[torch.Tensor] = None):
        """`device_iteration`: a 0-d float32 tensor on the device holding
        `iteration`, which the deformation then reads (a captured step's
        static input) instead of the number."""
        flat = flatten_params(params)
        leaves = {p: t.detach().requires_grad_(True) for p, t in flat.items()}
        C = aux.alive.shape[0]
        n_cam = batch["gt_image"].shape[0]
        offsets = torch.zeros((n_cam, C, 2), dtype=torch.float32, device=aux.alive.device,
                              requires_grad=True)
        loss, metrics, radii, visible = loss_fn(
            unflatten_params(leaves), offsets, aux, batch, knn_cache,
            step_branches(setup, iteration, batch),
            iteration if device_iteration is None else device_iteration)
        with trace.stage("backward"):
            grads = torch.autograd.grad(loss, [*leaves.values(), offsets], allow_unused=True)
            g = {p: torch.zeros_like(leaves[p]) if d is None else d
                 for p, d in zip(leaves, grads)}
            vs_grad = grads[-1].sum(dim=0)
            metrics = {k: v.detach() for k, v in metrics.items()}
            if mesh is not None:
                g, vs_grad = psh.reduce_gradients(mesh, g, vs_grad)
                radii, visible = psh.reduce_densify_stats(mesh, radii, visible)
                metrics = psh.reduce_metrics(mesh, metrics)
        return metrics["loss"], metrics, g, vs_grad, radii, visible

    return loss_and_grads


def make_train_step(setup: TrainSetup, optimizer, graph: bool = True):
    """The train step: (state, aux, batch, knn_cache) -> (state, aux,
    metrics), the counterpart of ed3dgs_tpu/train/trainer.py:313-478
    (`make_train_step`, jitted by default), with `optimizer` from
    `init_train_state` (it holds the lr schedules) and `knn_cache` from
    `refresh_knn_cache`. Batch entries (leading dim B, or this rank's
    cameras of it): gt_image [B,3,H,W], viewmatrix [B,4,4], projmatrix
    [B,4,4], campos [B,3], time [B], cam_no [B], tongue_gt [B,1,H,W] (read
    with tongue_enabled), pcd_points [P,3] and pcd_valid, a bool (read with
    colmap_supervision); use_ssim, a bool (the host-computed periodic SSIM
    gate, train.py:199).

    graph=True (the default, as JAX's jit=True) runs the step on the card
    as a captured CUDA graph per key (`GraphedTrainStep`: the state it
    returns is its static buffers, which the next call overwrites); on a
    CPU state the same path runs eagerly. graph=False gives the eager,
    functional step on any device. On a mesh (`setup.mesh`), state, aux
    and batch are this rank's shards (parallel/sharded.py) and the metrics
    are global; graph=True then captures each rank's step with its
    collectives (the counterpart of the jitted `make_sharded_train_step`,
    ed3dgs_tpu/parallel/sharded.py:111), which NCCL allows and gloo does
    not: on the card a gloo mesh raises at the first call
    (`check_capturable`), and takes graph=False."""
    check_supported(setup)
    if graph:
        return GraphedTrainStep(setup, optimizer)
    return _eager_step(setup, optimizer)


def check_capturable(setup: TrainSetup, device):
    """Raise unless the step of `setup` can be captured on `device`: a
    mesh's collectives on the card are captured only over NCCL (gloo runs
    its collectives on the host)."""
    mesh = setup.mesh
    if torch.device(device).type == "cuda" and mesh is not None and mesh.backend == "gloo":
        raise ValueError("graph=True on the card with a gloo mesh: gloo's collectives cannot "
                         "be captured in a CUDA graph; pass graph=False (the eager step), or "
                         "give each rank a GPU of its own and use nccl")


def _eager_step(setup: TrainSetup, optimizer):
    loss_and_grads = make_loss_and_grads(setup)

    def train_step(state: TrainState, aux: gm.GaussianAux, batch, knn_cache: KnnCache):
        iteration = int(state.iteration)
        _, metrics, grads, vs_grad, radii, visible = loss_and_grads(
            state.params, aux, batch, knn_cache, iteration)
        params, opt_state = optimizer.update(grads, state.opt_state, state.params)
        aux2 = add_densification_stats(aux, vs_grad, visible, radii)
        return TrainState(params, opt_state, iteration + 1), aux2, metrics

    return train_step


_KNN_FIELDS = ("pi", "inv", "nbr", "w", "coef", "rev_ptr", "rev_pair")   # what the step reads


class GraphedTrainStep(GraphedFunction):
    """The train step as a CUDA graph captured per key and replayed: the
    port's `jax.jit(train_step)`.

    Each call is "prepare, then replay, then return the static state":
      * the inputs are copied into static buffers, each unless it is that
        buffer already: the state and aux this step returned need no copy;
        the state a densify step returns, a new KNN cache (its reverse
        adjacency padded to the graph's Cp*K in-edges) and the batch get one
        copy on the card;
      * the update's schedule and bias corrections (`Optimizer.update_table`)
        and the iteration, which the deformation reads, go to the card
        through pinned memory (utils/graphs.py `PinnedScalars`);
      * the key is the step's Python branches (`StepBranches`: the active SH
        degree, the SSIM gate, the depth-normal term, the COLMAP gate) and
        every input's shape; a new key is run once eagerly on a side stream
        and captured (utils/graphs.py `GraphCache`); a known one is replayed;
      * the graph ends by writing the new parameters, Adam moments and aux
        statistics into the static buffers, and the metrics into its own.
    The returned state, aux and metrics ARE those static buffers: the next
    call writes into them, as a donated `jax.jit` argument would be. Keep a
    copy (`clone`) of anything needed after the next step.

    A new input signature (other shapes) gets new static buffers, and the
    graphs captured on the old ones are dropped.

    On a mesh each rank holds the static buffers of its shards and captures
    its own graph, the step's collectives (the gathers and all-to-alls of
    the forward and of autograd's backward, the gradient and metric
    reductions) inside it. Before a key's first run the ranks agree on it
    (utils/graphs.py `agree_on_key`); a replay is not checked, so every
    part of the key is a value all ranks share (the iteration, the SSIM
    gate of the identically seeded sampler, the shapes, which capacities
    that follow max-reduced metrics set). A replay appends the collectives
    of the key's first run to parallel/comm.py's ledger.

    On a CPU state the same prepare, body and return run eagerly, without
    a graph (the CPU has none): bit for bit the eager step."""

    def __init__(self, setup: TrainSetup, optimizer):
        super().__init__("train step")
        check_supported(setup)
        self.setup, self.optimizer = setup, optimizer
        self.loss_and_grads = make_loss_and_grads(setup)
        self._agreed = set()         # keys the mesh's ranks agreed on
        self._records = {}           # key -> the ledger records of its first run

    def __call__(self, state: TrainState, aux: gm.GaussianAux, batch, knn_cache: KnnCache):
        check_capturable(self.setup, aux.alive.device)
        iteration = int(state.iteration)
        with trace.span("step", call=iteration) as sp:
            with trace.span("inputs"):
                named = self._inputs(state, aux, batch, knn_cache)
                key = (step_branches(self.setup, iteration, batch), self._shapes(named))
                replay = sp.replayed = self.graphs is not None and key in self.graphs
            with trace.span("copy_in"):
                st = self.prepare(key[1], named,
                                  lambda: self._allocate(named, state, aux, batch, knn_cache))
            with trace.span("scalars"):
                scalars = torch.cat([self.optimizer.update_table(state.opt_state,
                                                                 aux.alive.device)
                                     .reshape(-1), torch.tensor([float(iteration)])])
                st["scalars"].write(scalars)
            with trace.span("launch"):
                body = self._body(st, key[0], iteration)
                mesh = self.setup.mesh
                if mesh is not None and key not in self._agreed:
                    if mesh.group("world") is not None:
                        agree_on_key(key, mesh.group("world"), aux.alive.device)
                    self._agreed.add(key)
                first = len(comm.ledger.records)
                metrics = self.run(key, body, aux.alive.device)
            if mesh is not None and replay:
                comm.ledger.replay(self._records[key])
            elif mesh is not None:
                self._records[key] = comm.ledger.records[first:]
            opt_state = {g: AdamState(state.opt_state[g].count + 1, st["mu"][g], st["nu"][g])
                         for g in GROUPS}
            return TrainState(st["params_tree"], opt_state, iteration + 1), st["aux"], metrics

    def key(self, state, aux, batch, knn_cache) -> tuple:
        """(StepBranches, the inputs' shapes and dtypes): the graph a call
        replays."""
        return (step_branches(self.setup, int(state.iteration), batch),
                self._shapes(self._inputs(state, aux, batch, knn_cache)))

    @staticmethod
    def _inputs(state, aux, batch, knn_cache) -> dict:
        """{name: tensor} of every tensor the step reads."""
        named = {f"params/{p}": t for p, t in flatten_params(state.params).items()}
        for g in GROUPS:
            named.update({f"mu/{g}/{p}": t for p, t in state.opt_state[g].mu.items()})
            named.update({f"nu/{g}/{p}": t for p, t in state.opt_state[g].nu.items()})
        named.update({f"aux/{f}": getattr(aux, f) for f in aux._fields})
        named.update({f"batch/{k}": v for k, v in batch.items()
                      if isinstance(v, torch.Tensor)})
        graphs = [knn_cache.graph] + ([] if knn_cache.t_graph is knn_cache.graph
                                      else [knn_cache.t_graph])
        for i, gr in enumerate(graphs):
            named.update({f"knn{i}/{f}": getattr(gr, f) for f in _KNN_FIELDS})
        return named

    @staticmethod
    def _shapes(named: dict) -> tuple:
        out = []
        for name, t in named.items():
            # the reverse adjacency's length changes at every refresh: its
            # static buffer holds the most it can need, Cp*K in-edges
            shape = (0,) if name.endswith("/rev_pair") else tuple(t.shape)
            out.append((name, shape, t.dtype))
        return tuple(out)

    @staticmethod
    def _allocate(named, state, aux, batch, knn_cache) -> dict:
        flat = {}
        for name, t in named.items():
            if name.endswith("/rev_pair"):
                nbr = named[name.replace("rev_pair", "nbr")]
                flat[name] = torch.zeros(nbr.numel(), dtype=t.dtype, device=t.device)
            else:
                flat[name] = torch.empty_like(t, memory_format=torch.contiguous_format)
        params = {p[len("params/"):]: t for p, t in flat.items() if p.startswith("params/")}
        mu = {g: {p: flat[f"mu/{g}/{p}"] for p in state.opt_state[g].mu} for g in GROUPS}
        nu = {g: {p: flat[f"nu/{g}/{p}"] for p in state.opt_state[g].nu} for g in GROUPS}

        def graph_of(i, gr):
            return gr._replace(**{f: flat[f"knn{i}/{f}"] for f in _KNN_FIELDS})
        graph = graph_of(0, knn_cache.graph)
        t_graph = (graph if knn_cache.t_graph is knn_cache.graph
                   else graph_of(1, knn_cache.t_graph))
        dev = aux.alive.device
        return {
            "flat": flat, "params": params, "params_tree": unflatten_params(params),
            "mu": mu, "nu": nu,
            "aux": aux._replace(**{f: flat[f"aux/{f}"] for f in aux._fields}),
            "batch": {k: flat.get(f"batch/{k}", v) for k, v in batch.items()},
            "cache": KnnCache(graph, t_graph),
            "scalars": PinnedScalars(len(GROUPS) * 3 + 1, dev),
        }

    def _body(self, st: dict, br: StepBranches, iteration: int):
        """The step on the static buffers, writing its results back into
        them; returns the metrics. Everything it reads from the host is
        baked in per key: `br`, the shapes, the batch's host bools."""
        setup, optimizer = self.setup, self.optimizer
        scalars = st["scalars"].values
        table = scalars[:len(GROUPS) * 3].view(len(GROUPS), 3)
        it = scalars[len(GROUPS) * 3]
        batch = dict(st["batch"], use_ssim=br.use_ssim)
        if setup.colmap_supervision:
            batch["pcd_valid"] = br.colmap

        def body():
            params, aux = st["params_tree"], st["aux"]
            opt_state = {g: AdamState(0, st["mu"][g], st["nu"][g]) for g in GROUPS}
            with trace.region("step", aux.alive.device):
                # the branches are the key's: the iteration passed here only
                # selects them again, the deformation reads `it`
                _, metrics, grads, vs_grad, radii, visible = self.loss_and_grads(
                    params, aux, batch, st["cache"], iteration, device_iteration=it)
                with trace.stage("adam"):
                    new_params, new_opt = optimizer.update(grads, opt_state, params,
                                                           table=table)
                with trace.stage("writeback"):
                    aux2 = add_densification_stats(aux, vs_grad, visible, radii)
                    for p, t in flatten_params(new_params).items():
                        st["params"][p].copy_(t)
                    for g in GROUPS:
                        for p in st["mu"][g]:
                            st["mu"][g][p].copy_(new_opt[g].mu[p])
                            st["nu"][g][p].copy_(new_opt[g].nu[p])
                    for f in aux._fields:
                        new, old = getattr(aux2, f), getattr(aux, f)
                        if new is not old:
                            old.copy_(new)
            return metrics

        return body


def make_densify_step(opt_cfg: OptimizationConfig, percent_dense: float,
                      scene_extent: float, graph: bool = True):
    """(state, aux, generator, grad_threshold[, noise]) -> (state, aux,
    n_cloned, n_split): densify the cloud (train/densify.py) and zero the
    Adam moments of every slot it touched, the counterpart of
    ed3dgs_tpu/train/trainer.py:481-497 (jitted). The caller then refreshes
    the 3D filter and the KNN cache, as tools/train.py does; n_cloned and
    n_split are 0-d tensors on the cloud's device, for the caller to read
    after the step.

    graph=True (the default) runs it on the card as a CUDA graph captured
    per input signature (`GraphedDensifyStep`; on a CPU state the same path
    runs eagerly); graph=False gives the eager, functional step."""
    if graph:
        return GraphedDensifyStep(opt_cfg, percent_dense, scene_extent)

    def densify_step(state: TrainState, aux, generator, grad_threshold, noise=None):
        res = densify(state.params["gaussians"], aux, generator,
                      grad_threshold=grad_threshold, percent_dense=percent_dense,
                      scene_extent=scene_extent, max_gaussians=opt_cfg.max_number_gaussians,
                      noise=noise)
        params = dict(state.params)
        params["gaussians"] = res.params
        opt_state = reset_moments_at(state.opt_state, res.reset_mask)
        return (TrainState(params, opt_state, state.iteration), res.aux, res.n_cloned,
                res.n_split)

    return densify_step


class GraphedDensifyStep(GraphedFunction):
    """The densify step as a CUDA graph captured per input signature and
    replayed: the port's jitted `make_densify_step`.

    Each call copies the cloud's parameters, its aux arrays, the Adam
    moments of its rows and the split children's noise into static buffers
    (each unless it is that buffer already), writes the gradient threshold
    to the card through pinned memory (utils/graphs.py `PinnedScalars`), and
    replays the graph, which writes the densified cloud, its aux and the
    moments back into the static buffers. The noise is drawn before the
    replay from the caller's generator, the draw the eager step makes
    inside: with the same generator state both give the same bits. The
    deformation network and its moments are not touched and pass through.
    The returned state and aux ARE the static buffers, which the next call
    overwrites, and n_cloned and n_split the graph's own outputs.

    On a CPU state the same prepare, body and return run eagerly."""

    def __init__(self, opt_cfg: OptimizationConfig, percent_dense: float, scene_extent: float):
        super().__init__("densify step")
        self.percent_dense, self.scene_extent = percent_dense, scene_extent
        self.max_gaussians = opt_cfg.max_number_gaussians

    def __call__(self, state: TrainState, aux, generator, grad_threshold, noise=None):
        C = aux.alive.shape[0]
        dev = aux.alive.device
        it = state.iteration if isinstance(state.iteration, int) else None
        with trace.span("densify_step", call=it) as sp:
            if noise is None:
                noise = torch.randn((2, C, 3), generator=generator, device=dev)
            named = self._inputs(state, aux, noise)
            signature = tuple((k, tuple(t.shape), t.dtype) for k, t in named.items())
            sp.replayed = self.graphs is not None and signature in self.graphs
            st = self.prepare(signature, named, lambda: self._allocate(named, state, aux))
            st["threshold"].write(torch.tensor([float(grad_threshold)]))
            counts = self.run(signature, self._body(st), dev)
        params = dict(state.params)
        params["gaussians"] = st["params"]
        opt_state = {g: s._replace(mu={**s.mu, **st["mu"][g]}, nu={**s.nu, **st["nu"][g]})
                     for g, s in state.opt_state.items()}
        return (TrainState(params, opt_state, state.iteration), st["aux"], counts["n_cloned"],
                counts["n_split"])

    @staticmethod
    def _inputs(state, aux, noise) -> dict:
        """{name: tensor} of every tensor the step reads and writes: the
        moments of the cloud's rows only (leading dimension the capacity)."""
        C = aux.alive.shape[0]
        gp = state.params["gaussians"]
        named = {f"params/{f}": getattr(gp, f) for f in gp._fields}
        named.update({f"aux/{f}": getattr(aux, f) for f in aux._fields})
        for g, s in state.opt_state.items():
            for part in ("mu", "nu"):
                named.update({f"{part}/{g}/{p}": t for p, t in getattr(s, part).items()
                              if t.dim() >= 1 and t.shape[0] == C})
        named["noise"] = noise
        return named

    @staticmethod
    def _allocate(named, state, aux) -> dict:
        flat = {k: torch.empty_like(t, memory_format=torch.contiguous_format)
                for k, t in named.items()}
        gp = state.params["gaussians"]
        moments = {part: {g: {k.split("/", 2)[2]: t for k, t in flat.items()
                              if k.startswith(f"{part}/{g}/")} for g in state.opt_state}
                   for part in ("mu", "nu")}
        return {
            "flat": flat, "mu": moments["mu"], "nu": moments["nu"],
            "params": gp._replace(**{f: flat[f"params/{f}"] for f in gp._fields}),
            "aux": aux._replace(**{f: flat[f"aux/{f}"] for f in aux._fields}),
            "threshold": PinnedScalars(1, aux.alive.device),
        }

    def _body(self, st: dict):
        """The densify step on the static buffers, writing its results back
        into them; returns the counts. The threshold is read on the card."""
        def body():
            with trace.region("densify_step", st["aux"].alive.device):
                res = densify(st["params"], st["aux"],
                              grad_threshold=st["threshold"].values[0],
                              percent_dense=self.percent_dense,
                              scene_extent=self.scene_extent,
                              max_gaussians=self.max_gaussians, noise=st["flat"]["noise"])
                reset = reset_moments_at({g: AdamState(0, st["mu"][g], st["nu"][g])
                                          for g in st["mu"]}, res.reset_mask)
                for old, new in zip(st["params"], res.params):
                    old.copy_(new)
                for old, new in zip(st["aux"], res.aux):
                    if new is not old:
                        old.copy_(new)
                for g, moments in reset.items():
                    for p, t in moments.mu.items():
                        st["mu"][g][p].copy_(t)
                    for p, t in moments.nu.items():
                        st["nu"][g][p].copy_(t)
            return {"n_cloned": res.n_cloned, "n_split": res.n_split}

        return body


def init_train_state(params: gm.GaussianParams, hidden: DeformHiddenConfig,
                     opt_cfg: OptimizationConfig, spatial_lr_scale: float, seed: int = 0):
    """A fresh TrainState on the cloud's device: random deformation weights
    from a numpy seed (the numbers differ from jax.random's; carry a JAX
    model across with convert.py), zero moments. Returns (state, optimizer)."""
    dparams = init_deform_params(hidden, seed=seed, device=params.xyz.device)
    all_params = {"gaussians": params, "deform": dparams}
    optimizer = build_optimizer(opt_cfg, spatial_lr_scale)
    return TrainState(all_params, optimizer.init(all_params), 0), optimizer
