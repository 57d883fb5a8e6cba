"""The data x gauss sharded training step (port of
ed3dgs_tpu/parallel/sharded.py).

The JAX package annotates shardings and lets GSPMD insert the collectives.
Here each rank runs the step on its own shard and the collectives are
explicit (parallel/comm.py):

  * state: every tensor whose leading axis is the Gaussian capacity (the
    cloud's parameters, their Adam moments, the aux arrays) keeps rows
    [g*C/G, (g+1)*C/G) on gauss rank g; the deformation network and its
    moments are replicated; so is the KNN graph cache, which every rank
    builds from the gathered cloud (K6 and K7 then run on the gathered
    embedding table, and each rank keeps its rows of dL/de);
  * batch: data rank d renders cameras [d*B/D, (d+1)*B/D) of the global
    batch (`shard_batch`); the sampled COLMAP cloud and the SSIM gate are
    replicated;
  * the step (train/trainer.py with `TrainSetup.mesh`): each rank deforms
    and projects its rows; with comms="gspmd" it gathers the projected splat
    rows over the gauss group in rank order, which is global row order, so
    the stable depth sort bins exactly as on one device, and every gauss
    rank blends its data shard's cameras whole (`gathered_rasterize`); with
    comms="strip" it exchanges them with parallel/tile_sharded.py;
  * the loss: every gauss rank of a data row computes the same loss. The
    per-camera terms are weighted by B_local / B, so their sum over the data
    group is the global batch mean; the global terms (opacity mean, KNN
    regulariser, temporal TV) are added on data rank 0 only, and the last
    camera's terms (depth-normal, COLMAP, tongue) on the data rank that
    holds the global batch's last camera;
  * gradients (`reduce_gradients`): the replicated leaves are summed over
    the world, the Gaussian rows over the data group (with the screen-space
    gradient of the densification statistics); `radii` and visibility are
    maxed over the data group; metrics come back global on every rank.

Densification and the 3D filter and KNN refreshes run on the gathered state
(`gather_train_state`), replicated: every rank's generator has the same seed,
so every rank draws the same noise; then each keeps its rows again.
"""

from __future__ import annotations

import torch

from ..convert import map_state_rows, shard_state
from ..ops.binning import PAYLOAD_WIDTH, build_gaussian_payload, tile_grid
from ..ops.rasterize import rasterize_rows
from . import comm
from .mesh import Mesh

# the batch keys that are not per camera
REPLICATED_KEYS = ("use_ssim", "pcd_points", "pcd_valid")


def shard_train_state(mesh: Mesh, state, aux):
    """This rank's gauss shard of a whole (state, aux)."""
    return shard_state(state, aux, mesh.g, mesh.size("gauss"))


def gather_train_state(mesh: Mesh, state, aux):
    """The whole (state, aux) on every rank, from the gauss shards."""
    return map_state_rows(state, aux,
                          lambda t: comm.all_gather_rows(t.detach(), mesh, "gauss", "state"))


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's cameras of a global batch; the replicated keys whole."""
    D = mesh.size("data")
    out = {}
    for k, v in batch.items():
        if k in REPLICATED_KEYS or not torch.is_tensor(v) or v.dim() == 0:
            out[k] = v
            continue
        if v.shape[0] % D:
            raise ValueError(f"batch {k}: {v.shape[0]} cameras do not split over data={D}")
        per = v.shape[0] // D
        out[k] = v[mesh.d * per:(mesh.d + 1) * per]
    return out


def shard_knn_cache(mesh: Mesh, cache):
    """The KNN cache is replicated: every rank builds the same one from the
    gathered cloud, so there is nothing to move."""
    return cache


def make_sharded_train_step(setup, optimizer, mesh: Mesh, graph: bool = True):
    """The train step of `setup` on `mesh`: (state, aux, batch, knn_cache) ->
    (state, aux, metrics) on this rank's shards (shard_train_state,
    shard_batch, shard_knn_cache); the metrics are global. graph=True (the
    default, as the JAX function always jits) captures each rank's step
    with its collectives as a CUDA graph per key on the card (NCCL only:
    a gloo mesh on the card raises) and runs the same path eagerly on the
    CPU; graph=False is the eager step (train/trainer.py
    `make_train_step`)."""
    from dataclasses import replace

    from ..train.trainer import make_train_step
    return make_train_step(replace(setup, mesh=mesh), optimizer, graph=graph)


def gathered_rasterize(proj, tongue, bg, cfg, mesh: Mesh):
    """rasterize() of this rank's projected rows together with the rest of
    its gauss group's: the rows are gathered in rank order (one all-gather
    of the payload, depth, validity and tile rect), and the whole image is
    blended on every rank. Returns (RasterOutputs, the view's pair demand)."""
    side = torch.cat([proj.depth.detach()[:, None], proj.valid.to(torch.float32)[:, None],
                      proj.rect_min.to(torch.float32), proj.rect_max.to(torch.float32),
                      proj.tiles_touched.to(torch.float32)[:, None]], dim=1)
    rows = comm.all_gather_rows(torch.cat([build_gaussian_payload(proj, tongue), side], 1),
                                mesh, "gauss", "payload")
    P = PAYLOAD_WIDTH
    grid_x, grid_y = tile_grid(cfg.width, cfg.height)
    tiles_all = rows[:, P + 6].detach().to(torch.int32)
    valid_all = rows[:, P + 1].detach() > 0.5
    out = rasterize_rows(rows[:, :P], rows[:, P].detach(), valid_all,
                         rows[:, P + 2:P + 4].detach().to(torch.int32),
                         rows[:, P + 4:P + 6].detach().to(torch.int32), tiles_all, bg, cfg,
                         grid_x=grid_x, grid_y=grid_y)
    num_pairs = torch.sum(torch.where(valid_all, tiles_all, torch.zeros_like(tiles_all)),
                          dtype=torch.int32)
    return out, num_pairs


def _flat_reduce(tensors: list, mesh: Mesh, axis: str) -> list:
    """Sum a list of float tensors over `axis` in one all-reduce."""
    if not tensors or mesh.group(axis) is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    comm.all_reduce_(flat, mesh, axis, "sum", "grad")
    return [c.view_as(t) for c, t in zip(torch.split(flat, [t.numel() for t in tensors]),
                                          tensors)]


def reduce_gradients(mesh: Mesh, grads: dict, vs_grad: torch.Tensor):
    """(grads, vs_grad) summed as the sharded step needs them: the
    replicated leaves over the world, the Gaussian rows and the
    screen-space gradient over the data group."""
    rows = [p for p in grads if p.startswith("gaussians/")]
    reps = [p for p in grads if not p.startswith("gaussians/")]
    *g_rows, vs_grad = _flat_reduce([grads[p] for p in rows] + [vs_grad], mesh, "data")
    g_reps = _flat_reduce([grads[p] for p in reps], mesh, "world")
    out = dict(zip(rows, g_rows))
    out.update(zip(reps, g_reps))
    return {p: out[p] for p in grads}, vs_grad


def reduce_densify_stats(mesh: Mesh, radii: torch.Tensor, visible: torch.Tensor):
    """The batch's largest radius and its visibility over the data group."""
    if mesh.group("data") is None:
        return radii, visible
    both = torch.stack([radii.to(torch.int32), visible.to(torch.int32)])
    comm.all_reduce_(both, mesh, "data", "max", "metric")
    return both[0].to(radii.dtype), both[1] > 0


# metrics summed over the data group (each rank holds its weighted part),
# and those maxed over the world
SUM_METRICS = ("loss", "l1", "psnr", "ssim", "emb_loss", "tv_loss", "opacity_mean",
               "depth_normal", "pcd_loss", "tongue_l1", "tongue_emb", "tongue_rgb",
               "wo_tongue_rgb")
MAX_METRICS = ("num_pairs", "tile_overflow", "send_overflow")


def reduce_metrics(mesh: Mesh, metrics: dict) -> dict:
    """Every rank's partial metrics -> the global ones, on every rank."""
    out = dict(metrics)
    sums = [k for k in SUM_METRICS if k in metrics]
    if mesh.group("data") is not None:
        vals = torch.stack([metrics[k].to(torch.float32) for k in sums])
        comm.all_reduce_(vals, mesh, "data", "sum", "metric")
        out.update(zip(sums, vals))
        out["l1_items"] = comm.all_gather_rows(metrics["l1_items"].contiguous(), mesh, "data",
                                               "metric")
    if mesh.group("world") is not None:
        maxes = torch.stack([metrics[k].to(torch.int32) for k in MAX_METRICS])
        comm.all_reduce_(maxes, mesh, "world", "max", "metric")
        out.update({k: v.to(metrics[k].dtype) for k, v in zip(MAX_METRICS, maxes)})
    return out
