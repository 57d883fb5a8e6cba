"""Training CLI (port of ed3dgs_tpu/tools/train.py; the reference train.py).

Usage:
  python -m ed3dgs_torch.tools.train -s <scene_dir> -m <model_dir> \
      [--configs cfg.py] [--loader dynerf] [--iterations N] [--device cuda] ...

The same flags and config files as the JAX package's tool, and the same
files out: `cfg_args`, `training_time.txt`, tfevents scalars,
`point_cloud/iteration_N/{point_cloud.ply,deformation.npz}` and
`chkpnt<N>.npz`, which either package loads and resumes. The loop samples
cameras on the host (train/sampling.py), decodes iteration i+1's images on a
thread pool while the card runs step i (data/native_staging.py), runs the
train step (train/trainer.py), moves the pair capacity with the pair demand
(train/capacity.py), and densifies and refreshes the 3D filter and the KNN
graph on the reference's cadences (train.py:123-452).

It runs on the card unless `--device cpu` is passed; without a GPU the
default raises. On the card the step, the densify step and the test render
replay CUDA graphs captured per key (trainer.GraphedTrainStep,
trainer.GraphedDensifyStep, tools.FrameRenderer), as the JAX tool jits
them; a pair-capacity or send-capacity change captures anew, and the state
a densify step returns and each new KNN cache are copied into the step's
static buffers. With `--mesh` over NCCL each rank replays its own graph of
the sharded step, the collectives inside it; over gloo (ranks sharing a
card, or the CPU) the sharded step runs op by op, as gloo's collectives
cannot be captured, and the test render runs op by op on any mesh.
`--profile N` writes a torch.profiler trace of N iterations and, beside
it, the tracer's Chrome trace of its stage stamps and host spans
(utils/trace.py `dump`); each densify event is the host span "densify".
`--backend` is accepted for the JAX tool's command lines and ignored: the
port has one backend. Densification draws come from a
`torch.Generator` seeded by `--seed`: the JAX package's `PRNGKey` stream
cannot be reproduced, so the two tools densify with different noise.

Multi-device training runs one process per rank:

  python -m torch.distributed.run --standalone --nproc_per_node N \
      -m ed3dgs_torch.tools.train ... --mesh data=D,gauss=G [--comms strip]

Each rank stages only its data row's cameras, keeps its gauss shard of the
cloud and takes the sharded step (parallel/sharded.py); the metrics are
global, rank 0 writes cfg_args, tfevents, PLYs and checkpoints (whole, the
single-process format), and densification and the 3D filter and KNN
refreshes run on the gathered cloud. `--dist_backend` picks the
torch.distributed backend ("nccl" by default on GPUs, one per rank;
"gloo" on the CPU), and `--share_device` puts every rank on cuda:0 (gloo
only: NCCL refuses two ranks on one card).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace

import numpy as np

from ..utils import trace


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ed3dgs_torch trainer")
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--model_path", "-m", required=True)
    p.add_argument("--configs", default=None)
    p.add_argument("--loader", default=None)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--duration", type=int, default=None)
    p.add_argument("--capacity", type=int, default=None,
                   help="Gaussian capacity (default: max_number_gaussians)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--backend", default=None, choices=["auto", "xla", "pallas"],
                   help="accepted for the JAX tool's command lines and ignored: the port "
                        "has one backend (the CUDA kernels on the card, their plain "
                        "versions on the CPU)")
    p.add_argument("--mesh", default=None, metavar="SPEC",
                   help="multi-device mesh over the torch.distributed world, e.g. "
                        "'data=2,gauss=4' (0 = the rest) or 'auto'; run one process per "
                        "rank under torch.distributed.run")
    p.add_argument("--comms", default="gspmd", choices=["gspmd", "strip"],
                   help="with --mesh: 'gspmd' gathers the projected splats over the gauss "
                        "axis, 'strip' exchanges them strip by strip (one all_to_all a "
                        "camera)")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend with --mesh (default: nccl on GPUs, "
                        "gloo on the CPU or with --share_device)")
    p.add_argument("--share_device", action="store_true",
                   help="with --mesh on GPUs: every rank on cuda:0 (ranks sharing one "
                        "card; needs --dist_backend gloo)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the GPU; 'cpu' runs the "
                        "kernels' plain versions)")
    p.add_argument("--save_iterations", type=int, nargs="+", default=None)
    p.add_argument("--checkpoint_iterations", type=int, nargs="+", default=[])
    p.add_argument("--start_checkpoint", default=None,
                   help="resume from a chkpnt<N>.npz (params + Adam state)")
    p.add_argument("--test_every", type=int, default=2000,
                   help="render a held-out test camera every N iterations and "
                        "log test/psnr (reference train.py:378-389 evaluates "
                        "at fixed test_iterations by default); 0 disables")
    p.add_argument("--no_tensorboard", action="store_true",
                   help="disable tfevents logging (reference train.py:488-493)")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="capture a torch.profiler trace of N steady-state "
                        "iterations (starting at iteration 20) to "
                        "<model_path>/profile/trace.json, and the tracer's stage "
                        "stamps and host spans (utils/trace.py) beside it, "
                        "stages.json")
    p.add_argument("--seed", type=int, default=6666)
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="config overrides, e.g. --set kernel_size=0.1")
    return p.parse_args(argv)


def build_config(args):
    from ..config.loader import load_full_config

    overrides = {"source_path": args.source_path, "model_path": args.model_path}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    if args.loader:
        overrides["loader"] = args.loader
    if args.iterations:
        overrides["iterations"] = args.iterations
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.backend:
        overrides["raster_backend"] = args.backend
    return load_full_config(args.configs, overrides)


class PcdSupervisionLoader:
    """Host-side per-frame GT cloud sampler for the COLMAP supervision loss
    (train.py:273-295). Caches decoded clouds; samples `n` points per step
    for the last batch camera's frame, with the JAX package's draws."""

    def __init__(self, model, seed=0):
        self.dir = model.colmap_pcd_dir
        self.pattern = model.colmap_pcd_pattern
        self.mult = model.colmap_pcd_frame_multiplier
        self.n = model.colmap_pcd_samples
        self.seed = seed
        self._calls = 0
        self._cache = {}

    def sample(self, frame_no: int):
        """Returns (points [n,3] float32, valid bool). The RNG is derived per
        call from (seed, call#, frame), so the stream does not depend on
        which cloud files exist."""
        rng = np.random.default_rng((self.seed, self._calls, frame_no))
        self._calls += 1
        pts = self._load(frame_no)
        if pts is None or len(pts) == 0:
            return np.zeros((self.n, 3), np.float32), False
        idx = rng.choice(len(pts), self.n, replace=len(pts) < self.n)
        return pts[idx], True

    def _load(self, frame_no: int):
        if frame_no in self._cache:
            return self._cache[frame_no]
        pts = None
        if self.dir:
            path = os.path.join(
                self.dir, self.pattern.format(frame=frame_no * self.mult))
            if os.path.exists(path):
                from ..data.pcd import load_pointcloud_any
                pts, _ = load_pointcloud_any(path)
        if len(self._cache) > 256:  # bound host memory
            self._cache.clear()
        self._cache[frame_no] = pts
        return pts


def stage_batch(cams, use_ssim, tongue_enabled, device, pcd_loader=None, pcd_frame_no=None):
    """The train step's batch for `cams` on `device`: images, camera
    matrices, times, camera ids, the SSIM gate, the tongue masks with
    `tongue_enabled`, and with `pcd_loader` the sampled GT cloud of frame
    `pcd_frame_no` (default: the last camera's; `pcd_valid` stays a host
    bool)."""
    import torch

    mats = [c.matrices() for c in cams]
    imgs, tongues = [], []
    for c in cams:
        img = c.image
        if img is None:
            raise FileNotFoundError(f"image missing: {c.image_path}")
        imgs.append(img)
        t = c.tongue_mask
        tongues.append(t if t is not None else np.zeros((1,) + img.shape[1:], np.float32))

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device)

    batch = {
        "gt_image": dev(np.stack(imgs)),
        "viewmatrix": dev(np.stack([m.world_view for m in mats])),
        "projmatrix": dev(np.stack([m.full_proj for m in mats])),
        "campos": dev(np.stack([m.campos for m in mats])),
        "time": dev(np.array([c.time for c in cams], np.float32)),
        "cam_no": dev(np.array([c.cam_no for c in cams], np.int64)),
        "use_ssim": bool(use_ssim),
    }
    if tongue_enabled:
        batch["tongue_gt"] = dev(np.stack(tongues))
    if pcd_loader is not None:
        pts, valid = pcd_loader.sample(cams[-1].frame_no if pcd_frame_no is None
                                       else pcd_frame_no)
        batch["pcd_points"] = dev(np.asarray(pts, np.float32))
        batch["pcd_valid"] = bool(valid)
    return batch


# the tongue terms' metrics (tongue_mask_loss_enabled), in the loss's order
TONGUE_TERMS = ("tongue_l1", "tongue_emb", "tongue_rgb", "wo_tongue_rgb")


def training_report(tb, iteration, metrics, iter_time, total_points, total_tongue):
    """The reference's per-iteration scalar set (train.py:505-524)."""
    g = lambda k: float(metrics[k]) if k in metrics else 0.0  # noqa: E731
    ssim_val = g("ssim")
    tb.add_scalar("train_loss_patches/l1_loss", g("l1"), iteration)
    tb.add_scalar("train_loss_patches/normal_loss", g("depth_normal"), iteration)
    tb.add_scalar("train_loss_patches/total_loss", g("loss"), iteration)
    tb.add_scalar("train_loss_patches/dssim_loss", (1.0 - ssim_val) / 2.0, iteration)
    tb.add_scalar("train_loss_patches/temporal_loss", g("tv_loss"), iteration)
    tb.add_scalar("train_loss_patches/embedding_loss", g("emb_loss"), iteration)
    tb.add_scalar("train_loss_patches/tongue_embedding_loss", g("tongue_emb"), iteration)
    tb.add_scalar("train_loss_patches/opacity_mean_loss", g("opacity_mean"), iteration)
    tb.add_scalar("train_loss_patches/psnr", g("psnr"), iteration)
    tb.add_scalar("train_loss_patches/colmap_pcd_loss", g("pcd_loss"), iteration)
    tb.add_scalar("train_loss_patches/tongue_loss", g("tongue_l1"), iteration)
    tb.add_scalar("train_loss_patches/wo_tongue_rgb_loss", g("wo_tongue_rgb"), iteration)
    tb.add_scalar("train_loss_patches/tongue_rgb_loss", g("tongue_rgb"), iteration)
    tb.add_scalar("iter_time", iter_time, iteration)
    tb.add_scalar("total_points", total_points, iteration)
    tb.add_scalar("total_tongue_gaussians", total_tongue, iteration)


def main(argv=None):
    """Parse the flags, train, and return run_training's (scene, state,
    aux, log)."""
    args = parse_args(argv)
    cfg = build_config(args)
    return run_training(cfg, args)


def _start_world(args):
    """(mesh, device) for this rank: the world torchrun describes joined on
    the asked backend, or (None, the asked device) without --mesh."""
    import torch

    from ..device import resolve_device
    from ..parallel import multihost

    if not args.mesh:
        if args.comms != "gspmd":
            raise ValueError("--comms strip exchanges splats between the ranks of a mesh: "
                             "pass --mesh")
        return None, resolve_device(args.device)
    device = multihost.rank_device(args.device, share=args.share_device)
    if device.type == "cuda":
        torch.cuda.set_device(device)   # NCCL's own calls use the current device
    backend = args.dist_backend or (
        "nccl" if device.type == "cuda" and not args.share_device else "gloo")
    multihost.check_backend(backend, device, args.share_device)
    multihost.initialize_multihost(backend)
    mesh = multihost.parse_mesh_spec(args.mesh)
    if mesh.rank == 0:
        print(f"[mesh] {mesh.size('world')} ranks, data={mesh.shape['data']} "
              f"gauss={mesh.shape['gauss']}, comms {args.comms}, backend {backend}, "
              f"device {device}{' (shared by every rank)' if args.share_device else ''}",
              flush=True)
    return mesh, device


def run_training(cfg, args):
    """Train as the JAX tool does. Returns (scene, state, aux, log): log
    holds the loop's wall ms, loss and train PSNR per iteration, the ms
    each iteration's first read of the step's results waited, the test
    PSNRs, the densify events, the pair-capacity changes, the alive counts
    at start and end, with the tongue terms on each TONGUE_TERMS metric and
    the alive tongue Gaussians (`total_tongue`) per iteration, the
    stager's decode and wait ms, and per graph cache
    (each train step made, the densify step, the test render) its name,
    captures, their seconds and its pool bytes. With --mesh the state and
    aux are whole (gathered) on every rank."""
    import torch

    from ..data.native_staging import Stager
    from ..data.scene import Scene
    from ..models import gaussians as gm
    from ..ops.rasterize import RasterConfig
    from ..parallel import comm
    from ..parallel.multihost import host_batch_slice, to_host
    from ..parallel.sharded import shard_train_state
    from ..render import RenderSettings
    from ..render import render as render_fn
    from ..train import losses as L
    from ..train import trainer
    from ..train.capacity import CapacityPolicy
    from ..train.sampling import CameraSampler
    from ..train.trainer import (TrainSetup, init_train_state, make_densify_step,
                                 make_train_step)
    from . import FrameRenderer

    mesh, device = _start_world(args)
    t_start = time.time()
    model, opt, hidden = cfg.model, cfg.opt, cfg.hidden
    capacity = args.capacity or opt.max_number_gaussians
    is_proc0 = mesh is None or mesh.rank == 0
    if mesh is not None:
        if opt.batch_size % mesh.shape["data"]:
            raise ValueError(f"batch_size {opt.batch_size} must be divisible by the mesh's "
                             f"data axis ({mesh.shape['data']})")
        gauss = mesh.shape["gauss"]
        if capacity % gauss:  # the row shards must be equal
            capacity += gauss - capacity % gauss
            if is_proc0:
                print(f"capacity rounded up to {capacity} (multiple of gauss axis {gauss})",
                      flush=True)

    os.makedirs(model.model_path, exist_ok=True)
    if is_proc0:
        with open(os.path.join(model.model_path, "cfg_args"), "w") as f:
            f.write(repr({"model": vars(model), "opt": vars(opt), "hidden": vars(hidden)}))

    scene = Scene(model, hidden, capacity=capacity, duration=args.duration,
                  shuffle=False, seed=args.seed, device=device)
    train_cams = sorted(scene.train_cameras, key=lambda c: (c.cam_no, c.frame_no))
    cam0 = train_cams[0].matrices()

    rcfg = RasterConfig(width=cam0.width, height=cam0.height,
                        focal_x=cam0.focal_x, focal_y=cam0.focal_y,
                        pair_capacity=opt.pair_capacity, chunk=opt.raster_chunk)
    comms = args.comms if mesh is not None else "gspmd"
    strip_caps = {"send": max(64, -(-2 * capacity // (mesh.shape["gauss"] if mesh else 1)))}
    setup = TrainSetup(
        raster=rcfg, hidden=hidden, batch_size=opt.batch_size,
        white_background=model.white_background, kernel_size=model.kernel_size,
        disable_filter3d=model.disable_filter3D,
        use_coord_map=model.use_coord_map,
        tongue_enabled=model.tongue_mask_loss_enabled,
        lambda_dssim=opt.lambda_dssim, opacity_l1_coef=opt.opacity_l1_coef_fine,
        reg_coef=opt.reg_coef, coef_tv_temporal=opt.coef_tv_temporal_embedding,
        lambda_depth_normal=opt.lambda_depth_normal,
        radegs_from_iter=opt.radegs_regularization_from_iter,
        num_down_emb=hidden.min_embeddings, sh_degree=model.sh_degree,
        colmap_supervision=model.colmap_supervision_enabled,
        deform_from_iter=hidden.deform_from_iter,
        batch_mode="vmap" if mesh is not None else "scan",
        comms=comms, mesh=mesh,
        send_capacity=strip_caps["send"] if comms == "strip" else None)

    state, optimizer = init_train_state(scene.params, hidden, opt, scene.cameras_extent,
                                        seed=args.seed)
    aux = scene.aux
    first_iter = 1
    if args.start_checkpoint:
        state, aux, first_iter = load_checkpoint(args.start_checkpoint, state, aux, device)
        if is_proc0:
            print(f"resumed from {args.start_checkpoint} at iteration {first_iter}",
                  flush=True)

    # one CUDA graph per key on the card, as the JAX tool jits the step (and
    # the sharded step, ed3dgs_tpu/parallel/sharded.py:111); gloo's
    # collectives cannot be captured, so a gloo mesh takes the eager step
    graph = mesh is None or mesh.backend != "gloo"
    step_fn = make_train_step(setup, optimizer, graph=graph)
    captured = []               # the captures of each step and graph cache released
    densify_fn = make_densify_step(opt, opt.percent_dense, scene.cameras_extent)

    # camera metadata for sampling / 3D filter
    cam_ids = sorted({c.cam_no for c in train_cams})
    cam_index = {c: i for i, c in enumerate(cam_ids)}
    first_frames = [c for c in train_cams if c.frame_no == 0]
    centers = np.stack([c.matrices().campos for c in first_frames])
    by_key = {(c.cam_no, c.frame_no): c for c in train_cams}
    maxtime = scene.maxtime

    f32 = dict(dtype=torch.float32, device=device)
    view_mats = torch.as_tensor(np.stack([c.matrices().world_view for c in first_frames]), **f32)
    focals_x = torch.tensor([c.matrices().focal_x for c in first_frames], **f32)
    focals_y = torch.tensor([c.matrices().focal_y for c in first_frames], **f32)
    widths = torch.tensor([float(c.width) for c in first_frames], **f32)
    heights = torch.tensor([float(c.height) for c in first_frames], **f32)

    def refresh_filter(params, aux):
        """The 3D filter of the whole cloud (params and aux whole)."""
        if model.disable_filter3D:
            return aux._replace(filter_3d=torch.zeros_like(aux.filter_3d))
        return aux._replace(filter_3d=gm.compute_3d_filter(
            params.xyz, aux.alive, view_mats, focals_x, focals_y, widths, heights))

    def whole(state, aux):
        return (state, aux) if mesh is None else to_host(mesh, state, aux)

    def shard(state, aux):
        return (state, aux) if mesh is None else shard_train_state(mesh, state, aux)

    def points(aux):
        """(alive, alive tongue) Gaussians of the whole cloud, from this
        rank's shard."""
        n = torch.stack([aux.alive.sum(), (aux.alive & (aux.tongue_class[:, 0] > 0.5)).sum()])
        if mesh is not None:
            comm.all_reduce_(n, mesh, "gauss", "sum", "metric")
        return [int(v) for v in n]

    aux = refresh_filter(state.params["gaussians"], aux)

    sampler = CameraSampler(
        num_cams=len(cam_ids), maxtime=maxtime, camera_centers=centers,
        batch_size=opt.batch_size, random_until=opt.random_until,
        num_multiview_ssim=opt.num_multiview_ssim,
        sequential=model.sampling_sequential_frame_enabled,
        first_frame_then_sequential=model.sampling_first_frame_then_sequential_enabled,
        first_frame_change=model.sampling_first_frame_change,
        is_sample_from_past=model.is_sample_from_past,
        preference_frames=tuple(model.frame_indices_higher_preference),
        preference_probability=model.frame_preference_probability,
        seed=args.seed)

    # adaptive KNN-graph capacity buckets (grow-only, like the pair capacity):
    # a refresh that drops more edges than the coverage target allows
    # re-prepares the graph at bigger buckets before training continues.
    # Every rank builds the same (replicated) cache from the whole cloud, so
    # the bucket decisions agree.
    knn_caps = dict(trainer.KNN_CAPS_DEFAULT)

    def refresh_knn(params, aux):
        return trainer.refresh_knn_cache(
            params, aux, knn_caps, tongue_enabled=model.tongue_mask_loss_enabled,
            coverage_target=opt.knn_coverage_target, quiet=args.quiet or not is_proc0)

    knn_cache = refresh_knn(state.params["gaussians"], aux)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    log_points = int(aux.alive.sum())     # the whole cloud, before sharding
    state, aux = shard(state, aux)

    final_iter = opt.iterations
    save_iters = set(args.save_iterations or [final_iter])
    ckpt_iters = set(args.checkpoint_iterations)
    ema_loss = 0.0
    log_path = os.path.join(model.model_path, "training_time.txt")

    def pick(c, f):
        cam = by_key.get((cam_ids[c % len(cam_ids)], int(f) % maxtime))
        if cam is None:  # sparse frame ids: nearest frame
            options = [x for x in train_cams if x.cam_no == cam_ids[c % len(cam_ids)]]
            cam = min(options, key=lambda x: abs(x.frame_no - int(f) % maxtime))
        return cam

    def local_slice(cams):
        """The cameras this rank stages: its data row's slice of the batch
        (every rank's sampler has the same seed, so they agree on the batch)."""
        return cams if mesh is None else cams[host_batch_slice(len(cams), mesh)]

    # decode iteration i+1's batch on worker threads while the card runs
    # step i (the reference's lazy PIL load stalls the loop instead,
    # train.py:172)
    stager = Stager()

    def sample_batch(iteration):
        cams_idx, frames, use_ssim = sampler.sample(iteration, final_iter)
        cams = [pick(c, f) for c, f in zip(cams_idx, frames)]
        for c in local_slice(cams):
            stager.submit(c)
        return cams, use_ssim

    pcd_loader = (PcdSupervisionLoader(model, seed=args.seed)
                  if model.colmap_supervision_enabled else None)

    def stage(cams, use_ssim):
        # the COLMAP cloud keys to the GLOBAL batch's last camera: every rank
        # samples the same replicated cloud
        batch = stage_batch(local_slice(cams), use_ssim, model.tongue_mask_loss_enabled,
                            device, pcd_loader, pcd_frame_no=cams[-1].frame_no)
        if mesh is not None and pcd_loader is not None:
            # a cloud file present on some hosts and missing on others would
            # feed the ranks different terms: fail instead
            mine = torch.tensor([[cams[-1].frame_no, int(batch["pcd_valid"])]], device=device)
            seen = comm.all_gather_rows(mine, mesh, "world", "metric")
            if not bool((seen == mine).all()):
                raise RuntimeError(
                    f"colmap-pcd supervision desynced across ranks: (frame, valid) "
                    f"{seen.tolist()}; a cloud file present on some hosts is missing on "
                    "others (check colmap_pcd_dir on every host)")
        return batch

    tb = None
    if not args.no_tensorboard and is_proc0:
        from ..utils.tb_writer import SummaryWriter
        tb = SummaryWriter(model.model_path)

    # periodic held-out test PSNR (reference train.py:378-389), rendered at
    # the CURRENT raster config: the pair capacity follows the demand, and an
    # eval render at a stale one would drop pairs. On a mesh every rank
    # renders the camera with its gauss group (the strip exchange).
    test_cams = list(scene.test_cameras)
    eval_rng = np.random.default_rng(args.seed)
    bg = torch.full((3,), 1.0 if model.white_background else 0.0, **f32)

    # one graph per raster config (JAX: tools/train.py:465-480)
    eval_frame = FrameRenderer(hidden, bg, sh_degree=model.sh_degree,
                               kernel_size=model.kernel_size,
                               disable_filter3d=model.disable_filter3D,
                               num_down_emb=hidden.min_embeddings)

    def eval_test_psnr(iteration):
        cam = test_cams[eval_rng.integers(len(test_cams))]
        img = cam.image
        if img is None:
            return None
        m = cam.matrices()
        if mesh is None:
            out = eval_frame(rcfg, (state.params["gaussians"], aux, state.params["deform"]),
                             rcfg, m.world_view, m.full_proj, m.campos, cam.time,
                             iteration=iteration, cam_no=0)["render"]
        else:
            with torch.no_grad():
                s = RenderSettings(torch.as_tensor(m.world_view, **f32),
                                   torch.as_tensor(m.full_proj, **f32),
                                   torch.as_tensor(m.campos, **f32),
                                   torch.tensor(cam.time, **f32),
                                   torch.zeros((), dtype=torch.int64, device=device))
                out = render_fn(state.params["gaussians"], aux, state.params["deform"],
                                hidden, s, rcfg, bg, iteration=iteration,
                                sh_degree=model.sh_degree, kernel_size=model.kernel_size,
                                disable_filter3d=model.disable_filter3D,
                                num_down_emb_c=hidden.min_embeddings,
                                num_down_emb_f=hidden.min_embeddings, mesh=mesh,
                                send_capacity=strip_caps["send"])["render"]
        cam.release_image()
        gt = torch.as_tensor(img, device=device)
        return float(torch.mean(L.psnr(out[None], gt[None])))

    # adaptive pair capacity (train/capacity.py): the step's pair buffers
    # follow the reported pair demand
    cap_policy = CapacityPolicy(capacity=rcfg.pair_capacity)
    cap_policy.start(first_iter)

    log = {"iter_ms": [], "loss": [], "psnr": [], "test_psnr": [], "densify": [],
           "capacity": [], "points_start": log_points, "read_wait_ms": []}
    if model.tongue_mask_loss_enabled:
        log.update({k: [] for k in (*TONGUE_TERMS, "total_tongue")})

    def maybe_resize_capacity(iteration, num_pairs, send_overflow):
        nonlocal rcfg, setup, step_fn
        want = cap_policy.observe(iteration, num_pairs)
        if want is not None:
            if not args.quiet and is_proc0:
                print(f"[{iteration}] pair_capacity {rcfg.pair_capacity} -> {want}", flush=True)
            log["capacity"].append((iteration, rcfg.pair_capacity, want))
            rcfg = replace(rcfg, pair_capacity=want)
            setup = replace(setup, raster=rcfg)
            # a new step on the new buffers: the old step's graphs go with it
            captured.extend(_graph_stats(step_fn))
            step_fn = make_train_step(setup, optimizer, graph=graph)
        if comms == "strip" and send_overflow > strip_caps["send"]:
            # the strip buffers dropped the deepest splats: grow them (the
            # contract of the pair capacity)
            while strip_caps["send"] < send_overflow:
                strip_caps["send"] *= 2
            if is_proc0:
                print(f"[{iteration}] strip send_capacity -> {strip_caps['send']}", flush=True)
            setup = replace(setup, send_capacity=strip_caps["send"])
            captured.extend(_graph_stats(step_fn))
            step_fn = make_train_step(setup, optimizer, graph=graph)

    prof = None
    pending = sample_batch(first_iter)
    t_iter = time.time()
    prof_start = first_iter + 19 if args.profile and is_proc0 else -1
    prof_stop = prof_start + args.profile
    try:
        for iteration in range(first_iter, final_iter + 1):
            t_loop = time.perf_counter()
            cams, use_ssim = pending
            for c in local_slice(cams):
                stager.fetch_into(c)
            if iteration < final_iter:
                pending = sample_batch(iteration + 1)
            if iteration == prof_start:
                prof = _start_profile(torch, device)
            batch = stage(cams, use_ssim)
            state, aux, metrics = step_fn(state, aux, batch, knn_cache)
            if iteration == prof_stop and prof is not None:
                _stop_profile(prof, os.path.join(model.model_path, "profile"))
                prof = None

            # the loop's first read of the step's results waits for the card
            # to finish the step (the JAX tool reads them here too)
            t_read = time.perf_counter()
            l1_items = metrics["l1_items"].cpu().numpy()
            log["read_wait_ms"].append((time.perf_counter() - t_read) * 1e3)
            sampler.record_loss([cam_index.get(c.cam_no, 0) for c in cams],
                                [c.frame_no for c in cams], l1_items)
            maybe_resize_capacity(iteration, int(metrics["num_pairs"]),
                                  int(metrics["send_overflow"]))
            for c in local_slice(cams):
                c.release_image()

            if iteration < opt.densify_until_iter and iteration > opt.densify_from_iter \
                    and iteration % opt.densification_interval == 0:
                thr = (opt.densify_grad_threshold_fine_init
                       - iteration * (opt.densify_grad_threshold_fine_init
                                      - opt.densify_grad_threshold_after)
                       / opt.densify_until_iter)
                # on the whole cloud; every rank draws the same noise
                state, aux = whole(state, aux)
                with trace.span("densify", call=iteration):
                    state, aux, n_c, n_s = densify_fn(state, aux, generator, thr)
                    aux = refresh_filter(state.params["gaussians"], aux)
                    knn_cache = refresh_knn(state.params["gaussians"], aux)
                log["densify"].append((iteration, int(n_c), int(n_s), int(aux.alive.sum())))
                state, aux = shard(state, aux)
            elif (iteration % 100 == 0 and iteration > opt.densify_until_iter
                    and not model.disable_filter3D and iteration < final_iter - 100):
                state, aux = whole(state, aux)
                aux = refresh_filter(state.params["gaussians"], aux)
                state, aux = shard(state, aux)

            loss = float(metrics["loss"])
            log["loss"].append(loss)
            log["psnr"].append(float(metrics["psnr"]))
            n_points, n_tongue = points(aux)
            if model.tongue_mask_loss_enabled:
                for k in TONGUE_TERMS:
                    log[k].append(float(metrics[k]))
                log["total_tongue"].append(n_tongue)
            if tb is not None:
                now = time.time()
                training_report(tb, iteration, metrics, now - t_iter, n_points,
                                n_tongue if model.tongue_mask_loss_enabled else 0)
                t_iter = now
            if args.test_every > 0 and iteration % args.test_every == 0 and test_cams:
                tp = eval_test_psnr(iteration)
                if tp is not None:
                    log["test_psnr"].append((iteration, tp))
                    if tb is not None:
                        tb.add_scalar("test/psnr", tp, iteration)
                    if not args.quiet and is_proc0:
                        print(f"[{iteration}] test psnr {tp:.2f}", flush=True)

            if not args.quiet and is_proc0 and iteration % 100 == 0:
                ema_loss = 0.4 * loss + 0.6 * ema_loss
                print(f"[{iteration}/{final_iter}] loss={ema_loss:.5f} "
                      f"psnr={float(metrics['psnr']):.2f} points={n_points}", flush=True)

            if iteration in save_iters or iteration in ckpt_iters:
                saved = whole(state, aux)
                if is_proc0 and iteration in save_iters:
                    with open(log_path, "a") as f:
                        f.write(f"Iteration {iteration}: {time.time() - t_start} seconds "
                                f"points: {n_points}\n")
                    scene.save(iteration, saved[0].params["gaussians"], saved[1],
                               saved[0].params["deform"])
                if is_proc0 and iteration in ckpt_iters:
                    save_checkpoint(model.model_path, iteration, *saved)
            log["iter_ms"].append((time.perf_counter() - t_loop) * 1e3)
    finally:
        stager.close()
        if tb is not None:
            tb.close()
        if prof is not None:
            prof.stop()
    state, aux = whole(state, aux)
    log.update(points_end=int(aux.alive.sum()), decode_ms=list(stager.decode_ms),
               wait_ms=list(stager.wait_ms), first_iter=first_iter,
               graph_captures=(captured + _graph_stats(step_fn) + _graph_stats(densify_fn)
                               + _graph_stats(eval_frame)))
    return scene, state, aux, log


def _graph_stats(fn) -> list:
    """[(name, captures, their seconds, pool bytes)] of a graphed step or
    frame's graph cache; [] where it has none (eager, or on the CPU)."""
    c = getattr(fn, "graphs", None)
    if c is None:
        return []
    return [(c.name, len(c.captures), sum(t for _, t, _ in c.captures), c.pool_bytes)]


def _start_profile(torch, device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def _stop_profile(prof, out_dir):
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    trace.dump(os.path.join(out_dir, "stages.json"))
    print(f"profiler trace and stage stamps written to {out_dir}", flush=True)


def save_checkpoint(model_path, iteration, state, aux):
    """Full optimizer checkpoint (reference chkpnt<it>.pth,
    train.py:450-452), in the JAX package's chkpnt<N>.npz layout."""
    from ..convert import checkpoint_arrays

    flat = checkpoint_arrays(state, aux)
    flat["iteration"] = np.asarray(iteration)
    np.savez(os.path.join(model_path, f"chkpnt{iteration}.npz"), **flat)


def load_checkpoint(path, state, aux, device="cuda"):
    """Restore a chkpnt<N>.npz (written by either package) in place of a
    freshly built (state, aux): returns (state, aux, the next iteration).
    Every parameter, moment and aux array of the template must be in the
    file, at the template's shape."""
    from ..convert import load_checkpoint as load_arrays
    from ..train.optim import flatten_params

    new_state, new_aux = load_arrays(path, device=device)
    want = flatten_params(state.params)
    got = flatten_params(new_state.params)
    if set(got) != set(want) or any(got[k].shape != want[k].shape for k in want):
        raise ValueError(f"{path}: its parameters do not match the model's (capacity or "
                         "config differs)")
    if any(getattr(new_aux, k).shape != getattr(aux, k).shape for k in aux._fields):
        raise ValueError(f"{path}: its aux arrays do not match the model's")
    return new_state, new_aux, int(new_state.iteration) + 1


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():   # a rank of a torch.distributed.run world
        dist.destroy_process_group()
    sys.exit(0)
