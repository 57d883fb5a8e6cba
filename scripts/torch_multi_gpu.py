#!/usr/bin/env python3
"""The sharded step over NCCL, graphed against eager, and tools.train on one
GPU and on N GPUs (NCCL, a GPU a rank), same scene.

    python3 scripts/torch_multi_gpu.py [--gpus 4] [--config default|tongue] [--iters N]
                                       [--parts check,train] [--out FILE]

The check part (`--parts check`) runs one NCCL world of N spawned ranks
(`parallel.multihost.spawn_world`, rank r on cuda:r) at data=2 x gauss=N/2
(data=1 x gauss=N below four cards) with a batch of four views (CHECK_EYES).
Its problems, each the same on every rank (numpy seeds; the KNN cache is
bit-exact), by `--config`:

  * default: chip_smoke.py's bench problem (the 100,000-Gaussian cloud at the
    full width of configs/nersemble/default.py, 802x550, its KNN cache,
    iteration 20,000);
  * tongue: chip_smoke.py 5b's tongue problem (that cloud with its
    3,000-Gaussian tongue blob at configs/nersemble/tongue.py, targets the
    blob's tongue-only alpha, which must cover more than the 0.005 gate of
    the tongue colour term), then 5b's COLMAP step
    (configs/nersemble/407_tongue_colmap_supervision.py, 4,000 GT points,
    capacity 150,000, pcd_valid on and off).

For each problem and comms ("gspmd", "strip") it takes CHECK_STEPS eager
sharded steps (graph=False) and CHECK_STEPS graphed ones (the default: a
CUDA graph per key, the step's collectives inside it) from the same shards,
SSIM on the middle step (two keys, so the last graphed step replays the
first one's graph; the COLMAP problem alternates pcd_valid instead). The
tongue problem then makes tools.train's densify event on the mesh in each
run: the whole cloud gathered over NCCL, the densify step (graphed in the
graphed run) at chip_smoke.tongue_threshold (tongue parents clone and
split), the 3D filter and the KNN refresh with its tongue graph, whose
in-edge count must change, the shards again; then MORE_STEPS more steps of
each, which in the graphed run must replay. After every step it compares
every state tensor and metric bit for bit (the tongue and COLMAP problems
must be bit for bit; the default problem within the bounds of
tests/test_torch_parallel_step.py: xyz atol 5e-5, the deformation `weight`
atol 5e-6, `denom` atol 1e-6, `l1_items` rtol 1e-5, every other tensor
within 1e-5 of its largest value, with the largest differences printed).
It reads each step's collectives by kind and bytes from parallel/comm.py's
ledger (a replay appends its key's records), which must match; counts the
host waits of a replayed step (chip_smoke.py `count_waits`, sync debug mode
"warn"), which must be 0; and times TIME_STEPS more steps each way by CUDA
events on each rank's card (a time names its rank's data row). For the
tongue and COLMAP problems it also holds the first sharded step, gathered,
to the one-card step from the same state and batch (graph=False) within
the bounds of tests/test_torch_parallel_step.py `_hold` (loss rel 2e-4,
PSNR rel 2e-3, xyz, weight and denom as above), requires every tongue term
of every step non-zero and pcd_loss non-zero exactly where pcd_valid, and
reports the graphs' pool bytes on each rank. Then it makes tools.train's
densify event on the mesh from the graphed strip run (`check_densify`): on
the whole cloud gathered over NCCL (the default problem: its last state;
the tongue problem: the state its refresh gathers, before that refresh's
own densify), at once the densify step graphed (its first call runs
eagerly and captures while NCCL's watchdog thread runs), eager, and
graphed again (a replay), each from the same whole state with a generator
of one seed, at the 99.9th percentile of the cloud's mean screen-space
gradient (the tongue problem: at chip_smoke.tongue_threshold, and its
children of tongue class 1 counted, which must be some): bit for bit on
every rank, each timed by events. A mismatch exits non-zero.

The train part (`--parts train`), default config: generates chip_smoke.py's
cli scene (4 cameras, 8 frames, 802x550, 20,000 points) on cuda:0 and
trains it at the full width of configs/nersemble/default.py with batch 4
(chip_smoke's CLI_SET schedule, but densifying once, at iteration 50):
once in this process on cuda:0 (graphed, the tool's default), then for
each mesh in MESHES, graphed (the default over NCCL) and eager, in one NCCL
world of N spawned ranks (`tools.train.main(... --mesh ... --dist_backend
nccl)`). "Eager" there means the train step only (made with graph=False):
the tool has no option for it, so the script wraps `make_train_step`; the
densify step stays graphed in every run. Tongue config: chip_smoke.py's
tongue cli scene (10% tongue: segmentations and red seeds) trained at
configs/nersemble/tongue.py with chip_smoke's TONGUE_CLI_SET and batch 4
for TONGUE_CLI_ITERS iterations (one densify event at 150, with its
tongue refresh), on one GPU and on each mesh, graphed only; every tongue
term must be finite and live, and the tongue must keep Gaussians; then
the COLMAP configuration on that scene with a cloud for every other frame
(`write_clouds`), COLMAP_CLI_ITERS iterations on one GPU and on
COLMAP_MESH, both pcd_valid keys, counting the tool's per-iteration
all-gather of (frame, valid) and the host wait that reads it. Every
default and tongue run must cross its densify event. Prints, for each run, the median and
mean wall ms an iteration (rank 0's loop, host clock; the first 10
iterations left out), the first iteration's loss against the one-GPU
run's (the same state and batch, so equal up to summation order), the
last loss, the test PSNRs, the densify events and the graph captures.
Every line names the card; one JSON line holds all of it (also to --out).
Needs N GPUs; fails on a run that fails or misses its deadline.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = (("data=4", "gspmd"), ("data=2,gauss=2", "gspmd"), ("data=2,gauss=2", "strip"),
          ("gauss=4", "strip"))
SKIP = 10          # warm-up iterations left out of the times
TONGUE_TERMS = ("tongue_l1", "tongue_emb", "tongue_rgb", "wo_tongue_rgb")


def config_path(name: str) -> str:
    return os.path.join(REPO, "configs", "nersemble", name)


def argv(scene, model, iters, extra=()):
    return ["-s", scene, "-m", model, "--configs", config_path("default.py"),
            "--duration", "8", "--iterations", str(iters), "--test_every", str(iters // 2),
            "--quiet", "--seed", "0", "--no_tensorboard", "--device", "cuda", *extra,
            "--set", "batch_size=4", "deform_from_iter=50", "densify_from_iter=40",
            "densify_until_iter=260", "densification_interval=50",
            "radegs_regularization_from_iter=0", "min_embeddings=4", "max_embeddings=8"]


def tongue_argv(scene, model, iters, extra=()):
    import chip_smoke as cs
    return ["-s", scene, "-m", model, "--configs", config_path("tongue.py"),
            "--duration", str(cs.CLI_FRAMES), "--iterations", str(iters),
            "--test_every", str(iters // 2), "--quiet", "--seed", "0", "--no_tensorboard",
            "--device", "cuda", *extra, "--set", *cs.TONGUE_CLI_SET, "batch_size=4"]


COLMAP_CLI_ITERS = 120    # the COLMAP tool runs (the term on from iteration 51)
COLMAP_MESH = ("data=2,gauss=2", "strip")


def colmap_argv(scene, model, clouds, extra=()):
    import chip_smoke as cs
    return ["-s", scene, "-m", model, "--configs",
            config_path("407_tongue_colmap_supervision.py"), "--duration", str(cs.CLI_FRAMES),
            "--iterations", str(COLMAP_CLI_ITERS), "--test_every", str(COLMAP_CLI_ITERS),
            "--quiet", "--seed", "0", "--no_tensorboard", "--device", "cuda", *extra, "--set",
            *cs.TONGUE_CLI_SET, "batch_size=4", f"colmap_pcd_dir={clouds}"]


def write_clouds(scene: str, clouds: str, frames: int):
    """A COLMAP cloud for every other frame (the scene's points jittered by
    a numpy seed) at the reference's paths (the config's colmap_pcd_pattern
    and colmap_pcd_frame_multiplier); the other frames have none."""
    import numpy as np

    from ed3dgs_torch.config.loader import load_full_config
    from ed3dgs_torch.data.pcd import write_pcd
    from ed3dgs_torch.data.ply import fetch_point_cloud

    model = load_full_config(config_path("407_tongue_colmap_supervision.py")).model
    pts = np.asarray(fetch_point_cloud(os.path.join(scene, "points3D_downsample.ply"))[0],
                     np.float32)
    rng = np.random.default_rng(7)
    for f in range(0, frames, 2):
        path = os.path.join(clouds, model.colmap_pcd_pattern.format(
            frame=f * model.colmap_pcd_frame_multiplier))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        write_pcd(path, pts + rng.normal(0, 0.005, pts.shape).astype(np.float32))


def summary(log) -> dict:
    ms = log["iter_ms"][SKIP:]
    ms_sorted = sorted(ms)
    out = dict(median_iter_ms=ms_sorted[len(ms) // 2], mean_iter_ms=sum(ms) / len(ms),
               loss_first=log["loss"][0], loss_last=log["loss"][-1],
               test_psnr=[(int(i), float(v)) for i, v in log["test_psnr"]],
               points_end=log["points_end"], densify=log["densify"])
    if "total_tongue" in log:
        out.update(tongue_first={k: log[k][0] for k in TONGUE_TERMS},
                   tongue_last={k: log[k][-1] for k in TONGUE_TERMS},
                   tongue_max={k: max(log[k]) for k in TONGUE_TERMS},
                   tongue_finite=all(math.isfinite(v) for k in TONGUE_TERMS for v in log[k]),
                   total_tongue=(log["total_tongue"][0], log["total_tongue"][-1]))
    return out


def rank_main(rank, world, runs):
    """tools.train for each (argv, graph) of `runs`; graph=False makes the
    tool's train step eager (the tool itself graphs it over NCCL); its
    densify step stays graphed. With COLMAP supervision it also counts the
    COLMAP clouds sampled valid and not, and the tool's per-iteration
    all-gather of (frame, valid) over the world with the host wait that
    reads it (timed to the card's end of the gather)."""
    import torch
    sys.path.insert(0, REPO)
    from ed3dgs_torch.parallel import comm
    from ed3dgs_torch.tools import train
    from ed3dgs_torch.train import trainer

    make, gather, sample = (trainer.make_train_step, comm.all_gather_rows,
                            train.PcdSupervisionLoader.sample)
    out = []
    for a, graph in runs:
        stage = dict(gathers=0, wait_ms=[], valid=0, invalid=0)

        def timed_gather(x, mesh, axis, tag):
            if axis != "world":
                return gather(x, mesh, axis, tag)
            t0 = time.perf_counter()
            y = gather(x, mesh, axis, tag)
            torch.cuda.synchronize()          # what the tool's read of it waits for
            stage["gathers"] += 1
            stage["wait_ms"].append((time.perf_counter() - t0) * 1e3)
            return y

        def counted_sample(self, frame_no):
            pts, ok = sample(self, frame_no)
            stage["valid" if ok else "invalid"] += 1
            return pts, ok
        trainer.make_train_step = (make if graph else
                                   lambda setup, opt, graph=True: make(setup, opt, graph=False))
        comm.all_gather_rows = timed_gather
        train.PcdSupervisionLoader.sample = counted_sample
        try:
            _, _, _, log = train.main(a)
        finally:
            trainer.make_train_step = make
            comm.all_gather_rows = gather
            train.PcdSupervisionLoader.sample = sample
        torch.cuda.synchronize()
        ms = sorted(stage.pop("wait_ms")) or [0.0]
        stage.update(wait_ms_median=ms[len(ms) // 2], wait_ms_max=ms[-1])
        out.append(dict(summary(log), graph_captures=log["graph_captures"], stage=stage)
                   if rank == 0 else None)
    return out


# --- the check part ---------------------------------------------------------------

CHECK_STEPS = 3        # compared steps each way; SSIM on the middle one
MORE_STEPS = 2         # compared steps after the tongue problem's refresh (SSIM off, on)
TIME_STEPS = 10        # timed steps each way, after the compared ones
CHECK_EYES = ((0.0, 0.0, 0.0), (0.15, 0.05, 0.0), (-0.15, 0.0, 0.0), (0.0, -0.1, 0.0))
# graphed against eager where they are not bit for bit: the bounds of
# tests/test_torch_parallel_step.py against JAX's sharded step
BOUNDS = {"params/gaussians/xyz": ("atol", 5e-5), "params/deform/weight": ("atol", 5e-6),
          "aux/denom": ("atol", 1e-6), "metrics/l1_items": ("rtol", 1e-5)}
OTHER_REL = 1e-5       # any other tensor: max |diff| / max |value|
# the sharded step against the one-card step: tests/test_torch_parallel_step.py _hold
HOLD = {"loss": 2e-4, "psnr": 2e-3, "xyz": 5e-5, "weight": 5e-6, "denom": 1e-6}
TONGUE_GATE = 0.005    # the tongue colour term's gate on the target's mean
PROBLEMS = {"default": ("default",), "tongue": ("tongue", "colmap")}


def _cat(torch, views: list) -> dict:
    """One batch of the views' cameras (the host bools of the first)."""
    return {k: (torch.cat([v[k] for v in views]) if torch.is_tensor(views[0][k])
                else views[0][k]) for k in views[0]}


def _base(torch, dev, config: str, fields: dict, capacity: int) -> dict:
    """A problem's state on `dev`: the cloud `fields` in `capacity` rows at
    config `config`, its 3D filter and KNN cache (with the tongue graph
    where the config has the tongue terms), a fresh train state at
    chip_smoke.TRAIN_ITERATION, the four cameras and a batch-4 setup."""
    import chip_smoke as cs
    from dataclasses import replace

    from ed3dgs_torch.config.loader import load_full_config
    from ed3dgs_torch.convert import gaussians_from_numpy
    from ed3dgs_torch.models.gaussians import compute_3d_filter
    from ed3dgs_torch.render import raster_config_from_camera
    from ed3dgs_torch.train.trainer import (KNN_CAPS_DEFAULT, init_train_state,
                                            refresh_knn_cache)

    cfg = load_full_config(config_path(config))
    params, aux = gaussians_from_numpy(fields, capacity=capacity, device=dev)
    cams = [cs.bench_camera(cs.WIDTH, cs.HEIGHT, eye) for eye in CHECK_EYES]
    rcfg = raster_config_from_camera(cams[0], pair_capacity=cs.PAIR_CAPACITY,
                                     chunk=cfg.opt.raster_chunk)
    setup = replace(cs.train_setup(cfg, rcfg), batch_size=len(cams))
    fargs, extent = cs.filter_cameras(torch, dev)
    aux = aux._replace(filter_3d=compute_3d_filter(params.xyz, aux.alive, *fargs))
    caps = dict(KNN_CAPS_DEFAULT)
    cache = refresh_knn_cache(params, aux, caps, tongue_enabled=setup.tongue_enabled,
                              coverage_target=cfg.opt.knn_coverage_target)
    state, optimizer = init_train_state(params, cfg.hidden, cfg.opt, extent, seed=0)
    state = state._replace(iteration=cs.TRAIN_ITERATION)
    return dict(config=config, cfg=cfg, opt=cfg.opt, setup=setup, cams=cams, state=state,
                aux=aux, cache=cache, caps=caps, optimizer=optimizer, extent=extent,
                fargs=fargs, more=[], refresh=False, hold=True, exact=True)


def check_problem(torch, dev, name: str) -> dict:
    """Problem `name` ("default", "tongue" or "colmap") on `dev`: _base's
    dict with its compared batches (`batches`, and after the tongue
    problem's refresh `more`), its timing batch, and what the check holds
    it to."""
    import chip_smoke as cs
    from dataclasses import replace

    if name == "default":
        p = _base(torch, dev, "default.py", cs.bench_cloud(cs.N_GAUSS), cs.CAPACITY)

        def batch(i, ssim):
            return _cat(torch, [cs.make_batch(torch, c, 1, 0.1 + 0.2 * i, ssim, 100 + 10 * i + j,
                                              dev) for j, c in enumerate(p["cams"])])
        p.update(batches=[batch(i, i == 1) for i in range(CHECK_STEPS)],
                 timing=batch(CHECK_STEPS, False), hold=False, exact=False)
        return p
    if name == "tongue":
        p = _base(torch, dev, "tongue.py", cs.tongue_cloud(cs.N_GAUSS), cs.CAPACITY)
        one = replace(p["setup"], batch_size=1)

        def batch(i, ssim):
            return _cat(torch, [cs.tongue_batch(torch, one, p["state"], p["aux"], c,
                                                0.15 + 0.1 * i, ssim, 800 + 10 * i + j)
                                for j, c in enumerate(p["cams"])])
        p.update(batches=[batch(i, i == 1) for i in range(CHECK_STEPS)],
                 more=[batch(CHECK_STEPS + i, i == 1) for i in range(MORE_STEPS)],
                 timing=batch(CHECK_STEPS + MORE_STEPS, False), refresh=True)
        means = [float(b["tongue_gt"][-1].mean()) for b in p["batches"] + p["more"]]
        if min(means) <= TONGUE_GATE:
            raise RuntimeError(f"a tongue target's last view covers {min(means):.5f} of the "
                               f"image, not more than the gate {TONGUE_GATE}")
        p["target_means"] = means
        return p
    import numpy as np
    p = _base(torch, dev, "407_tongue_colmap_supervision.py", cs.tongue_cloud(cs.N_GAUSS),
              cs.COLMAP_CAPACITY)
    n = p["cfg"].model.colmap_pcd_samples
    rng = np.random.default_rng(900)
    gp, aux = p["state"].params["gaussians"], p["aux"]
    xyz = gp.xyz[aux.alive].cpu().numpy()
    pts = xyz[rng.integers(0, len(xyz), n)] + rng.normal(0, cs.COLMAP_JITTER, (n, 3))
    pts = torch.as_tensor(pts.astype(np.float32), device=dev)

    def batch(i, valid):
        b = _cat(torch, [cs.make_batch(torch, c, 1, 0.2 + 0.1 * i, False, 900 + 10 * i + j, dev)
                         for j, c in enumerate(p["cams"])])
        b.update(pcd_points=pts, pcd_valid=valid)
        return b
    p.update(batches=[batch(i, v) for i, v in enumerate(cs.COLMAP_VALID)],
             timing=batch(len(cs.COLMAP_VALID), True), samples=n)
    return p


def compare(torch, want: dict, got: dict) -> dict:
    """{name: max |diff|} of the tensors that are not bit for bit, and
    whether each is within its bound."""
    out = {}
    for k, w in want.items():
        g = got[k]
        if torch.equal(w, g):
            continue
        diff = float((w.double() - g.double()).abs().max())
        scale = float(w.double().abs().max())
        kind, bound = BOUNDS.get(k, ("rel", OTHER_REL))
        ok = diff <= (bound if kind == "atol" else bound * max(scale, 1e-30))
        out[k] = dict(max_abs=diff, max_value=scale, bound=f"{kind} {bound}", ok=ok)
    return out


def _numbers(state, aux, metrics) -> dict:
    """What _hold compares."""
    return dict(xyz=state.params["gaussians"].xyz.detach().clone(),
                weight=state.params["deform"]["weight"].detach().clone(),
                denom=aux.denom.clone(), loss=float(metrics["loss"]),
                psnr=float(metrics["psnr"]))


def _hold(want: dict, got: dict) -> dict:
    """{quantity: (error, ok)} at HOLD's bounds (rel for loss and PSNR,
    max |diff| for the tensors)."""
    out = {}
    for k, bound in HOLD.items():
        if k in ("loss", "psnr"):
            err = abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
        else:
            err = float((got[k].double() - want[k].double()).abs().max())
        out[k] = (err, err <= bound)
    return out


def gathered_refresh(torch, cs, mesh, p, state_l, aux_l, cache, graph: bool, dev,
                     densify_check: bool):
    """tools.train's densify event on the mesh, for the tongue problem: the
    whole cloud gathered (with `densify_check`, first `check_densify` on
    it), the densify step (graphed or eager) at chip_smoke.tongue_threshold,
    the 3D filter, the KNN refresh with the tongue graph (from the
    problem's buckets), the shards again. Returns (state shards, aux
    shards, the new cache, its record)."""
    from ed3dgs_torch.models.gaussians import compute_3d_filter
    from ed3dgs_torch.parallel.multihost import to_host
    from ed3dgs_torch.parallel.sharded import shard_train_state
    from ed3dgs_torch.train.trainer import make_densify_step, refresh_knn_cache

    opt, extent = p["opt"], p["extent"]
    state, aux = to_host(mesh, state_l, aux_l)
    check = check_densify(torch, cs, state, aux, p, dev) if densify_check else None
    thr = cs.tongue_threshold(torch, state, aux, opt, extent)[0]
    alive0 = aux.alive.clone()
    fn = make_densify_step(opt, opt.percent_dense, extent, graph=graph)
    state, aux, n_c, n_s = fn(state, aux, torch.Generator(device=dev).manual_seed(0), thr)
    dens = cs.densify_tensors(torch, state, aux, n_c, n_s)
    aux = aux._replace(filter_3d=compute_3d_filter(state.params["gaussians"].xyz, aux.alive,
                                                   *p["fargs"]))
    caps = dict(p["caps"])
    new = refresh_knn_cache(state.params["gaussians"], aux, caps,
                            tongue_enabled=True, coverage_target=opt.knn_coverage_target)
    born = aux.alive & ~alive0
    rec = dict(threshold=thr, n_cloned=int(n_c), n_split=int(n_s), check=check,
               buckets_grew=caps != p["caps"],
               born_tongue=int((born & (aux.tongue_class[:, 0] > 0.5)).sum()),
               in_edges=(int(cache.t_graph.rev_pair.shape[0]),
                         int(new.t_graph.rev_pair.shape[0])),
               densify=dens, cache=new)
    state_l, aux_l = shard_train_state(mesh, state, aux)
    return state_l, aux_l, new, rec


def check_one(torch, cs, mesh, p: dict, dev, densify_check: bool) -> tuple:
    """One problem on this rank, both comms, eager then graphed. Returns
    (its record, with `densify_check` the `check_densify` of the graphed
    strip run: before its refresh where the problem has one, else on its
    last state)."""
    from ed3dgs_torch.parallel.multihost import to_host
    from dataclasses import replace

    from ed3dgs_torch.parallel import comm
    from ed3dgs_torch.parallel.sharded import (gather_train_state, make_sharded_train_step,
                                               shard_batch, shard_train_state)
    from ed3dgs_torch.train.trainer import make_train_step

    on_card = dev.type == "cuda"
    st_l, ax_l = shard_train_state(mesh, p["state"], p["aux"])
    batches = [shard_batch(mesh, b) for b in p["batches"]]
    more = [shard_batch(mesh, b) for b in p["more"]]
    timing = shard_batch(mesh, p["timing"])
    single = None
    if p["hold"]:
        single = _numbers(*make_train_step(p["setup"], p["optimizer"], graph=False)(
            p["state"], p["aux"], p["batches"][0], p["cache"]))
    out, checked = {}, None
    for comms in ("gspmd", "strip"):
        res = {}
        for graph in (False, True):
            step = make_sharded_train_step(replace(p["setup"], comms=comms), p["optimizer"],
                                           mesh, graph=graph)
            s, a, cache = st_l, ax_l, p["cache"]
            r = dict(tensors=[], ledgers=[], replays=[], step_ms=[], metrics=[], hold=None,
                     refresh=None)

            def one(b):
                nonlocal s, a
                replay = bool(graph and step.graphs is not None
                              and step.key(s, a, b, cache) in step.graphs)
                comm.ledger.reset()
                e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                e0.record()
                s, a, m = step(s, a, b, cache)
                e1.record()
                r["ledgers"].append([(x.kind, x.axis, x.bytes, x.tag, x.backward, x.replayed)
                                     for x in comm.ledger.records])
                r["tensors"].append({k: v.detach().clone()
                                     for k, v in cs.state_tensors(s, a, m).items()})
                r["replays"].append(replay)
                r["step_ms"].append((e0, e1))
                r["metrics"].append({k: float(v) for k, v in m.items() if v.numel() == 1})
                return m
            for i, b in enumerate(batches):
                m = one(b)
                if i == 0 and single is not None and not graph:
                    r["hold"] = _hold(single, _numbers(*gather_train_state(mesh, s, a), m))
            if p["refresh"]:
                s, a, cache, r["refresh"] = gathered_refresh(
                    torch, cs, mesh, p, s, a, cache, graph, dev,
                    densify_check and graph and comms == "strip")
                checked = r["refresh"].pop("check") or checked
            for b in more:
                one(b)
            torch.cuda.synchronize()
            r["step_ms"] = [e0.elapsed_time(e1) for e0, e1 in r["step_ms"]]
            waits = (cs.count_waits(torch, lambda: step(s, a, batches[0], cache))
                     if graph else None)
            step(s, a, timing, cache)          # warm (graphed: the key is known)
            events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                      for _ in range(TIME_STEPS)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for e0, e1 in events:
                e0.record()
                s, a, m = step(s, a, timing, cache)
                e1.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / TIME_STEPS
            ms = sorted(e0.elapsed_time(e1) for e0, e1 in events)
            graphs = getattr(step, "graphs", None)
            r.update(waits=waits, ms_median=ms[len(ms) // 2], ms_min=ms[0], wall_ms=wall,
                     captures=len(graphs.captures) if graphs else 0,
                     pool_bytes=graphs.pool_bytes if graphs else 0)
            res[graph] = r
            if densify_check and graph and comms == "strip" and not p["refresh"]:
                checked = check_densify(torch, cs, *to_host(mesh, s, a), p, dev)
            del step, s, a, m, cache
            if on_card:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
        out[comms] = _verdict(torch, cs, p, res[False], res[True], on_card)
        del res
    return out, checked


def _verdict(torch, cs, p: dict, e: dict, g: dict, on_card: bool) -> dict:
    """One comms' record: eager `e` against graphed `g`."""
    diffs = [compare(torch, want, got) for want, got in zip(e["tensors"], g["tensors"])]
    ledger_same = [[x[:5] for x in a] == [x[:5] for x in b]
                   for a, b in zip(e["ledgers"], g["ledgers"])]
    ledger = []
    for recs in g["ledgers"]:
        by = {}
        for kind, axis, nbytes, tag, backward, replayed in recs:
            k = f"{kind}/{axis}/{tag}{'/bwd' if backward else ''}"
            c = by.setdefault(k, {"count": 0, "bytes": 0})
            c["count"] += 1
            c["bytes"] += nbytes
        ledger.append(dict(collectives=by, replayed=any(x[5] for x in recs)))
    faults = []
    if not all(x["ok"] for d in diffs for x in d.values()):
        faults.append("past the bounds")
    if p["exact"] and any(diffs):
        faults.append("not bit for bit")
    if not all(ledger_same):
        faults.append("ledgers differ")
    if g["waits"]:
        faults.append(f"{len(g['waits'])} waits in a replayed step")
    if e["hold"] is not None and not all(ok for _, ok in e["hold"].values()):
        faults.append(f"misses the one-card step {e['hold']}")
    terms = {}
    if p["setup"].tongue_enabled:
        terms = {k: [m[k] for m in g["metrics"]] for k in TONGUE_TERMS}
        if any(v <= 0 for vs in terms.values() for v in vs):
            faults.append(f"a tongue term is not live: {terms}")
    if p["setup"].colmap_supervision:
        valid = [bool(b["pcd_valid"]) for b in p["batches"]]
        terms = {"pcd_loss": [m["pcd_loss"] for m in g["metrics"]], "pcd_valid": valid}
        if any((x > 0) != v for x, v in zip(terms["pcd_loss"], valid)):
            faults.append(f"pcd_loss is not live exactly where pcd_valid: {terms}")
    refresh = None
    if g["refresh"] is not None:
        re_, rg = e["refresh"], g["refresh"]
        dens = sorted(k for k in re_["densify"]
                      if not torch.equal(re_["densify"][k], rg["densify"][k]))
        cache = cs.caches_equal(torch, re_["cache"], rg["cache"])
        refresh = {k: rg[k] for k in ("threshold", "n_cloned", "n_split", "born_tongue",
                                      "in_edges", "buckets_grew")}
        refresh.update(densify_differ=dens, cache_differ=cache)
        after = g["replays"][len(p["batches"]):]
        refresh["replays_after"] = after
        if dens or cache:
            faults.append(f"the refresh differs: densify {dens[:6]}, cache {cache[:6]}")
        if rg["in_edges"][0] == rg["in_edges"][1] or rg["born_tongue"] == 0:
            faults.append(f"the refresh left the tongue graph's in-edges {rg['in_edges']} "
                          f"({rg['born_tongue']} tongue children)")
        if on_card and not all(after) and not rg["buckets_grew"]:
            faults.append(f"after the refresh the graphed step did not replay: {after}")
    steps_ms = dict(graphed=g["step_ms"], eager=e["step_ms"], replay=g["replays"])
    return dict(
        bit_for_bit=[not d for d in diffs], differences=diffs,
        within_bounds=all(x["ok"] for d in diffs for x in d.values()),
        ledger_same=ledger_same, ledger=ledger,
        waits=len(g["waits"]), wait_places=sorted(set(g["waits"]))[:5],
        graphed_ms=g["ms_median"], graphed_ms_min=g["ms_min"], graphed_wall_ms=g["wall_ms"],
        eager_ms=e["ms_median"], eager_ms_min=e["ms_min"], eager_wall_ms=e["wall_ms"],
        captures=g["captures"], pool_bytes=g["pool_bytes"], steps_ms=steps_ms,
        hold={k: v[0] for k, v in e["hold"].items()} if e["hold"] else None, terms=terms,
        refresh=refresh, faults=faults)


def check_rank(rank, world, mesh_shape, device="cuda", config="default"):
    """One rank of the check part: each problem of `config`, both comms,
    eager then graphed, on cuda:rank (device="cpu" runs the same in a gloo
    world, without graphs: a rehearsal of the script's logic, not a
    check)."""
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    from ed3dgs_torch.parallel.mesh import Mesh

    dev = torch.device("cpu") if device == "cpu" else torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = Mesh(*mesh_shape)
    out = {"d": mesh.d, "g": mesh.g}
    for name in PROBLEMS[config]:
        p = check_problem(torch, dev, name)
        first = name == PROBLEMS[config][0]
        out[name], checked = check_one(torch, cs, mesh, p, dev, densify_check=first)
        if first:
            out["densify"] = checked
        if "target_means" in p:
            out[name]["target_means"] = p["target_means"]
        del p, checked
    return out


def check_densify(torch, cs, state, aux, p: dict, dev) -> dict:
    """tools.train's densify event on a mesh (tools/train.py: `whole`, then
    the densify step) on the whole (state, aux) just gathered over the mesh:
    the graphed step's first call (eager run and capture), then eager, then
    graphed again, all from that state and a generator of one seed; at the
    99.9th percentile of the mean screen-space gradient, or on a tongue
    state at chip_smoke.tongue_threshold."""
    from ed3dgs_torch.train.trainer import make_densify_step
    from ed3dgs_torch.utils.graphs import capture_error_mode

    opt, extent = p["opt"], p["extent"]
    if p["setup"].tongue_enabled:
        thr = cs.tongue_threshold(torch, state, aux, opt, extent)[0]
    else:
        mean_grad = (aux.xyz_grad_accum / aux.denom.clamp_min(1.0))[aux.alive & (aux.denom > 0)]
        thr = float(torch.quantile(mean_grad, 0.999))
    graphed = make_densify_step(opt, opt.percent_dense, extent)
    eager = make_densify_step(opt, opt.percent_dense, extent, graph=False)
    alive0 = aux.alive.clone()
    runs = {}
    for name, fn in (("first", graphed), ("eager", eager), ("replayed", graphed)):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn(state, aux, torch.Generator(device=dev).manual_seed(0), thr)
        e1.record()
        torch.cuda.synchronize()
        runs[name] = (cs.densify_tensors(torch, *out), e0.elapsed_time(e1))
    want = runs["eager"][0]
    differ = {name: sorted(k for k in want if not torch.equal(want[k], runs[name][0][k]))
              for name in ("first", "replayed")}
    born = want["aux/alive"] & ~alive0
    return dict(threshold=thr, n_cloned=int(want["n_cloned"]), n_split=int(want["n_split"]),
                alive_before=int(alive0.sum()), differ=differ,
                children_tongue=int((born & (want["aux/tongue_class"][:, 0] > 0.5)).sum()),
                tongue=p["setup"].tongue_enabled,
                bit_for_bit=not any(differ.values()), capture_mode=capture_error_mode(),
                captures=len(graphed.graphs.captures) if graphed.graphs else 0,
                ms={name: ms for name, (_, ms) in runs.items()})


def check_part(gpus: int, card: str, config: str = "default") -> dict:
    from ed3dgs_torch.parallel.multihost import spawn_world

    shape = (2, gpus // 2) if gpus >= 4 and gpus % 2 == 0 else (1, gpus)
    t0 = time.perf_counter()
    ranks = spawn_world(check_rank, gpus, backend="nccl", args=(shape, "cuda", config),
                        deadline_s=900.0, timeout_s=300.0)
    res = {"mesh": f"data={shape[0]},gauss={shape[1]}", "config": config,
           "world_s": time.perf_counter() - t0}
    bad = report_check(ranks, res["mesh"], card, config)
    for name in PROBLEMS[config]:
        res[name] = [rr[name] for rr in ranks]
    res["densify"] = [rr["densify"] for rr in ranks]
    res["rows"] = [(rr["d"], rr["g"]) for rr in ranks]
    if bad:
        print(f"FAIL: check: graphed against eager on {bad}", file=sys.stderr)
        sys.exit(1)
    return res


def report_check(ranks: list, mesh: str, card: str, config: str) -> list:
    """Print each rank's record; return the (problem, comms, rank) that failed."""
    bad = []
    for name in PROBLEMS[config]:
        what = mesh if name == "default" else f"{mesh} {name}"
        # the first rank of each data row: its collectives
        firsts = {rr["d"]: r for r, rr in reversed(list(enumerate(ranks)))}
        for comms in ("gspmd", "strip"):
            for r, rr in enumerate(ranks):
                c = rr[name][comms]
                print(f"[{card}] check {what} {comms} rank {r}: bit for bit a step "
                      f"{c['bit_for_bit']}, within bounds {c['within_bounds']}, ledger same "
                      f"{c['ledger_same']}, waits a replayed step {c['waits']} "
                      f"{c['wait_places']}, ms a step graphed {c['graphed_ms']:.3f} (min "
                      f"{c['graphed_ms_min']:.3f}, wall {c['graphed_wall_ms']:.3f}) eager "
                      f"{c['eager_ms']:.3f} (min {c['eager_ms_min']:.3f}, wall "
                      f"{c['eager_wall_ms']:.3f}), captures {c['captures']}", flush=True)
                if name != "default":
                    print(f"    data row {rr['d']}, gauss {rr['g']}: pool {c['pool_bytes']} "
                          f"bytes; compared steps' ms (CUDA events) graphed "
                          f"{[round(x, 3) for x in c['steps_ms']['graphed']]} (replay "
                          f"{c['steps_ms']['replay']}) eager "
                          f"{[round(x, 3) for x in c['steps_ms']['eager']]}; against the "
                          f"one-card step {c['hold']} (bounds {HOLD}); terms {c['terms']}",
                          flush=True)
                    if c["refresh"]:
                        print(f"    gathered refresh: {c['refresh']}", flush=True)
                for i, d in enumerate(c["differences"]):
                    if d:
                        worst = sorted(d.items(), key=lambda kv: -kv[1]["max_abs"])[:6]
                        print(f"    step {i}: {len(d)} tensors differ; largest {worst}",
                              flush=True)
                if r in firsts.values():
                    for i, led in enumerate(c["ledger"]):
                        print(f"    step {i} collectives (replayed={led['replayed']}): "
                              f"{led['collectives']}", flush=True)
                if c["faults"]:
                    print(f"    FAULTS: {c['faults']}", flush=True)
                if (not c["within_bounds"] or not all(c["ledger_same"]) or c["waits"]
                        or c["faults"]):
                    bad.append((name, comms, r))
    for r, rr in enumerate(ranks):
        d = rr["densify"]
        print(f"[{card}] check {mesh} densify after the gathers, rank {r}: threshold "
              f"{d['threshold']:.3e}, n_cloned {d['n_cloned']}, n_split {d['n_split']} of "
              f"{d['alive_before']} alive"
              + (f", children of tongue class 1 {d['children_tongue']}" if d["tongue"] else "")
              + f"; graphed bit for bit with eager {d['bit_for_bit']} "
              f"{d['differ'] if not d['bit_for_bit'] else ''}; capture mode "
              f"{d['capture_mode']}, captures {d['captures']}; ms by events: first call "
              f"(eager run and capture) {d['ms']['first']:.3f}, eager {d['ms']['eager']:.3f}, "
              f"replayed {d['ms']['replayed']:.3f}", flush=True)
        if (not d["bit_for_bit"] or not d["n_cloned"] + d["n_split"]
                or (d["tongue"] and not d["children_tongue"])):
            bad.append(("densify", r))
    return bad


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, default=4)
    ap.add_argument("--config", default="default", choices=sorted(PROBLEMS))
    ap.add_argument("--iters", type=int, default=None,
                    help="train part iterations (default 60; tongue: TONGUE_CLI_ITERS)")
    ap.add_argument("--parts", default="check,train", help="check, train or both")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    parts = args.parts.split(",")
    import torch
    if torch.cuda.device_count() < args.gpus:
        print(f"needs {args.gpus} GPUs, found {torch.cuda.device_count()}", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from ed3dgs_torch.data.synthetic import generate_scene
    from ed3dgs_torch.parallel.multihost import spawn_world
    from ed3dgs_torch.tools import train

    if args.iters is None:
        args.iters = cs.TONGUE_CLI_ITERS if args.config == "tongue" else 60
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, NCCL "
          f"{torch.cuda.nccl.version()}", flush=True)
    from ed3dgs_torch.ops import cuda_lib
    t0 = time.perf_counter()
    cuda_lib.build()              # once, before the ranks load the libraries
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    res = {"card": card, "config": args.config}
    if "check" in parts:
        try:
            res["check"] = check_part(args.gpus, card, args.config)
        except RuntimeError as e:
            print(f"FAIL: check: {e}", file=sys.stderr)
            sys.exit(1)
    if "train" in parts:
        part = train_part if args.config == "default" else tongue_train_part
        res.update(part(args, card, torch, generate_scene, spawn_world, train))
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


def train_part(args, card, torch, generate_scene, spawn_world, train) -> dict:
    res = {}
    with tempfile.TemporaryDirectory(prefix="ed3dgs_multi_gpu_") as tmp:
        scene = os.path.join(tmp, "scene")
        generate_scene(scene, n_cams=4, n_frames=8, width=802, height=550, n_points=20_000,
                       seed=0, device="cuda")
        t0 = time.perf_counter()
        _, _, _, log = train.main(argv(scene, os.path.join(tmp, "one"), args.iters))
        torch.cuda.synchronize()
        res["one_gpu"] = dict(summary(log), wall_s=time.perf_counter() - t0,
                              graph_captures=log["graph_captures"])
        runs_done = [("1 GPU", res["one_gpu"])]
        print(f"[{card}] 1 GPU graphed: {res['one_gpu']}", flush=True)
        runs = [(argv(scene, os.path.join(tmp, f"m{i}{'g' if graph else 'e'}"), args.iters,
                      ["--mesh", mesh, "--comms", comms, "--dist_backend", "nccl"]), graph)
                for i, (mesh, comms) in enumerate(MESHES) for graph in (True, False)]
        t0 = time.perf_counter()
        try:
            ranks = spawn_world(rank_main, args.gpus, backend="nccl", args=(runs,),
                                deadline_s=1500.0, timeout_s=300.0)
        except RuntimeError as e:
            print(f"FAIL: {e}", file=sys.stderr)
            sys.exit(1)
        res["world_s"] = time.perf_counter() - t0
        base = res["one_gpu"]
        for ((mesh, comms), graph), r in zip([(m, g) for m in MESHES for g in (True, False)],
                                             ranks[0]):
            r["first_loss_rel"] = abs(r["loss_first"] - base["loss_first"]) / base["loss_first"]
            r["speedup_median"] = base["median_iter_ms"] / r["median_iter_ms"]
            way = "graphed" if graph else "eager"
            res[f"{mesh} {comms} {way}"] = r
            runs_done.append((f"{mesh} {comms} {way}", r))
            print(f"[{card}] {args.gpus} GPUs {mesh} {comms} {way}: {r}", flush=True)
    missed = [name for name, r in runs_done if not r["densify"]]
    if missed:
        print(f"FAIL: train: no densify event in {missed}", file=sys.stderr)
        sys.exit(1)
    return res


def tongue_train_part(args, card, torch, generate_scene, spawn_world, train) -> dict:
    """tools.train at configs/nersemble/tongue.py on chip_smoke's tongue cli
    scene: one GPU, then each mesh of MESHES over NCCL, all graphed; then
    the COLMAP configuration on the same scene with a cloud for every other
    frame (COLMAP_CLI_ITERS iterations, both pcd_valid keys), on one GPU and
    on COLMAP_MESH, counting the tool's per-iteration (frame, valid)
    gather and its wait."""
    import chip_smoke as cs
    res = {}
    with tempfile.TemporaryDirectory(prefix="ed3dgs_multi_gpu_tongue_") as tmp:
        scene, clouds = os.path.join(tmp, "scene"), os.path.join(tmp, "clouds")
        generate_scene(scene, n_cams=cs.CLI_CAMS, n_frames=cs.CLI_FRAMES, width=cs.WIDTH,
                       height=cs.HEIGHT, n_points=cs.CLI_POINTS, seed=1,
                       tongue_frac=cs.TONGUE_FRAC, device="cuda")
        write_clouds(scene, clouds, cs.CLI_FRAMES)
        for name, a in (("one_gpu", tongue_argv(scene, os.path.join(tmp, "one"), args.iters)),
                        ("colmap_one_gpu", colmap_argv(scene, os.path.join(tmp, "c1"), clouds))):
            t0 = time.perf_counter()
            res[name] = dict(rank_main(0, 1, [(a, True)])[0], wall_s=time.perf_counter() - t0)
            print(f"[{card}] {name} graphed: {res[name]}", flush=True)
        runs_done = [("1 GPU", res["one_gpu"])]
        runs = [(tongue_argv(scene, os.path.join(tmp, f"m{i}"), args.iters,
                             ["--mesh", mesh, "--comms", comms, "--dist_backend", "nccl"]), True)
                for i, (mesh, comms) in enumerate(MESHES)]
        runs.append((colmap_argv(scene, os.path.join(tmp, "cm"), clouds,
                                 ["--mesh", COLMAP_MESH[0], "--comms", COLMAP_MESH[1],
                                  "--dist_backend", "nccl"]), True))
        t0 = time.perf_counter()
        try:
            ranks = spawn_world(rank_main, args.gpus, backend="nccl", args=(runs,),
                                deadline_s=1500.0, timeout_s=300.0)
        except RuntimeError as e:
            print(f"FAIL: {e}", file=sys.stderr)
            sys.exit(1)
        res["world_s"] = time.perf_counter() - t0
        for (mesh, comms), r, base in zip(MESHES + (COLMAP_MESH,), ranks[0],
                                          [res["one_gpu"]] * len(MESHES)
                                          + [res["colmap_one_gpu"]]):
            r["first_loss_rel"] = abs(r["loss_first"] - base["loss_first"]) / base["loss_first"]
            r["speedup_median"] = base["median_iter_ms"] / r["median_iter_ms"]
            name = f"{mesh} {comms} graphed" + (" colmap" if base is res["colmap_one_gpu"]
                                                else "")
            res[name] = r
            print(f"[{card}] {args.gpus} GPUs {name}: {r}", flush=True)
            if base is res["one_gpu"]:
                runs_done.append((name, r))
    colmap = [("1 GPU colmap", res["colmap_one_gpu"]),
              (f"{COLMAP_MESH[0]} {COLMAP_MESH[1]} colmap",
               res[f"{COLMAP_MESH[0]} {COLMAP_MESH[1]} graphed colmap"])]
    faults = [(name, fault) for name, r in colmap for fault, bad in (
        ("a loss is not finite", not all(math.isfinite(v) for v in (r["loss_first"],
                                                                    r["loss_last"]))),
        ("not both pcd_valid keys", not (r["stage"]["valid"] and r["stage"]["invalid"])))
        if bad]
    if colmap[1][1]["stage"]["gathers"] != COLMAP_CLI_ITERS:
        faults.append((colmap[1][0], f"{colmap[1][1]['stage']['gathers']} (frame, valid) "
                       f"gathers in {COLMAP_CLI_ITERS} iterations"))
    faults += [(name, fault) for name, r in runs_done for fault, bad in (
        ("no densify event", not r["densify"]),
        ("a tongue term is not finite", not r["tongue_finite"]),
        ("a tongue term stayed 0", any(v <= 0 for v in r["tongue_max"].values())),
        ("no tongue Gaussian left", r["total_tongue"][1] <= 0)) if bad]
    if faults:
        print(f"FAIL: tongue train: {faults}", file=sys.stderr)
        sys.exit(1)
    return res


if __name__ == "__main__":
    main()
