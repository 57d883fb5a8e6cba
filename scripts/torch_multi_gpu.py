#!/usr/bin/env python3
"""The sharded step over NCCL, graphed against eager, and tools.train on one
GPU and on N GPUs (NCCL, a GPU a rank), same scene.

    python3 scripts/torch_multi_gpu.py [--gpus 4] [--iters 60] [--parts check,train]
                                       [--out FILE]

The check part (`--parts check`) runs one NCCL world of N spawned ranks
(`parallel.multihost.spawn_world`, rank r on cuda:r) at data=2 x gauss=N/2
(data=1 x gauss=N below four cards) on chip_smoke.py's bench problem (the
100,000-Gaussian cloud at the full width of configs/nersemble/default.py,
802x550, its KNN cache, iteration 20,000) with a batch of four views. For
each comms ("gspmd", "strip") it takes CHECK_STEPS eager sharded steps
(graph=False) and CHECK_STEPS graphed ones (the default: a CUDA graph per
key, the step's collectives inside it) from the same shards, SSIM on the
middle step (two keys, so the last graphed step replays the first one's
graph), and compares every state tensor and metric after each step bit
for bit, or else within the bounds of tests/test_torch_parallel_step.py
(xyz atol 5e-5, the deformation `weight` atol 5e-6, `denom` atol 1e-6,
`l1_items` rtol 1e-5; every other tensor within 1e-5 of its largest
value) with the largest differences printed. It reads each step's
collectives by kind and bytes from parallel/comm.py's ledger (a replay
appends its key's records), which must match; counts the host waits of a
replayed step (chip_smoke.py `count_waits`, sync debug mode "warn"),
which must be 0; and times TIME_STEPS more steps each way by CUDA events
(rank 0's card). Then it makes tools.train's densify event on the mesh
from the last graphed strip state: the whole cloud gathered over NCCL
(`multihost.to_host`), at once the densify step graphed (its first call
runs eagerly and captures while NCCL's watchdog thread runs), eager, and
graphed again (a replay), each from the same whole state with a
generator of one seed, at the 99.9th percentile of the cloud's mean
screen-space gradient (so that it clones and splits): bit for bit on
every rank, each timed by events. A mismatch exits non-zero.

The train part (`--parts train`) generates chip_smoke.py's cli scene (4
cameras, 8 frames, 802x550, 20,000 points) on cuda:0 and trains it at the
full width of configs/nersemble/default.py with batch 4 (chip_smoke's
CLI_SET schedule, but densifying once, at iteration 50): once in this
process on cuda:0 (graphed, the tool's default), then for each mesh in
MESHES, graphed (the default over NCCL) and eager, in one NCCL world of N
spawned ranks (`tools.train.main(... --mesh ... --dist_backend nccl)`).
"Eager" there means the train step only (made with graph=False): the
tool has no option for it, so the script wraps `make_train_step`; the
densify step stays graphed in every run. Each run must cross its densify
event. Prints,
for each run, the median and mean wall ms an iteration (rank 0's loop,
host clock; the first 10 iterations left out), the first iteration's loss
against the one-GPU run's (the same state and batch, so equal up to
summation order), the last loss, the test PSNRs, the densify events and
the graph captures. Every line names the card; one JSON line holds all of it (also
to --out). Needs N GPUs; fails on a run that fails or misses its deadline.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = (("data=4", "gspmd"), ("data=2,gauss=2", "gspmd"), ("data=2,gauss=2", "strip"),
          ("gauss=4", "strip"))
SKIP = 10          # warm-up iterations left out of the times


def argv(scene, model, iters, extra=()):
    return ["-s", scene, "-m", model,
            "--configs", os.path.join(REPO, "configs", "nersemble", "default.py"),
            "--duration", "8", "--iterations", str(iters), "--test_every", str(iters // 2),
            "--quiet", "--seed", "0", "--no_tensorboard", "--device", "cuda", *extra,
            "--set", "batch_size=4", "deform_from_iter=50", "densify_from_iter=40",
            "densify_until_iter=260", "densification_interval=50",
            "radegs_regularization_from_iter=0", "min_embeddings=4", "max_embeddings=8"]


def summary(log) -> dict:
    ms = log["iter_ms"][SKIP:]
    ms_sorted = sorted(ms)
    return dict(median_iter_ms=ms_sorted[len(ms) // 2], mean_iter_ms=sum(ms) / len(ms),
                loss_first=log["loss"][0], loss_last=log["loss"][-1],
                test_psnr=[(int(i), float(v)) for i, v in log["test_psnr"]],
                points_end=log["points_end"], densify=log["densify"])


def rank_main(rank, world, runs):
    """tools.train for each (argv, graph) of `runs`; graph=False makes the
    tool's train step eager (the tool itself graphs it over NCCL); its
    densify step stays graphed."""
    import torch
    sys.path.insert(0, REPO)
    from ed3dgs_torch.tools import train
    from ed3dgs_torch.train import trainer

    make = trainer.make_train_step
    out = []
    for a, graph in runs:
        trainer.make_train_step = (make if graph else
                                   lambda setup, opt, graph=True: make(setup, opt, graph=False))
        try:
            _, _, _, log = train.main(a)
        finally:
            trainer.make_train_step = make
        torch.cuda.synchronize()
        out.append(dict(summary(log), graph_captures=log["graph_captures"])
                   if rank == 0 else None)
    return out


# --- the check part ---------------------------------------------------------------

CHECK_STEPS = 3        # compared steps each way; SSIM on the middle one
TIME_STEPS = 10        # timed steps each way, after the compared ones
CHECK_EYES = ((0.0, 0.0, 0.0), (0.15, 0.05, 0.0), (-0.15, 0.0, 0.0), (0.0, -0.1, 0.0))
# graphed against eager where they are not bit for bit: the bounds of
# tests/test_torch_parallel_step.py against JAX's sharded step
BOUNDS = {"params/gaussians/xyz": ("atol", 5e-5), "params/deform/weight": ("atol", 5e-6),
          "aux/denom": ("atol", 1e-6), "metrics/l1_items": ("rtol", 1e-5)}
OTHER_REL = 1e-5       # any other tensor: max |diff| / max |value|


def check_problem(torch, dev):
    """chip_smoke.py's bench problem on `dev`, the same on every rank (numpy
    seeds; the KNN cache is bit-exact): (state, aux, cache, setup,
    optimizer, batches, the timing batch, the optimisation config, the
    scene extent), with one batch of four views a step."""
    import chip_smoke as cs
    from dataclasses import replace

    from ed3dgs_torch.config.loader import load_full_config
    from ed3dgs_torch.convert import gaussians_from_numpy
    from ed3dgs_torch.models.gaussians import compute_3d_filter
    from ed3dgs_torch.render import raster_config_from_camera
    from ed3dgs_torch.train.trainer import (KNN_CAPS_DEFAULT, init_train_state,
                                            refresh_knn_cache)

    cfg = load_full_config(os.path.join(REPO, "configs", "nersemble", "default.py"))
    params, aux = gaussians_from_numpy(cs.bench_cloud(cs.N_GAUSS), capacity=cs.CAPACITY,
                                       device=dev)
    cams = [cs.bench_camera(cs.WIDTH, cs.HEIGHT, eye) for eye in CHECK_EYES]
    rcfg = raster_config_from_camera(cams[0], pair_capacity=cs.PAIR_CAPACITY,
                                     chunk=cfg.opt.raster_chunk)
    setup = replace(cs.train_setup(cfg, rcfg), batch_size=len(cams))
    fargs, extent = cs.filter_cameras(torch, dev)
    aux = aux._replace(filter_3d=compute_3d_filter(params.xyz, aux.alive, *fargs))
    cache = refresh_knn_cache(params, aux, dict(KNN_CAPS_DEFAULT),
                              coverage_target=cfg.opt.knn_coverage_target)
    state, optimizer = init_train_state(params, cfg.hidden, cfg.opt, extent, seed=0)
    state = state._replace(iteration=cs.TRAIN_ITERATION)

    def batch(i, ssim):
        views = [cs.make_batch(torch, c, 1, 0.1 + 0.2 * i, ssim, 100 + 10 * i + j, dev)
                 for j, c in enumerate(cams)]
        return {k: (torch.cat([v[k] for v in views]) if torch.is_tensor(views[0][k])
                    else views[0][k]) for k in views[0]}
    batches = [batch(i, i == 1) for i in range(CHECK_STEPS)]
    return (state, aux, cache, setup, optimizer, batches, batch(CHECK_STEPS, False), cfg.opt,
            extent)


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


def check_rank(rank, world, mesh_shape, device="cuda"):
    """One rank of the check part: both comms, eager then graphed, on
    cuda:rank (device="cpu" runs the same in a gloo world, without graphs:
    a rehearsal of the script's logic, not a check)."""
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from dataclasses import replace

    from ed3dgs_torch.parallel import comm
    from ed3dgs_torch.parallel.mesh import Mesh
    from ed3dgs_torch.parallel.sharded import (make_sharded_train_step, shard_batch,
                                               shard_train_state)

    dev = torch.device("cpu") if device == "cpu" else torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    (state, aux, cache, setup, optimizer, batches, timing, opt,
     extent) = check_problem(torch, dev)
    mesh = Mesh(*mesh_shape)
    st_l, ax_l = shard_train_state(mesh, state, aux)
    batches = [shard_batch(mesh, b) for b in batches]
    timing = shard_batch(mesh, timing)
    del state, aux
    out = {}
    for comms in ("gspmd", "strip"):
        res = {}
        for graph in (False, True):
            step = make_sharded_train_step(replace(setup, comms=comms), optimizer, mesh,
                                           graph=graph)
            s, a = st_l, ax_l
            tensors, ledgers = [], []
            for b in batches:
                comm.ledger.reset()
                s, a, m = step(s, a, b, cache)
                ledgers.append([(r.kind, r.axis, r.bytes, r.tag, r.backward, r.replayed)
                                for r in comm.ledger.records])
                tensors.append({k: v.detach().clone()
                                for k, v in cs.state_tensors(s, a, m).items()})
            waits = (cs.count_waits(torch, lambda: step(s, a, batches[0], cache))
                     if graph else None)
            step(s, a, timing, cache)          # the timing key's first run (graphed: capture)
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
            res[graph] = dict(tensors=tensors, ledgers=ledgers, waits=waits,
                              ms_median=ms[len(ms) // 2], ms_min=ms[0], wall_ms=wall,
                              captures=(len(step.graphs.captures)
                                        if getattr(step, "graphs", None) else 0))
            if graph and comms == "strip":
                trained = (s, a)           # the densify check's shards
            del step, s, a, m
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        e, g = res[False], res[True]
        diffs = [compare(torch, want, got) for want, got in zip(e["tensors"], g["tensors"])]
        ledger_same = [[r[:5] for r in x] == [r[:5] for r in y]
                       for x, y in zip(e["ledgers"], g["ledgers"])]
        summary_ = []
        for recs in g["ledgers"]:
            by = {}
            for kind, axis, nbytes, tag, backward, replayed in recs:
                k = f"{kind}/{axis}/{tag}{'/bwd' if backward else ''}"
                c = by.setdefault(k, {"count": 0, "bytes": 0})
                c["count"] += 1
                c["bytes"] += nbytes
            summary_.append(dict(collectives=by, replayed=any(r[5] for r in recs)))
        out[comms] = dict(
            bit_for_bit=[not d for d in diffs], differences=diffs,
            within_bounds=all(x["ok"] for d in diffs for x in d.values()),
            ledger_same=ledger_same, ledger=summary_,
            waits=len(g["waits"]), wait_places=sorted(set(g["waits"]))[:5],
            graphed_ms=g["ms_median"], graphed_ms_min=g["ms_min"], graphed_wall_ms=g["wall_ms"],
            eager_ms=e["ms_median"], eager_ms_min=e["ms_min"], eager_wall_ms=e["wall_ms"],
            captures=g["captures"])
        del res, e, g
    out["densify"] = check_densify(torch, cs, mesh, *trained, opt, extent, dev)
    return out


def check_densify(torch, cs, mesh, state_l, aux_l, opt, extent, dev) -> dict:
    """tools.train's densify event on a mesh (tools/train.py: `whole`, then
    the densify step): the graphed step's first call (eager run and
    capture) right after the gathers, then eager, then graphed again, all
    from the same whole state and a generator of one seed."""
    from ed3dgs_torch.parallel.multihost import to_host
    from ed3dgs_torch.train.trainer import make_densify_step
    from ed3dgs_torch.utils.graphs import capture_error_mode

    state, aux = to_host(mesh, state_l, aux_l)
    mean_grad = (aux.xyz_grad_accum / aux.denom.clamp_min(1.0))[aux.alive & (aux.denom > 0)]
    thr = float(torch.quantile(mean_grad, 0.999))
    graphed = make_densify_step(opt, opt.percent_dense, extent)
    eager = make_densify_step(opt, opt.percent_dense, extent, graph=False)
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
    return dict(threshold=thr, n_cloned=int(want["n_cloned"]), n_split=int(want["n_split"]),
                alive_before=int(aux.alive.sum()), differ=differ,
                bit_for_bit=not any(differ.values()), capture_mode=capture_error_mode(),
                captures=len(graphed.graphs.captures) if graphed.graphs else 0,
                ms={name: ms for name, (_, ms) in runs.items()})


def check_part(gpus: int, card: str) -> dict:
    from ed3dgs_torch.parallel.multihost import spawn_world

    shape = (2, gpus // 2) if gpus >= 4 and gpus % 2 == 0 else (1, gpus)
    t0 = time.perf_counter()
    ranks = spawn_world(check_rank, gpus, backend="nccl", args=(shape,), deadline_s=900.0,
                        timeout_s=300.0)
    res = {"mesh": f"data={shape[0]},gauss={shape[1]}", "world_s": time.perf_counter() - t0}
    bad = []
    for comms in ("gspmd", "strip"):
        for r, rr in enumerate(ranks):
            c = rr[comms]
            print(f"[{card}] check {res['mesh']} {comms} rank {r}: bit for bit a step "
                  f"{c['bit_for_bit']}, within bounds {c['within_bounds']}, ledger same "
                  f"{c['ledger_same']}, waits a replayed step {c['waits']} "
                  f"{c['wait_places']}, ms a step graphed {c['graphed_ms']:.3f} (min "
                  f"{c['graphed_ms_min']:.3f}, wall {c['graphed_wall_ms']:.3f}) eager "
                  f"{c['eager_ms']:.3f} (min {c['eager_ms_min']:.3f}, wall "
                  f"{c['eager_wall_ms']:.3f}), captures {c['captures']}", flush=True)
            for i, d in enumerate(c["differences"]):
                if d:
                    worst = sorted(d.items(), key=lambda kv: -kv[1]["max_abs"])[:6]
                    print(f"    step {i}: {len(d)} tensors differ; largest {worst}", flush=True)
            if r == 0:
                for i, led in enumerate(c["ledger"]):
                    print(f"    step {i} collectives (replayed={led['replayed']}): "
                          f"{led['collectives']}", flush=True)
            if not c["within_bounds"] or not all(c["ledger_same"]) or c["waits"]:
                bad.append((comms, r))
        res[comms] = [rr[comms] for rr in ranks]
    for r, rr in enumerate(ranks):
        d = rr["densify"]
        print(f"[{card}] check {res['mesh']} densify after the gathers, rank {r}: threshold "
              f"{d['threshold']:.3e}, n_cloned {d['n_cloned']}, n_split {d['n_split']} of "
              f"{d['alive_before']} alive; graphed bit for bit with eager {d['bit_for_bit']} "
              f"{d['differ'] if not d['bit_for_bit'] else ''}; capture mode "
              f"{d['capture_mode']}, captures {d['captures']}; ms by events: first call "
              f"(eager run and capture) {d['ms']['first']:.3f}, eager {d['ms']['eager']:.3f}, "
              f"replayed {d['ms']['replayed']:.3f}", flush=True)
        if not d["bit_for_bit"] or not d["n_cloned"] + d["n_split"]:
            bad.append(("densify", r))
    res["densify"] = [rr["densify"] for rr in ranks]
    if bad:
        print(f"FAIL: check: graphed against eager on {bad}", file=sys.stderr)
        sys.exit(1)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, default=4)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--parts", default="check,train", help="check, train or both")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    parts = args.parts.split(",")
    import torch
    if torch.cuda.device_count() < args.gpus:
        print(f"needs {args.gpus} GPUs, found {torch.cuda.device_count()}", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, REPO)
    from ed3dgs_torch.data.synthetic import generate_scene
    from ed3dgs_torch.parallel.multihost import spawn_world
    from ed3dgs_torch.tools import train

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
    res = {"card": card}
    if "check" in parts:
        try:
            res["check"] = check_part(args.gpus, card)
        except RuntimeError as e:
            print(f"FAIL: check: {e}", file=sys.stderr)
            sys.exit(1)
    if "train" in parts:
        res.update(train_part(args, card, torch, generate_scene, spawn_world, train))
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


if __name__ == "__main__":
    main()
