#!/usr/bin/env python3
"""tools.train on one GPU and on N GPUs (NCCL, a GPU a rank), same scene.

    python3 scripts/torch_multi_gpu.py [--gpus 4] [--iters 60] [--out FILE]

Generates chip_smoke.py's cli scene (4 cameras, 8 frames, 802x550, 20,000
points) on cuda:0 and trains it at the full width of
configs/nersemble/default.py with batch 4 (chip_smoke's CLI_SET
schedule): once in this process on cuda:0, then for each mesh in MESHES
in one NCCL world of N spawned ranks (`parallel.multihost.spawn_world`,
rank r on cuda:r, `tools.train.main(... --mesh ... --dist_backend nccl)`).
Prints, for each run, the median and mean wall ms an iteration (rank 0's
loop, host clock; the first 10 iterations left out), the first
iteration's loss against the one-GPU run's (the same state and batch, so
equal up to summation order), the last loss and the test PSNRs, and one
JSON line with all of it (also to --out). Needs N GPUs; fails on a run
that fails or misses its deadline.
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
            "--set", "batch_size=4", "deform_from_iter=50", "densify_from_iter=100",
            "densify_until_iter=260", "densification_interval=50",
            "radegs_regularization_from_iter=0", "min_embeddings=4", "max_embeddings=8"]


def summary(log) -> dict:
    ms = log["iter_ms"][SKIP:]
    ms_sorted = sorted(ms)
    return dict(median_iter_ms=ms_sorted[len(ms) // 2], mean_iter_ms=sum(ms) / len(ms),
                loss_first=log["loss"][0], loss_last=log["loss"][-1],
                test_psnr=[(int(i), float(v)) for i, v in log["test_psnr"]],
                points_end=log["points_end"])


def rank_main(rank, world, runs):
    import torch
    sys.path.insert(0, REPO)
    from ed3dgs_torch.tools import train

    out = []
    for a in runs:
        _, _, _, log = train.main(a)
        torch.cuda.synchronize()
        out.append(summary(log) if rank == 0 else None)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpus", type=int, default=4)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
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
    print(card.strip(), flush=True)
    with tempfile.TemporaryDirectory(prefix="ed3dgs_multi_gpu_") as tmp:
        scene = os.path.join(tmp, "scene")
        generate_scene(scene, n_cams=4, n_frames=8, width=802, height=550, n_points=20_000,
                       seed=0, device="cuda")
        t0 = time.perf_counter()
        _, _, _, log = train.main(argv(scene, os.path.join(tmp, "one"), args.iters))
        torch.cuda.synchronize()
        res = {"one_gpu": dict(summary(log), wall_s=time.perf_counter() - t0)}
        print(f"1 GPU: {res['one_gpu']}", flush=True)
        runs = [argv(scene, os.path.join(tmp, f"m{i}"), args.iters,
                     ["--mesh", mesh, "--comms", comms, "--dist_backend", "nccl"])
                for i, (mesh, comms) in enumerate(MESHES)]
        t0 = time.perf_counter()
        try:
            ranks = spawn_world(rank_main, args.gpus, backend="nccl", args=(runs,),
                                deadline_s=900.0, timeout_s=300.0)
        except RuntimeError as e:
            print(f"FAIL: {e}", file=sys.stderr)
            sys.exit(1)
        res["world_s"] = time.perf_counter() - t0
        base = res["one_gpu"]
        for (mesh, comms), r in zip(MESHES, ranks[0]):
            r["first_loss_rel"] = abs(r["loss_first"] - base["loss_first"]) / base["loss_first"]
            r["speedup_median"] = base["median_iter_ms"] / r["median_iter_ms"]
            res[f"{mesh} {comms}"] = r
            print(f"{args.gpus} GPUs {mesh} {comms}: {r}", flush=True)
    res["card"] = card.strip()
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
