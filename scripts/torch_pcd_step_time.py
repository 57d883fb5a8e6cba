"""Time the train step with COLMAP point-cloud supervision on and off.

Usage:
    python3 scripts/torch_pcd_step_time.py [--tree DIR] [--steps 20] [--reps 3] [--out FILE]

The step is chip_smoke.py's main-path step (configs/nersemble/default.py at
full width, the bench cloud of 100,000 Gaussians in a capacity of 100,352,
802x550, the config's batch) with `colmap_supervision` on, as
configs/nersemble/407_tongue_colmap_supervision.py turns it on, and off: a
GT cloud of the config's `colmap_pcd_samples` points within ~1 cm of the
Gaussians. With `--tree DIR` the ed3dgs_torch package of DIR (another
checkout, such as a parent commit unpacked by `git archive`) is imported
and timed by this script's method.

Each repetition runs `--steps` steps with the term off, then on, and
reports per step: the wall time of the steps enqueued back to back with one
synchronise at the end (what a training run pays, host waits included), and
the median device time between CUDA events around each step. Then the loss
term alone, `colmap_pcd_loss` forward and backward, in wall time per call.
The last line is one JSON object. Needs one CUDA device.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    """chip_smoke.py of this checkout (its cloud, camera, setup and batch
    helpers), by path: another tree first on sys.path has its own."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=REPO, help="checkout whose ed3dgs_torch is timed")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--loss-calls", type=int, default=50)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    smoke = load_smoke()

    import ed3dgs_torch
    from ed3dgs_torch.config.loader import load_full_config
    from ed3dgs_torch.convert import gaussians_from_numpy
    from ed3dgs_torch.models.gaussians import compute_3d_filter
    from ed3dgs_torch.ops import cuda_lib
    from ed3dgs_torch.render import raster_config_from_camera
    from ed3dgs_torch.train.losses import colmap_pcd_loss
    from ed3dgs_torch.train.trainer import (KNN_CAPS_DEFAULT, init_train_state,
                                            make_train_step, refresh_knn_cache)
    pkg = os.path.dirname(os.path.abspath(ed3dgs_torch.__file__))
    if os.path.dirname(pkg) != tree:
        sys.exit(f"imported {pkg}, not the package of {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smoke.card_line()
    print(f"{card}; ed3dgs_torch from {pkg}", flush=True)
    cuda_lib.build()

    dev = "cuda"
    cfg = load_full_config(os.path.join(tree, "configs", "nersemble", "default.py"))
    hidden, opt = cfg.hidden, cfg.opt
    fields = smoke.bench_cloud(smoke.N_GAUSS)
    params, aux = gaussians_from_numpy(fields, capacity=smoke.CAPACITY, device=dev)
    cam = smoke.bench_camera(smoke.WIDTH, smoke.HEIGHT)
    rcfg = raster_config_from_camera(cam, pair_capacity=smoke.PAIR_CAPACITY,
                                     chunk=opt.raster_chunk)
    fargs, extent = smoke.filter_cameras(torch, dev)
    aux = aux._replace(filter_3d=compute_3d_filter(params.xyz, aux.alive, *fargs))
    knn_cache = refresh_knn_cache(params, aux, dict(KNN_CAPS_DEFAULT),
                                  coverage_target=opt.knn_coverage_target)
    base = smoke.train_setup(cfg, rcfg)
    B = base.batch_size
    P = cfg.model.colmap_pcd_samples
    rng = np.random.default_rng(7)
    pts = fields["xyz"][rng.integers(0, smoke.N_GAUSS, P)] + rng.normal(0, 0.01, (P, 3))
    pcd = torch.as_tensor(pts.astype(np.float32), device=dev)
    batches = [dict(smoke.make_batch(torch, cam, B, 0.1 + 0.2 * (i % 5), i % 4 == 1, 100 + i,
                                     dev), pcd_points=pcd, pcd_valid=True)
               for i in range(args.steps)]

    variants = {}
    for name, on in (("off", False), ("on", True)):
        setup = dataclasses.replace(base, colmap_supervision=on,
                                    deform_from_iter=hidden.deform_from_iter)
        state, optimizer = init_train_state(params, hidden, opt, extent, seed=0)
        state = state._replace(iteration=smoke.TRAIN_ITERATION)
        variants[name] = [make_train_step(setup, optimizer), state, aux]

    def run(name):
        step, state, taux = variants[name]
        state, taux, _ = step(state, taux, batches[0], knn_cache)   # warm-up
        torch.cuda.synchronize()
        events = []
        t0 = time.perf_counter()
        for b in batches:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, taux, metrics = step(state, taux, b, knn_cache)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        if (float(metrics["pcd_loss"]) > 0) != (name == "on"):
            sys.exit(f"step {name}: pcd_loss {float(metrics['pcd_loss'])}")
        wall = (time.perf_counter() - t0) * 1e3 / len(batches)
        variants[name][1:] = [state, taux]
        return wall, float(np.median([s.elapsed_time(e) for s, e in events]))

    g = params.xyz.detach().clone().requires_grad_()

    def loss_fb():
        colmap_pcd_loss(pcd, g, aux.alive).backward()

    def loss_ms():
        loss_fb()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.loss_calls):
            loss_fb()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / args.loss_calls

    out = {"card": card, "tree": tree, "P": P, "capacity": smoke.CAPACITY, "batch": B,
           "steps": args.steps, "reps": []}
    for r in range(args.reps):
        rep = {}
        for name in ("off", "on"):
            rep[f"{name}_wall_ms"], rep[f"{name}_event_ms"] = run(name)
        rep["loss_fb_wall_ms"] = loss_ms()
        out["reps"].append(rep)
        print(f"rep {r}: step off {rep['off_wall_ms']:.3f} ms wall, {rep['off_event_ms']:.3f} ms "
              f"events; on {rep['on_wall_ms']:.3f} ms wall, {rep['on_event_ms']:.3f} ms events; "
              f"colmap_pcd_loss fwd+bwd {rep['loss_fb_wall_ms']:.3f} ms wall", flush=True)
    for key in out["reps"][0]:
        out[f"median_{key}"] = float(np.median([rep[key] for rep in out["reps"]]))
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
