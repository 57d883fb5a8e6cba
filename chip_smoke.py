#!/usr/bin/env python3
"""Smoke run of ed3dgs_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Builds the CUDA kernels from ed3dgs_torch/csrc (nvcc, sm_90a, one process per
source, all at once), then, at the width of configs/nersemble/default.py
(net_width 128, defor_depth 1, 256-d temporal and 32-d Gaussian embedding,
max_embeddings 150, SH degree 3, 3D filter on, bf16 activations) on the
bench scene (100k Gaussians, capacity 100,352, 802x550, pair capacity 2^20,
chunk 128):

1. renders one warm-up frame and records the inputs the render hands K1, K4
   and K5a; holds each of them against its plain PyTorch version on those
   inputs (K4 and K5a bit-exact; K1 within the tolerances below) and times
   kernel, plain version and library yardstick with CUDA events, L2 flushed
   before every launch (K1 and K2 also report their registers, shared
   memory and resident CTAs per SM);
2. drives the forward main path: `ed3dgs_torch.render.render` on three
   frames. Every launch count is set to 0 just before and read just after;
   K1, K4 and K5a must each have risen by one per frame. Profiles one frame
   and counts K4's kernels in it (one: its single pass);
3. drives the training loop of the JAX package's tools/train.py at the
   config's reg_coef (1.0) and knn_coverage_target (0.95): the 3D filter
   from `compute_3d_filter` over the bench camera and four around it;
   `refresh_knn_cache` (its wall time, final buckets, overflow, far demand
   and the trainer's coverage measure) and its two halves timed apart (the
   neighbour search `_cache_inputs`, the graph preparation `_prepare_cache`);
   `init_train_state` ->
   `make_train_step`, one warm-up step that records the inputs the step
   hands K2, K3, K5b, K6 and K7, then five steps at iteration 20,000
   (deformation, coarse-to-fine, SH 3, the KNN regulariser and the
   depth-normal term live; SSIM on two of them). Every count is set to 0
   just before the five steps: K1-K5b must have risen by steps x batch, K6
   and K7 by exactly one per step, K8 (no production caller) not at all.
   Prints each step's loss, the step time by CUDA events, the host time to
   return from each step and the device allocations (cudaMalloc) it made,
   and one profiled
   step's device busy time, idle share and top device items, and K6's and
   K7's device time inside it (warm L2), then profiles the step four
   times in turns with K3 reading the pair-gradient rows through the
   inverse pair permutation (as shipped) and with the gather before K3
   (the unfolded path) and reports the segment_sum stage of each. Then
   `make_densify_step` at the config's gradient threshold (n_cloned,
   n_split, the alive count, its time) or, where nothing reaches it, at the
   99.9th percentile of the same statistics, the filter and KNN refreshes,
   and two more steps, counted as the five were;
4. holds K2, K3, K5b, K6, K7 and K8 against their plain versions on the
   recorded inputs (K5b bit-exact; K2's live-chunk counts exactly and every
   row of every tile within K2_REL of its column's largest value; K3, as
   the step calls it (through the index) and on the gathered rows, and K8
   within K3_REL of the largest output; the KNN loss within KNN_LOSS_REL
   and every row of dL/demb within KNN_ROW_REL of its largest value), runs
   the payload gradient (K2 -> K3 through the index) and the KNN gradient (K6 ->
   K7) twice each and requires bit-identical results, and times them as in
   1 (K6 and K7 also report registers, shared memory, spilled bytes,
   resident CTAs per SM and their wrappers' host microseconds a call, and
   the graph's in-degree distribution);
5. compares a 4096-Gaussian cut on the card with the CPU: its bf16
   deformation, its render at 160x110 (float32 activations), one train
   step's loss and gradients at reg_coef 1 (float32 activations, each
   device building its own KNN cache) at the config's 32-d Gaussian
   embedding and again at 16-d (the KNN kernels run it zero-padded), one
   `densify` with the same injected draws, and `create_from_points`.

Weights are random, from numpy seeds; so are the training targets. Results go
to DIR/chip_smoke.json (default smoke_out/ in the checkout), with the
profiles and nvcc's register report beside it. The last three lines of
standard output are the card as nvidia-smi names it, the kernels' JSON line
and the result line. Any failure exits non-zero before the result line.
Needs one CUDA device; refuses to run without one.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

N_GAUSS, CAPACITY = 100_000, 100_352
WIDTH, HEIGHT = 802, 550
PAIR_CAPACITY = 1 << 20
FRAME_TIMES = (0.0, 0.5, 1.0)
TRAIN_STEPS = 5
TRAIN_ITERATION = 20_000
SSIM_STEPS = (1, 3)          # steps (of the five) with the periodic SSIM term on
SMALL_N, SMALL_W, SMALL_H = 4096, 160, 110
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit). Integer work
# is counted against the fp32 CUDA-core rate: the table has no int32 rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations per pair-pixel evaluation of K1 (offsets, exponent, exp2,
# opacity, clamp, the two pass tests) and per blended splat (transmittance,
# weight, 12 channel and 8 plane-term accumulations, include test)
K1_OPS_PER_EVAL = 14
K1_OPS_PER_INCLUDE = 45
# The function K2 computes needs two alpha evaluations per needed
# pair-pixel (the front-to-back pass and the back-to-front one that forms
# the gradient) and, per blended splat, one cotangent dot (~50 flops), the
# alpha gradient (~10) and 26 gradient terms with their sums (~60). It reads
# 10 channels of the forward output and 17 of its cotangent.
K2_OPS_PER_EVAL = 2 * K1_OPS_PER_EVAL
K2_OPS_PER_INCLUDE = 120
K2_CHANNELS_READ = 10 + 17

# K1 against its plain version: the two sum the same rows in another order
# (a sequential product and sum against torch.cumprod and einsum), so values
# differ by float rounding scaled by 1/weight where a pixel has little
# coverage. Every channel is held to K1_ATOL + K1_RTOL*|value| on every
# pixel, except the median ones (mcoord, mdepth): a pixel whose
# transmittance sits at the 0.5 crossing may select the neighbouring splat,
# and at most K1_MAX_FLIPPED of the pixels may do so.
K1_ATOL, K1_RTOL = 1e-4, 1e-4
K1_MAX_FLIPPED = 1e-3          # fraction of pixels per median channel
# The small render, card against CPU, under the same rule: float32
# activations on both (bf16 rounding of the MLP would differ with the
# accumulation order; the bf16 path is held to the JAX package's on the CPU
# by tests/test_torch_deformation.py).
SMALL_ATOL, SMALL_RTOL, SMALL_MAX_FLIPPED = 1e-4, 1e-4, 1e-3
MEDIAN_KEYS = ("median_coord", "median_depth")
# The bf16 deformation of the small cut, card against CPU: both round each
# layer's f32-accumulated product to bf16, and only a value whose sum lands
# at a rounding midpoint in one summation order and not the other rounds the
# other way. At most BF16_MAX_DIFFERING of each output's values may differ by
# more than BF16_ATOL; float32 activations differ in nearly all of them.
BF16_ATOL, BF16_MAX_DIFFERING = 1e-6, 1e-3
# K2 against its plain version: every row of every tile within K2_REL of
# its column's largest value (sequential sums against cumprod/cumsum/einsum).
# K3 (and K8, the same kernel) against its plain version: both round a
# float64-exact sum once.
K2_REL, K3_REL = 1e-4, 1e-6
# K6 -> K7 against the plain chain: the kernel reduces d2 by a shuffle
# butterfly and the loss by CTA partials, torch.sum in another order; every
# other operation is the same. The loss within KNN_LOSS_REL, every row of
# dL/demb within KNN_ROW_REL of that row's largest value.
KNN_LOSS_REL, KNN_ROW_REL = 1e-5, 1e-5
# the 3D filter's cameras: the bench camera and four around it
FILTER_EYES = ((0.0, 0.0, 0.0), (0.3, 0.0, 0.0), (-0.3, 0.0, 0.0), (0.0, 0.2, 0.0),
               (0.0, -0.2, 0.0))
MORE_STEPS = 2               # steps after the densify step and the refreshes
# the small cut's densify: free capacity beside the cloud, hot statistics
SMALL_CAP = 5120
# One train step of the small cut, card against CPU (float32 activations):
# the loss within SMALL_LOSS_REL, and every gradient leaf within
# SMALL_GRAD_REL of that leaf's largest value.
SMALL_LOSS_REL, SMALL_GRAD_REL = 1e-5, 1e-3

KERNELS = {
    "K1": dict(name="forward_blend", route="cuda",
               source="ed3dgs_torch/csrc/rasterize_forward.cu",
               replaces="ed3dgs_tpu/ops/rasterize_pallas.py:711"),
    "K4": dict(name="fused_bin_scans", route="cuda",
               source="ed3dgs_torch/csrc/binning_scan.cu",
               replaces="ed3dgs_tpu/ops/binning_scan.py:148"),
    "K5a": dict(name="unpack_image", route="cuda",
                source="ed3dgs_torch/csrc/relayout.cu",
                replaces="ed3dgs_tpu/ops/relayout.py:68"),
    "K2": dict(name="backward_blend", route="cuda",
               source="ed3dgs_torch/csrc/rasterize_backward.cu",
               replaces="ed3dgs_tpu/ops/rasterize_pallas.py:654"),
    "K3": dict(name="segment_sum_rows", route="cuda",
               source="ed3dgs_torch/csrc/segment_sum.cu",
               replaces="ed3dgs_tpu/ops/segment_sum.py:122"),
    "K5b": dict(name="pack_image", route="cuda",
                source="ed3dgs_torch/csrc/relayout.cu",
                replaces="ed3dgs_tpu/ops/relayout.py:83"),
    "K6": dict(name="knn_rows", route="cuda", source="ed3dgs_torch/csrc/knn_loss.cu",
               replaces="ed3dgs_tpu/ops/knn_loss.py:504"),
    "K7": dict(name="knn_reverse", route="cuda", source="ed3dgs_torch/csrc/knn_loss.cu",
               replaces="ed3dgs_tpu/ops/knn_loss.py:545"),
    "K8": dict(name="segment_sum_rows_packed", route="cuda",
               source="ed3dgs_torch/csrc/segment_sum.cu",
               replaces="ed3dgs_tpu/ops/segment_sum.py:228"),
}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bench_cloud(n: int, seed: int = 0) -> dict:
    """The bench scene's cloud (bench.py `_scene`) as raw model parameters,
    plus per-Gaussian embeddings and 3D-filter scales from a second seed."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.7, 0.7, n),
                      rng.uniform(1.2, 3.5, n)], 1)
    scales = np.exp(rng.normal(-4.5, 0.5, (n, 3)))
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, n)
    shs = rng.normal(0, 0.3, (n, 16, 3)) * np.array([3.0] + [0.3] * 15)[None, :, None]
    extra = np.random.default_rng(seed + 1)
    fields = {
        "xyz": means, "features_dc": shs[:, :1], "features_rest": shs[:, 1:],
        "scaling": np.log(scales), "rotation": q,
        "opacity": np.log(opac / (1.0 - opac))[:, None],
        "embedding": extra.normal(0, 0.1, (n, 32)),
        # RaDe-GS 3D filter: sqrt(0.2) * depth / focal, about 1e-3 here
        "filter_3d": extra.uniform(5e-4, 1.5e-3, (n, 1)),
        "tongue_class": np.zeros((n, 1)),
    }
    return {k: np.asarray(v, np.float32) for k, v in fields.items()}


def bench_camera(width: int, height: int, eye=(0.0, 0.0, 0.0)):
    from ed3dgs_torch.data.cameras import look_at_camera
    fov = math.radians(50.0)
    return look_at_camera(eye, (0, 0, 2.0), (0, -1, 0), fov,
                          2 * math.atan(math.tan(fov / 2) * height / width),
                          width, height).matrices()


def filter_cameras(torch, device):
    """compute_3d_filter's camera arguments for FILTER_EYES, and the scene
    extent those cameras give (1.1 x the largest distance of a centre from
    their mean, the reference's getNerfppNorm)."""
    cams = [bench_camera(WIDTH, HEIGHT, eye) for eye in FILTER_EYES]
    f32 = dict(dtype=torch.float32, device=device)
    args = (torch.as_tensor(np.stack([c.world_view for c in cams]), **f32),
            torch.tensor([c.focal_x for c in cams], **f32),
            torch.tensor([c.focal_y for c in cams], **f32),
            torch.tensor([float(c.width) for c in cams], **f32),
            torch.tensor([float(c.height) for c in cams], **f32))
    centers = np.stack([c.campos for c in cams])
    extent = 1.1 * float(np.linalg.norm(centers - centers.mean(0), axis=1).max())
    return args, extent


def time_ms(torch, fn, iters: int, flush, spin: bool = True) -> float:
    """Mean device time of `fn` over `iters` launches, each after an L2
    flush (the main path finds these inputs cold). With `spin` (the kernels
    line's method) the card then spins for ~1 ms before the start event, so
    that the host has queued `fn` before the card reaches it and the events
    time the card's work alone; without it, a wrapper's host work between
    the start event and its launch is timed too wherever it outlasts the
    flush (see `host_us`)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush()
        if spin:
            torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def host_us(torch, fn, calls: int = 100) -> float:
    """Host microseconds per call of `fn` (a wrapper's checks, allocations
    and launches), with the card held busy by a ~0.1 s spin so that no call
    waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def bound(nbytes: float, ops: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def recorder(seen, module, attr, key):
    """Wrap module.attr so that its last call's arguments land in seen[key];
    returns the function that restores it."""
    orig = getattr(module, attr)

    def rec(*args, **kwargs):
        seen[key] = (args, kwargs)
        return orig(*args, **kwargs)
    # a kernel wrapper counts its launches on the module-level name, which
    # now resolves to this stand-in
    rec.launches = getattr(orig, "launches", 0)
    setattr(module, attr, rec)
    return lambda: setattr(module, attr, orig)


def profile_window(torch, fn, out_path):
    """Profile one call of fn: (wall ms, device busy ms, top device items,
    stages). Device-side events only (kernels, copies); the record_function
    spans "ed3dgs.*" appear on the device as their extent and are reported
    by stage: kernel time inside / device extent / host ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_host = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t_host) * 1e6
    averages = prof.key_averages()
    items = sorted(((e.key, e.self_device_time_total, e.count) for e in averages
                    if e.device_type == DeviceType.CUDA and not e.key.startswith("ed3dgs.")
                    and e.self_device_time_total > 0), key=lambda x: -x[1])
    busy_us = sum(x[1] for x in items)
    with open(out_path, "w") as f:
        f.write(averages.table(sort_by="self_device_time_total", row_limit=60))
    stages = {}
    for e in averages:
        if e.key.startswith("ed3dgs."):
            st = stages.setdefault(e.key[len("ed3dgs."):], {})
            if e.device_type == DeviceType.CUDA:
                st["extent_ms"] = e.self_device_time_total / 1e3
            else:
                st.update(kernel_ms=e.device_time_total / 1e3, host_ms=e.cpu_time_total / 1e3)
    return wall_us / 1e3, busy_us / 1e3, items, stages


def print_profile(what, wall_ms, busy_ms, items, stages):
    idle = f"{1 - busy_ms / wall_ms:.3f}" if busy_ms else "not measured (no device time traced)"
    print(f"profiled {what}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle share {idle}); top device time:", flush=True)
    for name, us, n in items[:12]:
        print(f"  {us / 1e3:8.3f} ms  x{n:<4d} {name[:90]}")
    print("  by stage (kernel / device extent / host ms): " + ", ".join(
        f"{k} {v.get('kernel_ms', 0):.3f}/{v.get('extent_ms', 0):.3f}/{v.get('host_ms', 0):.3f}"
        for k, v in stages.items()), flush=True)
    return dict(wall_ms=wall_ms, device_busy_ms=busy_ms, stages=stages,
                top=[(k, us / 1e3, n) for k, us, n in items[:25]])


def train_setup(cfg, rcfg):
    """The nersemble config's TrainSetup, as the JAX package's tools/train.py
    builds it (the tongue terms are off in the config; COLMAP supervision
    is not ported yet)."""
    from ed3dgs_torch.train.trainer import TrainSetup
    model, hidden, opt = cfg.model, cfg.hidden, cfg.opt
    return TrainSetup(
        raster=rcfg, hidden=hidden, batch_size=opt.batch_size,
        white_background=model.white_background, kernel_size=model.kernel_size,
        disable_filter3d=model.disable_filter3D, use_coord_map=model.use_coord_map,
        lambda_dssim=opt.lambda_dssim, opacity_l1_coef=opt.opacity_l1_coef_fine,
        reg_coef=opt.reg_coef, coef_tv_temporal=opt.coef_tv_temporal_embedding,
        lambda_depth_normal=opt.lambda_depth_normal,
        radegs_from_iter=opt.radegs_regularization_from_iter,
        num_down_emb=hidden.min_embeddings, sh_degree=model.sh_degree)


def make_batch(torch, cam, B, t, use_ssim, seed, device):
    """A batch of B views of `cam` at time t, with a numpy-seeded target."""
    rng = np.random.default_rng(seed)
    rep = lambda a: torch.as_tensor(np.repeat(np.asarray(a, np.float32)[None], B, 0),  # noqa: E731
                                    device=device)
    return {"gt_image": torch.as_tensor(
                rng.uniform(0, 1, (B, 3, cam.height, cam.width)).astype(np.float32),
                device=device),
            "viewmatrix": rep(cam.world_view), "projmatrix": rep(cam.full_proj),
            "campos": rep(cam.campos),
            "time": torch.full((B,), t, dtype=torch.float32, device=device),
            "cam_no": torch.zeros((B,), dtype=torch.int64, device=device),
            "use_ssim": use_ssim}


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "smoke_out"),
                    help="directory for chip_smoke.json, the profiles and ptxas.txt")
    out_dir = ap.parse_args().out

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    if not os.path.isdir(os.path.join(REPO, "ed3dgs_torch", "csrc")):
        fail(f"no ed3dgs_torch package beside {__file__}: run it from a checkout")
    sys.path.insert(0, REPO)
    os.makedirs(out_dir, exist_ok=True)

    from ed3dgs_torch.config.loader import load_full_config
    from ed3dgs_torch.convert import gaussians_from_numpy
    from ed3dgs_torch.models.deformation import deform_forward, init_deform_params
    from ed3dgs_torch.models.gaussians import compute_3d_filter, create_from_points, get_features
    from ed3dgs_torch.ops import (binning, binning_scan, cuda_lib, knn_loss, rasterize,
                                  rasterize_cuda, relayout, segment_sum)
    from ed3dgs_torch.render import raster_config_from_camera, render, settings_from_camera
    from ed3dgs_torch.train.trainer import (KNN_CAPS_DEFAULT, KNN_K, _cache_inputs,
                                            _prepare_cache, init_train_state,
                                            make_densify_step, make_loss_and_grads,
                                            make_train_step, refresh_knn_cache,
                                            update_knn_cache)
    from ed3dgs_torch.train.densify import densify
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    result = {"card": card, "kind": torch.cuda.get_device_name(0)}
    t_start = time.perf_counter()

    # ---- build ---------------------------------------------------------
    t0 = time.perf_counter()
    reports = cuda_lib.build()
    result["build_s"] = time.perf_counter() - t0
    print(f"build: {result['build_s']:.1f} s for {sorted(reports) or 'cached'}", flush=True)
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
        for name, text in reports.items():
            f.write(f"--- {name}\n{text}\n")
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

    # ---- the model: nersemble width, bench cloud -------------------------
    cfg = load_full_config(os.path.join(REPO, "configs", "nersemble", "default.py"))
    model, hidden, opt = cfg.model, cfg.hidden, cfg.opt
    fields = bench_cloud(N_GAUSS)
    params, aux = gaussians_from_numpy(fields, capacity=CAPACITY, device=DEVICE)
    dparams = init_deform_params(hidden, seed=0, device=DEVICE)
    cam = bench_camera(WIDTH, HEIGHT)
    rcfg = raster_config_from_camera(cam, pair_capacity=PAIR_CAPACITY, chunk=opt.raster_chunk)
    bg = torch.full((3,), 1.0 if model.white_background else 0.0, device=DEVICE)
    render_kw = dict(iteration=10 ** 9, sh_degree=model.sh_degree,
                     kernel_size=model.kernel_size, disable_filter3d=model.disable_filter3D,
                     num_down_emb_c=hidden.min_embeddings,
                     num_down_emb_f=hidden.min_embeddings)
    print(f"model: net_width={hidden.net_width} defor_depth={hidden.defor_depth} "
          f"temporal={hidden.temporal_embedding_dim} gaussian_emb={hidden.gaussian_embedding_dim} "
          f"max_embeddings={hidden.max_embeddings} bf16={hidden.bf16_activations} "
          f"sh={model.sh_degree} filter3D={not model.disable_filter3D} "
          f"chunk={rcfg.chunk} N={N_GAUSS} cap={CAPACITY} {WIDTH}x{HEIGHT}", flush=True)

    def frame(t, **kw):
        return render(params, aux, dparams, hidden,
                      settings_from_camera(cam, time=t, device=DEVICE), rcfg, bg,
                      **render_kw, **kw)

    # ---- 1. warm-up frame, recording each kernel's inputs ----------------
    seen = {}
    restore = [recorder(seen, binning, "fused_bin_scans", "K4"),
               recorder(seen, rasterize, "rasterize_forward", "K1"),
               recorder(seen, relayout, "unpack_image", "K5a")]
    try:
        warm = frame(FRAME_TIMES[0])
        torch.cuda.synchronize()
    finally:
        for r in restore:
            r()
    if set(seen) != {"K1", "K4", "K5a"}:
        fail(f"the warm-up frame did not reach every forward kernel: {sorted(seen)}")

    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=DEVICE)
    flush = flush_buf.zero_
    rows = {}

    (dv, dpk, total), kw4 = seen["K4"]
    key = binning_scan.fused_bin_scans(dv, dpk, total, **kw4)
    key_plain = binning_scan.fused_bin_scans_plain(dv, dpk, total, **kw4)
    err4 = int((key.to(torch.int64) - key_plain.to(torch.int64)).abs().max())
    print(f"K4 fused_bin_scans: K={dv.shape[0]} total={int(total)} "
          f"max_abs_err={err4} (must be 0)", flush=True)
    if err4 != 0:
        fail("K4 disagrees with its plain version")
    ms4 = time_ms(torch, lambda: binning_scan.fused_bin_scans(dv, dpk, total, **kw4), 50, flush)
    plain4 = time_ms(torch, lambda: binning_scan.fused_bin_scans_plain(dv, dpk, total, **kw4),
                     20, flush)
    K = dv.shape[0]
    b4, by4 = bound(4 * (3 * K + 1), 25 * K)
    rows["K4"] = dict(KERNELS["K4"], max_abs_err=err4, ms=ms4, plain_ms=plain4,
                      bound_ms=b4, bound_by=by4, library_ms=None)

    (pair_payload, tile_start, tile_count), kw1 = seen["K1"]
    gx, gy, chunk = kw1["grid_x"], kw1["grid_y"], kw1["chunk"]
    packed = rasterize_cuda.rasterize_forward(pair_payload, tile_start, tile_count, **kw1)
    stats = {}
    packed_plain = rasterize_cuda.rasterize_forward_plain(
        pair_payload, tile_start, tile_count, stats=stats, **kw1)
    a = packed[:, :gx, :rasterize_cuda.OUT_DIM].permute(2, 0, 1, 3).reshape(
        rasterize_cuda.OUT_DIM, -1)
    b = packed_plain[:, :gx, :rasterize_cuda.OUT_DIM].permute(2, 0, 1, 3).reshape(
        rasterize_cuda.OUT_DIM, -1)
    if not bool(torch.isfinite(a).all()):
        fail("K1 wrote non-finite values")
    diff = (a - b).abs()
    off = diff > K1_ATOL + K1_RTOL * b.abs()
    flipped = off.float().mean(1)
    err1 = float(diff.max())
    names = [n for n, s in rasterize_cuda.OUT_CHANNELS.items() for _ in range(s.start, s.stop)]
    median_ch = [ch for ch, n in enumerate(names) if n in ("mcoord", "mdepth")]
    for ch in range(rasterize_cuda.OUT_DIM):
        print(f"  K1 ch{ch:2d} {names[ch]:10s} max|diff|={float(diff[ch].max()):.3e} "
              f"outside tol: {float(flipped[ch]):.2e}")
    worst_median = float(flipped[median_ch].max())
    off_other = int(sum(int(off[ch].sum()) for ch in range(rasterize_cuda.OUT_DIM)
                        if ch not in median_ch))
    print(f"K1 forward_blend: tiles={gx * gy} pairs={int(tile_count.sum())} chunk={chunk} "
          f"max_abs_err={err1:.3e}; outside {K1_ATOL}+{K1_RTOL}*|v|: {off_other} values "
          f"of the non-median channels (must be 0), worst median-channel fraction "
          f"{worst_median:.2e} (limit {K1_MAX_FLIPPED})", flush=True)
    if off_other or worst_median > K1_MAX_FLIPPED:
        fail("K1 disagrees with its plain version")
    ms1 = time_ms(torch, lambda: rasterize_cuda.rasterize_forward(
        pair_payload, tile_start, tile_count, **kw1), 30, flush)
    plain1 = time_ms(torch, lambda: rasterize_cuda.rasterize_forward_plain(
        pair_payload, tile_start, tile_count, **kw1), 3, flush)
    rows_read = int(torch.clamp_max(tile_count, chunk * rasterize_cuda.MAX_CHUNKS).sum())
    bytes1 = (rows_read * pair_payload.shape[1] * 4 + 2 * 4 * gx * gy
              + gx * gy * rasterize_cuda.OUT_PAD * 256 * 4)
    ops1 = K1_OPS_PER_EVAL * stats["evals"] + K1_OPS_PER_INCLUDE * stats["includes"]
    b1, by1 = bound(bytes1, ops1)
    print(f"  K1 work: rows read {rows_read}, pair-pixel evaluations {stats['evals']}, "
          f"blended {stats['includes']}; {bytes1 / 1e6:.1f} MB, {ops1 / 1e9:.2f} GFLOP")
    info1 = rasterize_cuda.kernel_info("rasterize_forward", chunk)
    print(f"  K1 {ms1:.4f} ms; {info1}", flush=True)
    rows["K1"] = dict(KERNELS["K1"], max_abs_err=err1, ms=ms1, plain_ms=plain1,
                      bound_ms=b1, bound_by=by1, library_ms=None, **info1)
    result["K1_flipped_fraction"] = {names[c]: float(flipped[c]) for c in range(len(names))}
    result["K1_work"] = dict(rows_read=rows_read, bytes=bytes1, ops=ops1, **stats)
    del packed, packed_plain, a, b, diff, off

    (packed5,), _ = seen["K5a"]
    img = relayout.unpack_image(packed5)
    img_plain = relayout.unpack_image_plain(packed5)
    same = torch.equal(img.view(torch.int32), img_plain.view(torch.int32))
    print(f"K5a unpack_image: {tuple(packed5.shape)} -> {tuple(img.shape)} bit-exact={same}",
          flush=True)
    if not same:
        fail("K5a disagrees with its plain version")
    gy5, gxp5, C5, _ = packed5.shape

    def library5():
        return (packed5.reshape(gy5, gxp5, C5, 16, 16).permute(2, 0, 3, 1, 4)
                .reshape(C5, gy5 * 16, gxp5 * 16).contiguous())
    ms5 = time_ms(torch, lambda: relayout.unpack_image(packed5), 50, flush)
    plain5 = time_ms(torch, lambda: relayout.unpack_image_plain(packed5), 50, flush)
    lib5 = time_ms(torch, library5, 50, flush)
    b5, by5 = bound(2 * packed5.numel() * 4, 0)
    rows["K5a"] = dict(KERNELS["K5a"], max_abs_err=0.0, ms=ms5, plain_ms=plain5,
                       bound_ms=b5, bound_by=by5, library_ms=lib5)
    del seen, img, img_plain, warm

    # ---- 2. the forward main path: three frames ------------------------------
    for t in FRAME_TIMES:       # warm-up at the frames' own times
        frame(t)
    torch.cuda.synchronize()
    counters = {"K1": rasterize_cuda.rasterize_forward, "K4": binning_scan.fused_bin_scans,
                "K5a": relayout.unpack_image}
    for fn in counters.values():
        fn.launches = 0
    outs, events = [], []
    t_host = time.perf_counter()
    for t in FRAME_TIMES:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs.append(frame(t))
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t_host) * 1e3 / len(FRAME_TIMES)
    launches = {k: fn.launches for k, fn in counters.items()}
    frame_ms = [s.elapsed_time(e) for s, e in events]
    print(f"render path: {len(FRAME_TIMES)} frames at t={list(FRAME_TIMES)}: "
          f"launches {launches}", flush=True)
    print("  frame ms (CUDA events): " + ", ".join(f"{x:.3f}" for x in frame_ms)
          + f"; host wall {host_ms:.3f} ms/frame", flush=True)
    for k, n in launches.items():
        if n != len(FRAME_TIMES):
            fail(f"{k} launched {n} times in {len(FRAME_TIMES)} frames")
    image_keys = ("render", "mask", "expected_coord", "median_coord", "expected_depth",
                  "median_depth", "normal", "tongue_mask")
    for t, out in zip(FRAME_TIMES, outs):
        for k in image_keys:
            shape = (3 if k in ("render", "expected_coord", "median_coord", "normal") else 1,
                     HEIGHT, WIDTH)
            if tuple(out[k].shape) != shape or not bool(torch.isfinite(out[k]).all()):
                fail(f"frame t={t}: {k} has shape {tuple(out[k].shape)} or non-finite values")
        npairs = int(out["num_pairs"])
        if bool(out["tile_overflow"]) or not 0 < npairs <= PAIR_CAPACITY:
            fail(f"frame t={t}: tile_overflow={bool(out['tile_overflow'])} num_pairs={npairs}")
        print(f"  t={t}: num_pairs={npairs} visible={int(out['visibility_filter'].sum())} "
              f"mask mean={float(out['mask'].mean()):.4f} "
              f"render mean={float(out['render'].mean()):.4f}", flush=True)
    result.update(frame_ms=frame_ms, host_ms_per_frame=host_ms, render_launches=launches,
                  num_pairs=[int(o["num_pairs"]) for o in outs])
    del outs
    prof_frame = profile_window(torch, lambda: frame(FRAME_TIMES[1]),
                                os.path.join(out_dir, "profile_frame.txt"))
    result["profile"] = print_profile("frame", *prof_frame)
    # K4's kernels in the profiled frame (one call): its single pass, or the
    # reduce, scan and decode of the three-launch design
    k4_kernels = sum(n for name, _, n in prof_frame[2]
                     if any(k in name for k in ("scan_decode", "block_sums")))
    memsets = sum(n for name, _, n in prof_frame[2] if "memset" in name.lower())
    print(f"  K4 kernels per call (profiled frame): {k4_kernels}; memsets in the frame "
          f"{memsets}", flush=True)
    rows["K4"]["kernels_per_call"] = k4_kernels

    # ---- 3. the training loop at the config's reg_coef -----------------------
    setup = train_setup(cfg, rcfg)
    B = setup.batch_size
    fargs, extent = filter_cameras(torch, DEVICE)

    def refresh_filter(p, a):
        return a._replace(filter_3d=compute_3d_filter(p.xyz, a.alive, *fargs))

    knn_caps = dict(KNN_CAPS_DEFAULT)

    def refresh_knn(p, a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = refresh_knn_cache(p, a, knn_caps, coverage_target=opt.knn_coverage_target)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        g = cache.graph
        edges = int(a.alive.sum()) * KNN_K
        coverage = 1.0 - int(g.overflow.sum()) / edges
        caps = {k: v for k, v in knn_caps.items() if not k.startswith("_")}
        print(f"  refresh_knn_cache: {wall_ms:.1f} ms wall, buckets {caps}, overflow "
              f"{g.overflow.tolist()}, n_far {int(g.n_far)}, coverage measure "
              f"1 - sum(overflow)/(alive*K) = {coverage:.5f} (target "
              f"{opt.knn_coverage_target})", flush=True)
        if coverage < opt.knn_coverage_target:
            fail("the KNN graph misses its coverage target")
        return cache, dict(wall_ms=wall_ms, caps=caps, overflow=g.overflow.tolist(),
                           n_far=int(g.n_far), coverage=coverage)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    aux = refresh_filter(params, aux)
    torch.cuda.synchronize()
    filter_ms = (time.perf_counter() - t0) * 1e3
    f3d = aux.filter_3d[aux.alive]
    print(f"train loop: compute_3d_filter over {len(FILTER_EYES)} cameras {filter_ms:.1f} ms "
          f"wall, filter {float(f3d.min()):.3e}..{float(f3d.max()):.3e}", flush=True)
    if not bool(torch.isfinite(aux.filter_3d).all()) or float(f3d.min()) <= 0:
        fail("compute_3d_filter gave non-finite or non-positive scales")
    knn_cache, knn_info = refresh_knn(params, aux)
    # the refresh's two halves, each ending in a synchronise: the neighbour
    # search (knn_op, inside _cache_inputs) and the graph preparation at the
    # buckets the refresh settled on
    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3
    inputs, search_ms = wall(lambda: _cache_inputs(params, aux, False, KNN_K))
    _, prepare_ms = wall(lambda: _prepare_cache(inputs, knn_caps["spill_a"],
                                                knn_caps["spill_b"], knn_caps["far"]))
    print(f"  refresh split: neighbour search (_cache_inputs) {search_ms:.1f} ms, graph "
          f"preparation (_prepare_cache) {prepare_ms:.1f} ms wall, beside "
          f"refresh_knn_cache's {knn_info['wall_ms']:.1f} ms", flush=True)
    result["knn_refresh"] = dict(knn_info, filter_ms=filter_ms, search_ms=search_ms,
                                 prepare_ms=prepare_ms)
    del inputs

    state, optimizer = init_train_state(params, hidden, opt, extent, seed=0)
    state = state._replace(iteration=TRAIN_ITERATION)
    step = make_train_step(setup, optimizer)
    batches = [make_batch(torch, cam, B, 0.1 + 0.2 * i, i in SSIM_STEPS, 100 + i, DEVICE)
               for i in range(TRAIN_STEPS)]
    print(f"train path: batch {B}, iteration {TRAIN_ITERATION}, reg_coef {setup.reg_coef}, "
          f"lambda_dssim {setup.lambda_dssim} (SSIM on steps {list(SSIM_STEPS)}), "
          f"opacity_l1 {setup.opacity_l1_coef}, depth-normal {setup.lambda_depth_normal} "
          f"from {setup.radegs_from_iter}", flush=True)
    seen = {}
    restore = [recorder(seen, rasterize, "rasterize_backward", "K2"),
               recorder(seen, rasterize, "segment_sum_rows_gathered", "K3"),
               recorder(seen, relayout, "pack_image", "K5b"),
               recorder(seen, rasterize, "sorted_payload_grad", "grad"),
               recorder(seen, knn_loss, "knn_rows", "K6"),
               recorder(seen, knn_loss, "knn_reverse", "K7")]
    try:
        state, taux, metrics = step(state, aux, make_batch(torch, cam, B, 0.05, True, 99,
                                                           DEVICE), knn_cache)
        torch.cuda.synchronize()
    finally:
        for r in restore:
            r()
    if set(seen) != {"K2", "K3", "K5b", "grad", "K6", "K7"}:
        fail(f"the warm-up step did not reach every gradient kernel: {sorted(seen)}")
    counters = {"K1": rasterize_cuda.rasterize_forward, "K2": rasterize_cuda.rasterize_backward,
                "K3": segment_sum.segment_sum_rows, "K4": binning_scan.fused_bin_scans,
                "K5a": relayout.unpack_image, "K5b": relayout.pack_image,
                "K6": knn_loss.knn_rows, "K7": knn_loss.knn_reverse,
                "K8": segment_sum.segment_sum_rows_packed}
    # launches per step: one per camera of the blend path, one KNN loss
    # (the tongue graph is off), none of K8 (no production caller)
    per_step = {k: (B if k in ("K1", "K2", "K3", "K4", "K5a", "K5b") else
                    1 if k in ("K6", "K7") else 0) for k in counters}

    def run_steps(state, taux, batches, what):
        """The steps of `batches` with every count set to 0 just before;
        fails unless each kernel rose by its per-step launches."""
        for fn in counters.values():
            fn.launches = 0
        out, events, enqueue_ms, mallocs = [], [], [], []
        t_host = time.perf_counter()
        for b in batches:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            n_malloc = torch.cuda.memory_stats().get("num_device_alloc", 0)
            t0 = time.perf_counter()
            start.record()
            state, taux, metrics = step(state, taux, b, knn_cache)
            end.record()
            enqueue_ms.append((time.perf_counter() - t0) * 1e3)
            mallocs.append(torch.cuda.memory_stats().get("num_device_alloc", 0) - n_malloc)
            events.append((start, end))
            out.append(metrics)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t_host) * 1e3 / len(batches)
        launches = {k: fn.launches for k, fn in counters.items()}
        print(f"train path, {what}: {len(batches)} steps: launches {launches}", flush=True)
        for k, n in launches.items():
            if n != per_step[k] * len(batches):
                fail(f"{k} launched {n} times in {len(batches)} steps of batch {B} ({what})")
        for i, m in enumerate(out):
            vals = {k: float(m[k]) for k in ("loss", "l1", "ssim", "psnr", "opacity_mean",
                                             "depth_normal", "emb_loss")}
            print(f"  step {i}: " + " ".join(f"{k}={v:.6f}" for k, v in vals.items())
                  + f" num_pairs={int(m['num_pairs'])}", flush=True)
            if not all(math.isfinite(v) for v in vals.values()) or bool(m["tile_overflow"]):
                fail(f"train step {i} ({what}): non-finite metrics or tile overflow")
            if vals["depth_normal"] <= 0 or vals["emb_loss"] <= 0:
                fail(f"train step {i} ({what}): the depth-normal or KNN term is not live")
        step_ms = [s.elapsed_time(e) for s, e in events]
        print("  train-step ms (CUDA events): " + ", ".join(f"{x:.3f}" for x in step_ms)
              + f"; host wall {host_ms:.3f} ms/step; host ms to return from each step "
              + ", ".join(f"{x:.3f}" for x in enqueue_ms)
              + f"; new device allocations (cudaMalloc) in each step {mallocs}", flush=True)
        return state, taux, out, step_ms, host_ms, launches

    state, taux, losses, step_ms, step_host_ms, train_launches = run_steps(
        state, taux, batches, "after the first refresh")
    for i, m in enumerate(losses):
        if (i in SSIM_STEPS) == (float(m["ssim"]) == 1.0):
            fail(f"train step {i}: the SSIM term is not live as configured")
    for name, t in list(state.params["gaussians"]._asdict().items()):
        if not bool(torch.isfinite(t).all()):
            fail(f"parameter {name} is not finite after the steps")
    if float(taux.denom.sum()) <= 0 or not bool(torch.isfinite(taux.xyz_grad_accum).all()):
        fail("the densification statistics did not accumulate")
    result.update(train_step_ms=step_ms, train_host_ms_per_step=step_host_ms,
                  train_launches=train_launches,
                  train_losses=[float(m["loss"]) for m in losses],
                  emb_losses=[float(m["emb_loss"]) for m in losses])
    del losses, batches
    pbatch = make_batch(torch, cam, B, 0.6, True, 200, DEVICE)

    def profiled_step():
        step(state, taux, pbatch, knn_cache)
    prof = profile_window(torch, profiled_step, os.path.join(out_dir, "profile_step.txt"))
    result["train_profile"] = print_profile("train step", *prof)
    # K6's and K7's device time inside the step (warm L2: the step has just
    # gathered the table they read), per launch
    knn_step_ms = {}
    for k, fn_name in (("K6", "knn_rows"), ("K7", "knn_reverse")):
        hits = [(us, n) for name, us, n in prof[2] if fn_name in name]
        knn_step_ms[k] = (sum(us for us, _ in hits) / 1e3 / max(1, sum(n for _, n in hits))
                          if hits else None)
    print(f"  K6/K7 device ms per launch inside the profiled step: {knn_step_ms}", flush=True)

    # the un-permute folded into K3 against the unfolded redesign (the
    # gather, then K3 on the gathered rows): the profiled step in turns, and
    # the device extent of its segment_sum stage (inverse permutation,
    # gather where unfolded, K3)
    def unfolded(src, idx, starts, ends):
        return segment_sum.segment_sum_rows(src[idx.long()], starts, ends)
    fold = {"folded": [], "unfolded": []}
    for what in ("folded", "unfolded", "folded", "unfolded"):
        if what == "unfolded":
            rasterize.segment_sum_rows_gathered = unfolded
        try:
            f_wall, f_busy, _, f_stages = profile_window(
                torch, profiled_step, os.path.join(out_dir, f"profile_step_{what}.txt"))
        finally:
            rasterize.segment_sum_rows_gathered = segment_sum.segment_sum_rows_gathered
        stage = f_stages.get("segment_sum", {})
        fold[what].append(dict(extent_ms=stage.get("extent_ms"), kernel_ms=stage.get("kernel_ms"),
                               device_busy_ms=f_busy, wall_ms=f_wall))
    print("  segment_sum stage, device extent / kernel ms / step device busy ms: " + "; ".join(
        f"{k} " + ", ".join(f"{x['extent_ms']}/{x['kernel_ms']}/{x['device_busy_ms']:.3f}"
                            for x in v) for k, v in fold.items()), flush=True)
    result["fold"] = fold

    # densify at the config's threshold (tools/train.py:556-567), then the
    # 3D filter and the KNN cache are rebuilt for the new cloud
    thr = (opt.densify_grad_threshold_fine_init
           - TRAIN_ITERATION * (opt.densify_grad_threshold_fine_init
                                - opt.densify_grad_threshold_after) / opt.densify_until_iter)
    densify_step = make_densify_step(opt, opt.percent_dense, extent)
    n_before = int(taux.alive.sum())
    mean_grad = (taux.xyz_grad_accum / taux.denom.clamp_min(1.0))[taux.alive & (taux.denom > 0)]
    q = torch.quantile(mean_grad, torch.tensor([0.5, 0.99, 0.999], device=mean_grad.device))
    q = q.tolist()
    print(f"densify statistics: mean screen-space gradient norm over {mean_grad.numel()} "
          f"seen Gaussians: median {q[0]:.3e}, 99th percentile {q[1]:.3e}, max "
          f"{float(mean_grad.max()):.3e}; {int((mean_grad >= thr).sum())} at or above the "
          f"config's threshold {thr}; {CAPACITY - n_before} free slots", flush=True)
    densified = []
    # the config's threshold; if that finds nothing hot (random targets give
    # small screen-space gradients), the 99.9th percentile of the same
    # statistics instead, so that the full-size step clones or splits
    state0, taux0 = state, taux
    for what, t in (("config", thr), ("99.9th percentile", q[2])):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        state, taux, n_c, n_s = densify_step(
            state0, taux0, torch.Generator(device=DEVICE).manual_seed(0), t)
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        n_after = int(taux.alive.sum())
        print(f"densify step at the {what} threshold {t:.3e} (percent_dense "
              f"{opt.percent_dense}, extent {extent:.4f}): n_cloned {int(n_c)}, n_split "
              f"{int(n_s)}, alive {n_before} -> {n_after} of {CAPACITY}; "
              f"{start.elapsed_time(end):.3f} ms (CUDA events), host wall {host_ms:.3f} ms",
              flush=True)
        if n_after != n_before + int(n_c) + int(n_s):
            fail("the densify step lost count of the Gaussians it added")
        densified.append(dict(threshold=t, n_cloned=int(n_c), n_split=int(n_s),
                              alive_before=n_before, alive_after=n_after,
                              ms=start.elapsed_time(end), host_ms=host_ms))
        if n_after > n_before:
            break
    if n_after == n_before:
        fail("no densify step cloned or split")
    del state0, taux0
    t0 = time.perf_counter()
    taux = refresh_filter(state.params["gaussians"], taux)
    torch.cuda.synchronize()
    filter2_ms = (time.perf_counter() - t0) * 1e3
    knn_cache, knn_info2 = refresh_knn(state.params["gaussians"], taux)
    more = [make_batch(torch, cam, B, 0.35 + 0.2 * i, False, 400 + i, DEVICE)
            for i in range(MORE_STEPS)]
    state, taux, losses2, step_ms2, host_ms2, launches2 = run_steps(
        state, taux, more, "after densify and the refreshes")
    result["densify"] = dict(steps=densified, extent=extent, filter_ms=filter2_ms,
                             knn_refresh=knn_info2, steps_after_ms=step_ms2,
                             steps_after_host_ms=host_ms2, launches_after=launches2)
    del losses2, more

    # ---- 4. the gradient kernels against their plain versions --------------
    # (the recorded inputs include the forward's saved output, which carries
    # its autograd history: compare without building a graph)
    torch.set_grad_enabled(False)
    (img_cot,), _ = seen["K5b"]
    pk = relayout.pack_image(img_cot)
    pk_plain = relayout.pack_image_plain(img_cot)
    same = torch.equal(pk.view(torch.int32), pk_plain.view(torch.int32))
    print(f"K5b pack_image: {tuple(img_cot.shape)} -> {tuple(pk.shape)} bit-exact={same}",
          flush=True)
    if not same:
        fail("K5b disagrees with its plain version")
    C6, H6, W6 = img_cot.shape

    def library5b():
        return (img_cot.reshape(C6, H6 // 16, 16, W6 // 16, 16).permute(1, 3, 0, 2, 4)
                .reshape(H6 // 16, W6 // 16, C6, 256).contiguous())
    ms5b = time_ms(torch, lambda: relayout.pack_image(img_cot), 50, flush)
    plain5b = time_ms(torch, lambda: relayout.pack_image_plain(img_cot), 50, flush)
    lib5b = time_ms(torch, library5b, 50, flush)
    b5b, by5b = bound(2 * img_cot.numel() * 4, 0)
    rows["K5b"] = dict(KERNELS["K5b"], max_abs_err=0.0, ms=ms5b, plain_ms=plain5b,
                       bound_ms=b5b, bound_by=by5b, library_ms=lib5b)
    del pk, pk_plain

    (pp2, ts2, tc2, packed2, cot2), kw2 = seen["K2"]
    chunk2 = kw2["chunk"]
    dpay, live = rasterize_cuda.rasterize_backward(pp2, ts2, tc2, packed2, cot2, **kw2)
    dpay_plain, live_plain = rasterize_cuda.rasterize_backward_plain(
        pp2, ts2, tc2, packed2, cot2, **kw2)
    total2 = int(tc2.sum())     # K2 writes every row of every tile
    got2, want2 = dpay[:total2], dpay_plain[:total2]
    col_max = want2.abs().amax(dim=0)
    col_err = (got2 - want2).abs().amax(dim=0)
    live_same = torch.equal(live, live_plain)
    err2 = float(col_err.max())
    worst2 = float((col_err / torch.clamp_min(col_max, 1e-30)).max())
    print(f"K2 backward_blend: tiles={ts2.numel()} pair rows={total2} live_chunks equal={live_same} max_abs_err={err2:.3e} "
          f"worst column error / column max {worst2:.3e} (limit {K2_REL})", flush=True)
    if not live_same or not bool(torch.isfinite(got2).all()) or not bool(
            (col_err <= K2_REL * col_max).all()):
        fail("K2 disagrees with its plain version")
    ms2 = time_ms(torch, lambda: rasterize_cuda.rasterize_backward(
        pp2, ts2, tc2, packed2, cot2, **kw2), 20, flush)
    plain2 = time_ms(torch, lambda: rasterize_cuda.rasterize_backward_plain(
        pp2, ts2, tc2, packed2, cot2, **kw2), 2, flush)
    stats2 = {}
    rasterize_cuda.rasterize_forward_plain(pp2, ts2, tc2, stats=stats2, **kw2)
    # the live rows read, the gradient rows written, the channels read, the
    # tile bounds read and the live-chunk counts written
    rows_live = int(torch.minimum(torch.clamp_max(tc2, chunk2 * rasterize_cuda.MAX_CHUNKS),
                                  live * chunk2).sum())
    ntiles2 = ts2.numel()
    bytes2 = ((rows_live + total2) * pp2.shape[1] * 4 + K2_CHANNELS_READ * ntiles2 * 256 * 4
              + 2 * 4 * ntiles2 + 4 * ntiles2)
    ops2 = K2_OPS_PER_EVAL * stats2["evals"] + K2_OPS_PER_INCLUDE * stats2["includes"]
    b2, by2 = bound(bytes2, ops2)
    print(f"  K2 work: live rows {rows_live}, pair-pixel evaluations {stats2['evals']}, "
          f"blended {stats2['includes']}; {bytes2 / 1e6:.1f} MB, {ops2 / 1e9:.2f} GFLOP",
          flush=True)
    info2 = rasterize_cuda.kernel_info("rasterize_backward", chunk2)
    print(f"  K2 {ms2:.4f} ms; {info2}", flush=True)
    rows["K2"] = dict(KERNELS["K2"], max_abs_err=err2, ms=ms2, plain_ms=plain2,
                      bound_ms=b2, bound_by=by2, library_ms=None, **info2)
    result["K2_work"] = dict(rows_live=rows_live, rows=total2, bytes=bytes2, ops=ops2, **stats2)
    del dpay, dpay_plain, got2, want2

    # K3 as the main path calls it: the pair-gradient rows read through the
    # inverse of the pair permutation (the un-permute folded into the sum)
    (src3, idx3, st3, en3), _ = seen["K3"]
    out3 = segment_sum.segment_sum_rows_gathered(src3, idx3, st3, en3)
    out3_plain = segment_sum.segment_sum_rows_gathered_plain(src3, idx3, st3, en3)
    err3 = float((out3 - out3_plain).abs().max())
    scale3 = float(out3_plain.abs().max())
    print(f"K3 segment_sum_rows_gathered: rows {tuple(src3.shape)} through idx "
          f"{tuple(idx3.shape)}, segments {st3.numel()} max_abs_err={err3:.3e} "
          f"(limit {K3_REL} x {scale3:.3e})", flush=True)
    if not err3 <= K3_REL * scale3 or not bool(torch.isfinite(out3).all()):
        fail("K3 (gathered) disagrees with its plain version")
    # and K3's own function on the gathered rows, as the unfolded path ran it
    rows3 = src3[idx3.long()]
    out3r = segment_sum.segment_sum_rows(rows3, st3, en3)
    err3r = float((out3r - out3_plain).abs().max())
    print(f"K3 segment_sum_rows: rows {tuple(rows3.shape)} max_abs_err={err3r:.3e} "
          f"(limit {K3_REL} x {scale3:.3e})", flush=True)
    if not err3r <= K3_REL * scale3 or not bool(torch.isfinite(out3r).all()):
        fail("K3 disagrees with its plain version")
    ms3 = time_ms(torch, lambda: segment_sum.segment_sum_rows_gathered(src3, idx3, st3, en3),
                  50, flush)
    plain3 = time_ms(torch, lambda: segment_sum.segment_sum_rows_gathered_plain(
        src3, idx3, st3, en3), 20, flush)
    ms3r = time_ms(torch, lambda: segment_sum.segment_sum_rows(rows3, st3, en3), 50, flush)
    plain3r = time_ms(torch, lambda: segment_sum.segment_sum_rows_plain(rows3, st3, en3),
                      20, flush)
    unfolded3 = time_ms(torch, lambda: segment_sum.segment_sum_rows(src3[idx3.long()], st3,
                                                                     en3), 50, flush)
    summed = int((en3 - st3).sum())
    # the library yardstick: one segment_reduce over the same contiguous
    # segments of the gathered rows (the binning's CSR bounds tile the rows
    # from 0 without gaps)
    contiguous = bool((st3[1:] == en3[:-1]).all()) and int(st3[0]) == 0
    lib3 = None
    if contiguous:
        lengths3 = (en3 - st3).long()
        data3 = rows3[:summed]
        lib_out = torch.segment_reduce(data3, "sum", lengths=lengths3, axis=0)
        print(f"  K3 library segment_reduce max|diff| {float((lib_out - out3).abs().max()):.3e}",
              flush=True)
        lib3 = time_ms(torch, lambda: torch.segment_reduce(data3, "sum", lengths=lengths3,
                                                            axis=0), 50, flush)
    F3 = src3.shape[1]
    out_bytes3 = 2 * 4 * st3.numel() + out3.numel() * 4
    b3r, by3r = bound(summed * F3 * 4 + out_bytes3, summed * F3)
    # the gathered call reads the index of every summed row and the whole
    # 32-byte sectors its rows cover in src
    used = idx3[int(st3[0]):int(en3[-1])].long()
    first_sec = used * (F3 * 4) // 32
    last_sec = (used * (F3 * 4) + F3 * 4 - 1) // 32
    covered = torch.zeros(int(last_sec.max()) + 1, dtype=torch.bool, device=src3.device)
    for k in range(int((last_sec - first_sec).max()) + 1):   # a sector counts once
        sec = first_sec + k
        covered[sec[sec <= last_sec]] = True
    n_sec = int(covered.sum())
    del used, first_sec, last_sec, covered
    b3, by3 = bound(summed * 4 + n_sec * 32 + out_bytes3, summed * F3)
    print(f"  K3 gathered {ms3:.5f} ms (bound {b3:.5f}, {n_sec} sectors), K3 on the rows "
          f"{ms3r:.5f} ms (bound {b3r:.5f}), gather + K3 {unfolded3:.5f} ms; plain "
          f"{plain3:.4f} / {plain3r:.4f} ms; segment_reduce {lib3}", flush=True)
    rows["K3"] = dict(KERNELS["K3"], max_abs_err=err3, ms=ms3, plain_ms=plain3,
                      bound_ms=b3, bound_by=by3, library_ms=lib3, rows_ms=ms3r,
                      rows_plain_ms=plain3r, rows_bound_ms=b3r, rows_max_abs_err=err3r,
                      gather_then_rows_ms=unfolded3)
    result["K3_work"] = dict(rows=summed, sectors=n_sec, segments=st3.numel())

    # K8 is the K3 kernel under its own counter, on K3's own function: the
    # same inputs, the same bound and the same library yardstick
    out8 = segment_sum.segment_sum_rows_packed(rows3, st3, en3)
    err8 = float((out8 - out3_plain).abs().max())
    print(f"K8 segment_sum_rows_packed (the K3 kernel): max_abs_err={err8:.3e} "
          f"(limit {K3_REL} x {scale3:.3e})", flush=True)
    if not err8 <= K3_REL * scale3:
        fail("K8 disagrees with its plain version")
    ms8 = time_ms(torch, lambda: segment_sum.segment_sum_rows_packed(rows3, st3, en3), 50,
                  flush)
    rows["K8"] = dict(KERNELS["K8"], max_abs_err=err8, ms=ms8, plain_ms=plain3r,
                      bound_ms=b3r, bound_by=by3r, library_ms=lib3)
    del out3, out3_plain, out3r, out8, rows3

    # K6 -> K7 on the graph and embedding table the warm-up step handed them
    (emb_r, nbr, w_eff, coef), _ = seen["K6"]
    (_, _, _, rev_ptr, rev_pair), _ = seen["K7"]
    Cp, E = emb_r.shape
    K = nbr.shape[1]

    def knn_chain(rows_fn, reverse_fn):
        loss, de, s = rows_fn(emb_r, nbr, w_eff, coef)
        return loss, de, s, reverse_fn(emb_r, s, de, rev_ptr, rev_pair)
    loss6, de6, s6, out7 = knn_chain(knn_loss.knn_rows, knn_loss.knn_reverse)
    again = knn_chain(knn_loss.knn_rows, knn_loss.knn_reverse)
    det_knn = torch.equal(loss6, again[0]) and torch.equal(out7, again[3])
    loss_p, de_p, s_p, out_p = knn_chain(knn_loss.knn_rows_plain, knn_loss.knn_reverse_plain)
    loss_err = abs(float(loss6) - float(loss_p))
    row_max = out_p.abs().amax(dim=1)
    row_err = (out7 - out_p).abs().amax(dim=1)
    worst_row = float((row_err / torch.clamp_min(row_max, 1e-30)).max())
    err6 = float((de6 - de_p).abs().max())
    err7 = float((out7 - knn_loss.knn_reverse_plain(emb_r, s6, de6, rev_ptr, rev_pair))
                 .abs().max())
    n_rev = rev_pair.shape[0]
    loss_rel = loss_err / abs(float(loss_p))
    indeg = (rev_ptr[1:] - rev_ptr[:-1]).float()
    print(f"  K7 in-degree over {Cp} ranks: max {int(indeg.max())}, p99 "
          f"{float(torch.quantile(indeg, 0.99)):.0f}, mean {float(indeg.mean()):.3f}",
          flush=True)
    print(f"K6 knn_rows + K7 knn_reverse: Cp={Cp} K={K} E={E} in-edges {n_rev}; loss "
          f"{float(loss6):.8f} vs plain {float(loss_p):.8f} (rel {loss_rel:.2e}, "
          f"limit {KNN_LOSS_REL}); worst row of dL/demb / its largest value {worst_row:.2e} "
          f"(limit {KNN_ROW_REL}); K6 de max_abs_err {err6:.3e}, K7 max_abs_err {err7:.3e} "
          f"on K6's output; two runs bit-identical={det_knn}", flush=True)
    if (loss_err > KNN_LOSS_REL * abs(float(loss_p)) or not bool(torch.isfinite(out7).all())
            or not bool((row_err <= KNN_ROW_REL * row_max).all())):
        fail("K6/K7 disagree with their plain versions")
    if not det_knn:
        fail("the KNN loss or its gradient differs from run to run")
    ms6 = time_ms(torch, lambda: knn_loss.knn_rows(emb_r, nbr, w_eff, coef), 50, flush)
    plain6 = time_ms(torch, lambda: knn_loss.knn_rows_plain(emb_r, nbr, w_eff, coef), 10, flush)
    ms7 = time_ms(torch, lambda: knn_loss.knn_reverse(emb_r, s6, de6, rev_ptr, rev_pair), 50,
                  flush)
    plain7 = time_ms(torch, lambda: knn_loss.knn_reverse_plain(emb_r, s6, de6, rev_ptr,
                                                                rev_pair), 10, flush)
    # K6 reads the table, the ranks, weights and coef once and writes de, s
    # and the partials; per edge: difference, square and sum over E, the
    # weight, sqrt, the loss term, s, and s * diff summed over E.
    # K7 reads the table, the in-edges' s and pair ids, the bounds and de,
    # and writes the gradient; per in-edge: difference, product, sum over E.
    bytes6 = 4 * (2 * Cp * E + 3 * Cp * K + Cp + -(-Cp // knn_loss.ROWS_PER_BLOCK))
    b6, by6 = bound(bytes6, Cp * K * (5 * E + 8))
    bytes7 = 4 * (3 * Cp * E + 2 * n_rev + Cp + 1)
    b7, by7 = bound(bytes7, n_rev * 3 * E + Cp * E)
    print(f"  K6 work: {bytes6 / 1e6:.1f} MB, {Cp * K * (5 * E + 8) / 1e9:.3f} GFLOP; "
          f"K7 work: {bytes7 / 1e6:.1f} MB, {(n_rev * 3 * E + Cp * E) / 1e9:.3f} GFLOP",
          flush=True)
    info6, info7 = knn_loss.kernel_info("knn_rows", K), knn_loss.kernel_info("knn_reverse", K)
    host6 = host_us(torch, lambda: knn_loss.knn_rows(emb_r, nbr, w_eff, coef))
    host7 = host_us(torch, lambda: knn_loss.knn_reverse(emb_r, s6, de6, rev_ptr, rev_pair))
    print(f"  K6 {ms6:.4f} ms cold, {knn_step_ms['K6']} ms in the step, {host6:.1f} us of "
          f"host a call; {info6}\n"
          f"  K7 {ms7:.4f} ms cold, {knn_step_ms['K7']} ms in the step, {host7:.1f} us of "
          f"host a call; {info7}", flush=True)
    rows["K6"] = dict(KERNELS["K6"], max_abs_err=err6, ms=ms6, plain_ms=plain6,
                      bound_ms=b6, bound_by=by6, library_ms=None, step_ms=knn_step_ms["K6"],
                      host_us=host6, **info6)
    rows["K7"] = dict(KERNELS["K7"], max_abs_err=err7, ms=ms7, plain_ms=plain7,
                      bound_ms=b7, bound_by=by7, library_ms=None, step_ms=knn_step_ms["K7"],
                      host_us=host7, **info7)
    result["knn_kernels"] = dict(Cp=Cp, K=K, E=E, in_edges=n_rev, loss=float(loss6),
                                 loss_plain=float(loss_p), worst_row=worst_row)
    del again, de_p, s_p, out_p, de6, s6, out7

    (gp, gk, gc, gbins, gkw), _ = seen["grad"]
    d_first = rasterize.sorted_payload_grad(gp, gk, gc, gbins, gkw)
    d_again = rasterize.sorted_payload_grad(gp, gk, gc, gbins, gkw)
    det = torch.equal(d_first.view(torch.int32), d_again.view(torch.int32))
    print(f"payload gradient (K2 -> K3 through the index) {tuple(d_first.shape)} run twice: "
          f"bit-identical={det}", flush=True)
    if not det:
        fail("the payload gradient differs from run to run")
    del seen, d_first, d_again, flush_buf
    torch.set_grad_enabled(True)

    # ---- 5. a small cut, card against CPU ---------------------------------
    small = {k: v[:SMALL_N] for k, v in fields.items()}
    deltas = {}
    for dev in (DEVICE, "cpu"):
        sp, _ = gaussians_from_numpy(small, device=dev)
        sd = init_deform_params(hidden, seed=0, device=dev)
        final, (_, orig) = deform_forward(
            sd, hidden, sp.xyz, sp.scaling, sp.rotation, sp.opacity, get_features(sp),
            sp.embedding, 0.5, 10 ** 9, num_down_emb_c=hidden.min_embeddings,
            num_down_emb_f=hidden.min_embeddings)
        deltas[dev] = [(f - o).cpu() for f, o in zip(final, orig)]
    differing = [float(((x - y).abs() > BF16_ATOL).float().mean())
                 for x, y in zip(deltas[DEVICE], deltas["cpu"])]
    print(f"small deformation, bf16={hidden.bf16_activations}: fraction of values "
          f"differing by more than {BF16_ATOL} (xyz, scale, rot, opacity, sh): "
          + ", ".join(f"{d:.2e}" for d in differing) + f" (limit {BF16_MAX_DIFFERING})",
          flush=True)
    if max(differing) > BF16_MAX_DIFFERING:
        fail("small deformation: the card's bf16 MLP disagrees with the CPU's")
    hidden32 = dataclasses.replace(hidden, bf16_activations=False)
    scam = bench_camera(SMALL_W, SMALL_H)
    scfg = raster_config_from_camera(scam, pair_capacity=1 << 16, chunk=opt.raster_chunk)
    got = {}
    for dev in (DEVICE, "cpu"):
        sp, sa = gaussians_from_numpy(small, device=dev)
        sd = init_deform_params(hidden32, seed=0, device=dev)
        got[dev] = render(sp, sa, sd, hidden32,
                          settings_from_camera(scam, time=0.5, device=dev), scfg,
                          bg.to(dev), **render_kw)
    worst = 0.0
    for k in image_keys:
        x, y = got[DEVICE][k].cpu(), got["cpu"][k]
        d = (x - y).abs()
        frac = float((d > SMALL_ATOL + SMALL_RTOL * y.abs()).float().mean())
        limit = SMALL_MAX_FLIPPED if k in MEDIAN_KEYS else 0.0
        worst = max(worst, float(d.max()))
        print(f"  small {k:15s} max|cuda-cpu|={float(d.max()):.3e} "
              f"outside {SMALL_ATOL}+{SMALL_RTOL}*|v|: {frac:.2e} (limit {limit})")
        if not bool(torch.isfinite(x).all()) or frac > limit:
            fail(f"small render: {k} disagrees between the card and the CPU")
    np_cuda, np_cpu = int(got[DEVICE]["num_pairs"]), int(got["cpu"]["num_pairs"])
    print(f"small render {SMALL_N} Gaussians {SMALL_W}x{SMALL_H}: num_pairs cuda={np_cuda} "
          f"cpu={np_cpu}; max|cuda-cpu| {worst:.3e}", flush=True)
    # a splat's tile rect comes from a rounded radius: one may differ by a tile
    if abs(np_cuda - np_cpu) > 0.005 * np_cpu:
        fail("small render: num_pairs disagrees between the card and the CPU")

    # one train step at the config's embedding width and one at E = 16,
    # which the KNN kernels run zero-padded to their 32 columns
    for emb_dim in (hidden32.gaussian_embedding_dim, 16):
        shidden = dataclasses.replace(hidden32, gaussian_embedding_dim=emb_dim)
        sfields = dict(small, embedding=small["embedding"][:, :emb_dim])
        ssetup = dataclasses.replace(train_setup(cfg, scfg), hidden=shidden)
        sgrads, semb = {}, {}
        for dev in (DEVICE, "cpu"):
            sp, sa = gaussians_from_numpy(sfields, device=dev)
            sd = init_deform_params(shidden, seed=0, device=dev)
            scache = update_knn_cache(sp, sa)
            knn_before = knn_loss.knn_rows.launches
            sgrads[dev] = make_loss_and_grads(ssetup)(
                {"gaussians": sp, "deform": sd}, sa,
                make_batch(torch, scam, B, 0.5, True, 300, dev), scache, TRAIN_ITERATION)
            semb[dev] = float(sgrads[dev][1]["emb_loss"])
            if dev == DEVICE and knn_loss.knn_rows.launches == knn_before:
                fail(f"small train step at E={emb_dim}: the KNN kernels did not run")
        loss_c, loss_h = float(sgrads[DEVICE][0]), float(sgrads["cpu"][0])
        grad_worst = {}
        for k, g_cpu in sgrads["cpu"][2].items():
            g_dev = sgrads[DEVICE][2][k].cpu()
            if not bool(torch.isfinite(g_dev).all()):
                fail(f"small train step at E={emb_dim}: gradient {k} is not finite on the card")
            scale = float(g_cpu.abs().max())
            grad_worst[k] = float((g_dev - g_cpu).abs().max()) / scale if scale else float(
                g_dev.abs().max())
        vs_c, vs_h = sgrads[DEVICE][3].cpu(), sgrads["cpu"][3]
        grad_worst["vs_grad"] = float((vs_c - vs_h).abs().max()) / float(vs_h.abs().max())
        top = sorted(grad_worst.items(), key=lambda kv: -kv[1])[:6]
        print(f"small train step {SMALL_N} Gaussians {SMALL_W}x{SMALL_H} (float32, reg_coef "
              f"{ssetup.reg_coef}, E={emb_dim}): loss cuda={loss_c:.7f} cpu={loss_h:.7f} "
              f"(limit rel {SMALL_LOSS_REL}), emb_loss cuda={semb[DEVICE]:.7e} "
              f"cpu={semb['cpu']:.7e}; worst gradient leaves (max|diff| / max|g|, limit "
              f"{SMALL_GRAD_REL}): " + ", ".join(f"{k} {v:.2e}" for k, v in top), flush=True)
        result[f"small_train_e{emb_dim}"] = dict(loss_cuda=loss_c, loss_cpu=loss_h,
                                                 emb_loss=semb, grad_rel=grad_worst)
        if (abs(loss_c - loss_h) > SMALL_LOSS_REL * abs(loss_h)
                or abs(semb[DEVICE] - semb["cpu"]) > SMALL_LOSS_REL * abs(semb["cpu"])
                or semb["cpu"] <= 0 or max(grad_worst.values()) > SMALL_GRAD_REL):
            fail(f"small train step at E={emb_dim}: the card's loss or gradients disagree "
                 "with the CPU's")

    # one densify of the small cut with free capacity and numpy-seeded
    # statistics, the same draws handed to both devices
    rng = np.random.default_rng(500)
    hot = dict(small, xyz_grad_accum=rng.uniform(0, 1e-3, SMALL_N).astype(np.float32),
               denom=rng.integers(0, 4, SMALL_N).astype(np.float32))
    noise = rng.normal(size=(2, SMALL_CAP, 3)).astype(np.float32)
    dens = {}
    for dev in (DEVICE, "cpu"):
        sp, sa = gaussians_from_numpy(hot, capacity=SMALL_CAP, device=dev)
        dens[dev] = densify(sp, sa, grad_threshold=2e-4, percent_dense=opt.percent_dense,
                            scene_extent=1.0, max_gaussians=SMALL_CAP,
                            noise=torch.as_tensor(noise, device=dev))
    dc, dh = dens[DEVICE], dens["cpu"]
    same_masks = (torch.equal(dc.aux.alive.cpu(), dh.aux.alive)
                  and torch.equal(dc.reset_mask.cpu(), dh.reset_mask)
                  and (int(dc.n_cloned), int(dc.n_split)) == (int(dh.n_cloned), int(dh.n_split)))
    dens_err = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(dc.params, dh.params))
    print(f"small densify: n_cloned {int(dh.n_cloned)} n_split {int(dh.n_split)}, masks and "
          f"counts equal={same_masks}, worst parameter max|diff| / max|v| {dens_err:.2e} "
          f"(limit {SMALL_LOSS_REL})", flush=True)
    if not same_masks or dens_err > SMALL_LOSS_REL or int(dh.n_split) == 0:
        fail("small densify: the card disagrees with the CPU")

    # create_from_points: its 3-NN scales on the card and on the CPU
    colors = np.clip(small["features_dc"][:, 0] * 0.28 + 0.5, 0, 1)
    made = {dev: create_from_points(small["xyz"], colors, capacity=SMALL_CAP, device=dev)
            for dev in (DEVICE, "cpu")}
    made_err = max(float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))
                   for a, b in zip(made[DEVICE][0], made["cpu"][0]))
    made_alive = torch.equal(made[DEVICE][1].alive.cpu(), made["cpu"][1].alive)
    print(f"small create_from_points: worst parameter max|diff| / max|v| {made_err:.2e} "
          f"(limit {SMALL_LOSS_REL}), alive equal={made_alive}", flush=True)
    if made_err > SMALL_LOSS_REL or not made_alive:
        fail("small create_from_points: the card disagrees with the CPU")
    result["small_densify"] = dict(n_cloned=int(dh.n_cloned), n_split=int(dh.n_split),
                                   param_rel=dens_err, create_rel=made_err)

    order = ("K1", "K2", "K3", "K4", "K5a", "K5b", "K6", "K7", "K8")
    kernel_rows = [dict(rows[k], launches=train_launches[k]) for k in order]
    result["kernels"] = kernel_rows
    result["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(f"total {result['total_s']:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernel_rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
