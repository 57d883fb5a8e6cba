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
   before every launch;
2. drives the forward main path: `ed3dgs_torch.render.render` on three
   frames. Every launch count is set to 0 just before and read just after;
   K1, K4 and K5a must each have risen by one per frame. Profiles one frame;
3. drives the train path: `init_train_state` -> `make_train_step`, one
   warm-up step that records the inputs the gradient hands K2, K3 and K5b,
   then five steps at iteration 20,000 (deformation, coarse-to-fine, SH 3 and
   the depth-normal term live; SSIM on two of them) with reg_coef=0, the cut
   of this slice (the KNN regulariser's kernels are not ported yet). Every
   count is set to 0 just before the five steps; all six kernels must have
   risen by steps x batch. Prints each step's loss, the step time by CUDA
   events, and one profiled step's device busy time, idle share and top
   device items;
4. holds K2, K3 and K5b against their plain versions on the recorded inputs
   (K5b bit-exact; K2's live-chunk counts exactly and every row of every
   tile within K2_REL of its column's largest value; K3 within K3_REL of the
   largest output), runs the payload gradient (K2 -> un-permute -> K3) twice and
   requires bit-identical results, and times them as in 1;
5. compares a 4096-Gaussian cut on the card with the CPU: its bf16
   deformation, its render at 160x110 (float32 activations) and one train
   step's loss and gradients (float32 activations).

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
# K3 against its plain version: both round a float64-exact sum once.
K2_REL, K3_REL = 1e-4, 1e-6
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


def bench_camera(width: int, height: int):
    from ed3dgs_torch.data.cameras import look_at_camera
    fov = math.radians(50.0)
    return look_at_camera((0, 0, 0), (0, 0, 2.0), (0, -1, 0), fov,
                          2 * math.atan(math.tan(fov / 2) * height / width),
                          width, height).matrices()


def time_ms(torch, fn, iters: int, flush) -> float:
    """Mean device time of `fn` over `iters` launches, each after an L2
    flush (the main path finds these inputs cold)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


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
    """The nersemble config's TrainSetup (as the JAX package's tools/train.py
    builds it), with reg_coef=0: this slice's cut."""
    from ed3dgs_torch.train.trainer import TrainSetup
    model, hidden, opt = cfg.model, cfg.hidden, cfg.opt
    return TrainSetup(
        raster=rcfg, hidden=hidden, batch_size=opt.batch_size,
        white_background=model.white_background, kernel_size=model.kernel_size,
        disable_filter3d=model.disable_filter3D, use_coord_map=model.use_coord_map,
        lambda_dssim=opt.lambda_dssim, opacity_l1_coef=opt.opacity_l1_coef_fine,
        reg_coef=0.0, coef_tv_temporal=opt.coef_tv_temporal_embedding,
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
    from ed3dgs_torch.models.gaussians import get_features
    from ed3dgs_torch.ops import (binning, binning_scan, cuda_lib, rasterize, rasterize_cuda,
                                  relayout, segment_sum)
    from ed3dgs_torch.render import raster_config_from_camera, render, settings_from_camera
    from ed3dgs_torch.train.trainer import init_train_state, make_loss_and_grads, make_train_step
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
    rows["K1"] = dict(KERNELS["K1"], max_abs_err=err1, ms=ms1, plain_ms=plain1,
                      bound_ms=b1, bound_by=by1, library_ms=None)
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
    result["profile"] = print_profile("frame", *profile_window(
        torch, lambda: frame(FRAME_TIMES[1]), os.path.join(out_dir, "profile_frame.txt")))

    # ---- 3. the train path: five steps --------------------------------------
    setup = train_setup(cfg, rcfg)
    B = setup.batch_size
    state, optimizer = init_train_state(params, hidden, opt, 1.0, seed=0)
    state = state._replace(iteration=TRAIN_ITERATION)
    step = make_train_step(setup, optimizer)
    batches = [make_batch(torch, cam, B, 0.1 + 0.2 * i, i in SSIM_STEPS, 100 + i, DEVICE)
               for i in range(TRAIN_STEPS)]
    print(f"train path: batch {B}, iteration {TRAIN_ITERATION}, reg_coef 0, "
          f"lambda_dssim {setup.lambda_dssim} (SSIM on steps {list(SSIM_STEPS)}), "
          f"opacity_l1 {setup.opacity_l1_coef}, depth-normal {setup.lambda_depth_normal} "
          f"from {setup.radegs_from_iter}", flush=True)
    seen = {}
    restore = [recorder(seen, rasterize, "rasterize_backward", "K2"),
               recorder(seen, rasterize, "segment_sum_rows", "K3"),
               recorder(seen, relayout, "pack_image", "K5b"),
               recorder(seen, rasterize, "sorted_payload_grad", "grad")]
    try:
        state, taux, metrics = step(state, aux, make_batch(torch, cam, B, 0.05, True, 99,
                                                           DEVICE))
        torch.cuda.synchronize()
    finally:
        for r in restore:
            r()
    if set(seen) != {"K2", "K3", "K5b", "grad"}:
        fail(f"the warm-up step did not reach every gradient kernel: {sorted(seen)}")
    counters = {"K1": rasterize_cuda.rasterize_forward, "K2": rasterize_cuda.rasterize_backward,
                "K3": segment_sum.segment_sum_rows, "K4": binning_scan.fused_bin_scans,
                "K5a": relayout.unpack_image, "K5b": relayout.pack_image}
    for fn in counters.values():
        fn.launches = 0
    losses, events = [], []
    t_host = time.perf_counter()
    for i in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, taux, metrics = step(state, taux, batches[i])
        end.record()
        events.append((start, end))
        losses.append(metrics)
    torch.cuda.synchronize()
    step_host_ms = (time.perf_counter() - t_host) * 1e3 / TRAIN_STEPS
    train_launches = {k: fn.launches for k, fn in counters.items()}
    step_ms = [s.elapsed_time(e) for s, e in events]
    print(f"train path: {TRAIN_STEPS} steps: launches {train_launches}", flush=True)
    for k, n in train_launches.items():
        if n != TRAIN_STEPS * B:
            fail(f"{k} launched {n} times in {TRAIN_STEPS} steps of batch {B}")
    for i, m in enumerate(losses):
        vals = {k: float(m[k]) for k in ("loss", "l1", "ssim", "psnr", "opacity_mean",
                                         "depth_normal")}
        print(f"  step {i}: " + " ".join(f"{k}={v:.6f}" for k, v in vals.items())
              + f" num_pairs={int(m['num_pairs'])}", flush=True)
        if not all(math.isfinite(v) for v in vals.values()) or bool(m["tile_overflow"]):
            fail(f"train step {i}: non-finite metrics or tile overflow")
        if vals["depth_normal"] <= 0 or (i in SSIM_STEPS) == (vals["ssim"] == 1.0):
            fail(f"train step {i}: the depth-normal or SSIM term is not live as configured")
    for name, t in list(state.params["gaussians"]._asdict().items()):
        if not bool(torch.isfinite(t).all()):
            fail(f"parameter {name} is not finite after the steps")
    if float(taux.denom.sum()) <= 0 or not bool(torch.isfinite(taux.xyz_grad_accum).all()):
        fail("the densification statistics did not accumulate")
    print("  train-step ms (CUDA events): " + ", ".join(f"{x:.3f}" for x in step_ms)
          + f"; host wall {step_host_ms:.3f} ms/step", flush=True)
    result.update(train_step_ms=step_ms, train_host_ms_per_step=step_host_ms,
                  train_launches=train_launches,
                  train_losses=[float(m["loss"]) for m in losses])
    del losses, batches
    pbatch = make_batch(torch, cam, B, 0.6, True, 200, DEVICE)

    def profiled_step():
        step(state, taux, pbatch)
    result["train_profile"] = print_profile("train step", *profile_window(
        torch, profiled_step, os.path.join(out_dir, "profile_step.txt")))

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
    rows["K2"] = dict(KERNELS["K2"], max_abs_err=err2, ms=ms2, plain_ms=plain2,
                      bound_ms=b2, bound_by=by2, library_ms=None)
    result["K2_work"] = dict(rows_live=rows_live, rows=total2, bytes=bytes2, ops=ops2, **stats2)
    del dpay, dpay_plain, got2, want2

    (rows3, st3, en3), _ = seen["K3"]
    out3 = segment_sum.segment_sum_rows(rows3, st3, en3)
    out3_plain = segment_sum.segment_sum_rows_plain(rows3, st3, en3)
    err3 = float((out3 - out3_plain).abs().max())
    scale3 = float(out3_plain.abs().max())
    print(f"K3 segment_sum_rows: rows {tuple(rows3.shape)} segments {st3.numel()} "
          f"max_abs_err={err3:.3e} (limit {K3_REL} x {scale3:.3e})", flush=True)
    if not err3 <= K3_REL * scale3 or not bool(torch.isfinite(out3).all()):
        fail("K3 disagrees with its plain version")
    ms3 = time_ms(torch, lambda: segment_sum.segment_sum_rows(rows3, st3, en3), 50, flush)
    plain3 = time_ms(torch, lambda: segment_sum.segment_sum_rows_plain(rows3, st3, en3),
                     20, flush)
    summed = int((en3 - st3).sum())
    # the library yardstick: one segment_reduce over the same contiguous
    # segments (the binning's CSR bounds tile the rows from 0 without gaps)
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
    b3, by3 = bound(summed * rows3.shape[1] * 4 + 2 * 4 * st3.numel()
                    + out3.numel() * 4, summed * rows3.shape[1])
    rows["K3"] = dict(KERNELS["K3"], max_abs_err=err3, ms=ms3, plain_ms=plain3,
                      bound_ms=b3, bound_by=by3, library_ms=lib3)

    (gp, gk, gc, gbins, gkw), _ = seen["grad"]
    d_first = rasterize.sorted_payload_grad(gp, gk, gc, gbins, gkw)
    d_again = rasterize.sorted_payload_grad(gp, gk, gc, gbins, gkw)
    det = torch.equal(d_first.view(torch.int32), d_again.view(torch.int32))
    print(f"payload gradient (K2 -> un-permute -> K3) {tuple(d_first.shape)} run twice: "
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

    ssetup = dataclasses.replace(train_setup(cfg, scfg), hidden=hidden32)
    sgrads = {}
    for dev in (DEVICE, "cpu"):
        sp, sa = gaussians_from_numpy(small, device=dev)
        sd = init_deform_params(hidden32, seed=0, device=dev)
        sgrads[dev] = make_loss_and_grads(ssetup)(
            {"gaussians": sp, "deform": sd}, sa,
            make_batch(torch, scam, B, 0.5, True, 300, dev), TRAIN_ITERATION)
    loss_c, loss_h = float(sgrads[DEVICE][0]), float(sgrads["cpu"][0])
    grad_worst = {}
    for k, g_cpu in sgrads["cpu"][2].items():
        g_dev = sgrads[DEVICE][2][k].cpu()
        if not bool(torch.isfinite(g_dev).all()):
            fail(f"small train step: gradient {k} is not finite on the card")
        scale = float(g_cpu.abs().max())
        grad_worst[k] = float((g_dev - g_cpu).abs().max()) / scale if scale else float(
            g_dev.abs().max())
    vs_c, vs_h = sgrads[DEVICE][3].cpu(), sgrads["cpu"][3]
    grad_worst["vs_grad"] = float((vs_c - vs_h).abs().max()) / float(vs_h.abs().max())
    top = sorted(grad_worst.items(), key=lambda kv: -kv[1])[:6]
    print(f"small train step {SMALL_N} Gaussians {SMALL_W}x{SMALL_H} (float32): loss cuda="
          f"{loss_c:.7f} cpu={loss_h:.7f} (limit rel {SMALL_LOSS_REL}); worst gradient leaves "
          f"(max|diff| / max|g|, limit {SMALL_GRAD_REL}): "
          + ", ".join(f"{k} {v:.2e}" for k, v in top), flush=True)
    result["small_train"] = dict(loss_cuda=loss_c, loss_cpu=loss_h, grad_rel=grad_worst)
    if abs(loss_c - loss_h) > SMALL_LOSS_REL * abs(loss_h) or max(
            grad_worst.values()) > SMALL_GRAD_REL:
        fail("small train step: the card's loss or gradients disagree with the CPU's")

    order = ("K1", "K2", "K3", "K4", "K5a", "K5b")
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
