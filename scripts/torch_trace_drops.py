#!/usr/bin/env python3
"""How often a torch.profiler trace loses the card's kernel records.

    python3 scripts/torch_trace_drops.py [--runs 3] [--cupti-buffer-mb MB]
                                         [--out FILE]

Runs the `cli` phase of chip_smoke.py (300 iterations of tools.train on a
generated 802x550 scene, graphed step) `--runs` times and counts the port's
kernel launches two ways at once: exactly, by the kernels' own counters
(ops/cuda_lib.py `DeviceLaunches`, which the phase reads), and from a
torch.profiler trace of CUDA activity lapped every 25 steps, each kernel by
its symbol (how the launches of replayed graphs were counted before the
counters). Prints, for each run, each kernel's two counts and the laps whose
trace fell short, and writes them to FILE as JSON. `--cupti-buffer-mb` sets
CUPTI's device buffer for kernel records (CUPTI_ACTIVITY_ATTR_DEVICE_BUFFER_SIZE,
3.2 MB by default) before the first trace. Needs one GPU.
"""

import argparse
import ctypes
import json
import os
import re
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAP = 25
# kernel symbol (csrc/*.cu, in an anonymous namespace) -> its counter slot
SYMBOLS = {
    "forward_blend": "rasterize_cuda.rasterize_forward",
    "backward_blend": "rasterize_cuda.rasterize_backward",
    "segment_sum<true>": "segment_sum.segment_sum_rows",
    "segment_sum<false>": "segment_sum.segment_sum_rows_packed",
    "scan_decode": "binning_scan.fused_bin_scans",
    "boundary_deltas": "binning_scan.boundary_deltas", "unpack": "relayout.unpack_image",
    "pack": "relayout.pack_image", "knn_rows": "knn_loss.knn_rows",
    "knn_rows_wide": "knn_loss.knn_rows", "knn_reverse<false>": "knn_loss.knn_reverse",
    "knn_reverse<true>": "knn_loss.knn_reverse",
    **{f"knn_select<{k}>": "knn.knn" for k in (2, 4, 8, 16, 21, 32)},
}
SYMBOL = re.compile(r"(?:void )?\(anonymous namespace\)::(\w+(?:<[^>(]*>)?)\(")


class ProfilerTrace:
    """The port's launches in a torch.profiler trace of CUDA activity,
    lapped by `lap()`; `laps` holds each lap's counts and its kernels."""

    def __init__(self):
        self.laps, self._prof = [], None

    def open(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()

    def close(self):
        from torch.autograd import DeviceType
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        lap = dict.fromkeys(sorted(set(SYMBOLS.values())), 0)
        lap["kernels"] = 0
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() != DeviceType.CUDA or name.startswith(("Memcpy", "Memset")):
                continue
            lap["kernels"] += 1
            m = SYMBOL.match(name)
            if m is not None and m.group(1) in SYMBOLS:
                lap[SYMBOLS[m.group(1)]] += 1
        self.laps.append(lap)

    def lap(self):
        self.close()
        self.open()


def set_cupti_device_buffer(mb: int):
    """CUPTI_ACTIVITY_ATTR_DEVICE_BUFFER_SIZE (0 in cupti_activity.h) of
    the libcupti this process has loaded."""
    with open("/proc/self/maps") as f:
        paths = sorted({line.split()[-1] for line in f if "libcupti" in line.split()[-1]})
    if not paths:
        raise RuntimeError("libcupti is not loaded in this process")
    value = ctypes.c_size_t(mb << 20)
    size = ctypes.c_size_t(ctypes.sizeof(value))
    err = ctypes.CDLL(paths[0]).cuptiActivitySetAttribute(0, ctypes.byref(size),
                                                          ctypes.byref(value))
    if err:
        raise RuntimeError(f"cuptiActivitySetAttribute failed with {err}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--cupti-buffer-mb", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(REPO, "smoke_out", "trace_drops.json"))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    import chip_smoke as cs
    from ed3dgs_torch.ops import (binning_scan, cuda_lib, knn, knn_loss, rasterize_cuda,
                                  relayout, segment_sum)
    from ed3dgs_torch.tools import train as train_tool
    from ed3dgs_torch.train import trainer

    cuda_lib.build()
    torch.zeros(1, device="cuda")
    if args.cupti_buffer_mb:
        set_cupti_device_buffer(args.cupti_buffer_mb)
    counters = {"K1": rasterize_cuda.rasterize_forward, "K2": rasterize_cuda.rasterize_backward,
                "K3": segment_sum.segment_sum_rows, "K4": binning_scan.fused_bin_scans,
                "K5a": relayout.unpack_image, "K5b": relayout.pack_image,
                "K6": knn_loss.knn_rows, "K7": knn_loss.knn_reverse,
                "K8": segment_sum.segment_sum_rows_packed, "X1": knn.knn}
    make_step, train_main = trainer.make_train_step, train_tool.main
    runs = []
    for run in range(args.runs):
        trace, calls = ProfilerTrace(), [0]

        class Lapped:
            """The train step, lapping the trace every LAP calls."""

            def __init__(self, step):
                self.step = step

            def __getattr__(self, name):
                return getattr(self.step, name)

            def __call__(self, *a):
                out = self.step(*a)
                calls[0] += 1
                if calls[0] % LAP == 0:
                    trace.lap()
                return out

        def traced_main(argv, _first=[True]):
            """The phase's first tools.train run (the one its counters
            read) under the trace; its resume run without."""
            if not _first:
                return train_main(argv)
            _first.clear()
            trace.open()
            try:
                return train_main(argv)
            finally:
                trace.close()
        trainer.make_train_step = lambda *a, **k: Lapped(make_step(*a, **k))
        train_tool.main = traced_main
        try:
            with tempfile.TemporaryDirectory() as tmp:
                out = cs.cli_phase(torch, counters, [float("nan")], tmp)
        finally:
            trainer.make_train_step, train_tool.main = make_step, train_main
        traced = {k: sum(lap[cs.WRAPPER_OF[k]] for lap in trace.laps) for k in out["launches"]}
        short = [(i, lap["rasterize_cuda.rasterize_backward"], lap["kernels"])
                 for i, lap in enumerate(trace.laps[:-1])
                 if lap["rasterize_cuda.rasterize_backward"] != LAP]
        runs.append(dict(counters=out["launches"], trace=traced, short_laps=short,
                         kernels_traced=sum(lap["kernels"] for lap in trace.laps)))
        print(f"run {run} (CUPTI device buffer "
              f"{args.cupti_buffer_mb or 3.2} MB): counters {out['launches']}; trace {traced}; "
              f"laps of {LAP} steps short of K2 (lap, K2, kernels): {short}", flush=True)
    print(f"{sum(r['trace'] != r['counters'] for r in runs)} of {len(runs)} runs' traces "
          f"differ from the counters; {cs.card_line()}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=cs.card_line(), cupti_buffer_mb=args.cupti_buffer_mb, runs=runs), f,
                  indent=1)


if __name__ == "__main__":
    main()
