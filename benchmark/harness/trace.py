"""The traced window: torch.profiler over a short run of the cell's own
loop, the port's kernels named by their ids, the device's busy time as the
union of its operations' intervals, the longest idle gaps labelled by the
harness span the host was in, and the check that the profiler saw every
launch of the port's kernels that their own counters saw.
"""

from __future__ import annotations

import re
import time

# the port's kernels (csrc/*.cu) by their function names, and the launch
# counter each counts on (ed3dgs_torch/ops/cuda_lib.py LAUNCH_SLOTS). X1's
# three kernels count once a call, on knn_select.
KERNEL_IDS = {"forward_blend": "K1", "backward_blend": "K2", "segment_sum": "K3",
              "scan_decode": "K4", "unpack": "K5a", "pack": "K5b", "knn_rows": "K6",
              "knn_rows_wide": "K6", "knn_reverse": "K7", "knn_codes": "X1.codes",
              "knn_stage": "X1.stage", "knn_select": "X1"}
COUNTED = {"K1": ("rasterize_cuda.rasterize_forward",),
           "K2": ("rasterize_cuda.rasterize_backward",),
           "K3": ("segment_sum.segment_sum_rows", "segment_sum.segment_sum_rows_packed"),
           "K4": ("binning_scan.fused_bin_scans",), "K5a": ("relayout.unpack_image",),
           "K5b": ("relayout.pack_image",), "K6": ("knn_loss.knn_rows",),
           "K7": ("knn_loss.knn_reverse",), "X1": ("knn.knn",)}
SPAN_PREFIX = "bench."


def kernel_id(name: str):
    """The port's id of a device operation's name, or None: the function's
    own name (before its arguments or template list, after any namespace)
    compared whole."""
    base = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", "").strip())
    base = re.split(r"[(<]", base, maxsplit=1)[0].split("::")[-1].strip()
    return KERNEL_IDS.get(base)


def union_length(intervals) -> float:
    """Total length covered by [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The idle [start, end) gaps of the device in [lo, hi]."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def span_at(spans, t: float) -> str:
    """The innermost harness span (name, start, end) that holds time t."""
    best = None
    for name, s, e in spans:
        if s <= t < e and (best is None or e - s < best[2] - best[1]):
            best = (name, s, e)
    return best[0][len(SPAN_PREFIX):] if best else "outside the loop"


def profile(torch, fn):
    """Run fn() under the profiler in the span "bench.window", the port's
    launch counters read around it. Returns a dict: wall_s (host clock, the
    card synchronised at both ends) and window_s (the span's length) of the
    window, busy_s (the union of the device operations inside it), the
    per-id launch lists [(start_us, dur_us)], the launches by the profiler
    and by the counters, the top device operations and the longest idle
    gaps, each labelled by the harness span the host was in."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    from ed3dgs_torch.ops.cuda_lib import DeviceLaunches

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with DeviceLaunches() as counters:
            t0 = time.perf_counter()
            with record_function(SPAN_PREFIX + "window"):
                fn()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    dev_ops, spans = [], []
    for e in prof.events():
        s, d = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(SPAN_PREFIX) and d > s:
                dev_ops.append((e.name, s, d))
        elif e.name.startswith(SPAN_PREFIX):
            spans.append((e.name, s, d))
    if not counters.armed:
        raise RuntimeError("the port's launch counters were not armed: no kernel was counted")
    launches, seen = {}, {}
    for name, s, d in dev_ops:
        kid = kernel_id(name)
        if kid is not None:
            launches.setdefault(kid, []).append((s, d - s))
            seen[kid] = seen.get(kid, 0) + 1
    counted = {k: sum(counters.counts[slot] for slot in slots) for k, slots in COUNTED.items()}
    by_profiler = {k: seen.get(k, 0) for k in COUNTED}
    window = [(s, d) for name, s, d in spans if name == SPAN_PREFIX + "window"]
    lo, hi = window[0] if window else (min((s for _, s, _ in dev_ops), default=0.0),
                                       max((d for _, _, d in dev_ops), default=0.0))
    dev_ops = [(name, max(s, lo), min(d, hi)) for name, s, d in dev_ops if d > lo and s < hi]
    busy_us = union_length([(s, d) for _, s, d in dev_ops])
    top = {}
    for name, s, d in dev_ops:
        key = kernel_id(name) or name[:80]
        top[key] = top.get(key, 0.0) + (d - s) * 1e-6
    idle = sorted(gaps([(s, d) for _, s, d in dev_ops], lo, hi),
                  key=lambda g: g[0] - g[1])
    idle_gaps = [[span_at(spans, a), (b - a) * 1e-6] for a, b in idle[:10]]
    return dict(wall_s=wall, window_s=(hi - lo) * 1e-6, busy_s=busy_us * 1e-6,
                launches=launches, counted=counted, by_profiler=by_profiler,
                device_ops=sorted(([k, v] for k, v in top.items()), key=lambda x: -x[1])[:10],
                idle_gaps=idle_gaps)


def check_counts(trace: dict):
    """Raise unless the profiler recorded every counted launch of the port's
    kernels (a trace that lost records gives no share)."""
    bad = {k: (trace["by_profiler"][k], n) for k, n in trace["counted"].items()
           if trace["by_profiler"][k] != n}
    if bad:
        raise RuntimeError("the profiler's kernel records disagree with the kernels' own "
                           f"launch counters (id: (profiler, counters)): {bad}; the trace's "
                           f"top device operations: {trace['device_ops']}")
