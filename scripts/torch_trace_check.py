"""The tracer (ed3dgs_torch/utils/trace.py) held to the card's own
measurements in the benchmark's cells. On the card, from the repo's root:

    python3 scripts/torch_trace_check.py --workload nersemble_default.train \\
        --seeds 11 12 13 [--seconds 51]
    python3 scripts/torch_trace_check.py --span-cost

Each seed runs the cell as `benchmark/run.py --workload W --seed S --trace 1`
does (in a process of its own, as each run of run.py is: a second profiler
session in one process has lost kernel records), with its traced window
wrapped: around it the stamps the kernels' launch counters saw (slot
"trace.stamp", `DeviceLaunches`) and each region's calls. After the run it
reads the tracer's summary and prints one JSON line a seed: `correct`, the
per-layer metrics, the regions' stage, span and gap ms, the gaps' host spans,
the clock, and the checks:
  * the stages' ms sum to the region's span within 1%;
  * blend_ms >= K1's mean device ms a launch, and in a train cell
    backward_ms >= K2's, both from the same traced window's profiler records;
  * the gap between two calls plus the region's span within 5% of the
    traced window's ms a step (or a frame);
  * the stamps the counters saw = each region's calls in the window times
    its stamps a call;
  * the clock's bracket <= 50 us.
`--span-cost` times a host span, and a span with a child, with no profiler
running (us a span). Exits 1 where a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def span_cost(n: int = 200_000) -> dict:
    from ed3dgs_torch.utils import trace

    def one(i):
        with trace.span("cost", call=i):
            pass

    def nested(i):
        with trace.span("cost", call=i):
            with trace.span("child"):
                pass
    out = {}
    for name, fn in (("span_us", one), ("span_with_child_us", nested)):
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        out[name] = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for i in range(n):
        pass
    out["empty_loop_us"] = (time.perf_counter() - t0) / n * 1e6
    return out


def region_calls() -> dict:
    from ed3dgs_torch.utils import trace
    return {name: ring.read()[0] for (name, _), ring in trace._RINGS.items()}


def run_seed(bench: dict, workload: str, seed: int, seconds: float) -> dict:
    import torch
    from harness import cell
    from harness import trace as htrace

    from ed3dgs_torch.ops.cuda_lib import DeviceLaunches
    from ed3dgs_torch.utils import trace

    seen = {}
    profile = htrace.profile

    def wrapped(torch_, fn):
        before = region_calls()
        with DeviceLaunches() as d:
            out = profile(torch_, fn)
        after = region_calls()
        seen.update(stamps_counted=d.counts["trace.stamp"],
                    calls={k: v - before.get(k, 0) for k, v in after.items()},
                    window_s=out["window_s"], wall_s=out["wall_s"],
                    launch_ms={k: sum(dur for _, dur in v) / len(v) / 1e3
                               for k, v in out["launches"].items() if v})
        return out

    htrace.profile = wrapped
    try:
        out = cell.run_cell(bench, workload, seed, seconds, True)
    finally:
        htrace.profile = profile
    torch.cuda.synchronize()
    s = trace.summary()
    spec = cell.cell_spec(bench, workload)
    traced = spec["traffic"]["traced"]
    main = "step" if spec["traffic"]["loop"] == "train" else "frame"
    r = s["regions"][main]
    checks = {}
    for name, reg in s["regions"].items():
        if reg.get("rows"):
            checks[f"{name}.stage_sum_over_span"] = reg["stage_sum_ms"] / reg["span_ms"]
    window_ms = 1e3 * seen["window_s"] / traced
    checks["gap_plus_span_over_window_ms"] = (r["gap_ms"] + r["span_ms"]) / window_ms
    checks["blend_over_k1"] = r["stage_ms"]["blend"] / seen["launch_ms"]["K1"]
    if main == "step":
        checks["backward_over_k2"] = r["stage_ms"]["backward"] / seen["launch_ms"]["K2"]
    per_call = {n: s["regions"][n]["stamps_per_call"] for n in seen["calls"]
                if s["regions"][n].get("stamps_per_call")}
    want = sum(seen["calls"][n] * per_call.get(n, 0) for n in seen["calls"])
    checks["stamps_counted_over_expected"] = seen["stamps_counted"] / want if want else None
    clock = next(iter(s["clock"].values()))
    ok = (all(abs(v - 1) <= 0.01 for k, v in checks.items() if k.endswith("over_span"))
          and abs(checks["gap_plus_span_over_window_ms"] - 1) <= 0.05
          and checks["blend_over_k1"] >= 1 and checks.get("backward_over_k2", 1) >= 1
          and checks["stamps_counted_over_expected"] == 1
          and clock["bracket_us"] <= 50 and clock["arm_bracket_us"] <= 50)
    regions = {n: {k: v for k, v in reg.items() if k not in ("gaps", "gaps_apart")}
               for n, reg in s["regions"].items()}
    for n, reg in s["regions"].items():
        regions[n]["apart"] = [(g["ms"], g["holds"]) for g in reg["gaps_apart"]]
    return {"workload": workload, "seed": seed, "ok": ok, "correct": out["result"]["correct"],
            "metrics": {k: v["value"] for k, v in out["result"]["metrics"].items()},
            "checks": checks, "clock": clock, "window_ms_a_call": window_ms,
            "traced": {k: v for k, v in seen.items() if k != "launches"},
            "regions": regions,
            "spans": {p: v for p, v in s["spans"].items() if not p.startswith("cost")},
            "counters": s["counters"], "card": out["notes"].get("_card")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--span-cost", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".bench_cache", "torch_extensions")
    if args.span_cost:
        print(json.dumps({"span_cost": span_cost()}), flush=True)
    bad = 0
    if args.workload:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("the check needs an NVIDIA GPU")
        if len(args.seeds) > 1:
            import subprocess
            for seed in args.seeds:
                bad += subprocess.run([sys.executable, os.path.abspath(__file__), "--workload",
                                       args.workload, "--seeds", str(seed), "--seconds",
                                       str(args.seconds)]).returncode != 0
            sys.exit(1 if bad else 0)
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
        for seed in args.seeds:
            line = run_seed(bench, args.workload, seed, args.seconds)
            bad += not line["ok"]
            print(json.dumps(line), flush=True)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
