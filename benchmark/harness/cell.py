"""One run of one cell: set-up, the measured window, the traced window
(with --trace 1), the comparison with the reference, and the result.

Everything a cell is made of is found by name: its configuration in
configs/<config>.json, its traffic mix in traffic/<traffic>.json (whose
"loop" names the module harness/<loop>.py whose `Cell` drives it), its
limits in limits/<workload>.json, and each metric's reader in
metrics/<name>.py."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK_VIEWS = 4          # views of a traced window whose blend work is counted


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def reader(name: str):
    """The `read(ctx)` of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_spec(bench: dict, workload: str) -> dict:
    """The workload's entry, its configuration and traffic, its limits and
    the metrics it reports (end-to-end with --trace 0, per layer with 1)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: one of {sorted(cells)}")
    w = cells[workload]

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]
    return dict(workload=w, config=load_json("configs", w["config"] + ".json"),
                traffic=load_json("traffic", w["traffic"] + ".json"),
                limits=load_json("limits", workload + ".json"),
                end_to_end=mine(bench["end_to_end"]), per_layer=mine(bench["per_layer"]))


def make_cell(spec: dict, seed: int, device):
    """The `Cell` of harness/<loop>.py for the traffic's loop."""
    import importlib
    loop = importlib.import_module(f"{__package__}.{spec['traffic']['loop']}")
    return loop.Cell(spec["config"], spec["traffic"], seed, device)


def compare(program: dict, reference: dict) -> dict:
    """The numbers compared for a train cell, each a gap between the
    program's reading and the reference's: the worst step's loss gap over
    the reference's loss; the worst leaf's gap of the first step's gradient
    norm and of the followed steps' change norm, each leaf's over the larger
    of the reference's norm of that leaf and of the median leaf (the median
    leaf's gradient gap goes to the notes). Leaves whose reference gradient
    is under a thousandth of the median leaf's move by round-off under Adam,
    and are left out of the change."""
    def median(v):
        v = sorted(v)
        return v[len(v) // 2] if v else 0.0

    def gap(a, b, floor):
        d = abs(a - b) / max(abs(b), floor, 1e-30)
        return d if math.isfinite(d) else math.inf

    loss = max(gap(a, b, 0.0) for a, b in zip(program["loss"], reference["loss"]))
    g_r = reference["grad_norms"]
    g_med = median(g_r.values())
    grads = {p: gap(program["grad_norms"][p], g_r[p], g_med) for p in g_r}
    kept = [p for p in g_r if g_r[p] >= 1e-3 * g_med]
    c_r = reference["change_norms"]
    c_med = median(c_r[p] for p in kept)
    change = max(gap(program["change_norms"][p], c_r[p], c_med) for p in kept)
    worst = max(kept, key=lambda p: gap(program["change_norms"][p], c_r[p], c_med))
    worst_grad = max(grads, key=grads.get)
    return dict(loss_gap=loss, grad_gap=grads[worst_grad], change_gap=change,
                _worst_leaf=worst, _grad_worst_leaf=worst_grad,
                _grad_median_gap=median(grads.values()),
                _left_out=sorted(set(g_r) - set(kept)), _losses=[program["loss"],
                                                                 reference["loss"]])


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float | None = None, spec: dict | None = None,
             fault=None, control: bool = False) -> dict:
    """One run; returns the result's fields and the checks. `spec` replaces
    the workload's files (the tests' small cells), `fault` (a function of
    the cell) breaks the timed path before the window (the tests' faults),
    and `control` reads the reference one precision step down in the
    program's place instead of the program."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or cell_spec(bench, workload)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        from ed3dgs_torch.ops import cuda_lib
        cuda_lib.build()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cell = make_cell(spec, seed, device)
    cell.make_inputs()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cell.setup()
    if fault is not None:
        fault(cell)
    cell.warm()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    log = cell.window(seconds)
    if on_card:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    card = card_state() if on_card else None
    ctx = dict(kind=spec["traffic"]["loop"], cfg=spec["config"], window=log, setup_s=setup_s,
               peak_bytes=peak)
    if log.get("densified"):
        ctx["densified"] = log["densified"]
    traced = None
    if trace:
        from . import trace as tr
        steps = spec["traffic"]["traced"]
        holder = {}
        t = tr.profile(torch, lambda: holder.setdefault("views", cell.traced(steps)))
        tr.check_counts(t)
        ctx.update(trace=t, work=cell.sample_work(holder["views"], WORK_VIEWS),
                   alive=cell.alive())
        traced = t
    cell.release()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    checks, overflow = cell.check(lower=control)
    limits = spec["limits"]
    numbers = {k: v for k, v in checks.items() if not k.startswith("_")}
    correct = (not overflow and all(
        math.isfinite(v) and v <= limits[k] for k, v in numbers.items()))
    metrics = {}
    for m in (spec["per_layer"] if trace else spec["end_to_end"]):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = len(log.get("iter_ms", log.get("latency_ms", [])))
    result = dict(correct=correct, attempted=attempted, failed=0, metrics=metrics,
                  device=device_info(torch, peak, traced))
    if traced is not None:
        result["breakdown"] = {"device_ops": traced["device_ops"],
                               "idle_gaps": traced["idle_gaps"]}
    result["check"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    if overflow:
        result["check"]["pair_overflow"] = {"value": 1, "limit": 0}
    notes = {k: v for k, v in checks.items() if k.startswith("_")}
    notes.update(cell.notes())
    notes["_peak_bytes_setup_window"] = [setup_peak, peak]
    notes["_window"] = window_summary(log)
    notes["_card"] = card
    return dict(result=result, notes=notes)


def device_info(torch, peak: int, traced) -> dict:
    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": peak}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": peak}
    if traced is not None:
        info.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
    return info


def window_summary(log: dict) -> dict:
    """Medians of the window's per-iteration or per-request times, for the
    run's standard error."""
    import statistics
    return {k: (statistics.median(v) if v and not isinstance(v[0], tuple) else len(v))
            for k, v in log.items() if isinstance(v, list)}


def card_state() -> str:
    """The card's name, power limit, clocks and temperature (nvidia-smi),
    read once after the window."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.mem,"
                              "power.draw,temperature.gpu", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"
