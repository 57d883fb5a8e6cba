"""The port's tracer (ed3dgs_torch/utils/trace.py) on the CPU, where the
"device" clock is the host's: a region's stages partition each call's span
(the train step at batch 2 and 1, a frame, a stage entered inside another);
the ring keeps the last R calls and readers skip eager rows; host spans
carry their path, parent's call id and self time; the card's stamps convert
to the host clock by the calibrated offset, against which each gap between
two calls is put to the host span open at its ends; the switch leaves the
stamps out; and each reader the benchmark adds (benchmark/metrics/) returns
None on an empty tracer and the rings' mean on a filled one. On the card,
tests/test_torch_cuda.py counts the stamps of a replayed step."""

import importlib.util
import json
import os
import time

import pytest
import torch

from ed3dgs_torch.utils import trace
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """An empty tracer for each test (the module's state is the process's)."""
    import collections
    monkeypatch.setattr(trace, "_RINGS", {})
    monkeypatch.setattr(trace, "_CLOCK", {})
    monkeypatch.setattr(trace, "_HOST", {})
    monkeypatch.setattr(trace, "_COUNTS",
                        collections.defaultdict(lambda: collections.defaultdict(int)))
    monkeypatch.setattr(trace, "_OPEN", [])
    monkeypatch.setattr(trace, "_SPANS", [])
    monkeypatch.setattr(trace, "_SWITCH", [True])


def check_partition(rows, stamps):
    assert rows
    for r in rows:
        assert all(ns >= 0 for ns in r.stages)
        assert sum(r.stages) == r.end - r.begin > 0
        assert r.stamps == stamps and not r.replayed


def test_the_steps_stages_partition_each_call():
    """The graphed step (eager on the CPU): 4 stamps a camera, then loss,
    backward, adam, writeback and the end; the host spans and counters of
    each call."""
    from test_torch_cuda import graph_batch, graph_problem

    from ed3dgs_torch.train import trainer

    cam, setup, state, aux, optimizer, cache = graph_problem("cpu")
    step = trainer.make_train_step(setup, optimizer)
    b2 = graph_batch(cam, "cpu", 0, True)
    state, aux, _ = step(state, aux, b2, cache)
    b1 = {k: v[:1] if isinstance(v, torch.Tensor) else v for k, v in b2.items()}
    state, aux, _ = step(state, aux, b1, cache)
    rows = trace.rows("step")
    assert [r.call for r in rows] == [0, 1]
    check_partition(rows[:1], 13)
    check_partition(rows[1:], 9)
    assert all(r.stages[i] > 0 for r in rows for i in range(len(trace.REGIONS["step"])))
    s = trace.summary()
    assert s["regions"]["step"]["rows"] == 0          # no replay on the CPU
    assert s["regions"]["step"]["eager_rows"] == 2
    assert {"step", "step/inputs", "step/copy_in", "step/scalars", "step/launch"} <= set(
        s["spans"])
    assert [e[3] for e in trace._HOST["step/launch"]] == [9, 10]   # the iterations
    assert s["counters"]["copy_in_calls"]["train step"] == 2
    assert s["counters"]["copy_in_bytes"]["train step"] > 0


def test_a_frames_stages_partition_it_and_the_switch_leaves_them_out():
    from test_torch_cuda import graph_problem

    from ed3dgs_torch.tools import FrameRenderer

    cam, setup, state, aux, _, _ = graph_problem("cpu")
    fr = FrameRenderer(setup.hidden, torch.ones(3), sh_degree=3, kernel_size=0.1,
                       disable_filter3d=False, num_down_emb=5)
    model = (state.params["gaussians"], aux, state.params["deform"])
    args = (cam.world_view, cam.full_proj, cam.campos, 0.3)
    fr("k", model, setup.raster, *args)
    check_partition(trace.rows("frame"), 5)
    assert [e[3] for e in trace._HOST["frame"]] == [1]
    trace._SWITCH[0] = False
    fr("k", model, setup.raster, *args)
    assert len(trace.rows("frame")) == 1              # no stamp, no row
    assert [e[3] for e in trace._HOST["frame"]] == [1, 2]   # the spans stay


def test_a_stage_inside_another_returns_to_it():
    """The tongue sub-renders enter deform and project inside the loss: on
    their exit the card is back in the loss, and the stages still partition
    the call."""
    with trace.region("step", CPU):
        with trace.stage("deform"):
            time.sleep(0.002)
        with trace.stage("loss"):
            time.sleep(0.002)
            with trace.stage("deform"):
                time.sleep(0.002)
            with trace.stage("project"):
                time.sleep(0.002)
            time.sleep(0.004)
        with trace.stage("backward"):
            with trace.stage("not a stage of the step"):
                time.sleep(0.002)
    (r,) = trace.rows("step")
    names = trace.REGIONS["step"]
    ms = {s: r.stages[i] / 1e6 for i, s in enumerate(names)}
    assert sum(r.stages) == r.end - r.begin
    assert r.stamps == 8    # deform, loss, deform, loss, project, loss, backward, the end
    assert ms["loss"] >= 6 and ms["deform"] >= 4 and ms["project"] >= 2
    assert ms["backward"] >= 2 and ms["bin"] == ms["adam"] == 0


def fill(region, n, replayed, stage_ns, gap_ns=1000, start=10 ** 9):
    """n calls of `region` stamped directly, each stage `stage_ns[i]` ns, the
    calls `gap_ns` apart, on the CPU ring (its clock replaced)."""
    ring = trace._RINGS.get((region, CPU)) or trace._Ring(region, CPU)
    trace._RINGS[(region, CPU)] = ring
    t = [start]
    clock = lambda: t[0]     # noqa: E731
    old = trace._now
    trace._now = clock
    try:
        for i in range(n):
            for k, ns in enumerate(stage_ns):
                ring.stamp(k, trace.OP_ENTER if k else trace.OP_BEGIN, replayed)
                t[0] += ns
            ring.stamp(len(stage_ns) - 1, trace.OP_END, replayed)
            t[0] += gap_ns
    finally:
        trace._now = old
    return t[0]


def test_the_ring_wraps_and_readers_skip_eager_rows():
    fill("frame", 3, False, [5, 5, 5, 5])                        # first runs
    fill("frame", trace.R + 4, True, [1000, 2000, 3000, 4000], start=2 * 10 ** 9)
    rows = trace.rows("frame")
    assert len(rows) == trace.R
    assert [r.call for r in rows] == list(range(7, 7 + trace.R))
    s = trace.summary()["regions"]["frame"]
    assert s["calls"] == 3 + trace.R + 4 and s["rows"] == trace.R and s["eager_rows"] == 0
    assert s["stage_ms"] == {"deform": 1e-3, "project": 2e-3, "bin": 3e-3, "blend": 4e-3}
    assert s["span_ms"] == pytest.approx(s["stage_sum_ms"]) == pytest.approx(1e-2)
    assert s["gap_ms"] == pytest.approx(1e-3) and len(s["gaps"]) == trace.R - 1
    assert s["stamps_per_call"] == 5
    # the oldest rows eager: read for the gap of neither neighbour
    fill("step", 2, False, [7] * 8)
    fill("step", 3, True, [1] * 8, start=3 * 10 ** 9)
    st = trace.summary()["regions"]["step"]
    assert st["rows"] == 3 and st["eager_rows"] == 2 and len(st["gaps"]) == 2


def test_host_spans_carry_parent_call_and_self_time():
    with trace.span("step", call=41) as sp:
        sp.replayed = True
        with trace.span("inputs"):
            time.sleep(0.001)
        with trace.span("launch", call=7):
            with trace.span("inner"):
                time.sleep(0.002)
        time.sleep(0.001)
    host = trace._HOST
    assert set(host) == {"step", "step/inputs", "step/launch", "step/launch/inner"}
    (t0, t1, self_ns, call, replayed, profiled), = host["step"]
    kids = [host[p][0] for p in ("step/inputs", "step/launch")]
    assert self_ns == (t1 - t0) - sum(e[1] - e[0] for e in kids) >= 1e6
    assert call == 41 and replayed is True and profiled is False
    assert [host[p][0][3] for p in ("step/inputs", "step/launch", "step/launch/inner")] == [
        41, 7, 7]
    assert all(host[p][0][4] is True for p in host)          # inherited
    lt0, lt1, lself = host["step/launch"][0][:3]
    it0, it1 = host["step/launch/inner"][0][:2]
    assert lself == (lt1 - lt0) - (it1 - it0)
    s = trace.summary()["spans"]["step"]
    assert s["n"] == 1 and s["ms"] == pytest.approx((t1 - t0) / 1e6)
    assert s["self_ms"] == pytest.approx(self_ns / 1e6)


def test_span_host_cost_is_small_with_no_profiler():
    n = 2000
    t0 = time.perf_counter()
    for i in range(n):
        with trace.span("cost", call=i):
            pass
    per_us = (time.perf_counter() - t0) / n * 1e6
    assert len(trace._HOST["cost"]) == trace.HOST_RING
    assert per_us < 50, per_us      # loose here: PERF.md gives the card host's reading


def test_the_clock_converts_by_the_calibrated_offset(monkeypatch):
    """Device stamps fall OFF ns before the host's clock: the gap between
    two calls is put to the host spans open at its ends once converted."""
    OFF = 5 * 10 ** 12
    calls = []

    def fake(device):
        calls.append(device)
        return OFF + 1000 * len(calls), 20_000 + len(calls), 10 ** 9 * len(calls)
    monkeypatch.setattr(trace, "_calibrate", fake)
    host0 = time.perf_counter_ns()
    dev0 = host0 - OFF
    fill("step", 2, True, [100_000] * 8, gap_ns=3_000_000, start=dev0)
    # the host's side of the gap: the card went idle at end0 and resumed 3 ms on
    end0 = dev0 + 800_000 + OFF
    trace._HOST["read"] = __import__("collections").deque(
        [(end0 - 10_000, end0 + 1_000_000, 0, 0, None, False)])
    trace._HOST["step"] = __import__("collections").deque(
        [(end0 + 1_000_000, end0 + 3_500_000, 0, 1, True, False)])
    trace._HOST["step/launch"] = __import__("collections").deque(
        [(end0 + 2_900_000, end0 + 3_100_000, 0, 1, True, False)])
    s = trace.summary()
    (g,) = s["regions"]["step"]["gaps"]
    assert g["ms"] == pytest.approx(3.0)
    assert (g["idle"], g["resume"]) == ("read", "step/launch")
    c = s["clock"]["cpu"]
    assert c["offset_ns"] == OFF + 2000
    assert c["drift_us"] == pytest.approx(1.0) and c["since_arm_s"] == pytest.approx(1.0)
    assert (c["arm_bracket_us"], c["bracket_us"]) == (pytest.approx(20.001),
                                                      pytest.approx(20.002))
    # a gap holding another region's call is reported apart
    fill("filter3d", 1, False, [500], start=dev0 + 800_000 + 1_000_000)
    s = trace.summary()["regions"]["step"]
    assert s["gap_ms"] is None and s["gaps_apart"][0]["holds"] == ["filter3d"]


def test_dump_writes_a_chrome_trace(tmp_path):
    fill("frame", 2, True, [10, 20, 30, 40])
    with trace.span("frame", call=1):
        pass
    events = json.load(open(trace.dump(str(tmp_path / "stages.json"))))["traceEvents"]
    assert sorted(e["name"] for e in events) == ["frame", "frame", "frame"]
    assert {e["pid"] for e in events} == {0, 1}


READERS = {   # reader -> (region or span, what it reads)
    **{f"{s}_ms.train": ("step", s) for s in
       ("deform", "project", "bin", "blend", "loss", "backward", "adam")},
    **{f"{s}_ms.render": ("frame", s) for s in ("deform", "project", "bin", "blend")},
    "densify_step_ms.train": ("densify_step", "densify_step"),
    "filter3d_ms.train": ("filter3d", "filter3d"),
    "knn_refresh_ms.train": ("knn_refresh", "knn_refresh"),
    "step_gap_ms.train": ("step", "gap"), "frame_gap_ms.render": ("frame", "gap"),
    "step_host_ms.train": ("step", "span"), "frame_host_ms.render": ("frame", "span"),
}


def reader(name):
    path = os.path.join(REPO, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_every_tracer_metric_of_the_benchmark_has_a_reader_here():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    mine = {m["name"] for m in bench["per_layer"]
            if "ed3dgs_torch.utils import trace" in open(os.path.join(
                REPO, "benchmark", "metrics", m["name"] + ".py")).read()}
    assert mine == set(READERS)


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_reader_is_none_when_empty_and_the_mean_when_filled(name):
    region, what = READERS[name]
    read = reader(name)
    traced = {"trace": {"window_s": 1.0}}         # a --trace 1 run's context
    assert read(traced) is None
    fill(region, 1, True, [1] * len(trace.REGIONS[region]))
    with trace.span(region, call=0) as sp:
        sp.replayed = True
    assert read({}) is None                        # no traced run: nothing read
    trace._RINGS.clear()
    trace._HOST.clear()
    assert read(traced) is None
    stages = trace.REGIONS[region]
    graphed = region in trace.GRAPHED
    if what == "span":
        for i, ms in enumerate((1.0, 2.0, 9.0, 3.0)):
            with trace.span(region, call=i) as sp:
                sp.replayed = i != 2            # a first run is left out
                time.sleep(ms / 1e3)
        kept = [e for e in trace._HOST[region] if e[4]]
        assert read(traced) == pytest.approx(sum(e[1] - e[0] for e in kept) / len(kept) / 1e6)
        return
    fill(region, 2, not graphed, [1] * len(stages))        # eager rows of a graphed region
    if graphed:
        assert read(traced) is None
    ns = [1000 * (i + 1) for i in range(len(stages))]
    fill(region, trace.R + 2, True, ns, gap_ns=250_000, start=10 ** 10)
    want = 0.25 if what == "gap" else ns[stages.index(what)] / 1e6
    assert read(traced) == pytest.approx(want)
