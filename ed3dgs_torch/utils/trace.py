"""The port's tracer: where a train step, a frame and a densify event spend
their time, on the card and on the host, on one clock.

Device stage stamps. A *region* is one call of a graphed or timed path:
"step" (the graphed train step), "frame" (`tools.FrameRenderer`),
"densify_step" (the graphed densify step), "filter3d"
(`compute_3d_filter`) and "knn_refresh" (`refresh_knn_cache`). Inside
`with region(name, device):`, each `with stage(name):` of one of the
region's stages launches a one-thread kernel (csrc/trace_stamp.cu,
launch slot "trace.stamp") that adds the card's clock since the last
stamp to the stage the card was in and moves it to the new one; the
region's exit stamps the call's end. A ring of R rows a region, one row a
call, and a call counter live on the card; the counter picks the row, so a
captured graph's stamps fill the next row at every replay with no host work
and no host read. The stages partition a call: they run in order on one
stream, and their sum is the call's first-to-last stamp span (a stage
entered twice, as a batch's cameras enter "deform", is summed; a stage
entered inside another returns to it on exit). Each row records whether its
stamps were captured (a replay) or ran eagerly (a key's first run), and
readers of graphed regions average replays only. The rings and counters are
made at a region's first eager call on a device, outside any graph pool,
and never freed. On the CPU the same rows are kept on the host, with the
host's clock as the "device" clock.

Host spans. `with span(name, call=...):` records its name (the path of the
enclosing spans, "step/launch"), start and end (`time.perf_counter_ns`),
its self time (duration minus its children's), the call it belongs to (an
iteration, a frame's number; children inherit it) and whether the call
replayed a graph, in a bounded ring a path. `count(group, key, n)` keeps
counters: graph replays and captures per graph, bytes copied in per call,
the pinned scalars' waits and their ms. A stage emits
`record_function("ed3dgs.<name>")` while a profiler runs (in an eager run
or a capture: a replay runs no Python). A span emits none: the profiler
would draw a span that launches kernels (a replay's `launch`) on the
card's timeline as if it were a kernel, where a reader of device time
(benchmark/harness/trace.py) counts it as busy time; `dump` shows the
spans instead, beside the profiler's own trace.

One clock. At a device's first stamp the tracer calibrates the card's clock
(`%globaltimer`) against `perf_counter_ns`: several stamp-plus-synchronize
brackets, the tightest kept. `summary()` calibrates again, reports both
brackets and the drift between the offsets, and converts the stamps to the
host's clock, so that each device gap between two calls of a region (the
last stamp of one to the first of the next) is put against the host span
open when the card went idle and when it resumed ("outside the program"
where none was). A gap that holds another region's call (a densify event
between two steps) is reported apart and left out of the gap mean.

`summary()` returns the regions' mean stage ms over their last R replays,
span and gap ms, the host spans' mean and self ms over their last R
calls that no profiler ran through (and over those it did, apart), the
counters and the clock; `dump(path)` writes the rings and spans
as a Chrome trace (`tools.train --profile` writes one beside its
`trace.json`).

ED3DGS_TRACE_STAMPS=0 in the environment, read once at the first stamp,
leaves the device stamps out (nothing launched, nothing captured); the host
spans and counters stay. The stamps touch no tensor of the program.

This module imports only torch and the standard library; the stamp kernel
is built and launched through ops/cuda_lib.py, imported at a card's first
stamp.
"""

from __future__ import annotations

import collections
import json
import os
import time

import torch

R = 16                  # rows a region's ring holds: its last R calls
HOST_RING = 256         # spans kept a path
CALIBRATIONS = 8        # brackets a calibration takes, the tightest kept
ENV = "ED3DGS_TRACE_STAMPS"

# a region's stages, in the order a call enters them
REGIONS = {
    "step": ("deform", "project", "bin", "blend", "loss", "backward", "adam", "writeback"),
    "frame": ("deform", "project", "bin", "blend"),
    "densify_step": ("densify_step",),
    "filter3d": ("filter3d",),
    "knn_refresh": ("knn_refresh",),
}
GRAPHED = frozenset(("step", "frame", "densify_step"))   # readers average their replays
# a ring row: one accumulator a stage, then these columns (csrc/trace_stamp.cu)
BEGIN, LAST, CUR, REPLAYED, CALL, DONE, STAMPS = range(7)
META = 7
OP_BEGIN, OP_ENTER, OP_END = 0, 1, 2
OUTSIDE = "outside the program"

_RINGS: dict = {}       # (region, device) -> _Ring
_CLOCK: dict = {}       # device -> {"arm": (offset ns, bracket ns, host ns), "read": ...}
_HOST: dict = {}        # span path -> deque of (start, end, self ns, call, replayed,
#                         whether a profiler ran)
_COUNTS: dict = collections.defaultdict(lambda: collections.defaultdict(int))
_OPEN: list = []        # open regions (_Open), innermost last
_SPANS: list = []       # open spans, innermost last
_SWITCH = [None]        # whether stamps are on: read once from ENV


def stamps_on() -> bool:
    if _SWITCH[0] is None:
        _SWITCH[0] = os.environ.get(ENV, "1") != "0"
    return _SWITCH[0]


_now = time.perf_counter_ns
profiler_on = torch._C._autograd._profiler_enabled     # whether a profiler runs


# --- the device rings -------------------------------------------------------------

class _Ring:
    """One region's ring on one device: rows [R, stages + META] int64 and the
    call counter, on the card (a kernel writes them) or on the host."""

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device
        self.n = len(REGIONS[name])
        self.on_card = device.type == "cuda"
        if self.on_card:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"trace: no ring for region {name!r} on {device} during a "
                                   "CUDA graph capture: run the region once before capturing")
            _arm(device)
            self.rows = torch.zeros((R, self.n + META), dtype=torch.int64, device=device)
            self.calls = torch.zeros(1, dtype=torch.int64, device=device)
            from ..ops import cuda_lib
            self.lib = cuda_lib.kernels("trace_stamp", self.rows)
        else:
            self.rows = [[0] * (self.n + META) for _ in range(R)]
            self.calls = [0]

    def stamp(self, stage: int, op: int, replayed: bool):
        if self.on_card:
            from ..ops import cuda_lib
            with torch.cuda.device(self.device):
                err = self.lib.ed3dgs_trace_stamp(self.rows.data_ptr(), self.calls.data_ptr(),
                                                  R, self.n, stage, op, int(replayed),
                                                  cuda_lib.stream_of(self.rows))
            cuda_lib.check_launch(err, "trace.stamp")
            cuda_lib.count_launch(stamp)
            return
        now = _now()
        call = self.calls[0]
        row = self.rows[call % R]
        meta = self.n
        if op == OP_BEGIN:
            row[:self.n] = [0] * self.n
            row[meta + BEGIN], row[meta + REPLAYED] = now, int(replayed)
            row[meta + CALL], row[meta + DONE], row[meta + STAMPS] = call, -1, 1
        else:
            row[row[meta + CUR]] += now - row[meta + LAST]
            row[meta + STAMPS] += 1
            if op == OP_END:
                row[meta + DONE] = call
                self.calls[0] = call + 1
        row[meta + CUR], row[meta + LAST] = stage, now

    def read(self) -> tuple:
        """(calls, rows as lists)."""
        if self.on_card:
            return int(self.calls.cpu()[0]), self.rows.cpu().tolist()
        return self.calls[0], [list(r) for r in self.rows]


def stamp():
    """The stamp kernel's launch slot ("trace.stamp" in ops/cuda_lib.py
    LAUNCH_SLOTS): `stamp.launches` counts the stamps launched on the host's
    side (a captured stamp is counted on the card when it replays)."""


stamp.launches = 0


# a decoded call: its number, whether its stamps were captured, its first and
# last stamp (ns, the card's clock), each stage's ns and its stamps
Row = collections.namedtuple("Row", "call replayed begin end stages stamps")


def _decode(ring: _Ring) -> tuple:
    """(calls, the complete rows of the ring's last R calls, oldest first)."""
    calls, rows = ring.read()
    n, out = ring.n, []
    for call in range(max(0, calls - R), calls):
        r = rows[call % R]
        if r[n + CALL] == call and r[n + DONE] == call:
            out.append(Row(call, bool(r[n + REPLAYED]), r[n + BEGIN], r[n + LAST], r[:n],
                           r[n + STAMPS]))
    return calls, out


def rows(name: str, device=None) -> list:
    """The complete rows of region `name`'s last R calls on `device` (the
    first device holding the region where None), oldest first."""
    for (n, dev), ring in _RINGS.items():
        if n == name and (device is None or dev == torch.device(device)):
            return _decode(ring)[1]
    return []


# --- regions and stages ------------------------------------------------------------

class _Open:
    __slots__ = ("name", "ring", "index", "replayed", "begun", "current", "stack")

    def __init__(self, name, ring, replayed):
        self.name, self.ring, self.replayed = name, ring, replayed
        self.index = {s: i for i, s in enumerate(REGIONS[name])}
        self.begun, self.current, self.stack = False, None, []

    def switch(self, stage: str):
        if stage == self.current or self.ring is None:
            self.current = stage
            return
        self.ring.stamp(self.index[stage], OP_ENTER if self.begun else OP_BEGIN, self.replayed)
        self.begun, self.current = True, stage


class region:
    """`with region(name, device):` one call of region `name` on `device`.
    A region of one stage enters it at once."""

    __slots__ = ("name", "device", "open")

    def __init__(self, name: str, device):
        self.name, self.device = name, torch.device(device)

    def __enter__(self):
        ring = None
        if stamps_on():
            key = (self.name, self.device)
            ring = _RINGS.get(key)
            if ring is None:
                ring = _RINGS[key] = _Ring(self.name, self.device)
        replayed = ring is not None and ring.on_card and torch.cuda.is_current_stream_capturing()
        self.open = _Open(self.name, ring, replayed)
        _OPEN.append(self.open)
        stages = REGIONS[self.name]
        if len(stages) == 1:
            self.open.switch(stages[0])
        return self

    def __exit__(self, exc_type, exc, tb):
        _OPEN.remove(self.open)
        o = self.open
        if exc_type is None and o.begun:
            o.ring.stamp(o.index[o.current], OP_END, o.replayed)
        return False


class stage:
    """`with stage(name):` the innermost open region's stage `name` starts
    here (a stamp where the region has that stage and the card is not in it
    already); on exit inside an enclosing stage, the card returns to that
    one. Outside a region, or for a stage the region lacks, only the
    profiler's scope."""

    __slots__ = ("name", "open", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if profiler_on():
            self.rf = torch.profiler.record_function("ed3dgs." + self.name)
            self.rf.__enter__()
        o = _OPEN[-1] if _OPEN else None
        self.open = o if o is not None and self.name in o.index else None
        if self.open is not None:
            o.stack.append(self.name)
            o.switch(self.name)
        return self

    def __exit__(self, exc_type, exc, tb):
        o = self.open
        if o is not None:
            o.stack.pop()
            if o.stack and exc_type is None:
                o.switch(o.stack[-1])
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
        return False


# --- host spans and counters ----------------------------------------------------

class span:
    """`with span(name, call=None) as s:` a host span; set `s.replayed` to
    mark whether its call replayed a graph (children inherit both)."""

    __slots__ = ("name", "call", "replayed", "path", "parent", "child", "t0", "profiled")

    def __init__(self, name: str, call=None):
        self.name, self.call, self.replayed = name, call, None

    def __enter__(self):
        spans = _SPANS
        if spans:
            parent = self.parent = spans[-1]
            self.path = parent.path + "/" + self.name
            if self.call is None:
                self.call = parent.call
        else:
            self.parent = None
            self.path = self.name
        self.child = 0
        spans.append(self)
        self.profiled = profiler_on()
        self.t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now()
        _SPANS.pop()
        dur = t1 - self.t0
        parent = self.parent
        replayed = self.replayed
        if parent is not None:
            parent.child += dur
            up = parent
            while replayed is None and up is not None:
                replayed, up = up.replayed, up.parent
        try:
            ring = _HOST[self.path]
        except KeyError:
            ring = _HOST[self.path] = collections.deque(maxlen=HOST_RING)
        ring.append((self.t0, t1, dur - self.child, self.call, replayed, self.profiled))
        return False


def count(group: str, key: str, n: float = 1):
    _COUNTS[group][key] += n


# --- the clock -----------------------------------------------------------------------

def _calibrate(device: torch.device) -> tuple:
    """(offset, bracket, host time) in ns: host clock = card clock + offset,
    from the tightest of CALIBRATIONS stamp-plus-synchronize brackets."""
    if device.type != "cuda":
        return 0, 0, time.perf_counter_ns()
    from ..ops import cuda_lib
    with torch.cuda.device(device):
        buf = torch.zeros(CALIBRATIONS, dtype=torch.int64, device=device)
        lib = cuda_lib.kernels("trace_stamp", buf)
        stream = cuda_lib.stream_of(buf)
        host = torch.zeros(CALIBRATIONS, dtype=torch.int64).pin_memory()
        torch.cuda.synchronize(device)
        brackets = []
        for i in range(CALIBRATIONS):
            t0 = time.perf_counter_ns()
            cuda_lib.check_launch(lib.ed3dgs_trace_clock(buf.data_ptr() + 8 * i, stream),
                                  "trace clock")
            torch.cuda.synchronize(device)
            brackets.append((t0, time.perf_counter_ns()))
        host.copy_(buf, non_blocking=True)
        torch.cuda.synchronize(device)
        card = host.tolist()
    best = min(range(CALIBRATIONS), key=lambda i: brackets[i][1] - brackets[i][0])
    t0, t1 = brackets[best]
    return (t0 + t1) // 2 - card[best], t1 - t0, t1


def _arm(device: torch.device):
    if device not in _CLOCK:
        _CLOCK[device] = {"arm": _calibrate(device)}


def clock(device) -> dict:
    """The device's clock against the host's, calibrated again: the offset
    (ns), both brackets and the drift between the two offsets (us)."""
    device = torch.device(device)
    c = _CLOCK.setdefault(device, {"arm": _calibrate(device)})
    c["read"] = _calibrate(device)
    (a_off, a_br, a_t), (r_off, r_br, r_t) = c["arm"], c["read"]
    return {"offset_ns": r_off, "bracket_us": r_br / 1e3, "arm_bracket_us": a_br / 1e3,
            "drift_us": (r_off - a_off) / 1e3, "since_arm_s": (r_t - a_t) / 1e9}


# --- reading ---------------------------------------------------------------------------

def _owner(t: int) -> str:
    """The innermost host span open at host time t."""
    best, width = OUTSIDE, None
    for path, ring in _HOST.items():
        for t0, t1, *_ in ring:
            if t0 <= t < t1 and (width is None or t1 - t0 < width):
                best, width = path, t1 - t0
    return best


def _mean(v) -> float:
    v = list(v)
    return sum(v) / len(v) if v else None


def _region_summary(name, calls, rows_, decoded, device, offset) -> dict:
    stages = REGIONS[name]
    use = [r for r in rows_ if r.replayed or name not in GRAPHED]
    out = {"device": str(device), "calls": calls, "rows": len(use),
           "eager_rows": sum(not r.replayed for r in rows_)}
    if use:
        stage_ms = {s: _mean(r.stages[i] for r in use) / 1e6 for i, s in enumerate(stages)}
        out.update(stage_ms=stage_ms, stage_sum_ms=sum(stage_ms.values()),
                   span_ms=_mean(r.end - r.begin for r in use) / 1e6,
                   stamps_per_call=_mean(r.stamps for r in use))
    used = {r.call for r in use}
    others = [(o, r.begin) for (o, d), (_, rr) in decoded.items() if d == device and o != name
              for r in rr]
    gaps, apart = [], []
    for a, b in zip(rows_, rows_[1:]):
        if b.call != a.call + 1 or a.call not in used or b.call not in used:
            continue
        held = sorted({o for o, t in others if a.end < t < b.begin})
        g = {"call": b.call, "ms": (b.begin - a.end) / 1e6, "idle": _owner(a.end + offset),
             "resume": _owner(b.begin + offset)}
        if held:
            apart.append(dict(g, holds=held))
        else:
            gaps.append(g)
    out.update(gap_ms=_mean(g["ms"] for g in gaps), gaps=gaps, gaps_apart=apart)
    owners = {"idle": collections.Counter(g["idle"] for g in gaps),
              "resume": collections.Counter(g["resume"] for g in gaps)}
    out["gap_owners"] = {k: dict(v) for k, v in owners.items()}
    return out


def _span_summary(ring) -> dict:
    """Mean and self ms over the path's last R calls that no profiler
    slowed and that were no graph's first run (and over the last R the
    profiler ran through, apart)."""
    out = {"first_runs": sum(e[4] is False for e in ring)}
    for key, profiled in (("", False), ("profiled_", True)):
        kept = [e for e in ring if e[4] is not False and e[5] is profiled][-R:]
        out[key + "n"] = len(kept)
        if kept:
            out[key + "ms"] = _mean(e[1] - e[0] for e in kept) / 1e6
            out[key + "self_ms"] = _mean(e[2] for e in kept) / 1e6
    return out


def _devices() -> list:
    devs = {dev for _, dev in _RINGS} | set(_CLOCK)
    return sorted(devs, key=lambda d: (d.type != "cuda", str(d)))


def summary() -> dict:
    """The tracer's readings: see the module's docstring. Synchronizes each
    card it traced (the read and a fresh calibration)."""
    clocks = {dev: clock(dev) for dev in _devices()}
    decoded = {key: _decode(ring) for key, ring in _RINGS.items()}
    regions = {}
    for dev in _devices():
        for (name, d), (calls, rr) in decoded.items():
            if d == dev and name not in regions:
                regions[name] = _region_summary(name, calls, rr, decoded, dev,
                                                clocks[dev]["offset_ns"])
    counters = {g: dict(v) for g, v in _COUNTS.items()}
    calls = counters.get("copy_in_calls", {})
    counters["copy_in_bytes_per_call"] = {k: v / calls[k] for k, v in
                                          counters.get("copy_in_bytes", {}).items()
                                          if calls.get(k)}
    return {"stamps": stamps_on(), "clock": {str(d): c for d, c in clocks.items()},
            "regions": regions, "spans": {p: _span_summary(r) for p, r in _HOST.items()},
            "counters": counters}


def dump(path: str) -> str:
    """Write the rings and host spans as a Chrome trace (JSON; times in us
    on the host's clock): pid 0 the host spans, pid 1 each region's calls
    on the card, one thread a region, the stage ms in each call's args."""
    events = []
    for p, ring in _HOST.items():
        for t0, t1, self_ns, call, replayed, profiled in ring:
            events.append({"name": p, "ph": "X", "pid": 0, "tid": 0, "ts": t0 / 1e3,
                           "dur": (t1 - t0) / 1e3,
                           "args": {"call": call, "self_us": self_ns / 1e3,
                                    "replayed": replayed, "profiled": profiled}})
    offsets = {dev: clock(dev)["offset_ns"] for dev in _devices()}
    for tid, ((name, dev), ring) in enumerate(_RINGS.items()):
        for r in _decode(ring)[1]:
            args = {s: ns / 1e6 for s, ns in zip(REGIONS[name], r.stages)}
            args.update(call=r.call, replayed=r.replayed, stamps=r.stamps)
            events.append({"name": name, "ph": "X", "pid": 1, "tid": tid,
                           "ts": (r.begin + offsets[dev]) / 1e3, "dur": (r.end - r.begin) / 1e3,
                           "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path

