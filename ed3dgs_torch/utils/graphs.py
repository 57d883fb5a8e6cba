"""Captured CUDA graphs: the port's counterpart of `jax.jit`.

The JAX package runs each hot path (the train step, a frame) as one
compiled program, traced once per static key: the Python values the
program branches on and the shapes of its inputs. The port runs the same
paths as a CUDA graph captured per key and replayed, so that a step costs
one launch of the host instead of thousands.

`GraphCache.run(key, body)` replays the key's graph, or, the first time it
sees the key:
  1. runs `body` eagerly on the cache's side stream: this is the call's
     result, and it builds whatever the body makes at its first run
     outside any graph pool (the kernels' libraries, cuBLAS's workspace,
     the kernels' zeroed scratch buffers, which ops/cuda_lib.py keeps per
     stream, and cached constants);
  2. captures `body` on the same stream into the cache's memory pool, one
     pool shared by every key: the graphs run one at a time on one stream,
     and none leaves a tensor alive in the pool between replays.
`body()` reads only static inputs (tensors whose storage stays put across
calls: the caller copies new values into them before `run`) and returns a
dict of tensors; the graph ends by copying them into static outputs of its
key, allocated outside the pool, which `run` returns and the next replay
of the key overwrites.

A capture that fails raises `GraphCaptureError` with its cause (a host read
of a device value, a copy from pageable memory, a synchronise): nothing
falls back to running eagerly.

Across the ranks of a torch.distributed world (the sharded step over
NCCL), each rank captures its own graph of a key, the step's collectives
inside it. Two ranks replaying graphs of different keys would leave NCCL
waiting forever, so before a key's first run the ranks `agree_on_key`:
they all-gather one int64 hash of it and raise `GraphKeyMismatch` unless
all hold the same. Replays are not checked (a check would cost a
collective and a host wait a step): every value a key is made of must
be one all ranks share (the iteration, the SSIM gate of the identically
seeded sampler, capacities that follow max-reduced metrics), so that
all ranks reach the same keys at the same calls. ProcessGroupNCCL's
watchdog thread queries the events of earlier collectives while a
capture is open, which a capture in the default "global" error mode
takes as an unsafe call from another thread; so while a
torch.distributed world is up on this process, every capture (a step
with collectives or not) uses `capture_error_mode="thread_local"`,
which checks only the capturing thread's calls. The NCCL communicators
exist before the capture: the eager first run made them.

`GraphedFunction` is the base of a function graphed on static buffers
(the train step, the densify step): the buffers of its current input
signature (new ones, and no graphs, when the signature changes), the
copy-in of each call's inputs, and `run`, which replays or captures on
the card and calls the body eagerly on the CPU.

A replay calls no kernel wrapper, and a wrapper called during a capture
launches nothing and counts nothing (ops/cuda_lib.py `count_launch`): the
kernels a replay runs count themselves on the card
(csrc/launch_count.cuh, read by ops/cuda_lib.py `DeviceLaunches`).

`PinnedScalars` stages a few float32 values a graph reads (a learning rate,
an iteration) through pinned host memory, so that writing them before a
replay makes the host wait for nothing.

The tracer (utils/trace.py) counts each cache's replays and captures, the
bytes copied in a call and the pinned scalars' waits.

This module imports only torch and the standard library.
"""

from __future__ import annotations

import hashlib
import time
import warnings

import torch

from . import trace


class GraphCaptureError(RuntimeError):
    """A body could not be captured; its cause is the exception's __cause__."""


class GraphKeyMismatch(RuntimeError):
    """The ranks of a world were about to run different keys."""


def key_hash(key) -> int:
    """A hash of `key` that every process computes alike (Python's `hash`
    of a string differs between processes): int64 of its repr's blake2b."""
    digest = hashlib.blake2b(repr(key).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little", signed=True)


def agree_on_key(key, group, device):
    """Raise `GraphKeyMismatch` on every rank of `group` unless all of them
    pass the same key: one all-gather of an int64 hash on `device` (a
    collective of its own, which parallel/comm.py's ledger does not
    count), read on the host. Called before a key's first run only: a
    replay is not checked."""
    import torch.distributed as dist

    mine = key_hash(key)
    gathered = torch.empty(dist.get_world_size(group), dtype=torch.int64, device=device)
    with warnings.catch_warnings():
        # deprecated in favour of all_gather_single in newer PyTorch; the
        # card machine's release has only this one
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(gathered, torch.tensor([mine], dtype=torch.int64,
                                                           device=device), group=group)
    hashes = gathered.tolist()
    differ = [r for r, h in enumerate(hashes) if h != mine]
    if differ:
        raise GraphKeyMismatch(
            f"rank {dist.get_rank()} holds key {key!r} (hash {mine}); ranks {differ} hold "
            f"other keys (hashes {[hashes[r] for r in differ]}): the ranks would run "
            "different steps")


def capture_error_mode() -> str:
    """"thread_local" while a torch.distributed world is up on this process
    (NCCL's watchdog thread queries events during a capture), else the
    default "global"."""
    import torch.distributed as dist

    return "thread_local" if dist.is_available() and dist.is_initialized() else "global"


class GraphCache:
    """One captured graph per static key on `device`, in one shared pool.

    `captures` lists each capture as (key, seconds, pool bytes it added):
    the seconds include the eager first run; the bytes are the growth of
    the card's reserved memory while the graph was recorded, which only
    the pool serves then."""

    def __init__(self, device, name: str = "graph"):
        self.device = torch.device(device)
        self.name = name
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.graphs: dict = {}      # key -> (CUDAGraph, static outputs)
        self.captures: list = []

    def __contains__(self, key) -> bool:
        return key in self.graphs

    @property
    def pool_bytes(self) -> int:
        return sum(b for _, _, b in self.captures)

    def clear(self):
        """Drop every graph (their inputs are gone); the pool stays for the
        next captures."""
        self.graphs.clear()

    def run(self, key, body) -> dict:
        entry = self.graphs.get(key)
        if entry is None:
            trace.count("captures", self.name)
            return self._first_run(key, body)
        graph, outputs = entry
        graph.replay()
        trace.count("replays", self.name)
        return outputs

    def _first_run(self, key, body) -> dict:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            warm = body()
        current.wait_stream(self.stream)
        outputs = {k: v.clone() for k, v in warm.items()}
        for v in warm.values():
            v.record_stream(current)    # read by the clones above
        del warm
        graph = torch.cuda.CUDAGraph()
        failure, grown = None, 0
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode=capture_error_mode()):
                reserved = torch.cuda.memory_reserved(self.device)
                try:
                    got = body()
                    for k, v in got.items():
                        outputs[k].copy_(v)
                    del got
                except Exception as e:   # noqa: BLE001 (re-raised below with its key)
                    failure = e
            grown = torch.cuda.memory_reserved(self.device) - reserved
        except Exception as e:           # noqa: BLE001 (capture_end on a broken capture)
            failure = failure or e
        if failure is not None:
            raise GraphCaptureError(f"capturing the {self.name} for key {key!r} failed: "
                                    f"{type(failure).__name__}: {failure}") from failure
        current.wait_stream(self.stream)
        self.graphs[key] = (graph, outputs)
        self.captures.append((key, time.perf_counter() - t0, grown))
        return outputs


class PinnedScalars:
    """`n` float32 values on `device` (`values`), written from the host by
    `write` without a wait: on the card through two pinned host buffers in
    turn, each refilled only after the copy that last read it has run
    (the host waits only when it runs two writes ahead of the card)."""

    def __init__(self, n: int, device):
        device = torch.device(device)
        self.values = torch.zeros(n, dtype=torch.float32, device=device)
        if device.type == "cuda":
            self._host = [torch.zeros(n, dtype=torch.float32).pin_memory() for _ in range(2)]
            self._copied = [torch.cuda.Event() for _ in range(2)]
            self._turn = 0

    def write(self, values: torch.Tensor):
        """values: n float32 on the CPU."""
        if not self.values.is_cuda:
            self.values.copy_(values)
            return
        i, self._turn = self._turn, self._turn ^ 1
        if not self._copied[i].query():
            t0 = time.perf_counter()
            self._copied[i].synchronize()
            trace.count("pinned_waits", "n")
            trace.count("pinned_waits", "ms", (time.perf_counter() - t0) * 1e3)
        self._host[i].copy_(values)
        self.values.copy_(self._host[i], non_blocking=True)
        self._copied[i].record()


class GraphedFunction:
    """The base of a function graphed on static buffers: `graphs` (a
    `GraphCache`, made at the first run on the card), `static` (the
    buffers of the current input signature: a dict whose "flat" entry maps
    each input's name to its buffer) and `signature`."""

    def __init__(self, name: str):
        self.name = name
        self.graphs = None
        self.static = None
        self.signature = None

    def prepare(self, signature, named: dict, allocate) -> dict:
        """The static buffers with `named`'s tensors copied in. A new
        signature (or the first call) gets new buffers from `allocate()`,
        and the graphs captured on the old ones go."""
        if signature != self.signature:
            self.static = allocate()
            self.signature = signature
            if self.graphs is not None:
                self.graphs.clear()
        nbytes = sum(copy_in(self.static["flat"][name], t) for name, t in named.items())
        trace.count("copy_in_bytes", self.name, nbytes)
        trace.count("copy_in_calls", self.name)
        return self.static

    def run(self, key, body, device) -> dict:
        """`body()` replayed (or run and captured) as the key's graph on the
        card; called eagerly on the CPU."""
        if torch.device(device).type != "cuda":
            return body()
        if self.graphs is None:
            self.graphs = GraphCache(device, self.name)
        return self.graphs.run(key, body)


def same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a is b's static buffer itself (nothing to copy in)."""
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype)


def copy_in(static: torch.Tensor, given: torch.Tensor) -> int:
    """Copy `given` into its static buffer unless it is that buffer; returns
    the bytes copied. A shorter 1-D `given` fills the buffer's front (a list
    padded to a fixed capacity)."""
    if same_storage(given, static):
        return 0
    if given.shape == static.shape:
        static.copy_(given)
    else:
        static[:given.shape[0]].copy_(given)
    return given.numel() * given.element_size()
