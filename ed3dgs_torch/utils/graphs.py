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

A replay calls no kernel wrapper, and a wrapper called during a capture
launches nothing and counts nothing (ops/cuda_lib.py `count_launch`): the
kernels a replay runs count themselves on the card
(csrc/launch_count.cuh, read by ops/cuda_lib.py `DeviceLaunches`).

`PinnedScalars` stages a few float32 values a graph reads (a learning rate,
an iteration) through pinned host memory, so that writing them before a
replay makes the host wait for nothing.

This module imports only torch and the standard library.
"""

from __future__ import annotations

import time

import torch


class GraphCaptureError(RuntimeError):
    """A body could not be captured; its cause is the exception's __cause__."""


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
            return self._first_run(key, body)
        graph, outputs = entry
        graph.replay()
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
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
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
            self._copied[i].synchronize()
        self._host[i].copy_(values)
        self.values.copy_(self._host[i], non_blocking=True)
        self._copied[i].record()


def same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    """a is b's static buffer itself (nothing to copy in)."""
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype)


def copy_in(static: torch.Tensor, given: torch.Tensor):
    """Copy `given` into its static buffer unless it is that buffer. A
    shorter 1-D `given` fills the buffer's front (a list padded to a fixed
    capacity)."""
    if same_storage(given, static):
        return
    if given.shape == static.shape:
        static.copy_(given)
    else:
        static[:given.shape[0]].copy_(given)
