"""The port's collectives, differentiable where the step needs it, and the
ledger that counts them (the role of ed3dgs_tpu/parallel/hlo_audit.py).

The JAX package lets XLA insert its collectives and audits the compiled HLO
to pin the sharding contracts. Here every collective is an explicit call on
a `Mesh` axis ("data", "gauss" or "world"), so each call records itself in
`ledger`: its kind, axis, bytes (the result's, as the HLO audit counts
them), its tag ("payload", "strip_image", "grad", "metric", or "state" for a
gathered parameter or state) and whether it
ran in the forward pass or in autograd's backward. The tests read the same
contracts from it: the sharded step all-reduces its gradients and gathers
nothing larger than the projected payload; the strip render exchanges each
camera's payload in one all-to-all and never all-gathers it.

A captured step (train/trainer.py `GraphedTrainStep`) calls these
functions twice for a new key, in its eager first run and while the CUDA
graph is recorded, and not at all when it replays the graph. The ledger
records the first run only (nothing while the current stream captures);
the step keeps those records per key and appends them again on each
replay (`Ledger.replay`), marked `replayed`, so that a graphed and an
eager run of the same steps leave the same collectives in the ledger.

  * `all_to_all(x, mesh, axis, tag)`: x [n*k, ...] split in n equal row
    blocks, block j to rank j of the axis. Its backward is the same
    exchange of the cotangent (the reverse all-to-all).
  * `all_gather_rows(x, mesh, axis, tag)`: every rank's x concatenated in
    rank order along dim 0. Its backward returns this rank's rows of the
    cotangent, NOT a sum over ranks: every rank of the axis computes the
    same replicated loss from the gathered value, so its own rows' slice is
    already the whole gradient (summing would multiply it by the axis size).
  * `all_reduce_(t, mesh, axis, op, tag)`: in place, not differentiable (the
    step's gradients and metrics).

Only `all_to_all_single`, `all_gather_into_tensor` and `all_reduce` of
torch.distributed are called. An axis of size one is the identity and
records nothing, so a `Mesh(1, 1)` needs no world. gloo takes CUDA tensors
for each of these calls (scripts/torch_gloo_cuda_probe.py, PERF.md), so a
world whose ranks share a card moves its tensors as they are.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, replace

import torch
import torch.distributed as dist

from .mesh import Mesh

TAGS = ("payload", "strip_image", "grad", "metric", "state")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclass(frozen=True)
class Record:
    kind: str       # "all_to_all" | "all_gather" | "all_reduce"
    axis: str       # "data" | "gauss" | "world"
    bytes: int      # the result's bytes on this rank
    tag: str
    backward: bool  # called from autograd's backward
    replayed: bool = False   # appended for a replay of a captured graph


class Ledger:
    """Every collective this process made since the last `reset()`."""

    def __init__(self):
        self.records = []

    def reset(self):
        self.records.clear()

    def add(self, kind, axis, t: torch.Tensor, tag, backward=False):
        if tag not in TAGS:
            raise ValueError(f"tag {tag!r}: want one of {TAGS}")
        if t.is_cuda and torch.cuda.is_current_stream_capturing():
            return      # a graph being recorded: its eager first run was counted
        self.records.append(Record(kind, axis, t.numel() * t.element_size(), tag, backward))

    def replay(self, records):
        """Append `records` (a captured graph's collectives, from its eager
        first run) as the collectives of one replay of that graph."""
        self.records.extend(replace(r, replayed=True) for r in records)

    def summary(self) -> dict:
        """{kind: {tag: {"count", "bytes", "max_bytes"}}}."""
        out: dict = {}
        for r in self.records:
            e = out.setdefault(r.kind, {}).setdefault(
                r.tag, {"count": 0, "bytes": 0, "max_bytes": 0})
            e["count"] += 1
            e["bytes"] += r.bytes
            e["max_bytes"] = max(e["max_bytes"], r.bytes)
        return out


ledger = Ledger()


def _exchange(x: torch.Tensor, mesh: Mesh, axis: str, tag: str, backward: bool):
    n = mesh.size(axis)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all: {x.shape[0]} rows do not split over {n} ranks")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group(axis))
    ledger.add("all_to_all", axis, out, tag, backward)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag):
        ctx.mesh, ctx.axis, ctx.tag = mesh, axis, tag
        return _exchange(x, mesh, axis, tag, False)

    @staticmethod
    def backward(ctx, ct):
        return _exchange(ct, ctx.mesh, ctx.axis, ctx.tag, True), None, None, None


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, tag: str) -> torch.Tensor:
    if mesh.group(axis) is None:
        return x
    return _AllToAll.apply(x, mesh, axis, tag)


def _gather(x: torch.Tensor, mesh: Mesh, axis: str, tag: str) -> torch.Tensor:
    n = mesh.size(axis)
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    out = torch.empty((n * wire.shape[0],) + tuple(wire.shape[1:]), dtype=wire.dtype,
                      device=wire.device)
    with warnings.catch_warnings():
        # deprecated in favour of all_gather_single in newer PyTorch; the
        # card machine's release has only this one
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, wire, group=mesh.group(axis))
    ledger.add("all_gather", axis, out, tag)
    return out.to(torch.bool) if x.dtype == torch.bool else out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag):
        ctx.rows, ctx.index = x.shape[0], mesh.index(axis)
        return _gather(x, mesh, axis, tag)

    @staticmethod
    def backward(ctx, ct):
        i, r = ctx.index, ctx.rows
        return ct[i * r:(i + 1) * r], None, None, None


def all_gather_rows(x: torch.Tensor, mesh: Mesh, axis: str, tag: str) -> torch.Tensor:
    if mesh.group(axis) is None:
        return x
    if x.requires_grad:
        return _AllGatherRows.apply(x, mesh, axis, tag)
    return _gather(x, mesh, axis, tag)


def all_reduce_(t: torch.Tensor, mesh: Mesh, axis: str, op: str, tag: str) -> torch.Tensor:
    """Reduce t in place over `axis` ("sum" or "max") and return it."""
    if mesh.group(axis) is None:
        return t
    if not t.is_contiguous():
        raise ValueError("all_reduce_ reduces in place: pass a contiguous tensor")
    dist.all_reduce(t, op=_OPS[op], group=mesh.group(axis))
    ledger.add("all_reduce", axis, t, tag)
    return t
