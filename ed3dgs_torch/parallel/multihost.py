"""Starting a torch.distributed world, and what each rank takes of the
batch, the cameras and the state (port of ed3dgs_tpu/parallel/multihost.py).

A run is launched one process per rank, by `torchrun` (`python -m
torch.distributed.run --nproc_per_node N ...`), which sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT; `initialize_multihost` reads them
and does nothing without them, so a single-process run is unaffected.

The backend is the caller's choice, never one picked after another fails:
"nccl" when each rank owns a GPU (device cuda:LOCAL_RANK), "gloo" on the
CPU or when ranks share one card (every rank on cuda:0, which NCCL refuses).
A collective that fails raises.

`spawn_world` starts such a world on one host from Python, with a deadline,
for tests and for the smoke script's shared-card phase.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
import traceback
from typing import List, Optional

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

BACKENDS = ("nccl", "gloo")


def initialize_multihost(backend: str = "gloo", *, timeout_s: float = 300.0) -> int:
    """Join the world torchrun describes in the environment and return this
    process's rank; 0, and nothing done, without RANK and WORLD_SIZE (or
    when the world is already initialised)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
    if dist.is_initialized():
        return dist.get_rank()
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return 0
    dist.init_process_group(backend, init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()


def rank_device(device: str = "cuda", *, share: bool = False) -> torch.device:
    """This rank's device: cuda:LOCAL_RANK, or cuda:0 for every rank with
    `share` (ranks sharing one card); the CPU stays the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for but torch.cuda.is_available() is "
                           "False; pass device='cpu' for a CPU world")
    index = 0 if share else int(os.environ.get("LOCAL_RANK", 0))
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK {index} has no GPU ({torch.cuda.device_count()} "
                           "visible); pass share=True to put every rank on cuda:0")
    return torch.device("cuda", index)


def check_backend(backend: str, device: torch.device, share: bool):
    """Refuse the pairings that cannot work: NCCL without a GPU of the
    rank's own, gloo is taken as asked (it moves CUDA tensors over the
    host)."""
    if backend == "nccl" and (device.type != "cuda" or share):
        raise ValueError("nccl needs one GPU per rank; use gloo on the CPU or for ranks "
                         "that share a card")


def global_mesh(data: Optional[int] = None, gauss: Optional[int] = None) -> Mesh:
    """A mesh over every rank. Defaults: "data" spans hosts (camera
    parallelism between machines), "gauss" the ranks of a host."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    data = data or max(world // per_host, 1)
    gauss = gauss or world // data
    return make_mesh(data=data, gauss=gauss)


def parse_mesh_spec(spec: Optional[str]) -> Optional[Mesh]:
    """The trainer's --mesh flag as a Mesh (None for no flag):
      "auto"            "data" spans hosts, "gauss" the ranks of a host
      "data=2,gauss=4"  explicit sizes (0 means the rest of the world)"""
    if not spec:
        return None
    if spec == "auto":
        return global_mesh()
    sizes = {"data": 1, "gauss": 1}
    for item in spec.split(","):
        k, _, v = item.partition("=")
        k = k.strip()
        if k not in sizes:
            raise ValueError(f"unknown mesh axis {k!r} (want data/gauss)")
        sizes[k] = int(v)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if sizes["data"] == 0:
        sizes["data"] = world // max(sizes["gauss"], 1)
    if sizes["gauss"] == 0:
        sizes["gauss"] = world // max(sizes["data"], 1)
    return make_mesh(data=sizes["data"], gauss=sizes["gauss"])


def host_camera_shard(cameras: List, mesh: Mesh, round_robin: bool = True) -> List:
    """This rank's data group's cameras (it decodes only its own images)."""
    i, n = mesh.d, mesh.shape["data"]
    if n == 1:
        return list(cameras)
    return list(cameras[i::n]) if round_robin else list(
        cameras[i * len(cameras) // n:(i + 1) * len(cameras) // n])


def host_batch_slice(n_items: int, mesh: Mesh) -> slice:
    """This rank's contiguous slice of a global batch axis of n_items, in
    the data axis's order."""
    per = n_items // mesh.shape["data"]
    return slice(mesh.d * per, (mesh.d + 1) * per)


def to_host(mesh: Mesh, state, aux):
    """The whole (state, aux) on every rank, the gauss shards gathered in
    row order; the caller then writes it from rank 0 only."""
    from .sharded import gather_train_state
    return gather_train_state(mesh, state, aux)


# --- a world on one host, from Python --------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, world, port, backend, timeout_s, args, queue):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    try:
        initialize_multihost(backend, timeout_s=timeout_s)
        queue.put((rank, True, fn(rank, world, *args)))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the parent, which raises
        queue.put((rank, False, traceback.format_exc()))
        raise


def spawn_world(fn, world: int, *, backend: str = "gloo", args=(), deadline_s: float = 120.0,
                timeout_s: float = 60.0) -> list:
    """Run fn(rank, world, *args) in `world` spawned processes that form one
    torch.distributed world (MASTER_PORT bound from port 0) and return the
    ranks' results in rank order. fn must be importable by name. Raises
    RuntimeError when a rank raises or the world misses `deadline_s`; every
    child still running is then killed. Collectives time out after
    `timeout_s` (init_process_group's timeout)."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world, port, backend, timeout_s, args, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    end = time.monotonic() + deadline_s

    def take(timeout):
        rank, ok, value = q.get(timeout=timeout)
        (results if ok else errors)[rank] = value

    try:
        # until every rank reported, one failed, one died without a word, or
        # the deadline passed
        while len(results) < world and not errors and time.monotonic() < end:
            try:
                take(min(end - time.monotonic(), 1.0))
            except queue_mod.Empty:
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
        while True:   # what the pipe still holds (a failed rank's traceback)
            try:
                take(0.5)
            except queue_mod.Empty:
                break
        # ranks that all reported leave the world; the others are killed
        wait = 10.0 if len(results) == world else 0.1
        for p in procs:
            p.join(timeout=max(0.1, min(wait, end - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    if errors:
        raise RuntimeError("ranks failed:\n" + "\n".join(
            f"--- rank {r}\n{tb}" for r, tb in sorted(errors.items())))
    if len(results) < world:
        missing = sorted(set(range(world)) - set(results))
        raise RuntimeError(f"ranks {missing} did not finish within {deadline_s} s "
                           f"(exit codes {[p.exitcode for p in procs]})")
    return [results[r] for r in range(world)]
