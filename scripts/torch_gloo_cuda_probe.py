#!/usr/bin/env python3
"""Which torch.distributed collectives a gloo world takes on CUDA tensors.

    python3 scripts/torch_gloo_cuda_probe.py [--ranks 2] [--mib 8]

Spawns RANKS processes that share cuda:0 in one gloo world and calls
`all_to_all_single`, `all_gather_into_tensor`, `all_reduce` and `broadcast`
on CUDA tensors, on the whole world and on a two-rank subgroup, each checked
against the value it must give. Each call that raises is reported with its
error, not retried another way. For each call that works it also times,
with the host clock around a synchronised call, MIB MiB moved as a CUDA
tensor and as a copy through pinned host memory. Prints one JSON line per
rank and exits non-zero when a rank fails or misses its 120 s deadline.
Needs a GPU.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import socket
import sys
import time
import warnings


def rank_main(rank: int, world: int, port: int, mib: int, q):
    import torch
    import torch.distributed as dist

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda:0")
    sub = dist.new_group([0, 1])
    n = mib * (1 << 20) // 4
    out = {"rank": rank}

    def check(name, fn, want):
        try:
            got = fn()
            torch.cuda.synchronize()
            out[name] = "ok" if torch.equal(got.cpu(), want) else "WRONG"
        except Exception as e:  # noqa: BLE001 - the probe reports every refusal
            out[name] = f"raised {type(e).__name__}: {str(e).splitlines()[0][:160]}"

    def a2a(x_dev, group=None):
        y = torch.empty_like(x_dev)
        dist.all_to_all_single(y, x_dev, group=group)
        return y

    def gather(x_dev, group=None, size=world):
        y = torch.empty((size * x_dev.shape[0],), dtype=x_dev.dtype, device=x_dev.device)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(y, x_dev, group=group)
        return y

    def reduce(x_dev, group=None):
        y = x_dev.clone()
        dist.all_reduce(y, group=group)
        return y

    def bcast(x_dev, group=None):
        y = x_dev.clone()
        dist.broadcast(y, src=0, group=group)
        return y

    base = torch.arange(4 * world, dtype=torch.float32)
    mine = base + 100 * rank
    check("all_to_all_single", lambda: a2a(mine.to(dev)),
          torch.cat([base[4 * rank:4 * rank + 4] + 100 * s for s in range(world)]))
    check("all_gather_into_tensor", lambda: gather(mine.to(dev)),
          torch.cat([base + 100 * s for s in range(world)]))
    check("all_reduce", lambda: reduce(mine.to(dev)),
          base * world + 100 * sum(range(world)))
    check("broadcast", lambda: bcast(mine.to(dev)), base)
    if rank < 2:
        check("all_reduce_subgroup", lambda: reduce(mine.to(dev), sub), base * 2 + 100)
        check("all_to_all_subgroup", lambda: a2a(mine[:8].to(dev), sub),
              torch.cat([base[4 * rank:4 * rank + 4] + 100 * s for s in range(2)]))

    # the same bytes as a CUDA tensor and through pinned host memory
    big = torch.full((n,), float(rank), device=dev)
    pinned = torch.empty((n,), pin_memory=True)
    for name, fn in (("all_reduce", reduce), ("all_to_all_single", a2a)):
        if out.get(name) != "ok":
            continue
        for how in ("cuda", "pinned"):
            ms = []
            for _ in range(4):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if how == "cuda":
                    fn(big)
                else:
                    pinned.copy_(big)
                    r = fn(pinned)
                    big.copy_(r, non_blocking=True)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            out[f"{name}_{how}_ms_{mib}MiB"] = sorted(ms)[1:3]
    q.put(out)
    dist.barrier()
    dist.destroy_process_group()


def main():
    import multiprocessing as mp

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--mib", type=int, default=8)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        sys.exit(1)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, args.ranks, port, args.mib, q))
             for r in range(args.ranks)]
    for p in procs:
        p.start()
    results, deadline = [], time.time() + 120
    while len(results) < args.ranks and time.time() < deadline:
        try:
            results.append(q.get(timeout=1))
        except Exception:  # noqa: BLE001 - queue.Empty: keep waiting
            if any(p.exitcode not in (None, 0) for p in procs):
                break
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.time()))
        if p.is_alive():
            p.kill()
    print(torch.cuda.get_device_name(0), flush=True)
    for r in sorted(results, key=lambda r: r["rank"]):
        print(json.dumps(r), flush=True)
    if len(results) < args.ranks or any(p.exitcode != 0 for p in procs):
        print("a rank failed or missed its deadline", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
