#!/usr/bin/env python3
"""Time X1 (the exact k-NN, ed3dgs_torch/csrc/knn.cu) against variants of
its design, on the KNN refresh's input, on one NVIDIA GPU:

    python3 scripts/torch_knn_x1_variants.py [--out DIR] [--iters N] [--variants A,B,...]
    python3 scripts/torch_knn_x1_variants.py --tree TREE [--out DIR] [--iters N]

The input is the refresh's (chip_smoke.py's bench cloud: 100,000 points in
the bench box, 352 dead slots parked on the far shell, k = 20) and a cloud
4x its size (chip_smoke.x1_big_cloud, 401,408 points).

Without `--tree`: each variant of this tree's knn.cu, made by exact-text
substitution (a substitution that no longer matches the source fails the
run), is built with the port's nvcc flags into the git-ignored build
directory (one nvcc each, all at once; ptxas's registers printed), launched
through the wrapper itself (ops/knn.py `_launch`, its scratch sized by the
variant's own `ed3dgs_knn_layout`), checked against `knn_plain` on the
refresh's input by torch.equal (distances and indices), and timed cold
(chip_smoke.time_ms: an L2 flush and a ~1 ms spin before each launch) at
both sizes, beside the tiles a warp visited. Then the shipped wrapper's
call is profiled (torch.profiler, device time by kernel) to split it into
the sort and the kernels. Variants:

- `port`: the source as it is;
- `t64`: 64 points a tile;
- `from0`: the warp's own tile scanned from its first row, not from the
  warp's own rows;
- `count`: the port, but its per-warp counters count the insertion pass:
  how often the warp enters it (any lane) and how often its lanes insert,
  in place of the tiles and points scanned.

With `--tree TREE` (a checkout of another tree, say the parent commit), it
times TREE's own `knn.knn` at both sizes by the same method, so that two
trees can be compared in one call (run it before and after this tree's).
Writes DIR/knn_x1_variants.json or DIR/knn_x1_tree.json. Prints the card as
nvidia-smi names it.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# variant -> [(text of knn.cu, replacement)]
VARIANTS = {
    "port": [],
    "t64": [("constexpr int T = 128;", "constexpr int T = 64;")],
    "from0": [("    const int from = cur == c ? g * 32 % T : 0;", "    const int from = 0;")],
    "count": [("  // offer this lane's list a candidate",
               "  int entries = 0, inserts = 0;\n  // offer this lane's list a candidate"),
              ("      if (below) {\n",
               "      if (below) {\n        ++inserts;\n"
               "        if ((int)__ffs(__activemask()) - 1 == lane) ++entries;\n"),
              ("  if (visits != nullptr && lane == 0) {\n    visits[2 * g] = seen_tiles;\n"
               "    visits[2 * g + 1] = seen_points;\n  }",
               "  if (visits != nullptr) {\n    atomicAdd(visits + 2 * g, entries);\n"
               "    atomicAdd(visits + 2 * g + 1, inserts);\n  }")],
}
K = 20


def load_smoke():
    """This tree's chip_smoke.py (its clouds and timers), by path, so that
    another tree on sys.path does not shadow it."""
    spec = importlib.util.spec_from_file_location("x1_bench_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def clouds(torch, smoke, knn):
    """{name: points on the card}: the refresh's input and the 4x cloud."""
    xyz = torch.as_tensor(smoke.bench_cloud(smoke.N_GAUSS)["xyz"], device="cuda")
    shell = knn.far_shell(smoke.CAPACITY, "cuda")[smoke.N_GAUSS:].expand(-1, 3)
    return {"refresh": torch.cat([xyz, shell]).contiguous(),
            "big": smoke.x1_big_cloud(torch, knn)}


def build_variants(cuda_lib, names) -> dict:
    """{variant: loaded library}, one nvcc per variant, all at once."""
    src = (cuda_lib.CSRC / "knn.cu").read_text()
    out_dir = cuda_lib.BUILD_DIR / "knn_x1_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not once in knn.cu")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"{name}.so"
        cmd = [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, f"-I{cuda_lib.CSRC}", "-o", str(so),
               str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{report}")
        regs = [line.split("Used ")[1].split(",")[0] for line in report.splitlines()
                if "Used" in line and "registers" in line]
        print(f"  {name}: select instances 32, 21, 16, 8, 4, 2: {regs[:6]}", flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in cuda_lib.SIGNATURES["knn"].items():
            if fn != "ed3dgs_set_launch_counters":
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def visit_stats(torch, knn, lib, pts) -> dict:
    """The tiles a warp scanned (mean, max) of all, and the points a warp
    scanned (mean); for `count`, the insertion-pass entries and the inserts
    a warp in their place."""
    tiles = knn.layout(lib)
    nt = -(-pts.shape[0] // tiles["tile"])
    v = torch.zeros((-(-pts.shape[0] // tiles["group"]), 2), dtype=torch.int32, device="cuda")
    knn._launch(pts, K, v, lib)
    v = v.double().cpu()
    return dict(tiles=nt, tiles_mean=float(v[:, 0].mean()), tiles_max=int(v[:, 0].max()),
                points_mean=float(v[:, 1].mean()))


def profile_call(torch, fn) -> dict:
    """{kernel name: device ms a call} over 5 calls of fn."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        dev = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if dev and e.device_type.name == "CUDA":
            out[e.key[:90]] = dev / 1e3 / 5
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "smoke_out"))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--tree", default=None)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    smoke = load_smoke()
    sys.path.insert(0, os.path.abspath(args.tree) if args.tree else REPO)
    import torch
    from ed3dgs_torch.ops import cuda_lib, knn
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    print(card(), flush=True)
    print(f"ed3dgs_torch from {os.path.dirname(knn.__file__)}", flush=True)
    flush_buf = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    pts = clouds(torch, smoke, knn)
    result = {"card": card()}
    if args.tree:
        for name, p in pts.items():
            ms = smoke.time_ms(torch, lambda: knn.knn(p, k=K), args.iters, flush_buf.zero_)
            result[name] = dict(n=p.shape[0], ms=ms)
            print(f"tree {args.tree}: knn.knn on {name} ({p.shape[0]} points) {ms:.4f} ms",
                  flush=True)
        with open(os.path.join(args.out, "knn_x1_tree.json"), "w") as f:
            json.dump(result, f, indent=1)
        return
    libs = build_variants(cuda_lib, args.variants.split(","))
    want = knn.knn_plain(pts["refresh"], k=K)
    for name, lib in libs.items():
        d2, idx = knn._launch(pts["refresh"], K, lib=lib)
        equal = (torch.equal(idx, want[1])
                 and torch.equal(d2.view(torch.int32), want[0].view(torch.int32)))
        row = dict(equal=equal)
        for cname, p in pts.items():
            row[cname] = dict(
                ms=smoke.time_ms(torch, lambda: knn._launch(p, K, lib=lib), args.iters,
                                 flush_buf.zero_),
                **visit_stats(torch, knn, lib, p))
        result[name] = row
        if name == "count":
            print(f"count: a warp enters the insertion pass {row['refresh']['tiles_mean']:.1f} "
                  f"times, its 32 lanes insert {row['refresh']['points_mean']:.1f} times (refresh; "
                  f"big: {row['big']['tiles_mean']:.1f}, {row['big']['points_mean']:.1f})",
                  flush=True)
        print(f"{name}: equal to knn_plain={equal}; refresh {row['refresh']['ms']:.4f} ms, "
              f"tiles {row['refresh']['tiles_mean']:.2f} (max {row['refresh']['tiles_max']}) of "
              f"{row['refresh']['tiles']}; big {row['big']['ms']:.4f} ms, tiles "
              f"{row['big']['tiles_mean']:.2f} (max {row['big']['tiles_max']}) of "
              f"{row['big']['tiles']}", flush=True)
    for cname, p in pts.items():
        prof = profile_call(torch, lambda: knn.knn(p, k=K))
        result[f"profile_{cname}"] = prof
        print(f"the shipped knn on {cname}, device ms a call by kernel:", flush=True)
        for key, ms in prof.items():
            print(f"  {ms:9.4f}  {key}", flush=True)
    with open(os.path.join(args.out, "knn_x1_variants.json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
