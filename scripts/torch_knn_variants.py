#!/usr/bin/env python3
"""Time the port's KNN-loss kernels (K6 `knn_rows`, K7 `knn_reverse`,
ed3dgs_torch/csrc/knn_loss.cu) against variants with 256-rank CTAs, on the
bench cloud's KNN graph, on one NVIDIA GPU:

    python3 scripts/torch_knn_variants.py [--out DIR] [--iters N] [--baseline DIR]
    python3 scripts/torch_knn_variants.py --wrappers-of TREE [--out DIR]

- `port`: the source as it is (128 K6 rows and 64 K7 ranks a CTA; both
  kernels read every row from L2);
- `k6_256`, `k7_256`: one CTA per 256-rank Morton block, rows from L2 (K7
  at two CTAs per SM, four ranks a group).

Each variant is the source with exact-text substitutions (`VARIANTS`); a
substitution that is not exactly once in knn_loss.cu raises before anything
is built (tests/test_torch_knn_variants_text.py checks the same on the CPU).
The shared-memory window variants (each Morton block's three-block window
of the embedding table staged by cp.async) were measured slower than the
L2 reads for both kernels when they were built, and are gone.

With `--baseline DIR` (a checkout of another tree, say the parent commit),
that tree's knn_loss.cu is built as `baseline` and timed first and last.
Every variant is timed twice, in the order baseline, port, the others, port,
baseline. Each is compiled with the port's nvcc flags into the git-ignored
build directory, run on the graph `refresh_knn_cache` builds for the bench
cloud of chip_smoke.py (100k Gaussians, K = 20, E = 32) at the trainer's
default buckets (K7 of every variant reads the port's K6 output), checked
against the port's kernels (dL/de_i, s and dL/demb within 1e-6 of their
largest values, the loss to 1e-6 relative, since the CTA partials differ
with the CTA size), and timed by CUDA events through its C entry point:
cold, one launch at a time after an L2 flush (chip_smoke.time_ms), and
warm, N launches back to back (the inputs stay in L2, as the table does
inside a train step). Writes DIR/knn_variants.json.

With `--wrappers-of TREE` it times TREE's own `knn_rows` and `knn_reverse`
wrappers (TREE's ed3dgs_torch, its kernels and its graph preparation, on the
same cloud) as chip_smoke.py's kernels line does: host microseconds a call
(chip_smoke.host_us) and cold device time with and without the ~1 ms spin
before the start event (chip_smoke.time_ms), so that two trees' wrappers are
timed by one method. Writes DIR/knn_wrappers.json.

Both modes print the card as nvidia-smi names it.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    """This tree's chip_smoke.py (its bench cloud and timers), by path, so
    that another tree on sys.path does not shadow it."""
    spec = importlib.util.spec_from_file_location("knn_bench_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


K6_256 = [("constexpr int R6 = 128;", "constexpr int R6 = 256;")]
K7_256 = [("constexpr int R7 = 64; ", "constexpr int R7 = 256;"),
          ("constexpr int K7_CTAS = 4;", "constexpr int K7_CTAS = 2;")]
# variant -> ([(text of knn_loss.cu, replacement)], K6's rank rows per CTA)
VARIANTS = {
    "port": ([], 128),
    "k6_256": (K6_256, 256),
    "k7_256": (K7_256, 128),
}


def build_variants(cuda_lib, baseline=None) -> dict:
    """{variant: loaded library}, one nvcc per variant, all at once; with
    `baseline` (a checkout), its knn_loss.cu as the variant "baseline"."""
    src = (cuda_lib.CSRC / "knn_loss.cu").read_text()
    out_dir = cuda_lib.BUILD_DIR / "knn_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name, (subs, _) in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not once in knn_loss.cu")
            text = text.replace(old, new)
        texts[name] = text
    if baseline:
        base_csrc = os.path.join(baseline, "ed3dgs_torch", "csrc")
        texts["baseline"] = open(os.path.join(base_csrc, "knn_loss.cu")).read()
    procs = {}
    for name, text in texts.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        so = out_dir / f"{name}.so"
        include = base_csrc if name == "baseline" else cuda_lib.CSRC
        cmd = [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, f"-I{include}", "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{report}")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
        lib = ctypes.CDLL(str(so))
        for fn in ("ed3dgs_knn_rows", "ed3dgs_knn_reverse"):   # the same in every tree
            getattr(lib, fn).argtypes = cuda_lib.SIGNATURES["knn_loss"][fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def baseline_rows_per_cta(baseline: str) -> int:
    """K6's rank rows per CTA in another checkout (its loss partials)."""
    text = open(os.path.join(baseline, "ed3dgs_torch", "ops", "knn_loss.py")).read()
    return int(re.search(r"^ROWS_PER_BLOCK = (\d+)", text, re.M).group(1))


def bench_graph(torch, smoke):
    """The bench cloud's KNN graph and its embedding table in rank order, by
    the ed3dgs_torch first on sys.path."""
    from ed3dgs_torch.convert import gaussians_from_numpy
    from ed3dgs_torch.train.trainer import KNN_CAPS_DEFAULT, refresh_knn_cache
    fields = smoke.bench_cloud(smoke.N_GAUSS)
    params, aux = gaussians_from_numpy(fields, capacity=smoke.CAPACITY, device="cuda")
    graph = refresh_knn_cache(params, aux, dict(KNN_CAPS_DEFAULT)).graph
    C, E = params.embedding.shape
    Cp = graph.pi.shape[0]
    emb_p = torch.cat([params.embedding, params.embedding.new_zeros((Cp - C, E))])
    return graph, emb_p[graph.pi].contiguous()


def warm_ms(torch, fn, iters: int) -> float:
    """Mean device time of `fn` over `iters` launches queued back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_wrappers(torch, smoke, tree: str, iters: int, out: str):
    """TREE's K6 and K7 wrappers on TREE's graph of the bench cloud."""
    sys.path.insert(0, os.path.abspath(tree))
    from ed3dgs_torch.ops import knn_loss
    print(f"wrappers of {knn_loss.__file__}", flush=True)
    graph, emb_r = bench_graph(torch, smoke)
    loss, de, s = knn_loss.knn_rows(emb_r, graph.nbr, graph.w, graph.coef)
    fns = {"K6": lambda: knn_loss.knn_rows(emb_r, graph.nbr, graph.w, graph.coef),
           "K7": lambda: knn_loss.knn_reverse(emb_r, s, de, graph.rev_ptr, graph.rev_pair)}
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    for kname, fn in fns.items():
        r = dict(host_us=smoke.host_us(torch, fn),
                 cold_ms=smoke.time_ms(torch, fn, iters, flush_buf.zero_),
                 cold_ms_no_spin=smoke.time_ms(torch, fn, iters, flush_buf.zero_, spin=False))
        results[kname] = r
        print(f"  {kname}: host {r['host_us']:.1f} us a call; cold {r['cold_ms']:.5f} ms "
              f"with the spin, {r['cold_ms_no_spin']:.5f} ms without", flush=True)
    with open(os.path.join(out, "knn_wrappers.json"), "w") as f:
        json.dump(dict(card=smoke.card_line(), tree=os.path.abspath(tree),
                       in_edges=int(graph.rev_pair.shape[0]), wrappers=results), f, indent=1)


def time_variants(torch, smoke, baseline, iters: int, out: str):
    sys.path.insert(0, REPO)
    from ed3dgs_torch.ops import cuda_lib, knn_loss

    libs = build_variants(cuda_lib, baseline)
    rows_per_cta = {name: rows for name, (_, rows) in VARIANTS.items()}
    if baseline:
        rows_per_cta["baseline"] = baseline_rows_per_cta(baseline)
    graph, emb_r = bench_graph(torch, smoke)
    Cp, E = emb_r.shape
    K = graph.nbr.shape[1]
    stream = cuda_lib.stream_of(emb_r)
    loss0, de0, s0 = knn_loss.knn_rows(emb_r, graph.nbr, graph.w, graph.coef)
    out0 = knn_loss.knn_reverse(emb_r, s0, de0, graph.rev_ptr, graph.rev_pair)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    launches = {}
    for name, lib in libs.items():
        ctas = -(-Cp // rows_per_cta[name])
        de = torch.empty_like(emb_r)
        s = torch.empty_like(graph.w)
        partials = torch.empty(ctas, dtype=torch.float32, device="cuda")
        out7 = torch.empty_like(emb_r)

        def k6(lib=lib, name=name, de=de, s=s, partials=partials):
            cuda_lib.check_launch(lib.ed3dgs_knn_rows(
                emb_r.data_ptr(), graph.nbr.data_ptr(), graph.w.data_ptr(),
                graph.coef.data_ptr(), de.data_ptr(), s.data_ptr(), partials.data_ptr(),
                Cp, E, K, stream), f"{name} knn_rows")

        def k7(lib=lib, name=name, out7=out7):
            cuda_lib.check_launch(lib.ed3dgs_knn_reverse(
                emb_r.data_ptr(), s0.data_ptr(), de0.data_ptr(), graph.rev_ptr.data_ptr(),
                graph.rev_pair.data_ptr(), out7.data_ptr(), Cp, E, K, stream),
                f"{name} knn_reverse")
        k6()
        k7()
        torch.cuda.synchronize()
        loss_rel = abs(float(partials.sum()) - float(loss0)) / abs(float(loss0))
        rel = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in ((de, de0), (s, s0), (out7, out0)))
        print(f"{name}: {ctas} K6 CTAs; dL/de_i, s and dL/demb (on the port's K6 output) "
              f"max rel diff {rel:.2e}; loss rel diff {loss_rel:.2e}", flush=True)
        if rel > 1e-6 or loss_rel > 1e-6:
            sys.exit(f"torch_knn_variants: variant {name} disagrees with the port's kernels")
        launches[name] = (k6, k7)
    # each timed twice, the baseline first and last: baseline, port, ...,
    # port, baseline
    names = [n for n in launches if n not in ("baseline", "port")]
    order = ["port", *names, "port"]
    if "baseline" in launches:
        order = ["baseline", *order, "baseline"]
    results = {}
    for name in order:
        for kname, fn in zip(("K6", "K7"), launches[name]):
            cold = smoke.time_ms(torch, fn, iters, flush_buf.zero_)
            warm = warm_ms(torch, fn, iters)
            results.setdefault(name, {}).setdefault(kname, []).append(
                dict(cold_ms=cold, warm_ms=warm))
            print(f"  {name} {kname}: cold {cold:.5f} ms, warm {warm:.5f} ms", flush=True)
    with open(os.path.join(out, "knn_variants.json"), "w") as f:
        json.dump(dict(card=smoke.card_line(), Cp=Cp, K=K, E=E,
                       in_edges=int(graph.rev_pair.shape[0]), variants=results), f, indent=1)


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "smoke_out"))
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--baseline", default=None,
                    help="a checkout whose knn_loss.cu is timed first and last, as `baseline`")
    ap.add_argument("--wrappers-of", default=None, metavar="TREE",
                    help="time TREE's K6 and K7 wrappers instead of the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_knn_variants: needs an NVIDIA GPU")
    os.makedirs(args.out, exist_ok=True)
    smoke = load_smoke()
    if args.wrappers_of:
        time_wrappers(torch, smoke, args.wrappers_of, args.iters, args.out)
    else:
        time_variants(torch, smoke, args.baseline, args.iters, args.out)
    print(smoke.card_line(), flush=True)


if __name__ == "__main__":
    main()
