#!/usr/bin/env python3
"""Time the port's segment sum (K3, ed3dgs_torch/csrc/segment_sum.cu) and
binning scan (K4, csrc/binning_scan.cu) against variants of their CTA size
and occupancy, on one frame of chip_smoke.py's bench scene, on one NVIDIA
GPU:

    python3 scripts/torch_segment_scan_variants.py [--out DIR] [--iters N]

K3 variants (each summing the pair-gradient rows of the frame through the
inverse pair permutation, as the train step calls it, and on the gathered
rows, K3's own function):
- `port`: the source as it is (a warp per segment, eight rows in flight,
  eight CTAs an SM, a segment longer than 64 rows summed by the CTA's eight
  warps);
- `k3_depth4`, `k3_depth16`: four, sixteen rows in flight;
- `k3_occ6`: held to six CTAs an SM instead of eight (more registers);
- `k3_long32`: the CTA takes segments longer than 32 rows.
K4 variants (the frame's delta streams, bit-exact against the port's keys):
- `port`: 16 slots a thread, 4096 a CTA;
- `k4_items8`: 8 slots a thread, 2048 a CTA;
- `k4_acquire`: acquire loads and release stores of the published words in
  place of relaxed ones.
Yardsticks, by the same method: an empty kernel, and a PyTorch sum and copy
of the rows K3 reads. Diagnostics, timed but not checked (their results are
wrong on purpose): `diag_k4_nolookback` skips the reads of the preceding
tiles' sums; `diag_k4_trace` writes a per-CTA %globaltimer trace (start,
tile taken, tile scanned, prefix added, end) after one cold launch and
reports the span, each phase's microseconds a CTA (mean, 90th percentile)
and the CTAs resident on average.

Each variant is built by exact-text substitution in the source, compiled
with the port's nvcc flags into the git-ignored build directory, checked
(K3 within 1e-6 of the largest output of the plain version, K4 bit-exact)
and timed by CUDA events through its C entry point: cold, one launch at a
time after an L2 flush with the ~1 ms spin (chip_smoke.time_ms, the kernels
line's method), and warm, N launches back to back. Variants are timed in
the order port, the others, port. Writes DIR/segment_scan_variants.json and
prints the card as nvidia-smi names it. An edit that moves a substituted
line makes this script raise: update its snippets.
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

K3_VARIANTS = {
    "port": [],
    "k3_depth4": [("constexpr int DEPTH = 8;", "constexpr int DEPTH = 4;")],
    "k3_depth16": [("constexpr int DEPTH = 8;", "constexpr int DEPTH = 16;")],
    "k3_occ6": [("__launch_bounds__(THREADS, 8)", "__launch_bounds__(THREADS, 6)")],
    "k3_long32": [("constexpr int LONG = 64;", "constexpr int LONG = 32;")],
}
K4_VARIANTS = {
    "port": [],
    "k4_items8": [("constexpr int ITEMS = 16;", "constexpr int ITEMS = 8;")],
    "k4_acquire": [("ld.relaxed.gpu.global.u64", "ld.acquire.gpu.global.u64"),
                   ("st.relaxed.gpu.global.u64", "st.release.gpu.global.u64")],
    "diag_k4_nolookback": [("for (int t = threadIdx.x; t < tile; t += THREADS) {",
                            "for (int t = threadIdx.x; t < 0; t += THREADS) {")],
}
K4_TILE = {"k4_items8": 2048}
# a per-CTA trace of %globaltimer (a diagnostic variant): K4 at its start,
# once it has its tile, once the tile is scanned, once the prefix is added
# and at its end, past the state the entry uses (the script allocates room)
GTIME = ("__device__ __forceinline__ unsigned long long gtime() {\n"
         "  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\n\n")
K4_VARIANTS["diag_k4_trace"] = [
    ("// state: [0] the tile counter", GTIME + "// state: [0] the tile counter"),
    ("  __shared__ int tile_sh;\n",
     "  __shared__ int tile_sh;\n  const unsigned long long t0 = gtime();\n"),
    ("  const int tile = tile_sh;\n",
     "  const int tile = tile_sh;\n  const unsigned long long t1 = gtime();\n"),
    ("  unsigned long long* words = state + 2;\n",
     "  const unsigned long long t2 = gtime();\n  unsigned long long* words = state + 2;\n"),
    ("  if (!in_range) return;\n",
     "  const unsigned long long t3 = gtime();\n  if (!in_range) return;\n"),
    ("        make_int4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);\n}\n",
     "        make_int4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);\n"
     "  if (threadIdx.x == 0) {\n"
     "    unsigned long long* tr = state + 2 + 2L * gridDim.x + 5L * blockIdx.x;\n"
     "    tr[0] = t0; tr[1] = t1; tr[2] = t2; tr[3] = t3; tr[4] = gtime();\n  }\n}\n"),
]


def load_smoke():
    spec = importlib.util.spec_from_file_location("segscan_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def build(cuda_lib, source: str, variants: dict, prefix: str) -> dict:
    """{variant: loaded library}, one nvcc per variant, all at once."""
    text = (cuda_lib.CSRC / source).read_text()
    cuda_lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in variants.items():
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: snippet not found once in {source}: {old!r}")
            src = src.replace(old, new)
        cu = cuda_lib.BUILD_DIR / f"variant_{prefix}_{name}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        cmd = [cuda_lib.nvcc_path(), *cuda_lib.NVCC_FLAGS, f"-I{cuda_lib.CSRC}", "-o", str(so),
               str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{out}")
        print(f"  {prefix}/{name}: " + " | ".join(
            line.strip() for line in out.splitlines() if "registers" in line), flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def bench_frame(torch, smoke):
    """K4's inputs and the binning of one bench frame (chip_smoke.py's scene)."""
    from ed3dgs_torch.config.loader import load_full_config
    from ed3dgs_torch.convert import gaussians_from_numpy
    from ed3dgs_torch.models.deformation import init_deform_params
    from ed3dgs_torch.ops import binning, rasterize
    from ed3dgs_torch.render import raster_config_from_camera, render, settings_from_camera
    cfg = load_full_config(os.path.join(REPO, "configs", "nersemble", "default.py"))
    params, aux = gaussians_from_numpy(smoke.bench_cloud(smoke.N_GAUSS),
                                       capacity=smoke.CAPACITY, device="cuda")
    dparams = init_deform_params(cfg.hidden, seed=0, device="cuda")
    cam = smoke.bench_camera(smoke.WIDTH, smoke.HEIGHT)
    rcfg = raster_config_from_camera(cam, pair_capacity=smoke.PAIR_CAPACITY,
                                     chunk=cfg.opt.raster_chunk)
    seen = {}
    restore = smoke.recorder(seen, binning, "fused_bin_scans", "K4")
    orig = rasterize.bin_rows

    def bin_rows(*a, **k):
        seen["bins"] = orig(*a, **k)
        return seen["bins"]
    rasterize.bin_rows = bin_rows
    try:
        with torch.no_grad():
            render(params, aux, dparams, cfg.hidden, settings_from_camera(cam, time=0.0,
                                                                         device="cuda"),
                   rcfg, torch.zeros(3, device="cuda"), iteration=10 ** 9,
                   sh_degree=cfg.model.sh_degree, kernel_size=cfg.model.kernel_size,
                   disable_filter3d=cfg.model.disable_filter3D,
                   num_down_emb_c=cfg.hidden.min_embeddings,
                   num_down_emb_f=cfg.hidden.min_embeddings)
        torch.cuda.synchronize()
    finally:
        restore()
        rasterize.bin_rows = orig
    return seen["K4"], seen["bins"]


def trace_stats(torch, tr) -> dict:
    """A per-CTA %globaltimer trace [CTAs, stamps] (ns) -> the span, each
    phase's mean and 90th percentile microseconds a CTA, and how many CTAs
    ran at once on average."""
    tr = (tr - tr.min()).double()
    span = float(tr[:, -1].max())
    life = tr[:, -1] - tr[:, 0]
    out = dict(span_us=span / 1e3, ctas=tr.shape[0],
               mean_resident=float(life.sum()) / max(span, 1.0))
    for k in range(1, tr.shape[1]):
        d = tr[:, k] - tr[:, k - 1]
        out[f"phase{k}_us"] = (float(d.mean()) / 1e3, float(torch.quantile(d, 0.9)) / 1e3)
    return out


def warm_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "smoke_out"))
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, REPO)
    from ed3dgs_torch.ops import binning_scan, cuda_lib, rasterize, segment_sum
    smoke = load_smoke()
    card = smoke.card_line()
    print(card, flush=True)
    os.makedirs(args.out, exist_ok=True)
    k3_libs = build(cuda_lib, "segment_sum.cu", K3_VARIANTS, "k3")
    k4_libs = build(cuda_lib, "binning_scan.cu", K4_VARIANTS, "k4")
    ((dv, dpk, total), kw4), bins = bench_frame(torch, smoke)
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    flush = flush_buf.zero_
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": card, "k3": {}, "k4": {}}

    # K3: the frame's pair rows (random values), summed through the inverse
    # of the pair permutation and on the gathered rows
    K = bins.pair_perm.shape[0]
    src = torch.randn(K, 26, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    idx = rasterize._inverse_permutation(bins.pair_perm)
    rows = src[idx.long()]
    st, en = bins.seg_starts, bins.seg_ends
    S, F = st.shape[0], 26
    want = segment_sum.segment_sum_rows_plain(rows, st, en)
    scale = float(want.abs().max())
    lengths = (en - st).double()
    result["segments"] = dict(count=S, rows=int(lengths.sum()), mean=float(lengths.mean()),
                              p99=float(torch.quantile(lengths, 0.99)), max=int(lengths.max()),
                              long_rows_share=float(lengths[lengths > 64].sum() / lengths.sum()))
    print(f"segments: {result['segments']}", flush=True)
    for name in ["port", *[n for n in K3_VARIANTS if n != "port"], "port"]:
        lib = k3_libs[name]
        lib.ed3dgs_segment_sum.argtypes = [P, P, P, P, I, I, P]
        lib.ed3dgs_segment_sum_gathered.argtypes = [P, P, P, P, P, I, I, P]
        out = torch.empty(S, F, device="cuda")

        def gathered():
            lib.ed3dgs_segment_sum_gathered(src.data_ptr(), idx.data_ptr(), st.data_ptr(),
                                            en.data_ptr(), out.data_ptr(), S, F, stream)

        def on_rows():
            lib.ed3dgs_segment_sum(rows.data_ptr(), st.data_ptr(), en.data_ptr(),
                                   out.data_ptr(), S, F, stream)
        errs = []
        for fn in (gathered, on_rows):
            out.fill_(float("nan"))
            fn()
            torch.cuda.synchronize()
            errs.append(float((out - want).abs().max()))
        if not max(errs) <= 1e-6 * scale:
            raise RuntimeError(f"K3 variant {name} disagrees with the plain version: {errs}")
        r = dict(gathered_cold=smoke.time_ms(torch, gathered, args.iters, flush),
                 rows_cold=smoke.time_ms(torch, on_rows, args.iters, flush),
                 gathered_warm=warm_ms(torch, gathered, args.iters),
                 rows_warm=warm_ms(torch, on_rows, args.iters), max_abs_err=max(errs))
        result["k3"].setdefault(name, []).append(r)
        print(f"K3 {name:18s} " + " ".join(f"{k} {v:.5f}" for k, v in r.items()), flush=True)

    # yardsticks by the same method: an empty kernel, and one PyTorch read
    # (a sum) and copy of the rows the segments cover
    used = rows[:int(en.max())]
    for name, fn in (("empty_kernel", lambda: torch.cuda._sleep(0)),
                     ("torch_sum_of_rows", lambda: used.sum()),
                     ("torch_copy_of_rows", lambda: used.clone())):
        r = dict(cold=smoke.time_ms(torch, fn, args.iters, flush),
                 warm=warm_ms(torch, fn, args.iters))
        result.setdefault("yardsticks", {})[name] = r
        print(f"yardstick {name}: " + " ".join(f"{k} {v:.5f}" for k, v in r.items()), flush=True)

    # K4 on the frame's delta streams
    want4 = binning_scan.fused_bin_scans_plain(dv, dpk, total, **kw4)
    K4 = dv.shape[0]
    total = total.reshape(1)
    for name in ["port", *[n for n in K4_VARIANTS if n != "port"], "port"]:
        lib = k4_libs[name]
        lib.ed3dgs_fused_bin_scans.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
        tiles = -(-K4 // K4_TILE.get(name, 4096))
        # the state the kernel leaves zeroed, and room for a trace past it
        scratch = torch.zeros(2 + 7 * tiles, dtype=torch.int64, device="cuda")
        key = torch.empty_like(dv)

        def scan():
            lib.ed3dgs_fused_bin_scans(dv.data_ptr(), dpk.data_ptr(), total.data_ptr(),
                                       key.data_ptr(), scratch.data_ptr(), K4, kw4["grid_x"],
                                       kw4["num_tiles"], kw4["rank_bits"], kw4["b"], stream)
        scan()
        torch.cuda.synchronize()
        if not name.startswith("diag_") and not torch.equal(key, want4):
            raise RuntimeError(f"K4 variant {name} is not bit-exact")
        r = dict(cold=smoke.time_ms(torch, scan, args.iters, flush),
                 warm=warm_ms(torch, scan, args.iters),
                 state_left_zero=bool((scratch[:2 + 2 * tiles] == 0).all()))
        if name == "diag_k4_trace":
            flush()
            torch.cuda.synchronize()
            scan()
            torch.cuda.synchronize()
            r["trace"] = trace_stats(torch, scratch[2 + 2 * tiles:].reshape(tiles, 5))
        result["k4"].setdefault(name, []).append(r)
        print(f"K4 {name:18s} " + " ".join(f"{k} {v}" for k, v in r.items()), flush=True)

    with open(os.path.join(args.out, "segment_scan_variants.json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
