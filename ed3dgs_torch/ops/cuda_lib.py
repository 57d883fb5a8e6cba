"""Build and bind the port's native libraries: the CUDA kernels (csrc/*.cu)
and the host image helpers (csrc/png_unfilter.cpp: the PNG unfilter and the
resampling pass of the loaders' resizes).

Each CUDA source is compiled by nvcc for sm_90a, each host source by g++,
into its own shared library with a plain C interface and loaded with
ctypes, at first use. Nothing is built or
loaded when a module is imported, so the CPU tests import every module on a
machine without nvcc. `build()` starts one nvcc per source, all at once.
Libraries land in `csrc/build/` (git-ignored), named by a hash of the source,
the shared headers (`csrc/*.cuh`) and the flags, so an edited source or header
is rebuilt. Every library hashes every header, whether its source includes it
or not: a header edit rebuilds all of them (seconds, in parallel), and no
include has to be traced.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"

# -fmad=false keeps a*b+c as two rounded operations, as the plain PyTorch
# versions compute them, so the blend's `power <= 0` and alpha >= 1/255 masks
# flip only where float ordering genuinely differs; no --use_fast_math (its
# approximate exp2/divide flips those masks, tests/test_rasterize_pallas.py).
# A kernel that wants fused multiply-adds off its mask path writes fmaf().
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# the host libraries' flags: no dependencies beyond the C++ standard library
HOST_FLAGS = ["-std=c++17", "-O3", "-shared", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# library -> {exported C function: argtypes}; every function returns the
# cudaError_t of its launches (0 = success)
SIGNATURES = {
    "binning_scan": {
        "ed3dgs_set_launch_counters": [_P],     # int64 [len(LAUNCH_SLOTS)]
        # dv, dpk, total, key, state, K, grid_x, num_tiles, rank_bits, b, stream
        "ed3dgs_fused_bin_scans": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "rasterize_forward": {
        "ed3dgs_set_launch_counters": [_P],     # int64 [len(LAUNCH_SLOTS)]
        # payload, tile_start, tile_count, out, num_tiles, grid_x, gxp,
        # chunk, cap, focal_x, focal_y, half_w, half_h, stream
        "ed3dgs_forward_blend": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _F, _F, _F, _F, _P],
        # chunk, *registers, *shared bytes, *CTAs per SM
        "ed3dgs_forward_blend_info": [_I, _P, _P, _P],
    },
    "rasterize_backward": {
        "ed3dgs_set_launch_counters": [_P],     # int64 [len(LAUNCH_SLOTS)]
        # payload, tile_start, tile_count, packed, cot, dpay, live_chunks,
        # tchk, ttot, tmed, num_tiles, grid_x, gxp, chunk, cap, focal_x,
        # focal_y, half_w, half_h, stream
        "ed3dgs_backward_blend": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _F, _F, _F, _F, _P],
        # chunk, *registers, *shared bytes, *CTAs per SM
        "ed3dgs_backward_blend_info": [_I, _P, _P, _P],
    },
    "segment_sum": {
        "ed3dgs_set_launch_counters": [_P],     # int64 [len(LAUNCH_SLOTS)]
        # rows, starts, ends, out, S, F, stream
        "ed3dgs_segment_sum": [_P, _P, _P, _P, _I, _I, _P],
        # src, idx, starts, ends, out, S, F, stream
        "ed3dgs_segment_sum_gathered": [_P, _P, _P, _P, _P, _I, _I, _P],
    },
    "relayout": {
        "ed3dgs_set_launch_counters": [_P],     # int64 [len(LAUNCH_SLOTS)]
        # packed, out, gy, gxp, C, stream
        "ed3dgs_unpack_image": [_P, _P, _I, _I, _I, _P],
        # img, packed, gy, gxp, C, stream
        "ed3dgs_pack_image": [_P, _P, _I, _I, _I, _P],
    },
    "knn_loss": {
        "ed3dgs_set_launch_counters": [_P],     # int64 [len(LAUNCH_SLOTS)]
        # emb, nbr, w, coef, de, s, partials, Cp, E, K, stream
        "ed3dgs_knn_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        # emb, s, de, rev_ptr, rev_pair, out, Cp, E, K, stream
        "ed3dgs_knn_reverse": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        # which (0 K6, 1 K7), K, *registers, *shared bytes, *local bytes, *CTAs per SM
        "ed3dgs_knn_info": [_I, _I, _P, _P, _P, _P],
    },
    "knn": {
        "ed3dgs_set_launch_counters": [_P],     # int64 [len(LAUNCH_SLOTS)]
        # points, box lo, box hi, codes, n, stream
        "ed3dgs_knn_codes": [_P, _P, _P, _P, _I, _P],
        # points, order, cloud, orig, tile boxes, super-tile boxes, d2, idx,
        # visits (or null), n, k + 1, stream
        "ed3dgs_knn": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
        # k + 1, *registers, *shared bytes, *local bytes, *CTAs per SM
        "ed3dgs_knn_info": [_I, _P, _P, _P, _P],
        # *points a tile, *tiles a super-tile, *queries a warp
        "ed3dgs_knn_layout": [_P, _P, _P],
    },
    "png_unfilter": {            # host code (csrc/png_unfilter.cpp)
        # filtered rows, out, height, row bytes, bytes per pixel
        "ed3dgs_png_unfilter": [_P, _P, _I, _I, _I],
        # in, out, outer, in size, inner, out size, first taps, weights, taps,
        # fraction bits
        "ed3dgs_resample_axis": [_P, _P, _I, _I, _I, _I, _P, _P, _I, _I],
    },
}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def host_compiler() -> str:
    for cand in (os.environ.get("CXX", ""), shutil.which("g++") or "",
                 shutil.which("c++") or ""):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("no C++ compiler found for the host libraries (set CXX or put g++ "
                       "on PATH)")


def _source(name: str) -> Path:
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _lib_path(name: str) -> Path:
    src = _source(name)
    h = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    else:
        h.update(" ".join(HOST_FLAGS).encode())
    return BUILD_DIR / f"{name}.{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path) -> list:
    src = _source(name)
    if src.suffix == ".cu":
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [host_compiler(), *HOST_FLAGS, "-o", str(out), str(src)]


def build(names=None) -> dict:
    """Compile the named libraries (default: all) that are not built yet, one
    compiler process per source (nvcc for .cu, g++ for .cpp), all started
    together. Returns {name: compiler report (ptxas's for a kernel)} for the
    libraries compiled by this call; raises on any failure."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".tmp{os.getpid()}.{threading.get_ident()}")
        procs[n] = (tmp, subprocess.Popen(_command(n, tmp), stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n} (compiler exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, _lib_path(n))  # atomic: concurrent builds agree
        reports[n] = out
    if failed:
        raise RuntimeError("native library build failed:\n" + "\n".join(failed))
    return reports


_LIBS: dict = {}
_LOAD_LOCK = threading.Lock()


def lib(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed (thread-safe: the
    image decode threads may ask for it together)."""
    handle = _LIBS.get(name)
    if handle is None:
        with _LOAD_LOCK:
            handle = _LIBS.get(name) or _load(name)
            _LIBS[name] = handle
    return handle


def _load(name: str) -> ctypes.CDLL:
    build([name])
    handle = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(handle, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return handle


def check_launch(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int):
    """Validate a tensor handed to a kernel."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_ZEROED = {}
_OUTGROWN = []   # buffers replaced by bigger ones, which a captured graph may still use


def zeroed(name: str, nbytes: int, like: torch.Tensor) -> torch.Tensor:
    """A buffer of at least `nbytes` zero bytes on `like`'s device, kept for
    its device and current stream: a kernel that takes it must leave it
    zeroed when it ends, so that the next launch on the stream needs no
    memset. Calls on other streams get buffers of their own.

    A CUDA graph bakes in the buffer it was captured with, so a buffer is
    never freed, and none is made during a capture (it would live in the
    graph's pool): the captured function must have run once on the capture
    stream first (utils/graphs.py does), or this raises."""
    key = (name, like.device, stream_of(like))
    buf = _ZEROED.get(key)
    if buf is None or buf.numel() < nbytes:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: no zeroed scratch buffer of {nbytes} bytes for this "
                               "stream during a CUDA graph capture: run the function once on "
                               "the capture stream before capturing it")
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = torch.zeros(nbytes, dtype=torch.uint8, device=like.device)
        _ZEROED[key] = buf
    return buf


def count_launch(wrapper):
    """One launch of `wrapper`'s kernel, counted in `wrapper.launches`:
    each wrapper calls this right after its launch. A launch recorded into
    a CUDA graph capture runs nothing and is not counted; the kernels a
    graph replays, which call no wrapper, are counted on the card by
    `DeviceLaunches`."""
    if not torch.cuda.is_current_stream_capturing():
        wrapper.launches += 1


# the launch counters' slots, in the order of csrc/launch_count.cuh
# `LaunchSlot`: the wrapper each kernel counts for. K3's kernel without an
# index counts for K8, as no path calls K3 without one.
LAUNCH_SLOTS = ("rasterize_cuda.rasterize_forward", "rasterize_cuda.rasterize_backward",
                "segment_sum.segment_sum_rows", "segment_sum.segment_sum_rows_packed",
                "binning_scan.fused_bin_scans", "relayout.unpack_image", "relayout.pack_image",
                "knn_loss.knn_rows", "knn_loss.knn_reverse", "knn.knn")
_COUNTERS = {}      # device -> int64 [len(LAUNCH_SLOTS)] on the card, never freed
_ARMED = set()      # (library, device) whose kernels count into _COUNTERS[device]


def kernels(name: str, like: torch.Tensor) -> ctypes.CDLL:
    """The library `name` (built and loaded at first use), its kernels
    counting their launches on `like`'s device: the first call for a device
    makes the device's counters and points the library at them. Like
    `zeroed`, it makes nothing during a CUDA graph capture: the captured
    function must have run once before (utils/graphs.py does)."""
    handle = lib(name)
    dev = like.device
    if (name, dev) not in _ARMED:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{name}: launch counters not set up on {dev} during a CUDA "
                               "graph capture: run the function once before capturing it")
        counters = _COUNTERS.get(dev)
        if counters is None:
            counters = _COUNTERS[dev] = torch.zeros(len(LAUNCH_SLOTS), dtype=torch.int64,
                                                    device=dev)
        with torch.cuda.device(dev):
            check_launch(handle.ed3dgs_set_launch_counters(counters.data_ptr()),
                         f"{name}: ed3dgs_set_launch_counters")
        _ARMED.add((name, dev))
    return handle


class DeviceLaunches:
    """The launches of the port's kernels that ran on the card, read from
    the kernels' own counters (csrc/launch_count.cuh: each kernel adds one
    to its wrapper's slot when it runs), so the kernels of replayed CUDA
    graphs, which call no wrapper, are counted too. `with DeviceLaunches()
    as d: ...`, then `d.counts`: {"module.wrapper": launches} over the
    window; the card synchronises at both ends. `armed` is False where no
    device had counters at the window's end: nothing was measured."""

    def __init__(self):
        self.counts = dict.fromkeys(LAUNCH_SLOTS, 0)
        self.armed = False
        self._start = {}

    def __enter__(self):
        self._start = self._read()
        return self

    def __exit__(self, *exc):
        end = self._read()
        for dev, values in end.items():
            before = self._start.get(dev, [0] * len(LAUNCH_SLOTS))
            for slot, a, b in zip(LAUNCH_SLOTS, before, values):
                self.counts[slot] += b - a
        self.armed = bool(end)

    @staticmethod
    def _read() -> dict:
        for dev in _COUNTERS:
            torch.cuda.synchronize(dev)
        return {dev: c.tolist() for dev, c in _COUNTERS.items()}

