"""Build and bind the port's CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc for sm_90a into its own shared library with a
plain C interface and loaded with ctypes, at first use. Nothing is built or
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
import functools
import hashlib
import os
import shutil
import subprocess
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

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# library -> {exported C function: argtypes}; every function returns the
# cudaError_t of its launches (0 = success)
SIGNATURES = {
    "binning_scan": {
        # dv, dpk, total, key, state, K, grid_x, num_tiles, rank_bits, b, stream
        "ed3dgs_fused_bin_scans": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "rasterize_forward": {
        # payload, tile_start, tile_count, out, num_tiles, grid_x, gxp,
        # chunk, cap, focal_x, focal_y, half_w, half_h, stream
        "ed3dgs_forward_blend": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _F, _F, _F, _F, _P],
        # chunk, *registers, *shared bytes, *CTAs per SM
        "ed3dgs_forward_blend_info": [_I, _P, _P, _P],
    },
    "rasterize_backward": {
        # payload, tile_start, tile_count, packed, cot, dpay, live_chunks,
        # tchk, ttot, tmed, num_tiles, grid_x, gxp, chunk, cap, focal_x,
        # focal_y, half_w, half_h, stream
        "ed3dgs_backward_blend": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                  _I, _I, _I, _F, _F, _F, _F, _P],
        # chunk, *registers, *shared bytes, *CTAs per SM
        "ed3dgs_backward_blend_info": [_I, _P, _P, _P],
    },
    "segment_sum": {
        # rows, starts, ends, out, S, F, stream
        "ed3dgs_segment_sum": [_P, _P, _P, _P, _I, _I, _P],
        # src, idx, starts, ends, out, S, F, stream
        "ed3dgs_segment_sum_gathered": [_P, _P, _P, _P, _P, _I, _I, _P],
    },
    "relayout": {
        # packed, out, gy, gxp, C, stream
        "ed3dgs_unpack_image": [_P, _P, _I, _I, _I, _P],
        # img, packed, gy, gxp, C, stream
        "ed3dgs_pack_image": [_P, _P, _I, _I, _I, _P],
    },
    "knn_loss": {
        # emb, nbr, w, coef, de, s, partials, Cp, E, K, stream
        "ed3dgs_knn_rows": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        # emb, s, de, rev_ptr, rev_pair, out, Cp, E, K, stream
        "ed3dgs_knn_reverse": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
        # which (0 K6, 1 K7), K, *registers, *shared bytes, *local bytes, *CTAs per SM
        "ed3dgs_knn_info": [_I, _I, _P, _P, _P, _P],
    },
}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}.{h.hexdigest()[:12]}.so"


def build(names=None) -> dict:
    """Compile the named libraries (default: all) that are not built yet, one
    nvcc process per source, all started together. Returns {name: ptxas
    report} for the libraries compiled by this call; raises on any failure."""
    names = list(SIGNATURES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = _lib_path(n).with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, _lib_path(n))  # atomic: concurrent builds agree
        reports[n] = out
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


@functools.cache
def lib(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
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


def zeroed(name: str, nbytes: int, like: torch.Tensor) -> torch.Tensor:
    """A buffer of at least `nbytes` zero bytes on `like`'s device, kept for
    its device and current stream: a kernel that takes it must leave it
    zeroed when it ends, so that the next launch on the stream needs no
    memset. Calls on other streams get buffers of their own."""
    key = (name, like.device, stream_of(like))
    buf = _ZEROED.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = torch.zeros(nbytes, dtype=torch.uint8, device=like.device)
        _ZEROED[key] = buf
    return buf
