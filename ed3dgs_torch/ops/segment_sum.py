"""CSR segment sum of rows: kernels K3 and K8 (port of
ed3dgs_tpu/ops/segment_sum.py, `segment_sum_rows` and
`segment_sum_rows_packed`).

`segment_sum_rows(rows, starts, ends)` returns `out[s] =
rows[starts[s]:ends[s]].sum(0)` for monotone CSR bounds (starts and ends
non-decreasing, starts[s] <= ends[s] <= R); an empty segment gives zeros. It
turns the rasterizer's per-pair gradient rows, un-permuted so that each
Gaussian's pairs are contiguous, into per-Gaussian gradients without a
scatter-add, so the result is deterministic.

The rows are at most 32 floats wide (the pair payload is 26): the TPU
kernel's 128-lane rule and its over-read slack rows (`pad_rows`, `SS_CHUNK`)
are not needed, since the CUDA kernel reads no row outside a segment.

On a CUDA tensor `segment_sum_rows` launches csrc/segment_sum.cu once (a warp
per segment, eight rows in flight; a segment longer than 64 rows summed by
its CTA's eight warps), which sums in float64 and rounds once; on a CPU
tensor it runs `segment_sum_rows_plain`, the difference of float64 prefix
sums, which agrees with it to the float32 rounding.

`segment_sum_rows_gathered(src, idx, starts, ends)` is the same sum over the
rows `src[idx]`, which the kernel reads through the index instead of a
gathered copy; it counts on `segment_sum_rows`'s counter (the same kernel).

K8, `segment_sum_rows_packed`, is the TPU's version of the same function for
rows at most 32 floats wide: it packs four rows into each 128-lane row so
that narrow rows are not padded to 128 lanes. Every row the CUDA kernel takes
is at most 32 wide already, so K8 is bound to the K3 kernel: the same launch,
counted on its own wrapper.
"""

from __future__ import annotations

import torch

from . import cuda_lib

MAX_WIDTH = 32   # one warp lane per column


def segment_sum_rows_plain(rows: torch.Tensor, starts: torch.Tensor,
                           ends: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: float64 prefix sums, differenced at the
    bounds, rounded to float32."""
    zero = torch.zeros((1, rows.shape[1]), dtype=torch.float64, device=rows.device)
    prefix = torch.cat([zero, torch.cumsum(rows.to(torch.float64), dim=0)])
    return (prefix[ends.long()] - prefix[starts.long()]).to(torch.float32)


def segment_sum_rows(rows: torch.Tensor, starts: torch.Tensor,
                     ends: torch.Tensor) -> torch.Tensor:
    """rows [R, F] float32 (F <= 32), starts/ends [S] int32 monotone CSR
    bounds -> [S, F] float32 segment sums."""
    _validate(rows, starts, ends)
    if not rows.is_cuda:
        return segment_sum_rows_plain(rows, starts, ends)
    out = _launch(rows, starts, ends)
    cuda_lib.count_launch(segment_sum_rows)
    return out


segment_sum_rows.launches = 0


def segment_sum_rows_gathered_plain(src: torch.Tensor, idx: torch.Tensor,
                                    starts: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gathered entry: the gather, then K3's."""
    return segment_sum_rows_plain(src[idx.long()], starts, ends)


def segment_sum_rows_gathered(src: torch.Tensor, idx: torch.Tensor, starts: torch.Tensor,
                              ends: torch.Tensor) -> torch.Tensor:
    """src [Rs, F] float32 (F <= 32), idx [R] int32 row ids in [0, Rs),
    starts/ends [S] int32 CSR bounds into idx -> [S, F] float32 sums of the
    rows src[idx[starts[s]:ends[s]]]. On a CUDA tensor the K3 kernel reads
    each row through the index (counted on `segment_sum_rows`)."""
    _validate(src, starts, ends)
    if idx.dim() != 1:
        raise ValueError(f"idx must be 1-D, got shape {tuple(idx.shape)}")
    if not src.is_cuda:
        return segment_sum_rows_gathered_plain(src, idx, starts, ends)
    cuda_lib.check_cuda(idx, "idx", torch.int32, 1)
    out = _launch(src, starts, ends, idx)
    cuda_lib.count_launch(segment_sum_rows)
    return out


def segment_sum_rows_packed(rows: torch.Tensor, starts: torch.Tensor,
                            ends: torch.Tensor) -> torch.Tensor:
    """K8: `segment_sum_rows` for narrow rows (F <= 32), with the JAX
    signature; on a CUDA tensor it launches the K3 kernel, counted here."""
    _validate(rows, starts, ends)
    if not rows.is_cuda:
        return segment_sum_rows_plain(rows, starts, ends)
    out = _launch(rows, starts, ends)
    cuda_lib.count_launch(segment_sum_rows_packed)
    return out


segment_sum_rows_packed.launches = 0


def _validate(rows: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor):
    if rows.dim() != 2 or rows.shape[1] > MAX_WIDTH:
        raise ValueError(f"rows must be [R, F] with F <= {MAX_WIDTH}, got {tuple(rows.shape)}")
    if starts.shape != ends.shape or starts.dim() != 1:
        raise ValueError("starts and ends must be matching 1-D bounds")


def _launch(rows: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
            idx: torch.Tensor = None) -> torch.Tensor:
    cuda_lib.check_cuda(rows, "rows", torch.float32, 2)
    cuda_lib.check_cuda(starts, "starts", torch.int32, 1)
    cuda_lib.check_cuda(ends, "ends", torch.int32, 1)
    S, F = starts.shape[0], rows.shape[1]
    out = torch.empty((S, F), dtype=torch.float32, device=rows.device)
    lib = cuda_lib.kernels("segment_sum", rows)
    with torch.cuda.device(rows.device):
        if idx is None:
            err = lib.ed3dgs_segment_sum(rows.data_ptr(), starts.data_ptr(), ends.data_ptr(),
                                         out.data_ptr(), S, F, cuda_lib.stream_of(rows))
        else:
            err = lib.ed3dgs_segment_sum_gathered(
                rows.data_ptr(), idx.data_ptr(), starts.data_ptr(), ends.data_ptr(),
                out.data_ptr(), S, F, cuda_lib.stream_of(rows))
    cuda_lib.check_launch(err, "segment_sum_rows")
    return out
