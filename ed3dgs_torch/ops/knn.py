"""Exact k-nearest neighbours of a point cloud (port of ed3dgs_tpu/ops/knn.py).

`knn` gives every point its k nearest other points by blocked pairwise
squared distances, |a|^2 + |b|^2 - 2 a.b; `mean_sqdist_3nn` is the
reference's distCUDA2 (the mean squared distance to the 3 nearest
neighbours, which sizes the initial Gaussian scales). The KNN embedding
regulariser's graph (train/trainer.py `update_knn_cache`) is built from
`knn` every densification refresh.

The JAX package leaves this to XLA (a matmul and top_k), not to a Pallas
kernel, so plain PyTorch computes it here. Two choices keep it equal to the
JAX package's result:

- The squared norms and the inner-dimension-3 cross term are fused
  multiply-add chains, each product and sum rounded once to float32, as XLA
  evaluates this dot and this reduction on the CPU. The chains are formed in
  float64 (a product of two float32 values is exact there) and rounded once
  to float32: where the float64 sum is inexact and lands on a float32
  rounding midpoint, it first steps towards its exact value (TwoSum), so no
  second rounding ties the other way. Small inputs (the COLMAP loss's
  squared norms) take that step on every element and never wait for the
  device; the large blocks gather their few midpoints first. No matmul is used, so the global TF32
  flags cannot move a neighbour.
- Neighbours are taken in (distance, index) order: the k+1 smallest of an
  int64 key that holds the distance's order-preserving bits above the
  index, so equal distances (dead slots parked on a far shell) resolve to
  the lower index, as XLA's top_k resolves them.
"""

from __future__ import annotations

import torch


_MID_MASK = (1 << 29) - 1   # float64 mantissa bits below float32's last
_MID_BITS = 1 << 28         # ... holding exactly half a float32 ulp
# Up to this many elements every one takes the TwoSum step (a few more
# elementwise passes, no wait for the device); above it, in the k-NN's large
# blocks, only the midpoints do, gathered first (one wait a call).
_DENSE_MAX = 1 << 22


def _toward_exact(p: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """s = fl64(p + c) stepped one float64 ulp towards p + c where it is
    inexact; the exact error comes from TwoSum."""
    bb = s - p
    e = (p - (s - bb)) + (c - bb)
    inf = torch.full_like(s, float("inf"))
    return torch.where(e != 0, torch.nextafter(s, torch.where(e > 0, inf, -inf)), s)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c rounded once.

    The product of two float32 values is exact in float64; the float64 sum
    s is not. Where s lies exactly on a float32 rounding midpoint and is
    inexact, it steps one float64 ulp towards the exact sum, so that the
    cast rounds as the exact sum does instead of tying to even. The step
    moves the value only: the gradient is that of a*b + c."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    dense = s.numel() <= _DENSE_MAX
    with torch.no_grad():
        sd, pe, ce = s.detach(), p.detach().expand_as(s), c.detach().expand_as(s)
        mid = (sd.view(torch.int64) & _MID_MASK) == _MID_BITS
        if not dense:
            mid = torch.nonzero(mid, as_tuple=True)
            sd, pe, ce = sd[mid], pe[mid], ce[mid]
        step = _toward_exact(pe, ce, sd) - sd
    if dense:
        return torch.where(mid, s + step, s).float()
    if len(mid[0]):
        s = s.index_put(mid, s[mid] + step)
    return s.float()


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_d a[..., d] * b[..., d] over d = 0, 1, 2 as one fused chain."""
    t = a[..., 0] * b[..., 0]
    t = _fma(a[..., 1], b[..., 1], t)
    return _fma(a[..., 2], b[..., 2], t)


def _order_key(d2: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """int64 key ordered as (d2, index): float32 bits made order-preserving
    (negative values flip their magnitude bits) above a 32-bit index."""
    bits = d2.view(torch.int32)
    bits = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    return (bits << 32) | index


def knn(points: torch.Tensor, k: int = 3, block_size: int = 1024):
    """Exact k-NN for every point, excluding itself.

    points: [N, 3] (N >= k+1). Returns (sqdists [N, k] float32, indices
    [N, k] int64) of the k nearest other points, nearest first."""
    n = points.shape[0]
    points = points.to(torch.float32)
    sq = _dot3(points, points)                                   # [N]
    index = torch.arange(n, device=points.device)
    d2s, idxs = [], []
    for s in range(0, n, block_size):
        block = points[s:s + block_size]
        d2 = (sq[s:s + block_size, None] + sq[None, :]) - 2.0 * _dot3(
            block[:, None, :], points[None, :, :])
        key = torch.topk(_order_key(d2, index), k + 1, dim=1, largest=False).values
        idx = key & 0xFFFFFFFF
        d2s.append(torch.gather(d2, 1, idx))
        idxs.append(idx)
    d2, idx = torch.cat(d2s), torch.cat(idxs)
    # drop the self-match by index (distance 0, but equal distances may
    # precede it): move it to the end and keep the first k
    is_self = idx == index[:, None]
    order = torch.argsort(is_self.to(torch.int32), dim=1, stable=True)
    d2 = torch.gather(d2, 1, order)[:, :k]
    idx = torch.gather(idx, 1, order)[:, :k]
    return d2, idx


def far_shell(n: int, device) -> torch.Tensor:
    """[n, 1] float32: 1e3 + 1e-3 * row, the shell where masked points are
    parked. It stays ~1e3: larger coordinates cancel catastrophically in the
    |a|^2 + |b|^2 - 2ab expansion in float32."""
    return 1e3 + 1e-3 * torch.arange(n, dtype=torch.float32, device=device)[:, None]


def mean_sqdist_3nn(points: torch.Tensor, mask: torch.Tensor | None = None,
                    block_size: int = 1024) -> torch.Tensor:
    """distCUDA2: mean squared distance to the 3 nearest neighbours. With
    `mask`, masked-out points are parked on the far shell (they neither
    query nor serve as neighbours) and get 0."""
    if mask is None:
        d2, _ = knn(points, k=3, block_size=block_size)
        return torch.mean(d2, dim=1)
    big = torch.where(mask[:, None], points.to(torch.float32),
                      far_shell(points.shape[0], points.device))
    d2, _ = knn(big, k=3, block_size=block_size)
    return torch.where(mask, torch.clamp_min(torch.mean(d2, dim=1), 0.0),
                       torch.zeros((), device=points.device))
