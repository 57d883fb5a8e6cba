"""Exact k-nearest neighbours of a point cloud (port of ed3dgs_tpu/ops/knn.py).

`knn` gives every point its k nearest other points by pairwise squared
distances, |a|^2 + |b|^2 - 2 a.b; `mean_sqdist_3nn` is the reference's
distCUDA2 (the mean squared distance to the 3 nearest neighbours, which
sizes the initial Gaussian scales). The KNN embedding regulariser's graph
(train/trainer.py `update_knn_cache`) is built from `knn` every
densification refresh, and the tetrahedra mesh's outlier filter
(mesh/tetra.py) takes its neighbours from it.

The JAX package leaves this to XLA (a jitted matmul and top_k, not a Pallas
kernel). On a CUDA tensor `knn` launches X1 (csrc/knn.cu), which forms the
chains with once-rounded float32 fused multiply-adds and keeps each row's
k+1 smallest keys in registers; on a CPU tensor it runs `knn_plain`, plain
PyTorch that computes the same numbers. Both drop the self-match the same
way (`_drop_self`; X1 in its last step). X1 orders the cloud by Morton code
first (`knn_codes`, then `torch.argsort` here) and leaves out the tiles of
that order that provably hold no neighbour; `morton_codes_plain`,
`tile_boxes_plain` and `skip_bound_plain` are that order, the tiles' boxes
and the skip bound in plain PyTorch, for the tests. Two choices keep the
result equal to the JAX package's:

- The squared norms and the inner-dimension-3 cross term are fused
  multiply-add chains, each product and sum rounded once to float32, as XLA
  evaluates this dot and this reduction on the CPU. PyTorch has no such
  fused multiply-add on tensors, so `knn_plain` forms the chains in float64
  (a product of two float32 values is exact there) and rounds once to
  float32: where the float64 sum is inexact and lands on a float32
  rounding midpoint, it first steps towards its exact value (TwoSum), so no
  second rounding ties the other way. Small inputs (the COLMAP loss's
  squared norms) take that step on every element and never wait for the
  device; the large blocks gather their few midpoints first. No matmul is
  used, so the global TF32 flags cannot move a neighbour.
- Neighbours are taken in (distance, index) order: the k+1 smallest of an
  int64 key that holds the distance's order-preserving bits above the
  index, so equal distances (dead slots parked on a far shell) resolve to
  the lower index, as XLA's top_k resolves them.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib


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


def _drop_self(d2: torch.Tensor, idx: torch.Tensor, k: int):
    """The k nearest of each row's k+1, without the row itself: the
    self-match is found by index (distance 0, but equal distances may
    precede it), moved to the end, and the first k kept."""
    index = torch.arange(idx.shape[0], device=idx.device)
    is_self = idx == index[:, None]
    order = torch.argsort(is_self.to(torch.int32), dim=1, stable=True)
    d2 = torch.gather(d2, 1, order)[:, :k]
    idx = torch.gather(idx, 1, order)[:, :k]
    return d2, idx


def knn_plain(points: torch.Tensor, k: int = 3, block_size: int = 1024):
    """`knn` in plain PyTorch, on any device: blocks of `block_size` rows,
    each row's keys against every point, torch.topk of the k+1 smallest."""
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
    return _drop_self(torch.cat(d2s), torch.cat(idxs), k)


MAX_K1 = 32     # X1 keeps at most 32 keys a row (k <= 31)
# X1's tile layout for the plain mirrors below: csrc/knn.cu's T (points a
# tile) and S (tiles a super-tile), and the queries a warp walks the tiles
# for. On the card the wrapper takes them from the library (`layout`);
# tests/test_torch_knn_cull.py holds these equal to the source.
TILE = 128
SUPER = 16
GROUP = 32
MORTON_BITS = 21
_U = 2.0 ** -24  # float32 unit roundoff


def _check_k(n: int, k: int):
    if not 0 <= k < MAX_K1:
        raise ValueError(f"the k-NN kernel keeps at most {MAX_K1} neighbours a point, self "
                         f"included (k + 1 <= {MAX_K1}), got k={k}")
    if n < k + 1:
        raise ValueError(f"k-NN of {n} points at k={k} needs at least k + 1 = {k + 1} points")
    if n >= 1 << 30:
        raise ValueError(f"the k-NN kernel takes fewer than 2^30 points, got {n}")


def kernel_info(k: int) -> dict:
    """The X1 instance that serves k: registers per thread, shared memory
    per CTA, local (spilled) bytes per thread and resident CTAs per SM, as
    the card reports them."""
    _check_k(k + 1, k)
    out = [ctypes.c_int(0) for _ in range(4)]
    err = cuda_lib.lib("knn").ed3dgs_knn_info(k + 1, *(ctypes.addressof(v) for v in out))
    cuda_lib.check_launch(err, "ed3dgs_knn_info")
    return dict(registers=out[0].value, smem_bytes=out[1].value, spill_bytes=out[2].value,
                ctas_per_sm=out[3].value)


def layout(lib=None) -> dict:
    """X1's tile layout as the built library (by default the port's knn
    library) reports it: points a tile, tiles a super-tile, queries a warp."""
    out = [ctypes.c_int(0) for _ in range(3)]
    lib = cuda_lib.lib("knn") if lib is None else lib
    cuda_lib.check_launch(lib.ed3dgs_knn_layout(*(ctypes.addressof(v) for v in out)),
                          "ed3dgs_knn_layout")
    return dict(tile=out[0].value, super=out[1].value, group=out[2].value)


def _as_cloud(points: torch.Tensor) -> torch.Tensor:
    points = points.to(torch.float32).contiguous()
    cuda_lib.check_cuda(points, "points", torch.float32, 2)
    if points.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {tuple(points.shape)}")
    return points


def _codes(points: torch.Tensor, lib) -> torch.Tensor:
    lo, hi = torch.aminmax(points, dim=0)
    codes = torch.empty(points.shape[0], dtype=torch.int64, device=points.device)
    err = lib.ed3dgs_knn_codes(points.data_ptr(), lo.data_ptr(), hi.data_ptr(), codes.data_ptr(),
                               points.shape[0], cuda_lib.stream_of(points))
    cuda_lib.check_launch(err, "knn: Morton codes")
    return codes


def morton_codes(points: torch.Tensor) -> torch.Tensor:
    """[N] int64 Morton codes of [N, 3] points over their box, MORTON_BITS
    an axis: on a CUDA tensor by X1's `knn_codes`, on a CPU tensor by
    `morton_codes_plain`."""
    if not points.is_cuda:
        return morton_codes_plain(points)
    points = _as_cloud(points)
    with torch.cuda.device(points.device):
        return _codes(points, cuda_lib.lib("knn"))


def _launch(points: torch.Tensor, k: int, visits=None, lib=None):
    """X1 on [N, 3] CUDA points: (d2 [N, k], idx [N, k]), each row's k
    nearest other points. `visits`, if given, is a [ceil(N / group), 2]
    int32 tensor that gets each warp's tiles and points scanned. `lib`, if
    given, is another build of csrc/knn.cu to launch (its launches are not
    counted); the scratch is sized by its `layout`."""
    n = points.shape[0]
    dev = points.device
    with torch.cuda.device(dev):
        counted = lib is None
        lib = cuda_lib.kernels("knn", points) if counted else lib
        tiles = layout(lib)
        nt = -(-n // tiles["tile"])
        ns = -(-nt // tiles["super"])
        order = torch.argsort(_codes(points, lib))
        cloud = torch.empty((nt * tiles["tile"], 4), dtype=torch.float32, device=dev)
        orig = torch.empty(nt * tiles["tile"], dtype=torch.int32, device=dev)
        boxes = torch.empty((2 * (nt + ns), 4), dtype=torch.float32, device=dev)
        d2 = torch.empty((n, k), dtype=torch.float32, device=dev)
        idx = torch.empty((n, k), dtype=torch.int64, device=dev)
        err = lib.ed3dgs_knn(points.data_ptr(), order.data_ptr(), cloud.data_ptr(),
                             orig.data_ptr(), boxes.data_ptr(), boxes[2 * nt:].data_ptr(),
                             d2.data_ptr(), idx.data_ptr(),
                             None if visits is None else visits.data_ptr(), n, k + 1,
                             cuda_lib.stream_of(points))
    cuda_lib.check_launch(err, "knn")
    if counted:
        cuda_lib.count_launch(knn)
    return d2, idx


def knn(points: torch.Tensor, k: int = 3, block_size: int = 1024):
    """Exact k-NN for every point, excluding itself.

    points: [N, 3] (N >= k+1). Returns (sqdists [N, k] float32, indices
    [N, k] int64) of the k nearest other points, nearest first. On a CUDA
    tensor X1 (csrc/knn.cu, k + 1 <= 32) finds each row's k+1 nearest,
    self included, and drops the self-match as `_drop_self` does; on a CPU
    tensor `knn_plain` does both (`block_size` sets its blocks; X1's
    result does not depend on it)."""
    if not points.is_cuda:
        return knn_plain(points, k, block_size)
    points = _as_cloud(points)
    _check_k(points.shape[0], k)
    return _launch(points, k)


knn.launches = 0


def tile_visits(points: torch.Tensor, k: int) -> torch.Tensor:
    """X1 on CUDA points as `knn` runs it (one launch, counted), returning
    [ceil(N / group), 2] int32: the tiles and the points each warp scanned
    for its group of queries (`layout`)."""
    points = _as_cloud(points)
    _check_k(points.shape[0], k)
    visits = torch.empty((-(-points.shape[0] // layout()["group"]), 2), dtype=torch.int32,
                         device=points.device)
    _launch(points, k, visits)
    return visits


def morton_codes_plain(points: torch.Tensor, bits: int = MORTON_BITS) -> torch.Tensor:
    """csrc/knn.cu `knn_codes` in plain PyTorch (at MORTON_BITS, the same
    codes): each coordinate's cell (v - lo) * (cells / (hi - lo)) in float32
    over the cloud's box, clamped to [0, cells] (NaN: 0), the three cells'
    bits interleaved, x lowest."""
    points = points.to(torch.float32)
    cells = float(2 ** bits - 1)
    lo, hi = points.amin(0), points.amax(0)
    scale = torch.tensor(cells, dtype=torch.float32, device=points.device) / (hi - lo)
    s = (points - lo) * scale
    cell = torch.where(s >= 0, torch.where(s < cells, s, cells), 0.0).to(torch.int64)
    code = torch.zeros(points.shape[0], dtype=torch.int64, device=points.device)
    for b in range(bits):
        for d in range(3):
            code |= ((cell[:, d] >> b) & 1) << (3 * b + d)
    return code


def sorted_cloud_plain(points: torch.Tensor, bits: int = MORTON_BITS):
    """The cloud in X1's order: ([N, 4] float32 (x, y, z, sq) by Morton
    code, sq the once-rounded chain; [N] int64 original rows)."""
    points = points.to(torch.float32)
    order = torch.argsort(morton_codes_plain(points, bits))
    p = points[order]
    return torch.cat([p, _dot3(p, p)[:, None]], dim=1), order


def tile_boxes_plain(cloud: torch.Tensor, tile: int = TILE):
    """csrc/knn.cu `knn_stage`'s tile boxes of a sorted [N, 4] cloud: (lo
    [nt, 3], hi [nt, 3], the largest sq [nt], NaN where a point of the tile
    is not finite or its sq overflows)."""
    n = cloud.shape[0]
    nt = -(-n // tile)
    pad = torch.full((nt * tile - n, 4), float("nan"), dtype=cloud.dtype, device=cloud.device)
    c = torch.cat([cloud, pad]).view(nt, tile, 4)
    real = (torch.arange(nt * tile, device=cloud.device) < n).view(nt, tile, 1)
    num = real & ~torch.isnan(c)           # fminf and fmaxf pass over a NaN
    lo = torch.where(num, c, float("inf"))[..., :3].amin(1)
    hi = torch.where(num, c, -float("inf")).amax(1)
    bad = (~torch.isfinite(c) & real).any(2).any(1)
    return lo, hi[:, :3], torch.where(bad, float("nan"), hi[:, 3])


def skip_bound_plain(q: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     sqmax: torch.Tensor) -> torch.Tensor:
    """csrc/knn.cu `may_hold`'s bound in plain PyTorch: [Q, nt] float64,
    below every d2 that the once-rounded chain gives between query q[i]
    ((x, y, z, sq), [Q, 4]) and any point of tile t (boxes from
    `tile_boxes_plain`): L - 2u |L|, L = gap^2 - 8u (sq_i + sqmax_t) -
    2^-140, gap the distance from the query to the box. Here each step is
    rounded to float64, nearest; the kernel rounds each step of it in
    float32 towards -inf, so its bound lies at or below this one. X1 skips
    a tile only where the bound exceeds the query's current worst distance
    for every query of its CTA; NaN never exceeds it."""
    q = q.double()
    lo, hi, sqmax = lo.double(), hi.double(), sqmax.double()
    qp = q[:, None, :3]
    g = torch.fmax(torch.fmax(lo[None] - qp, qp - hi[None]), torch.zeros((), dtype=q.dtype))
    g = g * g
    l = ((g[..., 0] + g[..., 1] + g[..., 2])
         - 8.0 * _U * (q[:, None, 3] + sqmax[None]) - 2.0 ** -140)
    return l - 2.0 * _U * l.abs()


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
