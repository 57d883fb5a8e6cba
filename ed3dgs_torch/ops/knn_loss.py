"""The KNN embedding regulariser: kernels K6 and K7 and the graph they run
on (port of ed3dgs_tpu/ops/knn_loss.py).

The loss is  L = sum_ik coef_i * sqrt(w_ik * |e_i - e_j(i,k)|^2 + 1e-20)
over every Gaussian i and each of its K cached neighbours j, with coef_i the
mask and the normalisation (train.py:231-235). `knn_loss_fused` returns L
and computes dL/demb in the same pass; its backward is a scalar multiply.

**The graph.** `prepare_knn_graph` reproduces the JAX package's graph
exactly: the Morton rank order of the positions (`pi`, `inv`), and which
edges it drops. The TPU kernels read a neighbour's embedding row from a
three-block window of ranks or from capacity-bounded spill and far lists;
an edge that does not fit a list is dropped deterministically and the
trainer grows the lists' capacity buckets until the drops fit its coverage
budget. Those lists exist only to avoid gathers on the TPU, so this module
does not build them; it replays the same decisions and keeps their result:

- `w` [Cp, K]: each (rank, slot)'s effective weight, 0 where the spill_a or
  the spill_b list overflowed (the spill_b drop carried back to the slot);
- `jside` edges: an edge feeds dL/de_j unless it is a far edge outside the
  far list (dropped by spill_a, or past the far capacity). Past the far
  capacity the JAX package keeps the edge's weight, so the loss and dL/de_i
  count it while dL/de_j does not; the port does the same;
- `overflow` (spill_a, spill_b, far) and `n_far`, which the trainer reads.

What the Hopper kernels read instead of the TPU tables: neighbour ranks
`nbr` [Cp, K], `w` and `coef` [Cp] in rank order, and the reverse adjacency:
`rev_pair`, the flat ids (i*K + k) of the jside edges with coef_i w_ik != 0
(the others add exactly 0 to dL/de_j) sorted stably by neighbour rank, with
CSR bounds `rev_ptr` [Cp+1] per rank. All of it is built once per refresh,
by plain PyTorch on the graph's device.

**The kernels** (csrc/knn_loss.cu), on the embedding table permuted to rank
order:
- K6 `knn_rows` (replaces `_main_kernel`): per rank row i, the loss terms,
  dL/de_i = sum_k s_ik (e_i - e_j), and s_ik = coef_i w_ik / v_ik per edge;
- K7 `knn_reverse` (replaces `_far_kernel` and the in-window half of
  `_main_kernel`): per rank j, dL/de_j = -sum over in-edges s_ik (e_i - e_j),
  added to K6's dL/de_i of the same rank: the whole gradient row.
The kernels take tables a multiple of 32 wide (a row is split in float4s
over the lanes; a wider row is walked in 32-column slabs), K <= 32 slots
and Cp a multiple of 128; their wrappers raise ValueError for anything
else. Any other embedding width runs on them zero-padded to the next
multiple of 32, which `_run` builds in its rank-order gather
(`rank_table`): a zero column adds exactly 0 to every d2, loss term, s and
gradient, so the kernels compute the E-wide result.
Each has a plain PyTorch version of the same signature: K6 by gather, K7 by
a gather over the reverse adjacency and `segment_sum_rows_plain`. A wrapper
launches its kernel on CUDA tensors and runs the plain version on CPU
tensors. Sums are taken in a fixed order, with no atomics, so two runs on
the same inputs are bit-identical.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import cuda_lib
from .segment_sum import segment_sum_rows_plain

BA = 256            # ranks per Morton block
FB = 1024           # far-list capacity granularity (the TPU far pass's chunk)
EPS = 1e-20         # sqrt epsilon (train/losses.py)
BIG = 2147480000    # sort key past every rank
KERNEL_E = 32       # the kernels' slab width (eight float4s); tables are whole slabs
MAX_K = 32          # neighbour slots the kernels take
ROWS_PER_BLOCK = 128  # K6's rank rows per CTA (csrc/knn_loss.cu R6; K7's 64 divide it)


class KnnGraph(NamedTuple):
    """A prepared KNN graph (built once per cache refresh). Rank space is
    the Morton order of the positions, padded to Cp = C rounded up to 1024."""

    pi: torch.Tensor        # [Cp] int64 rank -> id
    inv: torch.Tensor       # [Cp] int64 id -> rank
    nbr: torch.Tensor       # [Cp, K] int32 neighbour ranks
    w: torch.Tensor         # [Cp, K] float32 effective weights (0 = dropped)
    coef: torch.Tensor      # [Cp] float32 coef in rank order
    rev_ptr: torch.Tensor   # [Cp+1] int32 CSR bounds of each rank's in-edges
    rev_pair: torch.Tensor  # [P] int32 flat pair ids (i*K+k) of the weighted jside edges, by rank
    overflow: torch.Tensor  # [3] int64 dropped counts (spill_a, spill_b, far)
    n_far: torch.Tensor     # [] int64 far pairs the far list had to hold


def _morton_ranks(pts: torch.Tensor, Cp: int, valid: Optional[torch.Tensor] = None):
    """Morton (z-order) rank permutation of [C, 3] points, padded to Cp: 10
    bits an axis, quantized over the `valid` rows' box (dead rows parked on
    the far shell would otherwise collapse the cloud into a few cells);
    pad rows sort stably to the end."""
    C = pts.shape[0]
    if valid is None:
        lo, hi = pts.amin(0), pts.amax(0)
    else:
        inf = torch.tensor(float("inf"), device=pts.device)
        lo = torch.where(valid[:, None], pts, inf).amin(0)
        hi = torch.where(valid[:, None], pts, -inf).amax(0)
        lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))   # all-dead safety
        hi = torch.where(torch.isfinite(hi), hi, torch.ones_like(hi))
    q = torch.clamp((pts - lo) / torch.clamp_min(hi - lo, 1e-12) * 1023.0, 0, 1023)
    q = q.to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    code = torch.cat([code, BIG + torch.arange(Cp - C, device=pts.device)])
    pi = torch.argsort(code, stable=True)
    return pi, _inverse(pi)


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    return inv


def _sort_two_key(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Stable order by (primary, secondary) via two stable argsorts."""
    o1 = torch.argsort(secondary, stable=True)
    o2 = torch.argsort(primary[o1], stable=True)
    return o1[o2]


def _positions_in_block(blk: torch.Tensor, key: torch.Tensor, nb: int, capacity: int):
    """For (blk, key) entries sorted by (blk, key): each entry's position
    among its block's DISTINCT keys, and the count of distinct keys past
    `capacity`. Keys >= BIG are invalid (position 0, never counted)."""
    minus1 = torch.full((1,), -1, dtype=blk.dtype, device=blk.device)
    prev_b = torch.cat([minus1, blk[:-1]])
    prev_k = torch.cat([minus1, key[:-1]])
    valid = key < BIG
    is_new = valid & ((blk != prev_b) | (key != prev_k))
    snew = torch.cumsum(is_new.to(torch.int64), 0)
    starts = torch.searchsorted(blk, torch.arange(nb, device=blk.device), right=False)
    base = torch.cat([snew.new_zeros(1), snew])[starts]
    pos = torch.where(valid, snew - 1 - base[torch.clamp(blk, 0, nb - 1)],
                      torch.zeros_like(snew))
    overflow = ((pos >= capacity) & is_new).sum()
    return pos, overflow


def prepare_knn_graph(idx: torch.Tensor, w: torch.Tensor, coef: torch.Tensor,
                      pts: Optional[torch.Tensor] = None, *,
                      pts_valid: Optional[torch.Tensor] = None,
                      spill_a: int = 512, spill_b: int = 512,
                      far_capacity: Optional[int] = None) -> KnnGraph:
    """Cache-time preparation. idx/w: [C, K]; coef: [C] (the mask and the
    normalisation, loss = sum_ik coef_i sqrt(d2 w + eps)); pts: [C, 3]
    positions for the Morton order (None: identity order); pts_valid: [C]
    bool rows that bound the Morton quantization box.

    spill_a / spill_b / far_capacity are the JAX graph's capacity buckets
    (multiples of 256; far_capacity None: the worst case, exact for any
    input). Each is clamped to what the graph can need (Cp distinct ranks,
    Cp*K pairs), the far capacity rounded up to whole 1024-pair chunks, as
    the JAX package clamps them, and the edges the buckets cannot hold are
    dropped as the JAX graph drops them."""
    dev = idx.device
    C, K = idx.shape
    Cp = C + (-C) % 1024
    na = Cp // BA
    if far_capacity is None:
        far_capacity = Cp * K
    spill_a, spill_b = min(spill_a, Cp), min(spill_b, Cp)
    far_capacity = min(far_capacity, Cp * K)
    FAR = far_capacity + (-far_capacity) % FB      # <= Cp*K: Cp*K is whole chunks
    if spill_a % BA or spill_b % BA:
        raise ValueError(f"spill capacities must be multiples of {BA}, got {spill_a}, {spill_b}")

    idx_pad = torch.cat([idx.to(torch.int64),
                         torch.arange(C, Cp, device=dev)[:, None].expand(Cp - C, K)])
    w_pad = torch.cat([w.to(torch.float32), w.new_zeros((Cp - C, K), dtype=torch.float32)])
    coef_pad = torch.cat([coef.to(torch.float32), coef.new_zeros(Cp - C, dtype=torch.float32)])
    if pts is None:
        pi = torch.arange(Cp, device=dev)
        inv = pi
    else:
        pi, inv = _morton_ranks(pts.to(torch.float32), Cp, pts_valid)

    nbr = inv[idx_pad[pi]]                                   # [Cp, K]
    w_r = w_pad[pi]
    coef_r = coef_pad[pi]

    # far: the neighbour lies outside the (clamped) blocks b-1, b, b+1
    b_of = torch.arange(Cp, device=dev) // BA
    base3 = torch.stack([torch.clamp(b_of - 1, 0, na - 1), b_of,
                         torch.clamp(b_of + 1, 0, na - 1)], 1) * BA       # [Cp, 3]
    off = nbr[:, None, :] - base3[:, :, None]
    far = ~((off >= 0) & (off < BA)).any(1)                  # [Cp, K]

    # spill_a: the distinct far neighbour ranks of each i-block
    slot_b = b_of[:, None].expand(Cp, K).reshape(-1)
    slot_r = torch.where(far, nbr, BIG).reshape(-1)
    order_a = _sort_two_key(slot_b, torch.clamp_max(slot_r, Cp))
    pos_a, ovf_a = _positions_in_block(slot_b[order_a], slot_r[order_a], na, spill_a)
    dropped_a = torch.zeros(Cp * K, dtype=torch.bool, device=dev)
    dropped_a[order_a] = pos_a >= spill_a
    dropped_a = dropped_a.reshape(Cp, K) & far
    w_eff = torch.where(dropped_a, torch.zeros_like(w_r), w_r)

    # the far list, sorted by neighbour rank, holds the first FAR far pairs
    fkey = torch.where(far & ~dropped_a, nbr, BIG).reshape(-1)
    order_f = torch.argsort(fkey, stable=True)
    fj_all = fkey[order_f]
    n_far = (fj_all < BIG).sum()
    ovf_far = torch.clamp_min(n_far - FAR, 0)
    fvalid = torch.arange(FAR, device=dev) < torch.clamp_max(n_far, FAR)
    fj = torch.where(fj_all < BIG, fj_all, Cp - 1)[:FAR]
    fi = (order_f // K)[:FAR]
    bjf = fj // BA

    # spill_b: the distinct far i-ranks of each j-block; a pair it cannot
    # hold is dropped at its (i, k) slot
    fkey_i = torch.where(fvalid, fi, BIG)
    order_b = _sort_two_key(bjf, torch.clamp_max(fkey_i, Cp))
    pos_b, ovf_b = _positions_in_block(bjf[order_b], fkey_i[order_b], na, spill_b)
    dropped_b = torch.zeros(FAR, dtype=torch.bool, device=dev)
    dropped_b[order_b] = pos_b >= spill_b
    w_eff = w_eff.reshape(-1)
    w_eff[order_f[:FAR][dropped_b & fvalid]] = 0.0
    w_eff = w_eff.reshape(Cp, K)

    # dL/de_j edges: in-window pairs and the far list's pairs, less those
    # whose s = coef w / v is exactly 0 (a dead or masked row, a dropped or
    # underflowed weight): each adds exactly 0 to its rank's sum. Dead slots
    # parked on the far shell tie at equal distances and pick the same few
    # neighbours, which would otherwise gather thousands of in-edges each.
    jside = ~far.reshape(-1)
    jside[order_f[:FAR][fvalid]] = True
    jside &= ((w_eff != 0) & (coef_r != 0)[:, None]).reshape(-1)
    rkey = torch.where(jside, nbr.reshape(-1), Cp)
    rev_order = torch.argsort(rkey, stable=True)
    n_rev = int(jside.sum())
    rev_ptr = torch.searchsorted(rkey[rev_order], torch.arange(Cp + 1, device=dev),
                                 right=False)
    return KnnGraph(
        pi=pi, inv=inv, nbr=nbr.to(torch.int32).contiguous(),
        w=w_eff.contiguous(), coef=coef_r.contiguous(),
        rev_ptr=rev_ptr.to(torch.int32), rev_pair=rev_order[:n_rev].to(torch.int32),
        overflow=torch.stack([ovf_a, ovf_b, ovf_far]), n_far=n_far)


# --- K6 and K7 ------------------------------------------------------------------

def knn_rows_plain(emb_r: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                   coef: torch.Tensor):
    """Plain PyTorch version of K6. emb_r [Cp, E] float32 in rank order ->
    (loss [] float32, de [Cp, E] = dL/de_i, s [Cp, K] = coef w / v)."""
    K = nbr.shape[1]
    de = torch.zeros_like(emb_r)
    s = torch.empty_like(w)
    row_loss = torch.zeros_like(coef)
    for k in range(K):          # slot by slot, in the kernel's order
        diff = emb_r - emb_r[nbr[:, k].long()]
        d2 = torch.sum(diff * diff, dim=1)
        v = torch.sqrt(d2 * w[:, k] + EPS)
        row_loss = row_loss + coef * v
        s[:, k] = coef * w[:, k] / v
        de = de + s[:, k, None] * diff
    return torch.sum(row_loss), de, s


def knn_reverse_plain(emb_r: torch.Tensor, s: torch.Tensor, de: torch.Tensor,
                      rev_ptr: torch.Tensor, rev_pair: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7: de + dL/de_j, the latter summed over
    each rank's in-edges (-s_ik (e_i - e_j)) by a segment sum over the
    reverse adjacency. Returns [Cp, E] float32. rev_pair may run past
    rev_ptr[-1] (a list padded to a fixed length): those entries, any pair
    ids in range, are summed into no rank."""
    K, Cp = s.shape[1], emb_r.shape[0]
    pid = rev_pair.long()
    i = pid // K
    # each in-edge's rank j: rev_ptr[j] <= position < rev_ptr[j + 1]
    pos = torch.arange(pid.shape[0], dtype=rev_ptr.dtype, device=rev_ptr.device)
    j = torch.clamp_max(torch.searchsorted(rev_ptr[1:], pos, right=True), Cp - 1)
    rows = -(s.reshape(-1)[pid][:, None] * (emb_r[i] - emb_r[j]))
    return de + segment_sum_rows_plain(rows, rev_ptr[:-1], rev_ptr[1:])


def rank_table(emb: torch.Tensor, graph: KnnGraph, width: int) -> torch.Tensor:
    """emb [C, E] float32 in the graph's rank order, [Cp, width] with
    width >= E: the pad ranks' rows and the columns past E are zeros."""
    C, E = emb.shape
    Cp = graph.pi.shape[0]
    if width == E:
        emb_p = torch.cat([emb.to(torch.float32), emb.new_zeros((Cp - C, E), dtype=torch.float32)])
    else:
        emb_p = emb.new_zeros((Cp, width), dtype=torch.float32)
        emb_p[:C, :E] = emb
    return emb_p[graph.pi].contiguous()


def kernel_width(E: int) -> int:
    """The table width the kernels run an E-wide embedding at: E rounded up
    to whole 32-column slabs."""
    return -(-E // KERNEL_E) * KERNEL_E


def _check_kernel_shape(emb_r: torch.Tensor, K: int):
    """Raise ValueError for a table or slot count the kernels do not take."""
    Cp, E = emb_r.shape
    if E < KERNEL_E or E % KERNEL_E or not 1 <= K <= MAX_K:
        raise ValueError(f"the KNN kernels take E a multiple of {KERNEL_E} (other widths "
                         f"zero-padded by rank_table) and 1 <= K <= {MAX_K}, got E={E}, K={K}")
    if Cp % ROWS_PER_BLOCK:
        raise ValueError(f"the KNN kernels take Cp a multiple of {ROWS_PER_BLOCK}, got {Cp}")
    if emb_r.data_ptr() % 16:
        raise ValueError("emb_r must be 16-byte aligned (the kernels read it as float4)")


def kernel_info(kernel: str, K: int) -> dict:
    """The E = 32 kernels': K6's ("knn_rows", whose shared tiles grow with
    the K slots) or K7's ("knn_reverse") registers per thread, shared memory per CTA, local
    (spilled) bytes per thread and resident CTAs per SM, as the card reports
    them."""
    which = {"knn_rows": 0, "knn_reverse": 1}[kernel]
    out = [ctypes.c_int(0) for _ in range(4)]
    err = cuda_lib.lib("knn_loss").ed3dgs_knn_info(which, K,
                                                   *(ctypes.addressof(v) for v in out))
    cuda_lib.check_launch(err, "ed3dgs_knn_info")
    return dict(registers=out[0].value, smem_bytes=out[1].value, spill_bytes=out[2].value,
                ctas_per_sm=out[3].value)


def knn_rows(emb_r: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor, coef: torch.Tensor):
    """K6: (loss, de, s) as `knn_rows_plain`. Launches csrc/knn_loss.cu on
    CUDA tensors; the loss is the sum of per-CTA partials in CTA order."""
    if not emb_r.is_cuda:
        return knn_rows_plain(emb_r, nbr, w, coef)
    cuda_lib.check_cuda(emb_r, "emb_r", torch.float32, 2)
    cuda_lib.check_cuda(nbr, "nbr", torch.int32, 2)
    cuda_lib.check_cuda(w, "w", torch.float32, 2)
    cuda_lib.check_cuda(coef, "coef", torch.float32, 1)
    Cp, E = emb_r.shape
    K = nbr.shape[1]
    _check_kernel_shape(emb_r, K)
    if tuple(w.shape) != (Cp, K) or nbr.shape[0] != Cp or coef.shape[0] != Cp:
        raise ValueError(f"K6 shapes disagree: emb_r {tuple(emb_r.shape)}, nbr "
                         f"{tuple(nbr.shape)}, w {tuple(w.shape)}, coef {tuple(coef.shape)}")
    de = torch.empty_like(emb_r)
    s = torch.empty_like(w)
    partials = torch.empty(Cp // ROWS_PER_BLOCK, dtype=torch.float32, device=emb_r.device)
    with torch.cuda.device(emb_r.device):
        err = cuda_lib.lib("knn_loss").ed3dgs_knn_rows(
            emb_r.data_ptr(), nbr.data_ptr(), w.data_ptr(), coef.data_ptr(), de.data_ptr(),
            s.data_ptr(), partials.data_ptr(), Cp, E, K, cuda_lib.stream_of(emb_r))
    cuda_lib.check_launch(err, "knn_rows")
    cuda_lib.count_launch(knn_rows)
    return partials.sum(), de, s


knn_rows.launches = 0


def knn_reverse(emb_r: torch.Tensor, s: torch.Tensor, de: torch.Tensor,
                rev_ptr: torch.Tensor, rev_pair: torch.Tensor) -> torch.Tensor:
    """K7: de + dL/de_j as `knn_reverse_plain`. Launches csrc/knn_loss.cu on
    CUDA tensors; each rank's in-edges are summed in order in float64."""
    if not emb_r.is_cuda:
        return knn_reverse_plain(emb_r, s, de, rev_ptr, rev_pair)
    cuda_lib.check_cuda(emb_r, "emb_r", torch.float32, 2)
    cuda_lib.check_cuda(s, "s", torch.float32, 2)
    cuda_lib.check_cuda(de, "de", torch.float32, 2)
    cuda_lib.check_cuda(rev_ptr, "rev_ptr", torch.int32, 1)
    cuda_lib.check_cuda(rev_pair, "rev_pair", torch.int32, 1)
    Cp, E = emb_r.shape
    K = s.shape[1]
    _check_kernel_shape(emb_r, K)
    if de.shape != emb_r.shape or s.shape[0] != Cp or rev_ptr.shape[0] != Cp + 1:
        raise ValueError(f"K7 shapes disagree: emb_r {tuple(emb_r.shape)}, s {tuple(s.shape)}, "
                         f"de {tuple(de.shape)}, rev_ptr {tuple(rev_ptr.shape)}")
    if de.data_ptr() % 16:
        raise ValueError("de must be 16-byte aligned (the kernel reads it as float4)")
    out = torch.empty_like(emb_r)
    with torch.cuda.device(emb_r.device):
        err = cuda_lib.lib("knn_loss").ed3dgs_knn_reverse(
            emb_r.data_ptr(), s.data_ptr(), de.data_ptr(), rev_ptr.data_ptr(),
            rev_pair.data_ptr(), out.data_ptr(), Cp, E, K, cuda_lib.stream_of(emb_r))
    cuda_lib.check_launch(err, "knn_reverse")
    cuda_lib.count_launch(knn_reverse)
    return out


knn_reverse.launches = 0


def _run(emb: torch.Tensor, graph: KnnGraph, k: int):
    K = graph.nbr.shape[1]
    if k != K:
        raise ValueError(
            f"knn_loss_fused called with k={k} but the graph was prepared with K={K} "
            "(neighbor slots would be silently dropped or misread)")
    C, E = emb.shape
    # the kernels' width on the card, whole 32-column slabs (zero columns
    # past E add exactly 0); the plain versions on the CPU take the table as it is
    width = kernel_width(E) if emb.is_cuda else E
    emb_r = rank_table(emb, graph, width)
    loss, de, s = knn_rows(emb_r, graph.nbr, graph.w, graph.coef)
    demb_r = knn_reverse(emb_r, s, de, graph.rev_ptr, graph.rev_pair)
    return loss, demb_r[graph.inv[:C]][:, :E]


class _KnnLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, emb, graph, k):
        loss, demb = _run(emb.detach(), graph, k)
        ctx.save_for_backward(demb)
        return loss

    @staticmethod
    def backward(ctx, g):
        (demb,) = ctx.saved_tensors
        return g * demb, None, None


def knn_loss_fused(emb: torch.Tensor, graph: KnnGraph, k: int) -> torch.Tensor:
    """The KNN loss of emb [C, E] on `graph`, differentiable in emb: the
    forward computes the loss and dL/demb together (K6, K7), the backward
    scales the stored gradient. Raises ValueError if k is not the graph's K."""
    return _KnnLoss.apply(emb, graph, k)


def knn_loss_ref(emb, idx, w, coef):
    """Plain oracle: sum_ik coef_i sqrt(|e_i - e_j|^2 w_ik + eps)."""
    d2 = torch.sum((emb[:, None, :] - emb[idx.long()]) ** 2, dim=-1)
    return torch.sum(coef[:, None] * torch.sqrt(d2 * w + EPS))
