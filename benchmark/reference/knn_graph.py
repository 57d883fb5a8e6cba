"""The KNN regulariser's graph at the capacity buckets the configuration's
coverage target implies: a frozen copy of ed3dgs_torch/ops/knn_loss.py
`prepare_knn_graph` (Morton ranks, the spill and far buckets, the edges
they cannot hold dropped) and of ed3dgs_torch/train/trainer.py
`refresh_knn_cache`'s bucket growth, which the reference reads only for the
effective weight of each (point, neighbour) edge: 0 where it is dropped."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

BA = 256            # ranks per Morton block
FB = 1024           # far-list capacity granularity (the TPU far pass's chunk)
BIG = 2147480000    # sort key past every rank


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



# Default and ceiling capacity buckets of the graph (the program's
# KNN_CAPS_DEFAULT / KNN_CAPS_MAX).
KNN_CAPS_DEFAULT = {"spill_a": 256, "spill_b": 768, "far": 1 << 19}
KNN_CAPS_MAX = {"spill_a": 4096, "spill_b": 8192, "far": 1 << 21}


def _snug_far(demand: int) -> int:
    """The 2^17-granular far bucket that holds 1.25x the demand."""
    return -(-int(demand * 1.25) // (1 << 17)) << 17


def effective_weights(idx, w, coef, pts, valid, caps: dict, coverage_target: float):
    """[C, K] weights of the graph at the buckets a refresh settles on: grow
    them (doubling, the far bucket straight to a snug size, up to
    KNN_CAPS_MAX) until the dropped-edge count fits (1 - coverage_target) x
    alive x K, then shrink an oversized far bucket after three refreshes in
    a row that did not need it. With the tongue graph off the program counts
    the one graph's drops twice (its main and tongue graphs are one), and so
    does this. `caps` is mutated across refreshes, as the program's is."""
    caps.setdefault("_far_quiet", 0)
    C, K = idx.shape
    budget = (1.0 - coverage_target) * max(int(valid.sum()) * K, 1)

    def prepare():
        return prepare_knn_graph(idx, w, coef, pts, pts_valid=valid, spill_a=caps["spill_a"],
                                 spill_b=caps["spill_b"], far_capacity=caps["far"])
    while True:
        g = prepare()
        ovf = (2 * g.overflow).tolist()
        if sum(ovf) <= budget:
            break
        grew = False
        for i, name in enumerate(("spill_a", "spill_b")):
            if ovf[i] > budget / 3 and caps[name] < KNN_CAPS_MAX[name]:
                caps[name] *= 2
                grew = True
        if ovf[2] > budget / 3 and caps["far"] < KNN_CAPS_MAX["far"]:
            caps["far"] = min(max(_snug_far(int(g.n_far)), caps["far"] + (1 << 17)),
                              KNN_CAPS_MAX["far"])
            grew = True
        if not grew:
            break
    want = max(1 << 15, _snug_far(max(int(g.n_far), 1)))
    if want < caps["far"]:
        caps["_far_quiet"] += 1
        if caps["_far_quiet"] >= 3:
            caps["far"], caps["_far_quiet"] = want, 0
            g = prepare()
    else:
        caps["_far_quiet"] = 0
    w_id = torch.zeros((g.pi.shape[0], K), dtype=torch.float32, device=idx.device)
    w_id[g.pi] = g.w
    return w_id[:C], int(g.overflow.sum())
