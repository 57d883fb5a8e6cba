"""The KNN embedding regulariser of ed3dgs_torch (graph preparation, the
plain versions of kernels K6 and K7, the autograd Function) against
ed3dgs_tpu's, both on the CPU, on the problems of
tests/test_knn_loss.py (those with undersized capacity buckets, and the
cache refresh, are in tests/test_torch_knn_overflow.py).

Bounds: the prepared graph exactly (rank order `pi`/`inv`, the overflow
counts, `n_far`, and the effective weight of every (rank, slot), read back
from the JAX graph's blocked `aux_a` rows); the loss at rel 1e-5 and the
gradient at rtol 1e-4 / atol 1e-6 against JAX `knn_loss_fused` in interpret
mode (tests/test_knn_loss.py's bounds).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.ops import knn_loss as jkl
from ed3dgs_tpu.train import losses as jlosses

from ed3dgs_torch.ops import knn_loss as tkl
from ed3dgs_torch.train import losses as tlosses

from test_knn_loss import _problem

# name -> (C, K, E, seed, spatial, identity order, capacity buckets)
CASES = {
    "oracle-50": (50, 5, 32, 50, False, False, {}),
    "oracle-300": (300, 20, 32, 300, False, False, {}),
    "oracle-128-e16": (128, 3, 16, 128, False, False, {}),
    # a width that is no multiple of 4: the card pads it to the kernels' 32
    "oracle-200-e7": (200, 4, 7, 200, False, False, {}),
    "oracle-1200-spatial": (1200, 8, 32, 1200, True, False, {}),
    "identity-order": (260, 6, 32, 9, False, True, {}),
}
# the capacity-bucket cases, held in tests/test_torch_knn_overflow.py
OVERFLOW_CASES = {
    # all three lists overflow: spill_a, spill_b and the far list
    "overflow-256": (2200, 20, 32, 1, False, False,
                     dict(spill_a=256, spill_b=256, far_capacity=256)),
    # spill capacities that do not divide Cp = 3072
    "spill-2048": (2100, 20, 32, 5, False, False,
                   dict(spill_a=2048, spill_b=2048, far_capacity=None)),
    "spill-b-drops": (2200, 20, 32, 7, False, False,
                      dict(spill_a=512, spill_b=256, far_capacity=None)),
    "spill-b-only": (2200, 20, 32, 7, False, False,
                     dict(spill_a=4096, spill_b=256, far_capacity=None)),
}


def problem(name):
    C, K, E, seed, spatial, identity, caps = {**CASES, **OVERFLOW_CASES}[name]
    emb, pts, idx, w, coef = _problem(C, K, E, seed=seed, spatial=spatial)
    return K, emb, None if identity else pts, idx, w, coef, caps


def to_torch(*arrays):
    return [None if a is None else torch.as_tensor(np.asarray(a)) for a in arrays]


@functools.lru_cache(maxsize=None)
def jitted_prepare(_prepare=jkl.prepare_knn_graph, **caps):
    """JAX's prepare_knn_graph compiled for these buckets: the same graph,
    bit for bit, ten times faster on a CPU than op by op."""
    return jax.jit(functools.partial(_prepare, **caps))


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """JAX's graph (rank order, drops, w_eff in rank order) and its fused
    loss and gradient, computed once per case (both compiled)."""
    K, emb, pts, idx, w, coef, caps = problem(name)
    g = jitted_prepare(**caps)(idx, w, coef, pts)
    Cp = g.pi.shape[0]
    na = Cp // 256
    K1p = g.aux_a.shape[0] // na
    w_rank = np.asarray(g.aux_a).reshape(na, K1p, 256).transpose(0, 2, 1).reshape(
        Cp, K1p)[:, 1:K + 1]
    loss, grad = jax.jit(jax.value_and_grad(
        lambda e, g: jkl.knn_loss_fused(e, g, K, True)))(emb, g)
    return dict(pi=np.asarray(g.pi), inv=np.asarray(g.inv), overflow=np.asarray(g.overflow),
                n_far=int(g.n_far), w=w_rank, loss=float(loss), grad=np.asarray(grad))


def torch_graph(name):
    K, emb, pts, idx, w, coef, caps = problem(name)
    return tkl.prepare_knn_graph(*to_torch(idx, w, coef, pts), **caps)


def check_graph(name):
    want = jax_case(name)
    graph = torch_graph(name)
    np.testing.assert_array_equal(graph.pi.numpy(), want["pi"])
    np.testing.assert_array_equal(graph.inv.numpy(), want["inv"])
    np.testing.assert_array_equal(graph.overflow.numpy(), want["overflow"])
    assert int(graph.n_far) == want["n_far"]
    np.testing.assert_array_equal(graph.w.numpy(), want["w"])
    # the reverse adjacency lists each weighted jside edge once, by neighbour rank
    Cp, K = graph.nbr.shape
    assert graph.rev_ptr[0] == 0 and graph.rev_ptr[-1] == graph.rev_pair.shape[0]
    nbr_of = graph.nbr.reshape(-1)[graph.rev_pair.long()]
    counts = (graph.rev_ptr[1:] - graph.rev_ptr[:-1]).long()
    np.testing.assert_array_equal(nbr_of.numpy(),
                                  np.repeat(np.arange(Cp), counts.numpy()))
    assert len(np.unique(graph.rev_pair.numpy())) == graph.rev_pair.shape[0]


def check_loss(name):
    want = jax_case(name)
    K, emb, *_ = problem(name)
    graph = torch_graph(name)
    e = torch.as_tensor(np.asarray(emb)).requires_grad_(True)
    loss = tkl.knn_loss_fused(e, graph, K)
    (grad,) = torch.autograd.grad(3.0 * loss, e)
    assert float(loss) == pytest.approx(want["loss"], rel=1e-5)
    np.testing.assert_allclose(grad.numpy(), 3.0 * want["grad"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", CASES)
def test_prepare_knn_graph_matches_jax(name):
    check_graph(name)


@pytest.mark.parametrize("name", CASES)
def test_knn_loss_fused_matches_jax(name):
    check_loss(name)


def test_knn_loss_matches_the_oracles():
    """Without drops the fused loss is knn_loss_ref's and the trainer
    formula's (embedding_knn_loss, a masked mean), in value and gradient."""
    K, emb, pts, idx, w, coef, caps = problem("oracle-1200-spatial")
    rng = np.random.default_rng(3)
    mask = rng.random(idx.shape[0]) > 0.3
    w = np.asarray(w) * mask[:, None]
    coef = mask / max(mask.sum() * K, 1.0)
    temb, tidx, tw, tcoef, tpts = to_torch(emb, idx, w, np.float32(coef), pts)
    graph = tkl.prepare_knn_graph(tidx, tw, tcoef, tpts)
    value = {}
    for name, fn in (("fused", lambda e: tkl.knn_loss_fused(e, graph, K)),
                     ("ref", lambda e: tkl.knn_loss_ref(e, tidx, tw, tcoef)),
                     ("trainer", lambda e: tlosses.embedding_knn_loss(
                         e, tidx, tw, mask=torch.as_tensor(mask)))):
        e = temb.clone().requires_grad_(True)
        v = fn(e)
        value[name] = (float(v), torch.autograd.grad(v, e)[0].numpy())
    want = float(jlosses.embedding_knn_loss(jnp.asarray(emb), idx, jnp.asarray(w),
                                            mask=jnp.asarray(mask)))
    for name, (v, g) in value.items():
        assert v == pytest.approx(want, rel=1e-5), name
        np.testing.assert_allclose(g, value["ref"][1], rtol=1e-4, atol=1e-6, err_msg=name)


def test_knn_loss_k_mismatch_raises():
    graph = torch_graph("oracle-50")
    with pytest.raises(ValueError, match="prepared with K=5"):
        tkl.knn_loss_fused(torch.zeros(50, 32), graph, 20)


def test_reverse_adjacency_holds_exactly_the_weighted_edges():
    """With buckets that drop nothing, rev_ptr / rev_pair list exactly the
    edges with coef_i w_ik != 0, built here directly from nbr, w and coef,
    each once, by neighbour rank and then pair id; and K7's plain version
    gives the same gradient, bit for bit, as on the adjacency of every edge
    (the edges left out add exactly 0)."""
    rng = np.random.default_rng(7)
    C, K = 1500, 6
    pts = rng.uniform(-1, 1, (C, 3)).astype(np.float32)
    idx = rng.integers(0, C, (C, K))
    w = rng.uniform(0, 1, (C, K)).astype(np.float32)
    w[rng.uniform(size=(C, K)) < 0.2] = 0.0
    mask = rng.uniform(size=C) > 0.15
    coef = (mask / (mask.sum() * K)).astype(np.float32)
    graph = tkl.prepare_knn_graph(torch.as_tensor(idx), torch.as_tensor(w),
                                  torch.as_tensor(coef), torch.as_tensor(pts),
                                  spill_a=1 << 12, spill_b=1 << 12)
    assert int(graph.overflow.sum()) == 0
    Cp = graph.pi.shape[0]
    nbr = graph.nbr.reshape(-1).long().numpy()
    weighted = (graph.w.numpy() != 0) & (graph.coef.numpy() != 0)[:, None]
    want = sorted((int(nbr[p]), p) for p in np.flatnonzero(weighted.reshape(-1)))
    ptr = graph.rev_ptr.long().numpy()
    got = [(j, int(p)) for j in range(Cp) for p in graph.rev_pair.numpy()[ptr[j]:ptr[j + 1]]]
    assert got == want

    emb_r = torch.as_tensor(rng.normal(0, 0.3, (Cp, 32)).astype(np.float32))
    _, de, s = tkl.knn_rows_plain(emb_r, graph.nbr, graph.w, graph.coef)
    every = torch.argsort(graph.nbr.reshape(-1).long(), stable=True)
    every_ptr = torch.searchsorted(graph.nbr.reshape(-1).long()[every], torch.arange(Cp + 1))
    full = tkl.knn_reverse_plain(emb_r, s, de, every_ptr.to(torch.int32), every.to(torch.int32))
    kept = tkl.knn_reverse_plain(emb_r, s, de, graph.rev_ptr, graph.rev_pair)
    assert torch.equal(full, kept)


@pytest.mark.parametrize("E", [8, 20, 31, 48, 100])
def test_zero_padded_table_gives_the_unpadded_chain(E):
    """The card runs an E-wide table through the kernels zero-padded by
    `rank_table` to whole 32-column slabs (32 wide for E < 32, 64 for 48,
    128 for 100). On the plain chain (K6 -> K7) the padded table gives
    the unpadded one's loss, s and dL/de, and exact zeros in the padded
    columns. Bound: rtol 1e-4 (the plain versions' own bound against JAX):
    torch.sum over the padded columns may add in another order than over E, the
    zero columns add exactly 0."""
    rng = np.random.default_rng(E)
    C, K = 700, 6
    pts = torch.as_tensor(rng.uniform(-1, 1, (C, 3)).astype(np.float32))
    idx = torch.as_tensor(rng.integers(0, C, (C, K)))
    w = torch.as_tensor(rng.uniform(0, 1, (C, K)).astype(np.float32))
    mask = rng.uniform(size=C) > 0.2
    coef = torch.as_tensor((mask / (mask.sum() * K)).astype(np.float32))
    graph = tkl.prepare_knn_graph(idx, w * torch.as_tensor(mask)[:, None], coef, pts)
    emb = torch.as_tensor(rng.normal(0, 0.3, (C, E)).astype(np.float32))

    def chain(width):
        emb_r = tkl.rank_table(emb, graph, width)
        assert emb_r.shape == (graph.pi.shape[0], width)
        loss, de, s = tkl.knn_rows_plain(emb_r, graph.nbr, graph.w, graph.coef)
        return loss, s, tkl.knn_reverse_plain(emb_r, s, de, graph.rev_ptr, graph.rev_pair)

    loss, s, grad = chain(E)
    loss_p, s_p, grad_p = chain(tkl.kernel_width(E))
    assert float(loss_p) == pytest.approx(float(loss), rel=1e-4)
    np.testing.assert_allclose(s_p.numpy(), s.numpy(), rtol=1e-4, atol=0)
    np.testing.assert_allclose(grad_p[:, :E].numpy(), grad.numpy(), rtol=1e-4, atol=1e-9)
    assert bool((grad_p[:, E:] == 0).all())
