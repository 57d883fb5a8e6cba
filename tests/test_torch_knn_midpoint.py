"""The k-NN's fused multiply-add chains round once, as XLA's do.

`ops/knn.py::_fma` forms float32 a*b + c from a float64 product (exact) and
a float64 sum; where that sum is inexact and lands on a float32 rounding
midpoint, a second rounding would tie to even and could go the other way.
Held here bit for bit: a five-point cloud whose squared norm 4097^2 + 2^-32
sits on such a midpoint (before the repair, 3 of its 10 distances differed
from the JAX package's `knn`), and `_fma` on thousands of float32 triples
(odd a in (2^12, 2^12.5) make a^2 an exact midpoint; random triples of
mixed scales beside them) against the exact sum, rounded half to even by
Python's `fractions`), on both of `_fma`'s paths: every element stepped
(small inputs, no wait for the device) and the midpoints gathered first
(the k-NN's large blocks). The gradient through stepped midpoints is held to
JAX's bit for bit: the step moves the value, not the gradient.
"""

import math
from fractions import Fraction

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ed3dgs_tpu.ops import knn as jknn

from ed3dgs_torch.ops import knn as tknn


def round_f32(v: Fraction) -> np.float32:
    """The float32 nearest the exact v, ties to even (normal and subnormal)."""
    if v == 0:
        return np.float32(0.0)
    sign, a = (-1, -v) if v < 0 else (1, v)
    e = math.frexp(float(a))[1] - 24            # a / 2^e in [2^23, 2^24), to one step
    while a / Fraction(2) ** e >= 2 ** 24:
        e += 1
    while a / Fraction(2) ** e < 2 ** 23:
        e -= 1
    e = max(e, -149)                            # subnormal spacing
    m = a / Fraction(2) ** e
    n = math.floor(m)
    r = m - n
    if r > Fraction(1, 2) or (r == Fraction(1, 2) and n % 2):
        n += 1
    return np.float32(sign * float(n * Fraction(2) ** e))


def exact_fma(a, b, c) -> np.float32:
    return round_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def test_five_point_cloud_equals_jax_bit_for_bit():
    pts = np.array([[2.0 ** -16, 4097, 0], [0, 4090, 0], [0, 4100, 0], [1, 4095, 0],
                    [0, 4105, 1]], np.float32)
    jd2, jidx = jknn.knn(jnp.asarray(pts), k=2)
    td2, tidx = tknn.knn(torch.as_tensor(pts), k=2)
    np.testing.assert_array_equal(np.asarray(jd2), [[6, 8], [26, 50], [8, 24], [6, 24],
                                                    [24, 64]])
    np.testing.assert_array_equal(td2.numpy(), np.asarray(jd2))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


PATHS = {"dense": 1 << 22, "gathered": 0}   # _DENSE_MAX for each path


@pytest.mark.parametrize("path", sorted(PATHS))
def test_fma_rounds_once_at_midpoints_and_elsewhere(path, monkeypatch):
    monkeypatch.setattr(tknn, "_DENSE_MAX", PATHS[path])
    rng = np.random.default_rng(9)
    a = [np.float32(4097)] * 4
    b = [np.float32(4097)] * 4
    c = [np.float32(2.0 ** -32), np.float32(-(2.0 ** -32)), np.float32(0), np.float32(1)]
    # odd a in (2^12, 2^12.5): a^2 has 25 significant bits, a float32 midpoint
    odd = rng.integers(2049, 2896, 2000) * 2 + 1
    small = (rng.choice([-1.0, 1.0], 2000) * 2.0 ** -rng.integers(1, 60, 2000))
    a += list(odd.astype(np.float32))
    b += list(odd.astype(np.float32) * rng.choice([-1, 1], 2000).astype(np.float32))
    c += list(small.astype(np.float32))
    # random triples of mixed scales
    for scale in (1e-3, 1.0, 1e3):
        a += list((rng.normal(size=1000) * scale).astype(np.float32))
        b += list((rng.normal(size=1000) * scale).astype(np.float32))
        c += list((rng.normal(size=1000) * scale * scale).astype(np.float32))
    a, b, c = (np.asarray(x, np.float32) for x in (a, b, c))
    got = tknn._fma(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
    want = np.array([exact_fma(*t) for t in zip(a, b, c)], np.float32)
    assert got[0] == np.float32(16785410) and got[1] == np.float32(16785408)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # a second rounding moves the midpoint cases whose tie to even goes
    # against c's sign (|c| below a float64 ulp of a^2: about a quarter)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive != want).sum() > 300


@pytest.mark.parametrize("path", sorted(PATHS))
def test_dot3_gradient_at_midpoints_matches_jax(path, monkeypatch):
    """Rows (x, y, z) with odd y in (2^12, 2^12.5) and a small x: y^2 + x^2
    is an inexact midpoint, so the value steps; the gradients of sum(a . a)
    and sum(a . b) equal JAX's (2a; b and a)."""
    monkeypatch.setattr(tknn, "_DENSE_MAX", PATHS[path])
    rng = np.random.default_rng(4)
    n = 64
    a = np.stack([2.0 ** -rng.integers(14, 20, n), rng.integers(2049, 2896, n) * 2 + 1,
                  rng.choice([0.0, 0.5], n)], 1).astype(np.float32)
    a[0] = [2.0 ** -16, 4097, 0]
    b = np.stack([a[:, 0], a[:, 1], rng.normal(size=n)], 1).astype(np.float32)
    ta = torch.as_tensor(a).requires_grad_()
    tb = torch.as_tensor(b).requires_grad_()
    sq = tknn._dot3(ta, ta)
    naive = (a.astype(np.float64) ** 2).sum(1).astype(np.float32)
    assert sq[0] == np.float32(16785410) and (sq.detach().numpy() != naive).sum() > 10
    loss = sq.sum() + tknn._dot3(ta, tb).sum()
    # the step is taken outside autograd: PyTorch builds without a
    # derivative for nextafter raise in backward where it is on the graph
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            todo += [f for f, _ in fn.next_functions]
    assert not [fn for fn in seen if "Nextafter" in type(fn).__name__]
    loss.backward()
    ga, gb = jax.grad(lambda x, y: jnp.sum(jnp.sum(x * x, 1)) + jnp.sum(jnp.sum(x * y, 1)),
                      argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(ta.grad.numpy(), np.asarray(ga))
    np.testing.assert_array_equal(tb.grad.numpy(), np.asarray(gb))
