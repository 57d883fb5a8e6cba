"""The k-NN's test clouds, numpy-seeded, shared by the CPU tests of X1's skip
bound and order (test_torch_knn_cull.py) and its card tests
(test_torch_cuda.py). Imports no JAX.

- uniform: in a box around z = 2;
- duplicated: n // 3 points three times over, shuffled (ties at distance 0);
- cancelling: within ~1e-3 of (60, -40, 90), where |a|^2 + |b|^2 - 2ab
  cancels to rounding noise, often below zero;
- far-shell: uniform, the last 352 rows parked on the far shell, as the KNN
  refresh hands its input to the search;
- clusters: three clusters of very different density (spreads 1e-4, 1e-2
  and 0.5) and a few points between them;
- collinear: points on two axis-parallel lines (boxes flat in two axes);
- offset: uniform, moved to (60, -40, 90), where the rounding margin of
  |a|^2 + |b|^2 - 2ab is ~1e-2;
- margin: pairs whose squared distance lies at the skip bound's rounding
  margin, 8u (|a|^2 + |b|^2), half near (60, -40, 90), half near the far
  shell.
"""

import numpy as np

from ed3dgs_torch.ops import knn

KINDS = ("uniform", "duplicated", "cancelling", "far-shell", "clusters", "collinear",
         "offset", "margin")
SHELL_ROWS = 352
OFFSET = np.float32([60.0, -40.0, 90.0])


def knn_cloud(kind, n, seed=0):
    """[n, 3] float32 points of the named kind."""
    rng = np.random.default_rng(seed)

    def uniform(m):
        return (rng.uniform(-1, 1, (m, 3)) * [1.0, 0.7, 1.5] + [0, 0, 2]).astype(np.float32)
    if kind == "uniform":
        return uniform(n)
    if kind == "duplicated":
        return uniform(n // 3)[rng.permutation(np.repeat(np.arange(n // 3), 3))]
    if kind == "cancelling":
        return OFFSET + rng.uniform(-1e-3, 1e-3, (n, 3)).astype(np.float32)
    if kind == "far-shell":
        pts = uniform(n)
        pts[n - SHELL_ROWS:] = knn.far_shell(n, "cpu").numpy()[n - SHELL_ROWS:]
        return pts
    if kind == "clusters":
        sizes = [n // 3, n // 3, n // 3 - n // 50]
        centres = [(0.3, 0.2, 2.0), (-0.5, 0.0, 1.5), (0.0, 0.0, 2.0)]
        parts = [rng.normal(c, s, (m, 3)) for c, s, m in zip(centres, (1e-4, 1e-2, 0.5), sizes)]
        parts.append(rng.uniform(-1, 1, (n - sum(sizes), 3)) * 2)
        return np.concatenate(parts)[rng.permutation(n)].astype(np.float32)
    if kind == "collinear":
        t = rng.uniform(-1, 1, n).astype(np.float32)
        pts = np.empty((n, 3), np.float32)
        pts[:] = (0.5, -0.3, 2.0)
        pts[: n // 2, 0] = t[: n // 2]
        pts[n // 2:, 2] = 2.0 + t[n // 2:]
        return pts
    if kind == "offset":
        return uniform(n) + OFFSET
    if kind == "margin":
        return margin_pairs(n // 2, rng).reshape(-1, 3)[:n]
    raise ValueError(kind)


def margin_pairs(m, rng):
    """[m, 2, 3] float32 pairs (a, b): a near (60, -40, 90) (first half) or
    near (1e3, 1e3, 1e3), b = a + a random direction whose squared length
    is 0.25 to 4 times 8u (|a|^2 + |b|^2), u = 2^-24."""
    centre = np.where(np.arange(m)[:, None] < m // 2, OFFSET, np.float32(1e3))
    a = (centre + rng.uniform(-1, 1, (m, 3))).astype(np.float32)
    sq = (a.astype(np.float64) ** 2).sum(1)
    r2 = 8 * 2.0 ** -24 * 2 * sq * np.exp(rng.uniform(np.log(0.25), np.log(4.0), m))
    v = rng.normal(size=(m, 3))
    v *= np.sqrt(r2)[:, None] / np.linalg.norm(v, axis=1, keepdims=True)
    return np.stack([a, (a + v).astype(np.float32)], axis=1)
