"""X1's tile skip and spatial order (csrc/knn.cu), through their plain
PyTorch mirrors in ed3dgs_torch/ops/knn.py, on the CPU.

X1 orders the cloud by Morton code, cuts that order into tiles of TILE
points (knn.cu's T, checked against the source here), and leaves a tile
out for a warp only where `skip_bound_plain`'s bound exceeds every live
query's current worst distance. That is exact only if the bound never
exceeds a distance the once-rounded chain really gives: for every query and
tile, the bound must lie at or below the smallest chain-computed d2
between the query and the tile's points (`knn_plain`'s `_dot3` emulation,
bit for bit X1's arithmetic). Checked on every cloud of
tests/torch_knn_clouds.py, where the true distances may lie far below
their rounding error (cancelling, far shell, margin), on boxes flat in two
axes (collinear) and on a tile holding points that are not finite (its
bound is NaN: never skipped). Pair by pair, the chain stays within the
bound's margin, 8u (sq_i + sq_j), of the float64 squared distance. The
bound is not vacuous: on the uniform clouds it rules out most tiles
against each query's (k+1)-th distance.

The order: a permutation; with dead slots on the far shell (~1e3), the
21-bit codes keep consecutive live rows close together, which a 10-bit
order over the same box does not (it puts the live points in a few cells).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ed3dgs_torch.ops import knn
from torch_knn_clouds import SHELL_ROWS, knn_cloud

SOURCE = Path(knn.__file__).resolve().parents[1] / "csrc" / "knn.cu"

U = 2.0 ** -24
N = 1536
K = 20


@pytest.mark.parametrize("name,value", [("T", knn.TILE), ("S", knn.SUPER)])
def test_mirror_layout_is_the_kernels(name, value):
    """The plain mirrors' tile layout is knn.cu's, and the library reports
    that layout (`ed3dgs_knn_layout`, which the wrapper sizes its scratch
    by): T points a tile, S tiles a super-tile, knn.GROUP queries a warp."""
    text = SOURCE.read_text()
    assert int(re.search(rf"constexpr int {name} = (\d+);", text).group(1)) == value
    body = re.search(r"ed3dgs_knn_layout\(.*?\{(.*?)\}", text, re.S).group(1)
    assert re.findall(r"\*(\w+) = (\w+);", body) == [
        ("tile", "T"), ("super", "S"), ("group", str(knn.GROUP))]


def chain_d2(cloud):
    """All pairs' d2 of a sorted [n, 4] (x, y, z, sq) cloud, as X1 computes
    them: (sq_i + sq_j) - 2 c_ij, every operation once rounded in float32."""
    p, sq = cloud[:, :3], cloud[:, 3]
    return (sq[:, None] + sq[None, :]) - 2.0 * knn._dot3(p[:, None, :], p[None, :, :])


def per_tile_min(d2, tile=knn.TILE):
    """[n, nt] smallest d2 of each query over each tile's points."""
    n = d2.shape[1]
    nt = -(-n // tile)
    pad = torch.full((d2.shape[0], nt * tile - n), float("inf"), dtype=d2.dtype)
    return torch.cat([d2, pad], dim=1).view(d2.shape[0], nt, tile).amin(-1)


@pytest.mark.parametrize("kind", ["uniform", "duplicated", "cancelling", "far-shell",
                                  "clusters", "collinear", "offset", "margin"])
def test_skip_bound_never_exceeds_the_computed_minimum(kind):
    pts = torch.as_tensor(knn_cloud(kind, N, seed=7))
    cloud, order = knn.sorted_cloud_plain(pts)
    assert torch.equal(torch.sort(order).values, torch.arange(N))
    lo, hi, sqmax = knn.tile_boxes_plain(cloud)
    assert lo.shape == (N // knn.TILE, 3) and not torch.isnan(sqmax).any()
    bound = knn.skip_bound_plain(cloud, lo, hi, sqmax)
    d2 = chain_d2(cloud)
    dmin = per_tile_min(d2).double()
    over = bound > dmin
    assert not over.any(), (f"{int(over.sum())} (query, tile) bounds above the computed "
                            f"minimum, by up to {float((bound - dmin)[over].max())}")
    # pair by pair, the chain within 8u (sq_i + sq_j) of the float64 distance
    p = cloud[:, :3].double()
    exact = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    margin = 8 * U * (cloud[:, 3, None].double() + cloud[None, :, 3].double())
    assert bool((d2.double() >= exact - margin).all())
    # the bound rules tiles out: against each query's (k+1)-th distance,
    # self included (X1's worst once its list is full)
    worst = torch.sort(d2, dim=1).values[:, K].double()
    skipped = float((bound > worst[:, None]).double().mean())
    if kind in ("uniform", "far-shell", "offset", "clusters", "collinear"):
        assert skipped > 0.5, skipped
    if kind == "cancelling":
        assert skipped == 0.0


def test_skip_bound_at_the_margin_pair_by_pair():
    """Pairs whose squared distance lies at 0.25-4 times the bound's
    rounding margin: the bound from one point to a one-point box never
    exceeds the chain's d2, and is positive for some (the margin is not
    over-wide by orders of magnitude)."""
    from torch_knn_clouds import margin_pairs
    pairs = torch.as_tensor(margin_pairs(4096, np.random.default_rng(3)))
    a, b = pairs[:, 0], pairs[:, 1]
    sa, sb = knn._dot3(a, a), knn._dot3(b, b)
    d2 = (sa + sb) - 2.0 * knn._dot3(a, b)
    qa = torch.cat([a, sa[:, None]], 1)
    bound = torch.cat([knn.skip_bound_plain(qa[c], b[c], b[c], sb[c]).diagonal()
                       for c in torch.arange(len(a)).split(256)])
    assert not bool((bound > d2.double()).any())
    assert float((bound > 0).double().mean()) > 0.2


def test_tiles_with_points_not_finite_are_never_skipped():
    """A NaN or an infinite coordinate poisons its tile's box (NaN largest
    sq): every query's bound on it is NaN; a query that is not finite gets
    no finite bound on any tile."""
    pts = knn_cloud("uniform", N, seed=5)
    pts[[10, 700]] = [np.nan, 0.0, 2.0], [np.inf, 0.0, 2.0]
    cloud, order = knn.sorted_cloud_plain(torch.as_tensor(pts))
    lo, hi, sqmax = knn.tile_boxes_plain(cloud)
    rows = [int(torch.nonzero(order == r)) for r in (10, 700)]
    bad = sorted({r // knn.TILE for r in rows})
    assert torch.isnan(sqmax[bad]).all() and int(torch.isnan(sqmax).sum()) == len(bad)
    bound = knn.skip_bound_plain(cloud, lo, hi, sqmax)
    assert torch.isnan(bound[:, bad]).all()
    never = torch.isnan(bound[rows]) | (bound[rows] == -float("inf"))
    assert bool(never.all())


@pytest.mark.parametrize("bits,close", [(knn.MORTON_BITS, True), (10, False)])
def test_morton_order_keeps_live_points_together(bits, close):
    """With the far shell in the box, consecutive live rows of the 21-bit
    order lie within a few mean spacings of each other (median); a 10-bit
    order over the same box fails that."""
    n = 3000
    pts = torch.as_tensor(knn_cloud("far-shell", n, seed=11))
    order = torch.argsort(knn.morton_codes_plain(pts, bits), stable=True)
    assert torch.equal(torch.sort(order).values, torch.arange(n))
    live = order[order < n - SHELL_ROWS]
    assert torch.equal(order[-SHELL_ROWS:], torch.arange(n - SHELL_ROWS, n))
    step = (pts[live[1:]] - pts[live[:-1]]).norm(dim=1)
    spacing = (2.0 * 1.4 * 3.0 / (n - SHELL_ROWS)) ** (1 / 3)
    assert bool(float(step.median()) < 2.0 * spacing) == close, float(step.median()) / spacing


def test_morton_codes_interleave_the_cells():
    """The box's low corner is code 0, its high corner all 63 bits; a point
    at the high end of x alone sets every third bit from bit 0; cells are
    the truncated (v - lo) * (cells / (hi - lo)); a NaN coordinate is cell 0."""
    pts = torch.tensor([[0.0, 0.0, 0.0], [4.0, 2.0, 1.0], [4.0, 0.0, 0.0],
                        [1.0, 0.5, 0.25], [float("nan"), 2.0, 1.0]])
    lo = torch.tensor([0.0, 0.0, 0.0])
    codes = knn.morton_codes_plain(pts[:4]).tolist()
    third = sum(1 << (3 * b) for b in range(21))
    assert codes[0] == 0 and codes[1] == 2 ** 63 - 1 and codes[2] == third
    cells = ((pts[3] - lo) * (torch.tensor(2.0 ** 21 - 1) / torch.tensor([4.0, 2.0, 1.0])))
    want = 0
    for b in range(21):
        for d in range(3):
            want |= ((int(cells[d]) >> b) & 1) << (3 * b + d)
    assert codes[3] == want
    with_nan = knn.morton_codes_plain(pts[1:]).tolist()
    assert with_nan[3] & third == 0      # x: NaN box and cell, cell 0
