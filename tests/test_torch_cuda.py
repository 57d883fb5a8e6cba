"""ed3dgs_torch's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips without a CUDA device. The file imports neither
JAX nor the JAX package, so on a machine without JAX it runs without the
repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: K4, X2, K5a and K5b bit-exact (integer scans; permutations); K4
in one launch, leaving its zeroed state zeroed, also at K = 2^20 + 128 and
128 and on signed bin_rows-like deltas; X2 likewise, at N from 1 to
1,000,003 rows across its 1024-row tiles, with no row holding tiles and with
rows past the capacity; `bin_rows` (X2 then K4) against the CPU's at the
benchmark cells' frame sizes and 200,000 rows, and replayed from a CUDA
graph against eager. K1 at
atol 1e-4 plus rtol 1e-4 on every pixel: the kernel sums and multiplies in
sequence where the plain version uses torch.cumprod and einsum, and the
expected-coordinate channels divide by the blend weight. Only the median
channels may differ beyond that, for a pixel whose transmittance sits at the
0.5 crossing; at most 0.1% of pixels may do so. K2: live-chunk counts
exactly, every row of every tile within 1e-4 of its column's largest value
(the same orders of summation differ), zero where the plain version's is,
and bit-identical from run to run; K1 and K2 are held so on scenes and on
synthetic tiles that probe the warps' row skipping (`blend_case`). K3 and its
gathered entry: within 1e-6 of the largest output (both round an
exact-to-float64 sum once), bit-identical on a rerun, with rows outside
every segment NaN (never summed), empty segments exactly zero, overlapping
segments taken; K8, the same kernel under its own counter, likewise. K6 and K7
(the KNN regulariser) against their plain versions: the loss within 1e-5
relative, every row of dL/demb within 1e-5 of that row's largest value (the
kernel reduces d2 by a shuffle butterfly and the loss by CTA partials; the
terms are otherwise the same operations), and bit-identical from run to run,
also on the smallest table, at a rank with thousands of in-edges and at K = 1
and 32, and for embeddings narrower than 32 or wider (E = 48, 64, 100: run
zero-padded to whole 32-column slabs); the shapes they do not take raise
ValueError. X1 (the k-NN, csrc/knn.cu) against `knn_plain` bit for bit,
distances and indices, on ties, distances below zero, N = k + 1, ragged N,
k from 1 to 31, the KNN refresh's 100,352-point input, clusters,
collinear points, an offset cloud and pairs at the skip bound's margin,
one launch a call and no host-device wait; its Morton codes equal the
plain version's; k + 1 > 32 raises ValueError. The host PNG unfilter (not a kernel, built with g++) against its
numpy version, byte for byte. Beside the kernels, the serving modules that
run on the card: `integrate_points` (K4 bins its tiles) within 1e-5 of the
CPU's, the mesh evaluation's float64 closest points within 1e-6, LPIPS
at the bound of tests/test_lpips.py, and the offline tools' device code:
TSDF fusion (both engines) within 1e-6 with equal blocks and faces, the
mesh-video splatter and the Gaussian-ellipsoid mesh, each also
bit-identical on a rerun. The strip exchange's pieces (parallel/
tile_sharded.py): K1 and K2 at a strip's ray origin (half_w, half_h off the
image centre) under the same rules, and the pack's binning with K4 over 2, 4
and 8 strips (grid_x = 1) and its K3 backward, card against CPU bit for bit
(the sums within 1e-6 of the largest). The captured CUDA graphs
(utils/graphs.py): the graphed train step and frames against their eager
forms, bit for bit, with the kernels a graph runs counted on the card from
the kernels' own launch counters on the card (`cuda_lib.DeviceLaunches`),
since a replay calls no wrapper.
"""

import math
from dataclasses import replace

import numpy as np
import pytest
import torch

from ed3dgs_torch.core.projection import project_gaussians
from ed3dgs_torch.data.cameras import look_at_camera
from ed3dgs_torch.ops import (binning, binning_scan, cuda_lib, knn, knn_loss, rasterize_cuda,
                              relayout, segment_sum)
from ed3dgs_torch.ops.rasterize import RasterConfig, rasterize
from torch_knn_clouds import knn_cloud

pytestmark = pytest.mark.cuda

ATOL, RTOL = 1e-4, 1e-4
MAX_FLIPPED = 1e-3     # fraction of pixels of a median channel
MEDIAN_CHANNELS = [*range(rasterize_cuda.OUT_CHANNELS["mcoord"].start,
                          rasterize_cuda.OUT_CHANNELS["mcoord"].stop),
                   rasterize_cuda.OUT_CHANNELS["mdepth"].start]


def outside(got, want):
    return (got - want).abs() > ATOL + RTOL * want.abs()


def poison_next_block(rows, dev):
    """Fill with NaN the block that the caching allocator hands the next
    [rows, 26] float32 request (K2's output, the wrapper's first allocation)
    and return its address. Freeing the block restores the allocator's state,
    so the same request gets the same block, and a row K2 leaves unwritten
    stays NaN."""
    block = torch.full((rows, 26), float("nan"), device=dev)
    ptr = block.data_ptr()
    del block
    return ptr


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def scene(n, w, h, seed=0):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.7, 0.7, n),
                      rng.uniform(1.5, 4, n)], 1).astype(np.float32)
    scales = np.exp(rng.normal(-3.0, 0.5, (n, 3))).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, n).astype(np.float32)
    shs = rng.normal(0, 0.3, (n, 16, 3)).astype(np.float32)
    tongue = (rng.uniform(0, 1, n) > 0.7).astype(np.float32)
    fov = math.radians(60.0)
    cam = look_at_camera((0, 0, 0), (0, 0, 1), (0, -1, 0), fov, fov * h / w, w, h).matrices()
    return (means, scales, q, opac, shs, tongue), cam


def project(arrays, cam, w, h, device):
    means, scales, q, opac, shs, _ = (torch.as_tensor(a, device=device) for a in arrays)
    return project_gaussians(
        means, scales, q, opac, shs, viewmatrix=torch.as_tensor(cam.world_view, device=device),
        projmatrix=torch.as_tensor(cam.full_proj, device=device),
        campos=torch.as_tensor(cam.campos, device=device), width=w, height=h,
        tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, focal_x=cam.focal_x,
        focal_y=cam.focal_y, kernel_size=0.1, sh_degree=3)


@pytest.mark.parametrize("K,total", [(1 << 14, 9000), (1 << 16, 1 << 16), (4096, 0)])
def test_binning_scan_kernel_matches_plain(dev, K, total):
    rng = np.random.default_rng(K)
    # small non-negative deltas keep every decoded key inside int32
    dv = torch.as_tensor(rng.integers(0, 3, K).astype(np.int32), device=dev)
    dpk = torch.as_tensor(rng.integers(0, 2, K).astype(np.int32), device=dev)
    tot = torch.tensor(total, dtype=torch.int32, device=dev)
    kw = dict(grid_x=4, num_tiles=64, rank_bits=17, b=7)
    before = binning_scan.fused_bin_scans.launches
    got = binning_scan.fused_bin_scans(dv, dpk, tot, **kw)
    torch.cuda.synchronize()
    assert binning_scan.fused_bin_scans.launches == before + 1
    assert torch.equal(got, binning_scan.fused_bin_scans_plain(dv, dpk, tot, **kw))


def bin_deltas(K, seed):
    """dv, dpk as bin_rows writes them: per Gaussian rank a run of slots
    (its tiles) with v = rank << b | (start mod 2^b) and pk = tile_base << 9
    | rect_w, delta-encoded at each run's first slot. The deltas are signed
    (a later rect may start at a lower tile) and their prefix sums are the
    int32 words themselves. Returns dv, dpk, the run ends and kw."""
    rng = np.random.default_rng(seed)
    grid_x, grid_y, b = 51, 35, 11
    lengths = rng.integers(0, 40, K // 8)
    ends = np.cumsum(lengths)
    keep = ends <= K
    lengths, ends = lengths[keep], ends[keep]
    starts = ends - lengths
    rank = np.arange(len(lengths))
    rw = rng.integers(1, 8, len(lengths))
    base = rng.integers(0, grid_x * grid_y - 8 * grid_x, len(lengths))
    v_g = (rank << b) | (starts & ((1 << b) - 1))
    pk_g = (base << 9) | rw
    v = np.zeros(K, np.int64)
    pk = np.zeros(K, np.int64)
    live = lengths > 0
    v[starts[live]] = v_g[live]
    pk[starts[live]] = pk_g[live]
    # each word holds until the next run's first slot
    idx = np.maximum.accumulate(np.where(np.isin(np.arange(K), starts[live]),
                                         np.arange(K), 0))
    v, pk = v[idx], pk[idx]
    dv = np.diff(v, prepend=0).astype(np.int32)
    dpk = np.diff(pk, prepend=0).astype(np.int32)
    assert (dpk < 0).any()
    kw = dict(grid_x=grid_x, num_tiles=grid_x * grid_y, rank_bits=17, b=b)
    return dv, dpk, int(ends[-1]), kw


@pytest.mark.parametrize("K", [1 << 20, (1 << 20) + 128, 128])
@pytest.mark.parametrize("where", ["zero", "all", "mid-tile"])
def test_binning_scan_single_pass_is_bit_exact(dev, K, where):
    """K4's single pass with its decoupled look-back: bit-exact against the
    plain version on bin_rows-like signed deltas, at K a whole number of
    4096-slot tiles, with a partial last tile and below one tile, for
    total 0, K and one in the middle of a tile; one launch a call."""
    dv, dpk, used, kw = bin_deltas(K, seed=K + len(where))
    total = {"zero": 0, "all": K, "mid-tile": min(used, K // 2 + 1234 % (K // 2))}[where]
    dv, dpk = torch.as_tensor(dv, device=dev), torch.as_tensor(dpk, device=dev)
    tot = torch.tensor(total, dtype=torch.int32, device=dev)
    before = binning_scan.fused_bin_scans.launches
    got = binning_scan.fused_bin_scans(dv, dpk, tot, **kw)
    again = binning_scan.fused_bin_scans(dv, dpk, tot, **kw)
    torch.cuda.synchronize()
    assert binning_scan.fused_bin_scans.launches == before + 2
    want = binning_scan.fused_bin_scans_plain(dv, dpk, tot, **kw)
    assert torch.equal(got, want) and torch.equal(again, want)
    # the kernel leaves its tile counter and published words zeroed
    assert not bool(cuda_lib.zeroed("binning_scan", 0, dv).any())


def boundary_rows(n, seed, mask="random", grid_x=51, grid_y=35):
    """X2's inputs as bin_rows hands them over: [n, 5] rows (tile count,
    rect_min, rect_max) and the tile counts' inclusive scan. `mask`
    "random" gives ~60% of the rows tiles, "none" none. Returns rows,
    offsets and a capacity, a multiple of 128, that the pairs overflow once
    they pass 146."""
    rng = np.random.default_rng(seed)
    x0, y0 = rng.integers(0, grid_x, n), rng.integers(0, grid_y, n)
    x1 = np.minimum(x0 + rng.integers(1, 4, n), grid_x)
    y1 = np.minimum(y0 + rng.integers(1, 4, n), grid_y)
    keep = rng.uniform(size=n) < 0.6 if mask == "random" else np.zeros(n, bool)
    tiles = np.where(keep, (x1 - x0) * (y1 - y0), 0)
    offsets = np.cumsum(tiles).astype(np.int32)
    cap = max(128, int(offsets[-1]) * 7 // 8 // 128 * 128)
    return np.stack([tiles, x0, y0, x1, y1], 1).astype(np.int32), offsets, cap


@pytest.mark.parametrize("mask", ["random", "none"])
@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 200_000, 1_000_003])
def test_boundary_deltas_kernel_matches_plain(dev, n, mask):
    """X2's single pass with its max look-back: both delta streams bit for
    bit against the plain version (three torch.cummax), within one 1024-row
    tile, at whole and ragged tile counts, at the main path's 200,000 rows
    and at 1,000,003 (a 20-bit rank beside 11 offset bits), with no row
    holding tiles and with rows past the capacity; one launch a call, by
    its wrapper and on the card, and its state left zeroed after two. The
    first call's outputs land in memory that held other values: X2 writes
    every slot, the wrapper zeroes none."""
    rows, offsets, cap = boundary_rows(n, seed=n, mask=mask)
    rows, offsets = torch.as_tensor(rows, device=dev), torch.as_tensor(offsets, device=dev)
    kw = dict(pair_capacity=cap, grid_x=51, b=11)
    # the caching allocator hands this block to the wrapper's outputs
    torch.full((2, cap), -7, dtype=torch.int32, device=dev)
    before = binning_scan.boundary_deltas.launches
    with cuda_lib.DeviceLaunches() as traced:
        got = binning_scan.boundary_deltas(rows, offsets, **kw)
        again = binning_scan.boundary_deltas(rows, offsets, **kw)
    assert binning_scan.boundary_deltas.launches == before + 2
    assert traced.counts["binning_scan.boundary_deltas"] == 2
    want = binning_scan.boundary_deltas_plain(rows, offsets, **kw)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w)
    if mask == "none":
        assert not bool(want[0].any() or want[1].any())
    elif n > 4096:
        first = (offsets - rows[:, 0])[rows[:, 0] > 0]
        assert bool((first >= cap).any()) and bool((want[1] < 0).any())
    # the kernel leaves its tile counter and published words zeroed
    assert not bool(cuda_lib.zeroed("boundary_deltas", 0, rows).any())


def cell_rows(n, gx, gy, seed):
    """bin_rows' inputs on a grid: depths with ties, ~70% of the rows
    valid, rects of 1-5 tiles a side clamped to the grid."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.5, 5.0, n).astype(np.float32)
    depth[: n // 10] = depth[n // 10: 2 * (n // 10)]
    valid = rng.uniform(size=n) < 0.7
    rmin = np.stack([rng.integers(0, gx, n), rng.integers(0, gy, n)], 1)
    rmax = np.minimum(rmin + rng.integers(1, 6, (n, 2)), (gx, gy))
    tiles = np.where(valid, (rmax - rmin).prod(1), 0)
    return [depth, valid, tiles.astype(np.int32), rmin.astype(np.int32),
            rmax.astype(np.int32)]


BIN_FIELDS = ("order", "pair_gauss", "pair_tile", "pair_perm", "seg_starts", "seg_ends",
              "tile_start", "tile_count", "num_pairs")


@pytest.mark.parametrize("room", [True, False])
@pytest.mark.parametrize("w,h", [(802, 550), (1600, 1200)])
def test_bin_rows_on_card_matches_cpu_at_the_cells_sizes(dev, w, h, room):
    """bin_rows on the card (X2, then K4) against bin_rows on the CPU
    (their plain versions), every output bit for bit, at the benchmark
    cells' frame sizes (a 51x35 and a 100x75 tile grid: 18 + 11 and 18 +
    13 key bits) and 200,000 rows, with room for every pair and with the
    deepest pairs past the capacity; X2 and K4 launch once each."""
    gx, gy = binning.tile_grid(w, h)
    host = cell_rows(200_000, gx, gy, seed=w + room)
    total = int(host[2].sum())
    cap = (total // 128 + 1) * 128 if room else total * 3 // 4 // 128 * 128
    kw = dict(grid_x=gx, grid_y=gy, pair_capacity=cap)
    before = (binning_scan.boundary_deltas.launches, binning_scan.fused_bin_scans.launches)
    got = binning.bin_rows(*(torch.as_tensor(x, device=dev) for x in host), **kw)
    after = (binning_scan.boundary_deltas.launches, binning_scan.fused_bin_scans.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1]
    want = binning.bin_rows(*(torch.as_tensor(x) for x in host), **kw)
    for name in BIN_FIELDS:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    assert (int(want.num_pairs) > cap) != room


def test_bin_rows_graph_replay_equals_eager(dev):
    """bin_rows captured in a CUDA graph, replayed on new rows copied into
    the captured inputs, against eager bin_rows on those rows, bit for bit;
    each replay launches X2 and K4 once on the card (their counters)."""
    gx, gy, n = 51, 35, 50_000
    kw = dict(grid_x=gx, grid_y=gy, pair_capacity=1 << 18)
    static = [torch.as_tensor(x, device=dev) for x in cell_rows(n, gx, gy, seed=0)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):       # the capture stream's scratch and counters
        binning.bin_rows(*static, **kw)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = binning.bin_rows(*static, **kw)
    for seed in (1, 2):
        new = [torch.as_tensor(x, device=dev) for x in cell_rows(n, gx, gy, seed=seed)]
        for s, x in zip(static, new):
            s.copy_(x)
        with cuda_lib.DeviceLaunches() as traced:
            graph.replay()
        want = binning.bin_rows(*new, **kw)
        for name in BIN_FIELDS:
            assert torch.equal(getattr(out, name), getattr(want, name)), (seed, name)
        assert traced.counts["binning_scan.boundary_deltas"] == 1
        assert traced.counts["binning_scan.fused_bin_scans"] == 1


@pytest.mark.parametrize("gy,gx,C", [(35, 51, 24), (3, 11, 5)])
def test_unpack_kernel_matches_plain(dev, gy, gx, C):
    packed = torch.randn(gy, relayout.pad_grid_x(gx), C, 256, device=dev)
    got = relayout.unpack_image(packed)
    assert torch.equal(got, relayout.unpack_image_plain(packed))


@pytest.mark.parametrize("w,h,n,chunk", [(48, 40, 300, 32), (200, 136, 3000, 128)])
def test_forward_blend_kernel_matches_plain(dev, w, h, n, chunk):
    arrays, cam = scene(n, w, h)
    proj = project(arrays, cam, w, h, dev)
    bins = binning.bin_gaussians(proj, width=w, height=h, pair_capacity=1 << 15)
    rows = binning.build_gaussian_payload(proj, torch.as_tensor(arrays[5], device=dev))
    pairs = rows[bins.order][bins.pair_gauss]
    gx, gy = bins.grid
    kw = dict(grid_x=gx, grid_y=gy, width=w, height=h, focal_x=cam.focal_x,
              focal_y=cam.focal_y, chunk=chunk)
    got = rasterize_cuda.rasterize_forward(pairs, bins.tile_start, bins.tile_count, **kw)
    want = rasterize_cuda.rasterize_forward_plain(pairs, bins.tile_start, bins.tile_count, **kw)
    got, want = got[:, :gx], want[:, :gx]
    assert torch.isfinite(got).all()
    off = outside(got, want).float().mean(dim=(0, 1, 3))      # per channel
    other = [c for c in range(rasterize_cuda.OUT_PAD) if c not in MEDIAN_CHANNELS]
    assert off[other].max() == 0
    assert off[MEDIAN_CHANNELS].max() <= MAX_FLIPPED


def test_rasterize_on_card_matches_cpu(dev):
    w, h = 96, 72
    arrays, cam = scene(1500, w, h, seed=4)
    cfg = RasterConfig(width=w, height=h, focal_x=cam.focal_x, focal_y=cam.focal_y,
                       pair_capacity=1 << 14, chunk=64)
    bg = torch.tensor([0.1, 0.2, 0.3])
    outs = {}
    for d in (dev, torch.device("cpu")):
        proj = project(arrays, cam, w, h, d)
        outs[d.type] = rasterize(proj, torch.as_tensor(arrays[5], device=d), bg.to(d), cfg)
    for name in outs["cpu"]._fields:
        a, b = getattr(outs["cuda"], name).cpu(), getattr(outs["cpu"], name)
        if name == "tile_overflow":
            assert bool(a) is bool(b) is False
            continue
        assert torch.isfinite(a).all(), name
        limit = MAX_FLIPPED if name in ("median_coord", "median_depth") else 0.0
        assert outside(a, b).float().mean() <= limit, name


@pytest.mark.parametrize("gy,gx,C", [(35, 51, 24), (3, 11, 5)])
def test_pack_kernel_matches_plain(dev, gy, gx, C):
    img = torch.randn(C, gy * 16, relayout.pad_grid_x(gx) * 16, device=dev)
    before = relayout.pack_image.launches
    got = relayout.pack_image(img)
    torch.cuda.synchronize()
    assert relayout.pack_image.launches == before + 1
    assert torch.equal(got, relayout.pack_image_plain(img))
    assert torch.equal(relayout.unpack_image(got), img)


@pytest.mark.parametrize("S,F", [(100_352, 26), (1000, 32), (7, 3)])
def test_segment_sum_kernel_matches_plain(dev, S, F):
    rng = np.random.default_rng(S)
    lengths = rng.integers(0, 30, S) * (rng.uniform(size=S) > 0.2)
    lengths[S // 2] = 3000
    ends = np.cumsum(lengths).astype(np.int32)
    starts = (ends - lengths).astype(np.int32)
    rows = torch.randn(int(ends[-1]) + 5, F, device=dev)
    st, en = torch.as_tensor(starts, device=dev), torch.as_tensor(ends, device=dev)
    got = segment_sum.segment_sum_rows(rows, st, en)
    want = segment_sum.segment_sum_rows_plain(rows, st, en)
    assert torch.equal(got, segment_sum.segment_sum_rows(rows, st, en))     # deterministic
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert float(got[torch.as_tensor(lengths == 0, device=dev)].abs().max()) == 0.0


CHUNK = 256      # the edge cases put segment bounds on multiples of this many rows
LONG = 64        # csrc/segment_sum.cu: a longer segment is summed by its CTA's eight warps
K3_REL = 1e-6


def segment_case(case, seed=0):
    """(lengths, gaps, rows past the last end) of a CSR case for K3."""
    rng = np.random.default_rng(seed)
    if case == "long":            # one segment of > 100k rows (>= 3 x CHUNK), among short ones
        lengths = rng.integers(0, 20, 3000)
        lengths[1500] = 100_003
        return lengths, np.zeros_like(lengths), 77
    if case == "chunk-edges":     # segments starting and ending on multiples of CHUNK
        lengths = np.array([CHUNK, CHUNK, 0, 3 * CHUNK, 5, CHUNK - 5, 0, 0, CHUNK, 2 * CHUNK])
        return lengths, np.zeros_like(lengths), 0
    if case == "long-edges":      # lengths about the CTA-shared threshold, in one CTA and across
        lengths = np.array([LONG, LONG + 1, LONG - 1, 1, 2 * LONG, 0, LONG + 7, 3,
                            LONG + 1, LONG + 1, 8 * LONG + 5, 0, 9, LONG, 1000, 2])
        return lengths, np.zeros_like(lengths), 5
    if case == "empties":         # empty segments first, last and in runs
        lengths = rng.integers(1, 30, 2000)
        lengths[:7] = 0
        lengths[-9:] = 0
        lengths[rng.integers(0, 2000, 600)] = 0
        lengths[800:900] = 0
        return lengths, np.zeros_like(lengths), 13
    if case == "gaps":            # rows between segments and past the last end
        lengths = rng.integers(0, 60, 3000)
        lengths[100] = 900
        return lengths, rng.integers(0, 5, 3000), 3 * CHUNK + 17
    if case == "single":          # S = 1
        return np.array([5 * CHUNK + 3]), np.array([11]), 0
    if case == "ragged":          # R not a multiple of the chunk
        lengths = rng.integers(0, 12, 5000)
        return lengths, np.zeros_like(lengths), 7
    raise ValueError(case)


@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("F", [1, 3, 26, 32])
@pytest.mark.parametrize("case", ["long", "chunk-edges", "long-edges", "empties", "gaps",
                                  "single", "ragged"])
def test_segment_sum_kernel_on_chunk_cases(dev, case, F, gathered):
    """K3 (and its gathered entry, through a random permutation) against
    the plain version within K3_REL of the largest output, bit-identical on
    a rerun, one launch a call; rows outside every segment hold NaN and must
    not reach any output, empty segments give exact zeros."""
    lengths, gaps, past = segment_case(case, seed=F)
    starts = np.cumsum(gaps + np.concatenate([[0], lengths[:-1]]))
    ends = (starts + lengths).astype(np.int32)
    starts = starts.astype(np.int32)
    R = int(ends[-1]) + past
    if case == "ragged":
        assert R % CHUNK
    rng = np.random.default_rng(F + 100)
    rows = rng.normal(size=(R, F)).astype(np.float32)
    covered = np.zeros(R, bool)
    for a, b in zip(starts, ends):
        covered[a:b] = True
    clean = torch.as_tensor(np.where(covered[:, None], rows, 0.0).astype(np.float32), device=dev)
    poisoned = torch.as_tensor(np.where(covered[:, None], rows, np.nan).astype(np.float32),
                               device=dev)
    st, en = torch.as_tensor(starts, device=dev), torch.as_tensor(ends, device=dev)
    want = segment_sum.segment_sum_rows_plain(clean, st, en)
    before = segment_sum.segment_sum_rows.launches
    if gathered:
        perm = torch.as_tensor(rng.permutation(R).astype(np.int32), device=dev)
        src = torch.empty_like(poisoned)
        src[perm.long()] = poisoned                  # src[perm] holds the rows in order
        def run():
            return segment_sum.segment_sum_rows_gathered(src, perm, st, en)
    else:
        def run():
            return segment_sum.segment_sum_rows(poisoned, st, en)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert segment_sum.segment_sum_rows.launches == before + 2
    assert torch.isfinite(got).all()
    assert torch.equal(got, again)                   # no atomics: bit-identical
    assert float((got - want).abs().max()) <= K3_REL * float(want.abs().max())
    empty = torch.as_tensor(lengths == 0, device=dev)
    assert bool((got[empty] == 0).all())


def test_segment_sum_kernel_takes_overlapping_segments(dev):
    """Monotone bounds whose segments overlap (each segment is summed on
    its own): short and long ones, against the plain version."""
    starts = torch.tensor([0, 10, 40, 60, 300], dtype=torch.int32, device=dev)
    ends = torch.tensor([30, 50, 600, 600, 700], dtype=torch.int32, device=dev)
    rows = torch.randn(800, 5, device=dev)
    got = segment_sum.segment_sum_rows(rows, starts, ends)
    want = segment_sum.segment_sum_rows_plain(rows, starts, ends)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= K3_REL * float(want.abs().max())


@pytest.mark.parametrize("w,h,n,chunk,grow,dead", [
    (48, 40, 300, 32, 1.0, False), (200, 136, 3000, 128, 1.0, False),
    # ~2500 pairs a tile against a cap of 4 * 512: rows past the cap are dead
    (48, 40, 2500, 4, 20.0, True)])
def test_backward_blend_kernel_matches_plain(dev, w, h, n, chunk, grow, dead):
    arrays, cam = scene(n, w, h, seed=2)
    arrays = (arrays[0], arrays[1] * grow, *arrays[2:])
    proj = project(arrays, cam, w, h, dev)
    bins = binning.bin_gaussians(proj, width=w, height=h, pair_capacity=1 << 15)
    rows = binning.build_gaussian_payload(proj, torch.as_tensor(arrays[5], device=dev))
    pairs = rows[bins.order][bins.pair_gauss].contiguous()
    gx, gy = bins.grid
    kw = dict(grid_x=gx, grid_y=gy, width=w, height=h, focal_x=cam.focal_x,
              focal_y=cam.focal_y, chunk=chunk)
    packed = rasterize_cuda.rasterize_forward(pairs, bins.tile_start, bins.tile_count, **kw)
    packed[:, gx:] = 0.0
    cot = torch.randn(packed.shape, device=dev, generator=torch.Generator(dev).manual_seed(0))
    cot = cot * 0.01
    before = rasterize_cuda.rasterize_backward.launches
    poisoned = poison_next_block(pairs.shape[0], dev)
    got, live = rasterize_cuda.rasterize_backward(pairs, bins.tile_start, bins.tile_count,
                                                  packed, cot, **kw)
    assert got.data_ptr() == poisoned              # K2 wrote into the NaN block
    again, _ = rasterize_cuda.rasterize_backward(pairs, bins.tile_start, bins.tile_count,
                                                 packed, cot, **kw)
    want, want_live = rasterize_cuda.rasterize_backward_plain(
        pairs, bins.tile_start, bins.tile_count, packed, cot, **kw)
    torch.cuda.synchronize()
    assert rasterize_cuda.rasterize_backward.launches == before + 2
    assert torch.equal(live, want_live)
    # every row of every tile is written, zero past the tile's live chunks
    total = int(bins.tile_count.sum())
    assert total > 0
    if dead:
        assert bool((torch.minimum(bins.tile_count, live * chunk) < bins.tile_count).any())
    g, a, p = got[:total], again[:total], want[:total]
    assert torch.equal(g, a)                      # no atomics: bit-identical
    assert torch.isfinite(g).all()
    col_max = p.abs().amax(dim=0)
    assert bool(((g - p).abs().amax(dim=0) <= 1e-4 * col_max).all())
    dead_rows = p.abs().amax(dim=1) == 0
    assert bool((g[dead_rows] == 0).all())


def test_packed_segment_sum_is_the_k3_kernel(dev):
    rng = np.random.default_rng(3)
    lengths = rng.integers(0, 12, 5000)
    ends = np.cumsum(lengths).astype(np.int32)
    starts = (ends - lengths).astype(np.int32)
    rows = torch.randn(int(ends[-1]), 20, device=dev)
    st, en = torch.as_tensor(starts, device=dev), torch.as_tensor(ends, device=dev)
    before = (segment_sum.segment_sum_rows_packed.launches, segment_sum.segment_sum_rows.launches)
    got = segment_sum.segment_sum_rows_packed(rows, st, en)
    torch.cuda.synchronize()
    assert (segment_sum.segment_sum_rows_packed.launches,
            segment_sum.segment_sum_rows.launches) == (before[0] + 1, before[1])
    want = segment_sum.segment_sum_rows_plain(rows, st, en)
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("case,n,k", [
    ("uniform", 2200, 20), ("uniform", 700, 3), ("duplicated", 1200, 20),
    ("cancelling", 600, 20), ("uniform", 21, 20), ("uniform", 500, 1),
    ("uniform", 1000, 31), ("uniform", 257, 8), ("far-shell", 100_352, 20),
    ("clusters", 2200, 20), ("collinear", 1500, 20), ("offset", 2200, 20),
    ("margin", 2048, 20), ("clusters", 20_000, 3)])
def test_knn_kernel_matches_plain(dev, case, n, k):
    """X1 (csrc/knn.cu) against `knn_plain` on the card, distances and
    indices bit for bit: ties (equal distances to the lower index),
    distances below zero, N = k + 1, N not a multiple of a warp's 32
    queries or of a tile's 128 points, k from 1 to 31, the KNN refresh's 100,352-point input, clusters
    of very different density, collinear points (flat tile boxes), a cloud
    far from the origin and pairs at the skip bound's rounding margin
    (tests/torch_knn_clouds.py). One `knn` call is one launch, by its
    wrapper and on the card (the device counters); on the smaller clouds
    the CPU's plain version agrees too."""
    pts = torch.as_tensor(knn_cloud(case, n), device=dev)
    before = knn.knn.launches
    with cuda_lib.DeviceLaunches() as traced:
        d2, idx = knn.knn(pts, k=k)
        torch.cuda.synchronize()
    assert knn.knn.launches == before + 1 and traced.counts["knn.knn"] == 1
    want = [knn.knn_plain(pts, k=k)]
    if n <= 2200:
        want.append(knn.knn_plain(pts.cpu(), k=k))
    for pd2, pidx in want:
        assert torch.equal(idx.cpu(), pidx.cpu())
        assert torch.equal(d2.cpu().view(torch.int32), pd2.cpu().view(torch.int32))
    again = knn.knn(pts, k=k)
    assert torch.equal(again[0], d2) and torch.equal(again[1], idx)
    if case == "cancelling":
        assert float((d2 < 0).float().mean()) > 0.1


def test_knn_kernel_skips_tiles_and_sorts_like_the_plain_version(dev):
    """X1's Morton codes equal `morton_codes_plain`'s and the built library
    reports the plain mirrors' tile layout; on the refresh's input (far
    shell included) each warp scans its own tile and at most all of them,
    and on average a small share (the skip at work); the launch is counted
    once."""
    pts = torch.as_tensor(knn_cloud("far-shell", 100_352), device=dev)
    assert torch.equal(knn.morton_codes(pts).cpu(), knn.morton_codes_plain(pts.cpu()))
    tiles = knn.layout()
    assert tiles == dict(tile=knn.TILE, super=knn.SUPER, group=knn.GROUP)
    before = knn.knn.launches
    visits = knn.tile_visits(pts, 20).cpu()
    assert knn.knn.launches == before + 1
    nt = -(-100_352 // tiles["tile"])
    assert visits.shape == (100_352 // tiles["group"], 2)
    assert bool((visits[:, 0] >= 1).all()) and bool((visits[:, 0] <= nt).all())
    assert int(visits[:, 1].max()) <= 100_352
    assert float(visits[:, 0].double().mean()) < 0.2 * nt


def test_knn_kernel_adds_no_host_wait(dev):
    """`knn` on the card under sync debug mode "error": no host-device wait
    (the sort, the scratch and the launches are all enqueued)."""
    pts = torch.as_tensor(knn_cloud("far-shell", 20_000), device=dev)
    knn.knn(pts, k=20)       # builds and arms the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        d2, idx = knn.knn(pts, k=20)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    pd2, pidx = knn.knn_plain(pts, k=20)
    assert torch.equal(idx, pidx) and torch.equal(d2.view(torch.int32), pd2.view(torch.int32))


def test_knn_kernel_refuses_what_it_does_not_take(dev):
    """k + 1 > 32 and N < k + 1 raise ValueError, launching nothing."""
    pts = torch.rand(100, 3, device=dev)
    before = knn.knn.launches
    with pytest.raises(ValueError, match="k \\+ 1 <= 32"):
        knn.knn(pts, k=32)
    with pytest.raises(ValueError, match="at least k \\+ 1"):
        knn.knn(pts[:5], k=5)
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        knn.knn(pts[:, :2], k=3)
    assert knn.knn.launches == before
    assert knn.kernel_info(31)["registers"] > 0


def knn_graph_case(dev, C, K, spatial, caps, seed=0, hub=False, E=32):
    """A KNN graph on the card: neighbours by position (the trainer's kind)
    or at random (no locality: the far and spill lists fill up); with `hub`,
    every row's slot 0 points at Gaussian 0. Past X1's 31 neighbours the
    positions' neighbours come from its plain version (the same result)."""
    g = torch.Generator(dev).manual_seed(seed)
    pts = torch.rand(C, 3, device=dev, generator=g) * 2 - 1
    if spatial:
        d2, idx = (knn.knn if K < knn.MAX_K1 else knn.knn_plain)(pts, k=K)
        w = torch.exp(-20.0 * d2)
    else:
        idx = torch.randint(0, C, (C, K), device=dev, generator=g)
        w = torch.rand(C, K, device=dev, generator=g)
    if hub:
        idx[:, 0] = 0
    mask = torch.rand(C, device=dev, generator=g) > 0.1
    w = w * mask[:, None]
    coef = mask.float() / (mask.sum() * K)
    graph = knn_loss.prepare_knn_graph(idx, w, coef, pts, pts_valid=mask, **caps)
    emb = torch.randn(C, E, device=dev, generator=g) * 0.3
    return graph, emb


@pytest.mark.parametrize("C,K,spatial,caps,overflows", [
    # the trainer's default buckets drop ~0.7% of this cloud's edges
    (100_000, 20, True, dict(spill_a=256, spill_b=768, far_capacity=1 << 19), True),
    (3000, 20, False, dict(spill_a=256, spill_b=256, far_capacity=256), True),
    (700, 5, False, {}, False)])
def test_knn_loss_kernels_match_plain(dev, C, K, spatial, caps, overflows):
    graph, emb = knn_graph_case(dev, C, K, spatial, caps)
    assert bool((graph.overflow > 0).any()) == overflows
    check_knn_kernels(graph, emb, C, K)


@pytest.mark.parametrize("case", ["cp1024", "hub", "k1", "k32"])
def test_knn_loss_kernels_on_edge_cases(dev, case):
    """The smallest table a graph has (Cp = 1024: 8 K6 CTAs, 16 K7 CTAs), a
    rank with thousands of in-edges, and the least and most slots the
    kernels take."""
    C, K, spatial, hub = {"cp1024": (1000, 20, True, False),
                          "hub": (3000, 8, False, True),
                          "k1": (2000, 1, True, False),
                          "k32": (2000, 32, True, False)}[case]
    no_drops = dict(spill_a=1 << 12, spill_b=1 << 12)   # clamped to Cp: nothing dropped
    graph, emb = knn_graph_case(dev, C, K, spatial, no_drops, seed=3, hub=hub)
    assert int(graph.overflow.sum()) == 0
    indeg = graph.rev_ptr[1:] - graph.rev_ptr[:-1]
    if case == "cp1024":
        assert graph.pi.shape[0] == 1024
    if case == "hub":       # every weighted row's slot 0: ~0.9 C in-edges
        assert int(indeg[graph.inv[0]]) > 4 * knn_loss.BA
    check_knn_kernels(graph, emb, C, K)


def test_knn_loss_kernels_refuse_shapes_they_do_not_take(dev):
    """Tables that are not a multiple of 32 wide (any other embedding
    reaches the kernels zero-padded by rank_table:
    test_knn_loss_kernels_take_narrow_tables, _take_wide_tables), slot
    counts past 32, a rank count that is not a multiple of the CTA's 128
    rows and a table off 16-byte alignment raise ValueError before any
    launch."""
    def args(Cp, E, K):
        return (torch.zeros(Cp, E, device=dev), torch.zeros(Cp, K, dtype=torch.int32, device=dev),
                torch.zeros(Cp, K, device=dev), torch.zeros(Cp, device=dev))
    rev_ptr = torch.zeros(1025, dtype=torch.int32, device=dev)
    rev_pair = torch.zeros(0, dtype=torch.int32, device=dev)
    before = (knn_loss.knn_rows.launches, knn_loss.knn_reverse.launches)
    for Cp, E, K in ((1024, 16, 20), (1024, 36, 20), (1024, 31, 20), (1024, 32, 33),
                     (1000, 32, 20), (1024, 80, 20), (1000, 64, 20)):
        emb_r, nbr, w, coef = args(Cp, E, K)
        with pytest.raises(ValueError):
            knn_loss.knn_rows(emb_r, nbr, w, coef)
        with pytest.raises(ValueError):
            knn_loss.knn_reverse(emb_r, w, emb_r, rev_ptr[:Cp + 1], rev_pair)
    emb_r, nbr, w, coef = args(1024, 32, 20)
    shifted = torch.zeros(1024 * 32 + 1, device=dev)[1:].view(1024, 32)
    with pytest.raises(ValueError):
        knn_loss.knn_rows(shifted, nbr, w, coef)
    with pytest.raises(ValueError):
        knn_loss.knn_reverse(emb_r, w, shifted, rev_ptr, rev_pair)
    assert (knn_loss.knn_rows.launches, knn_loss.knn_reverse.launches) == before


@pytest.mark.parametrize("E", [16, 7, 1])
def test_knn_loss_kernels_take_narrow_tables(dev, E):
    """An embedding narrower than 32 runs through the 32-wide kernels
    zero-padded by `rank_table` (as the autograd Function's gather builds
    it) and matches the plain chain on the E-wide table as
    check_knn_kernels holds the 32-wide one."""
    graph, emb = knn_graph_case(dev, 2000, 20, True, dict(spill_a=1 << 12, spill_b=1 << 12),
                                seed=4, E=E)
    check_knn_kernels(graph, emb, 2000, 20)


@pytest.mark.parametrize("E", [48, 64, 100])
def test_knn_loss_kernels_take_wide_tables(dev, E):
    """An embedding wider than 32 runs in 32-column slabs (K6's wide kernel
    finishes each edge's d2 over every slab before it forms s; K7 sums
    one slab a CTA row), zero-padded to whole slabs by `rank_table`, and
    matches the plain chain as check_knn_kernels holds the 32-wide table."""
    graph, emb = knn_graph_case(dev, 2000, 20, True, dict(spill_a=1 << 12, spill_b=1 << 12),
                                seed=5, E=E)
    check_knn_kernels(graph, emb, 2000, 20)


def check_knn_kernels(graph, emb, C, K):
    """K6 -> K7 against the plain chain on `graph`: the loss within 1e-5
    relative, every row of dL/demb within 1e-5 of its largest value, two
    runs bit-identical, one launch each per run, and the autograd Function
    returns the same gradient."""
    E = emb.shape[1]
    emb_r = knn_loss.rank_table(emb, graph, knn_loss.kernel_width(E))   # zero columns past E
    before = (knn_loss.knn_rows.launches, knn_loss.knn_reverse.launches)
    loss, de, s = knn_loss.knn_rows(emb_r, graph.nbr, graph.w, graph.coef)
    out = knn_loss.knn_reverse(emb_r, s, de, graph.rev_ptr, graph.rev_pair)
    loss2, de2, s2 = knn_loss.knn_rows(emb_r, graph.nbr, graph.w, graph.coef)
    out2 = knn_loss.knn_reverse(emb_r, s2, de2, graph.rev_ptr, graph.rev_pair)
    torch.cuda.synchronize()
    assert (knn_loss.knn_rows.launches, knn_loss.knn_reverse.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(loss, loss2) and torch.equal(out, out2)        # no atomics
    # the plain chain on the E-wide table
    emb_p = knn_loss.rank_table(emb, graph, E)
    loss_p, de_p, s_p = knn_loss.knn_rows_plain(emb_p, graph.nbr, graph.w, graph.coef)
    out_p = knn_loss.knn_reverse_plain(emb_p, s_p, de_p, graph.rev_ptr, graph.rev_pair)
    assert abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    assert torch.isfinite(out).all() and bool((out[:, E:] == 0).all())
    row_max = out_p.abs().amax(dim=1)
    assert bool(((out[:, :E] - out_p).abs().amax(dim=1) <= 1e-5 * row_max).all())
    # through the autograd Function: the same gradient
    e = emb.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(knn_loss.knn_loss_fused(e, graph, K), e)
    assert torch.equal(g, out[graph.inv[:C], :E])


def pair_rows(rng, centers, conics, opacity):
    """[K, 26] pair rows with the given means, conics and opacities; the
    other columns random (colours, tongue, planes, depth, unit normals) and
    the ones column 1."""
    k = len(centers)
    rows = np.zeros((k, 26), np.float32)
    rows[:, 0:2] = centers
    rows[:, 2:5] = conics
    rows[:, 5] = opacity
    rows[:, 6:9] = rng.uniform(0, 1, (k, 3))
    rows[:, 9] = rng.uniform(0, 1, k) > 0.7
    rows[:, 10:13] = rng.normal(0, 1, (k, 3))
    rows[:, 13:21] = rng.normal(0, 0.01, (k, 8))
    rows[:, 21] = rng.uniform(1, 4, k)
    nrm = rng.normal(size=(k, 3))
    rows[:, 22:25] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    rows[:, 25] = 1.0
    return rows


def random_splats(rng, n, x0, y0, size=16.0):
    """n splats of 1.5-6 px over a size x size square at (x0, y0)."""
    s = rng.uniform(1.5, 6.0, (n, 2))
    th = rng.uniform(0, np.pi, n)
    cs, sn = np.cos(th), np.sin(th)
    a = (cs / s[:, 0]) ** 2 + (sn / s[:, 1]) ** 2
    c = (sn / s[:, 0]) ** 2 + (cs / s[:, 1]) ** 2
    b = cs * sn * (1 / s[:, 0] ** 2 - 1 / s[:, 1] ** 2)
    centers = np.stack([x0 + rng.uniform(-4, size + 4, n), y0 + rng.uniform(-4, size + 4, n)], 1)
    return centers, np.stack([a, b, c], 1), rng.uniform(0.2, 0.95, n)


def blend_case(case, seed=0):
    """Tiles of synthetic pair rows that probe the kernels' warp walk: the
    rows of tile t are (centers, conics, opacities) from `tile_rows(t)`.
    Returns (rows [K, 26], tile_count [T], grid_x, grid_y, chunk)."""
    rng = np.random.default_rng(seed)
    gx, gy, chunk = 4, 3, 32
    amin = np.float32(1.0) / np.float32(255.0)
    counts = [30 + 7 * t for t in range(gx * gy)]

    def tile_rows(t, n):
        x0, y0 = 16 * (t % gx), 16 * (t // gx)
        ctr, con, opc = random_splats(rng, n, x0, y0)
        if case == "edge":
            # circles whose pass edge q = r2 lies exactly on the pixel column
            # or row where one warp block meets the next (x0+7 | x0+8, y0+3 | y0+4)
            for i in range(n):
                k = int(rng.integers(1, 9))
                r2 = 2.0 * np.log(opc[i] * 255.0)
                side = rng.integers(0, 4)
                ctr[i] = ((x0 + 8 + k, y0 + 4 * rng.integers(0, 4)) if side == 0 else
                          (x0 + 7 - k, y0 + 4 * rng.integers(0, 4)) if side == 1 else
                          (x0 + 8 * rng.integers(0, 2), y0 + 4 + k) if side == 2 else
                          (x0 + 8 * rng.integers(0, 2), y0 + 3 - k))
                con[i] = (r2 / k ** 2, 0.0, r2 / k ** 2)
        elif case == "opacity":
            pick = np.array([amin, np.nextafter(amin, np.float32(1)),
                             np.nextafter(amin, np.float32(0)), amin * np.float32(1.0001),
                             amin * np.float32(0.999), amin * np.float32(1.02)], np.float32)
            opc[: n // 2] = pick[rng.integers(0, len(pick), n // 2)]
        elif case == "conic":
            special = np.array([(0.0, 0.0, 0.0), (0.05, 0.1, 0.05), (-0.02, 0.0, 0.03),
                                (0.03, 0.0, -0.02), (0.0, 0.01, 0.0),
                                (0.2, 0.9995 * 0.2, 0.2), (0.2, 0.9994 * 0.2, 0.2),
                                (0.2, -0.99951 * 0.2, 0.2)])
            sel = rng.integers(0, len(special), n // 3)
            con[: n // 3] = special[sel]
            opc[: n // 3] = np.where(sel == 0, 0.02, opc[: n // 3])
        elif case == "saturate":
            # four wide near-opaque splats saturate every pixel of the tile
            # within a few rows of each chunk; later rows include nowhere
            for start in range(0, n, chunk):
                for i in range(start + 3, min(start + 7, n)):
                    ctr[i] = (x0 + 8, y0 + 8)
                    con[i] = (1e-3, 0.0, 1e-3)
                    opc[i] = 0.99
        return ctr, con, opc

    if case == "cap":
        chunk = 4                       # cap 4 * 512 = 2048 pairs a tile
        counts[5] = 2500
    if case == "unequal":
        counts = [int(x) for x in rng.integers(0, 12, gx * gy)]
        counts[7] = 3000
    parts = [pair_rows(rng, *tile_rows(t, n)) for t, n in enumerate(counts)]
    return np.concatenate(parts), np.array(counts, np.int32), gx, gy, chunk


@pytest.mark.parametrize("case", ["edge", "opacity", "conic", "saturate", "cap", "unequal"])
def test_blend_kernels_on_edge_cases(dev, case):
    """K1 and K2 against their plain versions where the warp walk decides
    something: boxes on a warp block's boundary, opacities around 1/255,
    conics without a box, pixels that saturate mid-chunk, a tile past the
    cap and tiles of very unequal length. Same rules as above; K2 run twice
    is bit-identical."""
    rows, counts, gx, gy, chunk = blend_case(case)
    pairs = torch.as_tensor(rows, device=dev)
    tile_count = torch.as_tensor(counts, device=dev)
    tile_start = torch.as_tensor(np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32),
                                 device=dev)
    w, h = 16 * gx, 16 * gy
    kw = dict(grid_x=gx, grid_y=gy, width=w, height=h, focal_x=60.0, focal_y=58.0,
              chunk=chunk)
    packed = rasterize_cuda.rasterize_forward(pairs, tile_start, tile_count, **kw)
    stats = {}
    want = rasterize_cuda.rasterize_forward_plain(pairs, tile_start, tile_count, stats=stats,
                                                  **kw)
    got1, want1 = packed[:, :gx], want[:, :gx]
    assert torch.isfinite(got1).all()
    off = outside(got1, want1).float().mean(dim=(0, 1, 3))
    other = [c for c in range(rasterize_cuda.OUT_PAD) if c not in MEDIAN_CHANNELS]
    assert off[other].max() == 0
    assert off[MEDIAN_CHANNELS].max() <= MAX_FLIPPED
    if case == "saturate":
        # most pair-pixels come after their pixel's in-chunk product fell
        # below 1e-4
        assert stats["evals"] < 0.3 * 256 * rows.shape[0]

    packed[:, gx:] = 0.0
    cot = torch.randn(packed.shape, device=dev, generator=torch.Generator(dev).manual_seed(1))
    cot = cot * 0.01
    poisoned = poison_next_block(pairs.shape[0], dev)
    got, live = rasterize_cuda.rasterize_backward(pairs, tile_start, tile_count, packed, cot,
                                                  **kw)
    assert got.data_ptr() == poisoned              # K2 wrote into the NaN block
    again, _ = rasterize_cuda.rasterize_backward(pairs, tile_start, tile_count, packed, cot,
                                                 **kw)
    p, want_live = rasterize_cuda.rasterize_backward_plain(pairs, tile_start, tile_count, packed,
                                                           cot, **kw)
    torch.cuda.synchronize()
    assert torch.equal(live, want_live)
    assert torch.equal(got, again)
    assert torch.isfinite(got).all()
    col_max = p.abs().amax(dim=0)
    assert bool(((got - p).abs().amax(dim=0) <= 1e-4 * col_max).all())
    assert bool((got[p.abs().amax(dim=1) == 0] == 0).all())
    if case == "cap":
        assert int(counts.max()) > chunk * rasterize_cuda.MAX_CHUNKS


def test_png_unfilter_helper_on_the_card_machine(dev):
    """The host C++ unfilter (csrc/png_unfilter.cpp) builds with the card
    machine's g++ and equals its numpy version on random filtered streams
    of every filter type, a PNG the port encodes decodes to itself, and
    the library's resampling pass equals the numpy resize."""
    from ed3dgs_torch.data import image_io
    rng = np.random.default_rng(0)
    for h, row_bytes, bpp in ((31, 3 * 57, 3), (12, 4 * 20, 4), (40, 64, 1)):
        raw = rng.integers(0, 256, (h, row_bytes + 1), dtype=np.uint8)
        raw[:, 0] = rng.integers(0, 5, h)
        np.testing.assert_array_equal(image_io.unfilter(raw.tobytes(), h, row_bytes, bpp),
                                      image_io.unfilter_plain(raw.reshape(-1), h, row_bytes,
                                                              bpp))
    img = rng.integers(0, 256, (550, 802, 3), dtype=np.uint8)
    np.testing.assert_array_equal(image_io.decode_png(image_io.encode_png(img)), img)
    # the resampling pass of the same library against numpy
    np.testing.assert_array_equal(image_io.resize_lanczos(img, 430, 300),
                                  image_io.resize_lanczos_plain(img, 430, 300))


def test_integrate_points_on_card_matches_cpu(dev):
    """ops/integrate.py (plain PyTorch; K4 bins its tiles on the card) on
    the card against the CPU: every output within 1e-5, on points on and
    off screen and a tile cut at max_per_tile."""
    from ed3dgs_torch.ops.integrate import integrate_points
    w, h = 96, 72
    arrays, cam = scene(1500, w, h, seed=6)
    rng = np.random.default_rng(7)
    pts = np.concatenate([arrays[0][:500] + rng.normal(0, 0.02, (500, 3)),
                          np.stack([rng.uniform(-2, 2, 300), rng.uniform(-1.5, 1.5, 300),
                                    rng.uniform(-1, 4, 300)], 1)]).astype(np.float32)
    outs = {}
    for d in (dev, torch.device("cpu")):
        means, scales, q, opac, shs, _ = (torch.as_tensor(a, device=d) for a in arrays)
        proj = project_gaussians(
            means, scales, q, opac, shs, viewmatrix=torch.as_tensor(cam.world_view, device=d),
            projmatrix=torch.as_tensor(cam.full_proj, device=d),
            campos=torch.as_tensor(cam.campos, device=d), width=w, height=h,
            tan_fovx=cam.tan_fovx, tan_fovy=cam.tan_fovy, focal_x=cam.focal_x,
            focal_y=cam.focal_y, kernel_size=0.1, sh_degree=3, compute_invraycov=True)
        outs[d.type] = integrate_points(
            proj, torch.as_tensor(pts, device=d),
            viewmatrix=torch.as_tensor(cam.world_view, device=d), width=w, height=h,
            focal_x=cam.focal_x, focal_y=cam.focal_y, pair_capacity=1 << 15, max_per_tile=256)
    assert 0 < int(outs["cpu"].point_valid.sum()) < len(pts)
    for name in outs["cpu"]._fields:
        a, b = getattr(outs["cuda"], name).cpu().float(), getattr(outs["cpu"], name).float()
        assert float((a - b).abs().max()) <= 1e-5, name


def test_mesh_eval_on_card_matches_cpu(dev):
    """The closest-point search (float64) on the card against the CPU."""
    from ed3dgs_torch.mesh.mesh_eval import closest_points_on_mesh
    rng = np.random.default_rng(8)
    verts = rng.normal(size=(2000, 3)).astype(np.float32)
    faces = rng.integers(0, 2000, (9000, 3))
    pts = rng.normal(size=(1100, 3))
    got = closest_points_on_mesh(pts, verts, faces, device=dev)
    want = closest_points_on_mesh(pts, verts, faces, device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)


def test_lpips_on_card_matches_cpu(dev):
    """LPIPS's convolutions (cuDNN, TF32 off) against the CPU's."""
    from ed3dgs_torch.utils.lpips import LPIPS, random_params
    rng = np.random.default_rng(9)
    x = rng.random((2, 3, 96, 80)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    for net in ("alex", "vgg"):
        model = LPIPS(random_params(net, seed=0), net)
        want = model(x, y).numpy()
        got = model.to(dev)(x, y).cpu().numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)


def sphere_depth(w, h, f, center, radius=0.5):
    """Analytic z-depth of a sphere from a camera at the origin (+z fwd)."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    d = np.stack([(xs + 0.5 - w / 2) / f, (ys + 0.5 - h / 2) / f, np.ones((h, w))], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = np.asarray(center, float)
    b = d @ c
    disc = b ** 2 - (c @ c - radius ** 2)
    t = b - np.sqrt(np.maximum(disc, 0))
    return np.where((disc > 0) & (t > 0), t * d[..., 2], 0.0).astype(np.float32)


@pytest.mark.parametrize("engine", ["sparse", "dense"])
def test_tsdf_fusion_on_card_matches_cpu(dev, engine):
    """mesh/tsdf*.py on the card against the CPU, two views with colour and
    one without: the same blocks in the same rows, the fields within 1e-6
    (each float64 projection product and sum is its own operation on both),
    faces equal, vertices within 1e-6; bit-identical on a rerun."""
    from ed3dgs_torch.mesh import tsdf, tsdf_sparse
    w, h = 160, 120
    f = w / (2 * math.tan(math.radians(30.0)))
    wv2 = np.eye(4)
    wv2[0, 3] = -0.1
    rng = np.random.default_rng(10)
    depths = [sphere_depth(w, h, f, (0, 0, 2.0)), sphere_depth(w, h, f, (-0.1, 0, 2.0))]
    colors = [rng.uniform(0, 1, (h, w, 3)).astype(np.float32), None]
    if engine == "sparse":
        fuse, extract = tsdf_sparse.fuse_volume_sparse, tsdf_sparse.SparseTsdfVolume.extract_surface
    else:
        fuse, extract = tsdf.fuse_volume, tsdf.extract_surface
    vols = [fuse([torch.as_tensor(x, device=d) for x in depths],
                 [None if c is None else torch.as_tensor(c, device=d) for c in colors],
                 [np.eye(4), wv2], [(f, f)] * 2, voxel_size=0.01)
            for d in (dev, dev, torch.device("cpu"))]
    (v1, f1, c1), (v2, f2, c2), (v0, f0, c0) = (extract(v) for v in vols)
    vol1, vol2, vol0 = vols
    assert len(f0) > 1000
    np.testing.assert_array_equal(f1, f0)
    np.testing.assert_allclose(v1, v0, rtol=0, atol=1e-6)
    np.testing.assert_allclose(c1, c0, rtol=0, atol=1e-6)
    assert np.array_equal(v1, v2) and np.array_equal(f1, f2) and np.array_equal(c1, c2)
    if engine == "sparse":
        assert torch.equal(vol1.block_keys.cpu(), vol0.block_keys)
    for k in ("tsdf", "weight", "color"):
        a, b = getattr(vol1, k).cpu(), getattr(vol0, k)
        assert float((a - b).abs().max()) <= 1e-6, k
        assert torch.equal(getattr(vol2, k), getattr(vol1, k)), k


def test_render_points_on_card_matches_cpu(dev):
    """tools/mesh_video.render_points on the card against the CPU: a
    coloured cloud equal, a shaded one within 1e-6 (`x ** 16`'s last bit);
    bit-identical on a rerun (the per-pixel winner is a scatter amax)."""
    from ed3dgs_torch.tools.mesh_video import VIEWS, render_points
    rng = np.random.default_rng(11)
    eye, target, up, zoom = VIEWS["central"]
    pts = (target + rng.normal(0, 0.03, (20000, 3))).astype(np.float32)
    cols = rng.uniform(0, 1, (20000, 3)).astype(np.float32)
    normals = rng.normal(size=(20000, 3)).astype(np.float32)
    for cn, shaded, tol in ((cols, False, 0.0), (normals, True, 1e-6)):
        a = render_points(pts, cn, eye, target, up, zoom, 120, 160, shaded=shaded, device=dev)
        b = render_points(pts, cn, eye, target, up, zoom, 120, 160, shaded=shaded, device=dev)
        c = render_points(pts, cn, eye, target, up, zoom, 120, 160, shaded=shaded,
                          device="cpu")
        assert np.array_equal(a, b) and (c > 0).any(0).sum() > 1000
        np.testing.assert_allclose(a, c, rtol=0, atol=tol)


def test_gaussians_to_mesh_on_card_matches_cpu(dev):
    """mesh/gaussians_viz.gaussians_to_mesh on the card against the CPU:
    vertices within 1e-6, faces and colours equal; bit-identical on a rerun."""
    from ed3dgs_torch.mesh.gaussians_viz import gaussians_to_mesh
    rng = np.random.default_rng(12)
    n = 5000
    arrays = (rng.normal(size=(n, 3)), rng.uniform(0.01, 0.1, (n, 3)), rng.normal(size=(n, 4)),
              rng.uniform(-0.2, 1.2, (n, 3)), rng.uniform(0, 1, n))
    outs = [gaussians_to_mesh(*(torch.as_tensor(a, dtype=torch.float32, device=d)
                                for a in arrays), opacity_threshold=0.2)
            for d in (dev, dev, torch.device("cpu"))]
    assert all(np.array_equal(a, b) for a, b in zip(outs[0], outs[1]))
    np.testing.assert_allclose(outs[0][0], outs[2][0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(outs[0][1], outs[2][1])
    np.testing.assert_array_equal(outs[0][2], outs[2][2])


@pytest.mark.parametrize("dense_max", [1 << 22, 0])
def test_dot3_at_midpoints_on_card_matches_cpu(dev, dense_max, monkeypatch):
    """ops/knn._dot3 on rows whose chains step at a float32 midpoint, both
    of `_fma`'s paths (every element; midpoints gathered): values and the
    gradient of sum(a . a) + sum(a . b) equal to the CPU's bit for bit. The
    COLMAP loss takes this gradient on the card's PyTorch too."""
    monkeypatch.setattr(knn, "_DENSE_MAX", dense_max)
    rng = np.random.default_rng(5)
    n = 4096
    a = np.stack([2.0 ** -rng.integers(14, 20, n), rng.integers(2049, 2896, n) * 2 + 1,
                  rng.normal(size=n)], 1).astype(np.float32)
    b = rng.normal(size=(n, 3)).astype(np.float32)
    outs = []
    for d in (dev, torch.device("cpu")):
        ta = torch.as_tensor(a, device=d).requires_grad_()
        tb = torch.as_tensor(b, device=d).requires_grad_()
        sq, ab = knn._dot3(ta, ta), knn._dot3(ta, tb)
        (sq.sum() + ab.sum()).backward()
        outs.append([x.detach().cpu().numpy() for x in (sq, ab, ta.grad, tb.grad)])
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x.view(np.int32), y.view(np.int32))


@pytest.mark.parametrize("half", [(24.0, -12.0), (27.5, 52.0)])
def test_blend_kernels_at_a_strip_origin(dev, half):
    """K1 and K2 with the ray origin (half_w, half_h) of a strip of a larger
    image against their plain versions; the origin reaches the kernels (the
    coordinate channels move with it)."""
    w, h, n, chunk = 48, 32, 300, 32
    arrays, cam = scene(n, w, h, seed=5)
    proj = project(arrays, cam, w, h, dev)
    bins = binning.bin_gaussians(proj, width=w, height=h, pair_capacity=1 << 15)
    rows = binning.build_gaussian_payload(proj, torch.as_tensor(arrays[5], device=dev))
    pairs = rows[bins.order][bins.pair_gauss].contiguous()
    gx, gy = bins.grid
    kw = dict(grid_x=gx, grid_y=gy, width=w, height=h, focal_x=cam.focal_x,
              focal_y=cam.focal_y, chunk=chunk, half_w=half[0], half_h=half[1])
    got = rasterize_cuda.rasterize_forward(pairs, bins.tile_start, bins.tile_count, **kw)
    want = rasterize_cuda.rasterize_forward_plain(pairs, bins.tile_start, bins.tile_count, **kw)
    centred = rasterize_cuda.rasterize_forward(pairs, bins.tile_start, bins.tile_count,
                                               **dict(kw, half_w=None, half_h=None))
    got, want, centred = got[:, :gx], want[:, :gx], centred[:, :gx]
    off = outside(got, want).float().mean(dim=(0, 1, 3))
    other = [c for c in range(rasterize_cuda.OUT_PAD) if c not in MEDIAN_CHANNELS]
    assert off[other].max() == 0 and off[MEDIAN_CHANNELS].max() <= MAX_FLIPPED
    depth = rasterize_cuda.OUT_CHANNELS["depth"]
    assert float((got[:, :, depth] - centred[:, :, depth]).abs().max()) > 1e-3
    packed = torch.zeros((gy, relayout.pad_grid_x(gx)) + tuple(got.shape[2:]), device=dev)
    packed[:, :gx] = got
    cot = 0.01 * torch.randn(packed.shape, device=dev,
                             generator=torch.Generator(dev).manual_seed(1))
    g, live = rasterize_cuda.rasterize_backward(pairs, bins.tile_start, bins.tile_count, packed,
                                                cot, **kw)
    p, want_live = rasterize_cuda.rasterize_backward_plain(pairs, bins.tile_start,
                                                           bins.tile_count, packed, cot, **kw)
    total = int(bins.tile_count.sum())
    assert torch.equal(live, want_live) and total > 0
    g, p = g[:total], p[:total]
    assert bool(((g - p).abs().amax(dim=0) <= 1e-4 * p.abs().amax(dim=0)).all())


@pytest.mark.parametrize("g", [2, 4, 8])
@pytest.mark.parametrize("n", [100, 50_176])
def test_strip_pack_on_card_matches_cpu(dev, g, n):
    """The strip exchange's pack: bin_rows over g strips (grid_x = 1, X2's
    and K4's look-backs over few tiles), its buffers and demand, and its K3 backward,
    card against CPU."""
    from ed3dgs_torch.parallel import tile_sharded

    rng = np.random.default_rng(g * n)
    strip_rows = 3
    y0 = rng.integers(0, g * strip_rows, n)
    y1 = np.minimum(y0 + rng.integers(0, 2 * strip_rows, n), g * strip_rows)
    host = dict(payload=rng.normal(size=(n, 26)).astype(np.float32),
                extra=rng.normal(size=(n, 5)).astype(np.float32),
                depth=rng.uniform(1, 3, n).astype(np.float32),
                valid=rng.uniform(size=n) > 0.1, y0=y0.astype(np.int32),
                y1=y1.astype(np.int32))
    cap = max(64, 2 * n // g)
    ct = rng.normal(size=(g * cap, 31)).astype(np.float32)
    out = {}
    for d in (dev, torch.device("cpu")):
        t = {k: torch.as_tensor(v, device=d) for k, v in host.items()}
        payload = t["payload"].requires_grad_(True)
        before = (binning_scan.fused_bin_scans.launches, binning_scan.boundary_deltas.launches)
        bufs, demand = tile_sharded._pack_for_strips(payload, t["extra"], t["depth"], t["valid"],
                                                     t["y0"], t["y1"], g, strip_rows, cap)
        (grad,) = torch.autograd.grad((bufs * torch.as_tensor(ct, device=d)).sum(), payload)
        out[d.type] = (bufs.detach().cpu(), int(demand), grad.cpu(),
                       (binning_scan.fused_bin_scans.launches - before[0],
                        binning_scan.boundary_deltas.launches - before[1]))
    (bc, dc, gc, launched), (bh, dh, gh, _) = out["cuda"], out["cpu"]
    assert launched == (1, 1)
    assert torch.equal(bc, bh) and dc == dh
    assert float((gc - gh).abs().max()) <= 1e-6 * float(gh.abs().max())


# --- the step and the frame as captured CUDA graphs ----------------------------

GRAPH_W, GRAPH_H, GRAPH_N, GRAPH_CAP = 96, 64, 1500, 2048


def graph_problem(dev, pair_capacity=1 << 15):
    """A small cloud (scene()'s, with embeddings and 3D-filter scales) at
    net_width 32, its train setup and state at iteration 9, its KNN cache."""
    from ed3dgs_torch.config.params import DeformHiddenConfig, OptimizationConfig
    from ed3dgs_torch.convert import gaussians_from_numpy
    from ed3dgs_torch.train import trainer

    (means, scales, q, opac, shs, _), cam = scene(GRAPH_N, GRAPH_W, GRAPH_H, seed=3)
    rng = np.random.default_rng(4)
    fields = {"xyz": means, "features_dc": shs[:, :1], "features_rest": shs[:, 1:],
              "scaling": np.log(scales), "rotation": q,
              "opacity": np.log(opac / (1 - opac))[:, None],
              "embedding": rng.normal(0, 0.1, (GRAPH_N, 32)).astype(np.float32),
              "filter_3d": rng.uniform(5e-4, 1.5e-3, (GRAPH_N, 1)).astype(np.float32)}
    params, aux = gaussians_from_numpy(fields, capacity=GRAPH_CAP, device=dev)
    hidden = DeformHiddenConfig(net_width=32, defor_depth=1, min_embeddings=5,
                                max_embeddings=20, deform_from_iter=0, c2f_temporal_iter=100)
    opt = OptimizationConfig()
    raster = RasterConfig(width=GRAPH_W, height=GRAPH_H, focal_x=cam.focal_x,
                          focal_y=cam.focal_y, pair_capacity=pair_capacity, chunk=64)
    setup = trainer.TrainSetup(raster=raster, hidden=hidden, batch_size=2, kernel_size=0.1,
                               lambda_dssim=0.2, reg_coef=1.0, coef_tv_temporal=1e-3,
                               radegs_from_iter=11, num_down_emb=5, sh_degree=3)
    state, optimizer = trainer.init_train_state(params, hidden, opt, 2.0, seed=0)
    state = state._replace(iteration=9)
    cache = trainer.update_knn_cache(params, aux)
    return cam, setup, state, aux, optimizer, cache


def graph_batch(cam, dev, i, ssim):
    rng = np.random.default_rng(50 + i)
    rep = lambda a: torch.as_tensor(np.repeat(np.asarray(a, np.float32)[None], 2, 0),  # noqa: E731
                                    device=dev)
    return {"gt_image": torch.as_tensor(rng.uniform(0, 1, (2, 3, GRAPH_H, GRAPH_W))
                                        .astype(np.float32), device=dev),
            "viewmatrix": rep(cam.world_view), "projmatrix": rep(cam.full_proj),
            "campos": rep(cam.campos),
            "time": torch.tensor([0.13 + 0.1 * i, 0.71], device=dev),
            "cam_no": torch.tensor([1, 2], device=dev), "use_ssim": ssim}


def step_tensors(state, aux, metrics) -> dict:
    from ed3dgs_torch.train.optim import flatten_params
    out = {f"params/{k}": v for k, v in flatten_params(state.params).items()}
    for g, st in state.opt_state.items():
        out.update({f"mu/{g}/{k}": v for k, v in st.mu.items()})
        out.update({f"nu/{g}/{k}": v for k, v in st.nu.items()})
    out.update({f"aux/{k}": v for k, v in aux._asdict().items()})
    out.update({f"metrics/{k}": v for k, v in metrics.items()})
    return out


def wrapper_counts() -> dict:
    """{"module.wrapper": launches counted by the wrapper}."""
    return {w: cuda_lib.slot_wrapper(w).launches for w in cuda_lib.LAUNCH_SLOTS}


def test_graphed_step_equals_the_eager_step(dev):
    """The graphed step against the eager one from one state, bit for bit
    after every step: across SSIM on and off and the depth-normal term
    (from iteration 11), a densify step's state and a new KNN cache copied
    in, and a pair-capacity change (a new step, captured anew). Replays run
    under sync debug mode "error" and launch K1-K7 and X2 on the card
    (counted by the device counters; X2 as often as K4) as an eager step
    does, and the tracer's 13 stage
    stamps (utils/trace.py: 4 stages a camera, 4 after, the end); the
    wrappers count only the first, eager run of a key (a capture launches
    nothing)."""
    from ed3dgs_torch.config.params import OptimizationConfig
    from ed3dgs_torch.train import trainer

    cam, setup, state, aux, optimizer, cache = graph_problem(dev)
    eager = trainer.make_train_step(setup, optimizer, graph=False)
    graphed = trainer.make_train_step(setup, optimizer)
    assert isinstance(graphed, trainer.GraphedTrainStep)
    densify = [trainer.make_densify_step(OptimizationConfig(), 0.01, 2.0, graph=graph)
               for graph in (False, True)]
    e, g = (state, aux), (state, aux)
    counts = {"rasterize_cuda.rasterize_forward": 2, "rasterize_cuda.rasterize_backward": 2,
              "segment_sum.segment_sum_rows": 2, "binning_scan.fused_bin_scans": 2,
              "relayout.unpack_image": 2, "relayout.pack_image": 2, "knn_loss.knn_rows": 1,
              "knn_loss.knn_reverse": 1, "segment_sum.segment_sum_rows_packed": 0,
              "knn.knn": 0, "trace.stamp": 13, "binning_scan.boundary_deltas": 2}
    replayed = []
    for i, ssim in enumerate((True, False, True, True, True, False, False, False)):
        if i == 4:        # densify, then the filter and KNN refreshes
            out = [step(s[0], s[1], torch.Generator(device=dev).manual_seed(1), 1e-9)
                   for step, s in zip(densify, (e, g))]
            e, g = (out[0][0], out[0][1]), (out[1][0], out[1][1])
            assert int(out[0][2]) + int(out[0][3]) > 0
            cache = trainer.update_knn_cache(e[0].params["gaussians"], e[1])
        if i == 6:        # the pair capacity grows: a new step
            setup = replace(setup, raster=replace(setup.raster, pair_capacity=1 << 16))
            eager = trainer.make_train_step(setup, optimizer, graph=False)
            graphed = trainer.make_train_step(setup, optimizer)
        b = graph_batch(cam, dev, i, ssim)
        es, ea, em = eager(e[0], e[1], b, cache)
        replay = graphed.graphs is not None and graphed.key(g[0], g[1], b, cache) in graphed.graphs
        before = wrapper_counts()
        torch.cuda.synchronize()
        with cuda_lib.DeviceLaunches() as traced:
            if replay:
                torch.cuda.set_sync_debug_mode("error")
            try:
                gs, ga, gm = graphed(g[0], g[1], b, cache)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        after = wrapper_counts()
        assert traced.counts == counts, i
        assert {k: after[k] - before[k] for k in after} == (
            dict.fromkeys(counts, 0) if replay else counts), i
        want, got = step_tensors(es, ea, em), step_tensors(gs, ga, gm)
        differ = [k for k in want if not torch.equal(want[k], got[k])]
        assert not differ, (i, differ[:8])
        assert es.iteration == gs.iteration
        replayed.append(replay)
        e = (es, ea)
        g = (gs, ga)
    # step 4 replays on the densified state and the new cache; step 6, the
    # new step, captures again; step 7 replays its graph
    assert replayed == [False, False, False, True, True, False, False, True]
    assert len(graphed.graphs.captures) == 1 and graphed.graphs.pool_bytes > 0


def test_graphed_step_across_batch_sizes(dev):
    """Batches of 2, 2, 1, 2 and 2 cameras: each new input signature gets
    new static buffers and drops the graphs of the old ones, so the return
    to 2 captures anew instead of replaying a graph on freed buffers; every
    step equals the eager step bit for bit."""
    from ed3dgs_torch.train import trainer

    cam, setup, state, aux, optimizer, cache = graph_problem(dev)
    # past the depth-normal term's start: every step takes the same branches,
    # so only the batch's shapes tell the keys apart
    state = state._replace(iteration=setup.radegs_from_iter + 1)
    eager = trainer.make_train_step(setup, optimizer, graph=False)
    graphed = trainer.make_train_step(setup, optimizer)
    e, g = (state, aux), (state, aux)
    for i, n_cam in enumerate((2, 2, 1, 2, 2)):
        b = graph_batch(cam, dev, i, True)
        b = {k: v[:n_cam] if isinstance(v, torch.Tensor) else v for k, v in b.items()}
        es, ea, em = eager(e[0], e[1], b, cache)
        replay = graphed.graphs is not None and graphed.key(g[0], g[1], b, cache) in graphed.graphs
        assert replay == (i in (1, 4)), i
        gs, ga, gm = graphed(g[0], g[1], b, cache)
        want, got = step_tensors(es, ea, em), step_tensors(gs, ga, gm)
        differ = [k for k in want if not torch.equal(want[k], got[k])]
        assert not differ, (i, n_cam, differ[:8])
        e, g = (es, ea), (gs, ga)
    assert len(graphed.graphs.captures) == 3 and len(graphed.graphs.graphs) == 1


def test_capture_of_a_host_read_raises(dev, monkeypatch):
    """A step that reads a device value on the host runs its first, eager
    call and then raises at capture: it never falls back to the eager step."""
    from ed3dgs_torch.train import losses, trainer
    from ed3dgs_torch.utils.graphs import GraphCaptureError

    cam, setup, state, aux, optimizer, cache = graph_problem(dev)
    orig = losses.opacity_mean_loss

    def reads(opacity, alive):
        out = orig(opacity, alive)
        return out + 0.0 * float(out)     # a host read of a device value
    monkeypatch.setattr(losses, "opacity_mean_loss", reads)
    graphed = trainer.make_train_step(setup, optimizer)
    with pytest.raises(GraphCaptureError) as err:
        graphed(state, aux, graph_batch(cam, dev, 0, True), cache)
    assert err.value.__cause__ is not None
    assert not graphed.graphs.graphs


def test_graphed_frames_equal_render(dev, tmp_path, monkeypatch):
    """tools.render's renderer (a graph per tongue filter) and the viewer's
    handler (a graph per resolution) against `FrameRenderer(graph=False)`
    (render() op by op) on the same calls, bit for bit; each graphed frame
    launches K1 once on the card (counted by the device counters)."""
    import argparse

    from torch_offline_model import SET, make_model

    from ed3dgs_torch import tools
    from ed3dgs_torch.tools import add_model_flags, load_trained, viewer
    from ed3dgs_torch.tools import render as render_tool

    compared = []

    class AgainstEager:
        """The tool's FrameRenderer, each call held against the eager one."""

        def __init__(self, *a, **k):
            self.graphed = tools.FrameRenderer(*a, **k)
            self.eager = tools.FrameRenderer(*a, graph=False, **k)

        def __call__(self, *a, **k):
            want = self.eager(*a, **k)
            with cuda_lib.DeviceLaunches() as traced:
                got = self.graphed(*a, **k)
            assert traced.counts["rasterize_cuda.rasterize_forward"] == 1
            for key, v in want.items():
                assert torch.equal(v, got[key]), (a[0], key)
            compared.append(a[0])
            return got

    _, _, flags = make_model(str(tmp_path))
    renderers = {}

    def keep(out_dir, name, cams, renderer, *a):
        renderers.setdefault(name, (cams, renderer))
        return {}
    monkeypatch.setattr(render_tool, "render_set", keep)
    monkeypatch.setattr(render_tool, "FrameRenderer", AgainstEager)
    monkeypatch.setattr(viewer, "FrameRenderer", AgainstEager)
    render_tool.main(flags + ["--skip_video", "--device", "cuda", "--set"] + SET)
    for name, (cams, renderer) in renderers.items():
        for cam in cams[:3]:
            for tf in (None, "only"):
                renderer(cam, tongue_filter=tf)
    assert set(compared) == {"full", "only"}

    p = argparse.ArgumentParser()
    add_model_flags(p)
    cfg, sc, dparams = load_trained(p.parse_args(flags + ["--device", "cuda", "--set"] + SET),
                                    "cuda")
    handle = viewer.make_handler(cfg, sc, dparams, 0.3)
    m = sc.train_cameras[0].matrices()
    compared.clear()
    for w, h in ((64, 64), (80, 50), (64, 64)):
        req = {"width": w, "height": h, "fovx": 1.0, "fovy": 0.8,
               "world_view": np.asarray(m.world_view, np.float64),
               "full_proj": np.asarray(m.full_proj, np.float64)}
        assert handle(req).shape == (3, h, w)
    assert compared == [(64, 64), (80, 50), (64, 64)]
