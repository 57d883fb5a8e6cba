"""ed3dgs_torch's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; each test skips without a CUDA device. The file imports neither
JAX nor the JAX package, so on a machine without JAX it runs without the
repo's conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: K4, K5a and K5b bit-exact (integer scans; permutations). K1 at
atol 1e-4 plus rtol 1e-4 on every pixel: the kernel sums and multiplies in
sequence where the plain version uses torch.cumprod and einsum, and the
expected-coordinate channels divide by the blend weight. Only the median
channels may differ beyond that, for a pixel whose transmittance sits at the
0.5 crossing; at most 0.1% of pixels may do so. K2: live-chunk counts
exactly, every row of every tile within 1e-4 of its column's largest value
(the same orders of summation differ), zero where the plain version's is,
and bit-identical from run to run; K1 and K2 are held so on scenes and on
synthetic tiles that probe the warps' row skipping (`blend_case`). K3: within
1e-6 of the largest output (both round an exact-to-float64 sum once); K8,
the same kernel under its own counter, likewise. K6 and K7
(the KNN regulariser) against their plain versions: the loss within 1e-5
relative, every row of dL/demb within 1e-5 of that row's largest value (the
kernel reduces d2 by a shuffle butterfly and the loss by CTA partials; the
terms are otherwise the same operations), and bit-identical from run to run.
"""

import math

import numpy as np
import pytest
import torch

from ed3dgs_torch.core.projection import project_gaussians
from ed3dgs_torch.data.cameras import look_at_camera
from ed3dgs_torch.ops import (binning, binning_scan, knn, knn_loss, rasterize_cuda, relayout,
                              segment_sum)
from ed3dgs_torch.ops.rasterize import RasterConfig, rasterize

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


def knn_graph_case(dev, C, K, spatial, caps, seed=0):
    """A KNN graph on the card: neighbours by position (the trainer's kind)
    or at random (no locality: the far and spill lists fill up)."""
    g = torch.Generator(dev).manual_seed(seed)
    pts = torch.rand(C, 3, device=dev, generator=g) * 2 - 1
    if spatial:
        d2, idx = knn.knn(pts, k=K)
        w = torch.exp(-20.0 * d2)
    else:
        idx = torch.randint(0, C, (C, K), device=dev, generator=g)
        w = torch.rand(C, K, device=dev, generator=g)
    mask = torch.rand(C, device=dev, generator=g) > 0.1
    w = w * mask[:, None]
    coef = mask.float() / (mask.sum() * K)
    graph = knn_loss.prepare_knn_graph(idx, w, coef, pts, pts_valid=mask, **caps)
    emb = torch.randn(C, 32, device=dev, generator=g) * 0.3
    return graph, emb


@pytest.mark.parametrize("C,K,spatial,caps,overflows", [
    # the trainer's default buckets drop ~0.7% of this cloud's edges
    (100_000, 20, True, dict(spill_a=256, spill_b=768, far_capacity=1 << 19), True),
    (3000, 20, False, dict(spill_a=256, spill_b=256, far_capacity=256), True),
    (700, 5, False, {}, False)])
def test_knn_loss_kernels_match_plain(dev, C, K, spatial, caps, overflows):
    graph, emb = knn_graph_case(dev, C, K, spatial, caps)
    assert bool((graph.overflow > 0).any()) == overflows
    Cp = graph.pi.shape[0]
    emb_r = torch.cat([emb, emb.new_zeros(Cp - C, 32)])[graph.pi].contiguous()
    before = (knn_loss.knn_rows.launches, knn_loss.knn_reverse.launches)
    loss, de, s = knn_loss.knn_rows(emb_r, graph.nbr, graph.w, graph.coef)
    out = knn_loss.knn_reverse(emb_r, s, de, graph.rev_ptr, graph.rev_pair)
    loss2, de2, s2 = knn_loss.knn_rows(emb_r, graph.nbr, graph.w, graph.coef)
    out2 = knn_loss.knn_reverse(emb_r, s2, de2, graph.rev_ptr, graph.rev_pair)
    torch.cuda.synchronize()
    assert (knn_loss.knn_rows.launches, knn_loss.knn_reverse.launches) == (
        before[0] + 2, before[1] + 2)
    assert torch.equal(loss, loss2) and torch.equal(out, out2)        # no atomics
    loss_p, de_p, s_p = knn_loss.knn_rows_plain(emb_r, graph.nbr, graph.w, graph.coef)
    out_p = knn_loss.knn_reverse_plain(emb_r, s_p, de_p, graph.rev_ptr, graph.rev_pair)
    assert abs(float(loss) - float(loss_p)) <= 1e-5 * abs(float(loss_p))
    assert torch.isfinite(out).all()
    row_max = out_p.abs().amax(dim=1)
    assert bool(((out - out_p).abs().amax(dim=1) <= 1e-5 * row_max).all())
    # through the autograd Function: the same gradient
    e = emb.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(knn_loss.knn_loss_fused(e, graph, K), e)
    assert torch.equal(g, out[graph.inv[:C]])


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
