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
and bit-identical from run to run. K3: within 1e-6 of the largest output (both round an exact-to-float64
sum once); K8, the same kernel under its own counter, likewise. K6 and K7
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
    # leave NaN in the block the caching allocator hands the output next, so
    # that a row K2 fails to write shows
    torch.full((pairs.shape[0], 26), float("nan"), device=dev)
    got, live = rasterize_cuda.rasterize_backward(pairs, bins.tile_start, bins.tile_count,
                                                  packed, cot, **kw)
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
