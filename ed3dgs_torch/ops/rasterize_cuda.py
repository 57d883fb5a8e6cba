"""Tile blend kernels K1 (forward) and K2 (backward), the counterparts of
ed3dgs_tpu/ops/rasterize_pallas.py `rasterize_pallas_forward` and
`rasterize_pallas_backward`.

K1: one 16x16 tile per CUDA block, one thread per pixel, front to back over
the tile's depth-sorted pair rows (rows [tile_start, tile_start + min(count,
chunk*512)) of the gathered [K, 26] pair payload). The output keeps the TPU
kernel's packed layout [gy, GXP, 24, 256] and channel order (OUT_CHANNELS),
which K2 reads back.

K2: the gradient of the tile blend with respect to the pair payload, in two
passes per tile: pass A front to back records the transmittance at every
chunk boundary and the tile's live-chunk count; pass B back to front over the
live chunks turns the un-finalized output cotangents into one 26-wide
gradient row per pair. Rows past a tile's live chunks get zero rows.

On a CUDA tensor `rasterize_forward` / `rasterize_backward` launch
csrc/rasterize_forward.cu / csrc/rasterize_backward.cu; on a CPU tensor they
run `rasterize_forward_plain` / `rasterize_backward_plain`, which follow the
TPU kernels' chunked formulation (an in-chunk cumulative product and a
per-chunk transmittance carry) vectorised over tiles. Inside a tile each
kernel's warp skips the rows that cannot pass at any of its 8x4 pixels
(csrc/blend_common.cuh `meets_block`: a conservative screen box, then the
pass ellipse against the block; the copies here are `cull_box_plain` and
`meets_block_plain`): a failed pass changes nothing.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .binning import ONES_COL, PAYLOAD_SLICES, PAYLOAD_WIDTH
from .common import ALPHA_MAX, ALPHA_MIN, MEDIAN_T, NORMALIZE_EPS, T_STOP, TILE
from .relayout import PIX, pad_grid_x

# rows of the [.., OUT_PAD, PIX] kernel output
OUT_CHANNELS = {
    "color": slice(0, 3),
    "weight": slice(3, 4),
    "t_final": slice(4, 5),
    "coord": slice(5, 8),
    "mcoord": slice(8, 11),
    "depth": slice(11, 12),
    "mdepth": slice(12, 13),
    "tongue": slice(13, 14),
    "normal": slice(14, 17),
    "normal_len": slice(17, 18),   # backward residual (reference normal_length)
}
OUT_DIM = 18
OUT_PAD = 24
MAX_CHUNKS = 512    # per-tile cap: chunk * MAX_CHUNKS pairs
MAX_CHUNK = 512     # rows per chunk: the kernels' shared memory stays < 227 KB
TILE_BATCH = 256    # tiles per step of the plain version

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
BOX_FAR = 1 << 30   # cull_box_plain's bound for "the whole plane"


def _finalize(acc_w, acc_wx, acc_wy, med, t_final, pxf, pyf, half_w, half_h,
              focal_x, focal_y):
    """forward.cu:757-821 on [B, F, PIX] accumulators -> [B, OUT_PAD, PIX]."""
    S = PAYLOAD_SLICES
    weight = acc_w[:, ONES_COL]
    any_c = weight > 0.0
    inv_w = torch.where(any_c, 1.0 / torch.where(any_c, weight, torch.ones_like(weight)),
                        torch.zeros_like(weight))
    u = (pxf - half_w) / focal_x
    v = (pyf - half_h) / focal_y
    ln = torch.sqrt(u * u + v * v + 1.0)
    vp, cp, rp = S["view_point"].start, S["camera_planes"].start, S["ray_plane"].start
    coord = torch.stack([
        acc_w[:, vp + i] + acc_wx[:, cp + 2 * i] + acc_wy[:, cp + 2 * i + 1]
        for i in range(3)], dim=1)
    depth_ray = acc_w[:, S["ts"].start] + acc_wx[:, rp] + acc_wy[:, rp + 1]
    nrm = acc_w[:, S["normal"]]
    n_sq = torch.sum(nrm * nrm, dim=1)
    n_len = torch.sqrt(torch.where(n_sq < 1e-30, torch.ones_like(n_sq), n_sq))
    anyc1 = any_c[:, None]
    out_normal = torch.where(anyc1, nrm / torch.clamp_min(n_len, NORMALIZE_EPS)[:, None],
                             torch.zeros_like(nrm))
    zero = torch.zeros_like(weight)
    packed = torch.cat([
        acc_w[:, S["rgb"]], weight[:, None], t_final[:, None],
        coord * inv_w[:, None],
        torch.where(anyc1, med[:, 1:4], torch.zeros_like(med[:, 1:4])),
        ((depth_ray / ln) * inv_w)[:, None],
        torch.where(any_c, med[:, 0] / ln, zero)[:, None],
        acc_w[:, S["tongue"]], out_normal, n_len[:, None],
        torch.zeros((weight.shape[0], OUT_PAD - OUT_DIM, PIX), dtype=weight.dtype,
                    device=weight.device),
    ], dim=1)
    return packed


def _splat_alphas(block, inrow, pxf, pyf) -> dict:
    """The blend's per pair-pixel alpha terms for a [B, C, F] block of rows,
    with K1's and K2's arithmetic (the conic scaled by -0.5*log2(e) and
    -log2(e), exp2). inrow [B, C] masks rows past a tile's count."""
    S = PAYLOAD_SLICES
    mx, cc, op = S["mean2d"].start, S["conic"].start, S["opacity"].start
    col = lambda j: block[:, :, j:j + 1]                                   # noqa: E731
    dx = col(mx) - pxf[:, None, :]                                         # [B, C, PIX]
    dy = col(mx + 1) - pyf[:, None, :]
    c0e = col(cc) * (-0.5 * LOG2E)
    c1e = col(cc + 1) * (-LOG2E)
    c2e = col(cc + 2) * (-0.5 * LOG2E)
    power2 = dx * (c0e * dx + c1e * dy) + c2e * dy * dy
    e2 = torch.exp2(power2)
    alpha_raw = col(op) * e2
    alpha = torch.clamp_max(alpha_raw, ALPHA_MAX)
    passes = inrow[..., None] & (power2 <= 0.0) & (alpha >= ALPHA_MIN)
    a = torch.where(passes, alpha, torch.zeros_like(alpha))
    return dict(dx=dx, dy=dy, e2=e2, alpha_raw=alpha_raw, alpha=alpha, passes=passes,
                a=a, c0e=c0e, c1e=c1e, c2e=c2e)


def _tile_pixels(tid, grid_x, lane):
    f32 = torch.float32
    pxf = ((tid % grid_x) * TILE)[:, None].to(f32) + (lane % TILE).to(f32)
    pyf = ((tid // grid_x) * TILE)[:, None].to(f32) + (lane // TILE).to(f32)
    return pxf, pyf


def _cull_plain(rows: torch.Tensor):
    """csrc/blend_common.cuh `splat_cull` on [K, 26] rows, in the same
    float32 operations: the box [K, 4] and (kc, ka, a, b, c, r2), each [K]."""
    S = PAYLOAD_SLICES
    f32 = torch.float32
    mx, my = rows[:, S["mean2d"].start], rows[:, S["mean2d"].start + 1]
    a, b, c = (rows[:, S["conic"].start + i] for i in range(3))
    opc = rows[:, S["opacity"].start]
    alpha_min = torch.tensor(ALPHA_MIN, dtype=f32)
    ac = a * c
    det = ac - b * b
    cull = (torch.isfinite(mx) & torch.isfinite(my) & torch.isfinite(opc) & (a > 0)
            & (c > 0) & torch.isfinite(ac) & (det > torch.tensor(1e-3, dtype=f32) * ac))
    one, zero = torch.ones_like(det), torch.zeros_like(det)
    safe_det = torch.where(cull, det, one)
    r2 = (2.0 * torch.log(torch.where(cull, opc / alpha_min, one))
          + torch.tensor(1e-3, dtype=f32)) * torch.tensor(1.01, dtype=f32)
    ex = torch.sqrt(torch.where(cull, r2 * c / safe_det, one)) + 1.0
    ey = torch.sqrt(torch.where(cull, r2 * a / safe_det, one)) + 1.0
    far = float(BOX_FAR)
    box = torch.stack([torch.floor(torch.clamp_min(mx - ex, -far)),
                       torch.ceil(torch.clamp_max(mx + ex, far)),
                       torch.floor(torch.clamp_min(my - ey, -far)),
                       torch.ceil(torch.clamp_max(my + ey, far))], dim=1).to(torch.int64)
    whole = torch.tensor([-BOX_FAR, BOX_FAR, -BOX_FAR, BOX_FAR], dtype=torch.int64)
    none = torch.tensor([BOX_FAR, -BOX_FAR, BOX_FAR, -BOX_FAR], dtype=torch.int64)
    box = torch.where(cull[:, None], box, whole)
    box = torch.where((opc < alpha_min)[:, None], none, box)
    keep = lambda x, other: torch.where(cull, x, other)                     # noqa: E731
    return (box, keep(-b / torch.where(cull, c, one), zero),
            keep(-b / torch.where(cull, a, one), zero), keep(a, zero), keep(b, zero),
            keep(c, zero), keep(r2, one))


def cull_box_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernels' screen box (csrc/blend_common.cuh
    `splat_cull`): for [K, 26] pair rows, the inclusive integer pixel bounds
    [K, 4] = (x0, x1, y0, y1) outside which a row fails `_splat_alphas`' pass
    test. The whole plane (+-2^30) for a conic that is not positive definite
    or nearly degenerate or for values that are not finite; empty (x0 > x1)
    for an opacity below 1/255."""
    return _cull_plain(rows)[0]


def meets_block_plain(rows: torch.Tensor, bx0: int, by0: int) -> torch.Tensor:
    """Plain version of the kernels' per-warp test (csrc/blend_common.cuh
    `meets_block`): [K] bool, False where a row can pass at no pixel of the
    8x4 block whose top-left pixel is (bx0, by0): its box misses the block,
    or the least q over the block grown by one pixel exceeds r2."""
    box, kc, ka, a, b, c, r2 = _cull_plain(rows)
    S = PAYLOAD_SLICES
    mx, my = rows[:, S["mean2d"].start], rows[:, S["mean2d"].start + 1]
    in_box = (box[:, 1] >= bx0) & (box[:, 0] <= bx0 + 7) & (box[:, 3] >= by0) & (
        box[:, 2] <= by0 + 3)
    u0, u1 = float(bx0 - 1) - mx, float(bx0 + 8) - mx
    v0, v1 = float(by0 - 1) - my, float(by0 + 4) - my
    centre = (u0 <= 0) & (u1 >= 0) & (v0 <= 0) & (v1 >= 0)
    b2 = 2.0 * b

    def q(u, v):
        return u * (a * u + b2 * v) + c * v * v

    clamp = lambda x, lo, hi: torch.minimum(torch.maximum(x, lo), hi)      # noqa: E731
    qmin = torch.minimum(
        torch.minimum(q(u0, clamp(kc * u0, v0, v1)), q(u1, clamp(kc * u1, v0, v1))),
        torch.minimum(q(clamp(ka * v0, u0, u1), v0), q(clamp(ka * v1, u0, u1), v1)))
    return in_box & (centre | (qmin <= r2))


def _chunk_rows(pair_payload, start, count, c, chunk, rowid):
    """Rows of chunk c of each tile, [B, C, F], zero past the tile's count,
    with their row indices [B, C] and the in-count mask [B, C]."""
    inrow = rowid[None, :] < (count - c * chunk)[:, None]
    idx = torch.clamp(start[:, None] + c * chunk + rowid[None, :], 0,
                      pair_payload.shape[0] - 1)
    block = torch.where(inrow[..., None], pair_payload[idx],
                        torch.zeros((), dtype=pair_payload.dtype, device=pair_payload.device))
    return block, idx, inrow


def rasterize_forward_plain(pair_payload, tile_start, tile_count, *, grid_x: int,
                            grid_y: int, width: int, height: int, focal_x: float,
                            focal_y: float, chunk: int = 128, half_w: float | None = None,
                            half_h: float | None = None,
                            stats: dict | None = None) -> torch.Tensor:
    """Plain PyTorch version of K1 (same arguments as `rasterize_forward`),
    TILE_BATCH tiles at a time. Unwritten tile columns are zero.

    `stats`, if given, receives the blend work this input needs: "evals", the
    pair-pixel evaluations a pixel reaches while its in-chunk product is
    still >= T_STOP (once it falls below, no later row of that chunk can be
    included), and "includes", the splats blended into a pixel."""
    dev = pair_payload.device
    f32 = torch.float32
    S = PAYLOAD_SLICES
    num_tiles = grid_x * grid_y
    out = torch.zeros((grid_y, pad_grid_x(grid_x), OUT_PAD, PIX), dtype=f32, device=dev)
    count_all = torch.clamp_max(tile_count, chunk * MAX_CHUNKS)
    lane = torch.arange(PIX, device=dev)
    rowid = torch.arange(chunk, device=dev)
    vp, cp, rp, ts = (S["view_point"].start, S["camera_planes"].start,
                      S["ray_plane"].start, S["ts"].start)
    for b0 in range(0, num_tiles, TILE_BATCH):
        tid = torch.arange(b0, min(b0 + TILE_BATCH, num_tiles), device=dev)
        B = tid.shape[0]
        pxf, pyf = _tile_pixels(tid, grid_x, lane)
        start = tile_start[tid].to(torch.int64)
        count = count_all[tid].to(torch.int64)
        n_chunks = int(((count + chunk - 1) // chunk).max()) if B else 0
        t_carry = torch.ones((B, PIX), dtype=f32, device=dev)
        acc_w = torch.zeros((B, PAYLOAD_WIDTH, PIX), dtype=f32, device=dev)
        acc_wx = torch.zeros_like(acc_w)
        acc_wy = torch.zeros_like(acc_w)
        med = torch.zeros((B, 4, PIX), dtype=f32, device=dev)   # t, coord xyz
        for c in range(n_chunks):
            block, _, inrow = _chunk_rows(pair_payload, start, count, c, chunk, rowid)
            sp = _splat_alphas(block, inrow, pxf, pyf)
            dx, dy, passes, a = sp["dx"], sp["dy"], sp["passes"], sp["a"]
            p_incl = t_carry[:, None, :] * torch.cumprod(1.0 - a, dim=1)
            p_excl = torch.cat([t_carry[:, None, :], p_incl[:, :-1]], dim=1)
            include = passes & (p_incl >= T_STOP)
            w = torch.where(include, a * p_excl, torch.zeros_like(a))
            if stats is not None:
                needed = inrow[..., None] & (p_excl >= T_STOP)
                stats["evals"] = stats.get("evals", 0) + int(needed.sum())
                stats["includes"] = stats.get("includes", 0) + int(include.sum())
            t_carry = torch.where(include, p_incl, t_carry[:, None, :]).amin(dim=1)
            acc_w += torch.einsum("bcf,bcp->bfp", block, w)
            acc_wx += torch.einsum("bcf,bcp->bfp", block, w * dx)
            acc_wy += torch.einsum("bcf,bcp->bfp", block, w * dy)
            # median: last include with transmittance-before > 0.5
            mmask = include & (p_excl > MEDIAN_T)
            midx = torch.where(mmask, rowid[None, :, None], -1).amax(dim=1)  # [B, PIX]
            gi = torch.clamp_min(midx, 0)[:, None, :]
            sdx = dx.gather(1, gi)[:, 0]
            sdy = dy.gather(1, gi)[:, 0]
            sel = block.gather(1, gi[:, 0, :, None].expand(B, PIX, block.shape[2]))
            new = torch.stack([
                sel[..., ts] + sdx * sel[..., rp] + sdy * sel[..., rp + 1],
                sel[..., vp] + sdx * sel[..., cp] + sdy * sel[..., cp + 1],
                sel[..., vp + 1] + sdx * sel[..., cp + 2] + sdy * sel[..., cp + 3],
                sel[..., vp + 2] + sdx * sel[..., cp + 4] + sdy * sel[..., cp + 5],
            ], dim=1)
            med = torch.where((midx >= 0)[:, None, :], new, med)
        packed = _finalize(acc_w, acc_wx, acc_wy, med, t_carry, pxf, pyf,
                           *_half(width, height, half_w, half_h), focal_x, focal_y)
        out[tid // grid_x, tid % grid_x] = packed
    return out


def _half(width, height, half_w, half_h) -> tuple:
    """The ray origin's pixel (half_w, half_h), the image centre by default."""
    return (width / 2.0 if half_w is None else float(half_w),
            height / 2.0 if half_h is None else float(half_h))


def _check_tiles(pair_payload, tile_start, tile_count, num_tiles):
    cuda_lib.check_cuda(pair_payload, "pair_payload", torch.float32, 2)
    if pair_payload.shape[1] != PAYLOAD_WIDTH:
        raise ValueError(f"pair_payload rows must be {PAYLOAD_WIDTH} wide")
    for name, t in (("tile_start", tile_start), ("tile_count", tile_count)):
        cuda_lib.check_cuda(t, name, torch.int32, 1)
        if t.shape[0] != num_tiles:
            raise ValueError(f"{name} must have {num_tiles} entries")


def _check_chunk(chunk: int):
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} must be in 1..{MAX_CHUNK}")


def kernel_info(kernel: str, chunk: int = 128) -> dict:
    """K1's ("rasterize_forward") or K2's ("rasterize_backward") registers
    per thread, shared memory per CTA at `chunk` and resident CTAs per SM,
    as the card reports them."""
    fn = {"rasterize_forward": "ed3dgs_forward_blend_info",
          "rasterize_backward": "ed3dgs_backward_blend_info"}[kernel]
    _check_chunk(chunk)
    out = [ctypes.c_int(0) for _ in range(3)]
    err = getattr(cuda_lib.lib(kernel), fn)(chunk, *(ctypes.addressof(v) for v in out))
    cuda_lib.check_launch(err, fn)
    return dict(registers=out[0].value, smem_bytes=out[1].value, ctas_per_sm=out[2].value)


def rasterize_forward(pair_payload, tile_start, tile_count, *, grid_x: int,
                      grid_y: int, width: int, height: int, focal_x: float,
                      focal_y: float, chunk: int = 128, half_w: float | None = None,
                      half_h: float | None = None) -> torch.Tensor:
    """Blend every tile. pair_payload [K, 26] float32 rows in pair order;
    tile_start / tile_count [grid_x*grid_y] int32. Returns the packed
    [grid_y, GXP, 24, 256] channels; tile columns grid_x..GXP are left
    unwritten. A pixel's ray is ((x - half_w) / focal_x, (y - half_h) /
    focal_y, 1); half_w and half_h default to the image centre, and a strip
    of a larger image passes the full image's, shifted to its first row."""
    if not pair_payload.is_cuda:
        return rasterize_forward_plain(
            pair_payload, tile_start, tile_count, grid_x=grid_x, grid_y=grid_y,
            width=width, height=height, focal_x=focal_x, focal_y=focal_y,
            chunk=chunk, half_w=half_w, half_h=half_h)
    num_tiles = grid_x * grid_y
    _check_tiles(pair_payload, tile_start, tile_count, num_tiles)
    _check_chunk(chunk)
    gxp = pad_grid_x(grid_x)
    out = torch.empty((grid_y, gxp, OUT_PAD, PIX), dtype=torch.float32,
                      device=pair_payload.device)
    with torch.cuda.device(pair_payload.device):
        err = cuda_lib.lib("rasterize_forward").ed3dgs_forward_blend(
            pair_payload.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
            out.data_ptr(), num_tiles, grid_x, gxp, chunk,
            chunk * MAX_CHUNKS, focal_x, focal_y, *_half(width, height, half_w, half_h),
            cuda_lib.stream_of(pair_payload))
    cuda_lib.check_launch(err, "rasterize_forward")
    cuda_lib.count_launch(rasterize_forward)
    return out


rasterize_forward.launches = 0


def _unfinalize(pk, ct, ln):
    """Output cotangents of one tile batch -> the accumulator cotangents
    (rasterize_pallas.py:425-461). pk, ct [B, OUT_PAD, PIX]; ln [B, PIX].
    Returns a dict of [B, PIX] (or [B, k, PIX]) terms."""
    OC = OUT_CHANNELS
    W = pk[:, OC["weight"].start]
    anyc = W > 0.0
    safe_W = torch.where(anyc, W, torch.ones_like(W))
    zero = torch.zeros_like(W)
    cot_W = ct[:, OC["weight"].start]
    ec, cot_ec = pk[:, OC["coord"]], ct[:, OC["coord"]]
    cot_Ac = torch.where(anyc[:, None], cot_ec / safe_W[:, None], torch.zeros_like(cot_ec))
    cot_W = cot_W - torch.where(anyc, torch.sum(cot_ec * ec, dim=1) / safe_W, zero)
    ed, cot_ed = pk[:, OC["depth"].start], ct[:, OC["depth"].start]
    cot_Ad = torch.where(anyc, cot_ed / (ln * safe_W), zero)
    cot_W = cot_W - torch.where(anyc, cot_ed * ed / safe_W, zero)
    cot_mt = torch.where(anyc, ct[:, OC["mdepth"].start] / ln, zero)
    cot_mc = torch.where(anyc[:, None], ct[:, OC["mcoord"]], torch.zeros_like(ec))
    nrm, nlen = pk[:, OC["normal"]], pk[:, OC["normal_len"].start]
    cot_nrm = ct[:, OC["normal"]]
    inv_len = torch.where(anyc, 1.0 / torch.clamp_min(nlen, NORMALIZE_EPS), zero)
    ndot = torch.sum(nrm * cot_nrm, dim=1)
    degen = nlen * nlen < 1e-30
    cot_An = torch.where(degen[:, None],
                         cot_nrm * torch.where(anyc, torch.full_like(W, 1.0 / NORMALIZE_EPS),
                                               zero)[:, None],
                         (cot_nrm - nrm * ndot[:, None]) * inv_len[:, None])
    return dict(rgb=ct[:, OC["color"]], tongue=ct[:, OC["tongue"].start], Ac=cot_Ac,
                Ad=cot_Ad, mt=cot_mt, mc=cot_mc, An=cot_An, W=cot_W,
                tfin=ct[:, OC["t_final"].start] * pk[:, OC["t_final"].start])


def _cotangent_matrices(u):
    """The six [B, F, PIX] cotangent matrices of rasterize_pallas.py:463-503:
    a pixel's gradient row for a splat of weight w at offset (dx, dy) is
    w@M1 + (w dx)@M2 + (w dy)@M3, plus sel@N1 + (sel dx)@N2 + (sel dy)@N3 for
    the splat its median channels selected."""
    S = PAYLOAD_SLICES
    B, P = u["W"].shape
    z = lambda: torch.zeros((B, PAYLOAD_WIDTH, P), dtype=u["W"].dtype,  # noqa: E731
                            device=u["W"].device)
    M1, M2, M3, N1, N2, N3 = z(), z(), z(), z(), z(), z()
    vp, cp, rp, ts = (S["view_point"].start, S["camera_planes"].start,
                      S["ray_plane"].start, S["ts"].start)
    M1[:, S["rgb"]] = u["rgb"]
    M1[:, S["tongue"].start] = u["tongue"]
    M1[:, S["view_point"]] = u["Ac"]
    M1[:, ts] = u["Ad"]
    M1[:, S["normal"]] = u["An"]
    M1[:, ONES_COL] = u["W"]
    N1[:, S["view_point"]] = u["mc"]
    N1[:, ts] = u["mt"]
    for i in range(3):
        M2[:, cp + 2 * i] = u["Ac"][:, i]
        M3[:, cp + 2 * i + 1] = u["Ac"][:, i]
        N2[:, cp + 2 * i] = u["mc"][:, i]
        N3[:, cp + 2 * i + 1] = u["mc"][:, i]
    M2[:, rp] = u["Ad"]
    M3[:, rp + 1] = u["Ad"]
    N2[:, rp] = u["mt"]
    N3[:, rp + 1] = u["mt"]
    return M1, M2, M3, N1, N2, N3


def rasterize_backward_plain(pair_payload, tile_start, tile_count, packed, cot, *,
                             grid_x: int, grid_y: int, width: int, height: int,
                             focal_x: float, focal_y: float, chunk: int = 128,
                             half_w: float | None = None, half_h: float | None = None):
    """Plain PyTorch version of K2 (same arguments and results as
    `rasterize_backward`), TILE_BATCH tiles at a time. Rows past the last
    tile's, which K2 leaves unwritten, are zero here."""
    dev = pair_payload.device
    f32 = torch.float32
    num_tiles = grid_x * grid_y
    K = pair_payload.shape[0]
    dpay = torch.zeros((K, PAYLOAD_WIDTH), dtype=f32, device=dev)
    clive_all = torch.zeros(num_tiles, dtype=torch.int32, device=dev)
    count_all = torch.clamp_max(tile_count, chunk * MAX_CHUNKS)
    lane = torch.arange(PIX, device=dev)
    rowid = torch.arange(chunk, device=dev)
    ein = lambda x, m: torch.einsum("bcp,bfp->bcf", x, m)                  # noqa: E731
    pxy = lambda x, m: torch.einsum("bcf,bfp->bcp", x, m)                  # noqa: E731
    for b0 in range(0, num_tiles, TILE_BATCH):
        tid = torch.arange(b0, min(b0 + TILE_BATCH, num_tiles), device=dev)
        B = tid.shape[0]
        pxf, pyf = _tile_pixels(tid, grid_x, lane)
        start = tile_start[tid].to(torch.int64)
        count = count_all[tid].to(torch.int64)
        n_chunks = (count + chunk - 1) // chunk
        # ---- pass A: checkpoints tchk[c] (the carry entering chunk c) and the
        # live-chunk count: the loop runs while c < n_chunks and some pixel's
        # carry is still >= T_STOP
        t_carry = torch.ones((B, PIX), dtype=f32, device=dev)
        running = torch.ones(B, dtype=torch.bool, device=dev)
        clive = torch.zeros(B, dtype=torch.int64, device=dev)
        tchk = []
        for c in range(int(n_chunks.max()) if B else 0):
            tchk.append(t_carry)
            running = running & (c < n_chunks) & (t_carry.amax(dim=1) >= T_STOP)
            block, _, inrow = _chunk_rows(pair_payload, start, count, c, chunk, rowid)
            sp = _splat_alphas(block, inrow, pxf, pyf)
            p_incl = t_carry[:, None, :] * torch.cumprod(1.0 - sp["a"], dim=1)
            include = sp["passes"] & (p_incl >= T_STOP)
            new_t = torch.where(include, p_incl, t_carry[:, None, :]).amin(dim=1)
            t_carry = torch.where(running[:, None], new_t, t_carry)
            clive = clive + running.to(torch.int64)
        clive_all[tid] = clive.to(torch.int32)
        # ---- un-finalize the output cotangents
        ty, tx = tid // grid_x, tid % grid_x
        hw, hh = _half(width, height, half_w, half_h)
        u = (pxf - hw) / focal_x
        v = (pyf - hh) / focal_y
        ln = torch.sqrt(u * u + v * v + 1.0)
        cu = _unfinalize(packed[ty, tx], cot[ty, tx], ln)
        M1, M2, M3, N1, N2, N3 = _cotangent_matrices(cu)
        tfin = cu["tfin"][:, None, :]
        # ---- pass B: back to front over the live chunks
        s_carry = torch.zeros((B, PIX), dtype=f32, device=dev)
        med_done = torch.zeros((B, PIX), dtype=torch.bool, device=dev)
        for c in range(int(clive.max()) - 1 if B else -1, -1, -1):
            live = c < clive
            block, idx, inrow = _chunk_rows(pair_payload, start, count, c, chunk, rowid)
            inrow = inrow & live[:, None]
            sp = _splat_alphas(block, inrow, pxf, pyf)
            dx, dy, a, alpha = sp["dx"], sp["dy"], sp["a"], sp["alpha"]
            om = 1.0 - a
            t_c = tchk[c][:, None, :]
            p_incl = t_c * torch.cumprod(om, dim=1)
            p_excl = torch.cat([t_c, p_incl[:, :-1]], dim=1)
            include = sp["passes"] & (p_incl >= T_STOP)
            zero = torch.zeros_like(a)
            w = torch.where(include, a * p_excl, zero)
            G2, G3 = pxy(block, M2), pxy(block, M3)
            G = pxy(block, M1) + dx * G2 + dy * G3
            # median cotangent: once per pixel, to the last selecting splat
            mmask = include & (p_excl > MEDIAN_T)
            midx = torch.where(mmask, rowid[None, :, None], -1).amax(dim=1)       # [B, PIX]
            sel = ((rowid[None, :, None] == midx[:, None, :]) & mmask
                   & ~med_done[:, None, :]).to(f32)
            med_done = med_done | (midx >= 0)
            H2, H3 = pxy(block, N2), pxy(block, N3)
            # alpha gradient with the suffix sum of later splats' w*G
            uu = w * G
            pref = torch.cumsum(uu, dim=1)
            total = pref[:, -1:, :]
            s_after = s_carry[:, None, :] + (total - pref)
            da = torch.where(include, p_excl * G - (s_after + tfin) / om, zero)
            s_carry = s_carry + total[:, 0, :]
            notcl = (sp["alpha_raw"] < ALPHA_MAX).to(f32)
            dpow = da * alpha * notcl
            dop_pp = da * sp["e2"] * notcl
            dB = (ein(w, M1) + ein(w * dx, M2) + ein(w * dy, M3)
                  + ein(sel, N1) + ein(sel * dx, N2) + ein(sel * dy, N3))
            dpl = dpow * LN2
            ddx = dpl * (sp["c0e"] * 2.0 * dx + sp["c1e"] * dy) + w * G2 + sel * H2
            ddy = dpl * (sp["c2e"] * 2.0 * dy + sp["c1e"] * dx) + w * G3 + sel * H3
            head = torch.stack([ddx.sum(2), ddy.sum(2), (-0.5 * dx * dx * dpow).sum(2),
                                (-dx * dy * dpow).sum(2), (-0.5 * dy * dy * dpow).sum(2),
                                dop_pp.sum(2)], dim=2)                      # [B, C, 6]
            dB = torch.cat([dB[..., :6] + head, dB[..., 6:]], dim=2)
            dpay[idx[inrow]] = dB[inrow]      # head: columns 0..5 (mean2d, conic, opacity)
    return dpay, clive_all


def rasterize_backward(pair_payload, tile_start, tile_count, packed, cot, *,
                       grid_x: int, grid_y: int, width: int, height: int,
                       focal_x: float, focal_y: float, chunk: int = 128,
                       half_w: float | None = None, half_h: float | None = None):
    """Gradient of `rasterize_forward` with respect to pair_payload.

    packed is the forward's output and cot its cotangent, both [grid_y, GXP,
    24, 256]. Returns (d pair_payload [K, 26], live_chunks [T] int32). Every
    row of every tile, [tile_start, tile_start + tile_count), is written: a
    row past the tile's first live_chunks chunks (or past the cap) blends
    nowhere and gets a zero row. Rows past the last tile's hold whatever the
    buffer held."""
    if not pair_payload.is_cuda:
        return rasterize_backward_plain(
            pair_payload, tile_start, tile_count, packed, cot, grid_x=grid_x,
            grid_y=grid_y, width=width, height=height, focal_x=focal_x,
            focal_y=focal_y, chunk=chunk, half_w=half_w, half_h=half_h)
    num_tiles = grid_x * grid_y
    _check_tiles(pair_payload, tile_start, tile_count, num_tiles)
    gxp = pad_grid_x(grid_x)
    for name, t in (("packed", packed), ("cot", cot)):
        cuda_lib.check_cuda(t, name, torch.float32, 4)
        if tuple(t.shape) != (grid_y, gxp, OUT_PAD, PIX):
            raise ValueError(f"{name} must be [{grid_y}, {gxp}, {OUT_PAD}, {PIX}]")
    _check_chunk(chunk)
    K = pair_payload.shape[0]
    dev = pair_payload.device
    dpay = torch.empty((K, PAYLOAD_WIDTH), dtype=torch.float32, device=dev)
    clive = torch.empty(num_tiles, dtype=torch.int32, device=dev)
    # per chunk and pixel: the transmittance entering the chunk, the chunk's
    # sum of w*G and its median row; tile t keeps its n_chunks+1 rows of 256
    # of each plane at row 2t + ceil(tile_start/chunk), which never overlaps
    # the next tile's
    tchk = torch.empty((3, 2 * num_tiles + (K + chunk - 1) // chunk + 1, PIX),
                       dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_lib.lib("rasterize_backward").ed3dgs_backward_blend(
            pair_payload.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
            packed.data_ptr(), cot.data_ptr(), dpay.data_ptr(), clive.data_ptr(),
            tchk[0].data_ptr(), tchk[1].data_ptr(), tchk[2].data_ptr(), num_tiles, grid_x,
            gxp, chunk, chunk * MAX_CHUNKS, focal_x, focal_y,
            *_half(width, height, half_w, half_h), cuda_lib.stream_of(pair_payload))
    cuda_lib.check_launch(err, "rasterize_backward")
    cuda_lib.count_launch(rasterize_backward)
    return dpay, clive


rasterize_backward.launches = 0

