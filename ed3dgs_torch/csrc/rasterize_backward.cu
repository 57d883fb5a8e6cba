// K2: backward blend of one 16x16 tile per CTA.
//
// Replaces the Pallas TPU kernel ed3dgs_tpu/ops/rasterize_pallas.py::
// _backward_kernel (entry rasterize_pallas_backward, pallas_call at :654): the
// gradient of K1 (csrc/rasterize_forward.cu) with respect to the gathered
// [K, 26] pair payload, one row per pair, with K1's semantics (the in-chunk
// product that keeps multiplying after a failed include, the carry that
// restarts from the last include at a chunk boundary) and K1's exact mask
// arithmetic (splat_at in blend_common.cuh, built with -fmad=false like K1),
// so a pair gets a gradient row where K1 blended it and nowhere else.
//
// One thread per pixel; the tile's rows are staged in shared memory a chunk
// at a time, as in K1.
//   Un-finalize first: the output cotangents of the tile's pixels become the
//     cotangents of the blend accumulators (rasterize_pallas.py:425-461).
//   Pass A, front to back: for every chunk, the transmittance entering it,
//     the sum over its includes of w*G (G: the pixel's cotangent dotted with
//     the splat's row, with its dx and dy parts) and its median splat (the
//     last include with T_before > 0.5), written to a global scratch buffer
//     (the TPU keeps such rows in VMEM; a tile's [513, 256] floats exceed a
//     CTA's 227 KB of shared memory). Tile t owns n_chunks+1 rows of 256
//     floats of each of the three planes from row 2t + ceil(tile_start/chunk).
//     The loop stops once no pixel's carry is >= 1e-4; the number of chunks
//     run is the tile's live-chunk count.
//   Pass B, back to front over the live chunks, each walked once from its
//     checkpoint: each row's gradient terms, where the suffix sum of later
//     splats' w*G is the carried sum plus the chunk total minus the running
//     prefix. Pass A's total and pass B's prefix are the same fmaf chain over
//     the same includes, so the prefix ends at the total exactly. Exact under
//     these semantics, unlike dividing by (1-alpha) back to front.
//   Each row's 26 columns are summed over the 256 pixels in a fixed order:
//     in each warp a reduce-scatter butterfly that halves the columns a lane
//     holds at each of five steps (13 + 7 + 4 + 2 + 1 = 27 shuffles; 26
//     lanes end with one column's warp sum each), skipped where no lane of
//     the warp includes the row or selects it as its median; the warp sums
//     of 32 rows wait in shared memory, and after a barrier the 8 warps are
//     added in warp order and the 32 rows stored as one contiguous span. No
//     atomics: each pair row belongs to one tile and is written once, so the
//     result is bit-identical from run to run. The tile's rows past its live
//     chunks (and past the cap) get zero rows, so every row of [tile_start,
//     tile_start + tile_count) is written and the caller needs no mask.
//
// Bound on the H100: the function needs two alpha evaluations per needed
// pair-pixel (~14 flops each) and ~120 flops per blended splat (one
// cotangent dot, the alpha gradient, 26 terms), and moves the live pair rows,
// 10 packed and 17 cotangent channels and the gradient rows; chip_smoke.py
// computes both from its run's inputs and reports the larger (operations) as
// bound_ms. What held the first version at 40x that bound: a shuffle
// tree of 26 columns x 5 steps for every row a warp touched (130 shuffles,
// which issue at a quarter of the fp32 rate), a barrier per row, three
// alpha evaluations of every row at every pixel, and scalar staging with
// nothing in flight. This design: the reduce-scatter (27 shuffles) and two
// barriers per 32 rows above; the chunk totals and medians taken in pass A,
// so alpha is evaluated twice; the warp walk of blend_common.cuh (a warp
// visits only rows that can pass at its 8x4 pixel block, by box and then by
// ellipse, and leaves a chunk once every lane's product is below 1e-4);
// cp.async staging of the next chunk (the previous one, in pass B) while
// this one is computed, and pass B starts on the chunk pass A left staged;
// fused multiply-adds, written out as fmaf(), in the cotangent dot and the
// gradient terms, none on the mask path; three CTAs per SM (80 registers, a
// few bytes spilled; one ~27 KB buffer of warp sums, so ~57 KB of shared
// memory a CTA at chunk 128), which measured faster than two CTAs with
// double-buffered sums and no spills. Tiles are launched in tile order, as
// in K1 (longest first was measured not to pay, PERF.md). The card's own
// count of registers, shared memory and resident CTAs:
// ed3dgs_backward_blend_info (printed by chip_smoke.py).

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr float LN2 = 0.6931471805599453f;

constexpr int PART = GROUP * WARPS * F;  // floats of one buffer of warp sums
constexpr int MIN_CTAS = 3;  // CTAs of 256 threads per SM: 80 registers a thread

// staging, then the warp sums [GROUP][WARPS][F] and the touched-row masks
// [WARPS]
size_t smem_bytes(int chunk) {
  return stage_bytes(chunk) + PART * sizeof(float) + WARPS * sizeof(unsigned);
}

int smem_limit[MAX_DEVICES] = {};  // dynamic shared bytes allowed, per device

// cotangents of the blend accumulators at one pixel
struct Cot {
  float rgb[3], tng, ac[3], ad, mt, mc[3], an[3], w, tfin;
};

// The pixel's cotangent dotted with a splat's row: G = G1 + dx*G2 + dy*G3.
// Pass A's chunk total and pass B's prefix both sum w*G from this one chain
// of operations.
__device__ __forceinline__ float cot_dot(const Cols& r, const Cot& g, float dx, float dy,
                                         float& G2, float& G3) {
  float G1 = r.rgb[0] * g.rgb[0];
  G1 = fmaf(r.rgb[1], g.rgb[1], G1);
  G1 = fmaf(r.rgb[2], g.rgb[2], G1);
  G1 = fmaf(r.tng, g.tng, G1);
  G1 = fmaf(r.vp[0], g.ac[0], G1);
  G1 = fmaf(r.vp[1], g.ac[1], G1);
  G1 = fmaf(r.vp[2], g.ac[2], G1);
  G1 = fmaf(r.ts, g.ad, G1);
  G1 = fmaf(r.nrm[0], g.an[0], G1);
  G1 = fmaf(r.nrm[1], g.an[1], G1);
  G1 = fmaf(r.nrm[2], g.an[2], G1);
  G1 = fmaf(r.ones, g.w, G1);
  G2 = fmaf(r.rp[0], g.ad, fmaf(r.cp[4], g.ac[2], fmaf(r.cp[2], g.ac[1], r.cp[0] * g.ac[0])));
  G3 = fmaf(r.rp[1], g.ad, fmaf(r.cp[5], g.ac[2], fmaf(r.cp[3], g.ac[1], r.cp[1] * g.ac[0])));
  return fmaf(dy, G3, fmaf(dx, G2, G1));
}

// One step of the warp's reduce-scatter over its first M columns: lanes
// with bit B set keep columns H..M-1 (H = ceil(M/2)) in v[0..M-H-1], the
// others columns 0..H-1, each adding its partner's copy; a slot past M holds
// 0. Templates, so that every index of v is a constant and v stays in
// registers.
template <int M, int B>
__device__ __forceinline__ void scatter_step(float (&v)[F], int lane) {
  constexpr int H = (M + 1) / 2;
  const bool up = lane & B;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float lo = v[i];
    const float hi = i + H < M ? v[i + H] : 0.0f;
    const float send = up ? lo : hi;
    const float keep = up ? hi : lo;
    v[i] = keep + __shfl_xor_sync(FULL, send, B);
  }
}

// Sum v over the warp's 32 lanes: 13 + 7 + 4 + 2 + 1 = 27 shuffles, after
// which v[0] of lane l is the warp sum of column scatter_column(l) (26 of
// the 32 lanes hold one column each; the others, -1, hold nothing).
__device__ __forceinline__ float reduce_scatter(float (&v)[F], int lane) {
  scatter_step<26, 16>(v, lane);
  scatter_step<13, 8>(v, lane);
  scatter_step<7, 4>(v, lane);
  scatter_step<4, 2>(v, lane);
  scatter_step<2, 1>(v, lane);
  return v[0];
}

__device__ __forceinline__ int scatter_column(int lane) {
  int start = 0, m = F, size = F;
  for (int bit = 16; bit >= 1; bit >>= 1) {
    const int h = (m + 1) / 2;
    if (lane & bit) {
      start += h;
      size = max(size - h, 0);
    } else {
      size = min(size, h);
    }
    m = h;
  }
  return size == 1 ? start : -1;
}

__device__ __forceinline__ Cot unfinalize(const float* pk, const float* ct, float px, float py,
                                          float focal_x, float focal_y, float half_w,
                                          float half_h) {
  Cot g;
  const float u = (px - half_w) / focal_x;
  const float v = (py - half_h) / focal_y;
  const float ln = sqrtf(u * u + v * v + 1.0f);
  const float W = pk[O_WEIGHT * PIX];
  const bool anyc = W > 0.0f;
  const float safe_W = anyc ? W : 1.0f;
  float cot_W = ct[O_WEIGHT * PIX];
  float dot = 0.0f;
  for (int i = 0; i < 3; ++i) {
    const float cot_ec = ct[(O_COORD + i) * PIX];
    g.ac[i] = anyc ? cot_ec / safe_W : 0.0f;
    dot = dot + cot_ec * pk[(O_COORD + i) * PIX];
    g.rgb[i] = ct[(O_COLOR + i) * PIX];
    g.mc[i] = anyc ? ct[(O_MCOORD + i) * PIX] : 0.0f;
  }
  cot_W = cot_W - (anyc ? dot / safe_W : 0.0f);
  const float cot_ed = ct[O_DEPTH * PIX];
  g.ad = anyc ? cot_ed / (ln * safe_W) : 0.0f;
  cot_W = cot_W - (anyc ? cot_ed * pk[O_DEPTH * PIX] / safe_W : 0.0f);
  g.w = cot_W;
  g.mt = anyc ? ct[O_MDEPTH * PIX] / ln : 0.0f;
  g.tng = ct[O_TONGUE * PIX];
  const float nlen = pk[O_NLEN * PIX];
  const float inv_len = anyc ? 1.0f / fmaxf(nlen, NORMALIZE_EPS) : 0.0f;
  float nrm[3], cn[3], ndot = 0.0f;
  for (int i = 0; i < 3; ++i) {
    nrm[i] = pk[(O_NORMAL + i) * PIX];
    cn[i] = ct[(O_NORMAL + i) * PIX];
    ndot = ndot + nrm[i] * cn[i];
  }
  const bool degen = nlen * nlen < 1e-30f;
  for (int i = 0; i < 3; ++i)
    g.an[i] = degen ? cn[i] * (anyc ? 1.0f / NORMALIZE_EPS : 0.0f)
                    : (cn[i] - nrm[i] * ndot) * inv_len;
  g.tfin = ct[O_TFINAL * PIX] * pk[O_TFINAL * PIX];
  return g;
}

__global__ void __launch_bounds__(PIX, MIN_CTAS)
backward_blend(const float* __restrict__ payload, const int* __restrict__ tile_start,
               const int* __restrict__ tile_count, const float* __restrict__ packed,
               const float* __restrict__ cot, float* __restrict__ dpay,
               int* __restrict__ live_chunks, float* __restrict__ tchk,
               float* __restrict__ ttot, float* __restrict__ tmed, int grid_x, int gxp,
               int chunk, int cap, float focal_x, float focal_y, float half_w, float half_h) {
  extern __shared__ float4 smem4[];
  Stage st;
  st.raw = reinterpret_cast<float*>(smem4);
  st.rows = st.raw + raw_floats(chunk);
  float* part = st.rows + chunk * ROW;                           // [GROUP][WARPS][F]
  unsigned* tch = reinterpret_cast<unsigned*>(part + PART);       // [WARPS]
  const int t = blockIdx.x;  // the tile
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tile_x = t % grid_x, tile_y = t / grid_x;
  const Pixel q = pixel_of(tile_x, tile_y, tid);
  const int my_col = scatter_column(lane);  // the gradient column this lane sums
  const long start = tile_start[t];
  const int count = min(tile_count[t], cap);
  const int n_chunks = (count + chunk - 1) / chunk;
  const long ck0 = (2L * t + (start + chunk - 1) / chunk) * PIX + q.p;
  float* ckT = tchk + ck0;   // transmittance entering chunk c: ckT[c * PIX]
  float* ckS = ttot + ck0;   // the chunk's sum of w*G
  float* ckM = tmed + ck0;   // the chunk's median row (int bits), -1 if none
  if (n_chunks > 0) stage_issue(st, payload, start, min(chunk, count), tid);

  // ---- un-finalize the output cotangents
  const long tile_off = ((long)tile_y * gxp + tile_x) * OUT_PAD * PIX + q.p;
  const Cot g = unfinalize(packed + tile_off, cot + tile_off, q.px, q.py, focal_x, focal_y,
                           half_w, half_h);

  // ---- pass A: checkpoints, chunk totals and medians, live-chunk count
  float T = 1.0f;
  ckT[0] = T;
  int c_live = 0;
  bool go = n_chunks > 0;  // max carry starts at 1 >= T_STOP
  while (go) {
    const int c = c_live;
    const int n = min(chunk, count - c * chunk);
    stage_finish(st, n, tid);
    if (c + 1 < n_chunks)
      stage_issue(st, payload, start + (long)(c + 1) * chunk,
                  min(chunk, count - (c + 1) * chunk), tid);
    float P = T, new_t = T, total = 0.0f;
    int midx = -1;
    auto pass_a_row = [&](int j) {
      const float* r = st.rows + j * ROW;
      const Splat s = splat_at(r, q.px, q.py);
      if (!s.passes) return;
      const float p_excl = P;
      P = P * (1.0f - s.alpha);
      if (!(P >= T_STOP)) return;
      new_t = P;
      const float w = s.alpha * p_excl;
      float G2, G3;
      total = fmaf(w, cot_dot(load_cols(r), g, s.dx, s.dy, G2, G3), total);
      if (p_excl > MEDIAN_T) midx = j;
    };
    for (int gi = 0; gi < groups_of(n) && walk_group(st.rows, gi, n, q, P, pass_a_row); ++gi) {
    }
    ckS[(long)c * PIX] = total;
    ckM[(long)c * PIX] = __int_as_float(midx);
    T = new_t;
    ++c_live;
    ckT[(long)c_live * PIX] = T;
    go = __syncthreads_or(T >= T_STOP) && c_live < n_chunks;
  }
  if (tid == 0) live_chunks[t] = c_live;

  // rows of the tile past its live chunks and past the cap blend nowhere:
  // their gradient is a zero row, so that every row of the tile is written
  {
    const long full = tile_count[t];
    const long first = min((long)c_live * chunk, full);
    float* z = dpay + (start + first) * F;
    for (long i = tid; i < (full - first) * F; i += PIX) z[i] = 0.0f;
  }

  // ---- pass B: back to front over the live chunks. The last live chunk is
  // still staged from pass A; a copy pass A started past it may be in flight.
  cp_async_wait_all();
  __syncthreads();
  float s_carry = 0.0f;  // sum of w*G over the splats of later chunks
  bool med_done = false;
  for (int c = c_live - 1; c >= 0; --c) {
    const int n = min(chunk, count - c * chunk);
    if (c != c_live - 1) stage_finish(st, n, tid);
    if (c > 0) stage_issue(st, payload, start + (long)(c - 1) * chunk, chunk, tid);
    const float t_c = ckT[(long)c * PIX];
    const float total = ckS[(long)c * PIX];
    const int midx = __float_as_int(ckM[(long)c * PIX]);
    const int sel_row = (midx >= 0 && !med_done) ? midx : -1;
    med_done = med_done || midx >= 0;

    float P = t_c, pref = 0.0f;
    unsigned touched = 0;
    auto pass_b_row = [&](int j) {
      const float* r = st.rows + j * ROW;
      const Splat s = splat_at(r, q.px, q.py);
      const Cols rc = load_cols(r);
      float w = 0.0f, da = 0.0f, G2 = 0.0f, G3 = 0.0f;
      bool include = false;
      if (s.passes) {
        const float p_excl = P;
        const float om = 1.0f - s.alpha;
        P = P * om;
        if (P >= T_STOP) {
          include = true;
          w = s.alpha * p_excl;
          const float G = cot_dot(rc, g, s.dx, s.dy, G2, G3);
          pref = fmaf(w, G, pref);
          const float s_after = s_carry + (total - pref);
          da = p_excl * G - (s_after + g.tfin) / om;
        }
      }
      const bool sel = j == sel_row;
      if (!__any_sync(FULL, include || sel)) return;
      const float c0e = r[C0], c1e = r[C1], c2e = r[C2];
      const float dx = s.dx, dy = s.dy;
      const float notcl = s.alpha_raw < ALPHA_MAX ? 1.0f : 0.0f;
      const float dpow = da * s.alpha * notcl;
      const float dpl = dpow * LN2;
      const float wx = w * dx, wy = w * dy;
      // v stays in registers: every index below is a compile-time constant
      float v[F];
      v[0] = fmaf(w, G2, dpl * fmaf(c1e, dy, c0e * 2.0f * dx));
      v[1] = fmaf(w, G3, dpl * fmaf(c1e, dx, c2e * 2.0f * dy));
      v[2] = -0.5f * dx * dx * dpow;
      v[3] = -dx * dy * dpow;
      v[4] = -0.5f * dy * dy * dpow;
      v[5] = da * s.e2 * notcl;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        v[RGB + i] = w * g.rgb[i];
        v[VP + i] = w * g.ac[i];
        v[CP + 2 * i] = wx * g.ac[i];
        v[CP + 2 * i + 1] = wy * g.ac[i];
        v[NRM + i] = w * g.an[i];
      }
      v[TONGUE] = w * g.tng;
      v[RP] = wx * g.ad;
      v[RP + 1] = wy * g.ad;
      v[TS] = w * g.ad;
      v[ONES] = w * g.w;
      if (__any_sync(FULL, sel)) {
        // the median channels' cotangent, at the splat this pixel selected
        const float f = sel ? 1.0f : 0.0f;
        const float sx = f * dx, sy = f * dy;
        const float H2 = fmaf(rc.rp[0], g.mt, fmaf(rc.cp[4], g.mc[2],
                              fmaf(rc.cp[2], g.mc[1], rc.cp[0] * g.mc[0])));
        const float H3 = fmaf(rc.rp[1], g.mt, fmaf(rc.cp[5], g.mc[2],
                              fmaf(rc.cp[3], g.mc[1], rc.cp[1] * g.mc[0])));
        v[0] = fmaf(f, H2, v[0]);
        v[1] = fmaf(f, H3, v[1]);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          v[VP + i] = fmaf(f, g.mc[i], v[VP + i]);
          v[CP + 2 * i] = fmaf(sx, g.mc[i], v[CP + 2 * i]);
          v[CP + 2 * i + 1] = fmaf(sy, g.mc[i], v[CP + 2 * i + 1]);
        }
        v[RP] = fmaf(sx, g.mt, v[RP]);
        v[RP + 1] = fmaf(sy, g.mt, v[RP + 1]);
        v[TS] = fmaf(f, g.mt, v[TS]);
      }
      const float sum = reduce_scatter(v, lane);
      const int jj = j & (GROUP - 1);
      if (my_col >= 0) part[(jj * WARPS + warp) * F + my_col] = sum;
      touched |= 1u << jj;
    };

    bool walking = true;
    for (int gi = 0; gi < groups_of(n); ++gi) {
      touched = 0;
      if (walking) walking = walk_group(st.rows, gi, n, q, P, pass_b_row);
      if (lane == 0) tch[warp] = touched;
      __syncthreads();  // the group's warp sums are in
      // the 8 warps' sums of these rows, in warp order, as one contiguous span
      const int ng = min(GROUP, n - gi * GROUP);
      float* dst = dpay + (start + (long)c * chunk + gi * GROUP) * F;
      for (int i = tid; i < ng * F; i += PIX) {
        const int jj = i / F, k = i - jj * F;
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w)
          if ((tch[w] >> jj) & 1u) acc += part[(jj * WARPS + w) * F + k];
        dst[i] = acc;
      }
      __syncthreads();  // the warp sums are read: the next group may write them
    }
    s_carry = s_carry + total;
  }
}

}  // namespace

extern "C" int ed3dgs_backward_blend(const float* payload, const int* tile_start,
                                     const int* tile_count, const float* packed,
                                     const float* cot, float* dpay, int* live_chunks,
                                     float* tchk, float* ttot, float* tmed, int num_tiles,
                                     int grid_x, int gxp, int chunk, int cap, float focal_x,
                                     float focal_y, float half_w, float half_h, void* stream) {
  if (num_tiles == 0) return 0;
  const size_t smem = smem_bytes(chunk);
  cudaError_t err = allow_smem((const void*)backward_blend, (int)smem, smem_limit);
  if (err != cudaSuccess) return (int)err;
  backward_blend<<<num_tiles, PIX, smem, static_cast<cudaStream_t>(stream)>>>(
      payload, tile_start, tile_count, packed, cot, dpay, live_chunks, tchk, ttot, tmed,
      grid_x, gxp, chunk, cap, focal_x, focal_y, half_w, half_h);
  return (int)cudaGetLastError();
}

// The kernel's registers per thread, its shared memory at `chunk` and the
// CTAs an SM can hold at once.
extern "C" int ed3dgs_backward_blend_info(int chunk, int* regs, int* smem, int* ctas_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, backward_blend);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem = (int)smem_bytes(chunk) + (int)attr.sharedSizeBytes;
  err = allow_smem((const void*)backward_blend, (int)smem_bytes(chunk), smem_limit);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, backward_blend, PIX,
                                                            smem_bytes(chunk));
}
