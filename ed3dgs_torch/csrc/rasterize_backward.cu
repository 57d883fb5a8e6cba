// K2: backward blend of one 16x16 tile per CTA.
//
// Replaces the Pallas TPU kernel ed3dgs_tpu/ops/rasterize_pallas.py::
// _backward_kernel (entry rasterize_pallas_backward, pallas_call at :654): the
// gradient of K1 (csrc/rasterize_forward.cu) with respect to the gathered
// [K, 26] pair payload, one row per pair, with K1's semantics (the in-chunk
// product that keeps multiplying after a failed include, the carry that
// restarts from the last include at a chunk boundary) and K1's exact mask
// arithmetic (power2 <= 0, alpha >= 1/255, P >= 1e-4 from the same rounded
// sequential operations; built with -fmad=false like K1), so a pair gets a
// gradient row where K1 blended it and nowhere else.
//
// One thread per pixel, the tile's rows staged in shared memory a chunk at a
// time, as in K1.
//   Pass A, front to back: the transmittance entering every chunk, written to
//     a global scratch buffer (the TPU keeps it in VMEM, [513, 256] floats,
//     more than a CTA's 227 KB of shared memory). Tile t owns n_chunks+1 rows
//     of 256 floats from row 2t + ceil(tile_start/chunk). The loop stops once
//     no pixel's carry is >= 1e-4; the number of chunks run is the tile's
//     live-chunk count.
//   Un-finalize: the output cotangents of the tile's pixels become the
//     cotangents of the blend accumulators (rasterize_pallas.py:425-461).
//   Pass B, back to front over the live chunks. Within a chunk each pixel
//     walks the rows twice from the chunk's checkpoint: once for the sum of
//     w*G over the chunk and the chunk's median splat, once more to form each
//     row's gradient terms, where the suffix sum of later splats' w*G is the
//     carried sum plus the chunk total minus the running prefix (the same
//     order both times, so the prefix ends at the total exactly). Exact under
//     these semantics, unlike dividing by (1-alpha) back to front.
//   Each row's 26 columns are summed over the 256 pixels in a fixed order:
//     a shuffle tree in each warp (skipped, as zeros, when no pixel of the
//     warp touches the row), then the 8 warps' partials in order. No atomics:
//     each pair row belongs to one tile and is written once, so the result is
//     bit-identical from run to run. The tile's rows past its live chunks
//     (and past the cap) get zero rows, so every row of [tile_start,
//     tile_start + tile_count) is written and the caller needs no mask.
//
// Bound on the H100: the function needs two alpha evaluations per needed
// pair-pixel (~14 flops each) and ~120 flops per blended splat (one
// cotangent dot, the alpha gradient, 26 terms), and moves the live pair rows,
// 10 packed and 17 cotangent channels and the gradient rows; chip_smoke.py
// computes both from its run's inputs and reports the larger as bound_ms.
// This design is above it: alpha is evaluated three times (pass A and both
// walks of pass B), G twice per include, and one __syncthreads per row.
// Simple first: no double buffering, one CTA per tile.

#include <cuda_runtime.h>

namespace {

constexpr int PIX = 256;
constexpr int WARPS = PIX / 32;
constexpr int F = 26;
constexpr int OUT_PAD = 24;

// payload columns
constexpr int MX = 0, MY = 1, C0 = 2, C1 = 3, C2 = 4, OPC = 5, RGB = 6,
              TONGUE = 9, VP = 10, CP = 13, RP = 19, TS = 21, NRM = 22, ONES = 25;
// output channels (ops/rasterize_cuda.py OUT_CHANNELS)
constexpr int O_COLOR = 0, O_WEIGHT = 3, O_TFINAL = 4, O_COORD = 5, O_MCOORD = 8,
              O_DEPTH = 11, O_MDEPTH = 12, O_TONGUE = 13, O_NORMAL = 14, O_NLEN = 17;

constexpr float NEG_HALF_LOG2E = -0.7213475204444817f;  // -0.5 * log2(e)
constexpr float NEG_LOG2E = -1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_STOP = 1e-4f;
constexpr float MEDIAN_T = 0.5f;
constexpr float NORMALIZE_EPS = 1e-12f;

struct Splat {
  float dx, dy, c0e, c1e, c2e, e2, alpha_raw, alpha;
  bool passes;
};

// K1's arithmetic, operation for operation
__device__ __forceinline__ Splat splat_at(const float* r, float px, float py) {
  Splat s;
  s.dx = r[MX] - px;
  s.dy = r[MY] - py;
  s.c0e = r[C0] * NEG_HALF_LOG2E;
  s.c1e = r[C1] * NEG_LOG2E;
  s.c2e = r[C2] * NEG_HALF_LOG2E;
  const float power2 = s.dx * (s.c0e * s.dx + s.c1e * s.dy) + s.c2e * s.dy * s.dy;
  s.e2 = exp2f(power2);
  s.alpha_raw = r[OPC] * s.e2;
  s.alpha = fminf(ALPHA_MAX, s.alpha_raw);
  s.passes = power2 <= 0.0f && s.alpha >= ALPHA_MIN;
  return s;
}

// cotangents of the blend accumulators at one pixel
struct Cot {
  float rgb[3], tng, ac[3], ad, mt, mc[3], an[3], w, tfin;
};

__device__ __forceinline__ void stage_rows(float* rows, const float* payload, long first,
                                           int n, int lane) {
  __syncthreads();  // previous rows fully consumed
  const float* src = payload + first * F;
  for (int i = lane; i < n * F; i += PIX) rows[i] = src[i];
  __syncthreads();
}

__global__ void __launch_bounds__(PIX)
backward_blend(const float* __restrict__ payload, const int* __restrict__ tile_start,
               const int* __restrict__ tile_count, const float* __restrict__ packed,
               const float* __restrict__ cot, float* __restrict__ dpay,
               int* __restrict__ live_chunks, float* __restrict__ tchk, int grid_x,
               int gxp, int chunk, int cap, float focal_x, float focal_y, float half_w,
               float half_h) {
  extern __shared__ float smem[];
  float* rows = smem;                     // [chunk, F]
  float* partial = smem + chunk * F;      // [2][WARPS][F]
  const int t = blockIdx.x;
  const int lane = threadIdx.x;
  const int warp = lane >> 5, wl = lane & 31;
  const int tile_x = t % grid_x, tile_y = t / grid_x;
  const float px = (float)(tile_x * 16 + (lane & 15));
  const float py = (float)(tile_y * 16 + (lane >> 4));
  const long start = tile_start[t];
  const int count = min(tile_count[t], cap);
  const int n_chunks = (count + chunk - 1) / chunk;
  float* ck = tchk + (2L * t + (start + chunk - 1) / chunk) * PIX + lane;

  // ---- pass A: transmittance checkpoints, live-chunk count
  float T = 1.0f;
  ck[0] = T;
  int c_live = 0;
  bool go = n_chunks > 0;  // max carry starts at 1 >= T_STOP
  while (go) {
    const int c = c_live;
    const int n = min(chunk, count - c * chunk);
    stage_rows(rows, payload, start + (long)c * chunk, n, lane);
    float P = T, new_t = T;
    for (int j = 0; j < n; ++j) {
      const Splat s = splat_at(rows + j * F, px, py);
      if (!s.passes) continue;
      P = P * (1.0f - s.alpha);
      if (P >= T_STOP) new_t = P;
    }
    T = new_t;
    ++c_live;
    ck[(long)c_live * PIX] = T;
    go = __syncthreads_or(T >= T_STOP) && c_live < n_chunks;
  }
  if (lane == 0) live_chunks[t] = c_live;

  // rows of the tile past its live chunks and past the cap blend nowhere:
  // their gradient is a zero row, so that every row of the tile is written
  {
    const long full = tile_count[t];
    const long first = min((long)c_live * chunk, full);
    float* z = dpay + (start + first) * F;
    for (long i = lane; i < (full - first) * F; i += PIX) z[i] = 0.0f;
  }

  // ---- un-finalize the output cotangents
  const float* pk = packed + ((long)tile_y * gxp + tile_x) * OUT_PAD * PIX + lane;
  const float* ct = cot + ((long)tile_y * gxp + tile_x) * OUT_PAD * PIX + lane;
  Cot g;
  {
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
  }

  // ---- pass B: back to front over the live chunks
  float s_carry = 0.0f;  // sum of w*G over the splats of later chunks
  bool med_done = false;
  for (int c = c_live - 1; c >= 0; --c) {
    const int n = min(chunk, count - c * chunk);
    stage_rows(rows, payload, start + (long)c * chunk, n, lane);
    const float t_c = ck[(long)c * PIX];

    // B1: the chunk's sum of w*G, and its median splat
    float P = t_c, total = 0.0f;
    int midx = -1;
    for (int j = 0; j < n; ++j) {
      const float* r = rows + j * F;
      const Splat s = splat_at(r, px, py);
      if (!s.passes) continue;
      const float p_excl = P;
      P = P * (1.0f - s.alpha);
      if (!(P >= T_STOP)) continue;
      const float w = s.alpha * p_excl;
      const float G1 = r[RGB] * g.rgb[0] + r[RGB + 1] * g.rgb[1] + r[RGB + 2] * g.rgb[2] +
                       r[TONGUE] * g.tng + r[VP] * g.ac[0] + r[VP + 1] * g.ac[1] +
                       r[VP + 2] * g.ac[2] + r[TS] * g.ad + r[NRM] * g.an[0] +
                       r[NRM + 1] * g.an[1] + r[NRM + 2] * g.an[2] + r[ONES] * g.w;
      const float G2 = r[CP] * g.ac[0] + r[CP + 2] * g.ac[1] + r[CP + 4] * g.ac[2] +
                       r[RP] * g.ad;
      const float G3 = r[CP + 1] * g.ac[0] + r[CP + 3] * g.ac[1] + r[CP + 5] * g.ac[2] +
                       r[RP + 1] * g.ad;
      total = total + w * (G1 + s.dx * G2 + s.dy * G3);
      if (p_excl > MEDIAN_T) midx = j;
    }
    const int sel_row = (midx >= 0 && !med_done) ? midx : -1;
    med_done = med_done || midx >= 0;

    // B2: every row's gradient terms, reduced over the tile's pixels
    P = t_c;
    float pref = 0.0f;
    for (int j = 0; j < n; ++j) {
      const float* r = rows + j * F;
      const Splat s = splat_at(r, px, py);
      float w = 0.0f, da = 0.0f, G2 = 0.0f, G3 = 0.0f;
      bool include = false;
      if (s.passes) {
        const float p_excl = P;
        const float om = 1.0f - s.alpha;
        P = P * om;
        if (P >= T_STOP) {
          include = true;
          w = s.alpha * p_excl;
          const float G1 = r[RGB] * g.rgb[0] + r[RGB + 1] * g.rgb[1] + r[RGB + 2] * g.rgb[2] +
                           r[TONGUE] * g.tng + r[VP] * g.ac[0] + r[VP + 1] * g.ac[1] +
                           r[VP + 2] * g.ac[2] + r[TS] * g.ad + r[NRM] * g.an[0] +
                           r[NRM + 1] * g.an[1] + r[NRM + 2] * g.an[2] + r[ONES] * g.w;
          G2 = r[CP] * g.ac[0] + r[CP + 2] * g.ac[1] + r[CP + 4] * g.ac[2] + r[RP] * g.ad;
          G3 = r[CP + 1] * g.ac[0] + r[CP + 3] * g.ac[1] + r[CP + 5] * g.ac[2] +
               r[RP + 1] * g.ad;
          const float G = G1 + s.dx * G2 + s.dy * G3;
          pref = pref + w * G;
          const float s_after = s_carry + (total - pref);
          da = p_excl * G - (s_after + g.tfin) / om;
        }
      }
      const float sel = (j == sel_row) ? 1.0f : 0.0f;
      float v[F];
      if (__any_sync(0xffffffffu, include || sel != 0.0f)) {
        const float notcl = s.alpha_raw < ALPHA_MAX ? 1.0f : 0.0f;
        const float dpow = da * s.alpha * notcl;
        const float dpl = dpow * LN2;
        float H2 = 0.0f, H3 = 0.0f;
        if (sel != 0.0f) {
          H2 = r[CP] * g.mc[0] + r[CP + 2] * g.mc[1] + r[CP + 4] * g.mc[2] + r[RP] * g.mt;
          H3 = r[CP + 1] * g.mc[0] + r[CP + 3] * g.mc[1] + r[CP + 5] * g.mc[2] +
               r[RP + 1] * g.mt;
        }
        const float wx = w * s.dx, wy = w * s.dy, sx = sel * s.dx, sy = sel * s.dy;
        // v stays in registers: every index below is a compile-time constant
        v[0] = dpl * (s.c0e * 2.0f * s.dx + s.c1e * s.dy) + w * G2 + sel * H2;
        v[1] = dpl * (s.c2e * 2.0f * s.dy + s.c1e * s.dx) + w * G3 + sel * H3;
        v[2] = -0.5f * s.dx * s.dx * dpow;
        v[3] = -s.dx * s.dy * dpow;
        v[4] = -0.5f * s.dy * s.dy * dpow;
        v[5] = da * s.e2 * notcl;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          v[RGB + i] = w * g.rgb[i];
          v[VP + i] = w * g.ac[i] + sel * g.mc[i];
          v[CP + 2 * i] = wx * g.ac[i] + sx * g.mc[i];
          v[CP + 2 * i + 1] = wy * g.ac[i] + sy * g.mc[i];
          v[NRM + i] = w * g.an[i];
        }
        v[TONGUE] = w * g.tng;
        v[RP] = wx * g.ad + sx * g.mt;
        v[RP + 1] = wy * g.ad + sy * g.mt;
        v[TS] = w * g.ad + sel * g.mt;
        v[ONES] = w * g.w;
#pragma unroll
        for (int k = 0; k < F; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
        }
      } else {
#pragma unroll
        for (int k = 0; k < F; ++k) v[k] = 0.0f;
      }
      float* part = partial + (j & 1) * WARPS * F;
      if (wl == 0) {
#pragma unroll
        for (int k = 0; k < F; ++k) part[warp * F + k] = v[k];
      }
      __syncthreads();
      if (lane < F) {
        float acc = part[lane];
        for (int q = 1; q < WARPS; ++q) acc = acc + part[q * F + lane];
        dpay[(start + (long)c * chunk + j) * F + lane] = acc;
      }
    }
    s_carry = s_carry + total;
  }
}

}  // namespace

extern "C" int ed3dgs_backward_blend(const float* payload, const int* tile_start,
                                     const int* tile_count, const float* packed,
                                     const float* cot, float* dpay, int* live_chunks,
                                     float* tchk, int num_tiles, int grid_x, int gxp,
                                     int chunk, int cap, float focal_x, float focal_y,
                                     float half_w, float half_h, void* stream) {
  if (num_tiles == 0) return 0;
  const size_t smem = ((size_t)chunk * F + 2 * WARPS * F) * sizeof(float);
  backward_blend<<<num_tiles, PIX, smem, static_cast<cudaStream_t>(stream)>>>(
      payload, tile_start, tile_count, packed, cot, dpay, live_chunks, tchk, grid_x, gxp,
      chunk, cap, focal_x, focal_y, half_w, half_h);
  return (int)cudaGetLastError();
}
