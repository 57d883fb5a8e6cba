// K1: forward blend of one 16x16 tile per CTA.
//
// Replaces the Pallas TPU kernel ed3dgs_tpu/ops/rasterize_pallas.py::
// _forward_kernel (entry rasterize_pallas_forward, pallas_call at :711), and
// reproduces its semantics:
//   * pixel coordinates are integers, px = tile_x*16 + x (no +0.5);
//   * power2 = dx*(c0e*dx + c1e*dy) + c2e*dy*dy with the conic pre-scaled by
//     -0.5*log2(e) / -log2(e), alpha = min(0.99, opacity * exp2(power2));
//   * a splat passes where power2 <= 0 and alpha >= 1/255, and is included
//     while T*(1-alpha) >= 1e-4. Within a chunk of `chunk` rows the running
//     product keeps multiplying after a failed include (as the TPU kernel's
//     in-chunk cumulative product does); at a chunk boundary it restarts from
//     the transmittance after the last include (the TPU kernel's carry);
//   * the median channels take the last include with T_before > 0.5;
//   * "any contributor" is weight > 0; expected depth is divided by
//     ln = sqrt(u^2+v^2+1); the normal is normalised with the 1e-30 guard and
//     NORMALIZE_EPS;
//   * each tile reads at most chunk*512 of its pairs (the per-tile cap).
// The output is the TPU kernel's [gy, gxp, 24, 256] layout and channel order
// (OUT_CHANNELS in ops/rasterize_cuda.py), channels 18..23 zero; tile
// columns grid_x..gxp are not written.
//
// Bound on the H100: at the bench frame (~0.83 M pairs, 1785 tiles) the
// kernel reads ~86 MB of pair rows and writes ~44 MB, ~39 us of HBM time; the
// blend's fp32 work (~14 ops per pair-pixel evaluation a pixel needs, ~45 per
// blended splat) is counted by chip_smoke.py from the frame's own data and is
// below the bytes there. What held the first version at 10x that bound
// was evaluation it did not need: every pixel evaluated every row of its
// tile, 213 M evaluations for the 74 M a pixel reaches before its in-chunk
// product falls below 1e-4, and the rows were staged by scalar loads between
// two barriers with nothing in flight. This design (shared with K2 through
// blend_common.cuh):
//   * each warp owns an 8x4 pixel block and walks only the rows that can
//     pass at one of its pixels (meets_block: a conservative screen box,
//     then the pass ellipse against the block), found 32 at a time by a
//     ballot; a row that misses fails the pass test at every pixel of the
//     block, and a failed pass changes nothing;
//   * a warp leaves a chunk once every lane's in-chunk product is below
//     1e-4: no later row of that chunk can be included (the next chunk
//     restarts from the carried T >= 1e-4, so a pixel never leaves the tile);
//   * the next chunk's rows are copied by 16-byte cp.async while this one is
//     blended; the thread that converts a row also scales its conic and
//     computes its cull data once for all 256 pixels;
//   * the accumulations, off the mask path, are fused multiply-adds
//     (fmaf()) on 16-byte column loads; four CTAs per SM (64 registers, a
//     few bytes spilled), which measured faster than three or two.
// The output store is unchanged: 24 coalesced channels of 256 floats a tile.
// Tiles are launched in tile order: launching the longest first was measured
// to save less than the sort it needs (PERF.md). The card's own count of
// registers, shared memory and resident CTAs: ed3dgs_forward_blend_info
// (printed by chip_smoke.py).
//
// Build without --use_fast_math and with -fmad=false (see ops/cuda_lib.py).

#include "blend_common.cuh"

namespace {

using namespace blend;

constexpr int OUT_DIM = 18;

constexpr int MIN_CTAS = 4;  // CTAs of 256 threads per SM: 64 registers a thread

size_t smem_bytes(int chunk) { return stage_bytes(chunk); }

int smem_limit[MAX_DEVICES] = {};  // dynamic shared bytes allowed, per device

__global__ void __launch_bounds__(PIX, MIN_CTAS)
forward_blend(const float* __restrict__ payload, const int* __restrict__ tile_start,
              const int* __restrict__ tile_count, float* __restrict__ out, int grid_x,
              int gxp, int chunk, int cap, float focal_x, float focal_y, float half_w,
              float half_h) {
  extern __shared__ float4 smem4[];
  Stage st;
  st.raw = reinterpret_cast<float*>(smem4);
  st.rows = st.raw + raw_floats(chunk);
  const int t = blockIdx.x;  // the tile
  const int tid = threadIdx.x;
  const int tile_x = t % grid_x, tile_y = t / grid_x;
  const Pixel q = pixel_of(tile_x, tile_y, tid);
  const long start = tile_start[t];
  const int count = min(tile_count[t], cap);
  const int n_chunks = (count + chunk - 1) / chunk;
  if (n_chunks > 0) stage_issue(st, payload, start, min(chunk, count), tid);

  float T = 1.0f;  // transmittance after the last include (chunk carry)
  float acc_rgb0 = 0.f, acc_rgb1 = 0.f, acc_rgb2 = 0.f, acc_tongue = 0.f;
  float acc_vp0 = 0.f, acc_vp1 = 0.f, acc_vp2 = 0.f, acc_ts = 0.f;
  float acc_n0 = 0.f, acc_n1 = 0.f, acc_n2 = 0.f, weight = 0.f;
  // w*dx and w*dy weighted plane terms: camera planes (x: 0,2,4; y: 1,3,5)
  // and the ray plane (x: 0; y: 1)
  float acc_cx0 = 0.f, acc_cx2 = 0.f, acc_cx4 = 0.f, acc_rx = 0.f;
  float acc_cy1 = 0.f, acc_cy3 = 0.f, acc_cy5 = 0.f, acc_ry = 0.f;
  float m_t = 0.f, m_c0 = 0.f, m_c1 = 0.f, m_c2 = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    const int n = min(chunk, count - c * chunk);
    stage_finish(st, n, tid);
    if (c + 1 < n_chunks)
      stage_issue(st, payload, start + (long)(c + 1) * chunk,
                  min(chunk, count - (c + 1) * chunk), tid);

    float P = T;  // running in-chunk product, including failed includes
    auto blend_row = [&](int j) {
      const float* r = st.rows + j * ROW;
      const Splat s = splat_at(r, q.px, q.py);
      if (!s.passes) return;
      const float p_excl = P;
      P = P * (1.0f - s.alpha);
      if (!(P >= T_STOP)) return;
      T = P;
      // the accumulations are off the mask path: fused multiply-adds
      const Cols rc = load_cols(r);
      const float dx = s.dx, dy = s.dy;
      const float w = s.alpha * p_excl;
      const float wx = w * dx, wy = w * dy;
      acc_rgb0 = fmaf(w, rc.rgb[0], acc_rgb0);
      acc_rgb1 = fmaf(w, rc.rgb[1], acc_rgb1);
      acc_rgb2 = fmaf(w, rc.rgb[2], acc_rgb2);
      acc_tongue = fmaf(w, rc.tng, acc_tongue);
      acc_vp0 = fmaf(w, rc.vp[0], acc_vp0);
      acc_vp1 = fmaf(w, rc.vp[1], acc_vp1);
      acc_vp2 = fmaf(w, rc.vp[2], acc_vp2);
      acc_ts = fmaf(w, rc.ts, acc_ts);
      acc_n0 = fmaf(w, rc.nrm[0], acc_n0);
      acc_n1 = fmaf(w, rc.nrm[1], acc_n1);
      acc_n2 = fmaf(w, rc.nrm[2], acc_n2);
      weight += w;
      acc_cx0 = fmaf(wx, rc.cp[0], acc_cx0);
      acc_cx2 = fmaf(wx, rc.cp[2], acc_cx2);
      acc_cx4 = fmaf(wx, rc.cp[4], acc_cx4);
      acc_rx = fmaf(wx, rc.rp[0], acc_rx);
      acc_cy1 = fmaf(wy, rc.cp[1], acc_cy1);
      acc_cy3 = fmaf(wy, rc.cp[3], acc_cy3);
      acc_cy5 = fmaf(wy, rc.cp[5], acc_cy5);
      acc_ry = fmaf(wy, rc.rp[1], acc_ry);
      if (p_excl > MEDIAN_T) {
        m_t = fmaf(dy, rc.rp[1], fmaf(dx, rc.rp[0], rc.ts));
        m_c0 = fmaf(dy, rc.cp[1], fmaf(dx, rc.cp[0], rc.vp[0]));
        m_c1 = fmaf(dy, rc.cp[3], fmaf(dx, rc.cp[2], rc.vp[1]));
        m_c2 = fmaf(dy, rc.cp[5], fmaf(dx, rc.cp[4], rc.vp[2]));
      }
    };
    for (int g = 0; g < groups_of(n) && walk_group(st.rows, g, n, q, P, blend_row); ++g) {
    }
  }

  // ---- finalize (forward.cu:757-821)
  const bool any_c = weight > 0.0f;
  const float inv_w = any_c ? 1.0f / weight : 0.0f;
  const float u = (q.px - half_w) / focal_x;
  const float v = (q.py - half_h) / focal_y;
  const float ln = sqrtf(u * u + v * v + 1.0f);
  const float coord0 = acc_vp0 + acc_cx0 + acc_cy1;
  const float coord1 = acc_vp1 + acc_cx2 + acc_cy3;
  const float coord2 = acc_vp2 + acc_cx4 + acc_cy5;
  const float depth_ray = acc_ts + acc_rx + acc_ry;
  const float n_sq = acc_n0 * acc_n0 + acc_n1 * acc_n1 + acc_n2 * acc_n2;
  const float n_len = sqrtf(n_sq < 1e-30f ? 1.0f : n_sq);
  const float n_div = fmaxf(n_len, NORMALIZE_EPS);

  float o[OUT_DIM];
  o[0] = acc_rgb0;
  o[1] = acc_rgb1;
  o[2] = acc_rgb2;
  o[3] = weight;
  o[4] = T;
  o[5] = coord0 * inv_w;
  o[6] = coord1 * inv_w;
  o[7] = coord2 * inv_w;
  o[8] = any_c ? m_c0 : 0.0f;
  o[9] = any_c ? m_c1 : 0.0f;
  o[10] = any_c ? m_c2 : 0.0f;
  o[11] = (depth_ray / ln) * inv_w;
  o[12] = any_c ? m_t / ln : 0.0f;
  o[13] = acc_tongue;
  o[14] = any_c ? acc_n0 / n_div : 0.0f;
  o[15] = any_c ? acc_n1 / n_div : 0.0f;
  o[16] = any_c ? acc_n2 / n_div : 0.0f;
  o[17] = n_len;

  float* dst = out + ((long)tile_y * gxp + tile_x) * OUT_PAD * PIX + q.p;
#pragma unroll
  for (int ch = 0; ch < OUT_DIM; ++ch) dst[ch * PIX] = o[ch];
#pragma unroll
  for (int ch = OUT_DIM; ch < OUT_PAD; ++ch) dst[ch * PIX] = 0.0f;
}

}  // namespace

extern "C" int ed3dgs_forward_blend(const float* payload, const int* tile_start,
                                    const int* tile_count, float* out, int num_tiles,
                                    int grid_x, int gxp, int chunk, int cap,
                                    float focal_x, float focal_y, float half_w,
                                    float half_h, void* stream) {
  if (num_tiles == 0) return 0;
  const size_t smem = smem_bytes(chunk);
  cudaError_t err = allow_smem((const void*)forward_blend, (int)smem, smem_limit);
  if (err != cudaSuccess) return (int)err;
  forward_blend<<<num_tiles, PIX, smem, static_cast<cudaStream_t>(stream)>>>(
      payload, tile_start, tile_count, out, grid_x, gxp, chunk, cap, focal_x, focal_y,
      half_w, half_h);
  return (int)cudaGetLastError();
}

// The kernel's registers per thread, its dynamic shared memory at `chunk`
// and the CTAs an SM can hold at once (cudaOccupancy...).
extern "C" int ed3dgs_forward_blend_info(int chunk, int* regs, int* smem, int* ctas_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, forward_blend);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem = (int)smem_bytes(chunk) + (int)attr.sharedSizeBytes;
  err = allow_smem((const void*)forward_blend, (int)smem_bytes(chunk), smem_limit);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, forward_blend, PIX,
                                                            smem_bytes(chunk));
}
