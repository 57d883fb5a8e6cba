// K6 and K7: the KNN embedding regulariser, its loss and its gradient.
//
//   L = sum_ik coef_i * sqrt(w_ik * |e_i - e_j|^2 + 1e-20),  j = nbr[i][k]
//
// over the embedding table permuted to Morton rank order (ops/knn_loss.py
// builds the graph: neighbour ranks, effective weights, coef, and the
// reverse adjacency of the edges that feed dL/de_j).
//
// K6 `knn_rows` replaces the Pallas TPU kernel ed3dgs_tpu/ops/knn_loss.py::
// _main_kernel (pallas_call at :504). K7 `knn_reverse` replaces
// _far_kernel/_far_body (pallas_call at :545) together with the in-window
// half of dL/de_j that _main_kernel accumulates into window images. The TPU
// kernels reconstruct every neighbour row by one-hot membership matmuls from
// a three-block rank window and spill lists, because a gather is slow there.
// On the H100 the embedding table (Cp x 32 floats, 12.8 MB at the bench
// cloud) sits in the 50 MB L2, and a gather of a 128-byte row is one
// coalesced warp load, so both kernels gather:
//
//   K6, one warp per rank row i, lane = embedding dimension (E <= 32): the
//     warp loads its K neighbour ranks and weights (lane = slot, K <= 32),
//     then for each slot in order reads e_j, reduces |e_i - e_j|^2 with a
//     butterfly of shuffles (every lane ends with the same sum), and forms
//     v = sqrtf(d2 w + 1e-20), the loss term coef v, s = coef w / v and
//     de_i += s (e_i - e_j). It writes de_i, the per-edge s [Cp, K] and one
//     loss partial per CTA (its 8 rows' sums, in row order).
//   K7, one warp per rank j: walks j's in-edges through the reverse CSR in
//     order (32 pair ids staged per load, broadcast by shuffles), gathers
//     e_i, and sums -(s_ik (e_i - e_j)) in float64, rounded once; it writes
//     de_j + that sum, the whole gradient row of rank j.
//
// Every sum has a fixed order and nothing is accumulated by atomics, so two
// runs on the same inputs are bit-identical. Built with -fmad=false and
// IEEE sqrtf and division (no fast math), so each row's terms are the plain
// PyTorch versions' (ops/knn_loss.py knn_rows_plain, knn_reverse_plain)
// operation for operation; only the reduction order of d2 and of the loss
// partials differs.
//
// Bound on the H100: memory. K6 must read the table once, the ranks,
// weights and coef, and write de and s: at the bench graph (Cp = 100,352,
// K = 20, E = 32) ~50 MB, ~0.015 ms at 3.35 TB/s, against ~170 flops an edge
// (~0.34 GFLOP, ~0.005 ms). K7 reads the table, s, de and the reverse
// adjacency and writes the gradient, ~55 MB. Each gathered row is a 128-byte
// L2 hit; each warp's loop over its slots is serial (one row's K gathers
// are dependent loads in flight one at a time), which a later change may
// stage in shared memory by rank window.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;          // rank rows per CTA (ops/knn_loss.py ROWS_PER_BLOCK)
constexpr unsigned FULL = 0xffffffffu;
constexpr float EPS = 1e-20f;

__device__ __forceinline__ float warp_sum(float x) {
  // xor butterfly: each step adds two equal pairs in either order, so every
  // lane holds the identical sum
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__global__ void __launch_bounds__(WARPS * 32)
knn_rows(const float* __restrict__ emb, const int* __restrict__ nbr,
         const float* __restrict__ w, const float* __restrict__ coef,
         float* __restrict__ de, float* __restrict__ s_out,
         float* __restrict__ partials, int Cp, int E, int K) {
  __shared__ float row_loss[WARPS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + warp;
  float lsum = 0.f;
  if (r < Cp) {                                   // uniform over the warp
    const bool on = lane < E;
    const float ei = on ? emb[(long)r * E + lane] : 0.f;
    const float cf = coef[r];
    const int my_j = lane < K ? nbr[(long)r * K + lane] : 0;
    const float my_w = lane < K ? w[(long)r * K + lane] : 0.f;
    float acc = 0.f, my_s = 0.f;
    for (int k = 0; k < K; ++k) {
      const int j = __shfl_sync(FULL, my_j, k);
      const float wk = __shfl_sync(FULL, my_w, k);
      const float ej = on ? emb[(long)j * E + lane] : 0.f;
      const float diff = ei - ej;
      const float d2 = warp_sum(diff * diff);
      const float v = sqrtf(d2 * wk + EPS);
      lsum += cf * v;
      const float sk = cf * wk / v;
      acc += sk * diff;
      if (lane == k) my_s = sk;
    }
    if (on) de[(long)r * E + lane] = acc;
    if (lane < K) s_out[(long)r * K + lane] = my_s;
  }
  if (lane == 0) row_loss[warp] = lsum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float p = 0.f;
    for (int q = 0; q < WARPS; ++q) p += row_loss[q];
    partials[blockIdx.x] = p;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
knn_reverse(const float* __restrict__ emb, const float* __restrict__ s,
            const float* __restrict__ de, const int* __restrict__ rev_ptr,
            const int* __restrict__ rev_pair, float* __restrict__ out,
            int Cp, int E, int K) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS + warp;
  if (j >= Cp) return;                            // uniform over the warp
  const bool on = lane < E;
  const float ej = on ? emb[(long)j * E + lane] : 0.f;
  const int p0 = rev_ptr[j];
  const int p1 = rev_ptr[j + 1];
  double acc = 0.0;
  for (int base = p0; base < p1; base += 32) {
    const int n = min(32, p1 - base);
    int my_pid = 0;
    float my_s = 0.f;
    if (lane < n) {
      my_pid = rev_pair[base + lane];
      my_s = s[my_pid];
    }
    for (int t = 0; t < n; ++t) {
      const int pid = __shfl_sync(FULL, my_pid, t);
      const float st = __shfl_sync(FULL, my_s, t);
      const int i = pid / K;
      const float ei = on ? emb[(long)i * E + lane] : 0.f;
      acc += (double)(-(st * (ei - ej)));
    }
  }
  if (on) out[(long)j * E + lane] = de[(long)j * E + lane] + (float)acc;
}

}  // namespace

extern "C" int ed3dgs_knn_rows(const float* emb, const int* nbr, const float* w,
                               const float* coef, float* de, float* s, float* partials,
                               int Cp, int E, int K, void* stream) {
  if (Cp == 0) return 0;
  const int blocks = (Cp + WARPS - 1) / WARPS;
  knn_rows<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      emb, nbr, w, coef, de, s, partials, Cp, E, K);
  return (int)cudaGetLastError();
}

extern "C" int ed3dgs_knn_reverse(const float* emb, const float* s, const float* de,
                                  const int* rev_ptr, const int* rev_pair, float* out,
                                  int Cp, int E, int K, void* stream) {
  if (Cp == 0) return 0;
  const int blocks = (Cp + WARPS - 1) / WARPS;
  knn_reverse<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      emb, s, de, rev_ptr, rev_pair, out, Cp, E, K);
  return (int)cudaGetLastError();
}
