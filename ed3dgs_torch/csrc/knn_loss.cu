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
// On the H100 the table (Cp x 32 floats, 12.8 MB at the bench cloud) sits in
// the 50 MB L2 (the step has just gathered it), and a 16-byte load per lane
// gathers a row, so both kernels read every row from there. Staging the
// Morton block's three-block window of the table in shared memory (96 KB a
// CTA, as the TPU kernels do in VMEM) was measured and did not pay: both
// kernels are bound by instruction throughput and latency, not by where rows come from
// (scripts/torch_knn_variants.py builds the staged variants).
//
//   K6, one CTA per 128 rank rows, four lanes per row (each holds 8 of its
//     32 values as two float4s), so a warp works on 8 rows at once. The CTA
//     first copies its rows' K ranks and weights into shared memory, rows
//     padded to an odd stride so that the 8 rows a warp reads at once fall
//     on 8 banks. A group of four lanes then walks its row's slots in order:
//     it reads e_j (the next slot's row is loaded before this slot's
//     arithmetic), reduces |e_i - e_j|^2 by a 2-step xor butterfly inside
//     the group (every lane ends with the same sum), and forms
//     v = sqrtf(d2 w + 1e-20), the loss term coef v, s = coef w / v and
//     de_i += s (e_i - e_j). s goes to a shared tile that the CTA writes out
//     in one coalesced pass; one loss partial per CTA (its rows' sums, in a
//     fixed order). Four lanes a row, not eight, halve the lanes that repeat
//     an edge's sqrt and divide. Two CTAs per SM (62 registers a thread);
//     held to 40 for three, it spills and runs slower.
//   K7, one CTA per 64 ranks j, a group of eight lanes per rank (one float4
//     each), four CTAs per SM (32 registers a thread). The CTA stages its
//     ranks' in-edges, 2048 at a time, in shared memory as (source rank, -s)
//     pairs: every thread loads its four pair ids, then their four s, so
//     the CTA's gathers are in flight together and no group waits on a
//     chain of dependent loads. Each group then sums its rank's in-edges in
//     CSR order, two rows in flight, in float64, rounds once and adds de_j:
//     the whole gradient row of rank j. The warp walks as many in-edges as
//     its busiest group: the graph leaves out edges that add exactly 0, so
//     the dead slots' hub ranks (ops/knn_loss.py) no longer hold a warp.
//
// A wider embedding (E = 32 * ns, the wrapper zero-pads any E > 32 to the
// next multiple of 32) runs in 32-column slabs. K7 is linear in s, so each
// slab is one more CTA row of the same kernel (blockIdx.y picks the slab).
// K6 needs each edge's whole d2 before it can form v and s: `knn_rows_wide`
// first walks a row's slots over every slab for d2, v, the loss term and
// s (kept in the shared s tile), then forms dL/de_i slab by slab. The
// E = 32 kernels are unchanged.
//
// Every sum has a fixed order and nothing is accumulated by atomics, so two
// runs on the same inputs are bit-identical. Built with -fmad=false and
// IEEE sqrtf and division (no fast math), so each row's terms are the plain
// PyTorch versions' (ops/knn_loss.py knn_rows_plain, knn_reverse_plain)
// operation for operation; only the reduction order of d2 and of the loss
// partials differs (K7's float64 sums run in CSR order, as the plain
// version's prefix sums).
//
// Bound on the H100: memory. K6 must read the table once, the ranks,
// weights and coef, and write de and s: at the bench graph (Cp = 100,352,
// K = 20, E = 32) ~50 MB, ~0.015 ms at 3.35 TB/s, against ~170 flops an edge
// (~0.34 GFLOP, ~0.005 ms). K7 reads the table, s, de and the reverse
// adjacency and writes the gradient, ~55 MB.

#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int E = 32;                   // embedding width
constexpr int Q = E / 4;                // float4 per row
constexpr int THREADS = 512;
constexpr int MAX_K = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float EPS = 1e-20f;

constexpr int R6 = 128;                 // K6: rank rows per CTA (ops/knn_loss.py ROWS_PER_BLOCK)
constexpr int L6 = 4;                   // K6: lanes per row
constexpr int R7 = 64;                  // K7: ranks per CTA, one per group (divides R6)
constexpr int L7 = 8;                   // K7: lanes per rank
constexpr int CHUNK = 2048;             // K7: in-edges staged per pass (16 KB)
constexpr int IN_FLIGHT = 2;            // K7: rows a group loads before summing
constexpr int K7_CTAS = 4;              // K7: CTAs per SM (<= 32 registers a thread)
static_assert(R6 % (THREADS / L6) == 0 && R7 % (THREADS / L7) == 0 && CHUNK % THREADS == 0,
              "whole rows per group, whole in-edges per thread");

// K6's slot tiles: ranks, weights and s of its R6 rows, an odd stride apart
__host__ __device__ constexpr int slot_stride(int K) { return K | 1; }
__host__ __device__ constexpr int rows_smem(int K) { return 3 * R6 * slot_stride(K) * 4; }

__global__ void __launch_bounds__(THREADS, 2)
knn_rows(const float* __restrict__ emb, const int* __restrict__ nbr,
         const float* __restrict__ w, const float* __restrict__ coef,
         float* __restrict__ de, float* __restrict__ s_out,
         float* __restrict__ partials, int K) {
  count_launch(SLOT_KNN_ROWS);
  constexpr int L = L6, V = Q / L, GROUPS = THREADS / L;
  extern __shared__ int tiles[];
  __shared__ float row_loss[R6];
  const int kp = slot_stride(K);
  int* nbr_t = tiles;
  float* w_t = reinterpret_cast<float*>(tiles + R6 * kp);
  float* s_t = w_t + R6 * kp;
  const float4* emb4 = reinterpret_cast<const float4*>(emb);
  const int r0 = blockIdx.x * R6;
  const long e0 = (long)r0 * K;
  for (int e = threadIdx.x; e < R6 * K; e += THREADS) {
    const int at = (e / K) * kp + e % K;
    nbr_t[at] = nbr[e0 + e];
    w_t[at] = w[e0 + e];
  }
  __syncthreads();

  const int sub = threadIdx.x & (L - 1);
  for (int rr = threadIdx.x / L; rr < R6; rr += GROUPS) {
    const int r = r0 + rr;
    const int* jr = nbr_t + rr * kp;
    const float* wr = w_t + rr * kp;
    const float cf = coef[r];
    float4 ei[V], ea[V], eb[V], acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      ei[v] = emb4[(long)r * Q + sub + L * v];
      ea[v] = emb4[(long)jr[0] * Q + sub + L * v];
      acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float lsum = 0.f;
    // slot k with e_j in `cur`; loads slot k + 1's row into `nxt` first
    auto slot = [&](int k, float4 (&cur)[V], float4 (&nxt)[V]) {
      if (k + 1 < K) {                            // uniform over the warp
        const long jn = jr[k + 1];
#pragma unroll
        for (int v = 0; v < V; ++v) nxt[v] = emb4[jn * Q + sub + L * v];
      }
      const float wk = wr[k];
      float4 d[V];
      float d2 = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        d[v] = make_float4(ei[v].x - cur[v].x, ei[v].y - cur[v].y, ei[v].z - cur[v].z,
                           ei[v].w - cur[v].w);
        d2 = d2 + d[v].x * d[v].x;
        d2 = d2 + d[v].y * d[v].y;
        d2 = d2 + d[v].z * d[v].z;
        d2 = d2 + d[v].w * d[v].w;
      }
      // xor butterfly inside the group: each step adds two equal pairs in
      // either order, so all L lanes hold the identical sum
#pragma unroll
      for (int o = 1; o < L; o <<= 1) d2 += __shfl_xor_sync(FULL, d2, o);
      const float vk = sqrtf(d2 * wk + EPS);
      lsum += cf * vk;
      const float sk = cf * wk / vk;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        acc[v].x += sk * d[v].x;
        acc[v].y += sk * d[v].y;
        acc[v].z += sk * d[v].z;
        acc[v].w += sk * d[v].w;
      }
      if (sub == 0) s_t[rr * kp + k] = sk;
    };
    int k = 0;
    for (; k + 1 < K; k += 2) {
      slot(k, ea, eb);
      slot(k + 1, eb, ea);
    }
    if (k < K) slot(k, ea, eb);
#pragma unroll
    for (int v = 0; v < V; ++v)
      reinterpret_cast<float4*>(de)[(long)r * Q + sub + L * v] = acc[v];
    if (sub == 0) row_loss[rr] = lsum;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R6 * K; e += THREADS) s_out[e0 + e] = s_t[(e / K) * kp + e % K];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float p = 0.f;
#pragma unroll
    for (int q = 0; q < R6 / 32; ++q) p += row_loss[lane * (R6 / 32) + q];
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(FULL, p, o);
    if (lane == 0) partials[blockIdx.x] = p;
  }
}

// K6 at E = 32 * ns: the same CTA, lanes and tiles as knn_rows, in two
// passes over each row's slots (the first for d2 over every slab, v, the
// loss term and s; the second for dL/de_i, one slab at a time)
__global__ void __launch_bounds__(THREADS, 2)
knn_rows_wide(const float* __restrict__ emb, const int* __restrict__ nbr,
              const float* __restrict__ w, const float* __restrict__ coef,
              float* __restrict__ de, float* __restrict__ s_out,
              float* __restrict__ partials, int K, int ns) {
  count_launch(SLOT_KNN_ROWS);
  constexpr int L = L6, V = Q / L, GROUPS = THREADS / L;
  extern __shared__ int tiles[];
  __shared__ float row_loss[R6];
  const int kp = slot_stride(K);
  int* nbr_t = tiles;
  float* w_t = reinterpret_cast<float*>(tiles + R6 * kp);
  float* s_t = w_t + R6 * kp;
  const long rq = (long)ns * Q;                 // float4 per row
  const float4* emb4 = reinterpret_cast<const float4*>(emb);
  const int r0 = blockIdx.x * R6;
  const long e0 = (long)r0 * K;
  for (int e = threadIdx.x; e < R6 * K; e += THREADS) {
    const int at = (e / K) * kp + e % K;
    nbr_t[at] = nbr[e0 + e];
    w_t[at] = w[e0 + e];
  }
  __syncthreads();

  const int sub = threadIdx.x & (L - 1);
  for (int rr = threadIdx.x / L; rr < R6; rr += GROUPS) {
    const int r = r0 + rr;
    const int* jr = nbr_t + rr * kp;
    const float* wr = w_t + rr * kp;
    float* sr = s_t + rr * kp;
    const float cf = coef[r];
    const float4* ei = emb4 + r * rq + sub;
    float lsum = 0.f;
    for (int k = 0; k < K; ++k) {
      const float4* ej = emb4 + jr[k] * rq + sub;
      float d2 = 0.f;
      for (int b = 0; b < ns; ++b) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float4 a = ei[b * Q + L * v], c = ej[b * Q + L * v];
          const float dx = a.x - c.x, dy = a.y - c.y, dz = a.z - c.z, dw = a.w - c.w;
          d2 = d2 + dx * dx;
          d2 = d2 + dy * dy;
          d2 = d2 + dz * dz;
          d2 = d2 + dw * dw;
        }
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1) d2 += __shfl_xor_sync(FULL, d2, o);
      const float wk = wr[k];
      const float vk = sqrtf(d2 * wk + EPS);
      lsum += cf * vk;
      if (sub == 0) sr[k] = cf * wk / vk;
    }
    __syncwarp();                               // the group's s are in the tile
    for (int b = 0; b < ns; ++b) {
      float4 a[V], acc[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        a[v] = ei[b * Q + L * v];
        acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int k = 0; k < K; ++k) {
        const float sk = sr[k];
        const float4* ej = emb4 + jr[k] * rq + sub;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float4 c = ej[b * Q + L * v];
          acc[v].x += sk * (a[v].x - c.x);
          acc[v].y += sk * (a[v].y - c.y);
          acc[v].z += sk * (a[v].z - c.z);
          acc[v].w += sk * (a[v].w - c.w);
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v)
        reinterpret_cast<float4*>(de)[r * rq + b * Q + sub + L * v] = acc[v];
    }
    if (sub == 0) row_loss[rr] = lsum;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R6 * K; e += THREADS) s_out[e0 + e] = s_t[(e / K) * kp + e % K];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float p = 0.f;
#pragma unroll
    for (int q = 0; q < R6 / 32; ++q) p += row_loss[lane * (R6 / 32) + q];
    for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(FULL, p, o);
    if (lane == 0) partials[blockIdx.x] = p;
  }
}

// acc += (double)(ns * (ei - ej)), component by component; ns = -s, so each
// term is the plain version's -(s * (e_i - e_j)) exactly
__device__ __forceinline__ void add_term(double (&acc)[4], float ns, float4 ei, float4 ej) {
  acc[0] += (double)(ns * (ei.x - ej.x));
  acc[1] += (double)(ns * (ei.y - ej.y));
  acc[2] += (double)(ns * (ei.z - ej.z));
  acc[3] += (double)(ns * (ei.w - ej.w));
}

// WIDE: rows of ns slabs (E = 32 * ns), the slab blockIdx.y; otherwise one
// 32-wide slab, and the code of the E = 32 kernel
template <bool WIDE>
__global__ void __launch_bounds__(THREADS, K7_CTAS)
knn_reverse(const float* __restrict__ emb, const float* __restrict__ s,
            const float* __restrict__ de, const int* __restrict__ rev_ptr,
            const int* __restrict__ rev_pair, float* __restrict__ out, int K, int ns) {
  count_launch(SLOT_KNN_REVERSE);
  constexpr int L = L7, GROUPS = THREADS / L, JPG = R7 / GROUPS;
  static_assert(L == Q, "one float4 of a row per lane");
  __shared__ int2 edge[CHUNK];   // a chunk of in-edges: (source rank, bits of -s)
  const float4* emb4 = reinterpret_cast<const float4*>(emb);
  const int r0 = blockIdx.x * R7;
  const int sub = threadIdx.x & (L - 1);
  const long rq = WIDE ? (long)ns * Q : Q;      // float4 per row
  const int col = (WIDE ? blockIdx.y * Q : 0) + sub;
  auto row = [&](int j) { return emb4[(long)j * rq + col]; };

  // group g owns ranks r0 + g + q * GROUPS; their in-edges are rev_pair
  // [p0[q], p1[q]), all inside the CTA's range [P0, P1)
  const int g = threadIdx.x / L;
  int p0[JPG], p1[JPG];
#pragma unroll
  for (int q = 0; q < JPG; ++q) {
    p0[q] = rev_ptr[r0 + g + q * GROUPS];
    p1[q] = rev_ptr[r0 + g + q * GROUPS + 1];
  }
  const int P0 = rev_ptr[r0], P1 = rev_ptr[r0 + R7];
  double acc[JPG][4] = {};
  for (int c = P0; c < P1; c += CHUNK) {
    const int m = min(CHUNK, P1 - c);
    if (c > P0) __syncthreads();                  // every group is done with the last chunk
    // each thread loads its CHUNK / THREADS pair ids, then their s, so that
    // its loads are in flight together
    int pid[CHUNK / THREADS];
    float ns[CHUNK / THREADS];
#pragma unroll
    for (int u = 0; u < CHUNK / THREADS; ++u) {
      const int e = threadIdx.x + u * THREADS;
      pid[u] = e < m ? rev_pair[c + e] : 0;
    }
#pragma unroll
    for (int u = 0; u < CHUNK / THREADS; ++u)
      ns[u] = threadIdx.x + u * THREADS < m ? -s[pid[u]] : 0.f;
#pragma unroll
    for (int u = 0; u < CHUNK / THREADS; ++u) {
      const int e = threadIdx.x + u * THREADS;
      if (e < m) edge[e] = make_int2(pid[u] / K, __float_as_int(ns[u]));
    }
    __syncthreads();                              // the chunk is in
#pragma unroll
    for (int q = 0; q < JPG; ++q) {
      const int a = max(p0[q], c) - c;
      const int n = max(min(p1[q], c + m) - c - a, 0);
      // the warp walks as many in-edges as its busiest group has here
      const int n_warp = __reduce_max_sync(FULL, n);
      if (n_warp == 0) continue;
      const float4 ej = row(r0 + g + q * GROUPS);
      // IN_FLIGHT in-edges at a time: every row is loaded before the first
      // is summed, so one far row's L2 latency covers the others'
      for (int t = 0; t < n_warp; t += IN_FLIGHT) {
        int2 x[IN_FLIGHT];
        float4 ei[IN_FLIGHT];
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u) x[u] = edge[t + u < n ? a + t + u : 0];
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u) ei[u] = t + u < n ? row(x[u].x) : ej;
#pragma unroll
        for (int u = 0; u < IN_FLIGHT; ++u)
          if (t + u < n) add_term(acc[q], __int_as_float(x[u].y), ei[u], ej);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < JPG; ++q) {
    const long j = r0 + g + q * GROUPS;
    const float4 d = reinterpret_cast<const float4*>(de)[j * rq + col];
    reinterpret_cast<float4*>(out)[j * rq + col] =
        make_float4(d.x + (float)acc[q][0], d.y + (float)acc[q][1], d.z + (float)acc[q][2],
                    d.w + (float)acc[q][3]);
  }
}

constexpr int MAX_DEVICES = 64;
int rows_ready[MAX_DEVICES];      // K6's shared-memory limit is raised on device d

// Allow both K6 kernels the slot tiles at the largest K (over the 48 KB
// default) and ask for the largest shared-memory carveout: once per device.
cudaError_t allow_rows() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && rows_ready[dev])) return err;
  const void* rows_kernels[] = {(const void*)knn_rows, (const void*)knn_rows_wide};
  for (const void* fn : rows_kernels) {
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 rows_smem(MAX_K));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && dev < MAX_DEVICES) rows_ready[dev] = 1;
  return err;
}

// E a positive multiple of 32 (ns = E / 32 slabs)
cudaError_t check_shape(int Cp, int e, int K) {
  return (e < E || e % E != 0 || Cp % R6 != 0 || Cp % R7 != 0 || K < 1 || K > MAX_K)
             ? cudaErrorInvalidValue
             : cudaSuccess;
}

}  // namespace

extern "C" int ed3dgs_knn_rows(const float* emb, const int* nbr, const float* w,
                               const float* coef, float* de, float* s, float* partials,
                               int Cp, int e, int K, void* stream) {
  if (Cp == 0) return 0;
  cudaError_t err = check_shape(Cp, e, K);
  if (err == cudaSuccess) err = allow_rows();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e == E)
    knn_rows<<<Cp / R6, THREADS, rows_smem(K), st>>>(emb, nbr, w, coef, de, s, partials, K);
  else
    knn_rows_wide<<<Cp / R6, THREADS, rows_smem(K), st>>>(emb, nbr, w, coef, de, s, partials,
                                                          K, e / E);
  return (int)cudaGetLastError();
}

extern "C" int ed3dgs_knn_reverse(const float* emb, const float* s, const float* de,
                                  const int* rev_ptr, const int* rev_pair, float* out,
                                  int Cp, int e, int K, void* stream) {
  if (Cp == 0) return 0;
  cudaError_t err = check_shape(Cp, e, K);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (e == E)
    knn_reverse<false><<<Cp / R7, THREADS, 0, st>>>(emb, s, de, rev_ptr, rev_pair, out, K, 1);
  else
    knn_reverse<true><<<dim3(Cp / R7, e / E), THREADS, 0, st>>>(emb, s, de, rev_ptr, rev_pair,
                                                               out, K, e / E);
  return (int)cudaGetLastError();
}

// The E = 32 kernels': K6's (which = 0, at K slots) or K7's (which = 1) registers per thread,
// shared memory per CTA, local memory per thread (the kernels hold no local
// arrays, so this is what ptxas spilled) and the CTAs an SM can hold at once.
extern "C" int ed3dgs_knn_info(int which, int K, int* regs, int* smem, int* local,
                               int* ctas_per_sm) {
  const void* fn = which == 0 ? (const void*)knn_rows : (const void*)knn_reverse<false>;
  const int dynamic = which == 0 ? rows_smem(K) : 0;
  cudaFuncAttributes attr;
  cudaError_t err = which == 0 ? allow_rows() : cudaSuccess;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem = dynamic + (int)attr.sharedSizeBytes;
  *local = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn, THREADS, dynamic);
}
