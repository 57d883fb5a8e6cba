// X1: exact k-nearest neighbours of a point cloud, self included.
//
// For every query i < N, the k1 = k+1 smallest keys over all j < N, nearest
// first, where
//
//   sq_i  = fma(z, z, fma(y, y, x * x))
//   c_ij  = fma(z_i, z_j, fma(y_i, y_j, x_i * x_j))
//   d2_ij = (sq_i + sq_j) - 2 * c_ij
//   key   = d2's order-preserving bits above the index j
//
// every operation rounded once in float32 (ops/knn.py `knn_plain`, which
// forms the same chains in float64 and rounds once). The key is a total
// order: equal distances go to the lower index, as XLA's top_k resolves
// them, and -0 sorts before +0, as in the plain version. ops/knn.py `knn`
// drops the self-match afterwards, on both routes.
//
// X1 replaces no Pallas kernel: it is the counterpart of the jitted XLA
// function ed3dgs_tpu/ops/knn.py:39 `knn` (a matmul, broadcasts and
// top_k over blocks of 1024 rows). The inner dimension is 3, so tensor
// cores (TF32 at best) would gain little and move neighbours: the chains
// run on the fp32 cores, written with __fmul_rn, __fmaf_rn, __fadd_rn and
// __fsub_rn so that no contraction or reordering moves a bit (the library
// is also built with -fmad=false).
//
// Bound by operations: N^2 pairs of 7 fp32 operations (three for c, the
// add, the doubling, the subtraction, the compare), ~1.05 ms at N =
// 100,352 on an H100 at 67 TFLOP/s. The design is the simple one first:
//
//   - `knn_prologue` writes the cloud once as (x, y, z, sq) float4;
//   - `knn_select<K>`: one thread per query, ROWS queries a CTA. The CTA
//     stages the cloud through shared memory in tiles of ROWS float4 (every
//     thread of a warp reads the same float4: a broadcast). Each thread
//     keeps its K smallest keys sorted in registers (K a template
//     parameter, so the list is never indexed at run time) and scans the
//     candidates in ascending j. One float compare against the current
//     worst distance lets a candidate through (a superset of the key test,
//     NaN included); only then are its key formed and the list updated by
//     one branch-free insertion pass. Since j ascends, a candidate whose
//     distance bits equal the worst's loses to it, as its key says.
//   - k1 <= 32. The wrapper picks the smallest instance K >= k1 (2, 4, 8,
//     16, 21, 32) and writes the first k1 entries: the k1 smallest of the K
//     smallest.
//
// wgmma, TMA and warp-level selection are later work.

#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int ROWS = 256;          // queries a CTA (one a thread), and points a tile
constexpr int MAX_K1 = 32;
constexpr unsigned long long NO_KEY = ~0ull;   // above every key of a real point

// the plain version's int64 key (ops/knn.py `_order_key`) as an unsigned
// value of the same order: the high word's sign bit flipped
__device__ __forceinline__ unsigned long long order_key(float d2, unsigned j) {
  int bits = __float_as_int(d2);
  bits = bits >= 0 ? bits : bits ^ 0x7FFFFFFF;
  return ((unsigned long long)((unsigned)bits ^ 0x80000000u) << 32) | j;
}

// the distance a key holds (NO_KEY gives a NaN, which lets every candidate
// through the float pre-test)
__device__ __forceinline__ float key_d2(unsigned long long key) {
  int bits = (int)((unsigned)(key >> 32) ^ 0x80000000u);
  return __int_as_float(bits >= 0 ? bits : bits ^ 0x7FFFFFFF);
}

__global__ void knn_prologue(const float* __restrict__ pts, float4* __restrict__ cloud,
                             int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
  cloud[i] = make_float4(x, y, z, __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x))));
}

template <int K>
__global__ void __launch_bounds__(ROWS) knn_select(const float4* __restrict__ cloud,
                                                   float* __restrict__ d2_out,
                                                   long long* __restrict__ idx_out, int n,
                                                   int k1) {
  count_launch(SLOT_KNN);
  __shared__ float4 tile[ROWS];
  const int i = blockIdx.x * ROWS + threadIdx.x;
  // rows past n query the last point and write nothing; they still stage tiles
  const float4 q = cloud[min(i, n - 1)];
  unsigned long long best[K];
#pragma unroll
  for (int s = 0; s < K; ++s) best[s] = NO_KEY;
  float worst = key_d2(NO_KEY);

  for (int base = 0; base < n; base += ROWS) {
    __syncthreads();
    if (base + (int)threadIdx.x < n) tile[threadIdx.x] = cloud[base + threadIdx.x];
    __syncthreads();
    const int m = min(ROWS, n - base);
#pragma unroll 4
    for (int t = 0; t < m; ++t) {
      const float4 p = tile[t];
      const float c = __fmaf_rn(q.z, p.z, __fmaf_rn(q.y, p.y, __fmul_rn(q.x, p.x)));
      const float d2 = __fsub_rn(__fadd_rn(q.w, p.w), __fmul_rn(2.0f, c));
      if (!(d2 > worst)) {
        const unsigned long long key = order_key(d2, (unsigned)(base + t));
        if (key < best[K - 1]) {
          // one insertion pass from the end: entries above the key move up
#pragma unroll
          for (int s = K - 1; s > 0; --s)
            best[s] = key < best[s - 1] ? best[s - 1] : (key < best[s] ? key : best[s]);
          best[0] = key < best[0] ? key : best[0];
          worst = key_d2(best[K - 1]);
        }
      }
    }
  }
  if (i >= n) return;
  float* d2_row = d2_out + (size_t)i * k1;
  long long* idx_row = idx_out + (size_t)i * k1;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (s < k1) {
      d2_row[s] = key_d2(best[s]);
      idx_row[s] = (long long)(unsigned)best[s];
    }
  }
}

// the instance that serves k1, or nullptr past MAX_K1
const void* instance(int k1) {
  if (k1 < 1 || k1 > MAX_K1) return nullptr;
  if (k1 <= 2) return (const void*)knn_select<2>;
  if (k1 <= 4) return (const void*)knn_select<4>;
  if (k1 <= 8) return (const void*)knn_select<8>;
  if (k1 <= 16) return (const void*)knn_select<16>;
  if (k1 <= 21) return (const void*)knn_select<21>;
  return (const void*)knn_select<32>;
}

}  // namespace

// pts [n, 3] float32 -> d2 [n, k1] float32, idx [n, k1] int64; cloud is a
// scratch [n] float4 the prologue fills. n >= k1 (the wrapper checks).
extern "C" int ed3dgs_knn(const float* pts, void* cloud, float* d2, long long* idx, int n,
                          int k1, void* stream) {
  const void* fn = instance(k1);
  if (fn == nullptr || n < k1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float4* c = static_cast<float4*>(cloud);
  knn_prologue<<<(n + ROWS - 1) / ROWS, ROWS, 0, st>>>(pts, c, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&c, &d2, &idx, &n, &k1};
  return (int)cudaLaunchKernel(fn, dim3((n + ROWS - 1) / ROWS), dim3(ROWS), args, 0, st);
}

// The instance that serves k1: registers per thread, shared memory per CTA,
// local (spilled) bytes per thread and the CTAs an SM can hold at once.
extern "C" int ed3dgs_knn_info(int k1, int* regs, int* smem, int* local, int* ctas_per_sm) {
  const void* fn = instance(k1);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *smem = (int)attr.sharedSizeBytes;
  *local = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn, ROWS, 0);
}
