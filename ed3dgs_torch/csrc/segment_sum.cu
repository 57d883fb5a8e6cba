// K3: CSR segment sum of rows, out[s] = rows[starts[s]:ends[s]].sum(0), and
// the same sum over rows gathered through an index, out[s] =
// src[idx[starts[s]:ends[s]]].sum(0).
//
// Replaces the Pallas TPU kernel ed3dgs_tpu/ops/segment_sum.py::_kernel
// (entry segment_sum_rows, pallas_call at :122); K8 (_kernel_packed,
// pallas_call at :228) is bound to the same kernel. The TPU kernel resolves
// segment membership as a [128, chunk] 0/1 matrix and reduces with one MXU
// matmul per streamed chunk, one grid step per 128 segments. On Hopper a
// segment is a contiguous run of rows: the rasterizer's gradient has ~0.83 M
// rows of 26 floats in 100,352 segments, ~8 rows on average with a tail of
// hundreds.
//
// One launch; a CTA of eight warps takes eight consecutive segments, a warp
// each, lane f on column f (rows are at most 32 floats wide). A warp reads
// its segment's rows straight from global memory, eight rows in flight (for
// the gathered entry, the eight rows' indices come in one load and are
// broadcast by shuffles), and adds them in order into one float64 sum. Held
// to 32 registers, eight CTAs fit an SM, so 64 warps' loads are in flight
// there. A segment longer than LONG rows is left to the whole CTA once the
// short ones are done: warp w sums rows w, w+8, w+16, ... the same way and
// warp 0 adds the eight partials in warp order. Every output is the float32
// rounding of a float64 sum of its rows, in an order fixed by the bounds
// alone: two runs give the same bits, and nothing is accumulated by
// atomics. An empty segment gives zeros; no row outside a segment is read,
// so rows in gaps and past the last end are never summed. Any bounds with
// starts[s] <= ends[s] <= R are taken, overlapping or not.
//
// Design notes (PERF.md, PR 6; scripts/torch_segment_scan_variants.py
// times the variants that remain): the change from PR 5's kernel that
// paid is occupancy, eight rows in flight held to 32 registers. Kernels that
// balance the work by chunks of rows instead (each CTA copying a chunk into
// shared memory, finding its segments by a search of the bounds, summing
// the pieces and combining the segments that cross chunks in a second pass
// or by arrival counts), and a warp streaming the rows of several short
// segments as one sequence, were slower in every form tried: the searches,
// barriers and per-row bookkeeping took longer than the rows' loads, and
// the streaming warp needed more than 32 registers.
//
// Bound on the H100: memory. Each summed row is read once and each output
// written once: at the bench step's gradient, ~0.83 M rows of 26 floats
// (86 MB) and 100,352 x 26 floats out (10 MB), ~0.029 ms at 3.35 TB/s; the
// gathered entry also reads the index and whole 32-byte sectors of rows
// that lie anywhere in `src`. The float64 adds (~22 M) are far below that.

#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_F = 32;               // one lane per column
constexpr int DEPTH = 8;                // rows in flight per lane
constexpr int LONG = 64;                // longer segments are summed by the whole CTA
constexpr unsigned FULL = 0xffffffffu;

// The float64 sum of column `lane` over rows r0, r0 + step, ... < r1, in
// that order, DEPTH rows loaded before they are added. The whole warp calls
// it; lanes at or past F read no row. Gathering, row r is src row idx[r]:
// lane d < DEPTH reads the index of row r + d*step and every lane gets all.
template <bool GATHER>
__device__ __forceinline__ double column_sum(const float* __restrict__ rows,
                                             const int* __restrict__ idx, long r0, long r1,
                                             int step, int F, int lane) {
  double acc = 0.0;
  for (long r = r0; r < r1; r += (long)DEPTH * step) {
    const int n = (int)min((long)DEPTH, (r1 - r + step - 1) / step);   // rows this round
    float x[DEPTH];
    if (GATHER) {
      const int j = lane < n ? idx[r + (long)lane * step] : 0;
      int at[DEPTH];
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) at[d] = __shfl_sync(FULL, j, d);
#pragma unroll
      for (int d = 0; d < DEPTH; ++d)
        x[d] = d < n && lane < F ? rows[(long)at[d] * F + lane] : 0.f;
    } else {
      const float* p = rows + r * F + lane;
      const long stride = (long)step * F;
#pragma unroll
      for (int d = 0; d < DEPTH; ++d) x[d] = d < n && lane < F ? p[d * stride] : 0.f;
    }
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) acc += (double)x[d];
  }
  return acc;
}

template <bool GATHER>
__global__ void __launch_bounds__(THREADS, 8)
segment_sum(const float* __restrict__ rows, const int* __restrict__ idx,
            const int* __restrict__ starts, const int* __restrict__ ends,
            float* __restrict__ out, int S, int F) {
  // the gathered instance is K3's kernel; the plain one K8's (no path calls
  // K3 without an index)
  count_launch(GATHER ? SLOT_SEGMENT_SUM : SLOT_SEGMENT_SUM_ROWS);
  __shared__ int long_seg[WARPS];
  __shared__ double red[WARPS][MAX_F];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long s = (long)blockIdx.x * WARPS + warp;
  long r0 = 0, r1 = 0;
  if (s < S) {
    r0 = starts[s];
    r1 = ends[s];
  }
  const bool is_long = r1 - r0 > LONG;
  if (lane == 0) long_seg[warp] = is_long ? (int)s : -1;
  if (s < S && !is_long) {
    const double v = column_sum<GATHER>(rows, idx, r0, r1, 1, F, lane);
    if (lane < F) out[s * F + lane] = (float)v;
  }
  __syncthreads();
  for (int w = 0; w < WARPS; ++w) {
    const int sl = long_seg[w];
    if (sl < 0) continue;                         // the same for every thread
    const double v = column_sum<GATHER>(rows, idx, (long)starts[sl] + warp, ends[sl], WARPS,
                                        F, lane);
    if (lane < F) red[warp][lane] = v;
    __syncthreads();
    if (warp == 0 && lane < F) {
      double acc = red[0][lane];
#pragma unroll
      for (int q = 1; q < WARPS; ++q) acc += red[q][lane];
      out[(long)sl * F + lane] = (float)acc;
    }
    __syncthreads();
  }
}

int launch(const float* rows, const int* idx, const int* starts, const int* ends, float* out,
           int S, int F, cudaStream_t stream) {
  if (S == 0) return 0;
  if (F < 1 || F > MAX_F) return (int)cudaErrorInvalidValue;
  const long blocks = (S + WARPS - 1) / WARPS;
  if (idx)
    segment_sum<true><<<blocks, THREADS, 0, stream>>>(rows, idx, starts, ends, out, S, F);
  else
    segment_sum<false><<<blocks, THREADS, 0, stream>>>(rows, idx, starts, ends, out, S, F);
  return (int)cudaGetLastError();
}

}  // namespace

// rows [R, F] -> out [S, F]
extern "C" int ed3dgs_segment_sum(const float* rows, const int* starts, const int* ends,
                                  float* out, int S, int F, void* stream) {
  return launch(rows, nullptr, starts, ends, out, S, F, static_cast<cudaStream_t>(stream));
}

// src [*, F] gathered through idx [R] -> out [S, F]
extern "C" int ed3dgs_segment_sum_gathered(const float* src, const int* idx, const int* starts,
                                           const int* ends, float* out, int S, int F,
                                           void* stream) {
  return launch(src, idx, starts, ends, out, S, F, static_cast<cudaStream_t>(stream));
}
