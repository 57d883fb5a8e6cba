// K3: CSR segment sum of rows, out[s] = rows[starts[s]:ends[s]].sum(0).
//
// Replaces the Pallas TPU kernel ed3dgs_tpu/ops/segment_sum.py::_kernel
// (entry segment_sum_rows, pallas_call at :122). The TPU kernel resolves
// segment membership as a [128, chunk] 0/1 matrix and reduces with one MXU
// matmul per streamed chunk; on Hopper a segment is a contiguous run of rows,
// so one warp sums one segment directly: lane f owns column f (rows are at
// most 32 floats wide; the rasterizer's pair-gradient rows are 26), and the
// warp walks the segment's rows in order. Four interleaved accumulators keep
// four loads in flight; they are combined in a fixed order, and every sum is
// taken in float64 and rounded to float32 once, so the result does not depend
// on the launch (no atomics: the ROADMAP's deterministic-gradient rule) and is
// the float32 rounding of the exact sum to within float64 rounding.
// An empty segment (starts == ends) gives zeros. No row past ends[s] is read,
// so the TPU kernel's over-read slack rows are not needed.
//
// Bound on the H100: memory. Each row is read once and each output written
// once: at the bench frame's gradient, ~2^20 rows of 26 floats (109 MB) and
// 100,352 x 26 floats out (10 MB), ~0.036 ms at 3.35 TB/s. A warp reads one
// 104-byte row per step, so the loads are whole 32-byte sectors but only 26
// of 32 lanes are busy; a segment of thousands of rows is one warp's serial
// loop, which a later change may split.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;

__global__ void __launch_bounds__(WARPS * 32)
segment_sum(const float* __restrict__ rows, const int* __restrict__ starts,
            const int* __restrict__ ends, float* __restrict__ out, int S, int F) {
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int f = threadIdx.x & 31;
  if (s >= S || f >= F) return;
  const long r0 = starts[s];
  const long r1 = ends[s];
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  long r = r0;
  for (; r + 4 <= r1; r += 4) {
    const float* p = rows + r * F + f;
    a0 += (double)p[0];
    a1 += (double)p[F];
    a2 += (double)p[2 * F];
    a3 += (double)p[3 * F];
  }
  for (; r < r1; ++r) a0 += (double)rows[r * F + f];
  out[(long)s * F + f] = (float)((a0 + a1) + (a2 + a3));
}

}  // namespace

extern "C" int ed3dgs_segment_sum(const float* rows, const int* starts, const int* ends,
                                  float* out, int S, int F, void* stream) {
  if (S == 0) return 0;
  const int blocks = (S + WARPS - 1) / WARPS;
  segment_sum<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, starts, ends, out, S, F);
  return (int)cudaGetLastError();
}
