// K5a: tile-packed blend output -> channel-major image, and K5b, its inverse.
//
// Replaces the Pallas TPU kernel ed3dgs_tpu/ops/relayout.py::_unpack_kernel
// (entry unpack_image -> _unpack_impl, pallas_call at :68). Same function:
//   out[c, ty*16 + y, tx*16 + x] = in[ty, tx, c, 16*y + x]
// for in [gy, gxp, C, 256] and out [C, gy*16, gxp*16], float32.
//
// Bound on the H100: memory. A pure permutation: every byte is read once and
// written once (2 x 48 MB at 802x550 with C = 24, ~29 us at 3.35 TB/s). One
// thread per 4 consecutive output pixels of one row: the writes are 16-byte
// stores, fully coalesced across the warp; the reads are 16-byte loads from
// the matching 16-pixel tile row, so a warp reads eight 64-byte runs (one
// per tile), whole 32-byte sectors. No shared memory is needed.
//
// K5b replaces ed3dgs_tpu/ops/relayout.py::_pack_kernel (entry _pack_impl,
// pallas_call at :83), the cotangent path of unpack_image:
//   out[ty, tx, c, 16*y + x] = in[c, ty*16 + y, tx*16 + x]
// The same bound and the same design mirrored: one thread per float4 of the
// packed output, 16-byte coalesced writes, 16-byte reads of one image row.
//
// The layout exists because the TPU blend kernel writes whole tiles; a later
// change may fold this relayout into the blend kernel's epilogue.

#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

__global__ void __launch_bounds__(256)
unpack(const float4* __restrict__ in, float4* __restrict__ out, int gy, int gxp,
       int C, long n4) {
  count_launch(SLOT_UNPACK);
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int W4 = gxp * 4;          // float4s per output row (gxp*16 / 4)
  const int H = gy * 16;
  const int xg4 = (int)(i % W4);
  const long row = i / W4;
  const int yg = (int)(row % H);
  const int c = (int)(row / H);
  const int tx = xg4 >> 2, x4 = xg4 & 3;
  const int ty = yg >> 4, y = yg & 15;
  // float4 index of in[ty, tx, c, 16*y + 4*x4]
  const long src = (((long)ty * gxp + tx) * C + c) * 64 + y * 4 + x4;
  out[i] = in[src];
}

__global__ void __launch_bounds__(256)
pack(const float4* __restrict__ in, float4* __restrict__ out, int gy, int gxp, int C,
     long n4) {
  count_launch(SLOT_PACK);
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  // i = ((((ty * gxp) + tx) * C + c) * 16 + y) * 4 + x4
  const int x4 = (int)(i & 3);
  const int y = (int)((i >> 2) & 15);
  const long tile_c = i >> 6;
  const int c = (int)(tile_c % C);
  const long tile = tile_c / C;
  const int tx = (int)(tile % gxp);
  const int ty = (int)(tile / gxp);
  // float4 index of in[c, ty*16 + y, tx*16 + 4*x4]
  const long src = ((long)c * gy * 16 + ty * 16 + y) * (gxp * 4) + tx * 4 + x4;
  out[i] = in[src];
}

}  // namespace

extern "C" int ed3dgs_pack_image(const float* img, float* packed, int gy, int gxp, int C,
                                 void* stream) {
  const long n4 = (long)C * gy * 16 * gxp * 4;
  if (n4 == 0) return 0;
  const int threads = 256;
  const long blocks = (n4 + threads - 1) / threads;
  pack<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(img), reinterpret_cast<float4*>(packed), gy, gxp,
      C, n4);
  return (int)cudaGetLastError();
}

extern "C" int ed3dgs_unpack_image(const float* packed, float* out, int gy, int gxp,
                                   int C, void* stream) {
  const long n4 = (long)C * gy * 16 * gxp * 4;
  if (n4 == 0) return 0;
  const int threads = 256;
  const long blocks = (n4 + threads - 1) / threads;
  unpack<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(packed), reinterpret_cast<float4*>(out), gy,
      gxp, C, n4);
  return (int)cudaGetLastError();
}
