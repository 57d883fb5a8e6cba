// K4: fused pair-slot scans + rect decode + sort-key pack for tile binning.
//
// Replaces the Pallas TPU kernel ed3dgs_tpu/ops/binning_scan.py::_kernel
// (entry fused_bin_scans, pallas_call at :148). Same function: inclusive
// int32 prefix sums of the two delta streams dv and dpk over all K pair
// slots, then per slot p
//   v = scan(dv)[p], pk = scan(dpk)[p]
//   rank = v >> b, k = (p - v) & (2^b - 1)
//   rw = max(pk & 0x1FF, 1), q = k / rw, r = k - q*rw    (a real int divide)
//   tile = p < total ? (pk >> 9) + q*grid_x + r : num_tiles
//   key[p] = (tile << rank_bits) | rank
//
// Bound on the H100: memory. The function reads 2*K int32 and writes K int32
// (12.6 MB at K = 2^20, ~4 us at 3.35 TB/s); the arithmetic is a few integer
// ops per slot. The TPU kernel walks the grid in order and carries the scan
// in SMEM; Hopper's blocks run in no order, so this is one pass with a
// decoupled look-back, in one launch:
//   - a CTA takes the next tile of TILE slots from an atomic counter (so
//     every tile it may wait on is already running) and reads each input
//     once, 16 consecutive slots a thread as four 16-byte loads a stream;
//   - it scans its tile and publishes the tile's two sums (the
//     aggregates); then every thread of the CTA reads the aggregates of
//     its share of the preceding tiles at once (one thread a tile: at
//     K = 2^20 the 256 tiles all run together, so a chained look-back
//     would wait a round trip for each tile that has not yet published
//     its prefix) and the CTA adds them. Each published value is one
//     64-bit word (ready flag << 32 | value) per stream, stored and loaded
//     whole at gpu scope, so a value is never seen without its flag; no
//     other data is read through it, so relaxed accesses suffice (release
//     and acquire measured ~1.5 us slower, scripts/torch_segment_scan_variants.py);
//   - it adds the prefix, decodes and writes the keys.
// Sums are int32 additions modulo 2^32, as the plain version's int64 cumsum
// narrowed to int32, in any grouping: the keys are bit-exact. At K = 2^20
// the 256 tiles are about one wave of CTAs. `total` is read from device
// memory, so the host never synchronises. The tile counter and the
// published words live in a buffer the wrapper keeps zeroed for its device
// and stream: the CTA that finishes reading last clears them again, so no
// memset precedes the launch.

#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;                // consecutive slots per thread
constexpr int TILE = THREADS * ITEMS;    // 4096 slots per CTA
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long READY = 1ull << 32;

__device__ __forceinline__ unsigned warp_inclusive(unsigned x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  return x;
}

// Block-wide exclusive scan of one value per thread, for two streams at
// once, and the block totals. Every thread of the block must call it.
__device__ __forceinline__ void block_exclusive2(unsigned a, unsigned b, unsigned& ea,
                                                 unsigned& eb, unsigned& ta, unsigned& tb) {
  __shared__ unsigned sa[WARPS], sb[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ia = warp_inclusive(a), ib = warp_inclusive(b);
  if (lane == 31) { sa[warp] = ia; sb[warp] = ib; }
  __syncthreads();
  if (warp == 0) {
    unsigned x = lane < WARPS ? sa[lane] : 0u;
    unsigned y = lane < WARPS ? sb[lane] : 0u;
    x = warp_inclusive(x);
    y = warp_inclusive(y);
    if (lane < WARPS) { sa[lane] = x; sb[lane] = y; }
  }
  __syncthreads();
  ea = (warp ? sa[warp - 1] : 0u) + ia - a;
  eb = (warp ? sb[warp - 1] : 0u) + ib - b;
  ta = sa[WARPS - 1];
  tb = sb[WARPS - 1];
}

__device__ __forceinline__ unsigned long long load_word(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_word(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// K % 16 == 0 (the wrapper requires K % 128 == 0), so a thread's 16 slots
// are either all in range or all out, and 16-byte aligned.
__device__ __forceinline__ bool load16(const int* __restrict__ src, long base, int K,
                                       unsigned (&x)[ITEMS]) {
  if (base >= K) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) x[i] = 0u;
    return false;
  }
#pragma unroll
  for (int q = 0; q < ITEMS / 4; ++q) {
    const int4 v = *reinterpret_cast<const int4*>(src + base + 4 * q);
    x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z; x[4 * q + 3] = v.w;
  }
  return true;
}

// state: [0] the tile counter and [1] the count of CTAs done reading (low 32
// bits each); then per tile two words: the aggregates of v and of pk. Zero
// on entry and left zero.
__global__ void __launch_bounds__(THREADS)
scan_decode(const int* __restrict__ dv, const int* __restrict__ dpk,
            const int* __restrict__ total_ptr, int* __restrict__ key,
            unsigned long long* __restrict__ state, int K, int grid_x, int num_tiles,
            int rank_bits, int b) {
  count_launch(SLOT_BIN_SCANS);
  __shared__ int tile_sh;
  __shared__ unsigned prefix_sh[2];
  if (threadIdx.x == 0) tile_sh = (int)atomicAdd(reinterpret_cast<unsigned*>(state), 1u);
  __syncthreads();
  const int tile = tile_sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long base = (long)tile * TILE + (long)threadIdx.x * ITEMS;
  unsigned v[ITEMS], pk[ITEMS];
  const bool in_range = load16(dv, base, K, v);
  load16(dpk, base, K, pk);
#pragma unroll
  for (int i = 1; i < ITEMS; ++i) { v[i] += v[i - 1]; pk[i] += pk[i - 1]; }
  unsigned ev, epk, tv, tpk;
  block_exclusive2(v[ITEMS - 1], pk[ITEMS - 1], ev, epk, tv, tpk);

  unsigned long long* words = state + 2;
  if (threadIdx.x == 0) {
    store_word(words + 2L * tile, READY | tv);
    store_word(words + 2L * tile + 1, READY | tpk);
  }
  // the preceding tiles' aggregates, a tile a thread
  unsigned pv = 0u, ppk = 0u;
  for (int t = threadIdx.x; t < tile; t += THREADS) {
    unsigned long long av, apk;
    do {
      av = load_word(words + 2L * t);
      apk = load_word(words + 2L * t + 1);
    } while (!((av & READY) && (apk & READY)));
    pv += (unsigned)av;
    ppk += (unsigned)apk;
  }
  pv = __reduce_add_sync(FULL, pv);
  ppk = __reduce_add_sync(FULL, ppk);
  __shared__ unsigned part_v[WARPS], part_pk[WARPS];
  if (lane == 0) { part_v[warp] = pv; part_pk[warp] = ppk; }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned a = 0u, c = 0u;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) { a += part_v[w]; c += part_pk[w]; }
    prefix_sh[0] = a;
    prefix_sh[1] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // every CTA has read what it needs once all have counted themselves
    // here: the last one clears the state for the next launch
    __threadfence();
    unsigned* done = reinterpret_cast<unsigned*>(state + 1);
    if (atomicAdd(done, 1u) == gridDim.x - 1) {
      for (long w = 0; w < 2L + 2L * gridDim.x; ++w) state[w] = 0ull;
    }
  }
  if (!in_range) return;
  const unsigned off_v = prefix_sh[0] + ev;
  const unsigned off_pk = prefix_sh[1] + epk;
  const int total = *total_ptr;
  const int kmask = (1 << b) - 1;
  int out[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int p = (int)base + i;
    const int vv = (int)(v[i] + off_v);
    const int pp = (int)(pk[i] + off_pk);
    const int rank = vv >> b;
    const int k = (p - vv) & kmask;
    const int rw = max(pp & 0x1FF, 1);
    const int q = k / rw;
    const int r = k - q * rw;
    const int tile_id = p < total ? (pp >> 9) + q * grid_x + r : num_tiles;
    out[i] = (tile_id << rank_bits) | rank;
  }
#pragma unroll
  for (int q = 0; q < ITEMS / 4; ++q)
    *reinterpret_cast<int4*>(key + base + 4 * q) =
        make_int4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
}

}  // namespace

// state: 8 * (2 + 2 * ceil(K / 4096)) bytes, 8-byte aligned, zero on entry
// and left zero (ops/binning_scan.py keeps one per device and stream).
extern "C" int ed3dgs_fused_bin_scans(const int* dv, const int* dpk, const int* total,
                                      int* key, void* state, int K, int grid_x,
                                      int num_tiles, int rank_bits, int b,
                                      void* stream) {
  if (K == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (K + TILE - 1) / TILE;
  scan_decode<<<tiles, THREADS, 0, s>>>(dv, dpk, total, key,
                                        static_cast<unsigned long long*>(state), K,
                                        grid_x, num_tiles, rank_bits, b);
  return (int)cudaGetLastError();
}
