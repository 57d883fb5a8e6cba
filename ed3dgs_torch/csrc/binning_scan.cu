// K4: fused pair-slot scans + rect decode + sort-key pack for tile binning;
// X2 (below): the delta streams K4 scans, from each row's previous boundary.
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

// X2: each depth-ranked row's previous boundary, and the delta streams
// dv, dpk that K4 scans.
//
// Replaces no Pallas kernel: the JAX package finds the previous boundary
// with jax.lax.cummax (ed3dgs_tpu/ops/binning.py:150-153, left to XLA),
// three times over the N rows, and the plain version
// (ops/binning_scan.py boundary_deltas_plain) with three torch.cummax calls.
// Each scanned word holds the row index in its high bits, so over the valid
// rows (tiles > 0, first slot pos = offset - tiles below K) it strictly
// increases, and its running max is the word of the last valid row j < i.
// One exclusive max-scan of (valid ? i : -1) finds j for all three words,
// and each valid row i writes its two deltas at its first slot:
//   dv[pos_i]  = v_i - v_j,         v  = i << b | (pos mod 2^b)
//   dpk[pos_i] = pk_i - pk'_j,      pk = base << 9 | rect_w,
//                                   pk' = (base mod 2^b) << 9 | (rect_w mod 2^9)
// with v_j = pk'_j = 0 where no valid row precedes i. The first slots of the
// valid rows step by their tile counts, so they are distinct and the writes
// equal the plain version's scatter-adds into zeroed [K] buffers. A valid row
// whose first slot is K or more is dropped there and here; only rows after it
// follow it, and they are dropped too.
//
// X2 writes every slot of [0, K), so dv and dpk need no memset: the rows of
// a tile own the contiguous slots [offset before its first row, offset of
// its last row), which the CTA zeroes before its first-slot writes (a
// __syncthreads between), and the slots past the last offset are zeroed by
// all CTAs in turn.
//
// Bound on the H100: memory, and at the main path's N the launch. It reads
// the row's five int32 (tiles, rect min and max) and its offset, 24 bytes a
// row (4.8 MB at N = 200,000, ~1.4 us at 3.35 TB/s), and writes 8 bytes a
// slot of [0, K). The scan is scan_decode's single pass with a decoupled
// look-back, with max in place of +: tiles of ROW_TILE rows from an atomic
// counter, ROW_ITEMS consecutive rows a thread, one 64-bit word a tile
// (READY | 1 + the tile's last valid row, 0 for none), every predecessor's
// word read at once, the state cleared by the CTA that finishes reading last.

constexpr int ROW_ITEMS = 4;                   // consecutive rows per thread
constexpr int ROW_TILE = THREADS * ROW_ITEMS;  // 1024 rows per CTA

struct Row {
  int tiles, pos, base, rw;
};

// row r's record: rows is [N, 5] (tiles, rect_min x, y, rect_max x, y)
__device__ __forceinline__ Row load_row(const int* __restrict__ rows,
                                        const int* __restrict__ offsets, long r,
                                        int grid_x) {
  const int* p = rows + 5 * r;
  Row o;
  o.tiles = __ldg(p);
  o.pos = __ldg(offsets + r) - o.tiles;
  const int x0 = __ldg(p + 1), y0 = __ldg(p + 2), x1 = __ldg(p + 3);
  o.base = y0 * grid_x + x0;
  o.rw = max(x1 - x0, 1);
  return o;
}

__device__ __forceinline__ int warp_inclusive_max(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x = max(x, y);
  }
  return x;
}

// Block-wide exclusive max-scan (identity -1) of one value per thread, and
// the block's max. Every thread of the block must call it.
__device__ __forceinline__ void block_exclusive_max(int a, int& ex, int& total) {
  __shared__ int s[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ia = warp_inclusive_max(a);
  const int before = __shfl_up_sync(FULL, ia, 1);
  if (lane == 31) s[warp] = ia;
  __syncthreads();
  if (warp == 0) {
    int x = lane < WARPS ? s[lane] : -1;
    x = warp_inclusive_max(x);
    if (lane < WARPS) s[lane] = x;
  }
  __syncthreads();
  ex = max(warp ? s[warp - 1] : -1, lane ? before : -1);
  total = s[WARPS - 1];
}

// state: [0] the tile counter and [1] the count of CTAs done reading (low 32
// bits each); then one word a tile. Zero on entry and left zero. Every slot
// of dv and dpk is written.
__global__ void __launch_bounds__(THREADS)
boundary_deltas(const int* __restrict__ rows, const int* __restrict__ offsets,
                int* __restrict__ dv, int* __restrict__ dpk,
                unsigned long long* __restrict__ state, int N, int K, int grid_x, int b) {
  count_launch(SLOT_BOUNDARY_DELTAS);
  __shared__ int tile_sh, prefix_sh;
  __shared__ unsigned part[WARPS];
  if (threadIdx.x == 0) tile_sh = (int)atomicAdd(reinterpret_cast<unsigned*>(state), 1u);
  __syncthreads();
  const int tile = tile_sh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // zero the tile's slots and its share of the slots past the last offset;
  // the first-slot writes below follow at least one __syncthreads
  {
    const long r0 = (long)tile * ROW_TILE, r1 = min((long)N, r0 + ROW_TILE);
    const int lo = min(__ldg(offsets + r0) - __ldg(rows + 5 * r0), K);
    const int hi = min(__ldg(offsets + r1 - 1), K);
    for (int p = lo + threadIdx.x; p < hi; p += THREADS) {
      dv[p] = 0;
      dpk[p] = 0;
    }
    const int total = __ldg(offsets + N - 1);
    for (long p = (long)max(total, 0) + (long)tile * THREADS + threadIdx.x; p < K;
         p += (long)gridDim.x * THREADS) {
      dv[p] = 0;
      dpk[p] = 0;
    }
  }
  const long first = (long)tile * ROW_TILE + (long)threadIdx.x * ROW_ITEMS;
  Row row[ROW_ITEMS];
  bool valid[ROW_ITEMS];
  int last = -1;
#pragma unroll
  for (int k = 0; k < ROW_ITEMS; ++k) {
    valid[k] = false;
    if (first + k < N) {
      row[k] = load_row(rows, offsets, first + k, grid_x);
      valid[k] = row[k].tiles > 0 && (unsigned)row[k].pos < (unsigned)K;
      if (valid[k]) last = (int)(first + k);
    }
  }
  int ex, agg;
  block_exclusive_max(last, ex, agg);

  unsigned long long* words = state + 2;
  if (threadIdx.x == 0) store_word(words + tile, READY | (unsigned)(agg + 1));
  // 1 + the last valid row of the preceding tiles (0: none), a tile a thread
  unsigned pm = 0u;
  for (int t = threadIdx.x; t < tile; t += THREADS) {
    unsigned long long w;
    do {
      w = load_word(words + t);
    } while (!(w & READY));
    pm = max(pm, (unsigned)w);
  }
  pm = __reduce_max_sync(FULL, pm);
  if (lane == 0) part[warp] = pm;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned a = 0u;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) a = max(a, part[w]);
    prefix_sh = (int)a - 1;
    // every CTA has read what it needs once all have counted themselves
    // here: the last one clears the state for the next launch
    __threadfence();
    unsigned* done = reinterpret_cast<unsigned*>(state + 1);
    if (atomicAdd(done, 1u) == gridDim.x - 1) {
      for (long w = 0; w < 2L + gridDim.x; ++w) state[w] = 0ull;
    }
  }
  __syncthreads();
  const int prev = max(prefix_sh, ex);
  const unsigned mask = (1u << b) - 1u;
  // the previous valid row's v and pk', read once the thread needs them
  unsigned pv = 0u, ppk = 0u;
  bool have = prev < 0;
#pragma unroll
  for (int k = 0; k < ROW_ITEMS; ++k) {
    if (!valid[k]) continue;
    if (!have) {
      const Row q = load_row(rows, offsets, prev, grid_x);
      pv = ((unsigned)prev << b) | ((unsigned)q.pos & mask);
      ppk = (((unsigned)q.base & mask) << 9) | ((unsigned)q.rw & 0x1FFu);
      have = true;
    }
    const Row& r = row[k];
    const unsigned v = ((unsigned)(first + k) << b) | ((unsigned)r.pos & mask);
    const unsigned pk = ((unsigned)r.base << 9) | (unsigned)r.rw;
    dv[r.pos] = (int)(v - pv);
    dpk[r.pos] = (int)(pk - ppk);
    pv = v;
    ppk = (((unsigned)r.base & mask) << 9) | ((unsigned)r.rw & 0x1FFu);
  }
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

// rows: [N, 5] int32 (tiles, rect_min, rect_max) in depth order; offsets: [N]
// int32, the inclusive scan of the tiles; dv, dpk: [K] int32, each slot
// written. N must be at least 1.
// state: 8 * (2 + ceil(N / 1024)) bytes, 8-byte aligned, zero on entry and
// left zero (ops/binning_scan.py keeps one per device and stream).
extern "C" int ed3dgs_boundary_deltas(const int* rows, const int* offsets, int* dv, int* dpk,
                                      void* state, int N, int K, int grid_x, int b,
                                      void* stream) {
  if (N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (N + ROW_TILE - 1) / ROW_TILE;
  boundary_deltas<<<tiles, THREADS, 0, s>>>(rows, offsets, dv, dpk,
                                            static_cast<unsigned long long*>(state), N, K,
                                            grid_x, b);
  return (int)cudaGetLastError();
}
