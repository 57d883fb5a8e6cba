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
// them, and -0 sorts before +0, as in the plain version. Each row then
// drops its self-match as `knn_plain` does (ops/knn.py `_drop_self`): of
// its k1 keys, the k that are not i, in order, or the first k if i is not
// among them.
//
// X1 replaces no Pallas kernel: it is the counterpart of the jitted XLA
// function ed3dgs_tpu/ops/knn.py:39 `knn` (a matmul, broadcasts and
// top_k over blocks of 1024 rows). The inner dimension is 3, so tensor
// cores (TF32 at best) would gain little and move neighbours: the chains
// run on the fp32 cores, written with __fmul_rn, __fmaf_rn, __fadd_rn and
// __fsub_rn so that no contraction or reordering moves a bit (the library
// is also built with -fmad=false).
//
// What bounds it: the function's floor is its bytes (the points read once,
// the k nearest's distances and indices written once: ~25 MB, ~7.5 us at N
// = 100,352, k = 20); the flops of the N (k+1) pairs its answer holds are
// far below that. A pair the search evaluates costs 8 flops as the 67
// TFLOP/s peak counts them (fmul 1, two fma 4, add 1, doubling 1, subtract
// 1): all N^2 pairs (the JAX function's work, and X1's first design) take
// ~1.2 ms at N = 100,352; this design evaluates a few per cent of them,
// because a query's k+1 nearest lie in a small neighbourhood. In practice
// the insertion passes (a warp pays for one whenever any lane inserts) and
// the latency of each lane's dependent chains weigh as much as the pairs
// (PERF.md, section 6):
//
//   - `knn_codes`: a 63-bit Morton code a point, 21 bits an axis over the
//     cloud's whole box (ops/knn.py gives the box and argsorts the codes).
//     Dead slots parked on the far shell (~1e3, ops/knn.py `far_shell`)
//     stretch the box; 21 bits still leave cells of ~5e-4 there, so the
//     live points keep their order (10 bits would put them all in a cell).
//   - `knn_stage`: gathers the cloud in that order as (x, y, z, sq) float4
//     with each point's original index beside it, and gives each tile of T
//     consecutive points, and each super-tile of S tiles, its box: the
//     per-axis minimum and maximum and the largest sq. A tile holding a
//     point that is not finite (or whose sq overflows) gets a NaN largest
//     sq, so no bound on it ever skips it.
//   - `knn_select<K>`: one thread a query; each warp walks the tiles for
//     its own 32 consecutive queries, on its own (WARPS warps a CTA share
//     no barrier, so a warp that finishes early does not wait, and the
//     work is cut finer than the card's resident warps). The warp visits
//     the tile holding its queries first (from its own rows on, so that
//     the lists fill with near points), then c +- 1, c +- 2, then the
//     super-tiles in order and, inside each one its box does not rule out,
//     the tiles its boxes do not rule out. A visited tile is copied into
//     the warp's shared memory by cp.async, double-buffered: the next tile
//     is chosen and its copy issued before the current tile is scanned.
//     Each thread keeps its K smallest keys sorted in registers (K a
//     template parameter, so the list is never indexed at run time); one
//     float compare against its current worst distance lets a candidate
//     through (a superset of the key test, NaN included), then its key is
//     formed and the list updated by one branch-free insertion pass.
//     Finally each row drops its self-match and is written to its original
//     row.
//
// The result does not depend on the visiting order: every key holds the
// ORIGINAL index j, the key order is total, and the list keeps the K
// smallest keys of the candidates it was offered, whatever their order.
// A tile may be left out only when no point of it could enter any list.
//
// The skip test. With u = 2^-24, S_ij = sq_i + sq_j of the computed squared
// norms, and d2 the true squared distance of the float32 points:
//   - each of sq_i, sq_j, c_ij is a chain of three once-rounded operations,
//     so |sq^ - sq| <= g3 * sq and |c^ - c| <= g3 * (|x_i x_j| + |y_i y_j| +
//     |z_i z_j|) <= g3 * (sq_i + sq_j) / 2, with g3 = 3u / (1 - 3u);
//   - the add rounds once (u * S), the doubling is exact;
// so the operand of the last subtraction lies within (2 g3 + u (1 + g3)) *
// S_true ~ 7u * S of d2, and with S_true <= S / (1 - g3) within 8u * S.
// Subnormal results add at most ~14 * 2^-150 more. Rounding is monotone, so
//
//   d2^ >= fl(L),  L = gap^2 - 8u * S - 2^-140,
//
// where gap is the distance from the query's point to the tile's box (gap
// <= |p_i - p_j| for every j in it) and S uses the tile's largest sq; and
// fl(L) >= B = L - 2u |L|. The kernel computes B in float32 with every
// step rounded toward -inf (S and 8u * S toward +inf: __fsub_rd,
// __fmul_rd, __fadd_ru, ...), so the value it compares lies at or below
// the real B, overflow included (a product rounded down stops at the
// largest float). A tile is skipped only if B > worst for every live
// query of the warp (a strict '>', so a key of equal distance and lower
// index is never lost); B is then below every d2^ the tile would give,
// and each would fail the key test. Points near (60, -40, 90) or on the far shell, whose true
// squared distances lie far below 8u * S, are never skipped on that
// ground: the bound is negative there. A NaN anywhere (a poisoned box, a
// query whose list is not full yet, whose worst is key_d2(NO_KEY) = NaN)
// makes the comparison false: visit. Overflow of s = sq_i + sq_j alone
// gives +inf or the card's canonical +NaN, whose keys sort after every
// finite one and never enter a full list.
//
// Two levels of the same test: the warp's (the box of its 32 queries, their
// largest sq, and the largest worst of its live lanes, against the
// candidate's box: the same value in every lane, so the branch is uniform)
// and, where that passes, each lane's own (its point, its sq, its worst),
// joined by __any_sync.
//
// k1 <= 32. The wrapper picks the smallest instance K >= k1 (2, 4, 8, 16,
// 21, 32); a row's k1 smallest are the first k1 of its K smallest.
//
// Measured against other forms on an H100 (PERF.md, section 6;
// scripts/torch_knn_x1_variants.py): a CTA of 128 queries sharing one
// walk (a CTA-wide vote a tile) was 1.03 ms at the refresh's input, a warp
// a group 0.82; the skip bound in float64 took the K = 21 instance from 91
// to 114 registers and 4 CTAs an SM; dropping the self-match here saves
// the plain version's sort of the rows (0.29 ms); queueing each lane's
// keys in shared memory and inserting them in step was slower (1.12 ms);
// 64-point tiles gained at 100,352 points and lost at 401,408.

#include <cuda_runtime.h>

#include "launch_count.cuh"

namespace {

constexpr int T = 128;             // points a tile
constexpr int WARPS = 4;           // warps a CTA, each with its own 32 queries
constexpr int S = 16;              // tiles a super-tile
constexpr int WINDOW = 2;          // tiles each side of the own tile, visited first
constexpr int MAX_K1 = 32;
constexpr unsigned long long NO_KEY = ~0ull;   // above every key of a real point
constexpr float CELLS = 2097151.0f;            // 2^21 - 1: the last Morton cell an axis

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

// the low 21 bits of x moved to every third bit
__device__ __forceinline__ unsigned long long spread3(unsigned long long x) {
  x &= 0x1FFFFFull;
  x = (x | x << 32) & 0x1F00000000FFFFull;
  x = (x | x << 16) & 0x1F0000FF0000FFull;
  x = (x | x << 8) & 0x100F00F00F00F00Full;
  x = (x | x << 4) & 0x10C30C30C30C30C3ull;
  x = (x | x << 2) & 0x1249249249249249ull;
  return x;
}

// a coordinate's Morton cell over [lo, hi] (ops/knn.py `morton_codes_plain`)
__device__ __forceinline__ unsigned long long morton_cell(float v, float lo, float hi) {
  const float s = __fmul_rn(__fsub_rn(v, lo), __fdiv_rn(CELLS, __fsub_rn(hi, lo)));
  return s >= 0.0f ? (unsigned long long)(s < CELLS ? s : CELLS) : 0ull;   // NaN: 0
}

__global__ void knn_codes(const float* __restrict__ pts, const float* __restrict__ lo,
                          const float* __restrict__ hi, long long* __restrict__ codes, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned long long code = 0;
#pragma unroll
  for (int d = 0; d < 3; ++d) code |= spread3(morton_cell(pts[3 * i + d], lo[d], hi[d])) << d;
  codes[i] = (long long)code;
}

// One CTA a super-tile, one warp a tile: the sorted cloud, the original
// indices, and the boxes, each as two float4 (lo.xyz; hi.xyz, hi.w the
// largest sq or NaN).
__global__ void __launch_bounds__(S * 32) knn_stage(const float* __restrict__ pts,
                                                    const long long* __restrict__ order,
                                                    float4* __restrict__ cloud,
                                                    int* __restrict__ orig,
                                                    float4* __restrict__ tiles,
                                                    float4* __restrict__ supers, int n) {
  __shared__ float4 box[S][2];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = (n + T - 1) / T;
  const int t = blockIdx.x * S + warp;
  float lx = INFINITY, ly = INFINITY, lz = INFINITY;
  float hx = -INFINITY, hy = -INFINITY, hz = -INFINITY, hw = -INFINITY;
  bool bad = false;
  for (int r = lane; r < T; r += 32) {
    const int p = t * T + r;
    if (t >= nt || p >= n) break;
    const long long o = order[p];
    const float x = pts[3 * o], y = pts[3 * o + 1], z = pts[3 * o + 2];
    const float sq = __fmaf_rn(z, z, __fmaf_rn(y, y, __fmul_rn(x, x)));
    cloud[p] = make_float4(x, y, z, sq);
    orig[p] = (int)o;
    lx = fminf(lx, x), ly = fminf(ly, y), lz = fminf(lz, z);
    hx = fmaxf(hx, x), hy = fmaxf(hy, y), hz = fmaxf(hz, z), hw = fmaxf(hw, sq);
    bad |= !(isfinite(x) && isfinite(y) && isfinite(z) && isfinite(sq));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lx = fminf(lx, __shfl_xor_sync(~0u, lx, o));
    ly = fminf(ly, __shfl_xor_sync(~0u, ly, o));
    lz = fminf(lz, __shfl_xor_sync(~0u, lz, o));
    hx = fmaxf(hx, __shfl_xor_sync(~0u, hx, o));
    hy = fmaxf(hy, __shfl_xor_sync(~0u, hy, o));
    hz = fmaxf(hz, __shfl_xor_sync(~0u, hz, o));
    hw = fmaxf(hw, __shfl_xor_sync(~0u, hw, o));
  }
  bad = __any_sync(~0u, bad);
  if (lane == 0) {
    box[warp][0] = make_float4(lx, ly, lz, 0.0f);
    box[warp][1] = make_float4(hx, hy, hz, bad ? NAN : hw);
    if (t < nt) {
      tiles[2 * t] = box[warp][0];
      tiles[2 * t + 1] = box[warp][1];
    }
  }
  __syncthreads();
  if (warp != 0) return;
  // the super-tile's box over its tiles (past nt: the empty box above)
  float4 lo = box[lane % S][0], hi = box[lane % S][1];
  bad = isnan(hi.w);
#pragma unroll
  for (int o = S / 2; o > 0; o >>= 1) {
    lo.x = fminf(lo.x, __shfl_xor_sync(~0u, lo.x, o));
    lo.y = fminf(lo.y, __shfl_xor_sync(~0u, lo.y, o));
    lo.z = fminf(lo.z, __shfl_xor_sync(~0u, lo.z, o));
    hi.x = fmaxf(hi.x, __shfl_xor_sync(~0u, hi.x, o));
    hi.y = fmaxf(hi.y, __shfl_xor_sync(~0u, hi.y, o));
    hi.z = fmaxf(hi.z, __shfl_xor_sync(~0u, hi.z, o));
    hi.w = fmaxf(hi.w, __shfl_xor_sync(~0u, hi.w, o));
  }
  bad = __any_sync(~0u, bad);
  if (lane == 0) {
    supers[2 * blockIdx.x] = lo;
    supers[2 * blockIdx.x + 1] = make_float4(hi.x, hi.y, hi.z, bad ? NAN : hi.w);
  }
}

// the pair's d2, each operation rounded once
__device__ __forceinline__ float pair_d2(float4 q, float4 p) {
  const float c = __fmaf_rn(q.z, p.z, __fmaf_rn(q.y, p.y, __fmul_rn(q.x, p.x)));
  return __fsub_rn(__fadd_rn(q.w, p.w), __fmul_rn(2.0f, c));
}

// false only if no point of box b can give any query of box a a computed
// d2 at or below `worst` (the bound derived at the top; a point is a box
// with lo = hi, its sq in .w). NaN anywhere: true.
__device__ __forceinline__ float gap_rd(float alo, float ahi, float blo, float bhi) {
  return fmaxf(0.0f, fmaxf(__fsub_rd(blo, ahi), __fsub_rd(alo, bhi)));
}

__device__ __forceinline__ bool may_hold(float4 alo, float4 ahi, float4 blo, float4 bhi,
                                         float worst) {
  const float gx = gap_rd(alo.x, ahi.x, blo.x, bhi.x);
  const float gy = gap_rd(alo.y, ahi.y, blo.y, bhi.y);
  const float gz = gap_rd(alo.z, ahi.z, blo.z, bhi.z);
  const float gap2 = __fmaf_rd(gz, gz, __fmaf_rd(gy, gy, __fmul_rd(gx, gx)));
  const float e = __fmul_ru(__fadd_ru(ahi.w, bhi.w), 0x1p-21f);      // 8u * S
  const float l = __fsub_rd(__fsub_rd(gap2, e), 0x1p-140f);
  return !(__fmaf_rd(-0x1p-23f, fabsf(l), l) > worst);                 // l - 2u |l|
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

// tile `t` of the sorted cloud and its original indices into this warp's
// shared memory, as one cp.async group (cloud and orig are padded to whole
// tiles)
__device__ __forceinline__ void stage(float4* pts_s, int* idx_s, const float4* cloud,
                                      const int* orig, int t, int lane) {
#pragma unroll
  for (int r = lane; r < T; r += 32) cp_async16(pts_s + r, cloud + (size_t)t * T + r);
  for (int r = lane; r < T / 4; r += 32) cp_async16(idx_s + 4 * r, orig + (size_t)t * T + 4 * r);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

template <int K>
__global__ void __launch_bounds__(WARPS * 32) knn_select(const float4* __restrict__ cloud,
                                                         const int* __restrict__ orig,
                                                         const float4* __restrict__ tiles,
                                                         const float4* __restrict__ supers,
                                                         float* __restrict__ d2_out,
                                                         long long* __restrict__ idx_out,
                                                         int* __restrict__ visits, int n,
                                                         int k1) {
  count_launch(SLOT_KNN);
  __shared__ __align__(16) float4 pts_all[WARPS][2][T];
  __shared__ __align__(16) int idx_all[WARPS][2][T];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x * WARPS + warp;   // the warp's group: sorted rows 32 g ...
  if (g * 32 >= n) return;                   // the whole warp: no CTA barrier follows
  const int nt = (n + T - 1) / T, ns = (nt + S - 1) / S;
  const int row = g * 32 + lane;
  const bool live = row < n;
  // rows past n query the group's first point, write nothing and vote for nothing
  const float4 q = cloud[live ? row : g * 32];
  // the group's box and largest sq (NaN if a query is not finite)
  const bool bad = __any_sync(~0u, !(isfinite(q.x) && isfinite(q.y) && isfinite(q.z) &&
                                     isfinite(q.w)));
  const float4 glo = make_float4(warp_min(q.x), warp_min(q.y), warp_min(q.z), 0.0f);
  const float4 ghi = make_float4(warp_max(q.x), warp_max(q.y), warp_max(q.z),
                                 bad ? NAN : warp_max(q.w));
  float4 (*pts_s)[T] = pts_all[warp];
  int (*idx_s)[T] = idx_all[warp];
  unsigned long long best[K];
#pragma unroll
  for (int s = 0; s < K; ++s) best[s] = NO_KEY;
  float worst = key_d2(NO_KEY);
  float wmax = INFINITY;   // the largest worst of the group's live queries (+inf: a list not full)

  // offer this lane's list a candidate: the float test lets through a
  // superset of the key test (NaN included), then one branch-free insertion
  // pass from the end moves the entries above the key up (one compare an
  // entry: `below` carries key < best[s] from the step before)
  auto offer = [&](float d2, unsigned j) {
    if (!(d2 > worst)) {
      const unsigned long long key = order_key(d2, j);
      bool below = key < best[K - 1];
      if (below) {
#pragma unroll
        for (int s = K - 1; s > 0; --s) {
          const bool above = key < best[s - 1];
          best[s] = above ? best[s - 1] : (below ? key : best[s]);
          below = above;
        }
        best[0] = below ? key : best[0];
        worst = key_d2(best[K - 1]);
      }
    }
  };

  // may a point of tile t enter a list? (the same answer in every lane)
  auto tile_may_hold = [&](int t) -> bool {
    const float4 lo = __ldg(tiles + 2 * t), hi = __ldg(tiles + 2 * t + 1);
    if (!may_hold(glo, ghi, lo, hi, wmax)) return false;
    return __any_sync(~0u, live && may_hold(q, q, lo, hi, worst));
  };

  const int c = g * 32 / T;   // the tile holding the group
  int cur = c, buf = 0;
  int win = 1;            // the next of the window's tiles c+1, c-1, c+2, c-2
  int sup = 0, t = -1;    // the super-tile being walked, and its next tile (-1: not entered)
  int seen_tiles = 0, seen_points = 0;
  stage(pts_s[0], idx_s[0], cloud, orig, cur, lane);
  while (true) {
    // the next tile to visit, chosen with the lists as they stand
    int nxt = -1;
    while (nxt < 0 && win <= 2 * WINDOW) {
      const int tt = c + ((win & 1) ? (win + 1) / 2 : -(win / 2));
      ++win;
      if (tt >= 0 && tt < nt && tile_may_hold(tt)) nxt = tt;
    }
    while (nxt < 0 && sup < ns) {
      const int end = min(nt, (sup + 1) * S);
      if (t < 0)
        t = may_hold(glo, ghi, __ldg(supers + 2 * sup), __ldg(supers + 2 * sup + 1), wmax)
                ? sup * S : end;
      if (t < end) {
        const int tt = t++;
        if (abs(tt - c) > WINDOW && tile_may_hold(tt)) nxt = tt;
      }
      if (t >= end) ++sup, t = -1;
    }
    if (nxt >= 0) {
      stage(pts_s[buf ^ 1], idx_s[buf ^ 1], cloud, orig, nxt, lane);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncwarp();

    const int m = min(T, n - cur * T);
    const float4* pts = pts_s[buf];
    const int* idx = idx_s[buf];
    // the own tile from the warp's own rows on, so that the lists first
    // fill with near points
    const int from = cur == c ? g * 32 % T : 0;
#pragma unroll 4
    for (int j = from; j < m; ++j) offer(pair_d2(q, pts[j]), (unsigned)idx[j]);
#pragma unroll 4
    for (int j = 0; j < from; ++j) offer(pair_d2(q, pts[j]), (unsigned)idx[j]);
    ++seen_tiles, seen_points += m;
    // the group's largest worst; every lane is done with this buffer
    wmax = warp_max(live ? (isnan(worst) ? INFINITY : worst) : -INFINITY);
    __syncwarp();
    if (nxt < 0) break;
    cur = nxt, buf ^= 1;
  }

  if (visits != nullptr && lane == 0) {
    visits[2 * g] = seen_tiles;
    visits[2 * g + 1] = seen_points;
  }
  if (!live) return;
  // the query's own row, without the self-match
  const unsigned self = (unsigned)orig[row];
  float* d2_row = d2_out + (size_t)self * (k1 - 1);
  long long* idx_row = idx_out + (size_t)self * (k1 - 1);
  int w = 0;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const unsigned j = (unsigned)best[s];
    if (s < k1 && j != self && w < k1 - 1) {
      d2_row[w] = key_d2(best[s]);
      idx_row[w] = (long long)j;
      ++w;
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

// pts [n, 3] float32, lo and hi [3] float32 (the cloud's box) -> codes [n]
// int64, the points' Morton codes.
extern "C" int ed3dgs_knn_codes(const float* pts, const float* lo, const float* hi,
                                long long* codes, int n, void* stream) {
  knn_codes<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(pts, lo, hi, codes,
                                                                            n);
  return (int)cudaGetLastError();
}

// pts [n, 3] float32 and order [n] int64 (the points by Morton code) -> d2
// [n, k1 - 1] float32, idx [n, k1 - 1] int64: each row's k1 - 1 nearest
// other points, in the original rows. Scratch:
// cloud [nt * T] float4, orig [nt * T] int32, tiles [2 nt] float4, supers
// [2 ns] float4 (nt = ceil(n / T), ns = ceil(nt / S); `ed3dgs_knn_layout`
// gives T and S). visits: null, or
// [ceil(n / 32), 2] int32 that gets each warp's tiles and points scanned.
// n >= k1.
extern "C" int ed3dgs_knn(const float* pts, const long long* order, void* cloud, void* orig,
                          void* tiles, void* supers, float* d2, long long* idx, int* visits,
                          int n, int k1, void* stream) {
  const void* fn = instance(k1);
  if (fn == nullptr || n < k1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nt = (n + T - 1) / T, ns = (nt + S - 1) / S;
  float4* c = static_cast<float4*>(cloud);
  int* o = static_cast<int*>(orig);
  float4* tb = static_cast<float4*>(tiles);
  float4* sb = static_cast<float4*>(supers);
  knn_stage<<<ns, S * 32, 0, st>>>(pts, order, c, o, tb, sb, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&c, &o, &tb, &sb, &d2, &idx, &visits, &n, &k1};
  const int groups = (n + 31) / 32;
  return (int)cudaLaunchKernel(fn, dim3((groups + WARPS - 1) / WARPS), dim3(WARPS * 32), args,
                               0, st);
}

// The tile layout the wrapper sizes its scratch by: points a tile (T),
// tiles a super-tile (S) and queries a warp walks the tiles for.
extern "C" int ed3dgs_knn_layout(int* tile, int* super, int* group) {
  *tile = T;
  *super = S;
  *group = 32;
  return 0;
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
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, fn, WARPS * 32, 0);
}
