// Shared pieces of the tile blend kernels K1 (rasterize_forward.cu) and K2
// (rasterize_backward.cu): constants, the staging of a chunk of pair rows,
// the conservative screen box that lets a warp skip rows, the warp's walk
// over a chunk, and the splat arithmetic both kernels must agree on bit for
// bit (a pair gets a gradient row in K2 exactly where K1 blended it).
//
// Both files are built with -fmad=false (ops/cuda_lib.py), so every a*b+c
// here is two rounded operations, as in the plain PyTorch versions; both
// kernels ask for fused multiply-adds explicitly with fmaf() where no mask
// depends on the result.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace blend {

constexpr int PIX = 256;            // pixels of a 16x16 tile, one thread each
constexpr int WARPS = PIX / 32;
constexpr int F = 26;               // payload row width (ops/binning.py)
constexpr int OUT_PAD = 24;
constexpr int GROUP = 32;           // rows per ballot (one bit per row)
constexpr unsigned FULL = 0xffffffffu;

// payload columns
constexpr int MX = 0, MY = 1, C0 = 2, C1 = 3, C2 = 4, OPC = 5, RGB = 6, TONGUE = 9,
              VP = 10, CP = 13, RP = 19, TS = 21, NRM = 22, ONES = 25;
// output channels (ops/rasterize_cuda.py OUT_CHANNELS)
constexpr int O_COLOR = 0, O_WEIGHT = 3, O_TFINAL = 4, O_COORD = 5, O_MCOORD = 8,
              O_DEPTH = 11, O_MDEPTH = 12, O_TONGUE = 13, O_NORMAL = 14, O_NLEN = 17;

constexpr float NEG_HALF_LOG2E = -0.7213475204444817f;  // -0.5 * log2(e)
constexpr float NEG_LOG2E = -1.4426950408889634f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_STOP = 1e-4f;
constexpr float MEDIAN_T = 0.5f;
constexpr float NORMALIZE_EPS = 1e-12f;

// A staged row: 36 floats, 16-byte aligned, conflict-free for the 16-byte
// stores that fill it. Columns 0..25 are the payload's, except 2..4, which
// hold the conic already scaled by -0.5*log2(e), -log2(e), -0.5*log2(e)
// (the same rounded products K1 formed per pixel); 26..35 hold the row's
// cull data (struct Cull): -c1/c2, -c1/c0, the raw conic c0, c1, c2, the
// raised pass radius r2, and the screen box as ints {x0, x1, y0, y1}.
constexpr int ROW = 36;
constexpr int ELL = 26;
constexpr int BOX = 32;

// ---- culling (ops/rasterize_cuda.py cull_box_plain / meets_block_plain) ----
//
// A splat passes at a pixel only where power2 <= 0 and opacity*exp2(power2)
// >= 1/255, i.e. inside the ellipse q(d) = c0 dx^2 + 2 c1 dx dy + c2 dy^2
// <= 2 ln(opacity * 255). The cull data hold that ellipse with the bound
// raised to r2 = (2 ln(opacity * 255) + 1e-3) * 1.01, and its screen box
// with one pixel of margin on every side. The float power2 errs by at most
// ~4e-7 * (c0 dx^2 + 2|c1 dx dy| + c2 dy^2), which is at most ~4e-7 *
// (1+rho)/(1-rho) * q with rho = |c1|/sqrt(c0 c2); the ellipse is used only
// where det = c0 c2 - c1^2 > 1e-3 c0 c2 (rho < 0.9995, so that error is
// below 0.2% of q), and exp2f's error moves the bound by less than 1e-6.
// Elsewhere (a conic that is not positive definite or nearly degenerate,
// anything not finite) the box is the whole plane and the ellipse test
// always meets; where the opacity is below 1/255 the box is empty: alpha <=
// opacity passes nowhere.
constexpr int BOX_FAR = 1 << 30;

struct Cull {
  float kc, ka;        // -c1/c2, -c1/c0: where q is least along a column, a row
  float a, b, c, r2;   // the raw conic and the raised bound
  int4 box;            // {x0, x1, y0, y1}, inclusive pixel bounds
};

__device__ __forceinline__ Cull splat_cull(const float* r) {
  const float mx = r[MX], my = r[MY], a = r[C0], b = r[C1], c = r[C2], opc = r[OPC];
  Cull k = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 1.0f,
            make_int4(-BOX_FAR, BOX_FAR, -BOX_FAR, BOX_FAR)};
  if (opc < ALPHA_MIN) {
    k.box = make_int4(BOX_FAR, -BOX_FAR, BOX_FAR, -BOX_FAR);
    return k;
  }
  const float ac = a * c;
  const float det = ac - b * b;
  if (!(isfinite(mx) && isfinite(my) && isfinite(opc) && a > 0.0f && c > 0.0f &&
        isfinite(ac) && det > 1e-3f * ac))
    return k;
  const float r2 = (2.0f * logf(opc / ALPHA_MIN) + 1e-3f) * 1.01f;
  const float ex = sqrtf(r2 * c / det) + 1.0f;
  const float ey = sqrtf(r2 * a / det) + 1.0f;
  const float lim = (float)BOX_FAR;
  k.kc = -b / c;
  k.ka = -b / a;
  k.a = a, k.b = b, k.c = c, k.r2 = r2;
  k.box = make_int4((int)floorf(fmaxf(mx - ex, -lim)), (int)ceilf(fminf(mx + ex, lim)),
                    (int)floorf(fmaxf(my - ey, -lim)), (int)ceilf(fminf(my + ey, lim)));
  return k;
}

// Whether a staged row can pass at any pixel of the 8x4 block whose
// top-left pixel is (bx0, by0): its box meets the block, and the least q
// over the block grown by one pixel on every side is within r2. q is convex
// with its least value at the splat's centre, so off the rectangle's
// inside that least value lies on an edge, at the clamped minimiser of the
// edge's quadratic.
__device__ __forceinline__ bool meets_block(const float* row, int bx0, int by0) {
  const int4 bx = *reinterpret_cast<const int4*>(row + BOX);
  if (!(bx.y >= bx0 && bx.x <= bx0 + 7 && bx.w >= by0 && bx.z <= by0 + 3)) return false;
  const float2 m = *reinterpret_cast<const float2*>(row);
  const float2 k = *reinterpret_cast<const float2*>(row + ELL);
  const float4 e = *reinterpret_cast<const float4*>(row + ELL + 2);
  const float u0 = (float)(bx0 - 1) - m.x, u1 = (float)(bx0 + 8) - m.x;
  const float v0 = (float)(by0 - 1) - m.y, v1 = (float)(by0 + 4) - m.y;
  if (u0 <= 0.0f && u1 >= 0.0f && v0 <= 0.0f && v1 >= 0.0f) return true;
  const float b2 = 2.0f * e.y;
  auto q = [&](float u, float v) { return u * (e.x * u + b2 * v) + e.z * v * v; };
  float qmin = q(u0, fminf(fmaxf(k.x * u0, v0), v1));
  qmin = fminf(qmin, q(u1, fminf(fmaxf(k.x * u1, v0), v1)));
  qmin = fminf(qmin, q(fminf(fmaxf(k.y * v0, u0), u1), v0));
  qmin = fminf(qmin, q(fminf(fmaxf(k.y * v1, u0), u1), v1));
  return qmin <= e.w;
}

// columns 6..25 of a staged row, in 16- and 8-byte loads
struct Cols {
  float rgb[3], tng, vp[3], cp[6], rp[2], ts, nrm[3], ones;
};

__device__ __forceinline__ Cols load_cols(const float* r) {
  const float2 a = *reinterpret_cast<const float2*>(r + 6);
  const float4 b = *reinterpret_cast<const float4*>(r + 8);
  const float4 c = *reinterpret_cast<const float4*>(r + 12);
  const float4 d = *reinterpret_cast<const float4*>(r + 16);
  const float4 e = *reinterpret_cast<const float4*>(r + 20);
  const float2 f = *reinterpret_cast<const float2*>(r + 24);
  Cols o;
  o.rgb[0] = a.x, o.rgb[1] = a.y, o.rgb[2] = b.x, o.tng = b.y;
  o.vp[0] = b.z, o.vp[1] = b.w, o.vp[2] = c.x;
  o.cp[0] = c.y, o.cp[1] = c.z, o.cp[2] = c.w, o.cp[3] = d.x, o.cp[4] = d.y, o.cp[5] = d.z;
  o.rp[0] = d.w, o.rp[1] = e.x, o.ts = e.y;
  o.nrm[0] = e.z, o.nrm[1] = e.w, o.nrm[2] = f.x, o.ones = f.y;
  return o;
}

// ---- a warp's pixel block -------------------------------------------------
// Warp w covers the 8x4 block (w & 1, w >> 1) of the tile, lane l the pixel
// (l & 7, l >> 3) of it; `p` is the pixel's index in the tile's 256.
struct Pixel {
  float px, py;
  int p;
  int bx0, by0;  // the warp block's top-left pixel (its box is bx0..bx0+7, by0..by0+3)
};

__device__ __forceinline__ Pixel pixel_of(int tile_x, int tile_y, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int x = (warp & 1) * 8 + (lane & 7), y = (warp >> 1) * 4 + (lane >> 3);
  Pixel q;
  q.px = (float)(tile_x * 16 + x);
  q.py = (float)(tile_y * 16 + y);
  q.p = y * 16 + x;
  q.bx0 = tile_x * 16 + (warp & 1) * 8;
  q.by0 = tile_y * 16 + (warp >> 1) * 4;
  return q;
}

// ---- K1's per-pixel splat arithmetic, operation for operation --------------
struct Splat {
  float dx, dy, e2, alpha_raw, alpha;
  bool passes;
};

__device__ __forceinline__ Splat splat_at(const float* r, float px, float py) {
  const float4 h = *reinterpret_cast<const float4*>(r);        // mx, my, c0e, c1e
  const float2 t = *reinterpret_cast<const float2*>(r + 4);    // c2e, opacity
  Splat s;
  s.dx = h.x - px;
  s.dy = h.y - py;
  const float power2 = s.dx * (h.z * s.dx + h.w * s.dy) + t.x * s.dy * s.dy;
  s.e2 = exp2f(power2);
  s.alpha_raw = t.y * s.e2;
  s.alpha = fminf(ALPHA_MAX, s.alpha_raw);
  s.passes = power2 <= 0.0f && s.alpha >= ALPHA_MIN;
  return s;
}

// ---- staging: one raw copy in flight, one converted chunk in use ----------
// The chunk's n rows are n*104 contiguous bytes on an 8-byte boundary; the
// 16-byte-aligned superset is copied with cp.async (the extra bytes at
// either end lie in the same 16-byte granules as the rows, so inside the
// allocation) and the rows are read back from `off` floats into it.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// floats of the raw buffer for `chunk` rows
__host__ __device__ constexpr int raw_floats(int chunk) { return (chunk * F + 3 + 3) / 4 * 4; }

// dynamic shared memory of the staging: raw copy + converted rows
__host__ __device__ constexpr size_t stage_bytes(int chunk) {
  return ((size_t)raw_floats(chunk) + (size_t)chunk * ROW) * sizeof(float);
}

struct Stage {
  float* raw;   // [raw_floats(chunk)]
  float* rows;  // [chunk][ROW]
  int off;      // the in-flight copy's first row, in floats into `raw`
};

// Start copying rows [first, first + n) of the payload into st.raw.
__device__ __forceinline__ void stage_issue(Stage& st, const float* payload, long first, int n,
                                            int tid) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(payload + first * F);
  const float* base = reinterpret_cast<const float*>(a & ~uintptr_t(15));
  st.off = (int)((a & 15) >> 2);
  const int nseg = (st.off + n * F + 3) >> 2;
  for (int i = tid; i < nseg; i += PIX) cp_async16(st.raw + 4 * i, base + 4 * i);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for the copy, then convert its n rows into st.rows (scaled conic,
// cull data). On return every thread sees the converted chunk and st.raw is free.
__device__ __forceinline__ void stage_finish(const Stage& st, int n, int tid) {
  cp_async_wait_all();
  __syncthreads();  // the copy has landed for all threads; st.rows is no longer read
  for (int j = tid; j < n; j += PIX) {
    const float* r = st.raw + st.off + j * F;
    float v[ROW];
#pragma unroll
    for (int k = 0; k < F; ++k) v[k] = r[k];
    v[C0] = r[C0] * NEG_HALF_LOG2E;
    v[C1] = r[C1] * NEG_LOG2E;
    v[C2] = r[C2] * NEG_HALF_LOG2E;
    const Cull k = splat_cull(r);
    v[ELL] = k.kc;
    v[ELL + 1] = k.ka;
    v[ELL + 2] = k.a;
    v[ELL + 3] = k.b;
    v[ELL + 4] = k.c;
    v[ELL + 5] = k.r2;
    v[BOX] = __int_as_float(k.box.x);
    v[BOX + 1] = __int_as_float(k.box.y);
    v[BOX + 2] = __int_as_float(k.box.z);
    v[BOX + 3] = __int_as_float(k.box.w);
    float4* d = reinterpret_cast<float4*>(st.rows + j * ROW);
#pragma unroll
    for (int k = 0; k < ROW / 4; ++k)
      d[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  }
  __syncthreads();
}

// ---- a warp's walk over a staged chunk -----------------------------------
// Calls body(j) for the rows j of group g (rows GROUP*g .. GROUP*g+31 of the
// n staged rows), in order, that meet this warp's pixel block (meets_block:
// each lane tests one row), and stops once no lane's in-chunk product P is
// >= T_STOP (no later row of the chunk can then be included at any of its
// pixels; a row that misses the block fails the pass test at all of them,
// and a failed pass changes nothing). Returns false once the warp is done
// with the chunk.
template <class Body>
__device__ __forceinline__ bool walk_group(const float* rows, int g, int n, const Pixel& q,
                                           const float& P, Body&& body) {
  const int lane = threadIdx.x & 31;
  const int row = g * GROUP + lane;
  const bool hit = row < n && meets_block(rows + row * ROW, q.bx0, q.by0);
  unsigned m = __ballot_sync(FULL, hit);
  while (m) {
    const int j = g * GROUP + __ffs(m) - 1;
    m &= m - 1;
    body(j);
    if (__all_sync(FULL, !(P >= T_STOP))) return false;
  }
  return true;
}

__host__ __device__ constexpr int groups_of(int n) { return (n + GROUP - 1) / GROUP; }

// ---- host: a kernel's dynamic shared-memory limit -------------------------
constexpr int MAX_DEVICES = 64;

// Raise `kernel`'s dynamic shared-memory limit on the current device to
// `smem` bytes, unless `limit` (the bytes already allowed, one slot per
// device) shows that it is that high already: cudaFuncSetAttribute runs
// once per device and size, not at every launch.
inline cudaError_t allow_smem(const void* kernel, int smem, int (&limit)[MAX_DEVICES]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && limit[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && dev < MAX_DEVICES) limit[dev] = smem;
  return err;
}

}  // namespace blend
