// Host helpers of ed3dgs_torch/data/image_io.py: undo the five PNG row
// filters (PNG specification, section 9) of an inflated 8-bit image, and
// one fixed-point pass of PIL's resampling (the Lanczos and bilinear
// resizes of the loaders).
//
// The Average and Paeth filters predict each byte from the decoded byte to
// its left, so a row cannot be undone by whole-row array operations; a
// Python loop over the bytes would outlast a training step. The resampling
// pass in numpy gathers every tap of every output pixel at once (13 taps a
// pixel for 2704 -> 1600 columns: a gigabyte of int64 for a DyNeRF frame)
// and takes seconds a frame.
// No dependencies; built with g++ at first use (ops/cuda_lib.py) and called
// through ctypes, which releases the GIL for the call, so the decode threads
// of data/native_staging.py run it side by side.

#include <cstdint>
#include <cstdlib>
#include <vector>

extern "C" int ed3dgs_png_unfilter(const uint8_t* in, uint8_t* out, int height, int row_bytes,
                                   int bpp) {
  // in: height rows of 1 filter byte + row_bytes bytes; out: height x row_bytes
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = in + (long)y * (row_bytes + 1);
    const int filter = src[0];
    ++src;
    uint8_t* dst = out + (long)y * row_bytes;
    switch (filter) {
      case 0:
        for (int i = 0; i < row_bytes; ++i) dst[i] = src[i];
        break;
      case 1:  // Sub
        for (int i = 0; i < row_bytes; ++i)
          dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:  // Up
        for (int i = 0; i < row_bytes; ++i) dst[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:  // Average
        for (int i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (int i = 0; i < row_bytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          dst[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        return y + 1;  // the first row with an unknown filter type, 1-based
    }
    prev = dst;
  }
  return 0;
}

// One output row of a resampling pass with C interleaved channels a tap
// (C a compile-time constant, so the accumulators stay in registers).
template <int C>
static void resample_row(const uint8_t* src, uint8_t* dst, int in_size, int out_size,
                         const int64_t* xmin, const int64_t* coef, int ksize, int bits) {
  const int64_t half = (int64_t)1 << (bits - 1);
  for (int x = 0; x < out_size; ++x) {
    int64_t acc[C];
    for (int i = 0; i < C; ++i) acc[i] = half;
    const int64_t* w = coef + (int64_t)x * ksize;
    for (int k = 0; k < ksize; ++k) {
      if (w[k] == 0) continue;
      int64_t tap = xmin[x] + k;
      tap = tap < 0 ? 0 : (tap > in_size - 1 ? in_size - 1 : tap);
      const uint8_t* s = src + tap * C;
      for (int i = 0; i < C; ++i) acc[i] += (int64_t)s[i] * w[k];
    }
    for (int i = 0; i < C; ++i) {
      const int64_t v = acc[i] >> bits;  // arithmetic shift, as numpy's
      dst[(int64_t)x * C + i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

extern "C" int ed3dgs_resample_axis(const uint8_t* in, uint8_t* out, int outer, int in_size,
                                    int inner, int out_size, const int64_t* xmin,
                                    const int64_t* coef, int ksize, int bits) {
  // in: [outer, in_size, inner], out: [outer, out_size, inner], both uint8;
  // out[o, x, i] = clip((2^(bits-1) + sum_k in[o, min(xmin[x] + k, in_size - 1), i]
  //                      * coef[x, k]) >> bits, 0, 255), the sum exact in int64
  // (image_io._resample_axis_plain, in the same integers). A pass along the
  // columns (inner = the channels) walks a row at a time; a pass along the
  // rows (inner = a whole row) sums whole input rows, which vectorises.
  for (int o = 0; o < outer; ++o) {
    const uint8_t* src = in + (int64_t)o * in_size * inner;
    uint8_t* dst = out + (int64_t)o * out_size * inner;
    switch (inner) {
      case 1: resample_row<1>(src, dst, in_size, out_size, xmin, coef, ksize, bits); continue;
      case 2: resample_row<2>(src, dst, in_size, out_size, xmin, coef, ksize, bits); continue;
      case 3: resample_row<3>(src, dst, in_size, out_size, xmin, coef, ksize, bits); continue;
      case 4: resample_row<4>(src, dst, in_size, out_size, xmin, coef, ksize, bits); continue;
      default: break;
    }
    const int64_t half = (int64_t)1 << (bits - 1);
    std::vector<int64_t> acc(inner);
    for (int x = 0; x < out_size; ++x) {
      for (int i = 0; i < inner; ++i) acc[i] = half;
      const int64_t* w = coef + (int64_t)x * ksize;
      for (int k = 0; k < ksize; ++k) {
        if (w[k] == 0) continue;
        int64_t tap = xmin[x] + k;
        tap = tap < 0 ? 0 : (tap > in_size - 1 ? in_size - 1 : tap);
        const uint8_t* s = src + tap * inner;
        const int64_t wk = w[k];
        for (int i = 0; i < inner; ++i) acc[i] += (int64_t)s[i] * wk;
      }
      uint8_t* d = dst + (int64_t)x * inner;
      for (int i = 0; i < inner; ++i) {
        const int64_t v = acc[i] >> bits;
        d[i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
      }
    }
  }
  return 0;
}
