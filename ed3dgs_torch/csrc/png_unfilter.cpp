// Host helper of ed3dgs_torch/data/image_io.py: undo the five PNG row
// filters (PNG specification, section 9) of an inflated 8-bit image.
//
// The Average and Paeth filters predict each byte from the decoded byte to
// its left, so a row cannot be undone by whole-row array operations; a
// Python loop over the bytes would outlast a training step.
// No dependencies; built with g++ at first use (ops/cuda_lib.py) and called
// through ctypes, which releases the GIL for the call, so the decode threads
// of data/native_staging.py run it side by side.

#include <cstdint>
#include <cstdlib>

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
