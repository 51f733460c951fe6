// PNG scanline defilter (PNG spec, section 9: filter method 0).
//
// Host C++ for tensoflow_tpu_torch/data/image_io.py: undoes the five
// per-row filters (None, Sub, Up, Average, Paeth) of a decompressed IDAT
// stream.  Average and Paeth depend on the byte one pixel to the left in
// the same row, which numpy cannot vectorise; this loop is the reader's
// hot path.  Built with g++ into build/kernels/ at first use and bound
// with ctypes; the plain numpy version beside it in image_io.py is its
// reference.
#include <cstdint>
#include <cstdlib>

extern "C" {

// raw: h rows of (1 + stride) bytes, the filter type first.
// out: h rows of stride bytes.  bpp: bytes per complete pixel (>= 1).
// Returns 0, or 1 + the row index of the first row whose filter type is
// not 0-4.
int64_t png_unfilter(const uint8_t* raw, int64_t h, int64_t stride,
                     int64_t bpp, uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = raw + y * (stride + 1);
    const uint8_t ft = src[0];
    ++src;
    uint8_t* cur = out + y * stride;
    const uint8_t* prior = y > 0 ? out + (y - 1) * stride : nullptr;
    switch (ft) {
      case 0:
        for (int64_t i = 0; i < stride; ++i) cur[i] = src[i];
        break;
      case 1:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < stride; ++i)
          cur[i] = static_cast<uint8_t>(src[i] + (prior ? prior[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          cur[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = prior ? prior[i] : 0;
          const int c = (prior && i >= bpp) ? prior[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = static_cast<uint8_t>(src[i] + pred);
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}

}  // extern "C"
