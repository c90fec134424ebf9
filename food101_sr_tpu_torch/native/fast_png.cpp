// PNG row filtering for the port's PNG codec, without libpng or zlib.
//
// The port's PNG encode and decode do the container and the deflate
// stream in Python (struct and the stdlib zlib module, which every
// CPython carries), so a host without libpng or zlib headers still reads
// and writes PNG. What Python cannot do quickly is the per-byte row
// filtering: the encoder's fixed SUB filter (the JAX package's fast_png
// choice: one filter, no per-row search), and on decode the four filter
// types of the PNG specification, two of which (Average, Paeth) depend on
// the byte just reconstructed and so cannot be vectorized along a row.
//
// Build: g++ -O3 -shared -fPIC fast_png.cpp -o libfast_png.so (no library;
// native/__init__.py builds it on first use into the package's _build/).
// ctypes releases the GIL for each call.

#include <cstdlib>
#include <cstring>

extern "C" {

// SUB-filter `rows` rows of `stride` bytes (bytes per pixel `bpp`) into
// `out`, which must hold rows * (stride + 1) bytes: each output row is the
// filter-type byte 1 followed by x[i] - x[i - bpp] (mod 256), with the
// bytes left of the row taken as 0.
void f101png_filter_sub(const unsigned char* in, long rows, long stride,
                        int bpp, unsigned char* out) {
  for (long y = 0; y < rows; ++y) {
    const unsigned char* src = in + y * stride;
    unsigned char* dst = out + y * (stride + 1);
    dst[0] = 1;
    ++dst;
    const long lead = bpp < stride ? bpp : stride;
    std::memcpy(dst, src, static_cast<size_t>(lead));
    for (long i = lead; i < stride; ++i) {
      dst[i] = static_cast<unsigned char>(src[i] - src[i - bpp]);
    }
  }
}

// Undo the row filters of `rows` filtered rows (`stride` + 1 bytes each:
// the filter type, then the row) into `out` (rows * stride bytes). `bpp`
// is the bytes per complete pixel, at least 1. Returns 0, or -(y + 1) for
// a row y whose filter type is not 0-4.
int f101png_unfilter(const unsigned char* in, long rows, long stride,
                     int bpp, unsigned char* out) {
  for (long y = 0; y < rows; ++y) {
    const unsigned char type = in[y * (stride + 1)];
    const unsigned char* src = in + y * (stride + 1) + 1;
    unsigned char* cur = out + y * stride;
    const unsigned char* up = y > 0 ? out + (y - 1) * stride : nullptr;
    switch (type) {
      case 0:  // None
        std::memcpy(cur, src, static_cast<size_t>(stride));
        break;
      case 1:  // Sub
        for (long i = 0; i < stride; ++i) {
          const unsigned a = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = static_cast<unsigned char>(src[i] + a);
        }
        break;
      case 2:  // Up
        for (long i = 0; i < stride; ++i) {
          const unsigned b = up ? up[i] : 0;
          cur[i] = static_cast<unsigned char>(src[i] + b);
        }
        break;
      case 3:  // Average
        for (long i = 0; i < stride; ++i) {
          const unsigned a = i >= bpp ? cur[i - bpp] : 0;
          const unsigned b = up ? up[i] : 0;
          cur[i] = static_cast<unsigned char>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:  // Paeth
        for (long i = 0; i < stride; ++i) {
          const int a = i >= bpp ? cur[i - bpp] : 0;
          const int b = up ? up[i] : 0;
          const int c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c;
          const int pa = std::abs(p - a);
          const int pb = std::abs(p - b);
          const int pc = std::abs(p - c);
          const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = static_cast<unsigned char>(src[i] + pred);
        }
        break;
      default:
        return static_cast<int>(-(y + 1));
    }
  }
  return 0;
}

}  // extern "C"
