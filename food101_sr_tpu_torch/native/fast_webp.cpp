// WebP decoding for the port's request decoder, without a library: the
// pixels PIL's Image.open(...).convert("RGB") gives for a WebP upload,
// which is how the JAX package's server reads one. PIL opens every WebP
// through libwebp 1.6's animation decoder; this unit is that decoder's
// pixel work written out, and the container is parsed in Python
// (native/__init__.py), as for GIF and BMP:
//   - VP8 (lossy) key frames per RFC 6386 to Y/U/V planes, bit-equal to
//     libwebp's: the boolean decoder with its 56-bit window (where a
//     partition ends decides which streams fail), 1 to 8 token partitions,
//     segments, coefficient probability updates, dequantization with
//     libwebp's clamps, the WHT and the inverse DCT (the full one as its
//     SSE2 code computes it, in 16-bit lanes), the 16x16, 4x4 and chroma
//     predictions with libwebp's borders, and the simple or normal loop
//     filter over the frame in macroblock order.
//   - Y/U/V to RGB as libwebp's RGB output does it: the "fancy" upsampler
//     ((9,3,3,1)/16 over pairs of rows) and its 14-bit converters.
//   - VP8L (lossless) to ARGB: prefix codes (simple, normal, meta codes),
//     the color cache, LZ77 with the 120-entry distance map, and the
//     predictor, cross-color, subtract-green and color-indexing transforms
//     undone in reverse order; end-of-stream as libwebp flags it.
//   - ALPH: raw or VP8L-coded, then its prediction filter undone. Alpha
//     never reaches RGB, but libwebp fails the whole decode on a broken one.
//
// The probability, quantizer, mode-probability and distance tables are
// RFC 6386's and the WebP lossless format's.
//
// Build: g++ -O3 -shared -fPIC fast_webp.cpp -o libfast_webp.so (no
// library; native/__init__.py builds it on first use into _build/). ctypes
// releases the GIL for each call.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const uint16_t kAcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
  16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
  28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
  40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
  52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68,
  70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92,
  94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
  119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
  155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
  197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
  249, 254, 259, 264, 269, 274, 279, 284
};
const uint8_t kDcTable[128] = {
  4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
  18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
  29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
  44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
  59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
  75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
  91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
  122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157
};
const uint8_t kCoeffsUpdateProba[1056] = {
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
  250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
  234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
  234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
  251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
  255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
  255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
  255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
  248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
  250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
  255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255
};
const uint8_t kBModesProba[900] = {
  231, 120, 48, 89, 115, 113, 120, 152, 112,
  152, 179, 64, 126, 170, 118, 46, 70, 95,
  175, 69, 143, 80, 85, 82, 72, 155, 103,
  56, 58, 10, 171, 218, 189, 17, 13, 152,
  114, 26, 17, 163, 44, 195, 21, 10, 173,
  121, 24, 80, 195, 26, 62, 44, 64, 85,
  144, 71, 10, 38, 171, 213, 144, 34, 26,
  170, 46, 55, 19, 136, 160, 33, 206, 71,
  63, 20, 8, 114, 114, 208, 12, 9, 226,
  81, 40, 11, 96, 182, 84, 29, 16, 36,
  134, 183, 89, 137, 98, 101, 106, 165, 148,
  72, 187, 100, 130, 157, 111, 32, 75, 80,
  66, 102, 167, 99, 74, 62, 40, 234, 128,
  41, 53, 9, 178, 241, 141, 26, 8, 107,
  74, 43, 26, 146, 73, 166, 49, 23, 157,
  65, 38, 105, 160, 51, 52, 31, 115, 128,
  104, 79, 12, 27, 217, 255, 87, 17, 7,
  87, 68, 71, 44, 114, 51, 15, 186, 23,
  47, 41, 14, 110, 182, 183, 21, 17, 194,
  66, 45, 25, 102, 197, 189, 23, 18, 22,
  88, 88, 147, 150, 42, 46, 45, 196, 205,
  43, 97, 183, 117, 85, 38, 35, 179, 61,
  39, 53, 200, 87, 26, 21, 43, 232, 171,
  56, 34, 51, 104, 114, 102, 29, 93, 77,
  39, 28, 85, 171, 58, 165, 90, 98, 64,
  34, 22, 116, 206, 23, 34, 43, 166, 73,
  107, 54, 32, 26, 51, 1, 81, 43, 31,
  68, 25, 106, 22, 64, 171, 36, 225, 114,
  34, 19, 21, 102, 132, 188, 16, 76, 124,
  62, 18, 78, 95, 85, 57, 50, 48, 51,
  193, 101, 35, 159, 215, 111, 89, 46, 111,
  60, 148, 31, 172, 219, 228, 21, 18, 111,
  112, 113, 77, 85, 179, 255, 38, 120, 114,
  40, 42, 1, 196, 245, 209, 10, 25, 109,
  88, 43, 29, 140, 166, 213, 37, 43, 154,
  61, 63, 30, 155, 67, 45, 68, 1, 209,
  100, 80, 8, 43, 154, 1, 51, 26, 71,
  142, 78, 78, 16, 255, 128, 34, 197, 171,
  41, 40, 5, 102, 211, 183, 4, 1, 221,
  51, 50, 17, 168, 209, 192, 23, 25, 82,
  138, 31, 36, 171, 27, 166, 38, 44, 229,
  67, 87, 58, 169, 82, 115, 26, 59, 179,
  63, 59, 90, 180, 59, 166, 93, 73, 154,
  40, 40, 21, 116, 143, 209, 34, 39, 175,
  47, 15, 16, 183, 34, 223, 49, 45, 183,
  46, 17, 33, 183, 6, 98, 15, 32, 183,
  57, 46, 22, 24, 128, 1, 54, 17, 37,
  65, 32, 73, 115, 28, 128, 23, 128, 205,
  40, 3, 9, 115, 51, 192, 18, 6, 223,
  87, 37, 9, 115, 59, 77, 64, 21, 47,
  104, 55, 44, 218, 9, 54, 53, 130, 226,
  64, 90, 70, 205, 40, 41, 23, 26, 57,
  54, 57, 112, 184, 5, 41, 38, 166, 213,
  30, 34, 26, 133, 152, 116, 10, 32, 134,
  39, 19, 53, 221, 26, 114, 32, 73, 255,
  31, 9, 65, 234, 2, 15, 1, 118, 73,
  75, 32, 12, 51, 192, 255, 160, 43, 51,
  88, 31, 35, 67, 102, 85, 55, 186, 85,
  56, 21, 23, 111, 59, 205, 45, 37, 192,
  55, 38, 70, 124, 73, 102, 1, 34, 98,
  125, 98, 42, 88, 104, 85, 117, 175, 82,
  95, 84, 53, 89, 128, 100, 113, 101, 45,
  75, 79, 123, 47, 51, 128, 81, 171, 1,
  57, 17, 5, 71, 102, 57, 53, 41, 49,
  38, 33, 13, 121, 57, 73, 26, 1, 85,
  41, 10, 67, 138, 77, 110, 90, 47, 114,
  115, 21, 2, 10, 102, 255, 166, 23, 6,
  101, 29, 16, 10, 85, 128, 101, 196, 26,
  57, 18, 10, 102, 102, 213, 34, 20, 43,
  117, 20, 15, 36, 163, 128, 68, 1, 26,
  102, 61, 71, 37, 34, 53, 31, 243, 192,
  69, 60, 71, 38, 73, 119, 28, 222, 37,
  68, 45, 128, 34, 1, 47, 11, 245, 171,
  62, 17, 19, 70, 146, 85, 55, 62, 70,
  37, 43, 37, 154, 100, 163, 85, 160, 1,
  63, 9, 92, 136, 28, 64, 32, 201, 85,
  75, 15, 9, 9, 64, 255, 184, 119, 16,
  86, 6, 28, 5, 64, 255, 25, 248, 1,
  56, 8, 17, 132, 137, 255, 55, 116, 128,
  58, 15, 20, 82, 135, 57, 26, 121, 40,
  164, 50, 31, 137, 154, 133, 25, 35, 218,
  51, 103, 44, 131, 131, 123, 31, 6, 158,
  86, 40, 64, 135, 148, 224, 45, 183, 128,
  22, 26, 17, 131, 240, 154, 14, 1, 209,
  45, 16, 21, 91, 64, 222, 7, 1, 197,
  56, 21, 39, 155, 60, 138, 23, 102, 213,
  83, 12, 13, 54, 192, 255, 68, 47, 28,
  85, 26, 85, 85, 128, 128, 32, 146, 171,
  18, 11, 7, 63, 144, 171, 4, 4, 246,
  35, 27, 10, 146, 174, 171, 12, 26, 128,
  190, 80, 35, 99, 180, 80, 126, 54, 45,
  85, 126, 47, 87, 176, 51, 41, 20, 32,
  101, 75, 128, 139, 118, 146, 116, 128, 85,
  56, 41, 15, 176, 236, 85, 37, 9, 62,
  71, 30, 17, 119, 118, 255, 17, 18, 138,
  101, 38, 60, 138, 55, 70, 43, 26, 142,
  146, 36, 19, 30, 171, 255, 97, 27, 20,
  138, 45, 61, 62, 219, 1, 81, 188, 64,
  32, 41, 20, 117, 151, 142, 20, 21, 163,
  112, 19, 12, 61, 195, 128, 48, 4, 24
};
const uint8_t kCoeffsProba0[1056] = {
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
  189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
  106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
  1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
  181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
  78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
  1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
  184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
  77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
  1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
  170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
  37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
  1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
  207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
  102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
  1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
  177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
  80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
  131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
  68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
  1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
  184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
  81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
  1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
  99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
  23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
  1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
  109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
  44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
  1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
  94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
  22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
  1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
  124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
  35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
  1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
  121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
  45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
  1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
  203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
  253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
  175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
  73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
  1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
  239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
  155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
  1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
  201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
  69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
  1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
  223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
  141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
  190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
  149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
  213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
  55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
  202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
  126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
  61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
  1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
  166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
  39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
  1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
  124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
  24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
  1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
  149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
  28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
  1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
  123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
  20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
  1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
  168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
  47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
  1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
  141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
  42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
  1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
  238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128
};
const uint8_t kCodeToPlane[120] = {
  24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
  56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
  71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
  75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
  68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
  102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
  120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
  118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
  0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
  81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112
};

// ---------------------------------------------------------------------------
// VP8 (lossy): RFC 6386 key frames, decoded as libwebp 1.6 decodes them
// ---------------------------------------------------------------------------

constexpr int kBps = 32;  // stride of the reconstruction workspace
constexpr int kYOff = kBps * 1 + 8;
constexpr int kUOff = kYOff + kBps * 16 + kBps;
constexpr int kVOff = kUOff + 16;
constexpr int kYuvSize = kBps * 17 + kBps * 9;

// libwebp's mode numbers: the 4x4 modes, then the 16x16/chroma DC variants
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU,
       DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11,
                             14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7,
                            0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130,
                         129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};
// where each 4x4 block of a macroblock starts in the workspace
const int kScan[16] = {0 + 0 * kBps,  4 + 0 * kBps,  8 + 0 * kBps,
                       12 + 0 * kBps, 0 + 4 * kBps,  4 + 4 * kBps,
                       8 + 4 * kBps,  12 + 4 * kBps, 0 + 8 * kBps,
                       4 + 8 * kBps,  8 + 8 * kBps,  12 + 8 * kBps,
                       0 + 12 * kBps, 4 + 12 * kBps, 8 + 12 * kBps,
                       12 + 12 * kBps};

// The boolean decoder with libwebp's 56-bit window: where it loads bytes
// and when it flags the end of a partition decide which truncated or
// corrupt streams fail.
struct BoolReader {
  uint64_t value = 0;
  uint32_t range = 255 - 1;
  int bits = -8;
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  const uint8_t* max = nullptr;
  int eof = 0;
};

void LoadFinalBytes(BoolReader& br) {
  if (br.buf < br.end) {
    br.bits += 8;
    br.value = static_cast<uint64_t>(*br.buf++) | (br.value << 8);
  } else if (!br.eof) {
    br.value <<= 8;
    br.bits += 8;
    br.eof = 1;
  } else {
    br.bits = 0;
  }
}

inline void LoadNewBytes(BoolReader& br) {
  if (br.buf < br.max) {
    uint64_t in;
    std::memcpy(&in, br.buf, sizeof(in));
    br.buf += 7;
    in = __builtin_bswap64(in) >> 8;
    br.value = in | (br.value << 56);
    br.bits += 56;
  } else {
    LoadFinalBytes(br);
  }
}

void InitBoolReader(BoolReader& br, const uint8_t* start, size_t size) {
  br = BoolReader();
  br.buf = start;
  br.end = start + size;
  br.max = size >= 8 ? start + size - 8 + 1 : start;
  LoadNewBytes(br);
}

inline int GetBit(BoolReader& br, int prob) {
  uint32_t range = br.range;
  if (br.bits < 0) LoadNewBytes(br);
  const int pos = br.bits;
  const uint32_t split = (range * static_cast<uint32_t>(prob)) >> 8;
  const uint32_t value = static_cast<uint32_t>(br.value >> pos);
  const int bit = value > split;
  if (bit) {
    range -= split;
    br.value -= static_cast<uint64_t>(split + 1) << pos;
  } else {
    range = split + 1;
  }
  const int shift = 7 ^ (31 - __builtin_clz(range));
  range <<= shift;
  br.bits -= shift;
  br.range = range - 1;
  return bit;
}

// GetBit at probability 1/2 with the sign applied (libwebp's VP8GetSigned)
inline int GetSigned(BoolReader& br, int v) {
  if (br.bits < 0) LoadNewBytes(br);
  const int pos = br.bits;
  const uint32_t split = br.range >> 1;
  const uint32_t value = static_cast<uint32_t>(br.value >> pos);
  const int32_t mask = static_cast<int32_t>(split - value) >> 31;
  br.bits -= 1;
  br.range += static_cast<uint32_t>(mask);
  br.range |= 1;
  br.value -= static_cast<uint64_t>((split + 1) & static_cast<uint32_t>(mask))
              << pos;
  return (v ^ mask) - mask;
}

inline int GetValue(BoolReader& br, int bits) {
  int v = 0;
  while (bits-- > 0) v |= GetBit(br, 0x80) << bits;
  return v;
}

inline int GetSignedValue(BoolReader& br, int bits) {
  const int value = GetValue(br, bits);
  return GetBit(br, 0x80) ? -value : value;
}

struct FInfo {
  uint8_t limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t is_i4x4, imodes[16], uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
};

struct Vp8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  int segments_proba[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  FInfo fstrengths[4][2];
  struct {
    int y1[2], y2[2], uv[2];
  } dqm[4];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  BoolReader br;
  BoolReader parts[8];
  int num_parts_minus_one = 0;
  // the contexts of the coefficient and mode parsers
  std::vector<uint8_t> intra_t;
  uint8_t intra_l[4];
  std::vector<uint8_t> nz_t, nz_dc_t;  // per macroblock column
  uint8_t nz_l = 0, nz_dc_l = 0;
};

inline int Clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }

bool ParseHeaders(Vp8& d, const uint8_t* buf, size_t size) {
  if (size < 10) return false;
  const uint32_t bits = buf[0] | (buf[1] << 8) | (buf[2] << 16);
  const int key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t partition_length = bits >> 5;
  if (profile > 3 || !show || !key_frame) return false;
  buf += 3;
  size -= 3;
  if (buf[0] != 0x9d || buf[1] != 0x01 || buf[2] != 0x2a) return false;
  d.width = ((buf[4] << 8) | buf[3]) & 0x3fff;  // the scale bits are ignored
  d.height = ((buf[6] << 8) | buf[5]) & 0x3fff;
  buf += 7;
  size -= 7;
  if (d.width == 0 || d.height == 0) return false;
  d.mb_w = (d.width + 15) >> 4;
  d.mb_h = (d.height + 15) >> 4;
  if (partition_length > size) return false;
  BoolReader& br = d.br;
  InitBoolReader(br, buf, partition_length);
  buf += partition_length;
  size -= partition_length;
  GetValue(br, 1);  // colorspace
  GetValue(br, 1);  // clamp type
  // segment header
  d.use_segment = GetValue(br, 1);
  if (d.use_segment) {
    d.update_map = GetValue(br, 1);
    if (GetValue(br, 1)) {
      d.absolute_delta = GetValue(br, 1);
      for (int s = 0; s < 4; ++s)
        d.quantizer[s] = GetValue(br, 1) ? GetSignedValue(br, 7) : 0;
      for (int s = 0; s < 4; ++s)
        d.filter_strength[s] = GetValue(br, 1) ? GetSignedValue(br, 6) : 0;
    }
    if (d.update_map)
      for (int s = 0; s < 3; ++s)
        d.segments_proba[s] = GetValue(br, 1) ? GetValue(br, 8) : 255;
  } else {
    d.update_map = 0;
  }
  if (br.eof) return false;
  // filter header
  d.simple = GetValue(br, 1);
  d.level = GetValue(br, 6);
  d.sharpness = GetValue(br, 3);
  d.use_lf_delta = GetValue(br, 1);
  if (d.use_lf_delta && GetValue(br, 1)) {
    for (int i = 0; i < 4; ++i)
      if (GetValue(br, 1)) d.ref_lf_delta[i] = GetSignedValue(br, 6);
    for (int i = 0; i < 4; ++i)
      if (GetValue(br, 1)) d.mode_lf_delta[i] = GetSignedValue(br, 6);
  }
  d.filter_type = d.level == 0 ? 0 : d.simple ? 1 : 2;
  if (br.eof) return false;
  // token partitions: the last one takes every byte that is left
  d.num_parts_minus_one = (1 << GetValue(br, 2)) - 1;
  const size_t last_part = d.num_parts_minus_one;
  if (size < 3 * last_part) return false;
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + last_part * 3;
  size_t size_left = size - last_part * 3;
  for (size_t p = 0; p < last_part; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    InitBoolReader(d.parts[p], part_start, psize);
    part_start += psize;
    size_left -= psize;
    sz += 3;
  }
  InitBoolReader(d.parts[last_part], part_start, size_left);
  if (!(part_start < buf + size)) return false;
  // quantizers, with libwebp's clamps
  const int base_q0 = GetValue(br, 7);
  const int dqy1_dc = GetValue(br, 1) ? GetSignedValue(br, 4) : 0;
  const int dqy2_dc = GetValue(br, 1) ? GetSignedValue(br, 4) : 0;
  const int dqy2_ac = GetValue(br, 1) ? GetSignedValue(br, 4) : 0;
  const int dquv_dc = GetValue(br, 1) ? GetSignedValue(br, 4) : 0;
  const int dquv_ac = GetValue(br, 1) ? GetSignedValue(br, 4) : 0;
  for (int i = 0; i < 4; ++i) {
    int q;
    if (d.use_segment) {
      q = d.quantizer[i];
      if (!d.absolute_delta) q += base_q0;
    } else if (i > 0) {
      d.dqm[i] = d.dqm[0];
      continue;
    } else {
      q = base_q0;
    }
    auto& m = d.dqm[i];
    m.y1[0] = kDcTable[Clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[Clip(q, 127)];
    m.y2[0] = kDcTable[Clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[Clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[Clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[Clip(q + dquv_ac, 127)];
  }
  GetValue(br, 1);  // refresh entropy probs: ignored, as libwebp does
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int i = ((t * 8 + b) * 3 + c) * 11 + p;
          d.proba[t][b][c][p] = GetBit(br, kCoeffsUpdateProba[i])
                                    ? GetValue(br, 8) : kCoeffsProba0[i];
        }
  d.use_skip_proba = GetValue(br, 1);
  if (d.use_skip_proba) d.skip_p = GetValue(br, 8);
  // loop-filter strengths per segment and per 16x16 / 4x4 prediction
  for (int s = 0; s < 4; ++s) {
    int base_level;
    if (d.use_segment) {
      base_level = d.filter_strength[s];
      if (!d.absolute_delta) base_level += d.level;
    } else {
      base_level = d.level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& info = d.fstrengths[s][i4x4];
      int level = base_level;
      if (d.use_lf_delta) {
        level += d.ref_lf_delta[0];
        if (i4x4) level += d.mode_lf_delta[0];
      }
      level = level < 0 ? 0 : level > 63 ? 63 : level;
      if (level > 0) {
        int ilevel = level;
        if (d.sharpness > 0) {
          ilevel >>= d.sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - d.sharpness) ilevel = 9 - d.sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * level + ilevel;
        info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      } else {
        info.limit = 0;
      }
      info.inner = i4x4;
    }
  }
  return true;
}

void ParseIntraMode(Vp8& d, MBData& block, int mb_x) {
  BoolReader& br = d.br;
  uint8_t* const top = d.intra_t.data() + 4 * mb_x;
  uint8_t* const left = d.intra_l;
  if (d.update_map) {
    block.segment = !GetBit(br, d.segments_proba[0])
                        ? GetBit(br, d.segments_proba[1])
                        : GetBit(br, d.segments_proba[2]) + 2;
  } else {
    block.segment = 0;
  }
  block.skip = d.use_skip_proba ? GetBit(br, d.skip_p) : 0;
  block.is_i4x4 = !GetBit(br, 145);
  if (!block.is_i4x4) {
    const int ymode = GetBit(br, 156) ? (GetBit(br, 128) ? B_TM : B_HE)
                                      : (GetBit(br, 163) ? B_VE : B_DC);
    block.imodes[0] = ymode;
    std::memset(top, ymode, 4);
    std::memset(left, ymode, 4);
  } else {
    uint8_t* modes = block.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* const prob = kBModesProba + (top[x] * 10 + ymode) * 9;
        ymode = !GetBit(br, prob[0]) ? B_DC
              : !GetBit(br, prob[1]) ? B_TM
              : !GetBit(br, prob[2]) ? B_VE
              : !GetBit(br, prob[3])
                  ? (!GetBit(br, prob[4]) ? B_HE
                     : (!GetBit(br, prob[5]) ? B_RD : B_VR))
                  : (!GetBit(br, prob[6]) ? B_LD
                     : (!GetBit(br, prob[7]) ? B_VL
                        : (!GetBit(br, prob[8]) ? B_HD : B_HU)));
        top[x] = ymode;
      }
      std::memcpy(modes, top, 4);
      modes += 4;
      left[y] = ymode;
    }
  }
  block.uvmode = !GetBit(br, 142) ? B_DC
               : !GetBit(br, 114) ? B_VE
               : GetBit(br, 183) ? B_TM : B_HE;
}

int GetLargeValue(BoolReader& br, const uint8_t* p) {
  int v;
  if (!GetBit(br, p[3])) {
    v = !GetBit(br, p[4]) ? 2 : 3 + GetBit(br, p[5]);
  } else if (!GetBit(br, p[6])) {
    if (!GetBit(br, p[7])) {
      v = 5 + GetBit(br, 159);
    } else {
      v = 7 + 2 * GetBit(br, 165);
      v += GetBit(br, 145);
    }
  } else {
    const int bit1 = GetBit(br, p[8]);
    const int bit0 = GetBit(br, p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab)
      v += v + GetBit(br, *tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// the position of the last non-zero coefficient plus one
int GetCoeffs(BoolReader& br, const uint8_t (*bands)[3][11], int ctx,
              const int* dq, int n, int16_t* out) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!GetBit(br, p[0])) return n;
    while (!GetBit(br, p[1])) {
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t (*p_ctx)[11] = bands[kBands[n + 1]];
    int v;
    if (!GetBit(br, p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = GetLargeValue(br, p);
      p = p_ctx[2];
    }
    out[kZigzag[n]] = static_cast<int16_t>(GetSigned(br, v) * dq[n > 0]);
  }
  return 16;
}

inline uint32_t NzCodeBits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= nz > 3 ? 3 : nz > 1 ? 2 : dc_nz;
  return nz_coeffs;
}

void TransformWHT(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = static_cast<int16_t>((a0 + a1) >> 3);
    out[16] = static_cast<int16_t>((a3 + a2) >> 3);
    out[32] = static_cast<int16_t>((a0 - a1) >> 3);
    out[48] = static_cast<int16_t>((a3 - a2) >> 3);
    out += 64;
  }
}

// returns true when the macroblock has no non-zero coefficient
bool ParseResiduals(Vp8& d, MBData& block, int mb_x, BoolReader& br) {
  const auto& q = d.dqm[block.segment];
  int16_t* dst = block.coeffs;
  std::memset(dst, 0, sizeof(block.coeffs));
  uint8_t& mb_nz = d.nz_t[mb_x];
  uint8_t& mb_nz_dc = d.nz_dc_t[mb_x];
  const uint8_t (*ac_proba)[3][11];
  int first;
  if (!block.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = mb_nz_dc + d.nz_dc_l;
    const int nz = GetCoeffs(br, d.proba[1], ctx, q.y2, 0, dc);
    mb_nz_dc = d.nz_dc_l = nz > 0;
    if (nz > 1) {
      TransformWHT(dc, dst);
    } else {
      const int dc0 = (dc[0] + 3) >> 3;
      for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
    }
    first = 1;
    ac_proba = d.proba[0];
  } else {
    first = 0;
    ac_proba = d.proba[3];
  }
  uint32_t non_zero_y = 0, non_zero_uv = 0;
  uint8_t tnz = mb_nz & 0x0f, lnz = d.nz_l & 0x0f;
  for (int y = 0; y < 4; ++y) {
    int l = lnz & 1;
    uint32_t nz_coeffs = 0;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + (tnz & 1);
      const int nz = GetCoeffs(br, ac_proba, ctx, q.y1, first, dst);
      l = nz > first;
      tnz = (tnz >> 1) | (l << 7);
      nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
      dst += 16;
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | (l << 7);
    non_zero_y = (non_zero_y << 8) | nz_coeffs;
  }
  uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
  for (int ch = 0; ch < 4; ch += 2) {
    uint32_t nz_coeffs = 0;
    tnz = mb_nz >> (4 + ch);
    lnz = d.nz_l >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      int l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = GetCoeffs(br, d.proba[2], ctx, q.uv, 0, dst);
        l = nz > 0;
        tnz = (tnz >> 1) | (l << 3);
        nz_coeffs = NzCodeBits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | (l << 5);
    }
    non_zero_uv |= nz_coeffs << (4 * ch);
    out_t_nz |= (tnz << 4) << ch;
    out_l_nz |= (lnz & 0xf0) << ch;
  }
  mb_nz = static_cast<uint8_t>(out_t_nz);
  d.nz_l = static_cast<uint8_t>(out_l_nz);
  block.non_zero_y = non_zero_y;
  block.non_zero_uv = non_zero_uv;
  return !(non_zero_y | non_zero_uv);
}

// --- inverse transforms: the full one as libwebp's SSE2 code computes it
// (16-bit lanes), the DC-only and AC3 ones as its C code does

inline uint8_t Clip8b(int v) {
  return !(v & ~0xff) ? static_cast<uint8_t>(v) : v < 0 ? 0 : 255;
}

inline int16_t W16(int v) { return static_cast<int16_t>(v); }
inline int16_t MulHi16(int16_t a, int k) {
  return static_cast<int16_t>((static_cast<int32_t>(a) * k) >> 16);
}

void TransformOne(const int16_t* in, uint8_t* dst) {
  const int k1 = 20091, k2 = -30068;
  int16_t T[4][4];  // T[row of the transposed output][lane]
  {
    int16_t tmp[4][4];  // tmp[k][column]
    for (int i = 0; i < 4; ++i) {
      const int16_t in0 = in[0 + i], in1 = in[4 + i], in2 = in[8 + i],
                    in3 = in[12 + i];
      const int16_t a = W16(in0 + in2), b = W16(in0 - in2);
      const int16_t c = W16(W16(in1 - in3) +
                            W16(MulHi16(in1, k2) - MulHi16(in3, k1)));
      const int16_t dd = W16(W16(in1 + in3) +
                             W16(MulHi16(in1, k1) + MulHi16(in3, k2)));
      tmp[0][i] = W16(a + dd);
      tmp[1][i] = W16(b + c);
      tmp[2][i] = W16(b - c);
      tmp[3][i] = W16(a - dd);
    }
    for (int r = 0; r < 4; ++r)
      for (int c = 0; c < 4; ++c) T[r][c] = tmp[c][r];
  }
  int16_t out[4][4];
  for (int i = 0; i < 4; ++i) {
    const int16_t t0 = T[0][i], t1 = T[1][i], t2 = T[2][i], t3 = T[3][i];
    const int16_t dc = W16(t0 + 4);
    const int16_t a = W16(dc + t2), b = W16(dc - t2);
    const int16_t c =
        W16(W16(t1 - t3) + W16(MulHi16(t1, k2) - MulHi16(t3, k1)));
    const int16_t dd =
        W16(W16(t1 + t3) + W16(MulHi16(t1, k1) + MulHi16(t3, k2)));
    out[0][i] = static_cast<int16_t>(W16(a + dd) >> 3);
    out[1][i] = static_cast<int16_t>(W16(b + c) >> 3);
    out[2][i] = static_cast<int16_t>(W16(b - c) >> 3);
    out[3][i] = static_cast<int16_t>(W16(a - dd) >> 3);
  }
  // out[k][i]: row i of the block, column k
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) {
      const int16_t s = W16(dst[x + y * kBps] + out[x][y]);
      dst[x + y * kBps] = s < 0 ? 0 : s > 255 ? 255 : static_cast<uint8_t>(s);
    }
}

inline int Mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int Mul2(int a) { return (a * 35468) >> 16; }

void TransformAC3(const int16_t* in, uint8_t* dst) {
  const int a = in[0] + 4;
  const int c4 = Mul2(in[4]), d4 = Mul1(in[4]);
  const int c1 = Mul2(in[1]), d1 = Mul1(in[1]);
  const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
  for (int y = 0; y < 4; ++y) {
    const int dc = rows[y];
    uint8_t* p = dst + y * kBps;
    p[0] = Clip8b(p[0] + ((dc + d1) >> 3));
    p[1] = Clip8b(p[1] + ((dc + c1) >> 3));
    p[2] = Clip8b(p[2] + ((dc - c1) >> 3));
    p[3] = Clip8b(p[3] + ((dc - d1) >> 3));
  }
}

void TransformDC(const int16_t* in, uint8_t* dst) {
  const int dc = in[0] + 4;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x)
      dst[x + y * kBps] = Clip8b(dst[x + y * kBps] + (dc >> 3));
}

void DoTransform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  switch (bits >> 30) {
    case 3: TransformOne(src, dst); break;
    case 2: TransformAC3(src, dst); break;
    case 1: TransformDC(src, dst); break;
    default: break;
  }
}

void DoUVTransform(uint32_t bits, const int16_t* src, uint8_t* dst) {
  if (bits & 0xff) {
    if (bits & 0xaa) {
      TransformOne(src, dst);
      TransformOne(src + 16, dst + 4);
      TransformOne(src + 32, dst + 4 * kBps);
      TransformOne(src + 48, dst + 4 * kBps + 4);
    } else {
      if (src[0]) TransformDC(src, dst);
      if (src[16]) TransformDC(src + 16, dst + 4);
      if (src[32]) TransformDC(src + 32, dst + 4 * kBps);
      if (src[48]) TransformDC(src + 48, dst + 4 * kBps + 4);
    }
  }
}

// --- intra prediction (libwebp's dsp/dec.c)

#define DST(x, y) dst[(x) + (y) * kBps]
inline uint8_t Avg3(int a, int b, int c) {
  return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2);
}
inline uint8_t Avg2(int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); }

void TrueMotion(uint8_t* dst, int size) {
  const uint8_t* top = dst - kBps;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = Clip8b(top[x] + l - tl);
    dst += kBps;
  }
}

void Pred4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - kBps;
  switch (mode) {
    case B_DC: {
      uint32_t dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - kBps] + dst[-1 + i * kBps];
      dc >>= 3;
      for (int i = 0; i < 4; ++i) std::memset(dst + i * kBps, dc, 4);
      break;
    }
    case B_TM: TrueMotion(dst, 4); break;
    case B_VE: {
      const uint8_t vals[4] = {Avg3(top[-1], top[0], top[1]),
                               Avg3(top[0], top[1], top[2]),
                               Avg3(top[1], top[2], top[3]),
                               Avg3(top[2], top[3], top[4])};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * kBps, vals, 4);
      break;
    }
    case B_HE: {
      const int A = dst[-1 - kBps], B = dst[-1], C = dst[-1 + kBps],
                D = dst[-1 + 2 * kBps], E = dst[-1 + 3 * kBps];
      std::memset(dst + 0 * kBps, Avg3(A, B, C), 4);
      std::memset(dst + 1 * kBps, Avg3(B, C, D), 4);
      std::memset(dst + 2 * kBps, Avg3(C, D, E), 4);
      std::memset(dst + 3 * kBps, Avg3(D, E, E), 4);
      break;
    }
    case B_RD: {
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps],
                L = dst[-1 + 3 * kBps], X = dst[-1 - kBps], A = top[0],
                B = top[1], C = top[2], D = top[3];
      DST(0, 3) = Avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = Avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = Avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = Avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = Avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = Avg3(C, B, A);
      DST(3, 0) = Avg3(D, C, B);
      break;
    }
    case B_LD: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
                F = top[5], G = top[6], H = top[7];
      DST(0, 0) = Avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = Avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = Avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = Avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = Avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = Avg3(F, G, H);
      DST(3, 3) = Avg3(G, H, H);
      break;
    }
    case B_VR: {
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps],
                X = dst[-1 - kBps], A = top[0], B = top[1], C = top[2],
                D = top[3];
      DST(0, 0) = DST(1, 2) = Avg2(X, A);
      DST(1, 0) = DST(2, 2) = Avg2(A, B);
      DST(2, 0) = DST(3, 2) = Avg2(B, C);
      DST(3, 0) = Avg2(C, D);
      DST(0, 3) = Avg3(K, J, I);
      DST(0, 2) = Avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = Avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = Avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = Avg3(A, B, C);
      DST(3, 1) = Avg3(B, C, D);
      break;
    }
    case B_VL: {
      const int A = top[0], B = top[1], C = top[2], D = top[3], E = top[4],
                F = top[5], G = top[6], H = top[7];
      DST(0, 0) = Avg2(A, B);
      DST(1, 0) = DST(0, 2) = Avg2(B, C);
      DST(2, 0) = DST(1, 2) = Avg2(C, D);
      DST(3, 0) = DST(2, 2) = Avg2(D, E);
      DST(0, 1) = Avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = Avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = Avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = Avg3(D, E, F);
      DST(3, 2) = Avg3(E, F, G);
      DST(3, 3) = Avg3(F, G, H);
      break;
    }
    case B_HU: {
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps],
                L = dst[-1 + 3 * kBps];
      DST(0, 0) = Avg2(I, J);
      DST(2, 0) = DST(0, 1) = Avg2(J, K);
      DST(2, 1) = DST(0, 2) = Avg2(K, L);
      DST(1, 0) = Avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = Avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = Avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) =
          static_cast<uint8_t>(L);
      break;
    }
    case B_HD: {
      const int I = dst[-1], J = dst[-1 + kBps], K = dst[-1 + 2 * kBps],
                L = dst[-1 + 3 * kBps], X = dst[-1 - kBps], A = top[0],
                B = top[1], C = top[2];
      DST(0, 0) = DST(2, 1) = Avg2(I, X);
      DST(0, 1) = DST(2, 2) = Avg2(J, I);
      DST(0, 2) = DST(2, 3) = Avg2(K, J);
      DST(0, 3) = Avg2(L, K);
      DST(3, 0) = Avg3(A, B, C);
      DST(2, 0) = Avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = Avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = Avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = Avg3(K, J, I);
      DST(1, 3) = Avg3(L, K, J);
      break;
    }
  }
}
#undef DST

void Fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) std::memset(dst + j * kBps, v, size);
}

// 16x16 luma (size 16) and 8x8 chroma (size 8) prediction
void PredBlock(int mode, uint8_t* dst, int size) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * kBps] + dst[j - kBps];
      Fill(dst, dc >> (shift + 1), size);
      break;
    }
    case B_TM: TrueMotion(dst, size); break;
    case B_VE:
      for (int j = 0; j < size; ++j)
        std::memcpy(dst + j * kBps, dst - kBps, size);
      break;
    case B_HE:
      for (int j = 0; j < size; ++j)
        std::memset(dst + j * kBps, dst[-1 + j * kBps], size);
      break;
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * kBps];
      Fill(dst, dc >> shift, size);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int i = 0; i < size; ++i) dc += dst[i - kBps];
      Fill(dst, dc >> shift, size);
      break;
    }
    case DC_NOTOPLEFT: Fill(dst, 0x80, size); break;
  }
}

inline int CheckMode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : B_DC;
  }
  return mode;
}

struct TopSamples {
  uint8_t y[16], u[8], v[8];
};

// Reconstruct one macroblock row into the planes (libwebp's
// ReconstructRow: prediction from the unfiltered neighbours, the workspace's
// 127/129 borders, the above-right samples of the rightmost macroblock
// replicated from its top row's last pixel).
void ReconstructRow(const Vp8& d, const MBData* blocks, int mb_y,
                    std::vector<TopSamples>& yuv_t, uint8_t* ws, uint8_t* py,
                    uint8_t* pu, uint8_t* pv, int ystride, int uvstride) {
  uint8_t* const y_dst = ws + kYOff;
  uint8_t* const u_dst = ws + kUOff;
  uint8_t* const v_dst = ws + kVOff;
  for (int j = 0; j < 16; ++j) y_dst[j * kBps - 1] = 129;
  for (int j = 0; j < 8; ++j) {
    u_dst[j * kBps - 1] = 129;
    v_dst[j * kBps - 1] = 129;
  }
  if (mb_y > 0) {
    y_dst[-1 - kBps] = u_dst[-1 - kBps] = v_dst[-1 - kBps] = 129;
  } else {
    std::memset(y_dst - kBps - 1, 127, 16 + 4 + 1);
    std::memset(u_dst - kBps - 1, 127, 8 + 1);
    std::memset(v_dst - kBps - 1, 127, 8 + 1);
  }
  for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
    const MBData& block = blocks[mb_x];
    if (mb_x > 0) {
      for (int j = -1; j < 16; ++j)
        std::memcpy(&y_dst[j * kBps - 4], &y_dst[j * kBps + 12], 4);
      for (int j = -1; j < 8; ++j) {
        std::memcpy(&u_dst[j * kBps - 4], &u_dst[j * kBps + 4], 4);
        std::memcpy(&v_dst[j * kBps - 4], &v_dst[j * kBps + 4], 4);
      }
    }
    TopSamples* const top_yuv = yuv_t.data() + mb_x;
    const int16_t* const coeffs = block.coeffs;
    uint32_t bits = block.non_zero_y;
    if (mb_y > 0) {
      std::memcpy(y_dst - kBps, top_yuv[0].y, 16);
      std::memcpy(u_dst - kBps, top_yuv[0].u, 8);
      std::memcpy(v_dst - kBps, top_yuv[0].v, 8);
    }
    if (block.is_i4x4) {
      uint8_t* const top_right = y_dst - kBps + 16;
      if (mb_y > 0) {
        if (mb_x >= d.mb_w - 1)
          std::memset(top_right, top_yuv[0].y[15], 4);
        else
          std::memcpy(top_right, top_yuv[1].y, 4);
      }
      std::memcpy(top_right + 4 * kBps, top_right, 4);
      std::memcpy(top_right + 8 * kBps, top_right, 4);
      std::memcpy(top_right + 12 * kBps, top_right, 4);
      for (int n = 0; n < 16; ++n, bits <<= 2) {
        uint8_t* const dst = y_dst + kScan[n];
        Pred4(block.imodes[n], dst);
        DoTransform(bits, coeffs + n * 16, dst);
      }
    } else {
      PredBlock(CheckMode(mb_x, mb_y, block.imodes[0]), y_dst, 16);
      if (bits != 0)
        for (int n = 0; n < 16; ++n, bits <<= 2)
          DoTransform(bits, coeffs + n * 16, y_dst + kScan[n]);
    }
    const uint32_t bits_uv = block.non_zero_uv;
    const int uv_mode = CheckMode(mb_x, mb_y, block.uvmode);
    PredBlock(uv_mode, u_dst, 8);
    PredBlock(uv_mode, v_dst, 8);
    DoUVTransform(bits_uv >> 0, coeffs + 16 * 16, u_dst);
    DoUVTransform(bits_uv >> 8, coeffs + 20 * 16, v_dst);
    if (mb_y < d.mb_h - 1) {
      std::memcpy(top_yuv[0].y, y_dst + 15 * kBps, 16);
      std::memcpy(top_yuv[0].u, u_dst + 7 * kBps, 8);
      std::memcpy(top_yuv[0].v, v_dst + 7 * kBps, 8);
    }
    for (int j = 0; j < 16; ++j)
      std::memcpy(py + (mb_y * 16 + j) * ystride + mb_x * 16, y_dst + j * kBps,
                  16);
    for (int j = 0; j < 8; ++j) {
      std::memcpy(pu + (mb_y * 8 + j) * uvstride + mb_x * 8, u_dst + j * kBps,
                  8);
      std::memcpy(pv + (mb_y * 8 + j) * uvstride + mb_x * 8, v_dst + j * kBps,
                  8);
    }
  }
}

// --- the loop filter (libwebp's C filters; its SSE2 ones are bit-exact)

inline int Abs0(int v) { return v < 0 ? -v : v; }
inline int SClip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int SClip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void DoFilter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + SClip1(p1 - q1);
  const int a1 = SClip2((a + 4) >> 3);
  const int a2 = SClip2((a + 3) >> 3);
  p[-step] = Clip8b(p0 + a2);
  p[0] = Clip8b(q0 - a1);
}

inline void DoFilter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = SClip2((a + 4) >> 3);
  const int a2 = SClip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = Clip8b(p1 + a3);
  p[-step] = Clip8b(p0 + a2);
  p[0] = Clip8b(q0 - a1);
  p[step] = Clip8b(q1 - a3);
}

inline void DoFilter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = SClip1(3 * (q0 - p0) + SClip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = Clip8b(p2 + a3);
  p[-2 * step] = Clip8b(p1 + a2);
  p[-step] = Clip8b(p0 + a1);
  p[0] = Clip8b(q0 - a1);
  p[step] = Clip8b(q1 - a2);
  p[2 * step] = Clip8b(q2 - a3);
}

inline int Hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return Abs0(p1 - p0) > thresh || Abs0(q1 - q0) > thresh;
}

inline int NeedsFilter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * Abs0(p0 - q0) + Abs0(p1 - q1) <= t;
}

inline int NeedsFilter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * Abs0(p0 - q0) + Abs0(p1 - q1) > t) return 0;
  return Abs0(p3 - p2) <= it && Abs0(p2 - p1) <= it && Abs0(p1 - p0) <= it &&
         Abs0(q3 - q2) <= it && Abs0(q2 - q1) <= it && Abs0(q1 - q0) <= it;
}

void SimpleFilter(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i)
    if (NeedsFilter(p + i * vstride, hstride, thresh2))
      DoFilter2(p + i * vstride, hstride);
}

void FilterLoop(uint8_t* p, int hstride, int vstride, int size, int thresh,
                int ithresh, int hev_thresh, bool edge) {
  const int thresh2 = 2 * thresh + 1;
  while (size-- > 0) {
    if (NeedsFilter2(p, hstride, thresh2, ithresh)) {
      if (Hev(p, hstride, hev_thresh))
        DoFilter2(p, hstride);
      else if (edge)
        DoFilter6(p, hstride);
      else
        DoFilter4(p, hstride);
    }
    p += vstride;
  }
}

// Filter every macroblock in raster order: left edge, inner vertical
// edges, top edge, inner horizontal edges (libwebp's DoFilter).
void FilterFrame(const Vp8& d, const std::vector<FInfo>& finfo, uint8_t* py,
                 uint8_t* pu, uint8_t* pv, int ys, int uvs) {
  for (int mb_y = 0; mb_y < d.mb_h; ++mb_y)
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      const FInfo& f = finfo[mb_y * d.mb_w + mb_x];
      const int limit = f.limit, ilevel = f.ilevel, hev = f.hev_thresh;
      if (limit == 0) continue;
      uint8_t* const y = py + mb_y * 16 * ys + mb_x * 16;
      if (d.filter_type == 1) {
        if (mb_x > 0) SimpleFilter(y, 1, ys, limit + 4);
        if (f.inner)
          for (int k = 1; k < 4; ++k) SimpleFilter(y + 4 * k, 1, ys, limit);
        if (mb_y > 0) SimpleFilter(y, ys, 1, limit + 4);
        if (f.inner)
          for (int k = 1; k < 4; ++k)
            SimpleFilter(y + 4 * k * ys, ys, 1, limit);
        continue;
      }
      uint8_t* const u = pu + mb_y * 8 * uvs + mb_x * 8;
      uint8_t* const v = pv + mb_y * 8 * uvs + mb_x * 8;
      if (mb_x > 0) {
        FilterLoop(y, 1, ys, 16, limit + 4, ilevel, hev, true);
        FilterLoop(u, 1, uvs, 8, limit + 4, ilevel, hev, true);
        FilterLoop(v, 1, uvs, 8, limit + 4, ilevel, hev, true);
      }
      if (f.inner) {
        for (int k = 1; k < 4; ++k)
          FilterLoop(y + 4 * k, 1, ys, 16, limit, ilevel, hev, false);
        FilterLoop(u + 4, 1, uvs, 8, limit, ilevel, hev, false);
        FilterLoop(v + 4, 1, uvs, 8, limit, ilevel, hev, false);
      }
      if (mb_y > 0) {
        FilterLoop(y, ys, 1, 16, limit + 4, ilevel, hev, true);
        FilterLoop(u, uvs, 1, 8, limit + 4, ilevel, hev, true);
        FilterLoop(v, uvs, 1, 8, limit + 4, ilevel, hev, true);
      }
      if (f.inner) {
        for (int k = 1; k < 4; ++k)
          FilterLoop(y + 4 * k * ys, ys, 1, 16, limit, ilevel, hev, false);
        FilterLoop(u + 4 * uvs, uvs, 1, 8, limit, ilevel, hev, false);
        FilterLoop(v + 4 * uvs, uvs, 1, 8, limit, ilevel, hev, false);
      }
    }
}

// Decode a key frame into macroblock-aligned planes (Y: mb_w*16 wide,
// U/V: mb_w*8). Returns 0, or -1 for a stream libwebp refuses.
int DecodeVp8(const uint8_t* data, size_t size, Vp8& d,
              std::vector<uint8_t>& Y, std::vector<uint8_t>& U,
              std::vector<uint8_t>& V) {
  if (!ParseHeaders(d, data, size)) return -1;
  const int ys = d.mb_w * 16, uvs = d.mb_w * 8;
  Y.assign(static_cast<size_t>(ys) * d.mb_h * 16, 0);
  U.assign(static_cast<size_t>(uvs) * d.mb_h * 8, 0);
  V.assign(static_cast<size_t>(uvs) * d.mb_h * 8, 0);
  d.intra_t.assign(4 * d.mb_w, B_DC);
  d.nz_t.assign(d.mb_w, 0);
  d.nz_dc_t.assign(d.mb_w, 0);
  std::vector<MBData> blocks(d.mb_w);
  std::vector<FInfo> finfo(static_cast<size_t>(d.mb_w) * d.mb_h);
  std::vector<TopSamples> yuv_t(d.mb_w);
  uint8_t ws[kYuvSize];
  std::memset(ws, 0, sizeof(ws));
  for (int mb_y = 0; mb_y < d.mb_h; ++mb_y) {
    BoolReader& token_br = d.parts[mb_y & d.num_parts_minus_one];
    std::memset(d.intra_l, B_DC, 4);
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x)
      ParseIntraMode(d, blocks[mb_x], mb_x);
    if (d.br.eof) return -1;
    d.nz_l = d.nz_dc_l = 0;
    for (int mb_x = 0; mb_x < d.mb_w; ++mb_x) {
      MBData& block = blocks[mb_x];
      int skip = d.use_skip_proba ? block.skip : 0;
      if (!skip) {
        skip = ParseResiduals(d, block, mb_x, token_br);
      } else {
        d.nz_l = d.nz_t[mb_x] = 0;
        if (!block.is_i4x4) d.nz_dc_l = d.nz_dc_t[mb_x] = 0;
        block.non_zero_y = 0;
        block.non_zero_uv = 0;
      }
      if (d.filter_type > 0) {
        FInfo& f = finfo[mb_y * d.mb_w + mb_x];
        f = d.fstrengths[block.segment][block.is_i4x4];
        f.inner |= !skip;
      }
      if (token_br.eof) return -1;
    }
    ReconstructRow(d, blocks.data(), mb_y, yuv_t, ws, Y.data(), U.data(),
                   V.data(), ys, uvs);
  }
  if (d.filter_type > 0)
    FilterFrame(d, finfo, Y.data(), U.data(), V.data(), ys, uvs);
  return 0;
}

// --- YUV -> RGB as libwebp's RGB(A) output does it: the "fancy"
// upsampler over pairs of rows, then the 14-bit fixed-point converters

inline int MultHi(int v, int coeff) { return (v * coeff) >> 8; }
inline int YuvClip8(int v) {
  return (v & ~16383) == 0 ? (v >> 6) : v < 0 ? 0 : 255;
}
inline void YuvToRgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = static_cast<uint8_t>(YuvClip8(MultHi(y, 19077) + MultHi(v, 26149) -
                                         14234));
  rgb[1] = static_cast<uint8_t>(YuvClip8(MultHi(y, 19077) - MultHi(u, 6419) -
                                         MultHi(v, 13320) + 8708));
  rgb[2] = static_cast<uint8_t>(YuvClip8(MultHi(y, 19077) + MultHi(u, 33050) -
                                         17685));
}

inline void Interp(int tl, int t, int l, int c, int* o) {
  // the four outputs of libwebp's packed (9,3,3,1)/16 arithmetic: o[0]
  // beside tl on the top row, o[1] beside t, o[2] beside l, o[3] beside c
  const int avg = tl + t + l + c + 8;
  const int diag_12 = (avg + 2 * (t + l)) >> 3;
  const int diag_03 = (avg + 2 * (tl + c)) >> 3;
  o[0] = (diag_12 + tl) >> 1;
  o[1] = (diag_03 + t) >> 1;
  o[2] = (diag_03 + l) >> 1;
  o[3] = (diag_12 + c) >> 1;
}

void UpsampleLinePair(const uint8_t* top_y, const uint8_t* bottom_y,
                      const uint8_t* top_u, const uint8_t* top_v,
                      const uint8_t* cur_u, const uint8_t* cur_v,
                      uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pixel_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  YuvToRgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
           top_dst);
  if (bottom_y)
    YuvToRgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
             bottom_dst);
  for (int x = 1; x <= last_pixel_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
    int ou[4], ov[4];
    Interp(tl_u, t_u, l_u, u, ou);
    Interp(tl_v, t_v, l_v, v, ov);
    YuvToRgb(top_y[2 * x - 1], ou[0], ov[0], top_dst + (2 * x - 1) * 3);
    YuvToRgb(top_y[2 * x], ou[1], ov[1], top_dst + (2 * x) * 3);
    if (bottom_y) {
      YuvToRgb(bottom_y[2 * x - 1], ou[2], ov[2], bottom_dst + (2 * x - 1) * 3);
      YuvToRgb(bottom_y[2 * x], ou[3], ov[3], bottom_dst + (2 * x) * 3);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = u;
    l_v = v;
  }
  if (!(len & 1)) {
    YuvToRgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2,
             (3 * tl_v + l_v + 2) >> 2, top_dst + (len - 1) * 3);
    if (bottom_y)
      YuvToRgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2,
               (3 * l_v + tl_v + 2) >> 2, bottom_dst + (len - 1) * 3);
  }
}

// ---------------------------------------------------------------------------
// VP8L (lossless), as libwebp 1.6's vp8l_dec.c decodes it
// ---------------------------------------------------------------------------

constexpr int kHuffmanTableBits = 8;
constexpr int kLengthsTableBits = 7;
constexpr int kMaxCodeLength = 15;
constexpr int kNumLiteralCodes = 256, kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40, kCodeToPlaneCodes = 120;
const int kAlphabetSize[5] = {kNumLiteralCodes + kNumLengthCodes, 256, 256,
                              256, kNumDistanceCodes};
const uint8_t kCodeLengthCodeOrder[19] = {17, 18, 0, 1,  2,  3,  4,  5,  16, 6,
                                          7,  8,  9, 10, 11, 12, 13, 14, 15};
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

// The bit reader: LSB first. libwebp flags the end of the stream once more
// bits were consumed than its 64-bit window and the data hold together
// (max(8 * len, 64)); bits past the end read as zeros.
struct LBitReader {
  const uint8_t* buf = nullptr;
  size_t len = 0;
  uint64_t pos = 0;  // bits consumed
  uint64_t limit = 0;
  bool Eos() const { return pos > limit; }
  uint32_t Peek() const {  // the next 32 bits
    uint64_t v = 0;
    const size_t byte = pos >> 3;
    for (int i = 0; i < 5; ++i)
      if (byte + i < len) v |= static_cast<uint64_t>(buf[byte + i]) << (8 * i);
    return static_cast<uint32_t>(v >> (pos & 7));
  }
  uint32_t Read(int n) {  // n <= 24
    const uint32_t v = Peek() & ((1u << n) - 1);
    pos += n;
    return v;
  }
};

void InitLBitReader(LBitReader& br, const uint8_t* data, size_t len) {
  br.buf = data;
  br.len = len;
  br.pos = 0;
  br.limit = std::max<uint64_t>(8 * static_cast<uint64_t>(len), 64);
}

struct HuffmanCode {
  uint8_t bits;
  uint16_t value;
};

inline uint32_t GetNextKey(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

inline void ReplicateValue(HuffmanCode* table, int step, int end,
                           HuffmanCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

inline int NextTableBitSize(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// libwebp's BuildHuffmanTable: the table's size, or 0 for a code it
// refuses (every length 0, over-subscribed, or not complete unless it has
// a single symbol). `out` == nullptr only checks.
int BuildHuffmanTable(std::vector<HuffmanCode>* out, int root_bits,
                      const int* code_lengths, int code_lengths_size) {
  int total_size = 1 << root_bits;
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int symbol = 0; symbol < code_lengths_size; ++symbol) {
    if (code_lengths[symbol] > kMaxCodeLength) return 0;
    ++count[code_lengths[symbol]];
  }
  if (count[0] == code_lengths_size) return 0;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return 0;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<uint16_t> sorted(code_lengths_size);
  for (int symbol = 0; symbol < code_lengths_size; ++symbol) {
    const int l = code_lengths[symbol];
    if (l > 0) {
      if (offset[l] >= code_lengths_size) return 0;
      sorted[offset[l]++] = static_cast<uint16_t>(symbol);
    }
  }
  if (offset[kMaxCodeLength] == 1) {
    if (out) {
      const size_t base = out->size();
      out->resize(base + total_size);
      HuffmanCode code{0, sorted[0]};
      ReplicateValue(out->data() + base, 1, total_size, code);
    }
    return total_size;
  }
  // a first pass sizes the table, a second fills it
  std::vector<HuffmanCode> table_store;
  for (int pass = 0; pass < (out ? 2 : 1); ++pass) {
    int cnt[kMaxCodeLength + 1];
    std::memcpy(cnt, count, sizeof(cnt));
    const bool fill = pass == 1;
    HuffmanCode* root = fill ? table_store.data() : nullptr;
    HuffmanCode* table = root;
    int tsize = 1 << root_bits;
    int step;
    uint32_t low = 0xffffffffu, mask = (1u << root_bits) - 1, key = 0;
    int num_nodes = 1, num_open = 1, table_bits = root_bits;
    int table_size = 1 << table_bits, symbol = 0, len;
    for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= cnt[len];
      if (num_open < 0) return 0;
      if (!fill) continue;
      for (; cnt[len] > 0; --cnt[len]) {
        HuffmanCode code{static_cast<uint8_t>(len), sorted[symbol++]};
        ReplicateValue(&table[key], step, table_size, code);
        key = GetNextKey(key, len);
      }
    }
    for (len = root_bits + 1, step = 2; len <= kMaxCodeLength;
         ++len, step <<= 1) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= cnt[len];
      if (num_open < 0) return 0;
      for (; cnt[len] > 0; --cnt[len]) {
        if ((key & mask) != low) {
          if (fill) table += table_size;
          table_bits = NextTableBitSize(cnt, len, root_bits);
          table_size = 1 << table_bits;
          tsize += table_size;
          low = key & mask;
          if (fill) {
            root[low].bits = static_cast<uint8_t>(table_bits + root_bits);
            root[low].value = static_cast<uint16_t>((table - root) - low);
          }
        }
        if (fill) {
          HuffmanCode code{static_cast<uint8_t>(len - root_bits),
                           sorted[symbol++]};
          ReplicateValue(&table[key >> root_bits], step, table_size, code);
        }
        key = GetNextKey(key, len);
      }
    }
    if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return 0;
    total_size = tsize;
    if (!fill && out) table_store.assign(total_size, HuffmanCode{0, 0});
  }
  if (out) out->insert(out->end(), table_store.begin(), table_store.end());
  return total_size;
}

inline int ReadSymbol(const HuffmanCode* table, LBitReader& br) {
  uint32_t val = br.Peek();
  table += val & ((1u << kHuffmanTableBits) - 1);
  const int nbits = table->bits - kHuffmanTableBits;
  if (nbits > 0) {
    br.pos += kHuffmanTableBits;
    val = br.Peek();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.pos += table->bits;
  return table->value;
}

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

struct Meta {
  int color_cache_bits = 0;
  int huffman_bits = 0, huffman_xsize = 0;
  std::vector<uint32_t> huffman_image;
  std::vector<HuffmanCode> tables;
  std::vector<std::array<int, 5>> groups;  // offsets into tables
  std::vector<char> stored;                 // groups whose tables were kept
};

struct Vp8l {
  LBitReader br;
  Transform transforms[4];
  int next_transform = 0;
  unsigned transforms_seen = 0;
};

bool ReadHuffmanCodeLengths(Vp8l& d, const int* cl_code_lengths,
                            int num_symbols, int* code_lengths) {
  LBitReader& br = d.br;
  std::vector<HuffmanCode> table;
  if (!BuildHuffmanTable(&table, kLengthsTableBits, cl_code_lengths, 19))
    return false;
  int max_symbol;
  if (br.Read(1)) {
    const int length_nbits = 2 + 2 * br.Read(3);
    max_symbol = 2 + br.Read(length_nbits);
    if (max_symbol > num_symbols) return false;
  } else {
    max_symbol = num_symbols;
  }
  int symbol = 0, prev_code_len = 8;
  while (symbol < num_symbols) {
    if (max_symbol-- == 0) break;
    const HuffmanCode& p =
        table[br.Peek() & ((1u << kLengthsTableBits) - 1)];
    br.pos += p.bits;
    const int code_len = p.value;
    if (code_len < 16) {
      code_lengths[symbol++] = code_len;
      if (code_len != 0) prev_code_len = code_len;
    } else {
      static const int kExtraBits[3] = {2, 3, 7};
      static const int kRepeatOffsets[3] = {3, 3, 11};
      const int slot = code_len - 16;
      int repeat = br.Read(kExtraBits[slot]) + kRepeatOffsets[slot];
      if (symbol + repeat > num_symbols) return false;
      const int length = code_len == 16 ? prev_code_len : 0;
      while (repeat-- > 0) code_lengths[symbol++] = length;
    }
  }
  return true;
}

// Read one prefix code; append its table to `tables` (unless null) and
// return its size, 0 for a code libwebp refuses.
int ReadHuffmanCode(Vp8l& d, int alphabet_size, std::vector<int>& code_lengths,
                    std::vector<HuffmanCode>* tables) {
  LBitReader& br = d.br;
  std::fill(code_lengths.begin(), code_lengths.begin() + alphabet_size, 0);
  bool ok;
  if (br.Read(1)) {  // simple: one or two symbols
    const int num_symbols = br.Read(1) + 1;
    const int first_symbol_len_code = br.Read(1);
    int symbol = br.Read(first_symbol_len_code == 0 ? 1 : 8);
    code_lengths[symbol] = 1;
    if (num_symbols == 2) {
      symbol = br.Read(8);
      code_lengths[symbol] = 1;
    }
    ok = true;
  } else {
    int cl_code_lengths[19] = {0};
    const int num_codes = br.Read(4) + 4;
    for (int i = 0; i < num_codes; ++i)
      cl_code_lengths[kCodeLengthCodeOrder[i]] = br.Read(3);
    ok = ReadHuffmanCodeLengths(d, cl_code_lengths, alphabet_size,
                                code_lengths.data());
  }
  ok = ok && !br.Eos();
  if (!ok) return 0;
  return BuildHuffmanTable(tables, kHuffmanTableBits, code_lengths.data(),
                           alphabet_size);
}

inline int SubSampleSize(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}

bool DecodeImageStream(Vp8l& d, int xsize, int ysize, bool is_level0,
                       std::vector<uint32_t>* out, Meta* level0_meta,
                       int* level0_xsize);

bool ReadHuffmanCodes(Vp8l& d, int xsize, int ysize, int color_cache_bits,
                      bool allow_recursion, Meta& hdr) {
  LBitReader& br = d.br;
  int num_groups_max = 1;
  if (allow_recursion && br.Read(1)) {
    const int precision = 2 + br.Read(3);
    const int hx = SubSampleSize(xsize, precision);
    const int hy = SubSampleSize(ysize, precision);
    std::vector<uint32_t> image;
    if (!DecodeImageStream(d, hx, hy, false, &image, nullptr, nullptr))
      return false;
    hdr.huffman_bits = precision;
    for (auto& px : image) {
      px = (px >> 8) & 0xffff;
      if (static_cast<int>(px) >= num_groups_max) num_groups_max = px + 1;
    }
    hdr.huffman_image.swap(image);
  }
  if (br.Eos()) return false;
  // every group is read and checked; libwebp keeps them all, or only the
  // ones the image uses when there are more than 1000 or than pixels
  const bool mapping =
      num_groups_max > 1000 ||
      num_groups_max > static_cast<int64_t>(xsize) * ysize;
  std::vector<char>& used = hdr.stored;
  used.assign(num_groups_max, !mapping);
  for (uint32_t g : hdr.huffman_image) used[g] = 1;
  const int max_alphabet =
      kAlphabetSize[0] + (color_cache_bits > 0 ? 1 << color_cache_bits : 0);
  std::vector<int> code_lengths(std::max(max_alphabet, 256 + 24 + 1));
  hdr.groups.assign(num_groups_max, std::array<int, 5>{0, 0, 0, 0, 0});
  for (int i = 0; i < num_groups_max; ++i) {
    for (int j = 0; j < 5; ++j) {
      int alphabet_size = kAlphabetSize[j];
      if (j == 0 && color_cache_bits > 0)
        alphabet_size += 1 << color_cache_bits;
      const int off = static_cast<int>(hdr.tables.size());
      if (!ReadHuffmanCode(d, alphabet_size, code_lengths,
                           used[i] ? &hdr.tables : nullptr))
        return false;
      hdr.groups[i][j] = off;
    }
  }
  return true;
}

bool ReadTransform(Vp8l& d, int* xsize, int ysize) {
  LBitReader& br = d.br;
  const int type = br.Read(2);
  if (d.transforms_seen & (1u << type)) return false;
  d.transforms_seen |= 1u << type;
  Transform& t = d.transforms[d.next_transform++];
  t.type = type;
  t.xsize = *xsize;
  t.ysize = ysize;
  switch (type) {
    case PREDICTOR:
    case CROSS_COLOR:
      t.bits = br.Read(3) + 2;
      return DecodeImageStream(d, SubSampleSize(t.xsize, t.bits),
                               SubSampleSize(t.ysize, t.bits), false, &t.data,
                               nullptr, nullptr);
    case COLOR_INDEXING: {
      const int num_colors = br.Read(8) + 1;
      const int bits = num_colors > 16 ? 0 : num_colors > 4 ? 1
                     : num_colors > 2 ? 2 : 3;
      *xsize = SubSampleSize(t.xsize, bits);
      t.bits = bits;
      std::vector<uint32_t> pal;
      if (!DecodeImageStream(d, num_colors, 1, false, &pal, nullptr, nullptr))
        return false;
      // the palette is delta-coded; entries past it are transparent black
      const int final_num_colors = 1 << (8 >> bits);
      t.data.assign(final_num_colors, 0);
      uint8_t* nd = reinterpret_cast<uint8_t*>(t.data.data());
      const uint8_t* od = reinterpret_cast<const uint8_t*>(pal.data());
      std::memcpy(nd, od, 4);
      for (int i = 4; i < 4 * num_colors; ++i)
        nd[i] = static_cast<uint8_t>(od[i] + nd[i - 4]);
      return true;
    }
    default:  // subtract green
      return true;
  }
}

inline int GetCopyDistance(int distance_symbol, LBitReader& br) {
  if (distance_symbol < 4) return distance_symbol + 1;
  const int extra_bits = (distance_symbol - 2) >> 1;
  const int offset = (2 + (distance_symbol & 1)) << extra_bits;
  return offset + br.Read(extra_bits) + 1;
}

inline int PlaneCodeToDistance(int xsize, int plane_code) {
  if (plane_code > kCodeToPlaneCodes) return plane_code - kCodeToPlaneCodes;
  const int dist_code = kCodeToPlane[plane_code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

// Decode the entropy-coded pixels. `tolerate_final_eos`: libwebp's 8-bit
// alpha path accepts a stream whose last symbol read past the end.
bool DecodeImageData(Vp8l& d, const Meta& hdr, uint32_t* data, int width,
                     int height, bool tolerate_final_eos) {
  LBitReader& br = d.br;
  const int cache_bits = hdr.color_cache_bits;
  std::vector<uint32_t> cache(cache_bits > 0 ? 1u << cache_bits : 0);
  const int len_code_limit = kNumLiteralCodes + kNumLengthCodes;
  const int hbits = hdr.huffman_bits;
  const int hxsize = SubSampleSize(width, hbits);
  const int64_t total = static_cast<int64_t>(width) * height;
  int64_t pos = 0, cached = 0;
  int col = 0, row = 0;
  auto group = [&](int x, int y) -> const std::array<int, 5>& {
    if (hdr.huffman_image.empty()) return hdr.groups[0];
    return hdr.groups[hdr.huffman_image[static_cast<size_t>(hxsize) *
                                            (y >> hbits) + (x >> hbits)]];
  };
  auto flush_cache = [&]() {
    if (cache_bits > 0)
      for (; cached < pos; ++cached)
        cache[(0x1e35a7bdu * data[cached]) >> (32 - cache_bits)] =
            data[cached];
  };
  const HuffmanCode* tb = hdr.tables.data();
  // libwebp stops at the first symbol read past the end; its 8-bit alpha
  // path finishes that symbol first
  const bool strict = !tolerate_final_eos;
  while (pos < total) {
    const auto& g = group(col, row);
    const int code = ReadSymbol(tb + g[GREEN], br);
    if (code < kNumLiteralCodes) {
      const int red = ReadSymbol(tb + g[RED], br);
      const int blue = ReadSymbol(tb + g[BLUE], br);
      const int alpha = ReadSymbol(tb + g[ALPHA], br);
      if (strict && br.Eos()) break;
      data[pos] = (static_cast<uint32_t>(alpha) << 24) | (red << 16) |
                  (code << 8) | blue;
      ++pos;
      if (++col >= width) {
        col = 0;
        ++row;
      }
    } else if (code < len_code_limit) {
      const int length = GetCopyDistance(code - kNumLiteralCodes, br);
      const int dist_symbol = ReadSymbol(tb + g[DIST], br);
      const int dist =
          PlaneCodeToDistance(width, GetCopyDistance(dist_symbol, br));
      if (strict && br.Eos()) break;
      if (pos < dist || total - pos < length) return false;
      for (int i = 0; i < length; ++i) data[pos + i] = data[pos + i - dist];
      pos += length;
      col += length;
      while (col >= width) {
        col -= width;
        ++row;
      }
    } else {
      if (strict && br.Eos()) break;
      flush_cache();
      data[pos] = cache[code - len_code_limit];
      ++pos;
      if (++col >= width) {
        col = 0;
        ++row;
      }
    }
    flush_cache();
    if (br.Eos()) break;
  }
  if (br.Eos()) return tolerate_final_eos && pos >= total;
  return true;
}

bool DecodeImageStream(Vp8l& d, int xsize, int ysize, bool is_level0,
                       std::vector<uint32_t>* out, Meta* level0_meta,
                       int* level0_xsize) {
  LBitReader& br = d.br;
  int transform_xsize = xsize;
  if (is_level0)
    while (br.Read(1))
      if (!ReadTransform(d, &transform_xsize, ysize)) return false;
  int color_cache_bits = 0;
  if (br.Read(1)) {
    color_cache_bits = br.Read(4);
    if (color_cache_bits < 1 || color_cache_bits > 11) return false;
  }
  Meta local;
  Meta& hdr = is_level0 ? *level0_meta : local;
  hdr.color_cache_bits = color_cache_bits;
  if (!ReadHuffmanCodes(d, transform_xsize, ysize, color_cache_bits,
                        is_level0, hdr))
    return false;
  if (is_level0) {
    *level0_xsize = transform_xsize;
    return true;
  }
  out->assign(static_cast<size_t>(transform_xsize) * ysize, 0);
  return DecodeImageData(d, hdr, out->data(), transform_xsize, ysize, false) &&
         !br.Eos();
}

// --- the inverse transforms, over the whole image

inline uint32_t AddPixels(uint32_t a, uint32_t b) {
  const uint32_t alpha_and_green = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t red_and_blue = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (alpha_and_green & 0xff00ff00u) | (red_and_blue & 0x00ff00ffu);
}
inline uint32_t Average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int Sub3(int a, int b, int c) {
  const int pb = b - c, pa = a - c;
  return std::abs(pb) - std::abs(pa);
}
inline uint32_t Select(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = Sub3(a >> 24, b >> 24, c >> 24) +
                          Sub3((a >> 16) & 0xff, (b >> 16) & 0xff,
                               (c >> 16) & 0xff) +
                          Sub3((a >> 8) & 0xff, (b >> 8) & 0xff,
                               (c >> 8) & 0xff) +
                          Sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}
inline uint32_t Clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline uint32_t ClampedAddSubtractFull(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t r = 0;
  for (int s = 0; s < 32; s += 8)
    r |= Clip255(static_cast<uint32_t>(((c0 >> s) & 0xff) + ((c1 >> s) & 0xff) -
                                       ((c2 >> s) & 0xff)))
         << s;
  return r;
}
inline uint32_t ClampedAddSubtractHalf(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = Average2(c0, c1);
  uint32_t r = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (ave >> s) & 0xff, b = (c2 >> s) & 0xff;
    r |= Clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;
  }
  return r;
}

inline uint32_t Predict(int mode, const uint32_t* left, const uint32_t* top) {
  switch (mode) {
    case 1: return *left;
    case 2: return top[0];
    case 3: return top[1];
    case 4: return top[-1];
    case 5: return Average2(Average2(*left, top[1]), top[0]);
    case 6: return Average2(*left, top[-1]);
    case 7: return Average2(*left, top[0]);
    case 8: return Average2(top[-1], top[0]);
    case 9: return Average2(top[0], top[1]);
    case 10: return Average2(Average2(*left, top[-1]),
                             Average2(top[0], top[1]));
    case 11: return Select(top[0], *left, top[-1]);
    case 12: return ClampedAddSubtractFull(*left, top[0], top[-1]);
    case 13: return ClampedAddSubtractHalf(*left, top[0], top[-1]);
    default: return 0xff000000u;  // 0, and the sentinels 14 and 15
  }
}

void InversePredictor(const Transform& t, uint32_t* px, int height) {
  const int width = t.xsize;
  // first row: black, then left
  px[0] = AddPixels(px[0], 0xff000000u);
  for (int x = 1; x < width; ++x) px[x] = AddPixels(px[x], px[x - 1]);
  const int tiles_per_row = SubSampleSize(width, t.bits);
  for (int y = 1; y < height; ++y) {
    uint32_t* out = px + static_cast<size_t>(y) * width;
    const uint32_t* modes = t.data.data() + (y >> t.bits) * tiles_per_row;
    out[0] = AddPixels(out[0], out[-width]);
    for (int x = 1; x < width; ++x) {
      const int mode = (modes[x >> t.bits] >> 8) & 0xf;
      out[x] = AddPixels(out[x], Predict(mode, out + x - 1, out + x - width));
    }
  }
}

inline int ColorTransformDelta(int8_t color_pred, int8_t color) {
  return (static_cast<int>(color_pred) * color) >> 5;
}

void InverseCrossColor(const Transform& t, uint32_t* px, int height) {
  const int width = t.xsize;
  const int tiles_per_row = SubSampleSize(width, t.bits);
  for (int y = 0; y < height; ++y) {
    uint32_t* row = px + static_cast<size_t>(y) * width;
    const uint32_t* codes = t.data.data() + (y >> t.bits) * tiles_per_row;
    for (int x = 0; x < width; ++x) {
      const uint32_t code = codes[x >> t.bits];
      const int8_t g2r = static_cast<int8_t>(code & 0xff);
      const int8_t g2b = static_cast<int8_t>((code >> 8) & 0xff);
      const int8_t r2b = static_cast<int8_t>((code >> 16) & 0xff);
      const uint32_t argb = row[x];
      const int8_t green = static_cast<int8_t>(argb >> 8);
      int new_red = (argb >> 16) & 0xff;
      int new_blue = argb & 0xff;
      new_red += ColorTransformDelta(g2r, green);
      new_red &= 0xff;
      new_blue += ColorTransformDelta(g2b, green);
      new_blue += ColorTransformDelta(r2b, static_cast<int8_t>(new_red));
      new_blue &= 0xff;
      row[x] = (argb & 0xff00ff00u) | (new_red << 16) | new_blue;
    }
  }
}

void AddGreen(uint32_t* px, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    const uint32_t argb = px[i];
    const uint32_t green = (argb >> 8) & 0xff;
    uint32_t red_blue = argb & 0x00ff00ffu;
    red_blue += (green << 16) | green;
    px[i] = (argb & 0xff00ff00u) | (red_blue & 0x00ff00ffu);
  }
}

// Decode a VP8L stream (without its 5-byte header when `headerless`, as
// ALPH carries it) of `width` x `height` to ARGB. Returns 0 or -1.
int DecodeVp8l(const uint8_t* data, size_t size, int width, int height,
               bool headerless, bool alpha_tolerant,
               std::vector<uint32_t>& out) {
  Vp8l d;
  InitLBitReader(d.br, data, size);
  if (!headerless) {
    if (d.br.Read(8) != 0x2f) return -1;
    const int w = d.br.Read(14) + 1, h = d.br.Read(14) + 1;
    d.br.Read(1);
    if (d.br.Read(3) != 0 || d.br.Eos()) return -1;
    if (w != width || h != height) return -1;
  }
  Meta hdr;
  int xsize = 0;
  if (!DecodeImageStream(d, width, height, true, nullptr, &hdr, &xsize))
    return -1;
  // libwebp decodes alpha through its 8-bit path when the only transform
  // is a palette, no color cache is used and every group's red, blue and
  // alpha codes are single symbols
  bool eight_bit = alpha_tolerant && d.next_transform == 1 &&
                   d.transforms[0].type == COLOR_INDEXING &&
                   hdr.color_cache_bits == 0;
  if (eight_bit)
    for (size_t i = 0; i < hdr.groups.size(); ++i)
      if (hdr.stored[i])
        for (int j : {RED, BLUE, ALPHA})
          if (hdr.tables[hdr.groups[i][j]].bits > 0) eight_bit = false;
  std::vector<uint32_t> px(static_cast<size_t>(xsize) * height);
  if (!DecodeImageData(d, hdr, px.data(), xsize, height, eight_bit))
    return -1;
  for (int n = d.next_transform - 1; n >= 0; --n) {
    const Transform& t = d.transforms[n];
    switch (t.type) {
      case PREDICTOR: InversePredictor(t, px.data(), height); break;
      case CROSS_COLOR: InverseCrossColor(t, px.data(), height); break;
      case SUBTRACT_GREEN: AddGreen(px.data(), px.size()); break;
      case COLOR_INDEXING: {
        const int bits_per_pixel = 8 >> t.bits;
        const int count_mask = (1 << t.bits) - 1;
        const uint32_t bit_mask = (1u << bits_per_pixel) - 1;
        const int src_w = SubSampleSize(t.xsize, t.bits);
        std::vector<uint32_t> full(static_cast<size_t>(t.xsize) * height);
        for (int y = 0; y < height; ++y) {
          const uint32_t* src = px.data() + static_cast<size_t>(y) * src_w;
          uint32_t* dst = full.data() + static_cast<size_t>(y) * t.xsize;
          uint32_t packed = 0;
          for (int x = 0; x < t.xsize; ++x) {
            if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
            dst[x] = t.data[packed & bit_mask];
            packed >>= bits_per_pixel;
          }
        }
        px.swap(full);
        break;
      }
    }
  }
  out.swap(px);
  return 0;
}

// --- ALPH: raw or VP8L-coded, then the prediction filter undone

void Unfilter(int filter, const uint8_t* prev, const uint8_t* in, uint8_t* out,
              int width) {
  if (filter == 0) {
    std::memmove(out, in, width);
    return;
  }
  if (filter == 1 || prev == nullptr) {  // horizontal, and every first row
    uint8_t pred = prev == nullptr ? 0 : prev[0];
    for (int i = 0; i < width; ++i) {
      out[i] = static_cast<uint8_t>(pred + in[i]);
      pred = out[i];
    }
  } else if (filter == 2) {  // vertical
    for (int i = 0; i < width; ++i)
      out[i] = static_cast<uint8_t>(prev[i] + in[i]);
  } else {  // gradient
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      const int g = left + top - top_left;
      const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
      left = static_cast<uint8_t>(in[i] + pred);
      top_left = top;
      out[i] = left;
    }
  }
}

}  // namespace

extern "C" {

// Decode a VP8 key frame (the chunk's payload, its padding byte included)
// into planes: y (w x h), u and v ((w+1)/2 x (h+1)/2), bit-equal to
// libwebp's WebPDecodeYUV. Returns 0, or -1 where libwebp fails.
int f101webp_vp8_yuv(const uint8_t* data, long size, int w, int h, uint8_t* y,
                     uint8_t* u, uint8_t* v) {
  Vp8 d;
  std::vector<uint8_t> Y, U, V;
  if (size < 0 || DecodeVp8(data, static_cast<size_t>(size), d, Y, U, V))
    return -1;
  if (d.width != w || d.height != h) return -1;
  const int ys = d.mb_w * 16, uvs = d.mb_w * 8, uw = (w + 1) / 2,
            uh = (h + 1) / 2;
  for (int j = 0; j < h; ++j)
    std::memcpy(y + static_cast<size_t>(j) * w, Y.data() + j * ys, w);
  for (int j = 0; j < uh; ++j) {
    std::memcpy(u + static_cast<size_t>(j) * uw, U.data() + j * uvs, uw);
    std::memcpy(v + static_cast<size_t>(j) * uw, V.data() + j * uvs, uw);
  }
  return 0;
}

// Planes as f101webp_vp8_yuv gives them -> RGB rows of `stride` bytes,
// through libwebp's fancy upsampler and converters.
void f101webp_yuv_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v,
                      int w, int h, uint8_t* rgb, long stride) {
  const int uw = (w + 1) / 2;
  UpsampleLinePair(y, nullptr, u, v, u, v, rgb, nullptr, w);
  int row = 1;
  for (; row + 1 < h; row += 2) {
    const int k = (row + 1) / 2;  // chroma row of the bottom line
    UpsampleLinePair(y + static_cast<size_t>(row) * w,
                     y + static_cast<size_t>(row + 1) * w,
                     u + static_cast<size_t>(k - 1) * uw,
                     v + static_cast<size_t>(k - 1) * uw,
                     u + static_cast<size_t>(k) * uw,
                     v + static_cast<size_t>(k) * uw, rgb + row * stride,
                     rgb + (row + 1) * stride, w);
  }
  if (row < h) {  // the last row of an even height
    const int k = (h - 1) / 2;
    UpsampleLinePair(y + static_cast<size_t>(row) * w, nullptr,
                     u + static_cast<size_t>(k) * uw,
                     v + static_cast<size_t>(k) * uw,
                     u + static_cast<size_t>(k) * uw,
                     v + static_cast<size_t>(k) * uw, rgb + row * stride,
                     nullptr, w);
  }
}

// Decode a VP8L chunk's payload (header included, padding byte included)
// of w x h into ARGB words. Returns 0, or -1 where libwebp fails.
int f101webp_vp8l_argb(const uint8_t* data, long size, int w, int h,
                       uint32_t* argb) {
  std::vector<uint32_t> out;
  if (size < 0 ||
      DecodeVp8l(data, static_cast<size_t>(size), w, h, false, false, out))
    return -1;
  std::memcpy(argb, out.data(), out.size() * sizeof(uint32_t));
  return 0;
}

// Decode an ALPH chunk's payload (its declared size) for a w x h frame into
// `alpha`. Returns 0, or -1 where libwebp fails the whole decode.
int f101webp_alpha(const uint8_t* data, long size, int w, int h,
                   uint8_t* alpha) {
  if (size <= 1) return -1;
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3,
            pre = (data[0] >> 4) & 3, rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0) return -1;
  const size_t n = static_cast<size_t>(w) * h;
  std::vector<uint8_t> deltas(n);
  if (method == 0) {
    if (static_cast<size_t>(size - 1) < n) return -1;
    std::memcpy(deltas.data(), data + 1, n);
  } else {
    std::vector<uint32_t> argb;
    if (DecodeVp8l(data + 1, static_cast<size_t>(size - 1), w, h, true, true,
                   argb))
      return -1;
    for (size_t i = 0; i < n; ++i) deltas[i] = (argb[i] >> 8) & 0xff;
  }
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    uint8_t* out = alpha + static_cast<size_t>(y) * w;
    Unfilter(filter, prev, deltas.data() + static_cast<size_t>(y) * w, out, w);
    prev = out;
  }
  return 0;
}

}  // extern "C"
