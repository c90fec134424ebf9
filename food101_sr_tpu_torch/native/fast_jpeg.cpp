// JPEG decode and encode with no library: the port's own codec, written to
// give the bytes libjpeg-turbo gives (JPEG-6b semantics: 8x8 IDCTs at scale
// 1, no DCT-scaled upsampling as in IJG libjpeg 9).
//
// Decoder: what jpeg_read_header + out_color_space = JCS_RGB +
// jpeg_start_decompress + jpeg_read_scanlines produce.
//   - markers: SOI, SOF0/SOF1/SOF2 (8-bit), DHT, DQT (8- and 16-bit
//     entries), SOS, DRI with RST0-7, COM, EOI; APPn skipped, except that
//     JFIF APP0 and Adobe APP14 (its transform flag) are read. As in
//     libjpeg-turbo, the Annex K Huffman tables stand in for tables a
//     stream does not define (motion-JPEG frames).
//   - 1 or 3 components, sampling factors 1-4 with integral ratios,
//     interleaved and non-interleaved scans, any size down to 1x1.
//   - baseline Huffman (jdhuff.c) and progressive Huffman (jdphuff.c): DC
//     first and refine, AC first and refine, EOB runs.
//   - libjpeg-turbo's jpeg_idct_islow (jidctint.c) with its range-limit
//     table, then upsampling as jdsample.c picks it with
//     do_fancy_upsampling TRUE (the triangle filters h2v1, h2v2 and h1v2,
//     replication for the other integral ratios and for components at most
//     2 samples wide), then jdcolor.c's fixed-point YCbCr -> RGB. RGB
//     against YCbCr is decided as jdapimin.c's default_decompress_parms
//     decides it: JFIF, else the Adobe transform, else the component IDs.
//   - Block smoothing: in the non-buffered mode, libjpeg reads every scan
//     of a progressive file before output, and smooths only when some of
//     the first AC coefficients are still not fully refined then. A
//     complete file from a progression script refines them all, so no
//     smoothing applies; a file whose scans leave them unrefined is
//     refused by name, and a truncated file (no EOI) is refused as
//     corrupt, instead of being decoded differently.
//   - Refused by name (return -2, message from fastjpeg_error): arithmetic
//     coding, lossless and hierarchical streams, precisions other than 8,
//     CMYK/YCCK and other component counts. A broken or truncated stream
//     returns -1. Nothing is decoded another way.
//
// Region decode: entropy-decodes every scan up to the crop's last iMCU row
// (the context row for fancy upsampling included), then runs the IDCT,
// upsampling and color conversion only for the blocks the crop and its
// one-sample context touch. Its pixels are full-decode-then-crop's by
// construction: the same functions, the same edge rules.
//
// Encoder: the bytes jpeg_set_defaults + jpeg_set_quality(q, TRUE) write
// for an RGB image: JFIF 1.01 APP0, Annex K quantization tables scaled by
// jpeg_quality_scaling and clamped to 1..255, SOF0 at 4:2:0, the Annex K
// Huffman tables, one interleaved scan, no restarts. jccolor.c's RGB ->
// YCbCr, jcsample.c's h2v2 box downsampling with its alternating bias,
// jcprepct.c's and jccoefct.c's edge padding and dummy blocks,
// jfdctint.c's ISLOW forward DCT, and jcdctmgr.c's reciprocal
// quantization (16-bit DCTELEM, as libjpeg-turbo's x86-64 builds use).
//
// Build: g++ -O3 -shared -fPIC fast_jpeg.cpp -o libfast_jpeg.so (no
// library; native/__init__.py builds it on first use into _build/).
// Every entry point keeps its state on the stack, so calls from several
// threads run in parallel (ctypes releases the GIL).

#include <algorithm>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <new>
#include <string>
#include <vector>

namespace {

// zigzag index -> natural (row-major) index; 16 extra entries so that a
// corrupt run past 63 stays inside the block (as libjpeg's table)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr long kMaxPixels = 178956970;  // PIL's decompression-bomb limit

// ---------------------------------------------------------------------------
// errors: thrown inside, turned into a return code and a message at the
// extern "C" boundary
// ---------------------------------------------------------------------------

struct Failure {
  int code;  // -1 corrupt, -2 unsupported
  std::string msg;
};

thread_local char g_error[256];

[[noreturn]] void fail(int code, const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw Failure{code, buf};
}

#define CORRUPT(...) fail(-1, __VA_ARGS__)
#define UNSUPPORTED(...) fail(-2, __VA_ARGS__)

template <class F>
int guarded(F&& body) {
  try {
    body();
    g_error[0] = 0;
    return 0;
  } catch (const Failure& f) {
    std::snprintf(g_error, sizeof g_error, "%s", f.msg.c_str());
    return f.code;
  } catch (const std::bad_alloc&) {
    std::snprintf(g_error, sizeof g_error, "out of memory");
    return -1;
  }
}

// ---------------------------------------------------------------------------
// the Annex K tables (jstdhuff.c, jcparam.c)
// ---------------------------------------------------------------------------

const uint8_t kBitsDcLum[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kBitsDcChr[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kValDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kBitsAcLum[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kValAcLum[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kBitsAcChr[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kValAcChr[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// natural order
const int kQuantLum[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kQuantChr[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// ---------------------------------------------------------------------------
// fixed-point constants (jidctint.c, jfdctint.c, jdcolor.c, jccolor.c)
// ---------------------------------------------------------------------------

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr long F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433,
               F_0_765 = 6270, F_0_899 = 7373, F_1_175 = 9633,
               F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
               F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }

constexpr int kScaleBits = 16;
constexpr long kOneHalf = 1L << (kScaleBits - 1);
inline long fix16(double x) { return static_cast<long>(x * (1L << kScaleBits) + 0.5); }

struct Tables {
  uint8_t idct_limit[1024];  // jdmaster.c's post-IDCT range limit, masked
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  long rgb_ycc[8 * 256];  // jccolor.c's rgb_ycc_tab
  Tables() {
    for (int i = 0; i < 1024; ++i) {
      // x = i as a signed 10-bit value, before the +128 offset
      int v = i < 128 ? 128 + i : i < 512 ? 255 : i < 896 ? 0 : i - 896;
      idct_limit[i] = static_cast<uint8_t>(v);
    }
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix16(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = static_cast<int>((fix16(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix16(0.71414) * x;
      cb_g[i] = -fix16(0.34414) * x + kOneHalf;
    }
    const long cbcr_offset = 128L << kScaleBits;
    for (int i = 0; i < 256; ++i) {
      rgb_ycc[i + 0 * 256] = fix16(0.29900) * i;
      rgb_ycc[i + 1 * 256] = fix16(0.58700) * i;
      rgb_ycc[i + 2 * 256] = fix16(0.11400) * i + kOneHalf;
      rgb_ycc[i + 3 * 256] = -fix16(0.16874) * i;
      rgb_ycc[i + 4 * 256] = -fix16(0.33126) * i;
      // B=>Cb and R=>Cr share this entry
      rgb_ycc[i + 5 * 256] = fix16(0.50000) * i + cbcr_offset + kOneHalf - 1;
      rgb_ycc[i + 6 * 256] = -fix16(0.41869) * i;
      rgb_ycc[i + 7 * 256] = -fix16(0.08131) * i;
    }
  }
};

const Tables& tables() {
  static const Tables t;  // thread-safe initialization
  return t;
}

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

// ---------------------------------------------------------------------------
// ISLOW inverse DCT (jidctint.c jpeg_idct_islow); the DC-only column and
// row shortcuts of the original give the same values as the full path
// ---------------------------------------------------------------------------

void idct_islow(const int16_t* in, const int* quant, uint8_t* out,
                int stride) {
  const uint8_t* limit = tables().idct_limit;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* p = in + c;
    const int* q = quant + c;
    if (!p[8] && !p[16] && !p[24] && !p[32] && !p[40] && !p[48] && !p[56]) {
      int dc = (p[0] * q[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    long z2 = p[16] * q[16], z3 = p[48] * q[48];
    long z1 = (z2 + z3) * F_0_541;
    long tmp2 = z1 + z3 * -F_1_847;
    long tmp3 = z1 + z2 * F_0_765;
    z2 = p[0] * q[0];
    z3 = p[32] * q[32];
    long tmp0 = (z2 + z3) * (1L << kConstBits);
    long tmp1 = (z2 - z3) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = p[56] * q[56];
    tmp1 = p[40] * q[40];
    tmp2 = p[24] * q[24];
    tmp3 = p[8] * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * F_1_175;
    tmp0 *= F_0_298;
    tmp1 *= F_2_053;
    tmp2 *= F_3_072;
    tmp3 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 *= -F_1_961;
    z4 *= -F_0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = static_cast<int>(descale(tmp10 + tmp3, s));
    ws[7 * 8 + c] = static_cast<int>(descale(tmp10 - tmp3, s));
    ws[1 * 8 + c] = static_cast<int>(descale(tmp11 + tmp2, s));
    ws[6 * 8 + c] = static_cast<int>(descale(tmp11 - tmp2, s));
    ws[2 * 8 + c] = static_cast<int>(descale(tmp12 + tmp1, s));
    ws[5 * 8 + c] = static_cast<int>(descale(tmp12 - tmp1, s));
    ws[3 * 8 + c] = static_cast<int>(descale(tmp13 + tmp0, s));
    ws[4 * 8 + c] = static_cast<int>(descale(tmp13 - tmp0, s));
  }
  constexpr int s2 = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    long z2 = w[2], z3 = w[6];
    long z1 = (z2 + z3) * F_0_541;
    long tmp2 = z1 + z3 * -F_1_847;
    long tmp3 = z1 + z2 * F_0_765;
    long tmp0 = (static_cast<long>(w[0]) + w[4]) * (1L << kConstBits);
    long tmp1 = (static_cast<long>(w[0]) - w[4]) * (1L << kConstBits);
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    long z4 = tmp1 + tmp3;
    long z5 = (z3 + z4) * F_1_175;
    tmp0 *= F_0_298;
    tmp1 *= F_2_053;
    tmp2 *= F_3_072;
    tmp3 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 *= -F_1_961;
    z4 *= -F_0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = limit[static_cast<int>(descale(tmp10 + tmp3, s2)) & 1023];
    o[7] = limit[static_cast<int>(descale(tmp10 - tmp3, s2)) & 1023];
    o[1] = limit[static_cast<int>(descale(tmp11 + tmp2, s2)) & 1023];
    o[6] = limit[static_cast<int>(descale(tmp11 - tmp2, s2)) & 1023];
    o[2] = limit[static_cast<int>(descale(tmp12 + tmp1, s2)) & 1023];
    o[5] = limit[static_cast<int>(descale(tmp12 - tmp1, s2)) & 1023];
    o[3] = limit[static_cast<int>(descale(tmp13 + tmp0, s2)) & 1023];
    o[4] = limit[static_cast<int>(descale(tmp13 - tmp0, s2)) & 1023];
  }
}

// ---------------------------------------------------------------------------
// Huffman decoding
// ---------------------------------------------------------------------------

constexpr int kLook = 9;  // lookahead bits of the fast table

struct Huff {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t vals[256] = {};
  int maxcode[18];
  int valoffset[18];
  uint16_t look[1 << kLook];  // (length << 8) | symbol; 0: longer code

  // jdhuff.c jpeg_make_d_derived_tbl, with its checks
  void build(const uint8_t* b, const uint8_t* v, bool dc) {
    std::memcpy(bits, b, 17);
    int huffsize[257], huffcode[257], p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (p + bits[l] > 256) CORRUPT("JPEG: bad Huffman table");
      for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
    }
    huffsize[p] = 0;
    const int n = p;
    std::memcpy(vals, v, n);
    int code = 0, si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1 << si)) CORRUPT("JPEG: bad Huffman table");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0xFFFFF;
    valoffset[17] = 0;
    std::memset(look, 0, sizeof look);
    p = 0;
    for (int l = 1; l <= kLook; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        int lo = huffcode[p] << (kLook - l), hi = (huffcode[p] + 1) << (kLook - l);
        for (int k = lo; k < hi; ++k)
          look[k] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    if (dc)
      for (int i = 0; i < n; ++i)
        if (vals[i] > 15) CORRUPT("JPEG: bad Huffman table");
    defined = true;
  }
};

// Entropy-coded bytes, with 0xFF00 unstuffed. Reaching a marker (or the
// end of the data) feeds zero bits, as libjpeg does; consuming any of them
// is a truncated or corrupt segment.
struct Bits {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int nbits = 0, pad = 0;
  bool marker = false;  // pos is at the 0xFF of the marker that ended it

  Bits(const uint8_t* data, size_t len, size_t start) : d(data), n(len), pos(start) {}

  void fill() {
    while (nbits <= 56) {
      uint32_t b = 0;
      if (!marker) {
        if (pos >= n) {
          marker = true;
        } else if (d[pos] != 0xFF) {
          b = d[pos++];
        } else {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;  // fill bytes
          if (q < n && d[q] == 0x00) {
            b = 0xFF;
            pos = q + 1;
          } else {
            marker = true;
          }
        }
      }
      if (marker) pad += 8;
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }
  void check() {
    if (nbits < pad) CORRUPT("JPEG: entropy-coded data truncated or corrupt");
  }
  int get(int k) {
    if (k == 0) return 0;
    if (nbits < k) fill();
    nbits -= k;
    check();
    return static_cast<int>((acc >> nbits) & ((1u << k) - 1));
  }
  int bit() { return get(1); }
  int decode(const Huff& h) {
    if (nbits < 16) fill();
    uint16_t e = h.look[(acc >> (nbits - kLook)) & ((1 << kLook) - 1)];
    if (e) {
      nbits -= e >> 8;
      check();
      return e & 0xFF;
    }
    int code16 = static_cast<int>((acc >> (nbits - 16)) & 0xFFFF);
    for (int l = kLook + 1; l <= 16; ++l) {
      int code = code16 >> (16 - l);
      if (code <= h.maxcode[l]) {
        nbits -= l;
        check();
        return h.vals[(code + h.valoffset[l]) & 0xFF];
      }
    }
    CORRUPT("JPEG: bad Huffman code");
  }
  void reset(size_t start) {
    pos = start;
    acc = 0;
    nbits = pad = 0;
    marker = false;
  }
};

inline int extend(int v, int s) {
  return s == 0 ? 0 : v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// Position of the next marker at or after p that ends an entropy-coded
// segment (RSTn and stuffed bytes are part of the segment); n if none.
size_t skip_entropy(const uint8_t* d, size_t n, size_t p) {
  while (p + 1 < n) {
    if (d[p] != 0xFF) {
      const void* f = std::memchr(d + p, 0xFF, n - p);
      if (!f) return n;
      p = static_cast<const uint8_t*>(f) - d;
      continue;
    }
    uint8_t b = d[p + 1];
    if (b == 0x00 || (b >= 0xD0 && b <= 0xD7)) {
      p += 2;
    } else if (b == 0xFF) {
      ++p;
    } else {
      return p;
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// the decoder
// ---------------------------------------------------------------------------

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;  // downsampled size (jdinput.c)
  int bw = 0, bh = 0;  // blocks holding samples
  int bw_alloc = 0, bh_alloc = 0;  // blocks of the interleaved MCU grid
  std::vector<int16_t> coef;
  int quant[64];
  bool latched = false;
  int dc_pred = 0;
  int coef_bits[64];
};

enum Color { kGray, kYCbCr, kRGB };
enum Up { kFull, kH2V1, kH2V2, kH1V2, kRepl };

struct Scan {
  int n = 0;
  int ci[4], td[4], ta[4];
  int ss = 0, se = 63, ah = 0, al = 0;
};

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {
    dc_[0].build(kBitsDcLum, kValDc, true);
    dc_[1].build(kBitsDcChr, kValDc, true);
    ac_[0].build(kBitsAcLum, kValAcLum, false);
    ac_[1].build(kBitsAcChr, kValAcChr, false);
    std::memset(qdef_, 0, sizeof qdef_);
  }

  // Header only: width and height from the first SOF of any kind.
  void dims(int* w, int* h) {
    size_t pos = start();
    for (;;) {
      int m = next_marker(&pos);
      if (m == 0xD9 || m == 0xDA) CORRUPT("JPEG: no frame header");
      if (is_sof(m)) {
        size_t len = seg_len(pos);
        if (len < 8) CORRUPT("JPEG: bad frame header");
        *h = (d_[pos + 3] << 8) | d_[pos + 4];
        *w = (d_[pos + 5] << 8) | d_[pos + 6];
        return;
      }
      pos += standalone(m) ? 0 : seg_len(pos);
    }
  }

  // Decode (all, or the rows the region needs) and write the region's RGB.
  void decode(int x0, int y0, int cw, int ch, uint8_t* out) {
    x0_ = x0;
    y0_ = y0;
    cw_ = cw;
    ch_ = ch;
    size_t pos = start();
    for (;;) {
      int m = next_marker(&pos);
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn: no length
      if (m == 0x01) continue;               // TEM
      if (m == 0xD8) CORRUPT("JPEG: second SOI");
      size_t len = seg_len(pos);
      const uint8_t* s = d_ + pos + 2;
      const size_t sl = len - 2;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
        read_sof(m, s, sl);
      } else if (m == 0xC3) {
        UNSUPPORTED("lossless JPEG (SOF3) is not supported");
      } else if (m >= 0xC5 && m <= 0xC7) {
        UNSUPPORTED("hierarchical JPEG (SOF%d) is not supported", m - 0xC0);
      } else if ((m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF) ||
                 m == 0xCC) {
        UNSUPPORTED("arithmetic-coded JPEG (%s) is not supported",
                    m == 0xCC ? "DAC" : m == 0xC9 ? "SOF9"
                                : m == 0xCA       ? "SOF10"
                                : m == 0xCB       ? "SOF11"
                                : m == 0xCD       ? "SOF13"
                                : m == 0xCE       ? "SOF14"
                                                  : "SOF15");
      } else if (m == 0xC4) {
        read_dht(s, sl);
      } else if (m == 0xDB) {
        read_dqt(s, sl);
      } else if (m == 0xDD) {
        if (sl < 2) CORRUPT("JPEG: bad DRI");
        restart_ = (s[0] << 8) | s[1];
      } else if (m == 0xDA) {
        pos = scan(s, sl, pos + len);
        continue;
      } else if (m == 0xE0) {
        if (sl >= 14 && !std::memcmp(s, "JFIF", 5)) jfif_ = true;
      } else if (m == 0xEE) {
        if (sl >= 12 && !std::memcmp(s, "Adobe", 5)) {
          adobe_ = true;
          adobe_transform_ = s[11];
        }
      }
      pos += len;
    }
    if (!scans_) CORRUPT("JPEG: no image data");
    if (progressive_) check_refined();
    output(out);
  }

 private:
  const uint8_t* d_;
  size_t n_;
  int qtab_[4][64];
  bool qdef_[4];
  Huff dc_[4], ac_[4];
  int restart_ = 0;
  bool sof_ = false, progressive_ = false;
  int W_ = 0, H_ = 0, ncomp_ = 0;
  Comp comp_[4];
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = 0;
  Color color_ = kYCbCr;
  bool allocated_ = false;
  int scans_ = 0;
  int limit_imcu_ = 0;  // iMCU rows to entropy-decode
  int x0_ = 0, y0_ = 0, cw_ = 0, ch_ = 0;

  static bool is_sof(int m) {
    return m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC;
  }
  static bool standalone(int m) {
    return m == 0x01 || (m >= 0xD0 && m <= 0xD7);
  }

  size_t start() {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8)
      CORRUPT("not a JPEG (no SOI marker)");
    return 2;
  }

  // Skips bytes that are not a marker (libjpeg warns and does the same)
  // and 0xFF fill bytes; returns the marker code, pos after it.
  int next_marker(size_t* pos) {
    size_t p = *pos;
    for (;;) {
      while (p < n_ && d_[p] != 0xFF) ++p;
      while (p < n_ && d_[p] == 0xFF) ++p;
      if (p >= n_) CORRUPT("JPEG: truncated (no EOI marker)");
      if (d_[p] != 0x00) break;
      ++p;  // a stuffed zero outside a scan: garbage
    }
    *pos = p + 1;
    return d_[p];
  }

  size_t seg_len(size_t pos) {
    if (pos + 2 > n_) CORRUPT("JPEG: truncated marker segment");
    size_t len = (d_[pos] << 8) | d_[pos + 1];
    if (len < 2 || pos + len > n_) CORRUPT("JPEG: truncated marker segment");
    return len;
  }

  void read_dqt(const uint8_t* s, size_t sl) {
    size_t p = 0;
    while (p < sl) {
      int pq = s[p] >> 4, tq = s[p] & 15;
      ++p;
      if (tq > 3 || pq > 1) CORRUPT("JPEG: bad DQT");
      if (p + (pq ? 128 : 64) > sl) CORRUPT("JPEG: bad DQT");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? (s[p + 2 * k] << 8) | s[p + 2 * k + 1] : s[p + k];
        // libjpeg-turbo's multiplier tables hold these as 16-bit values
        qtab_[tq][kNatural[k]] = static_cast<int16_t>(v);
      }
      p += pq ? 128 : 64;
      qdef_[tq] = true;
    }
  }

  void read_dht(const uint8_t* s, size_t sl) {
    size_t p = 0;
    while (p < sl) {
      if (p + 17 > sl) CORRUPT("JPEG: bad DHT");
      int tc = s[p] >> 4, th = s[p] & 15;
      if (tc > 1 || th > 3) CORRUPT("JPEG: bad DHT");
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += bits[l] = s[p + l];
      if (count > 256 || p + 17 + count > sl) CORRUPT("JPEG: bad DHT");
      (tc ? ac_[th] : dc_[th]).build(bits, s + p + 17, tc == 0);
      p += 17 + count;
    }
  }

  void read_sof(int m, const uint8_t* s, size_t sl) {
    if (sof_) CORRUPT("JPEG: more than one frame header");
    if (sl < 6) CORRUPT("JPEG: bad frame header");
    int prec = s[0];
    H_ = (s[1] << 8) | s[2];
    W_ = (s[3] << 8) | s[4];
    ncomp_ = s[5];
    if (prec != 8)
      UNSUPPORTED("%d-bit JPEG is not supported (8-bit samples only)", prec);
    if (W_ == 0 || H_ == 0)
      CORRUPT("JPEG: empty image or a DNL-defined height");
    if (static_cast<long>(W_) * H_ > kMaxPixels)
      CORRUPT("JPEG: %dx%d exceeds %ld pixels", W_, H_, kMaxPixels);
    if (ncomp_ == 0 || sl < 6 + 3 * static_cast<size_t>(ncomp_))
      CORRUPT("JPEG: bad frame header");
    if (ncomp_ == 4) {
      // named now; libjpeg reads the Adobe transform before the first scan
      UNSUPPORTED("CMYK or YCCK JPEG (4 components) is not supported");
    }
    if (ncomp_ != 1 && ncomp_ != 3)
      UNSUPPORTED("JPEG with %d components is not supported (1 or 3 only)",
                  ncomp_);
    for (int i = 0; i < ncomp_; ++i) {
      Comp& c = comp_[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        CORRUPT("JPEG: bad sampling factors or table number");
      for (int j = 0; j < i; ++j)
        if (comp_[j].id == c.id) CORRUPT("JPEG: duplicate component ID");
    }
    progressive_ = m == 0xC2;
    sof_ = true;
  }

  // Geometry, color space and buffers, at the first scan (libjpeg decides
  // the color space once the header up to the first SOS is read).
  void setup() {
    if (ncomp_ == 1) {
      color_ = kGray;
    } else if (jfif_) {
      color_ = kYCbCr;
    } else if (adobe_) {
      color_ = adobe_transform_ == 0 ? kRGB : kYCbCr;
    } else if (comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B') {
      color_ = kRGB;
    } else {
      color_ = kYCbCr;
    }
    hmax_ = vmax_ = 1;
    for (int i = 0; i < ncomp_; ++i) {
      hmax_ = std::max(hmax_, comp_[i].h);
      vmax_ = std::max(vmax_, comp_[i].v);
    }
    for (int i = 0; i < ncomp_; ++i)
      if (hmax_ % comp_[i].h || vmax_ % comp_[i].v)
        UNSUPPORTED("JPEG with a non-integral sampling ratio is not "
                    "supported");
    mcux_ = (W_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (H_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (int i = 0; i < ncomp_; ++i) {
      Comp& c = comp_[i];
      c.dw = static_cast<int>((static_cast<long>(W_) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>((static_cast<long>(H_) * c.v + vmax_ - 1) / vmax_);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.bw_alloc = mcux_ * c.h;
      c.bh_alloc = mcuy_ * c.v;
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    // iMCU rows the region needs: its last row, and the row below it that
    // fancy upsampling reads
    limit_imcu_ = 0;
    for (int i = 0; i < ncomp_; ++i) {
      const Comp& c = comp_[i];
      int vexp = vmax_ / c.v;
      int r = std::min((y0_ + ch_ - 1) / vexp + 1, c.dh - 1);
      limit_imcu_ = std::max(limit_imcu_, r / 8 / c.v + 1);
    }
    limit_imcu_ = std::min(limit_imcu_, mcuy_);
    for (int i = 0; i < ncomp_; ++i) {
      Comp& c = comp_[i];
      c.coef.assign(static_cast<size_t>(c.bw_alloc) *
                        std::min(c.bh_alloc, limit_imcu_ * c.v) * 64,
                    0);
    }
    allocated_ = true;
  }

  int16_t* block(Comp& c, int by, int bx) {
    return c.coef.data() + (static_cast<size_t>(by) * c.bw_alloc + bx) * 64;
  }

  // one SOS: parse, then entropy-decode; returns the position of the
  // marker that ends the scan
  size_t scan(const uint8_t* s, size_t sl, size_t data) {
    if (!sof_) CORRUPT("JPEG: scan before frame header");
    if (!allocated_) setup();
    Scan sc;
    if (sl < 1) CORRUPT("JPEG: bad scan header");
    sc.n = s[0];
    if (sc.n < 1 || sc.n > 4 || sl < 4 + 2 * static_cast<size_t>(sc.n))
      CORRUPT("JPEG: bad scan header");
    for (int i = 0; i < sc.n; ++i) {
      int id = s[1 + 2 * i], ci = -1;
      for (int j = 0; j < ncomp_; ++j)
        if (comp_[j].id == id) ci = j;
      if (ci < 0) CORRUPT("JPEG: scan names an unknown component");
      for (int j = 0; j < i; ++j)
        if (sc.ci[j] == ci) CORRUPT("JPEG: component twice in a scan");
      sc.ci[i] = ci;
      sc.td[i] = s[2 + 2 * i] >> 4;
      sc.ta[i] = s[2 + 2 * i] & 15;
      if (sc.td[i] > 3 || sc.ta[i] > 3) CORRUPT("JPEG: bad table number");
    }
    size_t p = 1 + 2 * sc.n;
    sc.ss = s[p];
    sc.se = s[p + 1];
    sc.ah = s[p + 2] >> 4;
    sc.al = s[p + 2] & 15;
    if (sc.n > 1) {
      int blocks = 0;
      for (int i = 0; i < sc.n; ++i)
        blocks += comp_[sc.ci[i]].h * comp_[sc.ci[i]].v;
      if (blocks > 10) CORRUPT("JPEG: MCU larger than 10 blocks");
    }
    if (progressive_) {
      bool bad = sc.ss == 0 ? sc.se != 0 : (sc.ss > sc.se || sc.se > 63 || sc.n != 1);
      if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
      if (sc.al > 13) bad = true;
      if (bad) CORRUPT("JPEG: bad progressive scan parameters");
    }
    for (int i = 0; i < sc.n; ++i) {
      Comp& c = comp_[sc.ci[i]];
      if (!c.latched) {  // jdinput.c latch_quant_tables
        if (!qdef_[c.tq]) CORRUPT("JPEG: quantization table not defined");
        std::memcpy(c.quant, qtab_[c.tq], sizeof c.quant);
        c.latched = true;
      }
      bool need_dc = !progressive_ || (sc.ss == 0 && sc.ah == 0);
      bool need_ac = !progressive_ || sc.ss != 0;
      if ((need_dc && !dc_[sc.td[i]].defined) ||
          (need_ac && !ac_[sc.ta[i]].defined))
        CORRUPT("JPEG: Huffman table not defined");
      if (progressive_)
        for (int k = sc.ss; k <= sc.se; ++k) c.coef_bits[k] = sc.al;
      c.dc_pred = 0;
    }
    ++scans_;
    Bits br(d_, n_, data);
    decode_scan(sc, br);
    return br.marker ? br.pos : skip_entropy(d_, n_, br.pos);
  }

  // jdhuff.c process_restart: drop the bits left, read RSTn (bytes before
  // it are skipped, as libjpeg does with a warning); a missing or
  // out-of-sequence marker is corrupt data
  void restart(Bits& br, int* next) {
    size_t p = br.pos;
    if (!br.marker)
      while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0x00 &&
                             d_[p + 1] != 0xFF))
        ++p;
    while (p < n_ && d_[p] == 0xFF) ++p;
    if (p >= n_ || d_[p] != 0xD0 + *next)
      CORRUPT("JPEG: restart marker missing or out of sequence");
    br.reset(p + 1);
    *next = (*next + 1) & 7;
  }

  void decode_scan(const Scan& sc, Bits& br) {
    int togo = restart_, next_rst = 0, eobrun = 0;
    auto mcu_start = [&]() {
      if (!restart_) return;
      if (togo == 0) {
        restart(br, &next_rst);
        for (int i = 0; i < sc.n; ++i) comp_[sc.ci[i]].dc_pred = 0;
        eobrun = 0;
        togo = restart_;
      }
      --togo;
    };
    auto one = [&](int i, int16_t* blk) {
      Comp& c = comp_[sc.ci[i]];
      if (!progressive_)
        seq_block(br, c, dc_[sc.td[i]], ac_[sc.ta[i]], blk);
      else if (sc.ss == 0)
        dc_block(br, c, dc_[sc.td[i]], sc, blk);
      else if (sc.ah == 0)
        ac_first(br, ac_[sc.ta[i]], sc, blk, &eobrun);
      else
        ac_refine(br, ac_[sc.ta[i]], sc, blk, &eobrun);
    };
    if (sc.n == 1) {
      Comp& c = comp_[sc.ci[0]];
      int rows = std::min(c.bh, limit_imcu_ * c.v);
      for (int by = 0; by < rows; ++by)
        for (int bx = 0; bx < c.bw; ++bx) {
          mcu_start();
          one(0, block(c, by, bx));
        }
    } else {
      int rows = std::min(mcuy_, limit_imcu_);
      for (int my = 0; my < rows; ++my)
        for (int mx = 0; mx < mcux_; ++mx) {
          mcu_start();
          for (int i = 0; i < sc.n; ++i) {
            Comp& c = comp_[sc.ci[i]];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x)
                one(i, block(c, my * c.v + y, mx * c.h + x));
          }
        }
    }
  }

  // repeated extreme differences would overflow the predictor; libjpeg-turbo
  // refuses them as a bad coefficient
  static void add_dc(Comp& c, int diff) {
    long v = static_cast<long>(c.dc_pred) + diff;
    if (v > INT32_MAX || v < INT32_MIN) CORRUPT("JPEG: DC coefficient out of range");
    c.dc_pred = static_cast<int>(v);
  }

  // jdhuff.c decode_mcu, one block
  void seq_block(Bits& br, Comp& c, const Huff& dct, const Huff& act,
                 int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    int s = br.decode(dct);
    add_dc(c, extend(br.get(s), s));
    blk[0] = static_cast<int16_t>(c.dc_pred);
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // jdphuff.c decode_mcu_DC_first / decode_mcu_DC_refine, one block
  void dc_block(Bits& br, Comp& c, const Huff& dct, const Scan& sc,
                int16_t* blk) {
    if (sc.ah == 0) {
      int s = br.decode(dct);
      add_dc(c, extend(br.get(s), s));
      blk[0] = static_cast<int16_t>(c.dc_pred * (1 << sc.al));
    } else if (br.bit()) {
      blk[0] = static_cast<int16_t>(blk[0] | (1 << sc.al));
    }
  }

  // jdphuff.c decode_mcu_AC_first, one block
  void ac_first(Bits& br, const Huff& act, const Scan& sc, int16_t* blk,
                int* eobrun) {
    if (*eobrun > 0) {
      --*eobrun;
      return;
    }
    for (int k = sc.ss; k <= sc.se; ++k) {
      int rs = br.decode(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] =
            static_cast<int16_t>(extend(br.get(s), s) * (1 << sc.al));
      } else if (r == 15) {
        k += 15;
      } else {
        *eobrun = 1 << r;
        if (r) *eobrun += br.get(r);
        --*eobrun;
        break;
      }
    }
  }

  // jdphuff.c decode_mcu_AC_refine, one block
  void ac_refine(Bits& br, const Huff& act, const Scan& sc, int16_t* blk,
                 int* eobrun) {
    const int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);
    int k = sc.ss;
    auto correct = [&](int16_t* coef) {
      if (br.bit() && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
    };
    if (*eobrun == 0) {
      for (; k <= sc.se; ++k) {
        int rs = br.decode(act);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          // a newly nonzero coefficient has size 1 (libjpeg warns otherwise)
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          *eobrun = 1 << r;
          if (r) *eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= sc.se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (*eobrun > 0) {
      for (; k <= sc.se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      --*eobrun;
    }
  }

  // libjpeg smooths (jdcoefct.c smoothing_ok) when a component's DC is
  // known and one of its first AC coefficients is not fully refined
  void check_refined() {
    for (int i = 0; i < ncomp_; ++i) {
      const Comp& c = comp_[i];
      if (c.coef_bits[0] < 0) continue;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0)
          UNSUPPORTED("progressive JPEG whose scans leave coefficient %d "
                      "of component %d unrefined is not supported (libjpeg "
                      "would block-smooth it)", k, c.id);
    }
  }

  // --- output: IDCT of the blocks the region needs, upsampling, color ---

  struct Plane {
    Up up;
    int hexp, vexp;
    int r0, c0;  // component coordinates of the plane's first sample
    int stride;
    std::vector<uint8_t> px;
    const uint8_t* at(int r, int c) const {
      return px.data() + static_cast<size_t>(r - r0) * stride + (c - c0);
    }
  };

  void make_plane(Comp& c, Plane& pl) {
    pl.hexp = hmax_ / c.h;
    pl.vexp = vmax_ / c.v;
    const int he = pl.hexp, ve = pl.vexp;
    if (he == 1 && ve == 1)
      pl.up = kFull;
    else if (he == 2 && ve == 1)
      pl.up = c.dw > 2 ? kH2V1 : kRepl;
    else if (he == 1 && ve == 2)
      pl.up = kH1V2;
    else if (he == 2 && ve == 2)
      pl.up = c.dw > 2 ? kH2V2 : kRepl;
    else
      pl.up = kRepl;
    const bool hctx = pl.up == kH2V1 || pl.up == kH2V2;
    const bool vctx = pl.up == kH2V2 || pl.up == kH1V2;
    int rlo = y0_ / ve, rhi = (y0_ + ch_ - 1) / ve;
    int clo = x0_ / he, chi = (x0_ + cw_ - 1) / he;
    if (vctx) rlo = std::max(rlo - 1, 0), rhi = std::min(rhi + 1, c.dh - 1);
    if (hctx) clo = std::max(clo - 1, 0), chi = std::min(chi + 1, c.dw - 1);
    const int br0 = rlo / 8, br1 = rhi / 8, bc0 = clo / 8, bc1 = chi / 8;
    pl.r0 = br0 * 8;
    pl.c0 = bc0 * 8;
    pl.stride = (bc1 - bc0 + 1) * 8;
    pl.px.resize(static_cast<size_t>(br1 - br0 + 1) * 8 * pl.stride);
    for (int by = br0; by <= br1; ++by)
      for (int bx = bc0; bx <= bc1; ++bx)
        idct_islow(block(c, by, bx), c.quant,
                   pl.px.data() + static_cast<size_t>(by - br0) * 8 * pl.stride +
                       (bx - bc0) * 8,
                   pl.stride);
  }

  // one output row of one component over the region's columns
  void upsample_row(const Comp& c, const Plane& pl, int y, uint8_t* o) {
    const int x0 = x0_, n = cw_;
    const int last = c.dw - 1;
    switch (pl.up) {
      case kFull: {
        std::memcpy(o, pl.at(y, x0), n);
        return;
      }
      case kRepl: {
        const uint8_t* row = pl.at(y / pl.vexp, pl.c0);
        for (int i = 0; i < n; ++i) o[i] = row[(x0 + i) / pl.hexp - pl.c0];
        return;
      }
      case kH2V1: {
        const uint8_t* row = pl.at(y, pl.c0);
        for (int i = 0; i < n; ++i) {
          int x = x0 + i, j = x >> 1;
          int v3 = 3 * row[j - pl.c0];
          o[i] = (x & 1) ? static_cast<uint8_t>((v3 + row[std::min(j + 1, last) - pl.c0] + 2) >> 2)
                         : static_cast<uint8_t>((v3 + row[std::max(j - 1, 0) - pl.c0] + 1) >> 2);
        }
        return;
      }
      case kH1V2: {
        int r = y >> 1, rn = (y & 1) ? std::min(r + 1, c.dh - 1) : std::max(r - 1, 0);
        int bias = (y & 1) ? 2 : 1;
        const uint8_t* a = pl.at(r, x0);
        const uint8_t* b = pl.at(rn, x0);
        for (int i = 0; i < n; ++i)
          o[i] = static_cast<uint8_t>((3 * a[i] + b[i] + bias) >> 2);
        return;
      }
      case kH2V2: {
        int r = y >> 1, rn = (y & 1) ? std::min(r + 1, c.dh - 1) : std::max(r - 1, 0);
        const uint8_t* a = pl.at(r, pl.c0);
        const uint8_t* b = pl.at(rn, pl.c0);
        auto cs = [&](int j) { return 3 * a[j - pl.c0] + b[j - pl.c0]; };
        for (int i = 0; i < n; ++i) {
          int x = x0 + i, j = x >> 1;
          int t = 3 * cs(j);
          o[i] = (x & 1) ? static_cast<uint8_t>((t + cs(std::min(j + 1, last)) + 7) >> 4)
                         : static_cast<uint8_t>((t + cs(std::max(j - 1, 0)) + 8) >> 4);
        }
        return;
      }
    }
  }

  void output(uint8_t* out) {
    Plane pl[3];
    for (int i = 0; i < ncomp_; ++i) make_plane(comp_[i], pl[i]);
    const Tables& t = tables();
    std::vector<uint8_t> rows(static_cast<size_t>(3) * cw_);
    uint8_t* r0 = rows.data();
    uint8_t* r1 = r0 + cw_;
    uint8_t* r2 = r1 + cw_;
    for (int yy = 0; yy < ch_; ++yy) {
      const int y = y0_ + yy;
      uint8_t* o = out + static_cast<size_t>(yy) * cw_ * 3;
      upsample_row(comp_[0], pl[0], y, r0);
      if (color_ == kGray) {
        for (int i = 0; i < cw_; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = r0[i];
        continue;
      }
      upsample_row(comp_[1], pl[1], y, r1);
      upsample_row(comp_[2], pl[2], y, r2);
      if (color_ == kRGB) {
        for (int i = 0; i < cw_; ++i) {
          o[3 * i] = r0[i];
          o[3 * i + 1] = r1[i];
          o[3 * i + 2] = r2[i];
        }
        continue;
      }
      for (int i = 0; i < cw_; ++i) {
        int yv = r0[i], cb = r1[i], cr = r2[i];
        o[3 * i] = clamp255(yv + t.cr_r[cr]);
        o[3 * i + 1] = clamp255(
            yv + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> kScaleBits));
        o[3 * i + 2] = clamp255(yv + t.cb_b[cb]);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// the encoder
// ---------------------------------------------------------------------------

struct EHuff {
  unsigned code[256];
  int size[256];
  // jchuff.c jpeg_make_c_derived_tbl
  EHuff(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof size);
    int huffsize[257], huffcode[257], p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) huffsize[p++] = l;
    huffsize[p] = 0;
    const int n = p;
    unsigned c = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = c++;
      c <<= 1;
      ++si;
    }
    for (int i = 0; i < n; ++i) {
      code[vals[i]] = huffcode[i];
      size[vals[i]] = huffsize[i];
    }
  }
};

class Writer {
 public:
  explicit Writer(std::vector<uint8_t>& out) : out_(out) {}
  void byte(int b) { out_.push_back(static_cast<uint8_t>(b)); }
  void u16(int v) {
    byte(v >> 8);
    byte(v & 0xFF);
  }
  void marker(int m) {
    byte(0xFF);
    byte(m);
  }
  // entropy-coded bits, 0xFF stuffed with 0x00
  void bits(unsigned code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1));
    n_ += size;
    while (n_ >= 8) {
      int b = static_cast<int>((acc_ >> (n_ - 8)) & 0xFF);
      byte(b);
      if (b == 0xFF) byte(0);
      n_ -= 8;
    }
  }
  void flush() {  // pad the last byte with 1-bits (jchuff.c flush_bits)
    if (n_ > 0) bits(0x7F, 8 - n_);
    acc_ = 0;
    n_ = 0;
  }

 private:
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int n_ = 0;
};

// jfdctint.c jpeg_fdct_islow
void fdct_islow(int* data) {
  for (int r = 0; r < 8; ++r) {
    int* p = data + r * 8;
    long tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    long tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    long tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    long tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = static_cast<int>((tmp10 - tmp11) * (1 << kPass1Bits));
    long z1 = (tmp12 + tmp13) * F_0_541;
    constexpr int s = kConstBits - kPass1Bits;
    p[2] = static_cast<int>(descale(z1 + tmp13 * F_0_765, s));
    p[6] = static_cast<int>(descale(z1 + tmp12 * -F_1_847, s));
    z1 = tmp4 + tmp7;
    long z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    long z5 = (z3 + z4) * F_1_175;
    tmp4 *= F_0_298;
    tmp5 *= F_2_053;
    tmp6 *= F_3_072;
    tmp7 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 *= -F_1_961;
    z4 *= -F_0_390;
    z3 += z5;
    z4 += z5;
    p[7] = static_cast<int>(descale(tmp4 + z1 + z3, s));
    p[5] = static_cast<int>(descale(tmp5 + z2 + z4, s));
    p[3] = static_cast<int>(descale(tmp6 + z2 + z3, s));
    p[1] = static_cast<int>(descale(tmp7 + z1 + z4, s));
  }
  for (int c = 0; c < 8; ++c) {
    int* p = data + c;
    long tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    long tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    long tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    long tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int>(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = static_cast<int>(descale(tmp10 - tmp11, kPass1Bits));
    long z1 = (tmp12 + tmp13) * F_0_541;
    constexpr int s = kConstBits + kPass1Bits;
    p[16] = static_cast<int>(descale(z1 + tmp13 * F_0_765, s));
    p[48] = static_cast<int>(descale(z1 + tmp12 * -F_1_847, s));
    z1 = tmp4 + tmp7;
    long z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    long z5 = (z3 + z4) * F_1_175;
    tmp4 *= F_0_298;
    tmp5 *= F_2_053;
    tmp6 *= F_3_072;
    tmp7 *= F_1_501;
    z1 *= -F_0_899;
    z2 *= -F_2_562;
    z3 *= -F_1_961;
    z4 *= -F_0_390;
    z3 += z5;
    z4 += z5;
    p[56] = static_cast<int>(descale(tmp4 + z1 + z3, s));
    p[40] = static_cast<int>(descale(tmp5 + z2 + z4, s));
    p[24] = static_cast<int>(descale(tmp6 + z2 + z3, s));
    p[8] = static_cast<int>(descale(tmp7 + z1 + z4, s));
  }
}

// jcdctmgr.c compute_reciprocal with a 16-bit DCTELEM
struct Divisor {
  unsigned recip, corr;
  int shift;
};

Divisor reciprocal(unsigned divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  unsigned fq = (1u << r) / divisor, fr = (1u << r) % divisor;
  unsigned c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r};
}

class Encoder {
 public:
  Encoder(const uint8_t* rgb, int w, int h, int quality)
      : rgb_(rgb), w_(w), h_(h) {
    if (quality < 1) quality = 1;
    if (quality > 100) quality = 100;
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int k = 0; k < 64; ++k) {
      qt_[0][k] = scaled(kQuantLum[k], scale);
      qt_[1][k] = scaled(kQuantChr[k], scale);
      div_[0][k] = reciprocal(qt_[0][k] << 3);
      div_[1][k] = reciprocal(qt_[1][k] << 3);
    }
  }

  void encode(std::vector<uint8_t>& out) {
    planes();
    Writer wr(out);
    wr.marker(0xD8);
    // JFIF APP0, version 1.01, aspect 1:1 without units, no thumbnail
    wr.marker(0xE0);
    wr.u16(16);
    for (char ch : {'J', 'F', 'I', 'F', '\0'}) wr.byte(ch);
    for (int b : {1, 1, 0, 0, 1, 0, 1, 0, 0}) wr.byte(b);
    for (int t = 0; t < 2; ++t) {
      wr.marker(0xDB);
      wr.u16(67);
      wr.byte(t);
      for (int k = 0; k < 64; ++k) wr.byte(qt_[t][kNatural[k]]);
    }
    wr.marker(0xC0);
    wr.u16(17);
    wr.byte(8);
    wr.u16(h_);
    wr.u16(w_);
    wr.byte(3);
    for (int b : {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1}) wr.byte(b);
    dht(wr, 0x00, kBitsDcLum, kValDc);
    dht(wr, 0x10, kBitsAcLum, kValAcLum);
    dht(wr, 0x01, kBitsDcChr, kValDc);
    dht(wr, 0x11, kBitsAcChr, kValAcChr);
    wr.marker(0xDA);
    wr.u16(12);
    for (int b : {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0}) wr.byte(b);
    scan(wr);
    wr.flush();
    wr.marker(0xD9);
  }

 private:
  const uint8_t* rgb_;
  int w_, h_;
  int qt_[2][64];
  Divisor div_[2][64];
  // Y at (ybw * 8) x (ybh * 8); Cb, Cr downsampled at (cbw * 8) x (cbh * 8)
  int ybw_ = 0, ybh_ = 0, cbw_ = 0, cbh_ = 0, mcux_ = 0, mcuy_ = 0;
  std::vector<uint8_t> y_, cb_, cr_;

  static int scaled(int basic, int scale) {
    long t = (static_cast<long>(basic) * scale + 50) / 100;
    if (t <= 0) t = 1;
    if (t > 32767) t = 32767;
    if (t > 255) t = 255;  // force_baseline
    return static_cast<int>(t);
  }

  static void dht(Writer& wr, int index, const uint8_t* bits,
                  const uint8_t* vals) {
    int n = 0;
    for (int l = 1; l <= 16; ++l) n += bits[l];
    wr.marker(0xC4);
    wr.u16(n + 2 + 1 + 16);
    wr.byte(index);
    for (int l = 1; l <= 16; ++l) wr.byte(bits[l]);
    for (int i = 0; i < n; ++i) wr.byte(vals[i]);
  }

  // color conversion, edge padding and downsampling (jccolor.c,
  // jcprepct.c, jcsample.c)
  void planes() {
    ybw_ = (w_ + 7) / 8;
    ybh_ = (h_ + 7) / 8;
    cbw_ = (w_ + 15) / 16;
    cbh_ = (h_ + 15) / 16;
    mcux_ = cbw_;
    mcuy_ = cbh_;
    const int yw = ybw_ * 8, yh = ybh_ * 8;
    const int fw = cbw_ * 16, fh = h_ + (h_ & 1);  // full-res chroma extent
    const long* tab = tables().rgb_ycc;
    y_.resize(static_cast<size_t>(yw) * yh);
    std::vector<uint8_t> fcb(static_cast<size_t>(fw) * fh), fcr(fcb.size());
    for (int r = 0; r < h_; ++r) {
      const uint8_t* in = rgb_ + static_cast<size_t>(r) * w_ * 3;
      uint8_t* yo = y_.data() + static_cast<size_t>(r) * yw;
      uint8_t* bo = fcb.data() + static_cast<size_t>(r) * fw;
      uint8_t* ro = fcr.data() + static_cast<size_t>(r) * fw;
      for (int x = 0; x < w_; ++x) {
        int R = in[3 * x], G = in[3 * x + 1], B = in[3 * x + 2];
        yo[x] = static_cast<uint8_t>((tab[R] + tab[G + 256] + tab[B + 512]) >> kScaleBits);
        bo[x] = static_cast<uint8_t>((tab[R + 768] + tab[G + 1024] + tab[B + 1280]) >> kScaleBits);
        ro[x] = static_cast<uint8_t>((tab[R + 1280] + tab[G + 1536] + tab[B + 1792]) >> kScaleBits);
      }
      for (int x = w_; x < yw; ++x) yo[x] = yo[w_ - 1];
      for (int x = w_; x < fw; ++x) bo[x] = bo[w_ - 1], ro[x] = ro[w_ - 1];
    }
    for (int r = h_; r < yh; ++r)
      std::memcpy(y_.data() + static_cast<size_t>(r) * yw,
                  y_.data() + static_cast<size_t>(h_ - 1) * yw, yw);
    if (fh > h_) {
      std::memcpy(fcb.data() + static_cast<size_t>(h_) * fw,
                  fcb.data() + static_cast<size_t>(h_ - 1) * fw, fw);
      std::memcpy(fcr.data() + static_cast<size_t>(h_) * fw,
                  fcr.data() + static_cast<size_t>(h_ - 1) * fw, fw);
    }
    down(fcb, fw, fh, cb_);
    down(fcr, fw, fh, cr_);
  }

  // h2v2_downsample, then the bottom padded to the block rows by
  // replicating the last row
  void down(const std::vector<uint8_t>& f, int fw, int fh,
            std::vector<uint8_t>& o) {
    const int ow = cbw_ * 8, oh = cbh_ * 8, rows = fh / 2;
    o.resize(static_cast<size_t>(ow) * oh);
    for (int r = 0; r < rows; ++r) {
      const uint8_t* a = f.data() + static_cast<size_t>(2 * r) * fw;
      const uint8_t* b = a + fw;
      uint8_t* out = o.data() + static_cast<size_t>(r) * ow;
      int bias = 1;
      for (int x = 0; x < ow; ++x) {
        out[x] = static_cast<uint8_t>(
            (a[2 * x] + a[2 * x + 1] + b[2 * x] + b[2 * x + 1] + bias) >> 2);
        bias ^= 3;
      }
    }
    for (int r = rows; r < oh; ++r)
      std::memcpy(o.data() + static_cast<size_t>(r) * ow,
                  o.data() + static_cast<size_t>(rows - 1) * ow, ow);
  }

  void fdct_quant(const std::vector<uint8_t>& pl, int stride, int by, int bx,
                  int t, int16_t* coef) {
    int ws[64];
    const uint8_t* p = pl.data() + static_cast<size_t>(by) * 8 * stride + bx * 8;
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) ws[r * 8 + c] = p[r * stride + c] - 128;
    fdct_islow(ws);
    for (int k = 0; k < 64; ++k) {
      const Divisor& dv = div_[t][k];
      int v = ws[k];
      bool neg = v < 0;
      unsigned a = static_cast<unsigned>(neg ? -v : v);
      unsigned q = static_cast<unsigned>(
          (static_cast<uint64_t>(a + dv.corr) * dv.recip) >> dv.shift);
      coef[k] = static_cast<int16_t>(neg ? -static_cast<int>(q) : static_cast<int>(q));
    }
  }

  static void block(Writer& wr, const int16_t* c, int* last_dc,
                    const EHuff& dc, const EHuff& ac) {
    int temp = c[0] - *last_dc, temp2 = temp;
    *last_dc = c[0];
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    int nbits = 0;
    while (temp) {
      ++nbits;
      temp >>= 1;
    }
    wr.bits(dc.code[nbits], dc.size[nbits]);
    if (nbits) wr.bits(static_cast<unsigned>(temp2), nbits);
    int r = 0;
    for (int k = 1; k < 64; ++k) {
      temp = c[kNatural[k]];
      if (temp == 0) {
        ++r;
        continue;
      }
      while (r > 15) {
        wr.bits(ac.code[0xF0], ac.size[0xF0]);
        r -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        --temp2;
      }
      nbits = 1;
      while ((temp >>= 1)) ++nbits;
      int i = (r << 4) + nbits;
      wr.bits(ac.code[i], ac.size[i]);
      wr.bits(static_cast<unsigned>(temp2), nbits);
      r = 0;
    }
    if (r > 0) wr.bits(ac.code[0], ac.size[0]);
  }

  // jccoefct.c compress_data: the MCU grid, with dummy blocks (zero AC,
  // the DC of the block before) right of and below the image's blocks
  void scan(Writer& wr) {
    static const EHuff dc_lum(kBitsDcLum, kValDc), ac_lum(kBitsAcLum, kValAcLum),
        dc_chr(kBitsDcChr, kValDc), ac_chr(kBitsAcChr, kValAcChr);
    int last[3] = {0, 0, 0};
    int16_t mcu[6][64];
    const int last_col_width = ybw_ % 2 ? 1 : 2;
    const int last_row_height = ybh_ % 2 ? 1 : 2;
    for (int my = 0; my < mcuy_; ++my) {
      for (int mx = 0; mx < mcux_; ++mx) {
        int blockcnt = mx < mcux_ - 1 ? 2 : last_col_width;
        for (int yi = 0; yi < 2; ++yi) {
          int16_t* row = mcu[2 * yi];
          if (my < mcuy_ - 1 || yi < last_row_height) {
            for (int bi = 0; bi < blockcnt; ++bi)
              fdct_quant(y_, ybw_ * 8, 2 * my + yi, 2 * mx + bi, 0, row + 64 * bi);
            for (int bi = blockcnt; bi < 2; ++bi) {
              std::memset(row + 64 * bi, 0, 64 * sizeof(int16_t));
              row[64 * bi] = row[64 * (bi - 1)];
            }
          } else {
            for (int bi = 0; bi < 2; ++bi) {
              std::memset(row + 64 * bi, 0, 64 * sizeof(int16_t));
              row[64 * bi] = mcu[2 * yi - 1][0];
            }
          }
        }
        fdct_quant(cb_, cbw_ * 8, my, mx, 1, mcu[4]);
        fdct_quant(cr_, cbw_ * 8, my, mx, 1, mcu[5]);
        for (int b = 0; b < 4; ++b) block(wr, mcu[b], &last[0], dc_lum, ac_lum);
        block(wr, mcu[4], &last[1], dc_chr, ac_chr);
        block(wr, mcu[5], &last[2], dc_chr, ac_chr);
      }
    }
  }
};

}  // namespace

extern "C" {

// The message of this thread's last failed call ("" after a success).
const char* fastjpeg_error(void) { return g_error; }

// Header-only probe: width and height from the frame header. 0 on
// success, -1 if no frame header parses.
int fastjpeg_dims(const unsigned char* buf, long len, int* w, int* h) {
  return guarded([&] {
    Decoder(buf, static_cast<size_t>(len)).dims(w, h);
  }) == 0 ? 0 : -1;
}

// Full decode to tightly packed RGB8; out must hold w*h*3 bytes (probe
// with fastjpeg_dims first). 0 on success (w, h filled), -1 for a broken
// or truncated stream, -2 for one this codec refuses by name.
int fastjpeg_decode_rgb8(const unsigned char* buf, long len,
                         unsigned char* out, long out_cap, int* w, int* h) {
  return guarded([&] {
    int W = 0, H = 0;
    Decoder(buf, static_cast<size_t>(len)).dims(&W, &H);
    if (static_cast<long>(W) * H * 3 > out_cap)
      CORRUPT("JPEG: output buffer too small");
    Decoder(buf, static_cast<size_t>(len)).decode(0, 0, W, H, out);
    *w = W;
    *h = H;
  });
}

// Region decode: exactly the pixels [y0, y0+ch) x [x0, x0+cw) of the full
// decode, decoding only the iMCU rows and blocks the region needs. 0 on
// success, -1 or -2 as above, -3 when the region is not inside the image.
int fastjpeg_decode_crop_rgb8(const unsigned char* buf, long len, int x0,
                              int y0, int cw, int ch, unsigned char* out,
                              long out_cap) {
  int W = 0, H = 0;
  int rc = guarded([&] { Decoder(buf, static_cast<size_t>(len)).dims(&W, &H); });
  if (rc) return rc;
  if (x0 < 0 || y0 < 0 || cw <= 0 || ch <= 0 || x0 + cw > W || y0 + ch > H ||
      static_cast<long>(cw) * ch * 3 > out_cap) {
    std::snprintf(g_error, sizeof g_error, "region outside the image");
    return -3;
  }
  return guarded([&] {
    Decoder(buf, static_cast<size_t>(len)).decode(x0, y0, cw, ch, out);
  });
}

// Encode tightly packed RGB8 at quality 1..100 (clamped). Returns the
// bytes written, or -1 on bad arguments or when out_cap is too small.
long fastjpeg_encode_rgb8(const unsigned char* rgb, int w, int h, int quality,
                          unsigned char* out, long out_cap) {
  if (!rgb || !out || w <= 0 || h <= 0 || w > 65535 || h > 65535) return -1;
  std::vector<uint8_t> bytes;
  int rc = guarded([&] {
    bytes.reserve(static_cast<size_t>(w) * h / 2 + 1024);
    Encoder(rgb, w, h, quality).encode(bytes);
  });
  if (rc || static_cast<long>(bytes.size()) > out_cap) return -1;
  std::memcpy(out, bytes.data(), bytes.size());
  return static_cast<long>(bytes.size());
}

}  // extern "C"
