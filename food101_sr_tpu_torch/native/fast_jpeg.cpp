// JPEG decode and encode with no library: the port's own codec, written to
// give the bytes libjpeg-turbo gives (JPEG-6b semantics: 8x8 IDCTs at scale
// 1, no DCT-scaled upsampling as in IJG libjpeg 9).
//
// Decoder: what jpeg_read_header + out_color_space = JCS_RGB +
// jpeg_start_decompress + jpeg_read_scanlines produce, in two modes (Mode
// below): the JAX package's libjpeg-turbo 2.1 binding, and PIL's
// libjpeg-turbo 3.1 (its server's decode, and its binding's fallback).
//   - markers: SOI, SOF0/1/2 (Huffman), SOF9/10 (arithmetic), SOF3
//     (lossless), DHT, DAC, DQT (8- and 16-bit entries), SOS, DRI with
//     RST0-7, COM, DNL, EOI; APPn skipped, except that JFIF APP0 and Adobe
//     APP14 (its transform flag) are read; other markers are an error, as
//     in libjpeg. As in libjpeg-turbo, the Annex K Huffman tables stand in
//     for tables a stream does not define (motion-JPEG frames).
//   - 1, 3 or 4 components, sampling factors 1-4 with integral ratios,
//     interleaved and non-interleaved scans, any size down to 1x1.
//   - baseline Huffman (jdhuff.c), progressive Huffman (jdphuff.c),
//     arithmetic coding sequential and progressive (jdarith.c: the
//     QM-decoder, its statistics bins, DAC conditioning, restart resets),
//     lossless Huffman (libjpeg-turbo 3's jdlhuff.c, jddiffct.c, jdpred.c:
//     predictors 1-7, point transform, restarts; PIL's only).
//   - the ISLOW IDCT as libjpeg-turbo's x86-64 SIMD runs it (16-bit lanes:
//     jidctint.c's values on valid data, libjpeg-turbo's on the garbage a
//     truncated stream decodes to), then upsampling as jdsample.c picks it
//     with do_fancy_upsampling TRUE (the triangle filters h2v1, h2v2 and
//     h1v2, replication for the other integral ratios, for components at
//     most 2 samples wide and for lossless), then jdcolor.c's fixed-point
//     YCbCr -> RGB, or YCCK -> CMYK and PIL's inverted CMYK -> RGB. The
//     color space is decided as jdapimin.c's default_decompress_parms
//     decides it: JFIF, else the Adobe transform, else the component IDs.
//   - Block smoothing (jdcoefct.c decompress_smooth_data) where a
//     progressive stream leaves one of the first AC coefficients
//     unrefined: libjpeg-turbo 2.1's in the binding's mode, 3.1's (the
//     neighbours' DC values clamped at the component's edges) in PIL's.
//   - Truncated and corrupt data as libjpeg meets it: the binding's input
//     ends in fake EOI markers (jpeg_mem_src), a marker inside the
//     entropy-coded data feeds zero bits and leaves the following MCUs
//     alone until a restart marker is found (jpeg_resync_to_restart), a
//     bad Huffman code decodes as 0. PIL's mode refuses a stream that
//     ends before its EOI where its load() does: PIL feeds libjpeg 64 KiB
//     blocks and raises when a suspended decoder finds the file at its
//     end, so a sequential single-scan image decodes when libjpeg-turbo's
//     reader never asks for a byte past the end (replayed by PilFeed), and
//     an arithmetic-coded scan fails where it needs a byte past the block
//     it was fed (jdarith.c cannot suspend).
//   - Refused by name (return -2, message from fastjpeg_error):
//     hierarchical and arithmetic lossless streams, precisions other than
//     8, component counts other than 1, 3 and 4; the JAX package refuses
//     them too. A broken stream returns -1. Nothing is decoded another
//     way.
//
// Region decode: entropy-decodes every scan up to the crop's last iMCU row
// (the context rows of fancy upsampling and block smoothing included),
// then runs the IDCT, upsampling and color conversion only for the blocks
// the crop and its context touch: the same functions and edge rules as the
// full decode, so its pixels are full-decode-then-crop's, except that
// block smoothing starts at jpeg_crop_scanline's first iMCU column, as in
// libjpeg's region decode, and a single-scan image's markers after the
// scan are not read. 4-component and lossless streams, which the JAX
// package's loader hands to PIL, decode as PIL's full decode cropped.
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
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  long rgb_ycc[8 * 256];  // jccolor.c's rgb_ycc_tab
  Tables() {
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
// ISLOW inverse DCT as libjpeg-turbo's x86-64 builds run it
// (jidctint-sse2.asm / -avx2.asm, which give the same bytes): jidctint.c's
// arithmetic on 16-bit lanes. The dequantized coefficients, the sums
// in0 + in4, in0 - in4, in1 + in5 and in3 + in7, and the first pass's
// outputs are 16-bit (wrapping, the outputs saturating); the rotations are
// 32-bit multiply-adds; the result saturates to 0..255. On the values of a
// valid stream this is jidctint.c exactly; on the garbage that a truncated
// or corrupt stream decodes to, it is what libjpeg-turbo gives there.
// ---------------------------------------------------------------------------

inline int16_t w16(long v) { return static_cast<int16_t>(static_cast<uint16_t>(v)); }
inline int16_t sat16(long v) {
  return static_cast<int16_t>(v < -32768 ? -32768 : v > 32767 ? 32767 : v);
}

// one 8-point pass over x[0..7] (16-bit lanes); o[k] = (out_k + round) >> shift
inline void idct_1d(const int16_t* x, int shift, long* o) {
  const long z2 = x[2], z3 = x[6];
  const long tmp3 = z2 * (F_0_541 + F_0_765) + z3 * F_0_541;
  const long tmp2 = z2 * F_0_541 + z3 * (F_0_541 - F_1_847);
  const long tmp0 = static_cast<long>(w16(x[0] + x[4])) * (1L << kConstBits);
  const long tmp1 = static_cast<long>(w16(x[0] - x[4])) * (1L << kConstBits);
  const long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  const long t0 = x[7], t1 = x[5], t2 = x[3], t3 = x[1];
  const long z3o = w16(t0 + t2), z4o = w16(t1 + t3);
  const long z3r = z3o * (F_1_175 - F_1_961) + z4o * F_1_175;
  const long z4r = z3o * F_1_175 + z4o * (F_1_175 - F_0_390);
  const long o0 = t0 * (F_0_298 - F_0_899) + t3 * -F_0_899 + z3r;
  const long o3 = t0 * -F_0_899 + t3 * (F_1_501 - F_0_899) + z4r;
  const long o1 = t1 * (F_2_053 - F_2_562) + t2 * -F_2_562 + z4r;
  const long o2 = t1 * -F_2_562 + t2 * (F_3_072 - F_2_562) + z3r;
  o[0] = descale(tmp10 + o3, shift);
  o[7] = descale(tmp10 - o3, shift);
  o[1] = descale(tmp11 + o2, shift);
  o[6] = descale(tmp11 - o2, shift);
  o[2] = descale(tmp12 + o1, shift);
  o[5] = descale(tmp12 - o1, shift);
  o[3] = descale(tmp13 + o0, shift);
  o[4] = descale(tmp13 - o0, shift);
}

void idct_islow(const int16_t* in, const int* quant, uint8_t* out,
                int stride) {
  int16_t ws[64];  // transposed: ws[c * 8 + r] holds row r of column c
  bool ac = false;
  for (int k = 8; k < 64 && !ac; ++k) ac = in[k] != 0;
  for (int c = 0; c < 8; ++c) {
    int16_t x[8];
    for (int r = 0; r < 8; ++r) x[r] = w16(static_cast<long>(in[r * 8 + c]) * quant[r * 8 + c]);
    if (!ac) {  // rows 1-7 all zero: the DC, shifted in 16 bits
      const int16_t dc = w16(static_cast<long>(static_cast<uint16_t>(x[0])) << kPass1Bits);
      for (int r = 0; r < 8; ++r) ws[c * 8 + r] = dc;
      continue;
    }
    long o[8];
    idct_1d(x, kConstBits - kPass1Bits, o);
    for (int r = 0; r < 8; ++r) ws[c * 8 + r] = sat16(o[r]);
  }
  for (int r = 0; r < 8; ++r) {
    int16_t x[8];
    for (int c = 0; c < 8; ++c) x[c] = ws[c * 8 + r];
    long o[8];
    idct_1d(x, kConstBits + kPass1Bits + 3, o);
    uint8_t* row = out + r * stride;
    for (int c = 0; c < 8; ++c) row[c] = clamp255(static_cast<int>(std::max(-1024L, std::min(1024L, o[c]))) + 128);
  }
}

// ---------------------------------------------------------------------------
// Huffman decoding
// ---------------------------------------------------------------------------

constexpr int kLook = 9;  // lookahead bits of the fast table

struct Huff {
  bool defined = false;
  int maxsym = 0;  // the largest symbol (DC: a category; 16 only lossless)
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
    maxsym = 0;
    for (int i = 0; i < n; ++i) maxsym = std::max(maxsym, static_cast<int>(vals[i]));
    if (dc && maxsym > 16) CORRUPT("JPEG: bad Huffman table");
    defined = true;
  }
};

// Entropy-coded bytes, with 0xFF00 unstuffed (jdhuff.c jpeg_fill_bit_buffer).
// Reaching a marker feeds zero bits; consuming one of them marks the data
// insufficient, after which libjpeg leaves the following MCUs zero (gray)
// until a restart marker is found. Data ending without a marker is a
// truncated stream: the lenient decodes never see it (their input is
// followed by the fake EOI markers of libjpeg's memory source).
struct NeedFeed {};  // see PilFeed

struct Bits {
  const uint8_t* d;
  size_t n, pos;
  uint64_t acc = 0;
  int nbits = 0, pad = 0;
  bool marker = false;  // an unread marker: pos is at an 0xFF before it
  bool insufficient = false;
  // at the end of the data: 0 fails, 1 throws NeedFeed, 2 reads on as at
  // a marker (zeros)
  int on_end = 0;
  // when set, each Huffman code's length (x2) and each run of raw bits
  // (x2 + 1) consumed, as PilFeed replays them
  std::vector<int>* events = nullptr;

  Bits(const uint8_t* data, size_t len, size_t start) : d(data), n(len), pos(start) {}

  void at_end() {
    if (on_end == 0) CORRUPT("JPEG: truncated (the data ends inside a scan)");
    if (on_end == 1) throw NeedFeed{};
    marker = true;
  }
  void fill() {
    while (nbits <= 56) {
      uint32_t b = 0;
      if (!marker) {
        if (pos >= n) {
          at_end();
        } else if (d[pos] != 0xFF) {
          b = d[pos++];
        } else {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;  // fill bytes
          if (q >= n) {
            at_end();
          } else if (d[q] == 0x00) {
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
    if (nbits < pad) insufficient = true;
  }
  int get(int k) {
    if (k == 0) return 0;
    if (events) events->push_back(k << 1 | 1);
    if (nbits < k) fill();
    nbits -= k;
    check();
    return static_cast<int>((acc >> nbits) & ((1u << k) - 1));
  }
  int bit() { return get(1); }
  // jdhuff.c jpeg_huff_decode: a code longer than 16 bits is garbage,
  // decoded (after 17 bits) as the symbol 0
  int decode(const Huff& h) {
    if (nbits < 17) fill();
    uint16_t e = h.look[(acc >> (nbits - kLook)) & ((1 << kLook) - 1)];
    if (e) {
      nbits -= e >> 8;
      if (events) events->push_back((e >> 8) << 1);
      check();
      return e & 0xFF;
    }
    int code16 = static_cast<int>((acc >> (nbits - 16)) & 0xFFFF);
    for (int l = kLook + 1; l <= 16; ++l) {
      int code = code16 >> (16 - l);
      if (code <= h.maxcode[l]) {
        nbits -= l;
        if (events) events->push_back(l << 1);
        check();
        return h.vals[(code + h.valoffset[l]) & 0xFF];
      }
    }
    nbits -= 17;
    if (events) events->push_back(17 << 1);
    check();
    return 0;
  }
  // after a restart: at `start` with no marker pending, or still held at
  // the unread marker (libjpeg's resync leaving it for the next reader)
  void reset(size_t start, bool at_marker) {
    pos = start;
    acc = 0;
    nbits = pad = 0;
    marker = at_marker;
  }
};

inline int extend(int v, int s) {
  return s == 0 ? 0 : v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// PIL feeds libjpeg the file in 64 KiB blocks (ImageFile.MAXBLOCK), one
// more each time the decoder suspends; at the end of the file it raises.
constexpr size_t kPilBlock = 65536;

inline size_t pil_blocks(size_t upto) {  // the bytes PIL has fed to read upto
  return std::max<size_t>(kPilBlock, (upto + kPilBlock - 1) / kPilBlock *
                                         kPilBlock);
}

// libjpeg-turbo 3.1's sequential Huffman reader as PIL feeds it: jdhuff.c's
// decode_mcu with its fast path (taken when 512 bytes per block are fed
// and no marker is pending: 6 bytes whenever 16 bits or fewer are left)
// and its slow path (jpeg_fill_bit_buffer: bytes until 57 bits, a marker,
// or the fed data ends, which suspends the MCU), and process_restart.
// Replays each MCU's codes and bits, as the decode consumed them, over the
// bytes fed, and answers false once PIL would need a byte past the end of
// the file. A sequential single-scan image decodes in PIL when that never
// happens, its EOI marker or not (PIL's load() stops once every row is
// out), which is what decides a stream cut before its EOI.
struct PilFeed {
  const uint8_t* d;
  size_t n, pos, end;
  int bits_left = 0, unread_marker = 0, next_rst = 0;
  bool insufficient = false;

  PilFeed(const uint8_t* data, size_t len, size_t start)
      : d(data), n(len), pos(start), end(std::min(len, pil_blocks(start))) {}

  bool more() {  // PIL reads the next block; false at the end of the file
    if (end >= n) return false;
    end = std::min(n, end + kPilBlock);
    return true;
  }
  // jpeg_fill_bit_buffer; false when it suspends
  bool fill(int& bl, size_t& p, int nbits) {
    if (unread_marker == 0) {
      while (bl < 57) {
        if (p >= end) return false;
        int c = d[p++];
        if (c == 0xFF) {
          do {
            if (p >= end) return false;
            c = d[p++];
          } while (c == 0xFF);
          if (c != 0) {
            unread_marker = c;
            break;
          }
        }
        bl += 8;
      }
      if (unread_marker == 0) return true;
    }
    if (nbits > bl) {  // zeros past the marker
      insufficient = true;
      bl = 57;
    }
    return true;
  }
  bool slow(const std::vector<int>& ev) {
    int bl = bits_left;
    size_t p = pos;
    for (int e : ev) {
      const int k = e >> 1;
      if (e & 1) {  // CHECK_BIT_BUFFER, GET_BITS
        if (bl < k && !fill(bl, p, k)) return false;
        bl -= k;
        continue;
      }
      int first = 9;  // HUFF_DECODE: a lookahead of 8 bits
      if (bl < 8) {
        if (!fill(bl, p, 0)) return false;
        if (bl < 8) first = 1;  // at a marker: jpeg_huff_decode from 1 bit
      }
      if (first == 9 && k <= 8) {
        bl -= k;
        continue;
      }
      if (bl < first && !fill(bl, p, first)) return false;
      bl -= first;
      for (int i = first; i < k; ++i) {
        if (bl < 1 && !fill(bl, p, 1)) return false;
        bl -= 1;
      }
    }
    bits_left = bl;
    pos = p;
    return true;
  }
  bool fast(const std::vector<int>& ev) {  // false when it meets a marker
    int bl = bits_left;
    size_t p = pos;
    bool marker = false;
    for (int e : ev) {
      if (bl <= 16)
        for (int i = 0; i < 6; ++i) {  // FILL_BIT_BUFFER_FAST
          const int c0 = p < n ? d[p] : 0, c1 = p + 1 < n ? d[p + 1] : 0;
          ++p;
          bl += 8;
          if (c0 == 0xFF) {
            ++p;
            if (c1 != 0) {  // the marker is met again by each later read
              marker = true;
              p -= 2;
            }
          }
        }
      bl -= e >> 1;
    }
    if (marker) return false;
    bits_left = bl;
    pos = p;
    return true;
  }
  // decode_mcu for one MCU of `blocks` blocks; false once PIL fails
  bool mcu(const std::vector<int>& ev, int blocks, bool restarts) {
    if (insufficient) return true;  // the MCU stays zero, nothing read
    for (;;) {
      if (!restarts && unread_marker == 0 &&
          end - pos >= static_cast<size_t>(512) * blocks && fast(ev))
        return true;
      if (slow(ev)) return true;
      if (!more()) return false;
    }
  }
  // process_restart: the bit buffer dropped, the RSTn marker read
  // (next_marker, which syncs after each byte it discards); false once
  // PIL fails, or for a marker other than the next restart (its resync is
  // not replayed)
  bool restart() {
    bits_left = 0;
    while (unread_marker == 0) {
      size_t p = pos, sync = pos;
      int c = -1;  // the marker code; -1 while the fed bytes run out first
      while (p < end) {
        int b = d[p++];
        while (b != 0xFF && p < end) {
          sync = p;
          b = d[p++];
        }
        if (b != 0xFF) {
          sync = p;
          break;
        }
        while (p < end && (b = d[p++]) == 0xFF) {
        }
        if (b == 0xFF) break;
        if (b != 0) {
          c = b;
          break;
        }
        sync = p;  // FF 00 outside the data: discarded
      }
      if (c > 0) {
        unread_marker = c;
        pos = p;
      } else {
        pos = sync;
        if (!more()) return false;
      }
    }
    if (unread_marker != 0xD0 + next_rst) return false;
    unread_marker = 0;
    next_rst = (next_rst + 1) & 7;
    insufficient = false;
    return true;
  }
};

// ---------------------------------------------------------------------------
// arithmetic decoding (jdarith.c, the QM-coder of ITU-T T.81 Annex D)
// ---------------------------------------------------------------------------

// Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
#define V(qe, nlps, nmps, sw) \
  ((static_cast<int64_t>(qe) << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
const int64_t kAritab[114] = {
    V(0x5a1d, 1, 1, 1),       V(0x2586, 14, 2, 0),     V(0x1114, 16, 3, 0),
    V(0x080b, 18, 4, 0),      V(0x03d8, 20, 5, 0),     V(0x01da, 23, 6, 0),
    V(0x00e5, 25, 7, 0),      V(0x006f, 28, 8, 0),     V(0x0036, 30, 9, 0),
    V(0x001a, 33, 10, 0),     V(0x000d, 35, 11, 0),    V(0x0006, 9, 12, 0),
    V(0x0003, 10, 13, 0),     V(0x0001, 12, 13, 0),    V(0x5a7f, 15, 15, 1),
    V(0x3f25, 36, 16, 0),     V(0x2cf2, 38, 17, 0),    V(0x207c, 39, 18, 0),
    V(0x17b9, 40, 19, 0),     V(0x1182, 42, 20, 0),    V(0x0cef, 43, 21, 0),
    V(0x09a1, 45, 22, 0),     V(0x072f, 46, 23, 0),    V(0x055c, 48, 24, 0),
    V(0x0406, 49, 25, 0),     V(0x0303, 51, 26, 0),    V(0x0240, 52, 27, 0),
    V(0x01b1, 54, 28, 0),     V(0x0144, 56, 29, 0),    V(0x00f5, 57, 30, 0),
    V(0x00b7, 59, 31, 0),     V(0x008a, 60, 32, 0),    V(0x0068, 62, 33, 0),
    V(0x004e, 63, 34, 0),     V(0x003b, 32, 35, 0),    V(0x002c, 33, 9, 0),
    V(0x5ae1, 37, 37, 1),     V(0x484c, 64, 38, 0),    V(0x3a0d, 65, 39, 0),
    V(0x2ef1, 67, 40, 0),     V(0x261f, 68, 41, 0),    V(0x1f33, 69, 42, 0),
    V(0x19a8, 70, 43, 0),     V(0x1518, 72, 44, 0),    V(0x1177, 73, 45, 0),
    V(0x0e74, 74, 46, 0),     V(0x0bfb, 75, 47, 0),    V(0x09f8, 77, 48, 0),
    V(0x0861, 78, 49, 0),     V(0x0706, 79, 50, 0),    V(0x05cd, 48, 51, 0),
    V(0x04de, 50, 52, 0),     V(0x040f, 50, 53, 0),    V(0x0363, 51, 54, 0),
    V(0x02d4, 52, 55, 0),     V(0x025c, 53, 56, 0),    V(0x01f8, 54, 57, 0),
    V(0x01a4, 55, 58, 0),     V(0x0160, 56, 59, 0),    V(0x0125, 57, 60, 0),
    V(0x00f6, 58, 61, 0),     V(0x00cb, 59, 62, 0),    V(0x00ab, 61, 63, 0),
    V(0x008f, 61, 32, 0),     V(0x5b12, 65, 65, 1),    V(0x4d04, 80, 66, 0),
    V(0x412c, 81, 67, 0),     V(0x37d8, 82, 68, 0),    V(0x2fe8, 83, 69, 0),
    V(0x293c, 84, 70, 0),     V(0x2379, 86, 71, 0),    V(0x1edf, 87, 72, 0),
    V(0x1aa9, 87, 73, 0),     V(0x174e, 72, 74, 0),    V(0x1424, 72, 75, 0),
    V(0x119c, 74, 76, 0),     V(0x0f6b, 74, 77, 0),    V(0x0d51, 75, 78, 0),
    V(0x0bb6, 77, 79, 0),     V(0x0a40, 77, 48, 0),    V(0x5832, 80, 81, 1),
    V(0x4d1c, 88, 82, 0),     V(0x438e, 89, 83, 0),    V(0x3bdd, 90, 84, 0),
    V(0x34ee, 91, 85, 0),     V(0x2eae, 92, 86, 0),    V(0x299a, 93, 87, 0),
    V(0x2516, 86, 71, 0),     V(0x5570, 88, 89, 1),    V(0x4ca9, 95, 90, 0),
    V(0x44d9, 96, 91, 0),     V(0x3e22, 97, 92, 0),    V(0x3824, 99, 93, 0),
    V(0x32b4, 99, 94, 0),     V(0x2e17, 93, 86, 0),    V(0x56a8, 95, 96, 1),
    V(0x4f46, 101, 97, 0),    V(0x47e5, 102, 98, 0),   V(0x41cf, 103, 99, 0),
    V(0x3c3d, 104, 100, 0),   V(0x375e, 99, 93, 0),    V(0x5231, 105, 102, 0),
    V(0x4c0f, 106, 103, 0),   V(0x4639, 107, 104, 0),  V(0x415e, 103, 99, 0),
    V(0x5627, 105, 106, 1),   V(0x50e7, 108, 107, 0),  V(0x4b85, 109, 103, 0),
    V(0x5597, 110, 109, 0),   V(0x504f, 111, 107, 0),  V(0x5a10, 110, 111, 1),
    V(0x5522, 112, 109, 0),   V(0x59eb, 112, 111, 1),  V(0x5a1d, 113, 113, 0)};
#undef V

// The QM-decoder's registers over the scan's bytes (jdarith.c). A marker
// inside the data is legal here: zeros are fed from it on, and decoding
// goes on; ct == -1 marks a code error, after which the MCUs up to the
// next restart are left alone.
struct Arith {
  const uint8_t* d;
  size_t n, pos;
  int64_t c = 0, a = 0;
  int ct = -16;
  bool marker = false;  // an unread marker: pos is at the 0xFF before it
  // PIL's decode: the bytes fed so far (PilFeed); jdarith.c cannot suspend,
  // so a byte needed past them fails the decode
  size_t fed = SIZE_MAX;

  Arith(const uint8_t* data, size_t len, size_t start) : d(data), n(len), pos(start) {}

  int byte() {
    if (pos >= n) CORRUPT("JPEG: truncated (the data ends inside a scan)");
    if (pos >= fed) pil_cannot_suspend();
    return d[pos++];
  }
  [[noreturn]] static void pil_cannot_suspend() {
    CORRUPT("JPEG: the arithmetic-coded data runs past a 64 KiB block of "
            "PIL's feed, where libjpeg cannot suspend");
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalization and data input, D.2.6
      if (--ct < 0) {
        int data = 0;
        if (!marker) {
          const size_t at = pos;
          data = byte();
          if (data == 0xFF) {
            do data = byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              marker = true;
              pos = at;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAritab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;  // decode and estimation, D.2.4 and D.2.5
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  void reset(size_t start, bool at_marker) {
    pos = start;
    marker = at_marker;
    c = a = 0;
    ct = -16;
  }
};

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

constexpr int kSaved = 10;  // coefficients block smoothing estimates (0-9)

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;  // downsampled size (jdinput.c)
  int bw = 0, bh = 0;  // blocks holding samples
  int bw_alloc = 0, bh_alloc = 0;  // blocks of the interleaved MCU grid
  std::vector<int16_t> coef;
  std::vector<int> diff;          // lossless: the decoded differences
  std::vector<uint8_t> first_row; // lossless: rows the first-row predictor starts
  int quant[64];      // the IDCT's multipliers (16-bit)
  int quantval[64];   // the table's values, as block smoothing reads them
  bool latched = false;
  int dc_pred = 0, dc_ctx = 0;
  int pred = 1, pt = 0;  // lossless: predictor and point transform
  bool scanned = false;
  int coef_bits[64], prev_bits[64];  // libjpeg's coef_bits, both halves
  int latch[kSaved], prev_latch[kSaved];  // smoothing_ok's latches
};

enum Color { kGray, kYCbCr, kRGB, kCMYK, kYCCK };
enum Up { kFull, kH2V1, kH2V2, kH1V2, kRepl };

struct Scan {
  int n = 0;
  int ci[4], td[4], ta[4];
  int ss = 0, se = 63, ah = 0, al = 0;
};

// How a decode treats what libjpeg itself does not decide:
//   kLibjpeg: the JAX package's libjpeg binding. A truncated stream
//     decodes (libjpeg's memory source ends it with fake EOI markers); a
//     region decode smooths blocks as jpeg_crop_scanline's column offset
//     makes libjpeg smooth them.
//   kPil: PIL's Image.open(...).convert("RGB"), which the JAX package's
//     server and loader use and its binding falls back to for CMYK/YCCK. A
//     stream that ends before its EOI raises, as PIL's load() does; 4
//     components go to RGB through PIL's inverted-CMYK convert.
enum Mode { kLibjpeg = 0, kPil = 1 };

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n, int mode = kPil, bool region = false,
          bool pil_feed = false, bool ojpeg = false)
      : mode_(mode), region_(region), pil_feed_(pil_feed), ojpeg_(ojpeg) {
    // ojpeg: libtiff's old-style JPEG source, whose data ends without fake
    // markers; reading past it is libjpeg's fatal error inside the scan,
    // which ends the decode at the iMCU row it was in (failed_row())
    if (mode_ == kLibjpeg && !ojpeg) {
      // jpeg_mem_src's fill_input_buffer: past the end, EOI markers
      // without end (enough of them for any one marker segment)
      padded_.reserve(n + kPad);
      padded_.assign(d, d + n);
      for (size_t i = 0; i < kPad; i += 2) {
        padded_.push_back(0xFF);
        padded_.push_back(0xD9);
      }
      d_ = padded_.data();
      n_ = padded_.size();
    } else {
      d_ = d;
      n_ = n;
    }
    dc_[0].build(kBitsDcLum, kValDc, true);
    dc_[1].build(kBitsDcChr, kValDc, true);
    ac_[0].build(kBitsAcLum, kValAcLum, false);
    ac_[1].build(kBitsAcChr, kValAcChr, false);
    std::memset(qdef_, 0, sizeof qdef_);
    for (int i = 0; i < 16; ++i) {
      arith_dc_l_[i] = 0;  // jdmarker.c get_soi defaults
      arith_dc_u_[i] = 1;
      arith_ac_k_[i] = 5;
    }
  }

  void tiff_color(int c) { tiff_color_ = c; }
  int failed_row() const { return failed_row_; }
  int width() const { return W_; }
  int height() const { return H_; }
  int h_max() const {
    int m = 1;
    for (int i = 0; i < ncomp_; ++i) m = std::max(m, comp_[i].h);
    return m;
  }
  int v_max() const {
    int m = 1;
    for (int i = 0; i < ncomp_; ++i) m = std::max(m, comp_[i].v);
    return m;
  }
  int components() const { return ncomp_; }
  int h_samp(int i) const { return comp_[i].h; }
  int v_samp(int i) const { return comp_[i].v; }

  // Header only, up to the first frame header, which is read.
  void header_only() {
    size_t pos = start();
    for (;;) {
      int m = next_marker(&pos);
      if (m == 0xD9 || m == 0xDA) CORRUPT("JPEG: no frame header");
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 ||
          m == 0xCA) {
        read_sof(m, d_ + pos + 2, seg_len(pos) - 2);
        return;
      }
      pos += standalone(m) ? 0 : seg_len(pos);
    }
  }

  // Header only: width and height from the first SOF of any kind, and
  // whether the JAX package's binding hands the stream to PIL (4
  // components, lossless).
  void dims(int* w, int* h, bool* to_pil = nullptr) {
    size_t pos = start();
    for (;;) {
      int m = next_marker(&pos);
      if (m == 0xD9 || m == 0xDA) CORRUPT("JPEG: no frame header");
      if (is_sof(m)) {
        size_t len = seg_len(pos);
        if (len < 8) CORRUPT("JPEG: bad frame header");
        *h = (d_[pos + 3] << 8) | d_[pos + 4];
        *w = (d_[pos + 5] << 8) | d_[pos + 6];
        if (to_pil) *to_pil = d_[pos + 7] == 4 || m == 0xC3;
        return;
      }
      pos += standalone(m) ? 0 : seg_len(pos);
    }
  }

  // Decode (all, or the rows the region needs) and write the region's RGB.
  // A stream with 4 components always decodes as PIL does (the JAX
  // package's binding refuses it and falls back to PIL).
  // out_cap >= 0: the bytes out holds (too few is an error before any is
  // written)
  void decode(int x0, int y0, int cw, int ch, uint8_t* out,
              long out_cap = -1) {
    x0_ = x0;
    y0_ = y0;
    cw_ = cw;
    ch_ = ch;
    size_t pos = start();
    try {
      markers(pos);
    } catch (const EndOfData&) {
      // PIL's decode of a single-scan image ends with its last MCU: what
      // follows the scan may be cut off (see PilFeed)
    } catch (const Failure& f) {
      // libtiff reads a strip's scanlines, then calls jpeg_finish_decompress
      // and takes its error for success (CALLJPEG's -1 is true): what
      // follows a sequential image's whole scan cannot fail a TIFF strip
      if (ojpeg_ && in_scan_)
        failed_row_ = cur_row_;
      else if (tiff_color_ < 0 || f.code != -1 || !single_scan_ ||
               !scan_done_)
        throw;
    }
    if (!scans_) CORRUPT("JPEG: no image data");
    if (out_cap >= 0 && output_size() > out_cap)
      CORRUPT("JPEG: output buffer too small");
    output(out);
  }

 private:
  struct EndOfData {};

  void markers(size_t pos) {
    for (;;) {
      int m = next_marker(&pos);
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn: no length
      if (m == 0x01) continue;               // TEM
      if (m == 0xD8) CORRUPT("JPEG: second SOI");
      size_t len = seg_len(pos);
      const uint8_t* s = d_ + pos + 2;
      const size_t sl = len - 2;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 ||
          m == 0xCA) {
        read_sof(m, s, sl);
      } else if (m >= 0xC5 && m <= 0xC7) {
        UNSUPPORTED("hierarchical JPEG (SOF%d) is not supported", m - 0xC0);
      } else if (m == 0xCB) {
        UNSUPPORTED("lossless arithmetic-coded JPEG (SOF11) is not supported");
      } else if (m >= 0xCD && m <= 0xCF) {
        UNSUPPORTED("hierarchical arithmetic-coded JPEG (SOF%d) is not "
                    "supported", m - 0xC0);
      } else if (m == 0xC4) {
        read_dht(s, sl);
      } else if (m == 0xCC) {
        read_dac(s, sl);
      } else if (m == 0xDB) {
        read_dqt(s, sl);
      } else if (m == 0xDD) {
        if (sl != 2) CORRUPT("JPEG: bad DRI");
        restart_ = (s[0] << 8) | s[1];
      } else if (m == 0xDA) {
        pos = scan(s, sl, pos + len);
        in_scan_ = false;
        scan_done_ = true;
        // libjpeg's region decode of a single-scan image stops reading
        // there (jpeg_abort_decompress): what follows is never parsed
        if (region_ && single_scan_ && !pil()) break;
        continue;
      } else if (m == 0xE0) {
        if (sl >= 14 && !std::memcmp(s, "JFIF", 5)) jfif_ = true;
      } else if (m == 0xEE) {
        if (sl >= 12 && !std::memcmp(s, "Adobe", 5)) {
          adobe_ = true;
          adobe_transform_ = s[11];
        }
      } else if (!(m > 0xE0 && m <= 0xEF) && m != 0xFE && m != 0xDC) {
        // APPn, COM and DNL are skipped; libjpeg refuses the rest
        CORRUPT("JPEG: unknown marker 0x%02X", m);
      }
      pos += len;
    }
  }

 public:

 private:
  static constexpr size_t kPad = 65536 + 16;
  int mode_;
  bool region_;  // a region decode (fastjpeg_decode_crop_rgb8)
  // PIL's mode: replay its feed over a sequential single-scan image whose
  // data ends inside the scan (PilFeed)
  bool pil_feed_;
  bool eoi_optional_ = false;  // the replay found every MCU fed
  size_t fed_ = kPilBlock;     // the bytes PIL has fed (arithmetic scans)
  size_t marker_read_ = 0;     // the last marker code next_marker read
  std::vector<uint8_t> padded_;
  const uint8_t* d_;
  size_t n_;
  int qtab_[4][64];
  bool qdef_[4];
  Huff dc_[4], ac_[4];
  // the arithmetic coder's 16 conditioning tables and statistics bins
  int arith_dc_l_[16], arith_dc_u_[16], arith_ac_k_[16];
  uint8_t dc_stats_[16][64], ac_stats_[16][256];
  int restart_ = 0;
  bool sof_ = false, progressive_ = false, arith_ = false, lossless_ = false;
  int W_ = 0, H_ = 0, ncomp_ = 0;
  Comp comp_[4];
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = 0;
  Color color_ = kYCbCr;
  // a JPEG strip or tile of a TIFF (fastjpeg_decode_tiff): libtiff forces
  // the colour space and, unless it is YCbCr, asks for the components
  // themselves (JCS_UNKNOWN)
  // -1: not a TIFF decode, 0: components, 1: YCbCr, 2: each component's
  // samples before upsampling (jpeg_read_raw_data)
  int tiff_color_ = -1;
  bool ojpeg_, in_scan_ = false;
  int cur_row_ = 0, failed_row_ = -1;
  bool allocated_ = false, single_scan_ = false;
  bool scan_done_ = false;  // a scan has been decoded to its end
  int scans_ = 0;
  int limit_imcu_ = 0;  // iMCU rows to entropy-decode
  int last_good_ = 0;   // jdmaster's last_good_iMCU_row
  int x0_ = 0, y0_ = 0, cw_ = 0, ch_ = 0;

  static bool is_sof(int m) {
    return m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC;
  }
  static bool standalone(int m) {
    return m == 0x01 || (m >= 0xD0 && m <= 0xD7);
  }
  // PIL's semantics: for its streams, and for those the JAX package's
  // binding refuses and hands to PIL (4 components, lossless)
  bool pil() const { return mode_ == kPil || ncomp_ == 4 || lossless_; }

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
      if (p >= n_) {
        if (eoi_optional_) throw EndOfData{};
        CORRUPT("JPEG: truncated (no EOI marker)");
      }
      if (d_[p] != 0x00) break;
      ++p;  // a stuffed zero outside a scan: garbage
    }
    *pos = p + 1;
    marker_read_ = p;
    return d_[p];
  }

  size_t seg_len(size_t pos) {
    if (eoi_optional_ && pos + 2 > n_) throw EndOfData{};
    if (pos + 2 > n_) CORRUPT("JPEG: truncated marker segment");
    size_t len = (d_[pos] << 8) | d_[pos + 1];
    if (eoi_optional_ && len >= 2 && pos + len > n_) throw EndOfData{};
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
        qtab_[tq][kNatural[k]] = v;
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

  // jdmarker.c get_dac: conditioning values of the arithmetic coder
  void read_dac(const uint8_t* s, size_t sl) {
    if (sl % 2) CORRUPT("JPEG: bad DAC");
    for (size_t p = 0; p < sl; p += 2) {
      int index = s[p], val = s[p + 1];
      if (index >= 32) CORRUPT("JPEG: bad DAC table index");
      if (index >= 16) {
        arith_ac_k_[index - 16] = val;
      } else {
        arith_dc_l_[index] = val & 15;
        arith_dc_u_[index] = val >> 4;
        if (arith_dc_l_[index] > arith_dc_u_[index])
          CORRUPT("JPEG: bad DAC value");
      }
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
    if (ncomp_ == 0 || sl != 6 + 3 * static_cast<size_t>(ncomp_))
      CORRUPT("JPEG: bad frame header");
    if (ncomp_ != 1 && ncomp_ != 3 && ncomp_ != 4)
      UNSUPPORTED("JPEG with %d components is not supported (1, 3 or 4 "
                  "only)", ncomp_);
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
    progressive_ = m == 0xC2 || m == 0xCA;
    arith_ = m == 0xC9 || m == 0xCA;
    lossless_ = m == 0xC3;
    sof_ = true;
  }

  // Geometry, color space and buffers, at the first scan (libjpeg decides
  // the color space once the header up to the first SOS is read:
  // jdapimin.c default_decompress_parms).
  void setup() {
    if (ncomp_ == 1) {
      color_ = kGray;
    } else if (ncomp_ == 4) {
      color_ = adobe_ && adobe_transform_ == 0 ? kCMYK : adobe_ ? kYCCK : kCMYK;
    } else if (jfif_) {
      color_ = kYCbCr;
    } else if (adobe_) {
      color_ = adobe_transform_ == 0 ? kRGB : kYCbCr;
    } else if (lossless_ ||
               (comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B')) {
      color_ = kRGB;  // libjpeg-turbo 3 guesses RGB for lossless
    } else {
      color_ = kYCbCr;
    }
    if (tiff_color_ == 1) color_ = kYCbCr;
    hmax_ = vmax_ = 1;
    for (int i = 0; i < ncomp_; ++i) {
      hmax_ = std::max(hmax_, comp_[i].h);
      vmax_ = std::max(vmax_, comp_[i].v);
    }
    for (int i = 0; i < ncomp_; ++i)
      if (hmax_ % comp_[i].h || vmax_ % comp_[i].v)
        UNSUPPORTED("JPEG with a non-integral sampling ratio is not "
                    "supported");
    const int unit = lossless_ ? 1 : 8;  // samples per data unit side
    mcux_ = (W_ + unit * hmax_ - 1) / (unit * hmax_);
    mcuy_ = (H_ + unit * vmax_ - 1) / (unit * vmax_);
    for (int i = 0; i < ncomp_; ++i) {
      Comp& c = comp_[i];
      c.dw = static_cast<int>((static_cast<long>(W_) * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>((static_cast<long>(H_) * c.v + vmax_ - 1) / vmax_);
      c.bw = (c.dw + unit - 1) / unit;
      c.bh = (c.dh + unit - 1) / unit;
      c.bw_alloc = mcux_ * c.h;
      c.bh_alloc = mcuy_ * c.v;
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = c.prev_bits[k] = -1;
    }
    // iMCU rows the region needs: its last row, the row below it that
    // fancy upsampling reads, and for a progressive stream the two block
    // rows below those that block smoothing reads
    limit_imcu_ = 0;
    for (int i = 0; i < ncomp_; ++i) {
      const Comp& c = comp_[i];
      int vexp = vmax_ / c.v;
      int r = std::min((y0_ + ch_ - 1) / vexp + 1, c.dh - 1);
      limit_imcu_ = std::max(limit_imcu_, r / 8 / c.v + 1);
    }
    if (progressive_) limit_imcu_ += 2;
    limit_imcu_ = std::min(limit_imcu_, mcuy_);
    if (lossless_) {  // PIL decodes it whole: every sample, undifferenced
      limit_imcu_ = mcuy_;
      for (int i = 0; i < ncomp_; ++i)
        comp_[i].diff.assign(static_cast<size_t>(comp_[i].bw_alloc) *
                                 comp_[i].bh_alloc, 0);
      allocated_ = true;
      return;
    }
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
    if (single_scan_) CORRUPT("JPEG: a second scan after a single-scan image");
    if (!allocated_) setup();
    Scan sc;
    if (sl < 1) CORRUPT("JPEG: bad scan header");
    sc.n = s[0];
    if (sc.n < 1 || sc.n > 4 || sl != 4 + 2 * static_cast<size_t>(sc.n))
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
      if (!arith_ && (sc.td[i] > 3 || sc.ta[i] > 3))
        CORRUPT("JPEG: bad table number");
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
    if (lossless_) return lossless_scan(sc, data);
    if (progressive_) {
      bool bad = sc.ss == 0 ? sc.se != 0 : (sc.ss > sc.se || sc.se > 63 || sc.n != 1);
      if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
      if (sc.al > 13) bad = true;
      if (bad) CORRUPT("JPEG: bad progressive scan parameters");
    }
    ++scans_;  // libjpeg's input_scan_number
    if (!progressive_ && scans_ == 1 && sc.n == ncomp_) single_scan_ = true;
    for (int i = 0; i < sc.n; ++i) {
      Comp& c = comp_[sc.ci[i]];
      if (!c.latched) {  // jdinput.c latch_quant_tables
        if (!qdef_[c.tq]) CORRUPT("JPEG: quantization table not defined");
        for (int k = 0; k < 64; ++k) {
          c.quantval[k] = qtab_[c.tq][k];
          // libjpeg-turbo's multiplier tables hold these as 16-bit values
          c.quant[k] = static_cast<int16_t>(qtab_[c.tq][k]);
        }
        c.latched = true;
      }
      bool need_dc = !progressive_ || (sc.ss == 0 && sc.ah == 0);
      bool need_ac = !progressive_ || sc.ss != 0;
      if (!arith_ && ((need_dc && !dc_[sc.td[i]].defined) ||
                      (need_ac && !ac_[sc.ta[i]].defined)))
        CORRUPT("JPEG: Huffman table not defined");
      if (!arith_ && need_dc && dc_[sc.td[i]].maxsym > 15)
        CORRUPT("JPEG: bad Huffman table");
      if (progressive_) {  // jdphuff.c / jdarith.c start_pass
        const int hi = std::max(sc.se, kSaved - 1);
        for (int k = std::min(sc.ss, 1); k <= hi; ++k)
          c.prev_bits[k] = scans_ > 1 ? c.coef_bits[k] : 0;
        for (int k = sc.ss; k <= sc.se; ++k) c.coef_bits[k] = sc.al;
      }
      if (arith_) {
        if (need_dc) std::memset(dc_stats_[sc.td[i]], 0, 64);
        if (need_ac) std::memset(ac_stats_[sc.ta[i]], 0, 256);
      }
      c.dc_pred = 0;
      c.dc_ctx = 0;
    }
    return arith_ ? arith_scan(sc, data) : huff_scan(sc, data);
  }

  // The MCUs of a scan, each as its blocks: fn(iMCU row, blocks, the
  // scan index of each block's component, count).
  template <class F>
  void for_mcus(const Scan& sc, F&& fn) {
    int16_t* blk[10];
    int si[10];
    if (sc.n == 1) {
      Comp& c = comp_[sc.ci[0]];
      int rows = std::min(c.bh, limit_imcu_ * c.v);
      si[0] = 0;
      for (int by = 0; by < rows; ++by)
        for (int bx = 0; bx < c.bw; ++bx) {
          blk[0] = block(c, by, bx);
          fn(by / c.v, blk, si, 1);
        }
    } else {
      int rows = std::min(mcuy_, limit_imcu_);
      for (int my = 0; my < rows; ++my)
        for (int mx = 0; mx < mcux_; ++mx) {
          int nb = 0;
          for (int i = 0; i < sc.n; ++i) {
            Comp& c = comp_[sc.ci[i]];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) {
                si[nb] = i;
                blk[nb++] = block(c, my * c.v + y, mx * c.h + x);
              }
          }
          fn(my, blk, si, nb);
        }
    }
  }

  // jdmarker.c read_restart_marker and jpeg_resync_to_restart, from a
  // reader at `pos` (at or before the marker it may already have met).
  // Returns where the reader resumes; *held is true when the marker found
  // is left unread (the reader then feeds zeros until the scan ends).
  size_t restart_marker(size_t pos, int* next, bool* held) {
    size_t p = pos;
    int m = next_marker(&p);
    const int want = *next;
    *next = (*next + 1) & 7;
    *held = false;
    for (;;) {
      if (m == 0xD0 + want) return p;
      // libtiff's old-style JPEG source has no resync: its
      // resync_to_restart is a fatal error ("Unexpected error")
      if (ojpeg_) CORRUPT("JPEG: restart marker out of order");
      int action;
      if (m < 0xC0) {
        action = 2;  // not a valid marker
      } else if (m < 0xD0 || m > 0xD7) {
        action = 3;  // a marker that is not a restart
      } else if (m == 0xD0 + ((want + 1) & 7) || m == 0xD0 + ((want + 2) & 7)) {
        action = 3;  // one of the next two restarts
      } else if (m == 0xD0 + ((want - 1) & 7) || m == 0xD0 + ((want - 2) & 7)) {
        action = 2;  // a restart before the wanted one: scan on
      } else {
        action = 1;  // too far away: take it for the wanted one
      }
      if (action == 1) return p;
      if (action == 3) {
        *held = true;
        return p - 2;  // the 0xFF before the marker code
      }
      m = next_marker(&p);
    }
  }

  // --- lossless: libjpeg-turbo 3's jdlhuff.c, jddiffct.c and jdpred.c, as
  // PIL decodes it (the JAX package's libjpeg refuses SOF3) ---

  size_t lossless_scan(const Scan& sc, size_t data) {
    if (sc.ss < 1 || sc.ss > 7 || sc.ah != 0 || sc.al > 7)
      CORRUPT("JPEG: bad lossless scan parameters");
    ++scans_;
    for (int i = 0; i < sc.n; ++i) {
      if (!dc_[sc.td[i]].defined) CORRUPT("JPEG: Huffman table not defined");
      comp_[sc.ci[i]].pred = sc.ss;
      comp_[sc.ci[i]].pt = sc.al;
      comp_[sc.ci[i]].scanned = true;
      comp_[sc.ci[i]].first_row.assign(comp_[sc.ci[i]].bh_alloc, 0);
      comp_[sc.ci[i]].first_row[0] = 1;
    }
    Bits br(d_, n_, data);
    int next_rst = 0;
    // restarts fall on MCU rows (jddiffct.c counts them in rows)
    const int per_row = sc.n == 1 ? comp_[sc.ci[0]].bw : mcux_;
    const int rows = sc.n == 1 ? comp_[sc.ci[0]].bh : mcuy_;
    const int rst_rows = restart_ ? std::max(restart_ / per_row, 1) : 0;
    int rows_togo = rst_rows;
    for (int my = 0; my < rows; ++my) {
      if (restart_ && rows_togo == 0) {
        bool held;
        size_t p = restart_marker(br.pos, &next_rst, &held);
        br.reset(p, held);
        if (!held) br.insufficient = false;
        for (int i = 0; i < sc.n; ++i) {
          Comp& c = comp_[sc.ci[i]];
          c.first_row[sc.n == 1 ? my : my * c.v] = 1;
        }
        rows_togo = rst_rows;
      }
      for (int mx = 0; mx < per_row; ++mx)
        for (int i = 0; i < sc.n; ++i) {
          Comp& c = comp_[sc.ci[i]];
          const int vv = sc.n == 1 ? 1 : c.v, hh = sc.n == 1 ? 1 : c.h;
          for (int y = 0; y < vv; ++y)
            for (int x = 0; x < hh; ++x) {
              int d = 0;
              if (!br.insufficient) {
                const int s = br.decode(dc_[sc.td[i]]);
                d = s == 16 ? 32768 : extend(br.get(s), s);
              }
              c.diff[static_cast<size_t>(my * vv + y) * c.bw_alloc + mx * hh + x] = d;
            }
        }
      if (restart_) --rows_togo;
    }
    return br.marker ? br.pos : skip_entropy(d_, n_, br.pos);
  }

  // jdpred.c: the samples from the differences, row by row; a row that
  // starts the scan or follows a restart uses the first-row predictor
  void lossless_samples(Comp& c, std::vector<uint8_t>& px, int stride) {
    const int w = c.bw, h = c.bh;
    std::vector<int> prev(w), cur(w);
    for (int r = 0; r < h; ++r) {
      const int* d = c.diff.data() + static_cast<size_t>(r) * c.bw_alloc;
      if (c.first_row[r]) {
        int ra = (d[0] + (1 << (8 - c.pt - 1))) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < w; ++x) cur[x] = ra = (d[x] + ra) & 0xFFFF;
      } else {
        int rb = prev[0];
        int ra = (d[0] + rb) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < w; ++x) {
          const int rc = rb;
          rb = prev[x];
          int p;
          switch (c.pred) {
            case 1: p = ra; break;
            case 2: p = rb; break;
            case 3: p = rc; break;
            case 4: p = ra + rb - rc; break;
            case 5: p = ra + ((rb - rc) >> 1); break;
            case 6: p = rb + ((ra - rc) >> 1); break;
            default: p = (ra + rb) >> 1; break;
          }
          cur[x] = ra = (d[x] + p) & 0xFFFF;
        }
      }
      uint8_t* o = px.data() + static_cast<size_t>(r) * stride;
      for (int x = 0; x < w; ++x) o[x] = static_cast<uint8_t>(cur[x] << c.pt);
      prev.swap(cur);
    }
  }

  // --- Huffman: jdhuff.c (sequential), jdphuff.c (progressive) ---

  size_t huff_scan(const Scan& sc, size_t data) {
    Bits br(d_, n_, data);
    // PIL's mode, a sequential single-scan image: data that ends inside
    // the scan is replayed through PIL's feed (PilFeed)
    const bool seq = mode_ == kPil && !progressive_ && single_scan_;
    std::vector<int> events;
    PilFeed feed(d_, n_, data);
    if (seq) br.on_end = pil_feed_ ? 2 : 1;
    if (seq && pil_feed_) br.events = &events;
    int togo = restart_, next_rst = 0, eobrun = 0;
    for_mcus(sc, [&](int row, int16_t** blk, const int* si, int nb) {
      cur_row_ = row;
      in_scan_ = true;  // the scan's header was good
      if (restart_) {
        if (togo == 0) {  // process_restart
          bool held;
          size_t p = restart_marker(br.pos, &next_rst, &held);
          br.reset(p, held);
          if (!held) br.insufficient = false;
          for (int i = 0; i < sc.n; ++i) comp_[sc.ci[i]].dc_pred = 0;
          eobrun = 0;
          togo = restart_;
          if (br.events && !feed.restart()) pil_runs_out();
        }
        --togo;
      }
      events.clear();
      // out of data: the MCU stays as it is (zero, or the earlier scans')
      if (br.insufficient) {
        if (br.events && !feed.mcu(events, nb, restart_ != 0)) pil_runs_out();
        return;
      }
      last_good_ = row;
      for (int b = 0; b < nb; ++b) {
        const int i = si[b];
        Comp& c = comp_[sc.ci[i]];
        if (!progressive_)
          seq_block(br, c, dc_[sc.td[i]], ac_[sc.ta[i]], blk[b]);
        else if (sc.ss == 0)
          dc_block(br, c, dc_[sc.td[i]], sc, blk[b]);
        else if (sc.ah == 0)
          ac_first(br, ac_[sc.ta[i]], sc, blk[b], &eobrun);
        else
          ac_refine(br, ac_[sc.ta[i]], sc, blk[b], &eobrun);
      }
      if (br.events && !feed.mcu(events, nb, restart_ != 0)) pil_runs_out();
    });
    if (br.events) eoi_optional_ = true;
    return br.marker ? br.pos : skip_entropy(d_, n_, br.pos);
  }

  [[noreturn]] static void pil_runs_out() {
    CORRUPT("JPEG: truncated (PIL's reader needs bytes past the end of the "
            "file)");
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
      blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << sc.al);
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
            static_cast<int16_t>(static_cast<unsigned>(extend(br.get(s), s)) << sc.al);
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

  // --- arithmetic: jdarith.c ---

  size_t arith_scan(const Scan& sc, size_t data) {
    Arith ar(d_, n_, data);
    // PIL has fed the blocks that reach past the scan header, or more
    fed_ = std::max(fed_, pil_blocks(data));
    if (pil()) ar.fed = fed_;
    int togo = restart_, next_rst = 0;
    for_mcus(sc, [&](int row, int16_t** blk, const int* si, int nb) {
      cur_row_ = row;
      in_scan_ = true;  // the scan's header was good
      if (restart_) {
        if (togo == 0) {  // process_restart: statistics and registers reset
          bool held;
          size_t p = restart_marker(ar.pos, &next_rst, &held);
          if (marker_read_ >= ar.fed) Arith::pil_cannot_suspend();
          ar.reset(p, held);
          for (int i = 0; i < sc.n; ++i) {
            Comp& c = comp_[sc.ci[i]];
            if (!progressive_ || (sc.ss == 0 && sc.ah == 0)) {
              std::memset(dc_stats_[sc.td[i]], 0, 64);
              c.dc_pred = 0;
              c.dc_ctx = 0;
            }
            if (!progressive_ || sc.ss) std::memset(ac_stats_[sc.ta[i]], 0, 256);
          }
          togo = restart_;
        }
        --togo;
      }
      last_good_ = row;
      if (progressive_ && sc.ss == 0 && sc.ah != 0) {  // decode_mcu_DC_refine
        uint8_t fixed = 113;
        for (int b = 0; b < nb; ++b)
          if (ar.decode(&fixed)) blk[b][0] = static_cast<int16_t>(blk[b][0] | (1 << sc.al));
        return;
      }
      if (ar.ct == -1) return;  // after a code error: nothing until a restart
      for (int b = 0; b < nb; ++b) {
        const int i = si[b];
        Comp& c = comp_[sc.ci[i]];
        if (!progressive_) {
          std::memset(blk[b], 0, 64 * sizeof(int16_t));
          if (!arith_dc(ar, c, sc.td[i], blk[b], 0)) return;
          if (!arith_ac(ar, sc.ta[i], 1, 63, 0, blk[b])) return;
        } else if (sc.ss == 0) {
          if (!arith_dc(ar, c, sc.td[i], blk[b], sc.al)) return;
        } else if (sc.ah == 0) {
          if (!arith_ac(ar, sc.ta[i], sc.ss, sc.se, sc.al, blk[b])) return;
        } else {
          if (!arith_ac_refine(ar, sc.ta[i], sc, blk[b])) return;
        }
      }
    });
    return ar.marker ? ar.pos : skip_entropy(d_, n_, ar.pos);
  }

  // the magnitude category and bits of a nonzero value, F.1.4.4.1.3 and
  // Figures F.23 and F.24 (st at the first magnitude bin); false on a
  // magnitude overflow
  static bool arith_magnitude(Arith& ar, uint8_t* st, uint8_t* x1, int* m_out) {
    int m = ar.decode(st);
    if (m) {
      st = x1;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          ar.ct = -1;
          return false;
        }
        ++st;
      }
    }
    *m_out = m;
    return true;
  }

  // decode_mcu / decode_mcu_DC_first, the DC part of one block
  bool arith_dc(Arith& ar, Comp& c, int tbl, int16_t* blk, int al) {
    uint8_t* st = dc_stats_[tbl] + c.dc_ctx;
    if (ar.decode(st) == 0) {
      c.dc_ctx = 0;
    } else {
      const int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m != 0) {
        st = dc_stats_[tbl] + 20;  // Table F.4: X1 = 20
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;
            return false;
          }
          ++st;
        }
      }
      // F.1.4.4.1.2: the conditioning category of the next difference
      if (m < static_cast<int>((1L << arith_dc_l_[tbl]) >> 1))
        c.dc_ctx = 0;
      else if (m > static_cast<int>((1L << arith_dc_u_[tbl]) >> 1))
        c.dc_ctx = 12 + sign * 4;
      else
        c.dc_ctx = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      c.dc_pred = (c.dc_pred + v) & 0xFFFF;
    }
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.dc_pred) << al);
    return true;
  }

  // decode_mcu / decode_mcu_AC_first, the AC coefficients ss..se of one
  // block
  bool arith_ac(Arith& ar, int tbl, int ss, int se, int al, int16_t* blk) {
    uint8_t* stats = ac_stats_[tbl];
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          ar.ct = -1;  // spectral overflow
          return false;
        }
      }
      uint8_t fixed = 113;
      const int sign = ar.decode(&fixed);
      st += 2;
      int m = ar.decode(st);
      if (m != 0 && ar.decode(st)) {
        m <<= 1;
        st = stats + (k <= arith_ac_k_[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ar.ct = -1;
            return false;
          }
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
    }
    return true;
  }

  // decode_mcu_AC_refine, one block
  bool arith_ac_refine(Arith& ar, int tbl, const Scan& sc, int16_t* blk) {
    uint8_t* stats = ac_stats_[tbl];
    const int p1 = 1 << sc.al, m1 = -1 * (1 << sc.al);
    int kex = sc.se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = sc.ss; k <= sc.se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {  // previously nonzero: a correction bit
          if (ar.decode(st + 2))
            *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {  // newly nonzero
          uint8_t fixed = 113;
          *coef = static_cast<int16_t>(ar.decode(&fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > sc.se) {
          ar.ct = -1;
          return false;
        }
      }
    }
    return true;
  }

  // --- block smoothing: jdcoefct.c smoothing_ok and decompress_smooth_data
  // of libjpeg-turbo 2.1 ---

  bool smoothing_ok() {
    if (!progressive_) return false;
    bool useful = false;
    for (int i = 0; i < ncomp_; ++i) {
      Comp& c = comp_[i];
      if (!c.latched) return false;
      for (int k = 0; k < kSaved; ++k)
        if (c.quantval[kNatural[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      c.latch[0] = c.coef_bits[0];
      for (int k = 1; k < kSaved; ++k) {
        c.prev_latch[k] = scans_ > 1 ? c.prev_bits[k] : -1;
        c.latch[k] = c.coef_bits[k];
        if (c.coef_bits[k] != 0) useful = true;
      }
    }
    return useful;
  }

  // Block row `by` of component c, with the estimated coefficients, for
  // block columns first..b1; emit(bx, block) for those from b0 on. The
  // DC values of the 5x5 neighbourhood slide through registers from the
  // column `first` (jpeg_crop_scanline's first_MCU_col), as in libjpeg:
  // left of it, and at the right edge, the registers keep earlier values.
  template <class F>
  void smooth_row(Comp& c, int by, int first, int b0, int b1, F&& emit) {
    const int last_row = mcuy_ - 1;
    const int R = by / c.v, br = by % c.v;
    int block_rows = c.v;
    if (R == last_row) {
      block_rows = c.bh % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int prev = (br > 0 || R > 0) ? by - 1 : by;
    int pprev = (br > 1 || R > 1) ? by - 2 : prev;
    const int next = (br < block_rows - 1 || R < last_row) ? by + 1 : by;
    int nnext = (br < block_rows - 2 || R + 1 < last_row) ? by + 2 : next;
    if (pil()) {
      // PIL's libjpeg-turbo 3.1 takes the rows two away wherever they
      // exist (below, a dummy row of the MCU grid counts), except for the
      // single block row of a last iMCU row that is the second
      pprev = R == 1 && block_rows == 1 ? prev : std::max(by - 2, 0);
      if (br < block_rows - 2 || R < last_row)
        nnext = std::min(by + 2, c.bh_alloc - 1);
    }
    const int rows[5] = {pprev, prev, by, next, nnext};
    const int* bits = R > last_good_ ? c.prev_latch : c.latch;
    bool change_dc = true;
    for (int k = 1; k < kSaved; ++k) change_dc = change_dc && bits[k] == -1;
    const long Q00 = c.quantval[0], Q01 = c.quantval[1], Q10 = c.quantval[8],
               Q20 = c.quantval[16], Q11 = c.quantval[9], Q02 = c.quantval[2],
               Q03 = c.quantval[3], Q12 = c.quantval[10], Q21 = c.quantval[17],
               Q30 = c.quantval[24];
    auto D = [&](int r, int col) -> int { return block(c, rows[r], col)[0]; };
    int dc[5][5];
    for (int r = 0; r < 5; ++r)
      for (int k = 0; k < 5; ++k) dc[r][k] = D(r, first);
    const int last_col = c.bw - 1;
    int16_t ws[64];
    for (int b = first; b <= b1; ++b) {
      if (pil()) {  // 3.1: the neighbours' columns clamped to the component
        for (int r = 0; r < 5; ++r)
          for (int k = 0; k < 5; ++k)
            dc[r][k] = D(r, std::min(std::max(b + k - 2, first), last_col));
      } else {
        if (b == first && b < last_col)
          for (int r = 0; r < 5; ++r) dc[r][3] = D(r, b + 1);
        if (b + 1 < last_col)
          for (int r = 0; r < 5; ++r) dc[r][4] = D(r, b + 2);
      }
      if (b >= b0) {
        std::memcpy(ws, block(c, by, b), sizeof ws);
        const int DC01 = dc[0][0], DC02 = dc[0][1], DC03 = dc[0][2],
                  DC04 = dc[0][3], DC05 = dc[0][4], DC06 = dc[1][0],
                  DC07 = dc[1][1], DC08 = dc[1][2], DC09 = dc[1][3],
                  DC10 = dc[1][4], DC11 = dc[2][0], DC12 = dc[2][1],
                  DC13 = dc[2][2], DC14 = dc[2][3], DC15 = dc[2][4],
                  DC16 = dc[3][0], DC17 = dc[3][1], DC18 = dc[3][2],
                  DC19 = dc[3][3], DC20 = dc[3][4], DC21 = dc[4][0],
                  DC22 = dc[4][1], DC23 = dc[4][2], DC24 = dc[4][3],
                  DC25 = dc[4][4];
        // an estimate goes only where the coefficient is still zero and
        // not known to full precision, capped below the next known bit
        auto est = [&](int k, int pos, long q, long num) {
          const int al = bits[k];
          if (al == 0 || ws[pos] != 0) return;
          num *= Q00;
          int pred;
          if (num >= 0) {
            pred = static_cast<int>(((q << 7) + num) / (q << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
          } else {
            pred = static_cast<int>(((q << 7) - num) / (q << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            pred = -pred;
          }
          ws[pos] = static_cast<int16_t>(pred);
        };
        if (change_dc) {
          est(1, 1, Q01, -DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                              13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 -
                              38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                              13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25);
          est(2, 8, Q10, -DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                              13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                              13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                              3 * DC22 + 3 * DC23 + 3 * DC24 + DC25);
          est(3, 16, Q20, DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                               14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 +
                               2 * DC19 + DC23);
          est(4, 9, Q11, -DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                              9 * DC19 + DC21 - DC25);
          est(5, 2, Q02, 2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                              14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 -
                              5 * DC18 + 2 * DC19);
          est(6, 3, Q03, DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
          est(7, 10, Q12, DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
          est(8, 17, Q21, DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
          est(9, 24, Q30, DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
          // the DC itself, interpolated with its average kept
          long num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 -
                            2 * DC05 - 6 * DC06 + 6 * DC07 + 42 * DC08 +
                            6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                            152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 +
                            6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                            2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                            2 * DC25);
          int pred = num >= 0
                         ? static_cast<int>(((Q00 << 7) + num) / (Q00 << 8))
                         : -static_cast<int>(((Q00 << 7) - num) / (Q00 << 8));
          ws[0] = static_cast<int16_t>(pred);
        } else {
          est(1, 1, Q01, -7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15);
          est(2, 8, Q10, -7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23);
          est(3, 16, Q20, -DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23);
          est(4, 9, Q11, DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                              DC22 - DC24 + DC04 - DC06 + 10 * DC07 -
                              10 * DC09);
          est(5, 2, Q02, -DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15);
        }
        emit(b, ws);
      }
      for (int r = 0; r < 5; ++r) {
        dc[r][0] = dc[r][1];
        dc[r][1] = dc[r][2];
        dc[r][2] = dc[r][3];
        dc[r][3] = dc[r][4];
      }
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

  // `first`: the block column block smoothing starts its registers at
  void make_plane(Comp& c, Plane& pl, bool smooth, int first) {
    pl.hexp = hmax_ / c.h;
    pl.vexp = vmax_ / c.v;
    const int he = pl.hexp, ve = pl.vexp;
    if (lossless_) {  // no fancy upsampling without a DCT (jdsample.c)
      pl.up = he == 1 && ve == 1 ? kFull : kRepl;
      pl.r0 = pl.c0 = 0;
      pl.stride = c.bw_alloc;
      pl.px.assign(static_cast<size_t>(c.bh_alloc) * pl.stride, 0);
      if (c.scanned) lossless_samples(c, pl.px, pl.stride);
      return;
    }
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
    auto dst = [&](int by, int bx) {
      return pl.px.data() + static_cast<size_t>(by - br0) * 8 * pl.stride +
             (bx - bc0) * 8;
    };
    for (int by = br0; by <= br1; ++by) {
      if (smooth) {
        smooth_row(c, by, std::min(first, bc0), bc0, bc1,
                   [&](int bx, const int16_t* ws) {
                     idct_islow(ws, c.quant, dst(by, bx), pl.stride);
                   });
      } else {
        for (int bx = bc0; bx <= bc1; ++bx)
          idct_islow(block(c, by, bx), c.quant, dst(by, bx), pl.stride);
      }
    }
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

  // The block column a region decode's smoothing starts at in component c:
  // jpeg_crop_scanline's first_MCU_col, from the column the JAX package's
  // binding asks for (8 pixels left of the region) aligned down to an iMCU.
  int first_col(const Comp& c) const {
    if (pil()) return 0;  // PIL decodes the whole image
    const int mx0 = x0_ > 8 ? x0_ - 8 : 0;
    const int align = ncomp_ == 1 ? 8 : 8 * hmax_;
    const int hsf = ncomp_ == 1 ? 1 : c.h;
    return (mx0 / align) * align * hsf / align;
  }

  // what output() writes
  long output_size() const {
    long blocks = 0;
    for (int i = 0; i < ncomp_; ++i) blocks += 1L * comp_[i].bw * comp_[i].bh;
    if (tiff_color_ == 2) return 64 * blocks;
    const bool planes = tiff_color_ == 0 || (tiff_color_ == 1 && ncomp_ != 3);
    return static_cast<long>(cw_) * ch_ * (planes ? ncomp_ : 3);
  }

  void output(uint8_t* out) {
    if (tiff_color_ == 2) {  // each component's blocks, in turn
      for (int i = 0; i < ncomp_; ++i) {
        Comp& c = comp_[i];
        const int stride = c.bw * 8;
        for (int by = 0; by < c.bh; ++by)
          for (int bx = 0; bx < c.bw; ++bx)
            idct_islow(block(c, by, bx), c.quant,
                       out + static_cast<size_t>(by) * 8 * stride + bx * 8,
                       stride);
        out += static_cast<size_t>(c.bh) * 8 * stride;
      }
      return;
    }
    const bool smooth = !lossless_ && smoothing_ok();
    Plane pl[4];
    for (int i = 0; i < ncomp_; ++i)
      make_plane(comp_[i], pl[i], smooth, first_col(comp_[i]));
    const Tables& t = tables();
    std::vector<uint8_t> rows(static_cast<size_t>(4) * cw_);
    uint8_t* r0 = rows.data();
    uint8_t* r1 = r0 + cw_;
    uint8_t* r2 = r1 + cw_;
    uint8_t* r3 = r2 + cw_;
    if (tiff_color_ == 0 || (tiff_color_ == 1 && ncomp_ != 3)) {
      uint8_t* r[4] = {r0, r1, r2, r3};
      for (int yy = 0; yy < ch_; ++yy) {
        uint8_t* o = out + static_cast<size_t>(yy) * cw_ * ncomp_;
        for (int k = 0; k < ncomp_; ++k) {
          upsample_row(comp_[k], pl[k], y0_ + yy, r[k]);
          for (int i = 0; i < cw_; ++i) o[ncomp_ * i + k] = r[k][i];
        }
      }
      return;
    }
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
      if (color_ == kYCbCr) {
        for (int i = 0; i < cw_; ++i) {
          int yv = r0[i], cb = r1[i], cr = r2[i];
          o[3 * i] = clamp255(yv + t.cr_r[cr]);
          o[3 * i + 1] = clamp255(
              yv + static_cast<int>((t.cb_g[cb] + t.cr_g[cr]) >> kScaleBits));
          o[3 * i + 2] = clamp255(yv + t.cb_b[cb]);
        }
        continue;
      }
      upsample_row(comp_[3], pl[3], y, r3);
      for (int i = 0; i < cw_; ++i) {
        int cmy[3] = {r0[i], r1[i], r2[i]};
        if (color_ == kYCCK) {  // jdcolor.c ycck_cmyk_convert
          int yv = r0[i], cb = r1[i], cr = r2[i];
          cmy[0] = clamp255(255 - (yv + t.cr_r[cr]));
          cmy[1] = clamp255(255 - (yv + static_cast<int>(
                                           (t.cb_g[cb] + t.cr_g[cr]) >> kScaleBits)));
          cmy[2] = clamp255(255 - (yv + t.cb_b[cb]));
        }
        // PIL reads 4-component JPEG as inverted CMYK ("CMYK;I"), then
        // Convert.c cmyk2rgb: nk - nk * c / 255 with its rounding
        const int nk = r3[i];  // 255 - (255 - K)
        for (int k = 0; k < 3; ++k) {
          const int ci = 255 - cmy[k];
          const int tmp = ci * nk + 128;
          o[3 * i + k] = clamp255(nk - (((tmp >> 8) + tmp) >> 8));
        }
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

// A decode, again with PIL's feed replayed where its data ends inside a
// sequential single-scan image (PilFeed).
void decode_fed(const unsigned char* buf, size_t len, int mode, bool region,
                int x0, int y0, int cw, int ch, unsigned char* out) {
  try {
    Decoder(buf, len, mode, region).decode(x0, y0, cw, ch, out);
  } catch (const NeedFeed&) {
    Decoder(buf, len, mode, region, true).decode(x0, y0, cw, ch, out);
  }
}

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
// with fastjpeg_dims first). `mode` 0 decodes as the JAX package's libjpeg
// binding, 1 as PIL (Mode above; 4 components always as PIL). 0 on success
// (w, h filled), -1 for a broken or truncated stream, -2 for one this
// codec refuses by name.
int fastjpeg_decode_rgb8(const unsigned char* buf, long len,
                         unsigned char* out, long out_cap, int* w, int* h,
                         int mode) {
  return guarded([&] {
    int W = 0, H = 0;
    bool to_pil = false;
    Decoder(buf, static_cast<size_t>(len)).dims(&W, &H, &to_pil);
    if (static_cast<long>(W) * H * 3 > out_cap)
      CORRUPT("JPEG: output buffer too small");
    decode_fed(buf, static_cast<size_t>(len), to_pil ? kPil : mode, false, 0,
               0, W, H, out);
    *w = W;
    *h = H;
  });
}

// Region decode: the pixels [y0, y0+ch) x [x0, x0+cw) that the JAX
// package's loader gets (libjpeg's region decode, or for 4 components
// PIL's full decode cropped), decoding only the iMCU rows and blocks the
// region needs. 0 on success, -1 or -2 as above, -3 when the region is not
// inside the image.
int fastjpeg_decode_crop_rgb8(const unsigned char* buf, long len, int x0,
                              int y0, int cw, int ch, unsigned char* out,
                              long out_cap) {
  int W = 0, H = 0;
  bool to_pil = false;
  int rc = guarded([&] {
    Decoder(buf, static_cast<size_t>(len)).dims(&W, &H, &to_pil);
  });
  if (rc) return rc;
  if (x0 < 0 || y0 < 0 || cw <= 0 || ch <= 0 || x0 + cw > W || y0 + ch > H ||
      static_cast<long>(cw) * ch * 3 > out_cap) {
    std::snprintf(g_error, sizeof g_error, "region outside the image");
    return -3;
  }
  return guarded([&] {
    decode_fed(buf, static_cast<size_t>(len), to_pil ? kPil : kLibjpeg, true,
               x0, y0, cw, ch, out);
  });
}

// A JPEG strip or tile of a TIFF, as libtiff 4.7 decodes it through
// libjpeg (its memory source: the data ends in fake EOI markers): `color`
// 1 forces YCbCr -> RGB (JPEGCOLORMODE_RGB on a YCbCr image), 0 gives the
// components as they are (JCS_UNKNOWN). Probe first with out == NULL:
// fills w, h, the component count and component 0's sampling factors.
// out holds w*h*ncomp bytes (3 with color 1). 0 on success, -1 or -2 as
// above.
int fastjpeg_decode_tiff(const unsigned char* buf, long len, int color,
                         unsigned char* out, long out_cap, int* info) {
  return guarded([&] {
    int W = 0, H = 0;
    // the headers need no padding: the probes read them as they are
    Decoder probe(buf, static_cast<size_t>(len), kPil);
    probe.dims(&W, &H);
    if (!out) {
      Decoder d(buf, static_cast<size_t>(len), kPil);
      d.tiff_color(color);
      d.header_only();
      info[0] = W;
      info[1] = H;
      info[2] = d.components();
      info[3] = d.h_samp(0);
      info[4] = d.v_samp(0);
      int others = 1;
      for (int i = 1; i < d.components(); ++i)
        others &= d.h_samp(i) == 1 && d.v_samp(i) == 1;
      info[5] = others;
      return;
    }
    Decoder d(buf, static_cast<size_t>(len), kLibjpeg);
    d.tiff_color(color);
    const long nc = color == 1 ? 3 : info[2];
    if (static_cast<long>(W) * H * nc > out_cap)
      CORRUPT("JPEG: output buffer too small");
    d.decode(0, 0, W, H, out);
  });
}

// An old-style JPEG TIFF's stream, as libtiff's tif_ojpeg.c has libjpeg
// read it (the stream is libtiff's own: its tables, frame and scan headers
// before the strips' data, restart markers between strips, an EOI after
// the last): raw 1 gives each component's samples before upsampling
// (jpeg_read_raw_data: width_in_blocks x height_in_blocks blocks each, the
// components in turn), 0 the components upsampled (JCS_UNKNOWN
// scanlines). The data ends where libtiff's source does: reading past it
// is libjpeg's fatal error, which leaves the iMCU rows from the one being
// decoded on undecoded. Probe with out == NULL: the headers only, into
// info: W, H, components, max h, max v, -1, then each component's h, v.
// Then decode with the probe's info and out sized from it: info[5] becomes
// the iMCU row the data ran out in (-1 for none). 0 on success, -1 or -2
// for a stream libjpeg refuses before its scan.
int fastjpeg_decode_ojpeg(const unsigned char* buf, long len, int raw,
                          unsigned char* out, long out_cap, int* info) {
  return guarded([&] {
    Decoder d(buf, static_cast<size_t>(len), kLibjpeg, false, false, true);
    d.tiff_color(raw ? 2 : 0);
    if (out) {
      d.decode(0, 0, info[0], info[1], out, out_cap);
      info[5] = d.failed_row();
      return;
    }
    d.header_only();
    info[0] = d.width();
    info[1] = d.height();
    info[2] = d.components();
    info[3] = d.h_max();
    info[4] = d.v_max();
    info[5] = -1;
    for (int i = 0; i < d.components(); ++i) {
      info[6 + 2 * i] = d.h_samp(i);
      info[7 + 2 * i] = d.v_samp(i);
    }
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
