// Run-length and colour loops of the legacy raster formats PIL opens,
// decoded as PIL 12.1's C decoders do (native/legacy.py parses the
// headers and unpacks the rows): Targa RLE, PCX RLE, SGI RLE, Sun raster
// RLE, PSD's PackBits and Kodak PhotoCD's YCC base image. No library is
// needed.
//
// Each decoder writes raw rows (the bytes PIL's decoder hands its row
// unpacker) and returns 0 when the image is whole, -1 where PIL's decoder
// sets an error (a run past the row, a table entry past the file) and -2
// where the data ends before the image is whole (PIL's "image file is
// truncated").
#include <cstdint>
#include <cstring>

namespace {

// ImagingUnpackYCC's tables (UnpackYCC.c), read off PIL's decodes:
// R = L[y] + CrR[cr], G = L[y] + CrG[cr] + CbG[cb], B = L[y] + CbB[cb],
// each clipped to 0..255
static const int16_t kYccL[256] = {
    0, 1, 3, 4, 5, 7, 8, 10, 11, 12, 14, 15, 16, 18, 19, 20,
    22, 23, 24, 26, 27, 29, 30, 31, 33, 34, 35, 37, 38, 39, 41, 42,
    43, 45, 46, 48, 49, 50, 52, 53, 54, 56, 57, 58, 60, 61, 62, 64,
    65, 67, 68, 69, 71, 72, 73, 75, 76, 77, 79, 80, 82, 83, 84, 86,
    87, 88, 90, 91, 92, 94, 95, 96, 98, 99, 101, 102, 103, 105, 106, 107,
    109, 110, 111, 113, 114, 115, 117, 118, 120, 121, 122, 124, 125, 126, 128, 129,
    130, 132, 133, 134, 136, 137, 139, 140, 141, 143, 144, 145, 147, 148, 149, 151,
    152, 153, 155, 156, 158, 159, 160, 162, 163, 164, 166, 167, 168, 170, 171, 173,
    174, 175, 177, 178, 179, 181, 182, 183, 185, 186, 187, 189, 190, 192, 193, 194,
    196, 197, 198, 200, 201, 202, 204, 205, 206, 208, 209, 211, 212, 213, 215, 216,
    217, 219, 220, 221, 223, 224, 225, 227, 228, 230, 231, 232, 234, 235, 236, 238,
    239, 240, 242, 243, 245, 246, 247, 249, 250, 251, 253, 254, 255, 257, 258, 259,
    261, 262, 264, 265, 266, 268, 269, 270, 272, 273, 274, 276, 277, 278, 280, 281,
    283, 284, 285, 287, 288, 289, 291, 292, 293, 295, 296, 297, 299, 300, 302, 303,
    304, 306, 307, 308, 310, 311, 312, 314, 315, 317, 318, 319, 321, 322, 323, 325,
    326, 327, 329, 330, 331, 333, 334, 336, 337, 338, 340, 341, 342, 344, 345, 346,
};
static const int16_t kYccCrR[256] = {
    -249, -247, -245, -243, -241, -239, -238, -236, -234, -232, -230, -229, -227, -225, -223, -221,
    -219, -218, -216, -214, -212, -210, -208, -207, -205, -203, -201, -199, -198, -196, -194, -192,
    -190, -188, -187, -185, -183, -181, -179, -178, -176, -174, -172, -170, -168, -167, -165, -163,
    -161, -159, -157, -156, -154, -152, -150, -148, -147, -145, -143, -141, -139, -137, -136, -134,
    -132, -130, -128, -127, -125, -123, -121, -119, -117, -116, -114, -112, -110, -108, -106, -105,
    -103, -101, -99, -97, -96, -94, -92, -90, -88, -86, -85, -83, -81, -79, -77, -76,
    -74, -72, -70, -68, -66, -65, -63, -61, -59, -57, -55, -54, -52, -50, -48, -46,
    -45, -43, -41, -39, -37, -35, -34, -32, -30, -28, -26, -25, -23, -21, -19, -17,
    -15, -14, -12, -10, -8, -6, -4, -3, -1, 0, 2, 4, 5, 7, 9, 11,
    13, 15, 16, 18, 20, 22, 24, 26, 27, 29, 31, 33, 35, 36, 38, 40,
    42, 44, 46, 47, 49, 51, 53, 55, 56, 58, 60, 62, 64, 66, 67, 69,
    71, 73, 75, 77, 78, 80, 82, 84, 86, 87, 89, 91, 93, 95, 97, 98,
    100, 102, 104, 106, 107, 109, 111, 113, 115, 117, 118, 120, 122, 124, 126, 128,
    129, 131, 133, 135, 137, 138, 140, 142, 144, 146, 148, 149, 151, 153, 155, 157,
    158, 160, 162, 164, 166, 168, 169, 171, 173, 175, 177, 179, 180, 182, 184, 186,
    188, 189, 191, 193, 195, 197, 199, 200, 202, 204, 206, 208, 209, 211, 213, 215,
};
static const int16_t kYccCrG[256] = {
    127, 126, 125, 124, 123, 122, 121, 121, 120, 119, 118, 117, 116, 115, 114, 113,
    112, 111, 110, 109, 108, 108, 107, 106, 105, 104, 103, 102, 101, 100, 99, 98,
    97, 96, 95, 95, 94, 93, 92, 91, 90, 89, 88, 87, 86, 85, 84, 83,
    83, 82, 81, 80, 79, 78, 77, 76, 75, 74, 73, 72, 71, 70, 70, 69,
    68, 67, 66, 65, 64, 63, 62, 61, 60, 59, 58, 57, 57, 56, 55, 54,
    53, 52, 51, 50, 49, 48, 47, 46, 45, 45, 44, 43, 42, 41, 40, 39,
    38, 37, 36, 35, 34, 33, 32, 32, 31, 30, 29, 28, 27, 26, 25, 24,
    23, 22, 21, 20, 19, 19, 18, 17, 16, 15, 14, 13, 12, 11, 10, 9,
    8, 7, 6, 6, 5, 4, 3, 2, 1, 0, 0, -1, -2, -3, -4, -5,
    -5, -6, -7, -8, -9, -10, -11, -12, -13, -14, -15, -16, -17, -18, -18, -19,
    -20, -21, -22, -23, -24, -25, -26, -27, -28, -29, -30, -31, -31, -32, -33, -34,
    -35, -36, -37, -38, -39, -40, -41, -42, -43, -44, -44, -45, -46, -47, -48, -49,
    -50, -51, -52, -53, -54, -55, -56, -56, -57, -58, -59, -60, -61, -62, -63, -64,
    -65, -66, -67, -68, -69, -69, -70, -71, -72, -73, -74, -75, -76, -77, -78, -79,
    -80, -81, -82, -82, -83, -84, -85, -86, -87, -88, -89, -90, -91, -92, -93, -94,
    -94, -95, -96, -97, -98, -99, -100, -101, -102, -103, -104, -105, -106, -107, -107, -108,
};
static const int16_t kYccCbG[256] = {
    67, 67, 66, 66, 65, 65, 65, 64, 64, 63, 63, 62, 62, 62, 61, 61,
    60, 60, 59, 59, 59, 58, 58, 57, 57, 56, 56, 56, 55, 55, 54, 54,
    53, 53, 52, 52, 52, 51, 51, 50, 50, 49, 49, 49, 48, 48, 47, 47,
    46, 46, 46, 45, 45, 44, 44, 43, 43, 43, 42, 42, 41, 41, 40, 40,
    40, 39, 39, 38, 38, 37, 37, 37, 36, 36, 35, 35, 34, 34, 34, 33,
    33, 32, 32, 31, 31, 31, 30, 30, 29, 29, 28, 28, 28, 27, 27, 26,
    26, 25, 25, 25, 24, 24, 23, 23, 22, 22, 22, 21, 21, 20, 20, 19,
    19, 19, 18, 18, 17, 17, 16, 16, 15, 15, 15, 14, 14, 13, 13, 12,
    12, 12, 11, 11, 10, 10, 9, 9, 9, 8, 8, 7, 7, 6, 6, 6,
    5, 5, 4, 4, 3, 3, 3, 2, 2, 1, 1, 0, 0, 0, 0, 0,
    -1, -1, -2, -2, -2, -3, -3, -4, -4, -5, -5, -5, -6, -6, -7, -7,
    -8, -8, -8, -9, -9, -10, -10, -11, -11, -11, -12, -12, -13, -13, -14, -14,
    -14, -15, -15, -16, -16, -17, -17, -18, -18, -18, -19, -19, -20, -20, -21, -21,
    -21, -22, -22, -23, -23, -24, -24, -24, -25, -25, -26, -26, -27, -27, -27, -28,
    -28, -29, -29, -30, -30, -30, -31, -31, -32, -32, -33, -33, -33, -34, -34, -35,
    -35, -36, -36, -36, -37, -37, -38, -38, -39, -39, -39, -40, -40, -41, -41, -42,
};
static const int16_t kYccCbB[256] = {
    -345, -343, -341, -338, -336, -334, -332, -329, -327, -325, -323, -321, -318, -316, -314, -312,
    -310, -307, -305, -303, -301, -298, -296, -294, -292, -290, -287, -285, -283, -281, -278, -276,
    -274, -272, -270, -267, -265, -263, -261, -258, -256, -254, -252, -250, -247, -245, -243, -241,
    -239, -236, -234, -232, -230, -227, -225, -223, -221, -219, -216, -214, -212, -210, -207, -205,
    -203, -201, -199, -196, -194, -192, -190, -188, -185, -183, -181, -179, -176, -174, -172, -170,
    -168, -165, -163, -161, -159, -156, -154, -152, -150, -148, -145, -143, -141, -139, -137, -134,
    -132, -130, -128, -125, -123, -121, -119, -117, -114, -112, -110, -108, -105, -103, -101, -99,
    -97, -94, -92, -90, -88, -85, -83, -81, -79, -77, -74, -72, -70, -68, -66, -63,
    -61, -59, -57, -54, -52, -50, -48, -46, -43, -41, -39, -37, -34, -32, -30, -28,
    -26, -23, -21, -19, -17, -15, -12, -10, -8, -6, -3, -1, 0, 2, 4, 7,
    9, 11, 13, 16, 18, 20, 22, 24, 27, 29, 31, 33, 35, 38, 40, 42,
    44, 47, 49, 51, 53, 55, 58, 60, 62, 64, 67, 69, 71, 73, 75, 78,
    80, 82, 84, 86, 89, 91, 93, 95, 98, 100, 102, 104, 106, 109, 111, 113,
    115, 118, 120, 122, 124, 126, 129, 131, 133, 135, 138, 140, 142, 144, 146, 149,
    151, 153, 155, 157, 160, 162, 164, 166, 169, 171, 173, 175, 177, 180, 182, 184,
    186, 189, 191, 193, 195, 197, 200, 202, 204, 206, 208, 211, 213, 215, 217, 220,
};

inline uint8_t clip8(int v) {
  return static_cast<uint8_t>(v <= 0 ? 0 : (v >= 255 ? 255 : v));
}

}  // namespace

extern "C" {

// TgaRleDecode.c: packets of `unit` bytes a pixel (PIL's depth / 8, so a
// 1-bit image never fills a row); a run may not cross a row (overrun), a
// literal flows on into the next rows. Rows come out in decode order.
int f101tga_rle(const uint8_t* src, long n, uint8_t* out, long row_bytes,
                long rows, int unit) {
  long pos = 0, x = 0, y = 0;
  while (true) {
    if (pos >= n) return -2;
    const long count = static_cast<long>(unit) * ((src[pos] & 0x7f) + 1);
    long take = count, extra = 0;
    if (src[pos] & 0x80) {
      if (n - pos < 1 + unit) return -2;
      if (x + count > row_bytes) return -1;
      for (long i = 0; i < count; i += unit)
        std::memcpy(out + y * row_bytes + x + i, src + pos + 1, unit);
      pos += 1 + unit;
    } else {
      if (n - pos < 1 + count) return -2;
      if (x + count > row_bytes) {
        take = row_bytes - x;
        extra = count - take;
      }
      std::memcpy(out + y * row_bytes + x, src + pos + 1, take);
      pos += 1 + take;
    }
    while (true) {
      x += take;
      if (x >= row_bytes) {
        x = 0;
        if (++y >= rows) return 0;
      }
      if (extra == 0 || x > 0) break;
      take = extra >= row_bytes ? row_bytes : extra;
      std::memcpy(out + y * row_bytes, src + pos, take);
      pos += take;
      extra -= take;
    }
  }
}

// PcxDecode.c: a byte with its two top bits set is a run of its low six
// bits of the next byte, anything else a literal; rows of row_bytes (the
// planes times PIL's stride). A run past the row is an error.
int f101pcx_rle(const uint8_t* src, long n, uint8_t* out, long row_bytes,
                long rows) {
  long pos = 0, x = 0, y = 0;
  bool overrun = false;
  while (true) {
    if (pos >= n) return -2;
    uint8_t* row = out + y * row_bytes;
    if ((src[pos] & 0xC0) == 0xC0) {
      if (n - pos < 2) return -2;
      for (int k = src[pos] & 0x3F; k > 0; --k) {
        if (x >= row_bytes) {
          overrun = true;
          break;
        }
        row[x++] = src[pos + 1];
      }
      pos += 2;
    } else {
      row[x++] = src[pos++];
    }
    if (x >= row_bytes) {
      x = 0;
      if (++y >= rows) return overrun ? -1 : 0;
    }
  }
}

// SunRleDecode.c: 0x80 0x00 is a literal 0x80, 0x80 n v a run of n + 1
// v's (flowing on into the next rows), anything else a literal byte.
int f101sun_rle(const uint8_t* src, long n, uint8_t* out, long row_bytes,
                long rows) {
  long pos = 0, x = 0, y = 0;
  while (true) {
    if (pos >= n) return -2;
    long take = 1, extra = 0;
    uint8_t value = src[pos];
    if (src[pos] == 0x80) {
      if (n - pos < 2) return -2;
      if (src[pos + 1] == 0) {
        pos += 2;
      } else {
        if (n - pos < 3) return -2;
        take = src[pos + 1] + 1;
        value = src[pos + 2];
        if (x + take > row_bytes) {
          extra = take - (row_bytes - x);
          take = row_bytes - x;
        }
        pos += 3;
      }
    } else {
      pos += 1;
    }
    std::memset(out + y * row_bytes + x, value, take);
    while (true) {
      x += take;
      if (x >= row_bytes) {
        x = 0;
        if (++y >= rows) return 0;
      }
      if (extra == 0 || x > 0) break;
      take = extra >= row_bytes ? row_bytes : extra;
      std::memset(out + y * row_bytes, value, take);
      extra -= take;
    }
  }
}

// SgiRleDecode.c over the file after its 512-byte header (`body`, n
// bytes): the start and length tables (bands x rows each, big-endian;
// a start before the body is an error), then each row's channels through
// expandrow (bpc 1) or expandrow2 (bpc 2) into one row buffer that is
// never cleared, copied out after each row. Rows come out in file order (the bottom row first). A packet that
// ends a row's length early stops the whole decode without an error, as
// in PIL; rows not reached stay as the caller filled them.
namespace {
int expand_row(uint8_t* dest, const uint8_t* buf, long src, long len, int z,
               long xsize, long last, int bpc) {
  long x = 0;
  for (long k = len; k > 0; --k) {
    uint8_t pixel;
    if (bpc == 1) {
      if (src > last) return -1;
      pixel = buf[src++];
    } else {
      if (src + 1 > last) return -1;
      pixel = buf[src + 1];
      src += 2;
    }
    if (k == 1 && pixel != 0) return 1;
    int count = pixel & 0x7f;
    if (!count) return 0;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + static_cast<long>(bpc) * count > last) return -1;
      while (count--) {
        std::memcpy(dest, buf + src, bpc);
        src += bpc;
        dest += z * bpc;
      }
    } else {
      if (src + (bpc == 1 ? 0 : 2) > last) return -1;
      const uint8_t* v = buf + src;
      while (count--) {
        std::memcpy(dest, v, bpc);
        dest += z * bpc;
      }
      src += bpc;
    }
  }
  return 0;
}
}  // namespace

int f101sgi_rle(const uint8_t* body, long n, uint8_t* out, long xsize,
                long ysize, int bands, int bpc) {
  const long tablen = static_cast<long>(bands) * ysize;
  if (n < 8 * tablen) return -1;
  auto be32 = [&](long at) {
    return (static_cast<uint64_t>(body[at]) << 24) |
           (static_cast<uint64_t>(body[at + 1]) << 16) |
           (static_cast<uint64_t>(body[at + 2]) << 8) | body[at + 3];
  };
  const long row_bytes = xsize * bands * bpc;
  uint8_t* buffer = new uint8_t[row_bytes > 0 ? row_bytes : 1]();
  int rc = 0;
  for (long row = 0; row < ysize && rc == 0; ++row) {
    for (int ch = 0; ch < bands; ++ch) {
      uint64_t off = be32(4 * (row + ch * ysize));
      // PIL reads the length into an int: past 2^31 it is negative, and
      // the row is left as the buffer holds it; a length past the file
      // is not checked (the packets stop at their own end)
      const long len =
          static_cast<int32_t>(be32(4 * (tablen + row + ch * ysize)));
      if (off < 512) {
        rc = -1;
        break;
      }
      off -= 512;
      const int status = expand_row(buffer + ch * bpc, body,
                                    static_cast<long>(off), len, bands, xsize,
                                    n - 1, bpc);
      if (status == -1) {
        rc = -1;
        break;
      }
      if (status == 1) {
        rc = 1;
        break;
      }
    }
    if (rc == 0) std::memcpy(out + row * row_bytes, buffer, row_bytes);
  }
  delete[] buffer;
  return rc < 0 ? -1 : 0;
}

// PcdDecode.c with the "YCC;P" unpacker: chunks of two luma rows and one
// row each of half-width C1 and C2 -> RGB rows of 768 x 512.
int f101pcd_rgb(const uint8_t* src, long n, uint8_t* out) {
  const long w = 768, h = 512, chunk = 3 * w;
  if (n < chunk * (h / 2)) return -2;
  for (long k = 0; k < h / 2; ++k) {
    const uint8_t* p = src + k * chunk;
    for (int line = 0; line < 2; ++line) {
      uint8_t* o = out + (2 * k + line) * w * 3;
      for (long x = 0; x < w; ++x) {
        const int l = kYccL[p[x + line * w]];
        const int cb = p[(x + 4 * w) / 2], cr = p[(x + 5 * w) / 2];
        o[3 * x] = clip8(l + kYccCrR[cr]);
        o[3 * x + 1] = clip8(l + kYccCrG[cr] + kYccCbG[cb]);
        o[3 * x + 2] = clip8(l + kYccCbB[cb]);
      }
    }
  }
  return 0;
}

// PackDecode.c over one tile of ``rows`` rows of ``row`` bytes: a single
// stream from the tile's offset to the end of the data, packets taken
// whole (0x80 is a no-op), a run or literal cut where its row ends (the
// rest of it dropped, not carried to the next row).
int f101packbits(const uint8_t* src, long n, uint8_t* out, long row,
                 long rows) {
  long i = 0, x = 0, y = 0;
  if (rows <= 0 || row <= 0) return 0;
  for (;;) {
    if (i >= n) return -2;
    const uint8_t c = src[i];
    if (c == 0x80) {
      ++i;
      continue;
    }
    if (c & 0x80) {
      if (n - i < 2) return -2;
      for (int k = 257 - c; k > 0 && x < row; --k) out[y * row + x++] = src[i + 1];
      i += 2;
    } else {
      const long k = c + 2;
      if (n - i < k) return -2;
      for (long j = 1; j < k && x < row; ++j) out[y * row + x++] = src[i + j];
      i += k;
    }
    if (x >= row) {
      x = 0;
      if (++y >= rows) return 0;
    }
  }
}

}  // extern "C"
