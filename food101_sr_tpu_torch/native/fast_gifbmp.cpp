// GIF and BMP pixel decoding for the port's request decoder, without a
// library: what PIL's Image.open(...).convert("RGB") gives, which is how
// the JAX package's server reads an upload.
//
// As for PNG, the container is parsed in Python (native/__init__.py); this
// unit does the per-pixel work:
//   - GIF: the LZW decoder of PIL's libImaging/GifDecode.c (codes of 3 to
//     12 bits, the string table, clear codes, the code KwKwK, a full table
//     kept until the next clear) and its row order, interlaced or not.
//   - BMP: rows of 1/4/8-bit indices, 16-bit 5-5-5 and 5-6-5, 24-bit BGR
//     and 32-bit pixels with byte-aligned channel masks, bottom-up or
//     top-down, as PIL's raw modes unpack them; and PIL's RLE8/RLE4
//     decoder (BmpImagePlugin.BmpRleDecoder), quirks included.
//
// Build: g++ -O3 -shared -fPIC fast_gifbmp.cpp -o libfast_gifbmp.so (no
// library; native/__init__.py builds it on first use into _build/). ctypes
// releases the GIL for each call.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kTable = 4096;  // GIFTABLE: 12-bit codes

}  // namespace

extern "C" {

// LZW-decode the data sub-blocks at `blocks` (n bytes: length-prefixed
// blocks as in the file) into `out`, a w x h frame of palette indices,
// rows in interlaced order if `interlace`. `bits` is the minimum code
// size. Returns 0 once every pixel is written (PIL stops there), 1 if the
// end code, the end of the blocks or of the data comes first (PIL then
// reads on past the image and fails), -1 for a code PIL refuses.
int f101gif_lzw(const uint8_t* blocks, long n, int bits, int interlace,
                uint8_t* out, int w, int h) {
  if (bits < 0 || bits > 12 || w <= 0 || h <= 0) return -1;
  const int clear = 1 << bits, end = clear + 1;
  std::vector<uint8_t> data(kTable), stack(kTable);
  std::vector<uint16_t> link(kTable);
  int next = clear + 2, codesize = bits + 1, codemask = (1 << codesize) - 1;
  int state = 2;  // 2: first code after a clear; 3: in a string
  int lastcode = 0, lastdata = 0;
  uint32_t bitbuf = 0;
  int bitcount = 0;
  long pos = 0, blockleft = 0;
  int x = 0, y = 0, step = interlace ? 8 : 1, pass = interlace ? 1 : 0;
  for (;;) {
    while (bitcount < codesize) {
      if (blockleft > 0) {
        bitbuf |= static_cast<uint32_t>(blocks[pos++]) << bitcount;
        bitcount += 8;
        --blockleft;
      } else {
        // a new sub-block, decoded only when whole
        if (pos >= n) return 1;
        const int len = blocks[pos];
        if (pos + 1 + len > n) return 1;
        if (len == 0) return 1;  // the terminator: PIL reads on and fails
        blockleft = len;
        ++pos;
      }
    }
    int c = static_cast<int>(bitbuf & static_cast<uint32_t>(codemask));
    bitbuf >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      state = 2;
      continue;
    }
    if (c == end) return 1;
    int len = 1, top = kTable;
    if (state == 2) {
      if (c > clear) return -1;
      lastdata = lastcode = c;
      state = 3;
      stack[--top] = static_cast<uint8_t>(c);
    } else {
      const int thiscode = c;
      if (c > next) return -1;
      if (c == next) {
        stack[--top] = static_cast<uint8_t>(lastdata);
        c = lastcode;
      }
      while (c >= clear) {
        if (top <= 0 || c >= kTable) return -1;
        stack[--top] = data[c];
        c = link[c];
      }
      lastdata = c;
      stack[--top] = static_cast<uint8_t>(c);
      if (next < kTable) {
        data[next] = static_cast<uint8_t>(c);
        link[next] = static_cast<uint16_t>(lastcode);
        if (next == codemask && codesize < 12) {
          ++codesize;
          codemask = (1 << codesize) - 1;
        }
        ++next;
      }
      lastcode = thiscode;
    }
    len = kTable - top;
    for (int i = 0; i < len; ++i) {
      out[static_cast<long>(y) * w + x] = stack[top + i];
      if (++x >= w) {  // NEWLINE: the next row, or the next pass
        x = 0;
        y += step;
        while (y >= h) {
          if (pass == 1) {
            y = 4;
            pass = 2;
          } else if (pass == 2) {
            step = 4;
            y = 2;
            pass = 3;
          } else if (pass == 3) {
            step = 2;
            y = 1;
            pass = 0;
          } else {
            return 0;
          }
        }
      }
    }
  }
}

// Raw BMP rows -> RGB8 (w x h). `src` holds h rows of `stride` bytes,
// the first one at the bottom of the image unless `top_down`. `kind`:
//   1, 4, 8: palette indices of that many bits, looked up in `pal` (256
//            RGB entries);
//   15, 16:  16-bit little-endian 5-5-5 or 5-6-5 (PIL's BGR;15, BGR;16:
//            each field scaled as v * 255 / max);
//   24:      BGR;
//   32:      a little-endian 32-bit pixel whose red, green and blue are
//            the bytes at shifts rs, gs, bs.
// Returns 0, or -1 if `src` is too short for the rows (PIL's raw decoder
// needs every row's stride but the last one's padding).
int f101bmp_rows(const uint8_t* src, long n, int w, int h, long stride,
                 int top_down, int kind, const uint8_t* pal, int rs, int gs,
                 int bs, uint8_t* out) {
  const long bits = kind <= 8 ? kind : kind == 15 ? 16 : kind;
  if (stride * (h - 1) + (w * bits + 7) / 8 > n) return -1;
  for (int r = 0; r < h; ++r) {
    const uint8_t* row = src + stride * (top_down ? r : h - 1 - r);
    uint8_t* o = out + static_cast<long>(r) * w * 3;
    for (int x = 0; x < w; ++x, o += 3) {
      if (kind <= 8) {
        int idx;
        if (kind == 8) {
          idx = row[x];
        } else {
          const int per = 8 / kind, sh = 8 - kind * (x % per + 1);
          idx = (row[x / per] >> sh) & ((1 << kind) - 1);
        }
        std::memcpy(o, pal + 3 * idx, 3);
      } else if (kind == 15 || kind == 16) {
        const int p = row[2 * x] | (row[2 * x + 1] << 8);
        o[2] = static_cast<uint8_t>((p & 31) * 255 / 31);
        if (kind == 15) {
          o[1] = static_cast<uint8_t>(((p >> 5) & 31) * 255 / 31);
          o[0] = static_cast<uint8_t>(((p >> 10) & 31) * 255 / 31);
        } else {
          o[1] = static_cast<uint8_t>(((p >> 5) & 63) * 255 / 63);
          o[0] = static_cast<uint8_t>(((p >> 11) & 31) * 255 / 31);
        }
      } else if (kind == 24) {
        o[0] = row[3 * x + 2];
        o[1] = row[3 * x + 1];
        o[2] = row[3 * x];
      } else {
        uint32_t p;
        std::memcpy(&p, row + 4 * x, 4);
        o[0] = static_cast<uint8_t>(p >> rs);
        o[1] = static_cast<uint8_t>(p >> gs);
        o[2] = static_cast<uint8_t>(p >> bs);
      }
    }
  }
  return 0;
}

// PIL's BmpRleDecoder over `src` (the file from the pixel data on; `start`
// is its offset in the file, for the word alignment PIL takes from the
// file position): palette indices, one byte per pixel, in file row order,
// into `out` (at least w * h + 256 bytes, zero-filled). Returns the count
// PIL's decoder produces before it stops; fewer than w * h is PIL's "not
// enough image data".
long f101bmp_rle(const uint8_t* src, long n, long start, int w, int h,
                 int rle4, uint8_t* out) {
  const long dest = static_cast<long>(w) * h;
  long len = 0, pos = 0, x = 0;
  auto put = [&](int v) {
    if (len < dest + 256) out[len] = static_cast<uint8_t>(v);
    ++len;
  };
  while (len < dest) {
    if (pos + 2 > n) break;
    const int pixels = src[pos], byte = src[pos + 1];
    pos += 2;
    if (pixels) {  // encoded mode, clipped to the row
      long count = pixels;
      if (x + count > w) count = w - x > 0 ? w - x : 0;
      for (long i = 0; i < count; ++i)
        put(rle4 ? (i % 2 == 0 ? byte >> 4 : byte & 15) : byte);
      x += count;
    } else if (byte == 0) {  // end of line
      while (len % w != 0) put(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta: PIL reads two bytes, then uses the next two
      if (pos + 2 > n) break;
      pos += 2;
      if (pos + 2 > n) break;  // PIL's unpacking of a short read fails
      const int right = src[pos], up = src[pos + 1];
      pos += 2;
      for (long i = 0, m = right + static_cast<long>(up) * w; i < m; ++i) put(0);
      x = len % w;
    } else {  // absolute mode
      const long want = rle4 ? byte / 2 : byte;
      const long got = pos + want <= n ? want : n - pos;
      for (long i = 0; i < got; ++i) {
        const int b = src[pos + i];
        if (rle4) {
          put(b >> 4);
          put(b & 15);
        } else {
          put(b);
        }
      }
      pos += got;
      if (got < want) break;
      x += byte;
      if ((start + pos) % 2 != 0) ++pos;  // word alignment, in file offsets
    }
  }
  return len;
}

}  // extern "C"
