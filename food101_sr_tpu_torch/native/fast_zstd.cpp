// Zstandard (RFC 8878) decoding with no library, for ZSTD-compressed TIFF
// strips as libtiff 4.7 decodes them through libzstd 1.5 (tif_zstd.c
// ZSTDDecode, behind PIL's TIFF plugin): native/tiff.py hands each strip
// or tile here with the bytes libtiff wants from it.
//
// What libtiff's decode does, and so what this unit does:
//   - One ZSTD_decompressStream call over the whole strip (every byte is
//     given at once), which stops at the end of the first frame: a strip
//     that the first frame does not fill is "Not enough data", so a
//     second frame or one after a skippable frame is never read. The
//     bytes decoded before a short end are kept, the rest zeroed; any
//     error zeroes the whole strip (the call's output position is not
//     updated when it fails).
//   - The single-pass shortcut: a frame whose content size is known,
//     fits the strip and lies whole in the data is decoded at once
//     (every block, the content size and the checksum checked, no window
//     limit). Otherwise block by block: the window limit of 2^27 + 1
//     bytes ("Frame requires too much memory"), a block decoded only when
//     all of it is there (a raw block streams), a block that straddles
//     the end of the strip decoded whole, and when the strip fills at a
//     block's end, the next block (or the checksum) read and checked
//     before the call returns.
//   - Frames: the frame header (reserved bit, window descriptor, a
//     dictionary ID other than 0 refused, content size), skippable
//     frames, the content checksum (XXH64, its low 32 bits).
//   - Blocks: raw, RLE and compressed; the reserved type and sizes past
//     the block maximum are errors. Literals raw, RLE or Huffman-coded in
//     1 or 4 streams, the table described by FSE-coded or direct weights
//     or repeated; sequences with predefined, RLE, FSE-coded or repeated
//     tables (FSE_readNCount as libzstd reads it), repeat offsets, and
//     every bitstream held to its exact end.
//
// Build: g++ -O3 -shared -fPIC fast_zstd.cpp -o libfast_zstd.so (no
// library; native/__init__.py builds it on first use into _build/).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <new>
#include <vector>

namespace {

thread_local char g_error[160] = "";

struct Error {
  const char* what;
};
[[noreturn]] void fail(const char* what) { throw Error{what}; }

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return le16(p) | (p[2] << 16); }
inline uint32_t le32(const uint8_t* p) {
  return le16(p) | (static_cast<uint32_t>(le16(p + 2)) << 16);
}
inline uint64_t le64(const uint8_t* p) {
  return le32(p) | (static_cast<uint64_t>(le32(p + 4)) << 32);
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------------------
// XXH64
// ---------------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t round64(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t merge(uint64_t acc, uint64_t v) {
  return (acc ^ round64(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = round64(v1, le64(p));
      v2 = round64(v2, le64(p + 8));
      v3 = round64(v3, le64(p + 16));
      v4 = round64(v4, le64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = merge(merge(merge(merge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ round64(0, le64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (le32(p) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// the backward bitstream (bitstream.h): read from the last byte, whose
// highest set bit marks the end; bits past the start read as zeros, and
// `left` going negative is libzstd's overflow
// ---------------------------------------------------------------------------

struct BitIn {
  const uint8_t* p = nullptr;
  int64_t left = 0;  // bits not yet read

  void init(const uint8_t* src, size_t n) {
    if (n < 1) fail("Src size is incorrect");
    if (src[n - 1] == 0) fail("Corrupted block detected");
    p = src;
    left = 8 * static_cast<int64_t>(n - 1) + highbit(src[n - 1]);
  }
  uint32_t peek(int k) const {
    uint32_t v = 0;
    for (int i = 1; i <= k; ++i) {
      const int64_t b = left - i;
      v = (v << 1) | (b >= 0 ? (p[b >> 3] >> (b & 7)) & 1 : 0);
    }
    return v;
  }
  uint32_t read(int k) {
    const uint32_t v = peek(k);
    left -= k;
    return v;
  }
  bool overflow() const { return left < 0; }
  bool done() const { return left == 0; }
};

// ---------------------------------------------------------------------------
// FSE: the normalized counts (entropy_common.c FSE_readNCount) and the
// decoding table
// ---------------------------------------------------------------------------

size_t read_ncount_body(int16_t* norm, unsigned* max_sv, unsigned* table_log,
                        const uint8_t* istart, size_t hb) {
  const uint8_t* const iend = istart + hb;
  const uint8_t* ip = istart;
  const unsigned max_sv1 = *max_sv + 1;
  unsigned charnum = 0;
  int previous0 = 0;
  std::memset(norm, 0, max_sv1 * sizeof(int16_t));
  uint32_t bits = le32(ip);
  int nbits = (bits & 0xF) + 5;
  if (nbits > 15) fail("tableLog requires too much memory");
  bits >>= 4;
  int count_bits = 4;
  *table_log = nbits;
  int remaining = (1 << nbits) + 1;
  int threshold = 1 << nbits;
  nbits++;
  for (;;) {
    if (previous0) {
      int repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          count_bits -= static_cast<int>(8 * (iend - 7 - ip));
          count_bits &= 31;
          ip = iend - 4;
        }
        bits = le32(ip) >> count_bits;
        repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      }
      charnum += 3 * repeats;
      bits >>= 2 * repeats;
      count_bits += 2 * repeats;
      charnum += bits & 3;
      count_bits += 2;
      if (charnum >= max_sv1) break;
      if (ip <= iend - 7 || ip + (count_bits >> 3) <= iend - 4) {
        ip += count_bits >> 3;
        count_bits &= 7;
      } else {
        count_bits -= static_cast<int>(8 * (iend - 4 - ip));
        count_bits &= 31;
        ip = iend - 4;
      }
      bits = le32(ip) >> count_bits;
    }
    {
      const int max = (2 * threshold - 1) - remaining;
      int count;
      if ((bits & (threshold - 1)) < static_cast<uint32_t>(max)) {
        count = bits & (threshold - 1);
        count_bits += nbits - 1;
      } else {
        count = bits & (2 * threshold - 1);
        if (count >= threshold) count -= max;
        count_bits += nbits;
      }
      count--;
      if (count >= 0)
        remaining -= count;
      else
        remaining += count;
      norm[charnum++] = static_cast<int16_t>(count);
      previous0 = !count;
      if (remaining < threshold) {
        if (remaining <= 1) break;
        nbits = highbit(remaining) + 1;
        threshold = 1 << (nbits - 1);
      }
      if (charnum >= max_sv1) break;
      if (ip <= iend - 7 || ip + (count_bits >> 3) <= iend - 4) {
        ip += count_bits >> 3;
        count_bits &= 7;
      } else {
        count_bits -= static_cast<int>(8 * (iend - 4 - ip));
        count_bits &= 31;
        ip = iend - 4;
      }
      bits = le32(ip) >> count_bits;
    }
  }
  if (remaining != 1) fail("Corrupted block detected");
  if (charnum > max_sv1) fail("Unsupported max Symbol Value : too large");
  if (count_bits > 32) fail("Corrupted block detected");
  *max_sv = charnum - 1;
  ip += (count_bits + 7) >> 3;
  return static_cast<size_t>(ip - istart);
}

size_t read_ncount(int16_t* norm, unsigned* max_sv, unsigned* table_log,
                   const uint8_t* src, size_t n) {
  if (n < 8) {
    uint8_t buf[8] = {0};
    std::memcpy(buf, src, n);
    const size_t got = read_ncount_body(norm, max_sv, table_log, buf, 8);
    if (got > n) fail("Corrupted block detected");
    return got;
  }
  return read_ncount_body(norm, max_sv, table_log, src, n);
}

struct FseCell {
  uint16_t next;    // newState base
  uint8_t nbits;    // bits read for the next state
  uint8_t symbol;
};

// FSE_buildDTable / ZSTD_buildFSETable: the symbols spread over the table
// (low-probability ones at its top), then each cell's next state
void build_fse(std::vector<FseCell>& t, const int16_t* norm, unsigned max_sv,
               unsigned table_log) {
  const unsigned size = 1u << table_log;
  t.assign(size, FseCell{});
  std::vector<uint16_t> next(max_sv + 1);
  unsigned high = size - 1;
  for (unsigned s = 0; s <= max_sv; ++s) {
    if (norm[s] == -1) {
      t[high--].symbol = static_cast<uint8_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint16_t>(norm[s]);
    }
  }
  const unsigned mask = size - 1, step = (size >> 1) + (size >> 3) + 3;
  unsigned pos = 0;
  for (unsigned s = 0; s <= max_sv; ++s)
    for (int i = 0; i < norm[s]; ++i) {
      t[pos].symbol = static_cast<uint8_t>(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  if (pos != 0) fail("Error (generic)");
  for (unsigned u = 0; u < size; ++u) {
    const unsigned ns = next[t[u].symbol]++;
    const int nb = static_cast<int>(table_log) - highbit(ns);
    t[u].nbits = static_cast<uint8_t>(nb);
    t[u].next = static_cast<uint16_t>((ns << nb) - size);
  }
}

// FSE_decompress_wksp for Huffman weights: two interleaved states until
// the bitstream overflows, at most `cap` symbols
size_t fse_weights(uint8_t* out, size_t cap, const uint8_t* src, size_t n) {
  int16_t norm[256];
  unsigned max_sv = 255, table_log;
  const size_t h = read_ncount(norm, &max_sv, &table_log, src, n);
  if (table_log > 6) fail("tableLog requires too much memory");
  std::vector<FseCell> t;
  build_fse(t, norm, max_sv, table_log);
  BitIn br;
  br.init(src + h, n - h);
  uint32_t s1 = br.read(table_log), s2 = br.read(table_log);
  if (br.overflow()) fail("Corrupted block detected");
  size_t k = 0;
  auto sym = [&](uint32_t& s) {
    const FseCell& c = t[s];
    s = c.next + br.read(c.nbits);
    return c.symbol;
  };
  for (;;) {
    if (k + 2 > cap) fail("Destination buffer is too small");
    out[k++] = sym(s1);
    if (br.overflow()) {
      out[k++] = sym(s2);
      break;
    }
    if (k + 2 > cap) fail("Destination buffer is too small");
    out[k++] = sym(s2);
    if (br.overflow()) {
      out[k++] = sym(s1);
      break;
    }
  }
  return k;
}

// ---------------------------------------------------------------------------
// Huffman literals (huf_decompress.c)
// ---------------------------------------------------------------------------

struct Huf {
  int table_log = 0;
  std::vector<uint8_t> sym, bits;  // 1 << table_log entries

  // HUF_readStats + HUF_readDTableX1: returns the description's size
  size_t read(const uint8_t* src, size_t n) {
    if (!n) fail("Src size is incorrect");
    uint8_t w[256];
    size_t isize = src[0], osize;
    if (isize >= 128) {
      osize = isize - 127;
      isize = (osize + 1) / 2;
      if (isize + 1 > n) fail("Src size is incorrect");
      if (osize >= 256) fail("Corrupted block detected");
      for (size_t i = 0; i < osize; i += 2) {
        w[i] = src[1 + i / 2] >> 4;
        w[i + 1] = src[1 + i / 2] & 15;
      }
    } else {
      if (isize + 1 > n) fail("Src size is incorrect");
      osize = fse_weights(w, 255, src + 1, isize);
    }
    uint32_t rank[13] = {0}, total = 0;
    for (size_t i = 0; i < osize; ++i) {
      if (w[i] > 12) fail("Corrupted block detected");
      rank[w[i]]++;
      total += (1u << w[i]) >> 1;
    }
    if (total == 0) fail("Corrupted block detected");
    const int log = highbit(total) + 1;
    if (log > 12) fail("Corrupted block detected");
    const uint32_t rest = (1u << log) - total;
    if ((1u << highbit(rest)) != rest) fail("Corrupted block detected");
    w[osize] = static_cast<uint8_t>(highbit(rest) + 1);
    rank[w[osize]]++;
    if (rank[1] < 2 || (rank[1] & 1)) fail("Corrupted block detected");
    const size_t nsym = osize + 1;
    table_log = log;
    sym.assign(1u << log, 0);
    bits.assign(1u << log, 0);
    uint32_t start[13], next_start = 0;
    for (int r = 1; r <= log; ++r) {
      start[r] = next_start;
      next_start += rank[r] << (r - 1);
    }
    for (size_t s = 0; s < nsym; ++s) {
      const int wt = w[s];
      if (!wt) continue;
      const uint32_t len = (1u << wt) >> 1;
      for (uint32_t u = start[wt]; u < start[wt] + len; ++u) {
        sym[u] = static_cast<uint8_t>(s);
        bits[u] = static_cast<uint8_t>(log + 1 - wt);
      }
      start[wt] += len;
    }
    return isize + 1;
  }

  void stream(uint8_t* out, size_t count, const uint8_t* src, size_t n) const {
    BitIn br;
    br.init(src, n);
    for (size_t i = 0; i < count; ++i) {
      const uint32_t v = br.peek(table_log);
      out[i] = sym[v];
      br.left -= bits[v];
    }
    if (!br.done()) fail("Corrupted block detected");
  }

  // libzstd's fast 4-stream loop (HUF_decompress4X1_usingDTable_internal
  // _fast, the path a 64-bit host takes when each stream holds 8 bytes or
  // more and the table fits 11 bits): its bit containers read on past a
  // stream's start into the bytes below it (down to the jump table, then
  // zeros or the container's own bits again), the streams' ends are not
  // checked, and only a stream whose loop read more than 8 bytes below its
  // start fails. False where the loop does not apply.
  bool fast4(uint8_t* out, size_t count, const uint8_t* src, size_t n) const {
    if (count == 0 || n < 10 || table_log > 11) return false;
    const size_t l1 = le16(src), l2 = le16(src + 2), l3 = le16(src + 4);
    const size_t l4 = n - (l1 + l2 + l3 + 6);  // wraps where they overrun
    if (l1 < 8 || l2 < 8 || l3 < 8 || l4 < 8) return false;
    if (l4 > n) fail("Corrupted block detected");
    const size_t seg = (count + 3) / 4;
    if (3 * seg >= count) return false;
    uint8_t dsym[2048], dbits[2048];  // the table at 11 bits
    for (int v = 0; v < 2048; ++v) {
      dsym[v] = sym[v >> (11 - table_log)];
      dbits[v] = bits[v >> (11 - table_log)];
    }
    auto rd = [](const uint8_t* q) {
      uint64_t v;
      std::memcpy(&v, q, 8);
      return v;
    };
    const uint8_t* iend[4] = {src + 6, src + 6 + l1, src + 6 + l1 + l2,
                              src + 6 + l1 + l2 + l3};
    const uint8_t* ip[4] = {iend[1] - 8, iend[2] - 8, iend[3] - 8,
                            src + n - 8};
    size_t op[4] = {0, seg, 2 * seg, 3 * seg};
    uint64_t b[4];
    for (int k = 0; k < 4; ++k) {
      const uint8_t last = ip[k][7];
      b[k] = (rd(ip[k]) | 1) << (last ? 8 - highbit(last) : 0);
    }
    for (;;) {
      const size_t iters = std::min((count - op[3]) / 5,
                                    static_cast<size_t>(ip[0] - src) / 7);
      const size_t olimit = op[3] + iters * 5;
      if (op[3] == olimit) break;
      if (ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
      do {
        for (int j = 0; j < 5; ++j)
          for (int k = 0; k < 4; ++k) {
            const int v = static_cast<int>(b[k] >> 53);
            out[op[k] + j] = dsym[v];
            b[k] <<= dbits[v];
          }
        for (int k = 0; k < 4; ++k) {
          const int ctz = __builtin_ctzll(b[k]);
          op[k] += 5;
          ip[k] -= ctz >> 3;
          b[k] = (rd(ip[k]) | 1) << (ctz & 7);
        }
      } while (op[3] < olimit);
    }
    size_t seg_end = 0;
    for (int k = 0; k < 4; ++k) {
      seg_end = seg <= count - seg_end ? seg_end + seg : count;
      if (op[k] > seg_end || ip[k] < iend[k] - 8)
        fail("Corrupted block detected");
      // HUF_decodeStreamX1 over a BIT_DStream starting at the jump table
      uint64_t c = rd(ip[k]);
      unsigned used = __builtin_ctzll(b[k]);
      const uint8_t* p = ip[k];
      enum { kMore, kEnd, kDone, kOver };
      auto reload = [&]() {
        if (used > 64) return static_cast<int>(kOver);
        if (p >= src + 8) {
          p -= used >> 3;
          used &= 7;
          c = rd(p);
          return static_cast<int>(kMore);
        }
        if (p == src) return static_cast<int>(used < 64 ? kEnd : kDone);
        size_t nb = used >> 3;
        int r = kMore;
        if (p - nb < src) {
          nb = static_cast<size_t>(p - src);
          r = kEnd;
        }
        p -= nb;
        used -= static_cast<unsigned>(nb * 8);
        c = rd(p);
        return r;
      };
      auto one = [&](size_t at) {
        const int v = static_cast<int>((c << (used & 63)) >> 53);
        out[at] = dsym[v];
        used += dbits[v];
      };
      size_t q = op[k];
      if (seg_end - q > 3) {
        while (reload() == kMore && q < seg_end - 3)
          for (int j = 0; j < 4; ++j) one(q++);
      } else {
        reload();
      }
      while (q < seg_end) one(q++);
    }
    return true;
  }

  void decode(uint8_t* out, size_t count, const uint8_t* src, size_t n,
              bool four) const {
    if (!four) return stream(out, count, src, n);
    if (fast4(out, count, src, n)) return;
    if (n < 10 || count < 6) fail("Corrupted block detected");
    const size_t l1 = le16(src), l2 = le16(src + 2), l3 = le16(src + 4);
    if (l1 + l2 + l3 + 6 > n) fail("Corrupted block detected");
    const size_t l4 = n - 6 - l1 - l2 - l3;
    const size_t seg = (count + 3) / 4;
    const uint8_t* p = src + 6;
    stream(out, seg, p, l1);
    stream(out + seg, seg, p + l1, l2);
    stream(out + 2 * seg, seg, p + l1 + l2, l3);
    stream(out + 3 * seg, count - 3 * seg, p + l1 + l2 + l3, l4);
  }
};

// ---------------------------------------------------------------------------
// sequences
// ---------------------------------------------------------------------------

const uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10,  11,  12,  13,
    14, 15, 16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256,
    512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
    21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195,
    16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                             2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// one of the three code tables of a frame, with its current mode's cells
struct SeqTable {
  std::vector<FseCell> cells;
  int log = 0;
  bool defined = false;  // a table to repeat
};

// ---------------------------------------------------------------------------
// a frame
// ---------------------------------------------------------------------------

struct Header {
  size_t size = 0;
  bool single = false, checksum = false, fcs_known = false;
  uint64_t fcs = 0, window = 0;
  uint32_t dict = 0;
};

constexpr uint32_t kMagic = 0xFD2FB528u;
constexpr uint64_t kBlockMax = 128 * 1024;

// ZSTD_getFrameHeader_advanced: 0 with *h filled, else the bytes it needs
size_t frame_header(const uint8_t* src, size_t n, Header* h) {
  if (n < 5) return 5;
  const uint8_t fhd = src[4];
  const int dict_code = fhd & 3, fcs_code = fhd >> 6;
  h->single = (fhd >> 5) & 1;
  h->checksum = (fhd >> 2) & 1;
  static const int kDict[4] = {0, 1, 2, 4}, kFcs[4] = {0, 2, 4, 8};
  const size_t size = 5 + !h->single + kDict[dict_code] +
                      (kFcs[fcs_code] ? kFcs[fcs_code] : h->single);
  if (n < size) return size;
  h->size = size;
  if (fhd & 0x08) fail("Unsupported frame parameter");
  size_t pos = 5;
  if (!h->single) {
    const uint8_t wl = src[pos++];
    const int log = (wl >> 3) + 10;
    if (log > 31) fail("Frame requires too much memory for decoding");
    h->window = 1ULL << log;
    h->window += (h->window >> 3) * (wl & 7);
  }
  switch (dict_code) {
    case 1: h->dict = src[pos]; break;
    case 2: h->dict = le16(src + pos); break;
    case 3: h->dict = le32(src + pos); break;
  }
  pos += kDict[dict_code];
  h->fcs_known = true;
  switch (fcs_code) {
    case 0:
      if (h->single)
        h->fcs = src[pos];
      else
        h->fcs_known = false;
      break;
    case 1: h->fcs = le16(src + pos) + 256; break;
    case 2: h->fcs = le32(src + pos); break;
    case 3: h->fcs = le64(src + pos); break;
  }
  if (h->single) h->window = h->fcs;
  return 0;
}

class Frame {
 public:
  Frame(const Header& h, bool streaming) : h_(h), streaming_(streaming) {
    block_max_ = h.window < kBlockMax ? h.window : kBlockMax;
    if (h.dict) fail("Dictionary mismatch");
    // the buffered output of the streaming decoder holds the whole frame
    // where its content size is known and small; it bounds the blocks
    if (streaming && h.fcs_known && h.fcs <= h.window + 2 * block_max_ + 64)
      limit_ = h.fcs;
  }

  // the single-pass shortcut writes into the strip itself
  void set_single_cap(uint64_t cap) { limit_ = cap; }
  uint64_t block_max() const { return block_max_; }
  const std::vector<uint8_t>& out() const { return out_; }

  // one block's content (its header already read): decodes it into out_
  void block(int type, const uint8_t* src, size_t csize, uint32_t rle_size) {
    const size_t before = out_.size();
    const uint64_t room = limit_ > before ? limit_ - before : 0;
    if (type == 0) {  // raw
      if (csize > room) fail("Destination buffer is too small");
      out_.insert(out_.end(), src, src + csize);
    } else if (type == 1) {  // RLE
      if (rle_size > room) fail("Destination buffer is too small");
      out_.insert(out_.end(), rle_size, src[0]);
    } else {
      compressed(src, csize, room);
    }
    if (streaming_ && out_.size() - before > block_max_)
      fail("Corrupted block detected");
  }

  void end_check() const {
    if (h_.fcs_known && out_.size() != h_.fcs) fail("Corrupted block detected");
  }
  bool checksum_ok(const uint8_t* p) const {
    return static_cast<uint32_t>(xxh64(out_.data(), out_.size())) == le32(p);
  }

 private:
  Header h_;
  bool streaming_;
  uint64_t block_max_;
  uint64_t limit_ = ~0ULL;  // the output a frame may write
  std::vector<uint8_t> out_, lit_;
  Huf huf_;
  bool lit_entropy_ = false;
  SeqTable ll_, of_, ml_;
  bool fse_entropy_ = false;
  uint32_t rep_[3] = {1, 4, 8};

  // ZSTD_decodeLiteralsBlock: returns the section's size
  size_t literals(const uint8_t* src, size_t n, uint64_t room) {
    if (n < 2) fail("Corrupted block detected");
    const int type = src[0] & 3, lhl = (src[0] >> 2) & 3;
    const uint64_t write_max = room < block_max_ ? room : block_max_;
    if (type == 2 || type == 3) {  // compressed, or treeless (repeat)
      if (type == 3 && !lit_entropy_) fail("Dictionary is corrupted");
      if (n < 5) fail("Corrupted block detected");
      const uint32_t lhc = le32(src);
      size_t lh, size, csize;
      bool single = false;
      if (lhl < 2) {
        single = lhl == 0;
        lh = 3;
        size = (lhc >> 4) & 0x3FF;
        csize = (lhc >> 14) & 0x3FF;
      } else if (lhl == 2) {
        lh = 4;
        size = (lhc >> 4) & 0x3FFF;
        csize = lhc >> 18;
      } else {
        lh = 5;
        size = (lhc >> 4) & 0x3FFFF;
        csize = (lhc >> 22) + (static_cast<size_t>(src[4]) << 10);
      }
      if (size > block_max_) fail("Corrupted block detected");
      if (!single && size < 6) fail("Header of Literals' block doesn't respect format specification");
      if (csize + lh > n) fail("Corrupted block detected");
      if (write_max < size) fail("Destination buffer is too small");
      lit_.assign(size, 0);
      const uint8_t* p = src + lh;
      size_t pn = csize;
      if (type == 2) {
        const size_t d = huf_.read(p, pn);
        if (d >= pn) fail("Corrupted block detected");
        p += d;
        pn -= d;
      }
      huf_.decode(lit_.data(), size, p, pn, !single);
      lit_entropy_ = true;
      return csize + lh;
    }
    size_t lh, size;
    if (lhl == 0 || lhl == 2) {
      lh = 1;
      size = src[0] >> 3;
    } else if (lhl == 1) {
      lh = 2;
      if (type == 1 && n < 3) fail("Corrupted block detected");
      size = le16(src) >> 4;
    } else {
      lh = 3;
      if (n < (type == 1 ? 4u : 3u)) fail("Corrupted block detected");
      size = le24(src) >> 4;
    }
    if (size > block_max_) fail("Corrupted block detected");
    if (write_max < size) fail("Destination buffer is too small");
    if (type == 0) {  // raw
      if (size + lh > n) fail("Corrupted block detected");
      lit_.assign(src + lh, src + lh + size);
      return lh + size;
    }
    lit_.assign(size, src[lh]);  // RLE
    return lh + 1;
  }

  // ZSTD_buildSeqTable
  size_t seq_table(SeqTable& t, int mode, unsigned max, unsigned max_log,
                   const int16_t* def, unsigned def_max, unsigned def_log,
                   const uint8_t* src, size_t n) {
    switch (mode) {
      case 0:  // predefined
        build_fse(t.cells, def, def_max, def_log);
        t.log = def_log;
        t.defined = true;
        return 0;
      case 1:  // RLE
        if (!n) fail("Src size is incorrect");
        if (src[0] > max) fail("Corrupted block detected");
        t.cells.assign(1, FseCell{0, 0, src[0]});
        t.log = 0;
        t.defined = true;
        return 1;
      case 2: {  // FSE-compressed
        int16_t norm[53];
        unsigned msv = max, log;
        const size_t h = read_ncount(norm, &msv, &log, src, n);
        if (log > max_log) fail("Corrupted block detected");
        build_fse(t.cells, norm, msv, log);
        t.log = log;
        t.defined = true;
        return h;
      }
      default:  // repeat
        if (!fse_entropy_ || !t.defined) fail("Corrupted block detected");
        return 0;
    }
  }

  void compressed(const uint8_t* src, size_t n, uint64_t room) {
    if (n > block_max_) fail("Src size is incorrect");
    const size_t lsize = literals(src, n, room);
    const uint8_t* ip = src + lsize;
    const uint8_t* const iend = src + n;
    if (ip >= iend) fail("Src size is incorrect");
    int nseq = *ip++;
    if (nseq > 0x7F) {
      if (nseq == 0xFF) {
        if (ip + 2 > iend) fail("Src size is incorrect");
        nseq = le16(ip) + 0x7F00;
        ip += 2;
      } else {
        if (ip >= iend) fail("Src size is incorrect");
        nseq = ((nseq - 0x80) << 8) + *ip++;
      }
    }
    const uint64_t before = out_.size();
    // what the sequences may write. Streaming: the buffer's room, and a
    // block past block_max is refused once decoded ("Decompressed Block Size
    // Exceeds Maximum"), so stop there rather than decode the rest first.
    // Single pass: where the strip has room for them, the literals are
    // parked in dst block_max + 32 bytes on, which then ends the block.
    uint64_t cap = room;
    const char* over = "Destination buffer is too small";
    if (streaming_ && block_max_ < room) {
      cap = block_max_;
      over = "Corrupted block detected";
    } else if (!streaming_ && room > block_max_ + 64 + lit_.size()) {
      cap = block_max_ + 32;
    }
    if (nseq == 0) {
      if (ip != iend) fail("Corrupted block detected");
      if (lit_.size() > room) fail("Destination buffer is too small");
      out_.insert(out_.end(), lit_.begin(), lit_.end());
      return;
    }
    if (ip + 1 > iend) fail("Src size is incorrect");
    if (*ip & 3) fail("Corrupted block detected");
    const int llm = *ip >> 6, ofm = (*ip >> 4) & 3, mlm = (*ip >> 2) & 3;
    ip++;
    ip += seq_table(ll_, llm, 35, 9, kLLNorm, 35, 6, ip, iend - ip);
    ip += seq_table(of_, ofm, 31, 8, kOFNorm, 28, 5, ip, iend - ip);
    ip += seq_table(ml_, mlm, 52, 9, kMLNorm, 52, 6, ip, iend - ip);
    fse_entropy_ = true;
    BitIn br;
    br.init(ip, iend - ip);
    uint32_t sll = br.read(ll_.log), sof = br.read(of_.log),
             sml = br.read(ml_.log);
    size_t lit = 0;
    uint64_t rep[3] = {rep_[0], rep_[1], rep_[2]};
    for (int i = 0; i < nseq; ++i) {
      const FseCell& cl = ll_.cells[sll];
      const FseCell& co = of_.cells[sof];
      const FseCell& cm = ml_.cells[sml];
      const int llc = cl.symbol, ofc = co.symbol, mlc = cm.symbol;
      if (llc > 35 || mlc > 52 || ofc > 31) fail("Corrupted block detected");
      uint64_t offset;
      const bool ll0 = llc == 0;
      if (ofc > 1) {
        offset = (1ULL << ofc) - 3 + br.read(ofc);
        rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      } else if (ofc == 0) {
        offset = rep[ll0];
        rep[1] = rep[!ll0];
        rep[0] = offset;
      } else {
        const uint64_t v = 1 + ll0 + br.read(1);
        uint64_t t = v == 3 ? rep[0] - 1 : rep[v];
        t -= !t;
        if (v != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset = t;
      }
      const uint64_t ml = kMLBase[mlc] + br.read(kMLBits[mlc]);
      const uint64_t ll = kLLBase[llc] + br.read(kLLBits[llc]);
      if (i + 1 < nseq) {
        sll = cl.next + br.read(cl.nbits);
        sml = cm.next + br.read(cm.nbits);
        sof = co.next + br.read(co.nbits);
      }
      if (lit + ll > lit_.size()) fail("Corrupted block detected");
      if (out_.size() - before + ll + ml > cap) fail(over);
      out_.insert(out_.end(), lit_.begin() + lit, lit_.begin() + lit + ll);
      lit += ll;
      if (offset > out_.size()) fail("Corrupted block detected");
      const size_t from = out_.size() - offset;
      for (uint64_t k = 0; k < ml; ++k) {
        const uint8_t b = out_[from + k];
        out_.push_back(b);
      }
    }
    if (!br.done()) fail("Corrupted block detected");
    const size_t last = lit_.size() - lit;
    if (out_.size() - before + last > cap) fail(over);
    out_.insert(out_.end(), lit_.begin() + lit, lit_.end());
    for (int k = 0; k < 3; ++k) rep_[k] = static_cast<uint32_t>(rep[k]);
  }
};

// ZSTD_findFrameCompressedSize: the frame's bytes, or 0 where it is not
// whole in the data (or its block headers are broken)
size_t frame_size(const uint8_t* src, size_t n, const Header& h) {
  size_t pos = h.size;
  for (;;) {
    if (n - pos < 3) return 0;
    const uint32_t bh = le24(src + pos);
    const int type = (bh >> 1) & 3;
    if (type == 3) return 0;
    const size_t cs = type == 1 ? 1 : bh >> 3;
    if (3 + cs > n - pos) return 0;
    pos += 3 + cs;
    if (bh & 1) break;
  }
  if (h.checksum) {
    if (n - pos < 4) return 0;
    pos += 4;
  }
  return pos;
}

// libtiff's ZSTDDecode over one strip: 0 full, 1 short (*got bytes
// decoded), -1 an error
int strip(const uint8_t* src, size_t n, uint8_t* dst, size_t occ,
          size_t* got) {
  *got = 0;
  if (n == 0) return 1;
  if (n < 5) {  // only the magic's first bytes can be checked
    uint8_t m[4];
    std::memcpy(m, "\x28\xB5\x2F\xFD", 4);
    std::memcpy(m, src, n < 4 ? n : 4);
    uint8_t s[4];
    std::memcpy(s, "\x50\x2A\x4D\x18", 4);
    std::memcpy(s, src, n < 4 ? n : 4);
    if (le32(m) != kMagic && (le32(s) & 0xFFFFFFF0u) != 0x184D2A50u)
      fail("Unknown frame descriptor");
    return 1;
  }
  const uint32_t magic = le32(src);
  if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) return 1;  // skippable
  if (magic != kMagic) fail("Unknown frame descriptor");
  Header h;
  if (frame_header(src, n, &h)) return 1;
  if (h.fcs_known && h.fcs <= occ) {
    const size_t fsize = frame_size(src, n, h);
    if (fsize) {  // the single-pass shortcut
      Frame f(h, false);
      f.set_single_cap(occ);
      size_t pos = h.size;
      for (;;) {
        const uint32_t bh = le24(src + pos);
        const int type = (bh >> 1) & 3;
        const size_t cs = type == 1 ? 1 : bh >> 3;
        f.block(type, src + pos + 3, cs, bh >> 3);
        pos += 3 + cs;
        if (bh & 1) break;
      }
      f.end_check();
      if (h.checksum && !f.checksum_ok(src + pos))
        fail("Restored data doesn't match checksum");
      std::memcpy(dst, f.out().data(), f.out().size());
      *got = f.out().size();
      return *got == occ ? 0 : 1;
    }
  }
  const uint64_t window = h.window < 1024 ? 1024 : h.window;
  if (window > (1ULL << 27) + 1)
    fail("Frame requires too much memory for decoding");
  Frame f(h, true);
  size_t pos = h.size, flushed = 0;
  bool full = false;  // the strip filled at a block's end
  auto flush = [&]() {
    const size_t have = f.out().size();
    const size_t k = have - flushed < occ - *got ? have - flushed : occ - *got;
    std::memcpy(dst + *got, f.out().data() + flushed, k);
    *got += k;
    flushed += k;
    return flushed == have;  // the flush completed
  };
  for (;;) {
    if (n - pos < 3) break;
    const uint32_t bh = le24(src + pos);
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    if (type == 3) fail("Corrupted block detected");
    const size_t cs = type == 1 ? 1 : bh >> 3;
    if (cs > f.block_max()) fail("Corrupted block detected");
    pos += 3;
    if (type == 0 && cs > n - pos) {  // a raw block streams
      f.block(0, src + pos, n - pos, 0);
      pos = n;
      flush();
      break;
    }
    if (cs > n - pos) break;  // the block is not all there
    if (cs || type == 1) {
      f.block(type, src + pos, cs, bh >> 3);
      if (last) f.end_check();  // not for an empty last block
    }
    pos += cs;
    const bool had = f.out().size() > flushed;
    if (full && had) break;  // decoded, but no room to flush it
    if (!flush()) break;
    if (*got == occ) full = true;
    if (last) {
      if (h.checksum && n - pos >= 4 && !f.checksum_ok(src + pos))
        fail("Restored data doesn't match checksum");
      break;
    }
  }
  return *got == occ ? 0 : 1;
}

}  // namespace

extern "C" {

// The message of this thread's last failed call ("" after a success).
const char* f101zstd_error(void) { return g_error; }

// One ZSTD strip of a TIFF, as libtiff's ZSTDDecode leaves it in dst[0:occ]:
// 0 when it is full; 1 when the data ended first ("Not enough data": the
// first *got bytes decoded, the rest zeros); -1 for an error (all zeros;
// f101zstd_error says which).
int f101zstd_tiff(const uint8_t* src, long n, uint8_t* dst, long occ,
                  long* got) {
  g_error[0] = 0;
  size_t k = 0;
  int rc;
  try {
    rc = strip(src, static_cast<size_t>(n), dst, static_cast<size_t>(occ), &k);
  } catch (const Error& e) {
    std::snprintf(g_error, sizeof g_error, "%s", e.what);
    k = 0;
    rc = -1;
  } catch (const std::bad_alloc&) {
    std::snprintf(g_error, sizeof g_error, "Allocation error");
    k = 0;
    rc = -1;
  }
  std::memset(dst + k, 0, static_cast<size_t>(occ) - k);
  *got = static_cast<long>(k);
  return rc;
}

}  // extern "C"
