// JPEG 2000 Part 1 decoding as OpenJPEG 2.5.4 does it for PIL's
// Jpeg2KDecode.c (opj_read_header, then opj_read_tile_header and
// opj_decode_tile_data for each tile, then opj_end_decompress): the JP2
// boxes OpenJPEG reads, the codestream's marker segments and tile-parts
// (its state machine, so a cut stream fails or stops where OpenJPEG's
// does), tier-2 packet headers in the five progression orders and POC
// changes, tier-1 (the MQ decoder, EBCOT's three passes, every code-block
// style), dequantisation, the inverse 5/3 and 9/7 wavelets, RCT/ICT, the
// DC level shift and the per-tile output buffer OpenJPEG hands its caller.
// No library is needed.
//
// The 9/7 path keeps OpenJPEG's float order of operations (its v8 lifting
// steps, the ICT, lrintf); the pragma keeps g++ from fusing multiply-adds.
#pragma GCC optimize("fp-contract=off")
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum : uint32_t {
  ST_NONE = 0, ST_MHSOC = 1, ST_MHSIZ = 2, ST_MH = 4, ST_TPHSOT = 8,
  ST_TPH = 16, ST_MT = 32, ST_NEOC = 64, ST_DATA = 128, ST_EOC = 256,
  ST_ERR = 0x8000
};
enum : uint32_t {
  MS_SOC = 0xff4f, MS_SOT = 0xff90, MS_SOD = 0xff93, MS_EOC = 0xffd9,
  MS_CAP = 0xff50, MS_SIZ = 0xff51, MS_COD = 0xff52, MS_COC = 0xff53,
  MS_CPF = 0xff59, MS_RGN = 0xff5e, MS_QCD = 0xff5c, MS_QCC = 0xff5d,
  MS_POC = 0xff5f, MS_TLM = 0xff55, MS_PLM = 0xff57, MS_PLT = 0xff58,
  MS_PPM = 0xff60, MS_PPT = 0xff61, MS_SOP = 0xff91, MS_EPH = 0xff92,
  MS_CRG = 0xff63, MS_COM = 0xff64, MS_CBD = 0xff78, MS_MCC = 0xff75,
  MS_MCT = 0xff74, MS_MCO = 0xff77, MS_UNK = 0
};

// OpenJPEG's marker table: id -> the decoder states it may appear in
struct Handler { uint32_t id, states; };
const Handler kHandlers[] = {
    {MS_SOT, ST_MH | ST_TPHSOT}, {MS_COD, ST_MH | ST_TPH},
    {MS_COC, ST_MH | ST_TPH},    {MS_RGN, ST_MH | ST_TPH},
    {MS_QCD, ST_MH | ST_TPH},    {MS_QCC, ST_MH | ST_TPH},
    {MS_POC, ST_MH | ST_TPH},    {MS_SIZ, ST_MHSIZ},
    {MS_TLM, ST_MH},             {MS_PLM, ST_MH},
    {MS_PLT, ST_TPH},            {MS_PPM, ST_MH},
    {MS_PPT, ST_TPH},            {MS_SOP, 0},
    {MS_CRG, ST_MH},             {MS_COM, ST_MH | ST_TPH},
    {MS_MCT, ST_MH | ST_TPH},    {MS_CBD, ST_MH},
    {MS_CAP, ST_MH},             {MS_CPF, ST_MH},
    {MS_MCC, ST_MH | ST_TPH},    {MS_MCO, ST_MH | ST_TPH},
};
Handler handler_of(uint32_t id) {
  for (const Handler& h : kHandlers)
    if (h.id == id) return h;
  return {MS_UNK, ST_MH | ST_TPH};
}

struct Fail {};  // a decode error: the message is already kept

struct Step { int32_t expn = 0, mant = 0; };
struct Tccp {
  uint32_t csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0;
  uint32_t qmfbid = 0, qntsty = 0, numgbits = 0, roishift = 0;
  Step steps[97];
  uint32_t prcw[33] = {}, prch[33] = {};
};
struct Poc { uint32_t resno0, compno0, layno1, resno1, compno1, prg; };
struct Tcp {
  uint32_t csty = 0, prg = 0, numlayers = 0, mct = 0;
  bool has_poc = false;
  uint32_t numpocs = 0;
  Poc pocs[32] = {};
  std::vector<Tccp> tccps;
  int cur_tp = -1;
  uint32_t nb_tp = 0;
  bool has_data = false;
  std::vector<uint8_t> data;
  bool ppt = false;
  std::vector<std::vector<uint8_t>> ppt_markers;
  std::vector<bool> ppt_have;
  std::vector<uint8_t> ppt_buf;
  size_t ppt_pos = 0;
  bool ppt_merged = false;
};
struct Comp { uint32_t dx = 1, dy = 1, prec = 8, sgnd = 0, resno_decoded = 0; };

// -- tile structures ------------------------------------------------------
struct TagTree {
  struct Node { int parent, value, low; };
  std::vector<Node> nodes;
  void build(int w, int h) {
    nodes.clear();
    if (w * h == 0) return;
    std::vector<int> lw{w}, lh{h};
    while (lw.back() * lh.back() > 1) {
      lw.push_back((lw.back() + 1) / 2);
      lh.push_back((lh.back() + 1) / 2);
    }
    std::vector<int> base(lw.size());
    int total = 0;
    for (size_t i = 0; i < lw.size(); ++i) { base[i] = total; total += lw[i] * lh[i]; }
    nodes.assign(total, {-1, 999, 0});
    for (size_t i = 0; i + 1 < lw.size(); ++i)
      for (int y = 0; y < lh[i]; ++y)
        for (int x = 0; x < lw[i]; ++x)
          nodes[base[i] + y * lw[i] + x].parent =
              base[i + 1] + (y / 2) * lw[i + 1] + x / 2;
  }
  void reset() { for (Node& n : nodes) { n.value = 999; n.low = 0; } }
};

struct Seg { uint32_t len = 0, numpasses = 0, maxpasses = 0, numnewpasses = 0, newlen = 0; };
struct Cblk {
  int32_t x0, y0, x1, y1;
  uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0;
  uint32_t numchunks = 0;  // zero-length chunks count: they start a decode
  std::vector<Seg> segs;
  std::vector<uint8_t> data;  // the chunks, concatenated
};
struct Precinct {
  int32_t x0, y0, x1, y1;
  uint32_t cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};
struct Band {
  uint32_t bandno;
  int32_t x0, y0, x1, y1;
  int32_t numbps;
  float stepsize;
  std::vector<Precinct> precincts;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};
struct Res {
  int32_t x0, y0, x1, y1;
  uint32_t pw, ph, pdx, pdy, numbands;
  Band bands[3];
};
struct TileComp {
  int32_t x0, y0, x1, y1;
  uint32_t numres;
  std::vector<Res> res;
  std::vector<int32_t> data;  // int32, or float32 bits for 9/7
};

// -- the MQ and raw decoders (mqc.c) ---------------------------------------
struct QeState { uint32_t qe; uint8_t nmps, nlps, sw; };
const QeState kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0ac1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1c01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1c01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0ac1, 31, 28, 0}, {0x09c1, 32, 29, 0}, {0x08a1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02a1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NCTX = 19 };

struct Mqc {
  const uint8_t* bp;
  uint32_t a, c, ct;
  uint8_t st[NCTX], mps[NCTX];
  void reset_states() {
    for (int i = 0; i < NCTX; ++i) { st[i] = 0; mps[i] = 0; }
    st[CTX_UNI] = 46;
    st[CTX_AGG] = 3;
    st[CTX_ZC] = 4;
  }
  // ``buf`` holds the segment and then 0xFF 0xFF (OpenJPEG's synthetic
  // marker at its end)
  void init(const uint8_t* buf, uint32_t len) {
    bp = buf;
    c = len == 0 ? 0xffu << 16 : uint32_t(buf[0]) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void bytein() {
    const uint32_t next = bp[1];
    if (bp[0] == 0xff) {
      if (next > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        ++bp;
        c += next << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += next << 8;
      ct = 8;
    }
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int decode(int ctx) {
    const QeState& s = kQe[st[ctx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        a = s.qe;
        d = mps[ctx];
        st[ctx] = s.nmps;
      } else {
        a = s.qe;
        d = !mps[ctx];
        if (s.sw) mps[ctx] ^= 1;
        st[ctx] = s.nlps;
      }
      renorm();
    } else {
      c -= s.qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = !mps[ctx];
          if (s.sw) mps[ctx] ^= 1;
          st[ctx] = s.nlps;
        } else {
          d = mps[ctx];
          st[ctx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[ctx];
      }
    }
    return d;
  }
  void raw_init(const uint8_t* buf) { bp = buf; c = 0; ct = 0; }
  int raw() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp++;
          ct = 7;
        }
      } else {
        c = *bp++;
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};

// -- tier-1 (t1.c): one code-block ------------------------------------------
enum : uint8_t { F_SIG = 1, F_NEG = 2, F_PI = 4, F_MU = 8 };

struct T1 {
  int w, h, stride;
  bool vsc;
  int orient;
  std::vector<uint8_t> f;  // (h + 2) x (w + 2) flags, a border of zeros
  std::vector<int32_t> data;
  Mqc mq;

  uint8_t& at(int x, int y) { return f[(y + 1) * stride + x + 1]; }
  // a neighbour's flags; under VSC the last row of a stripe does not see
  // the next stripe
  uint8_t nb(int x, int y, int dx, int dy) {
    if (dy > 0 && vsc && (y & 3) == 3) return 0;
    return f[(y + dy + 1) * stride + x + dx + 1];
  }
  bool any_sig(int x, int y) {
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx)
        if ((dx || dy) && (nb(x, y, dx, dy) & F_SIG)) return true;
    return false;
  }
  int zc(int x, int y) {
    int hh = (nb(x, y, -1, 0) & F_SIG) + (nb(x, y, 1, 0) & F_SIG);
    int vv = (nb(x, y, 0, -1) & F_SIG) + (nb(x, y, 0, 1) & F_SIG);
    const int d = (nb(x, y, -1, -1) & F_SIG) + (nb(x, y, 1, -1) & F_SIG) +
                  (nb(x, y, -1, 1) & F_SIG) + (nb(x, y, 1, 1) & F_SIG);
    int n = 0;
    if (orient == 3) {
      const int hv = hh + vv;
      if (!d) n = !hv ? 0 : hv == 1 ? 1 : 2;
      else if (d == 1) n = !hv ? 3 : hv == 1 ? 4 : 5;
      else if (d == 2) n = !hv ? 6 : 7;
      else n = 8;
      return CTX_ZC + n;
    }
    if (orient == 1) std::swap(hh, vv);  // HL: horizontally high-pass
    if (!hh) n = !vv ? (!d ? 0 : d == 1 ? 1 : 2) : vv == 1 ? 3 : 4;
    else if (hh == 1) n = !vv ? (!d ? 5 : 6) : 7;
    else n = 8;
    return CTX_ZC + n;
  }
  static int contrib(uint8_t a, uint8_t b) {
    const int pos = ((a & (F_SIG | F_NEG)) == F_SIG) + ((b & (F_SIG | F_NEG)) == F_SIG);
    const int neg = ((a & (F_SIG | F_NEG)) == (F_SIG | F_NEG)) +
                    ((b & (F_SIG | F_NEG)) == (F_SIG | F_NEG));
    return std::min(pos, 1) - std::min(neg, 1);
  }
  // the sign's context and the bit it is XORed with
  int sc(int x, int y, int* spb) {
    int hc = contrib(nb(x, y, -1, 0), nb(x, y, 1, 0));
    int vc = contrib(nb(x, y, 0, -1), nb(x, y, 0, 1));
    *spb = (!hc && !vc) ? 0 : !(hc > 0 || (!hc && vc > 0));
    if (hc < 0) { hc = -hc; vc = -vc; }
    int n;
    if (!hc) n = vc ? 1 : 0;
    else n = vc == -1 ? 2 : !vc ? 3 : 4;
    return CTX_SC + n;
  }
  void set_sig(int x, int y, int neg, int32_t oneplushalf) {
    at(x, y) |= F_SIG | (neg ? F_NEG : 0);
    data[y * w + x] = neg ? -oneplushalf : oneplushalf;
  }
  void sigpass(int bpno, bool raw) {
    const int32_t one = 1 << bpno, oph = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          uint8_t& fl = at(x, y);
          if ((fl & (F_SIG | F_PI)) || !any_sig(x, y)) continue;
          if (raw) {
            if (mq.raw()) set_sig(x, y, mq.raw(), oph);
          } else if (mq.decode(zc(x, y))) {
            int spb;
            const int ctx = sc(x, y, &spb);
            set_sig(x, y, mq.decode(ctx) ^ spb, oph);
          }
          at(x, y) |= F_PI;
        }
  }
  void refpass(int bpno, bool raw) {
    const int32_t poshalf = (1 << bpno) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          uint8_t& fl = at(x, y);
          if ((fl & (F_SIG | F_PI)) != F_SIG) continue;
          int v;
          if (raw) {
            v = mq.raw();
          } else {
            const int ctx = (fl & F_MU) ? CTX_MAG + 2
                                        : any_sig(x, y) ? CTX_MAG + 1 : CTX_MAG;
            v = mq.decode(ctx);
          }
          int32_t& dv = data[y * w + x];
          dv += (v ^ (dv < 0)) ? poshalf : -poshalf;
          fl |= F_MU;
        }
  }
  void cln_step(int x, int y, int32_t oph, bool partial) {
    if (!partial && !mq.decode(zc(x, y))) return;
    int spb;
    const int ctx = sc(x, y, &spb);
    set_sig(x, y, mq.decode(ctx) ^ spb, oph);
  }
  void clnpass(int bpno, bool segsym) {
    const int32_t one = 1 << bpno, oph = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x) {
        const int y1 = std::min(k + 4, h);
        bool run = y1 - k == 4;
        for (int y = k; run && y < y1; ++y)
          if ((at(x, y) & (F_SIG | F_PI)) || any_sig(x, y)) run = false;
        int start = k;
        bool partial = false;
        if (run) {
          if (!mq.decode(CTX_AGG)) continue;
          int r = mq.decode(CTX_UNI);
          r = (r << 1) | mq.decode(CTX_UNI);
          start = k + r;
          partial = true;
        }
        for (int y = start; y < y1; ++y) {
          if (!partial && (at(x, y) & (F_SIG | F_PI))) continue;
          cln_step(x, y, oph, partial);
          partial = false;
        }
        for (int y = k; y < y1; ++y) at(x, y) &= ~F_PI;
      }
    if (segsym) {
      for (int i = 0; i < 4; ++i) mq.decode(CTX_UNI);
    }
  }
};

// -- the decoder ------------------------------------------------------------
struct Dec {
  const uint8_t* d = nullptr;
  long n = 0, pos = 0;
  std::string err;
  int refused = 0;  // 1: HTJ2K, 2: Part 2
  // JP2
  uint32_t ihdr_w = 0, ihdr_h = 0, jp2_state = 0, enumcs = 0;
  bool has_colr = false, has_jp2h = false, has_ihdr = false, has_pclr = false;
  bool has_cmap = false, has_cdef = false;
  uint32_t jp2_nc = 0;
  // image
  uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0, rsiz = 0;
  std::vector<Comp> comps;
  uint32_t tx0 = 0, ty0 = 0, tdx = 0, tdy = 0, tw = 0, th = 0;
  Tcp deftcp;
  std::vector<Tcp> tcps;
  uint32_t state = ST_NONE, cur_tile = 0, sot_length = 0;
  bool last_tile_part = false, can_decode = false;
  bool ppm = false;
  std::vector<std::vector<uint8_t>> ppm_markers;
  std::vector<bool> ppm_have;
  std::vector<uint8_t> ppm_buf;
  size_t ppm_pos = 0;
  // the tile being decoded
  uint32_t tile_x0 = 0, tile_y0 = 0, tile_x1 = 0, tile_y1 = 0;
  std::vector<TileComp> tile;
  std::vector<uint8_t> tbuf;  // marker segment bytes

  [[noreturn]] void fail(const char* msg) {
    if (err.empty()) err = msg;
    throw Fail();
  }
  long left() const { return n - pos; }
  long read(uint8_t* out, long k) {
    const long got = std::max(0L, std::min(k, left()));
    if (got) std::memcpy(out, d + pos, got);
    pos += got;
    return got;
  }
  bool read2(uint32_t* v) {
    uint8_t b[2];
    if (read(b, 2) != 2) return false;
    *v = (uint32_t(b[0]) << 8) | b[1];
    return true;
  }
  long skip(long k) {  // opj_stream_skip, clamped at the end (-1: nothing)
    const long got = std::max(0L, std::min(k, left()));
    pos += got;
    return (got == 0 && k > 0) ? -1 : got;
  }
  static uint32_t be(const uint8_t* p, int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i) v = (v << 8) | p[i];
    return v;
  }

  // ---- JP2 boxes (jp2.c) ----
  bool read_boxhdr(uint32_t* len, uint32_t* type, uint32_t* nread) {
    uint8_t h[8];
    *nread = uint32_t(read(h, 8));
    if (*nread != 8) return false;
    *len = be(h, 4);
    *type = be(h + 4, 4);
    if (*len == 0) {
      if (left() > long(0xFFFFFFFFu - 8u)) fail("Cannot handle box sizes higher than 2^32");
      *len = uint32_t(left()) + 8u;
      return true;
    }
    if (*len == 1) {
      const uint32_t got = uint32_t(read(h, 8));
      if (got != 8) return false;
      *nread = 16;
      if (be(h, 4) != 0) fail("Cannot handle box sizes higher than 2^32");
      *len = be(h + 4, 4);
    }
    return true;
  }
  enum : uint32_t {
    JP2_JP = 0x6a502020, JP2_FTYP = 0x66747970, JP2_JP2H = 0x6a703268,
    JP2_IHDR = 0x69686472, JP2_COLR = 0x636f6c72, JP2_JP2C = 0x6a703263,
    JP2_PCLR = 0x70636c72, JP2_CMAP = 0x636d6170, JP2_CDEF = 0x63646566,
    JP2_BPCC = 0x62706363
  };
  enum : uint32_t { JS_SIG = 1, JS_FTYP = 2, JS_HDR = 4, JS_CS = 8, JS_UNK = 0x80000000u };
  static bool img_box(uint32_t t) {
    return t == JP2_IHDR || t == JP2_COLR || t == JP2_BPCC || t == JP2_PCLR ||
           t == JP2_CMAP || t == JP2_CDEF;
  }
  void img_handler(uint32_t type, const uint8_t* p, uint32_t size) {
    switch (type) {
      case JP2_IHDR:
        if (has_ihdr) return;  // "ignoring ihdr box"
        if (size != 14) fail("Bad image header box (bad size)");
        ihdr_h = be(p, 4);
        ihdr_w = be(p + 4, 4);
        jp2_nc = be(p + 8, 2);
        if (ihdr_h < 1 || ihdr_w < 1 || jp2_nc < 1) fail("Wrong values for: w h numcomps (ihdr)");
        if (jp2_nc - 1u >= 16384u) fail("Invalid number of components (ihdr)");
        has_ihdr = true;
        return;
      case JP2_COLR: {
        if (size < 3) fail("Bad COLR header box (bad size)");
        if (has_colr) return;
        const uint32_t meth = p[0];
        if (meth == 1) {
          if (size < 7) fail("Bad COLR header box (bad size)");
          enumcs = be(p + 3, 4);
          has_colr = true;
        } else if (meth == 2) {
          has_colr = true;
        }
        return;
      }
      case JP2_BPCC:
        if (size != jp2_nc) fail("Bad BPCC header box (bad size)");
        return;
      case JP2_PCLR: {
        if (has_pclr) fail("second PCLR box");
        if (size < 3) fail("PCLR box too short");
        const uint32_t ne = be(p, 2), npc = p[2];
        if (ne == 0 || ne > 1024) fail("Invalid PCLR box");
        if (npc == 0) fail("Invalid PCLR box: 0 palette columns");
        if (size < 3 + npc) fail("PCLR box too short");
        std::vector<uint32_t> bytes(npc);
        for (uint32_t i = 0; i < npc; ++i) bytes[i] = std::min(((p[3 + i] & 0x7fu) + 1 + 7) >> 3, 4u);
        long at = 3 + npc;
        for (uint32_t j = 0; j < ne; ++j)
          for (uint32_t i = 0; i < npc; ++i) {
            if (long(size) < at + long(bytes[i])) fail("PCLR box too short");
            at += bytes[i];
          }
        has_pclr = true;
        pclr_npc = npc;
        return;
      }
      case JP2_CMAP:
        if (!has_pclr) fail("Need to read a PCLR box before the CMAP box.");
        if (has_cmap) fail("Only one CMAP box is allowed.");
        if (size < pclr_npc * 4) fail("Insufficient data for CMAP box.");
        has_cmap = true;
        return;
      case JP2_CDEF: {
        if (has_cdef) fail("second CDEF box");
        if (size < 2) fail("Insufficient data for CDEF box.");
        const uint32_t nn = be(p, 2);
        if (nn == 0) fail("Number of channel description is equal to zero in CDEF box.");
        if (size < 2 + nn * 6) fail("Insufficient data for CDEF box.");
        has_cdef = true;
        return;
      }
    }
  }
  uint32_t pclr_npc = 0;
  void jp2h(const uint8_t* p, uint32_t size) {
    if ((jp2_state & JS_FTYP) != JS_FTYP) fail("The  box must be the first box in the file.");
    bool got_ihdr = false;
    while (size > 0) {
      if (size < 8) fail("Cannot handle box of less than 8 bytes");
      uint32_t len = be(p, 4), type = be(p + 4, 4), hl = 8;
      if (len == 1) {
        if (size < 16) fail("Cannot handle XL box of less than 16 bytes");
        if (be(p + 8, 4) != 0) fail("Cannot handle box sizes higher than 2^32");
        len = be(p + 12, 4);
        hl = 16;
        if (len == 0) fail("Cannot handle box of undefined sizes");
      } else if (len == 0) {
        fail("Cannot handle box of undefined sizes");
      }
      if (len < hl) fail("Box length is inconsistent.");
      if (len > size) fail("Stream error while reading JP2 Header box: box length is inconsistent.");
      if (img_box(type)) img_handler(type, p + hl, len - hl);
      if (type == JP2_IHDR) got_ihdr = true;
      p += len;
      size -= len;
    }
    if (!got_ihdr) fail("Stream error while reading JP2 Header box: no 'ihdr' box.");
    jp2_state |= JS_HDR;
    has_jp2h = true;
  }
  // opj_jp2_read_header_procedure: true at the codestream (or the end)
  void jp2_boxes() {
    uint32_t len, type, nread;
    std::vector<uint8_t> buf;
    while (read_boxhdr(&len, &type, &nread)) {
      if (type == JP2_JP2C) {
        if (jp2_state & JS_HDR) {
          jp2_state |= JS_CS;
          return;
        }
        fail("bad placed jpeg codestream");
      }
      if (len == 0) fail("Cannot handle box of undefined sizes");
      if (len < nread) fail("invalid box size");
      const bool top = type == JP2_JP || type == JP2_FTYP || type == JP2_JP2H;
      const bool misplaced = img_box(type);
      const uint32_t size = len - nread;
      if (top || misplaced) {
        if (!top) {
          if (!(jp2_state & JS_HDR)) {
            jp2_state |= JS_UNK;
            if (skip(size) != long(size)) fail("Problem with skipping JPEG2000 box, stream error");
            continue;
          }
        }
        if (long(size) > left()) fail("Invalid box size: not enough bytes remaining");
        buf.resize(size + 1);
        if (read(buf.data(), size) != long(size)) fail("Problem with reading JPEG2000 box, stream error");
        const uint8_t* p = buf.data();
        if (type == JP2_JP) {
          if (jp2_state != 0) fail("The signature box must be the first box in the file.");
          if (size != 4) fail("Error with JP signature Box size");
          if (be(p, 4) != 0x0d0a870a) fail("Error with JP Signature : bad magic number");
          jp2_state |= JS_SIG;
        } else if (type == JP2_FTYP) {
          if (jp2_state != JS_SIG) fail("The ftyp box must be the second box in the file.");
          if (size < 8 || ((size - 8) & 3)) fail("Error with FTYP signature Box size");
          jp2_state |= JS_FTYP;
        } else if (type == JP2_JP2H) {
          jp2h(p, size);
        } else {
          img_handler(type, p, size);
        }
      } else {
        if (!(jp2_state & JS_SIG)) fail("Malformed JP2 file format: first box must be JPEG 2000 signature box");
        if (!(jp2_state & JS_FTYP)) fail("Malformed JP2 file format: second box must be file type box");
        jp2_state |= JS_UNK;
        if (skip(size) != long(size)) {
          if (jp2_state & JS_CS) return;
          fail("Problem with skipping JPEG2000 box, stream error");
        }
      }
    }
  }

  // ---- marker segments (j2k.c) ----
  Tcp& cur_tcp() { return state == ST_TPH ? tcps[cur_tile] : deftcp; }

  void read_siz(const uint8_t* p, uint32_t size) {
    if (size < 36) fail("Error with SIZ marker size");
    const uint32_t rem = size - 36;
    if (rem % 3) fail("Error with SIZ marker size");
    rsiz = be(p, 2);
    x1 = be(p + 2, 4); y1 = be(p + 6, 4); x0 = be(p + 10, 4); y0 = be(p + 14, 4);
    tdx = be(p + 18, 4); tdy = be(p + 22, 4); tx0 = be(p + 26, 4); ty0 = be(p + 30, 4);
    const uint32_t nc = be(p + 34, 2);
    if (nc >= 16385) fail("Error with SIZ marker: number of component is illegal");
    if (nc != rem / 3) fail("Error with SIZ marker: number of component is not compatible with the remaining number of parameters");
    if (x0 >= x1 || y0 >= y1) fail("Error with SIZ marker: negative or zero image size");
    if (tdx == 0 || tdy == 0) fail("Error with SIZ marker: invalid tile size");
    const uint64_t tx1 = std::min<uint64_t>(uint64_t(tx0) + tdx, 0xFFFFFFFFu);
    const uint64_t ty1 = std::min<uint64_t>(uint64_t(ty0) + tdy, 0xFFFFFFFFu);
    if (tx0 > x0 || ty0 > y0 || tx1 <= x0 || ty1 <= y0) fail("Error with SIZ marker: illegal tile offset");
    if (ihdr_w > 0 && ihdr_h > 0 && (ihdr_w != x1 - x0 || ihdr_h != y1 - y0))
      fail("Error with SIZ marker: IHDR w h vs. SIZ w h");
    comps.assign(nc, Comp());
    for (uint32_t i = 0; i < nc; ++i) {
      const uint8_t* q = p + 36 + 3 * i;
      comps[i].prec = (q[0] & 0x7f) + 1;
      comps[i].sgnd = q[0] >> 7;
      comps[i].dx = q[1];
      comps[i].dy = q[2];
      if (comps[i].dx < 1 || comps[i].dy < 1) fail("Invalid values for comp: dx dy");
      if (comps[i].prec > 31) fail("Invalid values for comp: prec");
    }
    tw = uint32_t((uint64_t(x1) - tx0 + tdx - 1) / tdx);
    th = uint32_t((uint64_t(y1) - ty0 + tdy - 1) / tdy);
    if (tw == 0 || th == 0 || tw > 65535 / th) fail("Invalid number of tiles");
    deftcp.tccps.assign(nc, Tccp());
    state = ST_MH;
    if (rsiz & 0x4000) refused = 1;
  }
  void read_spcod(uint32_t compno, const uint8_t*& p, uint32_t& size) {
    Tccp& t = cur_tcp().tccps[compno];
    if (size < 5) fail("Error reading SPCod SPCoc element");
    t.numres = p[0] + 1u;
    if (t.numres > 33) fail("Invalid value for numresolutions");
    t.cblkw = p[1] + 2u;
    t.cblkh = p[2] + 2u;
    if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
      fail("Error reading SPCod SPCoc element, Invalid cblkw/cblkh combination");
    t.cblksty = p[3];
    if (t.cblksty & 0x80) fail("Unsupported Mixed HT code-block style found");
    // HT code-blocks: refused (415) in a Part 15 stream (Rsiz bit 14 or a
    // CAP marker before); without either, a corrupt stream OpenJPEG fails
    if ((t.cblksty & 0x40) && !refused) fail("HT code-block style without Part 15 capabilities");
    t.qmfbid = p[4];
    if (t.qmfbid > 1) fail("Error reading SPCod SPCoc element, Invalid transformation found");
    p += 5;
    size -= 5;
    if (t.csty & 1) {
      if (size < t.numres) fail("Error reading SPCod SPCoc element");
      for (uint32_t i = 0; i < t.numres; ++i) {
        const uint32_t v = p[i];
        if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) fail("Invalid precinct size");
        t.prcw[i] = v & 0xf;
        t.prch[i] = v >> 4;
      }
      p += t.numres;
      size -= t.numres;
    } else {
      for (uint32_t i = 0; i < t.numres; ++i) t.prcw[i] = t.prch[i] = 15;
    }
  }
  void read_cod(const uint8_t* p, uint32_t size) {
    Tcp& tcp = cur_tcp();
    if (size < 5) fail("Error reading COD marker");
    tcp.csty = p[0];
    if (tcp.csty & ~7u) fail("Unknown Scod value in COD marker");
    tcp.prg = p[1];
    if (tcp.prg > 4) tcp.prg = 0xffffffffu;  // OPJ_PROG_UNKNOWN
    tcp.numlayers = be(p + 2, 2);
    if (tcp.numlayers < 1) fail("Invalid number of layers in COD marker");
    tcp.mct = p[4];
    if (tcp.mct > 1) fail("Invalid multiple component transformation");
    for (Tccp& t : tcp.tccps) t.csty = tcp.csty & 1;
    p += 5;
    size -= 5;
    read_spcod(0, p, size);
    if (size != 0) fail("Error reading COD marker");
    for (size_t i = 1; i < tcp.tccps.size(); ++i) {
      Tccp& c = tcp.tccps[i];
      const Tccp& r = tcp.tccps[0];
      c.numres = r.numres; c.cblkw = r.cblkw; c.cblkh = r.cblkh;
      c.cblksty = r.cblksty; c.qmfbid = r.qmfbid;
      std::memcpy(c.prcw, r.prcw, sizeof(uint32_t) * r.numres);
      std::memcpy(c.prch, r.prch, sizeof(uint32_t) * r.numres);
    }
  }
  void read_coc(const uint8_t* p, uint32_t size) {
    Tcp& tcp = cur_tcp();
    const uint32_t room = comps.size() <= 256 ? 1 : 2;
    if (size < room + 1) fail("Error reading COC marker");
    const uint32_t compno = be(p, room);
    if (compno >= comps.size()) fail("Error reading COC marker (bad number of components)");
    tcp.tccps[compno].csty = p[room];
    p += room + 1;
    size -= room + 1;
    read_spcod(compno, p, size);
    if (size != 0) fail("Error reading COC marker");
  }
  void read_sqcd(uint32_t compno, const uint8_t*& p, uint32_t& size) {
    Tccp& t = cur_tcp().tccps[compno];
    if (size < 1) fail("Error reading SQcd or SQcc element");
    size -= 1;
    t.qntsty = p[0] & 0x1f;
    t.numgbits = p[0] >> 5;
    ++p;
    uint32_t nb;
    if (t.qntsty == 1) nb = 1;
    else nb = t.qntsty == 0 ? size : size / 2;
    if (t.qntsty == 0) {
      if (size < nb) fail("Error reading SQcd or SQcc element");
      for (uint32_t b = 0; b < nb; ++b)
        if (b < 97) { t.steps[b].expn = p[b] >> 3; t.steps[b].mant = 0; }
      p += nb;
      size -= nb;
    } else {
      if (size < 2 * nb) fail("Error reading SQcd or SQcc element");
      for (uint32_t b = 0; b < nb; ++b)
        if (b < 97) {
          const uint32_t v = be(p + 2 * b, 2);
          t.steps[b].expn = v >> 11;
          t.steps[b].mant = v & 0x7ff;
        }
      p += 2 * nb;
      size -= 2 * nb;
    }
    if (t.qntsty == 1)
      for (uint32_t b = 1; b < 97; ++b) {
        const int32_t e = t.steps[0].expn - int32_t((b - 1) / 3);
        t.steps[b].expn = e > 0 ? e : 0;
        t.steps[b].mant = t.steps[0].mant;
      }
  }
  void read_qcd(const uint8_t* p, uint32_t size) {
    read_sqcd(0, p, size);
    if (size != 0) fail("Error reading QCD marker");
    Tcp& tcp = cur_tcp();
    for (size_t i = 1; i < tcp.tccps.size(); ++i) {
      tcp.tccps[i].qntsty = tcp.tccps[0].qntsty;
      tcp.tccps[i].numgbits = tcp.tccps[0].numgbits;
      std::memcpy(tcp.tccps[i].steps, tcp.tccps[0].steps, sizeof(tcp.tccps[0].steps));
    }
  }
  void read_qcc(const uint8_t* p, uint32_t size) {
    const uint32_t room = comps.size() <= 256 ? 1 : 2;
    if (size < room) fail("Error reading QCC marker");
    const uint32_t compno = be(p, room);
    p += room;
    size -= room;
    if (compno >= comps.size()) fail("Invalid component number in QCC");
    read_sqcd(compno, p, size);
    if (size != 0) fail("Error reading QCC marker");
  }
  void read_rgn(const uint8_t* p, uint32_t size) {
    const uint32_t room = comps.size() <= 256 ? 1 : 2;
    if (size != 2 + room) fail("Error reading RGN marker");
    const uint32_t compno = be(p, room);
    if (compno >= comps.size()) fail("bad component number in RGN");
    cur_tcp().tccps[compno].roishift = p[room + 1];
  }
  void read_poc(const uint8_t* p, uint32_t size) {
    const uint32_t room = comps.size() <= 256 ? 1 : 2;
    const uint32_t chunk = 5 + 2 * room;
    uint32_t nb = size / chunk;
    if (nb == 0 || size % chunk) fail("Error reading POC marker");
    Tcp& tcp = cur_tcp();
    const uint32_t old = tcp.has_poc ? tcp.numpocs + 1 : 0;
    nb += old;
    if (nb >= 32) fail("Too many POCs");
    tcp.has_poc = true;
    for (uint32_t i = old; i < nb; ++i) {
      Poc& c = tcp.pocs[i];
      c.resno0 = p[0];
      c.compno0 = be(p + 1, room);
      c.layno1 = be(p + 1 + room, 2);
      c.resno1 = p[3 + room];
      c.compno1 = be(p + 4 + room, room);
      c.prg = p[4 + 2 * room];
      c.compno1 = std::min<uint32_t>(c.compno1, comps.size());
      p += chunk;
    }
    tcp.numpocs = nb - 1;
  }
  void read_tlm(const uint8_t* p, uint32_t size) {
    if (size < 2) fail("Error reading TLM marker");
    size -= 2;
    const uint32_t st = (p[1] >> 4) & 3, sp = (p[1] >> 6) & 1;
    if (st == 3) fail("Error reading TLM marker: ST = 3 is invalid");
    const uint32_t q = (sp + 1) * 2 + st;
    if (size % q) fail("Error reading TLM marker");
  }
  void read_plt(const uint8_t* p, uint32_t size) {
    if (size < 1) fail("Error reading PLT marker");
    uint32_t len = 0;
    for (uint32_t i = 1; i < size; ++i) {
      len |= p[i] & 0x7f;
      if (p[i] & 0x80) len <<= 7;
      else len = 0;
    }
    if (len != 0) fail("Error reading PLT marker");
  }
  void read_ppm(const uint8_t* p, uint32_t size) {
    if (size < 2) fail("Error reading PPM marker");
    ppm = true;
    const uint32_t z = p[0];
    if (ppm_markers.size() <= z) { ppm_markers.resize(z + 1); ppm_have.resize(z + 1, false); }
    if (ppm_have[z]) fail("Zppm already read");
    ppm_have[z] = true;
    ppm_markers[z].assign(p + 1, p + size);
  }
  void merge_ppm() {
    uint32_t remaining = 0;
    for (size_t i = 0; i < ppm_markers.size(); ++i) {
      if (!ppm_have[i]) continue;
      const std::vector<uint8_t>& m = ppm_markers[i];
      size_t at = 0, sz = m.size();
      if (remaining >= sz) { remaining -= uint32_t(sz); sz = 0; }
      else {
        ppm_buf.insert(ppm_buf.end(), m.begin(), m.begin() + remaining);
        at = remaining; sz -= remaining; remaining = 0;
      }
      while (sz > 0) {
        if (sz < 4) fail("Not enough bytes to read Nppm");
        const uint32_t nppm = be(m.data() + at, 4);
        at += 4; sz -= 4;
        if (sz >= nppm) {
          ppm_buf.insert(ppm_buf.end(), m.begin() + at, m.begin() + at + nppm);
          at += nppm; sz -= nppm;
        } else {
          ppm_buf.insert(ppm_buf.end(), m.begin() + at, m.end());
          remaining = uint32_t(nppm - sz);
          sz = 0;
        }
      }
    }
    if (remaining != 0) fail("Corrupted PPM markers");
  }
  void read_ppt(const uint8_t* p, uint32_t size) {
    if (size < 2) fail("Error reading PPT marker");
    if (ppm) fail("Error reading PPT marker: packet header have been previously found in the main header (PPM marker).");
    Tcp& tcp = tcps[cur_tile];
    tcp.ppt = true;
    const uint32_t z = p[0];
    if (tcp.ppt_markers.size() <= z) { tcp.ppt_markers.resize(z + 1); tcp.ppt_have.resize(z + 1, false); }
    if (tcp.ppt_have[z]) fail("Zppt already read");
    tcp.ppt_have[z] = true;
    tcp.ppt_markers[z].assign(p + 1, p + size);
  }
  void read_sot(const uint8_t* p, uint32_t size) {
    if (size != 8) fail("Error reading SOT marker");
    cur_tile = be(p, 2);
    const uint32_t tot = be(p + 2, 4), part = p[6];
    uint32_t parts = p[7];
    if (cur_tile >= tw * th) fail("Invalid tile number");
    Tcp& tcp = tcps[cur_tile];
    if (tcp.cur_tp + 1 != int(part)) fail("Invalid tile part index for tile number");
    ++tcp.cur_tp;
    if (tot != 0 && tot < 14 && tot != 12) fail("Psot value is not correct regards to the JPEG2000 norm");
    last_tile_part = false;
    if (!tot) last_tile_part = true;
    if (tcp.nb_tp != 0 && part >= tcp.nb_tp) { last_tile_part = true; fail("In SOT marker, TPSot is not valid"); }
    if (parts != 0) {
      if (tcp.nb_tp && part >= tcp.nb_tp) { last_tile_part = true; fail("In SOT marker, TPSot is not valid"); }
      if (part >= parts) { last_tile_part = true; fail("In SOT marker, TPSot is not valid (header)"); }
      tcp.nb_tp = parts;
    }
    if (tcp.nb_tp && tcp.nb_tp == part + 1) can_decode = true;
    sot_length = last_tile_part ? 0 : tot - 12;
    state = ST_TPH;
  }
  void handle(uint32_t id, const uint8_t* p, uint32_t size) {
    switch (id) {
      case MS_SOT: read_sot(p, size); break;
      case MS_COD: read_cod(p, size); break;
      case MS_COC: read_coc(p, size); break;
      case MS_RGN: read_rgn(p, size); break;
      case MS_QCD: read_qcd(p, size); break;
      case MS_QCC: read_qcc(p, size); break;
      case MS_POC: read_poc(p, size); break;
      case MS_SIZ: read_siz(p, size); break;
      case MS_TLM: read_tlm(p, size); break;
      case MS_PLM: if (size < 1) fail("Error reading PLM marker"); break;
      case MS_PLT: read_plt(p, size); break;
      case MS_PPM: read_ppm(p, size); break;
      case MS_PPT: read_ppt(p, size); break;
      case MS_CRG: if (size != comps.size() * 4) fail("Error reading CRG marker"); break;
      case MS_CAP: refused = 1; break;
      case MS_MCT: case MS_MCC: case MS_MCO: case MS_CBD:
        if (rsiz & 0x8000) refused = std::max(refused, 2);
        break;
      default: break;  // COM, CPF
    }
  }
  // opj_j2k_read_unk: 2-byte steps to the next known marker
  uint32_t read_unk() {
    for (;;) {
      uint32_t m;
      if (!read2(&m)) fail("Stream too short");
      if (m < 0xff00) continue;
      const Handler h = handler_of(m);
      if (!(state & h.states)) fail("Marker is not compliant with its position");
      if (h.id != MS_UNK) return h.id;
    }
  }
  void read_main_header() {
    state = ST_MHSOC;
    uint32_t m;
    if (!read2(&m) || m != MS_SOC) fail("Expected a SOC marker");
    state = ST_MHSIZ;
    if (!read2(&m)) fail("Stream too short");
    bool has_siz = false, has_cod = false, has_qcd = false;
    while (m != MS_SOT) {
      if (m < 0xff00) fail("A marker ID was expected (0xff--)");
      Handler h = handler_of(m);
      if (h.id == MS_UNK) {
        if ((m == 0xff70 || m == 0xff76 || m == 0xff79) && (rsiz & 0x8000))
          refused = std::max(refused, 2);  // DCO, NLT, ATK
        m = read_unk();
        if (m == MS_SOT) break;
        h = handler_of(m);
      }
      if (h.id == MS_SIZ) has_siz = true;
      if (h.id == MS_COD) has_cod = true;
      if (h.id == MS_QCD) has_qcd = true;
      if (!(state & h.states)) fail("Marker is not compliant with its position");
      uint32_t size;
      if (!read2(&size)) fail("Stream too short");
      if (size < 2) fail("Invalid marker size");
      size -= 2;
      tbuf.resize(size + 1);
      if (read(tbuf.data(), size) != long(size)) fail("Stream too short");
      handle(h.id, tbuf.data(), size);
      if (!read2(&m)) fail("Stream too short");
    }
    if (!has_siz) fail("required SIZ marker not found in main header");
    if (!has_cod) fail("required COD marker not found in main header");
    if (!has_qcd) fail("required QCD marker not found in main header");
    merge_ppm();
    state = ST_TPHSOT;
    tcps.assign(size_t(tw) * th, deftcp);
    for (Tcp& t : tcps) { t.ppt = false; t.cur_tp = -1; }
  }

  // opj_j2k_read_sod
  void read_sod() {
    Tcp& tcp = tcps[cur_tile];
    if (last_tile_part) sot_length = uint32_t(left() - 2);
    else if (sot_length >= 2) sot_length -= 2;
    long got = 0;
    if (sot_length) {
      if (long(sot_length) > left()) fail("Tile part length size inconsistent with stream length");
      const size_t at = tcp.data.size();
      tcp.data.resize(at + sot_length);
      got = read(tcp.data.data() + at, sot_length);
      tcp.data.resize(at + got);
      tcp.has_data = true;
    }
    state = got != long(sot_length) ? ST_NEOC : ST_TPHSOT;
  }

  // opj_j2k_read_tile_header: 1 with a tile to decode, 0 at the end
  int read_tile_header() {
    uint32_t m = MS_SOT;
    const uint32_t nb_tiles = tw * th;
    if (state == ST_EOC) m = MS_EOC;
    else if (state != ST_TPHSOT) fail("not at a tile-part header");
    while (!can_decode && m != MS_EOC) {
      while (m != MS_SOD) {
        if (left() == 0) { state = ST_NEOC; break; }
        uint32_t size;
        if (!read2(&size)) fail("Stream too short");
        if (size < 2) fail("Inconsistent marker size");
        if (m == 0x8080 && left() == 0) { state = ST_NEOC; break; }
        if ((state & ST_TPH) && sot_length != 0) {
          if (sot_length < size + 2) fail("Sot length is less than marker size + marker ID");
          sot_length -= size + 2;
        }
        size -= 2;
        const Handler h = handler_of(m);
        if (!(state & h.states)) fail("Marker is not compliant with its position");
        tbuf.resize(size + 1);
        if (read(tbuf.data(), size) != long(size)) fail("Stream too short");
        if (h.id == MS_UNK) fail("Not sure how that happened.");
        handle(h.id, tbuf.data(), size);
        if (!read2(&m)) fail("Stream too short");
      }
      if (left() == 0 && state == ST_NEOC) break;
      read_sod();
      if (!can_decode) {
        if (!read2(&m)) {
          if (cur_tile + 1 == nb_tiles) {
            uint32_t t = 0;
            for (; t < nb_tiles; ++t)
              if (tcps[t].cur_tp == 0 && tcps[t].nb_tp == 0) break;
            if (t < nb_tiles) {
              cur_tile = t;
              m = MS_EOC;
              state = ST_EOC;
              break;
            }
          }
          fail("Stream too short");
        }
      }
    }
    if (m == MS_EOC && state != ST_EOC) { cur_tile = 0; state = ST_EOC; }
    if (!can_decode) {
      while (cur_tile < nb_tiles && !tcps[cur_tile].has_data) ++cur_tile;
      if (cur_tile == nb_tiles) return 0;
    }
    Tcp& tcp = tcps[cur_tile];
    if (tcp.ppt_merged) fail("opj_j2k_merge_ppt() has already been called");
    if (tcp.ppt) {
      for (size_t i = 0; i < tcp.ppt_markers.size(); ++i)
        if (tcp.ppt_have[i])
          tcp.ppt_buf.insert(tcp.ppt_buf.end(), tcp.ppt_markers[i].begin(), tcp.ppt_markers[i].end());
      tcp.ppt_merged = true;
    }
    init_tile();
    state |= ST_DATA;
    return 1;
  }

  // ---- tile geometry (tcd.c opj_tcd_init_tile) ----
  static int32_t ceildiv(int64_t a, int64_t b) { return int32_t((a + b - 1) / b); }
  static int32_t ceildivpow2(int64_t a, uint32_t b) { return int32_t((a + (int64_t(1) << b) - 1) >> b); }
  static int32_t floordivpow2(int64_t a, uint32_t b) { return int32_t(a >> b); }

  void init_tile() {
    const uint32_t p = cur_tile % tw, q = cur_tile / tw;
    tile_x0 = uint32_t(std::max<uint64_t>(uint64_t(tx0) + uint64_t(p) * tdx, x0));
    tile_y0 = uint32_t(std::max<uint64_t>(uint64_t(ty0) + uint64_t(q) * tdy, y0));
    tile_x1 = uint32_t(std::min<uint64_t>(uint64_t(tx0) + uint64_t(p + 1) * tdx, x1));
    tile_y1 = uint32_t(std::min<uint64_t>(uint64_t(ty0) + uint64_t(q + 1) * tdy, y1));
    const Tcp& tcp = tcps[cur_tile];
    tile.assign(comps.size(), TileComp());
    for (size_t c = 0; c < comps.size(); ++c) {
      TileComp& tc = tile[c];
      const Tccp& tccp = tcp.tccps[c];
      tc.x0 = ceildiv(tile_x0, comps[c].dx);
      tc.y0 = ceildiv(tile_y0, comps[c].dy);
      tc.x1 = ceildiv(tile_x1, comps[c].dx);
      tc.y1 = ceildiv(tile_y1, comps[c].dy);
      tc.numres = tccp.numres;
      tc.res.assign(tc.numres, Res());
      const uint64_t area = uint64_t(tc.x1 - tc.x0) * uint64_t(tc.y1 - tc.y0);
      if (area > (uint64_t(1) << 31)) fail("Size of tile data exceeds system limits");
      tc.data.assign(area, 0);
      for (uint32_t r = 0; r < tc.numres; ++r) {
        Res& rs = tc.res[r];
        const uint32_t level = tc.numres - 1 - r;
        rs.x0 = ceildivpow2(tc.x0, level);
        rs.y0 = ceildivpow2(tc.y0, level);
        rs.x1 = ceildivpow2(tc.x1, level);
        rs.y1 = ceildivpow2(tc.y1, level);
        rs.pdx = tccp.prcw[r];
        rs.pdy = tccp.prch[r];
        const int64_t px0 = int64_t(floordivpow2(rs.x0, rs.pdx)) << rs.pdx;
        const int64_t py0 = int64_t(floordivpow2(rs.y0, rs.pdy)) << rs.pdy;
        const int64_t px1 = int64_t(ceildivpow2(rs.x1, rs.pdx)) << rs.pdx;
        const int64_t py1 = int64_t(ceildivpow2(rs.y1, rs.pdy)) << rs.pdy;
        if (px1 > 0x7fffffff || py1 > 0x7fffffff) fail("Integer overflow");
        rs.pw = rs.x0 == rs.x1 ? 0 : uint32_t((px1 - px0) >> rs.pdx);
        rs.ph = rs.y0 == rs.y1 ? 0 : uint32_t((py1 - py0) >> rs.pdy);
        if (rs.pw && uint64_t(rs.pw) * rs.ph > 0xffffffffull) fail("Size of tile data exceeds system limits");
        int64_t cbgx0, cbgy0;
        uint32_t cbgw, cbgh;
        if (r == 0) {
          cbgx0 = px0; cbgy0 = py0; cbgw = rs.pdx; cbgh = rs.pdy; rs.numbands = 1;
        } else {
          cbgx0 = ceildivpow2(px0, 1); cbgy0 = ceildivpow2(py0, 1);
          cbgw = rs.pdx - 1; cbgh = rs.pdy - 1; rs.numbands = 3;
        }
        const uint32_t cbw = std::min(tccp.cblkw, cbgw), cbh = std::min(tccp.cblkh, cbgh);
        for (uint32_t b = 0; b < rs.numbands; ++b) {
          Band& bd = rs.bands[b];
          const Step* st;
          if (r == 0) {
            bd.bandno = 0;
            bd.x0 = ceildivpow2(tc.x0, level); bd.y0 = ceildivpow2(tc.y0, level);
            bd.x1 = ceildivpow2(tc.x1, level); bd.y1 = ceildivpow2(tc.y1, level);
            st = &tccp.steps[0];
          } else {
            bd.bandno = b + 1;
            const int64_t xb = bd.bandno & 1, yb = bd.bandno >> 1;
            bd.x0 = ceildivpow2(int64_t(tc.x0) - (xb << level), level + 1);
            bd.y0 = ceildivpow2(int64_t(tc.y0) - (yb << level), level + 1);
            bd.x1 = ceildivpow2(int64_t(tc.x1) - (xb << level), level + 1);
            bd.y1 = ceildivpow2(int64_t(tc.y1) - (yb << level), level + 1);
            st = &tccp.steps[3 * (r - 1) + b + 1];
          }
          const int32_t gain = tccp.qmfbid == 0 ? 0 : bd.bandno == 0 ? 0 : bd.bandno == 3 ? 2 : 1;
          const int32_t rb = int32_t(comps[c].prec) + gain;
          bd.stepsize = float((1.0 + st->mant / 2048.0) * std::pow(2.0, double(rb - st->expn)));
          bd.numbps = st->expn + int32_t(tccp.numgbits) - 1;
          bd.precincts.clear();
          if (bd.empty()) continue;
          bd.precincts.resize(size_t(rs.pw) * rs.ph);
          for (uint32_t pn = 0; pn < rs.pw * rs.ph; ++pn) {
            Precinct& pr = bd.precincts[pn];
            const int64_t gx = cbgx0 + int64_t(pn % rs.pw) * (int64_t(1) << cbgw);
            const int64_t gy = cbgy0 + int64_t(pn / rs.pw) * (int64_t(1) << cbgh);
            pr.x0 = int32_t(std::max<int64_t>(gx, bd.x0));
            pr.y0 = int32_t(std::max<int64_t>(gy, bd.y0));
            pr.x1 = int32_t(std::min<int64_t>(gx + (int64_t(1) << cbgw), bd.x1));
            pr.y1 = int32_t(std::min<int64_t>(gy + (int64_t(1) << cbgh), bd.y1));
            const int64_t cx0 = int64_t(floordivpow2(pr.x0, cbw)) << cbw;
            const int64_t cy0 = int64_t(floordivpow2(pr.y0, cbh)) << cbh;
            const int64_t cx1 = int64_t(ceildivpow2(pr.x1, cbw)) << cbw;
            const int64_t cy1 = int64_t(ceildivpow2(pr.y1, cbh)) << cbh;
            pr.cw = uint32_t(std::max<int64_t>(0, (cx1 - cx0) >> cbw));
            pr.ch = uint32_t(std::max<int64_t>(0, (cy1 - cy0) >> cbh));
            pr.cblks.assign(size_t(pr.cw) * pr.ch, Cblk());
            for (uint32_t k = 0; k < pr.cw * pr.ch; ++k) {
              Cblk& cb = pr.cblks[k];
              const int64_t bx = cx0 + int64_t(k % pr.cw) * (int64_t(1) << cbw);
              const int64_t by = cy0 + int64_t(k / pr.cw) * (int64_t(1) << cbh);
              cb.x0 = int32_t(std::max<int64_t>(bx, pr.x0));
              cb.y0 = int32_t(std::max<int64_t>(by, pr.y0));
              cb.x1 = int32_t(std::min<int64_t>(bx + (int64_t(1) << cbw), pr.x1));
              cb.y1 = int32_t(std::min<int64_t>(by + (int64_t(1) << cbh), pr.y1));
            }
            pr.incl.build(int(pr.cw), int(pr.ch));
            pr.imsb.build(int(pr.cw), int(pr.ch));
          }
        }
      }
    }
  }

  // ---- tier-2 (t2.c, pi.c) ----
  struct Bio {
    const uint8_t *start, *end, *bp;
    uint32_t buf = 0, ct = 0;
    void init(const uint8_t* p, size_t len) { start = bp = p; end = p + len; buf = 0; ct = 0; }
    bool bytein() {
      buf = (buf << 8) & 0xffff;
      ct = buf == 0xff00 ? 7 : 8;
      if (bp >= end) return false;
      buf |= *bp++;
      return true;
    }
    uint32_t bit() {
      if (ct == 0) bytein();
      --ct;
      return (buf >> ct) & 1;
    }
    uint32_t read(uint32_t n) {
      uint32_t v = 0;
      for (uint32_t i = n - 1; i < n; --i) v |= bit() << i;
      return v;
    }
    bool inalign() {
      if ((buf & 0xff) == 0xff && !bytein()) return false;
      ct = 0;
      return true;
    }
    size_t numbytes() const { return size_t(bp - start); }
  };
  static uint32_t tgt_decode(Bio& bio, TagTree& t, uint32_t leaf, int32_t threshold) {
    int stk[64], sp = 0;
    int node = int(leaf);
    while (t.nodes[node].parent >= 0) { stk[sp++] = node; node = t.nodes[node].parent; }
    int32_t low = 0;
    for (;;) {
      TagTree::Node& nd = t.nodes[node];
      if (low > nd.low) nd.low = low;
      else low = nd.low;
      while (low < threshold && low < nd.value) {
        if (bio.read(1)) nd.value = low;
        else ++low;
      }
      nd.low = low;
      if (sp == 0) break;
      node = stk[--sp];
    }
    return t.nodes[node].value < threshold ? 1 : 0;
  }
  static void init_seg(Cblk& cb, uint32_t index, uint32_t cblksty, bool first) {
    if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
    Seg& s = cb.segs[index];
    s = Seg();
    if (cblksty & 4) s.maxpasses = 1;
    else if (cblksty & 1) {
      if (first) s.maxpasses = 10;
      else s.maxpasses = (cb.segs[index - 1].maxpasses == 1 || cb.segs[index - 1].maxpasses == 10) ? 2 : 1;
    } else s.maxpasses = 109;
  }
  static uint32_t floorlog2(uint32_t a) { uint32_t l = 0; while (a > 1) { a >>= 1; ++l; } return l; }

  // opj_tcd_is_subband_area_of_interest for the whole image: does this
  // precinct of a band meet the tile's band area, widened by the filter's
  // margin? (An empty band's never does.)
  bool band_of_interest(uint32_t compno, uint32_t resno, const Band& bd,
                        const Precinct& pr, uint32_t qmfbid) {
    const TileComp& tc = tile[compno];
    const uint32_t margin = qmfbid == 1 ? 2 : 3;
    const uint32_t nb = resno == 0 ? tc.numres - 1 : tc.numres - resno;
    const uint32_t x0b = bd.bandno & 1, y0b = bd.bandno >> 1;
    auto map = [nb](uint32_t v, uint32_t b) -> uint32_t {
      if (nb == 0) return v;
      const uint64_t off = (uint64_t(1) << (nb - 1)) * b;
      return v <= off ? 0 : uint32_t((v - off + (uint64_t(1) << nb) - 1) >> nb);
    };
    uint32_t bx0 = map(uint32_t(tc.x0), x0b), by0 = map(uint32_t(tc.y0), y0b);
    uint32_t bx1 = map(uint32_t(tc.x1), x0b), by1 = map(uint32_t(tc.y1), y0b);
    bx0 = bx0 < margin ? 0 : bx0 - margin;
    by0 = by0 < margin ? 0 : by0 - margin;
    bx1 = uint32_t(std::min<uint64_t>(uint64_t(bx1) + margin, 0xffffffffu));
    by1 = uint32_t(std::min<uint64_t>(uint64_t(by1) + margin, 0xffffffffu));
    return uint32_t(pr.x0) < bx1 && uint32_t(pr.y0) < by1 &&
           uint32_t(pr.x1) > bx0 && uint32_t(pr.y1) > by0;
  }

  // one packet: header and data; returns the bytes it takes from src. A
  // skipped packet (no band of interest) is read past: its code-block data
  // is not kept, as opj_t2_skip_packet does
  size_t decode_packet(Tcp& tcp, uint32_t compno, uint32_t resno, uint32_t precno,
                       uint32_t layno, const uint8_t* src, size_t max_len,
                       bool skip) {
    Res& res = tile[compno].res[resno];
    const uint32_t cblksty = tcp.tccps[compno].cblksty;
    if (layno == 0) {
      for (uint32_t b = 0; b < res.numbands; ++b) {
        Band& bd = res.bands[b];
        if (bd.empty()) continue;
        if (precno >= bd.precincts.size()) fail("Invalid precinct");
        Precinct& pr = bd.precincts[precno];
        pr.incl.reset();
        pr.imsb.reset();
        for (Cblk& cb : pr.cblks) cb.numsegs = 0;
      }
    }
    const uint8_t* cur = src;
    if (tcp.csty & 2) {  // SOP: optional, skipped where present
      if (max_len >= 6 && cur[0] == 0xff && cur[1] == 0x91) cur += 6;
    }
    const uint8_t* hdr;
    size_t hdr_len;
    std::vector<uint8_t>* hbuf = nullptr;
    size_t* hpos = nullptr;
    if (ppm) { hbuf = &ppm_buf; hpos = &ppm_pos; }
    else if (tcp.ppt) { hbuf = &tcp.ppt_buf; hpos = &tcp.ppt_pos; }
    if (hbuf) { hdr = hbuf->data() + *hpos; hdr_len = hbuf->size() - *hpos; }
    else { hdr = cur; hdr_len = size_t(src + max_len - cur); }
    Bio bio;
    bio.init(hdr, hdr_len);
    const bool present = bio.read(1);
    if (present) {
      for (uint32_t b = 0; b < res.numbands; ++b) {
        Band& bd = res.bands[b];
        if (bd.empty()) continue;
        Precinct& pr = bd.precincts[precno];
        for (uint32_t k = 0; k < pr.cw * pr.ch; ++k) {
          Cblk& cb = pr.cblks[k];
          uint32_t included;
          if (!cb.numsegs) included = tgt_decode(bio, pr.incl, k, int32_t(layno + 1));
          else included = bio.read(1);
          if (!included) { cb.numnewpasses = 0; continue; }
          if (!cb.numsegs) {
            uint32_t i = 0;
            while (!tgt_decode(bio, pr.imsb, k, int32_t(i))) ++i;
            cb.numbps = uint32_t(bd.numbps) + 1 - i;
            cb.numlenbits = 3;
          }
          uint32_t np;
          if (!bio.read(1)) np = 1;
          else if (!bio.read(1)) np = 2;
          else if ((np = bio.read(2)) != 3) np += 3;
          else if ((np = bio.read(5)) != 31) np += 6;
          else np = 37 + bio.read(7);
          cb.numnewpasses = np;
          uint32_t inc = 0;
          while (bio.read(1)) ++inc;
          cb.numlenbits += inc;
          uint32_t segno = 0;
          if (!cb.numsegs) init_seg(cb, 0, cblksty, true);
          else {
            segno = cb.numsegs - 1;
            if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) init_seg(cb, ++segno, cblksty, false);
          }
          int32_t left_passes = int32_t(cb.numnewpasses);
          do {
            Seg& s = cb.segs[segno];
            s.numnewpasses = uint32_t(std::min<int32_t>(int32_t(s.maxpasses - s.numpasses), left_passes));
            const uint32_t bits = cb.numlenbits + floorlog2(s.numnewpasses);
            if (bits > 32) fail("Invalid bit number in opj_t2_read_packet_header()");
            s.newlen = bio.read(bits);
            left_passes -= int32_t(s.numnewpasses);
            if (left_passes > 0) init_seg(cb, ++segno, cblksty, false);
          } while (left_passes > 0);
        }
      }
      if (!bio.inalign()) fail("packet header: bio_inalign");
    } else {
      bio.inalign();
    }
    const uint8_t* h = hdr + bio.numbytes();
    if (tcp.csty & 4) {  // EPH: required (OpenJPEG 2.5.4 fails without)
      const size_t used = size_t(h - hdr);
      if (hdr_len - used < 2) fail("Not enough space for expected EPH marker");
      if (h[0] != 0xff || h[1] != 0x92) fail("Expected EPH marker");
      h += 2;
    }
    const size_t hl = size_t(h - hdr);
    if (hbuf) *hpos += hl;
    else cur += hl;
    if (!present) return size_t(cur - src);
    // packet data (opj_t2_read_packet_data)
    for (uint32_t b = 0; b < res.numbands; ++b) {
      Band& bd = res.bands[b];
      if (bd.empty()) continue;
      Precinct& pr = bd.precincts[precno];
      for (Cblk& cb : pr.cblks) {
        if (!cb.numnewpasses) continue;
        uint32_t si;
        if (!cb.numsegs) { si = 0; ++cb.numsegs; }
        else {
          si = cb.numsegs - 1;
          if (cb.segs[si].numpasses == cb.segs[si].maxpasses) { ++si; ++cb.numsegs; }
        }
        do {
          Seg& s = cb.segs[si];
          if (size_t(cur - src) + s.newlen > max_len) fail("read: segment too long");
          if (!skip) {
            cb.data.insert(cb.data.end(), cur, cur + s.newlen);
            ++cb.numchunks;
          }
          cur += s.newlen;
          s.len += s.newlen;
          s.numpasses += s.numnewpasses;
          cb.numnewpasses -= s.numnewpasses;
          if (cb.numnewpasses > 0) { ++si; ++cb.numsegs; }
        } while (cb.numnewpasses > 0);
      }
    }
    return size_t(cur - src);
  }

  struct PiComp { uint32_t dx, dy, numres; std::vector<uint32_t> pdx, pdy, pw, ph; };
  void t2_decode(Tcp& tcp, const uint8_t* src, size_t len) {
    const uint32_t nc = uint32_t(comps.size());
    std::vector<PiComp> pc(nc);
    uint32_t max_res = 0, max_prec = 0;
    for (uint32_t c = 0; c < nc; ++c) {
      const TileComp& tc = tile[c];
      pc[c].dx = comps[c].dx; pc[c].dy = comps[c].dy; pc[c].numres = tc.numres;
      max_res = std::max(max_res, tc.numres);
      for (uint32_t r = 0; r < tc.numres; ++r) {
        const Res& rs = tc.res[r];
        pc[c].pdx.push_back(rs.pdx); pc[c].pdy.push_back(rs.pdy);
        pc[c].pw.push_back(rs.pw); pc[c].ph.push_back(rs.ph);
        max_prec = std::max(max_prec, rs.pw * rs.ph);
      }
    }
    const uint64_t step_c = max_prec, step_r = uint64_t(nc) * step_c, step_l = max_res * step_r;
    const uint64_t include_size = (uint64_t(tcp.numlayers) + 1) * step_l;
    if (include_size > (uint64_t(1) << 30)) fail("packet iterator too large");
    std::vector<uint8_t> include(include_size, 0);
    const uint32_t npocs = tcp.numpocs + 1;
    size_t at = 0;
    for (uint32_t pino = 0; pino < npocs; ++pino) {
      Poc poc;
      if (tcp.has_poc) {
        poc = tcp.pocs[pino];
        poc.layno1 = std::min(poc.layno1, tcp.numlayers);
      } else {
        poc = {0, 0, tcp.numlayers, max_res, nc, tcp.prg};
      }
      if (poc.prg == 0xffffffffu) fail("unknown progression order");
      std::vector<uint8_t> first_failed(nc, 1);
      auto visit = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t p) -> int {
        const uint64_t index = l * step_l + r * step_r + c * step_c + p;
        if (index >= include_size) return -1;
        if (include[index]) return 0;
        include[index] = 1;
        const Res& rs = tile[c].res[r];
        bool skip = true;
        for (uint32_t b = 0; b < rs.numbands && skip; ++b)
          skip = rs.bands[b].empty() ||
                 !band_of_interest(c, r, rs.bands[b], rs.bands[b].precincts[p],
                                   tcp.tccps[c].qmfbid);
        if (!skip) first_failed[c] = 0;
        at += decode_packet(tcp, c, r, p, l, src + at, len - at, skip);
        if (!skip) comps[c].resno_decoded = std::max(r, comps[c].resno_decoded);
        // a packet read past before any of its component's was decoded
        if (first_failed[c] && comps[c].resno_decoded == 0)
          comps[c].resno_decoded = tile[c].numres - 1;
        return 0;
      };
      // an order OpenJPEG's iterator does not know, or components out of
      // range: the iterator yields nothing for this progression
      bool stop = poc.prg > 4 || poc.compno0 >= nc || poc.compno1 >= nc + 1;
      const uint32_t prg = poc.prg;
      if (stop) {
      } else if (prg == 0 || prg == 1) {  // LRCP, RLCP
        const uint32_t outer1 = prg == 0 ? poc.layno1 : poc.resno1;
        const uint32_t inner0 = prg == 0 ? poc.resno0 : 0, inner1 = prg == 0 ? poc.resno1 : poc.layno1;
        for (uint32_t o = prg == 0 ? 0 : poc.resno0; o < outer1 && !stop; ++o)
          for (uint32_t i = inner0; i < inner1 && !stop; ++i)
            for (uint32_t c = poc.compno0; c < poc.compno1 && !stop; ++c) {
              const uint32_t l = prg == 0 ? o : i, r = prg == 0 ? i : o;
              if (r >= pc[c].numres) continue;
              const uint32_t np = pc[c].pw[r] * pc[c].ph[r];
              for (uint32_t p = 0; p < np && !stop; ++p)
                if (visit(l, r, c, p) < 0) stop = true;
            }
      } else {
        // RPCL (2), PCRL (3), CPRL (4): positions on the reference grid
        auto mins = [&](uint32_t c0, uint32_t c1, uint32_t* dx, uint32_t* dy) {
          *dx = *dy = 0;
          for (uint32_t c = c0; c < c1; ++c)
            for (uint32_t r = 0; r < pc[c].numres; ++r) {
              const uint32_t sx = pc[c].pdx[r] + pc[c].numres - 1 - r;
              const uint32_t sy = pc[c].pdy[r] + pc[c].numres - 1 - r;
              if (sx < 32 && pc[c].dx <= 0xffffffffu / (1u << sx)) {
                const uint32_t v = pc[c].dx * (1u << sx);
                *dx = !*dx ? v : std::min(*dx, v);
              }
              if (sy < 32 && pc[c].dy <= 0xffffffffu / (1u << sy)) {
                const uint32_t v = pc[c].dy * (1u << sy);
                *dy = !*dy ? v : std::min(*dy, v);
              }
            }
        };
        // the body shared by the three orders at (x, y, c, r): -1 to stop
        auto body = [&](uint32_t x, uint32_t y, uint32_t c, uint32_t r) -> int {
          const PiComp& k = pc[c];
          if (r >= k.numres) return 0;
          const uint32_t level = k.numres - 1 - r;
          if (uint32_t((uint64_t(k.dx) << level) >> level) != k.dx ||
              uint32_t((uint64_t(k.dy) << level) >> level) != k.dy) return 0;
          auto cdiv = [](uint64_t a, uint64_t b) { return uint32_t((a + b - 1) / b); };
          const uint32_t trx0 = cdiv(tile_x0, uint64_t(k.dx) << level);
          const uint32_t try0 = cdiv(tile_y0, uint64_t(k.dy) << level);
          const uint32_t trx1 = cdiv(tile_x1, uint64_t(k.dx) << level);
          const uint32_t try1 = cdiv(tile_y1, uint64_t(k.dy) << level);
          const uint32_t rpx = k.pdx[r] + level, rpy = k.pdy[r] + level;
          if (rpx >= 64 || rpy >= 64 ||
              uint32_t((uint64_t(k.dx) << rpx) >> rpx) != k.dx ||
              uint32_t((uint64_t(k.dy) << rpy) >> rpy) != k.dy) return 0;
          if (!((uint64_t(y) % (uint64_t(k.dy) << rpy) == 0) ||
                (y == tile_y0 && ((uint64_t(try0) << level) % (uint64_t(1) << rpy)))))
            return 0;
          if (!((uint64_t(x) % (uint64_t(k.dx) << rpx) == 0) ||
                (x == tile_x0 && ((uint64_t(trx0) << level) % (uint64_t(1) << rpx)))))
            return 0;
          if (k.pw[r] == 0 || k.ph[r] == 0) return 0;
          if (trx0 == trx1 || try0 == try1) return 0;
          const uint32_t prci = (cdiv(x, uint64_t(k.dx) << level) >> k.pdx[r]) - (trx0 >> k.pdx[r]);
          const uint32_t prcj = (cdiv(y, uint64_t(k.dy) << level) >> k.pdy[r]) - (try0 >> k.pdy[r]);
          const uint32_t p = prci + prcj * k.pw[r];
          for (uint32_t l = 0; l < poc.layno1; ++l)
            if (visit(l, r, c, p) < 0) return -1;
          return 0;
        };
        uint32_t dx, dy;
        if (prg == 2 || prg == 3) {
          mins(0, nc, &dx, &dy);
          if (dx == 0 || dy == 0) stop = true;
        }
        if (!stop && prg == 2) {
          for (uint32_t r = poc.resno0; r < poc.resno1 && !stop; ++r)
            for (uint32_t y = tile_y0; y < tile_y1 && !stop; y += dy - (y % dy))
              for (uint32_t x = tile_x0; x < tile_x1 && !stop; x += dx - (x % dx))
                for (uint32_t c = poc.compno0; c < poc.compno1 && !stop; ++c)
                  if (body(x, y, c, r) < 0) stop = true;
        } else if (!stop && prg == 3) {
          for (uint32_t y = tile_y0; y < tile_y1 && !stop; y += dy - (y % dy))
            for (uint32_t x = tile_x0; x < tile_x1 && !stop; x += dx - (x % dx))
              for (uint32_t c = poc.compno0; c < poc.compno1 && !stop; ++c)
                for (uint32_t r = poc.resno0; r < std::min(poc.resno1, pc[c].numres) && !stop; ++r)
                  if (body(x, y, c, r) < 0) stop = true;
        } else if (prg == 4) {
          for (uint32_t c = poc.compno0; c < poc.compno1 && !stop; ++c) {
            mins(c, c + 1, &dx, &dy);
            if (dx == 0 || dy == 0) { stop = true; break; }
            for (uint32_t y = tile_y0; y < tile_y1 && !stop; y += dy - (y % dy))
              for (uint32_t x = tile_x0; x < tile_x1 && !stop; x += dx - (x % dx))
                for (uint32_t r = poc.resno0; r < std::min(poc.resno1, pc[c].numres) && !stop; ++r)
                  if (body(x, y, c, r) < 0) stop = true;
          }
        }
      }
    }
  }

  // ---- tier-1 over the tile, dequantisation ----
  void t1_decode(const Tcp& tcp) {
    T1 t1;
    for (size_t c = 0; c < tile.size(); ++c) {
      TileComp& tc = tile[c];
      const Tccp& tccp = tcp.tccps[c];
      const int32_t tile_w = tc.x1 - tc.x0;
      for (uint32_t r = 0; r < tc.numres; ++r) {
        Res& rs = tc.res[r];
        for (uint32_t b = 0; b < rs.numbands; ++b) {
          Band& bd = rs.bands[b];
          if (bd.empty()) continue;
          for (Precinct& pr : bd.precincts)
            for (Cblk& cb : pr.cblks) {
              const int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
              if (w <= 0 || h <= 0) continue;
              decode_cblk(t1, cb, bd.bandno, tccp.roishift, tccp.cblksty, w, h);
              int32_t x = cb.x0 - bd.x0, y = cb.y0 - bd.y0;
              if (bd.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
              if (bd.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
              int32_t* dp = t1.data.data();
              if (tccp.roishift) {
                if (tccp.roishift >= 31) {
                  std::fill(t1.data.begin(), t1.data.end(), 0);
                } else {
                  const int32_t thresh = 1 << tccp.roishift;
                  for (int i = 0; i < w * h; ++i) {
                    const int32_t v = dp[i];
                    int32_t mag = v < 0 ? -v : v;
                    if (mag >= thresh) {
                      mag >>= tccp.roishift;
                      dp[i] = v < 0 ? -mag : mag;
                    }
                  }
                }
              }
              for (int j = 0; j < h; ++j) {
                int32_t* out = tc.data.data() + size_t(y + j) * tile_w + x;
                if (tccp.qmfbid == 1) {
                  for (int i = 0; i < w; ++i) out[i] = dp[j * w + i] / 2;
                } else {
                  const float step = 0.5f * bd.stepsize;
                  for (int i = 0; i < w; ++i) {
                    const float v = float(dp[j * w + i]) * step;
                    std::memcpy(out + i, &v, 4);
                  }
                }
              }
            }
        }
      }
    }
  }
  void decode_cblk(T1& t1, Cblk& cb, uint32_t orient, uint32_t roishift,
                   uint32_t cblksty, int w, int h) {
    t1.w = w; t1.h = h; t1.stride = w + 2;
    t1.vsc = cblksty & 8;
    t1.orient = int(orient);
    t1.f.assign(size_t(w + 2) * (h + 2), 0);
    t1.data.assign(size_t(w) * h, 0);
    int32_t bpno = int32_t(roishift + cb.numbps);
    if (bpno >= 31) fail("opj_t1_decode_cblk(): unsupported bpno_plus_one");
    if (cb.numchunks == 0) return;
    uint32_t passtype = 2;
    t1.mq.reset_states();
    std::vector<uint8_t> seg;
    size_t at = 0;
    for (uint32_t s = 0; s < cb.numsegs; ++s) {
      const Seg& sg = cb.segs[s];
      const bool raw = bpno <= int32_t(cb.numbps) - 4 && passtype < 2 && (cblksty & 1);
      seg.assign(sg.len + 4, 0xff);
      const size_t take = std::min<size_t>(sg.len, cb.data.size() - std::min(at, cb.data.size()));
      if (take) std::memcpy(seg.data(), cb.data.data() + at, take);
      seg[sg.len] = 0xff;
      seg[sg.len + 1] = 0xff;
      if (raw) t1.mq.raw_init(seg.data());
      else t1.mq.init(seg.data(), sg.len);
      at += sg.len;
      for (uint32_t p = 0; p < sg.numpasses && bpno >= 1; ++p) {
        if (passtype == 0) t1.sigpass(bpno, raw);
        else if (passtype == 1) t1.refpass(bpno, raw);
        else t1.clnpass(bpno, cblksty & 0x20);
        if ((cblksty & 2) && !raw) t1.mq.reset_states();
        if (++passtype == 3) { passtype = 0; --bpno; }
      }
    }
  }

  // ---- the inverse wavelets (dwt.c) ----
  static void idwt53(int32_t* x, int len, int sn, int cas, std::vector<int32_t>& tmp) {
    if (cas == 0) {
      if (len <= 1) return;
    } else if (len == 1) {
      x[0] /= 2;
      return;
    }
    // x: the first sn lows, then the highs -> interleaved by parity
    tmp.resize(len);
    for (int i = 0; i < len; ++i) {
      const bool low = ((i + cas) & 1) == 0;
      tmp[i] = low ? x[i / 2] : x[sn + i / 2];
    }
    auto at = [&](int i) -> int64_t {
      if (i < 0) i = -i;
      if (i >= len) i = 2 * (len - 1) - i;
      return tmp[i];
    };
    for (int i = 0; i < len; ++i)
      if (((i + cas) & 1) == 0) tmp[i] = int32_t(at(i) - ((at(i - 1) + at(i + 1) + 2) >> 2));
    for (int i = 0; i < len; ++i)
      if ((i + cas) & 1) tmp[i] = int32_t(at(i) + ((at(i - 1) + at(i + 1)) >> 1));
    std::memcpy(x, tmp.data(), sizeof(int32_t) * len);
  }
  // opj_v8dwt_decode on one line: w holds the interleaved samples
  static void idwt97(float* w, int sn, int dn, int cas) {
    int a, b;
    if (cas == 0) {
      if (!(dn > 0 || sn > 1)) return;
      a = 0; b = 1;
    } else {
      if (!(sn > 0 || dn > 1)) return;
      a = 1; b = 0;
    }
    const float K = 1.230174105f, two_invK = 1.625732422f;
    for (int i = 0; i < sn; ++i) w[a + 2 * i] = w[a + 2 * i] * K;
    for (int i = 0; i < dn; ++i) w[b + 2 * i] = w[b + 2 * i] * two_invK;
    auto step2 = [w](int l, int wi, int end, int m, float c) {
      int fl = l, fw = wi;
      const int imax = std::min(end, m);
      for (int i = 0; i < imax; ++i) {
        w[fw - 1] = w[fw - 1] + ((w[fl] + w[fw]) * c);
        fl = fw;
        fw += 2;
      }
      if (m < end) {
        c += c;
        w[fw - 1] = w[fw - 1] + w[fl] * c;
      }
    };
    step2(b, a + 1, sn, std::min(sn, dn - a), -0.443506852f);
    step2(a, b + 1, dn, std::min(dn, sn - b), -0.882911075f);
    step2(b, a + 1, sn, std::min(sn, dn - a), 0.052980118f);
    step2(a, b + 1, dn, std::min(dn, sn - b), 1.586134342f);
  }
  // opj_dwt_decode over the first ``numres`` resolutions (resno_decoded + 1)
  void dwt(TileComp& tc, uint32_t qmfbid, uint32_t numres) {
    if (numres <= 1) return;
    const int w = tc.x1 - tc.x0;
    int32_t* data = tc.data.data();
    int rw = tc.res[0].x1 - tc.res[0].x0, rh = tc.res[0].y1 - tc.res[0].y0;
    std::vector<int32_t> line, tmp;
    std::vector<float> fl;
    for (uint32_t r = 1; r < numres; ++r) {
      const int sn_h = rw, sn_v = rh;
      const Res& rs = tc.res[r];
      rw = rs.x1 - rs.x0;
      rh = rs.y1 - rs.y0;
      const int cas_h = rs.x0 % 2, cas_v = rs.y0 % 2;
      if (qmfbid == 1) {
        for (int j = 0; j < rh; ++j) idwt53(data + size_t(j) * w, rw, sn_h, cas_h, tmp);
        line.resize(rh);
        for (int i = 0; i < rw; ++i) {
          for (int j = 0; j < rh; ++j) line[j] = data[size_t(j) * w + i];
          idwt53(line.data(), rh, sn_v, cas_v, tmp);
          for (int j = 0; j < rh; ++j) data[size_t(j) * w + i] = line[j];
        }
      } else {
        fl.resize(std::max(rw, rh) + 2);
        const int dn_h = rw - sn_h, dn_v = rh - sn_v;
        for (int j = 0; j < rh; ++j) {
          float* row = reinterpret_cast<float*>(data + size_t(j) * w);
          for (int i = 0; i < sn_h; ++i) fl[cas_h + 2 * i] = row[i];
          for (int i = 0; i < dn_h; ++i) fl[1 - cas_h + 2 * i] = row[sn_h + i];
          idwt97(fl.data(), sn_h, dn_h, cas_h);
          std::memcpy(row, fl.data(), sizeof(float) * rw);
        }
        for (int i = 0; i < rw; ++i) {
          float* col = reinterpret_cast<float*>(data) + i;
          for (int j = 0; j < sn_v; ++j) fl[cas_v + 2 * j] = col[size_t(j) * w];
          for (int j = 0; j < dn_v; ++j) fl[1 - cas_v + 2 * j] = col[size_t(sn_v + j) * w];
          idwt97(fl.data(), sn_v, dn_v, cas_v);
          for (int j = 0; j < rh; ++j) col[size_t(j) * w] = fl[j];
        }
      }
    }
  }

  // ---- opj_tcd_decode_tile and opj_tcd_update_tile_data ----
  uint32_t size_comp(size_t c) const {
    uint32_t s = (comps[c].prec + 7) >> 3;
    return s == 3 ? 4 : s;
  }
  long tile_data_size() {
    uint64_t total = 0;
    for (size_t c = 0; c < comps.size(); ++c) {
      const Res& rs = tile[c].res[tile[c].numres - 1];
      total += uint64_t(rs.x1 - rs.x0) * uint64_t(rs.y1 - rs.y0) * size_comp(c);
    }
    if (total > 0xffffffffull) fail("tile too large");
    return long(total);
  }
  void decode_tile(uint8_t* out, long out_len) {
    Tcp& tcp = tcps[cur_tile];
    t2_decode(tcp, tcp.data.data(), tcp.data.size());
    t1_decode(tcp);
    for (size_t c = 0; c < tile.size(); ++c)
      dwt(tile[c], tcp.tccps[c].qmfbid,
          std::min(comps[c].resno_decoded + 1, tile[c].numres));
    // MCT
    if (tcp.mct) {
      const Res& r0 = tile[0].res[tile[0].numres - 1];
      const size_t n = size_t(r0.x1 - r0.x0) * size_t(r0.y1 - r0.y0);
      if (tile.size() >= 3) {
        const Res& r1 = tile[1].res[tile[0].numres - 1 < tile[1].numres ? tile[0].numres - 1 : 0];
        const Res& r2 = tile[2].res[tile[0].numres - 1 < tile[2].numres ? tile[0].numres - 1 : 0];
        if (tile[0].numres != tile[1].numres || tile[0].numres != tile[2].numres ||
            comps[0].resno_decoded != comps[1].resno_decoded ||
            comps[0].resno_decoded != comps[2].resno_decoded ||
            size_t(r1.x1 - r1.x0) * size_t(r1.y1 - r1.y0) != n ||
            size_t(r2.x1 - r2.x0) * size_t(r2.y1 - r2.y0) != n)
          fail("Tiles don't all have the same dimension. Skip the MCT step.");
        int32_t *c0 = tile[0].data.data(), *c1 = tile[1].data.data(), *c2 = tile[2].data.data();
        if (tcp.tccps[0].qmfbid == 1) {
          for (size_t i = 0; i < n; ++i) {
            const int32_t y = c0[i], u = c1[i], v = c2[i];
            const int32_t g = y - ((u + v) >> 2);
            c0[i] = v + g;
            c1[i] = g;
            c2[i] = u + g;
          }
        } else {
          float *f0 = reinterpret_cast<float*>(c0), *f1 = reinterpret_cast<float*>(c1),
                *f2 = reinterpret_cast<float*>(c2);
          for (size_t i = 0; i < n; ++i) {
            const float y = f0[i], u = f1[i], v = f2[i];
            const float r = y + (v * 1.402f);
            const float g = y - (u * 0.34413f) - (v * 0.71414f);
            const float b = y + (u * 1.772f);
            f0[i] = r;
            f1[i] = g;
            f2[i] = b;
          }
        }
      }
    }
    // DC level shift and clamping, then the output buffer
    long need = 0;
    for (size_t c = 0; c < tile.size(); ++c) {
      TileComp& tc = tile[c];
      const Tccp& tccp = tcp.tccps[c];
      const Res& rs = tc.res[std::min(comps[c].resno_decoded, tc.numres - 1)];
      const int w = rs.x1 - rs.x0, h = rs.y1 - rs.y0;
      const int stride = tc.x1 - tc.x0;
      const Comp& cp = comps[c];
      int64_t lo, hi;
      if (cp.sgnd) { lo = -(int64_t(1) << (cp.prec - 1)); hi = (int64_t(1) << (cp.prec - 1)) - 1; }
      else { lo = 0; hi = int64_t(uint32_t((1u << cp.prec) - 1)); }
      const int64_t shift = cp.sgnd ? 0 : int64_t(1) << (cp.prec - 1);
      for (int j = 0; j < h; ++j) {
        int32_t* p = tc.data.data() + size_t(j) * stride;
        for (int i = 0; i < w; ++i) {
          if (tccp.qmfbid == 1) {
            p[i] = int32_t(std::min(std::max(int64_t(p[i]) + shift, lo), hi));
          } else {
            float v;
            std::memcpy(&v, p + i, 4);
            if (v > float(INT32_MAX)) p[i] = int32_t(hi);
            else if (v < float(INT32_MIN)) p[i] = int32_t(lo);
            else if (std::isnan(v)) p[i] = int32_t(lo);
            else p[i] = int32_t(std::min(std::max(int64_t(lrintf(v)) + shift, lo), hi));
          }
        }
      }
      need += long(w) * h * size_comp(c);
    }
    if (need > out_len) fail("output buffer too small");
    uint8_t* o = out;
    for (size_t c = 0; c < tile.size(); ++c) {
      TileComp& tc = tile[c];
      const Res& rs = tc.res[std::min(comps[c].resno_decoded, tc.numres - 1)];
      const int w = rs.x1 - rs.x0, h = rs.y1 - rs.y0, stride = tc.x1 - tc.x0;
      const uint32_t sz = size_comp(c);
      for (int j = 0; j < h; ++j) {
        const int32_t* p = tc.data.data() + size_t(j) * stride;
        for (int i = 0; i < w; ++i) {
          const uint32_t v = uint32_t(p[i]);
          if (sz == 1) *o++ = uint8_t(v);
          else if (sz == 2) { const uint16_t s = uint16_t(v); std::memcpy(o, &s, 2); o += 2; }
          else { std::memcpy(o, &v, 4); o += 4; }
        }
      }
    }
    // after the tile: its data is dropped, the next marker read
    tcp.data.clear();
    tcp.data.shrink_to_fit();
    tcp.has_data = false;
    can_decode = false;
    state &= ~ST_DATA;
    if (left() == 0 && state == ST_NEOC) return;
    if (state != ST_EOC) {
      uint32_t m;
      if (!read2(&m)) fail("Stream too short");
      if (m == MS_EOC) { cur_tile = 0; state = ST_EOC; }
      else if (m != MS_SOT) {
        if (left() == 0) { state = ST_NEOC; return; }
        fail("Stream too short, expected SOT");
      }
    }
  }
};

void keep(char* err, long errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg.c_str());
}

}  // namespace

extern "C" {

// opj_read_header: the JP2 boxes up to the codestream (jp2 != 0), then the
// main header. Returns a handle, or null with the reason in ``err``;
// ``*refused`` is 1 for HTJ2K, 2 for Part 2 extensions, in a header that
// otherwise reads.
void* f101j2k_open(const uint8_t* data, long n, int jp2, int* refused, char* err,
                   long errlen) {
  Dec* dec = new Dec();
  dec->d = data;
  dec->n = n;
  *refused = 0;
  try {
    if (jp2) {
      dec->jp2_boxes();
      if (!dec->has_jp2h) dec->fail("JP2H box missing. Required.");
      if (!dec->has_ihdr) dec->fail("IHDR box missing. Required.");
    }
    dec->read_main_header();
    *refused = dec->refused;
    return dec;
  } catch (Fail&) {  // a header OpenJPEG fails too: 400, not 415
    keep(err, errlen, dec->err);
    delete dec;
    return nullptr;
  }
}

// the image: x0, y0, x1, y1, the number of components, OpenJPEG's colour
// space (0 unspecified (J2K), 1 sRGB, 2 grey, 3 sYCC, 4 eYCC, 5 CMYK, -1
// unknown), then dx, dy, prec, sgnd for each component
long f101j2k_image(void* h, int jp2, int64_t* out, long len) {
  Dec* d = static_cast<Dec*>(h);
  const long need = 6 + 4 * long(d->comps.size());
  if (len < need) return need;
  out[0] = d->x0; out[1] = d->y0; out[2] = d->x1; out[3] = d->y1;
  out[4] = int64_t(d->comps.size());
  int64_t cs = 0;
  if (jp2) {
    switch (d->enumcs) {
      case 16: cs = 1; break;
      case 17: cs = 2; break;
      case 18: cs = 3; break;
      case 24: cs = 4; break;
      case 12: cs = 5; break;
      default: cs = 0;  // PIL then goes by the number of components
    }
  }
  out[5] = cs;
  for (size_t c = 0; c < d->comps.size(); ++c) {
    out[6 + 4 * c] = d->comps[c].dx;
    out[7 + 4 * c] = d->comps[c].dy;
    out[8 + 4 * c] = d->comps[c].prec;
    out[9 + 4 * c] = d->comps[c].sgnd;
  }
  return need;
}

// opj_read_tile_header: 1 and (index, x0, y0, x1, y1, components, data
// size) in ``info``, 0 when no tile is left, -1 on error
int f101j2k_next_tile(void* h, int64_t* info, char* err, long errlen) {
  Dec* d = static_cast<Dec*>(h);
  try {
    if (!d->read_tile_header()) return 0;
    info[0] = d->cur_tile;
    info[1] = d->tile_x0; info[2] = d->tile_y0; info[3] = d->tile_x1; info[4] = d->tile_y1;
    info[5] = int64_t(d->comps.size());
    info[6] = d->tile_data_size();
    return 1;
  } catch (Fail&) {
    keep(err, errlen, d->err);
    return -1;
  }
}

// opj_decode_tile_data into ``out`` (OpenJPEG's layout: each component's
// samples in 1, 2 or 4 bytes, one after the other): 0, or -1 on error
int f101j2k_decode_tile(void* h, uint8_t* out, long len, char* err, long errlen) {
  Dec* d = static_cast<Dec*>(h);
  try {
    d->decode_tile(out, len);
    return 0;
  } catch (Fail&) {
    keep(err, errlen, d->err);
    return -1;
  }
}

// opj_end_decompress: for JP2 the boxes after the codestream
int f101j2k_end(void* h, int jp2, char* err, long errlen) {
  Dec* d = static_cast<Dec*>(h);
  try {
    if (jp2) d->jp2_boxes();
    return 0;
  } catch (Fail&) {
    keep(err, errlen, d->err);
    return -1;
  }
}

void f101j2k_close(void* h) { delete static_cast<Dec*>(h); }

}  // extern "C"
