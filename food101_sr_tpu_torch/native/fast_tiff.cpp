// TIFF decompression and QOI decoding with no library: what libtiff 4.7
// (behind PIL's TIFF plugin for every compressed TIFF) and PIL's QOI
// decoder give, written out for the request decoder in native/ (the TIFF
// container, Deflate, LZMA, JPEG, predictors and pixel layouts are in
// Python, native/tiff.py).
//   - PackBits (tif_packbits.c PackBitsDecode): a run past the strip is
//     cut, data that ends before the strip is full is an error.
//   - LZW (tif_lzw.c LZWDecode, and LZWDecodeCompat for the old-style
//     codes): 9 to 12 bit codes MSB first with early change (old-style:
//     LSB first, without), Clear and EOI; a stream that
//     does not start with Clear continues from entry 0 as libtiff's
//     does; data that ends before the strip is full, a code past the table
//     and an undefined string are errors.
//   - CCITT (tif_fax3.c with the tables mkg3states.c generates): Modified
//     Huffman (compression 2, byte-aligned rows), T.4 1-D and 2-D
//     (compression 3, EOL-synchronised) and T.6 (compression 4), with
//     libtiff's run bookkeeping and its recovery: a bad code word ends the
//     row as libtiff ends it and the decode goes on, the bits past the
//     data read as zeros, and data that ends early ends the strip as
//     libtiff 4.7 does (Fax below: Modified Huffman fails, T.4 1-D
//     succeeds, T.4 2-D and T.6 succeed in some places past the first row).
//   - raw-16 (compression 32771, Fax3DecodeRLE with FAXMODE_WORDALIGN):
//     Modified Huffman rows that start on 16-bit boundaries.
//   - ThunderScan (tif_thunder.c): 4-bit runs, deltas and raw pixels.
//   - QOI (PIL's QoiDecoder): the six ops over RGBA with PIL's index hash
//     and its (0, 0, 0, 0) for an index never written; data that ends
//     before the image is full is an error.
//
// Build: g++ -O3 -shared -fPIC fast_tiff.cpp -o libfast_tiff.so (no
// library; native/__init__.py builds it on first use into _build/).
// Every entry point keeps its state on the stack.

#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CCITT: the state tables of mkg3states.c, filled from the T.4 code lists
// ---------------------------------------------------------------------------

enum State {
  S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB,
  S_MakeUpW, S_MakeUpB, S_MakeUp, S_EOL
};

struct TabEnt {
  uint8_t state = S_Null, width = 0;
  uint32_t param = 0;
};

struct Code {
  const char* bits;  // most significant bit first, as T.4 lists them
  uint32_t param;
};

const Code kTermW[] = {
    {"00110101", 0},  {"000111", 1},    {"0111", 2},      {"1000", 3},
    {"1011", 4},      {"1100", 5},      {"1110", 6},      {"1111", 7},
    {"10011", 8},     {"10100", 9},     {"00111", 10},    {"01000", 11},
    {"001000", 12},   {"000011", 13},   {"110100", 14},   {"110101", 15},
    {"101010", 16},   {"101011", 17},   {"0100111", 18},  {"0001100", 19},
    {"0001000", 20},  {"0010111", 21},  {"0000011", 22},  {"0000100", 23},
    {"0101000", 24},  {"0101011", 25},  {"0010011", 26},  {"0100100", 27},
    {"0011000", 28},  {"00000010", 29}, {"00000011", 30}, {"00011010", 31},
    {"00011011", 32}, {"00010010", 33}, {"00010011", 34}, {"00010100", 35},
    {"00010101", 36}, {"00010110", 37}, {"00010111", 38}, {"00101000", 39},
    {"00101001", 40}, {"00101010", 41}, {"00101011", 42}, {"00101100", 43},
    {"00101101", 44}, {"00000100", 45}, {"00000101", 46}, {"00001010", 47},
    {"00001011", 48}, {"01010010", 49}, {"01010011", 50}, {"01010100", 51},
    {"01010101", 52}, {"00100100", 53}, {"00100101", 54}, {"01011000", 55},
    {"01011001", 56}, {"01011010", 57}, {"01011011", 58}, {"01001010", 59},
    {"01001011", 60}, {"00110010", 61}, {"00110011", 62}, {"00110100", 63},
    {nullptr, 0}};

const Code kMakeUpW[] = {
    {"11011", 64},       {"10010", 128},      {"010111", 192},
    {"0110111", 256},    {"00110110", 320},   {"00110111", 384},
    {"01100100", 448},   {"01100101", 512},   {"01101000", 576},
    {"01100111", 640},   {"011001100", 704},  {"011001101", 768},
    {"011010010", 832},  {"011010011", 896},  {"011010100", 960},
    {"011010101", 1024}, {"011010110", 1088}, {"011010111", 1152},
    {"011011000", 1216}, {"011011001", 1280}, {"011011010", 1344},
    {"011011011", 1408}, {"010011000", 1472}, {"010011001", 1536},
    {"010011010", 1600}, {"011000", 1664},    {"010011011", 1728},
    {nullptr, 0}};

const Code kTermB[] = {
    {"0000110111", 0},   {"010", 1},          {"11", 2},
    {"10", 3},           {"011", 4},          {"0011", 5},
    {"0010", 6},         {"00011", 7},        {"000101", 8},
    {"000100", 9},       {"0000100", 10},     {"0000101", 11},
    {"0000111", 12},     {"00000100", 13},    {"00000111", 14},
    {"000011000", 15},   {"0000010111", 16},  {"0000011000", 17},
    {"0000001000", 18},  {"00001100111", 19}, {"00001101000", 20},
    {"00001101100", 21}, {"00000110111", 22}, {"00000101000", 23},
    {"00000010111", 24}, {"00000011000", 25}, {"000011001010", 26},
    {"000011001011", 27}, {"000011001100", 28}, {"000011001101", 29},
    {"000001101000", 30}, {"000001101001", 31}, {"000001101010", 32},
    {"000001101011", 33}, {"000011010010", 34}, {"000011010011", 35},
    {"000011010100", 36}, {"000011010101", 37}, {"000011010110", 38},
    {"000011010111", 39}, {"000001101100", 40}, {"000001101101", 41},
    {"000011011010", 42}, {"000011011011", 43}, {"000001010100", 44},
    {"000001010101", 45}, {"000001010110", 46}, {"000001010111", 47},
    {"000001100100", 48}, {"000001100101", 49}, {"000001010010", 50},
    {"000001010011", 51}, {"000000100100", 52}, {"000000110111", 53},
    {"000000111000", 54}, {"000000100111", 55}, {"000000101000", 56},
    {"000001011000", 57}, {"000001011001", 58}, {"000000101011", 59},
    {"000000101100", 60}, {"000001011010", 61}, {"000001100110", 62},
    {"000001100111", 63}, {nullptr, 0}};

const Code kMakeUpB[] = {
    {"0000001111", 64},     {"000011001000", 128},  {"000011001001", 192},
    {"000001011011", 256},  {"000000110011", 320},  {"000000110100", 384},
    {"000000110101", 448},  {"0000001101100", 512}, {"0000001101101", 576},
    {"0000001001010", 640}, {"0000001001011", 704}, {"0000001001100", 768},
    {"0000001001101", 832}, {"0000001110010", 896}, {"0000001110011", 960},
    {"0000001110100", 1024}, {"0000001110101", 1088},
    {"0000001110110", 1152}, {"0000001110111", 1216},
    {"0000001010010", 1280}, {"0000001010011", 1344},
    {"0000001010100", 1408}, {"0000001010101", 1472},
    {"0000001011010", 1536}, {"0000001011011", 1600},
    {"0000001100100", 1664}, {"0000001100101", 1728}, {nullptr, 0}};

// the extended make-up codes, shared by both colours
const Code kMakeUp[] = {
    {"00000001000", 1792},  {"00000001100", 1856},  {"00000001101", 1920},
    {"000000010010", 1984}, {"000000010011", 2048}, {"000000010100", 2112},
    {"000000010101", 2176}, {"000000010110", 2240}, {"000000010111", 2304},
    {"000000011100", 2368}, {"000000011101", 2432}, {"000000011110", 2496},
    {"000000011111", 2560}, {nullptr, 0}};

const Code kEOLH[] = {{"00000000000", 0}, {nullptr, 0}};  // 11 zeros
const Code kPass[] = {{"0001", 0}, {nullptr, 0}};
const Code kHoriz[] = {{"001", 0}, {nullptr, 0}};
const Code kV0[] = {{"1", 0}, {nullptr, 0}};
const Code kVR[] = {{"011", 1}, {"000011", 2}, {"0000011", 3}, {nullptr, 0}};
const Code kVL[] = {{"010", 1}, {"000010", 2}, {"0000010", 3}, {nullptr, 0}};
const Code kExt[] = {{"0000001", 0}, {nullptr, 0}};
const Code kEOLV[] = {{"0000000", 0}, {nullptr, 0}};

// mkg3states.c FillTable: every index of a Size-bit table whose low bits
// (the bits in the order they are read) spell the code
void fill(TabEnt* t, int size, const Code* p, int state) {
  for (; p->bits; ++p) {
    const int width = static_cast<int>(std::strlen(p->bits));
    int code = 0;
    for (int i = 0; i < width; ++i)
      if (p->bits[i] == '1') code |= 1 << i;
    for (int c = code; c < (1 << size); c += 1 << width) {
      t[c].state = static_cast<uint8_t>(state);
      t[c].width = static_cast<uint8_t>(width);
      t[c].param = p->param;
    }
  }
}

struct Tables {
  TabEnt main[1 << 7], white[1 << 12], black[1 << 13];
  uint8_t rev[256];
  Tables() {
    fill(main, 7, kPass, S_Pass);
    fill(main, 7, kHoriz, S_Horiz);
    fill(main, 7, kV0, S_V0);
    fill(main, 7, kVR, S_VR);
    fill(main, 7, kVL, S_VL);
    fill(main, 7, kExt, S_Ext);
    fill(main, 7, kEOLV, S_EOL);
    fill(white, 12, kMakeUpW, S_MakeUpW);
    fill(white, 12, kMakeUp, S_MakeUp);
    fill(white, 12, kTermW, S_TermW);
    fill(white, 12, kEOLH, S_EOL);
    fill(black, 13, kMakeUpB, S_MakeUpB);
    fill(black, 13, kMakeUp, S_MakeUp);
    fill(black, 13, kTermB, S_TermB);
    fill(black, 13, kEOLH, S_EOL);
    for (int i = 0; i < 256; ++i) {
      int r = 0;
      for (int b = 0; b < 8; ++b)
        if (i & (1 << b)) r |= 0x80 >> b;
      rev[i] = static_cast<uint8_t>(r);
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

struct Eof {};       // the data ended where libtiff's decoder jumps to EOF
struct Overflow {};  // libtiff's "Buffer overflow": the strip fails

// The fax decoder of one strip or tile: libtiff's macros (Fax3Decode1D,
// Fax3Decode2D, Fax3DecodeRLE, Fax4Decode) as member functions. runs is
// the image's run arrays (fax_runs()), which libtiff allocates once per
// image and zeroes: each strip starts with the current row in its first
// half and the reference row (2-D coding) in its second (Fax3PreDecode),
// and entries past a row's runs keep what earlier rows and strips wrote.
class Fax {
 public:
  Fax(const uint8_t* cp, long n, bool msb_first, int width, bool noeol,
      bool refline, uint32_t* runs)
      : start_(cp), cp_(cp), ep_(cp + n), width_(width),
        nruns_(fax_runs(width, refline) / 2), cur_(runs),
        ref_(refline ? runs + nruns_ : nullptr), noeol_(noeol) {
    const Tables& t = tables();
    // libtiff's bit reader takes each byte's bits low first; a file in
    // FillOrder 1 has them high first, so its bytes go through BitRevTable
    for (int i = 0; i < 256; ++i)
      bitmap_[i] = msb_first ? t.rev[i] : static_cast<uint8_t>(i);
    if (ref_) {
      ref_[0] = width;  // an all-white reference line
      ref_[1] = 0;
    }
  }

  // libtiff's nruns (per half) times 2, for a row of width pixels
  static int fax_runs(int width, bool refline) {
    const int n = (width + 1 + 31) / 32 * 32;
    return 2 * (refline ? 2 * n : n);
  }

  // Compressions 2 and 32771 (Fax3DecodeRLE): 1-D rows, each starting on
  // a byte boundary, or for 32771 (FAXMODE_WORDALIGN) on a 16-bit one:
  // the bits held are cut to a multiple of 16, and with none held the
  // pointer steps to an even address (odd: the data starts at an odd
  // one). Data that ends before the strip is full fails it.
  int rle(uint8_t* buf, int rows, int rowbytes, bool word, bool odd) {
    for (int line = 0; line < rows; ++line) {
      start_row();
      try {
        expand1d();
      } catch (const Eof&) {
        fillruns(buf + static_cast<long>(line) * rowbytes);
        return -1;
      }
      fillruns(buf + static_cast<long>(line) * rowbytes);
      if (!word) {
        clr(avail_ - (avail_ & ~7));  // FAXMODE_BYTEALIGN
      } else {
        clr(avail_ - (avail_ & ~15));
        if (avail_ == 0 && ((cp_ - start_) + odd) & 1) ++cp_;
      }
    }
    return rows;
  }

  // Compression 3: rows after an EOL; with 2-D coding a tag bit per row
  // chooses 1-D or 2-D. Data that ends early fails the strip, as in
  // libtiff 4.7 (Fax3Decode1D, Fax3Decode2D), but for its SYNC_EOL: where
  // the data ends past an EOL's zeros, before its 1 (zero padding makes
  // any data that ends mid-row look so), libtiff takes the file for one
  // coded without EOLs ("Try to decode (read) fax Group 3 data without
  // EOL"): it decodes the strip again from its first byte, from the row it
  // was in, with no EOL before a row, and keeps that mode for the image's
  // later strips (noeol()). Zero padding then carries 1-D rows to the end
  // of the strip; 2-D rows may still reach the end of the data.
  int g3(uint8_t* buf, int rows, int rowbytes, bool twod) {
    for (int line = 0; line < rows; ++line) {
      start_row();
      uint8_t* row = buf + static_cast<long>(line) * rowbytes;
      try {
        if (!noeol_ && !sync_eol()) {
          noeol_ = true;
          cp_ = start_;
          acc_ = 0;
          avail_ = 0;
          eolcnt_ = 0;
          --line;
          continue;
        }
        bool is1d = true;
        if (twod) {
          need(1);
          is1d = bits(1);
          clr(1);
        }
        if (twod) {
          pb_ = 0;
          b1_ = ref_[pb_++];
        }
        if (is1d)
          expand1d();
        else
          expand2d();
      } catch (const Eof&) {
        fillruns(row);
        return -1;
      }
      fillruns(row);
      if (twod) {
        if (pa_ < nruns_) setvalue(0);  // imaginary change for reference
        std::swap(cur_, ref_);
      }
    }
    return rows;
  }

  bool noeol() const { return noeol_; }

  // Compression 4: 2-D rows against the previous one, no EOLs. Returns the
  // rows decoded. When the data ends early libtiff fills the row it was in
  // and succeeds if that was not the strip's first (-1 if it was): "don't
  // error on badly-terminated strips".
  int g4(uint8_t* buf, int rows, int rowbytes) {
    for (int line = 0; line < rows; ++line) {
      start_row();
      uint8_t* row = buf + static_cast<long>(line) * rowbytes;
      pb_ = 0;
      b1_ = ref_[pb_++];
      bool eof = false;
      try {
        expand2d();
      } catch (const Eof&) {
        eof = true;
      }
      if (eof || eolcnt_) {
        fillruns(row);
        return line ? line + 1 : -1;
      }
      fillruns(row);
      setvalue(0);  // imaginary change for reference
      std::swap(cur_, ref_);
    }
    return rows;
  }

 private:
  const uint8_t* start_;
  const uint8_t* cp_;
  const uint8_t* ep_;
  uint8_t bitmap_[256];
  uint32_t acc_ = 0;
  int avail_ = 0;
  int width_;
  const int nruns_;
  // libtiff's types: runs are uint32_t, positions int (C's conversions
  // between them included)
  // libtiff's curruns and refruns; the run arrays have 4 entries past
  // their end for the runs libtiff writes unchecked
  uint32_t* cur_;
  uint32_t* ref_;
  int pa_ = 0, pb_ = 0;
  int32_t a0_ = 0, run_length_ = 0, b1_ = 0;
  int eolcnt_ = 0;
  bool noeol_;

  void start_row() {
    a0_ = 0;
    run_length_ = 0;
    pa_ = 0;
  }

  // NeedBits8 / NeedBits16: past the data, the bits still held are padded
  // with zeros; with none held the decode has reached its end
  void need(int n) {
    while (avail_ < n) {
      if (cp_ >= ep_) {
        if (avail_ == 0) throw Eof();
        avail_ = n;
        return;
      }
      acc_ |= static_cast<uint32_t>(bitmap_[*cp_++]) << avail_;
      avail_ += 8;
    }
  }
  uint32_t bits(int n) const { return acc_ & ((1u << n) - 1); }
  void clr(int n) {
    avail_ -= n;
    acc_ >>= n;
  }
  const TabEnt& lookup(const TabEnt* t, int wid) {
    need(wid);
    const TabEnt& e = t[bits(wid)];
    clr(e.width);
    return e;
  }

  void setvalue(int32_t x) {
    if (pa_ >= nruns_) throw Overflow();
    cur_[pa_++] = static_cast<uint32_t>(run_length_ + x);
    a0_ += x;
    run_length_ = 0;
  }
  void push_unchecked(int32_t x) {
    if (pa_ >= nruns_ + 2) throw Overflow();
    cur_[pa_++] = static_cast<uint32_t>(x);
  }
  static int32_t add(int32_t a, uint32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) + b);
  }

  // SYNC_EOL: false where the data ends looking for the EOL's 1
  // (libtiff's noEOLFound)
  bool sync_eol() {
    if (eolcnt_ == 0) {
      for (;;) {
        need(11);
        if (bits(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      try {
        need(8);
      } catch (const Eof&) {
        return false;
      }
      if (bits(8)) break;
      clr(8);
    }
    while (bits(1) == 0) clr(1);
    clr(1);  // the EOL's 1
    eolcnt_ = 0;
    return true;
  }

  void cleanup_runs() {
    if (run_length_) setvalue(0);
    const int32_t lastx = width_;
    if (a0_ != lastx) {
      while (a0_ > lastx && pa_ > 0)
        a0_ = static_cast<int32_t>(static_cast<uint32_t>(a0_) - cur_[--pa_]);
      if (a0_ < lastx) {
        if (a0_ < 0) a0_ = 0;
        if (pa_ & 1) setvalue(0);
        setvalue(lastx - a0_);
      } else if (a0_ > lastx) {
        setvalue(lastx);
        setvalue(0);
      }
    }
  }

  // A run of one colour: make-up codes, then a terminating one. False when
  // the table gives anything else (libtiff's "unexpected", or an EOL).
  bool run(bool white, int* eol) {
    const Tables& t = tables();
    for (;;) {
      const TabEnt& e = white ? lookup(t.white, 12) : lookup(t.black, 13);
      switch (e.state) {
        case S_EOL:
          *eol = 1;
          return false;
        case S_TermW:
        case S_TermB:
          if ((e.state == S_TermW) != white) return false;
          setvalue(e.param);
          return true;
        case S_MakeUpW:
        case S_MakeUpB:
          if ((e.state == S_MakeUpW) != white) return false;
          [[fallthrough]];
        case S_MakeUp:
          a0_ += static_cast<int32_t>(e.param);
          run_length_ += static_cast<int32_t>(e.param);
          break;
        default:
          return false;
      }
    }
  }

  void expand1d() {
    const int32_t lastx = width_;
    try {
      for (;;) {
        int eol = 0;
        if (!run(true, &eol)) {
          if (eol) eolcnt_ = 1;
          break;
        }
        if (a0_ >= lastx) break;
        if (!run(false, &eol)) {
          if (eol) eolcnt_ = 1;
          break;
        }
        if (a0_ >= lastx) break;
        if (pa_ >= 2 && cur_[pa_ - 1] == 0 && cur_[pa_ - 2] == 0) pa_ -= 2;
      }
    } catch (const Eof&) {
      cleanup_runs();
      throw;
    }
    cleanup_runs();
  }

  void check_b1() {
    if (pa_ != 0) {
      while (b1_ <= a0_ && b1_ < width_) {
        if (pb_ + 1 >= nruns_) throw Overflow();
        b1_ = add(b1_, ref_[pb_] + ref_[pb_ + 1]);
        pb_ += 2;
      }
    }
  }

  void expand2d() {
    const Tables& t = tables();
    const int32_t lastx = width_;
    try {
      while (a0_ < lastx) {
        if (pa_ >= nruns_) throw Overflow();
        const TabEnt& e = lookup(t.main, 7);
        switch (e.state) {
          case S_Pass:
            check_b1();
            if (pb_ + 1 >= nruns_) throw Overflow();
            b1_ = add(b1_, ref_[pb_++]);
            run_length_ += b1_ - a0_;
            a0_ = b1_;
            b1_ = add(b1_, ref_[pb_++]);
            break;
          case S_Horiz: {
            int eol = 0;
            const bool black_first = pa_ & 1;
            if (!run(!black_first, &eol) || !run(black_first, &eol)) {
              cleanup_runs();
              return;
            }
            check_b1();
            break;
          }
          case S_V0:
            check_b1();
            setvalue(b1_ - a0_);
            b1_ = add(b1_, ref_[pb_++]);
            break;
          case S_VR:
            check_b1();
            setvalue(b1_ - a0_ + static_cast<int32_t>(e.param));
            b1_ = add(b1_, ref_[pb_++]);
            break;
          case S_VL:
            check_b1();
            if (b1_ < a0_ + static_cast<int32_t>(e.param)) {
              cleanup_runs();
              return;
            }
            setvalue(b1_ - a0_ - static_cast<int32_t>(e.param));
            if (pb_ == 0) throw Overflow();
            b1_ = static_cast<int32_t>(static_cast<uint32_t>(b1_) - ref_[--pb_]);
            break;
          case S_Ext:
            push_unchecked(lastx - a0_);
            cleanup_runs();
            return;
          case S_EOL:
            push_unchecked(lastx - a0_);
            need(4);
            clr(4);
            eolcnt_ = 1;
            cleanup_runs();
            return;
          default:
            cleanup_runs();
            return;
        }
      }
      if (run_length_) {
        if (run_length_ + a0_ < lastx) {  // expect a final V0
          need(1);
          if (!bits(1)) {
            cleanup_runs();
            return;
          }
          clr(1);
        }
        setvalue(0);
      }
    } catch (const Eof&) {
      cleanup_runs();
      throw;
    }
    cleanup_runs();
  }

  // _TIFFFax3fillruns: white runs clear bits, black runs set them; a run
  // past the row is cut at its end. An odd count gets a closing 0 run in
  // the array but not in pa_ (libtiff's fill takes its end by value), so
  // the imaginary change written next lands on it: entries past the row's
  // end keep what earlier rows left there, which a 2-D row can read.
  void fillruns(uint8_t* buf) {
    int end = pa_;
    if (end & 1) {
      if (end >= nruns_ + 2) throw Overflow();
      cur_[end++] = 0;
    }
    const uint32_t lastx = static_cast<uint32_t>(width_);
    uint32_t x = 0;
    for (int i = 0; i < end; i += 2) {
      for (int k = 0; k < 2; ++k) {
        uint32_t r = cur_[i + k];
        if (x + r > lastx || r > lastx) r = cur_[i + k] = lastx - x;
        for (uint32_t p = x; p < x + r; ++p) {
          if (k)
            buf[p >> 3] |= static_cast<uint8_t>(0x80 >> (p & 7));
          else
            buf[p >> 3] &= static_cast<uint8_t>(~(0x80 >> (p & 7)));
        }
        x += r;
      }
    }
  }
};

}  // namespace

extern "C" {

// PackBits (32773): fills dst[0:occ]. 0 on success, -1 when the data ends
// before the strip is full (the rest is zeroed, as libtiff leaves it).
int f101tiff_packbits(const uint8_t* src, long n, uint8_t* dst, long occ) {
  long cc = n;
  const uint8_t* bp = src;
  while (cc > 0 && occ > 0) {
    long r = static_cast<int8_t>(*bp++);
    cc--;
    if (r < 0) {
      if (r == -128) continue;
      r = -r + 1;
      if (occ < r) r = occ;
      if (cc == 0) break;
      occ -= r;
      const uint8_t b = *bp++;
      cc--;
      std::memset(dst, b, static_cast<size_t>(r));
      dst += r;
    } else {
      if (occ < r + 1) r = occ - 1;
      if (cc < r + 1) break;
      ++r;
      std::memcpy(dst, bp, static_cast<size_t>(r));
      dst += r;
      occ -= r;
      bp += r;
      cc -= r;
    }
  }
  if (occ > 0) {
    std::memset(dst, 0, static_cast<size_t>(occ));
    return -1;
  }
  return 0;
}

// LZW (5): fills dst[0:occ]. 0 on success; for a broken stream or one that
// ends before the strip is full, -1 less the bytes written before it.
// compat: the old-style codes libtiff detects by their first bytes
// (LZWDecodeCompat: least significant bit first, no early change).
int f101tiff_lzw(const uint8_t* src, long n, uint8_t* dst, long occ,
                 int compat) {
  constexpr int kClear = 256, kEOI = 257, kFirst = 258, kBitsMax = 12;
  constexpr int kCSize = ((1 << kBitsMax) - 1) + 1024;
  struct Ent {
    int next;  // index of the prefix entry, -1 for none
    int length;
    uint8_t value, firstchar;
  };
  std::vector<Ent> tab(kCSize);
  for (int i = 0; i < 256; ++i) tab[i] = {-1, 1, static_cast<uint8_t>(i),
                                          static_cast<uint8_t>(i)};
  for (int i = 256; i < kCSize; ++i) tab[i] = {-1, 0, 0, 0};
  const int early = compat ? 0 : 1;
  int free_ent = kFirst, nbits = 9, maxcode = (1 << 9) - 1 - early;
  int oldcode = 0;
  uint64_t acc = 0;
  int avail = 0;
  long pos = 0;
  auto next_code = [&](int nb) -> int {
    while (avail < nb) {
      if (pos >= n) return kEOI;  // "not terminated with EOI code"
      if (compat)
        acc |= static_cast<uint64_t>(src[pos++]) << avail;
      else
        acc = (acc << 8) | src[pos++];
      avail += 8;
    }
    avail -= nb;
    if (!compat) return static_cast<int>((acc >> avail) & ((1u << nb) - 1));
    const int code = static_cast<int>(acc & ((1u << nb) - 1));
    acc >>= nb;
    return code;
  };
  uint8_t* op = dst;
  while (occ > 0) {
    int code = next_code(nbits);
    if (code == kEOI) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int i = kFirst; i < kCSize; ++i) tab[i] = {-1, 0, 0, 0};
        nbits = 9;
        maxcode = (1 << 9) - 1 - early;
        code = next_code(nbits);
      } while (code == kClear);
      if (code == kEOI) break;
      if (code > kClear)  // "Corrupted LZW table"
        return -1 - static_cast<int>(op - dst);
      *op++ = static_cast<uint8_t>(code);
      occ--;
      oldcode = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kCSize)
      return -1 - static_cast<int>(op - dst);
    Ent& fe = tab[free_ent];
    fe.next = oldcode;
    fe.firstchar = tab[oldcode].firstchar;
    fe.length = tab[oldcode].length + 1;
    fe.value = code < free_ent ? tab[code].firstchar : fe.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      maxcode = (1 << nbits) - 1 - early;
      if (free_ent >= kCSize) free_ent = -1;
    }
    oldcode = code;
    const Ent& ce = tab[code];
    if (ce.length == 0)  // "Wrong length of decoded string"
      return -1 - static_cast<int>(op - dst);
    long len = ce.length;
    // the string is written back to front; what does not fit is dropped
    int c = code;
    long skip = len > occ ? len - occ : 0;
    long put = len - skip;
    for (long i = len - 1; i >= 0; --i) {
      if (i < put) op[i] = tab[c].value;
      c = tab[c].next;
    }
    op += put;
    occ -= put;
  }
  return occ > 0 ? -1 - static_cast<int>(op - dst) : 0;
}

// CCITT (2, 3, 4, 32771): rows x width bilevel pixels, 1 = black, MSB
// first, rows of rowbytes. kind is the compression, twod T4Options' 2-D
// bit, msb_first FillOrder 1, odd whether src lies at an odd address in
// libtiff's view (32771's word alignment); *noeol is libtiff's "without
// EOL" mode of the
// image (Fax::g3), read and updated, and runs its run arrays
// (f101tiff_fax_runs entries). 0 on success, -1 when the data ends
// where libtiff fails the strip, -2 when the runs overflow libtiff's run
// arrays (it fails the strip), else the rows decoded when the data ended
// early and libtiff succeeds (the rows after those keep what dst held).
int f101tiff_fax(const uint8_t* src, long n, int kind, int twod,
                 int msb_first, int odd, int width, int rows, uint8_t* dst,
                 int* noeol, uint32_t* runs) {
  if (width <= 0 || rows <= 0) return -1;
  const int rowbytes = (width + 7) / 8;
  Fax fax(src, n, msb_first != 0, width, *noeol != 0,
          kind == 4 || (kind == 3 && twod), runs);
  int got;
  try {
    got = kind == 2 || kind == 32771
              ? fax.rle(dst, rows, rowbytes, kind == 32771, odd != 0)
          : kind == 3 ? fax.g3(dst, rows, rowbytes, twod != 0)
                      : fax.g4(dst, rows, rowbytes);
  } catch (const Overflow&) {
    got = -2;
  }
  *noeol = fax.noeol();
  return got == rows ? 0 : got;
}

// ThunderScan (32809, tif_thunder.c ThunderDecodeRow): rows of width
// 4-bit pixels, (width + 1) / 2 bytes each, from one strip's codes (the
// data runs on from row to row): a run of the last pixel, three 2-bit
// or two 3-bit deltas (the "no delta" values skipped), a raw pixel.
// 0 on success, -1 where a row gets too few or too many pixels (libtiff
// fails the strip; the rest of that row is zeroed).
int f101tiff_thunder(const uint8_t* src, long n, uint8_t* dst, int width,
                     int rows) {
  static const int kTwo[4] = {0, 1, 0, -1};
  static const int kThree[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  const long maxpixels = width, rowbytes = (maxpixels + 1) / 2;
  const uint8_t* bp = src;
  long cc = n;
  for (int r = 0; r < rows; ++r) {
    uint8_t* const op0 = dst + r * rowbytes;
    uint8_t* op = op0;
    unsigned lastpixel = 0;
    long npixels = 0;
    auto set = [&](unsigned v) {  // SETPIXEL
      lastpixel = v & 0xf;
      if (npixels < maxpixels) {
        if (npixels++ & 1)
          *op++ |= static_cast<uint8_t>(lastpixel);
        else
          op[0] = static_cast<uint8_t>(lastpixel << 4);
      }
    };
    while (cc > 0 && npixels < maxpixels) {
      int c = *bp++;
      cc--;
      int delta;
      switch (c & 0xc0) {
        case 0x00:  // a run of the last pixel, c times
          if (npixels & 1) {
            op[0] |= static_cast<uint8_t>(lastpixel);
            lastpixel = *op++;
            npixels++;
            c--;
          } else {
            lastpixel |= lastpixel << 4;
          }
          npixels += c;
          if (npixels <= maxpixels)  // a run may end the row
            for (; c > 0; c -= 2) *op++ = static_cast<uint8_t>(lastpixel);
          if (c == -1) *--op &= 0xf0;
          lastpixel &= 0xf;
          break;
        case 0x40:  // three 2-bit deltas
          if ((delta = (c >> 4) & 3) != 2) set(lastpixel + kTwo[delta]);
          if ((delta = (c >> 2) & 3) != 2) set(lastpixel + kTwo[delta]);
          if ((delta = c & 3) != 2) set(lastpixel + kTwo[delta]);
          break;
        case 0x80:  // two 3-bit deltas
          if ((delta = (c >> 3) & 7) != 4) set(lastpixel + kThree[delta]);
          if ((delta = c & 7) != 4) set(lastpixel + kThree[delta]);
          break;
        default:  // a raw pixel
          set(static_cast<unsigned>(c));
          break;
      }
    }
    if (npixels != maxpixels) {
      uint8_t* const op_end = op0 + rowbytes;
      if (op < op_end) std::memset(op, 0, static_cast<size_t>(op_end - op));
      return -1;
    }
  }
  return 0;
}

// The entries of the run arrays f101tiff_fax takes for a row of width
// pixels (zeroed, kept for every strip and tile of the image).
long f101tiff_fax_runs(int width, int refline) {
  return Fax::fax_runs(width, refline != 0) + 4;
}

// QOI: w x h pixels of `bands` (3 or 4) bytes into dst. Returns the bytes
// of src consumed, or -1 when the data ends before the image is full.
long f101qoi_decode(const uint8_t* src, long n, int w, int h, int bands,
                    uint8_t* dst) {
  uint8_t seen[64][4];
  bool have[64] = {};
  uint8_t prev[4] = {0, 0, 0, 255};
  const long total = static_cast<long>(w) * h;
  long px = 0, pos = 0;
  auto put = [&](const uint8_t* v) {
    if (px < total) std::memcpy(dst + px * bands, v, static_cast<size_t>(bands));
    ++px;
  };
  auto remember = [&](const uint8_t* v) {
    std::memcpy(prev, v, 4);
    const int hsh = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    std::memcpy(seen[hsh], v, 4);
    have[hsh] = true;
  };
  while (px < total) {
    if (pos >= n) return -1;
    const uint8_t b = src[pos++];
    uint8_t v[4];
    if (b == 0xFE) {  // QOI_OP_RGB
      if (n - pos < 3) return -1;
      v[0] = src[pos];
      v[1] = src[pos + 1];
      v[2] = src[pos + 2];
      v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {  // QOI_OP_RGBA
      if (n - pos < 4) return -1;
      std::memcpy(v, src + pos, 4);
      pos += 4;
    } else {
      const int op = b >> 6;
      if (op == 0) {  // QOI_OP_INDEX
        const int i = b & 63;
        if (have[i])
          std::memcpy(v, seen[i], 4);
        else
          std::memset(v, 0, 4);
      } else if (op == 1) {  // QOI_OP_DIFF
        v[0] = static_cast<uint8_t>(prev[0] + ((b >> 4) & 3) - 2);
        v[1] = static_cast<uint8_t>(prev[1] + ((b >> 2) & 3) - 2);
        v[2] = static_cast<uint8_t>(prev[2] + (b & 3) - 2);
        v[3] = prev[3];
      } else if (op == 2) {  // QOI_OP_LUMA
        if (pos >= n) return -1;
        const uint8_t b2 = src[pos++];
        const int dg = (b & 63) - 32;
        v[0] = static_cast<uint8_t>(prev[0] + dg + ((b2 >> 4) & 15) - 8);
        v[1] = static_cast<uint8_t>(prev[1] + dg);
        v[2] = static_cast<uint8_t>(prev[2] + dg + (b2 & 15) - 8);
        v[3] = prev[3];
      } else {  // QOI_OP_RUN: the index is not updated
        for (int r = (b & 63) + 1; r > 0; --r) put(prev);
        continue;
      }
    }
    remember(v);
    put(v);
  }
  return pos;
}

}  // extern "C"
