// TIFF and GIF codecs for io/image.py and io/tiff.py, bound with ctypes:
// what libtiff 4.7 (inside PIL) and PIL's GifDecode.c do with a strip,
// a tile or an image block, so that the port reads the pixels of
// np.asarray(Image.open(path)).
//   - LZW: TIFF's MSB-first codes widened one code early (tif_lzw.c
//     LZWDecode), TIFF's old LSB-first "compat" codes (LZWDecodeCompat),
//     and GIF's LSB-first codes from any minimum code size;
//   - PackBits (tif_packbits.c);
//   - the bit reversal of fill order 2 (TIFFReverseBits);
//   - the byte swap of 16-, 32- and 64-bit samples to the host's order
//     (tif_postdecode), the horizontal predictor 2 at 8, 16, 32 and 64
//     bits and the floating-point predictor 3 (tif_predict.c horAcc*,
//     fpAcc: byte planes, then differencing), which return host order;
//   - CCITT modified Huffman (compression 2, rows byte-aligned), Group 3
//     (3: T4Options bit 0 for 2-D rows, EOLs found as tif_fax3.c's
//     SYNC_EOL finds them, so bit 2's fill bits need nothing more) and
//     Group 4 (4), each strip or tile started on an all-white reference
//     row, rows written as bits with 1 for black runs (tif_fax3.c), and
//     modified Huffman in 16-bit words (32771, tiff_raw_16: libtiff's
//     CCITTRLEW, whose word alignment follows its bit accumulator);
//   - ThunderScan's 4-bit codes (tif_thunder.c);
//     the uncompressed mode's extension codes and bad codes raise, where
//     libtiff reports them and fills the row;
//   - YCbCr to RGB as TIFFRGBAImageGet gives it: TIFFYCbCrToRGBInit's
//     integer tables from YCbCrCoefficients and ReferenceBlackWhite,
//     and the putcontig8bitYCbCr{11,12,21,22,41,42,44}tile layouts of
//     tif_getimage.c, each pixel taking its sampling block's Cb and Cr
//     (YCbCrPositioning is not used), including the 4x4 block skip of a
//     clipped tile that libtiff takes as 10 bytes a block.
// Every function returns 0, or -1 with a message in err.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

void set_error(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg.c_str());
}

// ---------------------------------------------------------------------------
// LZW

// kind 0: TIFF (MSB first, early change), 1: TIFF compat (LSB first),
// 2: GIF (LSB first).  Stops at the end code, a clear code's absence of
// room, a code past the table, the end of the data or `cap` bytes.
int64_t lzw(const uint8_t *in, int64_t n, int kind, int min_bits,
            uint8_t *out, int64_t cap) {
  const bool msb = kind == 0;
  const int early = kind == 0 ? 1 : 0;
  const int clear = 1 << min_bits, eoi = clear + 1;
  // each entry: its prefix code, its last byte, its first byte, length
  std::vector<int32_t> prefix(4096), length(4096);
  std::vector<uint8_t> last(4096), first(4096);
  for (int i = 0; i < clear; i++) {
    prefix[i] = -1;
    last[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int size = clear + 2, width = min_bits + 1, prev = -1;
  int64_t written = 0, pos = 0;
  const int64_t total = 8 * n;
  std::vector<uint8_t> stack(4097);
  while (pos + width <= total && written < cap) {
    int64_t k = pos >> 3;
    uint32_t b0 = in[k], b1 = k + 1 < n ? in[k + 1] : 0,
             b2 = k + 2 < n ? in[k + 2] : 0;
    int code;
    if (msb)
      code = static_cast<int>(((b0 << 16 | b1 << 8 | b2) >>
                               (24 - (pos & 7) - width)) &
                              ((1u << width) - 1));
    else
      code = static_cast<int>(((b0 | b1 << 8 | b2 << 16) >> (pos & 7)) &
                              ((1u << width) - 1));
    pos += width;
    if (code == clear) {
      size = clear + 2;
      width = min_bits + 1;
      prev = -1;
      continue;
    }
    if (code == eoi) break;
    int entry;
    if (prev < 0) {
      if (code >= clear) break;
      entry = code;
    } else if (code < size) {
      entry = code;
      if (size < 4096) {
        prefix[size] = prev;
        last[size] = first[code];
        first[size] = first[prev];
        length[size] = length[prev] + 1;
        size++;
      }
    } else if (code == size && size < 4096) {
      prefix[size] = prev;
      last[size] = first[prev];
      first[size] = first[prev];
      length[size] = length[prev] + 1;
      entry = size++;
    } else {
      break;
    }
    int len = length[entry];
    int sp = len;
    for (int c = entry; c >= 0; c = prefix[c]) stack[--sp] = last[c];
    int64_t take = len < cap - written ? len : cap - written;
    memcpy(out + written, stack.data(), static_cast<size_t>(take));
    written += take;
    prev = entry;
    if (size + early >= (1 << width) && width < 12) width++;
  }
  return written;
}

// ---------------------------------------------------------------------------
// PackBits

int64_t packbits(const uint8_t *in, int64_t n, uint8_t *out, int64_t cap) {
  int64_t i = 0, w = 0;
  while (i < n && w < cap) {
    int c = static_cast<int8_t>(in[i++]);
    if (c >= 0) {
      int64_t run = c + 1;
      if (run > n - i) run = n - i;
      if (run > cap - w) run = cap - w;
      memcpy(out + w, in + i, static_cast<size_t>(run));
      w += run;
      i += c + 1;
    } else if (c != -128 && i < n) {
      int64_t run = 1 - c;
      if (run > cap - w) run = cap - w;
      memset(out + w, in[i++], static_cast<size_t>(run));
      w += run;
    }
  }
  return w;
}

// ---------------------------------------------------------------------------
// byte order and predictors (tif_predict.c)

void swab(uint8_t *p, int64_t count, int bytes) {
  for (int64_t i = 0; i < count; i++, p += bytes)
    for (int a = 0, b = bytes - 1; a < b; a++, b--) {
      uint8_t t = p[a];
      p[a] = p[b];
      p[b] = t;
    }
}

template <typename T>
void hor_acc(uint8_t *row, int64_t count, int stride) {
  // libtiff's horAcc8/16/32/64: wrapping unsigned sums, stride samples
  for (int64_t i = stride; i < count; i++) {
    T a, b;
    memcpy(&a, row + (i - stride) * sizeof(T), sizeof(T));
    memcpy(&b, row + i * sizeof(T), sizeof(T));
    b = static_cast<T>(b + a);
    memcpy(row + i * sizeof(T), &b, sizeof(T));
  }
}

void fp_acc(uint8_t *row, int64_t cc, int bps, int stride,
            std::vector<uint8_t> &tmp) {
  for (int64_t i = stride; i < cc; i++)
    row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
  tmp.assign(row, row + cc);
  int64_t wc = cc / bps;
  for (int64_t count = 0; count < wc; count++)
    for (int byte = 0; byte < bps; byte++)
      row[bps * count + byte] = tmp[(bps - byte - 1) * wc + count];
}

// ---------------------------------------------------------------------------
// CCITT (T.4 / T.6)

struct Code {
  int len;
  const char *bits;
  int run;
};

// modified Huffman run codes: terminating (0-63) and make-up codes
const Code kWhite[] = {
    {8, "00110101", 0},     {6, "000111", 1},       {4, "0111", 2},
    {4, "1000", 3},         {4, "1011", 4},         {4, "1100", 5},
    {4, "1110", 6},         {4, "1111", 7},         {5, "10011", 8},
    {5, "10100", 9},        {5, "00111", 10},       {5, "01000", 11},
    {6, "001000", 12},      {6, "000011", 13},      {6, "110100", 14},
    {6, "110101", 15},      {6, "101010", 16},      {6, "101011", 17},
    {7, "0100111", 18},     {7, "0001100", 19},     {7, "0001000", 20},
    {7, "0010111", 21},     {7, "0000011", 22},     {7, "0000100", 23},
    {7, "0101000", 24},     {7, "0101011", 25},     {7, "0010011", 26},
    {7, "0100100", 27},     {7, "0011000", 28},     {8, "00000010", 29},
    {8, "00000011", 30},    {8, "00011010", 31},    {8, "00011011", 32},
    {8, "00010010", 33},    {8, "00010011", 34},    {8, "00010100", 35},
    {8, "00010101", 36},    {8, "00010110", 37},    {8, "00010111", 38},
    {8, "00101000", 39},    {8, "00101001", 40},    {8, "00101010", 41},
    {8, "00101011", 42},    {8, "00101100", 43},    {8, "00101101", 44},
    {8, "00000100", 45},    {8, "00000101", 46},    {8, "00001010", 47},
    {8, "00001011", 48},    {8, "01010010", 49},    {8, "01010011", 50},
    {8, "01010100", 51},    {8, "01010101", 52},    {8, "00100100", 53},
    {8, "00100101", 54},    {8, "01011000", 55},    {8, "01011001", 56},
    {8, "01011010", 57},    {8, "01011011", 58},    {8, "01001010", 59},
    {8, "01001011", 60},    {8, "00110010", 61},    {8, "00110011", 62},
    {8, "00110100", 63},    {5, "11011", 64},       {5, "10010", 128},
    {6, "010111", 192},     {7, "0110111", 256},    {8, "00110110", 320},
    {8, "00110111", 384},   {8, "01100100", 448},   {8, "01100101", 512},
    {8, "01101000", 576},   {8, "01100111", 640},   {9, "011001100", 704},
    {9, "011001101", 768},  {9, "011010010", 832},  {9, "011010011", 896},
    {9, "011010100", 960},  {9, "011010101", 1024}, {9, "011010110", 1088},
    {9, "011010111", 1152}, {9, "011011000", 1216}, {9, "011011001", 1280},
    {9, "011011010", 1344}, {9, "011011011", 1408}, {9, "010011000", 1472},
    {9, "010011001", 1536}, {9, "010011010", 1600}, {6, "011000", 1664},
    {9, "010011011", 1728}};

const Code kBlack[] = {
    {10, "0000110111", 0},     {3, "010", 1},
    {2, "11", 2},              {2, "10", 3},
    {3, "011", 4},             {4, "0011", 5},
    {4, "0010", 6},            {5, "00011", 7},
    {6, "000101", 8},          {6, "000100", 9},
    {7, "0000100", 10},        {7, "0000101", 11},
    {7, "0000111", 12},        {8, "00000100", 13},
    {8, "00000111", 14},       {9, "000011000", 15},
    {10, "0000010111", 16},    {10, "0000011000", 17},
    {10, "0000001000", 18},    {11, "00001100111", 19},
    {11, "00001101000", 20},   {11, "00001101100", 21},
    {11, "00000110111", 22},   {11, "00000101000", 23},
    {11, "00000010111", 24},   {11, "00000011000", 25},
    {12, "000011001010", 26},  {12, "000011001011", 27},
    {12, "000011001100", 28},  {12, "000011001101", 29},
    {12, "000001101000", 30},  {12, "000001101001", 31},
    {12, "000001101010", 32},  {12, "000001101011", 33},
    {12, "000011010010", 34},  {12, "000011010011", 35},
    {12, "000011010100", 36},  {12, "000011010101", 37},
    {12, "000011010110", 38},  {12, "000011010111", 39},
    {12, "000001101100", 40},  {12, "000001101101", 41},
    {12, "000011011010", 42},  {12, "000011011011", 43},
    {12, "000001010100", 44},  {12, "000001010101", 45},
    {12, "000001010110", 46},  {12, "000001010111", 47},
    {12, "000001100100", 48},  {12, "000001100101", 49},
    {12, "000001010010", 50},  {12, "000001010011", 51},
    {12, "000000100100", 52},  {12, "000000110111", 53},
    {12, "000000111000", 54},  {12, "000000100111", 55},
    {12, "000000101000", 56},  {12, "000001011000", 57},
    {12, "000001011001", 58},  {12, "000000101011", 59},
    {12, "000000101100", 60},  {12, "000001011010", 61},
    {12, "000001100110", 62},  {12, "000001100111", 63},
    {10, "0000001111", 64},    {12, "000011001000", 128},
    {12, "000011001001", 192}, {12, "000001011011", 256},
    {12, "000000110011", 320}, {12, "000000110100", 384},
    {12, "000000110101", 448}, {13, "0000001101100", 512},
    {13, "0000001101101", 576}, {13, "0000001001010", 640},
    {13, "0000001001011", 704}, {13, "0000001001100", 768},
    {13, "0000001001101", 832}, {13, "0000001110010", 896},
    {13, "0000001110011", 960}, {13, "0000001110100", 1024},
    {13, "0000001110101", 1088}, {13, "0000001110110", 1152},
    {13, "0000001110111", 1216}, {13, "0000001010010", 1280},
    {13, "0000001010011", 1344}, {13, "0000001010100", 1408},
    {13, "0000001010101", 1472}, {13, "0000001011010", 1536},
    {13, "0000001011011", 1600}, {13, "0000001100100", 1664},
    {13, "0000001100101", 1728}};

// make-up codes that both colours share
const Code kExtended[] = {
    {11, "00000001000", 1792},  {11, "00000001100", 1856},
    {11, "00000001101", 1920},  {12, "000000010010", 1984},
    {12, "000000010011", 2048}, {12, "000000010100", 2112},
    {12, "000000010101", 2176}, {12, "000000010110", 2240},
    {12, "000000010111", 2304}, {12, "000000011100", 2368},
    {12, "000000011101", 2432}, {12, "000000011110", 2496},
    {12, "000000011111", 2560}};

const int kEOL = -2, kMaxCode = 13;
// the extension codes into T.4's uncompressed mode: libtiff reports them
// and fills the rest of the row
const char *const kUncompressed =
    "TIFF CCITT uncompressed mode: PIL misreads it (libtiff does not "
    "decode it)";
const char *const kEolInRow =
    "TIFF CCITT data with an EOL inside a horizontal mode: PIL misreads "
    "it (libtiff ends the row and goes on)";

// run[len][code] for codes up to 13 bits: a run length, kEOL, or -1
struct RunTable {
  std::vector<int> run[kMaxCode + 1];
  explicit RunTable(const Code *codes, size_t n) {
    for (int l = 1; l <= kMaxCode; l++) run[l].assign(1 << l, -1);
    auto add = [&](const Code &c) {
      int v = 0;
      for (int i = 0; i < c.len; i++) v = v << 1 | (c.bits[i] == '1');
      run[c.len][v] = c.run;
    };
    for (size_t i = 0; i < n; i++) add(codes[i]);
    for (const Code &c : kExtended) add(c);
    run[12][1] = kEOL;  // 000000000001
  }
};

class BitReader {
 public:
  BitReader(const uint8_t *d, int64_t n) : d_(d), n_(n) {}
  bool at_end() const { return pos_ >= 8 * n_; }
  int64_t left() const { return 8 * n_ - pos_; }
  // the next k bits (zeros past the end)
  uint32_t peek(int k) const {
    uint32_t v = 0;
    for (int i = 0; i < k; i++) {
      int64_t p = pos_ + i;
      int bit = p < 8 * n_ ? (d_[p >> 3] >> (7 - (p & 7))) & 1 : 0;
      v = v << 1 | static_cast<uint32_t>(bit);
    }
    return v;
  }
  void skip(int k) { pos_ += k; }
  void align() { pos_ = (pos_ + 7) & ~static_cast<int64_t>(7); }

 private:
  const uint8_t *d_;
  int64_t n_, pos_ = 0;
};

class Fax {
 public:
  Fax(const uint8_t *d, int64_t n, int width)
      : br_(d, n), width_(width) {}

  // tif_fax3.c SYNC_EOL: to 11 zero bits, past zero bytes and zero bits,
  // then the EOL's 1; false at the end of the data
  // (zeros past the end of the data count, as NeedBits pads them)
  bool sync_eol() {
    while (true) {
      if (br_.left() <= 0) return false;
      if (br_.peek(11) == 0) break;
      br_.skip(1);
    }
    while (true) {
      if (br_.left() <= 0) return false;
      if (br_.peek(8)) break;
      br_.skip(8);
    }
    while (br_.peek(1) == 0) {
      if (br_.left() <= 0) return false;
      br_.skip(1);
    }
    br_.skip(1);
    return true;
  }
  int tag_bit() {
    int b = static_cast<int>(br_.peek(1));
    br_.skip(1);
    return b;
  }
  void align() { br_.align(); }
  bool at_end() const { return br_.at_end(); }
  // one row of 1-D runs into `line` (changing elements, alternating from
  // white); returns false where an EOL cut the row short
  bool row_1d(std::vector<int> &line) {
    line.clear();
    int a0 = 0, color = 0;
    while (a0 < width_) {
      int run = 0;
      while (true) {
        int r = code(color ? black_ : white_);
        if (r == kEOL) {
          finish(line, a0);
          return false;
        }
        run += r;
        if (r < 64) break;
      }
      a0 += run;
      if (a0 > width_) a0 = width_;
      line.push_back(a0);
      color ^= 1;
    }
    return true;
  }

  // one 2-D row against `ref` (pdf.js / xpdf's coding-line form)
  void row_2d(const std::vector<int> &ref_in, std::vector<int> &line) {
    // the reference row's changing elements, then the row's end as
    // often as an index past them asks (pdf.js keeps two such entries)
    const std::vector<int> &refv = ref_in;
    auto ref = [&](int i) {
      return i < static_cast<int>(refv.size()) ? refv[i] : width_;
    };
    std::vector<int> cl(width_ + 3, 0);
    int cp = 0, rp = 0, black = 0;
    auto add = [&](int a1, int blk) {
      if (a1 > cl[cp]) {
        if (a1 > width_) a1 = width_;
        if ((cp & 1) ^ blk) cp++;
        if (cp >= static_cast<int>(cl.size())) cl.resize(cp + 1, 0);
        cl[cp] = a1;
      }
    };
    auto add_neg = [&](int a1, int blk) {
      if (a1 > cl[cp]) {
        if (a1 > width_) a1 = width_;
        if ((cp & 1) ^ blk) cp++;
        if (cp >= static_cast<int>(cl.size())) cl.resize(cp + 1, 0);
        cl[cp] = a1;
      } else if (a1 < cl[cp]) {
        if (a1 < 0) a1 = 0;
        while (cp > 0 && a1 < cl[cp - 1]) cp--;
        cl[cp] = a1;
      }
    };
    auto advance = [&]() {
      while (ref(rp) <= cl[cp] && ref(rp) < width_) rp += 2;
    };
    while (cl[cp] < width_) {
      int mode = mode_code();
      if (mode == 'P') {
        add(ref(rp + 1), black);
        if (ref(rp + 1) < width_) rp += 2;
      } else if (mode == 'H') {
        int r1 = 0, r2 = 0, r;
        do {
          r = code(black ? black_ : white_);
          if (r == kEOL) throw Error{kEolInRow};
          r1 += r;
        } while (r >= 64);
        do {
          r = code(black ? white_ : black_);
          if (r == kEOL) throw Error{kEolInRow};
          r2 += r;
        } while (r >= 64);
        add(cl[cp] + r1, black);
        if (cl[cp] < width_) add(cl[cp] + r2, black ^ 1);
        advance();
      } else if (mode >= 0 && mode <= 6) {  // V: 3 + offset
        int d = mode - 3;
        if (d >= 0)
          add(ref(rp) + d, black);
        else
          add_neg(ref(rp) + d, black);
        black ^= 1;
        if (cl[cp] < width_) {
          if (d >= 0)
            rp++;
          else if (rp > 0)
            rp--;
          else
            rp++;
          advance();
        }
      } else {  // 'X', an extension code
        throw Error{kUncompressed};
      }
    }
    line.clear();
    for (int i = 0; i <= cp; i++) line.push_back(cl[i]);
  }

 private:
  BitReader br_;
  int width_;
  RunTable white_{kWhite, sizeof(kWhite) / sizeof(Code)};
  RunTable black_{kBlack, sizeof(kBlack) / sizeof(Code)};

  void finish(std::vector<int> &line, int a0) {
    if (line.empty() || line.back() != a0) line.push_back(a0);
  }
  int code(const RunTable &t) {
    if (br_.at_end()) throw Error{"CCITT: the data ends inside a row"};
    for (int l = 1; l <= kMaxCode; l++) {
      int r = t.run[l][br_.peek(l)];
      if (r != -1) {
        br_.skip(l);
        return r;
      }
    }
    if (br_.peek(12) == 0xF) throw Error{kUncompressed};  // 000000001111
    throw Error{"TIFF CCITT data with a bad run-length code: PIL misreads "
                "it (libtiff ends the row and goes on)"};
  }
  // 'P' pass, 'H' horizontal, 0-6 vertical (3 + offset), 'X' extension
  int mode_code() {
    if (br_.at_end()) throw Error{"CCITT: the data ends inside a row"};
    uint32_t v = br_.peek(7);
    if (v >> 6 == 1) return br_.skip(1), 3;
    if (v >> 4 == 3) return br_.skip(3), 4;
    if (v >> 4 == 2) return br_.skip(3), 2;
    if (v >> 4 == 1) return br_.skip(3), 'H';
    if (v >> 3 == 1) return br_.skip(4), 'P';
    if (v >> 1 == 3) return br_.skip(6), 5;
    if (v >> 1 == 2) return br_.skip(6), 1;
    if (v == 3) return br_.skip(7), 6;
    if (v == 2) return br_.skip(7), 0;
    if (v == 1) return 'X';
    throw Error{"TIFF CCITT data with a bad 2-D mode code: PIL misreads it "
                "(libtiff ends the row and goes on)"};
  }
};

// tiff_raw_16 (libtiff's CCITTRLEW): Fax3DecodeRLE under FAXMODE_WORDALIGN,
// step by step as libtiff takes it, since its reading is not the writer's
// rows: a 32-bit accumulator that fetches bytes as a 12-bit (white) or
// 13-bit (black) lookup needs them, zeros past the data's end (the end of
// data where the accumulator is empty); EXPAND1D's runs, where eleven
// zeros (libtiff's EOL entry, eleven bits taken) or a code that is none
// (libtiff's "unexpected", no bit taken) ends the row; CLEANUP_RUNS,
// which drops the runs past the row's end and fills it white; then the
// bits past a 16-bit multiple dropped and, where none is left, a byte
// skipped if the next one's address is odd (`parity`: the strip's file
// offset, as libtiff reads a mapped file in place).  A row's last code
// that ends in the 13 bits before a word boundary has the next row's
// first byte fetched and dropped with it.
class Rlew {
 public:
  Rlew(const uint8_t *d, int64_t n, int width, int parity)
      : d_(d), n_(n), width_(width), parity_(parity) {}

  void row(uint8_t *out, int64_t row_bytes, int y) {
    std::vector<int64_t> runs;
    int64_t a0 = 0, run_length = 0;
    auto set = [&](int64_t x) {
      runs.push_back(run_length + x);
      a0 += x;
      run_length = 0;
    };
    bool eof = false;
    for (bool done = false; !done;) {
      for (int colour = 0; colour < 2 && !done; colour++) {
        for (;;) {
          int const r = lookup(colour ? black_ : white_, colour ? 13 : 12,
                               &eof);
          if (eof || r == kEOL || r == kNone) {
            done = true;
            break;
          }
          if (r < 64) {
            set(r);
            break;
          }
          a0 += r;
          run_length += r;
        }
        if (!done && a0 >= width_) done = true;
      }
      if (!done && runs.size() >= 2 && runs[runs.size() - 1] == 0 &&
          runs[runs.size() - 2] == 0)
        runs.resize(runs.size() - 2);
    }
    // CLEANUP_RUNS
    if (run_length) set(0);
    if (a0 != width_) {
      while (a0 > width_ && !runs.empty()) {
        a0 -= runs.back();
        runs.pop_back();
      }
      if (a0 < width_) {
        if (a0 < 0) a0 = 0;
        if (runs.size() & 1) set(0);
        set(width_ - a0);
      } else if (a0 > width_) {
        set(width_);
        set(0);
      }
    }
    fill(runs, out, row_bytes);
    if (eof)
      throw Error{"TIFF tiff_raw_16 (CCITT RLEW) data ends inside row " +
                  std::to_string(y) + ": PIL refuses it (libtiff's decoder "
                  "fails)"};
    // FAXMODE_WORDALIGN
    take(avail_ % 16);
    if (avail_ == 0 && ((cp_ + parity_) & 1)) cp_++;
  }

 private:
  static const int kNone = -3;
  const uint8_t *d_;
  int64_t n_, cp_ = 0;
  int width_, parity_, avail_ = 0;
  uint64_t acc_ = 0;  // the next `avail_` bits, the first one highest
  RunTable white_{kWhite, sizeof(kWhite) / sizeof(Code)};
  RunTable black_{kBlack, sizeof(kBlack) / sizeof(Code)};

  // NeedBits16 then the table's entry: a run, kEOL or kNone (width 0)
  int lookup(const RunTable &t, int need, bool *eof) {
    for (int i = 0; i < 2 && avail_ < need; i++) {
      if (cp_ >= n_) {
        if (avail_ == 0) {
          *eof = true;
          return kNone;
        }
        acc_ <<= need - avail_;
        avail_ = need;
      } else {
        acc_ = acc_ << 8 | d_[cp_++];
        avail_ += 8;
      }
    }
    // eleven zeros are libtiff's EOL entry (mkg3states' EOLH), whatever
    // follows, and take eleven bits
    if (((acc_ >> (avail_ - 11)) & 0x7FF) == 0) {
      take(11);
      return kEOL;
    }
    for (int l = 1; l <= need; l++) {
      int const r = t.run[l][(acc_ >> (avail_ - l)) & ((1u << l) - 1)];
      if (r >= 0) {
        take(l);
        return r;
      }
    }
    return kNone;
  }
  void take(int l) {
    avail_ -= l;
    acc_ &= avail_ ? (uint64_t{1} << avail_) - 1 : 0;
  }

  // _TIFFFax3fillruns: white and black runs in turn, each cut at the row
  void fill(std::vector<int64_t> &runs, uint8_t *out, int64_t row_bytes) {
    if (runs.size() & 1) runs.push_back(0);
    int64_t x = 0;
    for (size_t i = 0; i < runs.size(); i++) {
      int64_t run = runs[i];
      if (x + run > width_ || run > width_) run = width_ - x;
      for (int64_t p = x; p < x + run; p++) {
        uint8_t const bit = static_cast<uint8_t>(0x80 >> (p & 7));
        if (i & 1)
          out[p >> 3] |= bit;
        else
          out[p >> 3] &= static_cast<uint8_t>(~bit);
      }
      x += run;
    }
    (void)row_bytes;
  }
};

void fill_row(const std::vector<int> &line, int width, uint8_t *out,
              int64_t row_bytes) {
  memset(out, 0, static_cast<size_t>(row_bytes));
  int x = 0;
  for (size_t i = 0; i < line.size(); i++) {
    int end = line[i] < width ? line[i] : width;
    if (i & 1)
      for (int p = x; p < end; p++) out[p >> 3] |= 0x80 >> (p & 7);
    x = end > x ? end : x;
  }
}

void ccitt(const uint8_t *in, int64_t n, int kind, int width, int rows,
           int options, uint8_t *out, int64_t row_bytes) {
  if (kind == 32771) {
    Rlew rlew(in, n, width, options & 1);
    memset(out, 0, static_cast<size_t>(rows * row_bytes));
    for (int y = 0; y < rows; y++)
      rlew.row(out + static_cast<int64_t>(y) * row_bytes, row_bytes, y);
    return;
  }
  Fax fax(in, n, width);
  std::vector<int> ref{width}, line;
  bool two_d = kind == 4 || (kind == 3 && (options & 1));
  for (int y = 0; y < rows; y++) {
    uint8_t *o = out + static_cast<int64_t>(y) * row_bytes;
    if (kind == 2) {
      fax.row_1d(line);
      fax.align();
    } else if (kind == 3) {
      if (!fax.sync_eol())
        throw Error{"CCITT Group 3: the data ends before row " +
                    std::to_string(y)};
      if (two_d && !fax.tag_bit())
        fax.row_2d(ref, line);
      else
        fax.row_1d(line);
    } else {
      fax.row_2d(ref, line);
    }
    fill_row(line, width, o, row_bytes);
    ref.clear();
    for (int v : line)
      if (v < width) ref.push_back(v);
  }
}

// ---------------------------------------------------------------------------
// ThunderScan (tif_thunder.c): 4-bit pixels, each row `width` of them from
// the codes that follow the last row's: a run of the last pixel, three
// 2-bit or two 3-bit deltas to it (a skip code leaves a slot out), or a raw
// value; codes past a full row are kept for the next

void thunder(const uint8_t *in, int64_t n, int width, int rows, uint8_t *out,
             int64_t row_bytes) {
  static const int two[4] = {0, 1, 0, -1};
  static const int three[8] = {0, 1, 2, 3, 0, -3, -2, -1};
  int64_t pos = 0;
  for (int y = 0; y < rows; y++) {
    uint8_t *const row = out + static_cast<int64_t>(y) * row_bytes;
    uint8_t *op = row;
    unsigned last = 0;
    int64_t np = 0;
    auto set = [&](int v) {
      last = static_cast<unsigned>(v) & 0xf;
      if (np < width) {
        if (np++ & 1)
          *op++ |= static_cast<uint8_t>(last);
        else
          op[0] = static_cast<uint8_t>(last << 4);
      }
    };
    while (pos < n && np < width) {
      int c = in[pos++];
      switch (c & 0xc0) {
        case 0x00: {  // run
          int k = c & 0x3f;
          if (np & 1) {
            op[0] |= static_cast<uint8_t>(last);
            last = *op++;
            np++;
            k--;
          } else {
            last |= last << 4;
          }
          np += k;
          if (np <= width)
            for (; k > 0; k -= 2) *op++ = static_cast<uint8_t>(last);
          if (k == -1) *--op &= 0xf0;
          last &= 0xf;
          break;
        }
        case 0x40:  // three 2-bit deltas, 2 skips
          for (int sh = 4; sh >= 0; sh -= 2)
            if (((c >> sh) & 3) != 2) set(static_cast<int>(last) + two[(c >> sh) & 3]);
          break;
        case 0x80:  // two 3-bit deltas, 4 skips
          for (int sh = 3; sh >= 0; sh -= 3)
            if (((c >> sh) & 7) != 4)
              set(static_cast<int>(last) + three[(c >> sh) & 7]);
          break;
        default:  // raw
          set(c);
      }
    }
    if (np != width)
      throw Error{std::string("TIFF ThunderScan data: ") +
                  (np < width ? "not enough" : "too much") + " data in row " +
                  std::to_string(y) + ": PIL refuses it (libtiff's decoder "
                  "fails)"};
  }
}

// ---------------------------------------------------------------------------
// YCbCr -> RGB (tif_color.c, tif_getimage.c)

struct YCbCrTables {
  int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y[256];
};

const int kShift = 16;
const int32_t kOneHalf = 1 << (kShift - 1);

int32_t fix(float x) {
  return static_cast<int32_t>(static_cast<double>(x * static_cast<float>(
                                  1L << kShift)) + 0.5);
}

float clampf(float f, float lo, float hi) {
  return !(f >= lo) ? lo : f > hi ? hi : f;
}

float code2v(int c, float rb, float rw, int cr) {
  float d = rw - rb != 0 ? rw - rb : 1.0f;
  return (static_cast<float>(c - static_cast<int32_t>(rb)) *
          static_cast<float>(cr)) /
         d;
}

float clampw(float f, float lo, float hi) {
  return f < lo ? lo : f > hi ? hi : f;
}

void ycbcr_tables(const float *luma, const float *rbw, YCbCrTables &t) {
  float f1 = 2 - 2 * luma[0];
  int32_t d1 = fix(clampf(f1, 0.0f, 2.0f));
  float f2 = luma[0] * f1 / luma[1];
  int32_t d2 = -fix(clampf(f2, 0.0f, 2.0f));
  float f3 = 2 - 2 * luma[2];
  int32_t d3 = fix(clampf(f3, 0.0f, 2.0f));
  float f4 = luma[2] * f3 / luma[1];
  int32_t d4 = -fix(clampf(f4, 0.0f, 2.0f));
  for (int i = 0, x = -128; i < 256; i++, x++) {
    int32_t cr = static_cast<int32_t>(
        clampw(code2v(x, rbw[4] - 128.0f, rbw[5] - 128.0f, 127),
               -128.0f * 32, 128.0f * 32));
    int32_t cb = static_cast<int32_t>(
        clampw(code2v(x, rbw[2] - 128.0f, rbw[3] - 128.0f, 127),
               -128.0f * 32, 128.0f * 32));
    t.cr_r[i] = (d1 * cr + kOneHalf) >> kShift;
    t.cb_b[i] = (d3 * cb + kOneHalf) >> kShift;
    t.cr_g[i] = d2 * cr;
    t.cb_g[i] = d4 * cb + kOneHalf;
    t.y[i] = static_cast<int32_t>(clampw(
        code2v(x + 128, rbw[0], rbw[1], 255), -128.0f * 32, 128.0f * 32));
  }
}

inline uint8_t clamp255(int32_t v) {
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

inline void to_rgb(const YCbCrTables &t, int Y, int cb, int cr, uint8_t *o) {
  o[0] = clamp255(t.y[Y] + t.cr_r[cr]);
  o[1] = clamp255(t.y[Y] + static_cast<int32_t>((t.cb_g[cb] + t.cr_g[cr]) >>
                                                kShift));
  o[2] = clamp255(t.y[Y] + t.cb_b[cb]);
}

}  // namespace

extern "C" int mods_lzw_decode(const uint8_t *in, int64_t n, int kind,
                               int min_bits, uint8_t *out, int64_t cap,
                               int64_t *written, char *err, int errlen) {
  if (kind < 0 || kind > 2 || min_bits < 1 || min_bits > 11) {
    set_error(err, errlen, "LZW: bad code kind or minimum code size");
    return -1;
  }
  *written = lzw(in, n, kind, min_bits, out, cap);
  return 0;
}

extern "C" int mods_packbits_decode(const uint8_t *in, int64_t n,
                                    uint8_t *out, int64_t cap,
                                    int64_t *written) {
  *written = packbits(in, n, out, cap);
  return 0;
}

extern "C" void mods_reverse_bits(uint8_t *buf, int64_t n) {
  for (int64_t i = 0; i < n; i++) {
    uint8_t b = buf[i];
    b = static_cast<uint8_t>((b & 0xF0) >> 4 | (b & 0x0F) << 4);
    b = static_cast<uint8_t>((b & 0xCC) >> 2 | (b & 0x33) << 2);
    buf[i] = static_cast<uint8_t>((b & 0xAA) >> 1 | (b & 0x55) << 1);
  }
}

// rows of row_bytes decoded bytes: swap wide samples to the host's order
// (not under predictor 3, whose reordering gives host order) and undo
// predictor 2 (stride samples apart) or 3
extern "C" int mods_tiff_unpredict(uint8_t *buf, int64_t rows,
                                   int64_t row_bytes, int bits, int stride,
                                   int predictor, int swap, char *err,
                                   int errlen) {
  try {
    int bytes = bits / 8;
    bool wide = bits == 16 || bits == 32 || bits == 64;
    if (predictor == 3) {
      if (bits != 16 && bits != 24 && bits != 32 && bits != 64)
        throw Error{"TIFF predictor 3 on " + std::to_string(bits) +
                    "-bit samples is not supported"};
      if (row_bytes % (bytes * stride))
        throw Error{"TIFF predictor 3: a row is not whole samples"};
      std::vector<uint8_t> tmp;
      for (int64_t r = 0; r < rows; r++)
        fp_acc(buf + r * row_bytes, row_bytes, bytes, stride, tmp);
      return 0;
    }
    if (swap && wide) swab(buf, rows * row_bytes / bytes, bytes);
    if (predictor == 2) {
      if (bits != 8 && !wide)
        throw Error{"TIFF predictor 2 on " + std::to_string(bits) +
                    "-bit samples is not supported"};
      int64_t count = row_bytes / bytes;
      for (int64_t r = 0; r < rows; r++) {
        uint8_t *row = buf + r * row_bytes;
        switch (bits) {
          case 8: hor_acc<uint8_t>(row, count, stride); break;
          case 16: hor_acc<uint16_t>(row, count, stride); break;
          case 32: hor_acc<uint32_t>(row, count, stride); break;
          default: hor_acc<uint64_t>(row, count, stride); break;
        }
      }
    } else if (predictor != 1) {
      throw Error{"TIFF predictor " + std::to_string(predictor) +
                  " is not supported"};
    }
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  }
  return -1;
}

// rows of `width` 4-bit ThunderScan pixels, row_bytes bytes a row
extern "C" int mods_thunder_decode(const uint8_t *in, int64_t n, int width,
                                   int rows, uint8_t *out, int64_t row_bytes,
                                   char *err, int errlen) {
  try {
    if (width <= 0 || row_bytes * 2 < width)
      throw Error{"ThunderScan: bad arguments"};
    thunder(in, n, width, rows, out, row_bytes);
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  }
  return -1;
}

// kind 2 (modified Huffman), 3 (Group 3, T4Options `options`), 4 (Group
// 4) or 32771 (modified Huffman in 16-bit words, libtiff's CCITTRLEW; bit
// 0 of `options` the parity of the strip's offset in the file, which
// libtiff's word alignment reads): `rows` rows of `width` pixels,
// row_bytes bytes a row
extern "C" int mods_ccitt_decode(const uint8_t *in, int64_t n, int kind,
                                 int width, int rows, int options,
                                 uint8_t *out, int64_t row_bytes, char *err,
                                 int errlen) {
  try {
    if ((kind < 2 || kind > 4) && kind != 32771)
      throw Error{"CCITT: bad arguments"};
    if (width <= 0 || row_bytes * 8 < width)
      throw Error{"CCITT: bad arguments"};
    ccitt(in, n, kind, width, rows, options, out, row_bytes);
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, std::string("CCITT: ") + e.what());
  }
  return -1;
}

// One strip or tile of 8-bit YCbCr samples in sampling blocks of hs x vs
// luma samples and Cb, Cr, chunk_w pixels a block row, to `rows` x `cols`
// RGB pixels at out (out_stride bytes a row), as TIFFRGBAImageGet puts it
extern "C" int mods_ycbcr_to_rgb(const uint8_t *in, int64_t n, int chunk_w,
                                 int cols, int rows, int hs, int vs,
                                 const float *luma, const float *rbw,
                                 uint8_t *out, int64_t out_stride, char *err,
                                 int errlen) {
  try {
    int key = hs << 4 | vs;
    if (key != 0x11 && key != 0x12 && key != 0x21 && key != 0x22 &&
        key != 0x41 && key != 0x42 && key != 0x44)
      throw Error{"TIFF YCbCr subsampling " + std::to_string(hs) + "x" +
                  std::to_string(vs) + " is not supported (libtiff reads "
                  "1x1, 1x2, 2x1, 2x2, 4x1, 4x2 and 4x4)"};
    if (std::isnan(luma[0]) || std::isnan(luma[1]) || luma[1] == 0.0f ||
        std::isnan(luma[2]))
      throw Error{"TIFF: invalid YCbCrCoefficients"};
    for (int i = 0; i < 6; i++)
      if (std::isnan(rbw[i]))
        throw Error{"TIFF: invalid ReferenceBlackWhite"};
    YCbCrTables t;
    ycbcr_tables(luma, rbw, t);
    const int block = hs * vs + 2;
    const int used = (cols + hs - 1) / hs;  // blocks a row puts
    const int fromskew = chunk_w - cols;
    const int skip = (fromskew / hs) * (key == 0x44 ? 10 : block);
    int64_t pp = 0;
    for (int by = 0; by < rows; by += vs) {
      for (int bx = 0; bx < used; bx++, pp += block) {
        if (pp + block > n)
          throw Error{"TIFF YCbCr: a strip or tile holds too few samples"};
        int cb = in[pp + hs * vs], cr = in[pp + hs * vs + 1];
        for (int dy = 0; dy < vs && by + dy < rows; dy++)
          for (int dx = 0; dx < hs && bx * hs + dx < cols; dx++)
            to_rgb(t, in[pp + dy * hs + dx], cb, cr,
                   out + (by + dy) * out_stride + 3 * (bx * hs + dx));
      }
      pp += skip;
    }
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  }
  return -1;
}
