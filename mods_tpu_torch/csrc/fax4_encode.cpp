// CCITT T.6 (Group 4) coding of a bilevel page as libtiff 4.7.1's
// tif_fax3.c writes it for PIL's `compression="group4"` TIFF save, which
// PdfImagePlugin puts in a PDF for mode "1" (io/pdf.py), bound with
// ctypes:
//   - mods_fax4_encode: Fax4Encode over every row, each row coded by
//     Fax3Encode2DRow against the row before it (an all-white row before
//     the first): pass mode where the reference row's b2 lies left of a1,
//     vertical mode where |a1 - b1| <= 3, else horizontal mode with a run
//     of each colour (putspan: the 2560 make-up code while 2624 or more
//     pixels are left, then one make-up code of 64 x (run / 64), then the
//     terminating code).  Rows are not byte-aligned.  Fax4PostEncode then
//     writes EOFB (two 12-bit EOLs) and pads the last byte with zeros.
//     Bits go most significant first (FillOrder 1).  A pixel's 0 is white
//     to the coder; PIL hands it mode "1" pixels as set bits for 255.
//
// Build: g++ -O3 -shared -fPIC (mods_tpu_torch/detectors/mser.py::
// build_native).

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Code {
  int len;
  unsigned code;
};

// tif_fax3sm.c's TIFFFaxWhiteCodes and TIFFFaxBlackCodes: runs 0-63, then
// make-up codes for 64 x k at index 63 + k (k = 1..40; 1792 and up shared
// by both colours)
const Code kWhite[104] = {
    {8, 0x35}, {6, 0x7}, {4, 0x7}, {4, 0x8}, {4, 0xb}, {4, 0xc}, {4, 0xe},
    {4, 0xf}, {5, 0x13}, {5, 0x14}, {5, 0x7}, {5, 0x8}, {6, 0x8}, {6, 0x3},
    {6, 0x34}, {6, 0x35}, {6, 0x2a}, {6, 0x2b}, {7, 0x27}, {7, 0xc}, {7, 0x8},
    {7, 0x17}, {7, 0x3}, {7, 0x4}, {7, 0x28}, {7, 0x2b}, {7, 0x13}, {7, 0x24},
    {7, 0x18}, {8, 0x2}, {8, 0x3}, {8, 0x1a}, {8, 0x1b}, {8, 0x12}, {8, 0x13},
    {8, 0x14}, {8, 0x15}, {8, 0x16}, {8, 0x17}, {8, 0x28}, {8, 0x29},
    {8, 0x2a}, {8, 0x2b}, {8, 0x2c}, {8, 0x2d}, {8, 0x4}, {8, 0x5}, {8, 0xa},
    {8, 0xb}, {8, 0x52}, {8, 0x53}, {8, 0x54}, {8, 0x55}, {8, 0x24},
    {8, 0x25}, {8, 0x58}, {8, 0x59}, {8, 0x5a}, {8, 0x5b}, {8, 0x4a},
    {8, 0x4b}, {8, 0x32}, {8, 0x33}, {8, 0x34}, {5, 0x1b}, {5, 0x12},
    {6, 0x17}, {7, 0x37}, {8, 0x36}, {8, 0x37}, {8, 0x64}, {8, 0x65},
    {8, 0x68}, {8, 0x67}, {9, 0xcc}, {9, 0xcd}, {9, 0xd2}, {9, 0xd3},
    {9, 0xd4}, {9, 0xd5}, {9, 0xd6}, {9, 0xd7}, {9, 0xd8}, {9, 0xd9},
    {9, 0xda}, {9, 0xdb}, {9, 0x98}, {9, 0x99}, {9, 0x9a}, {6, 0x18},
    {9, 0x9b}, {11, 0x8}, {11, 0xc}, {11, 0xd}, {12, 0x12}, {12, 0x13},
    {12, 0x14}, {12, 0x15}, {12, 0x16}, {12, 0x17}, {12, 0x1c}, {12, 0x1d},
    {12, 0x1e}, {12, 0x1f}};
const Code kBlack[104] = {
    {10, 0x37}, {3, 0x2}, {2, 0x3}, {2, 0x2}, {3, 0x3}, {4, 0x3}, {4, 0x2},
    {5, 0x3}, {6, 0x5}, {6, 0x4}, {7, 0x4}, {7, 0x5}, {7, 0x7}, {8, 0x4},
    {8, 0x7}, {9, 0x18}, {10, 0x17}, {10, 0x18}, {10, 0x8}, {11, 0x67},
    {11, 0x68}, {11, 0x6c}, {11, 0x37}, {11, 0x28}, {11, 0x17}, {11, 0x18},
    {12, 0xca}, {12, 0xcb}, {12, 0xcc}, {12, 0xcd}, {12, 0x68}, {12, 0x69},
    {12, 0x6a}, {12, 0x6b}, {12, 0xd2}, {12, 0xd3}, {12, 0xd4}, {12, 0xd5},
    {12, 0xd6}, {12, 0xd7}, {12, 0x6c}, {12, 0x6d}, {12, 0xda}, {12, 0xdb},
    {12, 0x54}, {12, 0x55}, {12, 0x56}, {12, 0x57}, {12, 0x64}, {12, 0x65},
    {12, 0x52}, {12, 0x53}, {12, 0x24}, {12, 0x37}, {12, 0x38}, {12, 0x27},
    {12, 0x28}, {12, 0x58}, {12, 0x59}, {12, 0x2b}, {12, 0x2c}, {12, 0x5a},
    {12, 0x66}, {12, 0x67}, {10, 0xf}, {12, 0xc8}, {12, 0xc9}, {12, 0x5b},
    {12, 0x33}, {12, 0x34}, {12, 0x35}, {13, 0x6c}, {13, 0x6d}, {13, 0x4a},
    {13, 0x4b}, {13, 0x4c}, {13, 0x4d}, {13, 0x72}, {13, 0x73}, {13, 0x74},
    {13, 0x75}, {13, 0x76}, {13, 0x77}, {13, 0x52}, {13, 0x53}, {13, 0x54},
    {13, 0x55}, {13, 0x5a}, {13, 0x5b}, {13, 0x64}, {13, 0x65}, {11, 0x8},
    {11, 0xc}, {11, 0xd}, {12, 0x12}, {12, 0x13}, {12, 0x14}, {12, 0x15},
    {12, 0x16}, {12, 0x17}, {12, 0x1c}, {12, 0x1d}, {12, 0x1e}, {12, 0x1f}};

const Code kHoriz = {3, 0x1};                    // 001
const Code kPass = {4, 0x1};                     // 0001
const Code kVertical[7] = {{7, 0x03}, {6, 0x03}, {3, 0x03}, {1, 0x1},
                           {3, 0x2},  {6, 0x02}, {7, 0x02}};  // VL3 .. VR3
const unsigned kEol = 0x001;

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t> &out) : out_(out) {}
  void put(unsigned code, int len) {
    for (int i = len - 1; i >= 0; i--) {
      data_ = static_cast<uint8_t>(data_ << 1 | ((code >> i) & 1));
      if (++bits_ == 8) flush();
    }
  }
  void put(const Code &c) { put(c.code, c.len); }
  // Fax3FlushBits: the last byte's unused bits are zeros
  void finish() {
    if (bits_) {
      data_ = static_cast<uint8_t>(data_ << (8 - bits_));
      flush();
    }
  }

 private:
  void flush() {
    out_.push_back(data_);
    data_ = 0;
    bits_ = 0;
  }
  std::vector<uint8_t> &out_;
  uint8_t data_ = 0;
  int bits_ = 0;
};

// finddiff: the end of the run of `color` that starts at bs, at most be
inline int64_t finddiff(const uint8_t *row, int64_t bs, int64_t be,
                        int color) {
  while (bs < be && row[bs] == color) bs++;
  return bs;
}
// finddiff2: finddiff where bs is inside the row, else be
inline int64_t finddiff2(const uint8_t *row, int64_t bs, int64_t be) {
  return bs < be ? finddiff(row, bs, be, row[bs]) : be;
}

void putspan(BitWriter &bw, int64_t span, const Code *tab) {
  while (span >= 2624) {
    bw.put(tab[63 + (2560 >> 6)]);
    span -= 2560;
  }
  if (span >= 64) {
    bw.put(tab[63 + (span >> 6)]);
    span -= (span >> 6) << 6;
  }
  bw.put(tab[span]);
}

// Fax3Encode2DRow: `bp` the row, `rp` the row above, one byte a pixel (0
// white, 1 black), `bits` pixels
void encode_row(BitWriter &bw, const uint8_t *bp, const uint8_t *rp,
                int64_t bits) {
  int64_t a0 = 0;
  int64_t a1 = bp[0] != 0 ? 0 : finddiff(bp, 0, bits, 0);
  int64_t b1 = rp[0] != 0 ? 0 : finddiff(rp, 0, bits, 0);
  for (;;) {
    int64_t b2 = finddiff2(rp, b1, bits);
    if (b2 >= a1) {
      int64_t d = b1 - a1;
      if (d < -3 || d > 3) {                     // horizontal mode
        int64_t a2 = finddiff2(bp, a1, bits);
        bw.put(kHoriz);
        if (a0 + a1 == 0 || bp[a0] == 0) {
          putspan(bw, a1 - a0, kWhite);
          putspan(bw, a2 - a1, kBlack);
        } else {
          putspan(bw, a1 - a0, kBlack);
          putspan(bw, a2 - a1, kWhite);
        }
        a0 = a2;
      } else {                                   // vertical mode
        bw.put(kVertical[d + 3]);
        a0 = a1;
      }
    } else {                                     // pass mode
      bw.put(kPass);
      a0 = b2;
    }
    if (a0 >= bits) break;
    int color = bp[a0];
    a1 = finddiff(bp, a0, bits, color);
    b1 = finddiff(rp, a0, bits, !color);
    b1 = finddiff(rp, b1, bits, color);
  }
}

void set_error(char *err, int errlen, const std::string &msg) {
  if (errlen <= 0) return;
  std::strncpy(err, msg.c_str(), errlen - 1);
  err[errlen - 1] = 0;
}

}  // namespace

// `pixels`: height rows of width bytes, 0 white and 1 black.  Writes the
// coded strip to out and returns its length; where cap is too small,
// returns the length it needs and writes nothing; -1 on bad arguments.
extern "C" int64_t mods_fax4_encode(const uint8_t *pixels, int64_t width,
                                    int64_t height, uint8_t *out, int64_t cap,
                                    char *err, int errlen) {
  if (width <= 0 || height < 0) {
    set_error(err, errlen, "CCITT G4: bad image size");
    return -1;
  }
  std::vector<uint8_t> coded;
  coded.reserve(static_cast<size_t>((width + 7) / 8 * height / 4 + 16));
  BitWriter bw(coded);
  std::vector<uint8_t> white(static_cast<size_t>(width), 0);
  const uint8_t *ref = white.data();
  for (int64_t y = 0; y < height; y++) {
    const uint8_t *row = pixels + y * width;
    encode_row(bw, row, ref, width);
    ref = row;
  }
  bw.put(kEol, 12);                              // EOFB
  bw.put(kEol, 12);
  bw.finish();
  const int64_t n = static_cast<int64_t>(coded.size());
  if (n <= cap) std::memcpy(out, coded.data(), coded.size());
  return n;
}
