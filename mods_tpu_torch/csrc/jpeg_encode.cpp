// JPEG encoder for io/image.py::save_image, bound with ctypes.
//
// It writes the bytes that Image.fromarray(a).save("x.jpg") writes, i.e.
// libjpeg-turbo's compression with jpeg_set_defaults() and nothing else:
//   - SOI, a JFIF 1.01 APP0 (no units, density 1x1), one DQT a table,
//     SOF0, the DC and AC DHTs of each component as its scan needs them,
//     SOS, the entropy-coded data, EOI;
//   - quality 75: the Annex K tables scaled by 50 % as jcparam.c's
//     jpeg_add_quant_table scales them ((q * 50 + 50) / 100, clamped to
//     1..255); the standard Huffman tables (jstdhuff.c); baseline, no
//     optimisation, no restart interval;
//   - gray (L) as one component; RGB as Y, Cb, Cr sampled 2x2, 1x1, 1x1,
//     with jccolor.c's fixed-point rgb_ycc_convert (16 fraction bits)
//     and jcsample.c's h2v2_downsample (a bias of 1, 2, 1, 2, ... along
//     each output row);
//   - jcprepct.c's and jcsample.c's edge replication: rows below the
//     image repeat its last row up to the sampling height, columns to its
//     right repeat its last column up to whole blocks, and a subsampled
//     component's last row repeats up to whole blocks; jccoefct.c's dummy
//     blocks (zero AC, the DC of the block before) fill the MCUs past the
//     image's blocks;
//   - the "islow" forward DCT of jfdctint.c (CONST_BITS 13, PASS1_BITS 2,
//     rows then columns, output scaled by 8), and jcdctmgr.c's quantiser
//     as libjpeg-turbo builds it with SIMD (16-bit DCTELEM): a division
//     by 8q through compute_reciprocal's reciprocal, correction and
//     shift, on the magnitude, with the sign put back;
//   - jchuff.c's bit packing: a 0x00 after every 0xFF byte, and the last
//     byte padded with 1-bits.
//
// Interface: mods_jpeg_encode(pixels, width, height, channels, out, cap,
// err, errlen) reads (height, width[, 3]) uint8 pixels (channels 1 or 3)
// and writes the file's bytes to out; it returns their number, or -1
// with a message in err.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ITU-T T.81 Annex K.1, natural order (jcparam.c)
const int kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// ITU-T T.81 Annex K.3 (jstdhuff.c): code counts by length 1..16, values
struct HuffSpec {
  uint8_t bits[16];
  std::vector<uint8_t> vals;
};

const HuffSpec kDcLuma = {{0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0},
                          {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11}};
const HuffSpec kDcChroma = {{0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0},
                            {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11}};
const HuffSpec kAcLuma = {
    {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d},
    {0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
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
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};
const HuffSpec kAcChroma = {
    {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77},
    {0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
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
     0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa}};

// jchuff.c jpeg_make_c_derived_tbl: canonical code and length by symbol
struct HuffCodes {
  uint32_t code[256] = {};
  int size[256] = {};
  explicit HuffCodes(const HuffSpec &s) {
    uint32_t c = 0;
    size_t k = 0;
    for (int len = 1; len <= 16; len++) {
      for (int i = 0; i < s.bits[len - 1]; i++, k++) {
        code[s.vals[k]] = c++;
        size[s.vals[k]] = len;
      }
      c <<= 1;
    }
  }
};

// jcdctmgr.c compute_reciprocal, 16-bit DCTELEM: |x| / d rounded half up
// as ((|x| + corr) * recip) >> shift
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t d) {
  if (d == 1) return {1, 0, 0};
  int b = 31 - __builtin_clz(d);
  int r = 16 + b;
  uint32_t fq = (1u << r) / d, fr = (1u << r) % d, c = d / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= d / 2) {
    c++;
  } else {
    fq++;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r};
}

struct QuantTable {
  int q[64];  // natural order
  Divisor div[64];
  QuantTable(const int *base) {
    for (int i = 0; i < 64; i++) {
      long t = (static_cast<long>(base[i]) * 50 + 50) / 100;
      q[i] = static_cast<int>(t < 1 ? 1 : t > 255 ? 255 : t);
      div[i] = reciprocal(static_cast<uint32_t>(q[i]) * 8);
    }
  }
};

// jfdctint.c, jpeg_fdct_islow
const int kConstBits = 13, kPass1Bits = 2;
const long FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
           FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
           FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
           FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
           FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
           FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline long descale(long x, int n) { return (x + (1L << (n - 1))) >> n; }

void fdct_islow(int *data) {
  for (int pass = 0; pass < 2; pass++) {
    const int step = pass == 0 ? 1 : 8;   // along a row, then a column
    const int next = pass == 0 ? 8 : 1;
    const int sh = pass == 0 ? kConstBits - kPass1Bits
                             : kConstBits + kPass1Bits;
    for (int ctr = 0; ctr < 8; ctr++) {
      int *d = data + ctr * next;
      long tmp0 = d[0] + d[7 * step], tmp7 = d[0] - d[7 * step];
      long tmp1 = d[step] + d[6 * step], tmp6 = d[step] - d[6 * step];
      long tmp2 = d[2 * step] + d[5 * step];
      long tmp5 = d[2 * step] - d[5 * step];
      long tmp3 = d[3 * step] + d[4 * step];
      long tmp4 = d[3 * step] - d[4 * step];
      long tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      long tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        d[0] = static_cast<int>((tmp10 + tmp11) * (1L << kPass1Bits));
        d[4 * step] = static_cast<int>((tmp10 - tmp11) * (1L << kPass1Bits));
      } else {
        d[0] = static_cast<int>(descale(tmp10 + tmp11, kPass1Bits));
        d[4 * step] = static_cast<int>(descale(tmp10 - tmp11, kPass1Bits));
      }
      long z1 = (tmp12 + tmp13) * FIX_0_541196100;
      d[2 * step] = static_cast<int>(descale(z1 + tmp13 * FIX_0_765366865,
                                             sh));
      d[6 * step] = static_cast<int>(descale(z1 + tmp12 * -FIX_1_847759065,
                                             sh));
      z1 = tmp4 + tmp7;
      long z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      long z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 *= FIX_0_298631336;
      tmp5 *= FIX_2_053119869;
      tmp6 *= FIX_3_072711026;
      tmp7 *= FIX_1_501321110;
      z1 *= -FIX_0_899976223;
      z2 *= -FIX_2_562915447;
      z3 *= -FIX_1_961570560;
      z4 *= -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      d[7 * step] = static_cast<int>(descale(tmp4 + z1 + z3, sh));
      d[5 * step] = static_cast<int>(descale(tmp5 + z2 + z4, sh));
      d[3 * step] = static_cast<int>(descale(tmp6 + z2 + z3, sh));
      d[step] = static_cast<int>(descale(tmp7 + z1 + z4, sh));
    }
  }
}

// one component's samples, already padded to whole blocks
struct Plane {
  int w = 0, h = 0;  // padded size
  std::vector<uint8_t> px;
  uint8_t at(int y, int x) const {
    return px[static_cast<size_t>(y) * w + x];
  }
};

// ceil(n / d)
int cdiv(int n, int d) { return (n + d - 1) / d; }

// rows of src (sw x sh, row stride sw) replicated right to w and down to h
Plane pad(const uint8_t *src, int sw, int sh, int w, int h) {
  Plane p;
  p.w = w;
  p.h = h;
  p.px.resize(static_cast<size_t>(w) * h);
  for (int y = 0; y < h; y++) {
    const uint8_t *s = src + static_cast<size_t>(y < sh ? y : sh - 1) * sw;
    uint8_t *o = &p.px[static_cast<size_t>(y) * w];
    memcpy(o, s, sw);
    memset(o + sw, s[sw - 1], w - sw);
  }
  return p;
}

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t> &out) : out_(out) {}
  void put(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1));
    n_ += size;
    while (n_ >= 8) {
      uint8_t b = static_cast<uint8_t>(acc_ >> (n_ - 8));
      out_.push_back(b);
      if (b == 0xFF) out_.push_back(0);
      n_ -= 8;
    }
    acc_ &= (1ull << n_) - 1;
  }
  void flush() { put(0x7F, 7); n_ = 0; acc_ = 0; }

 private:
  std::vector<uint8_t> &out_;
  uint64_t acc_ = 0;
  int n_ = 0;
};

struct Component {
  int id, h, v, tq;
  const Plane *plane;
  const QuantTable *qt;
  const HuffCodes *dc, *ac;
  int wb, hb;  // the image's blocks (width/height_in_blocks)
  int last_dc = 0;
};

// forward DCT and quantisation of the block at (by, bx) of c's plane
void quantised_block(const Component &c, int by, int bx, int16_t *coef) {
  int ws[64];
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++)
      ws[8 * y + x] = c.plane->at(8 * by + y, 8 * bx + x) - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    const Divisor &d = c.qt->div[i];
    int t = ws[i];
    uint32_t m = static_cast<uint32_t>(t < 0 ? -t : t);
    uint32_t qv = (((m + d.corr) & 0xFFFF) * d.recip) >> d.shift;
    coef[i] = static_cast<int16_t>(t < 0 ? -static_cast<int>(qv)
                                         : static_cast<int>(qv));
  }
}

int bit_length(int v) { return v ? 32 - __builtin_clz(v) : 0; }

// jchuff.c encode_one_block
void encode_block(BitWriter &bw, Component &c, const int16_t *coef) {
  int temp = coef[0] - c.last_dc, temp2 = temp;
  c.last_dc = coef[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = bit_length(temp);
  bw.put(c.dc->code[nbits], c.dc->size[nbits]);
  if (nbits) bw.put(static_cast<uint32_t>(temp2), nbits);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    temp = coef[kNatural[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      bw.put(c.ac->code[0xF0], c.ac->size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = bit_length(temp);
    int sym = (r << 4) + nbits;
    bw.put(c.ac->code[sym], c.ac->size[sym]);
    bw.put(static_cast<uint32_t>(temp2), nbits);
    r = 0;
  }
  if (r > 0) bw.put(c.ac->code[0], c.ac->size[0]);
}

void put16(std::vector<uint8_t> &o, int v) {
  o.push_back(static_cast<uint8_t>(v >> 8));
  o.push_back(static_cast<uint8_t>(v));
}

void marker(std::vector<uint8_t> &o, int m, int len) {
  o.push_back(0xFF);
  o.push_back(static_cast<uint8_t>(m));
  put16(o, len);
}

void write_dqt(std::vector<uint8_t> &o, const QuantTable &t, int id) {
  marker(o, 0xDB, 67);
  o.push_back(static_cast<uint8_t>(id));
  for (int i = 0; i < 64; i++)
    o.push_back(static_cast<uint8_t>(t.q[kNatural[i]]));
}

void write_dht(std::vector<uint8_t> &o, const HuffSpec &s, int cls_id) {
  marker(o, 0xC4, static_cast<int>(3 + 16 + s.vals.size()));
  o.push_back(static_cast<uint8_t>(cls_id));
  o.insert(o.end(), s.bits, s.bits + 16);
  o.insert(o.end(), s.vals.begin(), s.vals.end());
}

std::vector<uint8_t> encode(const uint8_t *px, int width, int height,
                            int channels) {
  static const QuantTable luma_q(kLumaQuant), chroma_q(kChromaQuant);
  static const HuffCodes dc_l(kDcLuma), ac_l(kAcLuma), dc_c(kDcChroma),
      ac_c(kAcChroma);
  const bool color = channels == 3;
  const int hmax = color ? 2 : 1, vmax = color ? 2 : 1;
  const int mcux = cdiv(width, 8 * hmax), mcuy = cdiv(height, 8 * vmax);
  Plane planes[3];
  if (!color) {
    planes[0] = pad(px, width, height, 8 * cdiv(width, 8),
                    8 * cdiv(height, 8));
  } else {
    // jccolor.c rgb_ycc_convert
    const long kHalf = 1L << 15, kOffset = 128L << 16;
    auto fix = [](double x) { return static_cast<long>(x * 65536 + 0.5); };
    const long ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
    const long rcb = -fix(0.16874), gcb = -fix(0.33126), half = fix(0.5);
    const long gcr = -fix(0.41869), bcr = -fix(0.08131);
    size_t n = static_cast<size_t>(width) * height;
    std::vector<uint8_t> ycc[3];
    for (auto &p : ycc) p.resize(n);
    for (size_t i = 0; i < n; i++) {
      long r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
      ycc[0][i] = static_cast<uint8_t>((ry * r + gy * g + by * b + kHalf)
                                       >> 16);
      ycc[1][i] = static_cast<uint8_t>(
          (rcb * r + gcb * g + half * b + kOffset + kHalf - 1) >> 16);
      ycc[2][i] = static_cast<uint8_t>(
          (half * r + gcr * g + bcr * b + kOffset + kHalf - 1) >> 16);
    }
    // Y: blocks of the image, rows to the MCU height
    planes[0] = pad(ycc[0].data(), width, height, 8 * cdiv(width, 8),
                    16 * mcuy);
    // Cb, Cr: the image replicated to (even rows, whole 16-column
    // blocks), h2v2_downsample, its last row replicated to whole blocks
    const int cw = 8 * cdiv(width, 16), ch = cdiv(height, 2);
    for (int k = 1; k < 3; k++) {
      Plane full = pad(ycc[k].data(), width, height, 2 * cw, 2 * ch);
      std::vector<uint8_t> ds(static_cast<size_t>(cw) * ch);
      for (int y = 0; y < ch; y++) {
        const uint8_t *r0 = &full.px[static_cast<size_t>(2 * y) * full.w];
        const uint8_t *r1 = r0 + full.w;
        int bias = 1;
        for (int x = 0; x < cw; x++) {
          ds[static_cast<size_t>(y) * cw + x] = static_cast<uint8_t>(
              (r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] +
               bias) >> 2);
          bias ^= 3;
        }
      }
      planes[k] = pad(ds.data(), cw, ch, cw, 8 * mcuy);
    }
  }

  Component comps[3] = {
      {1, hmax, vmax, 0, &planes[0], &luma_q, &dc_l, &ac_l,
       cdiv(width, 8), cdiv(height, 8)},
      {2, 1, 1, 1, &planes[1], &chroma_q, &dc_c, &ac_c, cdiv(width, 16),
       cdiv(height, 16)},
      {3, 1, 1, 1, &planes[2], &chroma_q, &dc_c, &ac_c, cdiv(width, 16),
       cdiv(height, 16)}};
  const int ncomp = color ? 3 : 1;

  std::vector<uint8_t> o = {0xFF, 0xD8};
  marker(o, 0xE0, 16);
  const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1,
                            0, 0};
  o.insert(o.end(), jfif, jfif + 14);
  write_dqt(o, luma_q, 0);
  if (color) write_dqt(o, chroma_q, 1);
  marker(o, 0xC0, 8 + 3 * ncomp);
  o.push_back(8);
  put16(o, height);
  put16(o, width);
  o.push_back(static_cast<uint8_t>(ncomp));
  for (int i = 0; i < ncomp; i++) {
    o.push_back(static_cast<uint8_t>(comps[i].id));
    o.push_back(static_cast<uint8_t>(comps[i].h << 4 | comps[i].v));
    o.push_back(static_cast<uint8_t>(comps[i].tq));
  }
  write_dht(o, kDcLuma, 0x00);
  write_dht(o, kAcLuma, 0x10);
  if (color) {
    write_dht(o, kDcChroma, 0x01);
    write_dht(o, kAcChroma, 0x11);
  }
  marker(o, 0xDA, 6 + 2 * ncomp);
  o.push_back(static_cast<uint8_t>(ncomp));
  for (int i = 0; i < ncomp; i++) {
    o.push_back(static_cast<uint8_t>(comps[i].id));
    o.push_back(static_cast<uint8_t>(comps[i].tq ? 0x11 : 0x00));
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  BitWriter bw(o);
  int16_t coef[64];
  if (!color) {
    // one component: a non-interleaved scan over the image's blocks
    Component &c = comps[0];
    for (int by = 0; by < c.hb; by++)
      for (int bx = 0; bx < c.wb; bx++) {
        quantised_block(c, by, bx, coef);
        encode_block(bw, c, coef);
      }
  } else {
    // jccoefct.c compress_data: blocks past the image's are dummies
    // with the DC of the block before them in the MCU
    for (int my = 0; my < mcuy; my++)
      for (int mx = 0; mx < mcux; mx++)
        for (int i = 0; i < ncomp; i++) {
          Component &c = comps[i];
          int16_t prev_dc = 0;
          for (int v = 0; v < c.v; v++)
            for (int h = 0; h < c.h; h++) {
              int by = my * c.v + v, bx = mx * c.h + h;
              if (by < c.hb && bx < c.wb) {
                quantised_block(c, by, bx, coef);
              } else {
                memset(coef, 0, sizeof(coef));
                coef[0] = prev_dc;
              }
              prev_dc = coef[0];
              encode_block(bw, c, coef);
            }
        }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

void set_error(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" int64_t mods_jpeg_encode(const uint8_t *pixels, int width,
                                    int height, int channels, uint8_t *out,
                                    int64_t cap, char *err, int errlen) {
  try {
    if (width < 1 || height < 1 || width > 65535 || height > 65535)
      throw Error{"JPEG: image size " + std::to_string(width) + "x" +
                  std::to_string(height) + " is outside 1..65535"};
    if (channels != 1 && channels != 3)
      throw Error{"JPEG: " + std::to_string(channels) +
                  " channels (1 or 3 are written)"};
    std::vector<uint8_t> o = encode(pixels, width, height, channels);
    if (static_cast<int64_t>(o.size()) > cap)
      throw Error{"JPEG: the output buffer is too small"};
    memcpy(out, o.data(), o.size());
    return static_cast<int64_t>(o.size());
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, std::string("JPEG: ") + e.what());
  }
  return -1;
}
