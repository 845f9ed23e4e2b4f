// JPEG decoder for io/image.py::read_image: Huffman sequential (SOF0,
// SOF1) and progressive (SOF2) files of 8-bit precision with 1, 3 or 4
// components, bound with ctypes.
//
// It reproduces libjpeg-turbo's default decompression, the one PIL runs
// for Image.open(path), so that the port reads the same pixels as the
// JAX package's np.asarray(Image.open(path)):
//   - the "islow" integer inverse DCT of jidctint.c (jpeg_idct_islow:
//     CONST_BITS 13, PASS1_BITS 2, the column pass then the row pass,
//     the post-IDCT range-limit table of jdmaster.c);
//   - "fancy" (triangle-filter) upsampling of jdsample.c: h2v1, h2v2 and
//     h1v2_fancy_upsample, and int_upsample's replication for any other
//     integral ratio (or a component 2 samples wide or less);
//   - the fixed-point YCbCr -> RGB of jdcolor.c (ycc_rgb_convert, 16
//     fraction bits), or no conversion where an Adobe marker (transform
//     0) or the component ids 'R', 'G', 'B' say the file is RGB;
//   - 4 components as CMYK (an Adobe marker with transform 0, or none:
//     jdapimin.c), each sample inverted as PIL's "CMYK;I" raw mode
//     inverts the Adobe convention.
// A progressive file is decoded as jdphuff.c decodes it (DC first and
// refinement, AC first and refinement with end-of-band runs); its
// coefficients are complete after the last scan, so libjpeg's block
// smoothing, which only runs on incomplete coefficients, never applies.
// Restart intervals (DRI, RSTn) are honoured.  Arithmetic coding,
// lossless and hierarchical files, 12-bit precision, 2 components and
// YCCK (4 components, Adobe transform other than 0) are refused with a
// message naming the case.
//
// Interface: mods_jpeg_info(data, n, info[4], err, errlen) fills width,
// height, channels; mods_jpeg_decode(data, n, out, cap, err, errlen)
// writes (height, width[, channels]) uint8 pixels.  Both return 0, or -1 with a
// message in err.  mods_jpeg_decode_tiff decodes one strip or tile of a
// JPEG-in-TIFF file as libtiff's JPEG codec does for PIL: the JPEGTables
// stream read first, the sampling factors checked against the TIFF's, and
// the colour transform taken from the TIFF's photometric interpretation
// (YCbCr -> RGB for 6, none otherwise), never from the markers.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for a corrupt run past the end (jutils.c)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool present = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int width_in_blocks = 0, height_in_blocks = 0;  // of the image's samples
  int blocks_w = 0, blocks_h = 0;                 // allocated: whole MCUs
  int ds_w = 0, ds_h = 0;                         // downsampled size
  int pred = 0;
  std::vector<int16_t> coef;  // blocks_h * blocks_w blocks of 64
  int16_t *block(int by, int bx) {
    return &coef[(static_cast<size_t>(by) * blocks_w + bx) * 64];
  }
};

class Decoder {
 public:
  Decoder(const uint8_t *d, size_t n) : d_(d), n_(n) {}

  void read_headers();
  void load_tables(const uint8_t *t, size_t nt);
  void decode();
  void output(uint8_t *out);
  void check_tiff_sampling(int hs, int vs) const;
  void raw_planes(uint8_t *out);
  int64_t raw_size() const;
  void raw_info(int32_t *info) const;

  // -1: the colour transform from the markers; 0: none (the components
  // as stored); 1: YCbCr -> RGB (a JPEG-in-TIFF strip or tile)
  int transform = -1;

  int width = 0, height = 0, ncomp = 0;
  // tif_ojpeg.c's resync_to_restart fails: a restart marker other than
  // the next RSTn ends the decoding at that MCU (fail_mcu, else -1)
  bool strict_restarts = false;
  int64_t fail_mcu = -1;
  int mcus_per_row() const { return mcux_; }

 private:
  const uint8_t *d_;
  size_t n_, pos_ = 0;
  uint16_t qt_[4][64] = {};
  bool qt_present_[4] = {};
  Huffman dc_[4], ac_[4];
  Component comp_[4];
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  bool sof_seen_ = false, progressive_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  // scan state
  int scan_comp_[4] = {}, scan_n_ = 0, ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  int eobrun_ = 0;
  // bit reader (jdhuff.c's fill_bit_buffer: a marker ends the data and
  // zeros are supplied after it)
  uint32_t bits_ = 0;
  int nbits_ = 0, real_bits_ = 0;
  bool marker_hit_ = false, insufficient_ = false;

  uint8_t byte() {
    if (pos_ >= n_) throw Error{"JPEG: the file ends inside a header"};
    return d_[pos_++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  void fill() {
    while (nbits_ <= 24) {
      uint32_t b = 0;
      if (!marker_hit_ && pos_ < n_) {
        b = d_[pos_];
        if (b == 0xFF) {
          uint8_t next = pos_ + 1 < n_ ? d_[pos_ + 1] : 0;
          if (next == 0x00) {
            pos_ += 2;
            real_bits_ += 8;
          } else {
            marker_hit_ = true;
            b = 0;
          }
        } else {
          pos_++;
          real_bits_ += 8;
        }
      }
      bits_ |= b << (24 - nbits_);
      nbits_ += 8;
    }
  }
  // jdhuff.c's insufficient_data: set once a code reads past the data
  // (zeros stuffed after a marker); the MCUs after it are left zero
  void consume(int k) {
    bits_ <<= k;
    nbits_ -= k;
    if (k > real_bits_) insufficient_ = true;
    real_bits_ = k > real_bits_ ? 0 : real_bits_ - k;
  }
  int get_bits(int k) {
    if (k == 0) return 0;
    fill();
    int v = static_cast<int>(bits_ >> (32 - k));
    consume(k);
    return v;
  }
  int get_bit() { return get_bits(1); }
  int decode_huff(const Huffman &t) {
    fill();
    for (int len = 1; len <= 16; len++) {
      int code = static_cast<int>(bits_ >> (32 - len));
      if (code <= t.maxcode[len]) {
        consume(len);
        return t.vals[(t.valoffset[len] + code) & 0xFF];
      }
    }
    // a corrupt code: libjpeg reads a 17th bit, warns and returns 0
    consume(16);
    fill();
    consume(1);
    return 0;
  }
  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
  void reset_bits() {
    bits_ = 0;
    nbits_ = 0;
    real_bits_ = 0;
    marker_hit_ = false;
  }
  void restart();
  bool restart_strict();
  int next_rst_ = 0;

  void read_sof(int marker);
  void read_dht();
  void read_dqt();
  void read_sos();
  void read_app(int marker);
  void skip_segment() {
    int len = u16();
    if (len < 2 || pos_ + len - 2 > n_)
      throw Error{"JPEG: a marker segment runs past the end of the file"};
    pos_ += len - 2;
  }
  void decode_scan();
  void decode_block(Component &c, int16_t *blk);
  void idct_plane(Component &c, std::vector<uint8_t> &plane);
};

void Decoder::read_sof(int marker) {
  switch (marker) {
    case 0xC0:
    case 0xC1:
      break;
    case 0xC2:
      progressive_ = true;
      break;
    case 0xC3:
      throw Error{"JPEG: lossless (SOF3) files are not supported"};
    case 0xC5:
    case 0xC6:
    case 0xC7:
      throw Error{"JPEG: hierarchical (SOF5-7) files are not supported"};
    case 0xC9:
    case 0xCA:
      throw Error{"JPEG: arithmetic-coded files are not supported"};
    case 0xCB:
    case 0xCD:
    case 0xCE:
    case 0xCF:
      throw Error{"JPEG: arithmetic-coded lossless/hierarchical files are "
                  "not supported"};
    default:
      throw Error{"JPEG: unknown frame type"};
  }
  if (sof_seen_) throw Error{"JPEG: more than one frame header"};
  sof_seen_ = true;
  int len = u16();
  int precision = byte();
  height = u16();
  width = u16();
  ncomp = byte();
  if (precision != 8)
    throw Error{"JPEG: " + std::to_string(precision) +
                "-bit precision is not supported (8-bit only)"};
  if (ncomp != 1 && ncomp != 3 && ncomp != 4)
    throw Error{"JPEG: " + std::to_string(ncomp) +
                " components are not supported (1, 3 or 4)"};
  if (len != 8 + 3 * ncomp) throw Error{"JPEG: bad frame header length"};
  if (width <= 0 || height <= 0)
    throw Error{"JPEG: zero image size (a DNL marker is not supported)"};
  for (int i = 0; i < ncomp; i++) {
    Component &c = comp_[i];
    c.id = byte();
    int hv = byte();
    c.h = hv >> 4;
    c.v = hv & 15;
    c.tq = byte();
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      throw Error{"JPEG: bad sampling factors or quantization table"};
    hmax_ = std::max(hmax_, c.h);
    vmax_ = std::max(vmax_, c.v);
  }
  mcux_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
  mcuy_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
  for (int i = 0; i < ncomp; i++) {
    Component &c = comp_[i];
    if (hmax_ % c.h || vmax_ % c.v)
      throw Error{"JPEG: non-integral sampling ratios are not supported"};
    // jdinput.c: ceil(image size * factor / (max factor * DCTSIZE))
    c.width_in_blocks =
        static_cast<int>((static_cast<long>(width) * c.h + 8L * hmax_ - 1) /
                         (8L * hmax_));
    c.height_in_blocks =
        static_cast<int>((static_cast<long>(height) * c.v + 8L * vmax_ - 1) /
                         (8L * vmax_));
    c.ds_w = static_cast<int>(
        (static_cast<long>(width) * c.h + hmax_ - 1) / hmax_);
    c.ds_h = static_cast<int>(
        (static_cast<long>(height) * c.v + vmax_ - 1) / vmax_);
    c.blocks_w = mcux_ * c.h;
    c.blocks_h = mcuy_ * c.v;
    c.coef.assign(static_cast<size_t>(c.blocks_w) * c.blocks_h * 64, 0);
  }
}

void Decoder::read_dht() {
  int len = u16() - 2;
  while (len > 0) {
    int tc_th = byte();
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) throw Error{"JPEG: bad Huffman table id"};
    uint8_t counts[17] = {};
    int total = 0;
    for (int i = 1; i <= 16; i++) {
      counts[i] = byte();
      total += counts[i];
    }
    if (total > 256) throw Error{"JPEG: bad Huffman table"};
    Huffman &t = tc == 0 ? dc_[th] : ac_[th];
    for (int i = 0; i < total; i++) t.vals[i] = byte();
    // canonical codes (jdhuff.c jpeg_make_d_derived_tbl)
    int code = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      if (counts[l]) {
        t.valoffset[l] = k - code;
        k += counts[l];
        code += counts[l];
        t.maxcode[l] = code - 1;
      } else {
        t.valoffset[l] = 0;
        t.maxcode[l] = -1;
      }
      code <<= 1;
    }
    t.maxcode[17] = 0x7FFFFFFF;
    t.present = true;
    len -= 17 + total;
  }
  if (len != 0) throw Error{"JPEG: bad DHT length"};
}

void Decoder::read_dqt() {
  int len = u16() - 2;
  while (len > 0) {
    int pq_tq = byte();
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (tq > 3) throw Error{"JPEG: bad quantization table id"};
    for (int i = 0; i < 64; i++)
      qt_[tq][kNatural[i]] = static_cast<uint16_t>(pq ? u16() : byte());
    qt_present_[tq] = true;
    len -= 1 + 64 * (pq ? 2 : 1);
  }
  if (len != 0) throw Error{"JPEG: bad DQT length"};
}

void Decoder::read_app(int marker) {
  size_t start = pos_;
  int len = u16();
  if (len < 2 || start + len > n_)
    throw Error{"JPEG: a marker segment runs past the end of the file"};
  const uint8_t *p = d_ + start + 2;
  int body = len - 2;
  if (marker == 0xE0 && body >= 5 && !memcmp(p, "JFIF\0", 5)) jfif_ = true;
  if (marker == 0xEE && body >= 12 && !memcmp(p, "Adobe", 5)) {
    adobe_ = true;
    adobe_transform_ = p[11];
  }
  pos_ = start + len;
}

void Decoder::read_sos() {
  if (!sof_seen_) throw Error{"JPEG: a scan before the frame header"};
  int len = u16();
  scan_n_ = byte();
  if (scan_n_ < 1 || scan_n_ > 4 || len != 6 + 2 * scan_n_)
    throw Error{"JPEG: bad scan header"};
  for (int i = 0; i < scan_n_; i++) {
    int id = byte(), tables = byte();
    int ci = -1;
    for (int j = 0; j < ncomp; j++)
      if (comp_[j].id == id) ci = j;
    if (ci < 0) throw Error{"JPEG: a scan names an unknown component"};
    scan_comp_[i] = ci;
    comp_[ci].dc_tbl = tables >> 4;
    comp_[ci].ac_tbl = tables & 15;
    if (comp_[ci].dc_tbl > 3 || comp_[ci].ac_tbl > 3)
      throw Error{"JPEG: bad Huffman table id in a scan"};
  }
  ss_ = byte();
  se_ = byte();
  int a = byte();
  ah_ = a >> 4;
  al_ = a & 15;
  if (progressive_) {
    if (ss_ > 63 || se_ > 63 || ss_ > se_ || (ss_ == 0 && se_ != 0) ||
        (ss_ > 0 && scan_n_ != 1) || al_ > 13)
      throw Error{"JPEG: bad progressive scan parameters"};
  } else {
    ss_ = 0;
    se_ = 63;
    ah_ = al_ = 0;
  }
}

void Decoder::restart() {
  // jdhuff.c process_restart: drop the bits left, read the RSTn marker,
  // reset the DC predictions and the end-of-band run
  reset_bits();
  while (pos_ + 1 < n_ &&
         !(d_[pos_] == 0xFF && d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7))
    pos_++;
  if (pos_ + 1 < n_) pos_ += 2;
  for (int i = 0; i < ncomp; i++) comp_[i].pred = 0;
  eobrun_ = 0;
}

// jdmarker.c read_restart_marker with tif_ojpeg.c's resync_to_restart:
// the next marker (next_marker skips the bytes before it) must be the
// next RSTn in turn, or libjpeg's error ends the decoding
bool Decoder::restart_strict() {
  reset_bits();
  while (pos_ + 1 < n_ &&
         !(d_[pos_] == 0xFF && d_[pos_ + 1] != 0x00 && d_[pos_ + 1] != 0xFF))
    pos_++;
  if (pos_ + 1 >= n_ || d_[pos_ + 1] != 0xD0 + next_rst_) return false;
  pos_ += 2;
  next_rst_ = (next_rst_ + 1) & 7;
  for (int i = 0; i < ncomp; i++) comp_[i].pred = 0;
  eobrun_ = 0;
  return true;
}

void Decoder::decode_block(Component &c, int16_t *blk) {
  const Huffman &dct = dc_[c.dc_tbl];
  const Huffman &act = ac_[c.ac_tbl];
  if (!progressive_) {
    // jdhuff.c decode_mcu
    int s = decode_huff(dct);
    c.pred += s ? extend(get_bits(s), s) : 0;
    blk[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64; k++) {
      int rs = decode_huff(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(get_bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return;
  }
  if (ss_ == 0) {
    if (ah_ == 0) {  // DC first (decode_mcu_DC_first)
      int s = decode_huff(dct);
      c.pred += s ? extend(get_bits(s), s) : 0;
      blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.pred) << al_);
    } else if (get_bit()) {  // DC refinement (decode_mcu_DC_refine)
      blk[0] = static_cast<int16_t>(blk[0] | (1 << al_));
    }
    return;
  }
  if (ah_ == 0) {  // AC first (decode_mcu_AC_first)
    if (eobrun_ > 0) {
      eobrun_--;
      return;
    }
    for (int k = ss_; k <= se_; k++) {
      int rs = decode_huff(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(
            static_cast<unsigned>(extend(get_bits(s), s)) << al_);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += get_bits(r);
        eobrun_--;
        break;
      }
    }
    return;
  }
  // AC refinement (decode_mcu_AC_refine)
  int p1 = 1 << al_, m1 = -1 * (1 << al_);
  int k = ss_;
  auto refine = [&](int16_t *coef) {
    if (get_bit() && (*coef & p1) == 0)
      *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
  };
  if (eobrun_ == 0) {
    for (; k <= se_; k++) {
      int rs = decode_huff(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = get_bit() ? p1 : m1;
      } else if (r != 15) {
        eobrun_ = 1 << r;
        if (r) eobrun_ += get_bits(r);
        break;
      }
      do {
        int16_t *coef = blk + kNatural[k];
        if (*coef != 0) {
          refine(coef);
        } else if (--r < 0) {
          break;
        }
        k++;
      } while (k <= se_);
      if (s && k <= 63) blk[kNatural[k]] = static_cast<int16_t>(s);
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se_; k++) {
      int16_t *coef = blk + kNatural[k];
      if (*coef != 0) refine(coef);
    }
    eobrun_--;
  }
}

void Decoder::decode_scan() {
  for (int i = 0; i < scan_n_; i++) {
    Component &c = comp_[scan_comp_[i]];
    bool needs_dc = !progressive_ || (ss_ == 0 && ah_ == 0);
    bool needs_ac = !progressive_ || ss_ > 0;
    if ((needs_dc && !dc_[c.dc_tbl].present) ||
        (needs_ac && !ac_[c.ac_tbl].present))
      throw Error{"JPEG: a scan uses an undefined Huffman table"};
    c.pred = 0;
  }
  eobrun_ = 0;
  reset_bits();
  int restarts_left = restart_interval_;
  int64_t mcu = -1;
  next_rst_ = 0;
  insufficient_ = false;
  auto next_mcu = [&]() {
    mcu++;
    if (!restart_interval_) return true;
    if (restarts_left == 0) {
      if (strict_restarts) {
        if (!restart_strict()) {
          fail_mcu = mcu;
          return false;
        }
      } else {
        restart();
      }
      insufficient_ = false;
      restarts_left = restart_interval_;
    }
    restarts_left--;
    return true;
  };
  if (scan_n_ == 1) {
    // non-interleaved: one block an MCU over the component's own blocks
    Component &c = comp_[scan_comp_[0]];
    for (int by = 0; by < c.height_in_blocks; by++)
      for (int bx = 0; bx < c.width_in_blocks; bx++) {
        if (!next_mcu()) return;
        if (!insufficient_) decode_block(c, c.block(by, bx));
      }
  } else {
    for (int my = 0; my < mcuy_; my++)
      for (int mx = 0; mx < mcux_; mx++) {
        if (!next_mcu()) return;
        if (insufficient_) continue;
        for (int i = 0; i < scan_n_; i++) {
          Component &c = comp_[scan_comp_[i]];
          for (int v = 0; v < c.v; v++)
            for (int h = 0; h < c.h; h++)
              decode_block(c, c.block(my * c.v + v, mx * c.h + h));
        }
      }
  }
  // leave the position at the next marker
  reset_bits();
  while (pos_ + 1 < n_ &&
         !(d_[pos_] == 0xFF && d_[pos_ + 1] != 0x00 &&
           !(d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7) &&
           d_[pos_ + 1] != 0xFF))
    pos_++;
}

void Decoder::read_headers() {
  if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8)
    throw Error{"JPEG: no SOI marker"};
  pos_ = 2;
  while (!sof_seen_) {
    // find the next marker, skipping fill bytes
    while (pos_ < n_ && d_[pos_] != 0xFF) pos_++;
    while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
    if (pos_ >= n_) throw Error{"JPEG: no frame header"};
    int m = d_[pos_++];
    if ((m >= 0xC0 && m <= 0xCF) && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      read_sof(m);
    } else if (m == 0xC4) {
      read_dht();
    } else if (m == 0xDB) {
      read_dqt();
    } else if (m == 0xDD) {
      if (u16() != 4) throw Error{"JPEG: bad DRI length"};
      restart_interval_ = u16();
    } else if (m == 0xCC) {
      throw Error{"JPEG: arithmetic-coded files are not supported"};
    } else if (m >= 0xE0 && m <= 0xEF) {
      read_app(m);
    } else if (m == 0xD9 || m == 0xDA) {
      throw Error{"JPEG: no frame header before the first scan"};
    } else if (m >= 0xD0 && m <= 0xD7) {
      continue;
    } else {
      skip_segment();
    }
  }
}

// libtiff's JPEGTables (tag 347): an abbreviated stream of tables (SOI,
// DQT, DHT, DRI, EOI) read before each strip's or tile's own stream
void Decoder::load_tables(const uint8_t *t, size_t nt) {
  const uint8_t *d = d_;
  size_t n = n_;
  d_ = t;
  n_ = nt;
  if (nt < 4 || t[0] != 0xFF || t[1] != 0xD8)
    throw Error{"JPEG-in-TIFF: JPEGTables without an SOI marker"};
  pos_ = 2;
  while (true) {
    while (pos_ < n_ && d_[pos_] != 0xFF) pos_++;
    while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
    if (pos_ >= n_) break;
    int m = d_[pos_++];
    if (m == 0xD9) break;
    if (m == 0xC4) {
      read_dht();
    } else if (m == 0xDB) {
      read_dqt();
    } else if (m == 0xDD) {
      if (u16() != 4) throw Error{"JPEG: bad DRI length"};
      restart_interval_ = u16();
    } else if (m >= 0xE0 && m <= 0xEF) {
      read_app(m);
    } else if ((m >= 0xC0 && m <= 0xCF) || m == 0xDA) {
      throw Error{"JPEG-in-TIFF: JPEGTables holds a frame or a scan"};
    } else if (!(m >= 0xD0 && m <= 0xD8)) {
      skip_segment();
    }
  }
  d_ = d;
  n_ = n;
  pos_ = 0;
}

// tif_jpeg.c JPEGPreDecode: component 0 sampled (hs, vs) as the TIFF's
// YCbCrSubsampling says (1, 1 for any other photometric), the rest 1, 1
void Decoder::check_tiff_sampling(int hs, int vs) const {
  for (int i = 0; i < ncomp; i++) {
    int h = i == 0 ? hs : 1, v = i == 0 ? vs : 1;
    if (comp_[i].h != h || comp_[i].v != v)
      throw Error{"JPEG-in-TIFF: improper JPEG sampling factors " +
                  std::to_string(comp_[i].h) + "x" +
                  std::to_string(comp_[i].v) + " of component " +
                  std::to_string(i) + " (the TIFF says " + std::to_string(h) +
                  "x" + std::to_string(v) + "): PIL refuses it (libtiff's "
                  "JPEGPreDecode fails)"};
  }
}

void Decoder::decode() {
  while (true) {
    while (pos_ < n_ && d_[pos_] != 0xFF) pos_++;
    while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
    if (pos_ >= n_) break;  // a truncated file: keep what was decoded
    int m = d_[pos_++];
    if (m == 0xD9) break;
    if (m == 0xDA) {
      read_sos();
      decode_scan();
      if (fail_mcu >= 0) break;
    } else if (m == 0xC4) {
      read_dht();
    } else if (m == 0xDB) {
      read_dqt();
    } else if (m == 0xDD) {
      if (u16() != 4) throw Error{"JPEG: bad DRI length"};
      restart_interval_ = u16();
    } else if (m >= 0xE0 && m <= 0xEF) {
      read_app(m);
    } else if (m >= 0xD0 && m <= 0xD7) {
      continue;
    } else if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
               m != 0xCC) {
      throw Error{"JPEG: more than one frame header"};
    } else {
      skip_segment();
    }
  }
}

// jidctint.c's "islow" inverse DCT as libjpeg-turbo's SIMD code runs it
// for PIL (jsimd_idct_islow: jidctint-sse2.asm and its AVX2 twin, which
// compute alike): the same fixed-point algorithm as jpeg_idct_islow, but
// on 16-bit lanes.  On valid data the two agree bit for bit; on corrupt
// data (the huge coefficients of entropy data read with the wrong
// sampling, say) they part, and PIL's pixels are the SIMD code's:
//   - each coefficient times its quantizer keeps the low 16 bits (pmullw);
//   - in0 +- in4, in3 + in7 and in1 + in5 wrap at 16 bits (paddw, psubw);
//     the products are 32-bit sums of two (pmaddwd);
//   - the column pass's outputs saturate to int16 (packssdw);
//   - where every AC coefficient of the block is zero, the column pass is
//     the DC times its quantizer shifted up PASS1_BITS in 16 bits (psllw);
//   - the row pass has no shortcut; its outputs saturate to int16, then to
//     int8 (packsswb), and are offset by 128.
const int kConstBits = 13, kPass1Bits = 2;
const int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433,
              F_0_765 = 6270, F_0_899 = 7373, F_1_175 = 9633,
              F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
              F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int16_t w16(int32_t x) { return static_cast<int16_t>(x); }
inline int32_t w32(int64_t x) {
  return static_cast<int32_t>(static_cast<uint32_t>(x));
}
inline int16_t sat16(int32_t x) {
  return static_cast<int16_t>(x < -32768 ? -32768 : x > 32767 ? 32767 : x);
}
// pmaddwd: a * ca + b * cb, summed in 32 bits
inline int32_t madd(int16_t a, int32_t ca, int16_t b, int32_t cb) {
  return w32(static_cast<int64_t>(a) * ca + static_cast<int64_t>(b) * cb);
}

// the dodct step on one column or row of 8 16-bit inputs -> the 8 32-bit
// sums before descaling, in output order
void dodct(const int16_t in[8], int32_t out[8]) {
  int32_t tmp3 = madd(in[2], F_0_541 + F_0_765, in[6], F_0_541);
  int32_t tmp2 = madd(in[2], F_0_541, in[6], F_0_541 - F_1_847);
  int32_t tmp0 = static_cast<int32_t>(w16(in[0] + in[4])) * (1 << kConstBits);
  int32_t tmp1 = static_cast<int32_t>(w16(in[0] - in[4])) * (1 << kConstBits);
  int32_t tmp10 = w32(static_cast<int64_t>(tmp0) + tmp3);
  int32_t tmp13 = w32(static_cast<int64_t>(tmp0) - tmp3);
  int32_t tmp11 = w32(static_cast<int64_t>(tmp1) + tmp2);
  int32_t tmp12 = w32(static_cast<int64_t>(tmp1) - tmp2);
  int16_t z3 = w16(in[3] + in[7]), z4 = w16(in[1] + in[5]);
  int32_t z3p = madd(z3, F_1_175 - F_1_961, z4, F_1_175);
  int32_t z4p = madd(z3, F_1_175, z4, F_1_175 - F_0_390);
  int32_t o0 = w32(static_cast<int64_t>(
      madd(in[7], F_0_298 - F_0_899, in[1], -F_0_899)) + z3p);
  int32_t o3 = w32(static_cast<int64_t>(
      madd(in[7], -F_0_899, in[1], F_1_501 - F_0_899)) + z4p);
  int32_t o1 = w32(static_cast<int64_t>(
      madd(in[5], F_2_053 - F_2_562, in[3], -F_2_562)) + z4p);
  int32_t o2 = w32(static_cast<int64_t>(
      madd(in[5], -F_2_562, in[3], F_3_072 - F_2_562)) + z3p);
  out[0] = w32(static_cast<int64_t>(tmp10) + o3);
  out[7] = w32(static_cast<int64_t>(tmp10) - o3);
  out[1] = w32(static_cast<int64_t>(tmp11) + o2);
  out[6] = w32(static_cast<int64_t>(tmp11) - o2);
  out[2] = w32(static_cast<int64_t>(tmp12) + o1);
  out[5] = w32(static_cast<int64_t>(tmp12) - o1);
  out[3] = w32(static_cast<int64_t>(tmp13) + o0);
  out[4] = w32(static_cast<int64_t>(tmp13) - o0);
}

// paddd of the rounding constant, then psrad
inline int32_t descale(int32_t x, int n) {
  return w32(static_cast<int64_t>(x) + (1 << (n - 1))) >> n;
}

void idct_islow(const int16_t *in, const uint16_t *q, uint8_t *out,
                int stride) {
  int16_t ws[64];  // ws[8 * r + c]: row r, column c
  bool ac = false;
  for (int i = 8; i < 64; i++) ac = ac || in[i] != 0;
  if (!ac) {
    for (int c = 0; c < 8; c++) {
      int16_t dc = w16(w16(in[c] * q[c]) * (1 << kPass1Bits));
      for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
    }
  } else {
    for (int c = 0; c < 8; c++) {
      int16_t col[8];
      int32_t sums[8];
      for (int r = 0; r < 8; r++) col[r] = w16(in[8 * r + c] * q[8 * r + c]);
      dodct(col, sums);
      for (int r = 0; r < 8; r++)
        ws[8 * r + c] = sat16(descale(sums[r], kConstBits - kPass1Bits));
    }
  }
  for (int r = 0; r < 8; r++) {
    int32_t sums[8];
    dodct(ws + 8 * r, sums);
    uint8_t *op = out + static_cast<size_t>(r) * stride;
    for (int c = 0; c < 8; c++) {
      int v = sat16(descale(sums[c], kConstBits + kPass1Bits + 3));
      op[c] = static_cast<uint8_t>((v < -128 ? -128 : v > 127 ? 127 : v) +
                                   128);
    }
  }
}

void Decoder::idct_plane(Component &c, std::vector<uint8_t> &plane) {
  if (!qt_present_[c.tq])
    throw Error{"JPEG: a component uses an undefined quantization table"};
  int stride = c.blocks_w * 8;
  plane.assign(static_cast<size_t>(stride) * c.blocks_h * 8, 0);
  for (int by = 0; by < c.blocks_h; by++)
    for (int bx = 0; bx < c.blocks_w; bx++)
      idct_islow(c.block(by, bx), qt_[c.tq],
                 &plane[static_cast<size_t>(by) * 8 * stride + bx * 8],
                 stride);
}

// jdsample.c: one component's (ds_h, ds_w) samples of a plane with row
// stride `stride` -> (vmax/v * ds_h, hmax/h * ds_w) samples.  Rows above
// the first and below the last repeat them, as jdmainct.c's context rows
// do at the image's top and bottom.
std::vector<uint8_t> upsample(const std::vector<uint8_t> &plane, int stride,
                              int ds_w, int ds_h, int rh, int rv,
                              int &out_w) {
  out_w = ds_w * rh;
  int out_h = ds_h * rv;
  std::vector<uint8_t> out(static_cast<size_t>(out_w) * out_h);
  auto row = [&](int y) {
    y = y < 0 ? 0 : (y >= ds_h ? ds_h - 1 : y);
    return &plane[static_cast<size_t>(y) * stride];
  };
  if (rh == 2 && rv == 1 && ds_w > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < ds_h; y++) {
      const uint8_t *in = row(y);
      uint8_t *o = &out[static_cast<size_t>(y) * out_w];
      o[0] = in[0];
      o[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < ds_w - 1; x++) {
        int v = in[x] * 3;
        o[2 * x] = static_cast<uint8_t>((v + in[x - 1] + 1) >> 2);
        o[2 * x + 1] = static_cast<uint8_t>((v + in[x + 1] + 2) >> 2);
      }
      int x = ds_w - 1;
      o[2 * x] = static_cast<uint8_t>((in[x] * 3 + in[x - 1] + 1) >> 2);
      o[2 * x + 1] = in[x];
    }
  } else if (rh == 2 && rv == 2 && ds_w > 2) {  // h2v2_fancy_upsample
    for (int y = 0; y < ds_h; y++)
      for (int v = 0; v < 2; v++) {
        const uint8_t *in0 = row(y);
        const uint8_t *in1 = row(v == 0 ? y - 1 : y + 1);
        uint8_t *o = &out[static_cast<size_t>(2 * y + v) * out_w];
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        o[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
        o[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 1; x < ds_w - 1; x++) {
          next_sum = in0[x + 1] * 3 + in1[x + 1];
          o[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          o[2 * x + 1] =
              static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        int x = ds_w - 1;
        o[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        o[2 * x + 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
      }
  } else if (rh == 1 && rv == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < ds_h; y++)
      for (int v = 0; v < 2; v++) {
        const uint8_t *in0 = row(y);
        const uint8_t *in1 = row(v == 0 ? y - 1 : y + 1);
        int bias = v == 0 ? 1 : 2;
        uint8_t *o = &out[static_cast<size_t>(2 * y + v) * out_w];
        for (int x = 0; x < ds_w; x++)
          o[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
      }
  } else {  // fullsize_upsample / h2v1_upsample / h2v2_upsample / int_upsample
    for (int y = 0; y < out_h; y++) {
      const uint8_t *in = row(y / rv);
      uint8_t *o = &out[static_cast<size_t>(y) * out_w];
      for (int x = 0; x < out_w; x++) o[x] = in[x / rh];
    }
  }
  return out;
}

void Decoder::output(uint8_t *out) {
  if (transform < 0 && ncomp == 4 && adobe_ && adobe_transform_ != 0)
    throw Error{"JPEG: YCCK (4 components, Adobe transform " +
                std::to_string(adobe_transform_) + ") is not supported"};
  std::vector<uint8_t> planes[4];
  int widths[4];
  for (int i = 0; i < ncomp; i++) {
    Component &c = comp_[i];
    std::vector<uint8_t> plane;
    idct_plane(c, plane);
    planes[i] = upsample(plane, c.blocks_w * 8, c.ds_w, c.ds_h,
                         hmax_ / c.h, vmax_ / c.v, widths[i]);
  }
  if (ncomp == 1) {
    for (int y = 0; y < height; y++)
      memcpy(out + static_cast<size_t>(y) * width,
             &planes[0][static_cast<size_t>(y) * widths[0]], width);
    return;
  }
  if (ncomp == 4) {
    for (int y = 0; y < height; y++) {
      uint8_t *o = out + static_cast<size_t>(y) * width * 4;
      for (int k = 0; k < 4; k++) {
        const uint8_t *p = &planes[k][static_cast<size_t>(y) * widths[k]];
        for (int x = 0; x < width; x++)
          o[4 * x + k] = static_cast<uint8_t>(transform == 0 ? p[x]
                                                             : 255 - p[x]);
      }
    }
    return;
  }
  bool rgb;  // jdapimin.c default_decompress_parms
  if (transform >= 0)
    rgb = transform == 0;
  else if (jfif_)
    rgb = false;
  else if (adobe_)
    rgb = adobe_transform_ == 0;
  else
    rgb = comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
  // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
  const int kScale = 16;
  const long kHalf = 1L << (kScale - 1);
  auto fix = [](double x) {
    return static_cast<long>(x * (1L << kScale) + 0.5);
  };
  int cr_r[256], cb_b[256];
  long cr_g[256], cb_g[256];
  for (int i = 0; i < 256; i++) {
    long x = i - 128;
    cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
    cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + kHalf;
  }
  auto clamp = [](int v) {
    return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
  };
  for (int y = 0; y < height; y++) {
    const uint8_t *p0 = &planes[0][static_cast<size_t>(y) * widths[0]];
    const uint8_t *p1 = &planes[1][static_cast<size_t>(y) * widths[1]];
    const uint8_t *p2 = &planes[2][static_cast<size_t>(y) * widths[2]];
    uint8_t *o = out + static_cast<size_t>(y) * width * 3;
    for (int x = 0; x < width; x++) {
      int Y = p0[x], cb = p1[x], cr = p2[x];
      if (rgb) {
        o[3 * x] = static_cast<uint8_t>(Y);
        o[3 * x + 1] = static_cast<uint8_t>(cb);
        o[3 * x + 2] = static_cast<uint8_t>(cr);
        continue;
      }
      o[3 * x] = clamp(Y + cr_r[cr]);
      o[3 * x + 1] =
          clamp(Y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> kScale));
      o[3 * x + 2] = clamp(Y + cb_b[cb]);
    }
  }
}

// libjpeg's raw_data_out: each component's samples as the inverse DCT
// leaves them, not upsampled, in a plane of whole MCUs (blocks_h * 8 rows
// of blocks_w * 8 samples), one plane after another
int64_t Decoder::raw_size() const {
  int64_t n = 0;
  for (int i = 0; i < ncomp; i++)
    n += static_cast<int64_t>(comp_[i].blocks_w) * comp_[i].blocks_h * 64;
  return n;
}

void Decoder::raw_info(int32_t *info) const {
  info[0] = width;
  info[1] = height;
  info[2] = ncomp;
  for (int i = 0; i < ncomp; i++) {
    info[3 + 4 * i] = comp_[i].h;
    info[4 + 4 * i] = comp_[i].v;
    info[5 + 4 * i] = comp_[i].blocks_w;
    info[6 + 4 * i] = comp_[i].blocks_h;
  }
}

void Decoder::raw_planes(uint8_t *out) {
  for (int i = 0; i < ncomp; i++) {
    std::vector<uint8_t> plane;
    idct_plane(comp_[i], plane);
    memcpy(out, plane.data(), plane.size());
    out += plane.size();
  }
}

void set_error(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" int mods_jpeg_info(const uint8_t *data, int64_t n, int32_t *info,
                              char *err, int errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.read_headers();
    info[0] = dec.width;
    info[1] = dec.height;
    info[2] = dec.ncomp;
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, std::string("JPEG: ") + e.what());
  }
  return -1;
}

extern "C" int mods_jpeg_decode(const uint8_t *data, int64_t n, uint8_t *out,
                                int64_t cap, char *err, int errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.read_headers();
    int64_t need = static_cast<int64_t>(dec.width) * dec.height * dec.ncomp;
    if (need > cap) throw Error{"JPEG: the output buffer is too small"};
    dec.decode();
    dec.output(out);
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, std::string("JPEG: ") + e.what());
  }
  return -1;
}

// One strip or tile of a JPEG-in-TIFF file (compression 7): `tables` (the
// JPEGTables tag, or n_tables 0) read first, the stream's sampling held
// to (hs, vs) as libtiff holds it, and the components put out as stored
// (ycc 0) or converted from YCbCr to RGB (ycc 1: photometric 6, planar
// configuration 1, libtiff's JPEGCOLORMODE_RGB).  info gets width,
// height and components before the decode.
extern "C" int mods_jpeg_decode_tiff(const uint8_t *tables, int64_t n_tables,
                                     const uint8_t *data, int64_t n, int ycc,
                                     int hs, int vs, uint8_t *out,
                                     int64_t cap, int32_t *info, char *err,
                                     int errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(n));
    if (n_tables > 0) dec.load_tables(tables, static_cast<size_t>(n_tables));
    dec.read_headers();
    info[0] = dec.width;
    info[1] = dec.height;
    info[2] = dec.ncomp;
    dec.check_tiff_sampling(hs, vs);
    if (ycc && dec.ncomp != 3)
      throw Error{"JPEG-in-TIFF: YCbCr with " + std::to_string(dec.ncomp) +
                  " components: PIL refuses it"};
    dec.transform = ycc ? 1 : 0;
    int64_t need = static_cast<int64_t>(dec.width) * dec.height * dec.ncomp;
    if (need > cap) throw Error{"JPEG: the output buffer is too small"};
    dec.decode();
    dec.output(out);
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, std::string("JPEG: ") + e.what());
  }
  return -1;
}

// An old-style JPEG TIFF's stream, as tif_ojpeg.c rebuilds it and hands it
// to libjpeg: `raw` 1 puts out the components as libjpeg's raw_data_out
// does (Decoder::raw_planes; info gets width, height, components, then
// each component's h, v, blocks_w, blocks_h), `raw` 0 as jpeg_read_scanlines
// does with no colour conversion (JCS_UNKNOWN: the components upsampled
// and interleaved); info[19] gets the MCU at which a wrong restart marker
// ended the decoding (Decoder::fail_mcu), info[20] the MCUs a row.  With
// out null, only info is filled.
extern "C" int mods_jpeg_decode_ojpeg(const uint8_t *data, int64_t n, int raw,
                                      uint8_t *out, int64_t cap,
                                      int32_t *info, char *err, int errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.read_headers();
    dec.raw_info(info);
    if (!out) return 0;
    dec.transform = 0;
    dec.strict_restarts = true;
    int64_t need = raw ? dec.raw_size()
                       : static_cast<int64_t>(dec.width) * dec.height *
                             dec.ncomp;
    if (need > cap) throw Error{"JPEG: the output buffer is too small"};
    dec.decode();
    if (raw)
      dec.raw_planes(out);
    else
      dec.output(out);
    info[19] = static_cast<int32_t>(dec.fail_mcu);
    info[20] = dec.mcus_per_row();
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, std::string("JPEG: ") + e.what());
  }
  return -1;
}
