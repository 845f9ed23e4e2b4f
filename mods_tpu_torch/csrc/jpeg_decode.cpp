// JPEG decoder for io/image.py::read_image: Huffman sequential (SOF0,
// SOF1), progressive (SOF2) and lossless (SOF3) files and arithmetic-coded
// sequential (SOF9) and progressive (SOF10) files of 8-bit precision with
// 1, 3 or 4 components, bound with ctypes.
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
//     jdapimin.c) or YCCK (any other transform: jdcolor.c's
//     ycck_cmyk_convert, Y, Cb and Cr to RGB as above, then each of C, M
//     and Y 255 less it, K as stored), each sample inverted as PIL's
//     "CMYK;I" raw mode inverts the Adobe convention.
// A progressive file is decoded as jdphuff.c decodes it (DC first and
// refinement, AC first and refinement with end-of-band runs).  Where its
// coefficients are not all at full precision after the last scan (an
// encoder or a download that stopped early), libjpeg-turbo 3.1's block
// smoothing (jdcoefct.c: smoothing_ok, decompress_smooth_data) estimates
// the low AC coefficients, and the DC where no AC is known, from the 5x5
// neighbourhood of DC values, as PIL's decode does by default.
// Arithmetic-coded scans are jdarith.c's: the QM decoder on jaricom.c's
// jpeg_aritab, DC statistics conditioned by the DAC segment's L and U and
// AC statistics by its Kx, the sequential MCU and the four progressive
// passes, zeros fed once a marker is met, and a bad code (ct = -1)
// leaving the rest of the scan at zero.  A lossless file is jdlossls.c's:
// jdlhuff.c's differences (category 16: 32768), jdpred.c's predictors
// 1-7 undone modulo 2^16 (each scan's, restart interval's and
// out-of-data row's first row from its left neighbour and 2^(7-Pt)), the
// point transform undone by a shift, plain replication for the upsampling
// (jdsample.c takes no fancy upsampling with 1-sample blocks) and no
// colour conversion (libjpeg-turbo refuses one in lossless mode).
// Restart intervals (DRI, RSTn) are honoured.  Hierarchical files (SOF5-7,
// SOF13-15), arithmetic-coded lossless files (SOF11), precisions other
// than 8 bits and 2 components are refused, as PIL refuses them, with a
// message naming the case.
//
// The end of the data follows PIL's rules in mods_jpeg_decode: PIL hands
// libjpeg the file in reads of 64 KiB (ImageFile.MAXBLOCK) through a
// suspending source, and refuses the file ("image file is truncated")
// wherever libjpeg would suspend at its end.  So the Huffman bit reader
// is jdhuff.c's: jpeg_fill_bit_buffer's 57-bit look-ahead
// (MIN_GET_BITS on a 64-bit machine), and decode_mcu_fast's six-byte
// fills for an MCU that starts with 512 bytes a block or more in the
// buffer; an MCU that suspends at the end of one read is decoded again
// with the next.  A progressive or multi-scan file must reach its EOI
// marker (jpeg_start_decompress reads it all); a single-scan file only
// its last MCU, since Pillow ignores jpeg_finish_decompress's
// suspension once every line is out.  An arithmetic-coded scan cannot
// suspend (jdarith.c's get_byte): a byte past PIL's reads so far, or past
// the file's end, is PIL's refusal.  The JPEG-in-TIFF entry points
// keep libtiff's rule instead: the end of the data reads as an EOI
// marker (tif_jpeg.c's std_fill_input_buffer).
//
// Interface: mods_jpeg_info(data, n, info[4], err, errlen) fills width,
// height, channels; mods_jpeg_decode(data, n, jpegmode, out, cap, err,
// errlen) writes (height, width[, channels]) uint8 pixels, jpegmode -1
// where the markers decide the colour space, 0 where Pillow names CMYK
// (BlpImagePlugin's BLP1 JPEG: no YCCK conversion).  Both return 0, or -1
// with a message in err.  mods_jpeg_decode_tiff decodes one strip or tile of a
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

// libjpeg's source would suspend: the decoder needs a byte past the end of
// the data that PIL has handed it
struct Suspend {};
// ... past the end of one of PIL's 64 KiB reads, before the file's end:
// the MCU is decoded again once the next read is in the buffer
struct ReadEnd {};

const size_t kPilRead = 65536;  // ImageFile.MAXBLOCK
const int kMinGetBits = 57;     // jdhuff.h: BIT_BUF_SIZE 64 - 7
const int kFastBytes = 512;     // jdhuff.c: BUFSIZE, a block's worst case

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries for a corrupt run past the end (jutils.c)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jstdhuff.c's std_huff_tables (ITU-T T.81 Annex K.3) as one DHT segment:
// DC and AC table 0 (luminance), DC and AC table 1 (chrominance)
const uint8_t kStdHuffman[] = {
    0xff, 0xc4, 0x01, 0xa2, 0x00, 0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01,
    0x01, 0x01, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x01, 0x02,
    0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a, 0x0b, 0x10, 0x00, 0x02,
    0x01, 0x03, 0x03, 0x02, 0x04, 0x03, 0x05, 0x05, 0x04, 0x04, 0x00, 0x00,
    0x01, 0x7d, 0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31,
    0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33,
    0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43,
    0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73,
    0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa, 0x01, 0x00, 0x03, 0x01,
    0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x01, 0x02, 0x03, 0x04, 0x05, 0x06, 0x07, 0x08, 0x09, 0x0a,
    0x0b, 0x11, 0x00, 0x02, 0x01, 0x02, 0x04, 0x04, 0x03, 0x04, 0x07, 0x05,
    0x04, 0x04, 0x00, 0x01, 0x02, 0x77, 0x00, 0x01, 0x02, 0x03, 0x11, 0x04,
    0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22,
    0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36,
    0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a,
    0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94,
    0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4,
    0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jaricom.c's jpeg_aritab, the QM coder's probability estimation (T.81
// Table D.2): Qe << 16 | the next state after an MPS << 8 | the MPS switch
// << 7 | the next state after an LPS
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

struct Huffman {
  bool present = false;
  int maxcode[18];
  int valoffset[18];
  uint8_t vals[256];
  // jpeg_make_d_derived_tbl's look-ahead: (length << 8) | value for a
  // code of 8 bits or fewer, 9 << 8 for a longer one
  uint16_t lookup[256];
  bool valid = false;  // the derived table's checks
  int max_val = 0;     // the largest symbol: 15 for DC, 16 for lossless
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int width_in_blocks = 0, height_in_blocks = 0;  // of the image's samples
  int blocks_w = 0, blocks_h = 0;                 // allocated: whole MCUs
  int ds_w = 0, ds_h = 0;                         // downsampled size
  int pred = 0;
  int dc_context = 0;  // jdarith.c's DC conditioning category
  // jdpred.c: the next row is undone as a first row (from its left
  // neighbour) after the scan's start, a restart or an out-of-data row
  bool first_row = true;
  int pt = 0;  // the point transform of the scan that coded it
  // jdphuff.c's coef_bits: the precision (Al) each of the first 10
  // coefficients has after the scans so far, -1 before any; and as they
  // were before the component's latest scan
  int coef_bits[10] = {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1};
  int prev_coef_bits[10] = {};
  std::vector<int16_t> coef;  // blocks_h * blocks_w blocks of 64
  // a lossless file's samples before the point transform's shift: rows
  // of blocks_w (blocks of 1 sample)
  std::vector<uint16_t> samp;
  int16_t *block(int by, int bx) {
    return &coef[(static_cast<size_t>(by) * blocks_w + bx) * 64];
  }
};

class Decoder {
 public:
  Decoder(const uint8_t *d, size_t n) : d_(d), n_(n), limit_(n) {
    for (int i = 0; i < 16; i++) {
      dc_l_[i] = 0;
      dc_u_[i] = 1;
      ac_k_[i] = 5;
    }
  }

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
  // Pillow's jpegmode: -1 none (libjpeg guesses the colour space from the
  // markers), else colour()'s value for the space it names
  int jpegmode = -1;
  // PIL's rules for the end of the data (the file header comment);
  // false: libtiff's, where it reads as an EOI marker
  bool pil = false;

  int width = 0, height = 0, ncomp = 0;
  // tif_ojpeg.c's resync_to_restart fails: a restart marker other than
  // the next RSTn ends the decoding at that MCU (fail_mcu, else -1)
  bool strict_restarts = false;
  int64_t fail_mcu = -1;
  int mcus_per_row() const { return mcux_; }

 private:
  const uint8_t *d_;
  size_t n_, pos_ = 0;
  size_t limit_;  // the end of the bytes that PIL's reads have handed over
  uint16_t qt_[4][64] = {};
  bool qt_present_[4] = {};
  Huffman dc_[4], ac_[4];
  Component comp_[4];
  int hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  bool sof_seen_ = false, progressive_ = false;
  bool arith_ = false, lossless_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int colour_ = -1;  // colour() as the first scan found it
  int restart_interval_ = 0;
  // scan state
  int scan_comp_[4] = {}, scan_n_ = 0, ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  int eobrun_ = 0, scans_ = 0, blocks_in_mcu_ = 0;
  bool multi_scan_ = false;
  // jdcoefct.c's last_good_iMCU_row: the last iMCU row at which an MCU
  // was started with data left
  int last_good_row_ = 0;
  // the bit reader (jdhuff.c's bitread state): bits_left_ valid bits at
  // the bottom of gbuf_; unread_marker_ the marker that ended the data,
  // pos_ then at its last 0xFF
  uint64_t gbuf_ = 0;
  int bits_left_ = 0, unread_marker_ = 0;
  size_t marker_end_ = 0;  // the byte after unread_marker_
  bool insufficient_ = false;
  bool fast_ = false, fast_marker_ = false;
  int next_rst_ = 0;
  // jdarith.c: the DAC segment's conditioning (jdmarker.c get_soi's
  // defaults), the statistics bins, the C and A registers and the bit
  // counter (-1 after a bad code), and the bin of probability 0.5
  int dc_l_[16], dc_u_[16], ac_k_[16];
  uint8_t dc_stats_[16][64] = {}, ac_stats_[16][256] = {};
  int64_t ar_c_ = 0, ar_a_ = 0;
  int ar_ct_ = -16;
  uint8_t fixed_bin_ = 113;
  // a read past PIL's reads ends the decoding (arithmetic-coded data)
  bool no_suspend_ = false;

  uint8_t byte() {
    if (pos_ >= n_) {
      if (pil) throw Suspend{};
      throw Error{"JPEG: the file ends inside a header"};
    }
    return d_[pos_++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  // the next byte of entropy-coded data, or -1 where libtiff's source
  // supplies its fake EOI
  int data_byte() {
    if (pos_ >= limit_) {
      if (limit_ < n_) throw ReadEnd{};
      if (pil) throw Suspend{};
      return -1;
    }
    return d_[pos_++];
  }
  void fill(int nbits);
  void fast_fill();
  int peek(int k) const {
    return static_cast<int>((gbuf_ >> (bits_left_ - k)) & ((1u << k) - 1));
  }
  int get_bits(int k) {
    if (k == 0) return 0;
    if (fast_)
      fast_fill();
    else if (bits_left_ < k)
      fill(k);
    bits_left_ -= k;
    return static_cast<int>((gbuf_ >> bits_left_) & ((1u << k) - 1));
  }
  int get_bit() { return get_bits(1); }
  int decode_huff(const Huffman &t);
  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
  void reset_bits() {
    gbuf_ = 0;
    bits_left_ = 0;
  }
  int next_marker();
  void read_restart_marker();
  void process_restart();
  bool restart_strict();
  int arith_decode(uint8_t *st);
  void arith_restart();
  bool arith_dc(Component &c);
  int arith_magnitude(uint8_t *st, int tbl, int k);
  bool arith_block(Component &c, int16_t *blk);
  int colour() const;
  void lossless_checks() const;
  void decode_lossless_scan();
  void undifference(Component &c, int y, const int32_t *diff);

  void read_sof(int marker);
  void read_dht();
  void std_huff_tables();
  void read_dac();
  void misplaced_marker(int m) const;
  void read_dqt();
  void read_sos();
  void read_app(int marker);
  // jdmarker.c skip_variable: a length below 2 skips nothing
  void skip_segment() {
    int len = u16();
    if (len < 2) return;
    if (pos_ + len - 2 > n_) {
      if (pil) throw Suspend{};
      throw Error{"JPEG: a marker segment runs past the end of the file"};
    }
    pos_ += len - 2;
  }
  void decode_scan();
  void decode_mcus();
  void decode_mcu(int mx, int my, int bx, int by);
  void decode_block(Component &c, int16_t *blk);
  bool smoothing_ok(int latch[4][2][10]) const;
  void smooth(Component &c, const int latch[2][10],
              std::vector<int16_t> &out) const;
  void idct_plane(Component &c, std::vector<uint8_t> &plane,
                  const int16_t *coef = nullptr);
};

// jdhuff.c's jpeg_fill_bit_buffer: load bytes until 57 bits are in the
// buffer, a marker ends the data (then zeros, and insufficient_data once
// a code needs them), or the data ends (libjpeg suspends)
void Decoder::fill(int nbits) {
  if (!unread_marker_) {
    while (bits_left_ < kMinGetBits) {
      size_t at = pos_;
      int c = data_byte();
      if (c == 0xFF) {
        do {
          at = pos_ - 1;
          c = data_byte();
        } while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          unread_marker_ = c < 0 ? 0xD9 : c;
          marker_end_ = c < 0 ? n_ : pos_;
          pos_ = c < 0 ? n_ : at;
          break;
        }
      } else if (c < 0) {
        unread_marker_ = 0xD9;
        marker_end_ = pos_ = n_;
        break;
      }
      gbuf_ = (gbuf_ << 8) | static_cast<uint64_t>(c);
      bits_left_ += 8;
    }
    if (!unread_marker_) return;
  }
  if (nbits > bits_left_) {
    insufficient_ = true;
    gbuf_ <<= kMinGetBits - bits_left_;
    bits_left_ = kMinGetBits;
  }
}

// decode_mcu_fast's FILL_BIT_BUFFER_FAST: six bytes once 16 bits or fewer
// are left; a marker among them sends the MCU to the slow path
void Decoder::fast_fill() {
  if (bits_left_ > 16) return;
  for (int i = 0; i < 6; i++) {
    int c0 = d_[pos_++];
    int c1 = pos_ < n_ ? d_[pos_] : 0;
    gbuf_ = (gbuf_ << 8) | static_cast<uint64_t>(c0);
    bits_left_ += 8;
    if (c0 == 0xFF) {
      pos_++;
      if (c1 != 0) {
        fast_marker_ = true;
        pos_ -= 2;
        gbuf_ &= ~static_cast<uint64_t>(0xFF);
      }
    }
  }
}

// HUFF_DECODE (jdhuff.h) and jpeg_huff_decode, or HUFF_DECODE_FAST
int Decoder::decode_huff(const Huffman &t) {
  if (fast_) {
    fast_fill();
    int e = t.lookup[peek(8)];
    int nb = e >> 8, s = e & 0xFF;
    bits_left_ -= nb;
    if (nb > 8) {
      s = static_cast<int>((gbuf_ >> bits_left_) & ((1u << nb) - 1));
      while (s > t.maxcode[nb]) {
        s <<= 1;
        bits_left_ -= 1;
        s |= static_cast<int>((gbuf_ >> bits_left_) & 1);
        nb++;
      }
      s = nb > 16 ? 0 : t.vals[(s + t.valoffset[nb]) & 0xFF];
    }
    return s;
  }
  int l = 1;
  if (bits_left_ < 8) fill(0);
  if (bits_left_ >= 8) {
    int e = t.lookup[peek(8)];
    if ((e >> 8) <= 8) {
      bits_left_ -= e >> 8;
      return e & 0xFF;
    }
    l = 9;
  }
  int code = get_bits(l);
  while (code > t.maxcode[l]) {  // maxcode[17] ends a corrupt code
    code = (code << 1) | get_bits(1);
    l++;
  }
  return l > 16 ? 0 : t.vals[(t.valoffset[l] + code) & 0xFF];
}

// jdmarker.c read_markers: the markers it skips or reads; any other (DHP,
// EXP, JPGn, the reserved 0x02-0xBF) is libjpeg's "Unsupported marker
// type" error
void check_marker(int m) {
  bool known = (m >= 0xC0 && m <= 0xDD) || (m >= 0xE0 && m <= 0xEF) ||
               m == 0xFE || m == 0x01;
  if (!known) {
    char hex[8];
    snprintf(hex, sizeof(hex), "0x%02X", m);
    throw Error{std::string("JPEG: an unsupported marker ") + hex +
                ": PIL refuses it (libjpeg: \"Unsupported marker type\")"};
  }
}

void Decoder::read_sof(int marker) {
  switch (marker) {
    case 0xC0:
    case 0xC1:
      break;
    case 0xC2:
      progressive_ = true;
      break;
    case 0xC3:
      lossless_ = true;
      break;
    case 0xC9:
      arith_ = true;
      break;
    case 0xCA:
      arith_ = progressive_ = true;
      break;
    // jdmarker.c: JERR_SOF_UNSUPPORTED; libjpeg-turbo's lossless mode has
    // no arithmetic decoder (jdmaster.c: JERR_ARITH_NOTIMPL)
    case 0xC5:
    case 0xC6:
    case 0xC7:
    case 0xCD:
    case 0xCE:
    case 0xCF:
      throw Error{"JPEG: a hierarchical (SOF5-7, SOF13-15) file: PIL "
                  "refuses it (libjpeg: \"Unsupported JPEG process\", "
                  "\"broken data stream\")"};
    case 0xCB:
      throw Error{"JPEG: an arithmetic-coded lossless (SOF11) file: PIL "
                  "refuses it (libjpeg-turbo: \"Sorry, arithmetic coding is "
                  "not supported\", \"broken data stream\")"};
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
  if (precision != 8)  // JpegImagePlugin.SOF
    throw Error{"JPEG: " + std::to_string(precision) +
                "-bit precision: PIL refuses it (\"cannot handle " +
                std::to_string(precision) + "-bit layers\")"};
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
  // jdinput.c: blocks of DCTSIZE samples a side, or of 1 (lossless)
  const long du = lossless_ ? 1 : 8;
  mcux_ = static_cast<int>((width + du * hmax_ - 1) / (du * hmax_));
  mcuy_ = static_cast<int>((height + du * vmax_ - 1) / (du * vmax_));
  for (int i = 0; i < ncomp; i++) {
    Component &c = comp_[i];
    if (hmax_ % c.h || vmax_ % c.v)
      throw Error{"JPEG: non-integral sampling ratios are not supported"};
    // jdinput.c: ceil(image size * factor / (max factor * block size))
    c.width_in_blocks = static_cast<int>(
        (static_cast<long>(width) * c.h + du * hmax_ - 1) / (du * hmax_));
    c.height_in_blocks = static_cast<int>(
        (static_cast<long>(height) * c.v + du * vmax_ - 1) / (du * vmax_));
    c.ds_w = static_cast<int>(
        (static_cast<long>(width) * c.h + hmax_ - 1) / hmax_);
    c.ds_h = static_cast<int>(
        (static_cast<long>(height) * c.v + vmax_ - 1) / vmax_);
    c.blocks_w = mcux_ * c.h;
    c.blocks_h = mcuy_ * c.v;
    if (lossless_)
      c.samp.assign(static_cast<size_t>(c.blocks_w) * c.blocks_h, 0);
    else
      c.coef.assign(static_cast<size_t>(c.blocks_w) * c.blocks_h * 64, 0);
  }
}

void Decoder::read_dht() {
  // jdmarker.c get_dht
  int len = u16() - 2;
  while (len > 16) {
    int tc_th = byte();
    int tc = tc_th >> 4, th = tc_th & 15;
    if (tc > 1 || th > 3) throw Error{"JPEG: bad Huffman table id"};
    uint8_t counts[17] = {};
    int total = 0;
    for (int i = 1; i <= 16; i++) {
      counts[i] = byte();
      total += counts[i];
    }
    len -= 17;
    if (total > 256 || total > len)
      throw Error{"JPEG: a bad Huffman table: PIL refuses it (libjpeg: "
                  "\"Bogus Huffman table definition\")"};
    Huffman &t = tc == 0 ? dc_[th] : ac_[th];
    memset(t.vals, 0, sizeof(t.vals));
    for (int i = 0; i < total; i++) t.vals[i] = byte();
    // canonical codes (jdhuff.c jpeg_make_d_derived_tbl), and its checks:
    // no length's codes may run out of its bits, and a DC table's symbols
    // are 0..15
    int code = 0, k = 0, last = 0;
    for (int l = 1; l <= 16; l++)
      if (counts[l]) last = l;
    t.valid = true;
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
      if (l <= last && code >= (1 << l)) t.valid = false;
      code <<= 1;
    }
    t.max_val = 0;
    for (int i = 0; i < total; i++)
      t.max_val = std::max<int>(t.max_val, t.vals[i]);
    t.maxcode[17] = 0x7FFFFFFF;
    for (int look = 0; look < 256; look++) {
      t.lookup[look] = 9 << 8;
      for (int l = 1; l <= 8; l++) {
        int c = look >> (8 - l);
        if (c <= t.maxcode[l]) {
          t.lookup[look] =
              static_cast<uint16_t>((l << 8) | t.vals[(t.valoffset[l] + c) & 0xFF]);
          break;
        }
      }
    }
    t.present = true;
    len -= total;
  }
  if (len != 0) throw Error{"JPEG: bad DHT length"};
}

// jstdhuff.c std_huff_tables, which jdhuff.c's jinit_huff_decoder (not
// the progressive decoder's) runs once the headers up to the first scan
// are read: tables 0 and 1 that no DHT has defined are the standard ones
// (Motion-JPEG frames carry none)
void Decoder::std_huff_tables() {
  Huffman dc[2] = {dc_[0], dc_[1]}, ac[2] = {ac_[0], ac_[1]};
  const uint8_t *d = d_;
  size_t n = n_, pos = pos_;
  bool p = pil;
  d_ = kStdHuffman;
  n_ = sizeof(kStdHuffman);
  pos_ = 2;
  pil = false;
  read_dht();
  d_ = d;
  n_ = n;
  pos_ = pos;
  pil = p;
  for (int i = 0; i < 2; i++) {
    if (dc[i].present) dc_[i] = dc[i];
    if (ac[i].present) ac_[i] = ac[i];
  }
}

// jdmarker.c get_dac: the arithmetic coding conditioning, L and U of a
// DC table (index 0-15), Kx of an AC table (16-31)
void Decoder::read_dac() {
  int len = u16() - 2;
  while (len > 0) {
    int index = byte(), val = byte();
    len -= 2;
    if (index >= 32 || (index < 16 && (val & 15) > (val >> 4)))
      throw Error{"JPEG: a bad DAC segment: PIL refuses it (libjpeg's "
                  "JERR_DAC_INDEX or JERR_DAC_VALUE)"};
    if (index >= 16) {
      ac_k_[index - 16] = val;
    } else {
      dc_l_[index] = val & 15;
      dc_u_[index] = val >> 4;
    }
  }
  if (len != 0) throw Error{"JPEG: bad DAC length"};
}

// jdmarker.c read_markers: a second SOI, and JPG (0xC8) among the frame
// types libjpeg does not decode
void Decoder::misplaced_marker(int m) const {
  if (m == 0xD8)
    throw Error{"JPEG: a second SOI marker: PIL refuses it (libjpeg: "
                "\"Invalid JPEG file structure: two SOI markers\")"};
  if (m == 0xC8)
    throw Error{"JPEG: a JPG (0xC8) marker: PIL refuses it (libjpeg: "
                "\"Unsupported JPEG process\")"};
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
  if (len < 2) return;  // jdmarker.c reads and skips nothing
  if (start + len > n_ && pil) throw Suspend{};
  if (start + len > n_)
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
    comp_[ci].dc_tbl = tables >> 4;  // checked where a scan uses it
    comp_[ci].ac_tbl = tables & 15;
  }
  ss_ = byte();
  se_ = byte();
  int a = byte();
  ah_ = a >> 4;
  al_ = a & 15;
  if (progressive_) {
    // jdphuff.c start_pass_phuff_decoder; a refinement has Al = Ah - 1
    if (ss_ > 63 || se_ > 63 || ss_ > se_ || (ss_ == 0 && se_ != 0) ||
        (ss_ > 0 && scan_n_ != 1) || al_ > 13 || (ah_ && al_ != ah_ - 1))
      throw Error{std::string("JPEG: bad parameters of a progressive ") +
                  (arith_ ? "arithmetic-coded" : "Huffman-coded") +
                  " scan (Ss=" +
                  std::to_string(ss_) + " Se=" + std::to_string(se_) +
                  " Ah=" + std::to_string(ah_) + " Al=" +
                  std::to_string(al_) + "): PIL refuses it (libjpeg: "
                  "\"Invalid progressive/lossless parameters\")"};
  } else if (!lossless_) {  // jdlossls.c checks a lossless scan's
    ss_ = 0;
    se_ = 63;
    ah_ = al_ = 0;
  }
  // jdmarker.c get_sos counts the scan; jdinput.c initial_setup decides
  // at the first whether the file has more; jdphuff.c start_pass_phuff_
  // decoder updates the progression status
  scans_++;
  if (scans_ == 1) multi_scan_ = progressive_ || scan_n_ < ncomp;
  if (!progressive_) return;
  for (int i = 0; i < scan_n_; i++) {
    Component &c = comp_[scan_comp_[i]];
    for (int k = std::min(ss_, 1); k <= std::max(se_, 9) && k < 10; k++)
      c.prev_coef_bits[k] = scans_ > 1 ? c.coef_bits[k] : 0;
    for (int k = ss_; k <= se_ && k < 10; k++) c.coef_bits[k] = al_;
  }
}

// jdmarker.c next_marker: skip to an 0xFF, past fill bytes, and past
// stuffed 0xFF 0x00 pairs; the unread marker that ended a scan's data
// comes first.  At the end of the data libjpeg suspends (PIL's rules) or
// reads libtiff's fake EOI.
int Decoder::next_marker() {
  if (unread_marker_) {
    int m = unread_marker_;
    unread_marker_ = 0;
    pos_ = marker_end_;
    return m;
  }
  auto next = [&]() {
    if (pos_ >= n_) {
      if (pil) throw Suspend{};
      return -1;
    }
    if (pos_ >= limit_ && no_suspend_) throw ReadEnd{};
    while (pos_ >= limit_) limit_ = std::min(n_, limit_ + kPilRead);
    return static_cast<int>(d_[pos_++]);
  };
  while (true) {
    int c = next();
    while (c >= 0 && c != 0xFF) c = next();
    do {
      c = c < 0 ? c : next();
    } while (c == 0xFF);
    if (c < 0) return 0xD9;
    if (c != 0) return c;
  }
}

// jdmarker.c read_restart_marker: read the RSTn marker, with
// jpeg_resync_to_restart's recovery where it is not the expected one
void Decoder::read_restart_marker() {
  int m = next_marker();
  int desired = next_rst_;
  auto rst = [](int k) { return 0xD0 + (k & 7); };
  while (m != rst(desired)) {
    int action;
    if (m < 0xC0)
      action = 2;
    else if (m < 0xD0 || m > 0xD7)
      action = 3;
    else if (m == rst(desired + 1) || m == rst(desired + 2))
      action = 3;
    else if (m == rst(desired - 1) || m == rst(desired - 2))
      action = 2;
    else
      action = 1;
    if (action == 1) break;
    if (action == 3) {  // leave the marker for the scan's end
      unread_marker_ = m;
      marker_end_ = pos_;
      pos_ = pos_ >= 2 ? pos_ - 2 : 0;
      break;
    }
    m = next_marker();
  }
  next_rst_ = (next_rst_ + 1) & 7;
}

// jdhuff.c process_restart: drop the bits left, read the RSTn marker,
// reset the DC predictions and the end-of-band run
void Decoder::process_restart() {
  bits_left_ = 0;
  read_restart_marker();
  for (int i = 0; i < ncomp; i++) comp_[i].pred = 0;
  eobrun_ = 0;
  if (!unread_marker_) insufficient_ = false;
}

// jdmarker.c read_restart_marker with tif_ojpeg.c's resync_to_restart:
// the next marker (next_marker skips the bytes before it) must be the
// next RSTn in turn, or libjpeg's error ends the decoding
bool Decoder::restart_strict() {
  reset_bits();
  unread_marker_ = 0;
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

// jdarith.c arith_decode: one binary decision with statistics bin *st,
// its renormalisation and data input (T.81 D.2.6) reading jdarith.c's
// get_byte; a marker in the data feeds zeros from there on
int Decoder::arith_decode(uint8_t *st) {
  while (ar_a_ < 0x8000) {
    if (--ar_ct_ < 0) {
      int data = 0;
      if (!unread_marker_) {
        size_t at = pos_;
        data = data_byte();
        if (data == 0xFF) {
          do {
            at = pos_ - 1;
            data = data_byte();
          } while (data == 0xFF);
          if (data == 0) {
            data = 0xFF;
          } else {  // a marker, or libtiff's EOI at the data's end
            unread_marker_ = data < 0 ? 0xD9 : data;
            marker_end_ = data < 0 ? n_ : pos_;
            pos_ = data < 0 ? n_ : at;
            data = 0;
          }
        } else if (data < 0) {
          unread_marker_ = 0xD9;
          marker_end_ = pos_ = n_;
          data = 0;
        }
      }
      ar_c_ = (ar_c_ << 8) | data;
      // the first two bytes fill C; then A is 0x10000
      if ((ar_ct_ += 8) < 0 && ++ar_ct_ == 0) ar_a_ = 0x8000;
    }
    ar_a_ <<= 1;
  }
  int sv = *st;
  uint32_t qe = kAritab[sv & 0x7F];
  int nl = qe & 0xFF, nm = (qe >> 8) & 0xFF;
  qe >>= 16;
  int64_t temp = ar_a_ - qe;
  ar_a_ = temp;
  temp <<= ar_ct_;
  if (ar_c_ >= temp) {
    ar_c_ -= temp;
    if (ar_a_ < qe) {  // conditional LPS exchange
      ar_a_ = qe;
      *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
    } else {
      ar_a_ = qe;
      *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
      sv ^= 0x80;
    }
  } else if (ar_a_ < 0x8000) {  // conditional MPS exchange
    if (ar_a_ < qe) {
      *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
      sv ^= 0x80;
    } else {
      *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
    }
  }
  return sv >> 7;
}

// jdarith.c process_restart: the RSTn marker, then the statistics of the
// scan's components and the coder reset
void Decoder::arith_restart() {
  read_restart_marker();
  for (int i = 0; i < scan_n_; i++) {
    Component &c = comp_[scan_comp_[i]];
    if (!progressive_ || (ss_ == 0 && ah_ == 0)) {
      memset(dc_stats_[c.dc_tbl], 0, sizeof(dc_stats_[0]));
      c.pred = c.dc_context = 0;
    }
    if (!progressive_ || ss_)
      memset(ac_stats_[c.ac_tbl], 0, sizeof(ac_stats_[0]));
  }
  ar_c_ = ar_a_ = 0;
  ar_ct_ = -16;
}

// jdarith.c's DC difference (T.81 F.19-F.24), conditioned by the
// previous one's category; c.pred becomes the new DC value modulo 2^16.
// false: a bad code (ct = -1)
bool Decoder::arith_dc(Component &c) {
  const int tbl = c.dc_tbl;
  uint8_t *st = dc_stats_[tbl] + c.dc_context;
  if (arith_decode(st) == 0) {
    c.dc_context = 0;
    return true;
  }
  int sign = arith_decode(st + 1);
  st += 2 + sign;
  int m = arith_decode(st);
  if (m) {
    st = dc_stats_[tbl] + 20;  // X1
    while (arith_decode(st)) {
      if ((m <<= 1) == 0x8000) {
        ar_ct_ = -1;
        return false;
      }
      st++;
    }
  }
  if (m < (1 << dc_l_[tbl]) >> 1)
    c.dc_context = 0;
  else if (m > (1 << dc_u_[tbl]) >> 1)
    c.dc_context = 12 + sign * 4;
  else
    c.dc_context = 4 + sign * 4;
  int v = m;
  st += 14;
  while (m >>= 1)
    if (arith_decode(st)) v |= m;
  v += 1;
  c.pred = (c.pred + (sign ? -v : v)) & 0xFFFF;
  return true;
}

// the sign and magnitude of a non-zero AC coefficient at k, st at its
// SN/SP bin (T.81 F.21-F.24); 0 for a bad code (ct = -1)
int Decoder::arith_magnitude(uint8_t *st, int tbl, int k) {
  int sign = arith_decode(&fixed_bin_);
  st += 2;
  int m = arith_decode(st);
  if (m && arith_decode(st)) {
    m <<= 1;
    st = ac_stats_[tbl] + (k <= ac_k_[tbl] ? 189 : 217);
    while (arith_decode(st)) {
      if ((m <<= 1) == 0x8000) {
        ar_ct_ = -1;
        return 0;
      }
      st++;
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (arith_decode(st)) v |= m;
  v += 1;
  return sign ? -v : v;
}

// one block of an arithmetic-coded scan: jdarith.c decode_mcu (sequential)
// or decode_mcu_DC_first, _AC_first, _DC_refine, _AC_refine; false where
// a bad code ends the MCU
bool Decoder::arith_block(Component &c, int16_t *blk) {
  if (progressive_ && ss_ == 0) {
    if (ah_) {  // DC refinement: the next bit, at probability 0.5
      if (arith_decode(&fixed_bin_))
        blk[0] = static_cast<int16_t>(blk[0] | (1 << al_));
      return true;
    }
    if (!arith_dc(c)) return false;
    blk[0] = static_cast<int16_t>(static_cast<unsigned>(c.pred) << al_);
    return true;
  }
  const int tbl = c.ac_tbl;
  int ss = 1, se = 63, al = 0;
  if (!progressive_) {
    if (!arith_dc(c)) return false;
    blk[0] = static_cast<int16_t>(c.pred);
  } else {
    ss = ss_;
    se = se_;
    al = al_;
  }
  if (!progressive_ || ah_ == 0) {
    for (int k = ss; k <= se; k++) {
      uint8_t *st = ac_stats_[tbl] + 3 * (k - 1);
      if (arith_decode(st)) break;  // end of block
      while (arith_decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {  // spectral overflow
          ar_ct_ = -1;
          return false;
        }
      }
      int v = arith_magnitude(st, tbl, k);
      if (!v) return false;
      blk[kNatural[k]] =
          static_cast<int16_t>(static_cast<unsigned>(v) << al);
    }
    return true;
  }
  // AC refinement: past the previous stage's end of block, an EOB flag
  const int p1 = 1 << al_, m1 = -p1;
  int kex = se_;
  while (kex > 0 && !blk[kNatural[kex]]) kex--;
  for (int k = ss_; k <= se_; k++) {
    uint8_t *st = ac_stats_[tbl] + 3 * (k - 1);
    if (k > kex && arith_decode(st)) break;
    while (true) {
      int16_t *coef = blk + kNatural[k];
      if (*coef) {  // a correction bit
        if (arith_decode(st + 2))
          *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
        break;
      }
      if (arith_decode(st + 1)) {  // newly non-zero
        *coef = static_cast<int16_t>(arith_decode(&fixed_bin_) ? m1 : p1);
        break;
      }
      st += 3;
      if (++k > se_) {
        ar_ct_ = -1;
        return false;
      }
    }
  }
  return true;
}

void Decoder::decode_block(Component &c, int16_t *blk) {
  if (arith_) {
    // a bad code leaves the rest of the scan (to the next restart) alone;
    // a DC refinement has no bad code, and no such check
    if (ar_ct_ == -1 && !(progressive_ && ss_ == 0 && ah_)) return;
    arith_block(c, blk);
    return;
  }
  // decode_scan checked the ids of the tables that this scan uses
  const Huffman &dct = dc_[c.dc_tbl & 3];
  const Huffman &act = ac_[c.ac_tbl & 3];
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
      // a run past the band's end (zeros read after a marker, say) puts
      // the new coefficient at jpeg_natural_order[64], which is 63
      if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
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

// the colour conversion that jdapimin.c's default_decompress_parms picks
// at the first scan: 0 none (gray, RGB or CMYK as stored), 1 YCbCr -> RGB,
// 2 YCCK -> CMYK
int Decoder::colour() const {
  if (transform >= 0) return transform;
  if (jpegmode >= 0) return jpegmode;
  if (ncomp == 4) return adobe_ && adobe_transform_ != 0 ? 2 : 0;
  if (ncomp != 3) return 0;
  if (jfif_) return 1;
  if (adobe_) return adobe_transform_ == 0 ? 0 : 1;
  // the component ids: 'R', 'G', 'B' is RGB; a lossless file is RGB
  // whatever its ids
  bool rgb = comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
  return rgb || lossless_ ? 0 : 1;
}

// jdcolor.c jinit_color_deconverter: no colour conversion in lossless mode
void Decoder::lossless_checks() const {
  const int conv = colour_;
  if (lossless_ && conv)
    throw Error{std::string("JPEG: a lossless (SOF3) file in ") +
                (conv == 1 ? "YCbCr" : "YCCK") +
                " (a JFIF or Adobe marker says so): PIL refuses it "
                "(libjpeg-turbo converts no colour in lossless mode: "
                "\"broken data stream when reading image file\")"};
}

// jdpred.c: row y of component c undone from its differences, modulo 2^16,
// by the scan's predictor (Ss), or as a first row
void Decoder::undifference(Component &c, int y, const int32_t *diff) {
  uint16_t *out = &c.samp[static_cast<size_t>(y) * c.blocks_w];
  const int w = c.width_in_blocks;
  if (c.first_row) {  // jpeg_undifference_first_row
    int ra = (diff[0] + (1 << (7 - al_))) & 0xFFFF;
    out[0] = static_cast<uint16_t>(ra);
    for (int x = 1; x < w; x++) {
      ra = (diff[x] + ra) & 0xFFFF;
      out[x] = static_cast<uint16_t>(ra);
    }
    c.first_row = false;
    return;
  }
  const uint16_t *prev = out - c.blocks_w;
  int rb = prev[0], ra = (diff[0] + rb) & 0xFFFF;
  out[0] = static_cast<uint16_t>(ra);
  for (int x = 1; x < w; x++) {
    int rc = rb, p;
    rb = prev[x];
    switch (ss_) {
      case 1: p = ra; break;
      case 2: p = rb; break;
      case 3: p = rc; break;
      case 4: p = ra + rb - rc; break;
      case 5: p = ra + ((rb - rc) >> 1); break;
      case 6: p = rb + ((ra - rc) >> 1); break;
      default: p = (ra + rb) >> 1; break;
    }
    ra = (diff[x] + p) & 0xFFFF;
    out[x] = static_cast<uint16_t>(ra);
  }
}

// jddiffct.c decompress_data over a lossless scan: iMCU row by iMCU row,
// each MCU row's differences (jdlhuff.c decode_mcus: H x V samples of each
// component an MCU, one sample of a lone component), then each row
// undone and kept with the scan's point transform
void Decoder::decode_lossless_scan() {
  // jdlossls.c start_pass_lossless
  if (ss_ < 1 || ss_ > 7 || se_ != 0 || ah_ != 0 || al_ >= 8)
    throw Error{"JPEG: bad lossless scan parameters (Ss=" +
                std::to_string(ss_) + " Se=" + std::to_string(se_) +
                " Ah=" + std::to_string(ah_) + " Al=" + std::to_string(al_) +
                "): PIL refuses it (libjpeg: \"Invalid progressive/lossless "
                "parameters\")"};
  const bool lone = scan_n_ == 1;
  Component &c0 = comp_[scan_comp_[0]];
  const int per_row = lone ? c0.width_in_blocks : mcux_;
  // jddiffct.c start_input_pass
  if (restart_interval_ % per_row)
    throw Error{"JPEG: a lossless file's restart interval of " +
                std::to_string(restart_interval_) +
                " MCUs is no whole number of MCU rows (" +
                std::to_string(per_row) + " MCUs): PIL refuses it "
                "(libjpeg-turbo: \"Invalid restart interval\")"};
  int rows_to_go = restart_interval_ / per_row;
  auto reset_predictors = [&]() {
    for (int i = 0; i < ncomp; i++) comp_[i].first_row = true;
  };
  reset_predictors();
  // one iMCU row's differences: v rows of blocks_w a component
  std::vector<int32_t> diff[4];
  for (int i = 0; i < scan_n_; i++) {
    Component &c = comp_[scan_comp_[i]];
    c.pt = al_;
    diff[i].assign(static_cast<size_t>(c.v) * c.blocks_w, 0);
  }
  auto rows_of = [&](const Component &c, int r) {
    if (r < mcuy_ - 1) return c.v;
    int last = c.height_in_blocks % c.v;
    return last ? last : c.v;
  };
  auto sample = [&](const Component &c) {
    int s = decode_huff(dc_[c.dc_tbl]);
    if (s == 16) return 32768;
    return s ? extend(get_bits(s), s) : 0;
  };
  for (int r = 0; r < mcuy_; r++) {
    const int mcu_rows = lone ? rows_of(c0, r) : 1;
    for (int y = 0; y < mcu_rows; y++) {
      if (restart_interval_) {
        if (rows_to_go == 0) {
          process_restart();
          reset_predictors();
          rows_to_go = restart_interval_ / per_row;
        }
        rows_to_go--;
      }
      if (insufficient_) {  // out of data: zeros, and first rows again
        for (int i = 0; i < scan_n_; i++) {
          Component &c = comp_[scan_comp_[i]];
          int32_t *d = lone ? &diff[i][static_cast<size_t>(y) * c.blocks_w]
                            : diff[i].data();
          std::fill(d, d + (lone ? c.blocks_w : c.v * c.blocks_w), 0);
        }
        reset_predictors();
        continue;
      }
      for (int mx = 0; mx < per_row; mx++) {
        if (lone) {
          diff[0][static_cast<size_t>(y) * c0.blocks_w + mx] = sample(c0);
          continue;
        }
        for (int i = 0; i < scan_n_; i++) {
          Component &c = comp_[scan_comp_[i]];
          for (int v = 0; v < c.v; v++)
            for (int h = 0; h < c.h; h++)
              diff[i][static_cast<size_t>(v) * c.blocks_w + mx * c.h + h] =
                  sample(c);
        }
      }
    }
    for (int i = 0; i < scan_n_; i++) {
      Component &c = comp_[scan_comp_[i]];
      for (int y = 0; y < rows_of(c, r); y++)
        undifference(c, r * c.v + y,
                     &diff[i][static_cast<size_t>(y) * c.blocks_w]);
    }
  }
}

// PIL's refusal of arithmetic-coded data past what it has handed libjpeg
[[noreturn]] void arith_refusal() {
  throw Error{"JPEG: arithmetic-coded data past the end of the file, or "
              "past one of PIL's 64 KiB reads: PIL refuses it (libjpeg's "
              "arithmetic decoder cannot suspend: \"broken data stream "
              "when reading image file\")"};
}

void Decoder::decode_scan() {
  // jdhuff.c's and jdlhuff.c's start of a pass: the standard tables where
  // none is defined (jdhuff.c only), and the checks of the tables the scan
  // uses (the symbols of a DC table are categories: at most 15, 16
  // lossless)
  if (!arith_) {
    if (scans_ == 1 && !progressive_ && !lossless_) std_huff_tables();
    for (int i = 0; i < scan_n_; i++) {
      Component &c = comp_[scan_comp_[i]];
      bool needs_dc = lossless_ || !progressive_ || (ss_ == 0 && ah_ == 0);
      bool needs_ac = !lossless_ && (!progressive_ || ss_ > 0);
      if ((needs_dc && c.dc_tbl > 3) || (needs_ac && c.ac_tbl > 3))
        throw Error{"JPEG: bad Huffman table id in a scan"};
      if ((needs_dc && !dc_[c.dc_tbl].present) ||
          (needs_ac && !ac_[c.ac_tbl].present))
        throw Error{"JPEG: a scan uses an undefined Huffman table: PIL "
                    "refuses it (libjpeg: \"Huffman table was not "
                    "defined\")"};
      if ((needs_dc && (!dc_[c.dc_tbl].valid ||
                        dc_[c.dc_tbl].max_val > (lossless_ ? 16 : 15))) ||
          (needs_ac && !ac_[c.ac_tbl].valid))
        throw Error{"JPEG: a bad Huffman table: PIL refuses it (libjpeg: "
                    "\"Bogus Huffman table definition\")"};
    }
  }
  for (int i = 0; i < scan_n_; i++) {
    Component &c = comp_[scan_comp_[i]];
    c.pred = 0;
    // jdarith.c start_pass: the statistics of the bins the scan codes
    if (arith_ && (!progressive_ || (ss_ == 0 && ah_ == 0))) {
      memset(dc_stats_[c.dc_tbl], 0, sizeof(dc_stats_[0]));
      c.dc_context = 0;
    }
    if (arith_ && (!progressive_ || ss_))
      memset(ac_stats_[c.ac_tbl], 0, sizeof(ac_stats_[0]));
  }
  // jdinput.c per_scan_setup: an interleaved MCU of at most 10 blocks
  blocks_in_mcu_ = 0;
  for (int i = 0; i < scan_n_; i++)
    blocks_in_mcu_ += comp_[scan_comp_[i]].h * comp_[scan_comp_[i]].v;
  if (scan_n_ > 1 && blocks_in_mcu_ > 10)
    throw Error{"JPEG: an MCU of " + std::to_string(blocks_in_mcu_) +
                " blocks: PIL refuses it (libjpeg: \"Sampling factors too "
                "large for interleaved scan\")"};
  ar_c_ = ar_a_ = 0;
  ar_ct_ = -16;
  eobrun_ = 0;
  reset_bits();
  unread_marker_ = 0;
  insufficient_ = false;
  next_rst_ = 0;
  // the end of PIL's read that holds the scan's first byte.  A
  // progressive or lossless Huffman scan has no fast path, and suspends
  // and resumes alike wherever a read ends, so only the file's end
  // matters there; an arithmetic-coded scan cannot suspend.
  if (!pil || (!arith_ && (progressive_ || lossless_))) {
    limit_ = n_;
  } else {
    while (limit_ < pos_) limit_ += kPilRead;
    limit_ = std::min(limit_, n_);
  }
  if (lossless_) {
    decode_lossless_scan();
    return;
  }
  if (arith_) {
    no_suspend_ = pil;
    try {
      decode_mcus();
    } catch (const ReadEnd &) {
      arith_refusal();
    } catch (const Suspend &) {
      arith_refusal();
    }
    no_suspend_ = false;
    return;
  }
  decode_mcus();
}

void Decoder::decode_mcus() {
  const int blocks_in_mcu = scan_n_ == 1 ? 1 : blocks_in_mcu_;
  int restarts_left = restart_interval_;
  int64_t mcu = -1;
  // decode_mcu, from jdcoefct.c's loop over the MCUs of an iMCU row
  auto next_mcu = [&](int imcu_row, const auto &blocks) {
    mcu++;
    if (!insufficient_) last_good_row_ = imcu_row;
    if (arith_) {
      if (restart_interval_) {
        if (restarts_left == 0) {
          arith_restart();
          restarts_left = restart_interval_;
        }
        restarts_left--;
      }
      blocks();
      return true;
    }
    if (restart_interval_) {
      if (restarts_left == 0) {
        if (strict_restarts) {
          if (!restart_strict()) {
            fail_mcu = mcu;
            return false;
          }
          insufficient_ = false;
        } else {
          process_restart();
        }
        restarts_left = restart_interval_;
      }
      restarts_left--;
    }
    if (insufficient_) return true;
    if (progressive_) {
      blocks();
      return true;
    }
    while (true) {
      size_t pos = pos_, marker_end = marker_end_;
      uint64_t gbuf = gbuf_;
      int bits_left = bits_left_, unread = unread_marker_;
      int preds[4];
      for (int i = 0; i < ncomp; i++) preds[i] = comp_[i].pred;
      auto restore = [&]() {
        pos_ = pos;
        marker_end_ = marker_end;
        gbuf_ = gbuf;
        bits_left_ = bits_left;
        unread_marker_ = unread;
        for (int i = 0; i < ncomp; i++) comp_[i].pred = preds[i];
        fast_ = fast_marker_ = false;
      };
      try {
        if (!restart_interval_ && !unread_marker_ && pos_ <= limit_ &&
            limit_ - pos_ >= static_cast<size_t>(kFastBytes) * blocks_in_mcu) {
          fast_ = true;
          fast_marker_ = false;
          blocks();
          fast_ = false;
          if (!fast_marker_) return true;
          restore();  // decode_mcu_fast met a marker: the slow path
        }
        blocks();
        return true;
      } catch (const ReadEnd &) {
        restore();
        limit_ = std::min(n_, limit_ + kPilRead);
      }
    }
  };
  if (scan_n_ == 1) {
    // non-interleaved: one block an MCU over the component's own blocks
    Component &c = comp_[scan_comp_[0]];
    for (int by = 0; by < c.height_in_blocks; by++)
      for (int bx = 0; bx < c.width_in_blocks; bx++)
        if (!next_mcu(by / c.v, [&]() { decode_block(c, c.block(by, bx)); }))
          return;
  } else {
    for (int my = 0; my < mcuy_; my++)
      for (int mx = 0; mx < mcux_; mx++) {
        auto blocks = [&]() {
          for (int i = 0; i < scan_n_; i++) {
            Component &c = comp_[scan_comp_[i]];
            for (int v = 0; v < c.v; v++)
              for (int h = 0; h < c.h; h++)
                decode_block(c, c.block(my * c.v + v, mx * c.h + h));
          }
        };
        if (!next_mcu(my, blocks)) return;
      }
  }
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
      read_dac();
    } else if (m >= 0xE0 && m <= 0xEF) {
      read_app(m);
    } else if (m == 0xD8 || m == 0xC8) {
      misplaced_marker(m);
    } else if (m == 0xD9 || m == 0xDA) {
      throw Error{"JPEG: no frame header before the first scan"};
    } else if ((m >= 0xD0 && m <= 0xD7) || m == 0x00 || m == 0x01) {
      continue;  // RSTn, TEM, and a stuffed 0xFF 0x00 that next_marker skips
    } else {
      check_marker(m);
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
  // PIL: a single-scan file whose scan is decoded; what follows it is
  // jpeg_finish_decompress's, whose suspension Pillow ignores
  bool finishing = false;
  if (pil) limit_ = 0;  // PIL's reads so far: none
  try {
    while (true) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xDA) {
        if (finishing)
          throw Error{"JPEG: a second scan after a single-scan frame: PIL "
                      "refuses it (libjpeg: \"Didn't expect more than one "
                      "scan\")"};
        read_sos();
        if (scans_ == 1) {  // jpeg_start_decompress
          colour_ = colour();
          lossless_checks();
        }
        decode_scan();
        if (fail_mcu >= 0) break;
        finishing = pil && !multi_scan_;
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
      } else if (m == 0x01) {  // TEM: no segment
        continue;
      } else if (m == 0xCC) {
        read_dac();
      } else if (m == 0xD8 || m == 0xC8) {
        misplaced_marker(m);
      } else {
        check_marker(m);
        skip_segment();
      }
    }
    // JpegImagePlugin._open walks the markers to the first SOS
    if (pil && scans_ == 0)
      throw Error{"JPEG: no scan before the EOI marker: PIL cannot "
                  "identify the file"};
  } catch (const Suspend &) {
    if (finishing) return;
    throw Error{"JPEG: the file is truncated (libjpeg runs out of data "
                "before the image's end): PIL refuses it (\"image file is "
                "truncated\")"};
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

// jdcoefct.c's decompress_smooth_data (libjpeg-turbo 3.1): each block's
// first AC coefficients that are still zero and not known to full
// precision are estimated from the DC values of its 5x5 neighbourhood
// (rows and columns past the image's edge repeat the last), and where no
// AC coefficient is known at all (change_dc) the DC too.  iMCU rows past
// the one where the last scan's data ran out take the precisions from
// before that scan.  `latch` holds coef_bits then prev_coef_bits as
// smoothing_ok latches them; the smoothed blocks go to `out`.
void Decoder::smooth(Component &c, const int latch[2][10],
                     std::vector<int16_t> &out) const {
  const uint16_t *q = qt_[c.tq];
  const int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9],
                Q02 = q[2], Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
  const int last_row = mcuy_ - 1;
  const int last_col = c.width_in_blocks - 1;
  const int16_t *coef = c.coef.data();
  auto dc = [&](int by, int bx) {
    return static_cast<int>(coef[(static_cast<size_t>(by) * c.blocks_w + bx) * 64]);
  };
  auto estimate = [](int64_t num, int64_t Qk, int Al, bool clamp) {
    int64_t pred;
    if (num >= 0) {
      pred = ((Qk << 7) + num) / (Qk << 8);
      if (clamp && Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
    } else {
      pred = ((Qk << 7) - num) / (Qk << 8);
      if (clamp && Al > 0 && pred >= (1 << Al)) pred = (1 << Al) - 1;
      pred = -pred;
    }
    return static_cast<int16_t>(pred);
  };
  for (int r = 0; r <= last_row; r++) {
    int block_rows = c.v;
    if (r == last_row) {
      block_rows = c.height_in_blocks % c.v;
      if (block_rows == 0) block_rows = c.v;
    }
    const int *bits = latch[r > last_good_row_ ? 1 : 0];
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc = change_dc && bits[k] == -1;
    // as libjpeg counts them: block_rows of the iMCU row being put out
    int image_block_rows = block_rows * mcuy_;
    for (int br = 0; br < block_rows; br++) {
      int ibr = r * block_rows + br;
      int by = r * c.v + br;
      int prev = ibr > 0 ? by - 1 : by;
      int pprev = ibr > 1 ? by - 2 : prev;
      int next = ibr < image_block_rows - 1 ? by + 1 : by;
      int nnext = ibr < image_block_rows - 2 ? by + 2 : next;
      const int rows[5] = {pprev, prev, by, next, nnext};
      // the sliding registers DC01..DC25, row by row: D[row][col]
      int D[5][5];
      for (int i = 0; i < 5; i++)
        for (int j = 0; j < 5; j++) D[i][j] = dc(rows[i], 0);
      for (int bx = 0; bx <= last_col; bx++) {
        int16_t *w = &out[(static_cast<size_t>(by) * c.blocks_w + bx) * 64];
        for (int i = 0; i < 5; i++)
          for (int j = 0; j < 5; j++)
            D[i][j] = dc(rows[i], std::min(last_col, std::max(0, bx + j - 2)));
        const int DC01 = D[0][0], DC02 = D[0][1], DC03 = D[0][2],
                  DC04 = D[0][3], DC05 = D[0][4], DC06 = D[1][0],
                  DC07 = D[1][1], DC08 = D[1][2], DC09 = D[1][3],
                  DC10 = D[1][4], DC11 = D[2][0], DC12 = D[2][1],
                  DC13 = D[2][2], DC14 = D[2][3], DC15 = D[2][4],
                  DC16 = D[3][0], DC17 = D[3][1], DC18 = D[3][2],
                  DC19 = D[3][3], DC20 = D[3][4], DC21 = D[4][0],
                  DC22 = D[4][1], DC23 = D[4][2], DC24 = D[4][3],
                  DC25 = D[4][4];
        int Al;
        if ((Al = bits[1]) != 0 && w[1] == 0)  // AC01
          w[1] = estimate(
              Q00 * (change_dc
                         ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 +
                            13 * DC07 - 13 * DC09 + 3 * DC10 - 3 * DC11 +
                            38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 +
                            13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                            DC24 + DC25)
                         : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)),
              Q01, Al, true);
        if ((Al = bits[2]) != 0 && w[8] == 0)  // AC10
          w[8] = estimate(
              Q00 * (change_dc
                         ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 -
                            DC06 + 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 +
                            DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 +
                            DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                         : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)),
              Q10, Al, true);
        if ((Al = bits[3]) != 0 && w[16] == 0)  // AC20
          w[16] = estimate(
              Q00 * (change_dc
                         ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 -
                            5 * DC12 - 14 * DC13 - 5 * DC14 + 2 * DC17 +
                            7 * DC18 + 2 * DC19 + DC23)
                         : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 -
                            DC23)),
              Q20, Al, true);
        if ((Al = bits[4]) != 0 && w[9] == 0)  // AC11
          w[9] = estimate(
              Q00 * (change_dc
                         ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                            9 * DC19 + DC21 - DC25)
                         : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 -
                            DC20 + DC22 - DC24 + DC04 - DC06 + 10 * DC07 -
                            10 * DC09)),
              Q11, Al, true);
        if ((Al = bits[5]) != 0 && w[2] == 0)  // AC02
          w[2] = estimate(
              Q00 * (change_dc
                         ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 +
                            7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
                            2 * DC17 - 5 * DC18 + 2 * DC19)
                         : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 -
                            DC15)),
              Q02, Al, true);
        if (change_dc) {
          if ((Al = bits[6]) != 0 && w[3] == 0)  // AC03
            w[3] = estimate(
                Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03,
                Al, true);
          if ((Al = bits[7]) != 0 && w[10] == 0)  // AC12
            w[10] = estimate(
                Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12,
                Al, true);
          if ((Al = bits[8]) != 0 && w[17] == 0)  // AC21
            w[17] = estimate(
                Q00 * (DC07 - 3 * DC12 + DC17 - DC09 + 3 * DC14 - DC19), Q21,
                Al, true);
          if ((Al = bits[9]) != 0 && w[24] == 0)  // AC30
            w[24] = estimate(
                Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30,
                Al, true);
          // coef_bits[0] is non-negative: smoothing_ok checked it
          w[0] = estimate(
              Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                     6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                     8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 -
                     8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                     6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                     2 * DC25),
              Q00, 0, false);
        }
        for (int i = 0; i < 5; i++)
          for (int j = 0; j < 4; j++) D[i][j] = D[i][j + 1];
      }
    }
  }
}

// jdcoefct.c's smoothing_ok: a progressive file whose components all have
// some DC bits and non-zero quantizers for the 10 coefficients smoothed,
// and one of whose first 9 AC coefficients is not at full precision
bool Decoder::smoothing_ok(int latch[4][2][10]) const {
  if (!progressive_) return false;
  bool useful = false;
  for (int i = 0; i < ncomp; i++) {
    const Component &c = comp_[i];
    if (!qt_present_[c.tq]) return false;
    const uint16_t *q = qt_[c.tq];
    for (int k : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
      if (q[k] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    latch[i][0][0] = c.coef_bits[0];
    for (int k = 1; k < 10; k++) {
      latch[i][1][k] = scans_ > 1 ? c.prev_coef_bits[k] : -1;
      latch[i][0][k] = c.coef_bits[k];
      if (c.coef_bits[k] != 0) useful = true;
    }
  }
  return useful;
}

void Decoder::idct_plane(Component &c, std::vector<uint8_t> &plane,
                         const int16_t *coef) {
  if (!qt_present_[c.tq])
    throw Error{"JPEG: a component uses an undefined quantization table"};
  if (!coef) coef = c.coef.data();
  int stride = c.blocks_w * 8;
  plane.assign(static_cast<size_t>(stride) * c.blocks_h * 8, 0);
  for (int by = 0; by < c.blocks_h; by++)
    for (int bx = 0; bx < c.blocks_w; bx++)
      idct_islow(coef + (static_cast<size_t>(by) * c.blocks_w + bx) * 64,
                 qt_[c.tq],
                 &plane[static_cast<size_t>(by) * 8 * stride + bx * 8],
                 stride);
}

// jdsample.c: one component's (ds_h, ds_w) samples of a plane with row
// stride `stride` -> (vmax/v * ds_h, hmax/h * ds_w) samples.  Rows above
// the first and below the last repeat them, as jdmainct.c's context rows
// do at the image's top and bottom.  Without `fancy` (a lossless file),
// every ratio replicates.
std::vector<uint8_t> upsample(const std::vector<uint8_t> &plane, int stride,
                              int ds_w, int ds_h, int rh, int rv, bool fancy,
                              int &out_w) {
  out_w = ds_w * rh;
  int out_h = ds_h * rv;
  std::vector<uint8_t> out(static_cast<size_t>(out_w) * out_h);
  auto row = [&](int y) {
    y = y < 0 ? 0 : (y >= ds_h ? ds_h - 1 : y);
    return &plane[static_cast<size_t>(y) * stride];
  };
  if (fancy && rh == 2 && rv == 1 && ds_w > 2) {  // h2v1_fancy_upsample
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
  } else if (fancy && rh == 2 && rv == 2 && ds_w > 2) {
    // h2v2_fancy_upsample
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
  } else if (fancy && rh == 1 && rv == 2) {  // h1v2_fancy_upsample
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
  const int conv = colour_ >= 0 ? colour_ : colour();
  std::vector<uint8_t> planes[4];
  int widths[4];
  int latch[4][2][10];
  bool smoothing = !lossless_ && smoothing_ok(latch);
  for (int i = 0; i < ncomp; i++) {
    Component &c = comp_[i];
    std::vector<uint8_t> plane;
    int stride = c.blocks_w * 8;
    if (lossless_) {  // jdlossls.c's scaler: the samples << Pt, 8 bits
      stride = c.blocks_w;
      plane.resize(c.samp.size());
      for (size_t k = 0; k < plane.size(); k++)
        plane[k] = static_cast<uint8_t>(c.samp[k] << c.pt);
    } else if (smoothing) {
      std::vector<int16_t> smoothed(c.coef);
      smooth(c, latch[i], smoothed);
      idct_plane(c, plane, smoothed.data());
    } else {
      idct_plane(c, plane);
    }
    planes[i] = upsample(plane, stride, c.ds_w, c.ds_h, hmax_ / c.h,
                         vmax_ / c.v, !lossless_, widths[i]);
  }
  if (ncomp == 1) {
    for (int y = 0; y < height; y++)
      memcpy(out + static_cast<size_t>(y) * width,
             &planes[0][static_cast<size_t>(y) * widths[0]], width);
    return;
  }
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
  // ycc_rgb_convert's R, G, B of a pixel
  auto rgb = [&](int Y, int cb, int cr, uint8_t *o) {
    o[0] = clamp(Y + cr_r[cr]);
    o[1] = clamp(Y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> kScale));
    o[2] = clamp(Y + cb_b[cb]);
  };
  const int nc = ncomp;
  for (int y = 0; y < height; y++) {
    const uint8_t *p[4];
    for (int k = 0; k < nc; k++)
      p[k] = &planes[k][static_cast<size_t>(y) * widths[k]];
    uint8_t *o = out + static_cast<size_t>(y) * width * nc;
    for (int x = 0; x < width; x++, o += nc) {
      if (conv == 0) {
        for (int k = 0; k < nc; k++) o[k] = p[k][x];
      } else {
        // YCbCr -> RGB; YCCK -> CMYK is 255 less that, K as stored
        rgb(p[0][x], p[1][x], p[2][x], o);
        if (nc == 4) {
          for (int k = 0; k < 3; k++) o[k] = static_cast<uint8_t>(255 - o[k]);
          o[3] = p[3][x];
        }
      }
      // PIL's "CMYK;I": the Adobe convention inverted
      if (nc == 4 && transform < 0)
        for (int k = 0; k < 4; k++) o[k] = static_cast<uint8_t>(255 - o[k]);
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

extern "C" int mods_jpeg_decode(const uint8_t *data, int64_t n, int jpegmode,
                                uint8_t *out, int64_t cap, char *err,
                                int errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.jpegmode = jpegmode;
    dec.read_headers();
    int64_t need = static_cast<int64_t>(dec.width) * dec.height * dec.ncomp;
    if (need > cap) throw Error{"JPEG: the output buffer is too small"};
    dec.pil = true;
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
