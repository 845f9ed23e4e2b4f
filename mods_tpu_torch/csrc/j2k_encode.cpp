// JPEG 2000 encoder for io/image.py::save_image, bound with ctypes.
//
// It writes the bytes of PIL's default save, Image.fromarray(a).save(path)
// with a .j2k or .jp2 path: Pillow 12.1.0's Jpeg2KEncode.c drives OpenJPEG
// 2.5.4's encoder with no options, which gives
//   - one tile the size of the image, one quality layer that holds every
//     coding pass (lossless: rate 0), the reversible 5/3 wavelet, no
//     component transform (MCT 0, RGB too), LRCP, 64x64 code-blocks, the
//     default precincts (2^15), no SOP, EPH or PLT;
//   - Pillow's number of resolutions: 6, less one while a side of the
//     image is below 2^(resolutions - 1);
//   - the main header SOC, SIZ, COD, QCD (no quantisation, 2 guard bits,
//     each band's exponent the precision plus its gain), COM ("Created by
//     OpenJPEG version 2.5.4"), then SOT (TNsot 1), SOD, the packets, EOC;
//   - for .jp2 the boxes jP, ftyp, jp2h (ihdr, colr with enumcs 17 for
//     grey and 16 for sRGB, cdef where the last component is alpha) and
//     jp2c around the codestream.
// The steps are OpenJPEG's: the DC level shift, the forward 5/3 lifting
// (dwt.c, vertical pass first, symmetric extension), tier-1 (t1.c: the
// magnitudes shifted by T1_NMSEDEC_FRACBITS, the significance, refinement
// and cleanup passes with the contexts that j2k_decode.cpp's T1 reads,
// the MQ coder of mqc.c with its byte-out, bit stuffing and flush, the
// last pass's rate), the rate allocation of tcd.c for a lossless layer
// (every pass, thresh -1) and tier-2 (t2.c,
// tgt.c, bio.c: tag trees, the number-of-passes and comma codes, 0xFF
// stuffing in the header, a header for every packet).
//
// Interface: mods_j2k_encode(planes, width, height, ncomp, prec, jp2, out,
// cap, err, errlen): ncomp planes of width x height samples (uint8 for
// precision 8, uint16 for 16), in PIL's channel order, the last of 2 or 4
// components alpha.  It returns the file's length, having copied it to
// out when it fits in cap bytes (otherwise the caller asks again with that
// room), or -1 with a message in err.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <exception>
#include <mutex>
#include <string>
#include <system_error>
#include <thread>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string &msg) { throw Error{msg}; }

void set_error(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) snprintf(err, static_cast<size_t>(errlen), "%s",
                                  msg.c_str());
}

inline int32_t ceildivpow2(int64_t a, int b) {
  return static_cast<int32_t>((a + (int64_t(1) << b) - 1) >> b);
}
inline int32_t floorlog2(uint32_t a) {
  int32_t l = 0;
  while (a > 1) {
    a >>= 1;
    ++l;
  }
  return l;
}

const char kComment[] = "Created by OpenJPEG version 2.5.4";
const uint32_t kCblkExp = 6;       // 64 x 64 code-blocks
const uint32_t kPrecinctExp = 15;  // OpenJPEG's default precincts
const uint32_t kGuardBits = 2;
const int kFracBits = 6;  // T1_NMSEDEC_FRACBITS

// ---------------------------------------------------------------------------
// output

struct Writer {
  std::vector<uint8_t> b;
  void u8(uint32_t v) { b.push_back(static_cast<uint8_t>(v)); }
  void u16(uint32_t v) {
    u8(v >> 8);
    u8(v);
  }
  void u32(uint32_t v) {
    u16(v >> 16);
    u16(v);
  }
  void bytes(const void *p, size_t n) {
    const uint8_t *q = static_cast<const uint8_t *>(p);
    b.insert(b.end(), q, q + n);
  }
};

// ---------------------------------------------------------------------------
// tile geometry (OpenJPEG's tcd.c for this one tile at the origin)

struct TagTree {
  struct Node {
    int32_t parent = -1, value = 999, low = 0;
    bool known = false;
  };
  std::vector<Node> nodes;
  void build(uint32_t w, uint32_t h) {
    nodes.clear();
    if (w == 0 || h == 0) return;
    std::vector<uint32_t> ws{w}, hs{h};
    while (ws.back() > 1 || hs.back() > 1) {
      ws.push_back((ws.back() + 1) / 2);
      hs.push_back((hs.back() + 1) / 2);
    }
    std::vector<uint32_t> base(ws.size());
    uint32_t total = 0;
    for (size_t l = 0; l < ws.size(); ++l) {
      base[l] = total;
      total += ws[l] * hs[l];
    }
    nodes.assign(total, Node());
    for (size_t l = 0; l + 1 < ws.size(); ++l)
      for (uint32_t j = 0; j < hs[l]; ++j)
        for (uint32_t i = 0; i < ws[l]; ++i)
          nodes[base[l] + j * ws[l] + i].parent =
              static_cast<int32_t>(base[l + 1] + (j / 2) * ws[l + 1] + i / 2);
  }
  // opj_tgt_setvalue
  void setvalue(uint32_t leaf, int32_t value) {
    int32_t n = static_cast<int32_t>(leaf);
    while (n >= 0 && nodes[n].value > value) {
      nodes[n].value = value;
      n = nodes[n].parent;
    }
  }
};

// The one layer holds every pass of every code-block (opj_tcd_makelayer
// with thresh -1), so only the last pass's rate reaches the file.
struct Cblk {
  int32_t x0, y0, x1, y1;  // in the band
  uint32_t numbps = 0, numpasses = 0;
  std::vector<uint8_t> data;  // the passes' bytes
};

struct Precinct {
  uint32_t cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

// The tile starts at the origin, so every resolution and band does too:
// each is its width and height.
struct Band {
  uint32_t bandno;
  int32_t w, h;
  int32_t numbps;
  std::vector<Precinct> precincts;
  bool empty() const { return w == 0 || h == 0; }
};

struct Resolution {
  int32_t w, h;
  uint32_t pw, ph;
  std::vector<Band> bands;
};

struct TileComp {
  int32_t w, h;
  uint32_t numres;
  std::vector<Resolution> res;
  std::vector<int32_t> data;
};

void init_tilecomp(TileComp &tc, int32_t w, int32_t h, uint32_t numres,
                   uint32_t prec) {
  tc.w = w;
  tc.h = h;
  tc.numres = numres;
  tc.res.assign(numres, Resolution());
  for (uint32_t resno = 0; resno < numres; ++resno) {
    Resolution &res = tc.res[resno];
    int level = static_cast<int>(numres - 1 - resno);
    res.w = ceildivpow2(w, level);
    res.h = ceildivpow2(h, level);
    res.pw = static_cast<uint32_t>(ceildivpow2(res.w, kPrecinctExp));
    res.ph = static_cast<uint32_t>(ceildivpow2(res.h, kPrecinctExp));
    // precincts of the bands: a resolution's, halved above resolution 0
    uint32_t cbg = resno == 0 ? kPrecinctExp : kPrecinctExp - 1;
    uint32_t cb = std::min(kCblkExp, cbg);
    res.bands.assign(resno == 0 ? 1 : 3, Band());
    for (uint32_t b = 0; b < res.bands.size(); ++b) {
      Band &band = res.bands[b];
      if (resno == 0) {
        band.bandno = 0;
        band.w = res.w;
        band.h = res.h;
      } else {
        band.bandno = b + 1;
        int64_t x0b = band.bandno & 1, y0b = band.bandno >> 1;
        band.w = ceildivpow2(w - (x0b << level), level + 1);
        band.h = ceildivpow2(h - (y0b << level), level + 1);
      }
      // reversible: the step 1 of opj_dwt_calc_explicit_stepsizes gives
      // the exponent prec + gain (LL 0, HL and LH 1, HH 2)
      int32_t gain = band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
      band.numbps = static_cast<int32_t>(prec) + gain +
                    static_cast<int32_t>(kGuardBits) - 1;
      uint32_t nprec = res.pw * res.ph;
      band.precincts.assign(nprec, Precinct());
      for (uint32_t p = 0; p < nprec; ++p) {
        Precinct &pr = band.precincts[p];
        // the precinct's part of the band, cut into code-blocks (a
        // precinct's side is a multiple of a code-block's)
        int32_t px0 = static_cast<int32_t>(p % res.pw) << cbg;
        int32_t py0 = static_cast<int32_t>(p / res.pw) << cbg;
        int32_t px1 = std::min(px0 + (1 << cbg), band.w);
        int32_t py1 = std::min(py0 + (1 << cbg), band.h);
        if (px0 < px1 && py0 < py1) {
          pr.cw = static_cast<uint32_t>(ceildivpow2(px1 - px0, cb));
          pr.ch = static_cast<uint32_t>(ceildivpow2(py1 - py0, cb));
        }
        uint32_t ncb = pr.cw * pr.ch;
        pr.cblks.assign(ncb, Cblk());
        for (uint32_t k = 0; k < ncb; ++k) {
          Cblk &c = pr.cblks[k];
          c.x0 = px0 + (static_cast<int32_t>(k % pr.cw) << cb);
          c.y0 = py0 + (static_cast<int32_t>(k / pr.cw) << cb);
          c.x1 = std::min(c.x0 + (1 << cb), px1);
          c.y1 = std::min(c.y0 + (1 << cb), py1);
        }
        pr.incl.build(pr.cw, pr.ch);
        pr.imsb.build(pr.cw, pr.ch);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// forward wavelet (OpenJPEG's dwt.c, the reversible 5/3)

// One line of n samples whose first coordinate is even: the low-pass
// samples then the high-pass ones (opj_dwt_encode_and_deinterleave_h_one_row
// with even set; a line of one sample is left as it is).
void fdwt53_line(int32_t *a, int32_t n, std::vector<int32_t> &tmp) {
  if (n < 2) return;
  const int32_t sn = (n + 1) >> 1, dn = n - sn;
  tmp.resize(static_cast<size_t>(n));
  int32_t *d = tmp.data() + sn;
  int32_t i;
  for (i = 0; i < sn - 1; ++i)
    d[i] = a[2 * i + 1] - ((a[2 * i] + a[2 * i + 2]) >> 1);
  if (n % 2 == 0) d[i] = a[2 * i + 1] - a[2 * i];
  a[0] += (d[0] + d[0] + 2) >> 2;
  for (i = 1; i < dn; ++i) a[i] = a[2 * i] + ((d[i - 1] + d[i] + 2) >> 2);
  if (n % 2 == 1) a[i] = a[2 * i] + ((d[i - 1] + d[i - 1] + 2) >> 2);
  std::memcpy(a + sn, d, sizeof(int32_t) * static_cast<size_t>(dn));
}

// opj_dwt_encode: from the full resolution down, each level's columns
// (vertical pass) and then its rows, low-pass first in place.
void fdwt53(TileComp &tc) {
  const int32_t w = tc.w;
  std::vector<int32_t> col, tmp;
  for (uint32_t r = tc.numres - 1; r >= 1; --r) {
    const int32_t rw = tc.res[r].w, rh = tc.res[r].h;
    col.resize(static_cast<size_t>(rh));
    for (int32_t i = 0; i < rw; ++i) {
      for (int32_t j = 0; j < rh; ++j) col[j] = tc.data[(size_t)j * w + i];
      fdwt53_line(col.data(), rh, tmp);
      for (int32_t j = 0; j < rh; ++j) tc.data[(size_t)j * w + i] = col[j];
    }
    for (int32_t j = 0; j < rh; ++j)
      fdwt53_line(&tc.data[(size_t)j * w], rw, tmp);
  }
}

// ---------------------------------------------------------------------------
// tier 1 (OpenJPEG's t1.c, mqc.c)

struct MqState {
  uint16_t qe;
  uint8_t nmps, nlps, sw;
};

const MqState kMq[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

enum { CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18 };

// The MQ encoder.  buf[0] is the byte before the code-block's first byte
// (opj_mqc_init_enc points bp there; it holds 0).
struct MqEncoder {
  std::vector<uint8_t> buf;
  size_t bp = 0;
  uint32_t a = 0, c = 0, ct = 0;
  uint8_t state[19], mps[19];

  void resetstates() {
    for (int i = 0; i < 19; ++i) state[i] = mps[i] = 0;
    state[CTX_UNI] = 46;
    state[CTX_AGG] = 3;
    state[CTX_ZC] = 4;
  }
  void init(size_t room) {
    buf.assign(room + 1, 0);
    a = 0x8000;
    c = 0;
    bp = 0;
    ct = 12;
  }
  void put(size_t at, uint32_t v) {
    if (at >= buf.size()) buf.resize(std::max(buf.size() * 2, at + 1), 0);
    buf[at] = static_cast<uint8_t>(v);
  }
  void byteout() {
    if (buf[bp] == 0xff) {
      put(++bp, c >> 20);
      c &= 0xfffff;
      ct = 7;
    } else if ((c & 0x8000000) == 0) {
      put(++bp, c >> 19);
      c &= 0x7ffff;
      ct = 8;
    } else {
      buf[bp]++;
      if (buf[bp] == 0xff) {
        c &= 0x7ffffff;
        put(++bp, c >> 20);
        c &= 0xfffff;
        ct = 7;
      } else {
        put(++bp, c >> 19);
        c &= 0x7ffff;
        ct = 8;
      }
    }
  }
  void renorm() {
    do {
      a <<= 1;
      c <<= 1;
      if (--ct == 0) byteout();
    } while ((a & 0x8000) == 0);
  }
  void encode(int cx, uint32_t d) {
    const MqState &s = kMq[state[cx]];
    a -= s.qe;
    if (d == mps[cx]) {  // opj_mqc_codemps
      if ((a & 0x8000) == 0) {
        if (a < s.qe)
          a = s.qe;
        else
          c += s.qe;
        state[cx] = s.nmps;
        renorm();
      } else {
        c += s.qe;
      }
    } else {  // opj_mqc_codelps
      if (a < s.qe)
        c += s.qe;
      else
        a = s.qe;
      if (s.sw) mps[cx] = static_cast<uint8_t>(1 - mps[cx]);
      state[cx] = s.nlps;
      renorm();
    }
  }
  // opj_mqc_flush: SETBITS, two byte-outs, and a last 0xFF left out
  void flush() {
    uint32_t tempc = c + a;
    c |= 0xffff;
    if (c >= tempc) c -= 0x8000;
    c <<= ct;
    byteout();
    c <<= ct;
    byteout();
    if (buf[bp] != 0xff) bp++;
  }
  // opj_mqc_numbytes: bytes from the code-block's first one
  uint32_t numbytes() const { return static_cast<uint32_t>(bp - 1); }
};

// flag bits of one sample, with a border of one around the code-block
enum : uint32_t {
  NB_NW = 1u << 0, NB_N = 1u << 1, NB_NE = 1u << 2, NB_W = 1u << 3,
  NB_E = 1u << 4, NB_SW = 1u << 5, NB_S = 1u << 6, NB_SE = 1u << 7,
  NEG_N = 1u << 8, NEG_S = 1u << 9, NEG_W = 1u << 10, NEG_E = 1u << 11,
  F_SIG = 1u << 12, F_VISIT = 1u << 13, F_REFINED = 1u << 14,
  F_NEG = 1u << 15
};

struct Luts {
  uint8_t zc[4][256];
  uint8_t sc[256];   // context, from NB_N, NB_S, NB_W, NB_E and their signs
  uint8_t spb[256];  // the bit that flips the coded sign
  Luts() {
    for (uint32_t orient = 0; orient < 4; ++orient)
      for (uint32_t f = 0; f < 256; ++f) {
        int hc = !!(f & NB_W) + !!(f & NB_E);
        int vc = !!(f & NB_N) + !!(f & NB_S);
        int dc = !!(f & NB_NW) + !!(f & NB_NE) + !!(f & NB_SW) +
                 !!(f & NB_SE);
        if (orient == 1) std::swap(hc, vc);  // HL: vertical neighbours first
        int n;
        if (orient == 3) {
          int hv = hc + vc;
          if (dc >= 3)
            n = 8;
          else if (dc == 2)
            n = hv >= 1 ? 7 : 6;
          else if (dc == 1)
            n = hv >= 2 ? 5 : hv == 1 ? 4 : 3;
          else
            n = hv >= 2 ? 2 : hv == 1 ? 1 : 0;
        } else if (hc == 2) {
          n = 8;
        } else if (hc == 1) {
          n = vc >= 1 ? 7 : dc >= 1 ? 6 : 5;
        } else if (vc == 2) {
          n = 4;
        } else if (vc == 1) {
          n = 3;
        } else {
          n = dc >= 2 ? 2 : dc == 1 ? 1 : 0;
        }
        zc[orient][f] = static_cast<uint8_t>(CTX_ZC + n);
      }
    // index: bits 0-3 significance of N, S, W, E; bits 4-7 their signs
    for (uint32_t k = 0; k < 256; ++k) {
      auto con = [&](int bit) {
        return (k >> bit & 1) ? ((k >> (bit + 4) & 1) ? -1 : 1) : 0;
      };
      int vcon = con(0) + con(1), hcon = con(2) + con(3);
      hcon = std::max(-1, std::min(1, hcon));
      vcon = std::max(-1, std::min(1, vcon));
      uint8_t flip = 0;
      if (hcon < 0 || (hcon == 0 && vcon < 0)) {
        flip = 1;
        hcon = -hcon;
        vcon = -vcon;
      }
      int ctx = hcon == 0 ? CTX_SC + (vcon != 0 ? 1 : 0)
                          : (vcon == 1 ? 13 : vcon == 0 ? 12 : 11);
      sc[k] = static_cast<uint8_t>(ctx);
      spb[k] = flip;
    }
  }
};

const Luts &luts() {
  static const Luts l;
  return l;
}

struct T1 {
  int w = 0, h = 0, sw = 0;
  std::vector<uint32_t> mag;    // h x w magnitudes << kFracBits
  std::vector<uint32_t> flags;  // (h + 2) x (w + 2)
  MqEncoder mqc;

  inline int at(int x, int y) const { return (y + 1) * sw + (x + 1); }
  static uint32_t sc_index(uint32_t f) {
    return ((f & NB_N) ? 1u : 0u) | ((f & NB_S) ? 2u : 0u) |
           ((f & NB_W) ? 4u : 0u) | ((f & NB_E) ? 8u : 0u) |
           ((f & NEG_N) ? 16u : 0u) | ((f & NEG_S) ? 32u : 0u) |
           ((f & NEG_W) ? 64u : 0u) | ((f & NEG_E) ? 128u : 0u);
  }
  void set_significant(int i, bool neg) {
    flags[i] |= F_SIG | (neg ? F_NEG : 0u);
    flags[i - sw - 1] |= NB_SE;
    flags[i - sw] |= NB_S | (neg ? NEG_S : 0u);
    flags[i - sw + 1] |= NB_SW;
    flags[i - 1] |= NB_E | (neg ? NEG_E : 0u);
    flags[i + 1] |= NB_W | (neg ? NEG_W : 0u);
    flags[i + sw - 1] |= NB_NE;
    flags[i + sw] |= NB_N | (neg ? NEG_N : 0u);
    flags[i + sw + 1] |= NB_NW;
  }
  void code_sign(int i) {
    const uint32_t k = sc_index(flags[i]);
    const bool neg = (flags[i] & F_NEG) != 0;
    mqc.encode(luts().sc[k], (neg ? 1u : 0u) ^ luts().spb[k]);
  }
  // a sample becomes significant: its sign, then the flags
  void significant(int i) {
    code_sign(i);
    set_significant(i, (flags[i] & F_NEG) != 0);
  }

  void sigpass(uint32_t one, uint32_t orient) {
    const uint8_t *zc = luts().zc[orient];
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          const int i = at(x, y);
          const uint32_t f = flags[i];
          if ((f & F_SIG) || !(f & 0xff)) continue;
          const uint32_t v = (mag[(size_t)y * w + x] & one) ? 1 : 0;
          mqc.encode(zc[f & 0xff], v);
          if (v) significant(i);
          flags[i] |= F_VISIT;
        }
  }

  void refpass(uint32_t one) {
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          const int i = at(x, y);
          const uint32_t f = flags[i];
          if ((f & (F_SIG | F_VISIT)) != F_SIG) continue;
          const int ctx = (f & F_REFINED) ? CTX_MAG + 2
                          : (f & 0xff)    ? CTX_MAG + 1
                                          : CTX_MAG;
          mqc.encode(ctx, (mag[(size_t)y * w + x] & one) ? 1 : 0);
          flags[i] |= F_REFINED;
        }
  }

  void clnpass(uint32_t one, uint32_t orient) {
    const uint8_t *zc = luts().zc[orient];
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x) {
        int y0 = k;
        if (k + 4 <= h) {
          bool rl = true;
          for (int y = k; y < k + 4 && rl; ++y)
            if (flags[at(x, y)] & (F_SIG | F_VISIT | 0xff)) rl = false;
          if (rl) {
            int runlen = 0;
            while (runlen < 4 &&
                   !(mag[(size_t)(k + runlen) * w + x] & one))
              ++runlen;
            mqc.encode(CTX_AGG, runlen != 4);
            if (runlen == 4) continue;
            mqc.encode(CTX_UNI, static_cast<uint32_t>(runlen) >> 1);
            mqc.encode(CTX_UNI, static_cast<uint32_t>(runlen) & 1);
            const int y = k + runlen;
            significant(at(x, y));
            y0 = y + 1;
            for (int yy = y0; yy < k + 4; ++yy) {
              const int i = at(x, yy);
              const uint32_t v = (mag[(size_t)yy * w + x] & one) ? 1 : 0;
              mqc.encode(zc[flags[i] & 0xff], v);
              if (v) significant(i);
            }
            continue;
          }
        }
        for (int y = y0; y < std::min(k + 4, h); ++y) {
          const int i = at(x, y);
          if (flags[i] & (F_SIG | F_VISIT)) continue;
          const uint32_t v = (mag[(size_t)y * w + x] & one) ? 1 : 0;
          mqc.encode(zc[flags[i] & 0xff], v);
          if (v) significant(i);
        }
      }
    for (uint32_t &f : flags) f &= ~F_VISIT;
  }

  // opj_t1_encode_cblk for a reversible code-block without code-block
  // style, the samples at `src` with row stride `stride`
  void encode(Cblk &cb, uint32_t orient, const int32_t *src, size_t stride) {
    w = cb.x1 - cb.x0;
    h = cb.y1 - cb.y0;
    sw = w + 2;
    mag.assign((size_t)w * h, 0);
    flags.assign((size_t)(w + 2) * (h + 2), 0);
    uint32_t max = 0;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        // (opj_t1_encode_cblks shifts on unsigned, as here)
        int32_t v = static_cast<int32_t>(
            static_cast<uint32_t>(src[(size_t)y * stride + x]) << kFracBits);
        uint32_t m;
        if (v < 0) {
          if (v == INT32_MIN) v = INT32_MIN + 1;
          m = static_cast<uint32_t>(-v);
          flags[at(x, y)] |= F_NEG;
        } else {
          m = static_cast<uint32_t>(v);
        }
        mag[(size_t)y * w + x] = m;
        max = std::max(max, m);
      }
    cb.numbps = max ? static_cast<uint32_t>(floorlog2(max) + 1 - kFracBits)
                    : 0;
    cb.numpasses = 0;
    cb.data.clear();
    if (cb.numbps == 0) return;
    int32_t bpno = static_cast<int32_t>(cb.numbps) - 1;
    uint32_t passtype = 2;
    mqc.resetstates();
    mqc.init((size_t)w * h * 2 + 64);
    while (bpno >= 0) {
      const uint32_t one = 1u << (bpno + kFracBits);
      if (passtype == 0)
        sigpass(one, orient);
      else if (passtype == 1)
        refpass(one);
      else
        clnpass(one, orient);
      ++cb.numpasses;
      if (++passtype == 3) {
        passtype = 0;
        bpno--;
      }
    }
    // only the last cleanup pass is terminated; its rate is the bytes
    // after the flush, less a last 0xFF (which the flush never leaves)
    mqc.flush();
    uint32_t rate = mqc.numbytes();
    if (mqc.buf[rate] == 0xff) rate--;
    cb.data.assign(mqc.buf.begin() + 1, mqc.buf.begin() + 1 + rate);
  }
};

// Every code-block of every component, coded on up to eight threads
// (each code-block is coded alone, so the bytes do not depend on the
// threads).
void tier1(std::vector<TileComp> &comps) {
  struct Job {
    Cblk *cb;
    uint32_t orient;
    const int32_t *src;
    size_t stride;
  };
  std::vector<Job> jobs;
  for (TileComp &tc : comps)
    for (uint32_t resno = 0; resno < tc.numres; ++resno)
      for (Band &band : tc.res[resno].bands)
        for (Precinct &pr : band.precincts)
          for (Cblk &cb : pr.cblks) {
            // a high-pass band lies after the lower resolution's samples
            int32_t x = cb.x0, y = cb.y0;
            if (band.bandno & 1) x += tc.res[resno - 1].w;
            if (band.bandno & 2) y += tc.res[resno - 1].h;
            jobs.push_back({&cb, band.bandno,
                            &tc.data[(size_t)y * tc.w + static_cast<size_t>(x)],
                            static_cast<size_t>(tc.w)});
          }
  std::atomic<size_t> next{0};
  std::exception_ptr error;
  std::mutex error_lock;
  auto work = [&]() {
    try {
      T1 t1;
      for (size_t k; (k = next.fetch_add(1)) < jobs.size();) {
        const Job &j = jobs[k];
        t1.encode(*j.cb, j.orient, j.src, j.stride);
      }
    } catch (...) {
      std::lock_guard<std::mutex> g(error_lock);
      if (!error) error = std::current_exception();
      next = jobs.size();
    }
  };
  const size_t nthreads = std::min<size_t>(
      {8, std::max(1u, std::thread::hardware_concurrency()),
       (jobs.size() + 3) / 4});
  std::vector<std::thread> threads;
  try {
    for (size_t t = 1; t < nthreads; ++t) threads.emplace_back(work);
  } catch (const std::system_error &) {
    // fewer threads: the ones started and this one take every job
  }
  work();
  for (std::thread &t : threads) t.join();
  if (error) std::rethrow_exception(error);
}

// ---------------------------------------------------------------------------
// tier 2 (OpenJPEG's t2.c, tgt.c, bio.c)

struct Bio {
  std::vector<uint8_t> &out;
  uint32_t buf = 0, ct = 8;
  explicit Bio(std::vector<uint8_t> &o) : out(o) {}
  void byteout() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    out.push_back(static_cast<uint8_t>(buf >> 8));
  }
  void putbit(uint32_t b) {
    if (ct == 0) byteout();
    ct--;
    buf |= b << ct;
  }
  void write(uint32_t v, uint32_t n) {
    for (uint32_t i = n - 1; i < n; i--) putbit((v >> i) & 1);
  }
  void flush() {
    byteout();
    if (ct == 7) byteout();
  }
};

void tgt_encode(Bio &bio, TagTree &t, uint32_t leaf, int32_t threshold) {
  int32_t stk[32];
  int n = 0;
  int32_t node = static_cast<int32_t>(leaf);
  while (t.nodes[node].parent >= 0) {
    stk[n++] = node;
    node = t.nodes[node].parent;
  }
  int32_t low = 0;
  for (;;) {
    TagTree::Node &nd = t.nodes[node];
    if (low > nd.low)
      nd.low = low;
    else
      low = nd.low;
    while (low < threshold) {
      if (low >= nd.value) {
        if (!nd.known) {
          bio.write(1, 1);
          nd.known = true;
        }
        break;
      }
      bio.write(0, 1);
      ++low;
    }
    nd.low = low;
    if (n == 0) break;
    node = stk[--n];
  }
}

void putnumpasses(Bio &bio, uint32_t n) {
  if (n == 1)
    bio.write(0, 1);
  else if (n == 2)
    bio.write(2, 2);
  else if (n <= 5)
    bio.write(0xc | (n - 3), 4);
  else if (n <= 36)
    bio.write(0x1e0 | (n - 6), 9);
  else if (n <= 164)
    bio.write(0xff80 | (n - 37), 16);
  else
    fail("JPEG 2000: more than 164 coding passes in a code-block");
}

void putcommacode(Bio &bio, int32_t n) {
  while (--n >= 0) bio.write(1, 1);
  bio.write(0, 1);
}

// opj_t2_encode_packet for the one layer of one precinct of one
// resolution.  Every code-block's passes end in one terminated segment,
// so its length is coded once, in 3 + floorlog2(passes) bits and more as
// the comma code adds.
void encode_packet(Resolution &res, uint32_t precno, std::vector<uint8_t> &out) {
  // OpenJPEG builds without ENABLE_EMPTY_PACKET_OPTIMIZATION: a packet
  // whose code-blocks are all left out still says it is not empty
  Bio bio(out);
  bio.write(1, 1);
  for (Band &band : res.bands) {
    if (band.empty()) continue;
    Precinct &pr = band.precincts[precno];
    for (uint32_t k = 0; k < pr.cblks.size(); ++k) {
      const Cblk &cb = pr.cblks[k];
      pr.imsb.setvalue(k, band.numbps - static_cast<int32_t>(cb.numbps));
      if (cb.numpasses) pr.incl.setvalue(k, 0);
    }
    for (uint32_t k = 0; k < pr.cblks.size(); ++k) {
      const Cblk &cb = pr.cblks[k];
      tgt_encode(bio, pr.incl, k, 1);
      if (!cb.numpasses) continue;
      tgt_encode(bio, pr.imsb, k, 999);
      putnumpasses(bio, cb.numpasses);
      const uint32_t len = static_cast<uint32_t>(cb.data.size());
      const int32_t lenbits = 3 + floorlog2(cb.numpasses);
      const int32_t increment = std::max(0, floorlog2(len) + 1 - lenbits);
      putcommacode(bio, increment);
      bio.write(len, static_cast<uint32_t>(lenbits + increment));
    }
  }
  bio.flush();
  for (Band &band : res.bands) {
    if (band.empty()) continue;
    for (const Cblk &cb : band.precincts[precno].cblks)
      out.insert(out.end(), cb.data.begin(), cb.data.end());
  }
}

// ---------------------------------------------------------------------------
// the codestream and the JP2 boxes (OpenJPEG's j2k.c, jp2.c)

std::vector<uint8_t> codestream(std::vector<TileComp> &comps, int32_t w,
                                int32_t h, uint32_t prec, uint32_t numres) {
  const uint32_t ncomp = static_cast<uint32_t>(comps.size());
  Writer o;
  o.u16(0xff4f);  // SOC
  o.u16(0xff51);  // SIZ
  o.u16(38 + 3 * ncomp);
  o.u16(0);  // Rsiz
  o.u32(static_cast<uint32_t>(w));
  o.u32(static_cast<uint32_t>(h));
  o.u32(0);
  o.u32(0);
  o.u32(static_cast<uint32_t>(w));  // one tile
  o.u32(static_cast<uint32_t>(h));
  o.u32(0);
  o.u32(0);
  o.u16(ncomp);
  for (uint32_t c = 0; c < ncomp; ++c) {
    o.u8(prec - 1);  // unsigned
    o.u8(1);
    o.u8(1);
  }
  o.u16(0xff52);  // COD
  o.u16(12);
  o.u8(0);     // Scod: default precincts, no SOP or EPH
  o.u8(0);     // LRCP
  o.u16(1);    // one layer
  o.u8(0);     // no MCT
  o.u8(numres - 1);
  o.u8(kCblkExp - 2);
  o.u8(kCblkExp - 2);
  o.u8(0);     // code-block style
  o.u8(1);     // reversible 5/3
  const uint32_t nbands = 3 * (numres - 1) + 1;
  o.u16(0xff5c);  // QCD
  o.u16(3 + nbands);
  o.u8(kGuardBits << 5);  // no quantisation
  for (uint32_t b = 0; b < nbands; ++b) {
    uint32_t gain = b == 0 ? 0 : (b - 1) % 3 == 2 ? 2 : 1;
    o.u8((prec + gain) << 3);
  }
  const size_t clen = sizeof(kComment) - 1;
  o.u16(0xff64);  // COM
  o.u16(static_cast<uint32_t>(4 + clen));
  o.u16(1);  // Latin text
  o.bytes(kComment, clen);
  // the tile's packets, LRCP
  std::vector<uint8_t> packets;
  for (uint32_t resno = 0; resno < numres; ++resno)
    for (uint32_t c = 0; c < ncomp; ++c) {
      Resolution &res = comps[c].res[resno];
      for (uint32_t p = 0; p < res.pw * res.ph; ++p)
        encode_packet(res, p, packets);
    }
  const uint64_t psot = 12 + 2 + packets.size();
  if (psot > 0xffffffffull) fail("JPEG 2000: the tile is over 4 GB");
  o.u16(0xff90);  // SOT
  o.u16(10);
  o.u16(0);
  o.u32(static_cast<uint32_t>(psot));
  o.u8(0);
  o.u8(1);
  o.u16(0xff93);  // SOD
  o.bytes(packets.data(), packets.size());
  o.u16(0xffd9);  // EOC
  return std::move(o.b);
}

std::vector<uint8_t> jp2(const std::vector<uint8_t> &cs, int32_t w, int32_t h,
                         uint32_t ncomp, uint32_t prec) {
  Writer o;
  o.u32(12);
  o.bytes("jP  \r\n\x87\n", 8);
  o.u32(20);
  o.bytes("ftypjp2 ", 8);
  o.u32(0);
  o.bytes("jp2 ", 4);
  const bool alpha = ncomp == 2 || ncomp == 4;
  const uint32_t cdef = alpha ? 8 + 2 + 6 * ncomp : 0;
  o.u32(8 + 22 + 15 + cdef);
  o.bytes("jp2h", 4);
  o.u32(22);
  o.bytes("ihdr", 4);
  o.u32(static_cast<uint32_t>(h));
  o.u32(static_cast<uint32_t>(w));
  o.u16(ncomp);
  o.u8(prec - 1);
  o.u8(7);  // JPEG 2000 compression
  o.u8(0);  // colour space known
  o.u8(0);  // no intellectual property box
  o.u32(15);
  o.bytes("colr", 4);
  o.u8(1);  // enumerated colour space
  o.u8(0);
  o.u8(0);
  o.u32(ncomp >= 3 ? 16 : 17);  // sRGB or greyscale
  if (alpha) {
    o.u32(cdef);
    o.bytes("cdef", 4);
    o.u16(ncomp);
    for (uint32_t c = 0; c < ncomp; ++c) {
      o.u16(c);
      o.u16(c + 1 == ncomp ? 1 : 0);       // colour or opacity
      o.u16(c + 1 == ncomp ? 0 : c + 1);   // its colour, or the image
    }
  }
  o.u32(static_cast<uint32_t>(8 + cs.size()));
  o.bytes("jp2c", 4);
  o.bytes(cs.data(), cs.size());
  return std::move(o.b);
}

std::vector<uint8_t> encode(const void *planes, int32_t w, int32_t h,
                            uint32_t ncomp, uint32_t prec, bool as_jp2) {
  if (w < 1 || h < 1) fail("JPEG 2000: an empty image");
  if (ncomp < 1 || ncomp > 4)
    fail("JPEG 2000: 1 to 4 components are written, not " +
         std::to_string(ncomp));
  if (prec != 8 && prec != 16)
    fail("JPEG 2000: 8- or 16-bit samples are written, not " +
         std::to_string(prec));
  if (8 + 8 + 8 + 4ull * ncomp * w * h > 0xffffffffull)
    fail("JPEG 2000: the image is too large for one tile");
  // Pillow's rule for the number of resolutions
  uint32_t numres = 6;
  while (static_cast<uint32_t>(w) < (1u << (numres - 1)) ||
         static_cast<uint32_t>(h) < (1u << (numres - 1)))
    numres -= 1;
  const size_t n = static_cast<size_t>(w) * h;
  const int32_t shift = 1 << (prec - 1);  // the DC level shift
  std::vector<TileComp> comps(ncomp);
  for (uint32_t c = 0; c < ncomp; ++c) {
    TileComp &tc = comps[c];
    init_tilecomp(tc, w, h, numres, prec);
    tc.data.resize(n);
    if (prec == 8) {
      const uint8_t *p = static_cast<const uint8_t *>(planes) + c * n;
      for (size_t i = 0; i < n; ++i) tc.data[i] = p[i] - shift;
    } else {
      const uint16_t *p = static_cast<const uint16_t *>(planes) + c * n;
      for (size_t i = 0; i < n; ++i) tc.data[i] = p[i] - shift;
    }
    fdwt53(tc);
  }
  tier1(comps);
  std::vector<uint8_t> cs = codestream(comps, w, h, prec, numres);
  return as_jp2 ? jp2(cs, w, h, ncomp, prec) : cs;
}

}  // namespace

extern "C" int64_t mods_j2k_encode(const void *planes, int width, int height,
                                   int ncomp, int prec, int jp2, uint8_t *out,
                                   int64_t cap, char *err, int errlen) {
  try {
    const std::vector<uint8_t> file =
        encode(planes, width, height, static_cast<uint32_t>(ncomp),
               static_cast<uint32_t>(prec), jp2 != 0);
    if (static_cast<int64_t>(file.size()) <= cap)
      std::memcpy(out, file.data(), file.size());
    return static_cast<int64_t>(file.size());
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, std::string("JPEG 2000: ") + e.what());
  }
  return -1;
}
