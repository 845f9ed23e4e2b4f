// JPEG 2000 codestream decoder for io/image.py::read_image, bound with
// ctypes.
//
// It reproduces what PIL returns for np.asarray(Image.open(path)) on a
// .j2k or .jp2 file: PIL decodes through OpenJPEG 2.5's tile interface
// (opj_read_tile_header, opj_decode_tile_data, with its defaults: no
// reduction, every quality layer, strict mode) and unpacks each tile
// with Pillow's Jpeg2KDecode.c.  Both steps are copied:
//   - The codestream (ISO/IEC 15444-1): SIZ, COD/COC, QCD/QCC, RGN, POC,
//     PPM/PPT, TLM/PLM/PLT and COM (the last three skipped), tiles and
//     tile-parts, decoded as a tile's last tile-part (TNsot) arrives, the
//     others at EOC in index order.  Packets in the five progression
//     orders and under POC (OpenJPEG's pi.c, its include table), with
//     precincts, tag trees, SOP/EPH and the segments of each code-block
//     style.  Tier-1: the MQ decoder (with OpenJPEG's 0xFF 0xFF sentinel
//     after each segment), raw bypass, reset, termination on each pass,
//     vertically causal contexts and segmentation symbols, OpenJPEG's
//     reconstruction (the half bit, the ROI shift).  Dequantisation as
//     OpenJPEG's tcd.c computes the step (a double, then float, times
//     0.5f), the 5/3 and 9/7 inverse wavelets in OpenJPEG's order and
//     float32 operations (its lifting constants, two_invK, the
//     horizontal pass first), the RCT or ICT, the DC level shift with
//     lrintf and the clamp to the component's range.
//   - Pillow's unpack: the tile buffer as OpenJPEG fills it (each
//     component's plane in 1, 2 or 4 bytes, truncated), kept between
//     tiles as Pillow keeps it (grown and zeroed only when too small),
//     read by the unpacker that Pillow's table picks for the mode, the
//     colour space and the subsampling, with its shifts and offsets in
//     unsigned arithmetic, its plane strides of (w / dx) * (h / dy), and
//     its YCbCr to RGB for sYCC.
// Build with -ffp-contract=off: OpenJPEG's float arithmetic has no fused
// multiply-adds.
//
// Interface: mods_j2k_decode(cs, n, mode, color_space, width, height,
// out, err, errlen) writes PIL's image memory (1, 2 or 4 bytes a pixel,
// as Pillow stores the mode) of width x height.  It returns 0, or -1
// with a message in err.

#include <algorithm>
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

[[noreturn]] void fail(const std::string &msg) { throw Error{msg}; }

// ---------------------------------------------------------------------------
// reading

struct Reader {
  const uint8_t *p;
  size_t n, pos = 0;
  Reader(const uint8_t *p_, size_t n_) : p(p_), n(n_) {}
  uint32_t u8() {
    if (pos + 1 > n) fail("Stream too short");
    return p[pos++];
  }
  uint32_t u16() {
    if (pos + 2 > n) fail("Stream too short");
    uint32_t v = (p[pos] << 8) | p[pos + 1];
    pos += 2;
    return v;
  }
  uint32_t u32() {
    uint32_t hi = u16();
    return (hi << 16) | u16();
  }
};

inline int32_t ceildiv(int64_t a, int64_t b) {
  return static_cast<int32_t>((a + b - 1) / b);
}
inline int32_t ceildivpow2(int64_t a, int b) {
  return static_cast<int32_t>((a + ((int64_t)1 << b) - 1) >> b);
}
inline int32_t floordivpow2(int32_t a, int b) { return a >> b; }
inline uint32_t floorlog2(uint32_t a) {
  uint32_t l = 0;
  while (a > 1) {
    a >>= 1;
    ++l;
  }
  return l;
}

// ---------------------------------------------------------------------------
// coding parameters (OpenJPEG's opj_tccp_t, opj_tcp_t)

enum { LRCP = 0, RLCP, RPCL, PCRL, CPRL };

enum : uint32_t {
  CBLKSTY_LAZY = 1,
  CBLKSTY_RESET = 2,
  CBLKSTY_TERMALL = 4,
  CBLKSTY_VSC = 8,
  CBLKSTY_PTERM = 16,
  CBLKSTY_SEGSYM = 32,
  CBLKSTY_HT = 64,
};

struct StepSize {
  int32_t expn = 0, mant = 0;
};

struct Tccp {
  uint32_t csty = 0, numresolutions = 0, cblkw = 0, cblkh = 0, cblksty = 0,
           qmfbid = 0, qntsty = 0, numgbits = 0;
  int32_t roishift = 0;
  StepSize stepsizes[97];
  uint32_t prcw[33], prch[33];
};

struct Poc {
  uint32_t resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0;
  uint32_t prg = 0;
};

struct Tcp {
  uint32_t csty = 0, prg = 0, numlayers = 0, mct = 0;
  std::vector<Tccp> tccps;
  bool has_poc = false;
  std::vector<Poc> pocs;
  std::vector<std::pair<uint32_t, std::vector<uint8_t>>> ppt;  // Zppt, data
  std::vector<uint8_t> data;
  uint32_t nb_tile_parts = 0;
  bool seen = false, decoded = false;
};

struct Comp {
  uint32_t prec = 0, sgnd = 0, dx = 1, dy = 1;
};

struct Codestream {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  int32_t tx0 = 0, ty0 = 0, tdx = 0, tdy = 0;
  uint32_t tw = 0, th = 0;
  std::vector<Comp> comps;
  Tcp dflt;
  std::vector<Tcp> tcps;
  // PPM: every Ippm, Nppm fields dropped, in Zppm order
  std::vector<std::pair<uint32_t, std::vector<uint8_t>>> ppm_markers;
  bool ppm = false;
  std::vector<uint8_t> ppm_data;
  size_t ppm_pos = 0;
};

uint32_t comp_room(const Codestream &cs) {
  return cs.comps.size() <= 256 ? 1 : 2;
}

void read_siz(Codestream &cs, Reader &r, uint32_t len) {
  if (len < 38 + 2) fail("Error with SIZ marker size");
  size_t end = r.pos + len - 2;
  r.u16();  // Rsiz
  cs.x1 = static_cast<int32_t>(r.u32());
  cs.y1 = static_cast<int32_t>(r.u32());
  cs.x0 = static_cast<int32_t>(r.u32());
  cs.y0 = static_cast<int32_t>(r.u32());
  cs.tdx = static_cast<int32_t>(r.u32());
  cs.tdy = static_cast<int32_t>(r.u32());
  cs.tx0 = static_cast<int32_t>(r.u32());
  cs.ty0 = static_cast<int32_t>(r.u32());
  uint32_t nc = r.u16();
  if (nc == 0 || nc > 16384) fail("Error with SIZ marker: number of component is illegal");
  if (len - 2 != 36 + 3 * nc) fail("Error with SIZ marker: number of component is not compatible with the remaining number of parameters");
  if (cs.x0 >= cs.x1 || cs.y0 >= cs.y1 || cs.x0 < 0 || cs.y0 < 0)
    fail("Error with SIZ marker: negative or zero image size");
  if (cs.tdx <= 0 || cs.tdy <= 0) fail("Error with SIZ marker: invalid tile size");
  if (cs.tx0 > cs.x0 || cs.ty0 > cs.y0 ||
      (int64_t)cs.tx0 + cs.tdx <= cs.x0 || (int64_t)cs.ty0 + cs.tdy <= cs.y0)
    fail("Error with SIZ marker: illegal tile offset");
  cs.comps.resize(nc);
  for (auto &c : cs.comps) {
    uint32_t s = r.u8();
    c.prec = (s & 0x7f) + 1;
    c.sgnd = s >> 7;
    c.dx = r.u8();
    c.dy = r.u8();
    if (c.dx == 0 || c.dy == 0) fail("Invalid values for comp: dx or dy is zero");
    if (c.prec > 31) fail("Invalid values for comp: prec above 31");
  }
  r.pos = end;
  cs.tw = ceildiv((int64_t)cs.x1 - cs.tx0, cs.tdx);
  cs.th = ceildiv((int64_t)cs.y1 - cs.ty0, cs.tdy);
  if (cs.tw == 0 || cs.th == 0 || (uint64_t)cs.tw * cs.th > 65535)
    fail("Invalid number of tiles");
  cs.dflt.tccps.assign(nc, Tccp());
}

// SPcod / SPcoc into tccp
void read_spcod(Tccp &t, Reader &r, size_t end) {
  if (r.pos + 5 > end) fail("Error reading SPCod SPCoc element");
  t.numresolutions = r.u8() + 1;
  if (t.numresolutions > 33) fail("Invalid value for numresolutions");
  t.cblkw = r.u8() + 2;
  t.cblkh = r.u8() + 2;
  if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
    fail("Error reading SPCod SPCoc element, Invalid cblkw/cblkh combination");
  t.cblksty = r.u8();
  if (t.cblksty & CBLKSTY_HT) fail("HT code-blocks are not supported");
  t.qmfbid = r.u8();
  if (t.qmfbid > 1) fail("Error reading SPCod SPCoc element, Invalid transformation found");
  if (t.csty & 1) {
    if (r.pos + t.numresolutions > end) fail("Error reading SPCod SPCoc element");
    for (uint32_t i = 0; i < t.numresolutions; ++i) {
      uint32_t v = r.u8();
      if (i != 0 && ((v & 0xf) == 0 || (v >> 4) == 0)) fail("Invalid precinct size");
      t.prcw[i] = v & 0xf;
      t.prch[i] = v >> 4;
    }
  } else {
    for (uint32_t i = 0; i < t.numresolutions; ++i) t.prcw[i] = t.prch[i] = 15;
  }
}

void copy_coding(Tccp &dst, const Tccp &src) {
  dst.numresolutions = src.numresolutions;
  dst.cblkw = src.cblkw;
  dst.cblkh = src.cblkh;
  dst.cblksty = src.cblksty;
  dst.qmfbid = src.qmfbid;
  std::copy(src.prcw, src.prcw + 33, dst.prcw);
  std::copy(src.prch, src.prch + 33, dst.prch);
}

void read_cod(Tcp &tcp, Reader &r, uint32_t len) {
  size_t end = r.pos + len - 2;
  if (len < 7) fail("Error reading COD marker");
  tcp.csty = r.u8();
  tcp.prg = r.u8();
  if (tcp.prg > CPRL) fail("Unknown progression order in COD marker");
  tcp.numlayers = r.u16();
  if (tcp.numlayers == 0) fail("Invalid number of layers in COD marker");
  tcp.mct = r.u8();
  if (tcp.mct > 1) fail("Invalid multiple component transformation");
  Tccp &t0 = tcp.tccps[0];
  t0.csty = tcp.csty & 1;
  read_spcod(t0, r, end);
  if (r.pos != end) fail("Error reading COD marker");
  for (size_t i = 1; i < tcp.tccps.size(); ++i) {
    tcp.tccps[i].csty = tcp.csty & 1;
    copy_coding(tcp.tccps[i], t0);
  }
}

void read_coc(Codestream &cs, Tcp &tcp, Reader &r, uint32_t len) {
  size_t end = r.pos + len - 2;
  uint32_t room = comp_room(cs);
  uint32_t c = room == 1 ? r.u8() : r.u16();
  if (c >= cs.comps.size()) fail("Error reading COC marker (bad number of components)");
  Tccp &t = tcp.tccps[c];
  t.csty = r.u8();
  read_spcod(t, r, end);
  if (r.pos != end) fail("Error reading COC marker");
}

void read_sqcd(Tccp &t, Reader &r, size_t end) {
  if (r.pos + 1 > end) fail("Error reading SQcd or SQcc element");
  uint32_t v = r.u8();
  t.qntsty = v & 0x1f;
  t.numgbits = v >> 5;
  size_t rest = end - r.pos;
  uint32_t nb;
  if (t.qntsty == 1) {
    nb = 1;
  } else {
    nb = t.qntsty == 0 ? static_cast<uint32_t>(rest)
                       : static_cast<uint32_t>(rest / 2);
    if (nb > 97) fail("While reading QCD or QCC marker segment, number of subbands is greater than OPJ_J2K_MAXBANDS");
  }
  if (t.qntsty == 0) {
    for (uint32_t b = 0; b < nb; ++b) {
      uint32_t x = r.u8();
      if (b < 97) {
        t.stepsizes[b].expn = static_cast<int32_t>(x >> 3);
        t.stepsizes[b].mant = 0;
      }
    }
  } else {
    if (r.pos + 2 * nb > end) fail("Error reading SQcd or SQcc element");
    for (uint32_t b = 0; b < nb; ++b) {
      uint32_t x = r.u16();
      if (b < 97) {
        t.stepsizes[b].expn = static_cast<int32_t>(x >> 11);
        t.stepsizes[b].mant = static_cast<int32_t>(x & 0x7ff);
      }
    }
  }
  if (t.qntsty == 1) {
    for (uint32_t b = 1; b < 97; ++b) {
      int32_t e = t.stepsizes[0].expn - static_cast<int32_t>((b - 1) / 3);
      t.stepsizes[b].expn = e > 0 ? e : 0;
      t.stepsizes[b].mant = t.stepsizes[0].mant;
    }
  }
}

void copy_quant(Tccp &dst, const Tccp &src) {
  dst.qntsty = src.qntsty;
  dst.numgbits = src.numgbits;
  std::copy(src.stepsizes, src.stepsizes + 97, dst.stepsizes);
}

void read_qcd(Tcp &tcp, Reader &r, uint32_t len) {
  size_t end = r.pos + len - 2;
  read_sqcd(tcp.tccps[0], r, end);
  if (r.pos != end) fail("Error reading QCD marker");
  for (size_t i = 1; i < tcp.tccps.size(); ++i)
    copy_quant(tcp.tccps[i], tcp.tccps[0]);
}

void read_qcc(Codestream &cs, Tcp &tcp, Reader &r, uint32_t len) {
  size_t end = r.pos + len - 2;
  uint32_t c = comp_room(cs) == 1 ? r.u8() : r.u16();
  if (c >= cs.comps.size()) fail("Invalid component number in QCC marker");
  read_sqcd(tcp.tccps[c], r, end);
  if (r.pos != end) fail("Error reading QCC marker");
}

void read_rgn(Codestream &cs, Tcp &tcp, Reader &r, uint32_t len) {
  size_t end = r.pos + len - 2;
  uint32_t c = comp_room(cs) == 1 ? r.u8() : r.u16();
  if (c >= cs.comps.size()) fail("bad component number in RGN");
  r.u8();  // Srgn
  tcp.tccps[c].roishift = static_cast<int32_t>(r.u8());
  if (r.pos != end) fail("Error reading RGN marker");
}

void read_poc(Codestream &cs, Tcp &tcp, Reader &r, uint32_t len) {
  size_t end = r.pos + len - 2;
  uint32_t room = comp_room(cs);
  uint32_t chunk = 5 + 2 * room;
  uint32_t body = len - 2;
  if (body % chunk != 0) fail("Error reading POC marker");
  uint32_t nb = body / chunk;
  size_t old = tcp.has_poc ? tcp.pocs.size() : 0;
  if (old + nb >= 32) fail("Too many POCs");
  tcp.pocs.resize(old);
  for (uint32_t i = 0; i < nb; ++i) {
    Poc p;
    p.resno0 = r.u8();
    p.compno0 = room == 1 ? r.u8() : r.u16();
    p.layno1 = std::min(r.u16(), tcp.numlayers);
    p.resno1 = r.u8();
    p.compno1 = room == 1 ? r.u8() : r.u16();
    p.prg = r.u8();
    p.compno1 = std::min<uint32_t>(p.compno1, cs.comps.size());
    tcp.pocs.push_back(p);
  }
  tcp.has_poc = true;
  r.pos = end;
}

// ---------------------------------------------------------------------------
// tile geometry (OpenJPEG's tcd.c)

struct Cblk {
  int32_t x0, y0, x1, y1;
  uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0;
  struct Seg {
    uint32_t len = 0, numpasses = 0, maxpasses = 0, numnewpasses = 0,
             newlen = 0;
  };
  std::vector<Seg> segs;
  uint32_t numsegs = 0;
  std::vector<uint8_t> data;  // every chunk, in order
};

struct TagTree {
  struct Node {
    int32_t parent = -1, value = 999, low = 0;
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
  float stepsize;
  int32_t numbps;
  std::vector<Precinct> precincts;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Resolution {
  int32_t x0, y0, x1, y1;
  uint32_t pw, ph, numbands, pdx, pdy;
  std::vector<Band> bands;
};

struct TileComp {
  int32_t x0, y0, x1, y1;
  uint32_t numres;
  std::vector<Resolution> res;
  std::vector<int32_t> data;  // int32, or float32 bits where qmfbid == 0
};

void init_tilecomp(TileComp &tc, const Comp &comp, const Tccp &tccp,
                   int32_t tx0, int32_t ty0, int32_t tx1, int32_t ty1) {
  tc.x0 = ceildiv(tx0, comp.dx);
  tc.y0 = ceildiv(ty0, comp.dy);
  tc.x1 = ceildiv(tx1, comp.dx);
  tc.y1 = ceildiv(ty1, comp.dy);
  tc.numres = tccp.numresolutions;
  tc.res.assign(tc.numres, Resolution());
  tc.data.assign((size_t)(tc.x1 - tc.x0) * (tc.y1 - tc.y0), 0);
  for (uint32_t resno = 0; resno < tc.numres; ++resno) {
    Resolution &res = tc.res[resno];
    int level = static_cast<int>(tc.numres - 1 - resno);
    res.x0 = ceildivpow2(tc.x0, level);
    res.y0 = ceildivpow2(tc.y0, level);
    res.x1 = ceildivpow2(tc.x1, level);
    res.y1 = ceildivpow2(tc.y1, level);
    uint32_t pdx = tccp.prcw[resno], pdy = tccp.prch[resno];
    res.pdx = pdx;
    res.pdy = pdy;
    int32_t prx0 = floordivpow2(res.x0, pdx) << pdx;
    int32_t pry0 = floordivpow2(res.y0, pdy) << pdy;
    int32_t prx1 = ceildivpow2(res.x1, pdx) << pdx;
    int32_t pry1 = ceildivpow2(res.y1, pdy) << pdy;
    res.pw = res.x0 == res.x1 ? 0 : static_cast<uint32_t>((prx1 - prx0) >> pdx);
    res.ph = res.y0 == res.y1 ? 0 : static_cast<uint32_t>((pry1 - pry0) >> pdy);
    uint32_t nprec = res.pw * res.ph;
    int32_t cbgx0, cbgy0;
    uint32_t cbgw, cbgh;
    if (resno == 0) {
      cbgx0 = prx0;
      cbgy0 = pry0;
      cbgw = pdx;
      cbgh = pdy;
      res.numbands = 1;
    } else {
      cbgx0 = ceildivpow2(prx0, 1);
      cbgy0 = ceildivpow2(pry0, 1);
      cbgw = pdx - 1;
      cbgh = pdy - 1;
      res.numbands = 3;
    }
    uint32_t cbw = std::min(tccp.cblkw, cbgw), cbh = std::min(tccp.cblkh, cbgh);
    res.bands.assign(res.numbands, Band());
    for (uint32_t b = 0; b < res.numbands; ++b) {
      Band &band = res.bands[b];
      uint32_t si;
      if (resno == 0) {
        band.bandno = 0;
        band.x0 = ceildivpow2(tc.x0, level);
        band.y0 = ceildivpow2(tc.y0, level);
        band.x1 = ceildivpow2(tc.x1, level);
        band.y1 = ceildivpow2(tc.y1, level);
        si = 0;
      } else {
        band.bandno = b + 1;
        int64_t x0b = band.bandno & 1, y0b = band.bandno >> 1;
        band.x0 = ceildivpow2(tc.x0 - (x0b << level), level + 1);
        band.y0 = ceildivpow2(tc.y0 - (y0b << level), level + 1);
        band.x1 = ceildivpow2(tc.x1 - (x0b << level), level + 1);
        band.y1 = ceildivpow2(tc.y1 - (y0b << level), level + 1);
        si = 3 * (resno - 1) + b + 1;
      }
      const StepSize &ss = tccp.stepsizes[si];
      int32_t log2_gain = tccp.qmfbid == 0 ? 0
                          : band.bandno == 0 ? 0
                          : band.bandno == 3 ? 2 : 1;
      int32_t Rb = static_cast<int32_t>(comp.prec) + log2_gain;
      band.stepsize = static_cast<float>(
          (1.0 + ss.mant / 2048.0) * std::pow(2.0, (int32_t)(Rb - ss.expn)));
      band.numbps = ss.expn + static_cast<int32_t>(tccp.numgbits) - 1;
      band.precincts.assign(nprec, Precinct());
      for (uint32_t p = 0; p < nprec; ++p) {
        Precinct &pr = band.precincts[p];
        int32_t cx0 = cbgx0 + static_cast<int32_t>(p % res.pw) * (1 << cbgw);
        int32_t cy0 = cbgy0 + static_cast<int32_t>(p / res.pw) * (1 << cbgh);
        int32_t cx1 = cx0 + (1 << cbgw), cy1 = cy0 + (1 << cbgh);
        pr.x0 = std::max(cx0, band.x0);
        pr.y0 = std::max(cy0, band.y0);
        pr.x1 = std::min(cx1, band.x1);
        pr.y1 = std::min(cy1, band.y1);
        int32_t bx0 = floordivpow2(pr.x0, cbw) << cbw;
        int32_t by0 = floordivpow2(pr.y0, cbh) << cbh;
        int32_t bx1 = ceildivpow2(pr.x1, cbw) << cbw;
        int32_t by1 = ceildivpow2(pr.y1, cbh) << cbh;
        pr.cw = bx1 > bx0 ? static_cast<uint32_t>((bx1 - bx0) >> cbw) : 0;
        pr.ch = by1 > by0 ? static_cast<uint32_t>((by1 - by0) >> cbh) : 0;
        if (pr.x0 >= pr.x1 || pr.y0 >= pr.y1) pr.cw = pr.ch = 0;
        uint32_t ncb = pr.cw * pr.ch;
        pr.cblks.assign(ncb, Cblk());
        for (uint32_t k = 0; k < ncb; ++k) {
          Cblk &cb = pr.cblks[k];
          int32_t kx0 = bx0 + static_cast<int32_t>(k % pr.cw) * (1 << cbw);
          int32_t ky0 = by0 + static_cast<int32_t>(k / pr.cw) * (1 << cbh);
          cb.x0 = std::max(kx0, pr.x0);
          cb.y0 = std::max(ky0, pr.y0);
          cb.x1 = std::min(kx0 + (1 << cbw), pr.x1);
          cb.y1 = std::min(ky0 + (1 << cbh), pr.y1);
        }
        pr.incl.build(pr.cw, pr.ch);
        pr.imsb.build(pr.cw, pr.ch);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tier 2: packet headers (OpenJPEG's t2.c, bio.c, tgt.c)

struct Bio {
  const uint8_t *start, *bp, *end;
  uint32_t buf = 0, ct = 0;
  Bio(const uint8_t *p, size_t len) : start(p), bp(p), end(p + len) {}
  void bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t getbit() {
    if (ct == 0) bytein();
    ct--;
    return (buf >> ct) & 1;
  }
  uint32_t read(uint32_t n) {
    uint32_t v = 0;
    for (uint32_t i = n - 1; i < n; i--) v |= getbit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xff) == 0xff) bytein();
    ct = 0;
  }
  size_t numbytes() const { return static_cast<size_t>(bp - start); }
};

uint32_t tgt_decode(Bio &bio, TagTree &t, uint32_t leaf, int32_t threshold) {
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
    while (low < threshold && low < nd.value) {
      if (bio.read(1))
        nd.value = low;
      else
        ++low;
    }
    nd.low = low;
    if (n == 0) break;
    node = stk[--n];
  }
  return t.nodes[node].value < threshold ? 1 : 0;
}

uint32_t getnumpasses(Bio &bio) {
  uint32_t n;
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  if ((n = bio.read(2)) != 3) return 3 + n;
  if ((n = bio.read(5)) != 31) return 6 + n;
  return 37 + bio.read(7);
}

uint32_t getcommacode(Bio &bio) {
  uint32_t n = 0;
  while (bio.read(1)) ++n;
  return n;
}

void init_seg(Cblk &cb, uint32_t index, uint32_t cblksty, bool first) {
  if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
  Cblk::Seg &seg = cb.segs[index];
  seg = Cblk::Seg();
  if (cblksty & CBLKSTY_TERMALL) {
    seg.maxpasses = 1;
  } else if (cblksty & CBLKSTY_LAZY) {
    if (first) {
      seg.maxpasses = 10;
    } else {
      uint32_t prev = cb.segs[index - 1].maxpasses;
      seg.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else {
    seg.maxpasses = 109;
  }
}

struct HeaderSource {
  const uint8_t *data;
  size_t len;
  size_t *pos;  // where the next header starts
};

// One packet: its header (from the tile data, PPT or PPM) and its body.
// Returns the bytes it took from the tile data.
size_t decode_packet(const Tcp &tcp, TileComp &tc,
                     uint32_t compno, uint32_t resno, uint32_t precno,
                     uint32_t layno, const uint8_t *src, size_t max_len,
                     HeaderSource *hs) {
  Resolution &res = tc.res[resno];
  const Tccp &tccp = tcp.tccps[compno];
  const uint8_t *cur = src;
  const uint8_t *src_end = src + max_len;
  if (tcp.csty & 2) {  // SOP
    if (max_len < 6) {
      // OpenJPEG warns ("Not enough space for expected SOP marker")
    } else if (cur[0] != 0xff || cur[1] != 0x91) {
      // OpenJPEG warns ("Expected SOP marker")
    } else {
      cur += 6;
    }
  }
  const uint8_t *hstart;
  size_t hlen;
  if (hs) {
    hstart = hs->data + *hs->pos;
    hlen = hs->len - *hs->pos;
  } else {
    hstart = cur;
    hlen = static_cast<size_t>(src_end - cur);
  }
  Bio bio(hstart, hlen);
  const uint8_t *hdata = hstart;
  uint32_t present = bio.read(1);
  if (present) {
    for (uint32_t b = 0; b < res.numbands; ++b) {
      Band &band = res.bands[b];
      if (band.empty()) continue;
      Precinct &pr = band.precincts[precno];
      uint32_t ncb = pr.cw * pr.ch;
      for (uint32_t k = 0; k < ncb; ++k) {
        Cblk &cb = pr.cblks[k];
        uint32_t included;
        if (!cb.numsegs)
          included = tgt_decode(bio, pr.incl, k, static_cast<int32_t>(layno + 1));
        else
          included = bio.read(1);
        if (!included) {
          cb.numnewpasses = 0;
          continue;
        }
        if (!cb.numsegs) {
          uint32_t i = 0;
          while (!tgt_decode(bio, pr.imsb, k, static_cast<int32_t>(i))) ++i;
          cb.numbps = static_cast<uint32_t>(band.numbps) + 1 - i;
          cb.numlenbits = 3;
        }
        cb.numnewpasses = getnumpasses(bio);
        uint32_t inc = getcommacode(bio);
        cb.numlenbits += inc;
        uint32_t segno = 0;
        if (!cb.numsegs) {
          init_seg(cb, 0, tccp.cblksty, true);
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
            ++segno;
            init_seg(cb, segno, tccp.cblksty, false);
          }
        }
        int32_t n = static_cast<int32_t>(cb.numnewpasses);
        do {
          Cblk::Seg &seg = cb.segs[segno];
          seg.numnewpasses = static_cast<uint32_t>(std::min<int32_t>(
              static_cast<int32_t>(seg.maxpasses - seg.numpasses), n));
          uint32_t bits = cb.numlenbits + floorlog2(seg.numnewpasses);
          if (bits > 32) fail("Invalid bit number in opj_t2_read_packet_header()");
          seg.newlen = bio.read(bits);
          n -= static_cast<int32_t>(seg.numnewpasses);
          if (n > 0) {
            ++segno;
            init_seg(cb, segno, tccp.cblksty, false);
          }
        } while (n > 0);
      }
    }
  }
  bio.inalign();
  hdata += bio.numbytes();
  if (tcp.csty & 4) {  // EPH
    size_t left = hlen - static_cast<size_t>(hdata - hstart);
    if (left >= 2 && hdata[0] == 0xff && hdata[1] == 0x92) hdata += 2;
  }
  size_t header_len = static_cast<size_t>(hdata - hstart);
  if (hs)
    *hs->pos += header_len;
  else
    cur += header_len;
  if (!present) return static_cast<size_t>(cur - src);
  // the body
  for (uint32_t b = 0; b < res.numbands; ++b) {
    Band &band = res.bands[b];
    if (band.empty()) continue;
    Precinct &pr = band.precincts[precno];
    uint32_t ncb = pr.cw * pr.ch;
    for (uint32_t k = 0; k < ncb; ++k) {
      Cblk &cb = pr.cblks[k];
      if (!cb.numnewpasses) continue;
      uint32_t segi;
      if (!cb.numsegs) {
        segi = 0;
        ++cb.numsegs;
      } else {
        segi = cb.numsegs - 1;
        if (cb.segs[segi].numpasses == cb.segs[segi].maxpasses) {
          ++segi;
          ++cb.numsegs;
        }
      }
      do {
        Cblk::Seg &seg = cb.segs[segi];
        if (cur + seg.newlen > src_end || cur + seg.newlen < cur)
          fail("read: segment too long");
        cb.data.insert(cb.data.end(), cur, cur + seg.newlen);
        cur += seg.newlen;
        seg.len += seg.newlen;
        seg.numpasses += seg.numnewpasses;
        cb.numnewpasses -= seg.numnewpasses;
        if (cb.numnewpasses > 0) {
          ++segi;
          ++cb.numsegs;
        }
      } while (cb.numnewpasses > 0);
    }
  }
  return static_cast<size_t>(cur - src);
}

// ---------------------------------------------------------------------------
// packet order (OpenJPEG's pi.c)

struct PiRes {
  uint32_t pdx, pdy, pw, ph;
};
struct PiComp {
  uint32_t dx, dy, numres;
  std::vector<PiRes> res;
};

struct Packet {
  uint32_t layno, resno, compno, precno;
};

std::vector<Packet> packet_order(const Codestream &cs, const Tcp &tcp,
                                 uint32_t tileno) {
  uint32_t p = tileno % cs.tw, q = tileno / cs.tw;
  uint32_t tx0 = static_cast<uint32_t>(std::max<int64_t>((int64_t)cs.tx0 + (int64_t)p * cs.tdx, cs.x0));
  uint32_t ty0 = static_cast<uint32_t>(std::max<int64_t>((int64_t)cs.ty0 + (int64_t)q * cs.tdy, cs.y0));
  uint32_t tx1 = static_cast<uint32_t>(std::min<int64_t>((int64_t)cs.tx0 + (int64_t)(p + 1) * cs.tdx, cs.x1));
  uint32_t ty1 = static_cast<uint32_t>(std::min<int64_t>((int64_t)cs.ty0 + (int64_t)(q + 1) * cs.tdy, cs.y1));
  uint32_t nc = static_cast<uint32_t>(cs.comps.size());
  std::vector<PiComp> comps(nc);
  uint32_t max_prec = 0, max_res = 0;
  for (uint32_t c = 0; c < nc; ++c) {
    const Tccp &t = tcp.tccps[c];
    PiComp &pc = comps[c];
    pc.dx = cs.comps[c].dx;
    pc.dy = cs.comps[c].dy;
    pc.numres = t.numresolutions;
    max_res = std::max(max_res, t.numresolutions);
    int32_t tcx0 = ceildiv(tx0, pc.dx), tcy0 = ceildiv(ty0, pc.dy);
    int32_t tcx1 = ceildiv(tx1, pc.dx), tcy1 = ceildiv(ty1, pc.dy);
    pc.res.resize(t.numresolutions);
    for (uint32_t r = 0; r < t.numresolutions; ++r) {
      int level = static_cast<int>(t.numresolutions - 1 - r);
      PiRes &pr = pc.res[r];
      pr.pdx = t.prcw[r];
      pr.pdy = t.prch[r];
      int32_t rx0 = ceildivpow2(tcx0, level), ry0 = ceildivpow2(tcy0, level);
      int32_t rx1 = ceildivpow2(tcx1, level), ry1 = ceildivpow2(tcy1, level);
      int32_t px0 = floordivpow2(rx0, pr.pdx) << pr.pdx;
      int32_t py0 = floordivpow2(ry0, pr.pdy) << pr.pdy;
      int32_t px1 = ceildivpow2(rx1, pr.pdx) << pr.pdx;
      int32_t py1 = ceildivpow2(ry1, pr.pdy) << pr.pdy;
      pr.pw = rx0 == rx1 ? 0 : static_cast<uint32_t>((px1 - px0) >> pr.pdx);
      pr.ph = ry0 == ry1 ? 0 : static_cast<uint32_t>((py1 - py0) >> pr.pdy);
      max_prec = std::max(max_prec, pr.pw * pr.ph);
    }
  }
  uint32_t step_p = 1, step_c = max_prec * step_p, step_r = nc * step_c,
           step_l = max_res * step_r;
  std::vector<uint8_t> include((size_t)(tcp.numlayers + 1) * step_l, 0);
  std::vector<Poc> pocs;
  if (tcp.has_poc) {
    for (const Poc &pc : tcp.pocs) {
      Poc x = pc;
      x.layno1 = std::min(pc.layno1, tcp.numlayers);
      pocs.push_back(x);
    }
  } else {
    Poc x;
    x.prg = tcp.prg;
    x.resno0 = 0;
    x.compno0 = 0;
    x.resno1 = max_res;
    x.compno1 = nc;
    x.layno1 = tcp.numlayers;
    pocs.push_back(x);
  }
  std::vector<Packet> out;
  auto take = [&](uint32_t l, uint32_t r, uint32_t c, uint32_t pr) {
    size_t index = (size_t)l * step_l + (size_t)r * step_r +
                   (size_t)c * step_c + (size_t)pr * step_p;
    if (index >= include.size()) fail("Invalid access to pi->include");
    if (!include[index]) {
      include[index] = 1;
      out.push_back(Packet{l, r, c, pr});
    }
  };
  // the precinct of (x, y) at resolution r of component c, or -1
  auto precinct_at = [&](uint32_t c, uint32_t r, uint32_t x, uint32_t y,
                         uint32_t &precno) -> bool {
    const PiComp &comp = comps[c];
    const PiRes &res = comp.res[r];
    uint32_t levelno = comp.numres - 1 - r;
    if (levelno >= 32 || ((comp.dx << levelno) >> levelno) != comp.dx ||
        ((comp.dy << levelno) >> levelno) != comp.dy)
      return false;
    if ((uint64_t)(comp.dx << levelno) > INT32_MAX ||
        (uint64_t)(comp.dy << levelno) > INT32_MAX)
      return false;
    uint32_t trx0 = ceildiv(tx0, (int64_t)comp.dx << levelno);
    uint32_t try0 = ceildiv(ty0, (int64_t)comp.dy << levelno);
    uint32_t trx1 = ceildiv(tx1, (int64_t)comp.dx << levelno);
    uint32_t try1 = ceildiv(ty1, (int64_t)comp.dy << levelno);
    uint32_t rpx = res.pdx + levelno, rpy = res.pdy + levelno;
    if (rpx >= 31 || ((comp.dx << rpx) >> rpx) != comp.dx || rpy >= 31 ||
        ((comp.dy << rpy) >> rpy) != comp.dy)
      return false;
    if (!(((uint64_t)y % ((uint64_t)comp.dy << rpy) == 0) ||
          ((y == ty0) && (((uint64_t)try0 << levelno) % ((uint64_t)1 << rpy)))))
      return false;
    if (!(((uint64_t)x % ((uint64_t)comp.dx << rpx) == 0) ||
          ((x == tx0) && (((uint64_t)trx0 << levelno) % ((uint64_t)1 << rpx)))))
      return false;
    if (res.pw == 0 || res.ph == 0) return false;
    if (trx0 == trx1 || try0 == try1) return false;
    uint32_t prci = (ceildiv(x, (int64_t)comp.dx << levelno) >> res.pdx) -
                    (trx0 >> res.pdx);
    uint32_t prcj = (ceildiv(y, (int64_t)comp.dy << levelno) >> res.pdy) -
                    (try0 >> res.pdy);
    precno = prci + prcj * res.pw;
    return true;
  };
  auto min_step = [&](uint32_t c0, uint32_t c1, uint32_t &dx, uint32_t &dy) {
    dx = dy = 0;
    for (uint32_t c = c0; c < c1; ++c) {
      const PiComp &comp = comps[c];
      for (uint32_t r = 0; r < comp.numres; ++r) {
        const PiRes &res = comp.res[r];
        uint32_t e = res.pdx + comp.numres - 1 - r;
        if (e < 32 && comp.dx <= UINT32_MAX / (1u << e)) {
          uint32_t d = comp.dx * (1u << e);
          dx = !dx ? d : std::min(dx, d);
        }
        e = res.pdy + comp.numres - 1 - r;
        if (e < 32 && comp.dy <= UINT32_MAX / (1u << e)) {
          uint32_t d = comp.dy * (1u << e);
          dy = !dy ? d : std::min(dy, d);
        }
      }
    }
  };
  for (const Poc &poc : pocs) {
    if (poc.compno0 >= nc || poc.compno1 >= nc + 1)
      fail("opj_pi_next(): invalid compno0/compno1");
    uint32_t layno0 = 0;
    switch (poc.prg) {
      case LRCP:
        for (uint32_t l = layno0; l < poc.layno1; ++l)
          for (uint32_t r = poc.resno0; r < poc.resno1; ++r)
            for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
              if (r >= comps[c].numres) continue;
              const PiRes &res = comps[c].res[r];
              for (uint32_t pr = 0; pr < res.pw * res.ph; ++pr) take(l, r, c, pr);
            }
        break;
      case RLCP:
        for (uint32_t r = poc.resno0; r < poc.resno1; ++r)
          for (uint32_t l = layno0; l < poc.layno1; ++l)
            for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
              if (r >= comps[c].numres) continue;
              const PiRes &res = comps[c].res[r];
              for (uint32_t pr = 0; pr < res.pw * res.ph; ++pr) take(l, r, c, pr);
            }
        break;
      case RPCL: {
        uint32_t dx, dy;
        min_step(0, nc, dx, dy);
        if (dx == 0 || dy == 0) break;
        for (uint32_t r = poc.resno0; r < poc.resno1; ++r)
          for (uint32_t y = ty0; y < ty1; y += dy - (y % dy))
            for (uint32_t x = tx0; x < tx1; x += dx - (x % dx))
              for (uint32_t c = poc.compno0; c < poc.compno1; ++c) {
                if (r >= comps[c].numres) continue;
                uint32_t pr;
                if (!precinct_at(c, r, x, y, pr)) continue;
                for (uint32_t l = layno0; l < poc.layno1; ++l) take(l, r, c, pr);
              }
        break;
      }
      case PCRL: {
        uint32_t dx, dy;
        min_step(0, nc, dx, dy);
        if (dx == 0 || dy == 0) break;
        for (uint32_t y = ty0; y < ty1; y += dy - (y % dy))
          for (uint32_t x = tx0; x < tx1; x += dx - (x % dx))
            for (uint32_t c = poc.compno0; c < poc.compno1; ++c)
              for (uint32_t r = poc.resno0;
                   r < std::min(poc.resno1, comps[c].numres); ++r) {
                uint32_t pr;
                if (!precinct_at(c, r, x, y, pr)) continue;
                for (uint32_t l = layno0; l < poc.layno1; ++l) take(l, r, c, pr);
              }
        break;
      }
      case CPRL: {
        bool stop = false;
        for (uint32_t c = poc.compno0; c < poc.compno1 && !stop; ++c) {
          uint32_t dx, dy;
          min_step(c, c + 1, dx, dy);
          if (dx == 0 || dy == 0) {
            stop = true;
            break;
          }
          for (uint32_t y = ty0; y < ty1; y += dy - (y % dy))
            for (uint32_t x = tx0; x < tx1; x += dx - (x % dx))
              for (uint32_t r = poc.resno0;
                   r < std::min(poc.resno1, comps[c].numres); ++r) {
                uint32_t pr;
                if (!precinct_at(c, r, x, y, pr)) continue;
                for (uint32_t l = layno0; l < poc.layno1; ++l) take(l, r, c, pr);
              }
        }
        break;
      }
      default:
        fail("unknown progression order");
    }
  }
  return out;
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

struct Mqc {
  const uint8_t *bp, *end;
  uint32_t a = 0, c = 0, ct = 0;
  uint8_t state[19], mps[19];
  void reset() {
    for (int i = 0; i < 19; ++i) state[i] = mps[i] = 0;
    state[CTX_UNI] = 46;
    state[CTX_AGG] = 3;
    state[CTX_ZC] = 4;
  }
  // bp points at len bytes followed by 0xFF 0xFF
  void init(const uint8_t *p, uint32_t len) {
    bp = p;
    end = p + len;
    if (len == 0)
      c = 0xffu << 16;
    else
      c = static_cast<uint32_t>(*bp) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void bytein() {
    uint32_t l_c = bp[1];
    if (*bp == 0xff) {
      if (l_c > 0x8f) {
        c += 0xff00;
        ct = 8;
      } else {
        bp++;
        c += l_c << 9;
        ct = 7;
      }
    } else {
      bp++;
      c += l_c << 8;
      ct = 8;
    }
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      ct--;
    } while (a < 0x8000);
  }
  uint32_t decode(int cx) {
    const MqState &s = kMq[state[cx]];
    uint32_t d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      // LPS exchange
      if (a < s.qe) {
        a = s.qe;
        d = mps[cx];
        state[cx] = s.nmps;
      } else {
        a = s.qe;
        d = 1 - mps[cx];
        if (s.sw) mps[cx] = static_cast<uint8_t>(1 - mps[cx]);
        state[cx] = s.nlps;
      }
      renorm();
    } else {
      c -= static_cast<uint32_t>(s.qe) << 16;
      if ((a & 0x8000) == 0) {
        // MPS exchange
        if (a < s.qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] = static_cast<uint8_t>(1 - mps[cx]);
          state[cx] = s.nlps;
        } else {
          d = mps[cx];
          state[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  // raw (bypass) decoding
  void raw_init(const uint8_t *p, uint32_t len) {
    bp = p;
    end = p + len;
    c = 0;
    ct = 0;
  }
  uint32_t raw_decode() {
    if (ct == 0) {
      if (c == 0xff) {
        if (*bp > 0x8f) {
          c = 0xff;
          ct = 8;
        } else {
          c = *bp;
          bp++;
          ct = 7;
        }
      } else {
        c = *bp;
        bp++;
        ct = 8;
      }
    }
    ct--;
    return (c >> ct) & 1;
  }
};

struct T1 {
  int w, h, sw;  // sw: the state arrays' row stride (w + 2)
  std::vector<int32_t> data;  // h x w
  // per sample (with a border of one): significance, sign (1 negative),
  // visited in this bit-plane's significance pass, refined before
  std::vector<uint8_t> sig, neg, pi, mu;
  bool vsc;
  Mqc mqc;

  void setup(int w_, int h_, bool vsc_) {
    w = w_;
    h = h_;
    sw = w + 2;
    vsc = vsc_;
    data.assign((size_t)w * h, 0);
    size_t n = (size_t)(w + 2) * (h + 2);
    sig.assign(n, 0);
    neg.assign(n, 0);
    pi.assign(n, 0);
    mu.assign(n, 0);
  }
  inline int at(int x, int y) const { return (y + 1) * sw + (x + 1); }
  // whether row y + 1 counts for a sample of row y
  inline bool south(int y) const { return !(vsc && (y & 3) == 3); }

  void counts(int x, int y, int &hc, int &vc, int &dc) const {
    int i = at(x, y);
    bool s = south(y);
    hc = sig[i - 1] + sig[i + 1];
    vc = sig[i - sw] + (s ? sig[i + sw] : 0);
    dc = sig[i - sw - 1] + sig[i - sw + 1] +
         (s ? sig[i + sw - 1] + sig[i + sw + 1] : 0);
  }
  bool any_neighbour(int x, int y) const {
    int hc, vc, dc;
    counts(x, y, hc, vc, dc);
    return hc + vc + dc > 0;
  }
  int zc_ctx(int x, int y, uint32_t orient) const {
    int hc, vc, dc;
    counts(x, y, hc, vc, dc);
    if (orient == 1) std::swap(hc, vc);  // HL: vertical neighbours first
    if (orient == 3) {
      int hv = hc + vc;
      if (dc >= 3) return 8;
      if (dc == 2) return hv >= 1 ? 7 : 6;
      if (dc == 1) return hv >= 2 ? 5 : hv == 1 ? 4 : 3;
      return hv >= 2 ? 2 : hv == 1 ? 1 : 0;
    }
    if (hc == 2) return 8;
    if (hc == 1) return vc >= 1 ? 7 : dc >= 1 ? 6 : 5;
    if (vc == 2) return 4;
    if (vc == 1) return 3;
    return dc >= 2 ? 2 : dc == 1 ? 1 : 0;
  }
  int contrib(int i) const { return sig[i] ? (neg[i] ? -1 : 1) : 0; }
  // sign context and the bit that flips the decoded sign
  void sc_ctx(int x, int y, int &ctx, uint32_t &spb) const {
    int i = at(x, y);
    int hcon = contrib(i - 1) + contrib(i + 1);
    int vcon = contrib(i - sw) + (south(y) ? contrib(i + sw) : 0);
    hcon = std::max(-1, std::min(1, hcon));
    vcon = std::max(-1, std::min(1, vcon));
    if (hcon < 0 || (hcon == 0 && vcon < 0)) {
      spb = 1;
      hcon = -hcon;
      vcon = -vcon;
    } else {
      spb = 0;
    }
    if (hcon == 0)
      ctx = 9 + (vcon != 0 ? 1 : 0);
    else
      ctx = vcon == 1 ? 13 : vcon == 0 ? 12 : 11;
  }

  void sigpass(int bpno, uint32_t orient, bool raw) {
    int32_t one = 1 << bpno, half = one >> 1, oneplushalf = one | half;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          int i = at(x, y);
          if (sig[i] || pi[i] || !any_neighbour(x, y)) continue;
          uint32_t v;
          if (raw) {
            v = mqc.raw_decode();
            if (v) {
              uint32_t s = mqc.raw_decode();
              data[(size_t)y * w + x] = s ? -oneplushalf : oneplushalf;
              sig[i] = 1;
              neg[i] = static_cast<uint8_t>(s);
            }
          } else {
            v = mqc.decode(CTX_ZC + zc_ctx(x, y, orient));
            if (v) {
              int ctx;
              uint32_t spb;
              sc_ctx(x, y, ctx, spb);
              uint32_t s = mqc.decode(ctx) ^ spb;
              data[(size_t)y * w + x] = s ? -oneplushalf : oneplushalf;
              sig[i] = 1;
              neg[i] = static_cast<uint8_t>(s);
            }
          }
          pi[i] = 1;
        }
  }

  void refpass(int bpno, bool raw) {
    int32_t one = 1 << bpno, poshalf = one >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          int i = at(x, y);
          if (!sig[i] || pi[i]) continue;
          uint32_t v;
          if (raw) {
            v = mqc.raw_decode();
          } else {
            int ctx = mu[i] ? CTX_MAG + 2
                            : (any_neighbour(x, y) ? CTX_MAG + 1 : CTX_MAG);
            v = mqc.decode(ctx);
          }
          int32_t &d = data[(size_t)y * w + x];
          d += (v ^ (d < 0 ? 1u : 0u)) ? poshalf : -poshalf;
          mu[i] = 1;
        }
  }

  void clean_step(int x, int y, int32_t oneplushalf, uint32_t orient,
                  bool partial) {
    int i = at(x, y);
    if (!partial) {
      if (!mqc.decode(CTX_ZC + zc_ctx(x, y, orient))) return;
    }
    int ctx;
    uint32_t spb;
    sc_ctx(x, y, ctx, spb);
    uint32_t s = mqc.decode(ctx) ^ spb;
    data[(size_t)y * w + x] = s ? -oneplushalf : oneplushalf;
    sig[i] = 1;
    neg[i] = static_cast<uint8_t>(s);
  }

  void clnpass(int bpno, uint32_t orient, bool segsym) {
    int32_t one = 1 << bpno, half = one >> 1, oneplushalf = one | half;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x) {
        if (k + 4 <= h) {
          bool rl = true;
          for (int y = k; y < k + 4 && rl; ++y) {
            int i = at(x, y);
            if (sig[i] || pi[i] || any_neighbour(x, y)) rl = false;
          }
          if (rl) {
            if (!mqc.decode(CTX_AGG)) continue;
            uint32_t runlen = mqc.decode(CTX_UNI);
            runlen = (runlen << 1) | mqc.decode(CTX_UNI);
            clean_step(x, k + static_cast<int>(runlen), oneplushalf, orient,
                       true);
            for (int y = k + static_cast<int>(runlen) + 1; y < k + 4; ++y)
              clean_step(x, y, oneplushalf, orient, false);
            continue;
          }
        }
        for (int y = k; y < std::min(k + 4, h); ++y) {
          int i = at(x, y);
          if (sig[i] || pi[i]) continue;
          clean_step(x, y, oneplushalf, orient, false);
        }
      }
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) pi[at(x, y)] = 0;
    if (segsym) {
      for (int j = 0; j < 4; ++j) mqc.decode(CTX_UNI);
    }
  }

  // OpenJPEG's opj_t1_decode_cblk
  void decode(Cblk &cb, uint32_t orient, int32_t roishift, uint32_t cblksty) {
    setup(cb.x1 - cb.x0, cb.y1 - cb.y0, (cblksty & CBLKSTY_VSC) != 0);
    int32_t bpno_plus_one = roishift + static_cast<int32_t>(cb.numbps);
    if (bpno_plus_one >= 31) fail("opj_t1_decode_cblk(): unsupported bpno_plus_one >= 31");
    uint32_t passtype = 2;
    mqc.reset();
    std::vector<uint8_t> buf;
    size_t off = 0;
    for (uint32_t segno = 0; segno < cb.numsegs; ++segno) {
      const Cblk::Seg &seg = cb.segs[segno];
      bool raw = (bpno_plus_one <= static_cast<int32_t>(cb.numbps) - 4) &&
                 passtype < 2 && (cblksty & CBLKSTY_LAZY);
      buf.assign(cb.data.begin() + off, cb.data.begin() + off + seg.len);
      buf.push_back(0xff);
      buf.push_back(0xff);
      off += seg.len;
      if (raw)
        mqc.raw_init(buf.data(), seg.len);
      else
        mqc.init(buf.data(), seg.len);
      for (uint32_t p = 0; p < seg.numpasses && bpno_plus_one >= 1; ++p) {
        if (passtype == 0)
          sigpass(bpno_plus_one, orient, raw);
        else if (passtype == 1)
          refpass(bpno_plus_one, raw);
        else
          clnpass(bpno_plus_one, orient, (cblksty & CBLKSTY_SEGSYM) != 0);
        if ((cblksty & CBLKSTY_RESET) && !raw) mqc.reset();
        if (++passtype == 3) {
          passtype = 0;
          bpno_plus_one--;
        }
      }
    }
  }
};

// ---------------------------------------------------------------------------
// inverse wavelets (OpenJPEG's dwt.c)

// one line of the reversible 5/3: sn low-pass then dn high-pass samples
// in a, cas the parity of the first sample's coordinate
void idwt53_line(int32_t *a, int32_t sn, int32_t dn, int cas,
                 std::vector<int32_t> &x) {
  int32_t len = sn + dn;
  if (len <= 0) return;
  if (len == 1) {
    if (cas) a[0] /= 2;
    return;
  }
  x.assign(len, 0);
  // interleave: even positions (relative to cas) hold the low band
  for (int32_t i = 0; i < len; ++i)
    x[i] = ((i + cas) & 1) == 0 ? a[i / 2] : a[sn + i / 2];
  auto at = [&](int32_t i) {
    if (i < 0) i = -i;
    if (i >= len) i = 2 * (len - 1) - i;
    return x[i];
  };
  for (int32_t i = 0; i < len; ++i)
    if (((i + cas) & 1) == 0) x[i] -= (at(i - 1) + at(i + 1) + 2) >> 2;
  for (int32_t i = 0; i < len; ++i)
    if (((i + cas) & 1) == 1) x[i] += (at(i - 1) + at(i + 1)) >> 1;
  std::copy(x.begin(), x.end(), a);
}

void idwt53(TileComp &tc) {
  int32_t w = tc.x1 - tc.x0;
  std::vector<int32_t> line, tmp;
  for (uint32_t r = 1; r < tc.numres; ++r) {
    const Resolution &lo = tc.res[r - 1], &cur = tc.res[r];
    int32_t rw = cur.x1 - cur.x0, rh = cur.y1 - cur.y0;
    int32_t hsn = lo.x1 - lo.x0, vsn = lo.y1 - lo.y0;
    int hcas = cur.x0 % 2, vcas = cur.y0 % 2;
    for (int32_t j = 0; j < rh; ++j)
      idwt53_line(&tc.data[(size_t)j * w], hsn, rw - hsn, hcas, tmp);
    line.resize(rh);
    for (int32_t i = 0; i < rw; ++i) {
      for (int32_t j = 0; j < rh; ++j) line[j] = tc.data[(size_t)j * w + i];
      idwt53_line(line.data(), vsn, rh - vsn, vcas, tmp);
      for (int32_t j = 0; j < rh; ++j) tc.data[(size_t)j * w + i] = line[j];
    }
  }
}

const float kAlpha = -1.586134342f;
const float kBeta = -0.052980118f;
const float kGamma = 0.882911075f;
const float kDelta = 0.443506852f;
const float kK = 1.230174105f;
const float kTwoInvK = 1.625732422f;

// OpenJPEG's opj_v8dwt_decode_step2 on one lane: w[i] is the sample
// between l[i] and w[i + 1]
void step2(float *wav, int lstart, int wstart, uint32_t end, uint32_t m,
           float c) {
  // wav is interleaved; l points at lstart, w at wstart (stride 2)
  uint32_t imax = std::min(end, m);
  float *fw = wav + wstart;
  float *fl = wav + lstart;
  for (uint32_t i = 0; i < imax; ++i) {
    fw[-1] = fw[-1] + ((fl[0] + fw[0]) * c);
    fl = fw;
    fw += 2;
  }
  if (m < end) {
    c += c;
    fw[-1] = fw[-1] + fl[0] * c;
  }
}

void idwt97_line(float *wav, int32_t sn, int32_t dn, int cas) {
  int a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0;
    b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1;
    b = 0;
  }
  for (int32_t i = 0; i < sn; ++i) wav[a + 2 * i] *= kK;
  for (int32_t i = 0; i < dn; ++i) wav[b + 2 * i] *= kTwoInvK;
  step2(wav, b, a + 1, static_cast<uint32_t>(sn),
        static_cast<uint32_t>(std::min(sn, dn - a)), -kDelta);
  step2(wav, a, b + 1, static_cast<uint32_t>(dn),
        static_cast<uint32_t>(std::min(dn, sn - b)), -kGamma);
  step2(wav, b, a + 1, static_cast<uint32_t>(sn),
        static_cast<uint32_t>(std::min(sn, dn - a)), -kBeta);
  step2(wav, a, b + 1, static_cast<uint32_t>(dn),
        static_cast<uint32_t>(std::min(dn, sn - b)), -kAlpha);
}

void idwt97(TileComp &tc) {
  int32_t w = tc.x1 - tc.x0;
  float *d = reinterpret_cast<float *>(tc.data.data());
  std::vector<float> wav;
  for (uint32_t r = 1; r < tc.numres; ++r) {
    const Resolution &lo = tc.res[r - 1], &cur = tc.res[r];
    int32_t rw = cur.x1 - cur.x0, rh = cur.y1 - cur.y0;
    int32_t hsn = lo.x1 - lo.x0, vsn = lo.y1 - lo.y0;
    int hcas = cur.x0 % 2, vcas = cur.y0 % 2;
    // the wavelet buffer holds one extra sample past the end, as
    // OpenJPEG's does, for the last lifting step's read of w[0]
    wav.assign((size_t)std::max(rw, rh) + 2, 0.0f);
    for (int32_t j = 0; j < rh; ++j) {
      float *row = d + (size_t)j * w;
      int32_t hdn = rw - hsn;
      std::fill(wav.begin(), wav.end(), 0.0f);
      for (int32_t i = 0; i < hsn; ++i) wav[hcas + 2 * i] = row[i];
      for (int32_t i = 0; i < hdn; ++i) wav[1 - hcas + 2 * i] = row[hsn + i];
      idwt97_line(wav.data(), hsn, hdn, hcas);
      for (int32_t i = 0; i < rw; ++i) row[i] = wav[i];
    }
    for (int32_t i = 0; i < rw; ++i) {
      int32_t vdn = rh - vsn;
      std::fill(wav.begin(), wav.end(), 0.0f);
      for (int32_t j = 0; j < vsn; ++j) wav[vcas + 2 * j] = d[(size_t)j * w + i];
      for (int32_t j = 0; j < vdn; ++j)
        wav[1 - vcas + 2 * j] = d[(size_t)(vsn + j) * w + i];
      idwt97_line(wav.data(), vsn, vdn, vcas);
      for (int32_t j = 0; j < rh; ++j) d[(size_t)j * w + i] = wav[j];
    }
  }
}

// ---------------------------------------------------------------------------
// a tile: tier 2, tier 1, wavelets, component transform, level shift

struct DecodedTile {
  int32_t x0, y0, x1, y1;
  std::vector<TileComp> comps;
};

DecodedTile decode_tile(Codestream &cs, uint32_t tileno) {
  Tcp &tcp = cs.tcps[tileno];
  uint32_t p = tileno % cs.tw, q = tileno / cs.tw;
  DecodedTile t;
  t.x0 = static_cast<int32_t>(std::max<int64_t>((int64_t)cs.tx0 + (int64_t)p * cs.tdx, cs.x0));
  t.y0 = static_cast<int32_t>(std::max<int64_t>((int64_t)cs.ty0 + (int64_t)q * cs.tdy, cs.y0));
  t.x1 = static_cast<int32_t>(std::min<int64_t>((int64_t)cs.tx0 + (int64_t)(p + 1) * cs.tdx, cs.x1));
  t.y1 = static_cast<int32_t>(std::min<int64_t>((int64_t)cs.ty0 + (int64_t)(q + 1) * cs.tdy, cs.y1));
  uint32_t nc = static_cast<uint32_t>(cs.comps.size());
  t.comps.resize(nc);
  for (uint32_t c = 0; c < nc; ++c)
    init_tilecomp(t.comps[c], cs.comps[c], tcp.tccps[c], t.x0, t.y0, t.x1, t.y1);
  // packet headers from PPT (Zppt order) or PPM
  std::vector<uint8_t> ppt;
  size_t ppt_pos = 0;
  HeaderSource hs_ppt{nullptr, 0, &ppt_pos}, *hs = nullptr;
  HeaderSource hs_ppm{cs.ppm_data.data(), cs.ppm_data.size(), &cs.ppm_pos};
  if (cs.ppm) {
    hs = &hs_ppm;
  } else if (!tcp.ppt.empty()) {
    std::stable_sort(tcp.ppt.begin(), tcp.ppt.end(),
                     [](const auto &a, const auto &b) { return a.first < b.first; });
    for (auto &m : tcp.ppt) ppt.insert(ppt.end(), m.second.begin(), m.second.end());
    hs_ppt.data = ppt.data();
    hs_ppt.len = ppt.size();
    hs = &hs_ppt;
  }
  std::vector<Packet> order = packet_order(cs, tcp, tileno);
  const uint8_t *src = tcp.data.data();
  size_t left = tcp.data.size();
  for (const Packet &pk : order) {
    if (pk.layno >= tcp.numlayers) continue;
    TileComp &tc = t.comps[pk.compno];
    if (pk.resno >= tc.numres) continue;
    size_t used = decode_packet(tcp, tc, pk.compno, pk.resno, pk.precno,
                                pk.layno, src, left, hs);
    src += used;
    left -= used;
  }
  // tier 1
  T1 t1;
  for (uint32_t c = 0; c < nc; ++c) {
    TileComp &tc = t.comps[c];
    const Tccp &tccp = tcp.tccps[c];
    int32_t tw = tc.x1 - tc.x0;
    for (uint32_t r = 0; r < tc.numres; ++r) {
      Resolution &res = tc.res[r];
      for (Band &band : res.bands) {
        for (Precinct &pr : band.precincts) {
          for (Cblk &cb : pr.cblks) {
            if (cb.x1 <= cb.x0 || cb.y1 <= cb.y0) continue;
            t1.decode(cb, band.bandno, tccp.roishift, tccp.cblksty);
            int32_t *dp = t1.data.data();
            size_t n = t1.data.size();
            if (tccp.roishift) {
              if (tccp.roishift >= 31) {
                std::fill(dp, dp + n, 0);
              } else {
                int32_t thresh = 1 << tccp.roishift;
                for (size_t i = 0; i < n; ++i) {
                  int32_t val = dp[i];
                  int32_t mag = val < 0 ? -val : val;
                  if (mag >= thresh) {
                    mag >>= tccp.roishift;
                    dp[i] = val < 0 ? -mag : mag;
                  }
                }
              }
            }
            int32_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
            if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
            if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
            int32_t cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
            if (tccp.qmfbid == 1) {
              for (int32_t j = 0; j < ch; ++j)
                for (int32_t i = 0; i < cw; ++i)
                  tc.data[(size_t)(y + j) * tw + x + i] = dp[(size_t)j * cw + i] / 2;
            } else {
              const float stepsize = 0.5f * band.stepsize;
              for (int32_t j = 0; j < ch; ++j)
                for (int32_t i = 0; i < cw; ++i) {
                  float v = static_cast<float>(dp[(size_t)j * cw + i]) * stepsize;
                  std::memcpy(&tc.data[(size_t)(y + j) * tw + x + i], &v, 4);
                }
            }
          }
        }
      }
    }
  }
  // wavelets
  for (uint32_t c = 0; c < nc; ++c) {
    if (tcp.tccps[c].qmfbid == 1)
      idwt53(t.comps[c]);
    else
      idwt97(t.comps[c]);
  }
  // component transform
  if (tcp.mct) {
    if (nc >= 3) {
      size_t n = t.comps[0].data.size();
      if (t.comps[1].data.size() != n || t.comps[2].data.size() != n ||
          t.comps[0].numres != t.comps[1].numres ||
          t.comps[0].numres != t.comps[2].numres)
        fail("Tiles don't all have the same dimension. Skip the MCT step.");
      int32_t *c0 = t.comps[0].data.data(), *c1 = t.comps[1].data.data(),
              *c2 = t.comps[2].data.data();
      if (tcp.tccps[0].qmfbid == 1) {
        for (size_t i = 0; i < n; ++i) {
          int32_t y = c0[i], u = c1[i], v = c2[i];
          int32_t g = y - ((u + v) >> 2);
          int32_t r = v + g;
          int32_t b = u + g;
          c0[i] = r;
          c1[i] = g;
          c2[i] = b;
        }
      } else {
        float *f0 = reinterpret_cast<float *>(c0),
              *f1 = reinterpret_cast<float *>(c1),
              *f2 = reinterpret_cast<float *>(c2);
        for (size_t i = 0; i < n; ++i) {
          float y = f0[i], u = f1[i], v = f2[i];
          float r = y + (v * 1.402f);
          float g = y - (u * 0.34413f) - (v * (0.71414f));
          float b = y + (u * 1.772f);
          f0[i] = r;
          f1[i] = g;
          f2[i] = b;
        }
      }
    }
  }
  // DC level shift and clamp
  for (uint32_t c = 0; c < nc; ++c) {
    const Comp &comp = cs.comps[c];
    TileComp &tc = t.comps[c];
    int32_t mn, mx;
    if (comp.sgnd) {
      mn = -(1 << (comp.prec - 1));
      mx = (1 << (comp.prec - 1)) - 1;
    } else {
      mn = 0;
      mx = static_cast<int32_t>((1u << comp.prec) - 1);
    }
    int32_t shift = comp.sgnd ? 0 : 1 << (comp.prec - 1);
    if (tcp.tccps[c].qmfbid == 1) {
      for (int32_t &v : tc.data)
        v = static_cast<int32_t>(std::max<int64_t>(mn, std::min<int64_t>(mx, (int64_t)v + shift)));
    } else {
      for (int32_t &v : tc.data) {
        float f;
        std::memcpy(&f, &v, 4);
        if (f > static_cast<float>(INT32_MAX)) {
          v = mx;
        } else if (f < static_cast<float>(INT32_MIN)) {
          v = mn;
        } else {
          int64_t iv = static_cast<int64_t>(lrintf(f));
          v = static_cast<int32_t>(std::max<int64_t>(mn, std::min<int64_t>(mx, iv + shift)));
        }
      }
    }
  }
  return t;
}

// ---------------------------------------------------------------------------
// the codestream's markers (OpenJPEG's j2k.c)

enum : uint32_t {
  M_SOC = 0xff4f, M_SIZ = 0xff51, M_COD = 0xff52, M_COC = 0xff53,
  M_TLM = 0xff55, M_PLM = 0xff57, M_PLT = 0xff58, M_QCD = 0xff5c,
  M_QCC = 0xff5d, M_RGN = 0xff5e, M_POC = 0xff5f, M_PPM = 0xff60,
  M_PPT = 0xff61, M_CRG = 0xff63, M_COM = 0xff64, M_SOT = 0xff90,
  M_SOD = 0xff93, M_EOC = 0xffd9, M_CAP = 0xff50, M_CPF = 0xff59,
  M_CBD = 0xff78, M_MCT = 0xff74, M_MCC = 0xff75, M_MCO = 0xff77,
};

// Zppm (Zppt) and at least one byte of packet headers, as OpenJPEG asks
void read_ppm(Codestream &cs, Reader &r, uint32_t len) {
  if (len < 4) fail("Error reading PPM marker");
  uint32_t z = r.u8();
  std::vector<uint8_t> d(r.p + r.pos, r.p + r.pos + (len - 3));
  r.pos += len - 3;
  cs.ppm_markers.emplace_back(z, std::move(d));
  cs.ppm = true;
}

void merge_ppm(Codestream &cs) {
  std::stable_sort(cs.ppm_markers.begin(), cs.ppm_markers.end(),
                   [](const auto &a, const auto &b) { return a.first < b.first; });
  uint32_t remaining = 0;
  for (auto &m : cs.ppm_markers) {
    const uint8_t *d = m.second.data();
    size_t n = m.second.size();
    if (remaining >= n) {
      cs.ppm_data.insert(cs.ppm_data.end(), d, d + n);
      remaining -= static_cast<uint32_t>(n);
      continue;
    }
    cs.ppm_data.insert(cs.ppm_data.end(), d, d + remaining);
    d += remaining;
    n -= remaining;
    remaining = 0;
    while (n > 0) {
      if (n < 4) fail("Not enough bytes to read Nppm");
      uint32_t nppm = (d[0] << 24) | (d[1] << 16) | (d[2] << 8) | d[3];
      d += 4;
      n -= 4;
      if (n >= nppm) {
        cs.ppm_data.insert(cs.ppm_data.end(), d, d + nppm);
        d += nppm;
        n -= nppm;
      } else {
        cs.ppm_data.insert(cs.ppm_data.end(), d, d + n);
        remaining = static_cast<uint32_t>(nppm - n);
        n = 0;
      }
    }
  }
}

// the main header, up to the first SOT; r stops at the SOT marker
void read_main_header(Codestream &cs, Reader &r) {
  if (r.u16() != M_SOC) fail("Expected a SOC marker");
  if (r.u16() != M_SIZ) fail("Expected a SIZ marker");
  uint32_t len = r.u16();
  read_siz(cs, r, len);
  bool cod = false, qcd = false;
  for (;;) {
    size_t at = r.pos;
    uint32_t m = r.u16();
    if (m == M_SOT) {
      r.pos = at;
      break;
    }
    if (m < 0xff00) fail("A marker ID was expected (0xff--) instead of another value");
    uint32_t l = r.u16();
    if (l < 2 || r.pos + l - 2 > r.n) fail("Marker size inconsistent with stream length");
    switch (m) {
      case M_COD: read_cod(cs.dflt, r, l); cod = true; break;
      case M_COC: read_coc(cs, cs.dflt, r, l); break;
      case M_QCD: read_qcd(cs.dflt, r, l); qcd = true; break;
      case M_QCC: read_qcc(cs, cs.dflt, r, l); break;
      case M_RGN: read_rgn(cs, cs.dflt, r, l); break;
      case M_POC: read_poc(cs, cs.dflt, r, l); break;
      case M_PPM: read_ppm(cs, r, l); break;
      case M_MCT: case M_MCC: case M_MCO: case M_CBD:
        fail("Part 2 multiple component transforms are not supported");
      default: r.pos += l - 2; break;  // TLM, PLM, CRG, COM, CAP, CPF, ...
    }
  }
  if (!cod) fail("required COD marker not found in main header");
  if (!qcd) fail("required QCD marker not found in main header");
  if (cs.ppm) merge_ppm(cs);
  cs.tcps.assign((size_t)cs.tw * cs.th, Tcp());
}

// ---------------------------------------------------------------------------
// Pillow's Jpeg2KDecode.c

enum { MODE_L = 0, MODE_P, MODE_PA, MODE_I16, MODE_LA, MODE_RGB, MODE_RGBA, MODE_CMYK };
enum { CS_UNKNOWN = -1, CS_UNSPECIFIED = 0, CS_SRGB, CS_GRAY, CS_SYCC, CS_EYCC, CS_CMYK };

inline uint32_t shiftu(uint32_t x, int n) { return n < 0 ? x >> -n : x << n; }

struct Pil {
  int bpp;  // bytes a pixel in Pillow's memory
  int width, height;
  uint8_t *out;
  uint8_t *row(int y, int x) { return out + ((size_t)y * width + x) * bpp; }
};

// ImagingConvertYCbCr2RGB (Pillow's ConvertYCbCr.c, SCALE 6): r = y +
// (kRCr[cr] >> 6), g = y + ((kGCb[cb] + kGCr[cr]) >> 6), b = y +
// (kBCb[cb] >> 6), each clamped to 0..255.  Tables that give the same
// sums for every (cb, cr) as Pillow 12.1.0's (read from its
// Image.convert("RGB") of every YCbCr triple).
const int32_t kRCr[256] = {
    -11520, -11456, -11328, -11264, -11136, -11072, -11008, -10880, -10816,
    -10688, -10624, -10560, -10432, -10368, -10240, -10176, -10112, -9984,
    -9920, -9792, -9728, -9600, -9536, -9472, -9344, -9280, -9152, -9088,
    -9024, -8896, -8832, -8704, -8640, -8576, -8448, -8384, -8256, -8192,
    -8128, -8000, -7936, -7808, -7744, -7680, -7552, -7488, -7360, -7296,
    -7232, -7104, -7040, -6912, -6848, -6784, -6656, -6592, -6464, -6400,
    -6336, -6208, -6144, -6016, -5952, -5888, -5760, -5696, -5568, -5504,
    -5440, -5312, -5248, -5120, -5056, -4992, -4864, -4800, -4672, -4608,
    -4544, -4416, -4352, -4224, -4160, -4096, -3968, -3904, -3776, -3712,
    -3648, -3520, -3456, -3328, -3264, -3200, -3072, -3008, -2880, -2816,
    -2752, -2624, -2560, -2432, -2368, -2304, -2176, -2112, -1984, -1920,
    -1856, -1728, -1664, -1536, -1472, -1408, -1280, -1216, -1088, -1024, -896,
    -832, -768, -640, -576, -448, -384, -320, -192, -128, 0, 64, 128, 256, 320,
    448, 512, 576, 704, 768, 896, 960, 1024, 1152, 1216, 1344, 1408, 1472,
    1600, 1664, 1792, 1856, 1920, 2048, 2112, 2240, 2304, 2368, 2496, 2560,
    2688, 2752, 2816, 2944, 3008, 3136, 3200, 3264, 3392, 3456, 3584, 3648,
    3712, 3840, 3904, 4032, 4096, 4160, 4288, 4352, 4480, 4544, 4608, 4736,
    4800, 4928, 4992, 5056, 5184, 5248, 5376, 5440, 5504, 5632, 5696, 5824,
    5888, 5952, 6080, 6144, 6272, 6336, 6400, 6528, 6592, 6720, 6784, 6848,
    6976, 7040, 7168, 7232, 7296, 7424, 7488, 7616, 7680, 7744, 7872, 7936,
    8064, 8128, 8192, 8320, 8384, 8512, 8576, 8704, 8768, 8832, 8960, 9024,
    9152, 9216, 9280, 9408, 9472, 9600, 9664, 9728, 9856, 9920, 10048, 10112,
    10176, 10304, 10368, 10496, 10560, 10624, 10752, 10816, 10944, 11008,
    11072, 11200, 11264, 11392,
};
const int32_t kBCb[256] = {
    -14528, -14464, -14336, -14208, -14080, -13952, -13888, -13760, -13632,
    -13504, -13440, -13312, -13184, -13056, -12928, -12864, -12736, -12608,
    -12480, -12416, -12288, -12160, -12032, -11968, -11840, -11712, -11584,
    -11456, -11392, -11264, -11136, -11008, -10944, -10816, -10688, -10560,
    -10496, -10368, -10240, -10112, -9984, -9920, -9792, -9664, -9536, -9472,
    -9344, -9216, -9088, -8960, -8896, -8768, -8640, -8512, -8448, -8320,
    -8192, -8064, -8000, -7872, -7744, -7616, -7488, -7424, -7296, -7168,
    -7040, -6976, -6848, -6720, -6592, -6464, -6400, -6272, -6144, -6016,
    -5952, -5824, -5696, -5568, -5504, -5376, -5248, -5120, -4992, -4928,
    -4800, -4672, -4544, -4480, -4352, -4224, -4096, -3968, -3904, -3776,
    -3648, -3520, -3456, -3328, -3200, -3072, -3008, -2880, -2752, -2624,
    -2496, -2432, -2304, -2176, -2048, -1984, -1856, -1728, -1600, -1536,
    -1408, -1280, -1152, -1024, -960, -832, -704, -576, -512, -384, -256, -128,
    0, 64, 192, 320, 448, 512, 640, 768, 896, 960, 1088, 1216, 1344, 1472,
    1536, 1664, 1792, 1920, 1984, 2112, 2240, 2368, 2432, 2560, 2688, 2816,
    2944, 3008, 3136, 3264, 3392, 3456, 3584, 3712, 3840, 3968, 4032, 4160,
    4288, 4416, 4480, 4608, 4736, 4864, 4928, 5056, 5184, 5312, 5440, 5504,
    5632, 5760, 5888, 5952, 6080, 6208, 6336, 6464, 6528, 6656, 6784, 6912,
    6976, 7104, 7232, 7360, 7424, 7552, 7680, 7808, 7936, 8000, 8128, 8256,
    8384, 8448, 8576, 8704, 8832, 8896, 9024, 9152, 9280, 9408, 9472, 9600,
    9728, 9856, 9920, 10048, 10176, 10304, 10432, 10496, 10624, 10752, 10880,
    10944, 11072, 11200, 11328, 11392, 11520, 11648, 11776, 11904, 11968,
    12096, 12224, 12352, 12416, 12544, 12672, 12800, 12928, 12992, 13120,
    13248, 13376, 13440, 13568, 13696, 13824, 13888, 14016, 14144, 14272,
    14400,
};
const int32_t kGCb[256] = {
    -2963, -2973, -3019, -3027, -3073, -3083, -3093, -3137, -3147, -3159,
    -3201, -3213, -3223, -3266, -3279, -3287, -3332, -3343, -3352, -3398,
    -3407, -3418, -3462, -3472, -3483, -3526, -3538, -3547, -3593, -3603,
    -3612, -3659, -3667, -3678, -3723, -3732, -3777, -3787, -3798, -3841,
    -3852, -3863, -3905, -3918, -3927, -3971, -3983, -3991, -4037, -4047,
    -4057, -4102, -4111, -4123, -4166, -4177, -4187, -4231, -4243, -4251,
    -4297, -4307, -4316, -4363, -4371, -4382, -4427, -4436, -4481, -4491,
    -4503, -4545, -4557, -4567, -4610, -4623, -4631, -4676, -4687, -4696,
    -4742, -4751, -4762, -4806, -4816, -4827, -4870, -4882, -4891, -4936,
    -4947, -4955, -5002, -5011, -5021, -5067, -5075, -5121, -5131, -5141,
    -5185, -5195, -5207, -5249, -5261, -5271, -5314, -5327, -5335, -5381,
    -5391, -5401, -5446, -5455, -5467, -5510, -5521, -5531, -5575, -5587,
    -5595, -5641, -5651, -5660, -5707, -5715, -5726, -5771, -5780, -5825,
    -5835, -5845, -5889, -5899, -5911, -5953, -5965, -5975, -6018, -6031,
    -6039, -6084, -6095, -6104, -6150, -6159, -6170, -6214, -6224, -6235,
    -6279, -6291, -6299, -6345, -6355, -6364, -6411, -6419, -6430, -6475,
    -6484, -6529, -6539, -6550, -6593, -6604, -6615, -6657, -6670, -6679,
    -6723, -6735, -6743, -6789, -6799, -6809, -6854, -6863, -6875, -6918,
    -6929, -6939, -6983, -6995, -7003, -7049, -7059, -7068, -7115, -7123,
    -7169, -7179, -7189, -7233, -7243, -7255, -7297, -7309, -7319, -7362,
    -7375, -7383, -7428, -7439, -7448, -7494, -7503, -7514, -7558, -7568,
    -7579, -7622, -7634, -7643, -7688, -7699, -7707, -7754, -7763, -7773,
    -7819, -7827, -7873, -7883, -7893, -7937, -7947, -7959, -8001, -8014,
    -8023, -8067, -8079, -8087, -8133, -8143, -8153, -8198, -8207, -8219,
    -8262, -8273, -8283, -8327, -8339, -8347, -8393, -8403, -8412, -8459,
    -8467, -8478, -8523, -8532, -8577, -8587,
};
const int32_t kGCr[256] = {
    11649, 11595, 11539, 11483, 11462, 11407, 11351, 11329, 11275, 11219,
    11163, 11142, 11087, 11031, 11009, 10955, 10899, 10843, 10823, 10767,
    10711, 10689, 10635, 10579, 10523, 10503, 10447, 10391, 10369, 10315,
    10259, 10203, 10183, 10127, 10071, 10050, 9995, 9939, 9883, 9863, 9807,
    9751, 9730, 9675, 9619, 9564, 9543, 9487, 9431, 9410, 9355, 9299, 9244,
    9223, 9167, 9111, 9090, 9035, 8979, 8924, 8903, 8847, 8792, 8770, 8715,
    8659, 8604, 8583, 8527, 8472, 8450, 8395, 8339, 8284, 8263, 8207, 8152,
    8130, 8075, 8020, 7964, 7943, 7887, 7832, 7810, 7755, 7700, 7644, 7623,
    7567, 7512, 7490, 7435, 7380, 7324, 7303, 7248, 7192, 7170, 7115, 7060,
    7004, 6983, 6928, 6872, 6850, 6796, 6740, 6684, 6663, 6608, 6552, 6530,
    6476, 6420, 6364, 6343, 6288, 6232, 6210, 6156, 6100, 6044, 6024, 5968,
    5912, 5890, 5836, 5780, 5725, 5705, 5649, 5593, 5571, 5517, 5461, 5405,
    5385, 5329, 5273, 5252, 5197, 5141, 5085, 5065, 5009, 4953, 4932, 4877,
    4821, 4765, 4745, 4689, 4633, 4612, 4557, 4501, 4446, 4425, 4369, 4313,
    4292, 4237, 4181, 4126, 4105, 4049, 3994, 3972, 3917, 3861, 3806, 3785,
    3729, 3674, 3652, 3597, 3541, 3486, 3465, 3409, 3354, 3332, 3277, 3222,
    3166, 3145, 3089, 3034, 3012, 2957, 2902, 2846, 2825, 2769, 2714, 2692,
    2637, 2582, 2526, 2505, 2450, 2394, 2372, 2317, 2262, 2206, 2185, 2130,
    2074, 2052, 1997, 1942, 1886, 1865, 1810, 1754, 1732, 1678, 1622, 1566,
    1545, 1490, 1434, 1412, 1358, 1302, 1246, 1226, 1170, 1114, 1092, 1038,
    982, 926, 906, 850, 794, 772, 718, 662, 606, 586, 530, 474, 453, 398, 342,
    286, 266, 210, 154, 133, 78, 22, 0,
};

void ycbcr2rgb(uint8_t *p, int n) {
  for (int x = 0; x < n; ++x, p += 4) {
    int y = p[0], cb = p[1], cr = p[2];
    int r = y + (kRCr[cr] >> 6);
    int g = y + ((kGCb[cb] + kGCr[cr]) >> 6);
    int b = y + (kBCb[cb] >> 6);
    p[0] = static_cast<uint8_t>(r <= 0 ? 0 : r >= 255 ? 255 : r);
    p[1] = static_cast<uint8_t>(g <= 0 ? 0 : g >= 255 ? 255 : g);
    p[2] = static_cast<uint8_t>(b <= 0 ? 0 : b >= 255 ? 255 : b);
  }
}

// Pillow's j2k_unpackers table -> the unpacker: 0 gray_l, 1 gray_i,
// 2 gray_rgb, 3 graya_la, 4 srgb_rgb, 5 sycc_rgb, 6 srgba_rgba (also
// CMYK), 7 sycca_rgba; -1 where no row matches
int pick_unpacker(int mode, int cs, uint32_t nc, bool subsampled) {
  struct Row { int mode, cs; uint32_t nc; int sub, kind; };
  static const Row table[] = {
      {MODE_L, CS_GRAY, 1, 0, 0},      {MODE_P, CS_SRGB, 1, 0, 0},
      {MODE_PA, CS_SRGB, 2, 0, 3},     {MODE_I16, CS_GRAY, 1, 0, 1},
      {MODE_LA, CS_GRAY, 2, 0, 3},     {MODE_RGB, CS_GRAY, 1, 0, 2},
      {MODE_RGB, CS_GRAY, 2, 0, 2},    {MODE_RGB, CS_SRGB, 3, 1, 4},
      {MODE_RGB, CS_SYCC, 3, 1, 5},    {MODE_RGB, CS_SRGB, 4, 1, 4},
      {MODE_RGB, CS_SYCC, 4, 1, 5},    {MODE_RGBA, CS_GRAY, 1, 0, 2},
      {MODE_RGBA, CS_GRAY, 2, 0, 3},   {MODE_RGBA, CS_SRGB, 3, 1, 4},
      {MODE_RGBA, CS_SYCC, 3, 1, 5},   {MODE_RGBA, CS_SRGB, 4, 1, 6},
      {MODE_RGBA, CS_SYCC, 4, 1, 7},   {MODE_CMYK, CS_CMYK, 4, 1, 6},
  };
  for (const Row &r : table)
    if (r.cs == cs && r.nc == nc && (r.sub || !subsampled) && r.mode == mode)
      return r.kind;
  return -1;
}

uint32_t word_at(const uint8_t *p, int csiz) {
  uint32_t v;
  switch (csiz) {
    case 1: return p[0];
    case 2: { uint16_t s; std::memcpy(&s, p, 2); return s; }
    default: std::memcpy(&v, p, 4); return v;
  }
}

void unpack(int kind, const std::vector<Comp> &comps, int32_t img_x0,
            int32_t img_y0, const DecodedTile &tile, const uint8_t *tiledata,
            size_t tilesize, Pil &im) {
  unsigned x0 = tile.x0 - img_x0, y0 = tile.y0 - img_y0;
  unsigned w = tile.x1 - tile.x0, h = tile.y1 - tile.y0;
  auto setup = [&](uint32_t n, int target, int &shift, uint32_t &offset, int &csiz) {
    shift = target - static_cast<int>(comps[n].prec);
    offset = comps[n].sgnd ? 1u << (comps[n].prec - 1) : 0;
    csiz = static_cast<int>((comps[n].prec + 7) >> 3);
    if (csiz == 3) csiz = 4;
    if (shift < 0) offset += 1u << (-shift - 1);
  };
  auto check = [&](size_t end) {
    if (end > tilesize) fail("the unpacker reads past the tile buffer");
  };
  if (kind == 0 || kind == 1 || kind == 2) {
    int shift, csiz;
    uint32_t offset;
    setup(0, kind == 1 ? 16 : 8, shift, offset, csiz);
    check((size_t)csiz * w * h);
    for (unsigned y = 0; y < h; ++y) {
      const uint8_t *data = tiledata + (size_t)csiz * y * w;
      for (unsigned x = 0; x < w; ++x) {
        uint32_t v = shiftu(offset + word_at(data + (size_t)csiz * x, csiz), shift);
        uint8_t *px = im.row(y0 + y, x0 + x);
        if (kind == 0) {
          px[0] = static_cast<uint8_t>(v);
        } else if (kind == 1) {
          uint16_t s = static_cast<uint16_t>(v);
          std::memcpy(px, &s, 2);
        } else {
          px[0] = px[1] = px[2] = static_cast<uint8_t>(v);
          px[3] = 0xff;
        }
      }
    }
    return;
  }
  if (kind == 3) {
    int shift, csiz, ashift, acsiz;
    uint32_t offset, aoffset;
    setup(0, 8, shift, offset, csiz);
    setup(1, 8, ashift, aoffset, acsiz);
    const uint8_t *atiledata = tiledata + (size_t)csiz * w * h;
    check((size_t)csiz * w * h + (size_t)acsiz * w * h);
    for (unsigned y = 0; y < h; ++y) {
      const uint8_t *data = tiledata + (size_t)csiz * y * w;
      const uint8_t *adata = atiledata + (size_t)acsiz * y * w;
      for (unsigned x = 0; x < w; ++x) {
        uint32_t word = word_at(data + (size_t)csiz * x, csiz);
        uint32_t aword = word_at(adata + (size_t)acsiz * x, acsiz);
        uint8_t *px = im.row(y0 + y, x0 + x);
        uint8_t byte = static_cast<uint8_t>(shiftu(offset + word, shift));
        px[0] = px[1] = px[2] = byte;
        px[3] = static_cast<uint8_t>(shiftu(aoffset + aword, ashift));
      }
    }
    return;
  }
  // srgb_rgb, sycc_rgb, srgba_rgba, sycca_rgba
  int nb = (kind == 4 || kind == 5) ? 3 : 4;
  int shifts[4], csiz[4];
  uint32_t offsets[4], dx[4], dy[4];
  const uint8_t *cdata[4];
  const uint8_t *cptr = tiledata;
  for (int n = 0; n < nb; ++n) {
    cdata[n] = cptr;
    setup(static_cast<uint32_t>(n), 8, shifts[n], offsets[n], csiz[n]);
    dx[n] = comps[n].dx;
    dy[n] = comps[n].dy;
    cptr += (size_t)csiz[n] * (w / dx[n]) * (h / dy[n]);
  }
  check(static_cast<size_t>(cptr - tiledata));
  for (unsigned y = 0; y < h; ++y) {
    const uint8_t *data[4];
    uint8_t *row = im.row(y0 + y, x0);
    for (int n = 0; n < nb; ++n)
      data[n] = cdata[n] + (size_t)csiz[n] * (y / dy[n]) * (w / dx[n]);
    for (unsigned x = 0; x < w; ++x) {
      uint8_t *px = row + (size_t)x * 4;
      for (int n = 0; n < nb; ++n) {
        uint32_t word = word_at(data[n] + (size_t)csiz[n] * (x / dx[n]), csiz[n]);
        px[n] = static_cast<uint8_t>(shiftu(offsets[n] + word, shifts[n]));
      }
      if (nb == 3) px[3] = 0xff;
    }
    if (kind == 5 || kind == 7) ycbcr2rgb(row, static_cast<int>(w));
  }
}

// OpenJPEG's opj_tcd_update_tile_data into Pillow's buffer
void write_tile_data(const Codestream &cs, const DecodedTile &t,
                     std::vector<uint8_t> &buf) {
  uint8_t *p = buf.data();
  for (size_t c = 0; c < cs.comps.size(); ++c) {
    const Comp &comp = cs.comps[c];
    uint32_t size = (comp.prec + 7) >> 3;
    if (size == 3) size = 4;
    for (int32_t v : t.comps[c].data) {
      if (size == 1) {
        *p++ = static_cast<uint8_t>(v);
      } else if (size == 2) {
        uint16_t s = static_cast<uint16_t>(v);
        std::memcpy(p, &s, 2);
        p += 2;
      } else {
        std::memcpy(p, &v, 4);
        p += 4;
      }
    }
  }
}

size_t decoded_tile_size(const Codestream &cs, const DecodedTile &t) {
  size_t n = 0;
  for (size_t c = 0; c < cs.comps.size(); ++c) {
    uint32_t size = (cs.comps[c].prec + 7) >> 3;
    if (size == 3) size = 4;
    n += t.comps[c].data.size() * size;
  }
  return n;
}

void set_error(char *err, int errlen, const std::string &msg) {
  if (errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

void decode_all(const uint8_t *data, size_t n, int mode, int color_space,
                int width, int height, uint8_t *out) {
  Codestream cs;
  Reader r(data, n);
  read_main_header(cs, r);
  uint32_t nc = static_cast<uint32_t>(cs.comps.size());
  // Pillow's checks before the first tile
  if (nc < 1 || nc > 4) fail("Pillow takes 1 to 4 components");
  int subsampling = -1;
  for (uint32_t c = 0; c < nc; ++c)
    if (cs.comps[c].dx != 1 || cs.comps[c].dy != 1) {
      subsampling = static_cast<int>(c);
      break;
    }
  // no colr box, an ICC profile or an EnumCS that OpenJPEG does not map
  // decode as a codestream's components do
  int cspace = color_space;
  if (cspace == CS_UNSPECIFIED || cspace == CS_UNKNOWN) {
    if (nc == 1 || nc == 2)
      cspace = CS_GRAY;
    else
      cspace = subsampling > -1 ? CS_SYCC : CS_SRGB;
  }
  int kind = pick_unpacker(mode, cspace, nc, subsampling > -1);
  if (kind < 0) fail("Pillow has no unpacker for the mode, colour space and components");
  Pil im;
  im.bpp = mode == MODE_L || mode == MODE_P ? 1 : mode == MODE_I16 ? 2 : 4;
  im.width = width;
  im.height = height;
  im.out = out;
  std::memset(out, 0, (size_t)width * height * im.bpp);
  std::vector<uint8_t> buffer;  // Pillow's state->buffer
  auto emit = [&](uint32_t tileno) {
    Tcp &tcp = cs.tcps[tileno];
    DecodedTile t = decode_tile(cs, tileno);
    tcp.decoded = true;
    tcp.data.clear();
    tcp.data.shrink_to_fit();
    if (t.x0 >= t.x1 || t.y0 >= t.y1 || t.x0 < cs.x0 || t.y0 < cs.y0 ||
        t.x1 - cs.x0 > width || t.y1 - cs.y0 > height)
      fail("a tile lies outside Pillow's image");
    uint32_t total = 0;
    for (const Comp &c : cs.comps) {
      uint32_t s = (c.prec + 7) >> 3;
      total += s == 3 ? 4 : s;
    }
    size_t data_size = decoded_tile_size(cs, t);
    size_t tile_bytes = (size_t)(t.x1 - t.x0) * (t.y1 - t.y0) * total;
    data_size = std::max(data_size, tile_bytes);
    if (buffer.size() < data_size) buffer.assign(data_size, 0);
    write_tile_data(cs, t, buffer);
    unpack(kind, cs.comps, cs.x0, cs.y0, t, buffer.data(), buffer.size(), im);
  };
  // tile-parts
  for (;;) {
    uint32_t m = r.u16();
    if (m == M_EOC) break;
    if (m != M_SOT) fail("Expected a SOT or EOC marker");
    size_t sot_start = r.pos - 2;
    uint32_t lsot = r.u16();
    if (lsot != 10) fail("Error reading SOT marker");
    uint32_t tileno = r.u16();
    uint32_t psot = r.u32();
    uint32_t tpsot = r.u8();
    uint32_t tnsot = r.u8();
    if (tileno >= cs.tcps.size()) fail("Tile index is out of range");
    if (psot != 0 && psot < 14) fail("Psot value is not correct regards to the JPEG2000 norm");
    Tcp &tcp = cs.tcps[tileno];
    if (tcp.decoded) fail("a tile-part arrives after its tile was decoded");
    if (!tcp.seen) {  // the tile's parameters start as the main header's
      tcp = cs.dflt;
      tcp.seen = true;
    }
    if (tcp.nb_tile_parts != 0 && tpsot >= tcp.nb_tile_parts)
      fail("In SOT marker, TPSot is not valid regards to the previous number of tile-part");
    if (tnsot != 0) {
      if (tpsot >= tnsot)
        fail("In SOT marker, TPSot is not valid regards to the current number of tile-part (header)");
      tcp.nb_tile_parts = tnsot;
    }
    size_t end;
    if (psot == 0) {
      if (n < 2 || n - 2 < r.pos) fail("Stream too short");
      end = n - 2;  // the last tile-part: up to EOC
    } else {
      end = sot_start + psot;
      if (end > n) fail("Tile part length size inconsistent with stream length");
    }
    // tile-part header
    for (;;) {
      uint32_t mk = r.u16();
      if (mk == M_SOD) break;
      if (mk < 0xff00) fail("A marker ID was expected (0xff--) instead of another value");
      uint32_t l = r.u16();
      if (l < 2 || r.pos + l - 2 > end) fail("Sot length is less than marker size + marker ID");
      switch (mk) {
        case M_COD: read_cod(tcp, r, l); break;
        case M_COC: read_coc(cs, tcp, r, l); break;
        case M_QCD: read_qcd(tcp, r, l); break;
        case M_QCC: read_qcc(cs, tcp, r, l); break;
        case M_RGN: read_rgn(cs, tcp, r, l); break;
        case M_POC: read_poc(cs, tcp, r, l); break;
        case M_PPT: {
          if (l < 4) fail("Error reading PPT marker");
          if (cs.ppm) fail("Error reading PPT marker: packet header have been previously found in the main header (PPM marker).");
          uint32_t z = r.u8();
          tcp.ppt.emplace_back(z, std::vector<uint8_t>(r.p + r.pos, r.p + r.pos + l - 3));
          r.pos += l - 3;
          break;
        }
        case M_SIZ: case M_TLM: case M_PLM: case M_PPM:
          fail("Marker is not compliant with its position");
        default: r.pos += l - 2; break;  // PLT, COM, ...
      }
    }
    if (r.pos > end) fail("Stream too short");
    tcp.data.insert(tcp.data.end(), data + r.pos, data + end);
    r.pos = end;
    if (tcp.nb_tile_parts && tcp.nb_tile_parts == tpsot + 1) emit(tileno);
    if (psot == 0) {
      if (r.u16() != M_EOC) fail("Stream does not end with EOC");
      break;
    }
  }
  // the tiles whose tile-part count was not given, in index order
  for (uint32_t i = 0; i < cs.tcps.size(); ++i)
    if (cs.tcps[i].seen && !cs.tcps[i].decoded) emit(i);
}

}  // namespace

extern "C" int mods_j2k_decode(const uint8_t *data, int64_t n, int mode,
                               int color_space, int width, int height,
                               uint8_t *out, char *err, int errlen) {
  try {
    decode_all(data, static_cast<size_t>(n), mode, color_space, width, height,
               out);
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, e.what());
  }
  return -1;
}
