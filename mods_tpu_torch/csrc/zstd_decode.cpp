// Zstandard frames (RFC 8878) for io/tiff.py's compression 50000, bound
// with ctypes: the bytes that libzstd 1.5.7 gives, with no dictionary and
// its default limits, on an x86-64 host with BMI2.
//   - mods_zstd_decode: ZSTD_decompress, every frame of the input
//     (skippable frames skipped), each frame's matches confined to its own
//     output;
//   - mods_zstd_decode_strip: libtiff 4.7's ZSTDDecode for one strip or
//     tile, which calls ZSTD_decompressStream until the output is full or
//     a frame ends: the first frame only (a skippable frame first gives
//     nothing), the whole frame at once where its content size is known
//     and fits (libzstd's single-pass shortcut), else block by block with
//     the window limited to 2^27 (ZSTD_WINDOWLOG_LIMIT_DEFAULT) and each
//     block to the frame's block size, stopping once the output is full;
//     bytes after the frame are ignored.
// Both take (in, n, out, cap, err, errlen) and return the bytes written,
// or -1 with a message in err.  Where the RFC leaves a malformed input's
// outcome to the decoder, libzstd's is taken: its bit containers (the
// 64-bit BIT_DStream, whose reads past a stream's start wrap around the
// container), its Huffman decoders (X1 or X2 by HUF_selectDecoder's
// timing table; the 4-stream fast loop, which checks only each stream's
// output length and reads past a stream's start into the bytes below it,
// and the checked loops elsewhere; X2's last symbol that may end past the
// stream), its FSE header reader, and the output limit of a compressed
// block, which depends on where the literals are buffered.  Each input
// byte is read inside the input, each output byte written inside `cap`.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string &m) { throw Error{m}; }

// the counters that tests read (mods_zstd_coverage), in this order
enum Cov {
  kBlockRaw, kBlockRle, kBlockCompressed,
  kLitRaw, kLitRle, kLitHuffman, kLitTreeless, kLit1Stream, kLit4Streams,
  kLLPredefined, kLLRle, kLLFse, kLLRepeat,
  kOFPredefined, kOFRle, kOFFse, kOFRepeat,
  kMLPredefined, kMLRle, kMLFse, kMLRepeat,
  kRepeatOffset1, kRepeatOffset2, kRepeatOffset3,
  kFrames, kSkippableFrames, kSingleSegment, kWindowed, kChecksums,
  kHuffmanX1, kHuffmanX2, kHuffmanFast,
  kCovCount
};
std::atomic<int64_t> g_cov[kCovCount];

inline void count(Cov c) { g_cov[c].fetch_add(1, std::memory_order_relaxed); }

inline uint32_t rd16(const uint8_t *p) { return p[0] | p[1] << 8; }
inline uint32_t rd24(const uint8_t *p) { return p[0] | p[1] << 8 | p[2] << 16; }
inline uint32_t rd32(const uint8_t *p) {
  return p[0] | p[1] << 8 | p[2] << 16 | static_cast<uint32_t>(p[3]) << 24;
}
inline uint64_t rd64(const uint8_t *p) {
  uint64_t v;
  memcpy(&v, p, 8);
  return v;  // little-endian host
}
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------------------
// XXH64 of the frame's content (its low 32 bits end a checksummed frame)

const uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
               P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
               P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return x << r | x >> (64 - r); }
inline uint64_t xround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xmerge(uint64_t acc, uint64_t v) {
  return (acc ^ xround(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t *p, size_t n) {
  const uint8_t *end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (end - p >= 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
  } else {
    h = P5;
  }
  h += n;
  while (end - p >= 8) {
    h ^= xround(0, rd64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h ^= static_cast<uint64_t>(rd32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= *p++ * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// libzstd's backward bit container (BIT_DStream_t): 64 bits loaded from
// `ptr`, read from the top down; `consumed` past 64 means overflow.  The
// buffer is [lo, hi): every 8-byte load is checked against it.

enum { kUnfinished = 0, kEndOfBuffer = 1, kCompleted = 2, kOverflow = 3 };

struct BitD {
  uint64_t c = 0;
  uint32_t consumed = 0;
  const uint8_t *ptr = nullptr, *start = nullptr, *lo = nullptr, *hi = nullptr;
  bool zero_filled = false;  // ptr at libzstd's static zero word

  uint64_t load(const uint8_t *p) const {
    if (p < lo || p + 8 > hi) fail("zstd: internal read out of bounds");
    return rd64(p);
  }
  // BIT_initDStream; false where the stream is empty or has no end mark
  bool init(const uint8_t *src, size_t n, const uint8_t *buf_lo,
            const uint8_t *buf_hi) {
    lo = buf_lo;
    hi = buf_hi;
    start = src;
    zero_filled = false;
    if (n < 1) return false;
    uint8_t last = src[n - 1];
    if (n >= 8) {
      ptr = src + n - 8;
      c = load(ptr);
      consumed = last ? 8 - highbit(last) : 0;
      return last != 0;
    }
    ptr = src;
    c = src[0];
    for (size_t i = 1; i < n; i++) c += static_cast<uint64_t>(src[i]) << (8 * i);
    consumed = last ? 8 - highbit(last) : 0;
    if (!last) return false;
    consumed += static_cast<uint32_t>(8 - n) * 8;
    return true;
  }
  uint64_t look(uint32_t nb) const {  // BIT_lookBits
    uint32_t s = (64 - consumed - nb) & 63;
    return nb ? (c >> s) & ((nb == 64) ? ~0ULL : ((1ULL << nb) - 1)) : 0;
  }
  uint64_t look_fast(uint32_t nb) const {  // BIT_lookBitsFast, nb >= 1
    return (c << (consumed & 63)) >> ((64 - nb) & 63);
  }
  uint64_t read(uint32_t nb) {
    uint64_t v = look(nb);
    consumed += nb;
    return v;
  }
  uint64_t read_fast(uint32_t nb) {
    uint64_t v = look_fast(nb);
    consumed += nb;
    return v;
  }
  void skip(uint32_t nb) { consumed += nb; }
  int reload() {  // BIT_reloadDStream
    if (consumed > 64) {
      zero_filled = true;
      return kOverflow;
    }
    if (zero_filled) fail("zstd: internal read of an overflowed stream");
    if (ptr >= start + 8) {
      ptr -= consumed >> 3;
      consumed &= 7;
      c = load(ptr);
      return kUnfinished;
    }
    if (ptr == start) return consumed < 64 ? kEndOfBuffer : kCompleted;
    uint32_t nbytes = consumed >> 3;
    int result = kUnfinished;
    if (ptr - nbytes < start) {
      nbytes = static_cast<uint32_t>(ptr - start);
      result = kEndOfBuffer;
    }
    ptr -= nbytes;
    consumed -= nbytes * 8;
    c = load(ptr);
    return result;
  }
  bool end() const { return !zero_filled && ptr == start && consumed == 64; }
};

// ---------------------------------------------------------------------------
// FSE (tANS) tables

// FSE_readNCount as libzstd reads it (including its reads near the end of
// a short header); returns the header's size.  max: in the largest symbol
// allowed, out the largest present.
size_t read_ncount(int16_t *norm, unsigned *max, unsigned *table_log,
                   const uint8_t *src, size_t size) {
  if (size < 8) {
    uint8_t buf[8] = {0};
    memcpy(buf, src, size);
    size_t n = read_ncount(norm, max, table_log, buf, 8);
    if (n > size) fail("zstd: FSE table header is truncated");
    return n;
  }
  const uint8_t *const istart = src, *const iend = src + size;
  const uint8_t *ip = src;
  unsigned const maxsv1 = *max + 1;
  memset(norm, 0, maxsv1 * sizeof(norm[0]));
  uint32_t bits = rd32(ip);
  int nb = (bits & 0xF) + 5;
  if (nb > 15) fail("zstd: FSE table log too large");
  bits >>= 4;
  int bitcount = 4;
  *table_log = nb;
  int remaining = (1 << nb) + 1, threshold = 1 << nb;
  nb++;
  unsigned charnum = 0;
  bool previous0 = false;
  auto advance = [&]() {
    if (ip <= iend - 7 || ip + (bitcount >> 3) <= iend - 4) {
      ip += bitcount >> 3;
      bitcount &= 7;
    } else {
      bitcount -= static_cast<int>(8 * (iend - 4 - ip));
      bitcount &= 31;
      ip = iend - 4;
    }
    bits = rd32(ip) >> bitcount;
  };
  for (;;) {
    if (previous0) {
      int repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      while (repeats >= 12) {
        charnum += 3 * 12;
        if (ip <= iend - 7) {
          ip += 3;
        } else {
          bitcount -= static_cast<int>(8 * (iend - 7 - ip));
          bitcount &= 31;
          ip = iend - 4;
        }
        bits = rd32(ip) >> bitcount;
        repeats = __builtin_ctz(~bits | 0x80000000u) >> 1;
      }
      charnum += 3 * repeats;
      bits >>= 2 * repeats;
      bitcount += 2 * repeats;
      charnum += bits & 3;
      bitcount += 2;
      if (charnum >= maxsv1) break;
      advance();
    }
    {
      int const mx = (2 * threshold - 1) - remaining;
      int cnt;
      if (static_cast<int>(bits & (threshold - 1)) < mx) {
        cnt = bits & (threshold - 1);
        bitcount += nb - 1;
      } else {
        cnt = bits & (2 * threshold - 1);
        if (cnt >= threshold) cnt -= mx;
        bitcount += nb;
      }
      cnt--;
      if (cnt >= 0)
        remaining -= cnt;
      else
        remaining += cnt;
      norm[charnum++] = static_cast<int16_t>(cnt);
      previous0 = !cnt;
      if (remaining < threshold) {
        if (remaining <= 1) break;
        nb = highbit(remaining) + 1;
        threshold = 1 << (nb - 1);
      }
      if (charnum >= maxsv1) break;
      advance();
    }
  }
  if (remaining != 1) fail("zstd: FSE table header does not sum to its size");
  if (charnum > maxsv1) fail("zstd: FSE table header has too many symbols");
  if (bitcount > 32) fail("zstd: FSE table header is corrupt");
  *max = charnum - 1;
  ip += (bitcount + 7) >> 3;
  return ip - istart;
}

struct FseCell {
  uint16_t next;  // the next state's base
  uint8_t nbits;  // state bits to read
  uint8_t symbol;
};

// FSE_buildDTable / ZSTD_buildFSETable's spread: cells in decode order
std::vector<FseCell> build_fse(const int16_t *norm, unsigned max,
                               unsigned table_log) {
  unsigned const size = 1u << table_log;
  std::vector<FseCell> t(size);
  std::vector<uint16_t> next(max + 1);
  unsigned high = size - 1;
  for (unsigned s = 0; s <= max; s++) {
    if (norm[s] == -1) {
      t[high--].symbol = static_cast<uint8_t>(s);
      next[s] = 1;
    } else {
      next[s] = static_cast<uint16_t>(norm[s]);
    }
  }
  unsigned const mask = size - 1, step = (size >> 1) + (size >> 3) + 3;
  unsigned pos = 0;
  for (unsigned s = 0; s <= max; s++)
    for (int i = 0; i < norm[s]; i++) {
      t[pos].symbol = static_cast<uint8_t>(s);
      pos = (pos + step) & mask;
      while (pos > high) pos = (pos + step) & mask;
    }
  if (pos != 0) fail("zstd: FSE table does not fill");
  for (unsigned u = 0; u < size; u++) {
    unsigned const ns = next[t[u].symbol]++;
    t[u].nbits = static_cast<uint8_t>(table_log - highbit(ns));
    t[u].next = static_cast<uint16_t>((ns << t[u].nbits) - size);
  }
  return t;
}

// ---------------------------------------------------------------------------
// Huffman literals (huf_decompress.c)

const int kHufTableLogMax = 12, kHufFastLog = 11;

struct Huffman {
  bool x2 = false;     // the double-symbol table (HUF_readDTableX2)
  int log = 0;         // the table's index bits
  std::vector<uint8_t> sym, nbits, sym2, len;  // by index
};

// HUF_readStats: the weights of each symbol; returns the header's size
size_t read_weights(const uint8_t *src, size_t size, std::vector<uint8_t> &w,
                    int *table_log) {
  if (!size) fail("zstd: Huffman header is missing");
  size_t isize = src[0], osize;
  w.assign(257, 0);
  if (isize >= 128) {
    osize = isize - 127;
    isize = (osize + 1) / 2;
    if (isize + 1 > size) fail("zstd: Huffman header is truncated");
    if (osize >= 256) fail("zstd: Huffman header has too many weights");
    for (size_t i = 0; i < osize; i += 2) {
      w[i] = src[1 + i / 2] >> 4;
      w[i + 1] = src[1 + i / 2] & 15;
    }
  } else {
    if (isize + 1 > size) fail("zstd: Huffman header is truncated");
    // FSE_decompress_wksp: at most 255 weights, table log at most 6
    const uint8_t *ip = src + 1;
    int16_t norm[256];
    unsigned max = 255, tlog;
    size_t const h = read_ncount(norm, &max, &tlog, ip, isize);
    if (tlog > 6) fail("zstd: Huffman weights' table log too large");
    std::vector<FseCell> t = build_fse(norm, max, tlog);
    BitD b;
    if (!b.init(ip + h, isize - h, ip + h, ip + isize))
      fail("zstd: Huffman weights' bitstream is corrupt");
    unsigned s1 = static_cast<unsigned>(b.read(tlog));
    b.reload();
    unsigned s2 = static_cast<unsigned>(b.read(tlog));
    b.reload();
    if (b.reload() == kOverflow)
      fail("zstd: Huffman weights' bitstream is corrupt");
    auto dec = [&](unsigned &s) {
      const FseCell &e = t[s];
      s = e.next + static_cast<unsigned>(b.read(e.nbits));
      return e.symbol;
    };
    size_t op = 0;
    const size_t omax = 255;
    // the 4-symbol loop, then the tail that ends at the overflow
    for (; b.reload() == kUnfinished && op < omax - 3; op += 4) {
      w[op] = dec(s1);
      w[op + 1] = dec(s2);
      w[op + 2] = dec(s1);
      w[op + 3] = dec(s2);
    }
    for (;;) {
      if (op > omax - 2) fail("zstd: Huffman header has too many weights");
      w[op++] = dec(s1);
      if (b.reload() == kOverflow) {
        w[op++] = dec(s2);
        break;
      }
      if (op > omax - 2) fail("zstd: Huffman header has too many weights");
      w[op++] = dec(s2);
      if (b.reload() == kOverflow) {
        w[op++] = dec(s1);
        break;
      }
    }
    osize = op;
  }
  uint32_t total = 0, rank1 = 0;
  for (size_t i = 0; i < osize; i++) {
    if (w[i] > kHufTableLogMax) fail("zstd: Huffman weight too large");
    total += (1u << w[i]) >> 1;
  }
  if (!total) fail("zstd: Huffman weights are all zero");
  int const tlog = highbit(total) + 1;
  if (tlog > kHufTableLogMax) fail("zstd: Huffman table log too large");
  uint32_t const rest = (1u << tlog) - total;
  if ((1u << highbit(rest)) != rest)
    fail("zstd: Huffman weights do not complete a tree");
  w[osize] = static_cast<uint8_t>(highbit(rest) + 1);
  w.resize(osize + 1);
  for (uint8_t x : w) rank1 += x == 1;
  if (rank1 < 2 || (rank1 & 1)) fail("zstd: Huffman tree is invalid");
  *table_log = tlog;
  return isize + 1;
}

// The code of each index of `log` bits (canonical: weight-1 symbols at the
// lowest indices, by symbol within a weight): symbol and code length
void single_table(const std::vector<uint8_t> &w, int tlog, int log,
                  std::vector<uint8_t> &sym, std::vector<uint8_t> &nbits) {
  size_t const size = size_t{1} << log;
  sym.assign(size, 0);
  nbits.assign(size, 0);
  uint32_t start[kHufTableLogMax + 2] = {0}, counts[kHufTableLogMax + 2] = {0};
  for (uint8_t x : w) counts[x]++;
  uint32_t pos = 0;
  for (int k = 1; k <= tlog; k++) {
    start[k] = pos;
    pos += counts[k] << (k - 1 + log - tlog);
  }
  for (size_t s = 0; s < w.size(); s++) {
    int const k = w[s];
    if (!k) continue;
    uint32_t const n = 1u << (k - 1 + log - tlog);
    for (uint32_t i = 0; i < n; i++) {
      sym[start[k] + i] = static_cast<uint8_t>(s);
      nbits[start[k] + i] = static_cast<uint8_t>(tlog + 1 - k);
    }
    start[k] += n;
  }
}

Huffman build_huffman(const std::vector<uint8_t> &w, int tlog, bool x2) {
  Huffman h;
  h.x2 = x2;
  if (!x2) {
    // HUF_readDTableX1: rescaled to 11 bits where shorter
    h.log = tlog < kHufFastLog ? kHufFastLog : tlog;
    single_table(w, tlog, h.log, h.sym, h.nbits);
    h.len.assign(h.sym.size(), 1);
    h.sym2.assign(h.sym.size(), 0);
    return h;
  }
  // HUF_readDTableX2: an index of 11 (or 12) bits holds a second symbol
  // where that symbol's whole code fits in the bits left
  h.log = tlog <= kHufFastLog ? kHufFastLog : kHufTableLogMax;
  std::vector<uint8_t> s1, n1;
  single_table(w, tlog, h.log, s1, n1);
  size_t const size = s1.size();
  h.sym = s1;
  h.nbits = n1;
  h.sym2.assign(size, 0);
  h.len.assign(size, 1);
  for (size_t v = 0; v < size; v++) {
    int const l1 = n1[v], left = h.log - l1;
    if (left <= 0) continue;
    size_t const rest = (v << l1) & (size - 1);  // the bits after code 1
    int const l2 = n1[rest];
    if (l2 <= left) {
      h.sym2[v] = s1[rest];
      h.nbits[v] = static_cast<uint8_t>(l1 + l2);
      h.len[v] = 2;
    }
  }
  return h;
}

// HUF_selectDecoder: X2 where its estimated time is lower
bool select_x2(size_t dst, size_t csrc) {
  static const uint32_t t[16][2][2] = {
      {{0, 0}, {1, 1}},         {{0, 0}, {1, 1}},
      {{150, 216}, {381, 119}}, {{170, 205}, {514, 112}},
      {{177, 199}, {539, 110}}, {{197, 194}, {644, 107}},
      {{221, 192}, {735, 107}}, {{256, 189}, {881, 106}},
      {{359, 188}, {1167, 109}}, {{582, 187}, {1570, 114}},
      {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
      {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}},
      {{1377, 185}, {1731, 202}}, {{1412, 185}, {1695, 202}}};
  uint32_t const q = csrc >= dst ? 15 : static_cast<uint32_t>(csrc * 16 / dst);
  uint32_t const d256 = static_cast<uint32_t>(dst >> 8);
  uint32_t const t0 = t[q][0][0] + t[q][0][1] * d256;
  uint32_t t1 = t[q][1][0] + t[q][1][1] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// HUF_decodeStreamX1 / HUF_decodeStreamX2 over [p, end)
void stream_x1(const Huffman &h, BitD &b, uint8_t *p, uint8_t *end) {
  auto one = [&]() {
    size_t const v = b.look_fast(h.log);
    *p++ = h.sym[v];
    b.skip(h.nbits[v]);
  };
  if (end - p > 3) {
    while (b.reload() == kUnfinished && p < end - 3) {
      one();
      one();
      one();
      one();
    }
  } else {
    b.reload();
  }
  while (p < end) one();
}

void stream_x2(const Huffman &h, BitD &b, uint8_t *p, uint8_t *end) {
  // each step writes two bytes and moves by its length; the second of a
  // one-symbol step is written over by the next
  auto step = [&]() {
    size_t const v = b.look_fast(h.log);
    p[0] = h.sym[v];
    p[1] = h.sym2[v];
    b.skip(h.nbits[v]);
    p += h.len[v];
  };
  if (end - p >= 8) {
    if (h.log <= 11) {
      while (b.reload() == kUnfinished && p < end - 9)
        for (int i = 0; i < 5; i++) step();
    } else {
      while (b.reload() == kUnfinished && p < end - 7)
        for (int i = 0; i < 4; i++) step();
    }
  } else {
    b.reload();
  }
  if (end - p >= 2) {
    while (b.reload() == kUnfinished && p <= end - 2) step();
    while (p <= end - 2) step();
  }
  if (p < end) {  // HUF_decodeLastSymbolX2
    size_t const v = b.look_fast(h.log);
    *p = h.sym[v];
    if (h.len[v] == 1) {
      b.skip(h.nbits[v]);
    } else if (b.consumed < 64) {
      b.skip(h.nbits[v]);
      if (b.consumed > 64) b.consumed = 64;
    }
  }
}

// one stream, checked: the stream must end exactly (HUF_decompress1X*)
void huffman_1(const Huffman &h, const uint8_t *src, size_t n, uint8_t *dst,
               size_t size) {
  BitD b;
  if (!b.init(src, n, src, src + n))
    fail("zstd: Huffman stream is corrupt");
  if (h.x2)
    stream_x2(h, b, dst, dst + size);
  else
    stream_x1(h, b, dst, dst + size);
  if (!b.end()) fail("zstd: Huffman stream is corrupt");
}

// four streams (HUF_decompress4X*_usingDTable_internal)
void huffman_4(const Huffman &h, const uint8_t *src, size_t n, uint8_t *dst,
               size_t size) {
  if (n < 10) fail("zstd: Huffman streams are truncated");
  size_t const l1 = rd16(src), l2 = rd16(src + 2), l3 = rd16(src + 4);
  size_t const l4 = n - (l1 + l2 + l3 + 6);
  size_t const seg = (size + 3) / 4;
  uint8_t *const oend = dst + size;
  const uint8_t *const in[4] = {src + 6, src + 6 + l1, src + 6 + l1 + l2,
                                src + 6 + l1 + l2 + l3};
  size_t const len[4] = {l1, l2, l3, l4};
  bool const fast = h.log == kHufFastLog && size > 0 && l1 >= 8 &&
                    l2 >= 8 && l3 >= 8 && l4 >= 8 && l4 <= n &&
                    dst + 3 * seg < oend;
  if (l4 > n) fail("zstd: Huffman streams overflow");
  if (fast) {
    // HUF_decompress4X?_usingDTable_internal_fast: the C loop, each
    // stream's bits in a register with a sentinel bit, 5 lookups and a
    // reload a round, as many rounds as are safe for every stream; then
    // each stream's tail from where it stands, reading down to the first
    // stream's jump table; no end-of-stream check
    count(kHuffmanFast);
    const uint8_t *ip[4];
    uint64_t bits[4];
    uint8_t *op[4], *oe[4];
    for (int s = 0; s < 4; s++) {
      ip[s] = in[s] + len[s] - 8;
      uint8_t const last = ip[s][7];
      uint64_t const v = rd64(ip[s]) | 1;
      bits[s] = v << (last ? 8 - highbit(last) : 0);
      op[s] = dst + s * seg;
    }
    for (int s = 0; s < 3; s++) oe[s] = op[s + 1];
    oe[3] = oend;
    const uint8_t *const ilowest = src;
    for (;;) {
      size_t iters = static_cast<size_t>(ip[0] - ilowest) / 7;
      if (!h.x2) {
        iters = std::min(iters, static_cast<size_t>(oend - op[3]) / 5);
      } else {
        for (int s = 0; s < 4; s++)
          iters = std::min(iters, static_cast<size_t>(oe[s] - op[s]) / 10);
      }
      uint8_t *const olimit = op[3] + iters * 5;
      if (op[3] == olimit) break;
      bool crossed = false;
      for (int s = 1; s < 4; s++) crossed |= ip[s] < ip[s - 1];
      if (crossed) break;
      do {
        for (int s = 0; s < 4; s++) {
          for (int k = 0; k < 5; k++) {
            size_t const v = static_cast<size_t>(bits[s] >> (64 - h.log));
            if (h.x2) {
              op[s][0] = h.sym[v];
              op[s][1] = h.sym2[v];
              op[s] += h.len[v];
            } else {
              op[s][k] = h.sym[v];
            }
            bits[s] <<= h.nbits[v] & 63;
          }
          if (!h.x2) op[s] += 5;
          int const ctz = bits[s] ? __builtin_ctzll(bits[s]) : 64;
          ip[s] -= ctz >> 3;
          if (ip[s] < src) fail("zstd: internal read out of bounds");
          bits[s] = (rd64(ip[s]) | 1) << (ctz & 7);
        }
      } while (op[3] < olimit);
    }
    uint8_t *seg_end = dst;
    for (int s = 0; s < 4; s++) {
      seg_end = seg <= static_cast<size_t>(oend - seg_end) ? seg_end + seg
                                                            : oend;
      // HUF_initRemainingDStream
      if (op[s] > seg_end) fail("zstd: Huffman streams are corrupt");
      if (ip[s] < in[s] - 8) fail("zstd: Huffman streams are corrupt");
      BitD b;
      b.lo = src;
      b.hi = src + n;
      b.start = ilowest;
      b.ptr = ip[s];
      b.c = b.load(ip[s]);
      b.consumed = static_cast<uint32_t>(__builtin_ctzll(bits[s]));
      if (h.x2)
        stream_x2(h, b, op[s], seg_end);
      else
        stream_x1(h, b, op[s], seg_end);
    }
    return;
  }
  // the checked loops: every stream must end exactly
  if (dst + 3 * seg > oend) fail("zstd: Huffman streams are corrupt");
  BitD b[4];
  for (int s = 0; s < 4; s++)
    if (!b[s].init(in[s], len[s], src, src + n))
      fail("zstd: Huffman stream is corrupt");
  for (int s = 0; s < 4; s++) {
    uint8_t *const p = dst + s * seg, *const e = s < 3 ? p + seg : oend;
    if (h.x2)
      stream_x2(h, b[s], p, e);
    else
      stream_x1(h, b[s], p, e);
  }
  for (int s = 0; s < 4; s++)
    if (!b[s].end()) fail("zstd: Huffman streams are corrupt");
}

// ---------------------------------------------------------------------------
// sequences

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,
                              9,  10, 11,  12,  13,  14,   15,   16,   18,
                              20, 22, 24,  28,  32,  40,   48,   64,   128,
                              256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                              65536};
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

// a decoding table of one field: FSE cells with the field's base values
struct SeqTable {
  int log = 0;
  std::vector<FseCell> cells;
};

enum Field { kLL = 0, kOF = 1, kML = 2 };

SeqTable predefined(Field f) {
  SeqTable t;
  if (f == kLL) {
    t.log = 6;
    t.cells = build_fse(kLLNorm, 35, 6);
  } else if (f == kML) {
    t.log = 6;
    t.cells = build_fse(kMLNorm, 52, 6);
  } else {
    t.log = 5;
    t.cells = build_fse(kOFNorm, 28, 5);
  }
  return t;
}

inline uint32_t base_of(Field f, unsigned code) {
  return f == kLL ? kLLBase[code]
                  : f == kML ? kMLBase[code]
                             : code > 1 ? (1u << code) - 3 : code;
}
inline unsigned bits_of(Field f, unsigned code) {
  return f == kLL ? kLLBits[code] : f == kML ? kMLBits[code] : code;
}

// ---------------------------------------------------------------------------
// a frame's decoding state

struct Frame {
  // what the frame's blocks share (reset at each frame)
  bool lit_entropy = false, fse_entropy = false;
  Huffman huf;
  SeqTable tables[3];
  uint32_t rep[3] = {1, 4, 8};
  size_t block_max = 0;
};

// A compressed block into out[op, cap): returns its size.  not_streaming:
// one-shot decoding, where the literals may be buffered in the output
// past the block (which then limits it to block_max + 32 bytes).
size_t compressed_block(Frame &fr, const uint8_t *src, size_t n,
                        uint8_t *out, size_t op, size_t cap,
                        bool not_streaming) {
  count(kBlockCompressed);
  if (n > fr.block_max) fail("zstd: compressed block too large");
  size_t const dcap = cap - op;
  // literals section (ZSTD_decodeLiteralsBlock)
  if (n < 2) fail("zstd: literals section is truncated");
  int const type = src[0] & 3, lh = (src[0] >> 2) & 3;
  size_t const write_max = std::min(fr.block_max, dcap);
  std::vector<uint8_t> lits;
  size_t lit_size, used;
  bool in_dst = false;
  auto placed = [&](size_t ls) {  // ZSTD_allocateLiteralsBuffer
    in_dst = not_streaming && dcap > fr.block_max + 32 + ls + 32;
  };
  if (type == 2 || type == 3) {
    if (type == 3 && !fr.lit_entropy)
      fail("zstd: treeless literals without a previous table");
    if (n < 5) fail("zstd: literals section is truncated");
    uint32_t const lhc = rd32(src);
    size_t lhs, csize;
    bool single = false;
    if (lh < 2) {
      single = lh == 0;
      lhs = 3;
      lit_size = (lhc >> 4) & 0x3FF;
      csize = (lhc >> 14) & 0x3FF;
    } else if (lh == 2) {
      lhs = 4;
      lit_size = (lhc >> 4) & 0x3FFF;
      csize = lhc >> 18;
    } else {
      lhs = 5;
      lit_size = (lhc >> 4) & 0x3FFFF;
      csize = (lhc >> 22) + (static_cast<size_t>(src[4]) << 10);
    }
    if (lit_size > fr.block_max) fail("zstd: too many literals");
    if (!single && lit_size < 6)
      fail("zstd: too few literals for four streams");
    if (csize + lhs > n) fail("zstd: literals section is truncated");
    if (write_max < lit_size) fail("zstd: literals overflow the output");
    placed(lit_size);
    count(type == 2 ? kLitHuffman : kLitTreeless);
    count(single ? kLit1Stream : kLit4Streams);
    lits.resize(lit_size + 8);
    const uint8_t *hp = src + lhs;
    size_t hn = csize;
    if (type == 2) {
      std::vector<uint8_t> w;
      int tlog;
      if (single) {
        // HUF_decompress1X1_DCtx_wksp: X1 always
        size_t const h = read_weights(hp, hn, w, &tlog);
        if (h >= hn) fail("zstd: Huffman literals are truncated");
        fr.huf = build_huffman(w, tlog, false);
        hp += h;
        hn -= h;
      } else {
        // HUF_decompress4X_hufOnly_wksp
        if (lit_size == 0) fail("zstd: no literals for four streams");
        if (hn == 0) fail("zstd: Huffman literals are missing");
        bool const x2 = select_x2(lit_size, hn);
        size_t const h = read_weights(hp, hn, w, &tlog);
        if (h >= hn) fail("zstd: Huffman literals are truncated");
        fr.huf = build_huffman(w, tlog, x2);
        hp += h;
        hn -= h;
      }
    }
    count(fr.huf.x2 ? kHuffmanX2 : kHuffmanX1);
    if (single)
      huffman_1(fr.huf, hp, hn, lits.data(), lit_size);
    else
      huffman_4(fr.huf, hp, hn, lits.data(), lit_size);
    fr.lit_entropy = true;
    used = lhs + csize;
  } else {
    size_t lhs;
    if (lh == 0 || lh == 2) {
      lhs = 1;
      lit_size = src[0] >> 3;
    } else if (lh == 1) {
      lhs = 2;
      if (type == 1 && n < 3) fail("zstd: literals section is truncated");
      lit_size = rd16(src) >> 4;
    } else {
      lhs = 3;
      if (n < (type == 1 ? 4u : 3u))
        fail("zstd: literals section is truncated");
      lit_size = rd24(src) >> 4;
    }
    if (lit_size > fr.block_max) fail("zstd: too many literals");
    if (write_max < lit_size) fail("zstd: literals overflow the output");
    placed(lit_size);
    if (type == 0) {
      count(kLitRaw);
      if (lhs + lit_size > n) fail("zstd: raw literals are truncated");
      // read in place where 32 bytes follow: then not in the output
      if (lhs + lit_size + 32 <= n) in_dst = false;
      lits.assign(src + lhs, src + lhs + lit_size);
      used = lhs + lit_size;
    } else {
      count(kLitRle);
      lits.assign(lit_size, src[lhs]);
      used = lhs + 1;
    }
  }
  lits.resize(lit_size);
  const uint8_t *ip = src + used;
  size_t left = n - used;
  // sequences section (ZSTD_decodeSeqHeaders)
  if (left < 1) fail("zstd: sequences section is missing");
  int nseq = *ip++;
  left--;
  if (nseq > 0x7F) {
    if (nseq == 0xFF) {
      if (left < 2) fail("zstd: sequences section is truncated");
      nseq = rd16(ip) + 0x7F00;
      ip += 2;
      left -= 2;
    } else {
      if (left < 1) fail("zstd: sequences section is truncated");
      nseq = ((nseq - 0x80) << 8) + *ip++;
      left--;
    }
  }
  // the block's output limit: the literals buffered past it, or `cap`
  size_t const limit = in_dst ? op + fr.block_max + 32 : cap;
  size_t o = op, lp = 0;
  if (nseq == 0) {
    if (left) fail("zstd: data after an empty sequences section");
  } else {
    if (left < 1) fail("zstd: sequences section is truncated");
    if (*ip & 3) fail("zstd: reserved bits set in the sequences section");
    int const modes[3] = {*ip >> 6, (*ip >> 4) & 3, (*ip >> 2) & 3};
    ip++;
    left--;
    // tables in the order LL, OF, ML
    static const Field order[3] = {kLL, kOF, kML};
    static const unsigned maxsym[3] = {35, 31, 52}, maxlog[3] = {9, 8, 9};
    static const Cov covs[3][4] = {
        {kLLPredefined, kLLRle, kLLFse, kLLRepeat},
        {kOFPredefined, kOFRle, kOFFse, kOFRepeat},
        {kMLPredefined, kMLRle, kMLFse, kMLRepeat}};
    for (Field f : order) {
      int const mode = modes[f];
      count(covs[f][mode]);
      SeqTable &t = fr.tables[f];
      if (mode == 0) {
        t = predefined(f);
      } else if (mode == 1) {
        if (!left) fail("zstd: sequences section is truncated");
        if (*ip > maxsym[f]) fail("zstd: sequence code out of range");
        t.log = 0;
        t.cells.assign(1, FseCell{0, 0, *ip});
        ip++;
        left--;
      } else if (mode == 2) {
        int16_t norm[53];
        unsigned max = maxsym[f], tlog;
        size_t const h = read_ncount(norm, &max, &tlog, ip, left);
        if (tlog > maxlog[f]) fail("zstd: sequence table log too large");
        t.log = static_cast<int>(tlog);
        t.cells = build_fse(norm, max, tlog);
        ip += h;
        left -= h;
      } else if (!fr.fse_entropy) {
        fail("zstd: repeated sequence table without a previous one");
      }
    }
    // the sequences (ZSTD_decompressSequences_body)
    fr.fse_entropy = true;
    BitD b;
    if (!b.init(ip, left, ip, ip + left))
      fail("zstd: sequences bitstream is corrupt");
    unsigned st[3];
    for (Field f : order) {
      st[f] = static_cast<unsigned>(b.read(fr.tables[f].log));
      b.reload();
    }
    uint64_t prev[3] = {fr.rep[0], fr.rep[1], fr.rep[2]};
    for (int i = 0; i < nseq; i++) {
      const FseCell &ll = fr.tables[kLL].cells[st[kLL]];
      const FseCell &ml = fr.tables[kML].cells[st[kML]];
      const FseCell &of = fr.tables[kOF].cells[st[kOF]];
      unsigned const llc = ll.symbol, mlc = ml.symbol, ofc = of.symbol;
      uint64_t mlen = base_of(kML, mlc), llen = base_of(kLL, llc);
      unsigned const llb = bits_of(kLL, llc), mlb = bits_of(kML, mlc),
                     ofb = bits_of(kOF, ofc);
      uint64_t offset;
      if (ofb > 1) {
        offset = base_of(kOF, ofc) + b.read_fast(ofb);
        prev[2] = prev[1];
        prev[1] = prev[0];
        prev[0] = offset;
      } else {
        unsigned const ll0 = llen == 0;
        if (ofb == 0) {
          count(ll0 ? kRepeatOffset2 : kRepeatOffset1);
          offset = prev[ll0];
          prev[1] = prev[!ll0];
          prev[0] = offset;
        } else {
          unsigned const k = 1 + ll0 + static_cast<unsigned>(b.read_fast(1));
          count(k == 1 ? kRepeatOffset2 : kRepeatOffset3);
          uint64_t tmp = k == 3 ? prev[0] - 1 : prev[k];
          tmp -= !tmp;  // 0 is invalid: fails below
          if (k != 1) prev[2] = prev[1];
          prev[1] = prev[0];
          prev[0] = offset = tmp;
        }
      }
      if (mlb > 0) mlen += b.read_fast(mlb);
      if (llb + mlb + ofb >= 31) b.reload();
      if (llb > 0) llen += b.read_fast(llb);
      if (i != nseq - 1) {
        st[kLL] = ll.next + static_cast<unsigned>(b.read(ll.nbits));
        st[kML] = ml.next + static_cast<unsigned>(b.read(ml.nbits));
        st[kOF] = of.next + static_cast<unsigned>(b.read(of.nbits));
        b.reload();
      }
      // ZSTD_execSequence
      if (llen + mlen > limit - o) fail("zstd: output overflows its buffer");
      if (llen > lits.size() - lp) fail("zstd: sequence past the literals");
      memcpy(out + o, lits.data() + lp, llen);
      o += llen;
      lp += llen;
      if (offset > o) fail("zstd: match offset before the frame's start");
      for (uint64_t k = 0; k < mlen; k++, o++) out[o] = out[o - offset];
    }
    if (!b.end()) fail("zstd: sequences bitstream is corrupt");
    for (int k = 0; k < 3; k++) fr.rep[k] = static_cast<uint32_t>(prev[k]);
  }
  size_t const last = lits.size() - lp;
  if (last > limit - o) fail("zstd: output overflows its buffer");
  memcpy(out + o, lits.data() + lp, last);
  return o + last - op;
}

// the frame header
struct Header {
  size_t size = 0;             // bytes
  uint64_t content = ~0ULL;    // content size, ~0 unknown
  uint64_t window = 0;
  bool checksum = false, single = false;
};

const uint32_t kMagic = 0xFD2FB528u;

bool skippable(const uint8_t *p, size_t n) {
  return n >= 4 && (rd32(p) & 0xFFFFFFF0u) == 0x184D2A50u;
}

// ZSTD_getFrameHeader_advanced and ZSTD_decodeFrameHeader; n >= 5
Header frame_header(const uint8_t *p, size_t n) {
  Header h;
  if (rd32(p) != kMagic) fail("zstd: not a Zstandard frame");
  uint8_t const fhd = p[4];
  int const did = fhd & 3, fcs = fhd >> 6;
  h.single = (fhd >> 5) & 1;
  h.checksum = (fhd >> 2) & 1;
  static const int did_size[4] = {0, 1, 2, 4}, fcs_size[4] = {0, 2, 4, 8};
  h.size = 5 + !h.single + did_size[did] + fcs_size[fcs] +
           (h.single && !fcs);
  if (n < h.size) fail("zstd: frame header is truncated");
  if (fhd & 0x08)
    fail("zstd: frame header with reserved bits set");
  size_t pos = 5;
  if (!h.single) {
    uint8_t const wd = p[pos++];
    int const wlog = (wd >> 3) + 10;
    if (wlog > 31) fail("zstd: window too large");
    h.window = uint64_t{1} << wlog;
    h.window += (h.window >> 3) * (wd & 7);
  }
  uint32_t dict = 0;
  if (did == 1) dict = p[pos];
  if (did == 2) dict = rd16(p + pos);
  if (did == 3) dict = rd32(p + pos);
  pos += did_size[did];
  if (fcs == 0 && h.single) h.content = p[pos];
  if (fcs == 1) h.content = rd16(p + pos) + 256;
  if (fcs == 2) h.content = rd32(p + pos);
  if (fcs == 3) h.content = rd64(p + pos);
  if (h.single) h.window = h.content;
  if (dict)
    fail("zstd: frame that names dictionary " + std::to_string(dict) +
         " (none is given)");
  count(kFrames);
  count(h.single ? kSingleSegment : kWindowed);
  return h;
}

// ZSTD_decompressFrame: one frame of in[0, n) into out[op, cap); returns
// the bytes it wrote and sets *used to the frame's size
size_t one_frame(const uint8_t *in, size_t n, uint8_t *out, size_t op,
                 size_t cap, size_t *used) {
  if (n < 6 + 3) fail("zstd: frame is truncated");
  Header h = frame_header(in, n);
  if (n < h.size + 3) fail("zstd: frame is truncated");
  Frame fr;
  fr.block_max = std::min<uint64_t>(h.window, 128 * 1024);
  size_t ip = h.size, o = op;
  for (;;) {
    if (n - ip < 3) fail("zstd: block header is truncated");
    uint32_t const bh = rd24(in + ip);
    bool const last = bh & 1;
    int const type = (bh >> 1) & 3;
    size_t const bsize = bh >> 3;
    ip += 3;
    if (type == 3) fail("zstd: reserved block type");
    size_t const csize = type == 1 ? 1 : bsize;
    if (csize > n - ip) fail("zstd: block is truncated");
    if (type == 0) {
      count(kBlockRaw);
      if (bsize > cap - o) fail("zstd: output overflows its buffer");
      memcpy(out + o, in + ip, bsize);
      o += bsize;
    } else if (type == 1) {
      count(kBlockRle);
      if (bsize > cap - o) fail("zstd: output overflows its buffer");
      memset(out + o, in[ip], bsize);
      o += bsize;
    } else {
      o += compressed_block(fr, in + ip, csize, out, o, cap, true);
    }
    ip += csize;
    if (last) break;
  }
  if (h.content != ~0ULL && o - op != h.content)
    fail("zstd: frame's content size differs from its header's");
  if (h.checksum) {
    if (n - ip < 4) fail("zstd: frame checksum is missing");
    count(kChecksums);
    if (rd32(in + ip) != static_cast<uint32_t>(xxh64(out + op, o - op)))
      fail("zstd: frame checksum does not match");
    ip += 4;
  }
  *used = ip;
  return o - op;
}

// ZSTD_decompress: every frame
size_t decode_all(const uint8_t *in, size_t n, uint8_t *out, size_t cap) {
  size_t o = 0;
  bool more = false;
  while (n >= 5) {
    if (skippable(in, n)) {
      if (n < 8) fail("zstd: skippable frame is truncated");
      uint32_t const s = rd32(in + 4);
      if (static_cast<uint32_t>(s + 8) < s)
        fail("zstd: skippable frame too large");
      if (uint64_t{s} + 8 > n) fail("zstd: skippable frame is truncated");
      count(kSkippableFrames);
      in += s + 8;
      n -= s + 8;
      continue;
    }
    if (more && rd32(in) != kMagic)
      fail("zstd: data after the last frame");
    size_t used;
    o += one_frame(in, n, out, o, cap, &used);
    in += used;
    n -= used;
    more = true;
  }
  if (n) fail("zstd: data after the last frame");
  return o;
}

// ZSTD_findFrameCompressedSize, or 0 where the frame is not whole
size_t frame_size(const uint8_t *in, size_t n) {
  if (n < 5) return 0;
  Header h;
  try {
    h = frame_header(in, n);
  } catch (const Error &) {
    return 0;
  }
  size_t ip = h.size;
  for (;;) {
    if (n - ip < 3) return 0;
    uint32_t const bh = rd24(in + ip);
    int const type = (bh >> 1) & 3;
    if (type == 3) return 0;
    size_t const csize = type == 1 ? 1 : bh >> 3;
    if (3 + csize > n - ip) return 0;
    ip += 3 + csize;
    if (bh & 1) break;
  }
  if (h.checksum) {
    if (n - ip < 4) return 0;
    ip += 4;
  }
  return ip;
}

// libtiff's ZSTDDecode loop over ZSTD_decompressStream (file comment)
size_t decode_strip(const uint8_t *in, size_t n, uint8_t *out, size_t cap) {
  if (n < 5 || cap == 0) return 0;
  if (skippable(in, n)) {
    // the skippable frame ends the first call with nothing written
    count(kSkippableFrames);
    return 0;
  }
  if (rd32(in) != kMagic) fail("zstd: not a Zstandard frame");
  {
    // a header cut short waits for more input: nothing written
    uint8_t const fhd = in[4];
    static const int did_size[4] = {0, 1, 2, 4}, fcs_size[4] = {0, 2, 4, 8};
    bool const single = (fhd >> 5) & 1;
    if (n < static_cast<size_t>(5 + !single + did_size[fhd & 3] +
                                fcs_size[fhd >> 6] + (single && !(fhd >> 6))))
      return 0;
  }
  Header h = frame_header(in, n);
  size_t const whole = frame_size(in, n);
  if (h.content != ~0ULL && h.content <= cap && whole) {
    size_t used;
    return one_frame(in, whole, out, 0, cap, &used);
  }
  // block by block: each into the frame's history, copied out until full
  uint64_t const window = std::max<uint64_t>(h.window, 1024);
  if (window > (uint64_t{1} << 27) + 1)
    fail("zstd: frame whose window exceeds 2^27 bytes (libzstd's default "
         "limit)");
  Frame fr;
  fr.block_max = std::min<uint64_t>(h.window, 128 * 1024);
  std::vector<uint8_t> hist;
  size_t ip = h.size;
  // once a block fills the output exactly, libzstd still decodes what
  // follows until something is written or the frame ends
  bool full = false;
  auto out_of = [&](size_t got) {
    got = std::min(got, cap);
    memcpy(out, hist.data(), got);
    return got;
  };
  for (;;) {
    if (n - ip < 3) return out_of(hist.size());
    uint32_t const bh = rd24(in + ip);
    bool const last = bh & 1;
    int const type = (bh >> 1) & 3;
    size_t const bsize = bh >> 3;
    if (type == 3) fail("zstd: reserved block type");
    if (bsize > fr.block_max)
      fail("zstd: block larger than the frame's maximum");
    ip += 3;
    size_t const csize = type == 1 ? 1 : bsize;
    size_t const before = hist.size();
    if (type == 0) {
      count(kBlockRaw);
      // a raw block is passed on as far as the input goes
      size_t const got = std::min(bsize, n - ip);
      hist.insert(hist.end(), in + ip, in + ip + got);
      if (got < bsize) return out_of(hist.size());
    } else {
      if (csize > n - ip) return out_of(hist.size());
      if (type == 1) {
        count(kBlockRle);
        hist.insert(hist.end(), bsize, in[ip]);
      } else {
        hist.resize(before + fr.block_max + 64);
        size_t const got = compressed_block(fr, in + ip, csize, hist.data(),
                                            before, hist.size(), false);
        if (got > fr.block_max)
          fail("zstd: block decodes past the frame's maximum");
        hist.resize(before + got);
      }
    }
    ip += csize;
    if (last && h.content != ~0ULL && hist.size() != h.content)
      fail("zstd: frame's content size differs from its header's");
    if (hist.size() > cap || (full && hist.size() > before))
      return out_of(cap);
    full = hist.size() == cap;
    if (last) break;
  }
  if (h.checksum && n - ip >= 4) {
    count(kChecksums);
    if (rd32(in + ip) != static_cast<uint32_t>(xxh64(hist.data(), hist.size())))
      fail("zstd: frame checksum does not match");
  }
  return out_of(hist.size());
}

void set_error(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" int64_t mods_zstd_decode(const uint8_t *in, int64_t n, uint8_t *out,
                                    int64_t cap, char *err, int errlen) {
  try {
    if (n < 0 || cap < 0) fail("zstd: bad arguments");
    return static_cast<int64_t>(decode_all(in, static_cast<size_t>(n), out,
                                           static_cast<size_t>(cap)));
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, std::string("zstd: ") + e.what());
  }
  return -1;
}

extern "C" int64_t mods_zstd_decode_strip(const uint8_t *in, int64_t n,
                                          uint8_t *out, int64_t cap,
                                          char *err, int errlen) {
  try {
    if (n < 0 || cap < 0) fail("zstd: bad arguments");
    return static_cast<int64_t>(decode_strip(in, static_cast<size_t>(n), out,
                                             static_cast<size_t>(cap)));
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, std::string("zstd: ") + e.what());
  }
  return -1;
}

// the counters (enum Cov's order) since the last reset; returns how many
extern "C" int mods_zstd_coverage(int64_t *counts, int n, int reset) {
  for (int i = 0; i < n && i < kCovCount; i++)
    counts[i] = g_cov[i].load(std::memory_order_relaxed);
  if (reset)
    for (auto &c : g_cov) c.store(0, std::memory_order_relaxed);
  return kCovCount;
}
