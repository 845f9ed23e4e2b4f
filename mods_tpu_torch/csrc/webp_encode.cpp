// Lossless WebP (VP8L, RFC 9649) encoder for io/image.py::save_image,
// bound with ctypes.
//
// PIL's default .webp is lossy VP8 from libwebp's encoder, whose rate-
// distortion search this port does not copy.  The port writes the exact
// canvas instead, as a simple-format VP8L file that any WebP reader (PIL
// included) decodes to what it decodes from PIL's lossless=True save of
// the same image:
//   - the alpha hint is set where some alpha is below 255 (libwebp's
//     WebPPictureHasTransparency), so PIL reads RGB or RGBA as it does
//     from its own lossless file;
//   - fully transparent pixels become 0x00000000, as libwebp's encoder
//     leaves them when `exact` is off (WebPReplaceTransparentPixels);
//   - one transform, subtract green; no colour cache; one prefix-code
//     group of length-limited (15 bits) Huffman codes, written with the
//     code-length code (7 bits at most, zero runs as codes 17 and 18), or
//     as a simple code where at most two symbols below 256 occur; every
//     pixel a literal.
// The bytes depend on the pixels alone: ties in the Huffman construction
// are broken by symbol order, so every machine writes the same file.
//
// Interface: mods_webp_encode(pixels, width, height, channels, out, cap,
// err, errlen) codes (height, width, channels) uint8 pixels (channels 3
// or 4) and returns the file's length, or -1 with a message in err.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

struct BitWriter {
  std::vector<uint8_t> &out;
  uint64_t acc = 0;
  int n = 0;

  explicit BitWriter(std::vector<uint8_t> &o) : out(o) {}
  void put(uint32_t v, int bits) {  // least significant bit first
    acc |= static_cast<uint64_t>(v) << n;
    n += bits;
    while (n >= 8) {
      out.push_back(static_cast<uint8_t>(acc));
      acc >>= 8;
      n -= 8;
    }
  }
  void flush() {
    if (n > 0) out.push_back(static_cast<uint8_t>(acc));
    acc = 0;
    n = 0;
  }
};

// Huffman code lengths of `counts`, at most `limit` bits; counts of the
// rarest symbols are raised until the tree fits (libwebp's approach)
std::vector<int> code_lengths(const std::vector<uint32_t> &counts, int limit) {
  const int n = static_cast<int>(counts.size());
  std::vector<int> lengths(n, 0);
  std::vector<int> used;
  for (int s = 0; s < n; ++s)
    if (counts[s]) used.push_back(s);
  if (used.size() == 1) {
    lengths[used[0]] = 1;
    return lengths;
  }
  if (used.empty()) return lengths;
  for (uint32_t count_min = 1;; count_min *= 2) {
    // nodes: leaves first, then internal nodes; (weight, id) orders them
    std::vector<uint64_t> weight;
    std::vector<int> parent;
    using Item = std::pair<uint64_t, int>;
    std::priority_queue<Item, std::vector<Item>, std::greater<Item>> q;
    for (int s : used) {
      weight.push_back(std::max(counts[s], count_min));
      parent.push_back(-1);
      q.push({weight.back(), static_cast<int>(weight.size()) - 1});
    }
    while (q.size() > 1) {
      const Item a = q.top();
      q.pop();
      const Item b = q.top();
      q.pop();
      weight.push_back(a.first + b.first);
      parent.push_back(-1);
      const int id = static_cast<int>(weight.size()) - 1;
      parent[a.second] = parent[b.second] = id;
      q.push({weight.back(), id});
    }
    int max_len = 0;
    for (size_t i = 0; i < used.size(); ++i) {
      int d = 0;
      for (int p = parent[i]; p >= 0; p = parent[p]) ++d;
      lengths[used[i]] = d;
      max_len = std::max(max_len, d);
    }
    if (max_len <= limit) return lengths;
  }
}

// canonical codes of `lengths`, bit-reversed for the LSB-first writer
std::vector<uint32_t> canonical(const std::vector<int> &lengths) {
  int count[16] = {0};
  for (int l : lengths)
    if (l) ++count[l];
  int next[16] = {0};
  int code = 0;
  for (int l = 1; l < 16; ++l) {
    code = (code + count[l - 1]) << 1;
    next[l] = code;
  }
  std::vector<uint32_t> codes(lengths.size(), 0);
  for (size_t s = 0; s < lengths.size(); ++s) {
    const int l = lengths[s];
    if (!l) continue;
    const int c = next[l]++;
    uint32_t rev = 0;
    for (int b = 0; b < l; ++b) rev |= ((c >> b) & 1u) << (l - 1 - b);
    codes[s] = rev;
  }
  return codes;
}

struct Code {
  std::vector<int> lengths;
  std::vector<uint32_t> codes;
  bool single = false;  // one symbol: written with no bits

  void put(BitWriter &bw, int s) const {
    if (!single) bw.put(codes[s], lengths[s]);
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                  7, 8, 9, 10, 11, 12, 13, 14, 15};

// write the prefix code of `counts` and return it
Code write_code(BitWriter &bw, const std::vector<uint32_t> &counts) {
  Code c;
  std::vector<int> used;
  for (size_t s = 0; s < counts.size(); ++s)
    if (counts[s]) used.push_back(static_cast<int>(s));
  if (used.size() <= 2 && (used.empty() || used.back() < 256)) {
    // simple code: one or two symbols of 1 or 8 bits
    if (used.empty()) used.push_back(0);
    bw.put(1, 1);
    bw.put(static_cast<uint32_t>(used.size() - 1), 1);
    if (used[0] < 2) {
      bw.put(0, 1);
      bw.put(used[0], 1);
    } else {
      bw.put(1, 1);
      bw.put(used[0], 8);
    }
    if (used.size() == 2) bw.put(used[1], 8);
    c.lengths.assign(counts.size(), 0);
    for (int s : used) c.lengths[s] = 1;
    c.codes = canonical(c.lengths);
    c.single = used.size() == 1;
    return c;
  }
  c.lengths = code_lengths(counts, 15);
  c.codes = canonical(c.lengths);
  // the lengths as code-length symbols, zero runs as 17 (3-10) and 18
  // (11-138)
  std::vector<std::pair<int, int>> syms;  // (symbol, extra bits' value)
  const int n = static_cast<int>(c.lengths.size());
  for (int i = 0; i < n;) {
    if (c.lengths[i] == 0) {
      int run = 0;
      while (i + run < n && c.lengths[i + run] == 0 && run < 138) ++run;
      if (run >= 11) {
        syms.push_back({18, run - 11});
        i += run;
        continue;
      }
      if (run >= 3) {
        syms.push_back({17, run - 3});
        i += run;
        continue;
      }
    }
    syms.push_back({c.lengths[i], 0});
    ++i;
  }
  std::vector<uint32_t> cl_counts(19, 0);
  for (auto &s : syms) ++cl_counts[s.first];
  Code cl;
  cl.lengths = code_lengths(cl_counts, 7);
  cl.codes = canonical(cl.lengths);
  int nonzero = 0;
  for (int s = 0; s < 19; ++s) nonzero += cl_counts[s] > 0;
  cl.single = nonzero == 1;
  int num_codes = 4;
  for (int i = 0; i < 19; ++i)
    if (cl.lengths[kCodeLengthOrder[i]]) num_codes = std::max(num_codes, i + 1);
  bw.put(0, 1);  // a normal code
  bw.put(num_codes - 4, 4);
  for (int i = 0; i < num_codes; ++i) bw.put(cl.lengths[kCodeLengthOrder[i]], 3);
  bw.put(0, 1);  // no max_symbol: every symbol's length follows
  for (auto &s : syms) {
    cl.put(bw, s.first);
    if (s.first == 17) bw.put(s.second, 3);
    if (s.first == 18) bw.put(s.second, 7);
  }
  return c;
}

void put32(std::vector<uint8_t> &o, uint32_t v) {
  for (int i = 0; i < 4; ++i) o.push_back(static_cast<uint8_t>(v >> (8 * i)));
}

std::vector<uint8_t> encode(const uint8_t *px, int width, int height,
                            int channels) {
  // libwebp's WEBP_MAX_DIMENSION, which PIL's save reports
  if (width < 1 || height < 1 || width > 16383 || height > 16383)
    throw Error{"WebP: a " + std::to_string(width) + "x" +
                std::to_string(height) + " image is outside the WebP limit "
                "of 1 to 16383 pixels a side"};
  const size_t npx = static_cast<size_t>(width) * height;
  std::vector<uint32_t> argb(npx);
  bool has_alpha = false;
  for (size_t i = 0; i < npx; ++i) {
    const uint8_t *p = px + i * channels;
    const uint32_t a = channels == 4 ? p[3] : 255;
    if (a != 255) has_alpha = true;
    // subtract green; a transparent pixel is transparent black
    argb[i] = a == 0 ? 0u
                     : (a << 24) | (static_cast<uint32_t>((p[0] - p[1]) & 0xff) << 16) |
                           (static_cast<uint32_t>(p[1]) << 8) |
                           static_cast<uint32_t>((p[2] - p[1]) & 0xff);
  }
  std::vector<uint32_t> green(256 + 24, 0), red(256, 0), blue(256, 0),
      alpha(256, 0), dist(40, 0);
  for (uint32_t v : argb) {
    ++green[(v >> 8) & 0xff];
    ++red[(v >> 16) & 0xff];
    ++blue[v & 0xff];
    ++alpha[v >> 24];
  }
  std::vector<uint8_t> body;
  BitWriter bw(body);
  bw.put(0x2f, 8);
  bw.put(width - 1, 14);
  bw.put(height - 1, 14);
  bw.put(has_alpha ? 1 : 0, 1);
  bw.put(0, 3);  // version
  bw.put(1, 1);  // a transform:
  bw.put(2, 2);  // subtract green
  bw.put(0, 1);  // no more transforms
  bw.put(0, 1);  // no colour cache
  bw.put(0, 1);  // no meta prefix codes
  const Code cg = write_code(bw, green), cr = write_code(bw, red),
             cb = write_code(bw, blue), ca = write_code(bw, alpha);
  write_code(bw, dist);
  for (uint32_t v : argb) {
    cg.put(bw, (v >> 8) & 0xff);
    cr.put(bw, (v >> 16) & 0xff);
    cb.put(bw, v & 0xff);
    ca.put(bw, v >> 24);
  }
  bw.flush();
  std::vector<uint8_t> file;
  const uint32_t chunk = static_cast<uint32_t>(body.size());
  const uint32_t padded = chunk + (chunk & 1);
  file.insert(file.end(), {'R', 'I', 'F', 'F'});
  put32(file, 4 + 8 + padded);
  file.insert(file.end(), {'W', 'E', 'B', 'P', 'V', 'P', '8', 'L'});
  put32(file, chunk);
  file.insert(file.end(), body.begin(), body.end());
  if (chunk & 1) file.push_back(0);
  return file;
}

void set_error(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" int64_t mods_webp_encode(const uint8_t *pixels, int width,
                                    int height, int channels, uint8_t *out,
                                    int64_t cap, char *err, int errlen) {
  try {
    if (channels != 3 && channels != 4)
      throw Error{"WebP: 3 or 4 channels are written, not " +
                  std::to_string(channels)};
    const std::vector<uint8_t> file = encode(pixels, width, height, channels);
    if (static_cast<int64_t>(file.size()) > cap)
      throw Error{"WebP: the output buffer is too small"};
    memcpy(out, file.data(), file.size());
    return static_cast<int64_t>(file.size());
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, std::string("WebP: ") + e.what());
  }
  return -1;
}
