// GIF writer's pixel work for io/image.py::save_image, bound with ctypes:
// Pillow 12.1.0's adaptive palette (libImaging/Quant.c, QuantOctree.c) and
// its GIF LZW encoder (libImaging/GifEncode.c).  io/image.py keeps
// GifImagePlugin's Python rules (modes, palette optimisation, headers).
//
// mods_gif_quantize: what ImagingQuantize(im, 256, method, 0) returns for
// Image.convert("P", palette=Image.Palette.ADAPTIVE), which runs the median
// cut (method 0) on "L" and "RGB" images and the fast octree (method 2,
// through Image.quantize) on "RGBA":
//   - median cut: colours counted in a hash whose key drops `scale` low
//     bits of each channel, `scale` growing while more than 65536 keys
//     remain (so the smallest scale with at most 65536 colours); a box
//     tree cut 255 times at most, always the box of most pixels next
//     (Quant.c's binary heap, ties as that heap breaks them), boxes of one
//     colour skipped; a box is cut on the axis of the largest spread
//     weighted 77, 150, 29 for R, G, B (the first such axis on ties), the
//     upper part taking every colour down to the value where the running
//     count passes half the box (all of the lowest value going to the
//     lower part where nothing would); the palette is the leaves from the
//     left, each the count-weighted mean of its pixels, rounded half up;
//     a pixel maps to its box's entry unless another entry is strictly
//     nearer (squared RGB distance), searched in the order of the entries'
//     distance to the box's entry (ties by index), up to four times the
//     pixel's distance to it;
//   - fast octree with alpha: RGBA counted in an 8x16x8x8 cube; a 4x4x4x4
//     coarse cube of the same counts keeps every used coarse bucket, the
//     rest of the 256 entries are the fine buckets of most pixels (sorted
//     by count, stably), each subtracted from its coarse bucket, more fine
//     entries taken while coarse buckets empty; entries are the buckets'
//     means (float division, truncated); pixels map through a lookup cube
//     of coarse, then fine entries; a transparent pixel first takes the RGB
//     of the first transparent pixel.
// mods_gif_lzw: ImagingGifEncode with bits 8: LZW codes packed least
// significant bit first, a clear code first, widths from 9 bits growing as
// the code inserted passes the width's largest value, a clear code when the
// 4096-code table is full; rows in the four interlace passes where asked;
// the data cut into sub-blocks of at most 255 bytes inside each `bufsize`
// output buffer of ImageFile._save (a buffer's last byte is left empty when
// only one remains).  The block terminator is the caller's.
//
// Interface:
//   mods_gif_quantize(pixels, n, channels, index, palette, count, err,
//   errlen): n pixels of 1 (L), 3 (RGB) or 4 (RGBA) channels -> n palette
//   indices, the palette as 256 RGBA entries of which `count` are used;
//   returns 0, or -1 with a message in err.
//   mods_gif_lzw(index, width, height, interlace, bufsize, out, cap, err,
//   errlen): the image data's sub-blocks; returns their length, or -1.

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

// ---------------------------------------------------------------------------
// median cut (Quant.c, method 0)

constexpr uint32_t kMaxHashEntries = 65536;

struct Box {
  std::vector<int> members;  // indices of distinct (scaled) colours
  int lo[3], hi[3];
  uint32_t pixels;
  int left = -1, right = -1;
};

struct MedianCut {
  const std::vector<uint8_t> &col;  // (E, 3) scaled colours
  const std::vector<uint32_t> &cnt;
  std::vector<Box> boxes;

  MedianCut(const std::vector<uint8_t> &c, const std::vector<uint32_t> &n)
      : col(c), cnt(n) {}

  void bounds(Box &b) {
    for (int a = 0; a < 3; ++a) {
      b.lo[a] = 255;
      b.hi[a] = 0;
    }
    for (int m : b.members)
      for (int a = 0; a < 3; ++a) {
        b.lo[a] = std::min<int>(b.lo[a], col[3 * m + a]);
        b.hi[a] = std::max<int>(b.hi[a], col[3 * m + a]);
      }
  }
  int volume(const Box &b) const {
    return (b.hi[0] - b.lo[0] + 1) * (b.hi[1] - b.lo[1] + 1) *
           (b.hi[2] - b.lo[2] + 1);
  }
  // Quant.c's split and splitlists
  void split(int k) {
    static const int weight[3] = {77, 150, 29};
    int axis = 0, f[3];
    for (int a = 0; a < 3; ++a)
      f[a] = (boxes[k].hi[a] - boxes[k].lo[a]) * weight[a];
    for (int a = 1; a < 3; ++a)
      if (f[a] > f[axis]) axis = a;
    uint64_t hist[256] = {0};
    for (int m : boxes[k].members) hist[col[3 * m + axis]] += cnt[m];
    const uint32_t total = boxes[k].pixels;
    uint32_t left = 0;
    int cut = 0;  // the upper part keeps the values >= cut
    for (int v = 255; v >= 0; --v) {
      if (!hist[v]) continue;
      left += static_cast<uint32_t>(hist[v]);
      if (static_cast<uint32_t>(left * 2) > total) {
        cut = v;
        break;
      }
    }
    if (cut == boxes[k].lo[axis]) cut = boxes[k].lo[axis] + 1;
    Box l, r;
    uint32_t nl = 0;
    for (int m : boxes[k].members) {
      if (col[3 * m + axis] >= cut) {
        l.members.push_back(m);
        nl += cnt[m];
      } else {
        r.members.push_back(m);
      }
    }
    bounds(l);
    bounds(r);
    l.pixels = nl;
    r.pixels = boxes[k].pixels - nl;
    boxes[k].members.clear();
    boxes[k].members.shrink_to_fit();
    boxes[k].left = static_cast<int>(boxes.size());
    boxes.push_back(std::move(l));
    boxes[k].right = static_cast<int>(boxes.size());
    boxes.push_back(std::move(r));
  }
};

// QuantHeap.c with box_heap_cmp: a max-heap on the pixel count
struct Heap {
  std::vector<int> a{0};
  unsigned count = 0;
  const std::vector<Box> &boxes;
  explicit Heap(const std::vector<Box> &b) : boxes(b) {}
  int cmp(int x, int y) const {
    return static_cast<int>(boxes[x].pixels) -
           static_cast<int>(boxes[y].pixels);
  }
  void add(int v) {
    if (a.size() < count + 2) a.resize(count + 2);
    unsigned k = ++count;
    while (k != 1) {
      if (cmp(v, a[k / 2]) <= 0) break;
      a[k] = a[k / 2];
      k >>= 1;
    }
    a[k] = v;
  }
  bool remove(int *r) {
    if (!count) return false;
    *r = a[1];
    const int v = a[count--];
    unsigned k, l;
    for (k = 1; k * 2 <= count; k = l) {
      l = k * 2;
      if (l < count && cmp(a[l], a[l + 1]) < 0) l++;
      if (cmp(v, a[l]) > 0) break;
      a[k] = a[l];
    }
    a[k] = v;
    return true;
  }
};

void leaves(const std::vector<Box> &boxes, int k, std::vector<int> &out) {
  if (boxes[k].left >= 0) {
    leaves(boxes, boxes[k].left, out);
    leaves(boxes, boxes[k].right, out);
  } else {
    out.push_back(k);
  }
}

inline uint32_t dist2(const uint8_t *p, const uint8_t *q) {
  const int dr = p[0] - q[0], dg = p[1] - q[1], db = p[2] - q[2];
  return static_cast<uint32_t>(dr * dr + dg * dg + db * db);
}

// keys sorted by an LSD radix sort on their 24 bits
void radix_sort24(std::vector<uint32_t> &keys) {
  std::vector<uint32_t> tmp(keys.size());
  for (int shift = 0; shift < 24; shift += 8) {
    size_t pos[257] = {0};
    for (uint32_t k : keys) pos[((k >> shift) & 255) + 1]++;
    for (int i = 0; i < 256; ++i) pos[i + 1] += pos[i];
    for (uint32_t k : keys) tmp[pos[(k >> shift) & 255]++] = k;
    keys.swap(tmp);
  }
}

void median_cut(const uint8_t *px, int64_t n, int channels, uint8_t *index,
                uint8_t *palette, int32_t *count) {
  std::vector<uint32_t> key(n);
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t *p = px + i * channels;
    key[i] = channels == 1 ? (p[0] * 0x10101u)
                           : (uint32_t(p[0]) << 16 | uint32_t(p[1]) << 8 | p[2]);
  }
  // the distinct colours (sorted) and their counts
  std::vector<uint32_t> sorted(key);
  radix_sort24(sorted);
  std::vector<uint32_t> uniq, ucount;
  for (int64_t i = 0; i < n; ++i) {
    if (i && sorted[i] == sorted[i - 1]) {
      ucount.back()++;
    } else {
      uniq.push_back(sorted[i]);
      ucount.push_back(1);
    }
  }
  sorted.clear();
  sorted.shrink_to_fit();
  auto scaled = [](uint32_t k, int s) {
    return ((k >> 16 & 255) >> s) << 16 | ((k >> 8 & 255) >> s) << 8 |
           ((k & 255) >> s);
  };
  int scale = 0;
  std::vector<uint32_t> ent;  // the distinct scaled colours, sorted
  for (;; ++scale) {
    ent.resize(uniq.size());
    for (size_t i = 0; i < uniq.size(); ++i) ent[i] = scaled(uniq[i], scale);
    radix_sort24(ent);
    ent.erase(std::unique(ent.begin(), ent.end()), ent.end());
    if (ent.size() <= kMaxHashEntries) break;
  }
  std::vector<int> entry_of(uniq.size());
  std::vector<uint8_t> col;
  std::vector<uint32_t> cnt(ent.size(), 0);
  for (uint32_t s : ent)
    col.insert(col.end(), {uint8_t(s >> 16), uint8_t(s >> 8), uint8_t(s)});
  for (size_t i = 0; i < uniq.size(); ++i) {
    entry_of[i] = static_cast<int>(
        std::lower_bound(ent.begin(), ent.end(), scaled(uniq[i], scale)) -
        ent.begin());
    cnt[entry_of[i]] += ucount[i];
  }

  MedianCut mc(col, cnt);
  Box root;
  root.members.resize(cnt.size());
  for (size_t e = 0; e < cnt.size(); ++e) root.members[e] = static_cast<int>(e);
  mc.bounds(root);
  root.pixels = static_cast<uint32_t>(n);
  mc.boxes.push_back(std::move(root));
  Heap heap(mc.boxes);
  heap.add(0);
  for (int todo = 256; --todo;) {
    int k;
    bool found = false;
    while (heap.remove(&k)) {
      if (mc.volume(mc.boxes[k]) != 1) {
        found = true;
        break;
      }
    }
    if (!found) break;
    mc.split(k);
    heap.add(mc.boxes[k].left);
    heap.add(mc.boxes[k].right);
  }
  std::vector<int> leaf;
  leaves(mc.boxes, 0, leaf);
  const int np = static_cast<int>(leaf.size());
  std::vector<int> box_of(cnt.size());
  for (int j = 0; j < np; ++j)
    for (int m : mc.boxes[leaf[j]].members) box_of[m] = j;

  // compute_palette_from_median_cut: uint32 sums over the pixels
  std::vector<uint32_t> sum(3 * np, 0), num(np, 0);
  for (size_t i = 0; i < uniq.size(); ++i) {
    const int j = box_of[entry_of[i]];
    sum[3 * j] += ucount[i] * (uniq[i] >> 16 & 255);
    sum[3 * j + 1] += ucount[i] * (uniq[i] >> 8 & 255);
    sum[3 * j + 2] += ucount[i] * (uniq[i] & 255);
    num[j] += ucount[i];
  }
  std::vector<uint8_t> pal(3 * np);
  for (int j = 0; j < np; ++j)
    for (int c = 0; c < 3; ++c)
      pal[3 * j + c] = static_cast<uint8_t>(static_cast<int>(
          .5 + static_cast<double>(sum[3 * j + c]) / static_cast<double>(num[j])));

  // build_distance_tables: each entry's others by distance, ties by index
  std::vector<uint32_t> dist(size_t(np) * np);
  std::vector<int> order(size_t(np) * np);
  for (int i = 0; i < np; ++i)
    for (int j = 0; j < np; ++j)
      dist[size_t(i) * np + j] = dist2(&pal[3 * i], &pal[3 * j]);
  for (int i = 0; i < np; ++i) {
    int *o = &order[size_t(i) * np];
    const uint32_t *d = &dist[size_t(i) * np];
    for (int j = 0; j < np; ++j) o[j] = j;
    std::stable_sort(o, o + np, [d](int a, int b) { return d[a] < d[b]; });
  }
  // map_image_pixels_from_median_box, once a distinct colour
  std::vector<uint8_t> mapped(uniq.size());
  for (size_t i = 0; i < uniq.size(); ++i) {
    const uint8_t c[3] = {uint8_t(uniq[i] >> 16), uint8_t(uniq[i] >> 8),
                          uint8_t(uniq[i])};
    const int own = box_of[entry_of[i]];
    uint32_t best_d = dist2(&pal[3 * own], c);
    int best = own;
    const uint32_t limit = best_d << 2;
    const int *o = &order[size_t(own) * np];
    const uint32_t *d = &dist[size_t(own) * np];
    for (int j = 0; j < np; ++j) {
      if (d[o[j]] > limit) break;
      const uint32_t dd = dist2(&pal[3 * o[j]], c);
      if (dd < best_d) {
        best_d = dd;
        best = o[j];
      }
    }
    mapped[i] = static_cast<uint8_t>(best);
  }
  for (int64_t i = 0; i < n; ++i) {
    const size_t u = std::lower_bound(uniq.begin(), uniq.end(), key[i]) -
                     uniq.begin();
    index[i] = mapped[u];
  }
  for (int j = 0; j < np; ++j) {
    memcpy(palette + 4 * j, &pal[3 * j], 3);
    palette[4 * j + 3] = 255;
  }
  *count = np;
}

// ---------------------------------------------------------------------------
// fast octree with alpha (QuantOctree.c, method 2)

struct Bucket {
  uint32_t count;
  uint64_t r, g, b, a;
};

struct Cube {
  int bits[4];
  int offset[4];
  std::vector<Bucket> buckets;
  Cube(int r, int g, int b, int a) : bits{r, g, b, a} {
    offset[0] = g + b + a;
    offset[1] = b + a;
    offset[2] = a;
    offset[3] = 0;
    buckets.assign(size_t(1) << (r + g + b + a), Bucket{0, 0, 0, 0, 0});
  }
  size_t pos(unsigned r, unsigned g, unsigned b, unsigned a) const {
    return size_t(r) << offset[0] | size_t(g) << offset[1] |
           size_t(b) << offset[2] | size_t(a) << offset[3];
  }
  Bucket &at(const uint8_t *p) {
    return buckets[pos(p[0] >> (8 - bits[0]), p[1] >> (8 - bits[1]),
                       p[2] >> (8 - bits[2]), p[3] >> (8 - bits[3]))];
  }
  size_t used() const {
    size_t n = 0;
    for (const Bucket &b : buckets) n += b.count > 0;
    return n;
  }
};

inline uint8_t clip8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v);
}

void bucket_mean(const Bucket &b, uint8_t *dst) {
  const float count = static_cast<float>(b.count);
  if (count != 0) {
    dst[0] = clip8(static_cast<int>(static_cast<float>(b.r) / count));
    dst[1] = clip8(static_cast<int>(static_cast<float>(b.g) / count));
    dst[2] = clip8(static_cast<int>(static_cast<float>(b.b) / count));
    dst[3] = clip8(static_cast<int>(static_cast<float>(b.a) / count));
  } else {
    dst[0] = dst[1] = dst[2] = dst[3] = 0;
  }
}

// copy_color_cube: the counts of `src` at other bit depths
Cube copy_cube(const Cube &src, int r, int g, int b, int a) {
  Cube out(r, g, b, a);
  int src_reduce[4] = {0}, dst_reduce[4] = {0}, width[4];
  for (int c = 0; c < 4; ++c) {
    if (src.bits[c] > out.bits[c]) {
      dst_reduce[c] = src.bits[c] - out.bits[c];
      width[c] = 1 << src.bits[c];
    } else {
      src_reduce[c] = out.bits[c] - src.bits[c];
      width[c] = 1 << out.bits[c];
    }
  }
  for (int i0 = 0; i0 < width[0]; ++i0)
    for (int i1 = 0; i1 < width[1]; ++i1)
      for (int i2 = 0; i2 < width[2]; ++i2)
        for (int i3 = 0; i3 < width[3]; ++i3) {
          const Bucket &s = src.buckets[src.pos(
              i0 >> src_reduce[0], i1 >> src_reduce[1], i2 >> src_reduce[2],
              i3 >> src_reduce[3])];
          Bucket &d = out.buckets[out.pos(
              i0 >> dst_reduce[0], i1 >> dst_reduce[1], i2 >> dst_reduce[2],
              i3 >> dst_reduce[3])];
          d.count += s.count;
          d.r += s.r;
          d.g += s.g;
          d.b += s.b;
          d.a += s.a;
        }
  return out;
}

std::vector<Bucket> sorted_buckets(const Cube &cube) {
  std::vector<Bucket> out(cube.buckets);
  std::stable_sort(out.begin(), out.end(), [](const Bucket &x, const Bucket &y) {
    return x.count > y.count;
  });
  return out;
}

void subtract(Cube &cube, const std::vector<Bucket> &from, size_t first,
              size_t n) {
  uint8_t p[4];
  for (size_t i = first; i < first + n; ++i) {
    const Bucket &s = from[i];
    if (s.count == 0) continue;
    bucket_mean(s, p);
    Bucket &m = cube.at(p);
    m.count -= s.count;
    m.r -= s.r;
    m.g -= s.g;
    m.b -= s.b;
    m.a -= s.a;
  }
}

void add_lookup(Cube &cube, const std::vector<Bucket> &palette, size_t n,
                size_t offset) {
  uint8_t p[4];
  for (int64_t i = int64_t(offset + n) - 1; i >= int64_t(offset); --i) {
    bucket_mean(palette[i], p);
    cube.at(p).count = static_cast<uint32_t>(i);
  }
}

void octree_rgba(const uint8_t *px, int64_t n, uint8_t *index,
                 uint8_t *palette, int32_t *count) {
  constexpr size_t kColors = 256;
  // ImagingQuantize: transparent pixels take the first one's RGB
  std::vector<uint8_t> p(px, px + 4 * n);
  bool seen = false;
  uint8_t rgb[3] = {0, 0, 0};
  for (int64_t i = 0; i < n; ++i) {
    uint8_t *q = &p[4 * i];
    if (q[3] != 0) continue;
    if (!seen) {
      seen = true;
      memcpy(rgb, q, 3);
    } else {
      memcpy(q, rgb, 3);
    }
  }
  Cube fine(3, 4, 3, 3);
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t *q = &p[4 * i];
    Bucket &b = fine.at(q);
    b.count += 1;
    b.r += q[0];
    b.g += q[1];
    b.b += q[2];
    b.a += q[3];
  }
  Cube coarse = copy_cube(fine, 2, 2, 2, 2);
  size_t n_coarse = std::min(coarse.used(), kColors);
  size_t n_fine = kColors - n_coarse;
  const std::vector<Bucket> fine_sorted = sorted_buckets(fine);
  subtract(coarse, fine_sorted, 0, n_fine);
  while (n_coarse > coarse.used()) {
    const size_t done = n_fine;
    n_coarse = coarse.used();
    n_fine = kColors - n_coarse;
    subtract(coarse, fine_sorted, done, n_fine - done);
  }
  const std::vector<Bucket> coarse_sorted = sorted_buckets(coarse);
  std::vector<Bucket> entries(coarse_sorted.begin(),
                              coarse_sorted.begin() + n_coarse);
  entries.insert(entries.end(), fine_sorted.begin(),
                 fine_sorted.begin() + n_fine);
  Cube coarse_lookup(2, 2, 2, 2);
  add_lookup(coarse_lookup, entries, n_coarse, 0);
  Cube lookup = copy_cube(coarse_lookup, 3, 4, 3, 3);
  add_lookup(lookup, entries, n_fine, n_coarse);
  for (int64_t i = 0; i < n; ++i)
    index[i] = static_cast<uint8_t>(lookup.at(&p[4 * i]).count);
  for (size_t j = 0; j < kColors; ++j) bucket_mean(entries[j], palette + 4 * j);
  *count = static_cast<int32_t>(kColors);
}

// ---------------------------------------------------------------------------
// GIF LZW (GifEncode.c, bits 8)

constexpr int kTableSize = 8192;
constexpr uint32_t kCodeLimit = 4096;

struct LzwWriter {
  std::vector<uint8_t> &out;
  uint32_t acc = 0;
  int n = 0;
  explicit LzwWriter(std::vector<uint8_t> &o) : out(o) {}
  void put(uint32_t code, int width) {
    acc |= code << n;
    n += width;
    while (n >= 8) {
      out.push_back(static_cast<uint8_t>(acc));
      acc >>= 8;
      n -= 8;
    }
  }
  void flush() {
    if (n > 0) out.push_back(static_cast<uint8_t>(acc));
  }
};

std::vector<uint8_t> lzw(const std::vector<uint8_t> &in) {
  constexpr uint32_t clear = 256, end = 257;
  std::vector<uint8_t> out;
  LzwWriter w(out);
  std::vector<uint32_t> codes(kTableSize);
  uint32_t next = end + 1, max_code = 2 * clear - 1;
  int width = 9;
  auto reset = [&]() {
    next = end + 1;
    max_code = 2 * clear - 1;
    width = 9;
    std::fill(codes.begin(), codes.end(), 0);
  };
  w.put(clear, width);
  if (!in.empty()) {
    uint32_t head = in[0];
    for (size_t i = 1; i < in.size(); ++i) {
      const uint32_t tail = in[i];
      int probe = ((head ^ (tail << 6)) * 31) & (kTableSize - 1);
      bool found = false;
      while (codes[probe]) {
        if ((codes[probe] & 0xFFFFF) == ((head << 8) | tail)) {
          head = codes[probe] >> 20;
          found = true;
          break;
        }
        probe -= static_cast<int>((tail << 2) | 1);
        if (probe < 0) probe += kTableSize;
      }
      if (found) continue;
      w.put(head, width);
      if (next < kCodeLimit) {
        codes[probe] = (next << 20) | (head << 8) | tail;
        if (next > max_code) {
          max_code = max_code * 2 + 1;
          width++;
        }
        next++;
      } else {
        w.put(clear, width);
        reset();
      }
      head = tail;
    }
    w.put(head, width);
  }
  w.put(end, width);
  w.flush();
  return out;
}

void set_error(char *err, int errlen, const std::string &msg) {
  if (err && errlen > 0) snprintf(err, errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" int mods_gif_quantize(const uint8_t *pixels, int64_t n,
                                 int channels, uint8_t *index,
                                 uint8_t *palette, int32_t *count, char *err,
                                 int errlen) {
  try {
    if (n < 1) throw Error{"GIF: no pixels to quantize"};
    memset(palette, 0, 4 * 256);
    if (channels == 4) {
      octree_rgba(pixels, n, index, palette, count);
    } else if (channels == 1 || channels == 3) {
      median_cut(pixels, n, channels, index, palette, count);
    } else {
      throw Error{"GIF: 1, 3 or 4 channels are quantized, not " +
                  std::to_string(channels)};
    }
    return 0;
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, std::string("GIF: ") + e.what());
  }
  return -1;
}

extern "C" int64_t mods_gif_lzw(const uint8_t *index, int width, int height,
                                int interlace, int64_t bufsize, uint8_t *out,
                                int64_t cap, char *err, int errlen) {
  try {
    if (width < 1 || height < 1) throw Error{"GIF: an empty image"};
    if (bufsize < 5) throw Error{"GIF: the encoder's buffer is too small"};
    // rows in the order ImagingGifEncode reads them
    std::vector<uint8_t> rows;
    rows.reserve(size_t(width) * height);
    auto row = [&](int y) {
      rows.insert(rows.end(), index + size_t(y) * width,
                  index + size_t(y + 1) * width);
    };
    if (interlace) {
      for (int y = 0; y < height; y += 8) row(y);
      for (int y = 4; y < height; y += 8) row(y);
      for (int y = 2; y < height; y += 4) row(y);
      for (int y = 1; y < height; y += 2) row(y);
    } else {
      for (int y = 0; y < height; ++y) row(y);
    }
    const std::vector<uint8_t> data = lzw(rows);
    // sub-blocks inside each output buffer of `bufsize` bytes
    std::vector<uint8_t> blocks;
    size_t at = 0;
    while (at < data.size()) {
      int64_t room = bufsize;
      while (room >= 2 && at < data.size()) {
        const size_t len = std::min<size_t>(
            {255, static_cast<size_t>(room - 1), data.size() - at});
        blocks.push_back(static_cast<uint8_t>(len));
        blocks.insert(blocks.end(), data.begin() + at, data.begin() + at + len);
        at += len;
        room -= static_cast<int64_t>(len) + 1;
      }
    }
    if (static_cast<int64_t>(blocks.size()) > cap)
      throw Error{"GIF: the output buffer is too small"};
    memcpy(out, blocks.data(), blocks.size());
    return static_cast<int64_t>(blocks.size());
  } catch (const Error &e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception &e) {
    set_error(err, errlen, std::string("GIF: ") + e.what());
  }
  return -1;
}
