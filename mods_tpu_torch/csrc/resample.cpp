// Pillow 12.1.0's Image.resize with Resampling.LANCZOS or BICUBIC and no
// box (Image.thumbnail(size, LANCZOS, reducing_gap=None) for
// IcoImagePlugin._save, im.resize((size, size)) for IcnsImagePlugin._save),
// bound with ctypes for io/raster.py:
//   - libImaging/Resample.c, ImagingResample: the filter (Lanczos: a = 3,
//     sin(pi x) / (pi x) from the C library's sin, in double; bicubic:
//     Keys' cubic with a = -0.5, support 2), its support scaled by the
//     ratio where the image shrinks; each output sample's window [xmin,
//     xmin + n) cut at the image's edges and its weights divided by their
//     sum; the horizontal pass first, over only the rows that the vertical
//     pass reads, then the vertical pass; a pass is skipped where its size
//     does not change;
//     * 8-bit bands ("L", "La", "RGB", "RGBa"): the weights rounded away
//       from zero to fixed point with 22 fraction bits, sums started at half
//       a unit, shifted down and clipped to 0..255;
//     * "I;16": a double sum rounded half away from zero, whose low byte is
//       the sum modulo 256 and high byte the sum shifted down 8, each
//       clipped to 0..255;
//     * "I": a double sum rounded half away from zero to int32;
//     * "F": a double sum stored as float;
//   - libImaging/Geometry.c, ImagingScaleAffine: the nearest neighbour that
//     resize runs for mode "1", source positions stepped in double from
//     half a step.
// Built with -ffp-contract=off: Pillow's own build has no fused
// multiply-adds, and the fixed-point weights move with the last bit.
//
// Interface:
//   mods_resample(in, kind, filter, width, height, channels, out_width,
//   out_height, out, err, errlen): kind 0 uint8 with 1-4 interleaved
//   bands, 1 uint16, 2 int32, 3 float32; filter 0 Lanczos, 1 bicubic;
//   returns 0, or -1 with a message.
//   mods_resample_nearest(in, width, height, out_width, out_height, out):
//   one byte a pixel.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <type_traits>
#include <vector>

namespace {

constexpr int kPrecisionBits = 32 - 8 - 2;

double sinc_filter(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return sin(x) / x;
}

double lanczos_filter(double x) {
  if (-3.0 <= x && x < 3.0) return sinc_filter(x) * sinc_filter(x / 3);
  return 0.0;
}

double bicubic_filter(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

struct Filter {
  double (*fn)(double);
  double support;
};
const Filter kFilters[2] = {{lanczos_filter, 3.0}, {bicubic_filter, 2.0}};

struct Coeffs {
  int ksize = 0;
  std::vector<int> bounds;   // (xmin, count) of each output sample
  std::vector<double> kk;    // ksize weights of each output sample
};

// precompute_coeffs
Coeffs precompute(int in_size, float in0, float in1, int out_size,
                  const Filter &f) {
  Coeffs c;
  double filterscale, scale;
  filterscale = scale = (double)(in1 - in0) / out_size;
  if (filterscale < 1.0) filterscale = 1.0;
  double support = f.support * filterscale;
  c.ksize = (int)ceil(support) * 2 + 1;
  c.kk.assign((size_t)out_size * c.ksize, 0.0);
  c.bounds.assign((size_t)out_size * 2, 0);
  for (int xx = 0; xx < out_size; xx++) {
    double center = in0 + (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double *k = &c.kk[(size_t)xx * c.ksize];
    for (int x = 0; x < xmax; x++) {
      double w = f.fn((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; x++)
      if (ww != 0.0) k[x] /= ww;
    c.bounds[xx * 2] = xmin;
    c.bounds[xx * 2 + 1] = xmax;
  }
  return c;
}

// normalize_coeffs_8bpc
std::vector<int32_t> fixed_point(const Coeffs &c) {
  std::vector<int32_t> k(c.kk.size());
  for (size_t i = 0; i < c.kk.size(); i++)
    k[i] = c.kk[i] < 0 ? (int)(-0.5 + c.kk[i] * (1 << kPrecisionBits))
                       : (int)(0.5 + c.kk[i] * (1 << kPrecisionBits));
  return k;
}

inline uint8_t clip8(int v) {
  v >>= kPrecisionBits;
  return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v;
}

inline uint8_t clip_byte(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }

inline int round_up(double f) {
  return (int)(f >= 0.0 ? f + 0.5F : f - 0.5F);
}

// One pass over `lines` lines of `n` output samples, each the weighted sum
// of `stride`-spaced input samples: a horizontal pass has lines = rows
// (line step = a row), a vertical pass lines = columns.
template <typename T>
struct Plane {
  T *p;
  int64_t sample, line;     // element steps between samples and lines
  T &at(int64_t s, int64_t l) const { return p[s * sample + l * line]; }
};

void pass_8bpc(const Plane<const uint8_t> &in, const Plane<uint8_t> &out,
               int lines, int n, int offset, const Coeffs &c) {
  std::vector<int32_t> kk = fixed_point(c);
  for (int l = 0; l < lines; l++)
    for (int s = 0; s < n; s++) {
      int xmin = c.bounds[s * 2], xmax = c.bounds[s * 2 + 1];
      const int32_t *k = &kk[(size_t)s * c.ksize];
      int ss = 1 << (kPrecisionBits - 1);
      for (int x = 0; x < xmax; x++) ss += in.at(x + xmin, l + offset) * k[x];
      out.at(s, l) = clip8(ss);
    }
}

void pass_16bpc(const Plane<const uint16_t> &in, const Plane<uint16_t> &out,
                int lines, int n, int offset, const Coeffs &c) {
  for (int l = 0; l < lines; l++)
    for (int s = 0; s < n; s++) {
      int xmin = c.bounds[s * 2], xmax = c.bounds[s * 2 + 1];
      const double *k = &c.kk[(size_t)s * c.ksize];
      double ss = 0.0;
      for (int x = 0; x < xmax; x++) ss += in.at(x + xmin, l + offset) * k[x];
      int v = round_up(ss);
      out.at(s, l) = (uint16_t)(clip_byte(v % 256) | clip_byte(v >> 8) << 8);
    }
}

template <typename T>
void pass_32bpc(const Plane<const T> &in, const Plane<T> &out, int lines,
                int n, int offset, const Coeffs &c) {
  for (int l = 0; l < lines; l++)
    for (int s = 0; s < n; s++) {
      int xmin = c.bounds[s * 2], xmax = c.bounds[s * 2 + 1];
      const double *k = &c.kk[(size_t)s * c.ksize];
      double ss = 0.0;
      for (int x = 0; x < xmax; x++) ss += in.at(x + xmin, l + offset) * k[x];
      if constexpr (std::is_same_v<T, float>)
        out.at(s, l) = (float)ss;
      else
        out.at(s, l) = round_up(ss);
    }
}

// ImagingResampleInner for one band of `channels` interleaved ones
template <typename T>
void resample_band(const T *in, int w, int h, int channels, int band,
                   int ow, int oh, T *out, const Coeffs &ch,
                   const Coeffs &cv, std::vector<T> &temp) {
  bool need_h = ow != w, need_v = oh != h;
  int first = cv.bounds[0];
  int last = cv.bounds[oh * 2 - 2] + cv.bounds[oh * 2 - 1];
  Coeffs v = cv;
  auto run = [&](auto &&pass) {
    const T *src = in + band;
    int64_t src_row = (int64_t)w * channels;
    if (need_h) {
      for (int i = 0; i < oh; i++) v.bounds[i * 2] -= first;
      int rows = last - first;
      temp.assign((size_t)ow * rows, T());
      pass(Plane<const T>{src, channels, src_row}, Plane<T>{temp.data(), 1, ow},
           rows, ow, first, ch);
      src = temp.data();
      src_row = ow;
      if (!need_v) {
        for (int y = 0; y < oh; y++)
          for (int x = 0; x < ow; x++)
            out[((int64_t)y * ow + x) * channels + band] = temp[(size_t)y * ow + x];
        return;
      }
      // vertical: samples down a column, lines across it
      pass(Plane<const T>{src, src_row, 1},
           Plane<T>{out + band, (int64_t)ow * channels, channels}, ow, oh, 0, v);
    } else if (need_v) {
      pass(Plane<const T>{src, src_row, channels},
           Plane<T>{out + band, (int64_t)ow * channels, channels}, ow, oh, 0, v);
    } else {
      for (int64_t i = 0; i < (int64_t)w * h; i++)
        out[i * channels + band] = in[i * channels + band];
    }
  };
  if constexpr (std::is_same_v<T, uint8_t>)
    run(pass_8bpc);
  else if constexpr (std::is_same_v<T, uint16_t>)
    run(pass_16bpc);
  else
    run(pass_32bpc<T>);
}

template <typename T>
void resample(const void *in, int w, int h, int channels, int ow, int oh,
              void *out, const Filter &f) {
  Coeffs ch = precompute(w, 0.0f, (float)w, ow, f);
  Coeffs cv = precompute(h, 0.0f, (float)h, oh, f);
  std::vector<T> temp;
  for (int b = 0; b < channels; b++)
    resample_band<T>((const T *)in, w, h, channels, b, ow, oh, (T *)out, ch,
                     cv, temp);
}

}  // namespace

extern "C" int mods_resample(const void *in, int kind, int filter, int width,
                             int height, int channels, int out_width,
                             int out_height, void *out, char *err,
                             int errlen) {
  if (width < 1 || height < 1 || out_width < 1 || out_height < 1 ||
      channels < 1 || channels > 4 || (kind != 0 && channels != 1) ||
      filter < 0 || filter > 1) {
    snprintf(err, errlen, "cannot resample %dx%d (%d bands) to %dx%d with "
             "filter %d", width, height, channels, out_width, out_height,
             filter);
    return -1;
  }
  const Filter &f = kFilters[filter];
  switch (kind) {
    case 0: resample<uint8_t>(in, width, height, channels, out_width, out_height, out, f); break;
    case 1: resample<uint16_t>(in, width, height, 1, out_width, out_height, out, f); break;
    case 2: resample<int32_t>(in, width, height, 1, out_width, out_height, out, f); break;
    case 3: resample<float>(in, width, height, 1, out_width, out_height, out, f); break;
    default:
      snprintf(err, errlen, "unknown sample kind %d", kind);
      return -1;
  }
  return 0;
}

extern "C" void mods_resample_nearest(const uint8_t *in, int width, int height,
                                      int out_width, int out_height,
                                      uint8_t *out) {
  double a0 = (double)(float)width / out_width;
  double a4 = (double)(float)height / out_height;
  std::vector<int> xin(out_width, 0);
  int xmin = out_width, xmax = 0;
  double xo = a0 * 0.5;
  for (int x = 0; x < out_width; x++) {
    int xi = xo < 0.0 ? -1 : (int)xo;
    if (xi >= 0 && xi < width) {
      xmax = x + 1;
      if (x < xmin) xmin = x;
      xin[x] = xi;
    }
    xo += a0;
  }
  double yo = a4 * 0.5;
  for (int y = 0; y < out_height; y++) {
    int yi = yo < 0.0 ? -1 : (int)yo;
    uint8_t *row = out + (int64_t)y * out_width;
    memset(row, 0, out_width);
    if (yi >= 0 && yi < height)
      for (int x = xmin; x < xmax; x++) row[x] = in[(int64_t)yi * width + xin[x]];
    yo += a4;
  }
}
