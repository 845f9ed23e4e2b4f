// The byte loops of the TGA, SGI, PCX, QOI, PSD, MSP, Sun raster and XBM
// files that io/raster.py, io/psd.py and io/x11.py read and write as Pillow
// 12.1.0 does, bound with ctypes:
//   - mods_tga_rle_decode: libImaging/TgaRleDecode.c.  A packet's header
//     byte holds a count of 1-128 pixels of `depth` bytes: a run (high bit
//     set) repeats one pixel and must end inside its row, else the decode
//     fails; a literal copies its pixels and may run on into the next
//     rows.  Rows are written in file order.
//   - mods_sgi_rle_decode: libImaging/SgiRleDecode.c on the file after its
//     512-byte header: the start and length tables (big-endian, one entry
//     for each row of each band), then each row of each band expanded
//     (expandrow, expandrow2 for 2 bytes a sample: a count byte, the high
//     bit for a copy, 0 to end the row) into one row buffer kept from row
//     to row; the first row read is the image's last.  A count that runs
//     past the row or the file fails the decode; the last byte of a row's
//     length being anything but an end stops it, the rows after it left 0.
//   - mods_pcx_decode: libImaging/PcxDecode.c: a byte of 0xC0 and above is
//     a run of its low six bits' count of the next byte; a line's bytes
//     (planes x stride) moved to planes `xsize` apart where the stride is
//     not a multiple of the width (its memmove); a run past the line fails.
//   - mods_pcx_encode: libImaging/PcxEncode.c: each plane of each line
//     coded alone, runs of at most 63, a single byte below 0xC0 written
//     as itself, each plane padded to an even stride with zeros.
//   - mods_qoi_encode / mods_qoi_decode: QoiImagePlugin's QoiEncoder and
//     QoiDecoder (the index of 64 seen pixels starts with transparent
//     black in the encoder and empty in the decoder, runs of at most 62).
//   - mods_packbits_decode: libImaging/PackBitsDecode.c, as PsdImagePlugin
//     runs it on each channel: a byte n below 0x80 copies
//     the next n + 1 bytes, 0x80 is skipped, any other repeats the next
//     byte 257 - n times; the bytes past a row's end are dropped, and the
//     next code starts the next row.
//   - mods_msp_decode: MspImagePlugin's MspDecoder (Python in Pillow) on a
//     "LinS" file after its 32-byte header: a row map of one 16-bit length
//     a row, then each row's runs (a type byte 0, a count and a value; any
//     other type byte a count of literal bytes, cut where the row ends); a
//     row of length 0 is a white (0xFF) line.  The rows' bytes make one
//     stream, which Pillow then reads as packed lines whatever their
//     lengths; -1, -2, -3: a row map, a row cut short, a run cut short.
//   - mods_sun_rle_decode: libImaging/SunRleDecode.c: 0x80 0 is a literal
//     0x80, 0x80 n v a run of n + 1 bytes v, any other byte itself; a run
//     past the line is cut there and its rest (counted in an 8-bit
//     variable, as Pillow counts it) fills the next lines.  The lines are
//     the unpacker's bytes, without the file's 16-bit row padding.
//   - mods_xbm_decode: libImaging/XbmDecode.c: each byte is the two
//     characters after the next 'x', read as hex (a character that is not
//     a hex digit counts 0).
//   - mods_fli_decode: libImaging/FliDecode.c on one FLI/FLC frame: its
//     16-bit LE chunk types 4 and 11 (colour, left to FliImagePlugin), 7
//     (SS2 word delta), 12 (LC byte delta), 13 (black), 15 (BRUN), 16
//     (copy) and 18 (stamp, ignored), each moved past by its own length;
//     any other type, or a chunk that runs past the frame, fails.
//   - mods_pcd_decode: libImaging/PcdDecode.c and Pillow's "YCC;P"
//     unpacker (UnpackYCC.c): each pair of 768-sample luma lines shares
//     the chroma samples that follow them, and each PhotoYCC triplet goes
//     to RGB through UnpackYCC.c's tables (L is round(1.3584 y); the four
//     chroma tables are Pillow 12.1.0's, read out of its build) with
//     clamping to 0..255.
//
// Every function returns 0 (or the output's length), -1 where Pillow's
// decoder reports an overrun or a malformed file, or -2 where the data
// ends before the image does (mods_fli_decode: -3 for an unknown chunk,
// Pillow's IMAGING_CODEC_UNKNOWN, and -4 for a chunk that does not move,
// its IMAGING_CODEC_BROKEN).

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" int mods_tga_rle_decode(const uint8_t *data, int64_t n, int depth,
                                   int row_bytes, int rows, uint8_t *out) {
  int64_t pos = 0;
  int x = 0, y = 0;
  std::vector<uint8_t> buffer(row_bytes);
  while (true) {
    if (pos >= n) return -2;
    int count = depth * ((data[pos] & 0x7f) + 1);
    int extra = 0;
    if (data[pos] & 0x80) {
      if (n - pos < 1 + depth) return -2;
      if (x + count > row_bytes) return -1;
      for (int i = 0; i < count; i += depth)
        memcpy(&buffer[x + i], data + pos + 1, depth);
      pos += 1 + depth;
    } else {
      if (n - pos < 1 + count) return -2;
      if (x + count > row_bytes) {
        extra = count - (row_bytes - x);
        count = row_bytes - x;
      }
      memcpy(&buffer[x], data + pos + 1, count);
      pos += 1 + count;
    }
    while (true) {
      x += count;
      if (x >= row_bytes) {
        memcpy(out + (int64_t)y * row_bytes, buffer.data(), row_bytes);
        x = 0;
        if (++y >= rows) return 0;
      }
      if (extra == 0 || x > 0) break;
      count = extra >= row_bytes ? row_bytes : extra;
      memcpy(&buffer[x], data + pos, count);
      pos += count;
      extra -= count;
    }
  }
}

namespace {

int expandrow(uint8_t *dest, const uint8_t *src, int n, int z, int xsize,
              const uint8_t *end) {
  int x = 0;
  for (; n > 0; n--) {
    if (src > end) return -1;
    uint8_t pixel = *src++;
    if (n == 1 && pixel != 0) return n;
    uint8_t count = pixel & 0x7f;
    if (!count) return count;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + count > end) return -1;
      while (count--) {
        *dest = *src++;
        dest += z;
      }
    } else {
      if (src > end) return -1;
      pixel = *src++;
      while (count--) {
        *dest = pixel;
        dest += z;
      }
    }
  }
  return 0;
}

int expandrow2(uint8_t *dest, const uint8_t *src, int n, int z, int xsize,
               const uint8_t *end) {
  int x = 0;
  for (; n > 0; n--) {
    if (src + 1 > end) return -1;
    uint8_t pixel = src[1];
    src += 2;
    if (n == 1 && pixel != 0) return n;
    uint8_t count = pixel & 0x7f;
    if (!count) return count;
    if (x + count > xsize) return -1;
    x += count;
    if (pixel & 0x80) {
      if (src + 2 * count > end) return -1;
      while (count--) {
        memcpy(dest, src, 2);
        src += 2;
        dest += z * 2;
      }
    } else {
      if (src + 2 > end) return -1;
      while (count--) {
        memcpy(dest, src, 2);
        dest += z * 2;
      }
      src += 2;
    }
  }
  return 0;
}

uint32_t be32(const uint8_t *p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 |
         p[3];
}

}  // namespace

// `ptr` is the file after its header: `bufsize` bytes.  `out` holds
// ysize rows of xsize * bands * bpc bytes, top row first.
extern "C" int mods_sgi_rle_decode(const uint8_t *ptr, int64_t bufsize,
                                   int bands, int xsize, int ysize, int bpc,
                                   uint8_t *out) {
  const int64_t tablen = (int64_t)bands * ysize;
  if (bufsize < 8 * tablen) return -1;
  const int64_t row = (int64_t)xsize * bands * bpc;
  std::vector<uint8_t> buffer(row, 0);
  const uint8_t *end = ptr + bufsize - 1;
  for (int rowno = 0; rowno < ysize; rowno++) {
    for (int ch = 0; ch < bands; ch++) {
      int64_t t = rowno + (int64_t)ch * ysize;
      uint32_t offset = be32(ptr + 4 * t);
      uint32_t length = be32(ptr + 4 * (tablen + t));
      if (offset < 512) return -1;
      offset -= 512;
      if ((int64_t)(uint32_t)(offset + length) > bufsize) return -1;
      int status = bpc == 1
          ? expandrow(&buffer[ch], ptr + offset, (int)length, bands, xsize, end)
          : expandrow2(&buffer[ch * 2], ptr + offset, (int)length, bands,
                       xsize, end);
      if (status == -1) return -1;
      if (status == 1) return 0;
    }
    memcpy(out + (int64_t)(ysize - 1 - rowno) * row, buffer.data(), row);
  }
  return 0;
}

// `bytes` is the line's length (planes x stride), `bits` the unpacker's
// bits a pixel; `out` holds ysize lines of `bytes` bytes.
extern "C" int mods_pcx_decode(const uint8_t *data, int64_t n, int bytes,
                               int xsize, int bits, int ysize, uint8_t *out) {
  if (((int64_t)xsize * bits + 7) / 8 > bytes) return -1;
  std::vector<uint8_t> buffer(bytes);
  int64_t pos = 0;
  int x = 0, y = 0;
  bool overrun = false;
  while (true) {
    if (pos >= n) return -2;
    if ((data[pos] & 0xC0) == 0xC0) {
      if (n - pos < 2) return -2;
      int k = data[pos] & 0x3F;
      while (k > 0) {
        if (x >= bytes) {
          overrun = true;
          break;
        }
        buffer[x++] = data[pos + 1];
        k--;
      }
      pos += 2;
    } else {
      buffer[x++] = data[pos++];
    }
    if (x >= bytes) {
      if (bytes % xsize && bytes > xsize) {
        int bands = bytes / xsize;
        int stride = bytes / bands;
        for (int i = 1; i < bands; i++)
          memmove(&buffer[(int64_t)i * xsize], &buffer[(int64_t)i * stride],
                  xsize);
      }
      memcpy(out + (int64_t)y * bytes, buffer.data(), bytes);
      x = 0;
      if (++y >= ysize) return overrun ? -1 : 0;
    }
  }
}

// `rows` holds ysize lines of planes x ((xsize * bpp + 7) / 8) bytes, as
// Pillow's packer gives them ("1", "L" or "RGB;L"); `bits` is 1, 8 or 24.
extern "C" int64_t mods_pcx_encode(const uint8_t *rows, int xsize, int ysize,
                                   int bits, uint8_t *out) {
  int planes = 1, bpp = bits;
  if (bits == 24) {
    planes = 3;
    bpp = 8;
  }
  const int per_line = (xsize * bpp + 7) / 8;
  const int padding = per_line % 2;
  uint8_t *ptr = out;
  auto flush = [&](int count, int last) {
    if (count == 1 && last < 0xC0) {
      *ptr++ = last;
    } else if (count > 0) {
      *ptr++ = 0xC0 | count;
      *ptr++ = last;
    }
  };
  for (int y = 0; y < ysize; y++) {
    const uint8_t *line = rows + (int64_t)y * planes * per_line;
    int x = 1, count = 1, last = line[0];
    do {
      while (x % per_line) {
        if (count == 63) {
          *ptr++ = 0xC0 | count;
          *ptr++ = last;
          count = 0;
        }
        int cur = line[x];
        if (cur == last) {
          x++;
          count++;
        } else {
          flush(count, last);
          last = cur;
          count = 1;
          x++;
        }
      }
      flush(count, last);
      for (int i = 0; i < padding; i++) *ptr++ = 0;
      if (x < planes * per_line) {
        count = 1;
        last = line[x];
        x++;
      }
    } while (x < planes * per_line);
  }
  return ptr - out;
}

namespace {

inline int qoi_hash(const uint8_t *p) {
  return (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64;
}

inline int delta(int left, int right) {
  int r = (left - right) & 255;
  return r >= 128 ? r - 256 : r;
}

}  // namespace

// `pixels` holds npx pixels of `channels` (3 or 4) bytes; `out` needs at
// most npx * 5 + 8 bytes.
extern "C" int64_t mods_qoi_encode(const uint8_t *pixels, int64_t npx,
                                   int channels, uint8_t *out) {
  uint8_t seen[64][4];
  bool known[64] = {true};
  memset(seen, 0, sizeof seen);
  uint8_t prev[4] = {0, 0, 0, 255};
  uint8_t *ptr = out;
  int run = 0;
  for (int64_t i = 0; i < npx; i++) {
    uint8_t px[4] = {0, 0, 0, 255};
    memcpy(px, pixels + i * channels, channels);
    if (!memcmp(px, prev, 4)) {
      if (++run == 62) {
        *ptr++ = 0xC0 | (run - 1);
        run = 0;
      }
    } else {
      if (run) {
        *ptr++ = 0xC0 | (run - 1);
        run = 0;
      }
      int h = qoi_hash(px);
      if (known[h] && !memcmp(seen[h], px, 4)) {
        *ptr++ = h;
      } else {
        memcpy(seen[h], px, 4);
        known[h] = true;
        if (prev[3] == px[3]) {
          int dr = delta(px[0], prev[0]), dg = delta(px[1], prev[1]),
              db = delta(px[2], prev[2]);
          if (-2 <= dr && dr < 2 && -2 <= dg && dg < 2 && -2 <= db && db < 2) {
            *ptr++ = 0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2);
          } else {
            int dgr = delta(dr, dg), dgb = delta(db, dg);
            if (-8 <= dgr && dgr < 8 && -32 <= dg && dg < 32 && -8 <= dgb &&
                dgb < 8) {
              *ptr++ = 0x80 | (dg + 32);
              *ptr++ = (dgr + 8) << 4 | (dgb + 8);
            } else {
              *ptr++ = 0xFE;
              memcpy(ptr, px, 3);
              ptr += 3;
            }
          }
        } else {
          *ptr++ = 0xFF;
          memcpy(ptr, px, 4);
          ptr += 4;
        }
      }
    }
    memcpy(prev, px, 4);
  }
  if (run) *ptr++ = 0xC0 | (run - 1);
  static const uint8_t padding[8] = {0, 0, 0, 0, 0, 0, 0, 1};
  memcpy(ptr, padding, 8);
  return ptr + 8 - out;
}

// `data` is the file after its 14-byte header; `out` holds npx pixels of
// `channels` bytes.
extern "C" int mods_qoi_decode(const uint8_t *data, int64_t n, int64_t npx,
                               int channels, uint8_t *out) {
  uint8_t seen[64][4];
  memset(seen, 0, sizeof seen);
  uint8_t prev[4] = {0, 0, 0, 255};
  int64_t pos = 0, i = 0;
  auto emit = [&](const uint8_t *v, int64_t times) {
    for (; times > 0 && i < npx; times--, i++)
      memcpy(out + i * channels, v, channels);
  };
  while (i < npx) {
    if (pos >= n) return -2;
    uint8_t b = data[pos++];
    uint8_t v[4];
    if (b == 0xFE) {
      if (n - pos < 3) return -2;
      memcpy(v, data + pos, 3);
      v[3] = prev[3];
      pos += 3;
    } else if (b == 0xFF) {
      if (n - pos < 4) return -2;
      memcpy(v, data + pos, 4);
      pos += 4;
    } else if (b >> 6 == 0) {
      memcpy(v, seen[b & 63], 4);
    } else if (b >> 6 == 1) {
      v[0] = prev[0] + ((b >> 4) & 3) - 2;
      v[1] = prev[1] + ((b >> 2) & 3) - 2;
      v[2] = prev[2] + (b & 3) - 2;
      v[3] = prev[3];
    } else if (b >> 6 == 2) {
      if (pos >= n) return -2;
      uint8_t second = data[pos++];
      int dg = (b & 63) - 32;
      v[0] = prev[0] + dg + ((second >> 4) - 8);
      v[1] = prev[1] + dg;
      v[2] = prev[2] + dg + ((second & 15) - 8);
      v[3] = prev[3];
    } else {
      emit(prev, (b & 63) + 1);
      continue;
    }
    memcpy(prev, v, 4);
    memcpy(seen[qoi_hash(v)], v, 4);
    emit(v, 1);
  }
  return 0;
}

// `rows` rows of `row_bytes` bytes into `out`.
extern "C" int mods_packbits_decode(const uint8_t *data, int64_t n,
                                    int64_t row_bytes, int rows,
                                    uint8_t *out) {
  int64_t pos = 0, x = 0;
  for (int y = 0; y < rows;) {
    if (pos >= n) return -2;
    uint8_t *row = out + (int64_t)y * row_bytes;
    uint8_t b = data[pos];
    if (b == 0x80) {
      pos++;
      continue;
    }
    if (b & 0x80) {
      if (n - pos < 2) return -2;
      for (int k = 257 - b; k > 0 && x < row_bytes; k--) row[x++] = data[pos + 1];
      pos += 2;
    } else {
      int64_t len = b + 1;
      if (n - pos < 1 + len) return -2;
      for (int64_t i = 0; i < len && x < row_bytes; i++) row[x++] = data[pos + 1 + i];
      pos += 1 + len;
    }
    if (x >= row_bytes) {
      x = 0;
      y++;
    }
  }
  return 0;
}

// `data` is the file after its header; `out` takes the first `cap` bytes of
// the stream; returns the stream's whole length, or a negative error.
extern "C" int64_t mods_msp_decode(const uint8_t *data, int64_t n, int xsize,
                                   int ysize, uint8_t *out, int64_t cap,
                                   int *bad_row) {
  const int64_t blank = (xsize + 7) / 8;
  int64_t pos = 2 * (int64_t)ysize, length = 0;
  if (n < pos) return -1;
  auto emit = [&](const uint8_t *v, int64_t k) {
    for (int64_t i = 0; i < k; i++, length++)
      if (length < cap) out[length] = v[i];
  };
  const uint8_t white = 0xFF;
  for (int y = 0; y < ysize; y++) {
    const int64_t rowlen = data[2 * y] | data[2 * y + 1] << 8;
    *bad_row = y;
    if (rowlen == 0) {
      for (int64_t i = 0; i < blank; i++) emit(&white, 1);
      continue;
    }
    if (n - pos < rowlen) return -2;
    const uint8_t *row = data + pos;
    pos += rowlen;
    int64_t idx = 0;
    while (idx < rowlen) {
      const int runtype = row[idx++];
      if (runtype == 0) {
        if (idx + 2 > rowlen) return -3;
        for (int k = 0; k < row[idx]; k++) emit(&row[idx + 1], 1);
        idx += 2;
      } else {
        emit(row + idx, idx + runtype > rowlen ? rowlen - idx : runtype);
        idx += runtype;
      }
    }
  }
  return length;
}

// `rows` lines of `row_bytes` bytes into `out`.
extern "C" int mods_sun_rle_decode(const uint8_t *data, int64_t n,
                                   int64_t row_bytes, int rows, uint8_t *out) {
  std::vector<uint8_t> buffer(row_bytes);
  int64_t pos = 0, x = 0;
  int y = 0;
  while (true) {
    uint8_t extra_data = 0, extra_bytes = 0;
    int64_t k;
    if (n - pos < 1) return -2;
    if (data[pos] == 0x80) {
      if (n - pos < 2) return -2;
      k = data[pos + 1];
      if (k == 0) {
        k = 1;
        buffer[x] = 0x80;
        pos += 2;
      } else {
        if (n - pos < 3) return -2;
        k += 1;
        if (x + k > row_bytes) {
          extra_bytes = (uint8_t)k;
          k = row_bytes - x;
          extra_bytes -= (uint8_t)k;
          extra_data = data[pos + 2];
        }
        memset(&buffer[x], data[pos + 2], k);
        pos += 3;
      }
    } else {
      k = 1;
      buffer[x] = data[pos++];
    }
    while (true) {
      x += k;
      if (x >= row_bytes) {
        memcpy(out + (int64_t)y * row_bytes, buffer.data(), row_bytes);
        x = 0;
        if (++y >= rows) return 0;
      }
      if (extra_bytes == 0 || x > 0) break;
      k = extra_bytes >= row_bytes ? row_bytes : extra_bytes;
      memset(&buffer[x], extra_data, k);
      extra_bytes -= (uint8_t)k;
    }
  }
}

namespace {

inline int hex_digit(uint8_t v) {
  return v >= '0' && v <= '9'   ? v - '0'
         : v >= 'a' && v <= 'f' ? v - 'a' + 10
         : v >= 'A' && v <= 'F' ? v - 'A' + 10
                                : 0;
}

}  // namespace

// `data` is the file from the end of the header's match; `rows` lines of
// `row_bytes` bytes into `out`.
extern "C" int mods_xbm_decode(const uint8_t *data, int64_t n,
                               int64_t row_bytes, int rows, uint8_t *out) {
  int64_t pos = 0, i = 0, total = row_bytes * rows;
  while (i < total) {
    while (pos < n && data[pos] != 'x') pos++;
    if (n - pos < 3) return -2;
    out[i++] = hex_digit(data[pos + 1]) << 4 | hex_digit(data[pos + 2]);
    pos += 3;
  }
  return 0;
}

namespace {

inline int fli16(const uint8_t *p) { return p[0] + (p[1] << 8); }
inline int fli32(const uint8_t *p) {
  return static_cast<int>(static_cast<uint32_t>(p[0]) | p[1] << 8 |
                          p[2] << 16 | static_cast<uint32_t>(p[3]) << 24);
}

}  // namespace

// One frame at `buf` (the `bytes` that FliImagePlugin's load hands the
// decoder) into `out`, xsize x ysize indices, which hold the frame before
// (zeros for the first).
extern "C" int mods_fli_decode(const uint8_t *buf, int64_t bytes, int xsize,
                               int ysize, uint8_t *out) {
  if (bytes < 4) return -2;
  const uint8_t *ptr = buf;
  int framesize = fli32(ptr);
  if (bytes + (bytes % 2) < framesize) return -2;  // one pad byte allowed
  if (bytes < 8) return -1;
  if (fli16(ptr + 4) != 0xF1FA) return -3;
  int chunks = fli16(ptr + 6);
  ptr += 16;
  bytes -= 16;
  auto row = [&](int y) { return out + static_cast<int64_t>(y) * xsize; };
  for (int c = 0; c < chunks; c++) {
    if (bytes < 10) return -1;
    const uint8_t *data = ptr + 6;
    auto oob = [&](int64_t k) { return data + k > ptr + bytes; };
    int x = 0, y, i;
    switch (fli16(ptr + 4)) {
      case 4:
      case 11:  // colour: FliImagePlugin's palette
        break;
      case 7: {  // SS2, word delta
        int lines = fli16(data);
        data += 2;
        int l;
        for (l = y = 0; l < lines && y < ysize; l++, y++) {
          uint8_t *local = row(y);
          if (oob(2)) return -1;
          int packets = fli16(data);
          data += 2;
          while (packets & 0x8000) {
            if (packets & 0x4000) {  // skip lines
              y += 65536 - packets;
              if (y >= ysize) return -1;
              local = row(y);
            } else {  // the last byte of an odd-width line
              local[xsize - 1] = static_cast<uint8_t>(packets);
            }
            if (oob(2)) return -1;
            packets = fli16(data);
            data += 2;
          }
          int p;
          for (p = x = 0; p < packets; p++) {
            if (oob(2)) return -1;
            x += data[0];
            if (data[1] >= 128) {
              if (oob(4)) return -1;
              i = 256 - data[1];
              if (x + i + i > xsize) break;
              for (int j = 0; j < i; j++) {
                local[x++] = data[2];
                local[x++] = data[3];
              }
              data += 4;
            } else {
              i = 2 * static_cast<int>(data[1]);
              if (x + i > xsize) break;
              if (oob(2 + i)) return -1;
              memcpy(local + x, data + 2, i);
              data += 2 + i;
              x += i;
            }
          }
          if (p < packets) break;
        }
        if (l < lines) return -1;
        break;
      }
      case 12: {  // LC, byte delta
        y = fli16(data);
        int ymax = y + fli16(data + 2);
        data += 4;
        for (; y < ymax && y < ysize; y++) {
          uint8_t *o = row(y);
          if (oob(1)) return -1;
          int p, packets = *data++;
          for (p = x = 0; p < packets; p++, x += i) {
            if (oob(2)) return -1;
            x += data[0];
            if (data[1] & 0x80) {
              i = 256 - data[1];
              if (x + i > xsize) break;
              if (oob(3)) return -1;
              memset(o + x, data[2], i);
              data += 3;
            } else {
              i = data[1];
              if (x + i > xsize) break;
              if (oob(2 + i)) return -1;
              memcpy(o + x, data + 2, i);
              data += i + 2;
            }
          }
          if (p < packets) break;
        }
        if (y < ymax) return -1;
        break;
      }
      case 13:  // black
        memset(out, 0, static_cast<size_t>(xsize) * ysize);
        break;
      case 15:  // BRUN, byte run length
        for (y = 0; y < ysize; y++) {
          uint8_t *o = row(y);
          data += 1;  // the packet count is ignored
          for (x = 0; x < xsize; x += i) {
            if (oob(2)) return -1;
            if (data[0] & 0x80) {
              i = 256 - data[0];
              if (x + i > xsize) break;
              if (oob(i + 1)) return -1;
              memcpy(o + x, data + 1, i);
              data += i + 1;
            } else {
              i = data[0];
              if (x + i > xsize) break;
              memset(o + x, data[1], i);
              data += 2;
            }
          }
          if (x != xsize) return -1;
        }
        break;
      case 16:  // copy
        if (INT32_MAX / xsize < ysize) return -1;
        if (oob(static_cast<int64_t>(xsize) * ysize)) return -2;
        for (y = 0; y < ysize; y++) {
          memcpy(row(y), data, xsize);
          data += xsize;
        }
        break;
      case 18:  // postage stamp
        break;
      default:
        return -3;
    }
    int advance = fli32(ptr);
    if (advance == 0) return -4;
    if (advance < 0 || advance > bytes) return -1;
    ptr += advance;
    bytes -= advance;
  }
  return 0;
}

namespace {

const int16_t kCb[256] = {
    -345, -343, -341, -338, -336, -334, -332, -329, -327, -325, -323, -321, -318, -316, -314, -312,
    -310, -307, -305, -303, -301, -298, -296, -294, -292, -290, -287, -285, -283, -281, -278, -276,
    -274, -272, -270, -267, -265, -263, -261, -258, -256, -254, -252, -250, -247, -245, -243, -241,
    -239, -236, -234, -232, -230, -227, -225, -223, -221, -219, -216, -214, -212, -210, -207, -205,
    -203, -201, -199, -196, -194, -192, -190, -188, -185, -183, -181, -179, -176, -174, -172, -170,
    -168, -165, -163, -161, -159, -156, -154, -152, -150, -148, -145, -143, -141, -139, -137, -134,
    -132, -130, -128, -125, -123, -121, -119, -117, -114, -112, -110, -108, -105, -103, -101, -99,
    -97, -94, -92, -90, -88, -85, -83, -81, -79, -77, -74, -72, -70, -68, -66, -63,
    -61, -59, -57, -54, -52, -50, -48, -46, -43, -41, -39, -37, -34, -32, -30, -28,
    -26, -23, -21, -19, -17, -15, -12, -10, -8, -6, -3, -1, 0, 2, 4, 7,
    9, 11, 13, 16, 18, 20, 22, 24, 27, 29, 31, 33, 35, 38, 40, 42,
    44, 47, 49, 51, 53, 55, 58, 60, 62, 64, 67, 69, 71, 73, 75, 78,
    80, 82, 84, 86, 89, 91, 93, 95, 98, 100, 102, 104, 106, 109, 111, 113,
    115, 118, 120, 122, 124, 126, 129, 131, 133, 135, 138, 140, 142, 144, 146, 149,
    151, 153, 155, 157, 160, 162, 164, 166, 169, 171, 173, 175, 177, 180, 182, 184,
    186, 189, 191, 193, 195, 197, 200, 202, 204, 206, 208, 211, 213, 215, 217, 220};
const int16_t kGb[256] = {
    67, 67, 66, 66, 65, 65, 65, 64, 64, 63, 63, 62, 62, 62, 61, 61,
    60, 60, 59, 59, 59, 58, 58, 57, 57, 56, 56, 56, 55, 55, 54, 54,
    53, 53, 52, 52, 52, 51, 51, 50, 50, 49, 49, 49, 48, 48, 47, 47,
    46, 46, 46, 45, 45, 44, 44, 43, 43, 43, 42, 42, 41, 41, 40, 40,
    40, 39, 39, 38, 38, 37, 37, 37, 36, 36, 35, 35, 34, 34, 34, 33,
    33, 32, 32, 31, 31, 31, 30, 30, 29, 29, 28, 28, 28, 27, 27, 26,
    26, 25, 25, 25, 24, 24, 23, 23, 22, 22, 22, 21, 21, 20, 20, 19,
    19, 19, 18, 18, 17, 17, 16, 16, 15, 15, 15, 14, 14, 13, 13, 12,
    12, 12, 11, 11, 10, 10, 9, 9, 9, 8, 8, 7, 7, 6, 6, 6,
    5, 5, 4, 4, 3, 3, 3, 2, 2, 1, 1, 0, 0, 0, 0, 0,
    -1, -1, -2, -2, -2, -3, -3, -4, -4, -5, -5, -5, -6, -6, -7, -7,
    -8, -8, -8, -9, -9, -10, -10, -11, -11, -11, -12, -12, -13, -13, -14, -14,
    -14, -15, -15, -16, -16, -17, -17, -18, -18, -18, -19, -19, -20, -20, -21, -21,
    -21, -22, -22, -23, -23, -24, -24, -24, -25, -25, -26, -26, -27, -27, -27, -28,
    -28, -29, -29, -30, -30, -30, -31, -31, -32, -32, -33, -33, -33, -34, -34, -35,
    -35, -36, -36, -36, -37, -37, -38, -38, -39, -39, -39, -40, -40, -41, -41, -42};
const int16_t kCr[256] = {
    -249, -247, -245, -243, -241, -239, -238, -236, -234, -232, -230, -229, -227, -225, -223, -221,
    -219, -218, -216, -214, -212, -210, -208, -207, -205, -203, -201, -199, -198, -196, -194, -192,
    -190, -188, -187, -185, -183, -181, -179, -178, -176, -174, -172, -170, -168, -167, -165, -163,
    -161, -159, -157, -156, -154, -152, -150, -148, -147, -145, -143, -141, -139, -137, -136, -134,
    -132, -130, -128, -127, -125, -123, -121, -119, -117, -116, -114, -112, -110, -108, -106, -105,
    -103, -101, -99, -97, -96, -94, -92, -90, -88, -86, -85, -83, -81, -79, -77, -76,
    -74, -72, -70, -68, -66, -65, -63, -61, -59, -57, -55, -54, -52, -50, -48, -46,
    -45, -43, -41, -39, -37, -35, -34, -32, -30, -28, -26, -25, -23, -21, -19, -17,
    -15, -14, -12, -10, -8, -6, -4, -3, -1, 0, 2, 4, 5, 7, 9, 11,
    13, 15, 16, 18, 20, 22, 24, 26, 27, 29, 31, 33, 35, 36, 38, 40,
    42, 44, 46, 47, 49, 51, 53, 55, 56, 58, 60, 62, 64, 66, 67, 69,
    71, 73, 75, 77, 78, 80, 82, 84, 86, 87, 89, 91, 93, 95, 97, 98,
    100, 102, 104, 106, 107, 109, 111, 113, 115, 117, 118, 120, 122, 124, 126, 128,
    129, 131, 133, 135, 137, 138, 140, 142, 144, 146, 148, 149, 151, 153, 155, 157,
    158, 160, 162, 164, 166, 168, 169, 171, 173, 175, 177, 179, 180, 182, 184, 186,
    188, 189, 191, 193, 195, 197, 199, 200, 202, 204, 206, 208, 209, 211, 213, 215};
const int16_t kGr[256] = {
    127, 126, 125, 124, 123, 122, 121, 121, 120, 119, 118, 117, 116, 115, 114, 113,
    112, 111, 110, 109, 108, 108, 107, 106, 105, 104, 103, 102, 101, 100, 99, 98,
    97, 96, 95, 95, 94, 93, 92, 91, 90, 89, 88, 87, 86, 85, 84, 83,
    83, 82, 81, 80, 79, 78, 77, 76, 75, 74, 73, 72, 71, 70, 70, 69,
    68, 67, 66, 65, 64, 63, 62, 61, 60, 59, 58, 57, 57, 56, 55, 54,
    53, 52, 51, 50, 49, 48, 47, 46, 45, 45, 44, 43, 42, 41, 40, 39,
    38, 37, 36, 35, 34, 33, 32, 32, 31, 30, 29, 28, 27, 26, 25, 24,
    23, 22, 21, 20, 19, 19, 18, 17, 16, 15, 14, 13, 12, 11, 10, 9,
    8, 7, 6, 6, 5, 4, 3, 2, 1, 0, 0, -1, -2, -3, -4, -5,
    -5, -6, -7, -8, -9, -10, -11, -12, -13, -14, -15, -16, -17, -18, -18, -19,
    -20, -21, -22, -23, -24, -25, -26, -27, -28, -29, -30, -31, -31, -32, -33, -34,
    -35, -36, -37, -38, -39, -40, -41, -42, -43, -44, -44, -45, -46, -47, -48, -49,
    -50, -51, -52, -53, -54, -55, -56, -56, -57, -58, -59, -60, -61, -62, -63, -64,
    -65, -66, -67, -68, -69, -69, -70, -71, -72, -73, -74, -75, -76, -77, -78, -79,
    -80, -81, -82, -82, -83, -84, -85, -86, -87, -88, -89, -90, -91, -92, -93, -94,
    -94, -95, -96, -97, -98, -99, -100, -101, -102, -103, -104, -105, -106, -107, -107, -108};

}  // namespace

// The 768x512 image base of a Photo CD file from byte 96 * 2048: `n`
// bytes at `data`, RGB into `out`.
extern "C" int mods_pcd_decode(const uint8_t *data, int64_t n, uint8_t *out) {
  const int xsize = 768, ysize = 512, chunk = 3 * xsize;
  auto put = [&](uint8_t *o, int yy, int cb, int cr) {
    int l = (yy * 13584 + 5000) / 10000;  // no ties: 1698 y = 625 mod 1250
    int r = l + kCr[cr], g = l + kGr[cr] + kGb[cb], b = l + kCb[cb];
    o[0] = static_cast<uint8_t>(r <= 0 ? 0 : r >= 255 ? 255 : r);
    o[1] = static_cast<uint8_t>(g <= 0 ? 0 : g >= 255 ? 255 : g);
    o[2] = static_cast<uint8_t>(b <= 0 ? 0 : b >= 255 ? 255 : b);
  };
  const uint8_t *ptr = data;
  for (int y = 0; y < ysize; y += 2) {
    if (n < chunk) return -2;  // two lines and their chroma
    for (int line = 0; line < 2; line++) {
      uint8_t *o = out + static_cast<int64_t>(y + line) * xsize * 3;
      for (int x = 0; x < xsize; x++)
        put(o + 3 * x, ptr[x + line * xsize], ptr[(x + 4 * xsize) / 2],
            ptr[(x + 5 * xsize) / 2]);
    }
    ptr += chunk;
    n -= chunk;
  }
  return 0;
}
