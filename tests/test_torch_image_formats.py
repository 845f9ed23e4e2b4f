"""Port vs PIL and the JAX reference: TIFF, GIF, PFM, RLE and 16-bit BMP,
CMYK JPEG, and the JPEG, TIFF, PFM and int32/float writers (CPU).

Tolerances.
* Every reader case: ``io/image.py::_read`` gives
  ``np.asarray(Image.open(p))`` (the same dtype, shape and values) and
  ``Image.open(p).mode``; ``image_size`` gives ``Image.open(p).size``.
  Files are PIL's where PIL writes them (its default TIFF, and
  ``compression=`` "tiff_lzw", "packbits", "tiff_deflate",
  "tiff_adobe_deflate", ``tiffinfo={317: 2}`` for the predictor,
  ``strip_size=`` for several strips; GIF with and without interlace;
  PFM; CMYK JPEG) and written by hand where PIL writes no such file
  (tiled, planar-2, MM 8-bit and 32-bit, WhiteIsZero, Deflate 32946 and
  RGBX TIFFs; a GIF with a local palette; big-endian PFM; RLE8, RLE4
  and 16-bit BMPs), PIL's reading of the same bytes being the reference.
  LZW's code widths differ between TIFF and GIF only past 511 codes, so
  both are also read at 1000x598.
* Writers: ``save_image`` to .jpg/.jpeg and .tif writes PIL's bytes for
  every array PIL writes there; .pfm, .ppm, .pgm, .png and .tif files of
  int32 and float arrays open in PIL in the mode of PIL's own save, with
  its array; each refusal is a ValueError naming the case, as PIL
  refuses it.
* ``cli match`` on ``test_torch_cli.py``'s textured pair saved as TIFF,
  its drawings named .jpg, against ``mods_tpu.cli.cmd_match``: that
  file's rule (the same steps, the verified count within 20 %); each
  package's drawings open in PIL as RGB, and the port's are PIL's bytes
  for ``viz``'s canvas of the matches it wrote.

``python tests/test_torch_image_formats.py --fixtures`` writes the
fixtures of ``chip_smoke.py`` phase 14e (``tests/data/image_io``);
``JAX_PLATFORMS=cpu python tests/test_torch_image_formats.py --jax-tiff``
prints the JAX command's figures on phase 14g's TIFF pair
(``chip_smoke.JAX_TIFF_REFERENCE``).
"""

import hashlib
import io
import os
import struct
import sys
import warnings
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

import chip_smoke  # noqa: E402
from mods_tpu import cli as jcli  # noqa: E402
from mods_tpu_torch import cli as tcli  # noqa: E402
from mods_tpu_torch import viz  # noqa: E402
from mods_tpu_torch.io.image import (_read, image_size,  # noqa: E402
                                     read_image, save_image)
from mods_tpu_torch.io.regions_io import read_h, read_matches  # noqa: E402
from test_pipeline import textured_image, warp_np  # noqa: E402
from test_torch_cli import (SHIFT, SMALL_ITERS,  # noqa: E402
                            load_jax_native)

torch.set_num_threads(2)

RNG = np.random.default_rng(0)
GRAY = RNG.integers(0, 256, (37, 53)).astype(np.uint8)
GRAY[5:20, 5:30] = 9                  # flat runs: PackBits and RLE repeats
RGB = np.stack([GRAY, GRAY // 2, 255 - GRAY], -1)
RGBA = np.concatenate([RGB, GRAY[..., None]], -1)
WIDE = GRAY.astype(np.uint16) * 251 + 7


def _zoom(i=1):
    return np.asarray(Image.open(os.path.join(REPO, ".parity_work",
                                              f"zoom2x_{i}.png")))


def _photo(h, w):
    """(h, w) gray and RGB crops of the zoom2x and tilt4 views."""
    a = _zoom()[100:100 + h, 0:w]
    b = np.asarray(Image.open(os.path.join(REPO, ".parity_work",
                                           "tilt4_1.png")))[:h, :w]
    return a, np.stack([a, b, 255 - a // 2], -1)


def _hold(p):
    """``_read``, ``read_image`` and ``image_size`` against PIL."""
    im = Image.open(p)
    want = np.asarray(im)
    got, mode = _read(p)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)
    assert mode == im.mode
    assert image_size(p) == im.size
    np.testing.assert_array_equal(read_image(p), want)


# ---------------------------------------------------------------------------
# files by hand

def _packbits(raw: bytes) -> bytes:
    """PackBits: a repeat run for 3 or more equal bytes, literals
    otherwise."""
    out, i = bytearray(), 0
    while i < len(raw):
        j = i
        while j < len(raw) and j - i < 128 and raw[j] == raw[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), raw[i]])
            i = j
            continue
        j = i
        while j < len(raw) and j - i < 128 and not (
                j + 2 < len(raw) and raw[j] == raw[j + 1] == raw[j + 2]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + raw[i:j]
        i = j
    return bytes(out)


def _tiff(a, bo="<", photometric=1, sample_format=1, extra=None,
          compression=1, predictor=1, planar=1, tile=None,
          rows_per_strip=None):
    """A TIFF of (H, W[, S]) samples of 8, 16 or 32 bits: strips or
    (th, tw) tiles, planar configuration 1 or 2, compression 1 (none),
    8 or 32946 (Deflate) or 32773 (PackBits), predictor 1 or 2."""
    a = a if a.ndim == 3 else a[..., None]
    h, w, spp = a.shape
    bits = a.dtype.itemsize * 8
    dt = a.dtype.newbyteorder(bo)

    def encode(block):
        if predictor == 2:
            u = block.view(f"u{block.dtype.itemsize}")
            block = np.diff(u, axis=1, prepend=np.zeros_like(u[:, :1]))
        raw = np.ascontiguousarray(block).astype(
            block.dtype.newbyteorder(bo)).tobytes()
        if compression in (8, 32946):
            return zlib.compress(raw)
        return _packbits(raw) if compression == 32773 else raw

    planes = [slice(p, p + 1) for p in range(spp)] if planar == 2 \
        else [slice(None)]
    chunks = []
    if tile:
        th, tw = tile
        pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw, spp), a.dtype)
        pad[:h, :w] = a
        for pl in planes:
            for y in range(0, pad.shape[0], th):
                for x in range(0, pad.shape[1], tw):
                    chunks.append(encode(pad[y:y + th, x:x + tw, pl]))
    else:
        rps = rows_per_strip or h
        for pl in planes:
            for y in range(0, h, rps):
                chunks.append(encode(a[y:y + rps, :, pl]))
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar]),
            339: (3, [sample_format] * spp)}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if extra is not None:
        tags[338] = (3, list(extra))
    if tile:
        tags[322], tags[323] = (4, [tile[1]]), (4, [tile[0]])
        offsets_tag, counts_tag = 324, 325
    else:
        tags[278] = (4, [rows_per_strip or h])
        offsets_tag, counts_tag = 273, 279
    tags[offsets_tag] = (4, [0] * len(chunks))
    tags[counts_tag] = (4, [len(c) for c in chunks])
    order = sorted(tags)

    def pack(t, vals):
        return struct.pack(f"{bo}{len(vals)}{'H' if t == 3 else 'I'}", *vals)

    pos = 8 + 2 + 12 * len(order) + 4
    big = {k: pack(*tags[k]) for k in order if len(pack(*tags[k])) > 4}
    data_at = pos + sum(len(v) + len(v) % 2 for v in big.values())
    offs, at = [], data_at
    for c in chunks:
        offs.append(at)
        at += len(c)
    tags[offsets_tag] = (4, offs)
    big = {k: pack(*tags[k]) for k in order if len(pack(*tags[k])) > 4}
    ifd, extras = [], b""
    for k in order:
        t, vals = tags[k]
        v = pack(t, vals)
        if len(v) > 4:
            ifd.append(struct.pack(bo + "HHII", k, t, len(vals),
                                   pos + len(extras)))
            extras += v + bytes(len(v) % 2)
        else:
            ifd.append(struct.pack(bo + "HHI", k, t, len(vals))
                       + v + bytes(4 - len(v)))
    head = (b"II*\x00" if bo == "<" else b"MM\x00*") + struct.pack(
        bo + "IH", 8, len(order))
    return head + b"".join(ifd) + bytes(4) + extras + b"".join(chunks)


def _rle_bmp(idx, rle4, palette, delta=False):
    """An RLE8 (or RLE4) BMP of (H, W) indices, bottom-up: each row as
    encoded runs where 3 or more equal pixels follow each other and
    absolute runs (3 or more pixels, word-aligned) elsewhere, an end of
    line after every row and an end of bitmap.  With ``delta`` one row
    is skipped with a delta escape instead."""
    h, w = idx.shape
    body = bytearray()
    rows = list(idx[::-1])
    for r, row in enumerate(rows):
        if delta and r == 2:
            body += bytes([0, 2, 0, 1])
            continue
        x = 0
        while x < w:
            j = x
            while j < w and j - x < 254 and row[j] == row[x]:
                j += 1
            if j - x >= 3 or w - x < 3:
                n = max(j - x, 1)
                v = int(row[x])
                body += bytes([n, (v << 4 | v) if rle4 else v])
                x += n
                continue
            j = x
            while j < w and j - x < 254 and not (
                    j + 2 < w and row[j] == row[j + 1] == row[j + 2]):
                j += 1
            n = j - x
            if n < 3:
                body += bytes([n, (int(row[x]) << 4 | int(row[x]))
                               if rle4 else int(row[x])])
                x += n
                continue
            vals = [int(v) for v in row[x:j]]
            if rle4:
                vals += [0] * (n % 2)
                packed = bytes(vals[i] << 4 | vals[i + 1]
                               for i in range(0, len(vals), 2))
                body += bytes([0, n]) + packed + bytes(len(packed) % 2)
            else:
                body += bytes([0, n]) + bytes(vals) + bytes(n % 2)
            x = j
        body += b"\x00\x00"
    body += b"\x00\x01"
    pal = np.c_[palette, np.zeros(len(palette))].astype(np.uint8).tobytes()
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 4 if rle4 else 8,
                       2 if rle4 else 1, len(body), 2835, 2835,
                       len(palette), 0)
    offset = 14 + 40 + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset)
            + info + pal + bytes(body))


def _bmp16(v, masks=None, header=40):
    """A 16-bit BMP of (H, W) uint16 pixel values, uncompressed (5-5-5)
    or with bitfield ``masks``."""
    h, w = v.shape
    stride = (w * 2 + 3) & ~3
    body = np.zeros((h, stride), np.uint8)
    body[:, :2 * w] = v.astype("<u2").view(np.uint8).reshape(h, -1)
    info = struct.pack("<IiiHHIIiiII", header, w, h, 1, 16,
                       3 if masks else 0, body.size, 2835, 2835, 0, 0)
    if masks and header >= 52:
        info += struct.pack("<4I", *masks, 0)[:header - 40]
    tail = struct.pack("<3I", *masks) if masks and header == 40 else b""
    offset = 14 + len(info) + len(tail)
    return (b"BM" + struct.pack("<IHHI", offset + body.size, 0, 0, offset)
            + info + tail + body[::-1].tobytes())


def _gif_local_palette(data: bytes) -> bytes:
    """PIL's GIF of one frame with no extension block (its image
    descriptor right after the global colour table), the table moved
    into the descriptor as a local one."""
    flags = data[10]
    n = 3 << ((flags & 7) + 1)
    pal, rest = data[13:13 + n], data[13 + n:]
    assert rest[:1] == b","
    desc = bytearray(rest[:10])
    desc[9] |= 0x80 | (flags & 7)
    return (data[:10] + bytes([flags & 0x70]) + data[11:13] + bytes(desc)
            + pal + rest[10:])


def _pil(array, convert=None, **kw):
    def write(p):
        im = Image.fromarray(array)
        (convert(im) if convert else im).save(p, **kw)
    return write


def _raw(data):
    return lambda p: open(p, "wb").write(data)


# ---------------------------------------------------------------------------
# readers

TIFF_MODES = {"L": GRAY, "RGB": RGB, "RGBA": RGBA, "1": GRAY > 100,
              "I16": WIDE, "I": GRAY.astype(np.int32) * 1000 - 70000,
              "F": GRAY.astype(np.float32) / 3 - 7, "LA":
              np.stack([GRAY, 255 - GRAY], -1)}


@pytest.mark.parametrize("compression", [None, "tiff_lzw", "packbits",
                                         "tiff_deflate",
                                         "tiff_adobe_deflate"])
@pytest.mark.parametrize("mode", sorted(TIFF_MODES) + ["P", "P4"])
def test_tiff_written_by_pil(tmp_path, mode, compression):
    kw = {} if compression is None else dict(compression=compression)
    p = tmp_path / "x.tif"
    if mode in ("P", "P4"):
        im = Image.fromarray(RGB).quantize(200 if mode == "P" else 16)
        im.save(p, **(dict(kw, bits=4) if mode == "P4" else kw))
    else:
        Image.fromarray(TIFF_MODES[mode]).save(p, **kw)
    _hold(p)


BIG_GRAY, BIG_RGB = _zoom(1), np.stack([_zoom(1), _zoom(2),
                                        255 - _zoom(1)], -1)

TIFF_CASES = {
    # PIL's, with a predictor, several strips, at full size, big-endian
    "lzw_predictor_L": _pil(GRAY, compression="tiff_lzw",
                            tiffinfo={317: 2}),
    "lzw_predictor_RGB": _pil(RGB, compression="tiff_lzw",
                              tiffinfo={317: 2}),
    "lzw_predictor_I16": _pil(WIDE, compression="tiff_lzw",
                              tiffinfo={317: 2}),
    "deflate_predictor_RGBA": _pil(RGBA, compression="tiff_deflate",
                                   tiffinfo={317: 2}),
    "lzw_1000x598_L": _pil(BIG_GRAY, compression="tiff_lzw"),
    "lzw_1000x598_RGB_strips": _pil(BIG_RGB, compression="tiff_lzw",
                                    strip_size=65536),
    "packbits_1000x598_predictor": _pil(BIG_GRAY, compression="packbits",
                                        tiffinfo={317: 2}),
    "MM_I16B": _pil(WIDE.astype(">u2")),
    # by hand
    "tiles_L": _raw(_tiff(GRAY, tile=(16, 32))),
    "tiles_deflate_RGB_MM": _raw(_tiff(RGB, ">", 2, compression=8,
                                       tile=(16, 16))),
    "tiles_predictor_RGB": _raw(_tiff(RGB, photometric=2, compression=8,
                                      predictor=2, tile=(32, 16))),
    "planar2_RGB": _raw(_tiff(RGB, photometric=2, planar=2,
                              rows_per_strip=8)),
    "planar2_deflate_RGBA_MM": _raw(_tiff(RGBA, ">", 2, extra=(2,),
                                          compression=8, planar=2,
                                          rows_per_strip=16)),
    "planar2_tiles_RGB": _raw(_tiff(RGB, photometric=2, planar=2,
                                    tile=(16, 32), compression=32773)),
    "deflate_32946_RGB": _raw(_tiff(RGB, photometric=2, compression=32946,
                                    rows_per_strip=5)),
    "packbits_L_strips": _raw(_tiff(GRAY, compression=32773,
                                    rows_per_strip=4)),
    "MM_L": _raw(_tiff(GRAY, ">")),
    "MM_F": _raw(_tiff(GRAY.astype(np.float32) / 7, ">",
                       sample_format=3)),
    "MM_I32": _raw(_tiff(GRAY.astype(np.int32) * -999, ">",
                         sample_format=2)),
    "MM_I16_predictor": _raw(_tiff(WIDE, ">", compression=8, predictor=2)),
    "int16_signed": _raw(_tiff(GRAY.astype(np.int16) * 100 - 12000,
                               sample_format=2)),
    "white_is_zero_L": _raw(_tiff(GRAY, photometric=0)),
    "RGBX": _raw(_tiff(RGBA, photometric=2, extra=(0,))),
    "RGBA_no_extra_samples": _raw(_tiff(RGBA, photometric=2)),
}


@pytest.mark.parametrize("case", sorted(TIFF_CASES))
def test_tiff_cases(tmp_path, case):
    p = tmp_path / "x.tif"
    TIFF_CASES[case](p)
    _hold(p)


def _local_palette_gif(p):
    f = io.BytesIO()
    Image.fromarray(RGB).quantize(64).save(f, "GIF")
    p.write_bytes(_gif_local_palette(f.getvalue()))


GIF_CASES = {
    "L_interlaced": _pil(GRAY),
    "L": _pil(GRAY, interlace=False),
    "P": _pil(RGB, lambda im: im.quantize(200)),
    "P_16_colours": _pil(RGB, lambda im: im.quantize(16)),
    "RGB": _pil(RGB),
    "transparency": _pil(RGB, lambda im: im.quantize(100), transparency=7),
    "tiny": _pil(GRAY[:3, :5]),
    "1000x598_L": _pil(BIG_GRAY),
    "1000x598_P": _pil(BIG_RGB, lambda im: im.quantize(256),
                       interlace=False),
    "local_palette": _local_palette_gif,
}


@pytest.mark.parametrize("case", sorted(GIF_CASES))
def test_gif_cases(tmp_path, case):
    p = tmp_path / "x.gif"
    GIF_CASES[case](p)
    _hold(p)


PAL16 = RNG.integers(0, 256, (16, 3)).astype(np.uint8)
PAL256 = RNG.integers(0, 256, (256, 3)).astype(np.uint8)
GRAY_RAMP = np.repeat(np.arange(256), 3).reshape(256, 3)

BMP_CASES = {
    "rle8": _rle_bmp(GRAY, False, PAL256),
    "rle8_gray": _rle_bmp(GRAY, False, GRAY_RAMP),
    "rle8_delta": _rle_bmp(GRAY, False, PAL256, delta=True),
    "rle4": _rle_bmp(GRAY // 16, True, PAL16),
    "rle4_odd_width": _rle_bmp(GRAY[:, :51] // 16, True, PAL16),
    "bgr555": _bmp16(WIDE & 0x7FFF),
    "bitfields_565": _bmp16(WIDE, (0xF800, 0x7E0, 0x1F)),
    "bitfields_555": _bmp16(WIDE & 0x7FFF, (0x7C00, 0x3E0, 0x1F)),
    "bitfields_565_v4_header": _bmp16(WIDE, (0xF800, 0x7E0, 0x1F), 108),
}


@pytest.mark.parametrize("case", sorted(BMP_CASES))
def test_bmp_cases(tmp_path, case):
    p = tmp_path / "x.bmp"
    p.write_bytes(BMP_CASES[case])
    _hold(p)


@pytest.mark.parametrize("case", ["pil", "big_endian", "1000x598",
                                  "comment"])
def test_pfm_cases(tmp_path, case):
    p = tmp_path / "x.pfm"
    f = (GRAY.astype(np.float32) - 100) / 3
    if case == "pil":
        Image.fromarray(f).save(p)
    elif case == "1000x598":
        Image.fromarray(BIG_GRAY.astype(np.float32) * 1.5).save(p)
    else:
        scale = b"2.5" if case == "big_endian" else b"-1.0"
        head = b"Pf\n%d %d\n" % (f.shape[1], f.shape[0])
        if case == "comment":
            head = b"Pf # floats\n%d %d\n" % (f.shape[1], f.shape[0])
        p.write_bytes(head + scale + b"\n" + f[::-1].astype(
            ">f4" if case == "big_endian" else "<f4").tobytes())
    _hold(p)


@pytest.mark.parametrize("size", [(37, 53), (211, 301)])
@pytest.mark.parametrize("quality", [75, 95])
def test_cmyk_jpeg(tmp_path, size, quality):
    """4 components with Adobe transform 0, PIL's mode CMYK, and the
    4-channel mean that ``to_gray_np`` takes of it, as the JAX command
    takes it."""
    from mods_tpu.ops.image import to_gray_np as jax_gray
    from mods_tpu_torch.ops.image import to_gray_np
    p = tmp_path / "x.jpg"
    Image.fromarray(_photo(*size)[1]).convert("CMYK").save(p,
                                                           quality=quality)
    _hold(p)
    np.testing.assert_array_equal(to_gray_np(read_image(p)),
                                  jax_gray(np.asarray(Image.open(p))))


@pytest.mark.parametrize("bits", [16, 32])
def test_planar2_wide_samples_refused(tmp_path, bits):
    """A planar-configuration-2 TIFF of 16- or 32-bit samples: PIL
    refuses the 16-bit one and misreads the 32-bit one (TiffImagePlugin
    reads each plane with one character of the raw mode: "I", "F"), so
    the port refuses both by name."""
    a = (WIDE if bits == 16 else GRAY.astype(np.float32) / 7)
    p = tmp_path / "x.tif"
    p.write_bytes(_tiff(a, ">", sample_format=1 if bits == 16 else 3,
                        planar=2, rows_per_strip=8))
    if bits == 16:
        with pytest.raises(ValueError, match="unknown raw mode"):
            np.asarray(Image.open(p))
    else:
        assert not np.array_equal(np.asarray(Image.open(p)), a)
    with pytest.raises(ValueError, match=f"planar configuration 2 with "
                       f"{bits}-bit"):
        read_image(p)


def test_refusals_name_the_case(tmp_path):
    """AVIF: PIL reads it; HDF5 and an arithmetic-coded lossless JPEG
    (SOF11): PIL opens each; SGILog TIFFs
    (libtiff's LogLuvSetupDecode refuses what PIL hands it), ThunderScan
    and tiff_raw_16 TIFFs of 8-bit samples (libtiff refuses those) and
    WebP in TIFF (this libtiff lacks it): the port raises a ValueError
    that names each.  A Zstandard TIFF of PIL's, an old-style JPEG TIFF,
    a YCCK JPEG (refused here before) and a GIMP brush are read as PIL
    reads them."""
    p = tmp_path / "z.tif"
    Image.fromarray(GRAY).save(p, compression="zstd")
    got, mode = read_image(p), Image.open(p).mode
    np.testing.assert_array_equal(got, np.asarray(Image.open(p)))
    assert mode == "L"
    from test_torch_ojpeg import ojpeg_tiff
    p = tmp_path / "o.tif"
    p.write_bytes(ojpeg_tiff(GRAY, (1, 1), photometric=1))
    np.testing.assert_array_equal(read_image(p), np.asarray(Image.open(p)))
    p = tmp_path / "x.gbr"           # a GIMP brush, version 1, gray
    h, w = GRAY.shape
    p.write_bytes(struct.pack(">5I", 25, 1, w, h, 1) + b"name\0"
                  + GRAY.tobytes())
    np.testing.assert_array_equal(np.asarray(Image.open(p)), GRAY)
    np.testing.assert_array_equal(read_image(p), GRAY)
    p = tmp_path / "x.h5"            # HDF5: PIL's stub opens the signature
    p.write_bytes(b"\x89HDF\r\n\x1a\n" + bytes(64))
    assert Image.open(p).format == "HDF5"
    with pytest.raises(ValueError, match="HDF5"):
        read_image(p)
    cases = [("x.avif", {}, RGB, "AVIF")]
    for name, kw, a, match in cases:
        p = tmp_path / name
        Image.fromarray(a).save(p, **kw)
        np.asarray(Image.open(p))
        with pytest.raises(ValueError, match=match):
            read_image(p)
    for comp, match in ((32809, "ThunderScan"),
                        (34676, "SGILog.*PIL refuses it"),
                        (32771, "tiff_raw_16"), (50001, "WebP")):
        p = tmp_path / "c.tif"
        p.write_bytes(_tiff(GRAY, compression=8).replace(
            struct.pack("<HHII", 259, 3, 1, 8),
            struct.pack("<HHIH", 259, 3, 1, comp) + bytes(2)))
        with pytest.raises(ValueError, match=match):
            read_image(p)
    f = io.BytesIO()
    Image.fromarray(RGB).convert("CMYK").save(f, "JPEG")
    data = bytearray(f.getvalue())
    at = data.index(b"Adobe")
    data[at + 11] = 2                     # Adobe transform 2: YCCK
    p = tmp_path / "ycck.jpg"
    p.write_bytes(bytes(data))
    assert Image.open(p).mode == "CMYK"
    np.testing.assert_array_equal(read_image(p), np.asarray(Image.open(p)))
    # an arithmetic-coded lossless frame (SOF11): PIL opens it, and
    # libjpeg-turbo has no such decoder
    f = io.BytesIO()
    Image.fromarray(GRAY).save(f, "JPEG")
    data = bytearray(f.getvalue())
    data[data.index(b"\xff\xc0") + 1] = 0xCB
    p = tmp_path / "sof11.jpg"
    p.write_bytes(bytes(data))
    assert Image.open(p).mode == "L"
    with pytest.raises(OSError):
        np.asarray(Image.open(p))
    with pytest.raises(ValueError, match="arithmetic-coded lossless"):
        read_image(p)


# ---------------------------------------------------------------------------
# writers

JPEG_SIZES = [(1, 1), (7, 9), (37, 53), (598, 1000), (1000, 598)]


@pytest.mark.parametrize("size", JPEG_SIZES)
@pytest.mark.parametrize("kind", ["L", "RGB", "noise_L", "noise_RGB"])
def test_jpeg_writes_pils_bytes(tmp_path, kind, size):
    h, w = size
    if kind.startswith("noise"):
        rng = np.random.default_rng(h * w)
        a = rng.integers(0, 256, (h, w, 3) if kind.endswith("RGB")
                         else (h, w)).astype(np.uint8)
    else:
        big = np.tile(BIG_RGB, (2, 2, 1))[:h, :w]
        a = big if kind == "RGB" else big[..., 0]
    a = np.ascontiguousarray(a)
    for ext in ("jpg", "jpeg"):
        ours, pils = tmp_path / f"o.{ext}", tmp_path / f"p.{ext}"
        save_image(ours, a)
        Image.fromarray(a).save(pils)
        assert ours.read_bytes() == pils.read_bytes()
    _hold(ours)


def test_jpeg_drawing_loss(tmp_path, capsys):
    """What 4:2:0 quality 75 loses on a drawing of 40 matches on zoom2x's
    pair: within ``chip_smoke.JPEG_DRAWING_BOUND``, the bound phase 14g
    holds the card's drawings to."""
    H = np.loadtxt(chip_smoke.PAIRS / "zoom2x_H.txt")
    rng = np.random.default_rng(0)
    xy1 = np.stack([rng.uniform(0, 598, 40), rng.uniform(0, 1000, 40)], -1)
    p = np.c_[xy1, np.ones(40)] @ H.T
    xy2 = p[:, :2] / p[:, 2:]
    for canvas in (viz.draw_matches(_zoom(1), _zoom(2), xy1, xy2),
                   viz.draw_matches_with_error(_zoom(1), _zoom(2), xy1, xy2,
                                               H)):
        save_image(tmp_path / "d.jpg", canvas)
        d = np.abs(read_image(tmp_path / "d.jpg").astype(np.float64)
                   - canvas)
        mean, psnr = d.mean(), 10 * np.log10(255.0 ** 2 / (d ** 2).mean())
        with capsys.disabled():
            print(f"\ndrawing loss: mean {mean:.3f}, PSNR {psnr:.2f} dB")
        assert mean <= chip_smoke.JPEG_DRAWING_BOUND["mean_abs"]
        assert psnr >= chip_smoke.JPEG_DRAWING_BOUND["psnr_db"]


def test_jpeg_writes_bool_as_pil(tmp_path):
    ours, pils = tmp_path / "o.jpg", tmp_path / "p.jpg"
    save_image(ours, GRAY > 100)
    Image.fromarray(GRAY > 100).save(pils)
    assert ours.read_bytes() == pils.read_bytes()


TIFF_WRITES = {"L": GRAY, "RGB": RGB, "RGBA": RGBA, "1": GRAY > 100,
               "LA": np.stack([GRAY, 255 - GRAY], -1), "I16": WIDE,
               "I": GRAY.astype(np.int32) * 1000 - 70000,
               "I_from_int16": GRAY.astype(np.int16) - 100,
               "F": GRAY.astype(np.float32) / 3 - 7,
               "F_from_float64": GRAY.astype(np.float64) / 7,
               "1000x598_RGB": BIG_RGB,
               "1000x598_F": BIG_GRAY.astype(np.float32) / 9}


@pytest.mark.parametrize("case", sorted(TIFF_WRITES))
def test_tiff_writes_pils_bytes(tmp_path, case):
    a = TIFF_WRITES[case]
    for ext in ("tif", "tiff"):
        ours, pils = tmp_path / f"o.{ext}", tmp_path / f"p.{ext}"
        save_image(ours, a)
        Image.fromarray(a).save(pils)
        assert ours.read_bytes() == pils.read_bytes()
    _hold(ours)


@pytest.mark.parametrize("ext,array", [
    ("pfm", GRAY.astype(np.float32) / 3 - 7),
    ("pfm", GRAY.astype(np.float64) * 1e5),
    ("pfm", GRAY), ("ppm", GRAY.astype(np.float32)),
    ("pgm", GRAY.astype(np.int32) * 300 - 1000),
    ("pnm", GRAY.astype(np.int16) - 50),
    ("png", GRAY.astype(np.int32) * 400 - 5000),
    ("png", GRAY.astype(np.int8)),
    ("tif", GRAY.astype(np.int32) * -3),
    ("tiff", GRAY.astype(np.float32) / 1e3)], ids=lambda v: str(
        getattr(v, "dtype", v)))
def test_int_and_float_writes_read_back_as_pils(tmp_path, ext, array):
    """PIL opens the file in the mode of its own save of the same array,
    with the same array (Pillow 12 still writes "I" to PNG as 16-bit,
    clipped, with a deprecation warning)."""
    ours, pils = tmp_path / f"o.{ext}", tmp_path / f"p.{ext}"
    save_image(ours, array)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        Image.fromarray(array).save(pils)
    got, want = Image.open(ours), Image.open(pils)
    assert got.mode == want.mode and got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    _hold(ours)


# ---------------------------------------------------------------------------
# the match command on a TIFF pair, its drawings named .jpg

@pytest.fixture(scope="module")
def tiff_pair(tmp_path_factory):
    """test_torch_cli.py's textured pair, saved as TIFF by the port."""
    load_jax_native()
    d = tmp_path_factory.mktemp("tiff_pair")
    img1 = textured_image(128, 176, seed=4)
    img2 = warp_np(img1, SHIFT, 128, 176)
    for name, img in (("a", img1), ("b", img2)):
        save_image(d / f"{name}.tif", np.clip(img, 0, 255).astype(np.uint8))
    (d / "iters.ini").write_text(SMALL_ITERS)
    (d / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
    return d


def test_cli_match_on_tiff_with_jpeg_drawings_against_jax(tiff_pair,
                                                          capsys):
    d = tiff_pair
    figures = {}
    for tag, run in (("jax", jcli.cmd_match),
                     ("torch", lambda a: tcli.main(
                         ["match"] + a + ["--device", "cpu"]))):
        m = d / f"m_{tag}.txt"
        assert run([str(d / "a.tif"), str(d / "b.tif"),
                    str(d / f"o1_{tag}.jpg"), str(d / f"o2_{tag}.jpg"),
                    "k1", "k2", str(m), "0", "LORANSACH",
                    str(d / "config.ini"), str(d / "iters.ini")]) == 0
        figures[tag] = chip_smoke.match_figures(
            capsys.readouterr().out, str(m), SHIFT, 176, 128)
        for o in (1, 2):
            im = Image.open(d / f"o{o}_{tag}.jpg")
            assert im.format == "JPEG" and im.mode == "RGB"
    j, t = figures["jax"], figures["torch"]
    assert t["steps"] == j["steps"]
    assert t["matches"] >= 10 and abs(t["matches"] - j["matches"]) \
        <= 0.2 * j["matches"], (t, j)
    # the port's drawings are PIL's JPEG bytes of viz's canvases
    imgs = [read_image(d / f"{n}.tif") for n in ("a", "b")]
    xy1, xy2 = read_matches(str(d / "m_torch.txt"))
    H = read_h(str(d / "m_torch.txt.H"))
    for o, canvas in ((1, viz.draw_matches(*imgs, xy1, xy2)),
                      (2, viz.draw_matches_with_error(*imgs, xy1, xy2, H))):
        f = io.BytesIO()
        Image.fromarray(canvas).save(f, "JPEG")
        assert (d / f"o{o}_torch.jpg").read_bytes() == f.getvalue()


# ---------------------------------------------------------------------------
# the fixtures and the JAX figures of chip_smoke.py phase 14

def write_fixtures(d) -> None:
    """Phase 14e's fixtures, small crops of the zoom2x and tilt4 views:
    TIFFs by PIL (LZW with predictor 2, PackBits 16-bit) and by
    ``_tiff`` (tiled Deflate, planar-2 big-endian RGB, big-endian
    float), GIFs by PIL
    (interlaced gray with PIL's full gray ramp, which reads as "L"; a
    64-colour palette), a PFM by PIL, BMPs by
    ``_rle_bmp`` (RLE8, RLE4) and ``_bmp16`` (5-6-5), and a CMYK JPEG
    by PIL at quality 90."""
    os.makedirs(d, exist_ok=True)
    g, rgb = _photo(96, 128)
    writers = {
        "lzw_predictor.tif": _pil(rgb, compression="tiff_lzw",
                                  tiffinfo={317: 2}),
        "packbits_16bit.tif": _pil(g[:48, :64].astype(np.uint16) * 257,
                                   compression="packbits"),
        "tiles_deflate.tif": _raw(_tiff(rgb, photometric=2, compression=8,
                                        tile=(32, 48))),
        "planar2_rgb_mm.tif": _raw(_tiff(rgb[:48, :64], ">", 2,
                                         compression=8, planar=2,
                                         rows_per_strip=16)),
        "float_mm.tif": _raw(_tiff(g[:48, :64].astype(np.float32) / 7, ">",
                                   sample_format=3)),
        "gray_interlaced.gif": _pil(g, optimize=False),
        "palette.gif": _pil(rgb, lambda im: im.quantize(64)),
        "float.pfm": _pil(g[:48, :64].astype(np.float32) / 3 - 20),
        "rle8.bmp": _raw(_rle_bmp(g // 8 * 8, False, PAL256)),
        "rle4.bmp": _raw(_rle_bmp(g // 16, True, PAL16)),
        "rgb565.bmp": _raw(_bmp16((g[:48, :64].astype(np.uint16) * 257)
                                  & 0xFFFF, (0xF800, 0x7E0, 0x1F))),
        "cmyk.jpg": _pil(rgb, lambda im: im.convert("CMYK"), quality=90),
    }
    for name, write in writers.items():
        write(os.path.join(d, name))


def test_format_fixture_hashes_are_pils():
    """Phase 14e's constants are PIL's decodes of the committed fixtures,
    and the port decodes each to the same array and mode here."""
    assert chip_smoke.FORMAT_FIXTURE_SHA256
    for name, (shape, mode, sha) in \
            chip_smoke.FORMAT_FIXTURE_SHA256.items():
        p = chip_smoke.IMAGE_FIXTURES / name
        im = Image.open(p)
        want = np.asarray(im)
        assert want.shape == shape and im.mode == mode
        assert hashlib.sha256(want.tobytes()).hexdigest() == sha
        _hold(p)


def _jax_tiff_main() -> None:
    """The JAX command on phase 14g's pair: zoom2x's PNGs written as TIFF
    by the port (PIL's bytes), LORANSACH, the CVIU-shaped INI files
    (``JAX_TIFF_REFERENCE``)."""
    import contextlib
    import json
    import tempfile
    import time
    from pathlib import Path
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        tifs = [td / f"zoom2x_{i}.tif" for i in (1, 2)]
        for i, p in enumerate(tifs, 1):
            save_image(p, _zoom(i))
        (td / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
        (td / "iters.ini").write_text(chip_smoke.cviu_iters_ini())
        m = td / "m.txt"
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jcli.cmd_match([str(tifs[0]), str(tifs[1]), "0", "0",
                                   "k1", "k2", str(m), "0", "LORANSACH",
                                   str(td / "config.ini"),
                                   str(td / "iters.ini")]) == 0
        h, w = _zoom(1).shape
        figures = chip_smoke.match_figures(
            buf.getvalue(), str(m),
            np.loadtxt(chip_smoke.PAIRS / "zoom2x_H.txt"), w, h)
    print(json.dumps(dict(figures, seconds=round(time.time() - t0, 1))),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--fixtures"]:
        write_fixtures(chip_smoke.IMAGE_FIXTURES)
    elif sys.argv[1:] == ["--jax-tiff"]:
        _jax_tiff_main()
