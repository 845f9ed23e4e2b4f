"""Port vs PIL and the JAX reference: image files (CPU).

The JAX commands read images with ``np.asarray(Image.open(path))`` and
write drawings with ``Image.fromarray(canvas).save(path)``;
``mods_tpu_torch/io/image.py`` does both without PIL.

Tolerances.
* ``read_image`` equals ``np.asarray(Image.open(p))`` in dtype, shape
  and values (and ``_read`` gives ``Image.open(p).mode``) for every PNG,
  PNM and BMP case below, written by PIL or by
  hand where PIL writes no such file (4-bit gray, 16-bit colour, Adam7,
  the plain PNM forms, 4-bit and bitfield BMPs); ``image_size`` equals
  ``Image.open(p).size``.
* JPEG: every pixel within 1 grey level of PIL's decode, at qualities
  50, 90 and 100, gray and colour, sampled 4:4:4, 4:2:2, 4:2:0, 4:4:0
  and 4:1:1, progressive, with restart intervals, at odd sizes.  The
  decoder reproduces libjpeg-turbo's integer decode, so all are expected
  exact; each case prints its share of exact pixels.  The cases PIL
  cannot write (4:4:0, 4:1:1, SOF1) come from ``_encode_jpeg``, a small
  baseline encoder of this file; PIL decodes them as the reference.
* ``save_image``: PIL opens the file in the mode of its own save of the
  same array to the same extension, with the same pixels; each refusal
  is a ``ValueError`` that names the format or mode, and writes nothing.
* ``cli match`` on ``test_torch_cli.py``'s textured pair saved as PGM
  and as JPEG, against ``mods_tpu.cli.cmd_match``: that file's rule (the
  same steps, the verified count within 20 %).  ``cli extract`` in the
  michal format on a colour JPEG against ``mods_tpu.cli.cmd_extract``'s
  files: ``test_torch_commands.py``'s rule.

``python tests/test_torch_image_io.py --fixtures`` writes the fixtures of
``chip_smoke.py`` phase 14 (``tests/data/image_io``) with PIL;
``JAX_PLATFORMS=cpu python tests/test_torch_image_io.py --jax-jpeg``
prints the JAX command's figures on the JPEG pair
(``chip_smoke.JAX_JPEG_REFERENCE``).
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
from mods_tpu_torch.io import regions_io as trio  # noqa: E402
from mods_tpu_torch.io.image import (_read, image_size,  # noqa: E402
                                     read_image, save_image)
from test_pipeline import textured_image, warp_np  # noqa: E402
from test_torch_cli import (SHIFT, SMALL_ITERS,  # noqa: E402
                            load_jax_native)
from test_torch_commands import _hold_rows  # noqa: E402

torch.set_num_threads(2)

RNG = np.random.default_rng(0)
GRAY = RNG.integers(0, 256, (37, 53)).astype(np.uint8)
GRAY[5:20, 5:30] = 9                 # flat runs: more PNG filter types
RGB = np.stack([GRAY, GRAY // 2, 255 - GRAY], -1)


def _hold_read(p):
    want = np.asarray(Image.open(p))
    got = read_image(p)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert image_size(p) == Image.open(p).size
    assert _read(p)[1] == Image.open(p).mode


# ---------------------------------------------------------------------------
# files PIL does not write, by hand

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _filter_rows(rows, bpp, rng):
    """Each byte row under a random PNG filter type (0-4)."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for r in rows.astype(np.int32):
        t = int(rng.integers(0, 5))
        left = np.r_[np.zeros(bpp, np.int32), r[:-bpp]]
        upleft = np.r_[np.zeros(bpp, np.int32), prev[:-bpp]]
        if t == 0:
            pred = np.zeros_like(r)
        elif t == 1:
            pred = left
        elif t == 2:
            pred = prev
        elif t == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        out.append(bytes([t]) + ((r - pred) & 0xFF).astype(np.uint8)
                   .tobytes())
        prev = r
    return b"".join(out)


def _png_bytes(samples, depth, color, interlace=False, palette=None):
    """A PNG of (H, W, C) raw sample values."""
    rng = np.random.default_rng(1)
    h, w, c = samples.shape
    bpp = max(1, depth * c // 8)

    def pack(sub):
        ph, pw = sub.shape[:2]
        v = sub.reshape(ph, pw * c)
        if depth == 16:
            return v.astype(">u2").view(np.uint8).reshape(ph, -1)
        if depth == 8:
            return v.astype(np.uint8)
        per = 8 // depth
        v = np.pad(v, ((0, 0), (0, -v.shape[1] % per))).reshape(ph, -1, per)
        shifts = 8 - depth * (np.arange(per) + 1)
        return (v.astype(np.int32) << shifts).sum(-1).astype(np.uint8)

    raw = b""
    for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter_rows(pack(sub), bpp, rng)

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
        out += chunk(b"tRNS", bytes(range(0, 250, 50)))
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


def _bmp_bytes(pixels, bits, palette=None, header=40, top_down=False,
               masks=None):
    """A BMP of row bytes (H, stride-free) ``pixels``: (H, W) indices for
    1/4/8 bits, (H, W) uint16 values for 16, (H, W, B) bytes for 24/32."""
    h, w = pixels.shape[:2]
    if bits <= 8:
        per = 8 // bits
        v = np.pad(pixels, ((0, 0), (0, -w % per))).reshape(h, -1, per)
        rows = (v.astype(np.int32) << (8 - bits * (np.arange(per) + 1))) \
            .sum(-1).astype(np.uint8)
    elif bits == 16:
        rows = pixels.astype("<u2").view(np.uint8).reshape(h, -1)
    else:
        rows = pixels.reshape(h, -1).astype(np.uint8)
    stride = ((w * bits + 31) >> 3) & ~3
    body = np.zeros((h, stride), np.uint8)
    body[:, :rows.shape[1]] = rows
    body = body if top_down else body[::-1]
    pal = b"" if palette is None else palette.astype(np.uint8).tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, 3 if masks else 0, body.size, 2835,
                           2835, 0, 0)
        if masks:
            info += struct.pack("<4I", *masks)
        info += bytes(header - len(info))
    offset = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + body.size, 0, 0, offset)
            + info + pal + body.tobytes())


def _pil(save_kw=None, convert=None, array=GRAY, ext="png"):
    def write(p):
        im = Image.fromarray(array)
        if convert:
            im = convert(im)
        im.save(p, **(save_kw or {}))
    return write, ext


def _raw(data, ext):
    return (lambda p: open(p, "wb").write(data)), ext


PAL = np.concatenate([RNG.integers(0, 256, (16, 3))]).astype(np.uint8)
IDX4 = (GRAY // 16).astype(np.uint8)
WIDE = GRAY.astype(np.uint16) * 251 + 7

READ_CASES = {
    # PNG written by PIL
    "png_L": _pil({"optimize": True}),
    "png_LA": _pil({"optimize": True}, array=np.stack([GRAY, 255 - GRAY],
                                                        -1)),
    "png_RGB": _pil({"optimize": True}, array=RGB),
    "png_RGBA": _pil(array=np.concatenate([RGB, GRAY[..., None]], -1)),
    "png_I16": _pil(array=WIDE),
    "png_1bit": _pil(array=GRAY > 100),
    "png_palette_tRNS": _pil({"transparency": 3},
                             lambda im: im.convert("RGB").quantize(200),
                             array=RGB),
    "png_palette_4bit": _pil({"bits": 4}, lambda im: im.quantize(16),
                             array=RGB),
    "png_palette_2bit": _pil({"bits": 2}, lambda im: im.quantize(4)),
    "png_palette_1bit": _pil(None, lambda im: im.quantize(2)),
    # PNG by hand
    "png_gray_2bit": _raw(_png_bytes((GRAY // 64)[..., None], 2, 0), "png"),
    "png_gray_4bit": _raw(_png_bytes((GRAY // 16)[..., None], 4, 0), "png"),
    "png_RGB_16": _raw(_png_bytes(np.stack([WIDE, WIDE // 3, 65535 - WIDE],
                                           -1), 16, 2), "png"),
    "png_RGBA_16": _raw(_png_bytes(np.stack([WIDE, WIDE // 3, WIDE // 2,
                                             65535 - WIDE], -1), 16, 6),
                        "png"),
    "png_LA_16": _raw(_png_bytes(np.stack([WIDE, 65535 - WIDE], -1), 16, 4),
                      "png"),
    "png_palette_4bit_filters": _raw(_png_bytes(IDX4[..., None], 4, 3,
                                                palette=PAL), "png"),
    "adam7_L": _raw(_png_bytes(GRAY[..., None], 8, 0, True), "png"),
    "adam7_RGB": _raw(_png_bytes(RGB, 8, 2, True), "png"),
    "adam7_1bit": _raw(_png_bytes((GRAY > 90)[..., None], 1, 0, True),
                       "png"),
    "adam7_palette_4bit": _raw(_png_bytes(IDX4[..., None], 4, 3, True, PAL),
                               "png"),
    "adam7_gray_16": _raw(_png_bytes(WIDE[..., None], 16, 0, True), "png"),
    "adam7_RGBA_16": _raw(_png_bytes(np.stack(
        [WIDE, WIDE // 3, WIDE // 2, 65535 - WIDE], -1), 16, 6, True), "png"),
    "adam7_tiny": _raw(_png_bytes(GRAY[:3, :2, None], 8, 0, True), "png"),
    # PNM
    "pgm_P5": _pil(ext="pgm"),
    "ppm_P6": _pil(array=RGB, ext="ppm"),
    "pbm_P4": _pil(array=GRAY > 100, ext="pbm"),
    "pgm_P5_16bit": _pil(array=WIDE, ext="pgm"),
    "pgm_maxval_15": _raw(b"P5\n4 2\n15\n" + bytes([0, 7, 15, 3, 1, 2, 14,
                                                    9]), "pgm"),
    "pgm_maxval_1000": _raw(b"P5 # a comment\n2 2\n1000\n"
                            + np.array([0, 500, 999, 1000], ">u2")
                            .tobytes(), "pgm"),
    "ppm_maxval_65535": _raw(b"P6\n2 1\n65535\n" + np.array(
        [1, 2, 3, 65535, 32768, 40000], ">u2").tobytes(), "ppm"),
    "ppm_maxval_100": _raw(b"P6\n2 1\n100\n" + bytes([1, 50, 99, 100, 0,
                                                      33]), "ppm"),
    "pgm_P2": _raw(b"P2\n# comment\n3 2\n255\n0 1 2\n3 # x\n 4 255\n", "pgm"),
    "pgm_P2_wide": _raw(b"P2\n3 1\n300\n0 150 300\n", "pgm"),
    "ppm_P3": _raw(b"P3\n2 1\n15\n1 2 3 4 5 15\n", "ppm"),
    "pbm_P1": _raw(b"P1\n3 2\n1 0 1\n001\n", "pbm"),
    "pbm_P4_odd": _raw(b"P4\n10 2\n" + bytes([0b10100000, 0b11000000, 0xFF,
                                              0x00]), "pbm"),
    # BMP written by PIL
    "bmp_L": _pil(ext="bmp"),
    "bmp_RGB": _pil(array=RGB, ext="bmp"),
    "bmp_RGBA": _pil(array=np.concatenate([RGB, GRAY[..., None]], -1),
                     ext="bmp"),
    "bmp_1bit": _pil(array=GRAY > 100, ext="bmp"),
    "bmp_palette": _pil(None, lambda im: im.quantize(200), array=RGB,
                        ext="bmp"),
    # BMP by hand
    "bmp_4bit_palette": _raw(_bmp_bytes(IDX4, 4, np.c_[PAL, np.zeros(16)]),
                             "bmp"),
    "bmp_1bit_colour_palette": _raw(_bmp_bytes(
        (GRAY > 100).astype(np.uint8), 1, np.array([[10, 20, 30, 0],
                                                    [200, 100, 50, 0]])),
        "bmp"),
    "bmp_top_down": _raw(_bmp_bytes(RGB, 24, top_down=True), "bmp"),
    "bmp_os2_header": _raw(_bmp_bytes(RGB, 24, header=12), "bmp"),
    "bmp_32_bitfields_alpha": _raw(_bmp_bytes(
        np.concatenate([RGB, GRAY[..., None]], -1), 32, header=56,
        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)), "bmp"),
}


@pytest.mark.parametrize("case", sorted(READ_CASES))
def test_read_image_equals_pil(tmp_path, case):
    write, ext = READ_CASES[case]
    p = tmp_path / f"x.{ext}"
    write(p)
    _hold_read(p)


def test_other_formats_raise_naming_them(tmp_path):
    """TIFF, GIF, PFM, WebP, PSD and FTEX read as PIL reads them (they
    raised before the port read them); so do the RLE-compressed and the
    16-bit BMP.  MPEG, which PIL opens and the port does not, and an
    unknown file raise a ValueError that names the format."""
    for fmt in ("TIFF", "GIF", "PFM", "WebP"):
        p = tmp_path / f"x.{fmt.lower()}"
        Image.fromarray(GRAY.astype(np.float32) if fmt == "PFM"
                        else RGB if fmt == "WebP" else GRAY).save(p)
        _hold_read(p)
    p = tmp_path / "x.psd"
    h, w = GRAY.shape            # PSD: gray, 8 bits, no resources, raw
    p.write_bytes(b"8BPS" + struct.pack(">H6xHIIHH", 1, 1, h, w, 8, 1)
                  + bytes(14) + GRAY.tobytes())
    np.testing.assert_array_equal(np.asarray(Image.open(p)), GRAY)
    _hold_read(p)
    p = tmp_path / "x.ftex"       # FTEX: one uncompressed RGB mipmap
    rgb = np.stack([GRAY] * 3, -1)
    h, w = GRAY.shape
    p.write_bytes(b"FTEX" + struct.pack("<7i", 0, w, h, 1, 1, 1, 32)
                  + struct.pack("<i", rgb.size) + rgb.tobytes())
    np.testing.assert_array_equal(np.asarray(Image.open(p)), rgb)
    _hold_read(p)
    p = tmp_path / "x.mpg"        # MPEG: a sequence header, 352x240
    p.write_bytes(b"\x00\x00\x01\xb3" + bytes([0x16, 0x00, 0xF0, 0x14])
                  + bytes(8))
    assert Image.open(p).size == (352, 240)
    with pytest.raises(ValueError, match="MPEG"):
        read_image(p)
    with pytest.raises(ValueError, match="MPEG"):
        image_size(p)
    p = tmp_path / "x.bin"
    p.write_bytes(b"\x00\x01\x02\x03" * 8)
    with pytest.raises(ValueError, match="not an image format"):
        read_image(p)
    # an uncompressed 8-bit BMP marked RLE8: PIL's RLE decoder reads its
    # rows as runs, and so does the port's
    data = bytearray(_bmp_bytes(GRAY, 8, np.c_[np.repeat(np.arange(256),
                                                         3).reshape(-1, 3),
                                                np.zeros(256)]))
    data[30:34] = struct.pack("<I", 1)
    p = tmp_path / "x.bmp"
    p.write_bytes(bytes(data))
    _hold_read(p)
    p.write_bytes(_bmp_bytes(WIDE & 0x7FFF, 16))
    _hold_read(p)


# ---------------------------------------------------------------------------
# JPEG

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
# every AC symbol a baseline scan can hold, each coded in 8 bits
_AC_SYMBOLS = [0x00, 0xF0] + [r << 4 | s for r in range(16)
                              for s in range(1, 11)]


def _encode_jpeg(img, sampling, restart=0, sof=0xC0, q=(6, 9)):
    """A baseline JPEG of (H, W) gray or (H, W, 3) RGB pixels with the
    components' sampling factors ``sampling`` (luma first): box-filtered
    chroma, flat quantization tables ``q`` (luma, chroma), fixed-length
    Huffman codes (DC 4 bits, AC 8 bits), a restart marker every
    ``restart`` MCUs."""
    img = np.asarray(img, np.float64)
    if img.ndim == 2:
        planes = [img]
    else:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    H, W = img.shape[:2]
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    k = np.arange(8)
    C = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16) / 2
    C[0] /= np.sqrt(2)
    blocks = []
    for i, (p, (h, v)) in enumerate(zip(planes, sampling)):
        fy, fx = vmax // v, hmax // h
        ph, pw = -(-H // fy), -(-W // fx)
        p = np.pad(p, ((0, ph * fy - H), (0, pw * fx - W)), mode="edge")
        p = p.reshape(ph, fy, pw, fx).mean((1, 3))
        p = np.pad(p, ((0, mcuy * v * 8 - ph), (0, mcux * h * 8 - pw)),
                   mode="edge")
        b = p.reshape(mcuy * v, 8, mcux * h, 8).transpose(0, 2, 1, 3) - 128
        coef = np.rint((C @ b @ C.T) / q[min(i, 1)]).astype(int)
        blocks.append(coef.reshape(mcuy * v, mcux * h, 64)[..., _ZIGZAG])
    out = bytearray()
    acc = [0, 0]

    def put(code, n):
        acc[0], acc[1] = (acc[0] << n) | code, acc[1] + n
        while acc[1] >= 8:
            byte = (acc[0] >> (acc[1] - 8)) & 0xFF
            acc[1] -= 8
            out.extend([byte, 0] if byte == 0xFF else [byte])
        acc[0] &= (1 << acc[1]) - 1

    def put_value(v):
        s = int(abs(v)).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    code = {sym: i for i, sym in enumerate(_AC_SYMBOLS)}
    preds, n_mcu = [0] * len(planes), 0
    for my in range(mcuy):
        for mx in range(mcux):
            if restart and n_mcu and n_mcu % restart == 0:
                if acc[1]:
                    put((1 << (8 - acc[1])) - 1, 8 - acc[1])
                out.extend([0xFF, 0xD0 + (n_mcu // restart - 1) % 8])
                preds = [0] * len(planes)
            n_mcu += 1
            for ci, (h, v) in enumerate(sampling):
                for by in range(v):
                    for bx in range(h):
                        z = blocks[ci][my * v + by, mx * h + bx]
                        s, val = put_value(int(z[0]) - preds[ci])
                        preds[ci] = int(z[0])
                        put(s, 4)
                        put(val, s)
                        nz = np.flatnonzero(z[1:]) + 1
                        run = 0
                        for kk in range(1, (nz[-1] if len(nz) else 0) + 1):
                            if z[kk] == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(code[0xF0], 8)
                                run -= 16
                            s, val = put_value(int(z[kk]))
                            put(code[run << 4 | s], 8)
                            put(val, s)
                            run = 0
                        if not len(nz) or nz[-1] < 63:
                            put(code[0x00], 8)
    if acc[1]:
        put((1 << (8 - acc[1])) - 1, 8 - acc[1])

    def seg(m, body):
        return bytes([0xFF, m]) + struct.pack(">H", len(body) + 2) + body
    ntab = 1 if len(planes) == 1 else 2
    data = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                                   b"\x00\x00")
    for t in range(ntab):
        data += seg(0xDB, bytes([t]) + bytes([q[t]] * 64))
    data += seg(sof, bytes([8]) + struct.pack(">HH", H, W)
                + bytes([len(planes)]) + b"".join(
                    bytes([i + 1, h << 4 | v, min(i, 1)])
                    for i, (h, v) in enumerate(sampling)))
    for t in range(ntab):
        data += seg(0xC4, bytes([t, 0, 0, 0, 12] + [0] * 12)
                    + bytes(range(12)))
        data += seg(0xC4, bytes([0x10 | t] + [0] * 7 + [162] + [0] * 8)
                    + bytes(_AC_SYMBOLS))
    if restart:
        data += seg(0xDD, struct.pack(">H", restart))
    data += seg(0xDA, bytes([len(planes)]) + b"".join(
        bytes([i + 1, min(i, 1) * 0x11]) for i in range(len(planes)))
        + bytes([0, 63, 0]))
    return data + bytes(out) + b"\xff\xd9"


def _jpeg_source(h, w):
    """Photographic content at (h, w): crops of the zoom2x and tilt4
    views, colour made of both."""
    a = read_image(os.path.join(REPO, ".parity_work", "zoom2x_1.png"))
    b = read_image(os.path.join(REPO, ".parity_work", "tilt4_1.png"))
    a = a[100:100 + h, 200:200 + w].astype(np.float32)
    b = b[300:300 + h, 100:100 + w].astype(np.float32)
    return a.astype(np.uint8), np.clip(np.stack(
        [a, 0.6 * b + 0.4 * a, 255 - 0.8 * b], -1), 0, 255).astype(np.uint8)


JPEG_CASES = {
    "gray": dict(gray=True),
    "gray_progressive": dict(gray=True, progressive=True),
    "gray_restart": dict(gray=True, restart_marker_blocks=5),
    "444": dict(subsampling=0),
    "422": dict(subsampling=1),
    "420": dict(subsampling=2),
    "420_progressive": dict(subsampling=2, progressive=True),
    "422_progressive_restart_rows": dict(subsampling=1, progressive=True,
                                         restart_marker_rows=1),
    "420_restart": dict(subsampling=2, restart_marker_blocks=7),
    "444_keep_rgb": dict(subsampling=0, keep_rgb=True),
    "440_by_hand": dict(sampling=((1, 2), (1, 1), (1, 1))),
    "440_by_hand_restart": dict(sampling=((1, 2), (1, 1), (1, 1)),
                                restart=3),
    "411_by_hand": dict(sampling=((4, 1), (1, 1), (1, 1))),
    "420_sof1_by_hand": dict(sampling=((2, 2), (1, 1), (1, 1)), sof=0xC1),
    "gray_by_hand_restart": dict(sampling=((1, 1),), restart=2),
}


@pytest.mark.parametrize("case", sorted(JPEG_CASES))
@pytest.mark.parametrize("size", [(211, 301), (97, 131)])
def test_jpeg_against_pil(tmp_path, case, size, capsys):
    kw = dict(JPEG_CASES[case])
    gray, rgb = _jpeg_source(*size)
    img = gray if kw.pop("gray", False) or kw.get("sampling") == ((1, 1),) \
        else rgb
    p = tmp_path / "x.jpg"
    shares = []
    for quality in (50, 90, 100):
        if "sampling" in kw:
            p.write_bytes(_encode_jpeg(img, q=(max(1, 100 - quality),
                                               max(1, 110 - quality)),
                                       **kw))
        else:
            Image.fromarray(img).save(p, quality=quality, **kw)
        want = np.asarray(Image.open(p))
        got = read_image(p)
        assert got.dtype == want.dtype and got.shape == want.shape
        d = np.abs(got.astype(np.int32) - want.astype(np.int32))
        assert d.max() <= 1, (quality, int(d.max()))
        assert image_size(p) == Image.open(p).size
        shares.append(float((d == 0).mean()))
    with capsys.disabled():
        print(f"\n{case} {size}: exact pixel shares at quality 50/90/100: "
              f"{shares}")


def test_fixture_hashes_are_pils():
    """Phase 14a's constants are PIL's decodes of the committed fixtures,
    and the port decodes each to the same bytes here."""
    for name, (shape, sha) in chip_smoke.JPEG_FIXTURE_SHA256.items():
        p = chip_smoke.IMAGE_FIXTURES / name
        want = np.asarray(Image.open(p))
        assert want.shape == shape
        assert hashlib.sha256(want.tobytes()).hexdigest() == sha
        np.testing.assert_array_equal(read_image(p), want)


@pytest.mark.parametrize("case,match", [
    ("arithmetic", "arithmetic"), ("progressive_arithmetic", "arithmetic"),
    ("lossless", "lossless"), ("hierarchical", "hierarchical"),
    ("12bit", "12-bit"), ("ycck", "YCCK")])
def test_jpeg_refusals_name_the_case(tmp_path, case, match):
    """A Huffman file relabelled arithmetic-coded (SOF9, SOF10) or lossless
    (SOF3), and a YCCK file, read as PIL reads them: the same array bit
    for bit, or, where PIL refuses the file, a ValueError naming PIL's
    reason (the progressive relabel's Se and the lossless relabel's Ss 0
    are no valid scan).  The hierarchical and the 12-bit file are refused
    by name, as PIL refuses them (libjpeg-turbo's 8-bit API); PIL reads
    the size from the header, and so does ``image_size`` (PIL opens no
    12-bit file at all).  (Arithmetic coding, lossless files and YCCK
    were refused here before: ``tests/test_torch_jpeg_codings.py``.)"""
    f = io.BytesIO()
    if case == "ycck":
        Image.fromarray(RGB).convert("CMYK").save(f, "JPEG")
        data = bytearray(f.getvalue())
        data[data.index(b"Adobe") + 11] = 2      # Adobe transform 2: YCCK
    else:
        Image.fromarray(GRAY).save(f, "JPEG")
        data = bytearray(f.getvalue())
        at = data.index(b"\xff\xc0")
        if case == "12bit":
            data[at + 4] = 12
        else:
            data[at + 1] = {"arithmetic": 0xC9, "progressive_arithmetic":
                            0xCA, "lossless": 0xC3,
                            "hierarchical": 0xC5}[case]
    p = tmp_path / "x.jpg"
    p.write_bytes(bytes(data))
    if case != "12bit":
        assert image_size(p) == Image.open(p).size
    if case in ("hierarchical", "12bit"):
        with pytest.raises(ValueError, match=match):
            read_image(p)
        with pytest.raises(OSError):
            np.asarray(Image.open(p))
        return
    try:
        want = np.asarray(Image.open(p))
    except OSError:
        with pytest.raises(ValueError, match=f"{match}.*PIL refuses it"):
            read_image(p)
        return
    got = read_image(p)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# writers

WRITE_CASES = {
    "png": [GRAY, np.stack([GRAY, 255 - GRAY], -1), RGB,
            np.concatenate([RGB, GRAY[..., None]], -1), GRAY > 100, WIDE],
    "pgm": [GRAY, WIDE],
    "ppm": [RGB, np.concatenate([RGB, GRAY[..., None]], -1)],
    "pbm": [GRAY > 100],
    "pnm": [GRAY, RGB],
    "bmp": [GRAY, RGB, np.concatenate([RGB, GRAY[..., None]], -1),
            GRAY > 100],
}


@pytest.mark.parametrize("ext", sorted(WRITE_CASES))
def test_save_image_writes_pils_format(tmp_path, ext):
    """Each array written to each extension opens in PIL in the mode of
    PIL's own save, with the same pixels, and reads back through
    ``read_image`` as PIL reads it."""
    for i, a in enumerate(WRITE_CASES[ext]):
        ours, pils = tmp_path / f"o{i}.{ext}", tmp_path / f"p{i}.{ext}"
        save_image(ours, a)
        Image.fromarray(a).save(pils)
        got, want = Image.open(ours), Image.open(pils)
        assert got.mode == want.mode and got.size == want.size
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        _hold_read(ours)


@pytest.mark.parametrize("name,array", [
    ("x.jpg", GRAY), ("x.jpeg", RGB), ("x.tif", GRAY),
    ("x.png", GRAY.astype(np.int32)), ("x.pgm", GRAY.astype(np.int32)),
    ("x.pfm", GRAY.astype(np.float32))])
def test_save_image_cases_refused_before(tmp_path, name, array):
    """What ``save_image`` refused before it wrote JPEG, TIFF, PFM and
    int32 arrays: PIL opens the file in the mode of its own save of the
    same array, with its pixels (the bytes are PIL's for JPEG and TIFF:
    ``test_torch_image_formats.py``)."""
    ours, pils = tmp_path / f"o{name[1:]}", tmp_path / f"p{name[1:]}"
    save_image(ours, array)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        Image.fromarray(array).save(pils)
    got, want = Image.open(ours), Image.open(pils)
    assert got.mode == want.mode and got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    if name.endswith((".jpg", ".jpeg", ".tif")):
        assert ours.read_bytes() == pils.read_bytes()
    _hold_read(ours)


@pytest.mark.parametrize("name,array,match", [
    ("x.jp2", GRAY.astype(np.float32), "mode F as JPEG 2000"),
    ("x.msp", GRAY, "cannot write mode L as MSP"),
    ("x.blp", RGB, "Unsupported BLP image mode"),
    ("x.foo", GRAY, "unknown image file extension"),
    ("x.png", GRAY.astype(np.float32), "mode F"),
    ("x.ppm", np.stack([GRAY, GRAY], -1), "mode LA as PPM"),
    ("x.bmp", np.stack([GRAY, GRAY], -1), "mode LA as BMP"),
    ("x.bmp", WIDE, "mode I;16 as BMP"),
    ("x.bmp", GRAY.astype(np.int32), "mode I as BMP"),
    ("x.bmp", GRAY.astype(np.float32), "mode F as BMP"),
    ("x.png", np.zeros((4, 4, 5), np.uint8), "cannot write"),
    ("x.jpg", np.concatenate([RGB, GRAY[..., None]], -1),
     "cannot write mode RGBA as JPEG"),
    ("x.jpg", np.stack([GRAY, GRAY], -1), "cannot write mode LA as JPEG"),
    ("x.jpg", WIDE, "cannot write mode I;16 as JPEG"),
    ("x.jpeg", GRAY.astype(np.int32), "cannot write mode I as JPEG"),
    ("x.jpg", GRAY.astype(np.float32), "cannot write mode F as JPEG"),
    ("x.tif", np.zeros((4, 4, 5), np.uint8), "cannot write"),
])
def test_save_image_refusals_name_what_they_refuse(tmp_path, name, array,
                                                   match):
    """Each refusal is PIL's: PIL raises on the same array and extension
    (BLP's refusal, with the same message, is a ValueError in PIL
    too)."""
    p = tmp_path / name
    with pytest.raises(ValueError, match=match):
        save_image(p, array)
    assert not p.exists()
    if name.endswith(".blp"):
        with pytest.raises(ValueError, match=match):
            Image.fromarray(array).save(tmp_path / f"pil{name[1:]}")
    elif match != "unknown image file extension":
        with pytest.raises((OSError, TypeError, KeyError)):
            Image.fromarray(array).save(tmp_path / f"pil{name[1:]}")


# ---------------------------------------------------------------------------
# the commands on PGM and JPEG files

@pytest.fixture(scope="module")
def pnm_jpeg_pair(tmp_path_factory):
    """test_torch_cli.py's textured pair, saved as PGM and as JPEG."""
    load_jax_native()
    d = tmp_path_factory.mktemp("pair")
    img1 = textured_image(128, 176, seed=4)
    img2 = warp_np(img1, SHIFT, 128, 176)
    for name, img in (("a", img1), ("b", img2)):
        im = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
        im.save(d / f"{name}.pgm")
        im.save(d / f"{name}.jpg", quality=95)
    (d / "iters.ini").write_text(SMALL_ITERS)
    (d / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
    return d


@pytest.mark.parametrize("ext", ["pgm", "jpg"])
def test_cli_match_on_pgm_and_jpeg_against_jax(pnm_jpeg_pair, ext, capsys):
    d = pnm_jpeg_pair
    figures = {}
    for tag, run in (("jax", jcli.cmd_match),
                     ("torch", lambda a: tcli.main(
                         ["match"] + a + ["--device", "cpu"]))):
        m = d / f"m_{tag}_{ext}.txt"
        assert run([str(d / f"a.{ext}"), str(d / f"b.{ext}"), "0", "none",
                    "k1", "k2", str(m), "0", "LORANSACH",
                    str(d / "config.ini"), str(d / "iters.ini")]) == 0
        figures[tag] = chip_smoke.match_figures(
            capsys.readouterr().out, str(m), SHIFT, 176, 128)
    j, t = figures["jax"], figures["torch"]
    assert t["steps"] == j["steps"]
    assert t["matches"] >= 10 and abs(t["matches"] - j["matches"]) \
        <= 0.2 * j["matches"], (t, j)


def test_cli_extract_michal_on_a_jpeg_against_jax(tmp_path, capsys):
    """``extract`` in the michal format on a colour JPEG: the header's
    image size is the JPEG's, and the regions are the JAX command's."""
    base = textured_image(144, 176, seed=8)
    rgb = np.stack([base, np.roll(base, 3, 1) * 0.9, base * 0.7 + 20], -1)
    img = tmp_path / "a.jpg"
    Image.fromarray(np.clip(rgb, 0, 255).astype(np.uint8)).save(img,
                                                                quality=90)
    (tmp_path / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
    (tmp_path / "iters.ini").write_text(chip_smoke.cviu_iters_ini([([dict(
        chip_smoke._HESAFF, tilt_set=(1.0,), descriptors=("RootSIFT",),
        fginn_threshold=(0.8,), distance_threshold=(0.0,))], None)],
        min_matches=10))
    inis = [str(tmp_path / "config.ini"), str(tmp_path / "iters.ini")]
    out = {}
    for tag, run in (("jax", jcli.cmd_extract),
                     ("torch", lambda a: tcli.main(
                         ["extract"] + a + ["--device", "cpu"]))):
        out[tag] = str(tmp_path / f"x_{tag}")
        assert run([str(img), out[tag]] + inis + ["michal"]) == 0
    rows = []
    for tag in ("jax", "torch"):
        p = f"{out[tag]}RootSIFT"
        with open(p, "rb") as f:
            head = np.frombuffer(f.read(20), "<i4")
        assert tuple(head[3:]) == image_size(img) == (176, 144)
        xy, s, A, _, _, desc = trio.load_regions_michal(p)
        rows.append(np.c_[xy, A.reshape(-1, 4), s, desc])
    _hold_rows(*rows)


# ---------------------------------------------------------------------------
# the fixtures and the JAX figures of chip_smoke.py phase 14

def write_fixtures(d) -> None:
    """PIL's JPEGs of phase 14: zoom2x's pair in gray at quality 90, and
    three 301x211 colour images of zoom2x and tilt4 crops (4:2:0 with a
    restart every 7 MCUs, 4:2:0 progressive, 4:2:2)."""
    os.makedirs(d, exist_ok=True)
    for i in (1, 2):
        Image.open(os.path.join(REPO, ".parity_work", f"zoom2x_{i}.png")) \
            .save(os.path.join(d, f"zoom2x_{i}.jpg"), quality=90)
    im = Image.fromarray(_jpeg_source(211, 301)[1])
    for name, kw in (("color_420_restart", dict(restart_marker_blocks=7)),
                     ("color_420_progressive", dict(progressive=True)),
                     ("color_422", dict(subsampling=1))):
        im.save(os.path.join(d, f"{name}.jpg"), quality=90,
                **dict(dict(subsampling=2), **kw))


def _jax_jpeg_main() -> None:
    """The JAX command on phase 14's JPEG pair (``JAX_JPEG_REFERENCE``)."""
    import contextlib
    import json
    import tempfile
    import time
    from pathlib import Path
    fx = chip_smoke.IMAGE_FIXTURES
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        (td / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
        (td / "iters.ini").write_text(chip_smoke.cviu_iters_ini())
        m = td / "m.txt"
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jcli.cmd_match([str(fx / "zoom2x_1.jpg"),
                                   str(fx / "zoom2x_2.jpg"), "0", "0", "k1",
                                   "k2", str(m), "0", "LORANSACH",
                                   str(td / "config.ini"),
                                   str(td / "iters.ini")]) == 0
        h, w = read_image(fx / "zoom2x_1.jpg").shape[:2]
        figures = chip_smoke.match_figures(
            buf.getvalue(), str(m),
            np.loadtxt(chip_smoke.PAIRS / "zoom2x_H.txt"), w, h)
    print(json.dumps(dict(figures, seconds=round(time.time() - t0, 1))),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--fixtures"]:
        write_fixtures(chip_smoke.IMAGE_FIXTURES)
    elif sys.argv[1:] == ["--jax-jpeg"]:
        _jax_jpeg_main()
