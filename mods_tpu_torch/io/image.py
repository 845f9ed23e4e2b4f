"""Image files as the JAX package's commands read and write them.

The JAX commands read every image with ``np.asarray(Image.open(path))``
(``mods_tpu/cli.py::_load_image``) and write drawings with
``Image.fromarray(canvas).save(path)`` (``mods_tpu/viz.py::save_image``).
The card machine has no PIL, so the port reads and writes the formats
itself, with numpy, zlib and ctypes, and returns what PIL returns:

* ``read_image(path)``: the array of ``np.asarray(Image.open(path))``,
  the same dtype, shape and values, the format picked from the file's
  magic bytes as PIL picks it:
  - PNG, every colour type, bit depth and Adam7 (``io/png.py``);
  - PNM (PIL's PpmImagePlugin): P1/P4 as bool with a set bit (black)
    False; P2/P5 as uint8, rescaled as value / maxval * 255 rounded half
    to even where maxval is not 255, and as int32 (PIL's "I", rescaled
    to 65535) where maxval > 255; P3/P6 as (H, W, 3) uint8, rescaled to
    255;
  - BMP (PIL's BmpImagePlugin), uncompressed or with the 24- and 32-bit
    bitfield masks PIL reads: 1-, 4- and 8-bit palettes as indices
    ("P"), as bool ("1") or gray ("L") where the palette is black and
    white or the gray ramp; 24-bit and 32-bit (its fourth byte dropped
    unless a mask names alpha);
  - JPEG, baseline and progressive, by ``csrc/jpeg_decode.cpp``
    (libjpeg-turbo's default decode, which PIL runs), built with g++ at
    first use into ``mods_tpu_torch/_build/native/<machine>/``.
  Anything else (TIFF, GIF, WebP, ...) raises a ``ValueError`` naming
  the format, as do the JPEG and BMP variants the readers leave out.
* ``image_size(path)``: ``Image.open(path).size``, (width, height), from
  the header.
* ``save_image(path, array)``: the format that the extension names, as
  ``Image.fromarray(array).save(path)`` writes it: ``.png`` (bool as
  1-bit, uint8 gray, gray+alpha, RGB, RGBA, uint16 as 16-bit gray),
  ``.pbm``/``.pgm``/``.ppm``/``.pnm`` (P4 for bool, P5 for uint8, P5
  with maxval 65535 for uint16, P6 for RGB and RGBA), ``.bmp`` (bool,
  gray, RGB, RGBA).  Every other extension (``.jpg``, ``.tif``, ...),
  every array that PIL refuses to write in that format, and int32 or
  float arrays (PIL's "I" and "F", which it writes clipped to 16 bits or
  as PFM) raise a ``ValueError`` naming them.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from mods_tpu_torch.io import png

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG_SOURCE = os.path.join(_PKG, "csrc", "jpeg_decode.cpp")

# magic bytes of formats that PIL opens and this module does not
_OTHER_FORMATS = ((b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                  (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
                  (b"\x00\x00\x01\x00", "ICO"), (b"8BPS", "PSD"),
                  (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"),
                  (b"\xff\x4f\xff\x51", "JPEG 2000"), (b"qoif", "QOI"),
                  (b"DDS ", "DDS"), (b"icns", "ICNS"),
                  (b"\x0a", "PCX"), (b"#?RADIANCE", "HDR"),
                  (b"Pf", "PFM"))


def _format(head: bytes, path) -> str:
    if head.startswith(png._SIGNATURE):
        return "PNG"
    if head.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if head.startswith(b"BM"):
        return "BMP"
    if head[:1] == b"P" and head[1:2] in (b"1", b"2", b"3", b"4", b"5",
                                          b"6"):
        return "PNM"
    if head.startswith(b"RIFF") and head[8:12] == b"WEBP":
        name = "WebP"
    else:
        name = next((n for m, n in _OTHER_FORMATS if head.startswith(m)),
                    None)
    if name:
        raise ValueError(f"{path}: {name} images are not supported (PNG, "
                         f"JPEG, PNM and BMP are)")
    raise ValueError(f"{path}: not an image format this reader knows (PNG, "
                     f"JPEG, PNM, BMP)")


def read_image(path) -> np.ndarray:
    """``np.asarray(Image.open(path))`` (module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    fmt = _format(data[:16], path)
    if fmt == "PNG":
        return png.read_png(path)
    if fmt == "JPEG":
        return _read_jpeg(data, path)
    if fmt == "BMP":
        return _read_bmp(data, path)
    return _read_pnm(data, path)


def image_size(path) -> tuple[int, int]:
    """``Image.open(path).size``: (width, height) from the header."""
    with open(path, "rb") as f:
        data = f.read(1 << 16)
    fmt = _format(data[:16], path)
    if fmt == "PNG":
        return png.png_size(path)
    if fmt == "JPEG":
        return _jpeg_size(path)
    if fmt == "BMP":
        return _bmp_header(data, path)["size"]
    return _pnm_header(data, path)["size"]


# ---------------------------------------------------------------------------
# PNM (PIL's PpmImagePlugin)

_PNM_SPACE = b" \t\n\x0b\x0c\r"


def _pnm_header(data: bytes, path) -> dict:
    """Magic, size, maxval and the offset of the data, read token by
    token as PpmImageFile._open reads them."""
    pos = 0
    magic = b""
    while pos < len(data) and len(magic) < 6:
        c = data[pos:pos + 1]
        pos += 1
        if c in _PNM_SPACE:
            break
        magic += c
    if magic not in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6"):
        raise ValueError(f"{path}: PNM variant {magic!r} is not supported")

    def token():
        nonlocal pos
        tok = b""
        while len(tok) <= 10:
            if pos >= len(data):
                break
            c = data[pos:pos + 1]
            pos += 1
            if c in _PNM_SPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                    pos += 1
                pos += 1
                continue
            tok += c
        if not tok or len(tok) > 10:
            raise ValueError(f"{path}: bad PNM header")
        return tok

    w, h = int(token()), int(token())
    out = dict(magic=magic, size=(w, h))
    if magic not in (b"P1", b"P4"):
        out["maxval"] = int(token())
        if not 0 < out["maxval"] < 65536:
            raise ValueError(f"{path}: PNM maxval must be 1..65535")
    out["offset"] = pos
    return out


def _strip_comments(body: bytes) -> bytes:
    """The plain formats' data without '#' comments (PpmPlainDecoder)."""
    out, pos = [], 0
    while True:
        i = body.find(b"#", pos)
        if i < 0:
            out.append(body[pos:])
            return b"".join(out)
        out.append(body[pos:i])
        ends = [e for e in (body.find(b"\n", i), body.find(b"\r", i))
                if e >= 0]
        if not ends:
            return b"".join(out)
        pos = min(ends) + 1


def _read_pnm(data: bytes, path) -> np.ndarray:
    hd = _pnm_header(data, path)
    magic, (w, h), body = hd["magic"], hd["size"], data[hd["offset"]:]
    if magic == b"P4":
        stride = (w + 7) // 8
        if len(body) < stride * h:
            raise ValueError(f"{path}: PNM image data is truncated")
        bits = np.unpackbits(np.frombuffer(body[:stride * h], np.uint8)
                             .reshape(h, stride), axis=1)[:, :w]
        return bits == 0
    if magic == b"P1":
        digits = b"".join(_strip_comments(body).split())
        if len(digits) < w * h:
            raise ValueError(f"{path}: PNM image data is truncated")
        d = np.frombuffer(digits[:w * h], np.uint8)
        if ((d != ord("0")) & (d != ord("1"))).any():
            raise ValueError(f"{path}: P1 data holds a token other than "
                             f"0 or 1")
        return (d == ord("0")).reshape(h, w)
    maxval = hd["maxval"]
    bands = 3 if magic in (b"P3", b"P6") else 1
    wide = bands == 1 and maxval > 255           # PIL's mode "I"
    out_max = 65535 if wide else 255
    n = w * h * bands
    if magic in (b"P2", b"P3"):
        toks = _strip_comments(body).split()
        if len(toks) < n:
            raise ValueError(f"{path}: PNM image data is truncated")
        v = np.array([int(t) for t in toks[:n]], np.int64)
        if (v > maxval).any() or (v < 0).any():
            raise ValueError(f"{path}: PNM value out of 0..{maxval}")
    else:
        size = 2 if maxval > 255 else 1
        if len(body) < n * size:
            raise ValueError(f"{path}: PNM image data is truncated")
        v = np.frombuffer(body[:n * size], ">u2" if size == 2 else np.uint8)
        v = v.astype(np.int64)
    if magic in (b"P5", b"P6") and (maxval == 255 or
                                    (wide and maxval == 65535)):
        scaled = v                                   # PIL's raw decoders
    else:
        scaled = np.minimum(out_max, np.rint(v / maxval * out_max))
    a = scaled.astype(np.int32 if wide else np.uint8)
    return a.reshape((h, w, 3) if bands == 3 else (h, w))


# ---------------------------------------------------------------------------
# BMP (PIL's BmpImagePlugin)

_BMP_MASKS = {
    # (bits, masks) -> (channel byte offsets, R G B [A]) as PIL's rawmodes
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): (2, 1, 0),              # BGRX
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): (3, 2, 1),        # XBGR
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): (3, 1, 0),            # BGXR
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): (3, 2, 1, 0),    # ABGR
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): (0, 1, 2, 3),    # RGBA
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): (2, 1, 0, 3),    # BGRA
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): (3, 1, 0, 2),    # BGAR
    (32, (0x0, 0x0, 0x0, 0x0)): (2, 1, 0, 3),                    # BGRA
    (24, (0xFF0000, 0xFF00, 0xFF)): (2, 1, 0),                   # BGR
}


def _u16(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 2], "little")


def _u32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 4], "little")


def _bmp_header(data: bytes, path) -> dict:
    hsize = _u32(data, 14)
    hd = data[18:14 + hsize]
    pos = 14 + hsize
    if hsize == 12:
        w, h, bits = _u16(hd, 0), _u16(hd, 2), _u16(hd, 6)
        comp, colors, pad, bottom_up = 0, 0, 3, True
    elif hsize in (40, 52, 56, 64, 108, 124):
        flip = hd[7] == 0xFF
        w, bits = _u32(hd, 0), _u16(hd, 10)
        h = 2 ** 32 - _u32(hd, 4) if flip else _u32(hd, 4)
        comp, colors, pad, bottom_up = _u32(hd, 12), _u32(hd, 28), 4, \
            not flip
    else:
        raise ValueError(f"{path}: BMP header size {hsize} is not supported")
    out = dict(size=(w, h), bits=bits, comp=comp, pad=pad,
               bottom_up=bottom_up, colors=colors or 1 << bits)
    if comp == 3:
        if len(hd) >= 48:
            masks = [_u32(hd, 36 + 4 * i) for i in range(3)]
            masks.append(_u32(hd, 48) if len(hd) >= 52 else 0)
        else:
            masks = [_u32(data, pos + 4 * i) for i in range(3)] + [0]
            pos += 12
        out["masks"] = tuple(masks)
    out["palette_at"] = pos
    offset = _u32(data, 10)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * out["colors"]
    out["offset"] = offset
    return out


def _read_bmp(data: bytes, path) -> np.ndarray:
    hd = _bmp_header(data, path)
    (w, h), bits, comp = hd["size"], hd["bits"], hd["comp"]
    if bits not in (1, 4, 8, 24, 32):
        raise ValueError(f"{path}: BMP pixel depth {bits} is not supported")
    layout = None
    if comp == 3:
        masks = hd["masks"] if bits == 32 else hd["masks"][:3]
        layout = _BMP_MASKS.get((bits, masks))
        if layout is None:
            raise ValueError(f"{path}: BMP bitfields layout {bits}-bit "
                             f"{[hex(m) for m in masks]} is not supported")
    elif comp == 0:
        layout = None if bits <= 8 else (2, 1, 0)
    elif comp in (1, 2):
        raise ValueError(f"{path}: RLE-compressed BMPs are not supported")
    else:
        raise ValueError(f"{path}: BMP compression {comp} is not supported")
    stride = ((w * bits + 31) >> 3) & ~3
    at = hd["offset"]
    if len(data) < at + stride * h:
        raise ValueError(f"{path}: BMP image data is truncated")
    rows = np.frombuffer(data[at:at + stride * h], np.uint8).reshape(h, stride)
    if hd["bottom_up"]:
        rows = rows[::-1]
    if bits <= 8:
        colors, pad = hd["colors"], hd["pad"]
        if not 0 < colors <= 65536:
            raise ValueError(f"{path}: BMP palette size {colors} is not "
                             f"supported")
        pal = data[hd["palette_at"]:hd["palette_at"] + pad * colors]
        ramp = (0, 255) if colors == 2 else range(colors)
        gray = all(pal[i * pad:i * pad + 3] == bytes([v & 0xFF]) * 3
                   for i, v in enumerate(ramp))
        per = 8 // bits
        shifts = (8 - bits * (np.arange(per) + 1)).astype(np.uint8)
        idx = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)) \
            .reshape(h, -1)[:, :w].astype(np.uint8)
        if gray and colors == 2:
            if bits != 1:
                raise ValueError(f"{path}: a {bits}-bit BMP with a "
                                 f"black-and-white palette is not supported")
            return idx != 0
        if gray and bits != 8:
            raise ValueError(f"{path}: a {bits}-bit BMP with a gray-ramp "
                             f"palette is not supported")
        return idx
    step = bits // 8
    px = rows[:, :step * w].reshape(h, w, step)
    return np.ascontiguousarray(px[..., list(layout)])


# ---------------------------------------------------------------------------
# JPEG (csrc/jpeg_decode.cpp)

@functools.lru_cache(maxsize=1)
def _jpeg_lib():
    # the port's one g++ rule (``detectors/mser.py::build_native``)
    from mods_tpu_torch.detectors.mser import build_native
    lib = ctypes.CDLL(build_native(JPEG_SOURCE, "libmods_jpeg.so"))
    for fn in (lib.mods_jpeg_info, lib.mods_jpeg_decode):
        fn.restype = ctypes.c_int
    lib.mods_jpeg_info.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_int]
    lib.mods_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int]
    return lib


def _read_jpeg(data: bytes, path) -> np.ndarray:
    lib = _jpeg_lib()
    err = ctypes.create_string_buffer(256)
    info = (ctypes.c_int32 * 4)()
    if lib.mods_jpeg_info(data, len(data), info, err, len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    w, h, c = info[0], info[1], info[2]
    out = np.empty((h, w, 3) if c == 3 else (h, w), np.uint8)
    if lib.mods_jpeg_decode(data, len(data), out.ctypes.data, out.size, err,
                            len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    return out


def _jpeg_size(path) -> tuple[int, int]:
    """(width, height) from the first SOFn marker, as PIL reads it."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            pos += 1
            continue
        m = data[pos + 1]
        if m == 0xFF or 0xD0 <= m <= 0xD8 or m == 0x01:
            pos += 1 if m == 0xFF else 2
            continue
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            h = int.from_bytes(data[pos + 5:pos + 7], "big")
            w = int.from_bytes(data[pos + 7:pos + 9], "big")
            return w, h
        pos += 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
    raise ValueError(f"{path}: JPEG without a frame header")


# ---------------------------------------------------------------------------
# writers

_SAVE_FORMATS = {".png": "PNG", ".apng": "PNG", ".pbm": "PNM", ".pgm": "PNM",
                 ".ppm": "PNM", ".pnm": "PNM", ".bmp": "BMP"}
_NOT_WRITTEN = {".jpg": "JPEG", ".jpeg": "JPEG", ".jpe": "JPEG",
                ".jfif": "JPEG", ".tif": "TIFF", ".tiff": "TIFF",
                ".gif": "GIF", ".webp": "WebP", ".dib": "DIB",
                ".ico": "ICO", ".j2k": "JPEG 2000", ".jp2": "JPEG 2000",
                ".pfm": "PFM"}


def _mode(a: np.ndarray) -> str:
    """PIL's ``Image.fromarray`` mode of an array."""
    if a.ndim == 2:
        if a.dtype == np.bool_:
            return "1"
        if a.dtype == np.uint8:
            return "L"
        if a.dtype == np.uint16:
            return "I;16"
        if a.dtype.kind == "i" and a.dtype.itemsize <= 4:
            return "I"
        if a.dtype in (np.float32, np.float64):
            return "F"
    if a.ndim == 3 and a.dtype == np.uint8 and a.shape[2] in (2, 3, 4):
        return {2: "LA", 3: "RGB", 4: "RGBA"}[a.shape[2]]
    raise ValueError(f"cannot write a {a.dtype} array of shape {a.shape} "
                     f"as an image")


def _pnm_bytes(a: np.ndarray, mode: str) -> bytes:
    h, w = a.shape[:2]
    if mode == "1":
        return b"P4\n%d %d\n" % (w, h) + np.packbits(~a, axis=1).tobytes()
    if mode == "L":
        return b"P5\n%d %d\n255\n" % (w, h) + a.tobytes()
    if mode == "I;16":
        return b"P5\n%d %d\n65535\n" % (w, h) + a.astype(">u2").tobytes()
    if mode in ("RGB", "RGBA"):
        return b"P6\n%d %d\n255\n" % (w, h) + \
            np.ascontiguousarray(a[..., :3]).tobytes()
    raise ValueError(f"cannot write mode {mode} as PPM")


def _bmp_bytes(a: np.ndarray, mode: str) -> bytes:
    h, w = a.shape[:2]
    if mode == "1":
        bits, pal = 1, bytes([0, 0, 0, 0, 255, 255, 255, 0])
        rows = np.packbits(a, axis=1)
    elif mode == "L":
        bits = 8
        pal = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
        pal[:, 3] = 0
        pal = pal.tobytes()
        rows = a
    elif mode in ("RGB", "RGBA"):
        bits, pal = 8 * a.shape[2], b""
        order = [2, 1, 0] if mode == "RGB" else [2, 1, 0, 3]
        rows = a[..., order].reshape(h, -1)
    else:
        raise ValueError(f"cannot write mode {mode} as BMP")
    stride = ((w * bits + 7) // 8 + 3) & ~3
    body = np.zeros((h, stride), np.uint8)
    body[:, :rows.shape[1]] = rows
    colors = len(pal) // 4
    offset = 14 + 40 + len(pal)
    ppm = int(96 * 39.3701 + 0.5)                   # PIL's default 96 dpi
    head = np.array([offset + body.size, 0, offset, 40, w, h, 1 | bits << 16,
                     0, body.size, ppm, ppm, colors, colors], "<u4")
    return b"BM" + head.tobytes() + pal + body[::-1].tobytes()


def save_image(path, array) -> None:
    """``Image.fromarray(array).save(path)`` (module docstring)."""
    ext = os.path.splitext(str(path))[1].lower()
    fmt = _SAVE_FORMATS.get(ext)
    if fmt is None:
        name = _NOT_WRITTEN.get(ext)
        raise ValueError(
            f"{path}: writing {name} images is not supported (.png, .pbm, "
            f".pgm, .ppm, .pnm and .bmp are)" if name else
            f"{path}: unknown image file extension {ext!r}")
    a = np.asarray(array)
    mode = _mode(a)
    if mode in ("I", "F"):
        raise ValueError(f"{path}: writing mode {mode} ({a.dtype} pixels) "
                         f"is not supported")
    if fmt == "PNG":
        png.write_png(path, a)
        return
    try:
        data = _pnm_bytes(a, mode) if fmt == "PNM" else _bmp_bytes(a, mode)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    with open(path, "wb") as f:
        f.write(data)
