"""ICO, CUR, TGA, SGI, PCX, DCX, QOI, MSP, Sun raster and PALM files as PIL
12.1.0 reads and writes them for the JAX commands (``Image.open``,
``Image.fromarray(a).save``).

``io/image.py`` picks the format and calls these; each reader returns
PIL's array and mode, each writer the bytes of PIL's file.  The byte loops
are host C++ built at first use (``csrc/raster_codec.cpp``: the RLE codecs,
QOI, PackBits, MSP's runs and Sun's RLE; ``csrc/resample.cpp``: Pillow's Lanczos resampling for
the ICO writer's thumbnails and its bicubic for ``io/icns.py``'s frames;
``resizer`` premultiplies an "LA" or "RGBA" source once for all sizes).

* ICO (IcoImagePlugin): writing makes a frame of each default size (16,
  24, 32, 48, 64, 128 and 256 square) that fits in the image, each the
  image itself where the size is its own and otherwise
  ``Image.thumbnail(size, LANCZOS, reducing_gap=None)`` (the aspect ratio
  kept; "LA" and "RGBA" resampled premultiplied, "1" by nearest
  neighbour), saved as PNG; the PNG payloads are ``io/png.py``'s, not
  Pillow's zlib-ng bytes, so PIL reads the same frames from a file of
  other bytes.  Reading gives the frame ``Image.open`` shows: the entry of
  the largest area (of the least colour depth among equals), a PNG through
  ``io/png.py`` or a DIB of double height whose AND mask (below 32 bits)
  or fourth bytes (at 32) become the alpha of an RGBA image.
* CUR (CurImagePlugin): the largest cursor's DIB, half its height, its
  32-bit pixels BGRA only where a single entry puts it at byte 22.
* TGA (TgaImagePlugin): raw and RLE, image types 1-3 and 9-11, 1-, 8-,
  16- (BGRA;15Z) 24- and 32-bit pixels, colour maps of 16 and 24 bits
  (a "P" image's indices; PIL cannot load a 32-bit map, nor a map before
  "1" or true-colour pixels), both orientations and the horizontal flip;
  written raw and bottom-up with the version-2 footer ("1", "L", "LA",
  "RGB", "RGBA").
* SGI (SgiImagePlugin): verbatim and RLE, 1 and 2 bytes a sample (the
  high byte kept), "L", "RGB", "RGBA"; written verbatim at 1 byte a sample
  with the file's base name in the header.
* PCX (PcxImagePlugin): "1", 2- and 4-plane palettes, 8-bit "L" or "P"
  (by the palette at the file's end) and three-plane RGB, read as
  PcxDecode.c reads them (planes of an odd stride included); "1", "L" and
  "RGB" written with PcxEncode.c's runs.
* QOI (QoiImagePlugin): RGB and RGBA, read and written by the plugin's
  own Python codec's rules.
* DCX (DcxImagePlugin): the first page's PCX image.
* MSP (MspImagePlugin): "DanM" (version 1) packed 1-bit rows, "LinS"
  (version 2) runs (``mods_msp_decode``: the plugin's own Python
  decoder's rules), the 32-byte header's checksum held as PIL holds it;
  mode "1" written as version 1, every other mode refused as PIL refuses
  it.
* Sun raster (SunImagePlugin), read only: 1-bit (inverted: a set bit is
  black), 4- and 8-bit gray ("P", the indices, after an RGB colour map),
  24- and 32-bit BGR(X), or RGB(X) in a type-3 file, rows padded to 16
  bits; type 2 is Pillow's SunRleDecode.c (``mods_sun_rle_decode``), whose
  lines are not padded.  PIL cannot load a colour map on a 1-bit or RGB
  image.
* PALM (PalmImagePlugin), written only, as PIL writes it: mode "1" as
  version 0 without compression (its 16-byte header big-endian), each row
  inverted (a set bit black) and padded with zeros to a whole number of
  16-bit words; every other mode refused as PIL refuses it (PIL takes
  "L" only with a ``bpp`` that ``Image.fromarray`` never sets).

A file that PIL's ``Image.open`` would pass on to the next plugin raises
``NotThisFormat``: ``io/image.py`` then tries TGA, which PIL tries last.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import struct

import numpy as np

from mods_tpu_torch.io import png

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODEC_SOURCE = os.path.join(_PKG, "csrc", "raster_codec.cpp")
RESAMPLE_SOURCE = os.path.join(_PKG, "csrc", "resample.cpp")


class NotThisFormat(Exception):
    """The file fails a plugin's ``_open`` in a way that makes
    ``Image.open`` try the next plugin."""


@functools.lru_cache(maxsize=1)
def _codec():
    from mods_tpu_torch.detectors.mser import build_native
    lib = ctypes.CDLL(build_native(CODEC_SOURCE, "libmods_raster.so"))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for fn, args in (("mods_tga_rle_decode", [p, i64, i, i, i, p]),
                     ("mods_sgi_rle_decode", [p, i64, i, i, i, i, p]),
                     ("mods_pcx_decode", [p, i64, i, i, i, i, p]),
                     ("mods_qoi_decode", [p, i64, i64, i, p]),
                     ("mods_packbits_decode", [p, i64, i64, i, p]),
                     ("mods_sun_rle_decode", [p, i64, i64, i, p]),
                     ("mods_xbm_decode", [p, i64, i64, i, p]),
                     ("mods_fli_decode", [p, i64, i, i, p]),
                     ("mods_pcd_decode", [p, i64, p])):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = args
    lib.mods_pcx_encode.restype = ctypes.c_int64
    lib.mods_pcx_encode.argtypes = [p, i, i, i, p]
    lib.mods_qoi_encode.restype = ctypes.c_int64
    lib.mods_qoi_encode.argtypes = [p, i64, i, p]
    lib.mods_msp_decode.restype = ctypes.c_int64
    lib.mods_msp_decode.argtypes = [p, i64, i, i, p, i64,
                                    ctypes.POINTER(ctypes.c_int)]
    return lib


@functools.lru_cache(maxsize=1)
def _resampler():
    from mods_tpu_torch.detectors.mser import build_native
    # Pillow's Resample.c has no fused multiply-adds
    lib = ctypes.CDLL(build_native(RESAMPLE_SOURCE, "libmods_resample.so",
                                   ("-ffp-contract=off",)))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mods_resample.restype = ctypes.c_int
    lib.mods_resample.argtypes = [p, i, i, i, i, i, i, i, p, ctypes.c_char_p,
                                  i]
    lib.mods_resample_nearest.restype = None
    lib.mods_resample_nearest.argtypes = [p, i, i, i, i, p]
    return lib


def _u16(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 2], "little")


def _u32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 4], "little")


def _decode_failed(path, status: int) -> ValueError:
    """ImageFile.load's errors: -2 where the data ends first."""
    return ValueError(f"{path}: image file is truncated" if status == -2
                      else f"{path}: buffer overrun when reading image file")


# ---------------------------------------------------------------------------
# Lanczos thumbnails and bicubic resizes (Image.thumbnail and Image.resize)

def thumbnail_size(width: int, height: int, size: tuple) -> tuple | None:
    """``Image.thumbnail``'s ``preserve_aspect_ratio``: the size within
    ``size`` that keeps the aspect ratio, or None where the image fits."""
    x, y = size

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    if x >= width and y >= height:
        return None
    aspect = width / height
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0
                         else abs(aspect - x / n))
    return x, y


def _premultiply(a: np.ndarray) -> np.ndarray:
    """Convert.c's rgbA2rgba / lA2la: colour x alpha / 255, rounded."""
    al = a[..., -1:].astype(np.uint32)
    t = a[..., :-1].astype(np.uint32) * al + 128
    return np.concatenate([((t >> 8) + t) >> 8, al], -1).astype(np.uint8)


def _unpremultiply(a: np.ndarray) -> np.ndarray:
    """Convert.c's rgba2rgbA / la2lA: colour x 255 / alpha, truncated and
    clipped, where alpha is neither 0 nor 255."""
    al = a[..., -1:].astype(np.int64)
    c = a[..., :-1].astype(np.int64)
    v = np.where((al == 255) | (al == 0), c,
                 np.minimum(255 * c // np.maximum(al, 1), 255))
    return np.concatenate([v, al], -1).astype(np.uint8)


# csrc/resample.cpp's filters
_FILTERS = {"lanczos": 0, "bicubic": 1}


def resizer(a: np.ndarray, mode: str, filt: str = "lanczos"):
    """A function of a size that gives ``Image.fromarray(a).resize(size,
    filt)`` (LANCZOS or BICUBIC) for the modes of
    ``io/image.py::_mode`` ("I" as int32, "F" as float32; "1" by nearest
    neighbour, as resize runs it): a copy where the size is the image's,
    and "LA" and "RGBA" resampled premultiplied, as Pillow converts them
    to "La" and "RGBa" and back, the source premultiplied once for all
    sizes."""
    lib = _resampler()
    h0, w0 = a.shape[:2]
    if mode in ("LA", "RGBA"):
        inner = resizer(_premultiply(a), "RGB", filt)

        def resize(size):
            if tuple(size) == (w0, h0):
                return a.copy()
            return _unpremultiply(inner(size))
        return resize
    kind, dtype = {"I;16": (1, np.uint16), "I": (2, np.int32),
                   "F": (3, np.float32)}.get(mode, (0, np.uint8))
    src = np.ascontiguousarray(a, np.uint8 if mode == "1" else dtype)

    def resize(size):
        w, h = size
        if (w, h) == (w0, h0):
            return a.copy()
        if mode == "1":
            out = np.empty((h, w), np.uint8)
            lib.mods_resample_nearest(src.ctypes.data, w0, h0, w, h,
                                      out.ctypes.data)
            return out.astype(bool)
        out = np.empty((h, w) + src.shape[2:], dtype)
        err = ctypes.create_string_buffer(256)
        if lib.mods_resample(src.ctypes.data, kind, _FILTERS[filt], w0, h0,
                             src.shape[2] if src.ndim == 3 else 1, w, h,
                             out.ctypes.data, err, len(err)):
            raise ValueError(err.value.decode())
        return out
    return resize


def resize_lanczos(a: np.ndarray, mode: str, size: tuple) -> np.ndarray:
    """``Image.fromarray(a).resize(size, LANCZOS)`` (``resizer``)."""
    return resizer(a, mode)(size)


def resize_bicubic(a: np.ndarray, mode: str, size: tuple) -> np.ndarray:
    """``Image.fromarray(a).resize(size)``: Pillow's default filter,
    BICUBIC (``resizer``)."""
    return resizer(a, mode, "bicubic")(size)


# ---------------------------------------------------------------------------
# ICO (IcoImagePlugin) and CUR (CurImagePlugin)

ICO_SIZES = (16, 24, 32, 48, 64, 128, 256)


def ico_frames(a: np.ndarray, mode: str) -> list:
    """IcoImagePlugin._save's frames with its default sizes: the image
    itself where a size is its own, else its Lanczos thumbnail."""
    h, w = a.shape[:2]
    resize = resizer(a, mode)
    frames = []
    for s in ICO_SIZES:
        if s > w or s > h:
            continue
        fit = thumbnail_size(w, h, (s, s))
        frames.append(a if fit is None else resize(fit))
    return frames


def ico_bytes(a: np.ndarray, mode: str) -> bytes:
    """PIL's ICO: the header, one 16-byte entry a frame (0 for 256, no
    colour count, 0 planes, 32 bits), then each frame's PNG."""
    frames = ico_frames(a, mode)
    if frames and mode == "F":
        raise ValueError("cannot write mode F as PNG")
    pngs = [png.encode_png(np.clip(f, 0, 65535).astype(np.uint16)
                           if mode == "I" else f) for f in frames]
    head = b"\x00\x00\x01\x00" + struct.pack("<H", len(frames))
    offset = len(head) + 16 * len(frames)
    for f, p in zip(frames, pngs):
        fh, fw = f.shape[:2]
        head += struct.pack("<BBBBHHII", fw % 256, fh % 256, 0, 0, 0, 32,
                            len(p), offset)
        offset += len(p)
    return head + b"".join(pngs)


def ico_entries(data: bytes) -> list:
    """IcoFile's directory: each entry's fields, sorted as PIL sorts them
    (largest area first, the least colour depth first among equals)."""
    if len(data) < 6:
        raise NotThisFormat("not an ICO file")
    entries = []
    for i in range(_u16(data, 4)):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise NotThisFormat("ICO directory is truncated")
        width, height, nb_color, bpp = s[0] or 256, s[1] or 256, s[2], \
            _u16(s, 6)
        entries.append(dict(
            dim=(width, height), square=width * height, nb_color=nb_color,
            bpp=bpp, size=_u32(s, 8), offset=_u32(s, 12),
            color_depth=(bpp or (nb_color != 0 and math.ceil(
                math.log(nb_color, 2))) or 256)))
    entries.sort(key=lambda e: e["color_depth"])
    entries.sort(key=lambda e: e["square"], reverse=True)
    if not entries:
        raise NotThisFormat("ICO without images")
    return entries


def _dib_half(data: bytes, at: int, path, alpha: bool = False) -> tuple:
    """The DIB at byte ``at`` read as PIL's BMP reader reads it with its
    height halved (the XOR bitmap of an icon or cursor) -> (array, mode,
    the pixel data's offset in ``data``, (width, height), palette)."""
    from mods_tpu_torch.io import image
    dib = bytearray(data[at:])
    if len(dib) < 4:
        raise NotThisFormat("DIB header is truncated")
    hsize = _u32(dib, 0)
    if hsize not in image._BMP_HEADER_SIZES:
        raise ValueError(f"{path}: Unsupported BMP header type ({hsize})")
    if len(dib) < hsize:
        raise ValueError(f"{path}: Truncated File Read")
    hd = image._bmp_header(b"BM" + bytes(12) + bytes(dib), path)
    w, h2 = hd["size"]
    h = h2 // 2
    if hsize == 12:
        dib[6:8] = struct.pack("<H", h)
    else:
        dib[8:12] = struct.pack("<I", (2 ** 32 - h) % 2 ** 32
                                if dib[11] == 0xFF else h)
    bmp = image._dib_as_bmp(bytes(dib), path)
    pixels_at = at + _u32(bmp, 10) - 14
    arr, mode = image._read_bmp(bmp, path, raw_alpha=alpha)
    pal = None
    if mode == "P":
        pad = 3 if hsize == 12 else 4
        raw = bmp[hd["palette_at"]:hd["palette_at"] + pad * hd["colors"]]
        n = len(raw) // pad
        pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        pal[:min(n, 256)] = np.frombuffer(raw[:pad * n], np.uint8).reshape(
            n, pad)[:256, 2::-1]
    return arr, mode, pixels_at, (w, h), pal


def _rgba(arr: np.ndarray, mode: str, pal) -> np.ndarray:
    """``convert("RGBA")`` of a BMP reader's image."""
    if mode == "P":
        rgb = pal[arr]
    elif mode in ("1", "L"):
        g = arr.astype(np.uint8) * (255 if mode == "1" else 1)
        rgb = np.stack([g] * 3, -1)
    else:
        rgb = arr[..., :3]
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)],
                          -1)


def read_ico(data: bytes, path) -> tuple[np.ndarray, str]:
    """``Image.open`` of an ICO: its first entry's frame."""
    return ico_frame(data, ico_entries(data)[0], path)


def ico_frame(data: bytes, e: dict, path) -> tuple[np.ndarray, str]:
    """IcoFile.frame of the entry ``e`` of ``ico_entries``: its array and
    mode."""
    from mods_tpu_torch.io import image
    at = e["offset"]
    if data[at:at + 8] == png._SIGNATURE:
        a = png.decode_png(data[at:], path)
        return a, "P" if data[at + 25:at + 26] == b"\x03" \
            else image._array_mode(a)
    arr, mode, pixels_at, (w, h), pal = _dib_half(data, at, path)
    if e["bpp"] == 32:
        alpha = np.frombuffer(data[pixels_at:pixels_at + w * h * 4][3::4],
                              np.uint8)
        if alpha.size < w * h:
            raise ValueError(f"{path}: not enough image data")
        alpha = alpha.reshape(h, w)[::-1]
    else:
        wpad = -(-w // 32) * 32
        total = wpad * h // 8
        mask_at = at + e["size"] - total
        if mask_at < 0:
            raise ValueError(f"{path}: negative seek value {mask_at}")
        mask = np.frombuffer(data[mask_at:mask_at + total], np.uint8)
        if mask.size < total:
            raise ValueError(f"{path}: not enough image data")
        bits = np.unpackbits(mask.reshape(h, wpad // 8), axis=1)[::-1, :w]
        alpha = np.where(bits == 0, 255, 0).astype(np.uint8)
    out = _rgba(arr, mode, pal)
    out[..., 3] = alpha
    return out, "RGBA"


def cur_entry(data: bytes) -> bytes:
    """CurImageFile._open's pick: the largest cursor's directory entry (by
    both sides, the first on ties)."""
    if len(data) < 6:
        raise NotThisFormat("not a CUR file")
    m = b""
    for i in range(_u16(data, 4)):
        s = data[6 + 16 * i:22 + 16 * i]
        if not m:
            m = s
        elif not s:
            raise NotThisFormat("CUR directory is truncated")
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if len(m) < 16:
        raise NotThisFormat("No cursors were found")
    if len(data) < _u32(m, 12) + 4:
        raise NotThisFormat("CUR bitmap header is truncated")
    return m


def read_cur(data: bytes, path) -> tuple[np.ndarray, str]:
    """``Image.open`` of a CUR: the picked cursor's DIB, half its
    height."""
    header = _u32(cur_entry(data), 12)
    arr, mode, *_ = _dib_half(data, header, path, alpha=header == 22)
    return arr, mode


# ---------------------------------------------------------------------------
# TGA (TgaImagePlugin)

# (image type & 7, depth) -> rawmode, as TgaImagePlugin.MODES
_TGA_RAW = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
            (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}
# rawmode -> (PIL's unpacker bits, bytes an RLE pixel)
_TGA_BITS = {"P": 8, "1": 1, "L": 8, "LA": 16, "BGRA;15Z": 16, "BGR": 24,
             "BGRA": 32}


def tga_header(data: bytes) -> dict:
    """TgaImageFile._open: size, mode, orientation, where the pixels start
    and how they are stored; ``NotThisFormat`` where it fails."""
    if len(data) < 18:
        raise NotThisFormat("not a TGA file")
    id_len, cmt, imagetype, depth, flags = data[0], data[1], data[2], \
        data[16], data[17]
    w, h = _u16(data, 12), _u16(data, 14)
    if cmt not in (0, 1) or w <= 0 or h <= 0 or \
            depth not in (1, 8, 16, 24, 32):
        raise NotThisFormat("not a TGA file")
    if imagetype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif imagetype in (1, 9):
        mode = "P" if cmt else "L"
    elif imagetype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise NotThisFormat("unknown TGA mode")
    pos = 18 + id_len
    if cmt:
        mapdepth = data[7]
        if mapdepth not in (16, 24, 32):
            raise NotThisFormat("unknown TGA map depth")
        pos += mapdepth // 8 * _u16(data, 5)
    return dict(size=(w, h), mode=mode, rle=bool(imagetype & 8),
                map_depth=data[7] if cmt else 0,
                rawmode=_TGA_RAW.get((imagetype & 7, depth)), depth=depth,
                top_down=flags & 0x20 != 0, flip=flags & 0x10 != 0,
                offset=min(pos, len(data)))


def _tga_unpack(rows: np.ndarray, rawmode: str, w: int) -> np.ndarray:
    """Pillow's unpacker of a TGA rawmode on (h, row bytes) rows."""
    h = rows.shape[0]
    if rawmode == "1":
        return np.unpackbits(rows, axis=1)[:, :w].astype(bool)
    if rawmode in ("P", "L"):
        return rows[:, :w]
    if rawmode == "LA":
        return rows[:, :2 * w].reshape(h, w, 2)
    if rawmode == "BGRA;15Z":
        v = rows[:, :2 * w].reshape(h, w, 2).astype(np.uint32)
        v = v[..., 0] | v[..., 1] << 8
        bgr = [(v >> sh & 31) * 255 // 31 for sh in (10, 5, 0)]
        return np.stack(bgr + [np.where(v >> 15, 0, 255)], -1) \
            .astype(np.uint8)
    n = 3 if rawmode == "BGR" else 4
    return rows[:, :n * w].reshape(h, w, n)[..., [2, 1, 0, 3][:n]]


def read_tga(data: bytes, path) -> tuple[np.ndarray, str]:
    hd = tga_header(data)
    (w, h), mode, rawmode = hd["size"], hd["mode"], hd["rawmode"]
    if rawmode is None:
        raise ValueError(f"{path}: cannot load this image (TGA image type "
                         f"{data[2]} of {hd['depth']}-bit pixels)")
    if hd["map_depth"] and mode in ("1", "RGB", "RGBA"):
        raise ValueError(f"{path}: unrecognized image mode (a TGA colour "
                         f"map on a {mode} image, which PIL cannot load)")
    if hd["map_depth"] == 32:
        raise ValueError(f"{path}: unrecognized raw mode (PIL cannot load "
                         f"a TGA's 32-bit colour map)")
    if rawmode == "P" and mode == "L":
        raise ValueError(f"{path}: unknown raw mode for given image mode "
                         f"(a TGA colour-mapped image without a colour "
                         f"map)")
    bits = _TGA_BITS[rawmode]
    stride = (w * bits + 7) // 8
    # the RLE decoder's pixel is depth // 8 bytes: none for 1-bit pixels,
    # whose packets never fill a row (PIL cannot read its own 1-bit RLE)
    body = data[hd["offset"]:]
    if hd["rle"]:
        rows = np.empty((h, stride), np.uint8)
        status = _codec().mods_tga_rle_decode(body, len(body),
                                              hd["depth"] // 8, stride,
                                              h, rows.ctypes.data)
        if status:
            raise _decode_failed(path, status)
    else:
        if len(body) < stride * h:
            raise _decode_failed(path, -2)
        rows = np.frombuffer(body[:stride * h], np.uint8).reshape(h, stride)
    if not hd["top_down"]:
        rows = rows[::-1]
    a = _tga_unpack(rows, rawmode, w)
    if hd["flip"]:
        a = a[:, ::-1]
    return np.ascontiguousarray(a), mode


# TgaImagePlugin.SAVE: mode -> (bits, image type)
_TGA_SAVE = {"1": (1, 3), "L": (8, 3), "LA": (16, 3), "RGB": (24, 2),
             "RGBA": (32, 2)}


def tga_bytes(a: np.ndarray, mode: str) -> bytes:
    """PIL's TGA with its defaults: uncompressed, bottom-up, flag 8 where
    there is alpha, the version-2 footer."""
    if mode not in _TGA_SAVE:
        raise ValueError(f"cannot write mode {mode} as TGA")
    h, w = a.shape[:2]
    bits, imagetype = _TGA_SAVE[mode]
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, imagetype, 0, 0, 0, 0, 0, w, h,
                       bits, 8 if mode in ("LA", "RGBA") else 0)
    if mode == "1":
        rows = np.packbits(a, axis=1)
    elif mode in ("RGB", "RGBA"):
        rows = a[..., [2, 1, 0, 3][:a.shape[2]]]
    else:
        rows = a
    return head + np.ascontiguousarray(rows[::-1]).tobytes() \
        + bytes(8) + b"TRUEVISION-XFILE.\x00"


# ---------------------------------------------------------------------------
# SGI (SgiImagePlugin)

# (bytes a sample, dimension, channels) -> rawmode, as SgiImagePlugin.MODES
_SGI_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B",
              (2, 2, 1): "L;16B", (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B",
              (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}


def sgi_header(data: bytes, path) -> dict:
    """SgiImageFile._open: its ValueError where the mode is unknown."""
    if len(data) < 12:
        raise NotThisFormat("SGI header is truncated")
    compression, bpc = data[2], data[3]
    dimension, xsize, ysize, zsize = struct.unpack_from(">4H", data, 4)
    rawmode = _SGI_MODES.get((bpc, dimension, zsize))
    if rawmode is None:
        raise ValueError(f"{path}: Unsupported SGI image mode")
    return dict(size=(xsize, ysize), mode=rawmode.split(";")[0], bpc=bpc,
                compression=compression)


def read_sgi(data: bytes, path) -> tuple[np.ndarray, str]:
    hd = sgi_header(data, path)
    (w, h), mode, bpc = hd["size"], hd["mode"], hd["bpc"]
    bands = len(mode)
    if hd["compression"] == 0:
        page = w * h * bpc
        if len(data) < 512 + page * bands:
            raise _decode_failed(path, -2)
        planes = np.frombuffer(data[512:512 + page * bands], np.uint8) \
            .reshape(bands, h, w, bpc)[..., 0]
        a = np.moveaxis(planes[:, ::-1], 0, -1)
    elif hd["compression"] == 1:
        body = data[512:]
        rows = np.zeros((h, w * bands * bpc), np.uint8)
        if _codec().mods_sgi_rle_decode(
                body, len(body), bands, w, h, bpc, rows.ctypes.data):
            raise _decode_failed(path, -1)
        a = rows.reshape(h, w, bands, bpc)[..., 0]
    else:
        raise ValueError(f"{path}: cannot load this image (SGI compression "
                         f"{hd['compression']})")
    return np.ascontiguousarray(a[..., 0] if bands == 1 else a), mode


def sgi_bytes(a: np.ndarray, mode: str, path) -> bytes:
    """PIL's SGI: verbatim, 1 byte a sample, planes bottom-up, the file's
    base name (ASCII, at most 79 characters) in the header."""
    if mode not in ("L", "RGB", "RGBA"):
        raise ValueError("Unsupported SGI image mode")
    h, w = a.shape[:2]
    z = 1 if mode == "L" else a.shape[2]
    dimension = (1 if h == 1 else 2) if mode == "L" else 3
    name = os.path.splitext(os.path.basename(str(path)))[0].encode(
        "ascii", "ignore")
    head = (struct.pack(">hBBHHHHll4s79ss", 474, 0, 1, dimension, w, h, z, 0,
                        255, b"", name, b"") + struct.pack(">l404s", 0, b""))
    planes = a[..., None] if a.ndim == 2 else a
    return head + np.ascontiguousarray(
        np.moveaxis(planes[::-1], -1, 0)).tobytes()


# ---------------------------------------------------------------------------
# PCX (PcxImagePlugin)

def pcx_header(data: bytes, path) -> dict:
    """PcxImageFile._open: size, mode, rawmode and the decoder's line
    length; ``NotThisFormat`` where PIL passes the file on, PIL's OSError
    (as ValueError) where it fails."""
    if len(data) < 68:
        raise NotThisFormat("PCX header is truncated")
    x0, y0, x1, y1 = struct.unpack_from("<4H", data, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise NotThisFormat("bad PCX image size")
    version, bits, planes = data[1], data[3], data[65]
    provided = _u16(data, 66)
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        if len(data) < 769:
            raise ValueError(f"{path}: [Errno 22] Invalid argument (a PCX "
                             f"file shorter than its palette)")
        tail = data[-769:]
        if tail[0] == 12 and tail[1:] != bytes(
                v for i in range(256) for v in (i, i, i)):
            mode = rawmode = "P"
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise ValueError(f"{path}: unknown PCX mode")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    return dict(size=(w, h), mode=mode, rawmode=rawmode,
                bits={"P;2L": 2, "P;4L": 4, "RGB;L": 24}.get(rawmode, bits),
                line=planes * stride)


def read_pcx(data: bytes, path) -> tuple[np.ndarray, str]:
    hd = pcx_header(data, path)
    (w, h), rawmode, line = hd["size"], hd["rawmode"], hd["line"]
    body = data[128:]
    rows = np.empty((h, line), np.uint8)
    status = _codec().mods_pcx_decode(body, len(body), line, w, hd["bits"],
                                      h, rows.ctypes.data)
    if status:
        raise _decode_failed(path, status)
    if rawmode == "1":
        a = np.unpackbits(rows, axis=1)[:, :w].astype(bool)
    elif rawmode in ("P;2L", "P;4L"):
        s = (w + 7) // 8
        a = np.zeros((h, w), np.uint8)
        for p in range(int(rawmode[2])):
            a |= np.unpackbits(rows[:, p * s:(p + 1) * s], axis=1)[:, :w] << p
    elif rawmode == "RGB;L":
        a = np.stack([rows[:, k * w:(k + 1) * w] for k in range(3)], -1)
    else:
        a = rows[:, :w]
    return np.ascontiguousarray(a), hd["mode"]


def dcx_page(data: bytes, path) -> bytes:
    """DcxImageFile._open: the file from its first page's PCX header on
    (the 4-byte magic, then up to 1024 little-endian page offsets ended
    by 0); PIL reads the page as a PCX file, whose palette it still
    takes from the end of the whole file."""
    first = _u32(data, 4) if len(data) >= 8 else 0
    if not first:
        raise ValueError(f"{path}: cannot identify image file (a DCX "
                         f"without pages)")
    page = data[first:]
    try:
        pcx_header(page, path)
    except NotThisFormat as e:
        raise ValueError(f"{path}: cannot identify image file (a DCX "
                         f"whose first page is not a PCX image: {e})") \
            from None
    return page


def read_dcx(data: bytes, path) -> tuple[np.ndarray, str]:
    """``Image.open`` of a DCX: its first page."""
    return read_pcx(dcx_page(data, path), path)


# PcxImagePlugin.SAVE: mode -> (version, bits, planes)
_PCX_SAVE = {"1": (2, 1, 1), "L": (5, 8, 1), "RGB": (5, 8, 3)}


def pcx_bytes(a: np.ndarray, mode: str) -> bytes:
    """PIL's PCX: the 128-byte header, PcxEncode.c's runs, a gray palette
    after an "L" image."""
    if mode not in _PCX_SAVE:
        raise ValueError(f"Cannot save {mode} images as PCX")
    version, bits, planes = _PCX_SAVE[mode]
    h, w = a.shape[:2]
    stride = (w * bits + 7) // 8
    stride += stride % 2
    head = (struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1,
                        h - 1, 100, 100) + bytes(24) + b"\xff" * 24
            + struct.pack("<BBHHHH", 0, planes, stride, 1, w, h) + bytes(54))
    if mode == "1":
        rows = np.packbits(a, axis=1)
    elif mode == "RGB":
        rows = np.moveaxis(a, -1, 1).reshape(h, 3 * w)
    else:
        rows = a
    rows = np.ascontiguousarray(rows, np.uint8)
    # a run codes at most 63 bytes in 2, a byte at worst in 2, plus padding
    out = np.empty(h * (2 * rows.shape[1] + 2 * planes) + 16, np.uint8)
    n = _codec().mods_pcx_encode(rows.ctypes.data, w, h, bits * planes,
                                 out.ctypes.data)
    tail = b"\x0c" + bytes(v for i in range(256) for v in (i, i, i)) \
        if mode == "L" else b""
    return head + out[:n].tobytes() + tail


# ---------------------------------------------------------------------------
# QOI (QoiImagePlugin)

def qoi_header(data: bytes) -> dict:
    if len(data) < 13:
        raise NotThisFormat("QOI header is truncated")
    w, h = struct.unpack_from(">II", data, 4)
    return dict(size=(w, h), mode="RGB" if data[12] == 3 else "RGBA")


def read_qoi(data: bytes, path) -> tuple[np.ndarray, str]:
    hd = qoi_header(data)
    (w, h), mode = hd["size"], hd["mode"]
    c = len(mode)
    out = np.empty((h, w, c), np.uint8)
    body = data[14:]
    if _codec().mods_qoi_decode(body, len(body), w * h, c, out.ctypes.data):
        raise ValueError(f"{path}: QOI image data is truncated")
    return out, mode


def qoi_bytes(a: np.ndarray, mode: str) -> bytes:
    """PIL's QOI: colorspace byte 1 (no ``colorspace="sRGB"``), then
    QoiEncoder's ops and its 8-byte end."""
    if mode not in ("RGB", "RGBA"):
        raise ValueError("Unsupported QOI image mode")
    h, w, c = a.shape
    px = np.ascontiguousarray(a, np.uint8)
    out = np.empty(h * w * 5 + 8, np.uint8)
    n = _codec().mods_qoi_encode(px.ctypes.data, h * w, c, out.ctypes.data)
    return b"qoif" + struct.pack(">IIBB", w, h, c, 1) + out[:n].tobytes()


# ---------------------------------------------------------------------------
# MSP (MspImagePlugin)

def msp_header(data: bytes, path) -> dict:
    """MspImageFile._open: size and version; a file PIL cannot identify
    (a short header, a bad checksum, an empty side) raises PIL's
    reason."""
    if len(data) < 32:
        raise ValueError(f"{path}: cannot identify image file (an MSP "
                         f"header of {len(data)} bytes)")
    words = struct.unpack_from("<16H", data)
    checksum = 0
    for word in words:
        checksum ^= word
    if checksum:
        raise ValueError(f"{path}: cannot identify image file (bad MSP "
                         f"checksum)")
    w, h = words[2], words[3]
    if not w or not h:
        raise ValueError(f"{path}: cannot identify image file (an MSP of "
                         f"{w} x {h} pixels)")
    return dict(size=(w, h), mode="1", version=1 if data[:4] == b"DanM"
                else 2)


def read_msp(data: bytes, path) -> tuple[np.ndarray, str]:
    hd = msp_header(data, path)
    (w, h) = hd["size"]
    stride = (w + 7) // 8
    if hd["version"] == 1:
        body = data[32:32 + stride * h]
        if len(body) < stride * h:
            raise _decode_failed(path, -2)
    else:
        out = np.zeros(stride * h, np.uint8)
        row = ctypes.c_int(0)
        n = _codec().mods_msp_decode(data[32:], len(data) - 32, w, h,
                                     out.ctypes.data, out.size,
                                     ctypes.byref(row))
        if n == -1:
            raise ValueError(f"{path}: Truncated MSP file in row map")
        if n == -2:
            raise ValueError(f"{path}: Truncated MSP file, expected "
                             f"{_u16(data, 32 + 2 * row.value)} bytes on "
                             f"row {row.value}")
        if n == -3:
            raise ValueError(f"{path}: Corrupted MSP file in row "
                             f"{row.value}")
        if n < out.size:
            raise ValueError(f"{path}: not enough image data")
        body = out.tobytes()
    rows = np.frombuffer(body, np.uint8).reshape(h, stride)
    return np.unpackbits(rows, axis=1)[:, :w].astype(bool), "1"


def msp_bytes(a: np.ndarray, mode: str) -> bytes:
    """PIL's MSP: version 1, the size twice and the checksum in word 12,
    then the packed rows (a set bit white)."""
    if mode != "1":
        raise ValueError(f"cannot write mode {mode} as MSP")
    h, w = a.shape
    words = [_u16(b"Da", 0), _u16(b"nM", 0), w, h, 1, 1, 1, 1, w, h] \
        + [0] * 6
    for word in words[:12]:
        words[12] ^= word
    return struct.pack("<16H", *words) + np.packbits(a, axis=1).tobytes()


def palm_bytes(a: np.ndarray, mode: str) -> bytes:
    """PIL's PALM of a bool array (module docstring)."""
    if mode != "1":
        raise ValueError(f"cannot write mode {mode} as Palm")
    h, w = a.shape
    rowbytes = int((w + 15) / 16) * 2
    rows = np.zeros((h, rowbytes), np.uint8)
    rows[:, :(w + 7) // 8] = np.packbits(~a, axis=1)
    # width, height, row bytes, flags, bits a pixel, version 0, offset 0,
    # transparent index, compression 0xFF (none), reserved
    return struct.pack(">4H2BH2BH", w, h, rowbytes, 0, 1, 0, 0, 0, 0xFF,
                       0) + rows.tobytes()


# ---------------------------------------------------------------------------
# Sun raster (SunImagePlugin)

# depth -> (mode, raw mode, bits) and, for 24 and 32 bits in a type-3 file,
# the raw mode RGB(X)
_SUN_DEPTHS = {1: ("1", "1;I"), 4: ("L", "L;4"), 8: ("L", "L"),
               24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}


def sun_header(data: bytes, path) -> dict:
    """SunImageFile._open: size, mode, raw mode, the data's offset and
    type; what PIL passes on to the next plugin raises "cannot identify
    image file" with the plugin's reason."""
    def unidentified(why):
        return ValueError(f"{path}: cannot identify image file ({why})")
    if len(data) < 32:
        raise unidentified("a Sun raster header of fewer than 32 bytes")
    (w, h, depth, _, file_type, palette_type,
     palette_length) = struct.unpack_from(">7I", data, 4)
    if depth not in _SUN_DEPTHS:
        raise unidentified("Unsupported Mode/Bit Depth")
    mode, rawmode = _SUN_DEPTHS[depth]
    if file_type == 3:
        rawmode = rawmode.replace("BGR", "RGB")
    if palette_length:
        if palette_length > 1024:
            raise unidentified("Unsupported Color Palette Length")
        if palette_type != 1:
            raise unidentified("Unsupported Palette Type")
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
    if file_type not in (0, 1, 2, 3, 4, 5):
        raise unidentified("Unsupported Sun Raster file type")
    if not w or not h:
        raise unidentified(f"a Sun raster of {w} x {h} pixels")
    return dict(size=(w, h), mode=mode, rawmode=rawmode, depth=depth,
                rle=file_type == 2, offset=32 + palette_length,
                stride=(w * depth + 15) // 16 * 2)


def read_sun(data: bytes, path) -> tuple[np.ndarray, str]:
    hd = sun_header(data, path)
    (w, h), depth, rawmode = hd["size"], hd["depth"], hd["rawmode"]
    if hd["offset"] > 32 and hd["mode"] in ("1", "RGB"):
        raise ValueError(f"{path}: unrecognized image mode (PIL cannot put "
                         f"a Sun raster's colour map on a {hd['mode']} "
                         f"image)")
    row_bytes = (w * depth + 7) // 8
    body = data[hd["offset"]:]
    if hd["rle"]:
        rows = np.empty((h, row_bytes), np.uint8)
        if _codec().mods_sun_rle_decode(body, len(body), row_bytes, h,
                                        rows.ctypes.data):
            raise _decode_failed(path, -2)
    else:
        stride = hd["stride"]
        if len(body) < stride * (h - 1) + row_bytes:
            raise _decode_failed(path, -2)
        rows = np.frombuffer(body + bytes(stride - row_bytes), np.uint8)[
            :stride * h].reshape(h, stride)[:, :row_bytes]
    if depth == 1:
        return np.unpackbits(rows, axis=1)[:, :w] == 0, "1"
    if depth == 4:
        v = np.stack([rows >> 4, rows & 15], -1).reshape(h, -1)[:, :w]
        return np.ascontiguousarray(v * 17 if rawmode == "L;4" else v), \
            hd["mode"]
    if depth == 8:
        return np.ascontiguousarray(rows), hd["mode"]
    px = rows.reshape(h, w, depth // 8)
    return np.ascontiguousarray(px[..., [2, 1, 0] if rawmode.startswith("B")
                                   else [0, 1, 2]]), "RGB"
