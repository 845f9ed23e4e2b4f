"""TIFF files as PIL 12.1.0 reads them (TiffImagePlugin, and libtiff 4.7
for every compressed file), and the LZW that GIF shares.

``read_tiff(data, path)`` returns ``np.asarray(Image.open(path))`` and
``Image.open(path).mode`` for the first page of a classic or BigTIFF file;
``tiff_size(data, path)`` returns ``Image.open(path).size``.  PIL's steps
are followed one by one:

* the first image file directory, in either byte order, with 12-byte
  entries (classic) or 20-byte entries and 8-byte values and offsets
  (BigTIFF: LONG8, SLONG8 and IFD8 too); a value that runs past the end
  of the file is dropped, as PIL drops it;
* ``TiffImageFile._setup``: the compression must be one of PIL's
  ``COMPRESSION_INFO``, and (byte order, photometric interpretation,
  sample format, fill order, bits per sample, extra samples) one of its
  ``OPEN_INFO`` keys (``OPEN_INFO`` below, a copy), which gives the mode
  and the raw mode;
* an uncompressed file goes through PIL's own raw decoder, strip by
  strip or tile by tile as ``_setup`` lists them (one strip of the whole
  image is read at its last offset; a plane of planar configuration 2 is
  read with one character of the raw mode; a tile past the right edge
  with the stride ``_setup`` computes), its rows unpacked by the raw
  mode's unpacker (``_UNPACKERS``, Pillow's Unpack.c: fill order 2's bit
  reversal, 2- and 4-bit gray scaled, 12-bit to "I;16", 16-bit colour
  samples to their high byte, associated alpha divided out, ...);
* a compressed file goes through libtiff as PIL's TiffDecode.c drives it:
  fill order 2 undone on the compressed bytes (libtiff's codecs but
  JPEG) and the fill-order-1 raw mode used; each strip or tile decoded
  (``csrc/tiff_decode.cpp``: LZW in both bit orders, PackBits, CCITT
  modified Huffman, Group 3 and Group 4, modified Huffman in 16-bit
  words (tiff_raw_16, libtiff's CCITTRLEW), ThunderScan's 4-bit codes;
  ``csrc/zstd_decode.cpp``: Zstandard as libzstd 1.5.7 decodes a strip
  for libtiff's ZSTDDecode; zlib's Deflate, CPython's ``lzma`` for LZMA;
  ``csrc/jpeg_decode.cpp`` for JPEG with the ``JPEGTables`` stream), its
  16-, 32- and 64-bit samples put in the host's byte order and predictor
  2 or 3 undone (LZW, Deflate, LZMA and Zstandard), then unpacked with
  the raw mode's native-order form ("I;16N", "RGB;16N", ...);
* YCbCr (photometric 6): JPEG in planar configuration 1 decodes to RGB
  (libtiff's JPEGCOLORMODE_RGB); any other compressed YCbCr file goes
  through libtiff's RGBA interface (TIFFRGBAImageGet: its subsampling
  blocks and integer YCbCr tables); an uncompressed one through PIL's
  "RGBX" raw mode, as PIL misreads it;
* old-style JPEG (compression 6, ``_OJpeg``) as libtiff's tif_ojpeg.c
  reads it: the stream rebuilt from JPEGInterchangeFormat's markers or
  from the tables of tags 512-521, the strips or tiles read on as one
  stream with an RSTn between them, the frame's sampling factors over
  YCbCrSubsampling; YCbCr as libjpeg's raw_data_out leaves it
  (``csrc/jpeg_decode.cpp``), in libtiff's sampling blocks, through the
  RGBA interface; one component through its scanlines; planar
  configuration 2 read as 1 where there is one strip offset and one byte
  count (TIFFReadDirectory's "OJPEG hack"), and refused otherwise;
* the Orientation tag transposes the result (``ImageOps.exif_transpose``
  in ``TiffImageFile.load_end``).

Every case that PIL refuses, and every compression that this module
does not read, raises a ``ValueError`` whose message names the case and
holds one of ``REFUSALS``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import sys
import zlib

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIFF_SOURCE = os.path.join(_PKG, "csrc", "tiff_decode.cpp")
ZSTD_SOURCE = os.path.join(_PKG, "csrc", "zstd_decode.cpp")

II, MM = b"II", b"MM"
# TiffImagePlugin.OPEN_INFO (Pillow 12.1.0): (byte order, photometric,
# sample format, fill order, bits per sample, extra samples) -> (mode,
# raw mode)
OPEN_INFO = {}
for _bo in (II, MM):
    for _key, _val in {
        (0, (1,), 1, (1,), ()): ("1", "1;I"),
        (0, (1,), 2, (1,), ()): ("1", "1;IR"),
        (1, (1,), 1, (1,), ()): ("1", "1"),
        (1, (1,), 2, (1,), ()): ("1", "1;R"),
        (0, (1,), 1, (2,), ()): ("L", "L;2I"),
        (0, (1,), 2, (2,), ()): ("L", "L;2IR"),
        (1, (1,), 1, (2,), ()): ("L", "L;2"),
        (1, (1,), 2, (2,), ()): ("L", "L;2R"),
        (0, (1,), 1, (4,), ()): ("L", "L;4I"),
        (0, (1,), 2, (4,), ()): ("L", "L;4IR"),
        (1, (1,), 1, (4,), ()): ("L", "L;4"),
        (1, (1,), 2, (4,), ()): ("L", "L;4R"),
        (0, (1,), 1, (8,), ()): ("L", "L;I"),
        (0, (1,), 2, (8,), ()): ("L", "L;IR"),
        (1, (1,), 1, (8,), ()): ("L", "L"),
        (1, (2,), 1, (8,), ()): ("L", "L"),
        (1, (1,), 2, (8,), ()): ("L", "L;R"),
        (1, (2,), 1, (32,), ()): ("I", "I;32S" if _bo == II else "I;32BS"),
        (0, (3,), 1, (32,), ()): ("F", "F;32F" if _bo == II else "F;32BF"),
        (1, (3,), 1, (32,), ()): ("F", "F;32F" if _bo == II else "F;32BF"),
        (1, (2,), 1, (16,), ()): ("I", "I;16S" if _bo == II else "I;16BS"),
        (1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
        (2, (1,), 1, (8, 8, 8), ()): ("RGB", "RGB"),
        (2, (1,), 2, (8, 8, 8), ()): ("RGB", "RGB;R"),
        (2, (1,), 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
        (2, (1,), 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
        (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
        (2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
        (2, (1,), 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
        (2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
        (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
        (2, (1,), 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
        (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
        (2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
        (2, (1,), 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
        (3, (1,), 1, (1,), ()): ("P", "P;1"),
        (3, (1,), 2, (1,), ()): ("P", "P;1R"),
        (3, (1,), 1, (2,), ()): ("P", "P;2"),
        (3, (1,), 2, (2,), ()): ("P", "P;2R"),
        (3, (1,), 1, (4,), ()): ("P", "P;4"),
        (3, (1,), 2, (4,), ()): ("P", "P;4R"),
        (3, (1,), 1, (8,), ()): ("P", "P"),
        (3, (1,), 1, (8, 8), (0,)): ("P", "PX"),
        (3, (1,), 1, (8, 8), (2,)): ("PA", "PA"),
        (3, (1,), 2, (8,), ()): ("P", "P;R"),
        (5, (1,), 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
        (5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
        (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
        (6, (1,), 1, (8,), ()): ("L", "L"),
        (6, (1,), 1, (8, 8, 8), ()): ("RGB", "RGBX"),
        (8, (1,), 1, (8, 8, 8), ()): ("LAB", "LAB"),
    }.items():
        OPEN_INFO[(_bo,) + _key] = _val
    _e = "L" if _bo == II else "B"
    for _key, _val in {
        (2, (1,), 1, (16, 16, 16), ()): ("RGB", f"RGB;16{_e}"),
        (2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", f"RGBA;16{_e}"),
        (2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", f"RGBX;16{_e}"),
        (2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", f"RGBa;16{_e}"),
        (2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", f"RGBA;16{_e}"),
        (5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", f"CMYK;16{_e}"),
    }.items():
        OPEN_INFO[(_bo,) + _key] = _val
OPEN_INFO[(II, 1, (1,), 1, (12,), ())] = ("I;16", "I;12")
OPEN_INFO[(II, 0, (1,), 1, (16,), ())] = ("I;16", "I;16")
OPEN_INFO[(II, 1, (1,), 1, (16,), ())] = ("I;16", "I;16")
OPEN_INFO[(MM, 1, (1,), 1, (16,), ())] = ("I;16B", "I;16B")
OPEN_INFO[(II, 1, (1,), 2, (16,), ())] = ("I;16", "I;16R")
OPEN_INFO[(II, 1, (1,), 1, (32,), ())] = ("I", "I;32N")

# TiffImagePlugin.COMPRESSION_INFO: the compressions PIL opens, by name
COMPRESSION_INFO = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4",
                    5: "tiff_lzw", 6: "tiff_jpeg", 7: "jpeg",
                    8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                    32773: "packbits", 32809: "tiff_thunderscan",
                    32946: "tiff_deflate", 34676: "tiff_sgilog",
                    34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                    50001: "webp"}
# the compressions this module decodes
READ_COMPRESSIONS = (1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946,
                     34925, 50000)
# the names of the others, for their refusal, and of the CCITT ones
_COMPRESSION_NAMES = {34661: "JBIG",
                      34676: "SGILog (LogLuv)", 34677: "SGILog24 (LogLuv)",
                      34712: "JPEG 2000", 50001: "WebP"}
# SGILog: PIL has no mode for LogL and LogLuv (32844, 32845), the only
# photometric interpretations that libtiff's LogLuvSetupDecode takes
_SGILOG = (34676, 34677)
_LOG_PHOTOMETRIC = {32844: "LogL", 32845: "LogLuv"}
_CCITT_NAMES = {2: "CCITT", 3: "CCITT Group 3", 4: "CCITT Group 4",
                32771: "tiff_raw_16 (CCITT RLEW)"}
# the phrases of every refusal
REFUSALS = ("PIL does not open", "PIL refuses", "PIL misreads",
            "is not supported")

# field type -> struct code (a rational is two of them)
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "i", 11: "f", 12: "d", 13: "I", 16: "Q", 17: "q",
          18: "Q"}
_MAX_SAMPLES = 6            # TiffImagePlugin.MAX_SAMPLESPERPIXEL
_MAX_PIXELS = 89478485      # Image.MAX_IMAGE_PIXELS
# the tags that lay out the pixels, which must hold integers
_INTEGER_TAGS = {256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279,
                 284, 292, 293, 317, 322, 323, 324, 325, 338, 339, 530}

_REV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _refuse(path, what: str) -> ValueError:
    return ValueError(f"{path}: TIFF {what}")


# ---------------------------------------------------------------------------
# the codecs (csrc/tiff_decode.cpp)

@functools.lru_cache(maxsize=1)
def _lib():
    # the port's one g++ rule; no FMA contraction in the YCbCr tables
    from mods_tpu_torch.detectors.mser import build_native
    lib = ctypes.CDLL(build_native(TIFF_SOURCE, "libmods_tiff.so",
                                   ("-ffp-contract=off",)))
    c = ctypes
    lib.mods_lzw_decode.argtypes = [c.c_char_p, c.c_int64, c.c_int, c.c_int,
                                    c.c_void_p, c.c_int64,
                                    c.POINTER(c.c_int64), c.c_char_p, c.c_int]
    lib.mods_packbits_decode.argtypes = [c.c_char_p, c.c_int64, c.c_void_p,
                                         c.c_int64, c.POINTER(c.c_int64)]
    lib.mods_reverse_bits.argtypes = [c.c_void_p, c.c_int64]
    lib.mods_reverse_bits.restype = None
    lib.mods_tiff_unpredict.argtypes = [c.c_void_p, c.c_int64, c.c_int64,
                                        c.c_int, c.c_int, c.c_int, c.c_int,
                                        c.c_char_p, c.c_int]
    lib.mods_ccitt_decode.argtypes = [c.c_char_p, c.c_int64, c.c_int,
                                      c.c_int, c.c_int, c.c_int, c.c_void_p,
                                      c.c_int64, c.c_char_p, c.c_int]
    lib.mods_ycbcr_to_rgb.argtypes = [c.c_char_p, c.c_int64, c.c_int, c.c_int,
                                      c.c_int, c.c_int, c.c_int, c.c_void_p,
                                      c.c_void_p, c.c_void_p, c.c_int64,
                                      c.c_char_p, c.c_int]
    lib.mods_thunder_decode.argtypes = [c.c_char_p, c.c_int64, c.c_int,
                                        c.c_int, c.c_void_p, c.c_int64,
                                        c.c_char_p, c.c_int]
    for fn in (lib.mods_lzw_decode, lib.mods_packbits_decode,
               lib.mods_tiff_unpredict, lib.mods_ccitt_decode,
               lib.mods_ycbcr_to_rgb, lib.mods_thunder_decode):
        fn.restype = c.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _zstd_lib():
    from mods_tpu_torch.detectors.mser import build_native
    lib = ctypes.CDLL(build_native(ZSTD_SOURCE, "libmods_zstd.so"))
    c = ctypes
    for fn in (lib.mods_zstd_decode, lib.mods_zstd_decode_strip):
        fn.argtypes = [c.c_char_p, c.c_int64, c.c_void_p, c.c_int64,
                       c.c_char_p, c.c_int]
        fn.restype = c.c_int64
    lib.mods_zstd_coverage.argtypes = [c.POINTER(c.c_int64), c.c_int, c.c_int]
    lib.mods_zstd_coverage.restype = c.c_int
    return lib


# csrc/zstd_decode.cpp's counters (enum Cov), for the tests
ZSTD_COUNTERS = (
    "block_raw", "block_rle", "block_compressed", "lit_raw", "lit_rle",
    "lit_huffman", "lit_treeless", "lit_1_stream", "lit_4_streams",
    "ll_predefined", "ll_rle", "ll_fse", "ll_repeat", "of_predefined",
    "of_rle", "of_fse", "of_repeat", "ml_predefined", "ml_rle", "ml_fse",
    "ml_repeat", "repeat_offset_1", "repeat_offset_2", "repeat_offset_3",
    "frames", "skippable_frames", "single_segment", "windowed",
    "checksums", "huffman_x1", "huffman_x2", "huffman_fast")


def zstd_decode(data: bytes, cap: int, strip: bool = False,
                path="Zstandard") -> bytes:
    """``ZSTD_decompress`` of ``data`` into at most ``cap`` bytes, or with
    ``strip`` what libtiff's ZSTDDecode reads of one strip of ``cap``
    bytes (csrc/zstd_decode.cpp); a ValueError where libzstd fails."""
    out = ctypes.create_string_buffer(max(cap, 1))
    err = ctypes.create_string_buffer(256)
    lib = _zstd_lib()
    fn = lib.mods_zstd_decode_strip if strip else lib.mods_zstd_decode
    n = fn(data, len(data), out, cap, err, len(err))
    if n < 0:
        raise ValueError(f"{path}: Zstandard data that libzstd does not "
                         f"decode ({err.value.decode()}): PIL refuses it")
    return out.raw[:n]


def zstd_coverage(reset: bool = False) -> dict:
    """csrc/zstd_decode.cpp's counters since the last reset, by name."""
    counts = (ctypes.c_int64 * len(ZSTD_COUNTERS))()
    _zstd_lib().mods_zstd_coverage(counts, len(ZSTD_COUNTERS), int(reset))
    return dict(zip(ZSTD_COUNTERS, counts))


def _check(rc: int, err, path) -> None:
    if rc:
        raise ValueError(f"{path}: {err.value.decode()}")


def lzw_decode(data: bytes, kind: int, min_bits: int, cap: int,
               path="LZW") -> bytes:
    """LZW of ``kind`` 0 (TIFF, MSB first, early change), 1 (TIFF's old
    LSB-first form) or 2 (GIF), at most ``cap`` bytes."""
    out = ctypes.create_string_buffer(max(cap, 1))
    n = ctypes.c_int64()
    err = ctypes.create_string_buffer(256)
    _check(_lib().mods_lzw_decode(data, len(data), kind, min_bits, out, cap,
                                  ctypes.byref(n), err, len(err)), err, path)
    return out.raw[:n.value]


def _packbits(data: bytes, cap: int) -> bytes:
    out = ctypes.create_string_buffer(max(cap, 1))
    n = ctypes.c_int64()
    _lib().mods_packbits_decode(data, len(data), out, cap, ctypes.byref(n))
    return out.raw[:n.value]


def _reverse_bits(data: bytes) -> bytes:
    buf = np.frombuffer(data, np.uint8).copy()
    _lib().mods_reverse_bits(buf.ctypes.data, buf.size)
    return buf.tobytes()


# ---------------------------------------------------------------------------
# the directory

def _header(data: bytes, path) -> tuple[str, bool, int]:
    """Byte order, BigTIFF or not, and the first directory's offset."""
    if len(data) < 8 or data[:2] not in (II, MM):
        raise ValueError(f"{path}: not a TIFF file")
    bo = "<" if data[:2] == II else ">"
    magic = struct.unpack_from(bo + "H", data, 2)[0]
    if magic == 43:
        if len(data) < 16:
            raise ValueError(f"{path}: BigTIFF header is truncated")
        return bo, True, struct.unpack_from(bo + "Q", data, 8)[0]
    return bo, False, struct.unpack_from(bo + "I", data, 4)[0]


def read_ifd(data: bytes, path) -> tuple[str, dict]:
    """The byte order and the first directory's tags: tag -> tuple of
    values (rationals as floats) or bytes (UNDEFINED and ASCII)."""
    bo, big, off = _header(data, path)
    if big and bo == ">":
        # TiffImagePlugin takes byte 2 of the header for the version: a
        # big-endian BigTIFF opens as a classic TIFF and fails
        raise ValueError(f"{path}: TIFF big-endian BigTIFF: PIL does not "
                         f"open it")
    head, entry, inline = (8, 20, 8) if big else (2, 12, 4)
    if off + head > len(data):
        raise ValueError(f"{path}: TIFF without an image file directory")
    count = struct.unpack_from(bo + ("Q" if big else "H"), data, off)[0]
    tags = {}
    for i in range(count):
        e = off + head + entry * i
        if e + entry > len(data):
            raise ValueError(f"{path}: TIFF directory is truncated")
        tag, typ, cnt = struct.unpack_from(bo + ("HHQ" if big else "HHI"),
                                           data, e)
        code = _TYPES.get(typ)
        if code is None or cnt == 0:
            continue
        n = cnt * (2 if typ in (5, 10) else 1)
        size = struct.calcsize(code) * n
        at = e + 4 + (8 if big else 4)
        if size > inline:
            at = struct.unpack_from(bo + ("Q" if big else "I"), data, at)[0]
        if at + size > len(data):
            continue                          # PIL drops the value
        if typ in (2, 7):
            tags[tag] = bytes(data[at:at + size])
            continue
        if typ in (5, 10, 11, 12) and tag in _INTEGER_TAGS:
            raise _refuse(path, f"tag {tag} of field type {typ}: PIL "
                          f"refuses it (not an integer)")
        vals = struct.unpack_from(f"{bo}{n}{code}", data, at)
        if typ in (5, 10):
            vals = tuple(a / b if b else float("nan")
                         for a, b in zip(vals[::2], vals[1::2]))
        tags[tag] = vals
    for t in (256, 257):
        if t not in tags or not isinstance(tags[t][0], int):
            raise ValueError(f"{path}: TIFF without an image size")
    return bo, tags


def tiff_size(data: bytes, path) -> tuple[int, int]:
    """``Image.open(path).size``: (width, height), swapped where the
    Orientation tag turns the image."""
    tags = read_ifd(data, path)[1]
    w, h = tags[256][0], tags[257][0]
    return (h, w) if tags.get(274, (1,))[0] in (5, 6, 7, 8) else (w, h)


# ---------------------------------------------------------------------------
# PIL's unpackers (Unpack.c), by raw mode: (bits a pixel, function of the
# (rows, row bytes) uint8 rows and the pixel count)

_HOST = sys.byteorder == "little"


def _samples(r: np.ndarray, bits: int, n: int) -> np.ndarray:
    """The first n samples of each row, MSB first, of 1, 2 or 4 bits."""
    per = 8 // bits
    shifts = (8 - bits * (np.arange(per) + 1)).astype(np.uint8)
    v = (r[:, :, None] >> shifts) & ((1 << bits) - 1)
    return v.reshape(len(r), -1)[:, :n]


def _bytes(r: np.ndarray, n: int, size: int) -> np.ndarray:
    return r[:, :n * size].reshape(len(r), n, size)


def _wide(r, n, dtype):
    size = np.dtype(dtype).itemsize
    return np.ascontiguousarray(r[:, :n * size]).view(dtype)


def _i12(r, n):
    m = (n + 1) // 2 * 3
    if r.shape[1] < m:
        r = np.pad(r, ((0, 0), (0, m - r.shape[1])))
    t = r[:, :m].astype(np.uint16).reshape(len(r), -1, 3)
    v = np.stack([t[..., 0] << 4 | t[..., 1] >> 4,
                  (t[..., 1] & 15) << 8 | t[..., 2]], -1)
    return v.reshape(len(r), -1)[:, :n]


def _unassociate(px: np.ndarray) -> np.ndarray:
    """unpackRGBa: each colour * 255 / alpha, truncated and clipped; all
    zero where alpha is 0."""
    a = px[..., 3:4].astype(np.int32)
    c = px[..., :3].astype(np.int32)
    out = np.where(a == 255, c, np.minimum(255, c * 255 // np.maximum(a, 1)))
    out = np.where(a == 0, 0, out)
    return np.concatenate([out, np.where(a == 0, 0, a)], -1).astype(np.uint8)


def _make_unpackers() -> dict:
    u = {}
    for inv in ("", "I"):
        for rev in ("", "R"):
            def one(r, n, inv=inv, rev=rev):
                v = _samples(_REV[r] if rev else r, 1, n)
                return v == 0 if inv else v != 0
            u["1" + (";" + inv + rev if inv or rev else "")] = (1, one)
            for bits, scale in ((2, 0x55), (4, 0x11)):
                def gray(r, n, bits=bits, scale=scale, inv=inv, rev=rev):
                    v = _samples(_REV[r] if rev else r, bits, n) * scale
                    return (255 - v if inv else v).astype(np.uint8)
                u[f"L;{bits}{inv}{rev}"] = (bits, gray)
    u["L"] = u["P"] = (8, lambda r, n: r[:, :n])
    u["L;I"] = (8, lambda r, n: 255 - r[:, :n])
    u["L;R"] = u["P;R"] = (8, lambda r, n: _REV[r[:, :n]])
    for bits in (1, 2, 4):
        u[f"P;{bits}"] = (bits, lambda r, n, b=bits: _samples(r, b, n))
    u["PX"] = (16, lambda r, n: _bytes(r, n, 2)[..., 0])
    u["PA"] = u["LA"] = (16, lambda r, n: _bytes(r, n, 2))
    u["I;12"] = (12, _i12)
    u["I;16"] = (16, lambda r, n: _wide(r, n, "<u2"))
    u["I;16N"] = (16, lambda r, n: _wide(r, n, "=u2"))
    u["I;16B"] = (16, lambda r, n: _wide(r, n, ">u2"))
    u["I;16R"] = (16, lambda r, n: _wide(_REV[r], n, "<u2"))
    u["I;16S"] = (16, lambda r, n: _wide(r, n, "<i2"))
    u["I;16BS"] = (16, lambda r, n: _wide(r, n, ">i2"))
    u["I;32N"] = (32, lambda r, n: _wide(r, n, "=i4"))
    u["I;32S"] = (32, lambda r, n: _wide(r, n, "<i4"))
    u["I;32BS"] = (32, lambda r, n: _wide(r, n, ">i4"))
    u["F;32F"] = (32, lambda r, n: _wide(r, n, "<f4"))
    u["F;32BF"] = (32, lambda r, n: _wide(r, n, ">f4"))
    u["RGB"] = (24, lambda r, n: _bytes(r, n, 3))
    u["RGB;R"] = (24, lambda r, n: _REV[_bytes(r, n, 3)])
    # unpackLAB moves a and b to unsigned and the array's packer moves
    # them back: the stored bytes
    u["LAB"] = u["RGB"]
    for name, size, keep, assoc in (
            ("RGBA", 4, 4, False), ("RGBX", 4, 3, False),
            ("RGBXX", 5, 3, False), ("RGBXXX", 6, 3, False),
            ("RGBa", 4, 4, True), ("RGBaX", 5, 4, True),
            ("RGBaXX", 6, 4, True), ("RGBAX", 5, 4, False),
            ("RGBAXX", 6, 4, False), ("CMYK", 4, 4, False),
            ("CMYKX", 5, 4, False), ("CMYKXX", 6, 4, False)):
        def px(r, n, size=size, keep=keep, assoc=assoc):
            v = _bytes(r, n, size)[..., :keep]
            return _unassociate(v) if assoc else v
        u[name] = (8 * size, px)
    # 16-bit colour samples: their high byte (the second byte of "L", the
    # first of "B"; "N" is the host's order)
    for name, size, keep, assoc in (
            ("RGB", 3, 3, False), ("RGBA", 4, 4, False),
            ("RGBX", 4, 3, False), ("RGBa", 4, 4, True),
            ("CMYK", 4, 4, False)):
        for e in "LBN":
            hi = 1 if e == "L" or (e == "N" and _HOST) else 0

            def px16(r, n, size=size, keep=keep, assoc=assoc, hi=hi):
                v = _bytes(r, n, 2 * size)[..., hi::2][..., :keep]
                return _unassociate(v) if assoc else v
            u[f"{name};16{e}"] = (16 * size, px16)
    return u


_UNPACKERS = _make_unpackers()
# one plane of planar configuration 2 on PIL's raw path: the raw mode's
# character at the plane's index, as a band of the mode, or the whole
# image for a one-band mode (Unpack.c's band unpackers)
_PLANE_BANDS = {("RGB", c): i for i, c in enumerate("RGB")}
_PLANE_BANDS.update({("RGBA", c): i for i, c in enumerate("RGBA")})
_PLANE_BANDS.update({("CMYK", c): i for i, c in enumerate("CMYK")})
_PLANE_BANDS.update({("LAB", c): i for i, c in enumerate("LAB")})
_PLANE_WHOLE = {("1", "1"): "1", ("L", "L"): "L", ("P", "P"): "P",
                ("I", "I"): "I;32N", ("F", "F"): "F;32F"}

# planar configuration 2 that PIL's libtiff decoder reads as it reads the
# same samples interleaved: these raw modes (but RGB with a fourth sample
# and no ExtraSamples tag), and those with unspecified extra samples in
# tiles only
_PLANAR_LIBTIFF = ("RGB", "RGBA", "RGBa", "CMYK", "RGB;16N", "RGBA;16N",
                   "RGBa;16N", "CMYK;16N")
_PLANAR_LIBTIFF_TILES = _PLANAR_LIBTIFF + (
    "RGBX", "RGBXX", "RGBXXX", "RGBaX", "RGBaXX", "RGBAX", "RGBAXX",
    "CMYKX", "CMYKXX", "RGBX;16N")

# mode -> (dtype, bands) of np.asarray(image)
_MODES = {"1": (np.bool_, 0), "L": (np.uint8, 0), "P": (np.uint8, 0),
          "I;16": ("<u2", 0), "I;16B": (">u2", 0), "I": ("<i4", 0),
          "F": ("<f4", 0), "LA": (np.uint8, 2), "PA": (np.uint8, 2),
          "RGB": (np.uint8, 3), "LAB": (np.uint8, 3), "RGBA": (np.uint8, 4),
          "CMYK": (np.uint8, 4)}


def _unpack(rawmode: str, rows: np.ndarray, n: int, path) -> np.ndarray:
    if rawmode not in _UNPACKERS:
        raise _refuse(path, f"raw mode {rawmode}: PIL refuses it (unknown "
                      f"raw mode)")
    return _UNPACKERS[rawmode][1](rows, n)


def _new(mode: str, h: int, w: int) -> np.ndarray:
    dtype, bands = _MODES[mode]
    return np.zeros((h, w, bands) if bands else (h, w), dtype)


# ---------------------------------------------------------------------------
# reading

class _Info:
    """What ``TiffImageFile._setup`` derives from the tags."""

    def __init__(self, data: bytes, path):
        self.bo, tags = read_ifd(data, path)
        self.tags = tags
        if 0xBC01 in tags:
            raise _refuse(path, "of Windows Media Photo: PIL does not open "
                          "it")
        self.comp = tags.get(259, (1,))[0]
        if self.comp not in COMPRESSION_INFO:
            name = _COMPRESSION_NAMES.get(self.comp, self.comp)
            raise _refuse(path, f"compression {name}: PIL does not open it")
        if self.comp not in READ_COMPRESSIONS + _SGILOG:
            name = _COMPRESSION_NAMES.get(self.comp,
                                          COMPRESSION_INFO[self.comp])
            raise _refuse(path, f"compression {name} is not supported "
                          f"(none, CCITT, LZW, old-style and new JPEG, "
                          f"Deflate, PackBits, LZMA, Zstandard and "
                          f"ThunderScan are)")
        self.planar = tags.get(284, (1,))[0]
        # _setup takes old-style JPEG for YCbCr, whatever the tag says, and
        # its pixels for 3 samples by default
        self.photo = photo = 6 if self.comp == 6 else tags.get(262, (0,))[0]
        self.fill = tags.get(266, (1,))[0]
        self.w, self.h = tags[256][0], tags[257][0]
        if self.w <= 0 or self.h <= 0:
            raise _refuse(path, f"of {self.w}x{self.h} pixels: PIL does not "
                          f"open it")
        if self.w * self.h > 2 * _MAX_PIXELS:
            raise _refuse(path, f"of {self.w}x{self.h} pixels: PIL refuses "
                          f"it (a decompression bomb)")
        sf = tags.get(339, (1,))
        if len(sf) > 1 and max(sf) == min(sf) == 1:
            sf = (1,)
        bps, extra = tags.get(258, (1,)), tags.get(338, ())
        spp = tags.get(277, (3 if photo in (2, 6) and self.comp == 6
                             else 1,))[0]
        if spp > _MAX_SAMPLES:
            raise _refuse(path, f"of {spp} samples per pixel: PIL refuses "
                          f"it")
        if spp < len(bps):
            bps = bps[:spp]
        elif spp > len(bps) and len(bps) == 1:
            bps = bps * spp
        if len(bps) != spp or spp < 1:
            raise _refuse(path, f"of bits per sample {bps} with {spp} "
                          f"samples per pixel: PIL refuses it (unknown "
                          f"data organization)")
        self.spp, self.bps, self.bits = spp, bps, bps[0]
        self.key = (II if self.bo == "<" else MM, photo, tuple(sf),
                    self.fill, tuple(bps), tuple(extra))
        if self.comp in _SGILOG and photo in _LOG_PHOTOMETRIC:
            raise _refuse(path, f"compression {_COMPRESSION_NAMES[self.comp]}"
                          f" of photometric interpretation {photo} "
                          f"({_LOG_PHOTOMETRIC[photo]}): PIL does not open "
                          f"it (no mode of its OPEN_INFO)")
        if self.key not in OPEN_INFO:
            raise _refuse(path, f"of photometric interpretation {photo}, "
                          f"sample format {sf}, fill order {self.fill}, bits "
                          f"{bps}, extra samples {extra} in byte order "
                          f"{self.key[0].decode()}: PIL refuses it (unknown "
                          f"pixel mode)")
        self.mode, self.rawmode = OPEN_INFO[self.key]
        if self.comp in _SGILOG:
            raise _refuse(path, f"compression {_COMPRESSION_NAMES[self.comp]}"
                          f" of photometric interpretation {photo}: PIL "
                          f"refuses it (libtiff's LogLuvSetupDecode takes "
                          f"LogL or LogLuv only)")
        if self.mode in ("P", "PA") and 320 not in tags:
            raise _refuse(path, "of palette indices without a ColorMap: "
                          "PIL does not open it")
        self.orientation = tags.get(274, (1,))[0]
        self.bps_count = (3 if photo in (2, 6, 8) else 4 if photo == 5
                          else 1) + len(extra)


def read_tiff(data: bytes, path) -> tuple[np.ndarray, str]:
    """``np.asarray(Image.open(path))`` and its mode (module docstring)."""
    info = _Info(data, path)
    if info.comp == 1 and info.planar == 2 and info.bits > 8 and (
            info.spp > 1 or info.rawmode not in ("F;32F", "I;32N",
                                                 "I;32S")):
        # TiffImagePlugin reads each plane with one character of the raw
        # mode ("F;32BF"[0] is "F", "I;16"[0] is "I")
        raise _refuse(path, f"planar configuration 2 with {info.bits}-bit "
                      f"samples in raw mode {info.rawmode}: PIL misreads it "
                      f"or refuses it")
    if info.comp == 1:
        a = _read_raw(data, info, path)
    elif info.comp == 6:
        a = _read_ojpeg(data, info, path)
    else:
        a = _read_libtiff(data, info, path)
    return _orient(a, info.orientation), info.mode


def _orient(a: np.ndarray, orientation: int) -> np.ndarray:
    """ImageOps.exif_transpose of the Orientation tag's value."""
    if orientation in (2, 3):
        a = a[:, ::-1]
    if orientation in (3, 4):
        a = a[::-1]
    if orientation in (5, 6, 7, 8):
        a = a.swapaxes(0, 1)
        if orientation in (6, 7):
            a = a[:, ::-1]
        if orientation in (7, 8):
            a = a[::-1]
    return np.ascontiguousarray(a)


def _read_raw(data: bytes, info: _Info, path) -> np.ndarray:
    """PIL's raw decoder over the tiles ``_setup`` lists."""
    tags, w, h = info.tags, info.w, info.h
    if 273 in tags:
        offsets = tags[273]
        tw, th = w, tags.get(278, (h,))[0]
    elif 324 in tags:
        offsets = tags[324]
        tw, th = tags.get(322, (None,))[0], tags.get(323, (None,))[0]
        if tw is None or th is None:
            raise _refuse(path, "without tile dimensions: PIL refuses it")
    else:
        raise _refuse(path, "without strip or tile offsets: PIL refuses it "
                      "(unknown data organization)")
    if tw == w and th == h and info.planar != 2:
        offsets = offsets[-1:]
    if tw <= 0 or th <= 0:
        raise _refuse(path, "of empty strips or tiles: PIL refuses it")
    tiles, x, y, layer = [], 0, 0, 0
    for offset in offsets:
        stride = tw * sum(info.bps) / 8 if x + tw > w else 0
        rawmode = info.rawmode
        if info.planar == 2:
            if layer >= len(rawmode):
                raise _refuse(path, "with more planes than its raw mode "
                              "has characters: PIL refuses it")
            rawmode = rawmode[layer]
            stride /= info.bps_count
        tiles.append((offset, x, y, min(x + tw, w), min(y + th, h), rawmode,
                      int(stride), layer))
        x += tw
        if x >= w:
            x, y = 0, y + th
            if y >= h:
                y, layer = 0, layer + 1
    out = _new(info.mode, h, w)
    for offset, x0, y0, x1, y1, rawmode, stride, layer in sorted(
            tiles, key=lambda t: t[0]):
        band = None
        if info.planar == 2:
            if (info.mode, rawmode) in _PLANE_WHOLE:
                rawmode = _PLANE_WHOLE[(info.mode, rawmode)]
            elif (info.mode, rawmode) in _PLANE_BANDS:
                band = _PLANE_BANDS[(info.mode, rawmode)]
                rawmode = "L"
            else:
                raise _refuse(path, f"planar configuration 2 in mode "
                              f"{info.mode}: PIL refuses it (unknown raw "
                              f"mode {rawmode})")
        if rawmode not in _UNPACKERS:
            raise _refuse(path, f"raw mode {rawmode}: PIL refuses it "
                          f"(unknown raw mode)")
        bits = _UNPACKERS[rawmode][0]
        cols, rows = x1 - x0, y1 - y0
        row_bytes = (cols * bits + 7) // 8
        step = stride if stride else row_bytes
        if step < row_bytes:
            raise _refuse(path, "tile stride shorter than its row: PIL "
                          "refuses it")
        need = (rows - 1) * step + row_bytes if rows > 0 else 0
        if offset + need > len(data):
            raise _refuse(path, "image data is truncated: PIL refuses it "
                          "(image file is truncated)")
        buf = np.frombuffer(data, np.uint8, rows * step - (step - row_bytes)
                            if rows else 0, offset)
        r = np.lib.stride_tricks.as_strided(
            buf, (rows, row_bytes), (step, 1)) if rows else \
            np.zeros((0, row_bytes), np.uint8)
        v = _unpack(rawmode, np.ascontiguousarray(r), cols, path)
        if band is None:
            out[y0:y1, x0:x1] = v
        else:
            # a LAB band unpacker copies a and b as stored, which the
            # array's packer then moves to signed
            out[y0:y1, x0:x1, band] = v ^ 128 if info.mode == "LAB" and \
                band else v
    return out


def _decode_chunk(raw: bytes, info: _Info, need: int, rows: int, cols: int,
                  row_bytes: int, samples: int, path,
                  short_ok: bool = False, offset: int = 0) -> bytes:
    """One strip or tile (at ``offset`` in the file) through libtiff's
    codec: ``need`` bytes of ``rows`` rows, in the host's byte order, the
    predictor undone (fewer where ``short_ok`` and the data ends early)."""
    comp = info.comp
    if info.fill == 2 and comp != 7:
        raw = _reverse_bits(raw)
    if comp in (2, 3, 4, 32771):
        if info.bits != 1 or samples != 1:
            raise _refuse(path, f"{_CCITT_NAMES[comp]} compression of "
                          f"{info.bits}-bit, {samples}-sample pixels is not "
                          f"supported (libtiff reads bilevel images only)")
        out = np.empty(rows * row_bytes, np.uint8)
        err = ctypes.create_string_buffer(256)
        # CCITTRLEW's word alignment reads the strip's address: libtiff
        # reads a mapped file in place, at its offset
        options = (offset & 1 if comp == 32771 else
                   info.tags.get(292 if comp == 3 else 293, (0,))[0])
        _check(_lib().mods_ccitt_decode(raw, len(raw), comp, cols, rows,
                                        options, out.ctypes.data, row_bytes,
                                        err, len(err)), err, path)
        return out.tobytes()
    if comp == 32809:
        if info.bits != 4:
            raise _refuse(path, f"ThunderScan compression of {info.bits}-bit "
                          f"samples: PIL refuses it (libtiff decodes 4-bit "
                          f"samples only)")
        if 322 in info.tags or 324 in info.tags:
            raise _refuse(path, "ThunderScan in tiles: PIL refuses it "
                          "(libtiff does not decode ThunderScan tiles)")
        line = -(-info.w * 4 // 8)
        out = np.zeros(need, np.uint8)
        err = ctypes.create_string_buffer(256)
        _check(_lib().mods_thunder_decode(raw, len(raw), info.w, need // line,
                                          out.ctypes.data, line, err,
                                          len(err)), err, path)
        return out.tobytes()
    if comp == 5:
        old = raw[:1] == b"\x00" and len(raw) > 1 and raw[1] & 1
        buf = lzw_decode(raw, 1 if old else 0, 8, need, path)
    elif comp in (8, 32946):
        try:
            buf = zlib.decompressobj().decompress(raw, need)
        except zlib.error as e:
            raise ValueError(f"{path}: TIFF Deflate data is corrupt ({e})") \
                from None
    elif comp == 50000:
        buf = zstd_decode(raw, need, True, path)
    elif comp == 34925:
        import lzma                 # chip_smoke.py 14n checks it imports
        try:
            buf = lzma.LZMADecompressor().decompress(raw, need)
        except lzma.LZMAError as e:
            raise ValueError(f"{path}: TIFF LZMA data is corrupt ({e})") \
                from None
    else:
        buf = _packbits(raw, need)
    whole = need % row_bytes == 0 and \
        row_bytes % (samples * max(1, info.bits // 8)) == 0
    if len(buf) < need or not whole:
        # libtiff leaves the predictor undone on a short chunk, on one that
        # is not whole rows (PredictorDecodeTile's "occ0%rowsize") and on
        # rows that are not whole pixels (horAcc8's "cc%stride")
        if short_ok:
            return buf
        raise _refuse(path, f"strip or tile of {len(buf)} bytes where "
                      f"{need} are due: PIL refuses it (libtiff's decoder "
                      f"fails)")
    predictor = info.tags.get(317, (1,))[0] if comp in (
        5, 8, 32946, 34925, 50000) else 1
    wide = info.bits in (16, 32, 64)
    swap = info.bo != ("<" if _HOST else ">")
    if predictor == 1 and not (swap and wide):
        return buf[:need]
    arr = np.frombuffer(buf, np.uint8, need).copy()
    if predictor not in (1, 2, 3) or (predictor == 3 and info.key[2] != (3,)):
        raise _refuse(path, f"predictor {predictor} on sample format "
                      f"{info.key[2]} is not supported (libtiff refuses it)")
    err = ctypes.create_string_buffer(256)
    _check(_lib().mods_tiff_unpredict(arr.ctypes.data, rows, row_bytes,
                                      info.bits, samples, predictor,
                                      int(swap), err, len(err)), err, path)
    return arr.tobytes()


def _jpeg_chunk(raw: bytes, info: _Info, rows: int, cols: int, ycc: bool,
                hs: int, vs: int, path) -> bytes:
    """One JPEG strip or tile (csrc/jpeg_decode.cpp): its components as
    stored, or RGB where ``ycc``; the stream's size as libtiff holds it
    (a last strip may be taller than its rows)."""
    from mods_tpu_torch.io.image import _jpeg_lib
    if info.bits != 8:
        raise _refuse(path, f"JPEG of {info.bits}-bit samples is not "
                      f"supported")
    tables = info.tags.get(347, b"")
    tables = tables if isinstance(tables, bytes) else bytes(tables)
    chans = 3 if ycc else (info.spp if info.planar == 1 else 1)
    cap = max(rows, 1) * cols * chans * 4 + (1 << 16)
    out = np.empty(cap, np.uint8)
    err = ctypes.create_string_buffer(256)
    dims = (ctypes.c_int32 * 3)()
    lib = _jpeg_lib()
    rc = lib.mods_jpeg_decode_tiff(tables, len(tables), raw, len(raw),
                                   int(ycc), hs, vs, out.ctypes.data, cap,
                                   dims, err, len(err))
    _check(rc, err, path)
    jw, jh, nc = dims[0], dims[1], dims[2]
    if nc != chans:
        raise _refuse(path, f"JPEG stream of {nc} components where the "
                      f"file has {chans}: PIL refuses it")
    if jw != cols or jh < rows:
        raise _refuse(path, f"JPEG stream of {jw}x{jh} pixels where the "
                      f"file has {cols}x{rows}: PIL refuses it")
    return out[:jw * rows * nc].tobytes()


def _chunks(info: _Info, path):
    """The strips or tiles as libtiff reads them: (offset, byte count,
    rows, columns of the stored chunk, top, left, plane)."""
    tags, w, h = info.tags, info.w, info.h
    planes = info.spp if info.planar == 2 else 1
    if 322 in tags or 324 in tags:
        tw, th = tags.get(322, (0,))[0], tags.get(323, (0,))[0]
        offsets, counts = tags.get(324), tags.get(325)
        if tw <= 0 or th <= 0:
            raise _refuse(path, "without tile dimensions is not supported")
        if tw * th > 2 * _MAX_PIXELS:
            raise _refuse(path, f"of {tw}x{th} tiles: PIL refuses it "
                          f"(libtiff cannot allocate a tile)")
        grid = [(ty * th, tx * tw, th, tw) for ty in range(-(-h // th))
                for tx in range(-(-w // tw))]
    else:
        rps = tags.get(278, (h,))[0]
        rps = h if rps <= 0 or rps > h else rps
        offsets, counts = tags.get(273), tags.get(279)
        grid = [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]
    if offsets is None or counts is None:
        raise ValueError(f"{path}: TIFF without strip or tile offsets and "
                         f"byte counts")
    out = []
    for plane in range(planes):
        for j, (y0, x0, rows, cols) in enumerate(grid):
            k = plane * len(grid) + j
            if k >= len(offsets) or k >= len(counts):
                raise ValueError(f"{path}: TIFF has fewer strips or tiles "
                                 f"than its image needs")
            out.append((offsets[k], counts[k], rows, cols, y0, x0, plane))
    return out


def _read_libtiff(data: bytes, info: _Info, path) -> np.ndarray:
    """PIL's libtiff decoder (TiffDecode.c) on a compressed file."""
    if info.fill == 2:
        key = info.key[:3] + (1,) + info.key[4:]
        info.mode, info.rawmode = OPEN_INFO[key]
    rawmode = info.rawmode
    jpeg_rgb = info.photo == 6 and info.comp == 7 and info.planar == 1
    if jpeg_rgb:
        rawmode = "RGB"
    elif rawmode == "I;16":
        rawmode = "I;16N"
    elif rawmode.endswith((";16B", ";16L")):
        rawmode = rawmode[:-1] + "N"
    if info.photo == 6 and not jpeg_rgb:
        return _read_rgba(data, info, path, rawmode)
    planar = info.planar == 2 and info.spp > 1
    tiled = 322 in info.tags or 324 in info.tags
    alpha_untagged = info.photo == 2 and info.spp > 3 and not info.key[5]
    if planar and (alpha_untagged or not (
            rawmode in _PLANAR_LIBTIFF or
            tiled and rawmode in _PLANAR_LIBTIFF_TILES)):
        # TiffDecode.c's planes: PIL reads these as it reads the same
        # pixels interleaved, and misreads or refuses the others
        raise _refuse(path, f"planar configuration 2 in raw mode {rawmode}"
                      f"{' in strips' if not tiled else ''} with extra "
                      f"samples {info.key[5]}: PIL misreads it or refuses "
                      f"it")
    bits = info.bits
    size = max(1, bits // 8)
    per = 1 if planar else info.spp
    out = _new(info.mode, info.h, info.w)
    if planar:                # the planes interleaved, then unpacked
        inter = np.zeros((info.h, info.w, info.spp, size), np.uint8)
    if info.comp == 7:
        hs, vs = _jpeg_subsampling(data, info, path) if jpeg_rgb else (1, 1)
    for offset, count, rows, cols, y0, x0, plane in _chunks(info, path):
        raw = data[offset:offset + count]
        row_bytes = -(-cols * per * bits // 8)
        if info.comp == 7:
            buf = _jpeg_chunk(raw, info, rows, cols, jpeg_rgb, hs, vs, path)
            row_bytes = cols * (3 if jpeg_rgb else per)
        else:
            buf = _decode_chunk(raw, info, rows * row_bytes, rows, cols,
                                row_bytes, per, path, offset=offset)
        r = np.frombuffer(buf, np.uint8, rows * row_bytes).reshape(
            rows, row_bytes)
        vis_rows = min(rows, info.h - y0)
        vis_cols = min(cols, info.w - x0)
        if planar:
            inter[y0:y0 + vis_rows, x0:x0 + vis_cols, plane] = \
                r[:vis_rows, :vis_cols * size].reshape(vis_rows, vis_cols,
                                                       size)
            continue
        v = _unpack(rawmode, r[:vis_rows], vis_cols, path)
        out[y0:y0 + vis_rows, x0:x0 + vis_cols] = v
    if planar:
        out[:] = _unpack(rawmode, inter.reshape(info.h, -1), info.w, path)
    return out


def _jpeg_subsampling(data: bytes, info: _Info, path) -> tuple[int, int]:
    """YCbCrSubsampling, or where the tag is absent what libtiff's
    JPEGFixupTags reads from the first strip's or tile's frame header."""
    if 530 in info.tags:
        t = info.tags[530]
        return t[0], t[1] if len(t) > 1 else t[0]
    offset, count = _chunks(info, path)[0][:2]
    raw = data[offset:offset + count]
    pos = 2
    while pos + 4 <= len(raw):
        if raw[pos] != 0xFF:
            pos += 1
            continue
        m = raw[pos + 1]
        if m == 0xFF or 0xD0 <= m <= 0xD8 or m == 0x01:
            pos += 1 if m == 0xFF else 2
            continue
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            hv = raw[pos + 11] if pos + 11 < len(raw) else 0x22
            return hv >> 4, hv & 15
        pos += 2 + int.from_bytes(raw[pos + 2:pos + 4], "big")
    return 2, 2


def _read_rgba(data: bytes, info: _Info, path, rawmode: str,
               sub=None, decoded=None) -> np.ndarray:
    """libtiff's RGBA interface on YCbCr, as TiffDecode.c's
    _decodeAsRGBA calls it: each strip's or tile's sampling blocks through
    the integer YCbCr tables, then PIL's raw mode over the RGBA pixels.
    Old-style JPEG gives its subsampling ``sub`` and each chunk's blocks
    ``decoded``."""
    if info.bits != 8 or info.spp != 3:
        raise _refuse(path, f"YCbCr of {info.spp} {info.bits}-bit samples: "
                      f"PIL refuses it (libtiff's RGBA interface cannot "
                      f"read it)")
    tags = info.tags
    hs, vs = sub or ((tags[530][0], tags[530][1] if len(tags[530]) > 1 else
                      tags[530][0]) if 530 in tags else (2, 2))
    if info.planar == 2 and (hs, vs) != (1, 1):
        raise _refuse(path, f"YCbCr in planar configuration 2 subsampled "
                      f"{hs}x{vs}: PIL refuses it (libtiff reads 1x1 only)")
    luma = np.array(tags.get(529, (0.299, 0.587, 0.114))[:3], np.float32)
    rbw = np.array(tags.get(532, (0.0, 255.0, 128.0, 255.0, 128.0,
                                  255.0))[:6], np.float32)
    if len(luma) < 3 or len(rbw) < 6:
        raise ValueError(f"{path}: TIFF YCbCrCoefficients or "
                         f"ReferenceBlackWhite too short")
    rgb = np.zeros((info.h, info.w, 3), np.uint8)
    block = hs * vs + 2
    chunks = _chunks(info, path)
    if info.planar == 2:
        groups = {}
        for c in chunks:
            groups.setdefault((c[4], c[5]), []).append(c)
        todo = [sorted(g, key=lambda c: c[6]) for g in groups.values()]
    else:
        todo = [[c] for c in chunks]
    err = ctypes.create_string_buffer(256)
    keep, keep_row = bytearray(), -1
    tiled = 322 in tags or 324 in tags
    for k, group in enumerate(todo):
        _, _, rows, cols, y0, x0, _ = group[0]
        if info.planar == 2:
            planes = []
            for offset, count, *_ in group:
                raw = data[offset:offset + count]
                planes.append(np.frombuffer(_decode_any(
                    raw, info, rows, cols, cols, 1, path), np.uint8))
            buf = np.stack(planes, -1).tobytes()
        else:
            offset, count = group[0][:2]
            raw = data[offset:offset + count]
            size = -(-cols // hs) * -(-rows // vs) * block
            # gtStripContig and gtTileContig go on past a short strip or
            # tile (stoponerr 0) with the rest of their buffer as the
            # last chunk left it: zeros at each call, one call a strip or
            # a row of tiles
            if y0 != keep_row:
                keep, keep_row = bytearray(), y0
            if tiled:
                need, row_bytes = size, cols * 3       # TIFFTileRowSize
            else:
                # gtStripContig reads its rows (rounded up to whole
                # sampling rows) times TIFFScanlineSize, a block row's
                # bytes / vs rounded down: 4x4 blocks lose bytes there
                row_bytes = -(-cols // hs) * block // vs
                need = min(size, -(-rows // vs) * vs * row_bytes)
            got = _decode_any(raw, info, need // row_bytes, cols, row_bytes,
                              3, path, need) if decoded is None else \
                decoded[k][:need]
            if len(keep) < size:
                keep.extend(bytes(size - len(keep)))
            keep[:len(got)] = got
            buf = bytes(keep[:size])
        vis_rows, vis_cols = min(rows, info.h - y0), min(cols, info.w - x0)
        tile = np.zeros((vis_rows, vis_cols, 3), np.uint8)
        _check(_lib().mods_ycbcr_to_rgb(
            buf, len(buf), cols, vis_cols, vis_rows, hs, vs,
            luma.ctypes.data, rbw.ctypes.data, tile.ctypes.data,
            vis_cols * 3, err, len(err)), err, path)
        rgb[y0:y0 + vis_rows, x0:x0 + vis_cols] = tile
    if rawmode != "RGBX":
        raise _refuse(path, f"YCbCr in raw mode {rawmode} is not supported")
    return rgb


def _decode_any(raw, info, rows, cols, row_bytes, samples, path, need=None):
    need = rows * row_bytes if need is None else need
    if info.comp == 7:
        return _jpeg_chunk(raw, info, rows, cols, False, 1, 1, path)[:need]
    return _decode_chunk(raw, info, need, rows, cols, row_bytes, samples,
                         path, short_ok=True)


# ---------------------------------------------------------------------------
# old-style JPEG (compression 6): libtiff 4.7's tif_ojpeg.c

# the frames that OJPEGReadHeaderInfoSec takes: SOF0, SOF1, SOF3
_OJPEG_SOF = (0xC0, 0xC1, 0xC3)


def _ojpeg_error(path, what: str) -> ValueError:
    return _refuse(path, f"old-style JPEG {what}: PIL refuses it")


class _OJpeg:
    """What tif_ojpeg.c reads of a file, and the stream that its
    OJPEGWriteStream hands to libjpeg: TIFFReadDirectory's repairs (a
    missing or RGB photometric interpretation is YCbCr; 3 samples by
    default), OJPEGSubsamplingCorrect (the frame's sampling wins over
    YCbCrSubsampling), OJPEGReadHeaderInfo (the strips or tiles as one
    stream, a restart interval each) and OJPEGReadHeaderInfoSec (the
    markers of JPEGInterchangeFormat or of the first strip, else the
    tables of tags 519-521)."""

    def __init__(self, data: bytes, info: _Info, path):
        tags, self.path = info.tags, path
        photo = tags.get(262, (6,))[0]
        self.photo = 6 if photo == 2 else photo
        self.spp = tags.get(277, (3 if self.photo == 6 else 1,))[0]
        self.tiled = 322 in tags or 324 in tags
        self.chunks = chunks = _chunks(info, path)
        if self.tiled:
            self.strile_w, self.strile_h = tags[322][0], tags[323][0]
            total = -(-info.h // self.strile_h) * self.strile_h
        else:
            self.strile_w, self.strile_h = info.w, chunks[0][2]
            total = info.h
        self.strile_h_total, self.info = total, info
        # the bytes in_buffer reads: JPEGInterchangeFormat, then each strip
        # or tile (a zero offset, or one past the end, reads nothing; a zero
        # byte count reads to the end of the file)
        size = len(data)
        jif = tags.get(513, (0,))[0]
        jif_len = tags.get(514, (0,))[0]
        if jif >= size:
            jif = jif_len = 0
        elif jif and (jif_len == 0 or jif + jif_len > size):
            jif_len = size - jif
        self.parts = [data[jif:jif + jif_len] if jif else b""]
        for offset, count, *_ in chunks:
            if offset == 0 or offset >= size:
                self.parts.append(None)
                continue
            end = size if count == 0 else min(size, offset + count)
            self.parts.append(data[offset:end])
        self.data = data
        sub = tags.get(530, (2, 2))
        self.hs, self.vs = sub[0], sub[1] if len(sub) > 1 else sub[0]
        self.force = False
        self.restart = tags.get(515, (0,))[0] & 0xFFFF
        self.qt, self.dc, self.ac = [None] * 4, [None] * 4, [None] * 4
        self.sof, self.sos = None, [(0, 0)] * 3
        self._correct()

    # in_buffer: the parts read one after another
    def _reader(self):
        self.flat = b"".join(p for p in self.parts if p)
        self.ends = np.cumsum([len(p) if p else 0 for p in self.parts])
        self.pos = 0

    def _byte(self):
        if self.pos >= len(self.flat):
            raise EOFError
        self.pos += 1
        return self.flat[self.pos - 1]

    def _word(self):
        return self._byte() << 8 | self._byte()

    def _block(self, n):
        if self.pos + n > len(self.flat):
            raise EOFError
        self.pos += n
        return self.flat[self.pos - n:self.pos]

    def _skip(self, n):
        # OJPEGReadSkip does not cross into the next strip
        end = int(self.ends[np.searchsorted(self.ends, self.pos,
                                            side="right")]) \
            if self.pos < len(self.flat) else self.pos
        self.pos = min(self.pos + n, end)

    def _correct(self):
        """OJPEGSubsamplingCorrect."""
        if self.spp != 3 or self.photo not in (6, 10):
            self.hs = self.vs = 1
            return
        try:
            self._markers(correct=True)
        except (EOFError, ValueError):
            pass                    # the first pass gives up quietly
        if self.force:
            self.hs = self.vs = 1

    def read_header(self):
        """OJPEGReadHeaderInfo and OJPEGReadHeaderInfoSec."""
        path = self.path
        if self.spp == 1:
            self.hs = self.vs = 1
        elif self.spp != 3:
            raise _ojpeg_error(path, f"of {self.spp} samples per pixel "
                               f"(libtiff reads 1 or 3)")
        self.per_plane = 1 if self.spp == 1 or self.info.planar == 2 else 3
        if self.strile_h < self.info.h:
            if self.hs not in (1, 2, 4) or self.vs not in (1, 2, 4):
                raise _ojpeg_error(path, f"subsampled {self.hs}x{self.vs} "
                                   f"in several strips (libtiff: invalid "
                                   f"subsampling values)")
            if self.strile_h % (self.vs * 8):
                raise _ojpeg_error(path, f"in strips or tiles of "
                                   f"{self.strile_h} rows, subsampled "
                                   f"{self.hs}x{self.vs} (libtiff: "
                                   f"incompatible vertical subsampling and "
                                   f"image strip/tile length)")
            self.restart = -(-self.strile_w // (self.hs * 8)) * (
                self.strile_h // (self.vs * 8))
        try:
            self._markers(correct=False)
        except EOFError:
            raise _ojpeg_error(path, "whose JPEG header ends early "
                               "(libtiff's OJPEGReadHeaderInfoSec fails)") \
                from None
        if self.sof is None:
            self._tables()

    def _markers(self, correct: bool):
        """OJPEGReadHeaderInfoSec's loop over the markers (with ``correct``,
        its first pass for OJPEGSubsamplingCorrect, to the frame)."""
        self._reader()
        path = self.path
        while True:
            if self.pos >= len(self.flat):
                raise EOFError
            m = self.flat[self.pos]
            if m != 0xFF:
                return
            self.pos += 1
            while m == 0xFF:
                m = self._byte()
            if m == 0xD8:
                continue
            if m == 0xFE or 0xE0 <= m <= 0xEF:
                n = self._word()
                if n < 2:
                    raise _ojpeg_error(path, "with corrupt JPEG data")
                self._skip(n - 2)
            elif m == 0xDD:
                if self._word() != 4:
                    raise _ojpeg_error(path, "with a corrupt DRI marker")
                self.restart = self._word()
            elif m in (0xDB, 0xC4):
                n = self._word()
                kind = "DQT" if m == 0xDB else "DHT"
                if n <= 2:
                    raise _ojpeg_error(path, f"with a corrupt {kind} marker")
                if correct:
                    self._skip(n - 2)
                elif m == 0xDB:
                    n -= 2
                    while n > 0:
                        if n < 65:
                            raise _ojpeg_error(path, "with a corrupt DQT "
                                               "marker")
                        t = self._block(65)
                        if t[0] & 15 > 3:
                            raise _ojpeg_error(path, "with a corrupt DQT "
                                               "marker")
                        self.qt[t[0] & 15] = b"\xff\xdb\x00\x43" + t
                        n -= 65
                else:
                    t = self._block(n - 2)
                    seg = b"\xff\xc4" + n.to_bytes(2, "big") + t
                    if t[0] >> 4 not in (0, 1) or t[0] & 15 > 3:
                        raise _ojpeg_error(path, "with a corrupt DHT marker")
                    (self.ac if t[0] >> 4 else self.dc)[t[0] & 15] = seg
            elif m in _OJPEG_SOF:
                self._frame(m, correct)
                if correct:
                    return
            elif m == 0xDA:
                if correct:
                    return
                self._scan()
                return
            else:
                raise _ojpeg_error(path, f"with a JPEG marker 0x{m:02X} "
                                   f"that libtiff does not take (unknown "
                                   f"marker type)")

    def _frame(self, marker: int, correct: bool):
        """OJPEGReadHeaderInfoSecStreamSof."""
        path = self.path
        if self.sof is not None:
            raise _ojpeg_error(path, "with two JPEG frames")
        n = self._word()
        if n < 11 or (n - 8) % 3:
            raise _ojpeg_error(path, "with a corrupt SOF marker")
        n = (n - 8) // 3
        if not correct and n != self.spp:
            raise _ojpeg_error(path, f"whose JPEG frame has {n} components "
                               f"for {self.spp} samples")
        if self._byte() != 8:
            raise _ojpeg_error(path, "whose JPEG frame is not of 8-bit "
                               "samples")
        y, x = self._word(), self._word()
        if not correct:
            info = self.info
            if y < info.h and y < self.strile_h_total:
                raise _ojpeg_error(path, f"whose JPEG frame of {y} rows is "
                                   f"shorter than the image")
            if x < info.w and x < self.strile_w:
                raise _ojpeg_error(path, f"whose JPEG frame of {x} columns "
                                   f"is narrower than the image")
            if x > self.strile_w:
                raise _ojpeg_error(path, f"whose JPEG frame of {x} columns "
                                   f"is wider than a strip or tile")
        if self._byte() != n:
            raise _ojpeg_error(path, "with a corrupt SOF marker")
        comps = [tuple(self._block(3)) for _ in range(n)]
        if correct:
            hv = comps[0][1]
            self.hs, self.vs = hv >> 4, hv & 15
            self.force = self.hs not in (1, 2, 4) or self.vs not in (
                1, 2, 4) or any(c[1] != 0x11 for c in comps[1:])
            return
        if not self.force:
            want = [self.hs << 4 | self.vs] + [0x11] * (n - 1)
            if [c[1] for c in comps] != want:
                raise _ojpeg_error(path, f"whose JPEG sampling factors "
                                   f"{[c[1] >> 4 for c in comps]}x"
                                   f"{[c[1] & 15 for c in comps]} are not "
                                   f"{self.hs}x{self.vs} (libtiff: "
                                   f"unexpected subsampling values)")
        self.sof = (marker, y, x, comps)

    def _scan(self):
        """OJPEGReadHeaderInfoSecStreamSos."""
        path = self.path
        if self.sof is None:
            raise _ojpeg_error(path, "with a corrupt SOS marker")
        if self._word() != 6 + 2 * self.per_plane or \
                self._byte() != self.per_plane:
            raise _ojpeg_error(path, "with a corrupt SOS marker")
        self.sos = [tuple(self._block(2)) for _ in range(self.per_plane)]
        self._block(3)

    def _tables(self):
        """OJPEGReadHeaderInfoSecTables{Q,Dc,Ac}Table: the frame and scan
        headers from the tags, the tables from the offsets of 519-521."""
        tags, data, path, spp = self.info.tags, self.data, self.path, self.spp

        def offsets(tag):
            v = tags.get(tag, ())
            v = v if 0 < len(v) <= 3 else ()     # more than 3: not set
            return [v[i] if i < len(v) else 0 for i in range(spp)]

        def read(at, n):
            if at + n > len(data):
                raise _ojpeg_error(path, "whose JPEG tables run past the "
                                   "end of the file")
            return data[at:at + n]

        tq, tda = [0] * spp, [0] * spp
        for tag, name in ((519, "QTables"), (520, "DcTables"),
                          (521, "AcTables")):
            offs = offsets(tag)
            if offs[0] == 0:
                raise _ojpeg_error(path, "without JPEG tables (libtiff: "
                                   "missing JPEG tables)")
            for m in range(spp):
                if offs[m] == 0 or (m and offs[m] == offs[m - 1]):
                    if tag == 519:
                        tq[m] = tq[m - 1]
                    elif tag == 520:
                        tda[m] = tda[m - 1]
                    else:
                        tda[m] |= tda[m - 1] & 15
                    continue
                if m == 2 and offs[2] == offs[0]:
                    raise _ojpeg_error(path, f"with a corrupt Jpeg{name} "
                                       f"tag value")
                if tag == 519:
                    self.qt[m] = b"\xff\xdb\x00\x43" + bytes([m]) + read(
                        offs[m], 64)
                    tq[m] = m
                    continue
                counts = read(offs[m], 16)
                q = sum(counts)
                seg = bytes([tag - 520 << 4 | m]) + counts + read(
                    offs[m] + 16, q)
                (self.dc if tag == 520 else self.ac)[m] = \
                    b"\xff\xc4" + (19 + q).to_bytes(2, "big") + seg
                tda[m] = m << 4 if tag == 520 else tda[m] | m
        hv = [self.hs << 4 | self.vs] + [0x11] * (spp - 1)
        self.sof = (0xC0, self.strile_h_total, self.strile_w,
                    [(c, hv[c], tq[c]) for c in range(spp)])
        self.sos = [(c, tda[c]) for c in range(spp)]

    def stream(self) -> bytes:
        """OJPEGWriteStream: SOI, the tables, DRI, SOF, SOS, the rest of
        the bytes read with an RSTn after each strip or tile but the last,
        EOI."""
        marker, y, x, comps = self.sof
        n = self.per_plane
        head = [b"\xff\xd8"] + [t for t in self.qt + self.dc + self.ac if t]
        if self.restart:
            head.append(b"\xff\xdd\x00\x04" + self.restart.to_bytes(2, "big"))
        head.append(bytes([0xFF, marker, 0, 8 + 3 * n, 8]) +
                    y.to_bytes(2, "big") + x.to_bytes(2, "big") +
                    bytes([n]) + b"".join(bytes(c) for c in comps[:n]))
        head.append(bytes([0xFF, 0xDA, 0, 6 + 2 * n, n]) +
                    b"".join(bytes(s) for s in self.sos[:n]) + b"\x00\x3f\x00")
        body, rst, start = [], 0, 0
        last = len(self.parts) - 1
        for k, part in enumerate(self.parts):
            end = start + (len(part) if part else 0)
            if part and end > self.pos:
                body.append(self.flat[max(start, self.pos):end])
                if k and k < last:
                    body.append(bytes([0xFF, 0xD0 + rst]))
                    rst = (rst + 1) % 8
            start = end
        return b"".join(head + body) + b"\xff\xd9"


def _ojpeg_decode(stream: bytes, raw: bool, path):
    """libjpeg on the rebuilt stream (csrc/jpeg_decode.cpp): the
    components' planes as raw_data_out leaves them, or the (h, w, 1)
    samples of one component that jpeg_read_scanlines gives; and the row
    of MCUs where a wrong restart marker stopped it, or None."""
    from mods_tpu_torch.io.image import _jpeg_lib
    lib = _jpeg_lib()
    err = ctypes.create_string_buffer(256)
    info = (ctypes.c_int32 * 21)()
    _check(lib.mods_jpeg_decode_ojpeg(stream, len(stream), int(raw), None, 0,
                                      info, err, len(err)), err, path)
    w, h, n = info[0], info[1], info[2]
    comps = [tuple(info[3 + 4 * i:7 + 4 * i]) for i in range(n)]
    cap = sum(bw * bh * 64 for _, _, bw, bh in comps) if raw else w * h * n
    out = np.empty(max(cap, 1), np.uint8)
    _check(lib.mods_jpeg_decode_ojpeg(stream, len(stream), int(raw),
                                      out.ctypes.data, cap, info, err,
                                      len(err)), err, path)
    # the first row of whole MCUs that a wrong restart marker left undone
    fail = info[19] // info[20] if info[19] >= 0 else None
    if not raw:
        return out[:w * h * n].reshape(h, w, n), fail
    planes, at = [], 0
    for _, _, bw, bh in comps:
        planes.append(out[at:at + bw * bh * 64].reshape(bh * 8, bw * 8))
        at += bw * bh * 64
    return planes, fail


def _read_ojpeg(data: bytes, info: _Info, path) -> np.ndarray:
    """PIL's libtiff decoder on an old-style JPEG file: one sample of a
    photometric interpretation other than YCbCr through libtiff's strips
    or tiles (jpeg_read_scanlines), or YCbCr through its RGBA interface
    (the components as libjpeg's raw_data_out leaves them, in libtiff's
    sampling blocks)."""
    tags = info.tags
    if info.planar == 2 and 322 not in tags and 324 not in tags and \
            len(tags.get(273, ())) == 1 and len(tags.get(279, ())) == 1:
        # TIFFReadDirectory's "OJPEG hack": one strip offset and one byte
        # count mean that the planar configuration tag is wrong
        info.planar = 1
    if info.planar == 2 and info.spp > 1:
        # libtiff decodes each plane as a stream of its own (one SOS a
        # plane, an Ls of 8): the file's one interleaved stream fails, or
        # in the tables form decodes to other samples than the image's
        raise _refuse(path, "old-style JPEG in planar configuration 2 over "
                      "more than one strip or tile offset, or without "
                      "StripByteCounts: PIL misreads it or refuses it "
                      "(libtiff decodes each plane as a JPEG stream of its "
                      "own)")
    oj = _OJpeg(data, info, path)
    if oj.photo == 6 and oj.spp != 3:
        raise _ojpeg_error(path, f"YCbCr of {oj.spp} samples (libtiff's "
                           f"directory is refused)")
    if oj.photo != 6 and (oj.spp != 1 or info.spp != 1):
        raise _ojpeg_error(path, f"of photometric interpretation "
                           f"{oj.photo} with {oj.spp} samples (PIL's mode "
                           f"{info.mode} is not what libtiff decodes)")
    oj.read_header()
    if oj.force:
        # libtiff decodes such a stream upsampled, as 1x1, and then finds
        # that libjpeg's largest sampling factors are not 1
        raise _ojpeg_error(path, "whose JPEG sampling factors libtiff "
                           "cannot take as YCbCr subsampling (libtiff: "
                           "unexpected max_h/v_samp_factor)")
    stream = oj.stream()
    chunks = oj.chunks
    # the first line that libtiff reads for each strip or tile: the stream
    # is read on from one to the next, but in a file of the other byte
    # order the BitsPerSample tag replaces OJPEGPostDecode by
    # _TIFFNoPostDecode, so OJPEGPreDecode skips one strip or tile more
    # before each after the first
    swab = info.bo != ("<" if _HOST else ">")
    starts = [k * (2 if swab and k else 1) for k in range(len(chunks))]
    raw = oj.spp == 3
    planes, fail = _ojpeg_decode(stream, raw, path)
    if raw:
        lines = _ojpeg_block_rows(planes, oj)
        per, width = -(-oj.strile_h // oj.vs), lines.shape[1]
    else:
        lines = planes.reshape(planes.shape[0], -1)
        per, width = oj.strile_h, oj.strile_w
    # the first line that the failed restart leaves unwritten
    fail = np.inf if fail is None else fail * (8 if raw else 8 * oj.vs)
    buf = np.zeros((per, width), np.uint8)
    got = []
    for k, (_, _, rows, cols, y0, x0, _) in enumerate(chunks):
        want = per if oj.tiled else -(-rows // oj.vs) if raw else rows
        idx = starts[k] * per + np.arange(want)
        if idx[-1] >= fail and (not raw or swab and k):
            # PIL fails where libtiff's strip read fails, and where a read
            # of a file of the other byte order skips on from a failure
            # (through libjpeg's broken state)
            raise _ojpeg_error(path, "whose JPEG stream has a wrong restart "
                               "marker (libtiff: unexpected error)")
        if raw:
            # a read past the stream's end (libjpeg's JWRN_TOO_MUCH_DATA)
            # leaves libtiff's buffer of the last iMCU row as it was; a
            # failed read (and every one after it) is zeroed by
            # TIFFReadEncodedStrip
            if idx[-1] >= fail:
                got.append(bytes(want * width))
                continue
            last = len(lines) - 8
            got.append(lines[np.where(idx < len(lines), idx,
                                      last + idx % 8)].tobytes())
            continue
        # a line past the stream's end is not written: PIL's strip or tile
        # buffer keeps what the last read left there
        ok = idx < len(lines)
        n = min(width, lines.shape[1])
        buf[np.nonzero(ok)[0], :n] = lines[idx[ok], :n]
        got.append(buf[:want].tobytes())
    if oj.spp == 1:
        out = _new("L", info.h, info.w)
        for (_, _, rows, cols, y0, x0, _), g in zip(chunks, got):
            v = np.frombuffer(g, np.uint8).reshape(-1, width)
            vr, vc = min(rows, info.h - y0), min(cols, info.w - x0)
            out[y0:y0 + vr, x0:x0 + vc] = v[:vr, :vc]
        return out
    return _read_rgba(data, info, path, info.rawmode, (oj.hs, oj.vs), got)


def _ojpeg_block_rows(planes, oj: _OJpeg) -> np.ndarray:
    """OJPEGDecodeRaw's rows of sampling blocks (hs x vs Y samples, then Cb
    and Cr), strile_w wide, of the whole stream: the last 8 are libtiff's
    buffer of the last iMCU row as jpeg_read_raw_data leaves it, where the
    dummy blocks below the image are not written and keep the iMCU row
    before."""
    hs, vs = oj.hs, oj.vs
    per_row = -(-oj.strile_w // hs)
    sof_y = oj.sof[1]
    n = planes[0].shape[0] // (8 * vs)            # iMCU rows
    out = []
    for p, v, h, width in (
            (planes[0], vs, sof_y, per_row * hs),
            (planes[1], 1, -(-sof_y // vs), per_row),
            (planes[2], 1, -(-sof_y // vs), per_row)):
        p = p.copy()
        rows = 8 * v                               # an iMCU row's
        dummy = np.arange((n - 1) * rows, n * rows) >= -(-h // 8) * 8
        p[(n - 1) * rows:][dummy] = p[(n - 2) * rows:(n - 1) * rows][
            dummy] if n > 1 else 0
        if p.shape[1] < width:
            p = np.pad(p, ((0, 0), (0, width - p.shape[1])))
        out.append(p[:, :width])
    y, cb, cr = out
    nb = len(cb)
    y = y.reshape(nb, vs, per_row, hs).transpose(0, 2, 1, 3).reshape(
        nb, per_row, vs * hs)
    return np.concatenate([y, cb[..., None], cr[..., None]], -1).reshape(
        nb, -1)
