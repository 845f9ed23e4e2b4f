"""The formats that PIL 12.1.0 opens by probing a file's content, read as
the JAX commands read them (``np.asarray(Image.open(path))``): SPIDER,
GBR, XVTHUMB, IMT, FLI, FTEX, McIdas, PCD, IPTC and PIXAR.  PIL writes
none of them by extension.

Each ``*_header(data, path)`` is its plugin's ``_open`` run over the bytes,
as ``Image.open`` runs it: it returns the size and mode that
``Image.open`` reports, raises ``NotThisFormat`` where the plugin fails in
a way that makes ``Image.open`` try the next one (``SyntaxError``, and the
``IndexError``, ``TypeError``, ``KeyError``, ``EOFError`` and
``struct.error`` that ``ImageFile`` turns into it, or no mode or size),
and a ``ValueError`` naming PIL's error where ``Image.open`` fails
outright.  ``read_*(data, path)`` returns PIL's array and mode.

* SPIDER (SpiderImagePlugin): 27 floats, big-endian first; a 2-D image
  ("F") or a stack's first image; 32-bit floats of the header's order.
* GBR (GbrImagePlugin): a GIMP brush, version 1 or 2, depth 1 ("L") or 4
  ("RGBA"), read with ``frombytes``.
* XVTHUMB (XVThumbImagePlugin): "P7 332", comment lines, then the size;
  "P" indices.
* IMT (ImtImagePlugin): ``key value`` text lines up to a form feed;
  "L" raw.
* FLI (FliImagePlugin): frame 0's indices ("P"), its chunks decoded by
  ``csrc/raster_codec.cpp::mods_fli_decode`` (FliDecode.c).
* FTEX (FtexImagePlugin): format 0 DXT1 ("RGBA", ``csrc/bcn_decode.cpp``),
  format 1 raw "RGB".
* McIdas (McIdasImagePlugin): 1, 2 or 4 bytes a pixel ("L", "I;16B", "I"
  from big-endian), with the stride and offset of area words 10-15 and 34.
* PCD (PcdImagePlugin): the 768x512 base image at 96 * 2048 through
  ``csrc/raster_codec.cpp::mods_pcd_decode`` (PcdDecode.c and the "YCC;P"
  unpacker), turned as byte 1538 of sector 1 says.
* IPTC (IptcImagePlugin): the records up to (8, 10); its data, raw bands
  (as a PGM) or a JPEG, opened again by ``Image.open``: ``reopen`` is
  ``io/image.py``'s reader of bytes, so a JPEG goes through its rules.
* PIXAR (PixarImagePlugin): channels and depth (14, 2) at bytes 424 and
  426 make "RGB" at byte 1024; any other pair leaves no mode.

Raw tiles follow ``ImageFile.load``: "L", "P" and "I;16B" tiles whose
raw mode is the mode are memory-mapped (a file too short for the map
raises PIL's "buffer is not large enough"), the rest decoded by
RawDecode.c (a file too short: "image file is truncated").
"""

from __future__ import annotations

import io
import re
import struct

import numpy as np

from mods_tpu_torch.io import raster
from mods_tpu_torch.io.raster import NotThisFormat

# the exceptions that ImageFile turns into SyntaxError, which Image.open
# takes as "not this format"
_PASS_ON = (SyntaxError, IndexError, TypeError, KeyError, EOFError,
            struct.error)


def _probe(fmt: str, open_, data: bytes, path) -> dict:
    """Run a transliterated ``_open`` as ``Image.open`` runs it."""
    try:
        hd = open_(io.BytesIO(data))
    except _PASS_ON as e:
        raise NotThisFormat(f"{fmt}: {e}") from e
    except Exception as e:                          # Image.open fails
        raise ValueError(f"{path}: {fmt}: PIL refuses the file "
                         f"({type(e).__name__}: {e})") from e
    w, h = hd.get("size", (0, 0))
    if not hd.get("mode") or w <= 0 or h <= 0:
        raise NotThisFormat(f"{fmt}: no mode or size")
    return hd


def _i32be(b: bytes, o: int = 0) -> int:
    return struct.unpack_from(">I", b, o)[0]


# raw mode -> (numpy dtype, bytes a pixel, bands)
_RAW = {"L": ("u1", 1, 1), "P": ("u1", 1, 1), "I;16B": (">u2", 2, 1),
        "I;32B": (">i4", 4, 1), "RGB": ("u1", 3, 3), "F;32BF": (">f4", 4, 1),
        "F;32F": ("<f4", 4, 1)}
# the array's dtype for PIL's mode, where it is not the raw one
_OUT = {"I": "<i4", "F": "<f4"}
_MAPMODES = ("L", "P", "I;16B")


def raw_tile(data: bytes, offset: int, size: tuple, mode: str,
             rawmode: str, stride: int, path) -> np.ndarray:
    """``ImageFile.load`` of one "raw" tile (the module docstring)."""
    w, h = size
    dtype, px, bands = _RAW[rawmode]
    line = w * px
    if not -2**31 <= stride < 2**31:    # the decoder's and the map's C int
        raise ValueError(f"{path}: a stride of {stride}: PIL refuses it "
                         f"(OverflowError)")
    starts = None
    if rawmode == mode and mode in _MAPMODES:
        if offset < 0:
            raise ValueError(f"{path}: Tile offset cannot be negative: PIL "
                             f"refuses it")
        if not offset + h * stride > len(data):   # else: RawDecode below
            step = stride if stride > 0 else line
            if offset + h * step > len(data):
                raise ValueError(f"{path}: buffer is not large enough: PIL "
                                 f"refuses it")
            starts = [offset + y * step for y in range(h)]
    if starts is None:
        skip = stride - line if stride else 0
        if skip < 0:
            raise ValueError(f"{path}: bad configuration when reading image "
                             f"file: PIL refuses it")
        if offset < 0 or offset + h * line + (h - 1) * skip > len(data):
            raise ValueError(f"{path}: image file is truncated: PIL refuses "
                             f"it")
        starts = [offset + y * (line + skip) for y in range(h)]
    if starts and all(b - a == line for a, b in zip(starts, starts[1:])):
        buf = data[starts[0]:starts[0] + h * line]
    else:
        buf = b"".join(data[s:s + line] for s in starts)
    a = np.frombuffer(buf, dtype).reshape((h, w, bands) if bands > 1
                                          else (h, w))
    return a.astype(_OUT.get(mode, a.dtype))


# ---------------------------------------------------------------------------
# SPIDER

_IFORMS = (1, 3, -11, -12, -21, -22)


def _is_int(f) -> int:
    try:
        i = int(f)
        return 1 if f - i == 0 else 0
    except (ValueError, OverflowError):
        return 0


def _spider_hdrlen(t: tuple) -> int:
    """SpiderImagePlugin.isSpiderHeader."""
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        if not _is_int(h[i]):
            return 0
    if int(h[5]) not in _IFORMS:
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    if labbyt != labrec * lenbyt:
        return 0
    return labbyt


def _spider_open(fp) -> dict:
    f = fp.read(27 * 4)
    try:
        big = True
        t = struct.unpack(">27f", f)
        hdrlen = _spider_hdrlen(t)
        if hdrlen == 0:
            big = False
            t = struct.unpack("<27f", f)
            hdrlen = _spider_hdrlen(t)
        if hdrlen == 0:
            raise SyntaxError("not a valid Spider file")
    except struct.error as e:
        raise SyntaxError("not a valid Spider file") from e
    h = (99,) + t
    if int(h[5]) != 1:
        raise SyntaxError("not a Spider 2D image")
    size = int(h[12]), int(h[2])
    istack, imgnumber = int(h[24]), int(h[27])
    if istack == 0 and imgnumber == 0:
        offset = hdrlen
    elif istack > 0 and imgnumber == 0:
        offset = hdrlen * 2
    elif istack == 0 and imgnumber > 0:
        # the plugin reads self.stkoffset, which only seek() sets
        raise AttributeError("'SpiderImageFile' object has no attribute "
                             "'stkoffset'")
    else:
        raise SyntaxError("inconsistent stack header values")
    return {"size": size, "mode": "F", "offset": offset,
            "rawmode": "F;32BF" if big else "F;32F"}


def spider_header(data: bytes, path) -> dict:
    return _probe("SPIDER", _spider_open, data, path)


def read_spider(data: bytes, path) -> tuple[np.ndarray, str]:
    hd = spider_header(data, path)
    return raw_tile(data, hd["offset"], hd["size"], "F", hd["rawmode"], 0,
                    path), "F"


# ---------------------------------------------------------------------------
# GBR

def gbr_accept(prefix: bytes) -> bool:
    return (len(prefix) >= 8 and _i32be(prefix, 0) >= 20
            and _i32be(prefix, 4) in (1, 2))


def _gbr_open(fp) -> dict:
    header_size = _i32be(fp.read(4))
    if header_size < 20:
        raise SyntaxError("not a GIMP brush")
    version = _i32be(fp.read(4))
    if version not in (1, 2):
        raise SyntaxError(f"Unsupported GIMP brush version: {version}")
    width, height = _i32be(fp.read(4)), _i32be(fp.read(4))
    color_depth = _i32be(fp.read(4))
    if width == 0 or height == 0:
        raise SyntaxError("not a GIMP brush")
    if color_depth not in (1, 4):
        raise SyntaxError(f"Unsupported GIMP brush color depth: "
                          f"{color_depth}")
    if version == 1:
        comment_length = header_size - 20
    else:
        comment_length = header_size - 28
        if fp.read(4) != b"GIMP":
            raise SyntaxError("not a GIMP brush, bad magic number")
        _i32be(fp.read(4))                          # spacing
    fp.read(comment_length)
    return {"size": (width, height), "mode": "L" if color_depth == 1
            else "RGBA", "offset": fp.tell(), "depth": color_depth}


def gbr_header(data: bytes, path) -> dict:
    return _probe("GBR", _gbr_open, data, path)


def read_gbr(data: bytes, path) -> tuple[np.ndarray, str]:
    hd = gbr_header(data, path)
    (w, h), depth = hd["size"], hd["depth"]
    body = data[hd["offset"]:hd["offset"] + w * h * depth]
    if len(body) < w * h * depth:
        raise ValueError(f"{path}: GBR: not enough image data: PIL refuses "
                         f"it")
    a = np.frombuffer(body, np.uint8)
    return a.reshape((h, w, 4) if depth == 4 else (h, w)), hd["mode"]


# ---------------------------------------------------------------------------
# XVTHUMB

def _xvthumb_open(fp) -> dict:
    if not fp.read(6).startswith(b"P7 332"):
        raise SyntaxError("not an XV thumbnail file")
    fp.readline()
    while True:
        s = fp.readline()
        if not s:
            raise SyntaxError("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:                              # not a '#' comment
            break
    w, h = s.strip().split(maxsplit=2)[:2]
    return {"size": (int(w), int(h)), "mode": "P", "offset": fp.tell()}


def xvthumb_header(data: bytes, path) -> dict:
    return _probe("XVTHUMB", _xvthumb_open, data, path)


def read_xvthumb(data: bytes, path) -> tuple[np.ndarray, str]:
    hd = xvthumb_header(data, path)
    return raw_tile(data, hd["offset"], hd["size"], "P", "P", 0, path), "P"


# ---------------------------------------------------------------------------
# IMT

_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _imt_open(fp) -> dict:
    buffer = fp.read(100)
    if b"\n" not in buffer:
        raise SyntaxError("not an IM file")
    xsize = ysize = 0
    size, mode, offset = (0, 0), None, None
    while True:
        if buffer:
            s = buffer[:1]
            buffer = buffer[1:]
        else:
            s = fp.read(1)
        if not s:
            break
        if s == b"\x0c":                            # the data begins
            offset = fp.tell() - len(buffer)
            break
        if b"\n" not in buffer:
            buffer += fp.read(100)
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord(b"*"):
            continue                                # a comment
        m = _IMT_FIELD.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        if k == b"width":
            xsize = int(v)
            size = xsize, ysize
        elif k == b"height":
            ysize = int(v)
            size = xsize, ysize
        elif k == b"pixel" and v == b"n8":
            mode = "L"
    # the tile takes the size as it was at the form feed
    return {"size": size, "mode": mode, "offset": offset}


def imt_header(data: bytes, path) -> dict:
    return _probe("IMT", _imt_open, data, path)


def read_imt(data: bytes, path) -> tuple[np.ndarray, str]:
    hd = imt_header(data, path)
    if hd["offset"] is None:
        raise ValueError(f"{path}: an IMT header without its form feed: PIL "
                         f"refuses it (cannot load this image)")
    return raw_tile(data, hd["offset"], hd["size"], "L", "L", 0, path), "L"


# ---------------------------------------------------------------------------
# FLI

def _u16(b: bytes, o: int) -> int:
    return struct.unpack_from("<H", b, o)[0]


def _u32(b: bytes, o: int = 0) -> int:
    return struct.unpack_from("<I", b, o)[0]


def fli_accept(prefix: bytes) -> bool:
    return (len(prefix) >= 16 and _u16(prefix, 4) in (0xAF11, 0xAF12)
            and _u16(prefix, 14) in (0, 3))


def _fli_palette(fp, palette: list, shift: int) -> None:
    i = 0
    for _ in range(_u16(fp.read(2), 0)):
        s = fp.read(2)
        i = i + s[0]
        n = s[1] or 256
        s = fp.read(n * 3)
        for k in range(0, len(s), 3):
            palette[i] = (s[k] << shift, s[k + 1] << shift, s[k + 2] << shift)
            i += 1


def _fli_open(fp) -> dict:
    s = fp.read(128)
    if not (fli_accept(s) and s[20:22] == b"\x00" * 2
            and s[42:80] == b"\x00" * 38 and s[88:] == b"\x00" * 40):
        raise SyntaxError("not an FLI/FLC file")
    size = _u16(s, 8), _u16(s, 10)
    # the colour chunk of the first frame: PIL's array is the indices, but
    # a palette that runs past 256 entries fails the open
    palette = [(a, a, a) for a in range(256)]
    s = fp.read(16)
    if _u16(s, 4) == 0xF100:
        fp.seek(128 + _u32(s))
        s = fp.read(16)
    if _u16(s, 4) == 0xF1FA:
        chunk_size = None
        for _ in range(_u16(s, 6)):
            if chunk_size is not None:
                fp.seek(chunk_size - 6, io.SEEK_CUR)
            s = fp.read(6)
            chunk_type = _u16(s, 4)
            if chunk_type in (4, 11):
                _fli_palette(fp, palette, 2 if chunk_type == 11 else 0)
                break
            chunk_size = _u32(s)
            if not chunk_size:
                break
    # seek(0): frame 0 starts at byte 128 with its size
    fp.seek(128)
    s = fp.read(4)
    if not s:
        raise EOFError("missing frame size")
    return {"size": size, "mode": "P", "framesize": _u32(s)}


def fli_header(data: bytes, path) -> dict:
    return _probe("FLI", _fli_open, data, path)


_FLI_ERRORS = {-1: "image buffer overrun error", -3: "unknown error",
               -4: "decoding error"}


def read_fli(data: bytes, path) -> tuple[np.ndarray, str]:
    hd = fli_header(data, path)
    w, h = hd["size"]
    # ImageFile.load reads the frame's size of bytes at a time
    body = data[128:128 + hd["framesize"]]
    out = np.zeros((h, w), np.uint8)
    status = raster._codec().mods_fli_decode(body, len(body), w, h,
                                             out.ctypes.data)
    if status == -2:
        raise ValueError(f"{path}: image file is truncated: PIL refuses it")
    if status:
        raise ValueError(f"{path}: {_FLI_ERRORS[status]} when reading image "
                         f"file: PIL refuses it (FliDecode.c)")
    return out, "P"


# ---------------------------------------------------------------------------
# FTEX

def _ftex_open(fp) -> dict:
    if not fp.read(4).startswith(b"FTEX"):
        raise SyntaxError("not an FTEX file")
    struct.unpack("<i", fp.read(4))                 # version
    size = struct.unpack("<2i", fp.read(8))
    mipmap_count, format_count = struct.unpack("<2i", fp.read(8))
    if format_count != 1:
        raise AssertionError(f"{format_count} formats (the plugin asserts "
                             f"format_count == 1)")
    fmt, where = struct.unpack("<2i", fp.read(8))
    fp.seek(where)
    (mipmap_size,) = struct.unpack("<i", fp.read(4))
    start = fp.tell()
    body = fp.read(mipmap_size if mipmap_size >= 0 else -1)
    if fmt == 0:
        mode = "RGBA"
    elif fmt == 1:
        mode = "RGB"
    else:
        raise ValueError(f"Invalid texture compression format: {fmt!r}")
    return {"size": size, "mode": mode, "start": start, "length": len(body)}


def ftex_header(data: bytes, path) -> dict:
    return _probe("FTEX", _ftex_open, data, path)


def read_ftex(data: bytes, path) -> tuple[np.ndarray, str]:
    from mods_tpu_torch.io import dds
    hd = ftex_header(data, path)
    (w, h), mode = hd["size"], hd["mode"]
    body = data[hd["start"]:hd["start"] + hd["length"]]
    if mode == "RGB":
        if len(body) < w * h * 3:
            raise ValueError(f"{path}: image file is truncated: PIL refuses "
                             f"it")
        return np.frombuffer(body[:w * h * 3], np.uint8).reshape(h, w, 3), \
            mode
    out = np.empty((h, w, 4), np.uint8)             # DXT1: BcnDecode.c n=1
    if dds._bcn_lib().mods_bcn_decode(body, len(body), 1, 0, w, h,
                                      out.ctypes.data):
        raise ValueError(f"{path}: image file is truncated: PIL refuses it")
    return out, mode


# ---------------------------------------------------------------------------
# McIdas

def _mcidas_open(fp) -> dict:
    s = fp.read(256)
    if not s.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04") or len(s) != 256:
        raise SyntaxError("not an McIdas area file")
    w = [0, *struct.unpack("!64i", s)]
    if w[11] == 1:
        mode = rawmode = "L"
    elif w[11] == 2:
        mode = rawmode = "I;16B"
    elif w[11] == 4:
        mode, rawmode = "I", "I;32B"
    else:
        raise SyntaxError("unsupported McIdas format")
    return {"size": (w[10], w[9]), "mode": mode, "rawmode": rawmode,
            "offset": w[34] + w[15], "stride": w[15] + w[10] * w[11] * w[14]}


def mcidas_header(data: bytes, path) -> dict:
    return _probe("MCIDAS", _mcidas_open, data, path)


def read_mcidas(data: bytes, path) -> tuple[np.ndarray, str]:
    hd = mcidas_header(data, path)
    return raw_tile(data, hd["offset"], hd["size"], hd["mode"],
                    hd["rawmode"], hd["stride"], path), hd["mode"]


# ---------------------------------------------------------------------------
# PCD

def _pcd_open(fp) -> dict:
    fp.seek(2048)
    s = fp.read(1539)
    if not s.startswith(b"PCD_"):
        raise SyntaxError("not a PCD file")
    orientation = s[1538] & 3
    return {"size": (512, 768) if orientation in (1, 3) else (768, 512),
            "mode": "RGB", "orientation": orientation}


def pcd_header(data: bytes, path) -> dict:
    return _probe("PCD", _pcd_open, data, path)


def read_pcd(data: bytes, path) -> tuple[np.ndarray, str]:
    hd = pcd_header(data, path)
    body = data[96 * 2048:]
    out = np.empty((512, 768, 3), np.uint8)
    if raster._codec().mods_pcd_decode(body, len(body), out.ctypes.data):
        raise ValueError(f"{path}: image file is truncated: PIL refuses it")
    # load_end: rotate(90 or 270, expand=True), Transpose.ROTATE_90/270
    turn = {1: 1, 3: -1}.get(hd["orientation"], 0)
    return np.ascontiguousarray(np.rot90(out, turn)), "RGB"


# ---------------------------------------------------------------------------
# IPTC

_IPTC_COMPRESSION = {1: "raw", 5: "jpeg"}


def _iptc_int(c: bytes) -> int:
    return _i32be((b"\0\0\0\0" + c)[-4:])


def _iptc_field(fp):
    s = fp.read(5)
    if not s.strip(b"\x00"):
        return None, 0
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
        raise SyntaxError("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise OSError("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        size = _iptc_int(fp.read(size - 128))
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size


def _iptc_open(fp) -> dict:
    info: dict = {}
    while True:
        offset = fp.tell()
        tag, size = _iptc_field(fp)
        if not tag or tag == (8, 10):
            break
        tagdata = fp.read(size) if size else None
        if tag in info:
            if isinstance(info[tag], list):
                info[tag].append(tagdata)
            else:
                info[tag] = [info[tag], tagdata]
        else:
            info[tag] = tagdata
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode, band = None, None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    size = _iptc_int(info[(3, 20)]), _iptc_int(info[(3, 30)])
    try:
        compression = _IPTC_COMPRESSION[_iptc_int(info[(3, 120)])]
    except KeyError as e:
        raise OSError("Unknown IPTC image compression") from e
    return {"size": size, "mode": mode, "band": band,
            "compression": compression,
            "offset": offset if tag == (8, 10) else None}


def iptc_header(data: bytes, path) -> dict:
    return _probe("IPTC", _iptc_open, data, path)


def read_iptc(data: bytes, path, reopen) -> tuple[np.ndarray, str]:
    """IptcImageFile.load: ``reopen(bytes, path)`` is ``Image.open`` of the
    records' data, returning its array and mode."""
    hd = iptc_header(data, path)
    (w, h), mode = hd["size"], hd["mode"]
    if hd["offset"] is None:
        raise ValueError(f"{path}: IPTC without image data: PIL refuses it "
                         f"(cannot load this image)")
    fp = io.BytesIO(data)
    fp.seek(hd["offset"])
    o = io.BytesIO()
    if hd["compression"] == "raw":
        o.write(b"P5\n%d %d\n255\n" % (w, h))
    while True:
        try:
            tag, size = _iptc_field(fp)
        except (SyntaxError, IndexError, struct.error, OSError) as e:
            raise ValueError(f"{path}: IPTC: PIL refuses the file "
                             f"({type(e).__name__}: {e})") from e
        if tag != (8, 10):
            break
        o.write(fp.read(max(size, 0)))
    inner, inner_mode = reopen(o.getvalue(), path)
    if inner_mode != "L":
        raise ValueError(f"{path}: IPTC data of mode {inner_mode} in a {mode} "
                         f"image: PIL's array of it is not an image's")
    bands = {"L": 1, "RGB": 3, "CMYK": 4}[mode]
    if hd["band"] is not None:
        if not -bands <= hd["band"] < bands:
            raise ValueError(f"{path}: IPTC band {hd['band'] + 1} of a {mode} "
                             f"image: PIL refuses it (list assignment index "
                             f"out of range)")
        merged = np.zeros(inner.shape + (bands,), np.uint8)
        merged[..., hd["band"] % bands] = inner
        inner = merged
    # np.asarray reads the data's bytes in the header's shape
    flat = inner.tobytes()
    if len(flat) < w * h * bands:
        raise ValueError(f"{path}: IPTC data of {inner.shape[1]}x"
                         f"{inner.shape[0]} in an image of {w}x{h}: PIL's "
                         f"array of it runs past the data")
    shape = (h, w) if bands == 1 else (h, w, bands)
    return np.frombuffer(flat[:w * h * bands], np.uint8).reshape(shape), mode


# ---------------------------------------------------------------------------
# PIXAR

def _pixar_open(fp) -> dict:
    s = fp.read(4)
    if not s.startswith(b"\x80\xe8\x00\x00"):
        raise SyntaxError("not a PIXAR file")
    s = s + fp.read(508)
    size = _u16(s, 418), _u16(s, 416)
    mode = "RGB" if (_u16(s, 424), _u16(s, 426)) == (14, 2) else None
    return {"size": size, "mode": mode}


def pixar_header(data: bytes, path) -> dict:
    return _probe("PIXAR", _pixar_open, data, path)


def read_pixar(data: bytes, path) -> tuple[np.ndarray, str]:
    hd = pixar_header(data, path)
    return raw_tile(data, 1024, hd["size"], "RGB", "RGB", 0, path), "RGB"
