"""IFUNC Image Memory (IM) files as PIL 12.1.0 reads and writes them for
the JAX commands (``np.asarray(Image.open(path))``,
``Image.fromarray(a).save(path)``; ImImagePlugin).

``read_im(data, path)`` returns PIL's array and mode, ``im_header`` the
size and mode that ``Image.open`` reports (``NotThisFormat`` where
ImImageFile._open fails and ``Image.open`` tries the next plugin), and
``im_bytes(a, mode, path)`` the bytes of PIL's save.

* The header is text: ``key: value`` lines (``\\r\\n`` or ``\\n``, a lone
  ``\\r`` skipped, none over 100 bytes) up to a NUL or ``\\x1a`` byte, then
  anything up to the ``\\x1a`` that starts the data.  A file whose first
  100 bytes hold no ``\\n``, a line that is not ``key: value``, or a header
  without one of PIL's tags is not IM.  "Image type" names the mode and
  the raw mode (``OPEN``, a copy of the plugin's), "Image size (x*y)" the
  size (512 x 512 where it is missing); only frame 0 of "File size (no of
  images)" is read.
* A "Lut" puts 768 bytes (R, G and B planes) after the ``\\x1a``: one that
  is not gray makes an "L" or "P" image "P" (raw mode "P") and an "LA"
  image "PA" (raw mode "PA;L"); a gray one changes nothing (PIL keeps it
  as an unused ``lut`` attribute).
* The pixels are rows bottom-up, each row's bands one after another
  (the ";L" raw modes: RGB, RGBA, RGBX, CMYK, YCbCr, LA, PA), or pixel by
  pixel ("X 24"), or three whole planes G, R, B ("RGB3" and "RYB3"); 1-,
  2- and 4-bit rows MSB first; 16- and 32-bit samples little-endian but
  "L 16B"; "L*n" images of n bits a sample (n not 8, 16 or 32) are read
  by Pillow's BitDecode.c into "F".

Writing is ImImagePlugin._save: the header lines (the file's base name,
cut to 92 characters with its extension), NUL bytes up to byte 511 and
``\\x1a``, then the rows bottom-up in SAVE's raw mode; every mode of
``Image.fromarray`` is written.
"""

from __future__ import annotations

import os
import re

import numpy as np

from mods_tpu_torch.io.raster import NotThisFormat

_COMMENT, _FRAMES, _LUT, _SCALE = ("Comment", "File size (no of images)",
                                   "Lut", "Scale (x,y)")
_NAME, _SIZE, _MODE = "Name", "Image size (x*y)", "Image type"
_TAGS = ("Comment", "Date", "Digitalization equipment", _FRAMES, _LUT, _NAME,
         _SCALE, _SIZE, _MODE)

# ImImagePlugin.OPEN: "Image type" -> (mode, raw mode)
OPEN = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"),
        "Greyscale image": ("L", "L"), "Grayscale image": ("L", "L"),
        "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
        "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"),
        "B2 image": ("P", "P;2"), "B4 image": ("P", "P;4"),
        "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
        "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
        "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"),
        "PA image": ("LA", "PA;L"), "RGBA image": ("RGBA", "RGBA;L"),
        "RGBX image": ("RGB", "RGBX;L"), "CMYK image": ("CMYK", "CMYK;L"),
        "YCC image": ("YCbCr", "YCbCr;L")}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")

# (mode, raw mode) -> the unpacker's bits a pixel and numpy's sample type
# (None: bits MSB first), for the pairs Pillow has an unpacker of
_UNPACK = {("1", "1"): (1, None), ("L", "L"): (8, "u1"),
           ("P", "P"): (8, "u1"), ("P", "P;2"): (2, None),
           ("P", "P;4"): (4, None), ("RGB", "RGB"): (24, "u1"),
           ("RGB", "RGB;L"): (24, "u1"), ("RGB", "RGBX;L"): (32, "u1"),
           ("RGBA", "RGBA;L"): (32, "u1"), ("CMYK", "CMYK;L"): (32, "u1"),
           ("YCbCr", "YCbCr;L"): (24, "u1"), ("LA", "LA;L"): (16, "u1"),
           ("PA", "PA;L"): (16, "u1"), ("I", "I;32"): (32, "<u4"),
           ("I", "I;32S"): (32, "<i4"), ("I;16", "I;16"): (16, "<u2"),
           ("I;16L", "I;16L"): (16, "<u2"), ("I;16B", "I;16B"): (16, ">u2"),
           ("F", "F;8"): (8, "u1"), ("F", "F;8S"): (8, "i1"),
           ("F", "F;16"): (16, "<u2"), ("F", "F;16S"): (16, "<i2"),
           ("F", "F;32"): (32, "<u4"), ("F", "F;32F"): (32, "<f4")}
# numpy's array of each mode: its sample type and bands
_ARRAY = {"1": (bool, 1), "L": ("u1", 1), "P": ("u1", 1), "LA": ("u1", 2),
          "PA": ("u1", 2), "RGB": ("u1", 3), "YCbCr": ("u1", 3),
          "RGBA": ("u1", 4), "CMYK": ("u1", 4), "I": ("<i4", 1),
          "I;16": ("<u2", 1), "I;16L": ("<u2", 1), "I;16B": (">u2", 1),
          "F": ("<f4", 1)}

_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")


def _number(s: str):
    try:
        return int(s)
    except ValueError:
        return float(s)


def im_header(data: bytes, path) -> dict:
    """ImImageFile._open: size, mode, raw mode, the Lut's effect and where
    the pixels start."""
    if b"\n" not in data[:100]:
        raise NotThisFormat("not an IM file")
    info = {_MODE: "L", _SIZE: (512, 512), _FRAMES: 1}
    rawmode, n, pos, s = "L", 0, 0, b""
    while True:
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s += data[pos:end]
        pos = end
        if len(s) > 100:
            raise NotThisFormat("not an IM file")
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") \
            else s
        m = _LINE.match(s)
        if not m:
            raise NotThisFormat("Syntax error in IM header")
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in (_FRAMES, _SCALE, _SIZE):
            try:
                v = tuple(map(_number, v.replace("*", ",").split(",")))
            except ValueError as e:
                raise ValueError(f"{path}: IM header {k!r}: {e}") from None
            v = v[0] if len(v) == 1 else v
        elif k == _MODE and v in OPEN:
            v, rawmode = OPEN[v]
        if k == _COMMENT:
            info.setdefault(k, []).append(v)
        else:
            info[k] = v
        n += k in _TAGS
    if not n:
        raise NotThisFormat("Not an IM file")
    size, mode = info[_SIZE], info[_MODE]
    if not isinstance(size, tuple) or len(size) < 2:
        raise NotThisFormat("not identified by this driver")
    if not all(isinstance(x, int) for x in size) or len(size) != 2:
        raise ValueError(f"{path}: IM image size {size} is not two whole "
                         f"numbers")
    if size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat("not identified by this driver")
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += len(s)
    if not s:
        raise NotThisFormat("File truncated")
    if _LUT in info:
        lut = data[pos:pos + 768]
        pos += len(lut)
        if len(lut) < 768:
            raise NotThisFormat("IM Lut is truncated")
        planes = np.frombuffer(lut, np.uint8).reshape(3, 256)
        grey = bool((planes[0] == planes[1]).all()
                    and (planes[0] == planes[2]).all())
        if mode in ("L", "LA", "P", "PA") and not grey:
            mode, rawmode = ("P", "P") if mode in ("L", "P") else \
                ("PA", "PA;L")
    return dict(size=size, mode=mode, rawmode=rawmode, offset=pos)


def _bit_decode(body: bytes, bits: int, w: int, h: int):
    """Pillow's BitDecode.c as ImImagePlugin sets it up (pad 8, fill 3:
    each byte OR'd into the bit buffer above the bits it holds, pixels
    taken from its low bits; sign 0; rows bottom-up; at a row's end the
    count of bits held drops to 0 but the buffer keeps them, so they are
    OR'd into the next row's first pixel) -> float32 rows, or None where
    the data ends first."""
    mask = (1 << bits) - 1
    out = np.empty(w * h, np.float32)
    buf = count = i = 0
    for byte in body:
        buf |= byte << count
        count += 8
        while count >= bits:
            v = buf & mask
            if count > 32:
                buf = byte >> (8 - (count - bits))
            else:
                buf >>= bits
            count -= bits
            out[i] = v
            i += 1
            if i % w == 0:
                if i == w * h:
                    return out.reshape(h, w)[::-1]
                count = 0                       # the buffer's bits stay
    return None


def read_im(data: bytes, path) -> tuple[np.ndarray, str]:
    """``np.asarray(Image.open(path))`` of an IM file and its mode."""
    hd = im_header(data, path)
    (w, h), mode, rawmode = hd["size"], hd["mode"], hd["rawmode"]
    if mode not in _ARRAY:
        raise ValueError(f"{path}: IM image type {mode!r}: PIL cannot load "
                         f"it (unrecognized image mode)")
    body = data[hd["offset"]:]
    if rawmode in ("RGB;T", "RYB;T"):
        # three planes, G, R and B, each of its rows bottom-up
        if len(body) < 3 * w * h:
            raise ValueError(f"{path}: image file is truncated")
        g, r, b = np.frombuffer(body[:3 * w * h], np.uint8).reshape(
            3, h, w)[:, ::-1]
        return np.ascontiguousarray(np.stack([r, g, b], -1)), mode
    if mode == "F" and rawmode[2:].isdigit() and \
            int(rawmode[2:]) not in (8, 16, 32):
        a = _bit_decode(body, int(rawmode[2:]), w, h)
        if a is None:
            raise ValueError(f"{path}: image file is truncated")
        return np.ascontiguousarray(a), mode
    if (mode, rawmode) not in _UNPACK:
        raise ValueError(f"{path}: IM raw mode {rawmode} of a {mode} image: "
                         f"PIL cannot load it (unknown raw mode for given "
                         f"image mode)")
    bits, sample = _UNPACK[mode, rawmode]
    stride = (w * bits + 7) // 8
    if len(body) < stride * h:
        raise ValueError(f"{path}: image file is truncated")
    rows = np.frombuffer(body[:stride * h], np.uint8).reshape(h, stride)[::-1]
    if sample is None:                          # 1, 2 or 4 bits, MSB first
        per = 8 // bits
        shifts = (8 - bits * (np.arange(per) + 1)).astype(np.uint8)
        v = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(
            h, -1)[:, :w]
        a = v != 0 if mode == "1" else v.astype(np.uint8)
        return np.ascontiguousarray(a), mode
    dtype, bands = _ARRAY[mode]
    if rawmode.endswith(";L"):                  # each row's bands in turn
        planes = rows.reshape(h, bits // 8, w)[:, :bands]
        return np.ascontiguousarray(np.moveaxis(planes, 1, -1)), mode
    v = np.ascontiguousarray(rows).view(sample).reshape(
        (h, w, bits // 8) if sample == "u1" and bits > 8 else (h, w))
    return np.ascontiguousarray(v.astype(dtype)), mode


# ImImagePlugin.SAVE: the modes of Image.fromarray -> (image type, raw
# mode's sample type)
_SAVE = {"1": ("0 1", None), "L": ("Greyscale", "u1"), "LA": ("LA", "u1"),
         "I": ("L 32S", "<i4"), "I;16": ("L 16", "<u2"),
         "F": ("L 32F", "<f4"), "RGB": ("RGB", "u1"), "RGBA": ("RGBA", "u1")}


def im_bytes(a: np.ndarray, mode: str, path) -> bytes:
    """PIL's IM of ``a``: the header with the base name of ``path``, then
    the rows bottom-up ("LA", "RGB" and "RGBA" a band after another in
    each row)."""
    if mode not in _SAVE:
        raise ValueError(f"Cannot save {mode} images as IM")
    h, w = a.shape[:2]
    image_type, sample = _SAVE[mode]
    name, ext = os.path.splitext(os.path.basename(str(path)))
    head = (f"Image type: {image_type} image\r\n"
            f"Name: {name[:92 - len(ext)] + ext}\r\n"
            f"Image size (x*y): {w}*{h}\r\n"
            f"File size (no of images): 1\r\n").encode("ascii")
    head += bytes(max(0, 511 - len(head))) + b"\x1a"
    if mode == "1":
        rows = np.packbits(a, axis=1)
    elif a.ndim == 3:
        rows = np.moveaxis(a, -1, 1).reshape(h, -1)
    else:
        rows = a.astype(sample)
    return head + np.ascontiguousarray(rows[::-1]).tobytes()
