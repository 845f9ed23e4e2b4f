"""A small PNG reader for 8-bit non-interlaced images, on zlib and numpy.

The card machine has no PIL.  The test pairs in ``.parity_work/`` are
8-bit grayscale; 8-bit RGB and RGBA (colour types 2 and 6) are read
too and converted to gray by ``ops/image.py::to_gray_np``, as the JAX
package converts what PIL returns.  Filter types 0-4 are handled (PNG
spec section 9); any other format raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from mods_tpu_torch.ops.image import to_gray_np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


# samples a pixel per colour type: gray, RGB, RGBA
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _paeth_row(line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(len(line))
    ln, pv = line.tolist(), prev.tolist()
    for i in range(len(ln)):
        left = out[i - bpp] if i >= bpp else 0
        upleft = pv[i - bpp] if i >= bpp else 0
        up = pv[i]
        p = left + up - upleft
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
        pred = left if pa <= pb and pa <= pc else (up if pb <= pc
                                                   else upleft)
        out[i] = (ln[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(len(line))
    ln, pv = line.tolist(), prev.tolist()
    for i in range(len(ln)):
        left = out[i - bpp] if i >= bpp else 0
        out[i] = (ln[i] + ((left + pv[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png_gray(path) -> np.ndarray:
    """Gray pixels of an 8-bit PNG: (H, W) uint8 for a grayscale file;
    for RGB or RGBA the float32 mean over the channels (``to_gray_np``)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    width = height = None
    while pos < len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            width, height, depth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", body)
            if depth != 8 or color not in _CHANNELS or interlace != 0:
                raise ValueError(
                    f"{path}: only 8-bit gray, RGB or RGBA non-interlaced "
                    f"PNGs are supported (depth {depth}, color type "
                    f"{color}, interlace {interlace})")
            bpp = _CHANNELS[color]
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if width is None:
        raise ValueError(f"{path}: no IHDR chunk")
    row = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(height, row + 1)
    img = np.zeros((height, row), np.uint8)
    prev = np.zeros(row, np.uint8)
    for r in range(height):
        ftype, line = raw[r, 0], raw[r, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = (np.cumsum(line.reshape(width, bpp), axis=0,
                             dtype=np.uint64) & 0xFF).astype(
                                 np.uint8).reshape(-1)
        elif ftype == 2:
            cur = line + prev
        elif ftype == 3:
            cur = _average_row(line, prev, bpp)
        elif ftype == 4:
            cur = _paeth_row(line, prev, bpp)
        else:
            raise ValueError(f"{path}: bad PNG filter type {ftype}")
        img[r] = cur
        prev = cur
    if bpp == 1:
        return img
    return to_gray_np(img.reshape(height, width, bpp))
