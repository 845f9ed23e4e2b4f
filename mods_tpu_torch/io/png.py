"""A small PNG reader for 8-bit grayscale images, on zlib and numpy.

The card machine has no PIL, and the test pairs in ``.parity_work/`` are
8-bit grayscale, non-interlaced PNGs.  Filter types 0-4 are handled
(PNG spec section 9); anything else raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth_row(line: np.ndarray, prev: np.ndarray) -> np.ndarray:
    out = bytearray(len(line))
    left = 0
    upleft = 0
    for i, (x, up) in enumerate(zip(line.tolist(), prev.tolist())):
        p = left + up - upleft
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - upleft)
        pred = left if pa <= pb and pa <= pc else (up if pb <= pc
                                                   else upleft)
        left = (x + pred) & 0xFF
        out[i] = left
        upleft = up
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(line: np.ndarray, prev: np.ndarray) -> np.ndarray:
    out = bytearray(len(line))
    left = 0
    for i, (x, up) in enumerate(zip(line.tolist(), prev.tolist())):
        left = (x + ((left + up) >> 1)) & 0xFF
        out[i] = left
    return np.frombuffer(bytes(out), np.uint8)


def read_png_gray(path) -> np.ndarray:
    """(H, W) uint8 pixels of an 8-bit grayscale PNG."""
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
            if depth != 8 or color != 0 or interlace != 0:
                raise ValueError(
                    f"{path}: only 8-bit grayscale non-interlaced PNGs are "
                    f"supported (depth {depth}, color type {color}, "
                    f"interlace {interlace})")
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if width is None:
        raise ValueError(f"{path}: no IHDR chunk")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(height, width + 1)
    img = np.zeros((height, width), np.uint8)
    prev = np.zeros(width, np.uint8)
    for r in range(height):
        ftype, line = raw[r, 0], raw[r, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = (np.cumsum(line, dtype=np.uint64) & 0xFF).astype(np.uint8)
        elif ftype == 2:
            cur = line + prev
        elif ftype == 3:
            cur = _average_row(line, prev)
        elif ftype == 4:
            cur = _paeth_row(line, prev)
        else:
            raise ValueError(f"{path}: bad PNG filter type {ftype}")
        img[r] = cur
        prev = cur
    return img
