"""A PNG reader and writer on zlib and numpy.

The card machine has no PIL.  ``read_png`` returns the pixels as PIL's
``np.asarray(Image.open(path))`` gives them (PngImagePlugin's modes), for
every colour type, bit depth and Adam7 interlacing:

* gray: 1-bit as bool, 2- and 4-bit scaled to 0..255 (x 85, x 17),
  8-bit uint8, 16-bit uint16 (PIL's "I;16");
* RGB, RGBA and gray+alpha: 8-bit as (H, W, 3), (H, W, 4), (H, W, 2)
  uint8; 16-bit as the high byte of each sample, gray+alpha 16-bit as
  RGBA (PIL's "LA;16B" read into "RGBA");
* palette: the (H, W) uint8 indices, whatever the depth and tRNS.

``read_png_gray`` converts them to gray with ``ops/image.py::to_gray_np``,
as the JAX package converts what PIL returns.  Filter types 0-4 are read
(PNG spec section 9).  ``write_png`` writes bool (1-bit gray), uint8
gray, gray+alpha, RGB and RGBA and uint16 gray, every row with filter 0
(``encode_png`` gives its bytes, ``decode_png`` reads bytes).
``png_size`` reads the size from the header.  The module needs numpy and
zlib only: the External plugin's scripts load it from its file.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# samples a pixel, and the bit depths allowed, per colour type: gray,
# RGB, palette, gray+alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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


def _unfilter(raw: np.ndarray, height: int, row: int, bpp: int,
              path) -> np.ndarray:
    """(height, 1 + row) filtered scanlines -> (height, row) bytes."""
    raw = raw.reshape(height, row + 1)
    img = np.zeros((height, row), np.uint8)
    prev = np.zeros(row, np.uint8)
    for r in range(height):
        ftype, line = raw[r, 0], raw[r, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:
            cur = np.concatenate([line, np.zeros(-row % bpp, np.uint8)])
            cur = (np.cumsum(cur.reshape(-1, bpp), axis=0, dtype=np.uint64)
                   & 0xFF).astype(np.uint8).reshape(-1)[:row]
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
    return img


def _samples(rows: np.ndarray, width: int, depth: int,
             channels: int) -> np.ndarray:
    """(h, row bytes) -> (h, width * channels) samples: uint8 for depths
    1-8 (the raw values), uint16 for 16."""
    h = rows.shape[0]
    n = width * channels
    if depth == 16:
        pairs = rows[:, :2 * n].reshape(h, n, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    if depth == 8:
        return rows[:, :n]
    per = 8 // depth
    shifts = (8 - depth * (np.arange(per) + 1)).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :n].astype(np.uint8)


def png_size(path) -> tuple[int, int]:
    """(width, height) from a PNG's header."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def read_png(path) -> np.ndarray:
    """The pixels of a PNG as PIL loads them (module docstring)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path) -> np.ndarray:
    """``read_png`` of a PNG's bytes (anything after IEND is ignored);
    ``path`` names it in errors."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    header = None
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS or depth not in _DEPTHS[color] or \
            interlace > 1:
        raise ValueError(f"{path}: not a valid PNG (depth {depth}, colour "
                         f"type {color}, interlace {interlace})")
    channels = _CHANNELS[color]
    bits = depth * channels
    bpp = max(1, bits // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.zeros((height, width * channels),
                       np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy in passes:
        pw = (width - x0 + dx - 1) // dx if width > x0 else 0
        ph = (height - y0 + dy - 1) // dy if height > y0 else 0
        if pw == 0 or ph == 0:
            continue
        row = (pw * bits + 7) // 8
        size = ph * (row + 1)
        if at + size > raw.size:
            raise ValueError(f"{path}: PNG image data is truncated")
        rows = _unfilter(raw[at:at + size], ph, row, bpp, path)
        at += size
        s = _samples(rows, pw, depth, channels).reshape(ph, pw, channels)
        view = samples.reshape(height, width, channels)
        view[y0::dy, x0::dx] = s
    img = samples.reshape(height, width, channels)
    if depth == 16 and color != 0:
        img = (img >> 8).astype(np.uint8)             # PIL's ";16B" modes
        if color == 4:
            img = img[..., [0, 0, 0, 1]]              # "LA;16B" -> RGBA
    elif color == 0 and depth < 8:
        img = img != 0 if depth == 1 else img * (255 // (2 ** depth - 1))
    return img[..., 0] if img.shape[-1] == 1 else img


def read_png_gray(path) -> np.ndarray:
    """Gray pixels of a PNG: a single-sample file as loaded; otherwise the
    float32 mean over the samples (``to_gray_np``)."""
    # imported here: the External plugin's scripts load this file on its
    # own, with numpy alone
    from mods_tpu_torch.ops.image import to_gray_np
    img = read_png(path)
    return img if img.ndim == 2 else to_gray_np(img)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path, array) -> None:
    """Write (H, W) bool as 1-bit gray, (H, W) uint16 as 16-bit gray, or
    (H, W) gray, (H, W, 2) gray+alpha, (H, W, 3) RGB or (H, W, 4) RGBA
    uint8 as 8-bit, every row with filter type 0."""
    with open(path, "wb") as f:
        f.write(encode_png(array))


def encode_png(array) -> bytes:
    """The bytes that ``write_png`` writes."""
    a = np.ascontiguousarray(array)
    h, w = a.shape[:2]
    if a.dtype == np.bool_ and a.ndim == 2:
        depth, color = 1, 0
        rows = np.packbits(a, axis=1)
    elif a.dtype == np.uint16 and a.ndim == 2:
        depth, color = 16, 0
        rows = a.astype(">u2").view(np.uint8).reshape(h, 2 * w)
    elif a.dtype == np.uint8:
        channels = 1 if a.ndim == 2 else (a.shape[2] if a.ndim == 3 else 0)
        color = {1: 0, 2: 4, 3: 2, 4: 6}.get(channels)
        if color is None:
            raise ValueError(f"write_png takes (H, W), (H, W, 2), (H, W, 3) "
                             f"or (H, W, 4) uint8 pixels, not {a.shape}")
        depth = 8
        rows = a.reshape(h, w * channels)
    else:
        raise ValueError(f"write_png takes uint8 pixels, (H, W) uint16 or "
                         f"(H, W) bool, not {a.dtype} {a.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0,
                                          0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
