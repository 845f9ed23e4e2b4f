"""Blizzard Mipmap (BLP) files as PIL 12.1.0 reads them for the JAX
commands (``np.asarray(Image.open(path))``; BlpImagePlugin), and its
refusal to write them.

``read_blp(data, path)`` returns PIL's array and mode, ``blp_header`` the
size and mode that ``Image.open`` reports.  The mode is "RGBA" where the
header's alpha field is not 0, else "RGB"; only mipmap 0 is read.  After
the header (20 bytes for BLP2, 28 for BLP1) come 16 mipmap offsets and 16
lengths, then, as the plugin's decoders read them:

* BLP1, compression 0 (JPEG): a shared JPEG header (its length, then the
  bytes) joined to mipmap 0's bytes and decoded as a JPEG
  (``csrc/jpeg_decode.cpp``, PIL's JpegImageFile), converted to RGB as
  ``convert("RGB")`` converts gray and CMYK, and then read as BGR: the
  red and blue channels trade places, as PIL's ``set_as_raw(..., "BGR")``
  makes them;
* BLP1, compression 1, encodings 4 and 5: a 256-entry BGRA palette, then
  ``lengths[0]`` palette indices read right after it;
* BLP2: the palette after the mipmap tables, then from ``offsets[0]``:
  encoding 1 the indices, encoding 2 DXT1 (alpha encoding 0; its
  transparent code where the alpha field is set), DXT3 (1) or DXT5 (7)
  blocks decoded with the plugin's own arithmetic (``_dxt``: 5:6:5
  colours shifted up without their high bits repeated, thirds and halves
  truncated), which is not BcnDecode.c's (``io/dds.py``);
* the pixels, 3 or 4 bytes each (as the decoder made them, whatever the
  mode), are then read as one stream of rows of the image's width: a
  width that is not a multiple of 4 skews DXT rows as PIL skews them.

Every other compression or encoding (BLP2's encoding 3 among them) raises
the plugin's message.  ``blp_bytes`` refuses every array: PIL writes BLP
from mode "P" only, which ``Image.fromarray`` never gives.
"""

from __future__ import annotations

import struct

import numpy as np


def blp_header(data: bytes, path) -> dict:
    """BlpImageFile._open: size, mode and the decoder's arguments."""
    try:
        magic = data[:4]
        compression, = struct.unpack_from("<i", data, 4)
        if magic == b"BLP1":
            alpha = struct.unpack_from("<I", data, 8)[0] != 0
            encoding, = struct.unpack_from("<i", data, 20)
            alpha_encoding, offset = None, 28
        else:
            encoding, alpha, alpha_encoding = struct.unpack_from(
                "<bbb", data, 8)
            alpha, offset = alpha != 0, 20
        w, h = struct.unpack_from("<II", data, 12)
    except struct.error:
        raise ValueError(f"{path}: cannot identify image file (a BLP "
                         f"header cut short)") from None
    if not w or not h:
        raise ValueError(f"{path}: cannot identify image file (a BLP of "
                         f"{w} x {h} pixels)")
    return dict(size=(w, h), mode="RGBA" if alpha else "RGB",
                version=magic[3:], compression=compression,
                encoding=encoding, alpha_encoding=alpha_encoding,
                offset=offset)


class _Reader:
    """ImageFile._safe_read over bytes: a short read raises PIL's
    "Truncated File Read"."""

    def __init__(self, data: bytes, pos: int, path):
        self.data, self.pos, self.path = data, pos, path

    def read(self, n: int) -> bytes:
        if n <= 0:
            return b""
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        if len(out) < n:
            raise ValueError(f"{self.path}: Truncated File Read")
        return out


def _unpack_565(c: np.ndarray) -> np.ndarray:
    """BlpImagePlugin.unpack_565: each field shifted up, no bits
    repeated -> (..., 3) int32."""
    c = c.astype(np.int32)
    return np.stack([(c >> 11 & 0x1F) << 3, (c >> 5 & 0x3F) << 2,
                     (c & 0x1F) << 3], -1)


def _dxt(body: bytes, bw: int, bh: int, kind: int, alpha: bool) -> bytes:
    """The plugin's decode_dxt1 / decode_dxt3 / decode_dxt5 on ``bh`` rows
    of ``bw`` blocks: 4 rows of pixels a block row, RGB(A) bytes."""
    size = 8 if kind == 1 else 16
    b = np.frombuffer(body, np.uint8).reshape(bh, bw, size)
    colour = b[..., size - 8:]
    c0 = colour[..., 0].astype(np.int32) | colour[..., 1].astype(np.int32) << 8
    c1 = colour[..., 2].astype(np.int32) | colour[..., 3].astype(np.int32) << 8
    bits = colour[..., 4:8].copy().view("<u4")[..., 0]
    code = (bits[..., None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
    p0, p1 = _unpack_565(c0), _unpack_565(c1)
    four = (c0 > c1) if kind == 1 else np.ones(c0.shape, bool)
    third0, third1 = (2 * p0 + p1) // 3, (2 * p1 + p0) // 3
    half = (p0 + p1) // 2
    # (bh, bw, 4 codes, 3) colours, and each code's alpha
    table = np.stack([p0, p1, np.where(four[..., None], third0, half),
                      np.where(four[..., None], third1, 0)], -2)
    rgb = np.take_along_axis(table, code[..., None].astype(np.int64), -2)
    if kind == 1:
        a = np.where((code == 3) & ~four[..., None], 0, 255)
    elif kind == 2:
        nib = np.stack([b[..., :8] & 15, b[..., :8] >> 4], -1).reshape(
            bh, bw, 16)
        a = nib.astype(np.int32) * 17
    else:
        a0, a1 = b[..., 0].astype(np.int32), b[..., 1].astype(np.int32)
        codes48 = np.zeros((bh, bw), np.uint64)
        for k in range(6):
            codes48 |= b[..., 2 + k].astype(np.uint64) << np.uint64(8 * k)
        ac = ((codes48[..., None] >> (3 * np.arange(16, dtype=np.uint64)))
              & np.uint64(7)).astype(np.int32)
        a0_, a1_ = a0[..., None], a1[..., None]
        eight = ((8 - ac) * a0_ + (ac - 1) * a1_) // 7
        six = np.where(ac == 6, 0, np.where(ac == 7, 255,
                                             ((6 - ac) * a0_ + (ac - 1)
                                              * a1_) // 5))
        a = np.where(ac == 0, a0_, np.where(ac == 1, a1_,
                                            np.where(a0_ > a1_, eight, six)))
    px = np.concatenate([rgb, a[..., None]], -1) if (kind != 1 or alpha) \
        else rgb
    # (block row, block column, pixel row, pixel column, bytes) to rows
    px = px.reshape(bh, bw, 4, 4, -1).transpose(0, 2, 1, 3, 4)
    return px.astype(np.uint8).tobytes()


def _palette(f: _Reader) -> np.ndarray:
    """256 BGRA entries -> (256, 4) RGBA."""
    return np.frombuffer(f.read(1024), np.uint8).reshape(256, 4)[
        :, [2, 1, 0, 3]]


def _indexed(f: _Reader, n: int, palette: np.ndarray, alpha: bool) -> bytes:
    idx = np.frombuffer(f.read(n), np.uint8)
    return palette[idx][:, :4 if alpha else 3].tobytes()


def _jpeg_rgb(f: _Reader, offsets, lengths, path) -> bytes:
    """The decoder's JPEG: the shared header and mipmap 0 decoded, then
    ``convert("RGB")``'s bytes."""
    from mods_tpu_torch.io import image, tiff
    size, = struct.unpack("<I", f.read(4))
    head = f.read(size)
    f.read(offsets[0] - f.pos)
    stream = head + f.read(lengths[0])
    if not stream.startswith(b"\xff\xd8\xff"):
        raise ValueError(f"{path}: not a JPEG file (BLP1 mipmap 0)")
    w, h = image._jpeg_size_of(stream, path)
    if w * h > 2 * tiff._MAX_PIXELS:
        raise ValueError(f"{path}: a BLP1 JPEG of {w}x{h} pixels: PIL "
                         f"refuses it (a decompression bomb)")
    # BlpImagePlugin: a CMYK stream's tile says jpegmode "CMYK"
    a = image._read_jpeg(stream, path, cmyk=True).astype(np.int32)
    if a.ndim == 2:
        a = np.repeat(a[..., None], 3, -1)
    elif a.shape[2] == 4:                       # Convert.c's cmyk2rgb
        nk = 255 - a[..., 3:]
        t = a[..., :3] * nk + 128
        a = np.clip(nk - (((t >> 8) + t) >> 8), 0, 255)
    return a.astype(np.uint8).tobytes()


def read_blp(data: bytes, path) -> tuple[np.ndarray, str]:
    """``np.asarray(Image.open(path))`` of a BLP and its mode."""
    hd = blp_header(data, path)
    (w, h), mode = hd["size"], hd["mode"]
    alpha = mode == "RGBA"
    compression, encoding = hd["compression"], hd["encoding"]
    f = _Reader(data, hd["offset"], path)
    offsets = struct.unpack("<16I", f.read(64))
    lengths = struct.unpack("<16I", f.read(64))
    bgr = False
    if hd["version"] == b"1":
        if compression == 0:
            px, bgr = _jpeg_rgb(f, offsets, lengths, path), True
        elif compression == 1 and encoding in (4, 5):
            px = _indexed(f, lengths[0], _palette(f), alpha)
        elif compression == 1:
            raise ValueError(f"{path}: Unsupported BLP encoding {encoding!r}")
        else:
            raise ValueError(f"{path}: Unsupported BLP compression "
                             f"{encoding!r}")
    else:
        palette = _palette(f)
        f.pos = offsets[0]
        if compression != 1:
            raise ValueError(f"{path}: Unknown BLP compression "
                             f"{compression!r}")
        if encoding == 1:
            px = _indexed(f, lengths[0], palette, alpha)
        elif encoding == 2:
            kind = {0: 1, 1: 2, 7: 3}.get(hd["alpha_encoding"])
            if kind is None:
                raise ValueError(f"{path}: Unsupported alpha encoding "
                                 f"{hd['alpha_encoding']!r}")
            bw, bh = (w + 3) // 4, (h + 3) // 4
            px = _dxt(f.read(bw * bh * (8 if kind == 1 else 16)), bw, bh,
                      kind, alpha)
        else:
            raise ValueError(f"{path}: Unknown BLP encoding {encoding!r}")
    # set_as_raw: the bytes as rows of the image's width in its raw mode
    # (BGR for the JPEG, which fills alpha with 255)
    step = 3 if bgr else len(mode)
    if len(px) < w * h * step:
        raise ValueError(f"{path}: not enough image data")
    a = np.frombuffer(px, np.uint8)[:w * h * step].reshape(h, w, step)
    if bgr:
        a = a[..., ::-1]
        if alpha:
            a = np.concatenate([a, np.full((h, w, 1), 255, np.uint8)], -1)
    return np.ascontiguousarray(a), mode


def blp_bytes(a: np.ndarray, mode: str) -> bytes:
    """BlpImagePlugin._save's refusal: only a "P" image is written."""
    raise ValueError("Unsupported BLP image mode")
