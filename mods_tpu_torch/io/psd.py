"""Photoshop (PSD) files as PIL 12.1.0 reads them for the JAX commands
(``np.asarray(Image.open(path))``, PsdImagePlugin): the composite image,
frame 0.

``read_psd(data, path)`` returns PIL's array and mode; ``psd_header``
gives the size and mode that ``Image.open`` reports.  PsdImageFile._open's
steps, one by one:

* the 26-byte header (signature "8BPS", version 1), its colour mode and
  bits a channel mapped by ``MODES`` (a copy of the plugin's): bitmap as
  "1", gray, multichannel and duotone as "L", indexed as "P" (its array is
  the indices), RGB (RGBA where the file has exactly 4 channels), CMYK
  (each channel inverted, PIL's "C;I" raw modes) and Lab as "LAB" (a and
  b with their top bit flipped, as PIL's "A" and "B" raw modes unpack
  them); a pair outside it (16-bit files among them) is refused with
  PIL's KeyError, fewer channels than the mode needs with its "not
  enough channels";
* the colour mode data, the image resources (read entry by entry, as the
  plugin reads them, padding included) and the layer and mask block,
  skipped as PIL skips them;
* the image data: compression 0 (each channel's rows one after another)
  or 1 (a table of each channel's row byte counts, then PackBits, which
  ``csrc/raster_codec.cpp``'s ``mods_packbits_decode`` expands as
  PackBitsDecode.c does: a channel decoded from its offset on, runs cut
  at a row's end); any other compression leaves PIL without a tile
  ("cannot load this image").

A file that ends inside the header or the resources makes the plugin
fail in a way that ``Image.open`` takes as "not a PSD file": it raises
"cannot identify image file", as PIL does.
"""

from __future__ import annotations

import struct

import numpy as np

# PsdImagePlugin.MODES: (colour mode, bits) -> (PIL's mode, channels)
MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
         (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
         (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


class _Reader:
    """A file object's ``read`` and ``tell`` over bytes, and the
    ``_binary`` helpers whose short reads raise struct.error."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def i16(self) -> int:
        return struct.unpack(">H", self.read(2))[0]

    def i32(self) -> int:
        return struct.unpack(">I", self.read(4))[0]


def _unidentified(path) -> ValueError:
    return ValueError(f"{path}: cannot identify image file (a PSD whose "
                      f"header or resources end early)")


def psd_header(data: bytes, path) -> dict:
    """PsdImageFile._open: the size, the mode, the channels read, the
    compression and where the image data starts."""
    f = _Reader(data)
    s = f.read(26)
    if len(s) < 26 or not s.startswith(b"8BPS") or \
            struct.unpack_from(">H", s, 4)[0] != 1:
        raise ValueError(f"{path}: cannot identify image file (not a PSD "
                         f"file of version 1)")
    channels_in_file, height, width, bits, colour = struct.unpack_from(
        ">HIIHH", s, 12)
    if (colour, bits) not in MODES:
        raise ValueError(f"{path}: PSD of colour mode {colour} at {bits} "
                         f"bits a channel: PIL refuses it (KeyError: no "
                         f"mode in PsdImagePlugin.MODES)")
    mode, channels = MODES[(colour, bits)]
    if channels > channels_in_file:
        raise ValueError(f"{path}: PSD of {channels_in_file} channels in "
                         f"mode {mode}: PIL refuses it (not enough "
                         f"channels)")
    if mode == "RGB" and channels_in_file == 4:
        mode, channels = "RGBA", 4
    try:
        size = f.i32()                                  # colour mode data
        f.read(size)
        size = f.i32()                                  # image resources
        if size:
            end = f.pos + size
            while f.pos < end:
                f.read(4)
                f.i16()
                name = f.read(f.read(1)[0])
                if not len(name) & 1:
                    f.read(1)
                if len(f.read(f.i32())) & 1:
                    f.read(1)
        size = f.i32()                                  # layers and masks
        if size:
            end = f.pos + size
            f.i32()
            f.pos = end
        compression = f.i16()
        counts = None
        if compression == 1:
            raw = f.read(channels * height * 2)
            counts = struct.unpack(f">{channels * height}H", raw)
    except (struct.error, IndexError):
        raise _unidentified(path) from None
    return dict(size=(width, height), mode=mode, channels=channels,
                compression=compression, counts=counts, offset=f.pos)


def read_psd(data: bytes, path) -> tuple[np.ndarray, str]:
    """``np.asarray(Image.open(path))`` of a PSD and its mode."""
    from mods_tpu_torch.io import raster
    hd = psd_header(data, path)
    (w, h), mode, compression = hd["size"], hd["mode"], hd["compression"]
    if compression not in (0, 1):
        raise ValueError(f"{path}: cannot load this image (PSD compression "
                         f"{compression}: PIL has no tile for it)")
    row_bytes = (w + 7) // 8 if mode == "1" else w
    planes, offset = [], hd["offset"]
    for c in range(hd["channels"]):
        if compression == 0:
            body = data[offset:offset + row_bytes * h]
            if len(body) < row_bytes * h:
                raise ValueError(f"{path}: image file is truncated")
            rows = np.frombuffer(body, np.uint8).reshape(h, row_bytes)
            offset += w * h
        else:
            body = data[offset:]
            rows = np.empty((h, row_bytes), np.uint8)
            status = raster._codec().mods_packbits_decode(
                body, len(body), row_bytes, h, rows.ctypes.data)
            if status:
                raise ValueError(f"{path}: image file is truncated")
            offset += sum(hd["counts"][c * h:(c + 1) * h])
        planes.append(rows)
    if mode == "1":
        return np.unpackbits(planes[0], axis=1)[:, :w].astype(bool), mode
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0]), mode
    a = np.stack(planes, -1)
    if mode == "LAB":                   # Unpack.c's "A" and "B": signed
        a[..., 1:] ^= 0x80
    return (255 - a if mode == "CMYK" else a), mode
