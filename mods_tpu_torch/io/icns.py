"""Apple icon (ICNS) files as PIL 12.1.0 reads and writes them for the JAX
commands (``Image.open``, ``Image.fromarray(a).save``; IcnsImagePlugin).

Reading (``read_icns``, ``icns_header``):

* IcnsFile: the 8-byte header (``icns`` and the file's length), then
  each entry's type and length up to that length; an entry of a type
  seen before replaces it;
* ``info["sizes"]`` (``icns_sizes``): each (width, height, scale) of
  ``SIZES`` (IcnsFile.SIZES, in its order) of which the file has an
  entry; ``Image.open`` shows the largest (``bestsize``), at width x
  scale by height x scale;
* loading reads every entry of that size in SIZES' order: a PNG
  (``io/png.py``) or a JPEG 2000 codestream or JP2 file
  (``csrc/j2k_decode.cpp``, converted to "RGBA") is the image; else the
  RLE entries ``it32`` (after 4 zero bytes), ``ih32``, ``il32`` and
  ``is32`` (read_32: three bands of runs, a byte of 128 and above
  repeating the next byte (byte - 125) times, any other copying byte + 1
  bytes; or uncompressed RGB where the length is 3 bytes a pixel) with
  their ``*8mk`` masks as alpha (read_mk);
* ``np.asarray`` then packs the loaded image with the raw mode "RGBA",
  which ``Image.open`` set before loading, and shapes it by the loaded
  image's mode: an "RGBA" image is itself, an "RGB" one is its RGBX
  bytes read as three bytes a pixel (what PIL gives; X is 255, or 0 for
  RLE bands), and any other mode fails as PIL fails ("No packer found
  from L to RGBA").

Writing (``icns_bytes``) is IcnsImagePlugin._save: the image resized to
32, 64, 128, 256, 512 and 1024 squares by ``Image.resize`` with Pillow's
default filter (``io/raster.py::resizer``: bicubic, nearest neighbour for
"1", premultiplied for "LA" and "RGBA" once for all sizes; the image
itself where its size is the square's), each saved as PNG by
``io/png.py::encode_png``, then the header, a table of contents of eight
entries and the eight entries (ic07 128, ic08 256, ic09 512, ic10 1024,
ic11 32, ic12 64, ic13 256, ic14 512).  Pillow's PNG payloads come from
zlib-ng with a filter chosen for each row; the port's come from CPython's
zlib with filter 0, so the bytes differ and PIL reads the same frames
from both files.
"""

from __future__ import annotations

import struct

import numpy as np

from mods_tpu_torch.io import png, raster

# IcnsFile.SIZES: (width, height, scale) -> the entry types read for it,
# in the plugin's order ("png": a PNG or JPEG 2000 image)
SIZES = (((512, 512, 2), ((b"ic10", "png"),)),
         ((512, 512, 1), ((b"ic09", "png"),)),
         ((256, 256, 2), ((b"ic14", "png"),)),
         ((256, 256, 1), ((b"ic08", "png"),)),
         ((128, 128, 2), ((b"ic13", "png"),)),
         ((128, 128, 1), ((b"ic07", "png"), (b"it32", "32t"),
                          (b"t8mk", "mk"))),
         ((64, 64, 1), ((b"icp6", "png"),)),
         ((32, 32, 2), ((b"ic12", "png"),)),
         ((48, 48, 1), ((b"ih32", "32"), (b"h8mk", "mk"))),
         ((32, 32, 1), ((b"icp5", "png"), (b"il32", "32"), (b"l8mk", "mk"))),
         ((16, 16, 2), ((b"ic11", "png"),)),
         ((16, 16, 1), ((b"icp4", "png"), (b"is32", "32"),
                        (b"s8mk", "mk"))))
# IcnsImagePlugin._save: each entry's type and square size, in its order
SAVE_SIZES = ((b"ic07", 128), (b"ic08", 256), (b"ic09", 512),
              (b"ic10", 1024), (b"ic11", 32), (b"ic12", 64), (b"ic13", 256),
              (b"ic14", 512))
_J2K_SIGNATURES = (b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a")
_JP2 = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"


def _unidentified(path, why: str) -> ValueError:
    return ValueError(f"{path}: cannot identify image file ({why})")


def icns_entries(data: bytes, path) -> dict:
    """IcnsFile.__init__: each entry's type -> (start, length) of its
    data."""
    if len(data) < 8:
        raise _unidentified(path, "an ICNS header that ends early")
    filesize = struct.unpack_from(">I", data, 4)[0]
    entries, i = {}, 8
    while i < filesize:
        if i + 8 > len(data):
            raise _unidentified(path, "an ICNS entry header that ends early")
        sig, blocksize = struct.unpack_from(">4sI", data, i)
        if blocksize <= 0:
            raise _unidentified(path, "invalid block header")
        entries[sig] = (i + 8, blocksize - 8)
        i += blocksize
    return entries


def icns_sizes(entries: dict) -> list:
    """IcnsFile.itersizes: ``info["sizes"]``."""
    return [size for size, kinds in SIZES
            if any(code in entries for code, _ in kinds)]


def icns_header(data: bytes, path) -> dict:
    """IcnsImageFile._open: the entries, ``info["sizes"]``, the size
    shown (width x scale, height x scale) and the best size."""
    entries = icns_entries(data, path)
    sizes = icns_sizes(entries)
    if not sizes:
        raise _unidentified(path, "No 32bit icon resources found")
    best = max(sizes)
    return dict(entries=entries, sizes=sizes, best=best,
                size=(best[0] * best[2], best[1] * best[2]))


def _to_rgba(a: np.ndarray, mode: str, path) -> np.ndarray:
    """``convert("RGBA")`` of a JPEG 2000 image."""
    if mode == "RGBA":
        return a
    if mode == "RGB":
        rgb = a
    elif mode == "L":
        rgb = np.repeat(a[..., None], 3, -1)
    elif mode == "LA":
        return np.ascontiguousarray(a[..., [0, 0, 0, 1]])
    else:
        raise ValueError(f"{path}: an ICNS JPEG 2000 entry of mode {mode} "
                         f"is not supported (L, LA, RGB and RGBA are)")
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)],
                          -1)


def _read_image_entry(data: bytes, start: int, length: int, path) -> tuple:
    """read_png_or_jpeg2000: (array, mode)."""
    from mods_tpu_torch.io import image
    sig = data[start:start + 12]
    if sig.startswith(png._SIGNATURE):
        a = png.decode_png(data[start:], path)
        return a, ("P" if data[start + 25:start + 26] == b"\x03"
                   else image._array_mode(a))
    if sig.startswith(_J2K_SIGNATURES) or sig == _JP2:
        a, mode = image._read_j2k(data[start:start + length], path)
        return _to_rgba(a, mode, path), "RGBA"
    raise ValueError(f"{path}: Unsupported icon subimage format")


def _read_32(data: bytes, start: int, length: int, side: int,
             path) -> tuple[np.ndarray, int]:
    """read_32: an (side, side, 3) RGB icon, uncompressed or RLE, and the
    fourth byte of each of PIL's pixels: 255 from the "RGB" unpacker of
    an uncompressed icon, 0 in the zeroed image that the RLE bands are
    put into."""
    n = side * side
    if length == n * 3:
        body = data[start:start + length]
        if len(body) < n * 3:
            raise ValueError(f"{path}: not enough image data")
        return np.frombuffer(body, np.uint8).reshape(side, side, 3), 255
    bands, pos = [], start
    for _ in range(3):
        out, left = bytearray(), n
        while left > 0:
            if pos >= len(data):
                break
            b = data[pos]
            pos += 1
            if b & 0x80:
                count = b - 125
                out += data[pos:pos + 1] * count
                pos += 1
            else:
                count = b + 1
                out += data[pos:pos + count]
                pos += count
            left -= count
        if left != 0:
            raise ValueError(f"{path}: Error reading channel [{left!r} "
                             f"left]")
        if len(out) < n:
            raise ValueError(f"{path}: not enough image data")
        bands.append(np.frombuffer(bytes(out[:n]), np.uint8))
    return np.stack(bands, -1).reshape(side, side, 3), 0


def _load(data: bytes, hd: dict, path) -> tuple[np.ndarray, str, int]:
    """IcnsFile.getimage(bestsize): the loaded image, its mode and, for
    "RGB", the fourth byte of PIL's pixels."""
    best, entries = hd["best"], hd["entries"]
    side = best[0] * best[2]
    channels = {}
    for code, kind in dict(SIZES)[best]:
        if code not in entries:
            continue
        start, length = entries[code]
        if kind == "png":
            channels["RGBA"] = _read_image_entry(data, start, length,
                                                 path) + (255,)
        elif kind == "32t":
            if data[start:start + 4] != bytes(4):
                raise ValueError(f"{path}: Unknown signature, expecting "
                                 f"0x00000000")
            channels["RGB"] = _read_32(data, start + 4, length - 4, side,
                                       path)
        elif kind == "32":
            channels["RGB"] = _read_32(data, start, length, side, path)
        else:
            mask = data[start:start + side * side]
            if len(mask) < side * side:
                raise ValueError(f"{path}: not enough image data")
            channels["A"] = np.frombuffer(mask, np.uint8).reshape(side, side)
    if "RGBA" in channels:
        return channels["RGBA"]
    if "RGB" not in channels:
        raise ValueError(f"{path}: an ICNS size with a mask and no image: "
                         f"PIL refuses it (KeyError: 'RGB')")
    rgb, pad = channels["RGB"]
    if "A" in channels:
        return np.concatenate([rgb, channels["A"][..., None]], -1), "RGBA", 0
    return rgb, "RGB", pad


def read_icns(data: bytes, path) -> tuple[np.ndarray, str]:
    """``np.asarray(Image.open(path))`` of an ICNS file and the mode of
    the loaded image."""
    hd = icns_header(data, path)
    a, mode, pad = _load(data, hd, path)
    h, w = a.shape[:2]
    for size in hd["sizes"]:             # IcnsImageFile.size's setter
        full = size[0] * size[2], size[1] * size[2]
        scale = full[0] // w
        if full[1] / h == scale:
            break
    else:
        raise ValueError(f"{path}: This is not one of the allowed sizes of "
                         f"this image ({w}x{h})")
    if mode == "RGBA":
        return np.ascontiguousarray(a), mode
    if mode == "RGB":
        # the RGBX bytes that the "RGBA" packer writes, shaped as RGB
        rgbx = np.concatenate([a, np.full((h, w, 1), pad, np.uint8)], -1)
        return rgbx.reshape(-1)[:h * w * 3].reshape(h, w, 3), mode
    raise ValueError(f"{path}: No packer found from {mode} to RGBA (PIL "
                     f"cannot give the array of an ICNS whose largest image "
                     f"is {mode})")


def icns_frames(a: np.ndarray, mode: str) -> dict:
    """IcnsImagePlugin._save's image of each square size."""
    resize = raster.resizer(a, mode, "bicubic")
    return {s: resize((s, s)) for s in sorted({s for _, s in SAVE_SIZES})}


def icns_bytes(a: np.ndarray, mode: str) -> bytes:
    """PIL's ICNS: the header, the table of contents, then each entry
    (type, length, the PNG of its size)."""
    if mode == "F":
        raise ValueError("cannot write mode F as PNG")
    streams = {s: png.encode_png(np.clip(f, 0, 65535).astype(np.uint16)
                                 if mode == "I" else f)
               for s, f in icns_frames(a, mode).items()}
    entries = [(code, streams[s]) for code, s in SAVE_SIZES]
    length = 8 + 8 + 8 * len(entries) + sum(8 + len(p) for _, p in entries)
    out = [b"icns", struct.pack(">i", length), b"TOC ",
           struct.pack(">i", 8 + 8 * len(entries))]
    out += [code + struct.pack(">i", 8 + len(p)) for code, p in entries]
    for code, p in entries:
        out += [code, struct.pack(">i", 8 + len(p)), p]
    return b"".join(out)
