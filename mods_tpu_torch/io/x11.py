"""X11 bitmaps (XBM) and pixmaps (XPM) as PIL 12.1.0 reads and writes them
for the JAX commands (``np.asarray(Image.open(path))``,
``Image.fromarray(a).save(path)``; XbmImagePlugin, XpmImagePlugin).

* XBM: the plugin's header regex over the first 512 bytes (the width and
  height ``#define``s, an optional hotspot, then anything up to the last
  ``_bits[]``), then Pillow's XbmDecode.c (``csrc/raster_codec.cpp``'s
  ``mods_xbm_decode``): each byte the two characters after the next
  ``x``, each row a whole number of bytes, bits LSB first, a set bit
  True; mode "1".  Writing is mode "1" only (XbmEncode.c: ``0xNN,`` items,
  a newline after every 15, the last item ended by a newline, then
  ``};``); ``Image.fromarray`` has no hotspot to write.
* XPM, read only: the ``"w h ncolors cpp"`` line, ``ncolors`` palette
  lines of ``cpp``-character keys and their ``c`` colours (``#rrggbb``, or
  ``None``, which only names the transparent key and has no entry; any
  other colour is "cannot read this XPM file"), then the pixel lines'
  text between their first and last quotes, read until the image is
  full.  Up to 256 palette lines give mode "P" (the array holds each
  key's palette index), more give "RGB".  A key without an entry fails
  as PIL's decoder fails.
"""

from __future__ import annotations

import re

import numpy as np

# XbmImagePlugin.xbm_head
_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")
# XpmImagePlugin.xpm_head
_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _lines(data: bytes) -> list:
    """``data`` cut as a binary file's ``readline`` cuts it: each line
    with its newline byte."""
    parts = data.split(b"\n")
    return [p + b"\n" for p in parts[:-1]] + ([parts[-1]] if parts[-1]
                                              else [])


def _unidentified(path, fmt: str, why: str) -> ValueError:
    return ValueError(f"{path}: cannot identify image file (an {fmt} file "
                      f"that PIL's plugin passes on: {why})")


def xbm_header(data: bytes, path) -> dict:
    """XbmImageFile._open: size and where the bits start."""
    m = _XBM_HEAD.match(data[:512])
    if not m:
        raise _unidentified(path, "XBM", "not a XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    if not w or not h:
        raise _unidentified(path, "XBM", f"{w} x {h} pixels")
    return dict(size=(w, h), mode="1", offset=m.end())


def read_xbm(data: bytes, path) -> tuple[np.ndarray, str]:
    from mods_tpu_torch.io.raster import _codec, _decode_failed
    hd = xbm_header(data, path)
    (w, h), body = hd["size"], data[hd["offset"]:]
    stride = (w + 7) // 8
    rows = np.empty((h, stride), np.uint8)
    if _codec().mods_xbm_decode(body, len(body), stride, h,
                                rows.ctypes.data):
        raise _decode_failed(path, -2)
    bits = np.unpackbits(rows, axis=1, bitorder="little")[:, :w]
    return bits.astype(bool), "1"


_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)


def xbm_bytes(a: np.ndarray, mode: str) -> bytes:
    """PIL's XBM of a mode "1" array."""
    if mode != "1":
        raise ValueError(f"cannot write mode {mode} as XBM")
    h, w = a.shape
    v = np.packbits(a, axis=1, bitorder="little").ravel()
    n = v.size
    # every item "0xNN," and a newline after each 15th, but the last item,
    # which ends with a newline alone
    items = np.empty((n, 6), np.uint8)
    items[:, 0], items[:, 1] = ord("0"), ord("x")
    items[:, 2], items[:, 3] = _HEX[v >> 4], _HEX[v & 15]
    items[:, 4], items[:, 5] = ord(","), ord("\n")
    keep = np.ones((n, 6), bool)
    keep[:, 5] = np.arange(1, n + 1) % 15 == 0
    keep[-1, 4:] = (False, True)
    return (f"#define im_width {w}\n#define im_height {h}\n".encode()
            + b"static char im_bits[] = {\n" + items[keep].tobytes()
            + b"};\n")


def xpm_header(data: bytes, path) -> dict:
    """XpmImageFile._open: size, mode, key length, the palette (key ->
    RGB bytes, in the file's order) and where the pixel lines start."""
    lines = _lines(data[9:])
    pos = 9
    m = None
    while lines:
        line = lines.pop(0)
        pos += len(line)
        m = _XPM_HEAD.match(line)
        if m:
            break
    if m is None:
        raise _unidentified(path, "XPM", "broken XPM file")
    try:
        w, h, ncolors, cpp = (int(g) for g in m.groups())
    except ValueError as e:
        raise ValueError(f"{path}: XPM header {m.group(0)!r}: {e}") from None
    palette = {}
    for _ in range(ncolors):
        raw = lines.pop(0) if lines else b""
        pos += len(raw)
        line = raw.rstrip()
        key, words = line[1:cpp + 1], line[cpp + 1:-2].split()
        for i in range(0, len(words), 2):
            if words[i] == b"c":
                if i + 1 >= len(words):
                    raise _unidentified(path, "XPM", "a colour key "
                                        "without a colour")
                rgb = words[i + 1]
                if rgb.startswith(b"#"):
                    v = int(rgb[1:], 16)
                    palette[key] = bytes([v >> 16 & 255, v >> 8 & 255,
                                          v & 255])
                elif rgb != b"None":
                    raise ValueError(f"{path}: cannot read this XPM file "
                                     f"(colour {rgb!r})")
                break
        else:
            raise ValueError(f"{path}: cannot read this XPM file (no colour "
                             f"key in {line!r})")
    if not w or not h:
        raise _unidentified(path, "XPM", f"{w} x {h} pixels")
    return dict(size=(w, h), mode="P" if ncolors <= 256 else "RGB", cpp=cpp,
                palette=palette, offset=pos)


def read_xpm(data: bytes, path) -> tuple[np.ndarray, str]:
    """XpmDecoder: the pixel lines' keys, looked up until the image is
    full."""
    hd = xpm_header(data, path)
    (w, h), mode, cpp, palette = hd["size"], hd["mode"], hd["cpp"], \
        hd["palette"]
    keys = list(palette)
    index = {k: bytes([i & 255]) for i, k in enumerate(keys)}
    table = index if mode == "P" else palette
    need = w * h * (1 if mode == "P" else 3)
    out, got = [], 0
    for line in _lines(data[hd["offset"]:]):
        if got >= need:
            break
        text = b'"'.join(line.split(b'"')[1:-1])
        for i in range(0, len(text), cpp):
            key = text[i:i + cpp]
            if key not in table:
                raise ValueError(f"{path}: XPM pixel key {key!r} has no "
                                 f"palette entry: PIL fails on it")
            out.append(table[key])
            got += len(table[key])
    if got < need:
        raise ValueError(f"{path}: not enough image data")
    a = np.frombuffer(b"".join(out)[:need], np.uint8)
    return a.reshape((h, w) if mode == "P" else (h, w, 3)).copy(), mode
