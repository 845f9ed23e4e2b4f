"""FITS files as PIL 12.1.0 reads them for the JAX commands
(``np.asarray(Image.open(path))``, FitsImagePlugin).  PIL does not write
FITS, and neither does the port.

``read_fits(data, path)`` returns PIL's array and mode, ``fits_header``
the size and mode ``Image.open`` reports.  FitsImageFile._open's steps:

* 80-character cards, each keyword the first 8 characters stripped and
  its value what comes before a "/" (a leading "=" dropped); the first
  card must be ``SIMPLE = T``; at each ``END`` the reader moves on to the
  next 2880-byte block and, until it has an image, parses the cards read
  so far (one dictionary for the primary header and every extension);
* the image: ``NAXIS`` 0 gives none (the next header unit is read), 1 a
  column of ``NAXIS1`` rows, more the first two axes; ``BITPIX`` 8, 16,
  32, -32 and -64 give modes "L", "I;16", "I", "F" and "F", whose raw
  modes read the big-endian data as PIL does: as little-endian 16- and
  32-bit integers and 32-bit floats, the rows bottom-up;
* a ``BINTABLE`` extension with ``ZIMAGE = T`` and ``ZCMPTYPE =
  'GZIP_1  '``: the image of ``ZNAXIS*`` and ``ZBITPIX`` after the
  table's rows, gzip-decompressed from there to the end of the file as
  PIL's fits_gzip decoder does, the last ``ZBITPIX / 8`` bytes (at most
  4) of each 4-byte value taken, the rows bottom-up.

PIL's failures are the port's, with PIL's reasons: a file without an
image ("No image data"), a header cut short ("Truncated FITS file"), a
missing or malformed keyword, too little data.
"""

from __future__ import annotations

import gzip
import math
import zlib

import numpy as np

_DTYPES = {"L": "u1", "I;16": "<u2", "I": "<i4", "F": "<f4"}
_MODES = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}


def _get_size(headers: dict, prefix: bytes):
    naxis = int(headers[prefix + b"NAXIS"])
    if naxis == 0:
        return None
    if naxis == 1:
        return 1, int(headers[prefix + b"NAXIS1"])
    return int(headers[prefix + b"NAXIS1"]), int(headers[prefix + b"NAXIS2"])


def _parse_headers(headers: dict) -> tuple:
    """FitsImageFile._parse_headers -> (decoder, offset, size, mode,
    bits)."""
    prefix, decoder, offset = b"", "raw", 0
    if headers.get(b"XTENSION") == b"'BINTABLE'" and \
            headers.get(b"ZIMAGE") == b"T" and \
            headers[b"ZCMPTYPE"] == b"'GZIP_1  '":
        w, h = _get_size(headers, prefix) or (0, 0)
        offset = w * h * (int(headers[b"BITPIX"]) // 8)
        prefix, decoder = b"Z", "fits_gzip"
    size = _get_size(headers, prefix)
    if not size:
        return "", 0, None, None, 0
    bits = int(headers[prefix + b"BITPIX"])
    return decoder, offset, size, _MODES.get(bits), bits


def fits_header(data: bytes, path) -> dict:
    """FitsImageFile._open: the decoder, where its data starts, the size,
    the mode and BITPIX."""
    pos, headers, in_progress, decoder = 0, {}, False, ""
    while True:
        card = data[pos:pos + 80]
        pos += len(card)
        if not card:
            raise ValueError(f"{path}: Truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_progress = True
        elif headers and not in_progress:
            break                                      # a data unit
        elif keyword == b"END":
            pos = math.ceil(pos / 2880) * 2880
            if not decoder:
                try:
                    decoder, offset, size, mode, bits = _parse_headers(
                        headers)
                except KeyError as e:
                    raise ValueError(
                        f"{path}: FITS without the keyword "
                        f"{e.args[0].decode(errors='replace')}: PIL "
                        f"refuses it (KeyError)") from None
                except ValueError as e:
                    raise ValueError(f"{path}: FITS with a malformed value: "
                                     f"PIL refuses it ({e})") from None
            in_progress = False
            continue
        if decoder:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not keyword.startswith(b"SIMPLE") or
                            value != b"T"):
            raise ValueError(f"{path}: cannot identify image file (Not a "
                             f"FITS file)")
        headers[keyword] = value
    if not decoder:
        raise ValueError(f"{path}: No image data (a FITS file without an "
                         f"image)")
    if mode is None:
        raise ValueError(f"{path}: cannot identify image file (a FITS of "
                         f"BITPIX {bits}, which PIL gives no mode)")
    return dict(decoder=decoder, offset=offset + pos - 80, size=size,
                mode=mode, bits=bits)


def read_fits(data: bytes, path) -> tuple[np.ndarray, str]:
    """``np.asarray(Image.open(path))`` of a FITS file and its mode."""
    hd = fits_header(data, path)
    (w, h), mode = hd["size"], hd["mode"]
    dtype = np.dtype(_DTYPES[mode])
    n = w * h * dtype.itemsize
    if hd["decoder"] == "raw":
        body = data[hd["offset"]:hd["offset"] + n]
        if len(body) < n:
            raise ValueError(f"{path}: image file is truncated")
    else:
        try:
            value = gzip.decompress(data[hd["offset"]:])
        except (OSError, EOFError, zlib.error) as e:
            raise ValueError(f"{path}: FITS GZIP_1 data that PIL fails on "
                             f"({e})") from None
        take = min(hd["bits"] // 8, 4)
        if take != dtype.itemsize or len(value) < 4 * w * h:
            raise ValueError(f"{path}: not enough image data")
        body = np.frombuffer(value[:4 * w * h], np.uint8).reshape(
            w * h, 4)[:, 4 - take:].tobytes()
    a = np.frombuffer(body, dtype).reshape(h, w)[::-1]
    return np.ascontiguousarray(a), mode
