"""PDF as PIL 12.1.0 writes one page of an image
(``Image.fromarray(a).save("x.pdf")``, PdfImagePlugin on PdfParser).

The page holds the image as one XObject: mode "L" and "RGB" as a JPEG
(``DCTDecode``, PIL's default JPEG save: ``io/image.py::_jpeg_bytes``),
"LA" and "RGBA" as a JP2 file (``JPXDecode``, PIL's default JPEG 2000
save of a name not ending in ".j2k": ``io/image.py::_j2k_bytes``, with
``SMaskInData 1`` and no ``BitsPerComponent``), and "1" as CCITT Group 4
(``CCITTFaxDecode``): PIL's libtiff save of the page as one strip less its
8-byte header, so that the stream is the coded strip
(``csrc/fax4_encode.cpp``, libtiff's Fax4Encode), a zero byte where the
strip's length is odd, and the TIFF's 9-entry directory.  PIL refuses the
other modes of ``Image.fromarray``.

The objects are PdfParser's, in PdfImagePlugin's order: 4 (Catalog), 5
(Pages), 1 (the image), 2 (the page), 3 (its contents), 6 (Info: the
file's stem as ``/Title``, ``CreationDate`` and ``ModDate`` from
``time.gmtime()`` at save time, as PIL reads the clock), then the xref
table and the trailer.
"""

from __future__ import annotations

import codecs
import ctypes
import functools
import os
import struct
import time

import numpy as np

FAX4_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
    "fax4_encode.cpp")


# ---------------------------------------------------------------------------
# PdfParser's objects as bytes

class Name(str):
    """PdfParser.PdfName of the plain ASCII names PdfImagePlugin uses
    (none needs PdfName's ``#XX`` escapes)."""

    def __bytes__(self) -> bytes:
        return b"/" + self.encode("us-ascii")


class Ref(int):
    """PdfParser.IndirectReference of generation 0."""

    def __bytes__(self) -> bytes:
        return b"%d 0 R" % self


def encode_text(s: str) -> bytes:
    """PdfParser.encode_text: UTF-16BE with its byte order mark."""
    return codecs.BOM_UTF16_BE + s.encode("utf_16_be")


def pdf_repr(x) -> bytes:
    """PdfParser.pdf_repr of the values PdfImagePlugin writes: a dict is a
    PdfDict (its None values left out), a list a PdfArray, a str a text
    string, bytes a literal string with ``\\``, ``(`` and ``)`` escaped
    byte by byte."""
    if x is True:
        return b"true"
    if x is None:
        return b"null"
    if isinstance(x, (Name, Ref)):
        return bytes(x)
    if isinstance(x, (int, float)):
        return str(x).encode("us-ascii")
    if isinstance(x, time.struct_time):
        return b"(D:" + time.strftime("%Y%m%d%H%M%SZ", x).encode(
            "us-ascii") + b")"
    if isinstance(x, dict):
        out = bytearray(b"<<")
        for key, value in x.items():
            if value is not None:
                out.extend(b"\n" + bytes(Name(key)) + b" " + pdf_repr(value))
        return bytes(out + b"\n>>")
    if isinstance(x, list):
        return b"[ " + b" ".join(pdf_repr(v) for v in x) + b" ]"
    if isinstance(x, str):
        return pdf_repr(encode_text(x))
    if isinstance(x, bytes):
        x = x.replace(b"\\", b"\\\\").replace(b"(", b"\\(") \
            .replace(b")", b"\\)")
        return b"(" + x + b")"
    raise TypeError(f"no PDF form for {type(x).__name__}")


# ---------------------------------------------------------------------------
# CCITT Group 4 (csrc/fax4_encode.cpp)

@functools.lru_cache(maxsize=1)
def _fax4_lib():
    from mods_tpu_torch.detectors.mser import build_native
    lib = ctypes.CDLL(build_native(FAX4_SOURCE, "libmods_fax4_encode.so"))
    lib.mods_fax4_encode.restype = ctypes.c_int64
    lib.mods_fax4_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
    return lib


def g4_strip(a: np.ndarray) -> bytes:
    """libtiff's Group 4 strip of a bool page, True a set bit (PIL's mode
    "1" raw mode), which the coder takes as black."""
    pixels = np.ascontiguousarray(a, np.uint8)
    h, w = pixels.shape
    err = ctypes.create_string_buffer(256)
    cap = (w + 7) // 8 * h + 64
    while True:
        out = np.empty(cap, np.uint8)
        n = _fax4_lib().mods_fax4_encode(pixels.ctypes.data, w, h,
                                         out.ctypes.data, cap, err, len(err))
        if n < 0:
            raise ValueError(err.value.decode())
        if n <= cap:
            return out[:n].tobytes()
        cap = n


def _short_or_long(tag: int, v: int) -> bytes:
    """A one-value entry as libtiff's TIFFWriteDirectoryTagShortLong."""
    if v <= 0xFFFF:
        return struct.pack("<HHIHH", tag, 3, 1, v, 0)
    return struct.pack("<HHII", tag, 4, 1, v)


def g4_tiff(a: np.ndarray) -> bytes:
    """PIL's ``save(fp, "TIFF", compression="group4", strip_size=...)`` of
    a bool page through libtiff: the header, the one strip at byte 8, and
    the directory at the next even offset (ImageWidth, ImageLength,
    BitsPerSample 1, Compression 4, Photometric 1, StripOffsets,
    RowsPerStrip, StripByteCounts, PlanarConfiguration 1)."""
    h, w = a.shape
    strip = g4_strip(a)
    pad = len(strip) % 2
    entries = (_short_or_long(256, w) + _short_or_long(257, h)
               + struct.pack("<HHIHH", 258, 3, 1, 1, 0)
               + struct.pack("<HHIHH", 259, 3, 1, 4, 0)
               + struct.pack("<HHIHH", 262, 3, 1, 1, 0)
               + struct.pack("<HHII", 273, 4, 1, 8)
               + _short_or_long(278, h)
               + struct.pack("<HHII", 279, 4, 1, len(strip))
               + struct.pack("<HHIHH", 284, 3, 1, 1, 0))
    return (b"II*\x00" + struct.pack("<I", 8 + len(strip) + pad) + strip
            + bytes(pad) + struct.pack("<H", 9) + entries + bytes(4))


# ---------------------------------------------------------------------------
# PdfImagePlugin._save and _write_image for one page

def pdf_bytes(a: np.ndarray, mode: str, path) -> bytes:
    """PIL's PDF of the array ``a`` of mode ``mode`` saved to ``path``
    (module docstring)."""
    from mods_tpu_torch.io.image import _j2k_bytes, _jpeg_bytes
    if mode not in ("1", "L", "LA", "RGB", "RGBA"):
        raise ValueError(f"cannot save mode {mode} as PDF")
    h, w = a.shape[:2]
    params = None
    extra = {"BitsPerComponent": 8}
    if mode == "1":
        extra["BitsPerComponent"] = 1
        extra["ColorSpace"] = Name("DeviceGray")
        params = [{"K": -1, "BlackIs1": True, "Columns": w, "Rows": h}]
        image_filter = [Name("CCITTFaxDecode")]
        stream = g4_tiff(a)[8:]
    elif mode in ("L", "RGB"):
        extra["ColorSpace"] = Name("DeviceGray" if mode == "L"
                                   else "DeviceRGB")
        image_filter = Name("DCTDecode")
        stream = _jpeg_bytes(a, mode)
    else:
        del extra["BitsPerComponent"]
        extra["SMaskInData"] = 1
        image_filter = Name("JPXDecode")
        stream = _j2k_bytes(a, mode, True)
    procset = "ImageC" if mode in ("RGB", "RGBA") else "ImageB"
    title = os.path.splitext(os.path.basename(os.fspath(path)))[0]
    info = {"Title": title, "CreationDate": time.gmtime(),
            "ModDate": time.gmtime()}

    out = bytearray(b"%PDF-1.4\n% created by Pillow PDF driver\n")
    offsets = {}

    def obj(number: int, d: dict, stream: bytes | None = None) -> None:
        offsets[number] = len(out)
        out.extend(b"%d 0 obj" % number)
        if stream is not None:
            d = dict(d, Length=len(stream))
        if d:
            out.extend(pdf_repr(d))
        if stream is not None:
            out.extend(b"stream\n" + stream + b"\nendstream\n")
        out.extend(b"endobj\n")

    obj(4, {"Type": Name("Catalog"), "Pages": Ref(5)})
    obj(5, {"Type": Name("Pages"), "Count": 1, "Kids": [Ref(2)]})
    obj(1, {"Type": Name("XObject"), "Subtype": Name("Image"), "Width": w,
            "Height": h, "Filter": image_filter, "DecodeParms": params,
            **extra}, stream)
    obj(2, {"Resources": {"ProcSet": [Name("PDF"), Name(procset)],
                          "XObject": {"image": Ref(1)}},
            "MediaBox": [0, 0, w * 72.0 / 72.0, h * 72.0 / 72.0],
            "Contents": Ref(3), "Type": Name("Page"), "Parent": Ref(5)})
    obj(3, {}, b"q %f 0 0 %f 0 0 cm /image Do Q\n"
        % (w * 72.0 / 72.0, h * 72.0 / 72.0))
    obj(6, {k: v for k, v in info.items() if v})
    start_xref = len(out)
    out.extend(b"xref\n0 %d\n0000000000 65536 f \n" % (len(offsets) + 1))
    for number in sorted(offsets):
        out.extend(b"%010d %05d n \n" % (offsets[number], 0))
    out.extend(b"trailer\n" + pdf_repr(
        {"Root": Ref(4), "Size": len(offsets) + 1, "Info": Ref(6)})
        + b"\nstartxref\n%d\n%%%%EOF" % start_xref)
    return bytes(out)
