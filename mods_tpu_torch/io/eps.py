"""EPS as PIL 12.1.0 writes it (``Image.fromarray(a).save("x.eps")`` and
``"x.ps"``: EpsImagePlugin._save with ``eps=1``).

A fixed header (its ``%ImageData`` line with one ``%``), the PostScript
that reads the image, then the pixels as EpsEncode.c writes them: each
byte as two lowercase hex digits, RGB pixels as their three bytes, and a
newline before every 79th digit (39 bytes a line, counted across rows),
none after the last; then ``\\n%%%%EndBinary\\n`` written as it stands
in the plugin, and ``grestore end``.  PIL writes modes "L" and "RGB" and
refuses the other modes of ``Image.fromarray``.
"""

from __future__ import annotations

import numpy as np

# two lowercase hex digits a byte value
_HEX = np.frombuffer(b"".join(b"%02x" % v for v in range(256)),
                     np.uint8).reshape(256, 2)
_LINE = 78                   # digits a line: 39 bytes (EpsEncode.c's 79 / 2)


def hex_lines(data: np.ndarray) -> bytes:
    """EpsEncode.c's hex of the bytes ``data``."""
    digits = _HEX[np.ascontiguousarray(data, np.uint8).reshape(-1)] \
        .reshape(-1)
    lines = -(-digits.size // _LINE)
    text = np.full((lines, _LINE + 1), ord("\n"), np.uint8)
    padded = np.zeros(lines * _LINE, np.uint8)
    padded[:digits.size] = digits
    text[:, :_LINE] = padded.reshape(lines, _LINE)
    return text.reshape(-1)[:digits.size + max(lines - 1, 0)].tobytes()


def eps_bytes(a: np.ndarray, mode: str) -> bytes:
    """PIL's EPS of the array ``a`` of mode ``mode`` (module
    docstring)."""
    if mode == "L":
        bands, operator = 1, b"image"
    elif mode == "RGB":
        bands, operator = 3, b"false 3 colorimage"
    else:
        raise ValueError(f"image mode is not supported (mode {mode} as "
                         f"EPS)")
    h, w = a.shape[:2]
    # the plugin's writes one by one: only some go through "%" formatting
    head = [b"%!PS-Adobe-3.0 EPSF-3.0\n",
            b"%%Creator: PIL 0.1 EpsEncode\n",
            b"%%%%BoundingBox: 0 0 %d %d\n" % (w, h),
            b"%%Pages: 1\n",
            b"%%EndComments\n",
            b"%%Page: 1 1\n",
            b"%%ImageData: %d %d " % (w, h),
            b'%d %d 0 1 1 "%s"\n' % (8, bands, operator),
            b"gsave\n",
            b"10 dict begin\n",
            b"/buf %d string def\n" % (w * bands),
            b"%d %d scale\n" % (w, h),
            b"%d %d 8\n" % (w, h),
            b"[%d 0 0 -%d 0 %d]\n" % (w, h, h),
            b"{ currentfile buf readhexstring pop } bind\n",
            operator + b"\n"]
    return b"".join(head) + hex_lines(a) + b"\n%%%%EndBinary\ngrestore end\n"
