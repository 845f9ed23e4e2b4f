"""Port vs PIL on MSP, XBM, XPM, Sun raster and BLP files, read and written
as the JAX commands do through PIL (``np.asarray(Image.open(path))``,
``Image.fromarray(a).save(path)``, Pillow 12.1.0) (CPU).

PIL writes MSP version 1, XBM (with and without a hotspot) and BLP1 and
BLP2 palette files; everything else is built here: MSP version 2
(``msp2_file``), XPM (``xpm_file``), Sun raster (``sun_file``,
``sun_rle``) and BLP's JPEG and DXT files (``blp1_jpeg``, ``blp2_file``,
random blocks).  PIL's reading of each is the reference.  The arrays come
from a seeded numpy generator.

Tolerance: none.  ``io/image.py::_read`` must give PIL's array (dtype,
shape, every value) and mode, ``image_size`` its size and ``_format`` the
format ``Image.open`` picks, or raise a ValueError where PIL fails
(``test_torch_raster_formats.hold_read``); ``save_image`` must write
PIL's bytes, or refuse what PIL refuses with its reason
(``hold_write``).
"""

import os
import struct
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytest  # noqa: E402
from PIL import Image  # noqa: E402

import chip_smoke  # noqa: E402
from mods_tpu_torch.io import image as I  # noqa: E402
from test_torch_psd_dcx_fits import hold as hold_named  # noqa: E402
from test_torch_psd_dcx_fits import hold_fixtures  # noqa: E402
from test_torch_raster_formats import (MODES, arrays, hold_read,  # noqa: E402
                                       hold_write, pil_bytes)


def hold(tmp_path, data: bytes, name: str = "f"):
    """``hold_read`` on ``data`` in a file of no extension; PIL's array,
    or None where PIL fails."""
    return hold_named(tmp_path, data, name)


# ---------------------------------------------------------------------------
# MSP

def msp2_file(w: int, h: int, rows: list, magic: bytes = b"LinS",
              checksum: bool = True) -> bytes:
    """A version-2 MSP: the header (its checksum in word 12), the row map
    and the rows, each already coded."""
    words = [*struct.unpack("<2H", magic), w, h, 1, 1, 1, 1, w, h] + [0] * 6
    if checksum:
        for word in words[:12]:
            words[12] ^= word
    return (struct.pack("<16H", *words)
            + struct.pack(f"<{len(rows)}H", *map(len, rows)) + b"".join(rows))


def msp_runs(row: bytes) -> bytes:
    """One row in MSP's runs: a run of 3 to 255 equal bytes as 0, count,
    byte; the rest as literals of 1 to 255 bytes."""
    out, i, lit = bytearray(), 0, bytearray()

    def flush():
        while lit:
            out.append(min(len(lit), 255))
            out.extend(lit[:255])
            del lit[:255]
    while i < len(row):
        j = i
        while j < len(row) and row[j] == row[i] and j - i < 255:
            j += 1
        if j - i >= 3:
            flush()
            out += bytes([0, j - i, row[i]])
            i = j
        else:
            lit.append(row[i])
            i += 1
    flush()
    return bytes(out)


def msp2_of(a: np.ndarray) -> bytes:
    rows = np.packbits(a, axis=1)
    return msp2_file(a.shape[1], a.shape[0],
                     [msp_runs(r.tobytes()) for r in rows])


@pytest.mark.parametrize("size", [(1, 1), (3, 5), (17, 70), (40, 600)])
def test_msp(tmp_path, size):
    """PIL's version-1 saves and version-2 files of the same bits (runs
    and literals, rows of 600 pixels), read as PIL reads them."""
    a = arrays(sum(size), *size)["1"]
    assert hold(tmp_path, pil_bytes(a, "MSP")) is not None
    assert hold(tmp_path, msp2_of(a)) is not None


def test_msp2_rows(tmp_path):
    """A row of length 0 is white; rows whose runs give more or fewer
    bytes than a line shift the lines after them, as PIL's stream of rows
    does; a literal cut by its row's end."""
    w, h = 20, 4
    rows = [b"", b"\x00\x03\x0f", b"\x05abcde\x00\x02\x81",
            b"\x09xyz"]
    assert hold(tmp_path, msp2_file(w, h, rows)) is not None


REFUSED_MSP = {
    "bad checksum": lambda: msp2_file(8, 2, [b"\x01a", b"\x01b"],
                                      checksum=False),
    "short header": lambda: b"DanM" + bytes(20),
    "width 0": lambda: msp2_file(0, 2, [b"", b""]),
    "v1 truncated": lambda: pil_bytes(arrays(1, 9, 30)["1"], "MSP")[:-3],
    "row map cut short": lambda: msp2_file(8, 4, [b"\x01a"])[:34],
    "row cut short": lambda: msp2_file(8, 2, [b"\x01a", b"\x01b"])[:-1],
    "run cut short": lambda: msp2_file(8, 2, [b"\x01a", b"\x00\x01"]),
    "not enough data": lambda: msp2_file(64, 2, [b"\x01a", b"\x01b"]),
}


@pytest.mark.parametrize("case", sorted(REFUSED_MSP))
def test_msp_refusals(tmp_path, case):
    """PIL's failures, each a ValueError: a bad checksum, a short header,
    an empty side (PIL cannot identify these), version-1 data cut short,
    a row map, a row or a run cut short, too few bytes for the image."""
    assert hold(tmp_path, REFUSED_MSP[case]()) is None


# ---------------------------------------------------------------------------
# XBM

@pytest.mark.parametrize("size", [(1, 1), (3, 5), (17, 70), (64, 7),
                                  (15, 8), (2, 121)])
def test_xbm_writer_and_pils_files(tmp_path, size):
    """PIL's bytes of a bool array (items of 15 to a line, rows of 8 and
    of 121 pixels) and PIL's files with a hotspot, read as PIL reads
    them."""
    a = arrays(sum(size), *size)["1"]
    hold_write(tmp_path, "x.xbm", a)
    assert hold(tmp_path, pil_bytes(a, "XBM", hotspot=(2, 1))) is not None


XBM_CASES = {
    "0X skipped, upper-case digits": b"#define a_width 9\n"
    b"#define a_height 1\nstatic char a_bits[]={0XFF,0x1A,0x0f,0Xc3};",
    "leading whitespace": b"  \n#define a_width 3\n#define a_height 1\n"
    b"static unsigned char a_bits[] = { 0x05 };",
    "not hex after x": b"#define a_width 8\n#define a_height 2\n"
    b"char a_bits[] = { 0xzz, 0x1g };",
    "two _bits[] in the header": b"#define a_width 8\n#define a_height 1\n"
    b"char b_bits[] c_bits[] = { 0x81 };",
    "hotspot names with underscores": b"#define a_width 8\n"
    b"#define a_height 1\n#define a_b_x_hot 1\n#define a_b_y_hot 2\n"
    b"char a_bits[] = { 0x81 };",
    "\\r\\n lines": b"#define a_width 16\r\n#define a_height 1\r\n"
    b"char a_bits[] = {\r\n 0x81, 0x7e };\r\n",
    "cut short": b"#define a_width 16\n#define a_height 2\n"
    b"char a_bits[] = { 0x81, 0x7e, 0x1",
    "header past 512 bytes": b"#define a_width 8\n#define a_height 1\n"
    + b" " * 600 + b"char a_bits[] = { 0x81 };",
    "no height": b"#define a_width 8\nchar a_bits[] = { 0x81 };",
}


@pytest.mark.parametrize("case", sorted(XBM_CASES))
def test_xbm_files_by_hand(tmp_path, case):
    """XbmDecode.c's rules: the two characters after each ``x`` (not
    ``X``; upper-case digits, a non-hex character as 0), LSB first; the header's regex
    (leading whitespace, the last ``_bits[]``, a hotspot, ``\\r\\n``); and
    what PIL refuses: data cut short, a header not matched in 512
    bytes."""
    hold(tmp_path, XBM_CASES[case])


# ---------------------------------------------------------------------------
# the writers' refusals

@pytest.mark.parametrize("ext", [".msp", ".xbm", ".blp"])
def test_writers_refuse_as_pil_refuses(tmp_path, ext):
    """MSP and XBM are written from mode "1" only and BLP from "P" only:
    every other mode of ``Image.fromarray`` (and for BLP every mode) is
    refused with PIL's reason, and no file is left."""
    for i, mode in enumerate(MODES):
        hold_write(tmp_path, f"x{i}{ext}", arrays(5, 6, 10)[mode])


# ---------------------------------------------------------------------------
# XPM

def xpm_file(idx: np.ndarray, keys: list, colours: list,
             comments: bool = True) -> bytes:
    """An XPM of the palette indices ``idx``: ``keys[i]`` coloured
    ``colours[i]`` (b"#rrggbb" or b"None")."""
    h, w = idx.shape
    lines = [b"/* XPM */", b"static char *x[] = {"]
    if comments:
        lines.append(b"/* columns rows colors chars-per-pixel */")
    lines.append(b'"%d %d %d %d",' % (w, h, len(keys), len(keys[0])))
    lines += [b'"%s c %s",' % (k, c) for k, c in zip(keys, colours)]
    if comments:
        lines.append(b"/* pixels */")
    lines += [b'"' + b"".join(keys[i] for i in row) + b'",' for row in idx]
    return b"\n".join(lines) + b"\n};\n"


def rgb_colours(rng, n: int) -> list:
    return [b"#%06x" % v for v in rng.integers(0, 1 << 24, n)]


def unknown_key(xpm: bytes) -> bytes:
    """``xpm`` with its last pixel row's first key made "~", which no
    palette line names."""
    lines = xpm.split(b"\n")
    lines[-3] = b'"~' + lines[-3][2:]
    return b"\n".join(lines)


def xpm_cases() -> dict:
    rng = np.random.default_rng(12)
    one = [bytes([c]) for c in b" .+@#$%&*=-;>,')!~{]^/(_:<[}|1234567890"]
    two = [bytes([a, b]) for a in b"abcdefghijklmnopqrst" for b in
           b"ABCDEFGHIJKLMNOP"]
    idx = rng.integers(0, 12, (9, 14))
    big = rng.integers(0, 300, (11, 23))
    none = list(rgb_colours(rng, 5))
    none[2] = b"None"
    return {
        "1-character keys": xpm_file(idx, one[:12], rgb_colours(rng, 12)),
        "2-character keys": xpm_file(rng.integers(0, 200, (7, 9)), two[:200],
                                     rgb_colours(rng, 200), False),
        "more than 256 colours": xpm_file(big, two[:300],
                                          rgb_colours(rng, 300)),
        "None unused": xpm_file(rng.integers(0, 2, (4, 5)), one[:5], none),
        "None used": xpm_file(rng.integers(0, 5, (4, 5)), one[:5], none),
        "a colour name": xpm_file(idx, one[:12], [b"red"] * 12),
        "no colour key": xpm_file(idx, one[:12], rgb_colours(rng, 12))
        .replace(b'"  c ', b'"  m '),
        "an unknown key": unknown_key(xpm_file(idx, one[:12],
                                               rgb_colours(rng, 12))),
        "rows cut short": xpm_file(idx, one[:12],
                                   rgb_colours(rng, 12)).rsplit(b"\n", 5)[0],
        "no header line": b"/* XPM */\nstatic char *x[] = {\n};\n",
    }


XPM_CASES = xpm_cases()


@pytest.mark.parametrize("case", sorted(XPM_CASES))
def test_xpm(tmp_path, case):
    """1- and 2-character keys as "P" (the indices), more than 256 colours
    as RGB, a None colour (no palette entry: a pixel of it fails as PIL
    fails), and PIL's refusals: a colour name, a line without a ``c`` key,
    a pixel key without an entry, rows cut short, no header line."""
    hold(tmp_path, XPM_CASES[case])


# ---------------------------------------------------------------------------
# Sun raster

def sun_file(w: int, h: int, depth: int, body: bytes, file_type: int = 1,
             palette: bytes = b"", palette_type: int = 1) -> bytes:
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(body), file_type,
                       palette_type if palette else 0, len(palette)) \
        + palette + body


def sun_rle(data: bytes) -> bytes:
    """Sun's RLE of a byte stream: runs of 3 to 256 as 0x80, n - 1, byte;
    a single 0x80 as 0x80 0; other bytes as themselves."""
    out, i = bytearray(), 0
    while i < len(data):
        j = i
        while j < len(data) and data[j] == data[i] and j - i < 256:
            j += 1
        if j - i >= 3:
            out += bytes([0x80, j - i - 1, data[i]])
            i = j
        elif data[i] == 0x80:
            out += b"\x80\x00"
            i += 1
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


def sun_rows(rng, w: int, h: int, depth: int, padded: bool = True) -> bytes:
    """Blocky rows of ``depth``-bit pixels, padded to 16 bits where
    ``padded`` (the raw layout), else not (the RLE decoder's lines)."""
    row = (w * depth + 7) // 8
    stride = (w * depth + 15) // 16 * 2 if padded else row
    v = np.repeat(rng.integers(0, 256, (h, (stride + 3) // 4), np.uint8),
                  4, 1)[:, :stride]
    v[:, row // 2::3] = 0x80
    return v.tobytes()


SUN_CASES = {}
for _depth in (1, 4, 8, 24, 32):
    for _ftype in (0, 1, 3):
        SUN_CASES[f"{_depth}-bit type {_ftype}"] = (_depth, _ftype, False)
    SUN_CASES[f"{_depth}-bit rle"] = (_depth, 2, False)
for _depth in (4, 8):
    SUN_CASES[f"{_depth}-bit with a colour map"] = (_depth, 1, True)
SUN_CASES["8-bit rle with a colour map"] = (8, 2, True)


@pytest.mark.parametrize("case", sorted(SUN_CASES))
def test_sun(tmp_path, case):
    """Each depth in each raw file type (BGR and BGRX but RGB and RGBX in
    type 3; 1-bit inverted; 4-bit gray x 17, or the indices with a map)
    at widths whose rows are padded to 16 bits, and in RLE (runs over
    rows, literal 0x80s), with and without a colour map."""
    depth, ftype, mapped = SUN_CASES[case]
    rng = np.random.default_rng(depth * 10 + ftype)
    palette = rng.bytes(3 * 16) if mapped else b""
    for w, h in ((3, 1), (7, 3), (33, 5)):
        body = sun_rows(rng, w, h, depth, ftype != 2)
        if ftype == 2:
            body = sun_rle(body)
        assert hold(tmp_path, sun_file(w, h, depth, body, ftype, palette)) \
            is not None


def test_sun_one_pixel_wide_is_a_gimp_brush_to_pil(tmp_path):
    """A Sun raster 1 pixel wide whose length field is 1 or 4 passes
    GbrImagePlugin's checks, which PIL runs first: PIL opens it as a GIMP
    brush and fails to load it, and the port refuses it naming GBR; with
    another length it is read as a Sun raster."""
    for depth, body in ((24, bytes(4)), (8, b"\x07\x00"), (1, b"\x80\x00"),
                        (8, b"\x07\x00" * 2)):
        data = sun_file(1, len(body) // 2, depth, body)
        p = tmp_path / "f.ras"
        p.write_bytes(data)
        if len(body) == 4:
            assert Image.open(p).format == "GBR"
            with pytest.raises(ValueError, match="GBR"):
                I._read(p)
        hold_read(p)


def test_sun_rle_runs(tmp_path):
    """SunRleDecode.c's runs that pass a line's end: the rest fills the
    next lines, counted in 8 bits (a run of 256 over a line's end wraps);
    a file that ends inside a run is refused."""
    w, h = 10, 40
    for body in (b"\x80\x1e\x07" + b"\x05" * 400,
                 b"\x80\xff\x07" + b"\x80\xff\x09" * 3,
                 b"\x80\x04\x07" + b"\x80\xff\x08" + b"\x80\xff\x09" * 2,
                 b"\x80\x00" * 5 + b"\x80\x05"):
        hold(tmp_path, sun_file(w, h, 8, body, 2))


REFUSED_SUN = {
    "depth 16": sun_file(4, 4, 16, bytes(32)),
    "a colour map over 1024 bytes": sun_file(4, 4, 8, bytes(16),
                                             palette=bytes(1027)),
    "a raw colour map": sun_file(4, 4, 8, bytes(16), palette=bytes(12),
                                 palette_type=2),
    "file type 6": sun_file(4, 4, 8, bytes(16), 6),
    "a short header": sun_file(4, 4, 8, b"")[:20],
    "data cut short": sun_file(5, 4, 24, bytes(50)),
    "width 0": sun_file(0, 4, 8, bytes(16)),
    "a colour map on a 1-bit image": sun_file(16, 2, 1, bytes(4),
                                              palette=bytes(6)),
    "a colour map on a 24-bit image": sun_file(4, 2, 24, bytes(24),
                                               palette=bytes(6)),
}


@pytest.mark.parametrize("case", sorted(REFUSED_SUN))
def test_sun_refusals(tmp_path, case):
    """PIL's refusals, each a ValueError: a depth, colour map length or
    type, or file type it does not read, a short header, data cut short,
    an empty side, a colour map on a 1-bit or an RGB image (PIL cannot
    load it)."""
    assert hold(tmp_path, REFUSED_SUN[case]) is None


# ---------------------------------------------------------------------------
# BLP

def blp_tables(offset: int, length: int) -> bytes:
    return struct.pack("<16I", offset, *(0,) * 15) + struct.pack(
        "<16I", length, *(0,) * 15)


def blp2_file(w: int, h: int, encoding: int, alpha: int, alpha_encoding: int,
              payload: bytes, palette: bytes = b"", compression: int = 1,
              gap: int = 0) -> bytes:
    """A BLP2: the header, the mipmap tables (mipmap 0 ``gap`` bytes after
    the palette), a 256-entry BGRA palette, mipmap 0."""
    palette = palette or bytes(range(256)) * 4
    offset = 20 + 128 + 1024 + gap
    return (b"BLP2" + struct.pack("<ibbbbII", compression, encoding, alpha,
                                  alpha_encoding, 0, w, h)
            + blp_tables(offset, len(payload)) + palette + bytes(gap)
            + payload)


def blp1_jpeg(w: int, h: int, jpeg: bytes, alpha: int, split: int,
              gap: int = 0) -> bytes:
    """A BLP1 of compression 0: the JPEG's first ``split`` bytes as the
    shared header, the rest as mipmap 0, ``gap`` bytes between them."""
    head, rest = jpeg[:split], jpeg[split:]
    offset = 28 + 128 + 4 + len(head) + gap
    return (b"BLP1" + struct.pack("<iIIIii", 0, alpha, w, h, 5, 0)
            + blp_tables(offset, len(rest)) + struct.pack("<I", len(head))
            + head + bytes(gap) + rest)


def dxt_blocks(rng, n: int, kind: int) -> bytes:
    """Random DXT blocks; a quarter of DXT1's with colour 0 <= colour 1
    (its 3-colour mode), and DXT5's alphas both ways round."""
    size = 8 if kind == 1 else 16
    b = rng.integers(0, 256, (n, size), np.uint8)
    c = b[:, size - 8:size - 4].copy().view("<u2")
    swap = np.arange(n) % 4 == 0
    lo, hi = np.minimum(c[:, 0], c[:, 1]), np.maximum(c[:, 0], c[:, 1])
    c[:, 0], c[:, 1] = np.where(swap, lo, hi), np.where(swap, hi, lo)
    c[::7, 1] = c[::7, 0]
    b[:, size - 8:size - 4] = c.view(np.uint8)
    return b.tobytes()


def jpeg_of(a: np.ndarray, cmyk: bool = False) -> bytes:
    img = Image.fromarray(a)
    return pil_bytes(img.convert("CMYK") if cmyk else img, "JPEG",
                     quality=90)


def blp_cases() -> dict:
    rng = np.random.default_rng(9)
    a = arrays(9, 21, 26)
    cases = {}
    for alpha in (0, 1):
        for kind, ae in ((1, 0), (2, 1), (3, 7)):
            for w, h in ((16, 8), (13, 7)):
                n = ((w + 3) // 4) * ((h + 3) // 4)
                cases[f"DXT{2 * kind - 1} alpha {alpha} {w}x{h}"] = blp2_file(
                    w, h, 2, alpha, ae, dxt_blocks(rng, n, kind))
    for alpha in (0, 1):
        pal = rng.bytes(1024)
        cases[f"BLP2 palette alpha {alpha}"] = blp2_file(
            19, 11, 1, alpha, 0, rng.bytes(19 * 11), pal, gap=5)
        cases[f"BLP1 palette alpha {alpha}"] = (
            b"BLP1" + struct.pack("<iIIIii", 1, alpha, 9, 6, 4, 0)
            + blp_tables(0, 54) + pal + rng.bytes(54))
    for name, arr, cmyk in (("gray", a["L"], False), ("RGB", a["RGB"], False),
                            ("CMYK", a["RGB"], True)):
        jpeg = jpeg_of(arr, cmyk)
        for alpha in (0, 1):
            cases[f"BLP1 JPEG {name} alpha {alpha}"] = blp1_jpeg(
                26, 21, jpeg, alpha, 200 + 7 * alpha, gap=3 * alpha)
    jpeg = jpeg_of(a["RGB"])
    cases["BLP1 JPEG larger than its header's size"] = blp1_jpeg(
        20, 9, jpeg, 0, 300)
    cases["BLP1 JPEG smaller than its header's size"] = blp1_jpeg(
        30, 21, jpeg, 0, 300)
    cases["BLP2 raw BGRA (encoding 3)"] = blp2_file(4, 4, 3, 8, 0,
                                                    rng.bytes(64))
    cases["BLP2 alpha encoding 8"] = blp2_file(4, 4, 2, 1, 8, rng.bytes(16))
    cases["BLP2 compression 0"] = blp2_file(4, 4, 1, 0, 0, bytes(16),
                                            compression=0)
    cases["BLP1 encoding 3"] = (b"BLP1" + struct.pack("<iIIIii", 1, 0, 4, 4,
                                                      3, 0)
                                + blp_tables(0, 16) + bytes(1024 + 16))
    cases["BLP1 compression 2"] = (b"BLP1" + struct.pack("<iIIIii", 2, 0, 4,
                                                         4, 5, 0)
                                   + blp_tables(0, 16) + bytes(1040))
    cases["DXT1 cut short"] = blp2_file(8, 8, 2, 0, 0, bytes(20))
    cases["palette cut short"] = blp2_file(8, 8, 1, 0, 0, b"")[:600]
    cases["indices cut short"] = blp2_file(8, 8, 1, 0, 0, bytes(10))
    cases["a short header"] = b"BLP2" + bytes(10)
    return cases


BLP_CASES = blp_cases()


@pytest.mark.parametrize("case", sorted(BLP_CASES))
def test_blp_files_by_hand(tmp_path, case):
    """BLP2 DXT1 (with and without the alpha field: its transparent code),
    DXT3 and DXT5 of random blocks, decoded with the plugin's arithmetic
    (5:6:5 shifted without repeating high bits), at widths that are and
    are not multiples of 4 (PIL's rows skew); palette files of BLP1 and
    BLP2 (a gap before BLP2's mipmap); BLP1 JPEGs (gray, RGB, CMYK; a
    header and mipmap split; alpha 255) read with red and blue swapped,
    and JPEGs larger and smaller than the header's size; and PIL's
    refusals: BLP2's raw BGRA (encoding 3), an alpha encoding, a
    compression or an encoding it does not know, data cut short."""
    hold(tmp_path, BLP_CASES[case])


@pytest.mark.parametrize("version", ["BLP1", "BLP2"])
def test_blp_pils_files(tmp_path, version):
    """PIL's BLP saves of "P" images (RGB and RGBA palettes, 3 sizes)."""
    for seed, (h, w) in enumerate(((1, 1), (9, 13), (40, 30))):
        a = arrays(seed, h, w)
        for img in (Image.fromarray(a["RGB"]).convert("P"),
                    Image.fromarray(a["RGBA"]).convert(
                        "P", palette=Image.Palette.ADAPTIVE)):
            assert hold(tmp_path, pil_bytes(img, "BLP", blp_version=version)
                        ) is not None


def test_blp_dxt_is_not_bcn_decode(tmp_path):
    """The witness: a DXT1 block whose 5:6:5 colours have their low bits
    set reads otherwise as a BLP (the plugin's shifts) than as a DDS
    (BcnDecode.c repeats the high bits), each as PIL reads it."""
    from test_torch_dds import dds_file
    block = struct.pack("<HHI", 0xFFFF, 0x0841, 0xE4E4E4E4)
    blp = hold(tmp_path, blp2_file(4, 4, 2, 1, 0, block))
    dds = hold(tmp_path, dds_file(4, 4, block, code=b"DXT1"), "f.dds")
    assert blp[0, 0].tolist() == [248, 252, 248, 255]
    assert dds[0, 0].tolist() == [255, 255, 255, 255]


# ---------------------------------------------------------------------------
# chip_smoke.py phase 14zd's fixtures

def fixture_files() -> dict:
    """The MSP, XBM, XPM, Sun raster and BLP files of
    ``chip_smoke.BITMAP_FIXTURES``, each small."""
    a = arrays(21, 23, 31)
    rng = np.random.default_rng(22)
    out = {"msp_v1.msp": pil_bytes(a["1"], "MSP"),
           "msp_v2.msp": msp2_of(a["1"]),
           "xbm.xbm": pil_bytes(a["1"], "XBM"),
           "xbm_hotspot.xbm": pil_bytes(a["1"], "XBM", hotspot=(5, 7)),
           "xpm_1char.xpm": XPM_CASES["1-character keys"],
           "xpm_2char.xpm": XPM_CASES["2-character keys"],
           "xpm_rgb.xpm": XPM_CASES["more than 256 colours"]}
    for depth, ftype, mapped, name in (
            (1, 1, False, "sun_1.ras"), (8, 1, True, "sun_8_map.ras"),
            (24, 1, False, "sun_24.ras"), (32, 3, False, "sun_32_rgb.ras"),
            (24, 2, False, "sun_24_rle.ras"), (4, 0, False, "sun_4.ras")):
        body = sun_rows(rng, 31, 23, depth, ftype != 2)
        out[name] = sun_file(31, 23, depth, sun_rle(body) if ftype == 2
                             else body, ftype, rng.bytes(48) if mapped
                             else b"")
    out["blp1_jpeg.blp"] = BLP_CASES["BLP1 JPEG RGB alpha 0"]
    out["blp1_jpeg_cmyk.blp"] = BLP_CASES["BLP1 JPEG CMYK alpha 1"]
    out["blp1_palette.blp"] = pil_bytes(Image.fromarray(a["RGB"]).convert(
        "P"), "BLP", blp_version="BLP1")
    out["blp2_palette.blp"] = pil_bytes(Image.fromarray(a["RGBA"]).convert(
        "P", palette=Image.Palette.ADAPTIVE), "BLP")
    for name, case in (("blp2_dxt1.blp", "DXT1 alpha 0 13x7"),
                       ("blp2_dxt1_alpha.blp", "DXT1 alpha 1 16x8"),
                       ("blp2_dxt3.blp", "DXT3 alpha 1 16x8"),
                       ("blp2_dxt5.blp", "DXT5 alpha 1 13x7")):
        out[name] = BLP_CASES[case]
    return out


def test_bitmap_fixtures_are_written_here():
    """Phase 14zd's MSP, XBM, XPM, Sun raster and BLP fixtures, under 60 KB
    in all; with the IM ones (``test_torch_im.fixture_files``) they are
    ``chip_smoke.BITMAP_FIXTURES``."""
    from test_torch_im import fixture_files as im_files
    files = fixture_files()
    hold_fixtures(files, 60_000, chip_smoke.BITMAP_FIXTURES)
    assert set(files) | set(im_files()) == set(chip_smoke.BITMAP_FIXTURES)


if __name__ == "__main__":
    if sys.argv[1:] == ["--fixtures"]:
        for name, data in fixture_files().items():
            (chip_smoke.IMAGE_FIXTURES / name).write_bytes(data)
    else:
        sys.exit("usage: python tests/test_torch_bitmap_formats.py "
                 "--fixtures")
