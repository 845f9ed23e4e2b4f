"""Port vs PIL on TGA, SGI, PCX and QOI files, the extensions that map
onto writers the port has (.j2c .jpc .jpf .jpx as JP2, .mpo as JPEG, .icb
.vda .vst as TGA, .bw .rgb .rgba as SGI), and the refusals of what PIL
reads or writes and the port does not (CPU, Pillow 12.1.0).

The arrays come from a seeded numpy generator, noisy and blocky (so the
RLE coders see runs).  PIL writes the files it can write; the ones it
cannot are built here by hand (``tga_file``, ``sgi_rle_file``,
``pcx_file``), and PIL's reading of them is the reference.

Tolerance: none.  ``save_image`` must write PIL's bytes, or refuse what
PIL refuses with a ValueError naming it; ``io/image.py::_read`` must give
PIL's array (dtype, shape, every value) and mode, ``image_size`` its size,
and ``_format`` the format that ``Image.open`` picks, or raise where PIL
raises.

``python tests/test_torch_raster_formats.py --fixtures`` writes
``chip_smoke.py`` phase 14w's fixtures (``chip_smoke.RASTER_FIXTURES``)
into ``tests/data/image_io``.
"""

import hashlib
import io
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

MODES = ("1", "L", "LA", "RGB", "RGBA", "I;16", "I", "F")


def arrays(seed: int, h: int, w: int) -> dict:
    """One array of each mode of ``io/image.py::_mode``, half noise and
    half 4 x 4 blocks."""
    rng = np.random.default_rng(seed)

    def pick(shape, lo, hi, dtype):
        a = rng.integers(lo, hi, shape, dtype=dtype)
        b = np.repeat(np.repeat(a[::4, ::4], 4, 0), 4, 1)[:h, :w]
        a[:, :w // 2] = b[:, :w // 2]
        return a
    return {"1": pick((h, w), 0, 2, np.uint8) != 0,
            "L": pick((h, w), 0, 256, np.uint8),
            "LA": pick((h, w, 2), 0, 256, np.uint8),
            "RGB": pick((h, w, 3), 0, 256, np.uint8),
            "RGBA": pick((h, w, 4), 0, 256, np.uint8),
            "I;16": pick((h, w), 0, 65536, np.uint16),
            "I": pick((h, w), -300, 70000, np.int32),
            "F": pick((h, w), -99, 999, np.int32).astype(np.float32) / 7}


def hold_read(path) -> None:
    """The port reads ``path`` as PIL does: format, array, mode, size; or
    both raise."""
    try:
        im = Image.open(path)
        want, mode, size, fmt = np.asarray(im), im.mode, im.size, im.format
    except Exception:
        with pytest.raises(ValueError):
            I._read(path)
        return
    data = open(path, "rb").read()
    assert I._format(data, path) == fmt
    got, got_mode = I._read(path)
    assert (got_mode, got.dtype, got.shape) == (mode, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)
    assert I.image_size(path) == size


def hold_write(tmp_path, name: str, a: np.ndarray) -> None:
    """``save_image`` writes PIL's bytes of ``a`` to ``name`` and reads
    them back as PIL does, or both refuse the array."""
    (tmp_path / "pil").mkdir(exist_ok=True)
    (tmp_path / "port").mkdir(exist_ok=True)
    ours, pils = tmp_path / "port" / name, tmp_path / "pil" / name
    try:
        Image.fromarray(a).save(pils)
    except (OSError, ValueError) as e:
        with pytest.raises(ValueError) as got:
            I.save_image(ours, a)
        assert str(e).split()[-1] in str(got.value) or "Unsupported" in \
            str(e) and "Unsupported" in str(got.value), (e, got.value)
        assert not ours.exists()
        return
    I.save_image(ours, a)
    assert ours.read_bytes() == pils.read_bytes()
    hold_read(ours)


# ---------------------------------------------------------------------------
# writers: every mode, PIL's bytes or PIL's refusal

@pytest.mark.parametrize("ext", [".tga", ".sgi", ".pcx", ".qoi"])
@pytest.mark.parametrize("mode", MODES)
def test_writer_bytes_are_pils(tmp_path, ext, mode):
    """Each mode at 1 x 1, 3 x 5 (odd strides), 17 x 70 (runs of more
    than 63, PCX's longest) and 64 x 7."""
    for seed, (h, w) in enumerate(((1, 1), (3, 5), (17, 70), (64, 7))):
        hold_write(tmp_path, f"x{ext}", arrays(seed, h, w)[mode])


@pytest.mark.parametrize("ext", [".j2c", ".jpc", ".jpf", ".jpx", ".mpo",
                                 ".icb", ".vda", ".vst", ".bw", ".rgb",
                                 ".rgba", ".SGI"])
def test_extensions_map_onto_pils_writers(tmp_path, ext):
    """Each extension writes PIL's bytes of an RGB and a gray array (JPEG
    2000's as JP2, since only a name ending in ".j2k" is a codestream;
    MPO's as JPEG; the SGI header's name is the file's)."""
    a = arrays(7, 21, 34)
    for mode in ("L", "RGB"):
        hold_write(tmp_path, f"name_{mode}{ext}", a[mode])


def test_sgi_header_holds_the_base_name(tmp_path):
    """The name in an SGI header is the file's base name without its
    extension, ASCII (other characters dropped), cut to 79 bytes."""
    a = arrays(3, 4, 6)["RGB"]
    for name in ("plain.sgi", "déjà vu.rgb", "x" * 90 + ".bw",
                 ".hidden.sgi", "two.dots.sgi"):
        hold_write(tmp_path, name, a)


# ---------------------------------------------------------------------------
# readers: PIL's own files with its options

def pil_bytes(a, fmt: str, **kw) -> bytes:
    f = io.BytesIO()
    (a if isinstance(a, Image.Image) else Image.fromarray(a)).save(
        f, fmt, **kw)
    return f.getvalue()


PIL_FILES = {
    "tga rle": ("TGA", {"compression": "tga_rle"}),
    "tga rle top-down": ("TGA", {"compression": "tga_rle",
                                 "orientation": 1}),
    "tga raw top-down with an id": ("TGA", {"orientation": 1,
                                            "id_section": b"id\n\x00"}),
    "sgi 2 bytes a sample": ("SGI", {"bpc": 2}),
    "pcx": ("PCX", {}),
    "qoi srgb": ("QOI", {"colorspace": "sRGB"}),
}


@pytest.mark.parametrize("case", sorted(PIL_FILES))
def test_read_pils_files(tmp_path, case):
    """PIL's saves with options in every mode that it writes (a "P" image
    too), at three sizes, read as PIL reads them (PIL's 1-bit TGA RLE,
    which PIL cannot read back, refused too)."""
    fmt, kw = PIL_FILES[case]
    for seed, (h, w) in enumerate(((1, 1), (9, 13), (40, 130))):
        a = arrays(seed, h, w)
        imgs = list(a.values()) + [Image.fromarray(a["RGB"]).convert(
            "P", palette=Image.Palette.ADAPTIVE, colors=40)]
        for img in imgs:
            try:
                data = pil_bytes(img, fmt, **kw)
            except (OSError, ValueError):
                continue
            p = tmp_path / "f"
            p.write_bytes(data)
            hold_read(p)


# ---------------------------------------------------------------------------
# TGA files that PIL does not write

def tga_file(imagetype: int, depth: int, w: int, h: int, body: bytes,
             colormap: bytes = b"", mapdepth: int = 0, flags: int = 0,
             id_section: bytes = b"", map_first: int = 0) -> bytes:
    cm_len = len(colormap) // max(1, mapdepth // 8)
    return (struct.pack("<BBBHHBHHHHBB", len(id_section), 1 if mapdepth
                        else 0, imagetype, map_first, cm_len, mapdepth, 0, 0,
                        w, h, depth, flags) + id_section + colormap + body)


def _tga_cases() -> dict:
    rng = np.random.default_rng(11)
    w, h = 13, 6
    px16 = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    idx = rng.integers(0, 12, (h, w), dtype=np.uint8)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    # RLE of 16-bit pixels: a run of 3, then a literal of the rest
    rows16 = px16.astype("<u2").view(np.uint8).reshape(h, 2 * w)
    rle16 = b"".join(b"\x82" + r[:2].tobytes() + bytes([w - 4])
                     + r[6:].tobytes() for r in rows16)
    far = rgb.copy()
    far[0, 0], far[0, 1, 0] = (255, 255, 255), 127
    gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
    return {
        "BGRA;15Z raw": tga_file(2, 16, w, h, px16.astype("<u2").tobytes()),
        "BGRA;15Z rle, flipped": tga_file(10, 16, w, h, rle16, flags=0x10),
        "P, 16-bit map": tga_file(1, 8, w, h, idx.tobytes(),
                                  rng.bytes(2 * 12), 16),
        "P, 24-bit map, first 3": tga_file(1, 8, w, h, idx.tobytes(),
                                           rng.bytes(3 * 12), 24,
                                           map_first=3),
        "P rle, 16-bit map, top-down flipped": tga_file(
            9, 8, w, h, b"".join(bytes([w - 1]) + r.tobytes() for r in idx),
            rng.bytes(2 * 12), 16, 0x30),
        "a 32-bit map": tga_file(1, 8, w, h, idx.tobytes(),
                                 rng.bytes(4 * 12), 32),
        "RGB with a map": tga_file(2, 24, w, h, rgb.tobytes(),
                                   rng.bytes(3 * 5), 24),
        "a literal over three rows": tga_file(
            11, 8, w, h, bytes([3 * w - 1]) + gray[:3].tobytes()
            + bytes([3 * w - 1]) + gray[3:].tobytes()),
        "a literal past the last row": tga_file(
            11, 8, w, h, bytes([127]) + rng.bytes(128)),
        "a run past its row": tga_file(11, 8, w, h, b"\x80\x07" * (w - 1)
                                       + b"\x81\x07" + bytes(99)),
        "short raw data": tga_file(3, 8, w, h, gray.tobytes()[:-1]),
        "gray of 32 bits": tga_file(3, 32, 2, 2, bytes(16)),
        "colour-mapped without a map": tga_file(1, 8, 2, 2, bytes(4)),
        "a map of 8 bits": tga_file(1, 8, 2, 2, bytes(4), bytes(4), 8),
        "1-bit rle": tga_file(11, 1, 9, 2, b"\x00\xff\x00\x80" * 4),
        "id of 10, PCX's magic": tga_file(3, 8, w, h, gray.tobytes(),
                                          id_section=b"0123456789"),
        # two cursor entries, the first's DIB at the pixels' first bytes
        "CUR's magic, a DIB past the end": tga_file(
            2, 24, w, h, far.tobytes(), map_first=0x200),
        "CUR's magic, a DIB at the start": tga_file(
            2, 24, w, h, np.zeros_like(rgb).tobytes(), map_first=0x200),
        "ICO's magic, no entries": tga_file(1, 8, w, h, idx.tobytes()),
    }


TGA_CASES = _tga_cases()


@pytest.mark.parametrize("case", sorted(TGA_CASES))
def test_tga_files_by_hand(tmp_path, case):
    """16-bit BGRA;15Z pixels, colour maps of 16 and 24 bits (from entry
    0 or later), both orientations and the horizontal flip; what PIL
    cannot load: a colour map of 32 bits, or before true-colour pixels;
    RLE literals over rows and past
    the image, runs past a row and short data (refused, as PIL refuses
    them), modes PIL cannot load, 1-bit RLE (PIL's pixel of depth // 8 =
    0 bytes never fills a row), and TGA headers with PCX's, CUR's and
    ICO's magic that those plugins pass on."""
    p = tmp_path / "f.tga"
    p.write_bytes(TGA_CASES[case])
    hold_read(p)


# ---------------------------------------------------------------------------
# SGI RLE, which PIL reads and does not write

def sgi_rle_file(a: np.ndarray, bpc: int, name: bytes = b"") -> bytes:
    """An RLE SGI of ``a`` ((H, W) or (H, W, Z) samples < 256**bpc): each
    row of each band coded alone in atoms of ``bpc`` bytes (a count atom,
    high bit for a copy, then the samples; a 0 count ends the row) with
    copies and runs of at most 127, its rows bottom-up, after the start
    and length tables."""
    planes = a[..., None] if a.ndim == 2 else a
    h, w, z = planes.shape
    rows, starts, lengths = [], [], []
    at = 512 + 8 * h * z
    for c in range(z):
        for y in range(h):
            v = planes[h - 1 - y, :, c].astype(np.int64)
            out, x = bytearray(), 0
            while x < w:
                run = 1
                while x + run < w and v[x + run] == v[x] and run < 127:
                    run += 1
                if run > 2:
                    out += run.to_bytes(bpc, "big") + int(v[x]).to_bytes(
                        bpc, "big")
                    x += run
                    continue
                n = 1
                while x + n < w and n < 127 and not (
                        x + n + 2 < w and v[x + n] == v[x + n + 1]
                        == v[x + n + 2]):
                    n += 1
                out += (0x80 | n).to_bytes(bpc, "big") + b"".join(
                    int(s).to_bytes(bpc, "big") for s in v[x:x + n])
                x += n
            out += bytes(bpc)
            starts.append(at)
            lengths.append(len(out))
            rows.append(bytes(out))
            at += len(out)
    dim = 3 if z > 1 else 2
    head = struct.pack(">hBBHHHHll4s79ss", 474, 1, bpc, dim, w, h, z, 0,
                       256 ** bpc - 1, b"", name, b"") + struct.pack(
                           ">l404s", 0, b"")
    return (head + struct.pack(f">{h * z}I", *starts)
            + struct.pack(f">{h * z}I", *lengths) + b"".join(rows))


@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("z", [1, 3, 4])
def test_sgi_rle(tmp_path, bpc, z):
    """RLE SGIs of 1 and 2 bytes a sample (the high byte read) in every
    band count, rows of copies and runs."""
    rng = np.random.default_rng(bpc * 10 + z)
    a = rng.integers(0, 256 ** bpc, (23, 150, z)).repeat(2, 1)[:, :150]
    a[5:9] = rng.integers(0, 256 ** bpc)
    p = tmp_path / "f.sgi"
    p.write_bytes(sgi_rle_file(a[..., 0] if z == 1 else a, bpc))
    assert np.asarray(Image.open(p)).shape[:2] == (23, 150)
    hold_read(p)


def test_sgi_rle_failures(tmp_path):
    """A row whose last counted byte is not an end stops the decode (the
    rows after it stay 0); a copy past the row, a start inside the header
    and a 3-dimensional gray header are refused, as PIL refuses them."""
    a = np.arange(40, dtype=np.uint8).reshape(5, 8) * 3
    good = bytearray(sgi_rle_file(a, 1))
    lengths_at = 512 + 4 * 5
    stop = bytearray(good)
    struct.pack_into(">I", stop, lengths_at + 4 * 2, 1)
    past = bytearray(good)
    struct.pack_into(">I", past, 512 + 4 * 1, struct.unpack_from(
        ">I", good, 512)[0])
    past[struct.unpack_from(">I", good, 512)[0]] = 0x80 | 9
    inside = bytearray(good)
    struct.pack_into(">I", inside, 512, 100)
    cube = bytearray(good)
    struct.pack_into(">H", cube, 4, 3)
    for i, data in enumerate((stop, past, inside, cube)):
        p = tmp_path / f"f{i}.sgi"
        p.write_bytes(bytes(data))
        hold_read(p)


# ---------------------------------------------------------------------------
# PCX files that PIL does not write

def pcx_file(w: int, h: int, bits: int, planes: int, body: bytes,
             version: int = 5, stride: int = 0, palette: bytes = b"",
             tail: bytes = b"") -> bytes:
    return (struct.pack("<BBBBHHHHHH", 10, version, 1, bits, 0, 0, w - 1,
                        h - 1, 72, 72) + palette.ljust(48, b"\x00")
            + struct.pack("<BBHHHH", 0, planes, stride, 1, w, h)
            + bytes(54) + body + tail)


def _pcx_cases() -> dict:
    rng = np.random.default_rng(5)
    cases = {}
    for planes in (2, 4):
        w, h = 19, 4
        s = (w + 7) // 8
        cases[f"P;{planes}L"] = pcx_file(
            w, h, 1, planes, bytes(c & 0xBF for c in rng.bytes(
                h * planes * s)), stride=s,
            palette=rng.bytes(48))
    for w in (1, 3, 5, 8):              # PcxDecode.c moves odd strides
        h = 3
        s = w + w % 2
        cases[f"RGB of width {w}"] = pcx_file(
            w, h, 8, 3, b"".join(bytes([c & 0xBF]) for c in rng.bytes(
                3 * s * h)), stride=s)
    gray = bytes(v for i in range(256) for v in (i, i, i))
    cases["L of odd stride given"] = pcx_file(
        7, 4, 8, 1, bytes(range(0, 120, 4)[:28]), stride=7,
        tail=b"\x0c" + gray)
    cases["P from its palette"] = pcx_file(
        6, 2, 8, 1, b"\xc6\xd0" + bytes(range(6)), stride=6,
        tail=b"\x0c" + rng.bytes(768))
    cases["no palette marker"] = pcx_file(
        6, 2, 8, 1, bytes(range(12)) + bytes(800), stride=6)
    cases["shorter than a palette"] = pcx_file(6, 2, 8, 1, bytes(12),
                                               stride=6)
    cases["4 bits a pixel"] = pcx_file(6, 2, 4, 1, bytes(800), stride=4)
    cases["a run past the line"] = pcx_file(
        4, 2, 8, 1, b"\xc9\x01" + bytes(800), stride=4)
    cases["short data"] = pcx_file(30, 30, 1, 1, b"\xc3\x00" * 4, stride=4)
    cases["version 3 gray"] = pcx_file(6, 2, 8, 1, bytes(900), version=3,
                                       stride=6)
    return cases


PCX_CASES = _pcx_cases()


@pytest.mark.parametrize("case", sorted(PCX_CASES))
def test_pcx_files_by_hand(tmp_path, case):
    """2- and 4-plane palettes, RGB whose planes Pillow moves (or, at
    widths where the line's length is a multiple of the width, does not),
    8-bit "L" or "P" by the palette at the end, and what PIL refuses: a
    file shorter than its palette, 4-bit pixels, runs past a line, short
    data, 8 bits in a version-3 file."""
    p = tmp_path / "f.pcx"
    p.write_bytes(PCX_CASES[case])
    hold_read(p)


# ---------------------------------------------------------------------------
# QOI

def test_qoi_ops_and_short_files(tmp_path):
    """Runs of 62 and more, index hits, small and luma differences, alpha
    changes; the decoder's index starts empty (an unseen index gives
    transparent black); a file that stops early is refused."""
    a = np.zeros((40, 50, 4), np.uint8)
    a[..., 3] = 255
    a[10:20] = (10, 200, 30, 255)
    a[20:25] = np.arange(50)[:, None] * (1, 2, 3, 0) + (0, 0, 0, 90)
    a[25:30, ::2] = (255, 0, 0, 7)
    a[30:] = np.random.default_rng(3).integers(0, 256, (10, 50, 4))
    for mode, arr in (("RGBA", a), ("RGB", a[..., :3])):
        data = pil_bytes(arr, "QOI")
        for cut, extra in ((None, b""), (-40, b""), (14, b"\x05\xc5")):
            p = tmp_path / f"{mode}.qoi"
            p.write_bytes(data[:cut] + extra)
            hold_read(p)


# ---------------------------------------------------------------------------
# refusals

@pytest.mark.parametrize("ext", sorted(I._NOT_WRITTEN) + sorted(I._STUBS))
def test_refused_extensions_name_the_format(tmp_path, ext):
    """Every extension that PIL 12.1.0 writes here and the port does not
    raises a ValueError naming the format, PIL's stubs one saying that
    PIL cannot write them either (PIL raises on them); no file is left."""
    a = arrays(1, 8, 8)["RGB"]
    p = tmp_path / f"x{ext}"
    with pytest.raises(ValueError) as e:
        I.save_image(p, a)
    assert not p.exists()
    if ext in I._STUBS:
        assert I._STUBS[ext] in str(e.value) and "either" in str(e.value)
        with pytest.raises(OSError, match="save handler"):
            Image.fromarray(a).save(tmp_path / f"pil{ext}")
    else:
        assert f"writing {I._NOT_WRITTEN[ext]} images" in str(e.value)
        assert Image.registered_extensions()[ext] == I._NOT_WRITTEN[ext]
        assert I._NOT_WRITTEN[ext] in Image.SAVE


@pytest.mark.parametrize("ext", [".blp", ".im", ".msp", ".xbm", ".eps",
                                 ".palm", ".pdf", ".ps"])
def test_bitmap_extensions_write_or_refuse_as_pil(tmp_path, ext):
    """The extensions that left the refused ones when the port learnt to
    write them: an RGB array is written as PIL writes it to ``.im``,
    ``.pdf``, ``.eps`` and ``.ps`` (its bytes, a PDF's with the clock
    fixed) and refused with PIL's reason as ``.msp``, ``.xbm``, ``.blp``
    and ``.palm`` (MSP, XBM and PALM take mode "1" only, BLP "P"
    only)."""
    a = arrays(1, 8, 8)["RGB"]
    with chip_smoke.fixed_gmtime():
        hold_write(tmp_path, f"x{ext}", a)
    assert (tmp_path / "port" / f"x{ext}").exists() == (
        ext in (".im", ".pdf", ".eps", ".ps"))


def test_every_pil_writer_is_written_or_refused():
    """The extensions PIL 12.1.0 saves: each written or named in a
    refusal."""
    ours = set(I._SAVE_FORMATS) | set(I._NOT_WRITTEN) | set(I._STUBS)
    pils = {e for e, f in Image.registered_extensions().items()
            if f in Image.SAVE}
    assert pils == ours


@pytest.mark.parametrize("fmt,kw", [("BLP", {"blp_version": "BLP1"}),
                                    ("XBM", {"hotspot": (3, 5)}),
                                    ("BLP", {}), ("MSP", {}), ("XBM", {}),
                                    ("IM", {}), ("EPS", {}), ("SPIDER", {})])
def test_read_refusals_name_the_format(tmp_path, fmt, kw):
    """Files PIL writes and reads: BLP1 and BLP2, MSP, XBM with and
    without a hotspot, IM and SPIDER are read as PIL reads them (the port
    refused them before it read them); EPS, which the port does not read,
    raises a ValueError naming the format."""
    a = arrays(2, 16, 16)
    img = a["1"] if fmt in ("MSP", "XBM") else a["F"] if fmt == "SPIDER" \
        else a["RGB"]
    if fmt == "BLP":
        img = Image.fromarray(a["RGB"]).convert("P")
    p = tmp_path / "f"
    p.write_bytes(pil_bytes(img, fmt, **kw))
    assert Image.open(p).format == fmt
    if fmt != "EPS":
        hold_read(p)
        return
    with pytest.raises(ValueError, match=fmt):
        I._read(p)


def test_hdr_is_refused_as_pil_refuses_it(tmp_path):
    """Radiance HDR: PIL 12.1.0 does not open it either."""
    p = tmp_path / "f.hdr"
    p.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 2\n"
                  + bytes(16))
    with pytest.raises(Exception):
        Image.open(p)
    with pytest.raises(ValueError, match="HDR.*does not open them either"):
        I._read(p)


# ---------------------------------------------------------------------------
# phase 14w's fixtures

def fixture_files() -> dict:
    """``chip_smoke.RASTER_FIXTURES``: {name: bytes}, each small: PIL's
    saves of seeded arrays and ``tga_file``'s and ``sgi_rle_file``'s of
    formats PIL does not write."""
    a = arrays(20, 47, 61)
    rgba = a["RGBA"].copy()
    rgba[:10, :, 3] = 0
    p_img = Image.fromarray(a["RGB"]).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=24)
    files = {
        "ico_png.ico": pil_bytes(rgba, "ICO"),
        "ico_bmp.ico": pil_bytes(a["RGB"], "ICO", bitmap_format="bmp"),
        "ico_bmp_rgba.ico": pil_bytes(rgba, "ICO", bitmap_format="bmp",
                                      sizes=[(16, 16), (32, 32)]),
        "tga_l_rle.tga": pil_bytes(a["L"], "TGA", compression="tga_rle"),
        "tga_rgb.tga": pil_bytes(a["RGB"], "TGA"),
        "tga_rgba_rle.tga": pil_bytes(rgba, "TGA", compression="tga_rle",
                                      orientation=1),
        "tga_bgr5.tga": TGA_CASES["BGRA;15Z raw"],
        "sgi_rgb.sgi": pil_bytes(a["RGB"], "SGI"),
        "sgi_l16.sgi": pil_bytes(a["L"], "SGI", bpc=2),
        "sgi_rgba_rle.sgi": sgi_rle_file(rgba, 1),
        "sgi_rgb16_rle.sgi": sgi_rle_file(
            a["RGB"].astype(np.uint16) * 257 + 3, 2),
        "pcx_1.pcx": pil_bytes(a["1"], "PCX"),
        "pcx_l.pcx": pil_bytes(a["L"], "PCX"),
        "pcx_p.pcx": pil_bytes(p_img, "PCX"),
        "pcx_rgb.pcx": pil_bytes(a["RGB"], "PCX"),
        "qoi_rgb.qoi": pil_bytes(a["RGB"], "QOI"),
        "qoi_rgba.qoi": pil_bytes(rgba, "QOI"),
    }
    cur = bytearray(pil_bytes(a["L"], "ICO", bitmap_format="bmp"))
    cur[2] = 2                          # a cursor directory: type 2
    files["cursor.cur"] = bytes(cur)
    return files


def write_fixtures(d) -> None:
    os.makedirs(d, exist_ok=True)
    for name, data in fixture_files().items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)


def pil_sha256(a: np.ndarray) -> str:
    """The hash ``chip_smoke._hold_tiff_fixtures`` takes: a mode "1"
    array as 0/255 bytes (the bytes under PIL's own bool arrays)."""
    return hashlib.sha256((a.astype(np.uint8) * 255 if a.dtype == bool
                           else a).tobytes()).hexdigest()


def test_raster_fixtures_are_written_here():
    """The committed fixtures of phase 14w are ``fixture_files``'s bytes,
    each read by the port as PIL reads it, with PIL's shape, mode and
    hash in ``chip_smoke.FORMAT_FIXTURE_SHA256``; under 170 KB in all."""
    files = fixture_files()
    assert set(files) == set(chip_smoke.RASTER_FIXTURES)
    for name, data in files.items():
        path = chip_smoke.IMAGE_FIXTURES / name
        assert path.read_bytes() == data, name
        hold_read(path)
        im = Image.open(path)
        a = np.asarray(im)
        assert chip_smoke.FORMAT_FIXTURE_SHA256[name] == (
            a.shape, im.mode, pil_sha256(a)), name
    assert sum(len(d) for d in files.values()) < 170_000


if __name__ == "__main__":
    if sys.argv[1:] == ["--fixtures"]:
        write_fixtures(chip_smoke.IMAGE_FIXTURES)
    else:
        sys.exit("usage: python tests/test_torch_raster_formats.py "
                 "--fixtures")
