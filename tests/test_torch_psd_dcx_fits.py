"""Port vs PIL on Photoshop (PSD), DCX and FITS files, as the JAX commands
open them through PIL (``np.asarray(Image.open(path))``, Pillow 12.1.0)
(CPU).

PIL writes none of these formats, so the files are built here:
``chip_smoke.psd_bytes`` lays out a PSD (raw or PackBits, with colour
mode data, resources and a layer block), ``dcx_file`` puts a DCX page
table in front of PIL's PCX files, ``fits_file`` writes FITS cards and
data (and ``GZIP_1`` tile-compressed tables).  The arrays come from a
seeded numpy generator.

Tolerance: none.  ``io/image.py::_read`` must give PIL's array (dtype,
shape, every value) and mode, ``image_size`` its size and ``_format`` the
format ``Image.open`` picks, or raise a ValueError where PIL fails
(``test_torch_raster_formats.hold_read``).
"""

import gzip
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
from test_torch_raster_formats import arrays, hold_read  # noqa: E402


def hold(tmp_path, data: bytes, name: str):
    """``hold_read`` on ``data``; PIL's array, or None where PIL fails."""
    p = tmp_path / name
    p.write_bytes(data)
    hold_read(p)
    try:
        return np.asarray(Image.open(p))
    except Exception:
        return None


# ---------------------------------------------------------------------------
# PSD

def resource(rid: int, name: bytes, payload: bytes) -> bytes:
    """An image resource block as Photoshop pads it: the Pascal name to an
    even length, the data to an even length."""
    pname = bytes([len(name)]) + name
    pname += bytes(len(pname) % 2)
    return (b"8BIM" + struct.pack(">H", rid) + pname
            + struct.pack(">I", len(payload)) + payload
            + bytes(len(payload) % 2))


def layer_block(n_layers: int = 2) -> bytes:
    """A layer and mask section that PIL skips: its layer info's length
    and some bytes."""
    info = struct.pack(">h", n_layers) + bytes(40)
    return struct.pack(">I", len(info)) + info + bytes(6)


# (colour mode, bits) -> the channels written and the mode PIL gives
PSD_MODES = {(0, 1): (1, "1"), (0, 8): (1, "L"), (1, 8): (1, "L"),
             (2, 8): (1, "P"), (3, 8): (3, "RGB"), (4, 8): (4, "CMYK"),
             (7, 8): (1, "L"), (8, 8): (1, "L"), (9, 8): (3, "LAB")}


def psd_planes(key, seed=0, h=29, w=37, channels=None):
    """(channels, rows, row bytes) planes of a colour mode: blocky noise,
    bitmaps packed 8 pixels a byte."""
    a = arrays(seed, h, w)
    n = channels or PSD_MODES[key][0]
    if key == (0, 1):
        return np.packbits(a["1"], axis=1)[None]
    base = np.concatenate([a["RGBA"], a["LA"]], -1)
    return np.moveaxis(base[..., :n], -1, 0)


@pytest.mark.parametrize("packbits", [False, True], ids=["raw", "packbits"])
@pytest.mark.parametrize("key", sorted(PSD_MODES),
                         ids=lambda k: f"mode{k[0]}_{k[1]}bit")
def test_psd_modes(tmp_path, key, packbits):
    """Every key of PsdImagePlugin.MODES, raw and PackBits: "1" (set bits
    True), "L" for gray, multichannel and duotone, "P" (the indices; the
    palette from a 768-byte colour mode data), RGB, CMYK (inverted) and
    LAB, at 29 x 37 and 1 x 1."""
    pal = np.random.default_rng(3).integers(0, 256, 768, np.uint8).tobytes()
    for h, w in ((29, 37), (1, 1)):
        planes = psd_planes(key, 1, h, w)
        got = hold(tmp_path, chip_smoke.psd_bytes(
            planes, key[0], key[1], packbits,
            colour_data=pal if key[0] == 2 else b"",
            width=w), "x.psd")
        assert got is not None
        assert Image.open(tmp_path / "x.psd").mode == PSD_MODES[key][1]


@pytest.mark.parametrize("packbits", [False, True], ids=["raw", "packbits"])
@pytest.mark.parametrize("case", ["rgba", "rgb_5_channels", "gray_2_channels",
                                  "cmyk_5_channels", "resources",
                                  "resources_odd", "layers", "colour_data"])
def test_psd_layouts(tmp_path, case, packbits):
    """RGB with exactly 4 channels as RGBA, with 5 as RGB (the extra ones
    not read), gray and CMYK with extra channels; image resources of odd
    and even names and data, a layer block and colour mode data skipped
    as PIL skips them."""
    planes = {"rgba": psd_planes((3, 8), channels=4),
              "rgb_5_channels": psd_planes((3, 8), channels=5),
              "gray_2_channels": psd_planes((1, 8), channels=2),
              "cmyk_5_channels": psd_planes((4, 8), channels=5)}
    colour = {"gray_2_channels": 1, "cmyk_5_channels": 4}.get(case, 3)
    kw = {"resources": dict(resources=resource(1039, b"", b"icc!")
                            + resource(1005, b"ab", bytes(16))),
          "resources_odd": dict(resources=resource(1000, b"x", b"abc")
                                + resource(1001, b"name", bytes(5))),
          "layers": dict(layers=layer_block()),
          "colour_data": dict(colour_data=bytes(range(200)))}.get(case, {})
    data = chip_smoke.psd_bytes(planes.get(case, psd_planes((3, 8))),
                                colour, 8, packbits, **kw)
    assert hold(tmp_path, data, "x.psd") is not None


def test_psd_packbits_runs_cut_at_row_end(tmp_path):
    """PackBitsDecode.c drops the bytes of a run past a row's end and
    starts the next row with the next code; a 0x80 code is skipped; the
    byte count table only places each channel's start."""
    w, h = 9, 4
    rows = [b"\xf0\x07",                      # a run of 17: cut at 9
            b"\x80\x08" + bytes(range(9)),    # a no-op, a literal of 9
            b"\x03abcd\xfb\x09",              # 4 + a run of 6 (cut at 5)
            b"\xf8\x01"]                      # a run of 9
    head = chip_smoke.psd_bytes(np.zeros((1, h, w), np.uint8), 1)
    head = head[:head.index(b"\x00\x01", 26 + 12)]
    data = head + b"\x00\x01" + struct.pack(">4H", *map(len, rows)) + \
        b"".join(rows)
    got = hold(tmp_path, data, "x.psd")
    assert got is not None and (got[0] == 7).all() and (got[3] == 1).all()


REFUSED_PSD = {
    "16_bit": lambda p: chip_smoke.psd_bytes(p, 3, 16, False),
    "not_enough_channels": lambda p: chip_smoke.psd_bytes(p[:2], 3, 8, False),
    "compression_zip": lambda p: chip_smoke.psd_bytes(p, 3, 8, False)
    .replace(b"\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00",
             b"\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x00\x02", 1),
    "version_2": lambda p: chip_smoke.psd_bytes(p, 3, 8, False)
    .replace(b"8BPS\x00\x01", b"8BPS\x00\x02", 1),
    "truncated_raw": lambda p: chip_smoke.psd_bytes(p, 3, 8, False)[:-50],
    "truncated_packbits": lambda p: chip_smoke.psd_bytes(p, 3)[:-50],
    "truncated_resources": lambda p: chip_smoke.psd_bytes(
        p, 3, 8, False, resources=resource(1000, b"", bytes(4000)))[:2000],
}


@pytest.mark.parametrize("case", sorted(REFUSED_PSD))
def test_psd_refusals(tmp_path, case):
    """PIL's failures, each a ValueError here: a 16-bit file (no MODES
    key), fewer channels than the mode needs, ZIP compression (no tile),
    version 2 (PSB: not identified), data or resources cut short."""
    data = REFUSED_PSD[case](psd_planes((3, 8)))
    p = tmp_path / "x.psd"
    p.write_bytes(data)
    with pytest.raises(Exception):
        np.asarray(Image.open(p))
    assert hold(tmp_path, data, "x.psd") is None


# ---------------------------------------------------------------------------
# DCX

def dcx_file(pages: list) -> bytes:
    """A DCX: the magic, the pages' offsets ended by 0, the PCX files."""
    at = 4 + 4 * (len(pages) + 1)
    offsets = []
    for page in pages:
        offsets.append(at)
        at += len(page)
    return (struct.pack("<I", 0x3ADE68B1)
            + struct.pack(f"<{len(pages) + 1}I", *offsets, 0)
            + b"".join(pages))


def pcx(a) -> bytes:
    f = io.BytesIO()
    (a if isinstance(a, Image.Image) else Image.fromarray(a)).save(f, "PCX")
    return f.getvalue()


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
def test_dcx(tmp_path, mode):
    """The first page of one and of three, each a PCX that PIL writes
    (an "L" or "P" page's palette is read from the end of the whole file,
    as PcxImageFile does: the last page's)."""
    a = arrays(5, 23, 31)
    img = Image.fromarray(a["RGB"]).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=12) if mode == "P" \
        else Image.fromarray(a[mode])
    other = pcx(arrays(6, 7, 9)["RGB"])
    for pages in ([pcx(img)], [pcx(img), other, pcx(img)]):
        got = hold(tmp_path, dcx_file(pages), "x.dcx")
        assert got is not None and got.shape[:2] == (23, 31)


def test_dcx_of_the_fixture(tmp_path):
    """The witness: a DCX of ``tests/data/image_io/pcx_l.pcx`` is PIL's "L"
    (47, 61) array; and a DCX with no pages is refused as PIL fails."""
    page = (chip_smoke.IMAGE_FIXTURES / "pcx_l.pcx").read_bytes()
    got = hold(tmp_path, dcx_file([page]), "x.dcx")
    assert got.shape == (47, 61) and got.dtype == np.uint8
    assert hold(tmp_path, struct.pack("<II", 0x3ADE68B1, 0), "y.dcx") is None


# ---------------------------------------------------------------------------
# FITS

def card(key: str, value=None) -> bytes:
    """An 80-character card: the keyword, "= " and the value, right-aligned
    as FITS writes numbers."""
    if value is None:
        return key.ljust(80).encode()
    v = value if isinstance(value, str) else str(value)
    return (key.ljust(8) + "= " + v.rjust(20) + " / a comment").ljust(
        80).encode()


def unit(cards: list, body: bytes = b"") -> bytes:
    """A header unit (its cards, END, padded to 2880 bytes) and its data
    (padded to 2880)."""
    head = b"".join(cards) + card("END")
    head += b" " * (-len(head) % 2880)
    return head + body + bytes(-len(body) % 2880)


_BE = {8: ">u1", 16: ">i2", 32: ">i4", -32: ">f4", -64: ">f8"}


def fits_values(bits: int, shape, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if bits < 0:
        return rng.normal(0, 300, shape).astype(_BE[bits])
    hi = {8: 256, 16: 32768, 32: 2 ** 31}[bits]
    lo = 0 if bits == 8 else -hi
    return rng.integers(lo, hi, shape).astype(_BE[bits])


def fits_file(bits: int, shape, extension: bool = False, seed: int = 0,
              extra: list = ()) -> bytes:
    """A FITS image of ``shape`` (NAXIS2, NAXIS1 or one axis, or three),
    big-endian; with ``extension`` an empty primary unit and the image in
    an IMAGE extension."""
    v = fits_values(bits, shape, seed)
    axes = [card("NAXIS", len(shape))] + [
        card(f"NAXIS{i + 1}", n) for i, n in enumerate(shape[::-1])]
    if extension:
        return (unit([card("SIMPLE", "T"), card("BITPIX", 8),
                      card("NAXIS", 0), card("EXTEND", "T")])
                + unit([card("XTENSION", "'IMAGE   '"),
                        card("BITPIX", bits)] + axes + list(extra),
                       v.tobytes()))
    return unit([card("SIMPLE", "T"), card("BITPIX", bits)] + axes
                + list(extra), v.tobytes())


def fits_gzip_file(zbits: int, shape, seed: int = 0, rows_a_tile=1,
                   cmptype: str = "'GZIP_1  '") -> bytes:
    """A tile-compressed image (a BINTABLE with ZIMAGE = T): one table row
    of 8 bytes a tile, then the heap of each tile's gzip member (its values
    as 4-byte big-endian integers)."""
    h, w = shape
    v = fits_values(zbits, shape, seed).astype(np.int64)
    tiles = [gzip.compress(v[y:y + rows_a_tile].astype(">i4").tobytes(),
                           mtime=0) for y in range(0, h, rows_a_tile)]
    table = b"".join(struct.pack(">ii", len(t), 0) for t in tiles)
    body = table + b"".join(tiles)
    return (unit([card("SIMPLE", "T"), card("BITPIX", 8), card("NAXIS", 0),
                  card("EXTEND", "T")])
            + unit([card("XTENSION", "'BINTABLE'"), card("BITPIX", 8),
                    card("NAXIS", 2), card("NAXIS1", 8),
                    card("NAXIS2", len(tiles)), card("PCOUNT", len(body)),
                    card("ZIMAGE", "T"), card("ZCMPTYPE", cmptype),
                    card("ZBITPIX", zbits), card("ZNAXIS", 2),
                    card("ZNAXIS1", w), card("ZNAXIS2", h)], body))


@pytest.mark.parametrize("bits", [8, 16, 32, -32, -64])
@pytest.mark.parametrize("layout", ["2d", "1d", "3d", "extension"])
def test_fits(tmp_path, bits, layout):
    """BITPIX 8, 16, 32, -32 and -64 as "L", "I;16", "I", "F" and "F",
    read with PIL's little-endian raw modes and rows bottom-up (-64's
    doubles as pairs of floats, as PIL reads them); NAXIS 1 (a column),
    2, 3 (the first plane's axes), and an image in an IMAGE extension
    after an empty primary unit."""
    shape = {"2d": (19, 23), "1d": (31,), "3d": (2, 19, 23),
             "extension": (19, 23)}[layout]
    got = hold(tmp_path, fits_file(bits, shape, layout == "extension", 2),
               "x.fits")
    assert got is not None


def test_fits_8_bit_is_rows_reversed(tmp_path):
    """A minimal 8-bit FITS opens as "L" with its rows in reverse order:
    PIL's array is the data's rows bottom-up."""
    data = fits_file(8, (20, 30))
    v = fits_values(8, (20, 30))
    got = hold(tmp_path, data, "x.fits")
    np.testing.assert_array_equal(got, v[::-1])


@pytest.mark.parametrize("zbits", [8, 16, 32])
@pytest.mark.parametrize("rows_a_tile", [1, 5])
def test_fits_gzip(tmp_path, zbits, rows_a_tile):
    """GZIP_1 tile compression: the heap after the table's rows
    decompressed as one stream of members, the last ZBITPIX / 8 bytes of
    each 4-byte value read by the mode's raw mode, rows bottom-up."""
    got = hold(tmp_path, fits_gzip_file(zbits, (13, 17), 4, rows_a_tile),
               "x.fits")
    assert got is not None and got.shape == (13, 17)


REFUSED_FITS = {
    "no_image": lambda: unit([card("SIMPLE", "T"), card("BITPIX", 8),
                              card("NAXIS", 0)]),
    "not_simple": lambda: fits_file(8, (4, 4)).replace(
        b"= " + b"T".rjust(20), b"= " + b"F".rjust(20), 1),
    "truncated_header": lambda: b"".join([card("SIMPLE", "T"),
                                          card("BITPIX", 8)]),
    "truncated_data": lambda: fits_file(16, (19, 23))[:2880 + 100],
    "bitpix_64": lambda: unit([card("SIMPLE", "T"), card("BITPIX", 64),
                               card("NAXIS", 2), card("NAXIS1", 3),
                               card("NAXIS2", 3)], bytes(72)),
    "no_naxis1": lambda: unit([card("SIMPLE", "T"), card("BITPIX", 8),
                               card("NAXIS", 2), card("NAXIS2", 3)],
                              bytes(9)),
    "bad_value": lambda: unit([card("SIMPLE", "T"), card("BITPIX", 8),
                               card("NAXIS", "'two'")]),
    "gzip_float": lambda: fits_gzip_file(-32, (5, 6)),
    "gzip_other_codec": lambda: fits_gzip_file(16, (5, 6),
                                               cmptype="'RICE_1  '"),
    "gzip_corrupt": lambda: fits_gzip_file(16, (5, 6))[:-2880 + 40],
}


@pytest.mark.parametrize("case", sorted(REFUSED_FITS))
def test_fits_refusals(tmp_path, case):
    """PIL's failures, each a ValueError here: no image ("No image
    data"), a first card other than SIMPLE = T, a header or data cut
    short, a BITPIX without a mode, a missing or malformed keyword, a
    GZIP_1 float image (PIL keeps no bytes of it), another compression
    (read as the table), a cut gzip stream."""
    data = REFUSED_FITS[case]()
    p = tmp_path / "x.fits"
    p.write_bytes(data)
    try:
        want = np.asarray(Image.open(p))
    except Exception:
        want = None
    got = hold(tmp_path, data, "x.fits")
    assert (got is None) == (want is None)


# ---------------------------------------------------------------------------
# chip_smoke.py phase 14za's fixtures and 14zc's pair

def pil_sha256(a: np.ndarray) -> str:
    """``chip_smoke._hold_tiff_fixtures``'s hash: a mode "1" array as
    0/255 bytes."""
    import hashlib
    return hashlib.sha256((a.astype(np.uint8) * 255 if a.dtype == bool
                           else a).tobytes()).hexdigest()


def fixture_files() -> dict:
    """The PSD, DCX and FITS files of ``chip_smoke.PSD_DDS_ICNS_FIXTURES``:
    {name: bytes}, each small."""
    key_planes = {k: psd_planes(k, 20, 47, 61) for k in PSD_MODES}
    pal = np.random.default_rng(21).integers(0, 256, 768, np.uint8)
    res = resource(1039, b"", b"icc!") + resource(1000, b"x", b"abc")
    return {
        "psd_rgb_raw.psd": chip_smoke.psd_bytes(
            key_planes[(3, 8)], 3, 8, False, resources=res),
        "psd_rgba_packbits.psd": chip_smoke.psd_bytes(
            psd_planes((3, 8), 20, 47, 61, 4), 3, layers=layer_block()),
        "psd_cmyk_packbits.psd": chip_smoke.psd_bytes(key_planes[(4, 8)], 4),
        "psd_p_raw.psd": chip_smoke.psd_bytes(
            key_planes[(2, 8)], 2, 8, False, colour_data=pal.tobytes()),
        "psd_1_packbits.psd": chip_smoke.psd_bytes(key_planes[(0, 1)], 0, 1,
                                                   width=61),
        "psd_lab_raw.psd": chip_smoke.psd_bytes(key_planes[(9, 8)], 9, 8,
                                                False),
        "psd_gray_packbits.psd": chip_smoke.psd_bytes(
            psd_planes((1, 8), 20, 47, 61, 2), 1, resources=res),
        "dcx_two_pages.dcx": dcx_file(
            [(chip_smoke.IMAGE_FIXTURES / f"pcx_{m}.pcx").read_bytes()
             for m in ("l", "rgb")]),
        "fits_8.fits": fits_file(8, (47, 61)),
        "fits_16.fits": fits_file(16, (47, 61), seed=1),
        "fits_32.fits": fits_file(32, (47, 61), True, seed=2),
        "fits_f32.fits": fits_file(-32, (47, 61), seed=3),
        "fits_gzip16.fits": fits_gzip_file(16, (47, 61), 4, 8),
    }


def write_fixtures(d) -> None:
    for name, data in fixture_files().items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)


def hold_fixtures(files: dict, limit: int,
                  names: tuple = chip_smoke.PSD_DDS_ICNS_FIXTURES) -> None:
    """The committed fixtures are ``files``'s bytes, each one of ``names``
    (a phase's list) and read by the port as PIL reads it, with PIL's
    shape, mode and hash in ``chip_smoke.FORMAT_FIXTURE_SHA256``; under
    ``limit`` bytes in all."""
    for name, data in files.items():
        assert name in names, name
        path = chip_smoke.IMAGE_FIXTURES / name
        assert path.read_bytes() == data, name
        hold_read(path)
        im = Image.open(path)
        a = np.asarray(im)
        assert chip_smoke.FORMAT_FIXTURE_SHA256[name] == (
            a.shape, im.mode, pil_sha256(a)), name
    assert sum(len(d) for d in files.values()) < limit


def test_psd_dcx_fits_fixtures_are_written_here():
    """Phase 14za's PSD, DCX and FITS fixtures: under 120 KB in all."""
    hold_fixtures(fixture_files(), 120_000)


def psd_pair(i: int) -> bytes:
    """zoom2x's view ``i`` as a gray PackBits PSD (phase 14zc)."""
    view = np.asarray(Image.open(chip_smoke.PAIRS / f"zoom2x_{i}.png"))
    return chip_smoke.psd_bytes(view[None], 1)


def test_cli_match_on_the_psd_pair(tmp_path, capsys):
    """``cli match`` (LORANSACH, the CVIU-shaped INI files, as phase 14zc
    runs it) on zoom2x's pair as PackBits PSDs, its drawings named .dds
    and .icns: the JAX command's rung and verified count within 20 %
    (``JAX_PSD_REFERENCE``); the .dds is the JAX package's
    ``viz.save_image`` (PIL) bytes of ``viz``'s canvas, and PIL reads from
    the .icns the frames of its own .icns of the other canvas."""
    from mods_tpu import viz as jviz
    from mods_tpu_torch import cli as tcli
    from mods_tpu_torch import viz
    from mods_tpu_torch.io.image import read_image
    from mods_tpu_torch.io.regions_io import read_h, read_matches
    from test_torch_icns import pil_entries
    imgs = []
    for i in (1, 2):
        imgs.append(tmp_path / f"zoom2x_{i}.psd")
        imgs[-1].write_bytes(psd_pair(i))
    (tmp_path / "iters.ini").write_text(chip_smoke.cviu_iters_ini())
    (tmp_path / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
    o1, o2, m = tmp_path / "o1.dds", tmp_path / "o2.icns", tmp_path / "m.txt"
    assert tcli.main(["match", *map(str, imgs), str(o1), str(o2), "k1",
                      "k2", str(m), "0", "LORANSACH",
                      str(tmp_path / "config.ini"),
                      str(tmp_path / "iters.ini"), "--device", "cpu"]) == 0
    loaded = [read_image(p) for p in imgs]
    for i, a in enumerate(loaded, 1):
        np.testing.assert_array_equal(a, np.asarray(Image.open(
            chip_smoke.PAIRS / f"zoom2x_{i}.png")))
    h, w = loaded[0].shape
    got = chip_smoke.match_figures(
        capsys.readouterr().out, str(m),
        np.loadtxt(chip_smoke.PAIRS / "zoom2x_H.txt"), w, h)
    ref = chip_smoke.JAX_PSD_REFERENCE
    assert got["steps"] == ref["steps"], (got, ref)
    assert abs(got["matches"] - ref["matches"]) <= 0.2 * ref["matches"]
    assert abs(got["tentatives"] - ref["tentatives"]) <= \
        0.2 * ref["tentatives"]
    xy1, xy2 = read_matches(str(m))
    canvases = (viz.draw_matches(*loaded, xy1, xy2),
                viz.draw_matches_with_error(*loaded, xy1, xy2,
                                            read_h(f"{m}.H")))
    jviz.save_image(str(tmp_path / "jax.dds"), canvases[0])
    jviz.save_image(str(tmp_path / "jax.icns"), canvases[1])
    assert o1.read_bytes() == (tmp_path / "jax.dds").read_bytes()
    want = pil_entries((tmp_path / "jax.icns").read_bytes())
    got = pil_entries(o2.read_bytes())
    assert got["sizes"] == want["sizes"] and got["types"] == want["types"]
    for key, (mode, arr) in want["frames"].items():
        assert got["frames"][key][0] == mode
        np.testing.assert_array_equal(got["frames"][key][1], arr)


def _jax_psd_main() -> None:
    """The JAX command on phase 14zc's pair: ``JAX_PSD_REFERENCE``."""
    import contextlib
    import json
    import tempfile
    import time
    from pathlib import Path

    from mods_tpu import cli as jcli
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        (td / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
        (td / "iters.ini").write_text(chip_smoke.cviu_iters_ini())
        pair = []
        for i in (1, 2):
            pair.append(td / f"zoom2x_{i}.psd")
            pair[-1].write_bytes(psd_pair(i))
        m = td / "m.txt"
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jcli.cmd_match([*map(str, pair), "0", "0", "k1", "k2",
                                   str(m), "0", "LORANSACH",
                                   str(td / "config.ini"),
                                   str(td / "iters.ini")]) == 0
        h, w = np.asarray(Image.open(pair[0])).shape
        figures = chip_smoke.match_figures(
            buf.getvalue(), str(m),
            np.loadtxt(chip_smoke.PAIRS / "zoom2x_H.txt"), w, h)
    print(json.dumps(dict(figures, seconds=round(time.time() - t0, 1))),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--fixtures"]:
        write_fixtures(chip_smoke.IMAGE_FIXTURES)
    elif sys.argv[1:] == ["--jax-psd"]:
        _jax_psd_main()
    else:
        sys.exit("usage: python tests/test_torch_psd_dcx_fits.py --fixtures "
                 "| --jax-psd")
