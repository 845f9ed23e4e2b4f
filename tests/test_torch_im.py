"""Port vs PIL on IFUNC Image Memory (IM) files, read and written as the
JAX commands do through PIL (``np.asarray(Image.open(path))``,
``Image.fromarray(a).save(path)``, Pillow 12.1.0) (CPU).

PIL writes IM in the modes of ``Image.fromarray`` and in "P" (with a
Lut), "PA", "CMYK", "YCbCr", "I;16B" and "I;16L"; every other "Image
type" of ImImagePlugin.OPEN (line-interleaved and plane layouts, 2- and
4-bit palettes, the "L*n" bit depths, Luts that are gray, linear or in
colour) is built here (``im_file``) and PIL's reading of it is the
reference.  The arrays come from a seeded numpy generator.

Tolerance: none.  ``io/image.py::_read`` must give PIL's array (dtype,
shape, every value) and mode, ``image_size`` its size and ``_format`` the
format ``Image.open`` picks, or raise a ValueError where PIL fails
(``test_torch_raster_formats.hold_read``); ``save_image`` must write
PIL's bytes to the same file name, or refuse what PIL refuses
(``hold_write``).
"""

import io
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytest  # noqa: E402
from PIL import Image  # noqa: E402

from mods_tpu_torch.io import im  # noqa: E402
from test_torch_psd_dcx_fits import hold as hold_named  # noqa: E402
from test_torch_psd_dcx_fits import hold_fixtures  # noqa: E402
from test_torch_raster_formats import MODES, arrays, hold_write  # noqa: E402
from test_torch_raster_formats import pil_bytes as pil_save  # noqa: E402


def im_file(image_type: str, w: int, h: int, body: bytes, lut: bytes = b"",
            lines: tuple = (), newline: bytes = b"\r\n") -> bytes:
    """An IM file: its header lines, a "Lut" line where ``lut`` is given,
    NUL bytes to byte 511, ``\\x1a``, the Lut, then ``body``."""
    head = [f"Image type: {image_type}", f"Image size (x*y): {w}*{h}",
            *lines] + (["Lut: 1"] if lut else [])
    text = b"".join(line.encode("latin-1") + newline for line in head)
    return text + bytes(max(0, 511 - len(text))) + b"\x1a" + lut + body


def hold(tmp_path, data: bytes):
    """``hold_read`` on ``data`` as "x.im"; PIL's array, or None where PIL
    fails."""
    return hold_named(tmp_path, data, "x.im")


def luts(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    grey = rng.integers(0, 256, 256, np.uint8).tobytes()
    return {"none": b"", "grey": grey * 3, "linear": bytes(range(256)) * 3,
            "colour": rng.bytes(768)}


# every "Image type" but the "L*n" bit depths, which test_bit_images takes
IMAGE_TYPES = sorted(k for k in im.OPEN
                     if not (k.startswith("L*") and k[2:-6].isdigit()))


@pytest.mark.parametrize("image_type", IMAGE_TYPES)
def test_image_types(tmp_path, image_type):
    """Each "Image type" at four sizes, with no Lut and with a gray, a
    linear and a colour one: the mode, raw mode and layout PIL reads (rows
    bottom-up), "P" / "PA" from a colour Lut, and PIL's failures (RLB,
    "PA" without a colour Lut: no unpacker)."""
    rng = np.random.default_rng(len(image_type))
    for w, h in ((5, 3), (13, 7), (1, 1), (33, 4)):
        for lut in luts(w).values():
            hold(tmp_path, im_file(image_type, w, h, rng.bytes(40 * w * h),
                                   lut))


@pytest.mark.parametrize("bits", [(2, 3, 4, 5), (6, 7, 8, 9), (10, 11, 12),
                                  (13, 14, 15, 16), (17, 18, 19, 20),
                                  (21, 22, 23, 24), (25, 26, 27, 28),
                                  (29, 30, 31, 32)],
                         ids=lambda b: f"{b[0]}-{b[-1]}")
def test_bit_images(tmp_path, bits):
    """"L*n" images: n of 8, 16 and 32 read as raw "F;n", every other n
    by Pillow's BitDecode.c (its bit buffer kept over a row's end), rows
    bottom-up, at widths that end rows inside a byte."""
    rng = np.random.default_rng(bits[0])
    for n in bits:
        for w, h in ((5, 3), (7, 2), (1, 4)):
            got = hold(tmp_path, im_file(f"L*{n} image", w, h,
                                         rng.bytes(5 * w * h)))
            assert got is not None and got.dtype == np.float32


@pytest.mark.parametrize("mode", MODES)
def test_writer_bytes_are_pils(tmp_path, mode):
    """Every mode of ``Image.fromarray`` at 1 x 1, 3 x 5, 17 x 70 and 64 x
    7: PIL's bytes (the header names the file), read back as PIL reads
    them."""
    for seed, (h, w) in enumerate(((1, 1), (3, 5), (17, 70), (64, 7))):
        hold_write(tmp_path, "x.im", arrays(seed, h, w)[mode])


@pytest.mark.parametrize("name", ["plain.im", "a" * 120 + ".im",
                                  "two.dots.IM", ".hidden.im", "déjà vu.im"])
def test_header_holds_the_base_name(tmp_path, name):
    """The "Name:" line is the file's base name cut to 92 characters with
    its extension; a name that is not ASCII is refused as PIL refuses it
    (and no file is left)."""
    hold_write(tmp_path, name, arrays(4, 6, 9)["RGB"])


def pil_bytes(img: Image.Image) -> bytes:
    return pil_save(img, "IM")


PIL_SAVES = {
    "P with a Lut": lambda a: Image.fromarray(a["RGB"]).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=40),
    "P of a gray palette": lambda a: Image.fromarray(a["L"]).convert("P"),
    "PA": lambda a: Image.fromarray(a["RGBA"]).convert("PA"),
    "CMYK": lambda a: Image.fromarray(a["RGB"]).convert("CMYK"),
    "YCbCr": lambda a: Image.fromarray(a["RGB"]).convert("YCbCr"),
    "I;16B": lambda a: Image.fromarray(a["I;16"]).convert("I;16B"),
    "I;16L": lambda a: Image.fromarray(a["I;16"]).convert("I;16L"),
    "RGBX": lambda a: Image.fromarray(a["RGBA"]).convert("RGBX"),
}


@pytest.mark.parametrize("case", sorted(PIL_SAVES))
def test_pils_other_saves(tmp_path, case):
    """PIL's IM of the modes ``Image.fromarray`` does not give: "P" and
    "PA" (a Lut; a gray palette's "P" file reads back as "L"), CMYK,
    YCbCr (three bands), "I;16B" (big-endian) and "I;16L", RGBX (read as
    RGB), at two sizes."""
    for seed, (h, w) in enumerate(((9, 13), (40, 3))):
        assert hold(tmp_path, pil_bytes(PIL_SAVES[case](arrays(seed, h, w)))
                    ) is not None


def test_header_forms(tmp_path):
    """Lines ended by "\\n" or by "\\n\\r", comments and other keys, a
    second frame (only the first is read), no size line (512 x 512), the
    header ended by "\\x1a" right after its last line or by NUL bytes, a
    Lut line before the type."""
    rng = np.random.default_rng(8)
    body = rng.bytes(3 * 512 * 512)
    cases = [
        im_file("RGB image", 7, 5, body, newline=b"\n"),
        im_file("L 16 image", 7, 5, body, newline=b"\n\r"),
        im_file("Greyscale image", 7, 5, body,
                lines=("Comment: one", "Comment: two", "Date: today",
                       "Scale (x,y): 1.5,2", "Other key: kept",
                       "File size (no of images): 3"))]
    head = b"Image type: RGB image\r\n"
    cases.append(head + b"\x1a" + body)
    cases.append(b"Lut: 1\nImage type: LA image\nImage size (x*y): 4*4\n"
                 + b"\0" * 5 + b"\x1a" + rng.bytes(768) + body[:64])
    for data in cases:
        assert hold(tmp_path, data) is not None


REFUSED = {
    "truncated": lambda: im_file("RGB image", 9, 9, bytes(100)),
    "no newline in 100 bytes": lambda: b"Image type: L image" + bytes(200),
    "a line not key: value": lambda: b"Image type: L image\n# no\n\x1a"
    + bytes(10),
    "no tag": lambda: b"Other: 1\nAnother: 2\n\x1a" + bytes(512 * 512),
    "a line over 100 bytes": lambda: b"Image type: L image\nName: "
    + b"n" * 120 + b"\n\x1a" + bytes(512 * 512),
    "no 0x1a": lambda: b"Image type: L image\nImage size (x*y): 2*2\n\0\0",
    "size 0": lambda: im_file("L image", 0, 4, bytes(64)),
    "one size number": lambda: b"Image type: L image\nImage size (x*y): 4\n"
    b"\x1a" + bytes(64),
    "a Lut cut short": lambda: im_file("L image", 2, 2, b"",
                                       lut=bytes(100)),
    "an unknown type": lambda: im_file("Foo image", 2, 2, bytes(64)),
    "a size that is not a number": lambda: b"Image type: L image\n"
    b"Image size (x*y): 2*x\n\x1a" + bytes(64),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals(tmp_path, case):
    """PIL's failures, each a ValueError here: data cut short, headers that
    are not IM (no newline in the first 100 bytes, a line that is not
    ``key: value``, no tag, a line over 100 bytes, no ``\\x1a``, a side of
    0, one size number, a Lut cut short), a mode PIL cannot make, a size
    that is not a number."""
    data = REFUSED[case]()
    p = tmp_path / "x.im"
    p.write_bytes(data)
    with pytest.raises(Exception):
        np.asarray(Image.open(p))
    assert hold(tmp_path, data) is None


# ---------------------------------------------------------------------------
# chip_smoke.py phase 14zd's IM fixtures and 14ze's hashes

def fixture_files() -> dict:
    """The IM files of ``chip_smoke.BITMAP_FIXTURES``: PIL's saves in the
    eight modes of ``Image.fromarray`` and in "P" with a Lut, "PA", CMYK,
    YCbCr and "I;16B"."""
    a = arrays(20, 23, 31)
    out = {f"im_{m.replace(';', '')}.im": pil_bytes(Image.fromarray(a[m]))
           for m in MODES}
    for case, name in (("P with a Lut", "im_p_lut.im"), ("PA", "im_pa.im"),
                       ("CMYK", "im_cmyk.im"), ("YCbCr", "im_ycbcr.im"),
                       ("I;16B", "im_i16b.im")):
        out[name] = pil_bytes(PIL_SAVES[case](a))
    return out


def test_im_fixtures_are_written_here():
    """Phase 14zd's IM fixtures: under 60 KB in all."""
    import chip_smoke
    hold_fixtures(fixture_files(), 60_000, chip_smoke.BITMAP_FIXTURES)


def encode_hashes(tmp) -> dict:
    """14ze's constant from PIL's own saves of
    ``chip_smoke.im_encode_canvases``: {canvas: {extension: SHA-256}},
    each file named as 14ze names it."""
    import hashlib
    import chip_smoke
    views = [np.asarray(Image.open(chip_smoke.PAIRS / f"{n}.png"))
             for n in ("zoom2x_1", "zoom2x_2", "tilt4_1")]
    out = {}
    for i, (name, canvas) in enumerate(
            chip_smoke.im_encode_canvases(views).items()):
        out[name] = {}
        for ext in chip_smoke.im_encode_extensions(canvas):
            p = os.path.join(tmp, chip_smoke.im_encode_name(i, ext))
            Image.fromarray(canvas).save(p)
            with open(p, "rb") as f:
                out[name][ext] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_im_msp_xbm_encode_hashes_are_pils(tmp_path):
    """Phase 14ze's hashes are PIL's, and the port's files of the same
    canvases under the same names give them."""
    import hashlib
    import chip_smoke
    from mods_tpu_torch.io.image import save_image
    want = encode_hashes(tmp_path)
    assert want == chip_smoke.IM_ENCODE_SHA256
    views = [np.asarray(Image.open(chip_smoke.PAIRS / f"{n}.png"))
             for n in ("zoom2x_1", "zoom2x_2", "tilt4_1")]
    (tmp_path / "port").mkdir()
    for i, (name, canvas) in enumerate(
            chip_smoke.im_encode_canvases(views).items()):
        for ext, sha in want[name].items():
            p = tmp_path / "port" / chip_smoke.im_encode_name(i, ext)
            save_image(p, canvas)
            assert hashlib.sha256(p.read_bytes()).hexdigest() == sha, (
                name, ext)


def im_pair(tmp, i: int):
    """zoom2x's view ``i`` written as a gray IM (phase 14zf) by PIL."""
    import chip_smoke
    from pathlib import Path
    p = Path(tmp) / f"zoom2x_{i}.im"
    Image.open(chip_smoke.PAIRS / f"zoom2x_{i}.png").save(p)
    return p


def test_cli_match_on_the_im_pair(tmp_path, capsys):
    """``cli match`` (LORANSACH, the CVIU-shaped INI files, as phase 14zf
    runs it) on zoom2x's pair as gray IM files, its drawings named .im:
    the JAX command's rung and verified count within 20 %
    (``JAX_IM_REFERENCE``); each drawing is the JAX package's
    ``viz.save_image`` (PIL) bytes of ``viz``'s canvas, under the same
    name."""
    import chip_smoke
    from mods_tpu import viz as jviz
    from mods_tpu_torch import cli as tcli
    from mods_tpu_torch import viz
    from mods_tpu_torch.io.image import read_image
    from mods_tpu_torch.io.regions_io import read_h, read_matches
    imgs = [im_pair(tmp_path, i) for i in (1, 2)]
    (tmp_path / "iters.ini").write_text(chip_smoke.cviu_iters_ini())
    (tmp_path / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
    o1, o2, m = tmp_path / "o1.im", tmp_path / "o2.im", tmp_path / "m.txt"
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
    ref = chip_smoke.JAX_IM_REFERENCE
    assert got["steps"] == ref["steps"], (got, ref)
    assert abs(got["matches"] - ref["matches"]) <= 0.2 * ref["matches"]
    assert abs(got["tentatives"] - ref["tentatives"]) <= \
        0.2 * ref["tentatives"]
    xy1, xy2 = read_matches(str(m))
    canvases = (viz.draw_matches(*loaded, xy1, xy2),
                viz.draw_matches_with_error(*loaded, xy1, xy2,
                                            read_h(f"{m}.H")))
    (tmp_path / "jax").mkdir()
    for out, canvas in zip((o1, o2), canvases):
        jviz.save_image(str(tmp_path / "jax" / out.name), canvas)
        assert out.read_bytes() == (tmp_path / "jax" / out.name).read_bytes()


def _jax_im_main() -> None:
    """The JAX command on phase 14zf's pair: ``JAX_IM_REFERENCE``."""
    import contextlib
    import json
    import tempfile
    import time
    from pathlib import Path

    import chip_smoke
    from mods_tpu import cli as jcli
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        (td / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
        (td / "iters.ini").write_text(chip_smoke.cviu_iters_ini())
        pair = [im_pair(td, i) for i in (1, 2)]
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
        import chip_smoke
        for name, data in fixture_files().items():
            (chip_smoke.IMAGE_FIXTURES / name).write_bytes(data)
    elif sys.argv[1:] == ["--hashes"]:
        import pprint
        import tempfile
        with tempfile.TemporaryDirectory() as td:
            pprint.pprint(encode_hashes(td), width=76)
    elif sys.argv[1:] == ["--jax-im"]:
        _jax_im_main()
    else:
        sys.exit("usage: python tests/test_torch_im.py --fixtures | "
                 "--hashes | --jax-im")
