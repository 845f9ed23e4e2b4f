"""Port vs PIL on PDF, EPS/PS and PALM files, written as the JAX commands
write drawings (``mods_tpu.viz.save_image``: ``Image.fromarray(a).save
(path)``, Pillow 12.1.0 with libtiff) (CPU).

PIL writes PDF from modes "1" (CCITT Group 4 through libtiff), "L" and
"RGB" (JPEG), "LA" and "RGBA" (JP2); EPS (``.eps``, ``.ps``) from "L" and
"RGB"; PALM from "1"; it refuses every other mode of ``Image.fromarray``.
A PDF holds the file's stem and the time of the save, so each case fixes
``time.gmtime`` for both packages (``chip_smoke.fixed_gmtime``).  The
arrays come from a seeded numpy generator.

Tolerance: none.  ``io/image.py::save_image`` must write the JAX
package's bytes to the same file name, or raise a ValueError that holds
PIL's message and names the format where PIL refuses (a ValueError or an
OSError), with no file left by either.  The Group 4 stream decodes back
to the page through the port's own CCITT decoder (``io/tiff.py`` on
``csrc/tiff_decode.cpp``).

``python tests/test_torch_pdf_eps_palm.py --hashes`` prints
``chip_smoke.py``'s 14zi tables from PIL's saves;
``JAX_PLATFORMS=cpu python tests/test_torch_pdf_eps_palm.py --jax-pdf``
prints the JAX command's figures on 14zj's pair
(``chip_smoke.JAX_PDF_REFERENCE``).
"""

import hashlib
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
from mods_tpu import cli as jcli  # noqa: E402
from mods_tpu import viz as jviz  # noqa: E402
from mods_tpu_torch import cli as tcli  # noqa: E402
from mods_tpu_torch.io.image import read_image, save_image  # noqa: E402
from test_torch_image_io import pnm_jpeg_pair  # noqa: E402,F401
from test_torch_raster_formats import MODES, arrays  # noqa: E402

EXTENSIONS = (".pdf", ".eps", ".ps", ".palm")
# the format each extension's refusal names
FORMAT_NAMES = {".pdf": "PDF", ".eps": "EPS", ".ps": "EPS", ".palm": "Palm"}


def runs_page() -> np.ndarray:
    """A "1" page 5300 wide: a white row (two 2560 make-ups past 2624),
    rows of black runs of 63, 64, 65, 2560, 2623, 2624 and 2625 (each a
    make-up boundary) between white runs of the same lengths, and the same
    rows shifted by 1-3 pixels (vertical modes) and by 40 (horizontal and
    pass modes)."""
    w = 5300
    rows = [np.zeros(w, bool)]
    for run in (63, 64, 65, 2560, 2623, 2624, 2625):
        row = np.zeros(w, bool)
        for start in range(run, w, 2 * run):
            row[start:start + run] = True
        rows.append(row)
        rows += [np.roll(row, s) for s in (1, -3, 40)]
    return np.stack(rows)


def pages() -> dict:
    """The "1" cases: sizes of 1 x 1, widths off multiples of 8 and 16,
    random and striped pages, and ``runs_page``."""
    rng = np.random.default_rng(0)
    out = {"1x1 set": np.ones((1, 1), bool), "1x1 clear": np.zeros((1, 1),
                                                                   bool)}
    for h, w in ((5, 13), (9, 17), (16, 33), (40, 100)):
        out[f"random {h}x{w}"] = rng.random((h, w)) < 0.5
        out[f"sparse {h}x{w}"] = rng.random((h, w)) < 0.05
        out[f"stripes {h}x{w}"] = \
            (np.arange(w)[None] // 3 + np.arange(h)[:, None] // 2) % 2 == 0
    out["blocks 64x7"] = arrays(3, 64, 7)["1"]
    out["runs 29x5300"] = runs_page()
    return out


def hold(tmp_path, name: str, a: np.ndarray) -> bytes | None:
    """``mods_tpu.viz.save_image`` and the port's ``save_image`` of ``a``
    to ``name`` in two folders, the clock fixed: the same bytes, or both
    refuse with PIL's message and the format's name and leave no file.
    Returns the bytes, None where refused."""
    jax, port = tmp_path / "jax", tmp_path / "port"
    jax.mkdir(exist_ok=True)
    port.mkdir(exist_ok=True)
    ext = os.path.splitext(name)[1].lower()
    with chip_smoke.fixed_gmtime():
        try:
            jviz.save_image(str(jax / name), a)
        except (OSError, ValueError) as e:
            with pytest.raises(ValueError) as got:
                save_image(port / name, a)
            assert str(e) in str(got.value), (e, got.value)
            assert FORMAT_NAMES[ext] in str(got.value)
            assert not (jax / name).exists() and not (port / name).exists()
            return None
        save_image(port / name, a)
    want = (jax / name).read_bytes()
    assert (port / name).read_bytes() == want, name
    return want


@pytest.mark.parametrize("ext", [".pdf", ".palm"])
def test_bilevel_pages_are_pils(tmp_path, ext):
    """Mode "1" as PDF (CCITT Group 4: pass, vertical and horizontal
    modes, make-up codes at 64, 2560 and past 2624, rows not byte-aligned)
    and as PALM (rows padded to 16 bits)."""
    for name, a in pages().items():
        assert hold(tmp_path, f"{name.replace(' ', '_')}{ext}", a)


def test_pdf_of_a_page_wider_than_65535(tmp_path):
    """libtiff writes ImageWidth as a LONG past 65535 (a SHORT below), in
    the directory that stays in a "1" page's stream."""
    rng = np.random.default_rng(7)
    assert hold(tmp_path, "wide.pdf", rng.random((2, 70_001)) < 0.3)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("ext", EXTENSIONS)
def test_small_images_are_pils_or_refused(tmp_path, ext, mode):
    """1 x 1, a width of 13 (an RGB row of 39 bytes: EPS's line edge), 39
    (a gray row of 39 bytes) and 40, 3 x 5 and 17 x 70: PIL's bytes where
    PIL writes the mode, its refusal elsewhere."""
    for seed, (h, w) in enumerate(((1, 1), (4, 13), (3, 39), (2, 40),
                                   (3, 5), (17, 70))):
        a = arrays(seed, h, w)[mode]
        data = hold(tmp_path, f"x{seed}{ext}", a)
        assert (data is not None) == (
            mode in chip_smoke.PDF_EPS_PALM_MODES[ext])


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_canvas_size_images_are_pils(tmp_path, mode):
    """A 1000 x 598 gray or RGB array, a drawing's size, as PDF and EPS:
    7.2 MB of EPS hex for the RGB one."""
    a = arrays(11, 598, 1000)[mode]
    for ext in (".pdf", ".eps"):
        assert hold(tmp_path, f"canvas{ext}", a)


@pytest.mark.parametrize("stem", ["a(b)c\\d", "Zürich-Ωμέγα", "日本(語)",
                                  "ĨŜĩ", "))((", "x.y"])
def test_pdf_titles_escape_as_pils(tmp_path, stem):
    """The title is the stem as UTF-16BE with a byte order mark, ``\\``,
    ``(`` and ``)`` escaped byte by byte: U+0128 and U+015C hold the bytes
    of ``(`` and ``\\``."""
    data = hold(tmp_path, f"{stem}.pdf", arrays(2, 6, 9)["RGB"])
    assert b"/Title (\xfe\xff" in data


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("ext", EXTENSIONS)
def test_every_mode_is_written_or_refused_as_pil(tmp_path, ext, mode):
    """Each mode of ``Image.fromarray`` in each extension: PIL's bytes, or
    its refusal ("cannot save mode" for PDF, "image mode is not
    supported" for EPS, "cannot write mode ... as Palm"), naming the
    format, no file left."""
    a = arrays(5, 6, 10)[mode]
    data = hold(tmp_path, f"x{ext}", a)
    assert (data is not None) == (mode in chip_smoke.PDF_EPS_PALM_MODES[ext])


@pytest.mark.parametrize("name", ["random 40x100", "stripes 16x33",
                                  "runs 29x5300", "1x1 set"])
def test_g4_stream_decodes_to_the_page(tmp_path, name):
    """The PDF's CCITT stream, given back the 8-byte TIFF header PIL cut,
    is a TIFF that the port's CCITT decoder reads to the page; its
    directory is the 9 entries at the stream's end."""
    a = pages()[name]
    p = tmp_path / "page.pdf"
    with chip_smoke.fixed_gmtime():
        save_image(p, a)
    ok, stream = chip_smoke.pdf_parts(p.read_bytes())
    assert ok
    ifd = len(stream) - (2 + 9 * 12 + 4)
    assert struct.unpack("<H", stream[ifd:ifd + 2]) == (9,)
    tiff = tmp_path / "page.tif"
    tiff.write_bytes(b"II*\x00" + struct.pack("<I", 8 + ifd) + stream)
    back = read_image(tiff)
    assert back.dtype == bool and np.array_equal(back, a)
    np.testing.assert_array_equal(np.asarray(Image.open(tiff)), a)


def test_eps_hex_and_pdf_jpeg_hold_the_canvas(tmp_path):
    """``chip_smoke.py`` 14zj's checks on a drawing: the EPS hex gives the
    canvas's bytes in lines of 78 digits; the PDF's xref points at its
    objects and its image stream is the canvas's JPEG."""
    from mods_tpu_torch.io.image import _jpeg_bytes
    a = arrays(4, 31, 47)["RGB"]
    save_image(tmp_path / "x.eps", a)
    lines_ok, pixels = chip_smoke.eps_pixels((tmp_path / "x.eps")
                                             .read_bytes())
    assert lines_ok and pixels == a.tobytes()
    save_image(tmp_path / "x.pdf", a)
    ok, stream = chip_smoke.pdf_parts((tmp_path / "x.pdf").read_bytes())
    assert ok and stream == _jpeg_bytes(a, "RGB")


# ---------------------------------------------------------------------------
# the commands

@pytest.mark.parametrize("names", [("o1.pdf", "o2.eps"), ("o1.ps", "o2.pdf")])
def test_cli_match_drawings_are_the_jax_commands(pnm_jpeg_pair, tmp_path,
                                                 names, capsys):
    """``cli match`` (LORANSACH) on ``test_torch_image_io.py``'s textured
    PGM pair through ``mods_tpu.cli.cmd_match`` and the port's
    ``cli.main``, drawings named as PDF, EPS and PS: the same Matches
    line and matches file, and each drawing's file the JAX command's byte
    for byte, the clock fixed."""
    d = pnm_jpeg_pair
    printed = {}
    for tag, run in (("jax", jcli.cmd_match),
                     ("torch", lambda a: tcli.main(
                         ["match"] + a + ["--device", "cpu"]))):
        (tmp_path / tag).mkdir()
        o1, o2 = (str(tmp_path / tag / n) for n in names)
        with chip_smoke.fixed_gmtime():
            assert run([str(d / "a.pgm"), str(d / "b.pgm"), o1, o2, "k1",
                        "k2", str(tmp_path / tag / "m.txt"), "0",
                        "LORANSACH", str(d / "config.ini"),
                        str(d / "iters.ini")]) == 0
        printed[tag] = chip_smoke.MATCH_LINE.search(
            capsys.readouterr().out).groups()
    assert printed["torch"] == printed["jax"]
    assert int(printed["jax"][0]) >= 10
    for n in names + ("m.txt",):
        assert (tmp_path / "torch" / n).read_bytes() == \
            (tmp_path / "jax" / n).read_bytes(), n


# ---------------------------------------------------------------------------
# chip_smoke.py phase 14zi's hashes and 14zj's JAX figures

def views() -> list:
    return [np.asarray(Image.open(chip_smoke.PAIRS / f"{n}.png"))
            for n in ("zoom2x_1", "zoom2x_2", "tilt4_1")]


def encode_hashes(tmp) -> tuple:
    """14zi's tables from PIL's own saves of
    ``chip_smoke.raster_encode_canvases`` (``jviz.save_image``), each
    file named as 14zi names it, the clock at ``chip_smoke.PDF_CLOCK``:
    (PDF, EPS, PALM), each {canvas: SHA-256}; and {canvas: the extensions
    PIL wrote}."""
    tables = {".pdf": {}, ".eps": {}, ".ps": {}, ".palm": {}}
    written = {}
    with chip_smoke.fixed_gmtime():
        for i, (name, canvas) in enumerate(
                chip_smoke.raster_encode_canvases(views()).items()):
            written[name] = []
            for ext, table in tables.items():
                p = os.path.join(tmp, chip_smoke.pdf_eps_palm_name(i, ext))
                try:
                    jviz.save_image(p, canvas)
                except (OSError, ValueError):
                    assert not os.path.exists(p)
                    continue
                written[name].append(ext)
                with open(p, "rb") as f:
                    table[name] = hashlib.sha256(f.read()).hexdigest()
    assert tables[".eps"] == tables[".ps"]
    return (tables[".pdf"], tables[".eps"], tables[".palm"]), written


def test_pdf_eps_palm_hashes_are_pils(tmp_path):
    """Phase 14zi's tables are PIL's, its extensions a canvas the ones PIL
    writes, and the port's files of the same canvases under the same names
    give the hashes (``chip_smoke._encode_pdf_eps_palm``'s checks, without
    its timing)."""
    want, written = encode_hashes(tmp_path)
    assert want == (chip_smoke.PDF_ENCODE_SHA256,
                    chip_smoke.EPS_ENCODE_SHA256,
                    chip_smoke.PALM_ENCODE_SHA256)
    (tmp_path / "port").mkdir()
    pdfs, epss, palms = want
    tables = {".pdf": pdfs, ".eps": epss, ".ps": epss, ".palm": palms}
    with chip_smoke.fixed_gmtime():
        for i, (name, canvas) in enumerate(
                chip_smoke.raster_encode_canvases(views()).items()):
            exts = chip_smoke.pdf_eps_palm_extensions(canvas)
            assert list(exts) == written[name], name
            for ext in exts:
                p = tmp_path / "port" / chip_smoke.pdf_eps_palm_name(i, ext)
                save_image(p, canvas)
                assert hashlib.sha256(p.read_bytes()).hexdigest() == \
                    tables[ext][name], (name, ext)


def _jax_pdf_main() -> None:
    """The JAX command on phase 14zj's pair: ``JAX_PDF_REFERENCE``."""
    import contextlib
    import io
    import json
    import tempfile
    import time
    from pathlib import Path
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        (td / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
        (td / "iters.ini").write_text(chip_smoke.cviu_iters_ini())
        pair = [chip_smoke.PAIRS / f"zoom2x_{i}.png" for i in (1, 2)]
        m = td / "m.txt"
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), chip_smoke.fixed_gmtime():
            assert jcli.cmd_match([*map(str, pair), str(td / "o1.pdf"),
                                   str(td / "o2.eps"), "k1", "k2", str(m),
                                   "0", "LORANSACH", str(td / "config.ini"),
                                   str(td / "iters.ini")]) == 0
        h, w = np.asarray(Image.open(pair[0])).shape
        figures = chip_smoke.match_figures(
            buf.getvalue(), str(m),
            np.loadtxt(chip_smoke.PAIRS / "zoom2x_H.txt"), w, h)
    print(json.dumps(dict(figures, seconds=round(time.time() - t0, 1))),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--hashes"]:
        import pprint
        import tempfile
        with tempfile.TemporaryDirectory() as td:
            for table in encode_hashes(td)[0]:
                pprint.pprint(table, width=76)
    elif sys.argv[1:] == ["--jax-pdf"]:
        _jax_pdf_main()
    else:
        sys.exit("usage: python tests/test_torch_pdf_eps_palm.py --hashes "
                 "| --jax-pdf")
