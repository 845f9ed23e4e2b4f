"""Port vs PIL on writing GIF, and the JAX reference with .gif drawings
(CPU).

Tolerances: none, everywhere.
* ``adaptive_palette(a)`` gives exactly the indices and ``getpalette()`` of
  ``Image.fromarray(a).convert("P", palette=Image.Palette.ADAPTIVE)``
  (Pillow 12.1.0): one colour, a gray ramp as RGB, exactly 256 and 257
  colours, a few thousand, 598x1000 random RGB (the colour hash at a
  coarser scale), a colour drawing of the WebP pair, RGBA whose alpha
  alone varies (the fast octree), tied colour counts, gray.
* ``save_image(p, a)`` to .gif writes exactly the bytes of
  ``Image.fromarray(a).save(p)`` for every mode ``fromarray`` gives (1, L,
  LA, I;16, I, F, RGB, RGBA) at 1x1, 15x40 and 16x16 (the interlace
  edge), an odd width, just under and at 512x512 pixels (the palette
  optimisation's edge), a 1000x598 random gray image (many LZW table
  resets), a 1000x1196 drawing, a width over 16384 (ImageFile._save's
  buffer is then no multiple of 256 bytes), data that fills its last
  sub-block, uint32 arrays, and a seeded sweep of 40 arrays; the port
  reads each file to PIL's array and mode.  What PIL refuses (a shape
  ``fromarray`` cannot take, a side over 65535, no pixels), the port
  refuses by name.
* ``save_image`` to .dib writes PIL's DIB bytes (modes 1, L, RGB, RGBA),
  which the port reads, as it reads the BMP fixtures without their file
  header, to PIL's array and mode;
  uint32 arrays are written as PIL writes mode "I" (their bits as int32)
  to PNG, PNM, TIFF, GIF and (lossless) WebP.
* ``cli match`` (LORANSACH, ``test_torch_cli.py``'s two-rung INI) on
  zoom2x's PNG pair and on the WebP zoom2x fixtures, its drawings named
  .gif, against ``mods_tpu.cli.cmd_match``: the same rungs, the verified
  count within 20 %; the port's writer gives the JAX command's bytes for
  the JAX command's canvases, and PIL's bytes for the port's.

``test_gif_encode_hashes_are_pils`` computes ``chip_smoke.py`` phase
14l's ``GIF_ENCODE_SHA256`` with PIL (the canvases of
``chip_smoke.gif_encode_canvases``).
``JAX_PLATFORMS=cpu python tests/test_torch_gif_write.py --jax-gif``
prints the JAX command's figures on phase 14m's pair
(``chip_smoke.JAX_GIF_REFERENCE``).
"""

import hashlib
import io
import os
import sys
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

import chip_smoke  # noqa: E402
from mods_tpu import cli as jcli  # noqa: E402
from mods_tpu_torch import cli as tcli  # noqa: E402
from mods_tpu_torch import viz  # noqa: E402
from mods_tpu_torch.io.image import (_gif_bytes, _mode, _read,  # noqa: E402
                                     adaptive_palette, image_size,
                                     read_image, save_image)
from mods_tpu_torch.io.regions_io import read_h, read_matches  # noqa: E402
from test_torch_cli import SMALL_ITERS, load_jax_native  # noqa: E402

torch.set_num_threads(2)

FIXTURES = chip_smoke.IMAGE_FIXTURES


def _pil_gif(a) -> bytes:
    f = io.BytesIO()
    Image.fromarray(a).save(f, "GIF")
    return f.getvalue()


def _hold(p):
    """``_read``, ``read_image`` and ``image_size`` against PIL."""
    im = Image.open(p)
    want = np.asarray(im)
    got, mode = _read(p)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert mode == im.mode
    assert image_size(p) == im.size
    np.testing.assert_array_equal(read_image(p), want)


def _writes_pils_gif(tmp_path, a, name="x.gif"):
    p = tmp_path / name
    save_image(p, a)
    assert p.read_bytes() == _pil_gif(a)
    _hold(p)


def _views():
    return [np.asarray(Image.open(chip_smoke.PAIRS / f"{n}.png"))
            for n in ("zoom2x_1", "zoom2x_2", "tilt4_1")]


def _webp_drawing():
    """``viz``'s drawing of 40 seeded matches over the WebP zoom2x pair
    (PIL's lossy files, which read as RGB)."""
    imgs = [np.asarray(Image.open(FIXTURES / f"zoom2x_{i}.webp"))
            for i in (1, 2)]
    rng = np.random.default_rng(7)
    xy1 = rng.uniform(0, 590, (40, 2))
    return viz.draw_matches(*imgs, xy1, xy1 + rng.normal(0, 3, (40, 2)))


# ---------------------------------------------------------------------------
# the quantiser

def _colours(k, h, w, seed, equal=False):
    """k distinct colours on an (h, w) RGB canvas, each the same number of
    times (``equal``) or drawn at random."""
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 24, k, replace=False)
    cols = np.stack([keys >> 16, keys >> 8 & 255, keys & 255],
                    -1).astype(np.uint8)
    at = (np.arange(h * w) % k)[rng.permutation(h * w)] if equal \
        else rng.integers(0, k, h * w)
    return cols[at].reshape(h, w, 3)


def _alpha_alone():
    a = np.full((40, 50, 4), 90, np.uint8)
    a[..., 3] = np.random.default_rng(3).integers(0, 256, (40, 50))
    return a


ADAPTIVE = {
    "one colour 1x1": lambda: np.array([[[10, 200, 30]]], np.uint8),
    "200-level gray ramp as RGB": lambda: np.repeat(np.stack(
        [np.linspace(0, 255, 200).astype(np.uint8)] * 3, -1)[None], 9, 0),
    "256 colours": lambda: _colours(256, 40, 70, 1),
    "257 colours": lambda: _colours(257, 40, 70, 2),
    "3000 colours": lambda: _colours(3000, 90, 110, 3),
    "598x1000 random RGB": lambda: np.random.default_rng(4).integers(
        0, 256, (1000, 598, 3)).astype(np.uint8),
    "drawing of the WebP pair": _webp_drawing,
    "RGBA, alpha alone varying": _alpha_alone,
    "RGBA random": lambda: np.random.default_rng(5).integers(
        0, 256, (60, 70, 4)).astype(np.uint8),
    "tied counts, 512 colours": lambda: _colours(512, 64, 64, 6, True),
    "tied counts, 70000 colours": lambda: _colours(70000, 280, 500, 7,
                                                   True),
    "gray": lambda: np.random.default_rng(8).integers(
        0, 256, (50, 70)).astype(np.uint8),
}


@pytest.mark.parametrize("case", sorted(ADAPTIVE))
def test_adaptive_palette_is_pils(case):
    a = ADAPTIVE[case]()
    index, palette = adaptive_palette(a)
    im = Image.fromarray(a).convert("P", palette=Image.Palette.ADAPTIVE)
    want = np.array(im.getpalette(), np.uint8).reshape(-1, 3)
    assert palette.dtype == np.uint8 and palette.shape == want.shape
    np.testing.assert_array_equal(palette, want)
    assert index.dtype == np.uint8
    np.testing.assert_array_equal(index, np.asarray(im))


def test_adaptive_palette_refuses_other_modes():
    with pytest.raises(ValueError, match="cannot quantize mode F"):
        adaptive_palette(np.zeros((3, 3), np.float32))


# ---------------------------------------------------------------------------
# the writer, every mode and size class

def _mode_array(mode, shape, seed):
    g = np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)
    if mode == "1":
        return g > 128
    if mode == "L":
        return g
    if mode == "LA":
        return np.stack([g, 255 - g], -1)
    if mode == "I;16":
        return g.astype(np.uint16) * 3                # past 255: clipped
    if mode == "I":
        return g.astype(np.int32) * 2 - 200           # negative: clipped
    if mode == "F":
        f = g.astype(np.float32) * 1.3 - 20.5
        f.ravel()[:3] = [np.nan, np.inf, -np.inf][:f.size]
        return f
    rgb = np.stack([g, g // 2, 255 - g], -1)
    if mode == "RGB":
        return rgb
    return np.concatenate([rgb, np.where(g < 30, 0, g)[..., None]], -1)


MODES = ["1", "L", "LA", "I;16", "I", "F", "RGB", "RGBA"]
SIZES = [(1, 1), (15, 40), (16, 16), (17, 33), (511, 512), (512, 512)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mode", MODES)
def test_gif_writes_pils_bytes(tmp_path, mode, size):
    a = _mode_array(mode, size, 10 * MODES.index(mode) + SIZES.index(size))
    assert _mode(a) == mode
    _writes_pils_gif(tmp_path, a)


@pytest.mark.parametrize("size", [(511, 512), (512, 512)])
def test_gif_palette_optimisation_edge(tmp_path, size):
    """Five RGBA colours: the octree's 256-entry palette is cut to the five
    used (the transparent entry renumbered) below 512 x 512 pixels only."""
    cols = np.array([[0, 0, 0, 0], [255, 0, 0, 255], [0, 255, 0, 255],
                     [0, 0, 255, 128], [250, 250, 250, 255]], np.uint8)
    at = np.random.default_rng(9).integers(0, 5, size)
    a = cols[at]
    _writes_pils_gif(tmp_path, a)
    data = (tmp_path / "x.gif").read_bytes()
    assert data[:6] == b"GIF89a"
    assert (data[10] & 7) == (2 if size[0] * size[1] < 512 * 512 else 7)


def test_gif_random_gray_resets_the_lzw_table(tmp_path):
    _writes_pils_gif(tmp_path, np.random.default_rng(10).integers(
        0, 256, (1000, 598)).astype(np.uint8))


def test_gif_drawing(tmp_path):
    _writes_pils_gif(tmp_path, _webp_drawing())


def test_gif_wider_than_16384(tmp_path):
    _writes_pils_gif(tmp_path, np.random.default_rng(11).integers(
        0, 256, (20, 16447)).astype(np.uint8))


def test_gif_data_that_fills_its_last_sub_block(tmp_path):
    """A small seeded image whose LZW data is a whole number of 255-byte
    sub-blocks: nothing follows them but the terminator."""
    rng = np.random.default_rng(12)
    for _ in range(5000):
        h, w = rng.integers(1, 40, 2)
        a = rng.integers(0, rng.integers(2, 256), (h, w)).astype(np.uint8)
        data = _gif_bytes(a, "L")
        pos = 13 + 3 * (2 << (data[10] & 7)) + 11
        total = 0
        while data[pos]:
            total += data[pos]
            pos += 1 + data[pos]
        if total % 255 == 0:
            break
    else:
        pytest.fail("no seeded image filled its last sub-block")
    assert data[pos:] == b"\x00;"
    _writes_pils_gif(tmp_path, a)


def test_gif_upper_case_extension(tmp_path):
    _writes_pils_gif(tmp_path, _mode_array("RGB", (20, 30), 13), "X.GIF")


def _sweep_case(seed):
    rng = np.random.default_rng(100 + seed)
    mode = MODES[rng.integers(len(MODES))]
    h, w = rng.integers(1, 300 if seed % 8 == 0 else 80, 2)
    a = _mode_array(mode, (h, w), seed)
    if mode in ("L", "RGB", "RGBA") and seed % 3 == 0:   # few colours
        a = (a // 64 * 64).astype(np.uint8)
    return a


@pytest.mark.parametrize("seed", range(40))
def test_gif_seeded_sweep(tmp_path, seed):
    _writes_pils_gif(tmp_path, _sweep_case(seed))


@pytest.mark.parametrize("a,match", [
    (np.zeros((4, 4, 5), np.uint8), "cannot write"),
    (np.zeros((2, 70000), np.uint8), "1 to 65535"),
    (np.zeros((0, 5), np.uint8), "1 to 65535"),
])
def test_gif_refusals_are_pils(tmp_path, a, match):
    p = tmp_path / "x.gif"
    with pytest.raises(ValueError, match=match):
        save_image(p, a)
    assert not p.exists()
    with pytest.raises(Exception):
        _pil_gif(a)


def test_viz_writes_gif_drawings(tmp_path):
    canvas = _webp_drawing()
    viz.save_image(str(tmp_path / "d.gif"), canvas)
    assert (tmp_path / "d.gif").read_bytes() == _pil_gif(canvas)


def test_gif_encode_hashes_are_pils():
    """Phase 14l's hashes: PIL's file of each canvas and PIL's reading of
    it, which the port's writer and reader give too."""
    for name, canvas in chip_smoke.gif_encode_canvases(_views()).items():
        data = _pil_gif(canvas)
        im = Image.open(io.BytesIO(data))
        file_sha, mode, read_sha = chip_smoke.GIF_ENCODE_SHA256[name]
        assert hashlib.sha256(data).hexdigest() == file_sha, name
        assert im.mode == mode
        assert hashlib.sha256(np.asarray(im).tobytes()).hexdigest() == \
            read_sha, name
        assert _gif_bytes(canvas, _mode(canvas)) == data, name


# ---------------------------------------------------------------------------
# .dib and uint32 arrays

@pytest.mark.parametrize("mode", ["1", "L", "RGB", "RGBA"])
def test_dib_writes_pils_bytes(tmp_path, mode):
    a = _mode_array(mode, (20, 30), 14)
    save_image(tmp_path / "x.dib", a)
    f = io.BytesIO()
    Image.fromarray(a).save(f, "DIB")
    assert (tmp_path / "x.dib").read_bytes() == f.getvalue()
    _hold(tmp_path / "x.dib")


@pytest.mark.parametrize("name", ["rle4.bmp", "rle8.bmp", "rgb565.bmp"])
def test_dib_of_a_bmp_fixture_reads_as_pil(tmp_path, name):
    """The BMP fixtures without their file header: RLE4, RLE8 (absolute
    runs aligned as in the file) and 16-bit bitfields, read where PIL's
    DibImageFile finds the pixels."""
    p = tmp_path / "x.dib"
    p.write_bytes((FIXTURES / name).read_bytes()[14:])
    assert Image.open(p).format == "DIB"
    _hold(p)


UINT32 = np.random.default_rng(15).integers(
    0, 2 ** 32, (17, 23), dtype=np.uint64).astype(np.uint32)
UINT32[0, :6] = [0, 5, 300, 70000, 2 ** 31, 2 ** 32 - 1]


@pytest.mark.parametrize("ext", [".png", ".pgm", ".tif", ".gif", ".webp"])
def test_uint32_is_written_as_pils_mode_i(tmp_path, ext):
    ours, pils = tmp_path / f"o{ext}", tmp_path / f"p{ext}"
    save_image(ours, UINT32)
    kw = dict(lossless=True) if ext == ".webp" else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        Image.fromarray(UINT32).save(pils, **kw)
    if ext in (".pgm", ".tif", ".gif"):
        assert ours.read_bytes() == pils.read_bytes()
    got, want = Image.open(ours), Image.open(pils)
    assert got.mode == want.mode
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    _hold(ours)


# ---------------------------------------------------------------------------
# the match command with .gif drawings

@pytest.fixture(scope="module")
def gif_work(tmp_path_factory):
    load_jax_native()
    d = tmp_path_factory.mktemp("gif_pair")
    (d / "iters.ini").write_text(SMALL_ITERS)
    (d / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
    return d


@pytest.mark.parametrize("pair", ["png", "webp"])
def test_cli_match_with_gif_drawings_against_jax(gif_work, pair, capsys):
    d = gif_work
    where = chip_smoke.PAIRS if pair == "png" else FIXTURES
    images = [str(where / f"zoom2x_{i}.{pair}") for i in (1, 2)]
    loaded = [read_image(p) for p in images]
    h, w = loaded[0].shape[:2]
    H_gt = np.loadtxt(chip_smoke.PAIRS / "zoom2x_H.txt")
    figures = {}
    for tag, run in (("jax", jcli.cmd_match),
                     ("torch", lambda a: tcli.main(
                         ["match"] + a + ["--device", "cpu"]))):
        m = d / f"m_{pair}_{tag}.txt"
        assert run([*images, str(d / f"o1_{pair}_{tag}.gif"),
                    str(d / f"o2_{pair}_{tag}.gif"), "k1", "k2", str(m), "0",
                    "LORANSACH", str(d / "config.ini"),
                    str(d / "iters.ini")]) == 0
        figures[tag] = chip_smoke.match_figures(
            capsys.readouterr().out, str(m), H_gt, w, h)
        # each command's drawings are its writer's bytes of viz's canvases
        # of its matches: the port's writer gives them for both
        xy1, xy2 = read_matches(str(m))
        H = read_h(f"{m}.H")
        for o, canvas in (
                (1, viz.draw_matches(*loaded, xy1, xy2)),
                (2, viz.draw_matches_with_error(*loaded, xy1, xy2, H))):
            data = (d / f"o{o}_{pair}_{tag}.gif").read_bytes()
            assert data == _gif_bytes(canvas, "RGB"), (tag, o)
            if tag == "torch":
                assert data == _pil_gif(canvas)
    j, t = figures["jax"], figures["torch"]
    assert t["steps"] == j["steps"]
    assert t["matches"] >= 10 and abs(t["matches"] - j["matches"]) \
        <= 0.2 * j["matches"], (t, j)


# ---------------------------------------------------------------------------
# the JAX figures of chip_smoke.py phase 14m

def _jax_gif_main() -> None:
    """The JAX command on phase 14m's pair: the WebP zoom2x fixtures,
    LORANSACH, the CVIU-shaped INI files, drawings named o1.gif and o2.gif
    (``JAX_GIF_REFERENCE``)."""
    import contextlib
    import json
    import tempfile
    import time
    from pathlib import Path
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        (td / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
        (td / "iters.ini").write_text(chip_smoke.cviu_iters_ini())
        m = td / "m.txt"
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jcli.cmd_match([str(FIXTURES / "zoom2x_1.webp"),
                                   str(FIXTURES / "zoom2x_2.webp"),
                                   str(td / "o1.gif"), str(td / "o2.gif"),
                                   "k1", "k2", str(m), "0", "LORANSACH",
                                   str(td / "config.ini"),
                                   str(td / "iters.ini")]) == 0
        h, w = np.asarray(Image.open(FIXTURES / "zoom2x_1.webp")).shape[:2]
        figures = chip_smoke.match_figures(
            buf.getvalue(), str(m),
            np.loadtxt(chip_smoke.PAIRS / "zoom2x_H.txt"), w, h)
        assert all(Image.open(td / f"o{o}.gif").format == "GIF"
                   for o in (1, 2))
    print(json.dumps(dict(figures, seconds=round(time.time() - t0, 1))),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--jax-gif"]:
        _jax_gif_main()
