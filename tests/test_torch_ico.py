"""Port vs PIL on ICO and CUR files and on the Lanczos thumbnails of
PIL's ICO writer (CPU, Pillow 12.1.0).

``Image.fromarray(a).save("x.ico")`` (IcoImagePlugin._save) makes a frame
of each default size that fits, each ``Image.thumbnail(size, LANCZOS,
reducing_gap=None)``, saved as PNG.  The port's PNG payloads are
``io/png.py``'s (filter 0, CPython's zlib) and Pillow's are zlib-ng's with
a filter chosen for each row, so the files differ in bytes; what PIL
reads from them must not: the same entries in the same order, the same
``info["sizes"]``, size and mode, and every frame's mode, size and array.
The thumbnails (``io/raster.py::resize_lanczos``, ``csrc/resample.cpp``)
are held to ``Image.resize`` alone in every mode at odd ratios.

Tolerance: none, anywhere.

``JAX_PLATFORMS=cpu python tests/test_torch_ico.py --jax-tga`` prints the
JAX command's figures on phase 14y's TGA pair
(``chip_smoke.JAX_TGA_REFERENCE``); ``python tests/test_torch_ico.py
--hashes`` prints 14x's ``RASTER_ENCODE_SHA256`` and
``ICO_ENCODE_FRAMES``, computed with PIL.
"""

import hashlib
import io
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytest  # noqa: E402
from PIL import Image  # noqa: E402

import chip_smoke  # noqa: E402
from mods_tpu_torch.io import raster  # noqa: E402
from mods_tpu_torch.io.image import _read, image_size, save_image  # noqa
from test_torch_raster_formats import (MODES, arrays, hold_read,  # noqa
                                       pil_bytes)

LANCZOS = Image.Resampling.LANCZOS
# (height, width) of the image -> the size asked of ``Image.thumbnail``
THUMBS = {"598 x 1000 to 153 x 256": ((1000, 598), (256, 256)),
          "37 x 29 to 16 x 13": ((29, 37), (16, 16)),
          "300 x 1 to 16 x 1": ((1, 300), (16, 16)),
          "1 x 300 to 1 x 24": ((300, 1), (24, 24)),
          "7 x 5 to 1 x 1": ((5, 7), (1, 1))}


@pytest.mark.parametrize("case", sorted(THUMBS))
@pytest.mark.parametrize("mode", MODES)
def test_thumbnail_equals_pils(case, mode):
    """``thumbnail_size`` is ``Image.thumbnail``'s size and
    ``resize_lanczos`` its array, dtype and all ("LA" and "RGBA"
    premultiplied, "1" by nearest neighbour); the resample to that size
    alone is ``Image.resize``'s."""
    shape, ask = THUMBS[case]
    a = arrays(len(case), *shape)[mode]
    im = Image.fromarray(a)
    want = im.copy()
    want.thumbnail(ask, LANCZOS, reducing_gap=None)
    size = raster.thumbnail_size(shape[1], shape[0], ask)
    assert size == want.size
    got = raster.resize_lanczos(a, mode, size)
    w = np.asarray(want)
    assert (got.dtype, got.shape) == (w.dtype, w.shape)
    np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(
        got, np.asarray(im.resize(size, LANCZOS)))


def _entries(im) -> list:
    return [(e.width, e.height, e.nb_color, e.bpp) for e in im.ico.entry]


def hold_ico(tmp_path, a: np.ndarray) -> None:
    """The port's ICO of ``a`` reads in PIL as PIL's own does (entries,
    sizes, size, mode, every frame), and the port reads both as PIL
    does; or both refuse ``a``."""
    ours, pils = tmp_path / "port.ico", tmp_path / "pil.ico"
    ours.unlink(missing_ok=True)
    try:
        Image.fromarray(a).save(pils)
    except OSError as e:
        with pytest.raises(ValueError, match=str(e)):
            save_image(ours, a)
        assert not ours.exists()
        return
    save_image(ours, a)
    try:
        want = Image.open(pils)
    except Exception:                   # no frame: PIL cannot open it
        assert ours.read_bytes() == pils.read_bytes()
        with pytest.raises(ValueError):
            _read(ours)
        return
    got = Image.open(ours)
    assert _entries(got) == _entries(want)
    assert (got.info["sizes"], got.size, got.mode) == (
        want.info["sizes"], want.size, want.mode)
    for i in range(len(want.ico.entry)):
        f, g = want.ico.frame(i), got.ico.frame(i)
        assert (g.mode, g.size) == (f.mode, f.size)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(f))
    hold_read(ours)
    hold_read(pils)


@pytest.mark.parametrize("mode", MODES)
def test_ico_frames_are_pils(tmp_path, mode):
    """Every mode at 16 x 16 (the image itself, no thumbnail), 33 x 20
    (one frame of 16 x 10), 300 x 257 (six frames up to 256 x 219),
    300 x 15 (none: PIL writes an empty directory, which it cannot open)
    and 17 x 64, and zoom2x_1 (598 x 1000: seven frames from 10 x 16 to
    153 x 256); "F" is refused as PIL refuses it, but where no frame is
    made."""
    for seed, shape in enumerate(((16, 16), (20, 33), (257, 300), (15, 300),
                                  (64, 17))):
        hold_ico(tmp_path, arrays(seed, *shape)[mode])
    z = np.asarray(Image.open(chip_smoke.PAIRS / "zoom2x_1.png"))
    hold_ico(tmp_path, {"1": z > 127, "LA": np.stack([z, z[::-1]], -1),
                        "RGB": np.stack([z, z[::-1], z[:, ::-1]], -1),
                        "RGBA": np.stack([z, z[::-1], z[:, ::-1],
                                          z // 2 + (z > 200) * 100], -1)
                        .astype(np.uint8),
                        "I;16": z.astype(np.uint16) * 257,
                        "I": z.astype(np.int32) * 300 - 9000,
                        "F": z.astype(np.float32)}.get(mode, z))


def test_png_payloads_are_pils_arrays_not_pils_bytes():
    """Why an ICO is held by its frames: Pillow 12.1.0 deflates PNG
    through zlib-ng 2.3.2 with a filter chosen for each row, the port
    through CPython's zlib with filter 0, so the bytes differ (a random
    40 x 50 RGB: 6108 bytes each, other bytes; a blocky 60 x 60 gray:
    206 and 180) or agree (a 16 x 16 zero RGBA: 75 bytes each), and PIL
    reads the same array from both."""
    from PIL import features
    from mods_tpu_torch.io import png
    assert features.version_feature("zlib_ng") == "2.3.2"
    rng = np.random.default_rng(0)
    cases = [(rng.integers(0, 256, (40, 50, 3), dtype=np.uint8), 6108,
              6108),
             (np.kron(rng.integers(0, 256, (6, 6), dtype=np.uint8),
                      np.ones((10, 10), np.uint8)), 206, 180),
             (np.zeros((16, 16, 4), np.uint8), 75, 75)]
    for a, n_pil, n_port in cases:
        pil, port = pil_bytes(a, "PNG"), png.encode_png(a)
        assert (len(pil), len(port)) == (n_pil, n_port)
        assert (pil == port) == (n_pil == 75)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(
            port))), a)


# ---------------------------------------------------------------------------
# reading PIL's icons and cursors

ICO_READS = {
    "png entries": {},
    "bmp entries": {"bitmap_format": "bmp"},
    "bmp entries, two sizes": {"bitmap_format": "bmp",
                               "sizes": [(16, 16), (48, 48)]},
}


@pytest.mark.parametrize("case", sorted(ICO_READS))
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "LA"])
def test_read_pils_icos(tmp_path, case, mode):
    """PIL's ICOs of PNG or BMP entries in each mode PIL writes (BMP
    entries below 32 bits get an AND mask, read from the end of the
    entry, and become RGBA), at 48 x 48 and 61 x 50."""
    for seed, shape in enumerate(((48, 48), (50, 61))):
        a = arrays(seed, *shape)
        img = Image.fromarray(a["RGB"]).convert(
            "P", palette=Image.Palette.ADAPTIVE, colors=30) \
            if mode == "P" else Image.fromarray(a[mode])
        try:
            data = pil_bytes(img, "ICO", **ICO_READS[case])
        except (OSError, KeyError):
            continue
        p = tmp_path / "f.ico"
        p.write_bytes(data)
        hold_read(p)
        cur = bytearray(data)
        cur[2] = 2
        p = tmp_path / "f.cur"
        p.write_bytes(bytes(cur))
        hold_read(p)


def test_equal_areas_take_the_deepest_entry_last(tmp_path):
    """Two entries of one size, 32 and 24 bits (PIL's ``append_images``):
    ``Image.open`` shows the one of fewer bits (PIL sorts by colour
    depth, then stably by area)."""
    a = arrays(4, 32, 32)
    data = pil_bytes(a["RGBA"], "ICO", bitmap_format="bmp",
                     sizes=[(32, 32)],
                     append_images=[Image.fromarray(a["RGB"])])
    p = tmp_path / "f.ico"
    p.write_bytes(data)
    assert [e.bpp for e in Image.open(p).ico.entry] == [24, 32]
    hold_read(p)


def test_cursor_of_one_32_bit_entry_is_bgra(tmp_path):
    """A cursor whose one DIB starts at byte 22 reads its 32-bit pixels
    as BGRA (CurImagePlugin's ``header == 22``); with two entries it
    does not."""
    a = arrays(5, 32, 32)["RGBA"]
    for sizes in ([(32, 32)], [(16, 16), (32, 32)]):
        cur = bytearray(pil_bytes(a, "ICO", bitmap_format="bmp",
                                  sizes=sizes))
        cur[2] = 2
        p = tmp_path / "f.cur"
        p.write_bytes(bytes(cur))
        assert Image.open(p).mode == ("RGBA" if len(sizes) == 1 else "RGB")
        hold_read(p)


def test_broken_directories(tmp_path):
    """An empty or cut directory, an entry past the end of the file and a
    cursor without cursors: refused, or passed on to TGA, as PIL does."""
    good = pil_bytes(arrays(6, 20, 20)["RGB"], "ICO")
    for data in (b"\x00\x00\x01\x00\x00\x00", good[:20],
                 good[:18] + b"\xff\xff\xff\x00" + good[22:],
                 b"\x00\x00\x02\x00\x00\x00" + bytes(40),
                 b"\x00\x00\x02\x00\x01\x00" + bytes(12) + b"\xff" * 4):
        p = tmp_path / "f.ico"
        p.write_bytes(data)
        hold_read(p)


# ---------------------------------------------------------------------------
# phase 14x's and 14y's figures

# 14x's QOI canvases (PIL's QOI encoder is Python: 1.5 s a 1000 x 598)
QOI_CANVASES = ("zoom2x_1, zoom2x_2, tilt4_1 RGB",
                "zoom2x_1, zoom2x_2, tilt4_1 RGBA",
                "a 12-row strip of the RGB canvas")


def encode_hashes(tmp) -> tuple:
    """``chip_smoke.RASTER_ENCODE_SHA256`` and ``ICO_ENCODE_FRAMES`` from
    PIL's files of ``raster_encode_canvases``."""
    views = [np.asarray(Image.open(chip_smoke.PAIRS / f"{n}.png"))
             for n in ("zoom2x_1", "zoom2x_2", "tilt4_1")]
    sha, frames = {}, {}
    for i, (name, canvas) in enumerate(
            chip_smoke.raster_encode_canvases(views).items()):
        for ext in (".tga", ".sgi", ".pcx", ".qoi"):
            if ext == ".qoi" and name not in QOI_CANVASES:
                continue
            p = os.path.join(tmp, f"canvas_{i}{ext}")
            try:
                Image.fromarray(canvas).save(p)
            except (OSError, ValueError):
                continue
            with open(p, "rb") as f:
                sha.setdefault(name, {})[ext] = hashlib.sha256(
                    f.read()).hexdigest()
        p = os.path.join(tmp, f"canvas_{i}.ico")
        Image.fromarray(canvas).save(p)
        if min(canvas.shape[:2]) < 16:      # no frame: PIL cannot open it
            frames[name] = ()
            continue
        im = Image.open(p)
        frames[name] = tuple(
            (e.width, e.height, e.bpp,
             chip_smoke._frame_sha256(np.asarray(im.ico.frame(k))))
            for k, e in enumerate(im.ico.entry))
    return sha, frames


def test_raster_encode_hashes_are_pils(tmp_path):
    """Phase 14x's hashes are PIL's; the port's files of the same canvases
    give them (its ICOs through the port's own reading of the frames)."""
    sha, frames = encode_hashes(tmp_path)
    assert sha == chip_smoke.RASTER_ENCODE_SHA256
    assert frames == chip_smoke.ICO_ENCODE_FRAMES
    views = [np.asarray(Image.open(chip_smoke.PAIRS / f"{n}.png"))
             for n in ("zoom2x_1", "zoom2x_2", "tilt4_1")]
    for i, (name, canvas) in enumerate(
            chip_smoke.raster_encode_canvases(views).items()):
        for ext in sha.get(name, {}):
            p = tmp_path / "port" / f"canvas_{i}{ext}"
            p.parent.mkdir(exist_ok=True)
            save_image(p, canvas)
            assert hashlib.sha256(p.read_bytes()).hexdigest() == \
                sha[name][ext], (name, ext)
        p = tmp_path / "port" / "x.ico"
        save_image(p, canvas)
        assert chip_smoke.ico_frames_of(p.read_bytes(), p) == frames[name]


def test_cli_match_on_the_tga_pair(tmp_path, capsys):
    """``cli match`` (LORANSACH, the CVIU-shaped INI files, as phase 14y
    runs it) on zoom2x's pair as PIL's TGAs, its drawings named .ico and
    .tga: the JAX command's rung and verified count within 20 %
    (``JAX_TGA_REFERENCE``, by ``test_torch_cli.py``'s rule); the .tga is
    the JAX package's ``viz.save_image`` (PIL) bytes of ``viz``'s canvas,
    and PIL reads from the .ico the frames of its own .ico of it."""
    from mods_tpu import viz as jviz
    from mods_tpu_torch import cli as tcli
    from mods_tpu_torch import viz
    from mods_tpu_torch.io.image import read_image
    from mods_tpu_torch.io.regions_io import read_h, read_matches
    imgs = []
    for i in (1, 2):
        imgs.append(tmp_path / f"zoom2x_{i}.tga")
        Image.open(chip_smoke.PAIRS / f"zoom2x_{i}.png").save(imgs[-1])
    (tmp_path / "iters.ini").write_text(chip_smoke.cviu_iters_ini())
    (tmp_path / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
    o1, o2, m = tmp_path / "o1.ico", tmp_path / "o2.tga", tmp_path / "m.txt"
    assert tcli.main(["match", *map(str, imgs), str(o1), str(o2), "k1",
                      "k2", str(m), "0", "LORANSACH",
                      str(tmp_path / "config.ini"),
                      str(tmp_path / "iters.ini"), "--device", "cpu"]) == 0
    loaded = [read_image(p) for p in imgs]
    h, w = loaded[0].shape
    got = chip_smoke.match_figures(
        capsys.readouterr().out, str(m),
        np.loadtxt(chip_smoke.PAIRS / "zoom2x_H.txt"), w, h)
    ref = chip_smoke.JAX_TGA_REFERENCE
    assert got["steps"] == ref["steps"], (got, ref)
    assert abs(got["matches"] - ref["matches"]) <= 0.2 * ref["matches"]
    assert abs(got["tentatives"] - ref["tentatives"]) <= \
        0.2 * ref["tentatives"]
    xy1, xy2 = read_matches(str(m))
    canvases = (viz.draw_matches(*loaded, xy1, xy2),
                viz.draw_matches_with_error(*loaded, xy1, xy2,
                                            read_h(f"{m}.H")))
    jviz.save_image(str(tmp_path / "jax.ico"), canvases[0])
    jviz.save_image(str(tmp_path / "jax.tga"), canvases[1])
    assert o2.read_bytes() == (tmp_path / "jax.tga").read_bytes()
    want, got_ico = Image.open(tmp_path / "jax.ico"), Image.open(o1)
    assert _entries(got_ico) == _entries(want)
    for i in range(len(want.ico.entry)):
        np.testing.assert_array_equal(np.asarray(got_ico.ico.frame(i)),
                                      np.asarray(want.ico.frame(i)))


def _jax_tga_main() -> None:
    """The JAX command on phase 14y's pair: ``JAX_TGA_REFERENCE``."""
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
            pair.append(str(td / f"zoom2x_{i}.tga"))
            Image.open(chip_smoke.PAIRS / f"zoom2x_{i}.png").save(pair[-1])
        m = td / "m.txt"
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jcli.cmd_match(pair + ["0", "0", "k1", "k2", str(m), "0",
                                          "LORANSACH", str(td / "config.ini"),
                                          str(td / "iters.ini")]) == 0
        h, w = np.asarray(Image.open(pair[0])).shape
        figures = chip_smoke.match_figures(
            buf.getvalue(), str(m),
            np.loadtxt(chip_smoke.PAIRS / "zoom2x_H.txt"), w, h)
    print(json.dumps(dict(figures, seconds=round(time.time() - t0, 1))),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--jax-tga"]:
        _jax_tga_main()
    elif sys.argv[1:] == ["--hashes"]:
        import pprint
        import tempfile
        with tempfile.TemporaryDirectory() as td:
            for table in encode_hashes(td):
                pprint.pprint(table, width=76)
    else:
        sys.exit("usage: python tests/test_torch_ico.py --jax-tga | "
                 "--hashes")
