"""Port vs PIL on writing JPEG 2000 (.j2k codestreams and .jp2 files), as
the JAX commands write their drawings (``mods_tpu/viz.py::save_image``:
``Image.fromarray(canvas).save(path)``, Pillow 12.1.0 with OpenJPEG
2.5.4) (CPU).

Tolerance: none, everywhere.  ``save_image(p, a)`` to .j2k or .jp2 writes
exactly the bytes of PIL's default save of the same array to the same
path, and the port reads its file back to PIL's array and mode:
* every mode PIL writes ("L", "LA", "RGB", "RGBA", "I;16") to both
  extensions;
* the sizes 1x1, 1x9, 9x1, 2x2, 3x5, 17x70, 64x64, 65x129 and two
  strips, 600x5 and 9x700: every number of resolutions from 1 to 6 and
  the code-block edges at 64/65;
* arrays that are flat (0, 128, 255, 65535) or hold one bright pixel:
  empty code-blocks and zero bit-planes in the tag trees;
* a seeded sweep of 30 arrays of random modes, shapes and contents;
* zoom2x_1, whose .jp2 is ``tests/data/image_io/zoom2x_1_lossless.jp2``
  (PIL's file, which ``chip_smoke.py`` phase 14v holds the card machine
  to);
* ``cli match``'s drawings on the repo's JP2 pair (``chip_smoke.J2K_PAIR``)
  named .jp2: the JAX package's ``viz.save_image`` of the same canvases;
* a side over 32768 (more than one precinct), an upper-case ".J2K"
  (written as JP2, as Pillow tests the name), the encoder's answer when
  its room is short, twelve encodes at once;
* modes "1", "I" and "F", which PIL refuses too: a ValueError naming the
  mode and JPEG 2000, and no file.

``test_j2k_encode_hashes_are_pils`` computes ``chip_smoke.py`` phase
14v's ``J2K_ENCODE_SHA256`` with PIL (the canvases of
``chip_smoke.gif_encode_canvases``).
"""

import ctypes
import hashlib
import io
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

import chip_smoke  # noqa: E402
from mods_tpu import viz as jviz  # noqa: E402
from mods_tpu_torch import cli as tcli  # noqa: E402
from mods_tpu_torch import viz  # noqa: E402
from mods_tpu_torch.io.image import (_j2k_bytes, _j2k_encoder,  # noqa
                                     _mode, _read, image_size,
                                     read_image, save_image)
from mods_tpu_torch.io.regions_io import read_h, read_matches  # noqa: E402

torch.set_num_threads(2)

EXTS = [".j2k", ".jp2"]


def _pil_save(a, name) -> bytes:
    """PIL's default save of ``a`` to a file called ``name``."""
    f = io.BytesIO()
    Image.fromarray(a).save(f, "JPEG2000", no_jp2=name.endswith(".j2k"))
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


def _writes_pils(tmp_path, a, name):
    """The port's file of ``a`` is PIL's, byte for byte, and reads back
    as PIL reads it."""
    ours, pils = tmp_path / name, tmp_path / f"pil_{name}"
    save_image(ours, a)
    Image.fromarray(a).save(pils)
    assert ours.read_bytes() == pils.read_bytes()
    _hold(ours)


def _mode_array(mode, shape, seed, style="texture"):
    """An array of ``mode`` (one of the modes PIL writes): a smooth
    texture with noise, uniform noise, a few levels, or a sparse one."""
    rng = np.random.default_rng(seed)
    h, w = shape
    top = 65535 if mode == "I;16" else 255
    bands = {"L": 1, "I;16": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    if style == "noise":
        a = rng.integers(0, top + 1, (h, w, bands))
    elif style == "levels":
        a = rng.integers(0, 4, (h, w, bands)) * (top // 3)
    elif style == "sparse":
        a = np.zeros((h, w, bands), np.int64)
        a.reshape(-1)[rng.integers(0, a.size, 3)] = top
    else:
        y, x = np.mgrid[0:h, 0:w]
        a = np.stack([(np.sin(x / 7.0 + c) + np.cos(y / 5.0 - c)) * top / 4
                      + top / 2 for c in range(bands)], -1)
        a = a + rng.normal(0, top / 40, a.shape)
    a = np.clip(a, 0, top).astype(np.uint16 if mode == "I;16" else np.uint8)
    return a[..., 0] if bands == 1 else a


# ---------------------------------------------------------------------------
# modes, sizes and edges

MODES = ["L", "LA", "RGB", "RGBA", "I;16"]


@pytest.mark.parametrize("ext", EXTS)
@pytest.mark.parametrize("mode", MODES)
def test_every_mode_pil_writes(tmp_path, mode, ext):
    a = _mode_array(mode, (37, 53), MODES.index(mode))
    assert _mode(a) == mode
    _writes_pils(tmp_path, a, f"x{ext}")


SIZES = [(1, 1), (1, 9), (9, 1), (2, 2), (3, 5), (17, 70), (64, 64),
         (65, 129), (600, 5), (9, 700)]


@pytest.mark.parametrize("ext", EXTS)
@pytest.mark.parametrize("size", SIZES)
def test_sizes(tmp_path, size, ext):
    """Resolutions 1 (a side of 1), 2 (2, 3), 3 (5), 4 (9), 5 (17) and 6,
    code-blocks cut at 64 and 65."""
    mode = MODES[SIZES.index(size) % len(MODES)]
    _writes_pils(tmp_path, _mode_array(mode, size, SIZES.index(size)),
                 f"x{ext}")


FLAT = {
    "all 0": lambda: np.zeros((40, 50), np.uint8),
    "all 128 RGB": lambda: np.full((40, 50, 3), 128, np.uint8),
    "all 255": lambda: np.full((70, 33), 255, np.uint8),
    "all 65535": lambda: np.full((40, 50), 65535, np.uint16),
    "all 0 RGBA": lambda: np.zeros((20, 70, 4), np.uint8),
    "one bright pixel": lambda: np.pad(np.full((1, 1), 255, np.uint8),
                                       ((33, 40), (44, 60))),
    "one bright pixel, 16 bits": lambda: np.pad(
        np.full((1, 1), 65535, np.uint16), ((70, 2), (3, 65))),
}


@pytest.mark.parametrize("ext", EXTS)
@pytest.mark.parametrize("case", sorted(FLAT))
def test_flat_and_sparse(tmp_path, case, ext):
    _writes_pils(tmp_path, FLAT[case](), f"x{ext}")


def _sweep_case(seed):
    rng = np.random.default_rng(500 + seed)
    mode = MODES[rng.integers(len(MODES))]
    h, w = rng.integers(1, 260 if seed % 6 == 0 else 90, 2)
    style = ["texture", "noise", "levels", "sparse"][seed % 4]
    return _mode_array(mode, (int(h), int(w)), seed, style), EXTS[seed % 2]


@pytest.mark.parametrize("seed", range(30))
def test_seeded_sweep(tmp_path, seed):
    a, ext = _sweep_case(seed)
    _writes_pils(tmp_path, a, f"x{ext}")


def test_more_than_one_precinct(tmp_path):
    """A side over 2^15 samples: two precincts, two packets in turn."""
    rng = np.random.default_rng(9)
    _writes_pils(tmp_path, rng.integers(0, 256, (2, 33000)).astype(
        np.uint8), "wide.jp2")
    _writes_pils(tmp_path, rng.integers(0, 256, (33000, 1)).astype(
        np.uint8), "tall.j2k")


def test_upper_case_extension_is_written_as_jp2(tmp_path):
    """Pillow writes a codestream only where the name ends in ".j2k"."""
    a = _mode_array("RGB", (20, 30), 13)
    _writes_pils(tmp_path, a, "X.J2K")
    assert (tmp_path / "X.J2K").read_bytes()[4:8] == b"jP  "


def test_short_room_gives_the_length(tmp_path):
    """With too little room the encoder copies nothing and gives the
    length; with that room, PIL's bytes."""
    a = _mode_array("L", (30, 40), 4)
    want = _pil_save(a, "x.jp2")
    out = np.full(len(want), 7, np.uint8)
    err = ctypes.create_string_buffer(256)
    lib = _j2k_encoder()
    n = lib.mods_j2k_encode(a.ctypes.data, 40, 30, 1, 8, 1, out.ctypes.data,
                            len(want) - 1, err, len(err))
    assert n == len(want) and (out == 7).all()
    n = lib.mods_j2k_encode(a.ctypes.data, 40, 30, 1, 8, 1, out.ctypes.data,
                            len(want), err, len(err))
    assert n == len(want) and out.tobytes() == want


def test_concurrent_saves_are_pils():
    """Twelve encodes at once, each coding its code-blocks on threads of
    its own: every file PIL's bytes."""
    from concurrent.futures import ThreadPoolExecutor
    arrays = [_mode_array(MODES[i % len(MODES)], (150 + i, 170), 40 + i,
                          ("texture", "noise")[i % 2]) for i in range(12)]
    with ThreadPoolExecutor(12) as pool:
        got = list(pool.map(lambda a: _j2k_bytes(a, _mode(a)), arrays,
                            timeout=120))
    assert got == [_pil_save(a, "x.jp2") for a in arrays]


def test_zoom2x_1_is_the_fixture(tmp_path):
    """zoom2x_1 as .jp2 is ``J2K_LOSSLESS``, PIL's file, byte for byte."""
    view = np.asarray(Image.open(chip_smoke.PAIRS / "zoom2x_1.png"))
    fixture = (chip_smoke.IMAGE_FIXTURES / chip_smoke.J2K_LOSSLESS)
    save_image(tmp_path / "z.jp2", view)
    assert (tmp_path / "z.jp2").read_bytes() == fixture.read_bytes() == \
        _pil_save(view, "z.jp2")


# ---------------------------------------------------------------------------
# refusals

@pytest.mark.parametrize("ext", EXTS)
@pytest.mark.parametrize("mode,a", [
    ("1", np.zeros((4, 4), bool)),
    ("I", np.arange(16, dtype=np.int32).reshape(4, 4)),
    ("F", np.ones((4, 4), np.float32)),
])
def test_modes_pil_refuses(tmp_path, mode, a, ext):
    p = tmp_path / f"x{ext}"
    with pytest.raises(ValueError, match=f"mode {mode} as JPEG 2000"):
        save_image(p, a)
    assert not p.exists()
    with pytest.raises(OSError, match="broken data stream"):
        Image.fromarray(a).save(tmp_path / f"pil{ext}")


# ---------------------------------------------------------------------------
# the drawings of cli match, and phase 14v's hashes

def test_cli_match_drawings_are_the_jax_writers(tmp_path, capsys):
    """``cli match`` (LORANSACH, the CVIU-shaped INI files, as phase 14u
    runs it) on the JP2 zoom2x pair, its drawings named .jp2: each file
    is what the JAX package's ``viz.save_image`` (PIL) writes for
    ``viz``'s canvas of the written matches and H."""
    imgs = [chip_smoke.IMAGE_FIXTURES / n for n in chip_smoke.J2K_PAIR]
    (tmp_path / "iters.ini").write_text(chip_smoke.cviu_iters_ini())
    (tmp_path / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
    o1, o2, m = tmp_path / "o1.jp2", tmp_path / "o2.jp2", tmp_path / "m.txt"
    assert tcli.main(["match", *map(str, imgs), str(o1), str(o2), "k1",
                      "k2", str(m), "0", "LORANSACH",
                      str(tmp_path / "config.ini"),
                      str(tmp_path / "iters.ini"), "--device", "cpu"]) == 0
    capsys.readouterr()
    loaded = [read_image(p) for p in imgs]
    xy1, xy2 = read_matches(str(m))
    assert len(xy1) >= 10
    canvases = (viz.draw_matches(*loaded, xy1, xy2),
                viz.draw_matches_with_error(*loaded, xy1, xy2,
                                            read_h(f"{m}.H")))
    for path, canvas in zip((o1, o2), canvases):
        want = tmp_path / f"jax_{path.name}"
        jviz.save_image(str(want), canvas)
        assert path.read_bytes() == want.read_bytes(), path.name
        np.testing.assert_array_equal(read_image(path), canvas)


def test_j2k_encode_hashes_are_pils():
    """Phase 14v's hashes: PIL's .j2k and .jp2 of each canvas, which the
    port's writer gives too."""
    views = [np.asarray(Image.open(chip_smoke.PAIRS / f"{n}.png"))
             for n in ("zoom2x_1", "zoom2x_2", "tilt4_1")]
    for name, canvas in chip_smoke.gif_encode_canvases(views).items():
        for ext, want in zip(EXTS, chip_smoke.J2K_ENCODE_SHA256[name]):
            data = _pil_save(canvas, f"x{ext}")
            assert hashlib.sha256(data).hexdigest() == want, (name, ext)
            assert _j2k_bytes(canvas, _mode(canvas), ext == ".jp2") == data
