"""Port vs JAX reference: the region files, the drawings and the PNG
writer (CPU, host numpy).

* ``io/regions_io.py``: the MODS hierarchical file and the Michal files,
  binary and text, written by each package and read by the other; the
  files are equal byte for byte and read back exactly (the text formats
  to their ``%.10g``).
* ``viz.py``: every drawing equal pixel for pixel to the JAX package's,
  on ``tests/test_aux.py``'s inputs and on random ones.
* ``io/png.py``: ``write_png`` decoded by PIL is the canvas; ``read_png``
  is PIL's ``np.asarray(Image.open(path))`` for gray, RGB and RGBA files
  that PIL wrote (with its own choice of row filters).
"""

import numpy as np
import pytest
from PIL import Image

from mods_tpu import viz as jviz
from mods_tpu.io import regions_io as jrio
from mods_tpu_torch import viz as tviz
from mods_tpu_torch.io import regions_io as trio
from mods_tpu_torch.io.png import png_size, read_png, read_png_gray, write_png


def _region_set(mod, n: int, dim: int, seed: int):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, 2, 2))
    A[:, 0, 0] += 2.0
    A[:, 1, 1] += 2.0
    return mod.RegionSet(
        det_xy=rng.uniform(0, 500, (n, 2)), det_A=A,
        det_s=rng.uniform(1, 20, n), reproj_xy=rng.uniform(0, 500, (n, 2)),
        reproj_A=A[::-1].copy(), reproj_s=rng.uniform(1, 20, n),
        sub_type=rng.integers(0, 3, n), desc=rng.uniform(0, 300, (n, dim)))


def _store(mod):
    return {"HessianAffine": {"RootSIFT": _region_set(mod, 7, 128, 0),
                              "ORB": _region_set(mod, 0, 256, 1)},
            "MSER": {"RootSIFT": _region_set(mod, 5, 128, 2)}}


def _same_sets(a, b, exact=True):
    assert a.keys() == b.keys()
    for det in a:
        assert a[det].keys() == b[det].keys()
        for name in a[det]:
            if b[det][name].n == 0:       # written with dim 0
                assert a[det][name].n == 0
                continue
            for f in ("det_xy", "det_A", "det_s", "reproj_xy", "reproj_A",
                      "reproj_s", "sub_type", "desc"):
                x, y = getattr(a[det][name], f), getattr(b[det][name], f)
                assert x.shape == y.shape, (det, name, f)
                if exact:
                    np.testing.assert_array_equal(x, y)
                else:
                    # %.10g: ten significant digits
                    np.testing.assert_allclose(x, y, rtol=1e-9, atol=0)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_mods_regions_file_round_trips_across_packages(tmp_path, writer):
    """The hierarchical file: byte for byte the JAX writer's, and each
    package reads the other's to the text's ten digits."""
    w, r = (jrio, trio) if writer == "jax" else (trio, jrio)
    store = _store(w)
    w.save_regions(str(tmp_path / "w.keys"), store)
    (jrio if writer == "torch" else trio).save_regions(
        str(tmp_path / "o.keys"), _store(r))
    assert (tmp_path / "w.keys").read_bytes() == \
        (tmp_path / "o.keys").read_bytes()
    back = r.load_regions(str(tmp_path / "w.keys"))
    _same_sets(back, store, exact=False)
    _same_sets(back, w.load_regions(str(tmp_path / "w.keys")))


@pytest.mark.parametrize("binary", [True, False], ids=["michal",
                                                       "michal-text"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_michal_files_across_packages(tmp_path, writer, binary):
    """One file a descriptor, pooled over detectors: the same bytes from
    both writers; the binary one read by both readers alike, and its
    frames the writer's up-is-up rectification of the reprojected A."""
    flat = {(det, name): rs for det, d in _store(trio).items()
            for name, rs in d.items()}
    flat[("HessianAffine", "None")] = _region_set(trio, 3, 4, 5)
    resp = np.linspace(0.5, 3.5, 7)
    files = {}
    for tag, mod in (("jax", jrio), ("torch", trio)):
        written = mod.save_regions_michal(str(tmp_path / f"{tag}_"), flat,
                                          640, 480, binary=binary,
                                          response=resp)
        files[tag] = [open(p, "rb").read() for p in written]
        assert [p.rsplit("_", 1)[1] for p in written] == ["RootSIFT"]
    assert files["jax"] == files["torch"]
    if not binary:
        rows = np.loadtxt(str(tmp_path / f"{writer}_RootSIFT"), ndmin=2)
        assert rows.shape == (12, 9 + 128)
        return
    path = str(tmp_path / f"{writer}_RootSIFT")
    got = trio.load_regions_michal(path)
    ref = jrio.load_regions_michal(path)
    for a, b in zip(got, ref, strict=True):
        np.testing.assert_array_equal(a, b)
    xy, s, A, st, r, desc = got
    rs = flat[("HessianAffine", "RootSIFT")]
    np.testing.assert_allclose(xy[:7], rs.reproj_xy, rtol=1e-6)
    np.testing.assert_allclose(A[:7], trio._rectify_up_is_up(rs.reproj_A),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(desc[:7],
                                  np.clip(rs.desc, 0, 255).astype(np.uint8))
    np.testing.assert_allclose(r[:7], resp.astype(np.float32))


def test_michal_reader_rejects_another_file(tmp_path):
    p = tmp_path / "bad"
    p.write_bytes(b"\0" * 40)
    with pytest.raises(ValueError, match="bad magic"):
        trio.load_regions_michal(str(p))


# ---------------------------------------------------------------------------
# drawings: tests/test_aux.py's inputs and random ones

def _aux_match_inputs():
    img1 = np.random.default_rng(0).uniform(0, 255, (120, 80)).astype(
        np.float32)
    img2 = np.random.default_rng(1).uniform(0, 255, (100, 90, 3)).astype(
        np.uint8)
    xy1 = np.array([[10, 10], [50, 60]], np.float32)
    xy2 = np.array([[20, 15], [40, 70]], np.float32)
    return img1, img2, xy1, xy2, np.array([True, False])


def _random_match_inputs(seed: int, n: int = 60):
    rng = np.random.default_rng(seed)
    img1 = rng.integers(0, 256, (90, 130, 4)).astype(np.uint8)
    img2 = rng.uniform(-20, 300, (110, 70)).astype(np.float32)
    # points inside, on and past the canvases' edges
    xy1 = rng.uniform(-15, 140, (n, 2)).astype(np.float32)
    xy2 = rng.uniform(-15, 120, (n, 2)).astype(np.float32)
    return img1, img2, xy1, xy2, rng.random(n) > 0.4


MATCH_INPUTS = {"aux": _aux_match_inputs(), "random": _random_match_inputs(3)}
H_TEST = np.array([[1.05, 0.04, 3.5], [-0.03, 0.95, -2.25],
                   [2e-4, -1e-4, 1.0]])


def _equal(a, b):
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("horizontal", [None, True, False])
@pytest.mark.parametrize("case", sorted(MATCH_INPUTS))
def test_draw_matches_pixel_equal(case, horizontal):
    img1, img2, xy1, xy2, mask = MATCH_INPUTS[case]
    for m in (mask, None):
        _equal(tviz.draw_matches(img1, img2, xy1, xy2, m, horizontal),
               jviz.draw_matches(img1, img2, xy1, xy2, m, horizontal))


@pytest.mark.parametrize("case", sorted(MATCH_INPUTS))
def test_draw_matches_with_error_pixel_equal(case):
    img1, img2, xy1, xy2, _ = MATCH_INPUTS[case]
    # image 2 points near the H's transfer: some below, some above 3 px
    xy2 = (np.c_[xy1, np.ones(len(xy1))] @ H_TEST.T)
    xy2 = (xy2[:, :2] / xy2[:, 2:]).astype(np.float32)
    xy2[::3] += np.float32(4.0)
    for th in (3.0, 1.5):
        _equal(tviz.draw_matches_with_error(img1, img2, xy1, xy2, H_TEST,
                                            th),
               jviz.draw_matches_with_error(img1, img2, xy1, xy2, H_TEST,
                                            th))


@pytest.mark.parametrize("case", ["aux", "random"])
def test_draw_regions_and_epipolar_pixel_equal(case):
    if case == "aux":
        img = np.zeros((64, 64), np.float32)
        xy = np.array([[32.0, 32.0]], np.float32)
        A = np.array([[[2.0, 0.5], [0.0, 1.0]]], np.float32)
        s = np.array([3.0], np.float32)
        mask = None
        F = np.array([[0, 0, 0], [0, 0, -1], [0, 1, 0]], np.float64)
        img2 = img
    else:
        rng = np.random.default_rng(7)
        img = rng.integers(0, 256, (96, 120, 3)).astype(np.uint8)
        img2 = rng.uniform(0, 255, (80, 100)).astype(np.float32)
        n = 70
        xy = rng.uniform(-10, 130, (n, 2)).astype(np.float32)
        A = rng.normal(size=(n, 2, 2)).astype(np.float32)
        s = rng.uniform(0.5, 12, n).astype(np.float32)
        mask = rng.random(n) > 0.3
        F = rng.normal(size=(3, 3)) * np.array([[1e-5, 1e-5, 1e-3]] * 2
                                               + [[1e-3, 1e-3, 1.0]])
    _equal(tviz.draw_regions(img, xy, A, s, mask),
           jviz.draw_regions(img, xy, A, s, mask))
    _equal(tviz.draw_regions(img, xy, A, s, mask, color=tviz.RED),
           jviz.draw_regions(img, xy, A, s, mask, color=jviz.RED))
    for max_lines in (50, 5):
        _equal(tviz.draw_epipolar(img, img2, xy, xy[::-1].copy(), F,
                                  max_lines),
               jviz.draw_epipolar(img, img2, xy, xy[::-1].copy(), F,
                                  max_lines))


@pytest.mark.parametrize("horizontal", [True, False])
def test_side_by_side_and_primitives_equal(horizontal):
    img1, img2, *_ = _random_match_inputs(11)
    (ct, ot), (cj, oj) = (tviz.side_by_side(img1, img2, horizontal),
                          jviz.side_by_side(img1, img2, horizontal))
    _equal(ct, cj)
    np.testing.assert_array_equal(ot, oj)
    rng = np.random.default_rng(12)
    for _ in range(30):
        p, q = rng.uniform(-20, 220, 2), rng.uniform(-20, 220, 2)
        r = float(rng.uniform(0.2, 40))
        A = rng.normal(size=(2, 2))
        a, b = np.zeros((120, 200, 3), np.uint8), np.zeros((120, 200, 3),
                                                           np.uint8)
        for mod, c in ((tviz, a), (jviz, b)):
            mod._draw_line(c, p, q, mod.YELLOW)
            mod._draw_circle(c, p, r, mod.GREEN)
            mod._draw_ellipse(c, q, A, r, mod.BLUE)
        _equal(a, b)


# ---------------------------------------------------------------------------
# the PNG writer and reader

SHAPES = {"gray": (37, 53), "rgb": (37, 53, 3), "rgba": (37, 53, 4)}


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_write_png_decodes_in_pil_to_the_canvas(tmp_path, kind):
    a = np.random.default_rng(5).integers(0, 256, SHAPES[kind]).astype(
        np.uint8)
    p = tmp_path / "c.png"
    write_png(p, a)
    with Image.open(p) as im:
        assert im.mode == {"gray": "L", "rgb": "RGB", "rgba": "RGBA"}[kind]
        got = np.asarray(im)
    np.testing.assert_array_equal(got, a)
    assert png_size(p) == (53, 37)
    np.testing.assert_array_equal(read_png(p), a)


def test_save_image_writes_a_drawing(tmp_path):
    img1, img2, xy1, xy2, m = MATCH_INPUTS["aux"]
    canvas = tviz.draw_matches(img1, img2, xy1, xy2, m)
    tviz.save_image(str(tmp_path / "d.png"), canvas)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "d.png")),
                                  canvas)


def test_write_png_rejects_what_it_cannot_write(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "f.png", np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="pixels"):
        write_png(tmp_path / "f.png", np.zeros((4, 4, 2), np.uint8))


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_read_png_equals_pil(tmp_path, kind):
    """PIL writes with its own (adaptive) row filters; a smooth image
    makes it pick Sub, Up, Average and Paeth rows."""
    h, w = SHAPES[kind][:2]
    yy, xx = np.mgrid[0:h, 0:w]
    base = (3 * xx + 2 * yy + 10 * np.sin(xx / 5.0)).astype(np.int64)
    noise = np.random.default_rng(9).integers(0, 3, SHAPES[kind])
    a = ((base[..., None] if len(SHAPES[kind]) == 3 else base) + noise)
    a = (a % 256).astype(np.uint8)
    p = tmp_path / "p.png"
    Image.fromarray(a).save(p, optimize=True)
    ref = np.asarray(Image.open(p))
    got = read_png(p)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    gray = read_png_gray(p)
    if a.ndim == 2:
        np.testing.assert_array_equal(gray, ref)
    else:
        np.testing.assert_array_equal(gray,
                                      ref.astype(np.float32).mean(-1))
