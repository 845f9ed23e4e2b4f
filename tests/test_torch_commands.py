"""Port vs JAX reference: the ``extract``, ``match`` (with drawn outputs)
and ``match_multi`` commands (CPU, small PNGs).

* ``extract`` in the ``mods``, ``michal`` and ``michal-text`` formats
  against ``mods_tpu.cli.cmd_extract``: the same stores with the same
  rows; regions paired by position within 5e-3 px (detection runs in
  both packages, and its float32 rounding moves keypoints by up to
  3e-3 px), frames within 2e-3, RootSIFT rows as the exporters' test
  holds them.
* ``match`` with both drawn outputs: each PNG equals, pixel for pixel,
  the JAX package's ``viz`` drawing of the matches and the H or F that
  the port's command wrote, over the image as loaded (RGB here).
* ``match_multi`` against ``mods_tpu.cli.cmd_match_multi`` on one
  device, as the port runs: batched, each gallery image's verified
  matches and tentatives within 20 % (RANSAC draws other random numbers
  in the two packages), the per-gallery logs and drawings, a rerun on the
  manifest; the manifest resume of ``tests/test_aux.py:100-137`` (one run
  of each package serves both tests); the serial path that ReadAffs
  takes, which records each image's failure as the JAX command does.

``JAX_PLATFORMS=cpu python tests/test_torch_commands.py --jax-match-multi``
prints the JAX command's figures on the full-size ``.parity_work`` images
that ``chip_smoke.py`` phase 12e holds the card to
(``JAX_MATCH_MULTI_REFERENCE``).
"""

import contextlib
import io
import json
import os
import re
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image  # noqa: E402

import chip_smoke  # noqa: E402
from mods_tpu import cli as jcli  # noqa: E402
from mods_tpu import viz as jviz  # noqa: E402
from mods_tpu_torch import cli as tcli  # noqa: E402
from mods_tpu_torch.io import regions_io as trio  # noqa: E402
from mods_tpu_torch.io.png import png_size  # noqa: E402
from test_pipeline import textured_image, warp_np  # noqa: E402

torch.set_num_threads(2)

SHIFT = np.array([[1.0, 0.0, 9.0], [0.0, 1.0, -5.0], [0, 0, 1.0]])
TILT = np.array([[1.0, 0.08, 4.0], [-0.05, 0.92, 6.0], [1e-4, 0, 1.0]])


def _save(path, img):
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A 144x176 textured pair (image 1 in RGB), two more gallery images,
    and INI files: one HessianAffine rung of RootSIFT and SIFT."""
    d = tmp_path_factory.mktemp("commands")
    base = textured_image(144, 176, seed=8)
    rgb = np.stack([base, np.roll(base, 3, 1) * 0.9, base * 0.7 + 20], -1)
    _save(d / "a.png", rgb)
    gray = np.asarray(Image.open(d / "a.png"), np.float32).mean(-1)
    _save(d / "b.png", warp_np(gray, SHIFT, 144, 176))
    _save(d / "c.png", warp_np(gray, TILT, 144, 176))
    _save(d / "e.png", textured_image(144, 176, seed=99))
    (d / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
    (d / "iters.ini").write_text(chip_smoke.cviu_iters_ini([([dict(
        chip_smoke._HESAFF, tilt_set=(1.0,), descriptors=("RootSIFT",
                                                          "SIFT"),
        fginn_threshold=(0.8, 0.8), distance_threshold=(0.0, 0.0))],
        None)], min_matches=10))
    return d


def _inis(d):
    return [str(d / "config.ini"), str(d / "iters.ini")]


def _pair_rows(a, b):
    """Rows of ``b`` paired with ``a``'s by the nearest position (the
    first two columns), and their distances."""
    dist = np.sqrt(((a[:, None, :2] - b[None, :, :2]) ** 2).sum(-1))
    j = dist.argmin(1)
    return b[j], dist[np.arange(len(a)), j]


def _hold_rows(a, b):
    """Region rows ``x y a11 a12 a21 a22 s desc...`` of the two packages:
    paired by position within 5e-3 px; the ellipses (s A)(s A)^T within
    2e-3 (the exporters' bound: a frame's rotation is its dominant
    orientation, which the rounding of the histogram peak moves by a few
    milliradians); 95 % of the descriptor rows within 1.0 (RootSIFT and
    SIFT entries run to 255; a keypoint moved by rounding moves its
    patch)."""
    assert len(a) == len(b) > 20
    rows, dist = _pair_rows(a, b)
    assert dist.max() <= 5e-3

    def cov(r):
        B = r[:, 2:6].reshape(-1, 2, 2) * r[:, 6, None, None]
        return B @ B.transpose(0, 2, 1)

    np.testing.assert_allclose(cov(rows), cov(a), rtol=2e-3, atol=2e-3)
    dd = np.abs(rows[:, 7:] - a[:, 7:]).max(1)
    assert (dd <= 1.0).mean() >= 0.95


@pytest.mark.parametrize("fmt", ["mods", "michal", "michal-text"])
def test_extract_against_jax(work, fmt, capsys):
    img = str(work / "a.png")
    out = {}
    for tag, run in (("jax", lambda a: jcli.cmd_extract(a)),
                     ("torch", lambda a: tcli.main(
                         ["extract"] + a + ["--device", "cpu"]))):
        out[tag] = str(work / f"x_{fmt}_{tag}")
        assert run([img, out[tag]] + _inis(work) + [fmt]) == 0
    printed = re.findall(r"Saved (\d+) regions", capsys.readouterr().out)
    assert len(printed) == 2 and printed[0] == printed[1]
    if fmt == "mods":
        sets = [trio.load_regions(out[t]) for t in ("jax", "torch")]
        assert sets[0].keys() == sets[1].keys() == {"HessianAffine"}
        assert set(sets[1]["HessianAffine"]) == {"RootSIFT", "SIFT"}
        for name, rj in sets[0]["HessianAffine"].items():
            rt = sets[1]["HessianAffine"][name]
            _hold_rows(*(np.c_[r.det_xy, r.det_A.reshape(-1, 4), r.det_s,
                               r.desc] for r in (rj, rt)))
            np.testing.assert_array_equal(rt.det_xy, rt.reproj_xy)
        return
    for name in ("RootSIFT", "SIFT"):
        paths = [f"{out[t]}{name}" for t in ("jax", "torch")]
        if fmt == "michal":
            rows = []
            for p in paths:
                with open(p, "rb") as f:
                    head = np.frombuffer(f.read(20), "<i4")
                assert tuple(head[3:]) == png_size(img) == (176, 144)
                xy, s, A, st, r, desc = trio.load_regions_michal(p)
                rows.append(np.c_[xy, A.reshape(-1, 4), s, desc])
        else:
            # x y s' a11 a12 a21 a22 sub_type response desc...
            rows = [np.loadtxt(p, ndmin=2) for p in paths]
            rows = [np.c_[r[:, :2], r[:, 3:7], r[:, 2], r[:, 9:]]
                    for r in rows]
        _hold_rows(*rows)


@pytest.mark.parametrize("ver", ["LORANSACH", "LORANSACF"])
def test_match_drawn_outputs_against_jax_viz(work, ver, capsys):
    d = work
    o1, o2 = d / f"o1_{ver}.png", d / f"o2_{ver}.png"
    m = d / f"m_{ver}.txt"
    assert tcli.main(["match", str(d / "a.png"), str(d / "b.png"), str(o1),
                      str(o2), "k1", "k2", str(m), "0", ver] + _inis(d)
                     + ["--device", "cpu"]) == 0
    n = int(re.search(r"Matches: (\d+)", capsys.readouterr().out).group(1))
    assert n >= 10 and int(m.read_text().split()[0]) == n
    xy1, xy2 = trio.read_matches(str(m))
    model = trio.read_h(f"{m}.H")
    img1 = np.asarray(Image.open(d / "a.png"))
    img2 = np.asarray(Image.open(d / "b.png"))
    assert img1.shape == (144, 176, 3) and img2.shape == (144, 176)
    ref1 = jviz.draw_matches(img1, img2, xy1, xy2)
    ref2 = (jviz.draw_epipolar(img1, img2, xy1, xy2, model)
            if ver == "LORANSACF" else
            jviz.draw_matches_with_error(img1, img2, xy1, xy2, model))
    for path, ref in ((o1, ref1), (o2, ref2)):
        got = np.asarray(Image.open(path))
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    # colour reaches the canvas: the drawing is made on the RGB image
    assert not np.array_equal(ref1[..., 0], ref1[..., 2])


def _gallery(d, names):
    lst = d / ("list_" + "".join(names) + ".txt")
    lst.write_text("".join(f"{d / n}.png\n" for n in names))
    return str(lst)


_LINE = re.compile(r"^(\S+): (\d+) matches \((\d+) tentatives\)$", re.M)


def _multi(run, d, tag, argv, capsys):
    assert run(argv) == 0
    out = capsys.readouterr().out
    return {os.path.basename(p): (int(n), int(t))
            for p, n, t in _LINE.findall(out)}, out


@pytest.fixture(scope="module")
def multi_runs(work):
    """Each package's ``match_multi`` of a.png against the gallery [b, e,
    c] on one HessianAffine rung, with logs, drawings and a manifest in
    which c is pre-marked done with a sentinel count (777, 999, 1).  The
    JAX command runs on one device, as the port does (it builds a mesh
    when it sees several, and the test harness gives it eight CPU
    devices).  -> {tag: (printed counts, output, manifest path)}."""
    import jax
    from mods_tpu_torch.parallel.manifest import RunManifest
    d = work
    lst = _gallery(d, ["b", "e", "c"])
    q = str(d / "a.png")
    (d / "iters_multi.ini").write_text(chip_smoke.cviu_iters_ini([([dict(
        chip_smoke._HESAFF, tilt_set=(1.0,), fginn_threshold=(0.8,),
        distance_threshold=(0.0,))], None)], min_matches=10))
    runs = {}
    for tag, run in (("jax", jcli.cmd_match_multi),
                     ("torch", lambda a: tcli.main(["match_multi"] + a
                                                   + ["--device", "cpu"]))):
        mpath = str(d / f"man_{tag}.json")
        m = RunManifest.load(mpath, query=q)
        m.record(str(d / "c.png"), 777, 999, 1)
        m.save()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax, "device_count", lambda: 1)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert run([q, lst, str(d / "config.ini"),
                            str(d / "iters_multi.ini"), str(d / f"log_{tag}"),
                            str(d / f"draw_{tag}_"), mpath]) == 0
        out = buf.getvalue()
        runs[tag] = ({os.path.basename(p): (int(n), int(t))
                      for p, n, t in _LINE.findall(out)}, out, mpath)
    return runs


def test_match_multi_against_jax(work, multi_runs, capsys):
    """The batched path: one HessianAffine rung, the gallery images to run
    are the shift and an unrelated image; per-gallery logs and drawings;
    a rerun with the manifest runs nothing and prints the manifest's
    counts."""
    d = work
    res = {tag: r for tag, (r, _, _) in multi_runs.items()}
    for tag, (_, out, _) in multi_runs.items():
        # c.png's sentinel 777 counts as matched
        assert "2/3 gallery images matched" in out
    for name in ("b.png", "e.png"):
        (jn, jt), (tn, tt) = res["jax"][name], res["torch"][name]
        assert abs(tn - jn) <= 0.2 * jn and abs(tt - jt) <= 0.2 * jt
    assert res["torch"]["b.png"][0] >= 10 and res["torch"]["e.png"][0] < 10
    for name in ("b", "e", "c"):
        log = (d / f"log_torch-{name}.log").read_text().splitlines()
        assert log[0].startswith("Tentatives") and len(log) == 2
    for name in ("b", "e"):
        canvas = np.asarray(Image.open(d / f"draw_torch_{name}-1.png"))
        assert canvas.shape == (288, 176, 3)     # a landscape query
    # c.png was not run: no drawing (the points of a resume are not kept)
    assert not (d / "draw_torch_c-1.png").exists()
    # the manifest holds every image: a rerun resumes, runs nothing and
    # prints the recorded counts (no drawings)
    again, out = _multi(lambda a: tcli.main(["match_multi"] + a
                                            + ["--device", "cpu"]),
                        d, "torch", [str(d / "a.png"),
                                     _gallery(d, ["b", "e", "c"]),
                                     str(d / "config.ini"),
                                     str(d / "iters_multi.ini"), "0",
                                     str(d / "draw2_"),
                                     multi_runs["torch"][2]], capsys)
    assert "3/3 gallery images already done, resuming" in out
    assert again == res["torch"]
    assert not list(d.glob("draw2_*"))


def test_match_multi_resume_as_jax(work, multi_runs):
    """``tests/test_aux.py::test_match_multi_cli_resume`` through the
    port, on the shared run: the image pre-marked done keeps its sentinel
    count, the others are computed; the same in both packages."""
    from mods_tpu_torch.parallel.manifest import RunManifest
    q = str(work / "a.png")
    got = {}
    for tag, (_, out, mpath) in multi_runs.items():
        assert "manifest: 1/3 gallery images already done, resuming" in out
        m2 = RunManifest.load(mpath, query=q)
        assert m2.result(str(work / "c.png"))["n_matches"] == 777
        got[tag] = [m2.result(str(work / f"{n}.png")) for n in ("b", "e")]
        assert all(r is not None and r["n_matches"] != 777
                   for r in got[tag])
    for t, j in zip(got["torch"], got["jax"]):
        assert t["steps"] == j["steps"] == 1
        assert abs(t["n_matches"] - j["n_matches"]) \
            <= max(2, 0.2 * j["n_matches"])


def test_match_multi_serial_path_records_failures_as_jax(work, capsys):
    """A ladder with ReadAffs takes the serial loop; the command names no
    keypoint files, so each image fails and, with a manifest, is recorded
    as failed while the run goes on: the same records in both
    packages."""
    d = work
    iters = d / "iters_readaffs.ini"
    iters.write_text(chip_smoke.cviu_iters_ini([([dict(
        detector="ReadAffs", descriptors=("RootSIFT",),
        fginn_threshold=(0.8,), distance_threshold=(0.0,))], None)]))
    lst = _gallery(d, ["b", "e"])
    done = {}
    for tag, run in (("jax", jcli.cmd_match_multi),
                     ("torch", lambda a: tcli.main(["match_multi"] + a
                                                   + ["--device", "cpu"]))):
        mpath = d / f"man_readaffs_{tag}.json"
        res, out = _multi(run, d, tag, [str(d / "a.png"), lst,
                                        str(d / "config.ini"), str(iters),
                                        "0", "0", str(mpath)], capsys)
        assert "0/2 gallery images matched" in out
        assert res == {"b.png": (0, 0), "e.png": (0, 0)}
        done[tag] = {os.path.basename(p): v for p, v in
                     json.loads(mpath.read_text())["done"].items()}
    assert done["torch"] == done["jax"]
    assert "affs_paths" in done["torch"]["b.png"]["error"]


# ---------------------------------------------------------------------------
# the full-size reference run (script mode)

def _jax_match_multi_main():
    """The JAX package's ``cmd_match_multi`` with ``chip_smoke.py``'s 12e
    files on the full-size pairs, its MultiMatcher's result read in the
    process: the figures of ``JAX_MATCH_MULTI_REFERENCE``."""
    import tempfile
    from pathlib import Path
    from mods_tpu.parallel import multi as jm
    data = [chip_smoke._load_pair_np(p) for p in chip_smoke.BATCH_PAIRS]
    with tempfile.TemporaryDirectory() as td:
        argv = chip_smoke.match_multi_files(Path(td))
        seen, release = chip_smoke.keep_multi_results(jm.MultiMatcher)
        t0 = time.time()
        try:
            assert jcli.cmd_match_multi(argv) == 0
        finally:
            release()
    ((_, r),) = seen
    figures = chip_smoke.multi_figures(r, data)
    print(json.dumps(dict(figures, seconds=round(time.time() - t0, 1))),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--jax-match-multi"]:
        _jax_match_multi_main()
