"""Port vs JAX reference: the host-stage plugins (CPU, small images).

* ``ReadAffs``: keypoints read from a file (Oxford ellipses, or ``kp``
  rows when the Oxford reader fails) into the identity view, as
  ``tests/test_oxford_io.py:70-106`` drives it; both packages read the
  same file.
* ``External``: a command run on each rendered view writes its
  keypoints, and a second command the descriptor rows of the External
  descriptor kind (``tests/test_aux.py:139-235``); both packages run the
  same commands (``chip_smoke.py``'s scripts, which read PNGs without
  PIL).

Region sets must be equal after sorting by (response, x, y), to 1e-4
(the same rows go through the same frame arithmetic; the views the
External command sees are the host render's, the same in both
packages); descriptors within 1e-4, but for the quantized SIFT entries
that flip by one at a rounding edge (at most 0.1 % of them; on a tilted
view, which each package renders itself, 95 % of the rows within one
quantum), and the External rows bit for bit.  A
pair batch of External pairs is held to its pairs' serial runs (the
JAX package's batch has no External descriptor slab), and a batch with
ReadAffs is refused with the JAX package's words.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from mods_tpu import config as jc  # noqa: E402
from mods_tpu import pipeline as jp  # noqa: E402
from mods_tpu.parallel import multi as jm  # noqa: E402
from mods_tpu.timing import TimeLog as JaxTimeLog  # noqa: E402
from mods_tpu_torch import config as tc  # noqa: E402
from mods_tpu_torch import pipeline as tp  # noqa: E402
from mods_tpu_torch.io import oxford as TO  # noqa: E402
from mods_tpu_torch.parallel import multi as tm  # noqa: E402
from mods_tpu_torch.timing import TimeLog  # noqa: E402
from test_pipeline import textured_image, warp_np  # noqa: E402

torch.set_num_threads(2)

SHIFT = np.array([[1.0, 0.0, 12.0], [0.0, 1.0, -12.0], [0, 0, 1.0]])


def _cfgs(commands=None, **ext):
    """(JAX, port) EngineConfigs at test_aux.py's sizes, with an External
    section when ``commands`` (detector, descriptor) are given."""
    out = []
    desc = ext.pop("desc", True)
    for P, C in ((jp, jc), (tp, tc)):
        kw = {}
        if commands:
            kw["external"] = P.ExternalCmdParams(
                command=commands[0],
                desc_command=commands[1] if desc else "", **ext)
        out.append(P.EngineConfig(
            caps=C.CapacityParams(per_octave=512, per_view=256,
                                  per_image=512, max_angles=2,
                                  tentatives=1024),
            ransac=C.RansacParams(err_threshold=3.0, batch_hypotheses=256,
                                  max_rounds=2), **kw))
    return out


@pytest.fixture(scope="module")
def pair():
    img1 = textured_image(156, 192, seed=17).astype(np.float32)
    return img1, warp_np(img1, SHIFT, 156, 192).astype(np.float32)


@pytest.fixture(scope="module")
def commands(tmp_path_factory):
    return chip_smoke.plugin_commands(tmp_path_factory.mktemp("plugins"))


def _stores(P, cfg, it, img, affs=None, img_idx=0):
    """One image's stores after ``_process_image`` of one iteration, as
    {descriptor: (rows sorted by (response, x, y), desc rows)}."""
    if P is jp:
        m = jp.TwoViewMatcher([it], cfg)
        log = JaxTimeLog()
    else:
        m = tp.TwoViewMatcher([it], cfg, device="cpu")
        log = TimeLog()
    if affs:
        m.affs_paths = affs
    stores: dict = {}
    if P is jp:
        m._process_image(img, it, [], stores, log, img_idx)
    else:
        m._process_image(torch.as_tensor(img), it, [], stores, log, img_idx,
                         img)
        m.close()
    out = {}
    for (_, name), st in stores.items():
        geo = np.c_[st.response, st.xy, st.A.reshape(-1, 4), st.s]
        order = np.lexsort((geo[:, 2], geo[:, 1], geo[:, 0]))
        out[name] = (geo[order], np.asarray(st.desc)[order])
    return out


def _hold(got: dict, ref: dict, exact=(), rendered=False):
    assert got.keys() == ref.keys()
    for name in ref:
        (g, gd), (r, rd) = got[name], ref[name]
        assert len(g) == len(r) > 10, name
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-4)
        if name in exact:
            np.testing.assert_array_equal(gd, rd)
        elif rendered:
            # a tilted view is each package's own render (shears and blur
            # in float32), which moves the patches by its rounding: the
            # exporters' bound, 95 % of the rows within one quantum
            dd = np.abs(gd - rd).max(1)
            assert (dd <= 1.0).mean() >= 0.95, (name, (dd <= 1.0).mean())
        else:
            # quantized SIFT entries, floor(512 v + 0.5), flip by one
            # where v sits on a rounding edge (tests/test_torch_describe.py)
            dd = np.abs(gd - rd)
            assert dd.max() <= 1.0 and (dd > 1e-4).mean() <= 1e-3, (
                name, dd.max(), (dd > 1e-4).mean())


def _keypoints(img):
    """HessianAffine regions of ``img`` from the port's own detection:
    the content of a ReadAffs file."""
    st = _stores(tp, _cfgs()[1], tc.IterationParams(), img)["RootSIFT"][0]
    return st[:, 1:3], st[:, 3:7].reshape(-1, 2, 2), st[:, 7]


@pytest.mark.parametrize("fmt", ["oxford", "kps"])
def test_readaffs_against_jax(pair, tmp_path, fmt):
    img1, _ = pair
    xy, A, s = _keypoints(img1)
    path = str(tmp_path / f"img.{fmt}")
    if fmt == "oxford":
        TO.write_oxford(path, xy, A, s)
    else:
        TO.write_kps(path, xy, A, s)
    kw = dict(detector="ReadAffs", descriptors=("RootSIFT", "HalfSIFT"),
              fginn_threshold=(0.8, 0.8))
    jcfg, tcfg = _cfgs()
    got = _stores(tp, tcfg, tc.IterationParams(**kw), img1,
                  (None, path), img_idx=1)
    ref = _stores(jp, jcfg, jc.IterationParams(**kw), img1,
                  (None, path), img_idx=1)
    _hold(got, ref)
    # every region of the file is there, bar the border filter's
    assert len(got["RootSIFT"][0]) <= len(xy)
    assert (got["RootSIFT"][0][:, 0] == 1.0).all()


def test_readaffs_matches_as_jax(pair, tmp_path):
    """A ReadAffs ladder on the files of a HessianAffine run on each
    image: the same rung and verified matches within 20 % (RANSAC draws
    other numbers in the two packages)."""
    paths = []
    for i, img in enumerate(pair):
        xy, A, s = _keypoints(img)
        paths.append(str(tmp_path / f"{i}.affs"))
        TO.write_oxford(paths[-1], xy, A, s)
    res = []
    for P, C, cfg in ((jp, jc, _cfgs()[0]), (tp, tc, _cfgs()[1])):
        ladder = [C.IterationParams(detector="ReadAffs",
                                    descriptors=("RootSIFT",))]
        m = (P.TwoViewMatcher(ladder, cfg) if P is jp else
             P.TwoViewMatcher(ladder, cfg, device="cpu"))
        m.affs_paths = tuple(paths)
        res.append(m.match(*pair))
    ref, got = res
    assert got.steps_used == ref.steps_used == 1
    assert got.n_matches >= 10
    assert abs(got.n_matches - ref.n_matches) <= 0.2 * ref.n_matches


@pytest.mark.parametrize("what", ["no file", "no command", "no rows"])
def test_plugins_refuse_what_they_miss(pair, commands, what):
    img1, img2 = pair
    if what == "no file":
        m = tp.TwoViewMatcher([tc.IterationParams(detector="ReadAffs")],
                              _cfgs()[1], device="cpu")
        err, match = ValueError, "affs_paths"
    elif what == "no command":
        m = tp.TwoViewMatcher([tc.IterationParams(detector="External")],
                              _cfgs()[1], device="cpu")
        err, match = ValueError, r"\[ExternalDetector\] command"
    else:
        m = tp.TwoViewMatcher([tc.IterationParams(
            detector="External", descriptors=("External",))],
            _cfgs(commands, desc=False, desc_dim=8)[1], device="cpu")
        err, match = ValueError, "descCommand"
    with pytest.raises(err, match=match):
        m.match(img1, img2)
    m.close()


@pytest.mark.parametrize("fmt,tilts", [("oxford", (1.0,)),
                                       ("kp", (1.0, 2.0))])
def test_external_detector_against_jax(pair, tmp_path, fmt, tilts):
    """The grid detector on each rendered view (two views of a tilt-2
    group with ``tilts`` (1, 2)), described with RootSIFT; ``kp`` reads
    the same file through the kp reader (its x y s columns)."""
    img1, _ = pair
    det = chip_smoke.plugin_commands(tmp_path)[0].split()[1]
    if fmt == "kp":
        # count, then x y s a11 a12 a21 a22: the grid's points, 3 px
        kp = tmp_path / "grid_kp.py"
        kp.write_text(
            "import runpy, sys\n"
            "out = sys.argv[2]\nsys.argv[2] = out + '.ox'\n"
            f"runpy.run_path({det!r}, run_name='__main__')\n"
            "rows = [l.split() for l in open(out + '.ox').read()"
            ".splitlines()[2:]]\n"
            "open(out, 'w').write('%d\\n' % len(rows) + ''.join("
            "'%s %s 3.0 1 0 0 1\\n' % (r[0], r[1]) for r in rows))\n")
        det = str(kp)
    cmds = (f"{sys.executable} {det} {{img}} {{out}}", "")
    kw = dict(detector="External", descriptors=("RootSIFT",),
              tilt_set=tilts, phi_base=180.0)
    jcfg, tcfg = _cfgs(cmds, desc=False, format=fmt)
    got = _stores(tp, tcfg, tc.IterationParams(**kw), img1)
    ref = _stores(jp, jcfg, jc.IterationParams(**kw), img1)
    _hold(got, ref, rendered=len(tilts) > 1)


def test_external_descriptor_rows_bit_for_bit(pair, commands):
    """The descriptor command's float32 rows reach the store unchanged,
    beside RootSIFT on the same regions."""
    img1, _ = pair
    kw = dict(detector="External", descriptors=("RootSIFT", "External"),
              fginn_threshold=(0.9, 0.9))
    jcfg, tcfg = _cfgs(commands, desc_dim=8)
    got = _stores(tp, tcfg, tc.IterationParams(**kw), img1)
    ref = _stores(jp, jcfg, jc.IterationParams(**kw), img1)
    _hold(got, ref, exact=("External",))
    assert got["External"][1].shape[1] == 8
    assert tp.spec_for("External", tcfg).dim == 8


@pytest.mark.parametrize("descs", [("RootSIFT",), ("External",)])
def test_external_match_against_jax(pair, commands, descs):
    """tests/test_aux.py's two External cases: the grid step is the
    translation, so true correspondences exist exactly."""
    res = []
    for P, C, cfg in ((jp, jc, _cfgs(commands, desc_dim=8)[0]),
                      (tp, tc, _cfgs(commands, desc_dim=8)[1])):
        ladder = [C.IterationParams(detector="External", descriptors=descs,
                                    fginn_threshold=(0.9,))]
        m = (P.TwoViewMatcher(ladder, cfg) if P is jp else
             P.TwoViewMatcher(ladder, cfg, device="cpu"))
        res.append(m.match(*pair))
    ref, got = res
    assert got.n_matches >= 8, (got.n_matches, got.n_tentatives)
    assert got.steps_used == ref.steps_used
    assert abs(got.n_matches - ref.n_matches) <= 0.2 * ref.n_matches
    assert abs(got.n_tentatives - ref.n_tentatives) <= 0.2 * ref.n_tentatives


def test_external_pair_batch_against_serial(pair, commands):
    """Two External pairs (the shift, and the shift of a second image) as
    one ``PairBatchMatcher`` batch, with the External descriptor's slab
    on a pair axis: each pair at its serial rung with >= 0.8x its serial
    verified matches."""
    img3 = textured_image(156, 192, seed=23).astype(np.float32)
    pairs = [pair, (img3, warp_np(img3, SHIFT, 156, 192).astype(np.float32))]
    cfg = _cfgs(commands, desc_dim=8)[1]
    ladder = [tc.IterationParams(detector="External",
                                 descriptors=("RootSIFT", "External"),
                                 fginn_threshold=(0.9, 0.9))]
    bm = tm.PairBatchMatcher(ladder, cfg, device="cpu")
    r = bm.match_batch(pairs)
    bm.close()
    for i, (a, b) in enumerate(pairs):
        s = tp.TwoViewMatcher(ladder, cfg, device="cpu").match(a, b)
        assert r.steps_used[i] == s.steps_used
        assert s.n_matches >= 8
        assert r.counts[i] >= 0.8 * s.n_matches, (i, r.counts, s.n_matches)


def test_readaffs_pair_batch_is_refused_as_in_jax(pair):
    """The batched matchers have no per-gallery keypoint files: both
    packages refuse ReadAffs with the same words."""
    msg = {}
    for P, M, C in ((jp, jm, jc), (tp, tm, tc)):
        ladder = [C.IterationParams(detector="ReadAffs")]
        bm = (M.PairBatchMatcher(ladder, P.EngineConfig()) if P is jp else
              M.PairBatchMatcher(ladder, P.EngineConfig(), device="cpu"))
        with pytest.raises(NotImplementedError) as e:
            bm.match_batch([pair])
        msg[P] = str(e.value)
    assert msg[tp] == msg[jp] == ("ReadAffs has no per-gallery keypoint "
                                  "files; use the serial path")
