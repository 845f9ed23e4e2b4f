"""Port vs JAX reference: the escalation ladder (CPU, small images).

Per stage: the HessianAffine detector over a view group (V > 1, one slot
bucket-padded), the describe stage (``_make_desc_fn``) on the same views
and regions, the store's append past its capacity.  End to end:
``TwoViewMatcher.match(device="cpu")`` against the JAX matcher on the
textured pairs and ladders of ``tests/test_pipeline.py`` (HessianAffine
and ORB rungs; the MSER rungs are in ``test_torch_mser.py``).

Tolerances.  Descriptors are integers 0..255 after ``floor(512 v + 0.5)``
(BRIEF: bits): a float32 rounding of the histogram can move a component
by one step, so rows agree to atol 1 on at least 99 % of the rows and
their geometry to atol 2e-3.  End to end the detections agree to
rounding, which can flip a region or a match at a threshold, and RANSAC
draws from another random stream: same ``steps_used``, verified matches
within 20 %, H within 1 px at the image corners.

Run as a script, ``python tests/test_torch_ladder.py [--cviu] PAIR``,
this file prints what the JAX matcher finds on a ``.parity_work`` pair at
full size with ``chip_smoke.py::LADDER`` (or, with ``--cviu``, with
``chip_smoke.py::CVIU_LADDER``), minutes a pair on a CPU: the figures in
``chip_smoke.py::JAX_LADDER_REFERENCE`` and ``JAX_CVIU_REFERENCE``.  With
``--seeds N [--banks FILE] PAIR`` it compares each rung's tentatives on
the CVIU-shaped ladder in the JAX matcher, the port on the CPU and FILE
(the card's, from ``python3 chip_smoke.py --seed-spread PAIR N``), and
prints both packages' spread of verification over N RANSAC seeds on each
(``_seed_study``).  With ``--detectors DET[,DET...] PAIR`` it prints the
JAX matcher's figures on ``chip_smoke.py::DETECTOR_LADDERS[DET]``
(``JAX_DETECTOR_REFERENCE``), and with ``--seeds N`` beside it each
seed's outcome (``JAX_DETECTOR_SPREAD``).  With ``--detectors DET
--tentatives [--seeds N] [--banks FILE] PAIR`` it compares each rung's
tentatives as ``--seeds`` does, on DET's ladder (FILE from ``python3
chip_smoke.py --seed-spread PAIR N DET``).  One pair a process: XLA's
CPU compiler ran out of memory maps on the second image shape.
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from scipy import ndimage  # noqa: E402

from mods_tpu import config as jax_config  # noqa: E402
from mods_tpu import pipeline as jp  # noqa: E402
from mods_tpu.config import CapacityParams as JaxCaps  # noqa: E402
from mods_tpu.config import IterationParams as JaxIteration  # noqa: E402
from mods_tpu.config import RansacParams as JaxRansac  # noqa: E402
from mods_tpu.detectors import hessaff as jh  # noqa: E402
from mods_tpu_torch import config as tc  # noqa: E402
from mods_tpu_torch import pipeline as tp  # noqa: E402
from mods_tpu_torch.detectors import hessaff as th  # noqa: E402
from mods_tpu_torch.parallel import multi as tm  # noqa: E402
from mods_tpu_torch.regions import regions_from_numpy  # noqa: E402
from test_pipeline import textured_image, warp_np  # noqa: E402

torch.set_num_threads(2)


def _port(obj, cls=None):
    return tc.from_dict(dataclasses.asdict(obj),
                        cls or getattr(tc, type(obj).__name__, None))


# ---------------------------------------------------------------------------
# stages

def _views(seed=0, V=3, h=128, w=256):
    return np.stack([textured_image(h, w, seed=seed + v) for v in range(V)])


def test_detect_affine_keypoints_over_a_view_group():
    """V = 3 with the last slot bucket-padded (valid_hw == 0) and a region
    budget: Baumberg runs once an octave over all views' keypoints."""
    views = _views(1)
    hw = np.asarray([[128, 256], [120, 200], [0, 0]], np.int32)
    regn = np.asarray([10 ** 9, 25, 10 ** 9], np.int32)
    p = tc.PyramidParams(detector_mode=tc.DetectionMode.FIXED_REG_NUMBER,
                         reg_number=60)
    from mods_tpu.config import AffineShapeParams, PyramidParams
    jp_ = PyramidParams(**dataclasses.asdict(p))
    caps = JaxCaps(per_octave=512, per_view=128)
    ref = jax.jit(lambda i, v, r: jh.detect_affine_keypoints(
        i, v, jp_, AffineShapeParams(), caps, r))(
            jnp.asarray(views), jnp.asarray(hw), jnp.asarray(regn))
    got = th.detect_affine_keypoints(
        torch.from_numpy(views), torch.from_numpy(hw), p,
        tc.AffineShapeParams(), _port(caps), torch.from_numpy(regn))
    assert got.mask.shape == (3, 128)
    n_ref = np.asarray(ref.mask).sum(-1)
    n_got = got.mask.sum(-1).numpy()
    assert n_ref[0] > 25 and n_ref[1] == 25 and n_ref[2] == 0
    assert n_got[2] == 0 and np.abs(n_got - n_ref).max() <= 2
    for v in range(2):
        m, mg = np.asarray(ref.mask)[v], got.mask[v].numpy()
        jx, tx = np.asarray(ref.xy)[v][m], got.xy[v].numpy()[mg]
        d = np.abs(jx[:, None] - tx[None]).max(-1)
        near = d.min(1) < 1e-2
        assert near.mean() >= 0.9
        j = d.argmin(1)[near]
        np.testing.assert_allclose(got.A[v].numpy()[mg][j],
                                   np.asarray(ref.A)[v][m][near], atol=2e-3)


def _regions(seed, V, K, hw):
    """Seeded regions in view coordinates, ~60 % of the slots valid."""
    rng = np.random.default_rng(seed)
    xy = 15.0 + rng.uniform(0, 1, (V, K, 2)) * (
        np.asarray(hw)[:, None, ::-1] - 30)
    th_ = rng.uniform(0, 6.28, (V, K))
    st = rng.uniform(0.7, 1.4, (V, K))
    A = np.stack([np.stack([np.cos(th_) * st, -np.sin(th_) / st], -1),
                  np.stack([np.sin(th_) * st, np.cos(th_) / st], -1)], -2)
    s = rng.uniform(1.5, 7.0, (V, K))
    s[:, :4] = 14.0                                   # large: upper mip levels
    resp = rng.normal(0, 50, (V, K))
    mask = rng.uniform(size=(V, K)) < 0.6
    return [a.astype(np.float32) for a in (xy, A, s, resp)] + [mask]


def _sorted_store(xy, A, s, r, d, n):
    n = int(n)
    rows = np.concatenate([np.asarray(a)[:n].reshape(n, -1)
                           for a in (r, xy, s, A, d)], 1)
    order = np.lexsort((rows[:, 2], rows[:, 1], rows[:, 0]))
    return rows[order]


@pytest.mark.parametrize("names,cap", [
    (("RootSIFT",), 512), (("ORB",), 512),
    (("RootSIFT", "HalfRootSIFT", "DSPSIFT", "ORB"), 512),
    (("SIFT",), 40)])
def test_describe_stage_against_jax(names, cap):
    """``_make_desc_fn``: the same views, regions and hinv through both
    packages; the stores' contents after sorting by (response, x, y).
    ``cap`` = 40 overflows the store on the second append."""
    V, K, hc, wc, h0, w0 = 3, 48, 128, 256, 120, 200
    views = _views(2, V, hc, wc)
    valid = np.asarray([[128, 256], [110, 230], [0, 0]], np.int32)
    xy, A, s, resp, mask = _regions(3, V, K, [[128, 256], [110, 230],
                                              [128, 256]])
    # view 0 maps to the image by a squash, view 1 by a rotation
    hinv = np.asarray([[[0.78, 0, 0], [0, 0.93, 0]],
                       [[0.7, -0.4, 60], [0.4, 0.7, -20]],
                       [[1, 0, 0], [0, 1, 0]]], np.float32)
    caps = JaxCaps(per_view=K, per_group=64, per_image=cap, max_angles=2)
    from mods_tpu.config import DominantOrientationParams as JaxDomOri
    dom = JaxDomOri(max_angles=2)
    specs_j = tuple(jp.spec_for(n, jp.EngineConfig()) for n in names)
    specs_t = tuple(tp.spec_for(n) for n in names)
    assert [(a.name, a.kind, a.dim, a.dsp_levels, a.half_sift_like)
            for a in specs_t] == \
        [(a.name, a.kind, a.dim, a.dsp_levels, a.half_sift_like)
         for a in specs_j]
    args = (V, hc, wc, h0, w0, K)
    jprog = jax.jit(jp._make_desc_fn(*args, specs_j, dom, 5.1962, 41, True,
                                     caps))
    tprog = tp._make_desc_fn(*args, specs_t, _port(dom), 5.1962, 41, True,
                             _port(caps))
    jstores = tuple(jp.DeviceStore(cap, sp.dim).buffers() for sp in specs_j)
    tstores = [tp.DeviceStore(cap, sp.dim) for sp in specs_t]
    jin = [jnp.asarray(a) for a in (views, valid, xy, A, s, resp, mask, hinv)]
    tin = [torch.from_numpy(a) for a in (views, valid, xy, A, s, resp, mask,
                                         hinv)]
    for _ in range(2):                      # two groups append in turn
        jstores = jprog(*jin, jstores)
        tprog(*tin, tstores)
    for sp, jst, tst in zip(specs_t, jstores, tstores):
        n = int(jst[5])
        assert tst.count == n, sp.name
        assert n == cap if cap == 40 else 20 < n < cap
        a = _sorted_store(*jst)
        b = _sorted_store(tst._xy, tst._A, tst._s, tst._r, tst._d, tst._n)
        np.testing.assert_allclose(b[:, :8], a[:, :8], atol=2e-3, rtol=1e-5)
        dd = np.abs(b[:, 8:] - a[:, 8:])
        if sp.kind == "binary":
            assert (dd == 0).mean() >= 0.995
        else:
            assert ((dd.max(1) <= 1.0).mean() >= 0.99), sp.name
            assert dd.mean() < 0.05
        # the host views return the count prefix
        assert tst.xy.shape == (n, 2) and tst.desc.shape == (n, sp.dim)
        assert tst.A.shape == (n, 2, 2) and tst.s.shape == (n,)
        assert tst.response.shape == (n,)


def test_device_store_append_past_capacity():
    st = tp.DeviceStore(10, 4)
    rows = torch.arange(8, dtype=torch.float32)

    def push(n):
        st.append(rows[:, None].expand(8, 2), rows[:, None, None].expand(
            8, 2, 2), rows, -rows, rows[:, None].expand(8, 4),
            torch.tensor(n))
    push(6)
    assert st.count == 6
    push(7)                                  # 4 fit, 3 are dropped
    assert st.count == 10
    np.testing.assert_array_equal(st.s, [0, 1, 2, 3, 4, 5, 0, 1, 2, 3])
    np.testing.assert_array_equal(st.response, -st.s)
    push(5)                                  # full: nothing lands
    assert st.count == 10
    np.testing.assert_array_equal(st.s, [0, 1, 2, 3, 4, 5, 0, 1, 2, 3])
    assert st.device_arrays()[0].shape == (10, 2)
    st.reset()
    assert st.count == 0 and st.xy.shape == (0, 2)
    carried = tp.stores_from_numpy(
        np.ones((3, 2)), np.ones((3, 2, 2)), np.ones(3), np.ones(3),
        np.ones((3, 4)), cap=10)
    assert carried.count == 3 and carried.desc.shape == (3, 4)
    r = regions_from_numpy(np.zeros((2, 5, 2)), np.zeros((2, 5, 2, 2)),
                           np.ones((2, 5)), np.ones((2, 5)),
                           np.ones((2, 5), bool))
    assert r.capacity == 5 and r.sub_type.dtype == torch.int32


# ---------------------------------------------------------------------------
# the matcher end to end

SMALL_CAPS = dict(per_octave=512, per_view=512, per_image=1024, max_angles=2)
RANSAC = dict(err_threshold=3.0, batch_hypotheses=256, max_rounds=3,
              error_type="sampson")
ORB = dict(detector="ORB", descriptors=("ORB",), fginn_threshold=(0.0,),
           distance_threshold=(60.0,))

SHIFT = np.array([[1.0, 0.0, 18.0], [0.0, 1.0, -7.0], [0, 0, 1.0]])
SQUASH = np.array([[1.0 / 3.0, 0.0, 30.0], [0.0, 1.0, 4.0], [0, 0, 1.0]])

# name -> (image seed, (h, w), H, ladder, EngineConfig keywords).  A rung
# of the ladder is IterationParams keywords, or (a list of them, MatchPlan
# keywords) for a rung of several detectors or with a plan.
CASES = {
    "identity": (0, (192, 256), SHIFT, [dict(tilt_set=(1.0,))], {}),
    "tilted": (7, (160, 224), SQUASH,
               [dict(tilt_set=(1.0,)),
                dict(tilt_set=(1.0, 4.0), phi_base=360.0)], {}),
    "orb_first": (11, (192, 240), SHIFT,
                  [dict(tilt_set=(1.0,), **ORB), dict(tilt_set=(1.0,))], {}),
}


def _ladder(config_module, ladder):
    """A case's ladder as ``config_module``'s IterationParams and Rungs."""
    c = config_module
    out = []
    for r in ladder:
        if isinstance(r, dict):
            out.append(c.IterationParams(**r))
        else:
            dets, plan = r
            out.append(c.Rung(dets=tuple(c.IterationParams(**d)
                                         for d in dets),
                              plan=c.MatchPlan(**plan)))
    return out


def _case(name, cases=CASES):
    """(img1, img2, H, ladder) of ``cases[name]``."""
    seed, (h, w), H, ladder, _ = cases[name]
    if name == "orb_first":
        # a block texture: FAST needs corners, which the smooth blobs of
        # ``textured_image`` lack
        rng = np.random.default_rng(seed)
        b = np.kron(rng.uniform(0, 255, (h // 12 + 1, w // 12 + 1)),
                    np.ones((12, 12)))[:h, :w]
        img1 = np.clip(ndimage.gaussian_filter(b, 0.8)
                       + rng.uniform(0, 6, b.shape), 0, 255).astype(np.float32)
    else:
        img1 = textured_image(h, w, seed=seed)
    return img1, warp_np(img1, H, h, w), H, ladder


def _jax_cfg(**kw):
    return jp.EngineConfig(caps=JaxCaps(**SMALL_CAPS),
                           ransac=JaxRansac(**RANSAC), **kw)


@pytest.fixture(scope="module")
def jax_results():
    """The JAX matcher's result per case, computed once for the module."""
    out = {}
    for name in CASES:
        img1, img2, _, ladder = _case(name)
        m = jp.TwoViewMatcher(_ladder(jax_config, ladder),
                              _jax_cfg(**CASES[name][4]))
        out[name] = m.match(img1, img2)
    return out


def _corners(H, w, h):
    c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], np.float64)
    p = c @ np.asarray(H, np.float64).T
    return p[:, :2] / p[:, 2:]


def _port_matcher(ladder, cfg_kw=None, **kw):
    return tp.TwoViewMatcher(_ladder(tc, ladder),
                             _port(_jax_cfg(**(cfg_kw or {}))),
                             device="cpu", **kw)


@pytest.mark.parametrize("name", list(CASES))
def test_matcher_against_jax(name, jax_results):
    img1, img2, H, ladder = _case(name)
    ref = jax_results[name]
    got = _port_matcher(ladder, CASES[name][4]).match(img1, img2)
    assert ref.n_matches >= 10, "the JAX matcher must solve the case"
    assert got.steps_used == ref.steps_used
    assert got.n_matches >= 10
    assert abs(got.n_matches - ref.n_matches) <= 0.2 * ref.n_matches
    assert got.xy1.shape == got.xy2.shape == (got.n_matches, 2)
    assert got.n_tentatives >= got.n_matches
    h, w = img1.shape
    d = np.abs(_corners(got.H, w, h) - _corners(ref.H, w, h)).max()
    assert d < 1.0, d
    # against the ground truth: the tilted pair's matches cover a third
    # of the width, so its corners extrapolate (JAX's are as far off)
    gt_px = 6.0 if name == "tilted" else 3.0
    assert np.abs(_corners(got.H, w, h) - _corners(H, w, h)).max() < gt_px
    assert set(got.log.times) == set(ref.log.times)
    assert got.log.times["TotalTime"] > 0


def test_async_stop_mode_matches_sync():
    img1, img2, _, ladder = _case("tilted")
    ms = _port_matcher(ladder, seed=3).match(img1, img2)
    ma = _port_matcher(ladder, seed=3, stop_mode="async").match(img1, img2)
    assert ma.steps_used == ms.steps_used == 2
    assert ma.n_matches == ms.n_matches
    np.testing.assert_array_equal(ma.xy1, ms.xy1)
    np.testing.assert_allclose(ma.H, ms.H)
    # the same matcher on the same pair again: seeded anew, same result
    m = _port_matcher(ladder, seed=3)
    a, b = m.match(img1, img2), m.match(img1, img2)
    assert a.n_matches == b.n_matches == ms.n_matches
    np.testing.assert_array_equal(a.xy2, b.xy2)


@pytest.mark.parametrize("name", ["tilted", "orb_first"])
def test_planned_launches_equal_the_calls_made(name, monkeypatch):
    """``chip_smoke.py`` holds the kernels' launch counts on the card
    against ``_planned_launches``.  Here, on the CPU, the same reckoning
    against the calls the matcher makes to the two wrappers."""
    img1, img2, _, ladder = _case(name)
    if name == "tilted":
        ladder = ladder + [dict(tilt_set=(1.0, 2.0, 4.0), phi_base=120.0,
                                descriptors=("RootSIFT", "HalfRootSIFT",
                                             "DSPSIFT", "ORB"),
                                fginn_threshold=(0.8, 0.8, 0.8, 0.0),
                                distance_threshold=(0.0, 0.0, 0.0, 60.0))]
    calls = count_launches(img1, img2, ladder, {}, monkeypatch)
    assert calls["baumberg_smm"] > 0


def count_launches(img1, img2, ladder, cfg_kw, monkeypatch) -> dict:
    """Runs every rung of ``ladder`` and counts the calls to the two
    kernels' wrappers; they must equal ``chip_smoke._planned_launches``."""
    import chip_smoke
    calls = {"window_sampler": 0, "baumberg_smm": 0}

    def counting(kernel, fn):
        def wrapped(*a, **kw):
            calls[kernel] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tp, "sample_affine_patches",
                        counting("window_sampler", tp.sample_affine_patches))
    monkeypatch.setattr(th, "baumberg_adapt",
                        counting("baumberg_smm", th.baumberg_adapt))
    m = _port_matcher(ladder, cfg_kw)
    m.cfg = dataclasses.replace(m.cfg, min_matches=10 ** 6)  # run every rung
    r = m.match(img1, img2)
    assert r.steps_used == len(ladder)
    assert calls == chip_smoke._planned_launches(
        m, (img1.shape, img2.shape), r.steps_used)
    assert calls["window_sampler"] >= 2 * len(ladder)
    return calls


_REF_FAR = dict(steps=5, matches=12, gt_consistent=12,
                corner_error_px=44.8)     # JAX's own H off at the corners
_REF_NEAR = dict(_REF_FAR, corner_error_px=4.0)


@pytest.mark.parametrize("ref,steps,n,true,err,ok", [
    (_REF_FAR, 5, 12, 12, 60.0, True),      # JAX's rung
    (_REF_FAR, 4, 10, 8, 60.0, True),       # one earlier, at the stop count
    (_REF_FAR, 6, 14, 12, 60.0, False),     # later than JAX
    (_REF_FAR, 3, 12, 12, 60.0, False),     # two earlier
    (_REF_FAR, 5, 9, 9, 60.0, False),       # under the stop count
    (_REF_FAR, 5, 12, 9, 60.0, False),      # < 0.8x JAX's within 3 px
    (_REF_NEAR, 5, 12, 12, 8.0, True),
    (_REF_NEAR, 5, 12, 12, 8.5, False),     # corners off where JAX's are not
    (dict(_REF_FAR, matches=9), 7, 0, 0, 600.0, True),   # JAX fails too
])
def test_chip_smoke_holds_the_port_to_jax(ref, steps, n, true, err, ok):
    """The rule of PERF.md section 2 as ``chip_smoke.py`` phases 6 and 7
    apply it to one result of the port."""
    import chip_smoke
    r = tp.MatchResult(H=np.eye(3), xy1=np.zeros((n, 2)),
                       xy2=np.zeros((n, 2)), n_matches=n, n_tentatives=100,
                       steps_used=steps, log=None)
    if ok:
        chip_smoke._hold_to_jax("pair", r, true, err, ref, 10)
    else:
        with pytest.raises(RuntimeError, match="pair"):
            chip_smoke._hold_to_jax("pair", r, true, err, ref, 10)


def test_seed_spread_reads_the_rungs_tentatives():
    """``chip_smoke.ladder_banks`` keeps each rung's tentatives, and
    ``verify_spread`` with the matcher's seed repeats the verification of
    rung 1 (the first draws of that seed)."""
    import chip_smoke
    img1, img2, H, ladder = _case("identity")
    ladder = ladder + [dict(tilt_set=(1.0, 4.0), phi_base=360.0)]
    m = _port_matcher(ladder, dict(min_matches=10 ** 6), stop_mode="async")
    banks = chip_smoke.ladder_banks(m, img1, img2)
    assert chip_smoke.bank_rungs(banks) == [1, 2]
    assert "_verify_bank" not in vars(m)          # the hook is gone
    single = _port_matcher(ladder[:1], dict(min_matches=10 ** 6))
    r = single.match(img1, img2)
    (got,) = chip_smoke.verify_spread(single.cfg, banks, 1, [0], H, "cpu")
    assert got[0] == r.n_matches >= 10
    assert got[1] == chip_smoke._gt_consistent(H, r.xy1, r.xy2)
    summary = chip_smoke.spread_summary([got, [0, 0]], 10)
    assert summary["share_stops"] == summary["share_zero"] == 0.5


def test_ground_truth_modes_against_jax():
    img1, img2, H, ladder = _case("identity")
    kw = dict(ver_type="GR_TRUTH", do_both_ransac_gt=True)
    ref = jp.TwoViewMatcher(_ladder(jax_config, ladder),
                            _jax_cfg(**kw)).match(img1, img2, gt_h=H)
    got = _port_matcher(ladder, kw).match(img1, img2, gt_h=H)
    assert got.steps_used == ref.steps_used == 1
    assert abs(got.n_matches - ref.n_matches) <= 0.1 * ref.n_matches
    assert abs(got.n_tentatives - ref.n_tentatives) <= 0.1 * ref.n_tentatives
    np.testing.assert_allclose(got.H, H)
    assert set(got.extras) == set(ref.extras) == {"ransac_matches",
                                                  "ransac_true"}
    for k in got.extras:
        assert abs(got.extras[k] - ref.extras[k]) <= 0.2 * ref.extras[k]


def _cli(*argv):
    from mods_tpu_torch import cli
    return cli.main(list(argv) + ["--device", "cpu"])


@pytest.mark.parametrize("what,item,make", [
    ("External detector", 21, lambda: tp.TwoViewMatcher(
        [tc.IterationParams(detector="External")], device="cpu")),
    ("ReadAffs", 21, lambda: tp.TwoViewMatcher(
        [tc.IterationParams(detector="ReadAffs")], device="cpu")),
    ("match_multi command", 21, lambda: _cli("match_multi", "q.png",
                                             "list.txt")),
    ("extract command, michal format", 21, lambda: _cli(
        "extract", "a.png", "a.keys", "0", "0", "michal")),
    ("External descriptor in a ladder", 21, lambda: tp.TwoViewMatcher(
        [tc.IterationParams(descriptors=("External",))],
        device="cpu").match(np.zeros((64, 64)), np.zeros((64, 64)))),
    ("MultiMatcher over a mesh", 22, lambda: tm.MultiMatcher(
        mesh="pair", device="cpu")),
    ("monolith", 23, lambda: tp.TwoViewMatcher(monolith=True, device="cpu")),
    ("extract command", 21, lambda: _cli("extract", "a.png", "a.keys")),
    ("drawn output", 21, lambda: _cli("match", "a.png", "b.png", "x.png",
                                      "0", "k1", "k2", "m.txt", "0")),
    ("drawn output of image 2", 21, lambda: _cli(
        "match", "a.png", "b.png", "0", "y.png", "k1", "k2", "m.txt", "0")),
    ("External descriptor in a pair batch", 21, lambda: tm.PairBatchMatcher(
        [tc.IterationParams(descriptors=("External",))],
        device="cpu").match_batch([(np.zeros((64, 64)),) * 2])),
    ("External", 21, lambda: tp.spec_for("External")),
])
def test_unported_branches_name_their_roadmap_item(what, item, make):
    with pytest.raises(NotImplementedError,
                       match=rf"ROADMAP\.md item {item}\b"):
        make()


def test_matcher_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        assert tp.TwoViewMatcher().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no GPU"):
            tp.TwoViewMatcher()
    with pytest.raises(ValueError):
        tp.TwoViewMatcher(stop_mode="later", device="cpu")


# ---------------------------------------------------------------------------
# the full-size reference run (script mode)

def _reference_main(pairs, cviu=False):
    from PIL import Image
    import chip_smoke
    if cviu:
        ladder = chip_smoke.cviu_rungs(jax_config)
    else:
        ladder = [JaxIteration(**kw) for kw in chip_smoke.LADDER]
    m = jp.TwoViewMatcher(ladder, jp.EngineConfig(), seed=0)
    for pair in pairs:
        imgs = [np.asarray(Image.open(os.path.join(
            REPO, ".parity_work", f"{pair}_{i}.png")), np.float32)
            for i in (1, 2)]
        H_gt = np.loadtxt(os.path.join(REPO, ".parity_work",
                                       f"{pair}_H.txt"))
        t0 = time.time()
        r = m.match(*imgs)
        h, w = imgs[0].shape[:2]
        err = float(np.sqrt(((_corners(r.H, w, h) - _corners(H_gt, w, h))
                             ** 2).sum(-1)).max())
        true = chip_smoke._gt_consistent(H_gt, r.xy1, r.xy2)
        print(json.dumps({pair: dict(
            steps=r.steps_used, tentatives=r.n_tentatives,
            matches=r.n_matches, gt_consistent=true, corner_error_px=err,
            seconds=time.time() - t0)}), flush=True)


def _full_pair(pair):
    from PIL import Image
    imgs = [np.asarray(Image.open(os.path.join(
        REPO, ".parity_work", f"{pair}_{i}.png")), np.float32)
        for i in (1, 2)]
    return imgs[0], imgs[1], np.loadtxt(os.path.join(
        REPO, ".parity_work", f"{pair}_H.txt"))


def _detector_main(dets, pairs, n_seeds=0):
    """The JAX matcher with ``chip_smoke.py::DETECTOR_LADDERS[det]`` on
    full-size pairs: the figures of ``JAX_DETECTOR_REFERENCE``.  With
    ``n_seeds``, instead each pair's result over RANSAC seeds 0..n-1
    (``JAX_DETECTOR_SPREAD``)."""
    import chip_smoke
    for det in dets:
        ladder, cfg = chip_smoke.detector_matcher_args(jp, jax_config, det)
        m = jp.TwoViewMatcher(ladder, cfg, seed=0)
        rows = chip_smoke.store_rows_per_rung(m, lambda st: st.count)
        tents = chip_smoke.tentatives_per_rung(m)
        for pair in pairs:
            img1, img2, H_gt = _full_pair(pair)
            if n_seeds:
                per_seed = []
                for seed in range(n_seeds):
                    m._seed = seed
                    r = m.match(img1, img2)
                    per_seed.append(chip_smoke.pair_outcome(r, H_gt,
                                                            img1.shape))
                print(json.dumps({f"{det} {pair}": per_seed}), flush=True)
                continue
            del rows[:], tents[:]
            t0 = time.time()
            r = m.match(img1, img2)
            steps, n, true, err = chip_smoke.pair_outcome(r, H_gt,
                                                          img1.shape)
            print(json.dumps({f"{det} {pair}": dict(
                steps=steps, tentatives=r.n_tentatives, matches=n,
                gt_consistent=true, corner_error_px=err,
                regions=list(rows),
                tentatives_per_rung=[int(t) for t in tents],
                seconds=round(time.time() - t0, 1))}), flush=True)


def _study_ladder(pipeline_module, config_module, det=None):
    """(ladder, EngineConfig) that ``_dump_banks`` and ``_seed_study``
    run: the CVIU-shaped ladder, or ``DETECTOR_LADDERS[det]``."""
    import chip_smoke
    if det:
        return chip_smoke.detector_matcher_args(pipeline_module,
                                                config_module, det)
    return (chip_smoke.cviu_rungs(config_module),
            pipeline_module.EngineConfig())


def _dump_banks(pair, path, det=None):
    """The tentatives that each of the first six rungs of the CVIU-shaped
    ladder (or of ``DETECTOR_LADDERS[det]``) verifies on ``pair`` (one
    JAX matcher run, every rung, ``async``), compacted to the tentative
    capacity as ``_concat_compact_parts`` compacts them, saved to
    ``path``.  Six rungs and numpy compaction: every XLA compile counts
    against the process's memory maps, and a seventh rung ran out of
    them."""
    from PIL import Image
    imgs = [np.asarray(Image.open(os.path.join(
        REPO, ".parity_work", f"{pair}_{i}.png")), np.float32)
        for i in (1, 2)]
    ladder, cfg = _study_ladder(jp, jax_config, det)
    cfg = dataclasses.replace(cfg, max_steps=6)
    m = jp.TwoViewMatcher(ladder, cfg, seed=0, stop_mode="async")
    banks, calls = {}, []
    verify_bank = m._verify_bank
    tcap = cfg.caps.tentatives

    def keep_bank(log):
        calls.append(None)                     # one call a rung
        parts = [p for ps in m._bank.values() for p in ps]
        if parts:
            mask = np.concatenate([np.asarray(p["mask"]) for p in parts])
            idx = np.nonzero(mask)[0][:tcap]
            for k in ("xy1", "A1", "s1", "xy2", "A2", "s2", "prio"):
                a = np.concatenate([np.asarray(p[k]) for p in parts])
                out = np.zeros((tcap,) + a.shape[1:], a.dtype)
                out[:len(idx)] = a[idx]
                banks[f"{len(calls)}_{k}"] = out
            banks[f"{len(calls)}_mask"] = np.arange(tcap) < len(idx)
        return verify_bank(log)

    m._verify_bank = keep_bank
    m.match(*imgs)
    np.savez(path, wh=np.asarray(m._wh), **banks)


def _seed_study(pair, n_seeds, bank_files=(), det=None):
    """The RANSAC draw's share in the stop rung of a pair of the
    CVIU-shaped ladder (or of ``DETECTOR_LADDERS[det]``).  Verification
    is the only random stage, so each rung's tentatives are those of one
    run: the JAX matcher's
    (``_dump_banks``, in a process of its own: XLA's CPU compiler runs out
    of memory maps when one process compiles both), the port's on the CPU
    (``chip_smoke.ladder_banks``) and those of ``bank_files`` (the card's,
    from ``python3 chip_smoke.py --seed-spread PAIR N``).  Prints per rung
    each bank's tentatives, those within 3 px of the ground truth and the
    rows it shares with JAX's (both ends within 0.5 px); then, on each
    rung with at least ``min_matches`` tentatives within 3 px (where a
    stop is possible), JAX's ``_verify_core`` and the port's, on the CPU,
    with seeds 0..N-1 on every bank that differs from JAX's, summarized by
    ``chip_smoke.spread_summary``; and the rung each JAX seed stops at on
    JAX's banks."""
    import subprocess
    import tempfile
    import chip_smoke
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "banks.npz")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--dump-banks", path, pair]
                       + (["--detectors", det] if det else []), check=True)
        jbanks = dict(np.load(path))
    H_gt = np.loadtxt(os.path.join(REPO, ".parity_work", f"{pair}_H.txt"))
    _, cfg = _study_ladder(jp, jax_config, det)
    ladder, tcfg = _study_ladder(tp, tc, det)
    m = tp.TwoViewMatcher(ladder, tcfg, seed=0, stop_mode="async",
                          device="cpu")
    imgs = [chip_smoke._load_pair_np(pair)[i] for i in (0, 1)]
    banks = {"jax": jbanks, "port_cpu": chip_smoke.ladder_banks(m, *imgs)}
    m.close()
    for f in bank_files:
        banks[os.path.basename(f)] = dict(np.load(f))
    w, h = (int(v) for v in jbanks["wh"])
    keys = chip_smoke.BANK_KEYS
    jverify = jax.jit(lambda *a: jp._verify_core(cfg, w, h, *a))

    def rows(b, rung):
        mask = b[f"{rung}_mask"]
        return b[f"{rung}_xy1"][mask], b[f"{rung}_xy2"][mask]

    def same(b, rung):
        return all(np.allclose(b[f"{rung}_{k}"], jbanks[f"{rung}_{k}"],
                               atol=1e-3) for k in keys)

    spread_rungs, jax_counts = [], {}
    for rung in chip_smoke.bank_rungs(jbanks):
        ja, jb = rows(jbanks, rung)
        row = {}
        for name, b in banks.items():
            a1, a2 = rows(b, rung)
            d = (np.sqrt(((a1[:, None] - ja[None]) ** 2).sum(-1))
                 + np.sqrt(((a2[:, None] - jb[None]) ** 2).sum(-1)))
            row[name] = dict(
                tentatives=len(a1),
                within_3px=chip_smoke._gt_consistent(H_gt, a1, a2),
                shared_with_jax=int((d.min(1) < 0.5).sum()) if len(ja)
                else 0, identical_to_jax=same(b, rung))
        print(json.dumps({pair: dict(rung=rung, banks=row)}), flush=True)
        if row["jax"]["within_3px"] >= cfg.min_matches:
            spread_rungs.append(rung)
    if not n_seeds:
        return
    for rung in spread_rungs:
        out = {}
        for name, b in banks.items():
            if name != "jax" and same(b, rung):
                continue
            args = [b[f"{rung}_{k}"] for k in keys]
            a1, a2 = args[0], args[3]
            jx = []
            for s in range(n_seeds):
                inl = np.asarray(jverify(*args, jax.random.PRNGKey(s))[
                    "inlier_mask"])
                jx.append([int(inl.sum()),
                           chip_smoke._gt_consistent(H_gt, a1[inl], a2[inl])])
            if name == "jax":
                jax_counts[rung] = [c[0] for c in jx]
            out[name] = dict(
                jax=chip_smoke.spread_summary(jx, cfg.min_matches),
                port=chip_smoke.spread_summary(chip_smoke.verify_spread(
                    tcfg, b, rung, range(n_seeds), H_gt, "cpu"),
                    cfg.min_matches))
        print(json.dumps({pair: dict(rung=rung, verified=out)}), flush=True)
    stops = [next((r for r in spread_rungs
                   if jax_counts[r][s] >= cfg.min_matches), None)
             for s in range(n_seeds)]
    print(json.dumps({pair: dict(jax_stop_rung_per_seed=stops)}),
          flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    flags = {f for f in ("--cviu", "--tentatives") if f in args}
    opts = {}
    for opt in ("--seeds", "--dump-banks", "--banks", "--detectors"):
        if opt in args:
            i = args.index(opt)
            opts[opt] = args[i + 1]
            del args[i:i + 2]
    args = [a for a in args if a not in flags]
    pairs = args or ["zoom2x", "rot90", "tilt4", "tilt6_rot45"]
    det = opts.get("--detectors")
    banks = [opts["--banks"]] if "--banks" in opts else []
    if "--dump-banks" in opts:
        _dump_banks(pairs[0], opts["--dump-banks"], det)
    elif det and "--tentatives" in flags:
        for pair in pairs:
            _seed_study(pair, int(opts.get("--seeds", 0)), banks, det)
    elif det:
        _detector_main(det.split(","), pairs, int(opts.get("--seeds", 0)))
    elif "--seeds" in opts:
        for pair in pairs:
            _seed_study(pair, int(opts["--seeds"]), banks)
    else:
        _reference_main(pairs, cviu="--cviu" in flags)
