"""Port vs JAX reference: the other descriptor families in the ladder
(CPU, small images).

The describe stage (``_make_desc_fn``) with the patch functors, Pixels
and the CNN on the same views and regions in both packages; end to end,
``TwoViewMatcher.match(device="cpu")`` against the JAX matcher on
``tests/test_multidesc.py``'s 160x192 textured pairs and caps, with
three multi-descriptor rungs (one JAX compilation each for several
families) and KAZE on the KAZE detector; one pair batch of two pairs
against the port's serial runs; the kernel launches of the new kinds
against ``chip_smoke.py::_planned_launches``.

Tolerances.  Describe stage: the stores hold the same rows after sorting
by (response, x, y), geometry to 2e-3 as ``test_torch_ladder.py``; the
patches differ by the sampler's rounding, so the descriptors of each
family agree on 99 % of the rows within its bound (float families 1e-3;
Pixels 1e-4; the bit families on all but 1 % of the bits), LIOP and
MROGH, whose pixels move bins at rank ties and bin edges, on 95 % within
1e-3 and everywhere within 0.05.  End to end:
``test_torch_ladder.py``'s rule (same rungs, verified matches within
20 %, H within 1 px at the image corners).  Pair batch vs serial:
``test_torch_batch.py``'s bounds of the blurs' batch rounding.
"""

import dataclasses
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mods_tpu import config as jc  # noqa: E402
from mods_tpu import pipeline as jp  # noqa: E402
from mods_tpu_torch import config as tc  # noqa: E402
from mods_tpu_torch import pipeline as tp  # noqa: E402
from mods_tpu_torch.parallel import multi as tm  # noqa: E402
from test_pipeline import textured_image, warp_np  # noqa: E402
from test_torch_batch import (_corners as _corners_small,  # noqa: E402
                              _record_stores, _rng_rule, _rows, _store)
from test_torch_ladder import (_corners, _port, _regions,  # noqa: E402
                               _sorted_store, _views, count_launches)

torch.set_num_threads(2)

BIT_KINDS = ("MLDB", "FREAK", "BRISK")


@pytest.mark.parametrize("names", [
    ("SURF", "LIOP", "DAISY", "SSIM", "Pixels", "RootSIFT"),
    ("MLDB", "MROGH", "FREAK", "BRISK", "CNN", "KAZE")])
def test_describe_stage_against_jax(names):
    """``_make_desc_fn``: the same views, regions and hinv through both
    packages, two groups appended in turn; the stores' contents after
    sorting by (response, x, y)."""
    V, K, hc, wc, h0, w0 = 3, 48, 128, 256, 120, 200
    views = _views(2, V, hc, wc)
    valid = np.asarray([[128, 256], [110, 230], [0, 0]], np.int32)
    xy, A, s, resp, mask = _regions(3, V, K, [[128, 256], [110, 230],
                                              [128, 256]])
    hinv = np.asarray([[[0.78, 0, 0], [0, 0.93, 0]],
                       [[0.7, -0.4, 60], [0.4, 0.7, -20]],
                       [[1, 0, 0], [0, 1, 0]]], np.float32)
    cap = 512
    caps = jc.CapacityParams(per_view=K, per_group=64, per_image=cap,
                             max_angles=2)
    dom = jc.DominantOrientationParams(max_angles=2)
    specs_j = tuple(jp.spec_for(n, jp.EngineConfig()) for n in names)
    specs_t = tuple(tp.spec_for(n, tc.from_dict(dataclasses.asdict(
        jp.EngineConfig()))) for n in names)
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
    for _ in range(2):
        jstores = jprog(*jin, jstores)
        tprog(*tin, tstores)
    for sp, jst, tst in zip(specs_t, jstores, tstores):
        n = int(jst[5])
        assert tst.count == n and 20 < n < cap, sp.name
        a = _sorted_store(*jst)
        b = _sorted_store(tst._xy, tst._A, tst._s, tst._r, tst._d, tst._n)
        np.testing.assert_allclose(b[:, :8], a[:, :8], atol=2e-3, rtol=1e-5)
        dd = np.abs(b[:, 8:] - a[:, 8:])
        if sp.kind == "sift":
            assert (dd.max(1) <= 1.0).mean() >= 0.99, sp.name
        elif sp.name in BIT_KINDS:
            assert (dd == 0).mean() >= 0.99, sp.name
        elif sp.name in ("LIOP", "MROGH"):
            # a pixel that moves bins moves two entries by 1/|v|, 0.01 to
            # 0.03 here: the ranks' ties (the 128 fill of clamped reads)
            # and the orientation bins' edges follow the rounding
            assert dd.max() <= 0.05, sp.name
            assert (dd.max(1) <= 1e-3).mean() >= 0.95, sp.name
        else:
            tol = 1e-4 if sp.kind == "pixels" else 1e-3
            assert (dd.max(1) <= tol).mean() >= 0.99, (sp.name, dd.max())
        assert tst.desc.shape == (n, sp.dim)


# tests/test_multidesc.py's caps and RANSAC, its 160x192 textured image
# and a shift
CAPS = dict(per_octave=512, per_view=256, per_image=512, max_angles=2,
            tentatives=1024)
RANSAC = dict(err_threshold=3.0, batch_hypotheses=256, max_rounds=2)
SHIFT = np.array([[1.0, 0.0, 12.0], [0.0, 1.0, -9.0], [0, 0, 1.0]])
RUNGS = {
    "surf_liop_daisy_ssim": ("HessianAffine",
                             ("SURF", "LIOP", "DAISY", "SSIM")),
    "mldb_mrogh_freak_brisk": ("HessianAffine",
                               ("MLDB", "MROGH", "FREAK", "BRISK")),
    "pixels_cnn_rootsift": ("HessianAffine", ("Pixels", "CNN", "RootSIFT")),
    "kaze": ("KAZE", ("KAZE",)),
}


def _rung(config_module, det, names):
    return [config_module.IterationParams(
        detector=det, descriptors=names, fginn_threshold=(0.8,) * len(names),
        distance_threshold=(0.0,) * len(names))]


def _pair():
    img1 = textured_image(160, 192, seed=21)
    return img1, warp_np(img1, SHIFT, 160, 192)


def _jax_cfg():
    return jp.EngineConfig(caps=jc.CapacityParams(**CAPS),
                           ransac=jc.RansacParams(**RANSAC))


@pytest.fixture(scope="module")
def jax_results():
    img1, img2 = _pair()
    return {case: jp.TwoViewMatcher(_rung(jc, *RUNGS[case]),
                                    _jax_cfg()).match(img1, img2)
            for case in RUNGS}


@pytest.mark.parametrize("case", list(RUNGS))
def test_matcher_against_jax(case, jax_results):
    img1, img2 = _pair()
    ref = jax_results[case]
    got = tp.TwoViewMatcher(
        _rung(tc, *RUNGS[case]),
        tc.from_dict(dataclasses.asdict(_jax_cfg())),
        device="cpu").match(img1, img2)
    assert ref.n_matches >= 10, "the JAX matcher must solve the case"
    assert got.steps_used == ref.steps_used
    assert got.n_matches >= 10
    assert abs(got.n_matches - ref.n_matches) <= 0.2 * ref.n_matches
    assert abs(got.n_tentatives - ref.n_tentatives) \
        <= 0.2 * ref.n_tentatives
    h, w = img1.shape
    assert np.abs(_corners(got.H, w, h) - _corners(ref.H, w, h)).max() < 1.0
    assert np.abs(_corners(got.H, w, h)
                  - _corners(SHIFT, w, h)).max() < 3.0


def test_planned_launches_of_the_new_kinds(monkeypatch):
    """Every kind's patch sets against ``_planned_launches``: the patch
    functors and Pixels share the SIFT kinds' patches, each CNN spec
    samples its own, KAZE's regions go through no Baumberg call."""
    img1, img2 = _pair()
    ladder = [dict(tilt_set=(1.0,), descriptors=("SURF", "Pixels", "CNN"),
                   fginn_threshold=(0.8,) * 3, distance_threshold=(0.0,) * 3),
              dict(tilt_set=(1.0, 2.0), phi_base=180.0,
                   descriptors=("RootSIFT", "MLDB", "HalfRootSIFT", "CNN",
                                "ORB"),
                   fginn_threshold=(0.8,) * 4 + (0.0,),
                   distance_threshold=(0.0,) * 4 + (60.0,)),
              dict(detector="KAZE", descriptors=("KAZE", "LIOP"),
                   fginn_threshold=(0.8,) * 2,
                   distance_threshold=(0.0,) * 2)]
    calls = count_launches(img1, img2, ladder, {}, monkeypatch)
    assert calls["window_sampler"] >= 2 * 3 * len(ladder)


# One pair batch: tests/test_torch_batch.py's pairs 0 and 1 (128x160)
# on one rung of two of the new families
BATCH_NAMES = ("SURF", "CNN")


def _batch_cfg():
    from test_torch_batch import CFG
    return tc.from_dict(dataclasses.asdict(CFG), tp.EngineConfig)


def test_pair_batch_equals_serial_runs():
    """``PairBatchMatcher`` on two unpadded pairs against the port's
    serial matcher on each, within ``test_torch_batch.py``'s bounds of
    the blurs' batch rounding: the same rungs, tentatives within
    max(2, 5 %), verified counts under its RNG rule, H's corners within
    0.1 px, and each store within 2 rows of the serial one with >= 95 %
    of its rows twinned (a row within 0.01 px whose frame, scale and
    response agree as there and whose descriptor is within 0.01)."""
    from test_torch_batch import PAIRS
    ladder = _rung(tc, "HessianAffine", BATCH_NAMES)
    cfg = _batch_cfg()
    m = tm.PairBatchMatcher(ladder, cfg, device="cpu")
    brungs = _record_stores(m.mm.qmatcher)
    r = m.match_batch(PAIRS[:2])
    m.close()
    for p in (0, 1):
        sm = tp.TwoViewMatcher(ladder, cfg, seed=0, device="cpu")
        srungs = _record_stores(sm)
        s = sm.match(*PAIRS[p])
        assert int(r.steps_used[p]) == s.steps_used
        assert abs(int(r.n_tentatives[p]) - s.n_tentatives) \
            <= max(2, 0.05 * s.n_tentatives)
        _rng_rule(int(r.counts[p]), s.n_matches, cfg.min_matches)
        if s.n_matches >= cfg.min_matches:
            np.testing.assert_allclose(_corners_small(r.H[p]),
                                       _corners_small(s.H), atol=0.1)
        for brung, srung in zip(brungs, srungs):
            assert brung.keys() == srung.keys()
            for k in srung:
                a, b = _rows(_store(brung[k]), p), _rows(_store(srung[k]))
                assert abs(len(a) - len(b)) <= 2, (k, len(a), len(b))
                d = np.sqrt(((a[:, None, :2] - b[None, :, :2]) ** 2).sum(-1))
                j = d.argmin(1)
                diff = np.abs(a - b[j])
                ok = ((d[np.arange(len(a)), j] < 0.01)
                      & (diff[:, 2:6].max(1) <= 0.02) & (diff[:, 6] <= 0.01)
                      & (diff[:, 7] <= 0.05) & (diff[:, 8:].max(1) <= 0.01))
                assert ok.mean() >= 0.95, (k, ok.mean())
    assert r.counts[0] >= cfg.min_matches


def test_phase_11_helpers_on_the_cpu():
    """``chip_smoke.py`` phase 11's card-vs-CPU check run on the CPU
    against itself: every family, zero differences, and the sampler's
    output against its plain version."""
    import chip_smoke
    img1, _ = _pair()
    ladder, cfg = chip_smoke.descriptor_matcher_args(tp, tc, "SURF")
    m = tp.TwoViewMatcher(ladder, cfg, device="cpu")
    patches = chip_smoke.descriptor_patches(m, torch.from_numpy(img1))
    assert set(patches) == {41, 32}
    assert all(e == 0.0 for _, e in patches.values())
    res = chip_smoke.descriptors_card_vs_cpu(patches, cfg)
    assert set(res) == set(chip_smoke.OTHER_DESCRIPTORS)
    assert all(r["max_abs_err"] == 0.0 for r in res.values())
    assert res["Pixels"]["dim"] == 41 * 41 and res["CNN"]["dim"] == 128
