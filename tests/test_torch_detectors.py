"""Port vs JAX reference: the scale-space responses, DoG and HarrisAffine,
FAST, BRISK, SURF and STAR (CPU, small images).

Each test feeds the same numpy inputs, made from a seed, to the
``mods_tpu`` function and its ``mods_tpu_torch`` counterpart.

Tolerances.  Responses and blurs are float32 stencils and convolutions
summed in another order: relative 1e-5 of the map's largest magnitude
(2e-5 for the TILDE bank's 21x21 convolutions); over a pyramid, whose
responses are products of differences of blurred levels, 1e-4.
Region sets are compared as sets: the same count, every JAX region with
a port region of the same sub-type within 1e-3 px and scale (1e-2 after
Baumberg's 16 fed-back iterations), shape within 1e-2 and scale within
1e-3 relative, response within 1e-4 of the largest, and the responses
sorted by magnitude equal to 1e-4.  SURF's and STAR's integral image is
rounded once from float64 in the port and summed in float32 by XLA, which
carries ~1e-4 of a small box sum: there responses agree to 1e-3 of the
largest, and SURF's quadratic fit to 2e-2 px.  End to end
(``TwoViewMatcher(device="cpu")`` against the JAX matcher on a shifted
pair, RootSIFT descriptors): the same rung, tentatives within 5 %,
verified matches within 20 % (RANSAC draws other random numbers) and the
median shift of the verified matches within 1 px of the truth.
"""

import dataclasses
import math
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
from mods_tpu.detectors import corners as jcorners  # noqa: E402
from mods_tpu.detectors import hessaff as jh  # noqa: E402
from mods_tpu.detectors import orb as jorb  # noqa: E402
from mods_tpu.detectors import scale_space as jss  # noqa: E402
from mods_tpu.detectors import surf as jsurf  # noqa: E402
from mods_tpu.ops import gaussian as jg  # noqa: E402
from mods_tpu_torch import config as tc  # noqa: E402
from mods_tpu_torch import pipeline as tp  # noqa: E402
from mods_tpu_torch.detectors import corners as tcorners  # noqa: E402
from mods_tpu_torch.detectors import hessaff as th  # noqa: E402
from mods_tpu_torch.detectors import orb as torb  # noqa: E402
from mods_tpu_torch.detectors import scale_space as tss  # noqa: E402
from mods_tpu_torch.detectors import surf as tsurf  # noqa: E402
from mods_tpu_torch.ops import gaussian as tg  # noqa: E402

torch.set_num_threads(2)


def textured(h=160, w=192, seed=0):
    """Gaussian blobs over a block texture and noise, 0..255: blobs for
    the blob detectors, block corners for the corner detectors."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = 15.0 * rng.uniform(0, 1, (h, w))
    for _ in range(10):
        cx, cy = rng.uniform(30, w - 30), rng.uniform(30, h - 30)
        sig = rng.uniform(3, 7)
        img += 150.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2)
                              / (2 * sig * sig))
    blocks = rng.uniform(0, 60, (h // 8 + 1, w // 8 + 1))
    img += np.kron(blocks, np.ones((8, 8)))[:h, :w]
    return np.clip(img, 0, 255).astype(np.float32)


def views_and_hw(V=2, h=160, w=192):
    """A (V, h, w) batch; the second view's valid extent is cut short,
    as a bucket-padded view group's are."""
    imgs = np.stack([textured(h, w, seed=s) for s in range(V)])
    hw = np.array([[h, w], [h - 12, w - 20]][:V], np.int32)
    return imgs, hw


def rel_close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.abs(a).max()), 1e-12)
    np.testing.assert_allclose(b, a, rtol=0, atol=rel * scale)


def _rows(r, v):
    m = np.asarray(r.mask[v]).astype(bool)
    return dict(xy=np.asarray(r.xy[v], np.float64)[m],
                s=np.asarray(r.s[v], np.float64)[m],
                A=np.asarray(r.A[v], np.float64)[m].reshape(-1, 4),
                resp=np.asarray(r.response[v], np.float64)[m],
                sub=np.asarray(r.sub_type[v])[m])


def assert_same_regions(jr, pr, xy_atol=1e-3, rel=1e-3, min_count=1,
                        resp_rel=1e-4):
    """The JAX package's and the port's Regions (V, K) agree as sets, view
    by view (see the module docstring)."""
    for v in range(np.asarray(jr.mask).shape[0]):
        a, b = _rows(jr, v), _rows(pr, v)
        assert len(a["xy"]) == len(b["xy"]), (v, len(a["xy"]), len(b["xy"]))
        assert len(a["xy"]) >= min_count, (v, len(a["xy"]))
        if not len(a["xy"]):
            continue
        top = np.abs(a["resp"]).max()
        np.testing.assert_allclose(np.sort(np.abs(b["resp"])),
                                   np.sort(np.abs(a["resp"])), rtol=0,
                                   atol=resp_rel * top)
        # twins by position and scale (a blob may hold a region at two
        # scales), the same sub-type, and among regions at one place
        # (MSER's nested components) the nearest response
        d = np.sqrt(((a["xy"][:, None] - b["xy"][None]) ** 2).sum(-1)
                    + (a["s"][:, None] - b["s"][None]) ** 2)
        d = np.where(a["sub"][:, None] == b["sub"][None], d, np.inf)
        j = (d + np.abs(a["resp"][:, None] - b["resp"][None]) / top).argmin(1)
        assert (d[np.arange(len(j)), j] <= xy_atol).all(), d.min(1).max()
        np.testing.assert_allclose(b["s"][j], a["s"], rtol=rel)
        np.testing.assert_allclose(b["A"][j], a["A"], rtol=0, atol=rel * 10)
        np.testing.assert_allclose(b["resp"][j], a["resp"], rtol=0,
                                   atol=resp_rel * top)


# ---------------------------------------------------------------------------
# scale-space responses


@pytest.mark.parametrize("name,sigma", [
    ("hessian_response", 1.6), ("dog_response", 1.6),
    ("dog_response", 4.0), ("iidog_response", 2.0),
    ("harris_response", 1.6), ("tilde_ss_response", 1.6)])
def test_responses_against_jax(name, sigma):
    img = textured(64, 80, seed=3)[None]
    want = np.asarray(getattr(jss, name)(jnp.asarray(img), sigma))
    got = getattr(tss, name)(torch.as_tensor(img), sigma).numpy()
    assert got.shape == want.shape
    rel_close(want, got, 2e-5 if name.startswith("tilde") else 1e-5)


def test_wld_coef_against_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 255, (5, 7)).astype(np.float32)
    want = np.asarray(jss.wld_coef(jnp.asarray(x), 3.0, 5.0, 5.0))
    got = tss.wld_coef(torch.as_tensor(x), 3.0, 5.0, 5.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("h,w", [(20, 37), (9, 60)])
def test_dog_blur_wider_than_the_octave(h, w):
    """DoG blurs by sigma^2: sigma 4 at an octave's top level is a
    97-tap kernel (``int(6 * 16 + 1)``), wider than a deep octave of a
    598 px side.  The replicate border holds when the pad exceeds the
    side."""
    assert len(tg.gauss_kernel_1d(16.0)) == 97 > max(h, w)
    img = np.random.default_rng(5).uniform(0, 255, (2, h, w)).astype(
        np.float32)
    want = np.asarray(jg.gaussian_blur(jnp.asarray(img), 16.0))
    got = tg.gaussian_blur(torch.as_tensor(img), 16.0).numpy()
    rel_close(want, got, 1e-5)
    want = np.asarray(jss.dog_response(jnp.asarray(img), 4.0))
    got = tss.dog_response(torch.as_tensor(img), 4.0).numpy()
    rel_close(want, got, 1e-5)


PYRAMIDS = {
    "DoG": dict(detector_type="DoG", threshold=8.0),
    "iiDoG": dict(detector_type="DoG", threshold=8.0, ii_dog=True),
    "Harris": dict(detector_type="Harris", threshold=15.0),
    "Hessian on WLD": dict(do_on_wld=True),
    "DoG on WLD": dict(detector_type="DoG", do_on_wld=True),
    "TILDE": dict(detector_type="TILDE"),
}


@pytest.mark.parametrize("name", list(PYRAMIDS))
def test_build_pyramid_against_jax(name):
    imgs = np.stack([textured(72, 90, seed=s) for s in range(2)])
    jo = jss.build_pyramid(jnp.asarray(imgs),
                           jc.PyramidParams(**PYRAMIDS[name]))
    to = tss.build_pyramid(torch.as_tensor(imgs),
                           tc.PyramidParams(**PYRAMIDS[name]))
    assert len(jo) == len(to) == 3
    for a, b in zip(jo, to):
        assert a.sigmas == b.sigmas
        assert a.pixel_distance == b.pixel_distance
        rel_close(np.asarray(a.blurs), b.blurs.numpy(), 1e-5)
        rel_close(np.asarray(a.resps), b.resps.numpy(), 1e-4)
    if "WLD" in name:
        # level 0 of an octave is left unnormalized, as in the reference
        plain = tss.build_pyramid(torch.as_tensor(imgs), tc.PyramidParams(
            **dict(PYRAMIDS[name], do_on_wld=False)))
        assert torch.equal(plain[0].resps[:, 0], to[0].resps[:, 0])
        assert not torch.equal(plain[0].resps[:, 1], to[0].resps[:, 1])


@pytest.mark.parametrize("det_type", ["Hessian", "DoG", "Harris"])
@pytest.mark.parametrize("mode", ["FixedTh", "FixedRegNumber"])
def test_thresholds_square_the_hessian_only(det_type, mode):
    kw = dict(detector_type=det_type, threshold=7.0, detector_mode=mode)
    got = th._thresholds(tc.PyramidParams(**kw))
    assert got == jh._thresholds(jc.PyramidParams(**kw))
    if mode == "FixedTh":
        assert got == (0.8 * 7.0, 49.0 if det_type == "Hessian" else 7.0)


@pytest.mark.parametrize("det,threshold", [("DoG", 8.0), ("Harris", 15.0)])
def test_affine_detector_against_jax(det, threshold):
    """DoG and HarrisAffine: the whole detector (pyramid, NMS,
    localization with their point types, Baumberg, the budget filter)
    over a view batch."""
    imgs, hw = views_and_hw(2, 128, 160)
    caps = dict(per_octave=512, per_view=256)
    p = dict(detector_type=det, threshold=threshold)
    want = jax.jit(lambda v, w: jh.detect_affine_keypoints(
        v, w, jc.PyramidParams(**p), jc.AffineShapeParams(),
        jc.CapacityParams(**caps)))(jnp.asarray(imgs), jnp.asarray(hw))
    got = th.detect_affine_keypoints(
        torch.as_tensor(imgs), torch.as_tensor(hw), tc.PyramidParams(**p),
        tc.AffineShapeParams(), tc.CapacityParams(**caps))
    assert_same_regions(want, got, xy_atol=1e-2, min_count=10)
    subs = set(np.unique(np.asarray(got.sub_type)[np.asarray(got.mask)]))
    types = ({tss.DOG_DARK, tss.DOG_BRIGHT} if det == "DoG"
             else {tss.HARRIS_DARK, tss.HARRIS_BRIGHT})
    assert subs <= types and subs


# ---------------------------------------------------------------------------
# FAST, BRISK


def test_fast_against_jax():
    imgs, hw = views_and_hw()
    caps = dict(per_view=256)
    want = jax.jit(lambda v, w: jcorners.detect_fast(
        v, w, jc.CapacityParams(**caps)))(jnp.asarray(imgs),
                                          jnp.asarray(hw))
    got = tcorners.detect_fast(torch.as_tensor(imgs), torch.as_tensor(hw),
                               tc.CapacityParams(**caps))
    assert_same_regions(want, got, min_count=20)
    np.testing.assert_allclose(got.s.numpy(), 7.0 / 5.1962, rtol=1e-7)


def test_brisk_levels_at_root_two():
    """BRISK is ORB's pyramid at scale factor 1.4142135 over 2 x octaves
    levels: the level sizes ``int(H / sc)`` in Python floats, where
    ORB's 1.2 never left an integer boundary at these shapes."""
    H, W = 150, 171
    n_levels = 6
    sizes = [(max(int(H / 1.4142135 ** lv), 32),
              max(int(W / 1.4142135 ** lv), 32)) for lv in range(n_levels)]
    assert sizes == [(150, 171), (106, 120), (75, 85), (53, 60), (37, 42),
                     (32, 32)]
    seen = []
    real = torb.detect_orb_level

    def spy(imgs, *a, **kw):
        seen.append(tuple(imgs.shape[-2:]))
        return real(imgs, *a, **kw)

    torb.detect_orb_level = spy
    try:
        imgs, hw = views_and_hw(2, H, W)
        kw = dict(n_levels=n_levels, scale_factor=1.4142135,
                  fast_threshold=20.0)
        got = torb.detect_orb(torch.as_tensor(imgs), torch.as_tensor(hw),
                              tc.CapacityParams(per_view=256), **kw)
    finally:
        torb.detect_orb_level = real
    assert seen == sizes
    want = jax.jit(lambda v, w: jorb.detect_orb(
        v, w, jc.CapacityParams(per_view=256), **kw))(jnp.asarray(imgs),
                                                      jnp.asarray(hw))
    assert_same_regions(want, got, xy_atol=1e-3, min_count=20)


# ---------------------------------------------------------------------------
# SURF, STAR


def test_integral_image_and_boxes_against_jax():
    img = textured(64, 80, seed=6) / 255.0
    exact = np.pad(img.astype(np.float64).cumsum(0).cumsum(1), ((1, 0),
                                                               (1, 0)))
    want = np.asarray(jsurf.integral_image(jnp.asarray(img)))
    got = tsurf.integral_image(torch.as_tensor(img)[None])[0].numpy()
    # the port rounds the float64 sums once; XLA sums in float32
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    rel_close(want, got, 1e-6)
    for h, w, dr, dc in ((9, 27, -4, -13), (5, 5, 1, 1), (91, 3, -45, 2)):
        want = np.asarray(jsurf._box(jnp.asarray(jsurf.integral_image(
            jnp.asarray(img))), h, w, dr, dc, 64, 80))
        got = tsurf._box(tsurf.integral_image(torch.as_tensor(img)),
                         h, w, dr, dc, 64, 80).numpy()
        rel_close(want, got, 1e-5)


@pytest.mark.parametrize("filt", [9, 27, 51, 99])
def test_surf_response_layer_against_jax(filt):
    img = textured(72, 96, seed=7) / 255.0
    ii = jsurf.integral_image(jnp.asarray(img))
    want_r, want_l = jsurf.response_layer(ii, filt, 72, 96)
    got_r, got_l = tsurf.response_layer(
        tsurf.integral_image(torch.as_tensor(img)), filt, 72, 96)
    rel_close(np.asarray(want_r), got_r.numpy(), 1e-3)
    # the laplacian's sign agrees wherever the response is not ~0 (flat
    # blocks give a trace of ~0, whose sign is the summation's rounding)
    strong = np.asarray(want_r) > 1e-2 * np.abs(want_r).max()
    assert strong.sum() > 100
    np.testing.assert_array_equal(got_l.numpy()[strong],
                                  np.asarray(want_l)[strong])


def test_surf_quad_interp_against_jax():
    rng = np.random.default_rng(8)
    win = rng.normal(0, 1, (200, 3, 3, 3)).astype(np.float32)
    win[:, 1, 1, 1] += 4.0          # a maximum in most windows
    win[:3] = 0.0                   # singular: no offset
    want_off, want_ok = jsurf._quad_interp(jnp.asarray(win))
    got_off, got_ok = tsurf._quad_interp(torch.as_tensor(win))
    np.testing.assert_array_equal(got_ok.numpy(), np.asarray(want_ok))
    ok = np.asarray(want_ok)
    assert not ok[:3].any() and ok.sum() > 50
    np.testing.assert_allclose(got_off.numpy()[ok],
                               np.asarray(want_off)[ok], atol=1e-5)


# XLA's float32 integral image carries ~1e-4 of a small box sum, which
# the det-of-Hessian and the quadratic fit amplify
SURF_TOL = dict(xy_atol=2e-2, rel=2e-3, min_count=16, resp_rel=1e-3)


@pytest.mark.parametrize("per_octave", [4096, 48])
def test_surf_against_jax(per_octave):
    """``per_octave`` 48 caps each of the 3 octaves' extrema at 16: JAX's
    ``jnp.nonzero(size=)`` cuts in raster order, not by response, and
    the port's ``nonzero_static`` cuts where it does."""
    imgs, hw = views_and_hw()
    caps = dict(per_octave=per_octave, per_view=256)
    want = jax.vmap(lambda v, w: jsurf._detect_one(
        v, w[0], w[1], 3, 0.0004, per_octave))(jnp.asarray(imgs),
                                               jnp.asarray(hw))
    got = tsurf._detect(torch.as_tensor(imgs), torch.as_tensor(hw), 3,
                        0.0004, per_octave)
    assert_same_regions(want, got, **SURF_TOL)
    if per_octave == 48:
        # the cap cuts: uncapped, an octave holds more than 16 extrema
        full = tsurf._detect(torch.as_tensor(imgs), torch.as_tensor(hw), 3,
                             0.0004, 4096)
        n_full = full.mask.reshape(2, 3, -1).sum(-1)
        assert (n_full > 16).any(), n_full
    want = jax.jit(lambda v, w: jsurf.detect_surf(
        v, w, jc.CapacityParams(**caps)))(jnp.asarray(imgs),
                                          jnp.asarray(hw))
    got = tsurf.detect_surf(torch.as_tensor(imgs), torch.as_tensor(hw),
                            tc.CapacityParams(**caps))
    assert_same_regions(want, got, **SURF_TOL)


def test_star_against_jax():
    imgs, hw = views_and_hw()
    caps = dict(per_view=512)
    want = jax.jit(lambda v, w: jcorners.detect_star(
        v, w, jc.CapacityParams(**caps)))(jnp.asarray(imgs),
                                          jnp.asarray(hw))
    got = tcorners.detect_star(torch.as_tensor(imgs), torch.as_tensor(hw),
                               tc.CapacityParams(**caps))
    assert_same_regions(want, got, min_count=50, resp_rel=1e-3)


# ---------------------------------------------------------------------------
# the dispatch and the matcher end to end


def test_every_device_detector_dispatches():
    """``_make_detect_fn`` has a branch for every device detector of the
    JAX package, device MSER included; ReadAffs and External are
    host-stage detectors (``tests/test_torch_plugins.py``)."""
    cfg = tp.EngineConfig(mser=tp.MserParams(backend="device"))
    for det in tp.DEVICE_DETECTORS + ("MSER",):
        assert callable(tp._make_detect_fn(det, cfg))
    assert tp.DEVICE_DETECTORS == jp.DEVICE_DETECTORS
    m = tp.TwoViewMatcher([tc.IterationParams(detector="MSER")], cfg,
                          device="cpu")
    assert m._device_det("MSER")
    assert not any(m._device_det(d) for d in ("ReadAffs", "External"))


def shifted_pair(h=160, w=192, seed=9):
    img1 = textured(h, w, seed)
    return img1, np.roll(img1, (-6, 4), (0, 1))


def matcher_pair(det, cfg_kw=None, ladder=None):
    """The JAX matcher and the port's (on the CPU) with one rung of
    ``det`` and RootSIFT, at small caps."""
    kw = dict(caps=jc.CapacityParams(per_octave=512, per_view=256,
                                     per_image=512, max_angles=2),
              ransac=jc.RansacParams(batch_hypotheses=256, max_rounds=2),
              **(cfg_kw or {}))
    jcfg = jp.EngineConfig(**kw)
    tcfg = tc.from_dict(dataclasses.asdict(jcfg), tp.EngineConfig)
    its = ladder or [dict(detector=det, descriptors=("RootSIFT",),
                          fginn_threshold=(0.9,),
                          distance_threshold=(0.0,))]
    return (jp.TwoViewMatcher([jc.IterationParams(**d) for d in its], jcfg),
            tp.TwoViewMatcher([tc.IterationParams(**d) for d in its], tcfg,
                              device="cpu"))


def assert_matcher_agrees(det, cfg_kw=None):
    img1, img2 = shifted_pair()
    jm, pm = matcher_pair(det, cfg_kw)
    want = jm.match(img1, img2)
    got = pm.match(img1, img2)
    assert want.n_matches >= 10, "the JAX matcher must solve the pair"
    assert got.steps_used == want.steps_used
    assert abs(got.n_tentatives - want.n_tentatives) \
        <= 0.05 * want.n_tentatives
    assert abs(got.n_matches - want.n_matches) <= 0.2 * want.n_matches
    shift = np.median(got.xy2 - got.xy1, axis=0)
    np.testing.assert_allclose(shift, [4.0, -6.0], atol=1.0)
    return want, got


@pytest.mark.parametrize("det", ["DoG", "SURF", "FAST"])
def test_matcher_against_jax(det):
    assert_matcher_agrees(det)


def test_detector_ladder_planned_launches():
    """A two-rung DoG ladder on the CPU calls the two kernels' wrappers
    as often as ``chip_smoke._planned_launches`` reckons (one Baumberg
    an octave of every DoG view group)."""
    import chip_smoke
    calls = {"window_sampler": 0, "baumberg_smm": 0}

    def counting(kernel, fn):
        def wrapped(*a, **kw):
            calls[kernel] += 1
            return fn(*a, **kw)
        return wrapped

    img1, img2 = shifted_pair(96, 128)
    its = [dict(detector="DoG", descriptors=("RootSIFT",),
                fginn_threshold=(0.9,), distance_threshold=(0.0,),
                tilt_set=t, phi_base=360.0)
           for t in ((1.0,), (1.0, 2.0))]
    _, pm = matcher_pair("DoG", ladder=its)
    pm.cfg = dataclasses.replace(pm.cfg, min_matches=10 ** 6)
    real_s, real_b = tp.sample_affine_patches, th.baumberg_adapt
    tp.sample_affine_patches = counting("window_sampler", real_s)
    th.baumberg_adapt = counting("baumberg_smm", real_b)
    try:
        r = pm.match(img1, img2)
    finally:
        tp.sample_affine_patches, th.baumberg_adapt = real_s, real_b
    assert r.steps_used == 2
    assert calls == chip_smoke._planned_launches(
        pm, (img1.shape, img2.shape), 2)
    n_oct = tss.num_octaves(96, 128)
    assert calls["baumberg_smm"] > 2 * n_oct
    assert math.isfinite(r.H.sum())


def test_tentatives_per_rung_against_jax():
    """``chip_smoke.tentatives_per_rung`` reads each rung's tentatives in
    either package (``MatchResult.n_tentatives`` is the best rung's), and
    the port's equal the JAX matcher's within 5 %; ``hold_tentatives``
    holds them to 20 % where JAX has at least ``min_matches``."""
    import chip_smoke
    img1, img2 = shifted_pair()
    its = [dict(detector="SURF", descriptors=("RootSIFT",),
                fginn_threshold=(0.9,), distance_threshold=(0.0,),
                tilt_set=t, phi_base=360.0)
           for t in ((1.0,), (1.0, 2.0))]
    jm, pm = matcher_pair("SURF", {"min_matches": 10 ** 6}, ladder=its)
    want = chip_smoke.tentatives_per_rung(jm)
    got = chip_smoke.tentatives_per_rung(pm)
    rj, rp = jm.match(img1, img2), pm.match(img1, img2)
    want, got = [int(t) for t in want], [int(t) for t in got]
    assert len(want) == len(got) == 2 and want[1] > want[0] > 10
    assert rj.n_tentatives in want and rp.n_tentatives in got
    for w, g in zip(want, got):
        assert abs(g - w) <= 0.05 * w
    chip_smoke.hold_tentatives("cell", got, want, 10)
    chip_smoke.hold_tentatives("cell", [13, 120], [9, 100], 10)
    for bad in ([11, 100], [10, 121]):
        with pytest.raises(RuntimeError, match="cell"):
            chip_smoke.hold_tentatives("cell", bad, [14, 100], 10)


def test_spread_figures_apply_the_rule_seed_by_seed():
    """``chip_smoke.spread_figures``: the share of seeds whose result
    meets the rule of PERF.md section 2 against the JAX matcher's seed
    0, and the means, as phase 9 holds them over seeds."""
    import chip_smoke
    ref = dict(steps=2, matches=13, gt_consistent=13, corner_error_px=40.3)
    outcomes = [[2, 13, 13, 40.3],     # JAX's own
                [2, 14, 0, 261.1],     # a consensus off the ground truth
                [1, 12, 12, 9.0],      # one rung earlier, at the stop count
                [2, 9, 9, 50.0]]       # under the stop count
    got = chip_smoke.spread_figures(outcomes, ref, 10)
    assert got == dict(seeds=4, share_rule=0.5, mean_verified=12.0,
                       mean_within_3px=8.5)
    near = dict(ref, corner_error_px=7.7)
    assert chip_smoke.spread_figures([[2, 13, 13, 8.5], [2, 13, 13, 2.0]],
                                     near, 10)["share_rule"] == 0.5
