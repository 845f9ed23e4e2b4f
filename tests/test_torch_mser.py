"""Port vs JAX reference: the host stage of the MSER rungs (CPU).

* ``detect_msers_np`` / ``detect_msers_padded`` and ``render_group_np``:
  both packages compile the same ``native/*.cpp`` with the same g++
  flags, so on one machine the outputs are equal bit for bit (a
  difference would be a flag or a ctypes signature, not rounding).
* The host render against the port's torch render of the same group:
  < 0.05 grey levels inside the valid extent, the bound that
  ``tests/test_host_render.py`` holds the JAX package's two renders to.
* The host-detector describe stage (device render + ``_make_desc_fn`` at
  K = ``host_cap``) on the JAX side's MSER regions: the tolerance of
  ``test_torch_ladder.py``'s describe stage (rows atol 1 on >= 99 %,
  geometry atol 2e-3).
* ``clahe_np``: to 1e-5 (the same float32 numpy code).
* ``TwoViewMatcher.match(device="cpu")`` with MSER rungs against the JAX
  matcher on the textured shift pair of ``test_torch_ladder.py``: an MSER
  rung with CLAHE on, and a rung of MSER and HessianAffine together
  followed by one whose plan keeps MSER's tentatives of the rung before
  (the CVIU ladder's rungs 4-6).  The tolerances of that file's
  end-to-end test: same ``steps_used``, verified within 20 %, H within
  1 px at the corners (for the second ladder over the verified matches,
  1 px in the median and 3 px at worst: its 270 inliers within 3 px leave
  the corners uncertain by several px).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from mods_tpu import config as jax_config
from mods_tpu import pipeline as jp
from mods_tpu import synthesis as jsyn
from mods_tpu.config import IterationParams as JaxIteration
from mods_tpu.detectors import mser as jm
from mods_tpu.ops import clahe as jc
from mods_tpu.ops import host_render as jr
from mods_tpu_torch import config as tc
from mods_tpu_torch import pipeline as tp
from mods_tpu_torch.detectors import mser as tm
from mods_tpu_torch.ops import clahe as tcl
from mods_tpu_torch.ops import host_render as tr
from test_mser import blob_image
from test_torch_ladder import (SHIFT, SQUASH, _case, _corners, _jax_cfg,
                               _ladder, _port_matcher, _sorted_store,
                               count_launches)

torch.set_num_threads(2)


def _block_image(h=160, w=224, seed=0):
    """Blocks of random grey: many extremal regions, as real scenes give."""
    rng = np.random.default_rng(seed)
    b = np.kron(rng.uniform(0, 255, (h // 10 + 1, w // 10 + 1)),
                np.ones((10, 10)))[:h, :w]
    return np.clip(ndimage.gaussian_filter(b, 1.0)
                   + rng.uniform(0, 4, b.shape), 0, 255).astype(np.float32)


@pytest.mark.parametrize("which", ["blobs", "blocks"])
def test_detect_msers_equal_jax_bit_for_bit(which):
    if which == "blobs":
        img, kw = blob_image(), dict(min_size=30, max_area=0.25,
                                     min_margin=8)
    else:
        img, kw = _block_image(seed=3), dict(min_size=30, max_area=0.05,
                                             min_margin=8)
    a = tm.detect_msers_np(img, **kw)
    b = jm.detect_msers_np(img, **kw)
    assert len(a["xy"]) >= 3
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype
    # padded slots: the strongest by margin first, cut at the cap
    cap = max(len(a["xy"]) // 2, 1)
    hw = np.asarray(img.shape, np.int32) - [5, 9]
    pa = tm.detect_msers_padded(img, hw, tc.CapacityParams(per_view=cap),
                                **kw)
    from mods_tpu.config import CapacityParams
    pb = jm.detect_msers_padded(img, hw, CapacityParams(per_view=cap), **kw)
    assert set(pa) == set(pb) and pa["mask"].sum() == cap
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def test_native_build_is_the_ports_own():
    tm._lib()
    tr._lib()
    assert tm.BUILD_DIR.startswith(tm._PKG)
    assert "_build" in tm.BUILD_DIR
    assert tr.omp_max_threads() >= 1


def _groups(img, tilt, zoom):
    it = JaxIteration(tilt_set=(tilt,), scale_set=(zoom,), phi_base=360.0)
    views, _ = jsyn.expand_views(it, [])
    plans = [jsyn.plan_view(v, img.shape[1], img.shape[0]) for v in views]
    return jsyn.group_views(plans)


def _rot_inv(group):
    out = []
    for p in group:
        a, b, tx, c, d, ty = p.rot
        det = a * d - b * c
        ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
        out.append([[ia, ib, -(ia * tx + ib * ty)],
                    [ic, id_, -(ic * tx + id_ * ty)]])
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("tilt,zoom", [(1.0, 1.0), (4.0, 1.0),
                                       (1.0, 0.25), (3.0, 0.5)])
def test_render_group_np_equals_jax_and_the_torch_render(tilt, zoom):
    img = ndimage.gaussian_filter(
        np.random.default_rng(1).uniform(0, 255, (96, 120)), 1.0
    ).astype(np.float32)
    h, w = img.shape
    for group in _groups(img, tilt, zoom):
        p0 = group[0]
        V = len(group)
        hr = 0 if p0.identity else max(p.h_rot for p in group)
        wr = 0 if p0.identity else max(p.w_rot for p in group)
        hc = -(-max(p.h_new for p in group) // 128) * 128
        wc = -(-max(p.w_new for p in group) // 128) * 128
        valid = np.asarray([[p.h_new, p.w_new] for p in group], np.int32)
        rot = (np.zeros((V, 2, 3), np.float32) if p0.identity
               else _rot_inv(group))
        args = (img, rot, hr, wr, p0.view.do_blur, p0.sigma_x, p0.sigma_y,
                p0.tilt_scale[0], p0.tilt_scale[1], valid, hc, wc,
                p0.identity)
        host = tr.render_group_np(*args)
        np.testing.assert_array_equal(host, jr.render_group_np(*args))
        # the port's device render of the same group (torch, CPU)
        sx, sy = p0.tilt_scale
        render = tp._make_render_fn(V, h, w, hr, wr, hc, wc,
                                    p0.view.do_blur, p0.identity)
        dev = render(torch.from_numpy(img), torch.from_numpy(rot),
                     torch.tensor([[1 / sx, 0, 0], [0, 1 / sy, 0]]),
                     torch.tensor(p0.sigma_x), torch.tensor(p0.sigma_y),
                     torch.from_numpy(valid)).numpy()
        for v, p in enumerate(group):
            d = np.abs(host[v, :p.h_new, :p.w_new]
                       - dev[v, :p.h_new, :p.w_new]).max()
            assert d < 0.05, (tilt, zoom, v, d)


def test_hostdet_describe_stage_against_jax():
    """One tilt-4 group (two views): the JAX matcher's host stage finds
    the MSER regions; its hostdet program and the port's render +
    ``_make_desc_fn`` at K = 512 describe them; the stores agree."""
    img = _block_image(seed=5)
    h, w = img.shape
    from mods_tpu.config import CapacityParams
    caps = dict(per_view=512, per_group=256, per_image=1024, max_angles=2)
    jcfg = jp.EngineConfig(caps=CapacityParams(**caps))
    jit_ = JaxIteration(detector="MSER", tilt_set=(4.0,), phi_base=360.0)
    jm_ = jp.TwoViewMatcher([jit_], jcfg)
    _, (jg,) = jm_._prep_groups(jit_, h, w, [])
    V, Vb = jg["V"], jg["Vb"]
    assert V == 2
    regs = jm_._host_stage_regions(
        "MSER", img, jg["group"], jg["rot_inv_np"][:V], jg["hr"], jg["wr"],
        jg["hc"], jg["wc"], jp.TimeLog(), 0)
    assert regs["mask"].sum() > 20
    pad = {k: np.concatenate([a, np.zeros((Vb - V,) + a.shape[1:], a.dtype)])
           for k, a in regs.items()}
    specs = jm_._specs(jit_)
    jst = tuple(jp.DeviceStore(caps["per_image"], sp.dim).buffers()
                for sp in specs)
    jout = jg["program"](
        jnp.asarray(img), jg["rot_inv"], jg["squash_inv"], jg["sig_x"],
        jg["sig_y"], jg["valid_hw"], *[jnp.asarray(pad[k]) for k in (
            "xy", "A", "s", "response", "mask")], jg["hinv"], jst)

    tcfg = tc.from_dict(dataclasses.asdict(jcfg))
    tit = tc.IterationParams(detector="MSER", tilt_set=(4.0,),
                             phi_base=360.0)
    m = tp.TwoViewMatcher([tit], tcfg, device="cpu")
    _, (gp,) = m._prep_groups(tit, h, w, [])
    assert gp["detect"] is None and (gp["V"], gp["Vb"]) == (V, Vb)
    for k in ("hr", "wr", "hc", "wc"):
        assert gp[k] == jg[k], k
    # the port's host stage finds the same regions, then the same slab
    # goes through the port's device render and describe stage
    mine = m._host_stage_regions("MSER", img, gp["group"],
                                 gp["rot_inv_np"][:V], gp["hr"], gp["wr"],
                                 gp["hc"], gp["wc"], tp.TimeLog())
    for k in regs:
        np.testing.assert_array_equal(mine[k], regs[k], err_msg=k)
    stores = {}
    m._process_image(torch.from_numpy(img), tit, [], stores, tp.TimeLog(),
                     img_np=img)
    assert m.host_stage["inline_s"] > 0
    (tst,) = stores.values()
    n = int(jout[0][5])
    assert tst.count == n and n > 20
    a = _sorted_store(*jout[0])
    b = _sorted_store(tst._xy, tst._A, tst._s, tst._r, tst._d, tst._n)
    np.testing.assert_allclose(b[:, :8], a[:, :8], atol=2e-3, rtol=1e-5)
    dd = np.abs(b[:, 8:] - a[:, 8:])
    assert (dd.max(1) <= 1.0).mean() >= 0.99
    assert dd.mean() < 0.05


def test_clahe_np_against_jax():
    img = _block_image(131, 173, seed=2) * 0.4 + 60.0
    np.testing.assert_allclose(tcl.clahe_np(img, clip_limit=4.0),
                               jc.clahe_np(img, clip_limit=4.0), atol=1e-5)
    out = tcl.clahe_np(img, clip_limit=2.0, tiles_x=4, tiles_y=6)
    np.testing.assert_allclose(
        out, jc.clahe_np(img, clip_limit=2.0, tiles_x=4, tiles_y=6),
        atol=1e-5)
    assert out.dtype == np.float32 and out.shape == img.shape
    assert out.std() > img.std()


# ---------------------------------------------------------------------------
# MSER rungs end to end

MSER = dict(detector="MSER")
SEPARATE = dict(separate_detectors=("MSER", "HessianAffine"),
                separate_descriptors=("RootSIFT",))
MSER_HESAFF = [([MSER, dict()], SEPARATE),
               ([dict(tilt_set=(1.0, 4.0), phi_base=360.0)], SEPARATE)]
# as test_torch_ladder.CASES: (seed, (h, w), H, ladder, EngineConfig kw)
CASES = {
    "mser_clahe": (0, (192, 256), SHIFT, [MSER], dict(do_clahe=True)),
    # both rungs run (no rung reaches the stop count), and rung 1 matches
    # MSER's stale tentatives of rung 0 beside its own
    "mser_hesaff": (0, (192, 256), SHIFT, MSER_HESAFF,
                    dict(min_matches=10 ** 6)),
    # rung 0 stays under 25 matches, rung 1 stops the ladder
    "mser_hesaff_tilted": (7, (160, 224), SQUASH, MSER_HESAFF,
                           dict(min_matches=25)),
}


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for name in ("mser_clahe", "mser_hesaff"):
        img1, img2, _, ladder = _case(name, CASES)
        m = jp.TwoViewMatcher(_ladder(jax_config, ladder),
                              _jax_cfg(**CASES[name][4]))
        out[name] = m.match(img1, img2)
    return out


def _apply(H, xy):
    p = np.c_[xy, np.ones(len(xy))] @ np.asarray(H, np.float64).T
    return p[:, :2] / p[:, 2:]


@pytest.mark.parametrize("name", ["mser_clahe", "mser_hesaff"])
def test_mser_matcher_against_jax(name, jax_results):
    img1, img2, H, ladder = _case(name, CASES)
    ref = jax_results[name]
    got = _port_matcher(ladder, CASES[name][4]).match(img1, img2)
    assert ref.n_matches >= 10
    assert got.steps_used == ref.steps_used
    assert abs(got.n_matches - ref.n_matches) <= 0.2 * ref.n_matches
    assert got.xy1.shape == (got.n_matches, 2)
    h, w = img1.shape
    if name == "mser_clahe":
        assert np.abs(_corners(got.H, w, h)
                      - _corners(ref.H, w, h)).max() < 1.0
    else:
        # 270 inliers within 3 px (Sampson) admit H's 3-8 px apart at the
        # corners: the JAX matcher's own H moves that far between RANSAC
        # sizes on this pair.  Held where the matches are instead: 1 px
        # in the median, the RANSAC threshold at worst.
        d = np.abs(_apply(got.H, got.xy1) - _apply(ref.H, got.xy1)).max(1)
        assert np.median(d) < 1.0 and d.max() < 3.0
    assert np.abs(_corners(got.H, w, h) - _corners(H, w, h)).max() < 6.0


def test_pipelined_stop_mode_matches_sync():
    """On the CPU every rung's verification has finished when the next
    rung starts, so ``pipelined`` stops where ``sync`` does."""
    img1, img2, _, ladder = _case("mser_hesaff_tilted", CASES)
    kw = CASES["mser_hesaff_tilted"][4]
    ms = _port_matcher(ladder, kw, seed=3).match(img1, img2)
    mp = _port_matcher(ladder, kw, seed=3,
                       stop_mode="pipelined").match(img1, img2)
    assert mp.steps_used == ms.steps_used == 2
    assert mp.n_matches == ms.n_matches >= 25
    np.testing.assert_array_equal(mp.xy1, ms.xy1)
    np.testing.assert_allclose(mp.H, ms.H)


def test_mser_prefetch_is_consumed():
    """``match`` prefetches every MSER group of the rungs it runs and
    consumes each job once: none runs inline, none is left pending."""
    img1, img2, _, ladder = _case("mser_hesaff_tilted", CASES)
    m = _port_matcher(ladder, CASES["mser_hesaff_tilted"][4])
    m.match(img1, img2)
    assert m.host_stage["job_s"] > 0 and m.host_stage["inline_s"] == 0
    assert m._host_futures == {} and m._host_jobs == {}
    m.close()
    assert m._host_pool is None


def test_mser_jobs_wait_for_the_rung_before():
    """A rung's MSER jobs are submitted when the rung before it starts: a
    pair that stops at rung 1 of 3 runs none of rung 3's."""
    img1, img2, _, _ = _case("identity")
    ladder = [dict(tilt_set=(1.0,)), dict(tilt_set=(1.0,)), MSER]
    m = _port_matcher(ladder)
    assert m.match(img1, img2).steps_used == 1
    assert m._host_pool is None and m._host_futures == {}
    assert m.host_stage == dict(job_s=0.0, wait_s=0.0, inline_s=0.0)


def test_planned_launches_of_mser_rungs(monkeypatch):
    """A host-stage group launches no ``baumberg_smm`` and the same
    ``window_sampler`` calls per descriptor family as a device group."""
    img1, img2, _, ladder = _case("mser_hesaff_tilted", CASES)
    ladder = ladder + [dict(MSER, tilt_set=(1.0, 2.0), phi_base=360.0)]
    calls = count_launches(img1, img2, ladder, {}, monkeypatch)
    assert calls["baumberg_smm"] > 0
