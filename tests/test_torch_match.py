"""Port vs JAX reference: FGINN matching, the duplicate filter and
LO-RANSAC H (CPU).

FGINN runs on integer descriptors (0..255, as SIFT quantizes them):
squared distances are exact in float32 (128 * 255^2 < 2^24), so the
neighbour lists and decisions must be identical, ties included.  The
RANSAC fit and error functions are held to float32 rounding: rtol 1e-5
on closed forms, 1e-4 on squared errors (differences of near-equal
coordinates), 1e-3 on eigenvector fits.  ``ransac_h`` draws from
another random stream than ``jax.random``, so it is held on outcomes:
the H within 0.5 px at the image corners and the same inlier set on
data with clear inliers.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mods_tpu.config import RansacParams
from mods_tpu.matching import fginn as jf
from mods_tpu.ransac import errors as je
from mods_tpu.ransac import homography as jhm
from mods_tpu_torch import config as tc
from mods_tpu_torch.matching import fginn as tf
from mods_tpu_torch.ransac import errors as te
from mods_tpu_torch.ransac import homography as thm
from test_knobs import _fginn_setup as knobs_fginn_setup

torch.set_num_threads(2)


def _descs(seed, n1, n2):
    rng = np.random.default_rng(seed)
    d2 = rng.integers(0, 256, (n2, 128)).astype(np.float32)
    # list1: noisy copies of list2 rows plus distractors and exact
    # duplicates of one row (ties in the neighbour list)
    src = rng.integers(0, n2, n1)
    d1 = np.clip(d2[src] + rng.integers(-12, 13, (n1, 128)), 0, 255)
    d1[: n1 // 4] = rng.integers(0, 256, (n1 // 4, 128))
    d2[5] = d2[6] = d2[7]
    return d1.astype(np.float32), d2, src


def test_knn_and_fginn_exact():
    d1, d2, _ = _descs(0, 300, 260)
    rng = np.random.default_rng(1)
    m1 = rng.uniform(size=300) < 0.95
    m2 = rng.uniform(size=260) < 0.95
    xy2 = rng.uniform(0, 60, (260, 2)).astype(np.float32)
    jd, ji = jf.knn_squared_l2(*(jnp.asarray(x) for x in (d1, m1, d2, m2)),
                               50, row_tile=128)
    td, ti = tf.knn_squared_l2(*(torch.from_numpy(x) for x in
                                 (d1, m1, d2, m2)), 50, row_tile=128)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    for std2 in (False, True):
        jt = jf.match_fginn(*(jnp.asarray(x) for x in (d1, m1, d2, m2, xy2)),
                            0.8, 10.0, 50, standard_2nd=std2)
        tt = tf.match_fginn(*(torch.from_numpy(x) for x in
                              (d1, m1, d2, m2, xy2)), 0.8, 10.0, 50,
                            standard_2nd=std2)
        for f in ("idx2", "d1", "d2", "ratio", "mask"):
            np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                          np.asarray(getattr(jt, f)))
        assert int(tt.count()) == int(jt.count()) > 50


@pytest.mark.parametrize("with_priority", [False, True])
def test_duplicate_filter_exact(with_priority):
    rng = np.random.default_rng(2)
    n = 200
    xy1 = rng.uniform(0, 40, (n, 2)).astype(np.float32)
    xy2 = rng.uniform(0, 40, (n, 2)).astype(np.float32)
    xy1[100:140] = xy1[60:100] + rng.uniform(-2, 2, (40, 2))
    xy2[100:140] = xy2[60:100] + rng.uniform(-2, 2, (40, 2))
    mask = rng.uniform(size=n) < 0.9
    pr = rng.uniform(size=n).astype(np.float32) if with_priority else None
    ref = jf.duplicate_filter(jnp.asarray(xy1), jnp.asarray(xy2),
                              jnp.asarray(mask), 3.0,
                              priority=None if pr is None
                              else jnp.asarray(pr))
    got = tf.duplicate_filter(torch.from_numpy(xy1), torch.from_numpy(xy2),
                              torch.from_numpy(mask), 3.0,
                              priority=None if pr is None
                              else torch.from_numpy(pr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.sum() < mask.sum()


def _homography(seed):
    rng = np.random.default_rng(seed)
    H = np.eye(3) + rng.normal(0, [[0.1, 0.1, 8], [0.1, 0.1, 8],
                                   [1e-4, 1e-4, 0]])
    return H.astype(np.float32)


def _correspondences(seed, n, inlier_frac):
    rng = np.random.default_rng(seed)
    H = _homography(seed)
    xy1 = rng.uniform(0, 400, (n, 2))
    p = np.c_[xy1, np.ones(n)] @ H.T.astype(np.float64)
    xy2 = p[:, :2] / p[:, 2:]
    xy2 += rng.normal(0, 0.3, xy2.shape)
    out = rng.uniform(size=n) > inlier_frac
    xy2[out] = rng.uniform(0, 400, (out.sum(), 2))
    mask = rng.uniform(size=n) < 0.97
    return (xy1.astype(np.float32), xy2.astype(np.float32), mask, H,
            ~out & mask)


def test_error_and_fit_functions():
    xy1, xy2, mask, H, _ = _correspondences(3, 64, 0.7)
    Hs = np.stack([_homography(s) for s in range(8)])
    j = [jnp.asarray(x) for x in (Hs, xy1, xy2)]
    t = [torch.from_numpy(x) for x in (Hs, xy1, xy2)]
    np.testing.assert_allclose(te.inv_3x3(t[0]).numpy(),
                               np.asarray(je.inv_3x3(j[0])), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(te.h_transfer(t[0], t[1]).numpy(),
                               np.asarray(je.h_transfer(j[0], j[1])),
                               rtol=1e-5)
    for mode in ("sum", "max"):
        np.testing.assert_allclose(
            te.h_error_symm(*t, mode=mode).numpy(),
            np.asarray(je.h_error_symm(*j, mode=mode)), rtol=1e-4,
            atol=1e-4)
    np.testing.assert_allclose(te.h_error_sampson(*t).numpy(),
                               np.asarray(je.h_error_sampson(*j)),
                               rtol=1e-4, atol=1e-4)
    tm = torch.from_numpy(mask)
    T1 = thm._normalization(t[1], tm)
    np.testing.assert_allclose(
        T1.numpy(), np.asarray(jhm._normalization(j[1], jnp.asarray(mask))),
        rtol=1e-5, atol=1e-6)
    p1 = thm._apply_T(T1, t[1])
    p2 = thm._apply_T(thm._normalization(t[2], tm), t[2])
    jp1, jp2 = jnp.asarray(p1.numpy()), jnp.asarray(p2.numpy())
    np.testing.assert_array_equal(thm._dlt_rows(p1, p2).numpy(),
                                  np.asarray(jhm._dlt_rows(jp1, jp2)))

    # the eigenvector's sign is arbitrary: compare H / H[2, 2].  A fit's
    # float32 error grows as eps over the gap between the two smallest
    # eigenvalues of the normal matrix, so the minimal fits are compared
    # on samples of 4 distinct points whose gap (float64) is > 1e-3 of
    # the largest eigenvalue; RANSAC scores the others no differently.
    def norm(h):
        h = np.asarray(h, np.float64)
        return h / h[..., 2:3, 2:3]
    idx = np.random.default_rng(4).integers(0, 64, (64, 4))
    rows = thm._dlt_rows(p1[idx], p2[idx]).reshape(64, 8, 9).double()
    ev = np.linalg.eigvalsh((rows.transpose(1, 2) @ rows).numpy())
    distinct = np.array([len(set(r)) == 4 for r in idx])
    idx = idx[distinct & (ev[:, 1] > 1e-3 * ev[:, -1])]
    assert len(idx) >= 16
    np.testing.assert_allclose(
        norm(thm._fit_h(p1[idx], p2[idx]).numpy()),
        norm(jhm._fit_h(jp1[idx], jp2[idx])), rtol=1e-3, atol=1e-3)
    w = np.random.default_rng(5).uniform(size=(3, 64)).astype(np.float32)
    np.testing.assert_allclose(
        norm(thm._weighted_fit_h(p1, p2, torch.from_numpy(w)).numpy()),
        norm(jhm._weighted_fit_h(jp1, jp2, jnp.asarray(w))), rtol=1e-3,
        atol=1e-3)


def _corner_dist(Ha, Hb, w=400, h=400):
    c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], np.float64)
    pa = c @ np.asarray(Ha, np.float64).T
    pb = c @ np.asarray(Hb, np.float64).T
    return np.abs(pa[:, :2] / pa[:, 2:] - pb[:, :2] / pb[:, 2:]).max()


def test_ransac_h_outcome():
    xy1, xy2, mask, H, true_inl = _correspondences(6, 300, 0.7)
    pars = RansacParams(batch_hypotheses=256, max_rounds=8)
    tp = tc.from_dict(dataclasses.asdict(pars), tc.RansacParams)
    jH, jinl, jn = jax.jit(lambda a, b, m, k: jhm.ransac_h(
        a, b, m, pars, k))(jnp.asarray(xy1), jnp.asarray(xy2),
                           jnp.asarray(mask), jax.random.PRNGKey(0))
    tH, tinl, tn = thm.ransac_h(torch.from_numpy(xy1),
                                torch.from_numpy(xy2),
                                torch.from_numpy(mask), tp,
                                torch.Generator().manual_seed(0))
    assert _corner_dist(tH.numpy(), jH) < 0.5
    assert _corner_dist(tH.numpy(), H) < 2.0
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tn) == int(jn) >= 0.9 * true_inl.sum()


# ---------------------------------------------------------------------------
# the ladder's matching and verification pieces

def _bits(seed, n1, n2):
    """ORB-like 0/1 descriptors: list1 rows are list2 rows with a few
    flipped bits, plus distractors."""
    rng = np.random.default_rng(seed)
    d2 = (rng.uniform(size=(n2, 256)) < 0.5).astype(np.float32)
    d1 = d2[rng.integers(0, n2, n1)].copy()
    flips = rng.uniform(size=d1.shape) < rng.uniform(0, 0.3, (n1, 1))
    d1 = np.where(flips, 1.0 - d1, d1).astype(np.float32)
    return d1, d2


@pytest.mark.parametrize("binary", [True, False])
def test_match_distance_exact(binary):
    """Hamming distances through a float product are exact integers
    (TF32 off), so the decisions against the budget of 60 are equal."""
    if binary:
        d1, d2 = _bits(10, 240, 200)
        thr = 60.0
    else:
        d1, d2, _ = _descs(10, 240, 200)
        thr = 150.0
    rng = np.random.default_rng(11)
    m1 = rng.uniform(size=240) < 0.9
    m2 = rng.uniform(size=200) < 0.9
    jt = jf.match_distance(*(jnp.asarray(x) for x in (d1, m1, d2, m2)),
                           thr, squared_threshold=binary)
    tt = tf.match_distance(*(torch.from_numpy(x) for x in (d1, m1, d2, m2)),
                           thr, squared_threshold=binary)
    for f in ("idx2", "d1", "d2", "mask"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      np.asarray(getattr(jt, f)))
    np.testing.assert_allclose(tt.ratio.numpy(), np.asarray(jt.ratio),
                               rtol=1e-6)
    assert 30 < int(tt.count()) < int(m1.sum())


@pytest.mark.parametrize("case", ["equal", "near_1e3", "ratios"])
def test_duplicate_filter_priority_ties(case):
    """The ladder passes a priority (FGINN ratio, distance, -scale).  The
    JAX rule adds ``arange * 1e-9`` to break ties, which vanishes in
    float32 beside values near 1e3 and beside equal values above ~0.02:
    then neither of two equal duplicates beats the other and both stay.
    The port copies the rule, so the results are equal."""
    rng = np.random.default_rng(12)
    n = 160
    xy1 = rng.uniform(0, 30, (n, 2)).astype(np.float32)
    xy2 = rng.uniform(0, 30, (n, 2)).astype(np.float32)
    xy1[80:120] = xy1[40:80] + rng.uniform(-1.5, 1.5, (40, 2))
    xy2[80:120] = xy2[40:80] + rng.uniform(-1.5, 1.5, (40, 2))
    mask = rng.uniform(size=n) < 0.92
    if case == "equal":
        pr = np.full(n, 0.5, np.float32)
    elif case == "near_1e3":
        pr = (1000.0 + rng.integers(0, 3, n)).astype(np.float32)
    else:
        pr = rng.uniform(0.2, 0.8, n).astype(np.float32)
        pr[80:120] = pr[40:80]                      # ties among duplicates
    ref = np.asarray(jf.duplicate_filter(
        jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(mask), 3.0,
        priority=jnp.asarray(pr)))
    got = tf.duplicate_filter(
        torch.from_numpy(xy1), torch.from_numpy(xy2),
        torch.from_numpy(mask), 3.0, priority=torch.from_numpy(pr)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() < mask.sum()
    if case == "near_1e3":
        # the 1e-9 steps vanish beside 1e3: of two duplicates with the
        # same priority neither beats the other, and both stay
        pr32 = (pr + np.arange(n, dtype=np.float32) * np.float32(1e-9))
        np.testing.assert_array_equal(pr32, pr)
        i = np.arange(40, 80)
        both = mask[i] & mask[i + 40] & (pr[i] == pr[i + 40])
        assert both.sum() > 3


def _store_parts(seed, cap, n, binary):
    rng = np.random.default_rng(seed)
    d = ((rng.uniform(size=(cap, 256)) < 0.5).astype(np.float32) if binary
         else rng.integers(0, 256, (cap, 128)).astype(np.float32))
    th = rng.uniform(0, 6.28, cap)
    A = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                  np.stack([np.sin(th), np.cos(th)], -1)], -2)
    return (rng.uniform(0, 300, (cap, 2)).astype(np.float32),
            A.astype(np.float32), rng.uniform(2, 9, cap).astype(np.float32),
            d, np.int32(n))


@pytest.mark.parametrize("dup_mode,binary", [("random", False),
                                             ("fginn", False),
                                             ("distance", True),
                                             ("bigger_region", True)])
def test_pool_match_parts_and_compaction(dup_mode, binary):
    from mods_tpu import pipeline as jp
    from mods_tpu_torch import pipeline as tp
    cap = 96
    p1 = [_store_parts(20, cap, 70, binary), _store_parts(21, cap, 40, binary)]
    p2 = [_store_parts(22, cap, 80, binary)]
    # make list1 rows near copies of list2 rows, so that matches exist
    for part in p1:
        src = np.random.default_rng(23).integers(0, 80, cap)
        part[3][:] = p2[0][3][src]
        if not binary:
            part[3][:, :8] += 3.0
    args = (0.8, 60.0 if binary else 200.0, None, cap, 20, 10.0, dup_mode,
            not binary, True, binary, False)
    jouts = jp._pool_match_parts(
        [tuple(jnp.asarray(a) for a in p) for p in p1],
        [tuple(jnp.asarray(a) for a in p) for p in p2], *args)
    touts = tp._pool_match_parts(
        [tuple(torch.as_tensor(a) for a in p) for p in p1],
        [tuple(torch.as_tensor(a) for a in p) for p in p2], *args)
    assert len(touts) == len(jouts) == (1 if binary else 2)
    for jo, to in zip(jouts, touts):
        m = np.asarray(jo["mask"])
        np.testing.assert_array_equal(to["mask"].numpy(), m)
        assert m.sum() > 20
        for k in ("xy1", "A1", "s1", "xy2", "A2", "s2"):
            np.testing.assert_array_equal(to[k].numpy()[m],
                                          np.asarray(jo[k])[m])
        np.testing.assert_allclose(to["prio"].numpy()[m],
                                   np.asarray(jo["prio"])[m], rtol=1e-6)
    for tcap in (64, 512):                   # over and under the capacity
        jc = jp._concat_compact_parts(jouts, tcap)
        tcm = tp._concat_compact_parts(touts, tcap)
        for k in jc:
            np.testing.assert_allclose(tcm[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6)
    if not binary:
        # the FGINN+DB branch: a database holding list1's own rows is an
        # impostor at distance 0 for each of them, so nothing matches
        db = (p1[0][3], np.ones(cap, bool))
        dargs = (0.8, 0.0, None, cap, 20, 10.0, dup_mode, True, False,
                 False, False)
        jd = jp._pool_match_parts(
            [tuple(jnp.asarray(a) for a in p) for p in p1],
            [tuple(jnp.asarray(a) for a in p) for p in p2], *dargs[:2],
            tuple(jnp.asarray(a) for a in db), *dargs[3:])
        td = tp._pool_match_parts(
            [tuple(torch.as_tensor(a) for a in p) for p in p1],
            [tuple(torch.as_tensor(a) for a in p) for p in p2], *dargs[:2],
            tuple(torch.as_tensor(a) for a in db), *dargs[3:])
        m = np.asarray(jd[0]["mask"])
        np.testing.assert_array_equal(td[0]["mask"].numpy(), m)
        assert not m[:cap].any()


def test_h_laf_check_and_gt_inliers():
    from mods_tpu.ransac.laf_check import K_SIGMA as JK
    from mods_tpu.ransac.laf_check import h_laf_check as jax_laf
    from mods_tpu.verify import gt_h_inliers as jax_gt
    from mods_tpu_torch.ransac.laf_check import K_SIGMA, h_laf_check
    from mods_tpu_torch.verify import gt_h_inliers, load_h_file
    assert K_SIGMA == JK
    xy1, xy2, mask, H, _ = _correspondences(30, 200, 0.7)
    rng = np.random.default_rng(31)
    xy1b, A1, s1, _, _ = _store_parts(32, 200, 200, True)
    # frames of image 2 = H's local affine map of image 1's, some perturbed
    lin = H[:2, :2].astype(np.float32)
    A2 = lin @ A1
    det = np.sqrt(np.abs(np.linalg.det(A2)))
    A2 = (A2 / det[:, None, None]).astype(np.float32)
    s2 = (s1 * det * rng.choice([1.0, 1.0, 1.0, 3.0], 200)).astype(np.float32)
    j = [jnp.asarray(x) for x in (H, xy1, A1, s1, xy2, A2, s2, mask)]
    t = [torch.from_numpy(x) for x in (H, xy1, A1, s1, xy2, A2, s2, mask)]
    for thr in (60.0, 15.0, 0.0):
        ref = np.asarray(jax_laf(*j, thr))
        got = h_laf_check(*t, thr).numpy()
        np.testing.assert_array_equal(got, ref)
    assert 20 < np.asarray(jax_laf(*j, 60.0)).sum() < mask.sum()
    for et in ("sampson", "symm_sum", "symm_max"):
        ref = np.asarray(jax_gt(jnp.asarray(H), j[1], j[4], j[7], 3.0, et))
        got = gt_h_inliers(H, t[1], t[4], t[7], 3.0, et).numpy()
        np.testing.assert_array_equal(got, ref)
        assert 100 < got.sum() < mask.sum()
    import os
    h_file = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".parity_work", "tilt4_H.txt")
    assert load_h_file(h_file).shape == (3, 3)


def _fginn_setup():
    """list2 holds two near-identical descriptors at nearby positions plus
    distant distractors (``tests/test_knobs.py::_fginn_setup``)."""
    return [np.asarray(a) for a in knobs_fginn_setup()]


@pytest.mark.parametrize("impostor", [True, False])
def test_fginn_db_against_jax(impostor):
    """FGINN+DB (``tests/test_knobs.py:60``): a database impostor as close
    as the true match rejects it; an irrelevant database changes
    nothing.  The decisions and ratios equal JAX's."""
    desc1, m1, desc2, m2, xy2 = _fginn_setup()
    if impostor:
        db = desc1[:1]
    else:
        v = np.arange(1.0, 9.0, dtype=np.float32)
        db = (v / np.linalg.norm(v))[None]
    dbm = np.ones(1, bool)
    t = tf.match_fginn(*[torch.from_numpy(a) for a in (desc1, m1, desc2,
                                                       m2, xy2)],
                       0.8, 10.0, knn=8,
                       db=(torch.from_numpy(db), torch.from_numpy(dbm)))
    j = jf.match_fginn(*[jnp.asarray(a) for a in (desc1, m1, desc2, m2,
                                                  xy2)],
                       0.8, 10.0, knn=8, db=(jnp.asarray(db),
                                             jnp.asarray(dbm)))
    assert bool(t.mask[0]) == bool(j.mask[0]) == (not impostor)
    np.testing.assert_allclose(t.ratio.numpy(), np.asarray(j.ratio),
                               rtol=1e-5)


def test_matcher_loads_the_fginn_db(tmp_path):
    """``TwoViewMatcher._fginn_db``: the [Matching] SIFTDBfile rows, padded
    to a power-of-two row count as the JAX matcher pads them, for RootSIFT
    only, cached until the file changes."""
    from mods_tpu import pipeline as jp
    from mods_tpu.config import MatchParams
    from mods_tpu_torch import pipeline as tp
    rows = np.random.default_rng(0).uniform(0, 1, (200, 128))
    path = tmp_path / "db.txt"
    np.savetxt(path, rows)
    match = MatchParams(use_db_for_fginn=True, sift_db_file=str(path))
    jm = jp.TwoViewMatcher(cfg=jp.EngineConfig(match=match))
    tm = tp.TwoViewMatcher(cfg=tp.EngineConfig(
        match=tc.from_dict(dataclasses.asdict(match), tc.MatchParams)),
        device="cpu")
    for name in ("RootSIFT", "SIFT"):
        jdb = jm._fginn_db(jp.spec_for(name, jm.cfg))
        tdb = tm._fginn_db(tp.spec_for(name))
        if name == "SIFT":
            assert jdb is None and tdb is None
            continue
        assert tdb[0].shape == (256, 128)
        np.testing.assert_array_equal(tdb[0].numpy(), jdb[0])
        np.testing.assert_array_equal(tdb[1].numpy(), jdb[1])
        assert tm._fginn_db(tp.spec_for(name)) is tdb
