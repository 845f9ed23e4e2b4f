"""Port vs JAX reference: F verification, DEGENSAC and ORSA (CPU).

Each check feeds the same seeded numpy inputs to the JAX function and to
the port's.  Tolerances:

* the F error functions, the epipolar lines and ``h_error_forward``: to
  float32 rounding (rtol 1e-4, atol 1e-3 on residuals of up to 1e4 px^2);
* ``_cubic_roots``: the real roots to 1e-3 relative, the same validity;
* ``_solve_7pt``: the solutions as sets of F normalised to unit Frobenius
  norm with the sign fixed, each JAX F matched by a port F to 1e-2, on at
  least 95 % of well-conditioned samples (98.5 % of these 200 agree to
  1e-2, 87 % to 1e-3: ``eigh`` picks each nullspace vector up to sign and
  rounds differently, and XLA and PyTorch round the determinant apart, so
  a root near the branch at ``disc <= 0`` may switch);
* ``_oriented_ok`` and ``f_laf_check``: exactly, on the same F;
* ``ransac_f`` and ``orsa_f`` draw other random numbers than
  ``jax.random`` (the ROADMAP's RNG rule): outcomes are compared, the
  inlier set on data with clear inliers (>= 95 % agreement with JAX's),
  Sampson error on the true inliers, rejection of random data, and
  DEGENSAC's ``degen`` flag on a plane with a few points off it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mods_tpu import pipeline as jp
from mods_tpu.config import OrsaParams as JaxOrsa
from mods_tpu.config import RansacParams as JaxRansac
from mods_tpu.ransac import errors as jE
from mods_tpu.ransac import fundamental as jf
from mods_tpu.ransac import laf_check as jl
from mods_tpu.ransac import orsa as jo
from mods_tpu_torch import config as tc
from mods_tpu_torch import pipeline as tp
from mods_tpu_torch.ransac import errors as tE
from mods_tpu_torch.ransac import fundamental as tf
from mods_tpu_torch.ransac import laf_check as tl
from mods_tpu_torch.ransac import orsa as to
from test_fundamental import synth_two_view
from test_orsa import two_view_scene

torch.set_num_threads(2)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _ransac(**kw):
    j = JaxRansac(**kw)
    return j, tc.from_dict(dataclasses.asdict(j), tc.RansacParams)


def test_f_error_functions_against_jax():
    rng = np.random.default_rng(0)
    F = rng.normal(size=(5, 3, 3)).astype(np.float32)
    F[:, 2] *= 1e-2
    xy1 = rng.uniform(0, 640, (64, 2)).astype(np.float32)
    xy2 = rng.uniform(0, 480, (64, 2)).astype(np.float32)
    H = np.eye(3, dtype=np.float32) + rng.normal(0, 1e-3, (3, 3)).astype(
        np.float32)
    for name in ("f_error_sampson", "f_error_symepi"):
        a = getattr(tE, name)(_t(F), _t(xy1), _t(xy2)).numpy()
        b = np.asarray(getattr(jE, name)(jnp.asarray(F), jnp.asarray(xy1),
                                         jnp.asarray(xy2)))
        assert a.shape == b.shape == (5, 64)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(
        tE.f_epipolar_lines(_t(F), _t(xy1)).numpy(),
        np.asarray(jE.f_epipolar_lines(jnp.asarray(F), jnp.asarray(xy1))),
        rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(
        tE.h_error_forward(_t(H), _t(xy1), _t(xy2)).numpy(),
        np.asarray(jE.h_error_forward(jnp.asarray(H), jnp.asarray(xy1),
                                      jnp.asarray(xy2))), rtol=1e-5)


def test_cubic_roots_against_jax():
    rng = np.random.default_rng(1)
    coef = rng.normal(size=(4, 500)).astype(np.float32)
    coef[0, :3] = [1.0, 1.0, 1.0]
    coef[1:, 0] = [-6.0, 11.0, -6.0]                     # roots 1, 2, 3
    coef[1:, 1] = [0.0, 1.0, 1.0]                        # one real root
    r, v = tf._cubic_roots(*[_t(c) for c in coef])
    jr, jv = jf._cubic_roots(*[jnp.asarray(c) for c in coef])
    jr, jv = np.asarray(jr), np.asarray(jv)
    np.testing.assert_array_equal(v.numpy(), jv)
    ok = jv
    np.testing.assert_allclose(r.numpy()[ok], jr[ok], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(np.sort(r.numpy()[0]), [1, 2, 3], atol=1e-3)
    a, b, c, d = coef[:, 1]
    x = r.numpy()[1, 0]
    assert abs(a * x ** 3 + b * x ** 2 + c * x + d) < 1e-3


def _normalized_samples(n_samples, seed=2):
    rng = np.random.default_rng(seed)
    xy1, xy2, _ = synth_two_view(rng, 7 * n_samples)
    p = []
    for xy in (xy1, xy2):
        xy = xy.reshape(n_samples, 7, 2)
        c = xy.mean(1, keepdims=True)
        s = np.sqrt(2) / np.linalg.norm(xy - c, axis=-1).mean(-1)
        p.append(((xy - c) * s[:, None, None]).astype(np.float32))
    return p


def _sign_fixed(F):
    F = F / np.linalg.norm(F)
    return F * np.sign(F.reshape(-1)[np.argmax(np.abs(F))])


def test_solve_7pt_solution_sets_against_jax():
    p1, p2 = _normalized_samples(200)
    F, v = tf._solve_7pt(_t(p1), _t(p2))
    jF, jv = jf._solve_7pt(jnp.asarray(p1), jnp.asarray(p2))
    F, v, jF, jv = F.numpy(), v.numpy(), np.asarray(jF), np.asarray(jv)
    agree = 0
    for b in range(len(p1)):
        mine = [_sign_fixed(F[b, i]) for i in range(3) if v[b, i]]
        ref = [_sign_fixed(jF[b, i]) for i in range(3) if jv[b, i]]
        agree += len(mine) == len(ref) and all(
            min(np.abs(r - m).max() for m in mine) < 1e-2 for r in ref)
        # every port solution has rank 2 and fits its sample
        for m in mine:
            assert abs(np.linalg.det(m)) < 1e-4
            x1 = np.c_[p1[b], np.ones(7)]
            x2 = np.c_[p2[b], np.ones(7)]
            assert np.abs(np.einsum("ni,ij,nj->n", x2, m, x1)).max() < 1e-3
    assert agree >= 0.95 * len(p1), agree


def test_oriented_ok_and_f_laf_check_exactly():
    rng = np.random.default_rng(3)
    xy1, xy2, F = synth_two_view(rng, 128, noise=0.5)
    F = F.astype(np.float32)
    Fs = np.stack([F, -F, F + rng.normal(0, 1e-3, (3, 3)).astype(np.float32),
                   rng.normal(size=(3, 3)).astype(np.float32)])
    s1 = xy1[:7 * 16].reshape(16, 7, 2)
    s2 = xy2[:7 * 16].reshape(16, 7, 2)
    s2[8:] = s2[8:, ::-1]                    # mismatched samples
    for Fi in Fs:
        a = tf._oriented_ok(_t(Fi), _t(s1), _t(s2)).numpy()
        b = np.asarray(jf._oriented_ok(jnp.asarray(Fi), jnp.asarray(s1),
                                       jnp.asarray(s2)))
        np.testing.assert_array_equal(a, b)
    assert a.shape == (16,)
    n = 128
    th_ = rng.uniform(0, 6.28, n)
    A = np.stack([np.stack([np.cos(th_), -np.sin(th_)], -1),
                  np.stack([np.sin(th_), np.cos(th_)], -1)], -2)
    A = A.astype(np.float32)
    s = rng.uniform(0.05, 0.4, n).astype(np.float32)
    mask = rng.uniform(size=n) < 0.8
    for sampson in (True, False):
        args = (F, xy1, A, s, xy2, A, s, mask)
        a = tl.f_laf_check(*[_t(x) for x in args], 6.0,
                           sampson=sampson).numpy()
        b = np.asarray(jl.f_laf_check(*[jnp.asarray(x) for x in args], 6.0,
                                      sampson=sampson))
        np.testing.assert_array_equal(a, b)
        assert 0 < a.sum() < mask.sum()


def _scene(seed, n_in=120, n_out=60, cap=256, noise=0.3):
    rng = np.random.default_rng(seed)
    xy1, xy2, F = synth_two_view(rng, cap, noise=noise)
    xy2[n_in:n_in + n_out] = rng.uniform(0, 600, (n_out, 2)).astype(
        np.float32)
    mask = np.zeros(cap, bool)
    mask[:n_in + n_out] = True
    return xy1, xy2, mask, F


@pytest.mark.parametrize("symm", [False, True])
def test_ransac_f_against_jax(symm):
    """A non-planar scene with 120 inliers and 60 outliers: both packages
    find the same inlier set (>= 95 %), a port F with small Sampson error
    on the true inliers, and no degeneracy."""
    xy1, xy2, mask, F = _scene(4)
    jpars, tpars = _ransac(use_f=True, err_threshold=2.0,
                           batch_hypotheses=256, max_rounds=4,
                           do_symm_check=symm, error_type="sampson")
    Fe, inl, cnt, degen = tf.ransac_f(_t(xy1), _t(xy2), _t(mask), tpars,
                                      torch.Generator().manual_seed(0))
    jFe, jinl, jcnt, jdegen = jf.ransac_f(
        jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(mask), jpars,
        jax.random.PRNGKey(0))
    inl, jinl = inl.numpy(), np.asarray(jinl)
    assert int(cnt) == inl.sum() and inl[:120].sum() >= 0.9 * 120
    assert inl[120:].sum() <= 6
    assert (inl == jinl).mean() >= 0.95
    assert not bool(degen) and not bool(jdegen)
    e = tE.f_error_sampson(Fe, _t(xy1[:120]), _t(xy2[:120])).numpy()
    assert np.median(e) < 0.5 and np.linalg.matrix_rank(
        Fe.numpy().astype(np.float64), tol=1e-5) == 2


def test_ransac_f_rejects_random_data():
    rng = np.random.default_rng(1)
    cap = 128
    xy1 = rng.uniform(0, 600, (cap, 2)).astype(np.float32)
    xy2 = rng.uniform(0, 600, (cap, 2)).astype(np.float32)
    _, pars = _ransac(use_f=True, err_threshold=1.0, batch_hypotheses=256,
                      max_rounds=2)
    _, inl, cnt, _ = tf.ransac_f(_t(xy1), _t(xy2), torch.ones(cap, dtype=bool),
                                 pars, torch.Generator().manual_seed(1))
    assert int(cnt) < cap // 2


def test_degensac_flags_a_plane_as_jax_does():
    """160 points on one plane plus 12 off it: the best 7-point sample
    has >= 5 points on one H in both packages, and the plane-and-parallax
    F explains the off-plane points too.  The image is 64x48 px: the
    plane test fits its H in raw pixel coordinates, and at 640x480 px
    neither package's float32 fit is precise enough to flag the plane."""
    rng = np.random.default_rng(5)
    K = np.array([[40.0, 0, 32], [0, 40.0, 24], [0, 0, 1]])
    n_pl, n_off = 160, 12
    X = np.c_[rng.uniform(-1, 1, (n_pl, 2)), np.full(n_pl, 4.0)]
    X = np.r_[X, rng.uniform(-1, 1, (n_off, 3)) + [0, 0, 5.5]]
    ang = 0.1
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    t = np.array([0.6, 0.05, 0.1])

    def proj(Xc):
        x = Xc @ K.T
        return (x[:, :2] / x[:, 2:]).astype(np.float32)
    xy1 = proj(X)
    xy2 = proj(X @ R.T + t) + rng.normal(0, 0.02, (len(X), 2)).astype(
        np.float32)
    cap = 256
    p1 = np.zeros((cap, 2), np.float32)
    p2 = np.zeros((cap, 2), np.float32)
    p1[:len(X)], p2[:len(X)] = xy1, xy2
    mask = np.arange(cap) < len(X)
    jpars, tpars = _ransac(use_f=True, err_threshold=0.3,
                           batch_hypotheses=256, max_rounds=2,
                           error_type="sampson")
    _, inl, _, degen = tf.ransac_f(_t(p1), _t(p2), _t(mask), tpars,
                                   torch.Generator().manual_seed(0))
    _, jinl, _, jdegen = jf.ransac_f(jnp.asarray(p1), jnp.asarray(p2),
                                     jnp.asarray(mask), jpars,
                                     jax.random.PRNGKey(0))
    assert bool(degen) and bool(jdegen)
    inl = inl.numpy()
    assert inl[:n_pl].mean() > 0.9
    assert inl[n_pl:len(X)].sum() >= n_off // 2


def _orsa(xy1, xy2, w, h, cap=256, seed=0):
    n = len(xy1)
    p1 = np.zeros((cap, 2), np.float32)
    p2 = np.zeros((cap, 2), np.float32)
    m = np.zeros(cap, bool)
    p1[:n], p2[:n], m[:n] = xy1, xy2, True
    pars = tc.from_dict(dataclasses.asdict(JaxOrsa()), tc.OrsaParams)
    F, inl, n_inl, nfa = to.orsa_f(_t(p1), _t(p2), _t(m), w, h, pars,
                                   torch.Generator().manual_seed(seed))
    return F.numpy(), inl.numpy()[:n], int(n_inl), float(nfa)


def test_orsa_recovers_inliers():
    xy1, xy2, true_inl, w, h = two_view_scene(80, 40)
    F, inl, n_inl, nfa = _orsa(xy1, xy2, w, h)
    assert nfa < -2.0
    assert inl[true_inl].mean() > 0.8
    assert inl[~true_inl].mean() < 0.15
    x1 = np.c_[xy1, np.ones(len(xy1))]
    x2 = np.c_[xy2, np.ones(len(xy2))]
    res = np.abs(np.einsum("ni,ij,nj->n", x2, F, x1))
    lines = (F @ x1.T).T
    d = res / np.maximum(np.hypot(lines[:, 0], lines[:, 1]), 1e-9)
    assert np.median(d[inl]) < 2.0


def test_orsa_rejects_random_and_scores_as_jax():
    rng = np.random.default_rng(3)
    xy1 = rng.uniform(0, 512, (60, 2)).astype(np.float32)
    xy2 = rng.uniform(0, 512, (60, 2)).astype(np.float32)
    _, inl, n_inl, nfa = _orsa(xy1, xy2, 512, 512, seed=1)
    assert nfa > -2.0 or n_inl < 14
    if nfa > -2.0:
        assert n_inl == 0 and not inl.any()
    # the NFA scan of one residual vector, against JAX's
    e2 = rng.uniform(0, 50, 200).astype(np.float32)
    m = rng.uniform(size=200) < 0.7
    a = to._best_nfa(_t(e2), _t(m), -2.5, torch.tensor(int(m.sum())))
    b = jo._best_nfa(jnp.asarray(e2), jnp.asarray(m), jnp.float32(-2.5),
                     jnp.int32(m.sum()))
    np.testing.assert_allclose(float(a[0]), float(b[0]), rtol=1e-4)
    assert int(a[1]) == int(b[1]) and float(a[2]) == float(b[2])


@pytest.mark.parametrize("ver", ["LORANSACF", "ORSA"])
def test_verify_core_f_modes_against_jax(ver):
    """The LORANSACF and ORSA branches of ``_verify_core``: duplicate
    filter, F estimation and F_LAF_check on one bank of tentatives."""
    xy1, xy2, true_inl, w, h = two_view_scene(60, 20, seed=5)
    cap, n = 128, len(xy1)
    p1 = np.zeros((cap, 2), np.float32)
    p2 = np.zeros((cap, 2), np.float32)
    p1[:n], p2[:n] = xy1, xy2
    m = np.arange(cap) < n
    A = np.tile(np.eye(2, dtype=np.float32), (cap, 1, 1)) * 0.3
    s = np.full(cap, 2.0, np.float32)
    prio = np.zeros(cap, np.float32)
    jcfg = jp.EngineConfig(ver_type=ver, ransac=JaxRansac(
        batch_hypotheses=256, max_rounds=2, error_type="sampson"))
    args = (p1, A, s, p2, A, s, prio, m)
    ref = jp._verify_core(jcfg, w, h, *[jnp.asarray(x) for x in args],
                          jax.random.PRNGKey(0))
    got = tp._verify_core(tc.from_dict(dataclasses.asdict(jcfg)), w, h,
                          *[_t(x) for x in args],
                          torch.Generator().manual_seed(0))
    assert int(got["n_tent"]) == int(ref["n_tent"]) == n
    assert int(got["n_inl"]) >= 0.8 * 60
    assert abs(int(got["n_inl"]) - int(ref["n_inl"])) <= 0.2 * int(
        ref["n_inl"])
    fin = got["inlier_mask"].numpy()[:n]
    assert fin[true_inl].mean() > 0.8 and fin[~true_inl].mean() < 0.15
    assert ("degen" in got) == (ver == "LORANSACF")
    assert ("log_nfa" in got) == (ver == "ORSA")
