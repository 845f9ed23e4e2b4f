"""Hypothesis-parallel DEGENSAC-F: batched 7-point fundamental matrices
with oriented constraints and H-degeneracy recovery (mirrors
``mods_tpu/ransac/fundamental.py``; reference ``exp_ransacFcustom``,
degensac/exp_ranF.c:795-1130).

Per round, ``batch_hypotheses`` 7-point solves (the 2-D nullspace from
the 9x9 normal matrix's ``eigh``, the cubic det(F1 + x F2) = 0 in closed
form, up to 3 F's each), the oriented epipolar constraint over the
sample, and residual scoring over all correspondences at once.
DEGENSAC's plane test (checksample/innerH/rFtH, exp_ranF.c:952-1006)
runs on the best model; local optimization resamples the inlier set and
anneals iterated least squares, its inner samples batched into one call.

Random numbers come from an explicit ``torch.Generator``, so the draws
differ from ``jax.random``'s: the solver and scoring functions agree with
the JAX package, ``ransac_f`` agrees on outcomes.  The adaptive round
count reads the best count back to the host once a round, as
``ransac_h`` does; nothing is read per hypothesis, and the best
hypothesis is picked on the device (``ops/select.py::pick``).
"""

from __future__ import annotations

import itertools
import math

import torch

from mods_tpu_torch.config import RansacErrorType, RansacParams
from mods_tpu_torch.ops.select import nonzero_static, pick
from mods_tpu_torch.ransac import errors as E
from mods_tpu_torch.ransac.homography import (_apply_T, _fit_h,
                                              _needed_samples,
                                              _normalization,
                                              _uniform_index,
                                              normal_eigvecs)

# the 35 four-point subsets of a 7-point sample (degensac_check)
_QUADS = tuple(itertools.combinations(range(7), 4))


def _f_rows(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Epipolar constraint rows: x2^T F x1 = 0 -> (..., 9) rows in F's
    row-major layout (lin_fm, degensac/Ftools.c)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                        x1, y1, o], -1)


def _nullspace2(rows: torch.Tensor):
    """The two smallest right-singular vectors of (..., 7, 9) rows, from
    ``eigh`` of the normal matrix (each up to sign)."""
    vecs = normal_eigvecs(rows)
    return vecs[..., :, 0], vecs[..., :, 1]


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _cubic_roots(a, b, c, d):
    """Real roots of a x^3 + b x^2 + c x + d -> (..., 3) roots and their
    validity (trigonometric method; reference rroots3, Ftools.h:67)."""
    a = torch.where(torch.abs(a) < 1e-12, torch.full_like(a, 1e-12), a)
    p = b / a
    q = c / a
    r = d / a
    # depressed cubic t^3 + pt t + qt, x = t - p/3
    pt = q - p * p / 3.0
    qt = 2.0 * p ** 3 / 27.0 - p * q / 3.0 + r
    disc = (qt / 2.0) ** 2 + (pt / 3.0) ** 3

    # three real roots (disc <= 0)
    m = torch.sqrt(torch.clamp(-pt / 3.0, min=1e-20))
    arg = torch.clamp(3.0 * qt / (2.0 * pt * m), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    k = torch.arange(3, dtype=a.dtype, device=a.device)
    t3 = 2.0 * m[..., None] * torch.cos(
        theta[..., None] - 2.0 * math.pi * k / 3.0)

    # one real root (disc > 0), Cardano
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = _cbrt(-qt / 2.0 + sq) + _cbrt(-qt / 2.0 - sq)
    three = (disc <= 0)[..., None]
    roots = torch.where(three, t3, t1[..., None].expand_as(t3))
    valid = three | (torch.arange(3, device=a.device) == 0)
    return roots - p[..., None] / 3.0, valid


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def _det_coeffs(F1, F2):
    """det(F1 + x F2) = a x^3 + b x^2 + c x + d for (..., 3, 3), b and c
    by polarization at x = 1 and x = -1."""
    d = _det3(F1)
    a = _det3(F2)
    f1 = _det3(F1 + F2)
    fm1 = _det3(F1 - F2)
    b = (f1 + fm1) / 2.0 - d
    c = (f1 - fm1) / 2.0 - a
    return a, b, c, d


def _solve_7pt(p1: torch.Tensor, p2: torch.Tensor):
    """(..., 7, 2) x2 -> up to 3 unit-norm F's (..., 3, 3, 3) and their
    validity (..., 3)."""
    n1, n2 = _nullspace2(_f_rows(p1, p2))
    F1 = n1.reshape(n1.shape[:-1] + (3, 3))
    F2 = n2.reshape(n2.shape[:-1] + (3, 3))
    roots, rvalid = _cubic_roots(*_det_coeffs(F1, F2))
    F = F1[..., None, :, :] + roots[..., :, None, None] * F2[..., None, :, :]
    norm = torch.sqrt((F * F).sum((-1, -2), keepdim=True))
    return F / torch.clamp(norm, min=1e-12), rvalid


def _epipole2(F: torch.Tensor) -> torch.Tensor:
    """Left epipole e2 (e2^T F = 0): the cross product of two columns of
    F, the other pair where those are near-parallel (Ftools.c)."""
    c0, c1, c2 = F[..., :, 0], F[..., :, 1], F[..., :, 2]
    e = torch.linalg.cross(c0, c2)
    alt = torch.linalg.cross(c1, c2)
    use_alt = (e * e).sum(-1, keepdim=True) < 1e-18
    return torch.where(use_alt, alt, e)


def _oriented_ok(F, p1s, p2s):
    """Oriented epipolar constraint over the sample points
    (all_ori_valid, Ftools.c:429-443): (F x1) . (e2 x x2) has one sign
    over all points.  F (..., 3, 3); p1s, p2s (..., S, 2), broadcast
    against F's leading axes."""
    x1 = E._homog(p1s)
    x2 = E._homog(p2s)
    e2 = _epipole2(F)
    Fx1 = (F[..., None, :, :] @ x1[..., None])[..., 0]
    l2 = torch.linalg.cross(e2[..., None, :].expand_as(Fx1),
                            x2.expand_as(Fx1))
    sig = (Fx1 * l2).sum(-1)
    return (sig > 0).all(-1) | (sig < 0).all(-1)


def _f_error_fn(pars: RansacParams):
    if pars.error_type == RansacErrorType.SAMPSON:
        return E.f_error_sampson
    return E.f_error_symepi


def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def ransac_f(xy1: torch.Tensor, xy2: torch.Tensor, mask: torch.Tensor,
             pars: RansacParams, generator: torch.Generator):
    """Robust F (x2^T F x1 = 0) from fixed-capacity correspondences ->
    (F (3, 3), inliers (N,) bool, n_inl, degen): ``degen`` is True when
    DEGENSAC found >= 5 of the best sample's 7 points on one homography."""
    n = xy1.shape[0]
    dev = xy1.device
    err_fn = _f_error_fn(pars)
    th = pars.err_threshold ** 2
    B = pars.batch_hypotheses

    T1 = _normalization(xy1, mask)
    T2 = _normalization(xy2, mask)
    p1 = _apply_T(T1, xy1)
    p2 = _apply_T(T2, xy2)
    nvalid = torch.clamp(mask.sum(), min=1)
    valid_idx, _ = nonzero_static(mask, n)
    eye7 = torch.eye(7, dtype=torch.bool, device=dev)

    def denorm(Fn):
        # x2n^T Fn x1n = 0 with xin = Ti xi  ->  F = T2^T Fn T1
        return T2.T @ Fn @ T1

    def count(e):
        return ((e < th) & mask).sum(-1)

    def hyp_round():
        idx = valid_idx[_uniform_index((B, 7), nvalid, generator, dev)]
        distinct = ~((idx[:, :, None] == idx[:, None, :]) & ~eye7).any(
            (1, 2))
        Fn, rvalid = _solve_7pt(p1[idx], p2[idx])        # (B, 3, 3, 3)
        F = denorm(Fn)
        ori = _oriented_ok(F, xy1[idx][:, None], xy2[idx][:, None])
        Ff = F.reshape(-1, 3, 3)
        cnt = count(err_fn(Ff, xy1, xy2)).reshape(B, 3)
        ok = rvalid & ori & distinct[:, None]
        if pars.do_symm_check:
            # symmetric-distance cross-check (exp_ranF.c:926-938): bad
            # when the symmetric-epipolar inliers at 4x th do not exceed
            # 0.6 of the Sampson count
            es = E.f_error_symepi(Ff, xy1, xy2)
            scnt = ((es < 4.0 * th) & mask).sum(-1).reshape(B, 3)
            ok = ok & (scnt.to(torch.float32)
                       > torch.floor(0.6 * cnt.to(torch.float32)))
        cnt = torch.where(ok, cnt, -1).reshape(-1)
        flat = torch.argmax(cnt)
        return pick(Ff, flat), pick(cnt, flat), pick(idx, flat // 3)

    def fit_f_weighted(w):
        """Least-squares F from weighted rows, projected to rank 2 (u2f
        semantics); w (R, N) -> (R, 3, 3)."""
        rows = _f_rows(p1, p2) * w[..., None]
        Fn = normal_eigvecs(rows)[..., :, 0].reshape(w.shape[:-1] + (3, 3))
        U, S, Vh = torch.linalg.svd(Fn)
        S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], -1)
        return denorm((U * S[..., None, :]) @ Vh)

    def lo_refine(F):
        inl0 = (err_fn(F, xy1, xy2) < th) & mask
        n_inl = torch.clamp(inl0.sum(), min=1)
        iidx, _ = nonzero_static(inl0, n)
        R = pars.lo_inner_samples
        ridx = iidx[_uniform_index((R, max(pars.lo_sample_size, 9)), n_inl,
                                   generator, dev)]
        w = torch.zeros((R, n), device=dev).scatter_(1, ridx, 1.0)
        Fs = fit_f_weighted(w)                            # (R, 3, 3)
        for i in range(pars.lo_iters):
            m = max(4.0 * 0.5 ** i, 1.0)
            wi = ((err_fn(Fs, xy1, xy2) < m * th) & mask).to(torch.float32)
            F2 = fit_f_weighted(wi)
            ok = torch.isfinite(F2).all(-1).all(-1)
            Fs = torch.where(ok[:, None, None], F2, Fs)
        Fall = torch.cat([Fs, F[None]])
        call = count(err_fn(Fall, xy1, xy2))
        b = torch.argmax(call)
        return pick(Fall, b), pick(call, b)

    def degensac_check(F, sample_idx):
        """checksample + innerH + rFtH (exp_ranF.c:952-1006): if >= 5 of
        the 7 sample points lie on one H (fit on each of the 35 4-point
        subsets), re-derive F by plane and parallax from 8 pairs of
        off-plane points of that H's consensus."""
        s1 = xy1[sample_idx]
        s2 = xy2[sample_idx]
        quads = torch.tensor(_QUADS, device=dev)
        Hn = _fit_h(s1[quads], s2[quads])                 # raw coords
        cons = (E.h_error_symm(Hn, s1, s2) < 9.0 * th).sum(-1)
        best = torch.argmax(cons)
        degenerate = pick(cons, best) >= 5
        Hd = pick(Hn, best)
        hin = (E.h_error_symm(Hd, xy1, xy2) < 16.0 * th) & mask
        x1h = E._homog(xy1)
        Hx1 = x1h @ Hd.T
        lines = torch.linalg.cross(Hx1, E._homog(xy2))   # epipolar pencil
        off = ~hin & mask
        noff = torch.clamp(off.sum(), min=1)
        oidx, _ = nonzero_static(off, n)
        two = oidx[_uniform_index((8, 2), noff, generator, dev)]
        ep = torch.linalg.cross(lines[two[:, 0]], lines[two[:, 1]])
        Fs = _skew(ep) @ Hd
        nf = torch.sqrt((Fs * Fs).sum((-1, -2), keepdim=True))
        Fs = Fs / torch.clamp(nf, min=1e-12)
        cs = count(err_fn(Fs, xy1, xy2))
        bi = torch.argmax(cs)
        return degenerate, pick(Fs, bi), pick(cs, bi)

    # adaptive round loop: one host read of the best count per round
    nvalid_host = int(nvalid)
    bF = torch.eye(3, dtype=torch.float32, device=dev)
    bc = torch.tensor(-1, dtype=torch.int64, device=dev)
    bsample = torch.zeros(7, dtype=torch.int64, device=dev)
    done = 0
    for _ in range(pars.max_rounds):
        if done >= _needed_samples(int(bc), nvalid_host, pars, m=7):
            break
        F, c, sample = hyp_round()
        better = c > bc
        bF = torch.where(better, F, bF)
        bsample = torch.where(better, sample, bsample)
        bc = torch.maximum(bc, c)
        done += B

    degen, Fd, cd = degensac_check(bF, bsample)
    use_d = degen & (cd > bc)
    bF = torch.where(use_d, Fd, bF)
    if pars.local_optimization:
        bF, _ = lo_refine(bF)

    inl = (err_fn(bF, xy1, xy2) < th) & mask
    return bF, inl, inl.to(torch.int32).sum(), degen
