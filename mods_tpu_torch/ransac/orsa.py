"""ORSA, a-contrario fundamental-matrix estimation, hypothesis-parallel
(mirrors ``mods_tpu/ransac/orsa.py``; reference ``orsa()``, orsa.cpp:371,
dispatched by ``ORSAFiltering``, matching/matching.cpp:982-1072).

A model with k inliers at precision d is meaningful when

    NFA(k) = (n-7) * C(n,k) * C(k,7) * alpha_k^(k-7)

is small, where alpha_k = 2 * d_k * D / A is the chance that a random
point of an image of area A lies within the k-th residual distance d_k of
an epipolar line (D the image diagonal).  The reference accepts a model
iff log10(NFA) < -2 (matching.cpp:1035-1040).

Each round scores ``batch_hypotheses`` 7-point solves (``_solve_7pt`` of
DEGENSAC-F), each by sorting its residuals once and scanning every k in
one pass.  Later rounds draw their samples from the best model's
consensus (ORSA's optimization phase).  The stall counter that ends the
rounds early is read back to the host once a round.
"""

from __future__ import annotations

import math

import torch

from mods_tpu_torch.config import OrsaParams
from mods_tpu_torch.ops.select import nonzero_static, pick
from mods_tpu_torch.ransac import errors as E
from mods_tpu_torch.ransac.fundamental import _solve_7pt
from mods_tpu_torch.ransac.homography import (_apply_T, _normalization,
                                              _uniform_index)

_LN10 = math.log(10.0)


def _log10_comb(n, k):
    """log10 C(n, k) for float n and k."""
    return (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
            - torch.lgamma(torch.clamp(n - k, min=0.0) + 1.0)) / _LN10


def _epiline_dist2(F, xy1, xy2):
    """Squared point-to-epipolar-line distances, both directions:
    (d(x2, F x1)^2, d(x1, F^T x2)^2), each (..., N)."""
    num, Fx1, Ftx2 = E._f_terms(F, xy1, xy2)
    d2 = num * num / torch.clamp(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2,
                                 min=1e-20)
    d1 = num * num / torch.clamp(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2,
                                 min=1e-20)
    return d2, d1


def _best_nfa(err2, mask, log_alpha0: float, nvalid):
    """NFA scan of residual vectors err2 (..., N) (squared max-direction
    epipolar distances) -> (log10 NFA at the best k, k*, d_{k*}^2), each
    (...,).  orsa.cpp's best-k search over sorted residuals."""
    n = err2.shape[-1]
    big = 1e30
    e_sorted, _ = torch.sort(torch.where(mask, err2, big), dim=-1)
    ks = torch.arange(1, n + 1, dtype=torch.float32, device=err2.device)
    nf = nvalid.to(torch.float32)
    log_alpha = log_alpha0 + 0.5 * torch.log10(
        torch.clamp(e_sorted, min=1e-20))
    log_nfa = (torch.log10(torch.clamp(nf - 7.0, min=1.0))
               + _log10_comb(nf, ks)
               + _log10_comb(ks, torch.full_like(ks, 7.0))
               + (ks - 7.0) * log_alpha)
    valid_k = (ks >= 8.0) & (ks <= nf)
    log_nfa = torch.where(valid_k, log_nfa, big)
    i = torch.argmin(log_nfa, dim=-1, keepdim=True)
    return (torch.gather(log_nfa, -1, i)[..., 0], i[..., 0] + 1,
            torch.gather(e_sorted, -1, i)[..., 0])


def orsa_f(xy1: torch.Tensor, xy2: torch.Tensor, mask: torch.Tensor,
           w: int, h: int, pars: OrsaParams, generator: torch.Generator):
    """A-contrario F from fixed-capacity correspondences -> (F,
    inlier_mask, n_inliers, log10_nfa).  The model is accepted iff
    log10_nfa < pars.max_log_nfa; on rejection the inlier mask is empty,
    as ORSAFiltering returns an empty list."""
    n = xy1.shape[0]
    dev = xy1.device
    B = pars.batch_hypotheses
    diag = math.sqrt(w * w + h * h)
    log_alpha0 = math.log10(2.0 * diag / (w * h))

    T1 = _normalization(xy1, mask)
    T2 = _normalization(xy2, mask)
    p1 = _apply_T(T1, xy1)
    p2 = _apply_T(T2, xy2)
    nvalid = torch.clamp(mask.sum(), min=1)
    valid_idx, _ = nonzero_static(mask, n)
    eye7 = torch.eye(7, dtype=torch.bool, device=dev)

    def err2_of(F):
        d2a, d2b = _epiline_dist2(F, xy1, xy2)
        return torch.maximum(d2a, d2b)

    def hyp_round(pool_idx, pool_n):
        """One round of B 7-point hypotheses sampled from pool_idx."""
        idx = pool_idx[_uniform_index((B, 7), pool_n, generator, dev)]
        distinct = ~((idx[:, :, None] == idx[:, None, :]) & ~eye7).any(
            (1, 2))
        Fn, rvalid = _solve_7pt(p1[idx], p2[idx])        # (B, 3, 3, 3)
        F = (T2.T @ Fn @ T1).reshape(-1, 3, 3)
        nfa, _, th2 = _best_nfa(err2_of(F), mask, log_alpha0, nvalid)
        ok = (rvalid & distinct[:, None]).reshape(-1)
        nfa = torch.where(ok, nfa, 1e30)
        i = torch.argmin(nfa)
        return pick(F, i), pick(nfa, i), pick(th2, i)

    bF = torch.eye(3, dtype=torch.float32, device=dev)
    bnfa = torch.tensor(1e30, device=dev)
    bth2 = torch.tensor(0.0, device=dev)
    stall = torch.tensor(0, device=dev)
    for _ in range(pars.rounds):
        # adaptive termination (the reference's nsamples update,
        # orsa.cpp:371+): once log-NFA has not improved by
        # min_improvement for stall_rounds rounds, the rest are skipped
        if int(stall) >= pars.stall_rounds:
            break
        # the first rounds sample the whole set, later ones the current
        # best consensus (ORSA's optimization phase)
        inl = mask & (err2_of(bF) <= bth2) & (bnfa < 1e29)
        n_inl = inl.sum()
        refine = n_inl >= 14
        pool_idx = torch.where(refine, nonzero_static(inl, n)[0], valid_idx)
        pool_n = torch.where(refine, torch.clamp(n_inl, min=1), nvalid)
        F, nfa, th2 = hyp_round(pool_idx, pool_n)
        improved = nfa < bnfa - pars.min_improvement
        stall = torch.where(improved, 0, stall + 1)
        better = nfa < bnfa
        bF = torch.where(better, F, bF)
        bth2 = torch.where(better, th2, bth2)
        bnfa = torch.minimum(nfa, bnfa)

    accepted = bnfa < pars.max_log_nfa
    inl = mask & (err2_of(bF) <= bth2) & accepted
    return bF, inl, inl.to(torch.int32).sum(), bnfa
