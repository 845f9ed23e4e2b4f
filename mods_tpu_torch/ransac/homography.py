"""Hypothesis-parallel LO-RANSAC for homographies (mirrors
``mods_tpu/ransac/homography.py``; reference ``exp_ransacHcustom``,
degensac/exp_ranH.c:223-380, and its local optimization :40-180).

Rounds of ``batch_hypotheses`` 4-point DLT fits are scored at once; the
best is refined by a batch of inner resamples, each annealed by
iterated weighted least squares over the inlier set.

Random numbers come from an explicit ``torch.Generator``.  torch cannot
reproduce ``jax.random``'s stream, so the two packages draw different
samples: the fit, error and scoring functions agree exactly, and
``ransac_h`` agrees on outcomes (the H and the inlier set on data with
clear inliers).  The adaptive round count depends on device values, so
each round reads the best count back to the host (at most
``max_rounds`` reads per call, one a round for a whole pair batch).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mods_tpu_torch.config import RansacErrorType, RansacParams
from mods_tpu_torch.ops.select import nonzero_static, take_rows
from mods_tpu_torch.ransac import errors as E


def _normalization(xy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Hartley normalization T (..., 3, 3): zero centroid, mean distance
    sqrt(2) over the masked points (reference normu, degensac/utools.c)
    of (..., N, 2) points."""
    w = mask.to(torch.float32)
    n = torch.clamp(w.sum(-1), min=1.0)
    mean = (xy * w[..., None]).sum(-2) / n[..., None]
    d = torch.sqrt(((xy - mean[..., None, :]) ** 2).sum(-1))
    scale = (d * w).sum(-1) / n
    s = math.sqrt(2.0) / torch.clamp(scale, min=1e-8)
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    return torch.stack([torch.stack([s, z, -s * mean[..., 0]], -1),
                        torch.stack([z, s, -s * mean[..., 1]], -1),
                        torch.stack([z, z, o], -1)], -2)


def _apply_T(T: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    return xy * T[..., 0, 0][..., None, None] + T[..., None, :2, 2]


def _dlt_rows(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Two DLT rows per correspondence p -> q: (..., 2) -> (..., 2, 9)."""
    x, y = p[..., 0], p[..., 1]
    u, v = q[..., 0], q[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], -1)
    return torch.stack([r1, r2], -2)


def normal_eigvecs(rows: torch.Tensor) -> torch.Tensor:
    """Eigenvectors, by ascending eigenvalue, of the normal matrix
    rows^T rows of (..., R, 9) constraint rows.  The CPU computes it in
    float32, as the JAX package does.  On the card the product and
    ``eigh`` run in float64: the normal matrix squares the rows'
    condition, and cuSOLVER's batched float32 ``eigh`` loses far more of
    a fit than LAPACK's (``python3 chip_smoke.py --seed-spread
    tilt6_rot45 100`` on an NVIDIA H100 80GB HBM3, 700 W: 4-point fits of
    rung 4 that keep 8.67 inliers in float64 keep 6.10 on the card in
    float32 and 8.33 on the CPU)."""
    if rows.is_cuda:
        r = rows.to(torch.float64)
        return torch.linalg.eigh(r.transpose(-1, -2) @ r)[1].to(rows.dtype)
    return torch.linalg.eigh(rows.transpose(-1, -2) @ rows)[1]


def _h_from_rows(rows: torch.Tensor) -> torch.Tensor:
    """Least-squares h from (..., R, 9) DLT rows: the eigenvector of the
    9x9 normal matrix with the smallest eigenvalue.  Its sign is
    arbitrary; compare H after dividing by H[2, 2]."""
    h = normal_eigvecs(rows)[..., :, 0]
    return h.reshape(h.shape[:-1] + (3, 3))


def _fit_h(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Minimal / least-squares fit; p1, p2 (..., S, 2)."""
    rows = _dlt_rows(p1, p2).reshape(p1.shape[:-2] + (-1, 9))
    return _h_from_rows(rows)


def _weighted_fit_h(p1, p2, w):
    """w: (..., N) weights (0 for outliers)."""
    rows = _dlt_rows(p1, p2) * w[..., None, None]
    return _h_from_rows(rows.reshape(rows.shape[:-3] + (-1, 9)))


def _error_fn(pars: RansacParams):
    if pars.error_type == RansacErrorType.SYMM_MAX:
        return lambda H, a, b: E.h_error_symm(H, a, b, mode="max")
    if pars.error_type == RansacErrorType.SAMPSON:
        return E.h_error_sampson
    return lambda H, a, b: E.h_error_symm(H, a, b, mode="sum")


def _uniform_index(shape, n: torch.Tensor, generator: torch.Generator,
                   device) -> torch.Tensor:
    """Uniform integers in [0, n) for a device-side count ``n``."""
    return _uniform_indices(shape, n[None], [generator], device)[0]


def _uniform_indices(shape, n: torch.Tensor, generators,
                     device) -> torch.Tensor:
    """(P,) + shape uniform integers, row p in [0, n[p]) drawn from
    ``generators[p]``."""
    u = torch.stack([torch.rand(shape, generator=g, device=device)
                     for g in generators])
    n = n.reshape((-1,) + (1,) * len(shape))
    return torch.minimum((u * n).to(torch.int64), n - 1)


def _needed_samples(bestc: int, nvalid: int, pars: RansacParams,
                    m: int = 4) -> float:
    """The adaptive stop for samples of ``m`` points (exp_ranH.c:366,
    exp_ranF.c:1060), in float32 as the JAX cond."""
    f32 = np.float32
    nf = max(f32(nvalid), f32(m))
    ratio = np.clip(f32(bestc) / nf, f32(1e-6), f32(1 - 1e-6))
    with np.errstate(over="ignore", divide="ignore"):
        # ratio ** 7 can round to 0: inf samples, capped below
        needed = np.log1p(f32(-pars.confidence)) / np.log1p(-(ratio ** m))
    return float(min(needed, f32(pars.max_samples)))


def ransac_h(xy1: torch.Tensor, xy2: torch.Tensor, mask: torch.Tensor,
             pars: RansacParams, generator):
    """Robust H (image1 -> image2) from fixed-capacity correspondences
    -> (H (3, 3), inliers (N,) bool, n_inl).  Hypotheses are fit in
    normalized coordinates and scored in pixels, so ``err_threshold``
    keeps its meaning.

    A pair batch, (P, N, 2) points and a (P, N) mask, takes a sequence of
    P generators and returns (P, 3, 3), (P, N) and (P,).  Pair p draws
    from its own generator only while its round count is short of its
    ``_needed_samples``, so it draws exactly what the serial call draws
    with that generator; the rounds go on until every pair is done, with
    one host read of the P best counts a round."""
    if xy1.dim() == 2:
        H, inl, n_inl = ransac_h(xy1[None], xy2[None], mask[None], pars,
                                 [generator])
        return H[0], inl[0], n_inl[0]
    P, n = mask.shape
    dev = xy1.device
    err_fn = _error_fn(pars)
    th = pars.err_threshold ** 2
    B = pars.batch_hypotheses
    if len(generator) != P:
        raise ValueError(f"{len(generator)} generators for {P} pairs")

    T1 = _normalization(xy1, mask)
    T2 = _normalization(xy2, mask)
    T2inv = E.inv_3x3(T2)
    p1 = _apply_T(T1, xy1)
    p2 = _apply_T(T2, xy2)
    nvalid = torch.clamp(mask.sum(-1), min=1)
    valid_idx, _ = nonzero_static(mask, n)

    def hyp_round(a, gens):
        """One round of B hypotheses for each pair of the index tensor
        ``a`` -> each one's best H and count."""
        idx = take_rows(valid_idx[a], _uniform_indices(
            (B, 4), nvalid[a], gens, dev), 1)                # (A, B, 4)
        # a sample with a repeated point is degenerate
        same = idx[..., :, None] == idx[..., None, :]
        distinct = ~(same & ~torch.eye(4, dtype=torch.bool,
                                       device=dev)).any((-2, -1))
        Hn = _fit_h(take_rows(p1[a], idx, 1), take_rows(p2[a], idx, 1))
        H = T2inv[a, None] @ Hn @ T1[a, None]
        h22 = H[..., 2:3, 2:3]
        H = H / torch.where(h22.abs() > 1e-12, h22, 1.0)
        cnt = torch.where(distinct, ((err_fn(H, xy1[a, None], xy2[a, None])
                                      < th) & mask[a, None]).sum(-1), -1)
        best = torch.argmax(cnt, -1)
        rows = torch.arange(len(gens), device=dev)
        return H[rows, best], cnt[rows, best]

    # adaptive round loop over the pairs still short of their samples:
    # one host read of the P best counts per round
    nvalid_host = nvalid.tolist()
    bestH = torch.eye(3, dtype=torch.float32, device=dev).repeat(P, 1, 1)
    bestc = torch.full((P,), -1, dtype=torch.int64, device=dev)
    bestc_host = [-1] * P
    done = [0] * P
    for _ in range(pars.max_rounds):
        act = [p for p in range(P) if done[p] < _needed_samples(
            bestc_host[p], nvalid_host[p], pars)]
        if not act:
            break
        a = torch.tensor(act, device=dev)
        H, c = hyp_round(a, [generator[p] for p in act])
        up = c > bestc[a]
        bestH[a] = torch.where(up[:, None, None], H, bestH[a])
        bestc[a] = torch.maximum(bestc[a], c)
        for p in act:
            done[p] += B
        bestc_host = bestc.tolist()

    if pars.local_optimization:
        bestH = _lo_refine(bestH, xy1, xy2, p1, p2, T1, T2inv, mask, th,
                           err_fn, pars, generator)

    inl = (err_fn(bestH, xy1, xy2) < th) & mask
    return bestH, inl, inl.to(torch.int32).sum(-1)


def _lo_refine(H, xy1, xy2, p1, p2, T1, T2inv, mask, th, err_fn,
               pars: RansacParams, generators):
    """Local optimization of each pair's (P, 3, 3) H:
    ``lo_inner_samples`` resamples of its inlier set, batched, each
    refined by ``lo_iters`` rounds of ILSQ with the threshold annealed
    from 4x down to 1x (exp_ranH.c:40-180)."""
    P, n = mask.shape
    dev = xy1.device
    a1, a2, m1 = xy1[:, None], xy2[:, None], mask[:, None]
    inl0 = (err_fn(H, xy1, xy2) < th) & mask
    n_inl = torch.clamp(inl0.sum(-1), min=1)
    iidx, _ = nonzero_static(inl0, n)
    R, S = pars.lo_inner_samples, pars.lo_sample_size
    ridx = take_rows(iidx, _uniform_indices((R, S), n_inl, generators, dev),
                     1)
    Hs = (T2inv[:, None] @ _fit_h(take_rows(p1, ridx, 1),
                                  take_rows(p2, ridx, 1))
          @ T1[:, None])                                    # (P, R, 3, 3)
    for i in range(pars.lo_iters):
        mth = max(4.0 * 0.5 ** i, 1.0) * th
        w = ((err_fn(Hs, a1, a2) < mth) & m1).to(torch.float32)
        Hn2 = (T2inv[:, None] @ _weighted_fit_h(p1[:, None], p2[:, None], w)
               @ T1[:, None])
        ok = torch.isfinite(Hn2).all(-1).all(-1)
        Hs = torch.where(ok[..., None, None], Hn2, Hs)
    cs = ((err_fn(Hs, a1, a2) < th) & m1).sum(-1)
    c0 = ((err_fn(H, xy1, xy2) < th) & mask).sum(-1)
    Hall = torch.cat([Hs, H[:, None]], 1)
    call = torch.cat([cs, c0[:, None]], 1)
    # torch.argmax returns the first maximal index, as jnp.argmax does
    return Hall[torch.arange(P, device=dev), torch.argmax(call, -1)]
