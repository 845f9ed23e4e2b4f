"""Local-affine-frame consistency check of verified matches (mirrors
``mods_tpu/ransac/laf_check.py``; reference ``H_LAF_check``,
matching/matching.cpp:251-309): each match contributes 3 point pairs,
the center plus the two affine-frame axis endpoints
center + k_sigma*s*A[:, j], whose model error must stay below a
coefficient times the RANSAC threshold; ``f_laf_check`` is
``F_LAF_check`` (matching.cpp:193-250) of the LORANSACF and ORSA modes.
"""

from __future__ import annotations

import torch

from mods_tpu_torch.ransac import errors as E

K_SIGMA = 2.0 * 3.0 * (3.0 ** 0.5)  # synth-detection.cpp:28


def _laf_points(xy, A, s):
    """(..., N, 3, 2): center, center + ks*s*A[:,1], center + ks*s*A[:,0]."""
    ax0 = xy + K_SIGMA * s[..., None] * A[..., :, 0]
    ax1 = xy + K_SIGMA * s[..., None] * A[..., :, 1]
    return torch.stack([xy, ax1, ax0], dim=-2)


def h_laf_check(H, xy1, A1, s1, xy2, A2, s2, mask, threshold):
    """Keep matches whose 3 LAF point pairs satisfy
    sqrt(sum of symmetric-max H errors) <= threshold (the call site
    passes 3 * HLAFCoef * err_threshold, matching.cpp:896-967).  A
    leading pair axis on every argument checks each pair against its
    own H."""
    if threshold <= 0:
        return mask
    p1 = _laf_points(xy1, A1, s1)
    p2 = _laf_points(xy2, A2, s2)
    lead = xy1.shape[:-1]
    e = E.h_error_symm(H, p1.reshape(lead[:-1] + (-1, 2)),
                       p2.reshape(lead[:-1] + (-1, 2)),
                       mode="max").reshape(lead + (3,))
    err = torch.sqrt(e.sum(-1))
    return mask & (err <= threshold)


def f_laf_check(F, xy1, A1, s1, xy2, A2, s2, mask, threshold,
                sampson: bool = True):
    """F_LAF_check: keep matches whose sum of square-rooted per-point
    epipolar errors is <= threshold (the call site passes
    LAFCoef * err_threshold)."""
    if threshold <= 0:
        return mask
    p1 = _laf_points(xy1, A1, s1)
    p2 = _laf_points(xy2, A2, s2)
    n = xy1.shape[0]
    fn = E.f_error_sampson if sampson else E.f_error_symepi
    e = fn(F, p1.reshape(-1, 2), p2.reshape(-1, 2)).reshape(n, 3)
    err = torch.sqrt(torch.clamp(e, min=0.0)).sum(-1)
    return mask & (err <= threshold)
