"""Geometric densification: match regions by ellipse overlap under a
known or estimated homography (mirrors ``mods_tpu/matching/densify.py``).

Reference: ``DensificationByHomography`` ->
``MatchRegionsByOverlapFastFLANN`` (matching/matching.cpp:669-806).  The
overlap matcher's body is commented out in the reference
(matching.cpp:690-806), so the shipped binary appends nothing; this is
the intended capability, batched: list-2 regions are mapped into image
1's frame by H^-1 and its local linearization (``linH``,
synth-detection.cpp:1172), an analytic ellipse-overlap error is computed
against each list-1 region's k nearest centres, and the best candidate
under ``max_error`` is accepted.

Overlap error: 1 - the Gaussian overlap ratio
    ovl = 4 sqrt(det C1 det C2) / det(C1 + C2) * exp(-dμᵀ(C1+C2)⁻¹dμ),
a smooth proxy of the Mikolajczyk ellipse-intersection measure
(matching.hpp:177-260), exact for equal ellipses and monotone in both
shape and centre disparity.  Plain torch on the tensors' device.
"""

from __future__ import annotations

import torch

from mods_tpu_torch.ransac.errors import inv_3x3


def _lin_h(Hinv: torch.Tensor, xy: torch.Tensor):
    """Project points by Hinv, and the local 2x2 linearization of Hinv at
    each point."""
    x, y = xy[..., 0], xy[..., 1]
    den = Hinv[2, 0] * x + Hinv[2, 1] * y + Hinv[2, 2]
    u = (Hinv[0, 0] * x + Hinv[0, 1] * y + Hinv[0, 2]) / den
    v = (Hinv[1, 0] * x + Hinv[1, 1] * y + Hinv[1, 2]) / den
    uv = torch.stack([u, v], -1)
    lin = (Hinv[None, :2, :2]
           - uv[..., None] * Hinv[None, 2:3, :2]) / den[..., None, None]
    return uv, lin


def overlap_error(xy1, C1, xy2, C2):
    """1 - Gaussian overlap of ellipses (..., 2), (..., 2, 2)."""
    Cs = C1 + C2
    det1 = C1[..., 0, 0] * C1[..., 1, 1] - C1[..., 0, 1] * C1[..., 1, 0]
    det2 = C2[..., 0, 0] * C2[..., 1, 1] - C2[..., 0, 1] * C2[..., 1, 0]
    dets = Cs[..., 0, 0] * Cs[..., 1, 1] - Cs[..., 0, 1] * Cs[..., 1, 0]
    dmu = xy1 - xy2
    # inverse of the 2x2 Cs
    inv = torch.stack([
        torch.stack([Cs[..., 1, 1], -Cs[..., 0, 1]], -1),
        torch.stack([-Cs[..., 1, 0], Cs[..., 0, 0]], -1)], -2) \
        / torch.clamp(dets, min=1e-12)[..., None, None]
    md = torch.einsum("...i,...ij,...j->...", dmu, inv, dmu)
    ovl = (4.0 * torch.sqrt(torch.clamp(det1 * det2, min=0.0))
           / torch.clamp(dets, min=1e-12)) * torch.exp(-md)
    return 1.0 - torch.clamp(ovl, 0.0, 1.0)


def densify_by_homography(xy1, A1, s1, m1, xy2, A2, s2, m2, H,
                          max_error: float = 0.5, knn: int = 30,
                          k_sigma: float = 3.0):
    """Match the regions of list 1 to those of list 2 by geometry alone
    under H (image 1 -> image 2).  Returns (idx2 (N1,), err (N1,), mask
    (N1,)).

    Covariances are (k_sigma * s * A)(...)^T; list-2 frames are pulled
    into image-1 coordinates with the local linearization of H^-1.  The
    k nearest centres are taken in the order of ``lax.top_k`` (ties to
    the lower index), by a stable sort."""
    Hinv = inv_3x3(torch.as_tensor(H, dtype=torch.float32,
                                   device=xy1.device))
    uv2, lin = _lin_h(Hinv, xy2)
    B2 = lin @ (A2 * (k_sigma * s2)[:, None, None])
    C2 = B2 @ B2.transpose(-1, -2)
    B1 = A1 * (k_sigma * s1)[:, None, None]
    C1 = B1 @ B1.transpose(-1, -2)

    d2 = ((xy1[:, None] - uv2[None]) ** 2).sum(-1)
    d2 = torch.where(m2[None], d2, torch.full_like(d2, float("inf")))
    k = min(knn, xy2.shape[0])
    idx = torch.sort(d2, dim=-1, stable=True)[1][:, :k]   # (N1, <=knn)

    err = overlap_error(xy1[:, None], C1[:, None], uv2[idx], C2[idx])
    err = torch.where(m2[idx], err, torch.full_like(err, float("inf")))
    best = torch.argmin(err, -1)
    best_err = torch.take_along_dim(err, best[:, None], -1)[:, 0]
    idx2 = torch.take_along_dim(idx, best[:, None], -1)[:, 0]
    ok = m1 & (best_err < max_error)
    return idx2, best_err, ok
