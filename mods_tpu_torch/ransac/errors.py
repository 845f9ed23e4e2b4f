"""Geometric residuals for H and F, batched over (hypotheses, points)
(mirrors ``mods_tpu/ransac/errors.py``; reference degensac/Htools.c and
degensac/Ftools.c).  H maps image1 -> image2 homogeneous coords
(x2 ~ H x1); F is the fundamental matrix with x2^T F x1 = 0.
"""

from __future__ import annotations

import torch


def inv_3x3(H: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 3, 3)."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1)], -2)
    return adj / det[..., None, None]


def h_transfer(H: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Apply (..., 3, 3) H to (N, 2) points -> (..., N, 2)."""
    x, y = xy[..., 0], xy[..., 1]
    w = H[..., 2:3, 0] * x + H[..., 2:3, 1] * y + H[..., 2:3, 2]
    u = (H[..., 0:1, 0] * x + H[..., 0:1, 1] * y + H[..., 0:1, 2]) / w
    v = (H[..., 1:2, 0] * x + H[..., 1:2, 1] * y + H[..., 1:2, 2]) / w
    return torch.stack([u, v], -1)


def h_error_symm(H: torch.Tensor, xy1: torch.Tensor, xy2: torch.Tensor,
                 Hinv: torch.Tensor | None = None,
                 mode: str = "sum") -> torch.Tensor:
    """Symmetric transfer error (HDsSym / HDsSymMax, Htools.c:26-39):
    (..., N) squared px |x2 - H x1|^2 (+|max) |x1 - H^-1 x2|^2."""
    if Hinv is None:
        Hinv = inv_3x3(H)
    f = h_transfer(H, xy1) - xy2
    b = h_transfer(Hinv, xy2) - xy1
    d1 = (f * f).sum(-1)
    d2 = (b * b).sum(-1)
    if mode == "max":
        return torch.maximum(d1, d2)
    return d1 + d2


def h_error_forward(H: torch.Tensor, xy1: torch.Tensor,
                    xy2: torch.Tensor) -> torch.Tensor:
    """One-directional transfer |x2 - H x1|^2 (HDsi-style)."""
    f = h_transfer(H, xy1) - xy2
    return (f * f).sum(-1)


def h_error_sampson(H: torch.Tensor, xy1: torch.Tensor,
                    xy2: torch.Tensor) -> torch.Tensor:
    """Sampson H error, the reference's ``HDs`` (Htools.c:158-200)."""
    x1, y1 = xy1[..., 0], xy1[..., 1]
    x2, y2 = xy2[..., 0], xy2[..., 1]

    def row(i):
        return (H[..., i:i + 1, 0] * x1 + H[..., i:i + 1, 1] * y1
                + H[..., i:i + 1, 2])

    def hij(i, j):
        return H[..., i:i + 1, j]

    u, v, w = row(0), row(1), row(2)
    e1 = x2 * w - u
    e2 = y2 * w - v
    j11 = x2 * hij(2, 0) - hij(0, 0)
    j12 = x2 * hij(2, 1) - hij(0, 1)
    j21 = y2 * hij(2, 0) - hij(1, 0)
    j22 = y2 * hij(2, 1) - hij(1, 1)
    a = j11 * j11 + j12 * j12 + w * w
    b = j11 * j21 + j12 * j22
    c = j21 * j21 + j22 * j22 + w * w
    det = torch.clamp(a * c - b * b, min=1e-12)
    return (c * e1 * e1 - 2.0 * b * e1 * e2 + a * e2 * e2) / det


def _homog(xy: torch.Tensor) -> torch.Tensor:
    return torch.cat([xy, torch.ones_like(xy[..., :1])], -1)


def f_epipolar_lines(F: torch.Tensor, xy1: torch.Tensor) -> torch.Tensor:
    """l2 = F x1 for (..., 3, 3) x (N, 2) -> (..., N, 3)."""
    return torch.einsum("...ij,nj->...ni", F, _homog(xy1))


def _f_terms(F, xy1, xy2):
    """(x2^T F x1, F x1, F^T x2) over the (..., 3, 3) models."""
    x1 = _homog(xy1)
    x2 = _homog(xy2)
    Fx1 = torch.einsum("...ij,nj->...ni", F, x1)
    Ftx2 = torch.einsum("...ji,nj->...ni", F, x2)
    num = torch.einsum("ni,...ni->...n", x2, Fx1)
    return num, Fx1, Ftx2


def f_error_sampson(F: torch.Tensor, xy1: torch.Tensor,
                    xy2: torch.Tensor) -> torch.Tensor:
    """Sampson distance^2 (FDs, degensac/Ftools.c)."""
    num, Fx1, Ftx2 = _f_terms(F, xy1, xy2)
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2
           + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2)
    return num * num / torch.clamp(den, min=1e-20)


def f_error_symepi(F: torch.Tensor, xy1: torch.Tensor,
                   xy2: torch.Tensor) -> torch.Tensor:
    """Symmetric squared epipolar distance (FDsSym, Ftools.c)."""
    num, Fx1, Ftx2 = _f_terms(F, xy1, xy2)
    d1 = num * num / torch.clamp(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2,
                                 min=1e-20)
    d2 = num * num / torch.clamp(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2,
                                 min=1e-20)
    return d1 + d2
