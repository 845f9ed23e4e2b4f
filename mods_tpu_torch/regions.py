"""Fixed-capacity SoA container for affine-covariant regions (mirrors
``mods_tpu/regions.py``).

A region is an affine frame: center ``xy``, unit-determinant 2x2 shape
matrix ``A``, isotropic scale ``s`` in pixels, detector response and a
point sub-type.  Counts are ``mask.sum()``; the capacity is static.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from mods_tpu_torch.ops.select import top_k

_FIELDS = ("xy", "A", "s", "response", "sub_type", "mask")
# trailing per-region axes of each field
_EXTRA = {"xy": 1, "A": 2, "s": 0, "response": 0, "sub_type": 0, "mask": 0}


@dataclass(frozen=True)
class Regions:
    """SoA batch of affine regions; leading shape ``(K,)`` or ``(V, K)``."""

    xy: torch.Tensor        # (..., 2) float32
    A: torch.Tensor         # (..., 2, 2) float32
    s: torch.Tensor         # (...,) float32
    response: torch.Tensor  # (...,) float32
    sub_type: torch.Tensor  # (...,) int32
    mask: torch.Tensor      # (...,) bool

    @property
    def capacity(self) -> int:
        return self.mask.shape[-1]

    def count(self) -> torch.Tensor:
        return self.mask.to(torch.int32).sum(-1)

    def replace(self, **kw) -> "Regions":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "Regions":
        """Apply ``fn(tensor, n_trailing_axes)`` to every field."""
        return Regions(**{f: fn(getattr(self, f), _EXTRA[f])
                          for f in _FIELDS})

    def take(self, idx: torch.Tensor) -> "Regions":
        """Gather along the capacity axis (take_along_axis semantics)."""
        def g(x, extra):
            ix = idx.reshape(idx.shape + (1,) * extra).expand(
                idx.shape + x.shape[x.ndim - extra:])
            return torch.gather(x, idx.ndim - 1, ix)
        return self.map(g)

    def masked_where(self, keep: torch.Tensor) -> "Regions":
        return self.replace(mask=self.mask & keep)


def upright(xy, s, response, mask, sub_type=None) -> Regions:
    """Regions with the identity shape (the detectors that find no affine
    shape: FAST, STAR, SURF, KAZE, TILDE); ``sub_type`` defaults to 0."""
    shape = mask.shape
    A = torch.eye(2, device=mask.device).expand(shape + (2, 2)).contiguous()
    if sub_type is None:
        sub_type = torch.zeros(shape, dtype=torch.int32, device=mask.device)
    return Regions(xy=xy, A=A, s=s, response=response, sub_type=sub_type,
                   mask=mask)


def concat_regions(rs: list[Regions]) -> Regions:
    """Concatenate region sets along the capacity (last mask) axis."""
    axis = rs[0].mask.ndim - 1
    return Regions(**{f: torch.cat([getattr(r, f) for r in rs], dim=axis)
                      for f in _FIELDS})


def compact_topk(r: Regions, k: int, by: str = "mask") -> Regions:
    """Compact valid regions to the front and truncate capacity to ``k``.

    ``by='response'`` orders by |response| descending; ``by='mask'`` keeps
    the original order among valid entries.  Ties go to the lower slot,
    as with ``lax.top_k`` (see ops/select.py).
    """
    if k > r.capacity:
        pad = k - r.capacity

        def padfn(x, extra):
            shape = list(x.shape)
            shape[x.ndim - extra - 1] = pad
            return torch.cat([x, x.new_zeros(shape)], dim=x.ndim - extra - 1)
        r = r.map(padfn)
    ninf = torch.tensor(-float("inf"), device=r.mask.device)
    if by == "response":
        key = torch.where(r.mask, r.response.abs(), ninf)
    else:
        n = r.capacity
        key = torch.where(
            r.mask, -torch.arange(n, dtype=torch.float32,
                                  device=r.mask.device), ninf)
    kk, idx = top_k(key, k)
    out = r.take(idx)
    return out.replace(mask=out.mask & (kk > -float("inf")))


def regions_from_numpy(xy, A, s, response, mask, sub_type=None,
                       device="cpu") -> Regions:
    """``Regions`` from host arrays (for instance the fields of a JAX-side
    ``Regions``), so that a later stage can be checked on identical
    input."""
    import numpy as np

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)
    mask = torch.as_tensor(np.asarray(mask), dtype=torch.bool, device=device)
    if sub_type is None:
        sub = torch.zeros(mask.shape, dtype=torch.int32, device=device)
    else:
        sub = torch.as_tensor(np.asarray(sub_type), dtype=torch.int32,
                              device=device)
    return Regions(xy=f32(xy), A=f32(A), s=f32(s), response=f32(response),
                   sub_type=sub, mask=mask)
