"""Bilinear gathers and patch grids (mirrors ``mods_tpu/ops/warp.py``).

Out-of-bounds samples return ``fill``; a sample is valid iff
floor(x) in [0, W-2] and floor(y) in [0, H-2], the reference's safe
``interpolate`` rule (helpers.cpp:574-607).
"""

from __future__ import annotations

import torch


def to_index(f: torch.Tensor) -> torch.Tensor:
    """float -> int64 with JAX's ``astype(int32)`` behaviour on the values
    the samplers see: NaN goes to 0 and huge values saturate (the
    callers clamp the result into range afterwards)."""
    f = torch.nan_to_num(f, nan=0.0).clamp(-2.0 ** 30, 2.0 ** 30)
    return f.to(torch.int64)


def gather_4plane(img: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor):
    """The 2x2 neighbourhood at int (y0, x0) of (H, W) as four planes
    (p00, p01, p10, p11); starts are clipped into range."""
    h, w = img.shape
    flat = img.reshape(-1)
    y0 = y0.clamp(0, h - 2)
    x0 = x0.clamp(0, w - 2)
    base = y0 * w + x0
    return (flat[base], flat[base + 1], flat[base + w], flat[base + w + 1])


def gather_4plane_level(vol: torch.Tensor, lvl: torch.Tensor,
                        y0: torch.Tensor, x0: torch.Tensor):
    """As gather_4plane from a (L, H, W) stack with per-index level."""
    l, h, w = vol.shape
    flat = vol.reshape(-1)
    lvl = torch.broadcast_to(lvl, y0.shape)
    y0 = y0.clamp(0, h - 2)
    x0 = x0.clamp(0, w - 2)
    base = (lvl.clamp(0, l - 1) * h + y0) * w + x0
    return (flat[base], flat[base + 1], flat[base + w], flat[base + w + 1])


def _bilinear_combine4(p00, p01, p10, p11, wx, wy):
    top = p00 + wx * (p01 - p00)
    bot = p10 + wx * (p11 - p10)
    return top + wy * (bot - top)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    fill: float = 0.0) -> torch.Tensor:
    """Sample (H, W) at float coords of any (broadcastable) shape."""
    h, w = img.shape[-2], img.shape[-1]
    x, y = torch.broadcast_tensors(x, y)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = to_index(x0)
    y0i = to_index(y0)
    valid = (x0i >= 0) & (y0i >= 0) & (x0i < w - 1) & (y0i < h - 1)
    val = _bilinear_combine4(*gather_4plane(img, y0i, x0i), wx, wy)
    return torch.where(valid, val, torch.full_like(val, fill))


def patch_grid(patch_size: int, device=None) -> torch.Tensor:
    """(P, P, 2) grid of patch offsets in [-half, +half], (dx, dy) order
    (interpolate, helpers.cpp:562-572)."""
    half = patch_size >> 1
    r = torch.arange(-half, patch_size - half, dtype=torch.float32,
                     device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([dx, dy], dim=-1)


def extract_patches(img: torch.Tensor, xy: torch.Tensor, A: torch.Tensor,
                    patch_size: int, fill: float = 0.0) -> torch.Tensor:
    """patch[k, j, i] = img(xy_k + A_k @ [dx_i, dy_j]), bilinear, for a
    (K,) batch on one (H, W) image -> (K, P, P)."""
    g = patch_grid(patch_size, img.device)
    coords = torch.einsum("kab,ijb->kija", A, g) + xy[:, None, None, :]
    return bilinear_sample(img, coords[..., 0], coords[..., 1], fill=fill)


def touches_border(img_w, img_h, xy, A, half_extent_x, half_extent_y,
                   clamp_frac=None):
    """Vectorized ``interpolateCheckBorders`` (helpers.cpp:524-549): True
    if the affine-mapped patch corners leave the safe interior.
    ``clamp_frac`` bounds the corner offsets to that fraction of the
    image extent first (see the JAX docstring)."""
    hw = torch.ceil(torch.as_tensor(half_extent_x, dtype=torch.float32,
                                    device=xy.device))
    hh = torch.ceil(torch.as_tensor(half_extent_y, dtype=torch.float32,
                                    device=xy.device))
    cx = torch.stack([-hw, -hw, hw, hw], dim=-1)
    cy = torch.stack([-hh, hh, -hh, hh], dim=-1)
    dx = cx * A[..., 0, 0:1] + cy * A[..., 0, 1:2]
    dy = cx * A[..., 1, 0:1] + cy * A[..., 1, 1:2]
    if clamp_frac is not None:
        dx = dx.clamp(-clamp_frac * img_w, clamp_frac * img_w)
        dy = dy.clamp(-clamp_frac * img_h, clamp_frac * img_h)
    ix = xy[..., 0:1] + dx
    iy = xy[..., 1:2] + dy
    bad = ((torch.floor(ix) <= 0) | (torch.floor(iy) <= 0)
           | (torch.ceil(ix) >= img_w - 2) | (torch.ceil(iy) >= img_h - 2))
    return bad.any(dim=-1)
