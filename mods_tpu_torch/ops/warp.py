"""Bilinear gathers, patch grids and the view-synthesis warps (mirrors
``mods_tpu/ops/warp.py``).

Out-of-bounds samples return ``fill``; a sample is valid iff
floor(x) in [0, W-2] and floor(y) in [0, H-2], the reference's safe
``interpolate`` rule (helpers.cpp:574-607).
"""

from __future__ import annotations

import math

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


def affine_warp(img: torch.Tensor, inv_map: torch.Tensor, out_h: int,
                out_w: int, fill: float = 128.0) -> torch.Tensor:
    """Warp (H, W) -> (out_h, out_w) through the 2x3 inverse map (output
    pixel -> input position), bilinear, ``fill`` outside."""
    ys = torch.arange(out_h, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.arange(out_w, dtype=torch.float32, device=img.device)[None, :]
    m = inv_map.to(device=img.device, dtype=torch.float32)
    sx = m[0, 0] * xs + m[0, 1] * ys + m[0, 2]
    sy = m[1, 0] * xs + m[1, 1] * ys + m[1, 2]
    return bilinear_sample(img, sx, sy, fill=fill)


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


def _shear_x(img: torch.Tensor, slope: torch.Tensor, off: torch.Tensor,
             out_w: int, fill: float) -> torch.Tensor:
    """out[r, c] = img[r, c + slope*r + off], linear along x, ``fill``
    outside; img (H, W), slope and off 0-dim tensors.

    The JAX package reads one slice per 8-row block at the block's least
    integer offset and resolves each row's residual shift in [0, 8]
    inside it; the block origin is clipped into the padded row.  This is
    the same arithmetic per row (block origin, clip, residual, weight) as
    one gather, so both give the same values also where the clip acts.
    |slope| <= 1 keeps the residual within the block."""
    H, W = img.shape
    Hp = -(-H // 8) * 8
    pad = out_w + 16
    img_p = torch.nn.functional.pad(img, (pad, pad, 0, Hp - H), value=fill)
    r = torch.arange(Hp, dtype=torch.float32, device=img.device)
    s = slope * r + off
    sb = s.reshape(Hp // 8, 8)
    base = torch.floor(sb.amin(dim=1))
    delta = sb - base[:, None]                              # [0, 8]
    basei = (to_index(base) + pad).clamp(0, W + 2 * pad - out_w - 10)
    d0 = torch.floor(delta)
    w = (delta - d0).reshape(Hp, 1)
    d0i = to_index(d0).reshape(Hp)
    # a residual outside [0, 8] matches none of the JAX form's 9 shifted
    # views and gives 0 there
    inside = ((d0i >= 0) & (d0i <= 8))[:, None]
    start = basei.repeat_interleave(8) + d0i.clamp(0, 8)
    idx = start[:, None] + torch.arange(out_w, device=img.device)
    lo = torch.gather(img_p, 1, idx)
    hi = torch.gather(img_p, 1, idx + 1)
    out = torch.where(inside, lo * (1.0 - w) + hi * w, 0.0)
    return out[:H]


def shear_rotate(img: torch.Tensor, rot_inv: torch.Tensor, out_h: int,
                 out_w: int, fill: float = 128.0) -> torch.Tensor:
    """Rotation warp of (H, W) as three x-shears (with transposes
    between), for a 2x3 inverse map whose linear part is a pure rotation
    (``mods_tpu/ops/warp.py::shear_rotate``): with
    theta = atan2(-rot_inv[1,0], rot_inv[0,0]), alpha = tan(theta/2),
    beta = -sin(theta).  |theta| > pi/2 first flips the source (both axes
    reversed == rotation by pi), so alpha stays <= 1.  Three 1-D linear
    interpolations, not one 2-D bilinear: values differ from a bilinear
    warp by up to 1 %, and equal the JAX package's."""
    a = rot_inv[0, 0]
    c_ = rot_inv[1, 0]
    tx = rot_inv[0, 2]
    ty = rot_inv[1, 2]
    theta = torch.atan2(-c_, a)
    H, W = img.shape
    flip = theta.abs() > (math.pi / 2 + 1e-6)
    theta_f = theta - torch.sign(theta) * math.pi
    img_eff = torch.where(flip, img.flip(0, 1), img)
    th = torch.where(flip, theta_f, theta)
    txe = torch.where(flip, (W - 1.0) - tx, tx)
    tye = torch.where(flip, (H - 1.0) - ty, ty)
    alpha = torch.tan(th / 2.0)
    beta = -torch.sin(th)
    wa = out_w + H + 8
    sa = _shear_x(img_eff, alpha, txe - alpha * tye, wa, fill)
    sb = _shear_x(sa.T, beta, tye, out_h, fill).T
    return _shear_x(sb, alpha, torch.zeros_like(alpha), out_w, fill)


def separable_scale(img: torch.Tensor, inv_sx, inv_sy, out_h: int,
                    out_w: int) -> torch.Tensor:
    """Axis-aligned scale warp of (..., H, W) (x_src = inv_sx * x,
    y_src = inv_sy * y) as two 1-D resamples, indices clamped into the
    image; inv_sx and inv_sy are floats or 0-dim tensors."""
    H, W = img.shape[-2:]
    dev = img.device
    src_y = torch.arange(out_h, dtype=torch.float32, device=dev) * inv_sy
    y0 = torch.floor(src_y)
    wy = (src_y - y0)[:, None]
    i0 = to_index(y0).clamp(0, H - 1)
    i1 = (i0 + 1).clamp(0, H - 1)
    rows = (img.index_select(-2, i0) * (1.0 - wy)
            + img.index_select(-2, i1) * wy)
    src_x = torch.arange(out_w, dtype=torch.float32, device=dev) * inv_sx
    x0 = torch.floor(src_x)
    wx = src_x - x0
    j0 = to_index(x0).clamp(0, W - 1)
    j1 = (j0 + 1).clamp(0, W - 1)
    return (rows.index_select(-1, j0) * (1.0 - wx)
            + rows.index_select(-1, j1) * wx)
