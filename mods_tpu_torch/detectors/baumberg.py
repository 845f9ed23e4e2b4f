"""Vectorized Baumberg affine-shape adaptation (mirrors
``mods_tpu/detectors/baumberg.py``; reference ``findAffineShape``,
affine.cpp:26-169).

All keypoints iterate together: per iteration one window-sampler launch
resamples the K 19x19 patches, then the masked second-moment matrix and
its closed-form inverse square root update each shape.  Keypoints that
diverge (anisotropy > 6, complex eigenvalues, NaN) or do not converge
within ``max_iterations`` are invalidated.
"""

from __future__ import annotations

import math

import torch

from mods_tpu_torch.config import AffineShapeParams
from mods_tpu_torch.ops.image import const, gauss_mask, patch_gradient
from mods_tpu_torch.ops.sampler import (MAX_HALF_EXTENT, pad_canvas,
                                        prepare_windows, sample_from_windows)


def inv_sqrt_2x2(a, b, c):
    """Closed-form inverse square root of SPD [[a,b],[b,c]], normalized to
    unit determinant -> (a', b', c', l1, l2), l1 >= l2 the unit-det
    eigenvalue pair (reference invSqrt, helpers.cpp:463-501)."""
    nz = b != 0
    r = torch.where(nz, (c - a) / (2 * torch.where(nz, b, 1.0)), 1.0)
    t = torch.where(
        nz,
        torch.where(r >= 0, 1.0 / (r + torch.sqrt(1 + r * r)),
                    -1.0 / (-r + torch.sqrt(1 + r * r))),
        0.0)
    cs = torch.where(nz, 1.0 / torch.sqrt(1 + t * t), 1.0)
    sn = t * cs
    x = 1.0 / torch.sqrt(cs * cs * a - 2 * cs * sn * b + sn * sn * c)
    z = 1.0 / torch.sqrt(sn * sn * a + 2 * cs * sn * b + cs * cs * c)
    d = torch.sqrt(x * z)
    x = x / d
    z = z / d
    l1 = torch.maximum(x, z)
    l2 = torch.minimum(x, z)
    na = cs * cs * x + sn * sn * z
    nb = -cs * sn * x + sn * cs * z
    nc = sn * sn * x + cs * cs * z
    return na, nb, nc, l1, l2


def eigenvalues_2x2(a, b, c, d):
    """(l1, l2, real) of a general 2x2 (reference getEigenvalues), with
    the discriminant in its cancellation-free form."""
    tr = a + d
    disc = (a - d) * (a - d) + 4.0 * b * c
    real = disc >= 0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    return (tr + sq) / 2.0, (tr - sq) / 2.0, real


def _prepare_smm_windows(blurs: torch.Tensor, lvl: torch.Tensor,
                         xy: torch.Tensor, max_norm: torch.Tensor,
                         half_w: int):
    """Fetch the per-keypoint windows ONCE for all iterations (only the
    shape matrix changes between them).  Keypoints whose reach exceeds
    the window read from a 2x-decimated copy of the stack.  Returns
    (window_source, xy_eff, inv_scale): sample with A * inv_scale."""
    stack = pad_canvas(blurs)
    l2, hc, wc = stack.shape
    dec = stack[:, ::2, ::2]
    dec = torch.nn.functional.pad(
        dec[:, None], (0, wc - dec.shape[2], 0, hc - dec.shape[1]),
        mode="replicate")[:, 0]
    big = torch.cat([stack, dec], 0)
    use_half = (max_norm * half_w * 1.4143) > (MAX_HALF_EXTENT - 2.0)
    inv_scale = torch.where(use_half, 0.5, 1.0)
    lvl_eff = lvl + l2 * use_half.to(lvl.dtype)
    xy_eff = xy * inv_scale[:, None]
    vhw = torch.tensor([[hc, wc]], dtype=torch.int32,
                       device=blurs.device).expand(2 * l2, 2)
    return (prepare_windows(big, lvl_eff, xy_eff, vhw, rows=96),
            xy_eff, inv_scale)


def baumberg_adapt(blurs: torch.Tensor, lvl: torch.Tensor,
                   xy_oct: torch.Tensor, s_oct: torch.Tensor,
                   valid: torch.Tensor, p: AffineShapeParams):
    """Unit-det affine shapes for a batch of keypoints.

    blurs (L+2, H, W) octave blur stack (views folded into the level
    axis); lvl (K,) the sampled level; xy_oct (K, 2) and s_oct (K,)
    octave-local.  Returns (A (K, 2, 2), ok (K,)).
    """
    K = lvl.shape[0]
    dev = blurs.device
    u = torch.eye(2, dtype=torch.float32, device=dev).expand(K, 2, 2)
    if not p.do_baumberg:
        return u, valid
    W = p.smm_window_size
    mask = const(gauss_mask(W), blurs)
    npix = float(W * W)
    ratio = s_oct / p.initial_sigma              # affine.cpp:33
    ws, xy_eff, inv_scale = _prepare_smm_windows(
        blurs, lvl, xy_oct, math.sqrt(6.0) * ratio, W // 2)

    act = torch.zeros((K,), dtype=torch.float32, device=dev)
    bef = torch.zeros_like(act)
    done = ~valid
    conv = torch.zeros((K,), dtype=torch.bool, device=dev)
    # The JAX package stops its while_loop once every keypoint is done.
    # ``done`` is absorbing (a done keypoint changes nothing), so running
    # all max_iterations gives bit-identical results without a host sync
    # per iteration.
    for _ in range(p.max_iterations):
        A = (u * ratio[:, None, None]) * inv_scale[:, None, None]
        patch = sample_from_windows(ws, xy_eff, A, W)
        fx, fy = patch_gradient(patch)
        a = (fx * fx * mask).sum((1, 2)) / npix
        b = (fx * fy * mask).sum((1, 2)) / npix
        c = (fy * fy * mask).sum((1, 2)) / npix
        na, nb, nc, l1s, l2s = inv_sqrt_2x2(a, b, c)
        nan_bad = ~(torch.isfinite(na) & torch.isfinite(nb)
                    & torch.isfinite(nc))
        new_bef = act
        new_act = 1.0 - l2s / l1s
        nu = torch.stack([
            torch.stack([na * u[:, 0, 0] + nb * u[:, 1, 0],
                         na * u[:, 0, 1] + nb * u[:, 1, 1]], -1),
            torch.stack([nb * u[:, 0, 0] + nc * u[:, 1, 0],
                         nb * u[:, 0, 1] + nc * u[:, 1, 1]], -1)], -2)
        e1, e2, real = eigenvalues_2x2(
            nu[:, 0, 0], nu[:, 0, 1], nu[:, 1, 0], nu[:, 1, 1])
        aniso_bad = (e1 / e2 > 6.0) | (e2 / e1 > 6.0)
        fail = nan_bad | ~real | aniso_bad
        step_ok = ~done & ~fail
        u = torch.where(step_ok[:, None, None], nu, u)
        act = torch.where(step_ok, new_act, act)
        bef = torch.where(step_ok, new_bef, bef)
        converged_now = (step_ok & (new_act < p.convergence_threshold)
                         & (new_bef < p.convergence_threshold))
        conv = conv | converged_now
        done = done | fail | converged_now
    return u, valid & conv
