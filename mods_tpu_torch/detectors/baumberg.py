"""Vectorized Baumberg affine-shape adaptation (mirrors
``mods_tpu/detectors/baumberg.py``; reference ``findAffineShape``,
affine.cpp:26-169).

Per iteration the K 19x19 patches are resampled with the current shape,
then the masked second-moment matrix and its closed-form inverse square
root update each shape.  Keypoints that diverge (anisotropy > 6, complex
eigenvalues, NaN) or do not converge within ``max_iterations`` are
invalidated.

``baumberg_adapt`` is the wrapper of the hand-written CUDA kernel
``csrc/baumberg_smm.cu``, which runs the whole iteration of one keypoint
in one block with its window held in shared memory: one launch per call.
A CUDA tensor launches the kernel or raises; a CPU tensor runs
``baumberg_adapt_plain``, the same arithmetic as a loop of PyTorch
operations over all keypoints together.  There is no fallback from the
one to the other.

Tolerance, kernel against plain version: ``ok`` differs on at most 1 % of
the valid keypoints and the shapes agree to 1e-3 where both converged.
The kernel copies the plain version's operations in their order, but its
block reduction adds the 361 terms of each second-moment sum in another
order than ``torch.sum``; over up to 16 fed-back iterations a keypoint
that sits on a threshold (0.05, 6.0) may fall to the other side.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mods_tpu_torch.config import AffineShapeParams
from mods_tpu_torch.ops.image import const, gauss_mask, patch_gradient
from mods_tpu_torch.ops.sampler import (MAX_HALF_EXTENT, PALLAS_COLS,
                                        WindowSource, pad_canvas,
                                        prepare_windows,
                                        sample_from_windows_plain)

SMM_ROWS = 96        # window rows: cover the +-42 px reach bound


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


def _smm_stack(blurs: torch.Tensor, lvl: torch.Tensor, xy: torch.Tensor,
               max_norm: torch.Tensor, half_w: int):
    """What every iteration samples from (only the shape matrix changes
    between them).  Keypoints whose reach exceeds the window read from a
    2x-decimated copy of the stack.  Returns (big, lvl_eff, xy_eff,
    inv_scale): the (2 * levels, hc, wc) stack of the padded levels and
    their decimated copies, each keypoint's plane and centre in it, and
    the factor its sampling matrix takes (sample with A * inv_scale)."""
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
    return big, lvl_eff, xy_eff, inv_scale


def _prepare_smm_windows(big: torch.Tensor, lvl_eff: torch.Tensor,
                         xy_eff: torch.Tensor) -> WindowSource:
    """The plain version's windows, fetched ONCE for all iterations.  No
    validity masking below the canvas size: out-of-image samples clamp to
    the replicated edge."""
    n, hc, wc = big.shape
    vhw = torch.tensor([[hc, wc]], dtype=torch.int32,
                       device=big.device).expand(n, 2)
    return prepare_windows(big, lvl_eff, xy_eff, vhw, rows=SMM_ROWS)


def smm_loop_plain(ws: WindowSource, xy_eff: torch.Tensor,
                   ratio: torch.Tensor, inv_scale: torch.Tensor,
                   valid: torch.Tensor, mask: torch.Tensor,
                   p: AffineShapeParams):
    """The iteration over all keypoints together -> (u (K, 2, 2), conv
    (K,)).

    The JAX package stops its while_loop once every keypoint is done.
    ``done`` is absorbing (a done keypoint changes nothing), so running
    all max_iterations gives bit-identical results without a host sync
    per iteration.
    """
    K = xy_eff.shape[0]
    dev = xy_eff.device
    W = mask.shape[-1]
    npix = float(W * W)
    u = torch.eye(2, dtype=torch.float32, device=dev).expand(K, 2, 2)
    act = torch.zeros((K,), dtype=torch.float32, device=dev)
    bef = torch.zeros_like(act)
    done = ~valid
    conv = torch.zeros((K,), dtype=torch.bool, device=dev)
    for _ in range(p.max_iterations):
        A = (u * ratio[:, None, None]) * inv_scale[:, None, None]
        patch = sample_from_windows_plain(ws, xy_eff, A, W)
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
    return u, conv


def _smm_inputs(blurs, lvl, xy_oct, s_oct, p: AffineShapeParams):
    """(big, lvl_eff, xy_eff, inv_scale, ratio, mask) of one call."""
    W = p.smm_window_size
    ratio = s_oct / p.initial_sigma              # affine.cpp:33
    big, lvl_eff, xy_eff, inv_scale = _smm_stack(
        blurs, lvl, xy_oct, math.sqrt(6.0) * ratio, W // 2)
    return big, lvl_eff, xy_eff, inv_scale, ratio, const(gauss_mask(W),
                                                         blurs)


def baumberg_adapt_plain(blurs: torch.Tensor, lvl: torch.Tensor,
                         xy_oct: torch.Tensor, s_oct: torch.Tensor,
                         valid: torch.Tensor, p: AffineShapeParams):
    """``baumberg_adapt`` as a loop of PyTorch operations: the kernel's
    plain version."""
    big, lvl_eff, xy_eff, inv_scale, ratio, mask = _smm_inputs(
        blurs, lvl, xy_oct, s_oct, p)
    ws = _prepare_smm_windows(big, lvl_eff, xy_eff)
    u, conv = smm_loop_plain(ws, xy_eff, ratio, inv_scale, valid, mask, p)
    return u, valid & conv


@functools.lru_cache(maxsize=None)
def _baumberg_smm_fn():
    from mods_tpu_torch import csrc
    fn = csrc.load("baumberg_smm").baumberg_smm
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _smm_loop_cuda(big: torch.Tensor, lvl_eff: torch.Tensor,
                   xy_eff: torch.Tensor, ratio: torch.Tensor,
                   inv_scale: torch.Tensor, valid: torch.Tensor,
                   mask: torch.Tensor, p: AffineShapeParams):
    """Launch the fused kernel (no launch is counted here) -> (u (K, 2,
    2), conv (K,) bool, iterations run (K,) int32)."""
    dev = big.device
    K = xy_eff.shape[0]
    W = mask.shape[-1]
    if not big.is_cuda or big.dtype != torch.float32 or big.dim() != 3:
        raise ValueError(f"baumberg_smm: the level stack must be a float32 "
                         f"(planes, H, W) CUDA tensor, got {big.dtype} "
                         f"{tuple(big.shape)} on {dev}")
    planes, hc, wc = big.shape
    if hc < SMM_ROWS or wc < PALLAS_COLS or wc % 4:
        raise ValueError(f"baumberg_smm: a ({hc}, {wc}) canvas cannot hold "
                         f"({SMM_ROWS}, {PALLAS_COLS}) windows in 16-byte "
                         "aligned rows")
    args = [(big, torch.float32, (planes, hc, wc)),
            (lvl_eff.to(torch.int32), torch.int32, (K,)),
            (xy_eff, torch.float32, (K, 2)),
            (inv_scale, torch.float32, (K,)),
            (ratio, torch.float32, (K,)),
            (valid, torch.bool, (K,)),
            (mask, torch.float32, (W, W))]
    for t, dt, shape in args:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(
                f"baumberg_smm: expected {dt} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
    tensors = [t.contiguous() for t, _, _ in args]
    if tensors[0].data_ptr() % 16:
        raise ValueError("baumberg_smm: the level stack is not 16-byte "
                         "aligned")
    u = torch.empty((K, 2, 2), dtype=torch.float32, device=dev)
    conv = torch.empty((K,), dtype=torch.bool, device=dev)
    iters = torch.empty((K,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        big_c, *per_kp = tensors
        err = _baumberg_smm_fn()(
            big_c.data_ptr(), planes, hc, wc,
            *(t.data_ptr() for t in per_kp), W, int(p.max_iterations),
            float(p.convergence_threshold), u.data_ptr(), conv.data_ptr(),
            iters.data_ptr(), K, stream)
    if err != 0:
        raise RuntimeError(f"baumberg_smm launch failed: CUDA error {err}")
    return u, conv, iters


def baumberg_adapt(blurs: torch.Tensor, lvl: torch.Tensor,
                   xy_oct: torch.Tensor, s_oct: torch.Tensor,
                   valid: torch.Tensor, p: AffineShapeParams):
    """Unit-det affine shapes for a batch of keypoints.

    blurs (L+2, H, W) octave blur stack (views folded into the level
    axis); lvl (K,) the sampled level; xy_oct (K, 2) and s_oct (K,)
    octave-local.  Returns (A (K, 2, 2), ok (K,)).  CUDA tensors launch
    the fused kernel once (and count the launch); CPU tensors run
    ``baumberg_adapt_plain``.
    """
    if not p.do_baumberg:
        K = lvl.shape[0]
        u = torch.eye(2, dtype=torch.float32,
                      device=blurs.device).expand(K, 2, 2)
        return u, valid
    if not blurs.is_cuda:
        return baumberg_adapt_plain(blurs, lvl, xy_oct, s_oct, valid, p)
    for name, t, ok in (("lvl", lvl, not lvl.is_floating_point()),
                        ("xy_oct", xy_oct, xy_oct.dtype == torch.float32),
                        ("s_oct", s_oct, s_oct.dtype == torch.float32),
                        ("valid", valid, valid.dtype == torch.bool)):
        if t.device != blurs.device or not ok:
            raise ValueError(f"baumberg_adapt: {name} is {t.dtype} on "
                             f"{t.device}; the level stack is on "
                             f"{blurs.device}")
    big, lvl_eff, xy_eff, inv_scale, ratio, mask = _smm_inputs(
        blurs, lvl, xy_oct, s_oct, p)
    u, conv, _ = _smm_loop_cuda(big, lvl_eff, xy_eff, ratio, inv_scale,
                                valid, mask, p)
    baumberg_adapt.launches += 1
    return u, valid & conv


baumberg_adapt.launches = 0         # kernel launches, for chip_smoke.py
