"""Dominant-orientation estimation over region batches (mirrors
``mods_tpu/descriptors/orientation.py``; reference ``DetectOrientation``,
synth-detection.cpp:722-919): a 36-bin gradient-orientation histogram
over a circular-Gaussian-masked patch, 6 circular smoothing passes,
parabolic peak interpolation, peaks >= th * max kept in bin order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mods_tpu_torch.ops.image import circular_gauss_mask, const
from mods_tpu_torch.ops.sampler import sample_mip_patches, select_level
from mods_tpu_torch.ops.select import top_k
from mods_tpu_torch.ops.warp import touches_border

BINS = 36


def orientation_histograms(patches: torch.Tensor) -> torch.Tensor:
    """(K, P, P) patches -> (K, 36) raw histograms over the patch interior,
    weighted by magnitude x mask where mask > 0 and magnitude > 1
    (synth-detection.cpp:781-792)."""
    k, pS, _ = patches.shape
    mask = const(circular_gauss_mask(pS, pS / 3.0), patches)
    gx = patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2]
    gy = patches[:, 2:, 1:-1] - patches[:, :-2, 1:-1]
    mag = torch.sqrt(gx * gx + gy * gy)
    ori = torch.atan2(gy, gx)
    w = mask[1:-1, 1:-1][None]
    weight = torch.where((w > 0) & (mag > 1.0), mag * w, 0.0)
    binf = BINS * (ori / math.pi + 1.0) / 2.0
    bini = binf.to(torch.int32).clamp(0, BINS)
    bini = torch.where(bini == BINS, 0, bini)   # the reference's hist[36]
    onehot = F.one_hot(bini.reshape(k, -1).long(), BINS).to(patches.dtype)
    return torch.einsum("kp,kpb->kb", weight.reshape(k, -1), onehot)


def smooth_circular(hist: torch.Tensor, passes: int = 6) -> torch.Tensor:
    """[1 1 1] circular smoothing, 6 passes (synth-detection.cpp:724-735)."""
    for _ in range(passes):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1))
    return hist


def find_peaks(hist: torch.Tensor, max_angles: int, th: float,
               half_sift: bool = False):
    """Local maxima >= th*max with parabolic interpolation -> (angles
    (K, max_angles) radians, mask).  Peaks are taken in bin order
    (synth-detection.cpp:814-840): the static top-``max_angles`` of
    -bin, with ``top_k``'s stable tie order (ops/select.py)."""
    mx = hist.amax(-1, keepdim=True)
    thresh = mx * th
    if half_sift:
        half = BINS // 2
        folded = hist[..., :half] + hist[..., half:]
        hist = torch.cat([folded, torch.zeros_like(folded)], -1)
    prev = torch.roll(hist, 1, -1)
    nxt = torch.roll(hist, -1, -1)
    is_peak = (hist >= thresh) & (hist > prev) & (hist > nxt)
    pp = (prev - nxt) / (prev - 2.0 * hist + nxt) / 2.0
    pp = torch.where(torch.isfinite(pp), pp, 0.0)
    bins = torch.arange(BINS, dtype=hist.dtype, device=hist.device)
    ang = (2.0 * math.pi * (bins[None] + 0.5 + pp) / BINS) - math.pi
    key = torch.where(is_peak, -bins[None],
                      torch.tensor(-float("inf"), device=hist.device))
    _, idx = top_k(key, max_angles)
    return torch.gather(ang, -1, idx), torch.gather(is_peak, -1, idx)


def rotate_shapes(A: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """A' = A @ R(-angle) (synth-detection.cpp:897-906): A (..., K, 2, 2),
    angles (..., K, M) -> (..., K, M, 2, 2)."""
    ci = torch.cos(-angles)
    si = torch.sin(-angles)
    a11 = A[..., None, 0, 0] * ci - A[..., None, 0, 1] * si
    a12 = A[..., None, 0, 0] * si + A[..., None, 0, 1] * ci
    a21 = A[..., None, 1, 0] * ci - A[..., None, 1, 1] * si
    a22 = A[..., None, 1, 0] * si + A[..., None, 1, 1] * ci
    return torch.stack([torch.stack([a11, a12], -1),
                        torch.stack([a21, a22], -1)], -2)


def detect_orientations(img: torch.Tensor, xy: torch.Tensor,
                        A: torch.Tensor, s: torch.Tensor,
                        valid: torch.Tensor, mr_size: float,
                        patch_size: int, max_angles: int, th: float,
                        half_sift: bool = False,
                        k_sigma: float = 6.0 * 1.7320508, *, mip_src):
    """Per-region dominant angles from a view image (H, W); regions (K,)
    -> (angles (K, M), mask (K, M)).  Regions whose k_sigma*s window
    touches the border are dropped (synth-detection.cpp:873-886).
    ``mip_src`` = (mips, valid_hw) from ``sampler.mip_stack``: every
    patch goes through the window sampler, as on the flagship path.  A
    batch of images, (P, H, W) with (P, K) regions and (P, L, Hc, Wc)
    mips, runs in the same single launch."""
    h, w = img.shape[-2:]
    patch_image_size = 2 * int(mr_size) + 1
    img_to_patch = patch_image_size / patch_size
    half_ext = torch.ceil(k_sigma * s / 2.0)
    bad = touches_border(w, h, xy, A, half_ext, half_ext)
    ok = valid & ~bad
    curr = img_to_patch * s
    As = A * curr[..., None, None]
    mips, valid_hw = mip_src
    lvl, scale = select_level(As, patch_size, mips.shape[-3])
    patches = sample_mip_patches(
        mips, valid_hw, lvl, xy / scale[..., None],
        As / scale[..., None, None], patch_size)
    hist = smooth_circular(orientation_histograms(patches))
    angles, pmask = find_peaks(hist.reshape(s.shape + (BINS,)), max_angles,
                               th, half_sift)
    return angles, pmask & ok[..., None]
