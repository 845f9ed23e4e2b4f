"""Anti-aliased descriptor patch extraction on the mip stack (mirrors
``mods_tpu/descriptors/describe.py``; reference ``DescribeRegions``,
synth-detection.hpp:169-255).

Per keypoint the mip level that bounds the sampling step is picked, the
P x P patch is sampled through the window sampler, and the reference's
1.5-sampling-step Gaussian is applied as a band-matrix product (reduced
on levels >= 1, which carry prefilter already).  t <= 0.4 keeps the
reference's direct, unblurred path (synth-detection.hpp:196-200).

``extract_descriptor_patches`` is the JAX package's single-image form of
the same pipeline: a (2P+1)^2 patch sampled at a step of at most one
image pixel through ``ops/warp.py::extract_patches``, blurred and
resampled to P x P by one folded (P, 2P+1) matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from mods_tpu_torch.ops.gaussian import blur_band_matrix
from mods_tpu_torch.ops.image import circular_gauss_mask, const
from mods_tpu_torch.ops.sampler import sample_mip_patches, select_level
from mods_tpu_torch.ops.warp import extract_patches

DESC_MIP_LEVELS = 4


def image_to_patch_scale(s: torch.Tensor, mr_size: float,
                         patch_size: int) -> torch.Tensor:
    """t = (2*ceil(s*mrSize)+1) / patchSize (synth-detection.hpp:187-189)."""
    return (2.0 * torch.ceil(s * mr_size) + 1.0) / patch_size


def blur_patches(patches: torch.Tensor, sigma: float) -> torch.Tensor:
    """(K, P, P) separable blur with replicate borders, as two batched
    band-matrix products."""
    M = const(blur_band_matrix(patches.shape[-1], float(sigma)), patches)
    out = torch.einsum("ij,kjc->kic", M, patches)
    return torch.einsum("kic,jc->kij", out, M)


def _resample_matrix(P: int, SP: int) -> np.ndarray:
    """(P, SP) bilinear row interpolation at the fixed grid
    c_i = (i - P//2) * SP/P + SP//2 of the oversampled patch."""
    half = P >> 1
    c = (np.arange(P) - half) * (SP / P) + (SP >> 1)
    i0 = np.clip(np.floor(c).astype(np.int64), 0, SP - 2)
    w = (c - i0).astype(np.float32)
    R = np.zeros((P, SP), np.float32)
    R[np.arange(P), i0] = 1.0 - w
    R[np.arange(P), i0 + 1] = w
    return R


def extract_descriptor_patches(img: torch.Tensor, xy: torch.Tensor,
                               A: torch.Tensor, s: torch.Tensor,
                               mr_size: float, patch_size: int,
                               photo_norm: bool = False) -> torch.Tensor:
    """(K,) regions on an (H, W) view image -> (K, P, P) patches: the
    oversampled patch, blurred by 1.5 sampling steps and resampled in one
    folded matrix (t > 0.4), or sampled directly at step t."""
    P = patch_size
    SP = 2 * P + 1
    t = image_to_patch_scale(s, mr_size, P)
    over = extract_patches(img, xy, A * (t * P / SP)[:, None, None], SP)
    M2 = const(_resample_matrix(P, SP) @ np.asarray(
        blur_band_matrix(SP, 1.5 * SP / P), np.float32), img)
    aa = torch.einsum("ps,ksq->kpq", M2, over)
    aa = torch.einsum("kpq,rq->kpr", aa, M2)
    direct = extract_patches(img, xy, A * t[:, None, None], P)
    patches = torch.where((t > 0.4)[:, None, None], aa, direct)
    if photo_norm:
        patches = photometric_normalize(patches)
    return patches


def extract_descriptor_patches_mip(mips: torch.Tensor,
                                   valid_hw: torch.Tensor, xy: torch.Tensor,
                                   A: torch.Tensor, s: torch.Tensor,
                                   mr_size: float, patch_size: int,
                                   photo_norm: bool = False) -> torch.Tensor:
    """(K,) regions -> (K, P, P) patches from ``sampler.mip_stack(img,
    DESC_MIP_LEVELS)``; (..., K) regions of a batch's (..., L, Hc, Wc)
    stacks -> (rows, P, P), in one launch."""
    P = patch_size
    t = image_to_patch_scale(s, mr_size, P)
    As = A * t[..., None, None]
    lvl, scale = select_level(As, P, mips.shape[-3])
    raw = sample_mip_patches(mips, valid_hw, lvl, xy / scale[..., None],
                             As / scale[..., None, None], P)
    return aa_filter_patches(raw, lvl.reshape(-1), t.reshape(-1),
                             photo_norm=photo_norm)


def aa_filter_patches(raw: torch.Tensor, lvl: torch.Tensor, t: torch.Tensor,
                      photo_norm: bool = False) -> torch.Tensor:
    """The post-sampling half of the AA pipeline: a 1.5-step (level 0) or
    0.9-step (levels >= 1) Gaussian as band-matrix products, the direct
    path for t <= 0.4, then optional photometric normalization."""
    P = raw.shape[-1]
    B15 = const(blur_band_matrix(P, 1.5), raw)
    B09 = const(blur_band_matrix(P, 0.9), raw)

    def band(Bm, x):
        y = torch.einsum("ij,kjc->kic", Bm, x)
        return torch.einsum("kic,jc->kij", y, Bm)

    aa = torch.where((lvl == 0)[:, None, None], band(B15, raw),
                     band(B09, raw))
    patches = torch.where((t > 0.4)[:, None, None], aa, raw)
    if photo_norm:
        patches = photometric_normalize(patches)
    return patches


def photometric_normalize(patches: torch.Tensor) -> torch.Tensor:
    """photometricallyNormalize (helpers.cpp:712-760): mean 128, std 50,
    clipped to 0..255, statistics over the circular Gaussian support."""
    P = patches.shape[-1]
    mask = (const(circular_gauss_mask(P), patches) > 0)[None]
    n = mask.sum()
    mean = torch.where(mask, patches, 0.0).sum((1, 2), keepdim=True) / n
    var = torch.where(mask, (patches - mean) ** 2, 0.0).sum(
        (1, 2), keepdim=True) / n
    std = torch.sqrt(var)
    out = 128.0 + (50.0 / torch.clamp(std, min=1e-4)) * (patches - mean)
    out = out.clamp(0.0, 255.0)
    return torch.where(std < 1e-4, patches, out)
