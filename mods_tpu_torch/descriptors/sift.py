"""SIFT-family descriptors as batched tensor contractions (mirrors
``mods_tpu/descriptors/sift.py``; reference ``SIFTDescriptor``,
matching/siftdesc.{h,cpp}).

Per orientation bin, desc[b, d, o] = Wr[r, b] * V_o[r, c] * Wc[c, d];
normalized and quantized to the reference's "length 512, clip 255"
integers (siftdesc.cpp:247-278).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from mods_tpu_torch.config import SIFTDescriptorParams
from mods_tpu_torch.ops.image import circular_gauss_mask, const, \
    patch_gradient


@functools.lru_cache(maxsize=16)
def spatial_bin_weights(patch_size: int, spatial_bins: int) -> np.ndarray:
    """(P, B) weights of precomputeBinsAndWeights (siftdesc.cpp:22-70):
    each pixel feeds <= 2 spatial bins linearly."""
    half = patch_size >> 1
    step = float(spatial_bins + 1) / (2 * half)
    W = np.zeros((patch_size, spatial_bins), np.float32)
    for i in range(patch_size):
        x = step * i
        xi = int(x)
        b0, b1 = xi - 1, xi
        w1 = x - xi
        w0 = 1.0 - w1
        if 0 <= b0 < spatial_bins:
            W[i, b0] += w0
        if 0 <= b1 < spatial_bins:
            W[i, b1] += w1
    return W


def sift_histograms(patches: torch.Tensor,
                    p: SIFTDescriptorParams) -> torch.Tensor:
    """(K, P, P) -> unnormalized (K, spatial, spatial, ori) histograms."""
    k, pS, _ = patches.shape
    mask = const(circular_gauss_mask(pS), patches)
    gx, gy = patch_gradient(patches)
    mag = torch.sqrt(gx * gx + gy * gy)
    ori = torch.atan2(gy, gx)
    val = torch.ones_like(mag) if p.magn_less else mask[None] * mag
    ob = p.orientation_bins
    o = ob * (ori + 2.0 * math.pi) / (2.0 * math.pi)
    bo0 = o.to(torch.int32)
    wo1 = o - bo0.to(o.dtype)
    bo0 = bo0 % ob
    bo1 = (bo0 + 1) % ob
    wo0 = 1.0 - wo1
    W = const(spatial_bin_weights(pS, p.spatial_bins), patches)
    out = []
    for b in range(ob):
        vo = val * (torch.where(bo0 == b, wo0, 0.0)
                    + torch.where(bo1 == b, wo1, 0.0))
        out.append(torch.einsum("rb,krc,cd->kbd", W, vo, W))
    return torch.stack(out, -1)


def _l2_normalize(v: torch.Tensor) -> torch.Tensor:
    n = torch.sqrt((v * v).sum(-1, keepdim=True))
    return v / torch.where(n > 0, n, 1.0)


def sift_norm(v: torch.Tensor, max_bin: float, root: bool) -> torch.Tensor:
    """SIFTnorm / RootSIFTnorm (siftdesc.cpp:199-278): L2 -> clip ->
    re-L2 -> (root: L1 + sqrt) -> floor(512 v + 0.5) clipped to 0..255."""
    v = _l2_normalize(v)
    v = torch.clamp(v, max=max_bin)
    v = _l2_normalize(v)
    if root:
        s = v.abs().sum(-1, keepdim=True)
        v = torch.sqrt(v / torch.where(s > 0, s, 1.0))
    return torch.floor(512.0 * v + 0.5).clamp(0.0, 255.0)


def compute_sift(patches: torch.Tensor,
                 p: SIFTDescriptorParams) -> torch.Tensor:
    """(K, P, P) float patches -> (K, dims) quantized descriptors."""
    h = sift_histograms(patches, p)
    k = h.shape[0]
    if p.half_sift:
        half = p.orientation_bins // 2
        h = h[..., :half] + h[..., half:]
    v = h.reshape(k, -1)
    if p.do_norm:
        v = sift_norm(v, p.max_bin_value, p.root_sift)
    return v
