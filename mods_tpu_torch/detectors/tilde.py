"""TILDE: learned filter-bank keypoint detector (mirrors
``mods_tpu/detectors/tilde.py``; reference ``TILDE/c++/src/libTILDE.cpp``
``getTILDEKeyPoints`` and ``applyNonApproxFilters`` :745-840, loader
``getTILDENonApproxFilters`` :642-730, dispatched at
imagerepresentation.cpp:1109-1131 and as a scale-space response,
pyramid.cpp:182-197).

score = sum_s (-1)^(s+1) * max_m (sum_ch conv(ch_c, w[s,m,c]) * K^2 + b)
over nbSum cascades of nbMax filters on 6 feature channels (grayscale:
gradient triplet + luminance triplet), then a sigma = 2 blur and a 5x5
NMS.  The whole bank is one ``conv2d`` (zero padding K // 2, the "SAME"
padding of the JAX package's convolution; TF32 off).  Learned filters
are per-scene data files (``load_tilde_filters``); ``procedural_filters``
is the JAX package's self-contained default bank, built the same way
with numpy.

The bank is zero-mean up to its float32 rounding, so its response to a
flat patch (the 128 fill around a rotated view, a saturated sky) is the
rounding of the sums: +3.3e-7 exactly for the procedural bank, -1.7e-7
in the JAX package's CPU convolution, -2.3e-7 in PyTorch's, another
value in cuDNN's.  Whether such a plateau passes ``score > 0`` is that
rounding's sign, as in the JAX package; where it passes, its pixels fill
the raster-order cap ahead of the real maxima.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from mods_tpu_torch.config import CapacityParams
from mods_tpu_torch.ops.gaussian import gaussian_blur
from mods_tpu_torch.ops.select import nonzero_static
from mods_tpu_torch.regions import Regions, compact_topk, upright


def load_tilde_filters(path: str):
    """Parse the reference's non-approximated filter text format
    (getTILDENonApproxFilters, libTILDE.cpp:642-730): line 1 parameters
    (resizeRatio ...), line 2 "nbFilters nbChannels sizeFilters", then
    per filter of a cascade nbChannels blocks of sizeFilters rows and one
    bias line; cascades repeat (a repeated header line between them)
    until the end.  Returns (weights (S, M, C, K, K), biases (S, M),
    resize)."""
    with open(path) as f:
        lines = [ln for ln in (raw.strip() for raw in f) if ln]
    resize = float(lines[0].split()[0])
    hdr = lines[1].split()
    nb_filters = int(float(hdr[0]))
    nb_channels = int(float(hdr[1]))
    size = int(float(hdr[2]))
    pos = 2
    cascades = []
    while pos < len(lines):
        cascade_w, cascade_b = [], []
        for _ in range(nb_filters):
            chans = []
            for _ in range(nb_channels):
                rows = []
                for _ in range(size):
                    rows.append([float(x) for x in lines[pos].split()[:size]])
                    pos += 1
                chans.append(rows)
            cascade_b.append(float(lines[pos].split()[0]))
            pos += 1
            cascade_w.append(chans)
        cascades.append((cascade_w, cascade_b))
        if pos < len(lines) and len(lines[pos].split()) == 3:
            pos += 1
    W = np.asarray([c[0] for c in cascades], np.float32)
    b = np.asarray([c[1] for c in cascades], np.float32)
    return W, b, resize


@functools.lru_cache(maxsize=2)
def procedural_filters(n_sum: int = 4, n_max: int = 4, n_ch: int = 6,
                       size: int = 21, seed: int = 11):
    """The JAX package's default bank: oriented Gabor-like filters across
    channels from numpy's ``default_rng(seed)``, not learned weights."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    c = (size - 1) / 2.0
    W = np.zeros((n_sum, n_max, n_ch, size, size), np.float32)
    for s in range(n_sum):
        for m in range(n_max):
            th = math.pi * (s * n_max + m) / (n_sum * n_max)
            fx = math.cos(th) / 6.0
            fy = math.sin(th) / 6.0
            env = np.exp(-((xx - c) ** 2 + (yy - c) ** 2) / (2 * 25.0))
            carrier = np.cos(2 * np.pi * (fx * (xx - c) + fy * (yy - c)))
            g = env * carrier
            g -= g.mean()
            for ch in range(n_ch):
                W[s, m, ch] = g * rng.uniform(0.5, 1.0) / (size * size)
    b = np.zeros((n_sum, n_max), np.float32)
    return W, b


@functools.lru_cache(maxsize=8)
def tilde_bank(path: str = "", device: str = "cpu"):
    """The filter bank of ``path`` (``load_tilde_filters``; the
    procedural bank where empty) as float32 tensors on ``device``, made
    once: weights (S, M, C, K, K) and biases (S, M)."""
    W, b = load_tilde_filters(path)[:2] if path else procedural_filters()
    return (torch.as_tensor(W, dtype=torch.float32, device=device),
            torch.as_tensor(b, dtype=torch.float32, device=device))


def _channels(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, 6, H, W): (gx, gy, |grad|, L, L, L), the
    grayscale analogue of the reference's grad(3) + LUV(3) stack
    (prepareData, libTILDE.cpp:297-325)."""
    g = img / 255.0
    gx = 0.5 * (torch.cat([g[..., :, 1:], g[..., :, -1:]], -1)
                - torch.cat([g[..., :, :1], g[..., :, :-1]], -1))
    gy = 0.5 * (torch.cat([g[..., 1:, :], g[..., -1:, :]], -2)
                - torch.cat([g[..., :1, :], g[..., :-1, :]], -2))
    mag = torch.sqrt(gx * gx + gy * gy)
    return torch.stack([gx, gy, mag, g, g, g], 1)


def tilde_response(img: torch.Tensor, W, b) -> torch.Tensor:
    """(..., H, W) images -> TILDE score maps (applyNonApproxFilters:
    per-cascade channel-summed convolutions + bias, max over the cascade,
    alternating-sign sum over cascades, sigma = 2 smoothing).  ``W``,
    ``b``: (S, M, C, K, K) and (S, M), tensors on ``img``'s device
    (``tilde_bank``) or numpy arrays, uploaded here."""
    S, M, C, K, _ = W.shape
    lead = img.shape[:-2]
    H, Wd = img.shape[-2:]
    ch = _channels(img.reshape(-1, H, Wd))
    kern = torch.as_tensor(W, dtype=torch.float32,
                           device=img.device).reshape(S * M, C, K, K)
    bias = torch.as_tensor(b, dtype=torch.float32,
                           device=img.device).reshape(S * M)
    resp = F.conv2d(ch, kern, padding=K // 2)          # (B, S*M, H, W)
    resp = resp * (K * K) + bias[:, None, None]
    casc = resp.reshape(-1, S, M, H, Wd).amax(2)       # (B, S, H, W)
    # even-indexed cascades are negated (libTILDE.cpp:1321+)
    sign = torch.tensor([-((-1.0) ** s) for s in range(S)],
                        dtype=torch.float32, device=img.device)
    score = (sign[:, None, None] * casc).sum(1)
    return gaussian_blur(score, 2.0).reshape(lead + (H, Wd))


def tilde_extrema(views: torch.Tensor, valid_hw: torch.Tensor,
                  filters=None, threshold: float = 0.0):
    """(V, H, W) -> (score (V, H, W), extremum mask (V, H, W)): the 5x5
    maxima above ``threshold`` at least 11 px inside each view's valid
    extent, before ``detect_tilde``'s raster-order cap.  ``filters``:
    (W, b) as ``tilde_response`` takes them (``tilde_bank()`` when
    None)."""
    if filters is None:
        filters = tilde_bank("", str(views.device))
    V, H, Wd = views.shape
    dev = views.device
    score = tilde_response(views, filters[0], filters[1])
    mx = F.max_pool2d(score[:, None], 5, stride=1, padding=2)[:, 0]
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(Wd, device=dev)[None, None, :]
    vh = valid_hw[:, 0, None, None]
    vw = valid_hw[:, 1, None, None]
    bd = 11
    inb = ((rows >= bd) & (rows < vh - bd) & (cols >= bd) & (cols < vw - bd))
    return score, (score > threshold) & (score >= mx) & inb


def detect_tilde(views: torch.Tensor, valid_hw: torch.Tensor,
                 caps: CapacityParams, filters=None,
                 threshold: float = 0.0) -> Regions:
    """(V, H, W) -> Regions (V, caps.per_view): ``tilde_extrema``, the
    first ``caps.per_view`` in raster order, ranked by score."""
    V, H, Wd = views.shape
    dev = views.device
    cap = caps.per_view
    score, ext = tilde_extrema(views, valid_hw, filters, threshold)
    idx, valid = nonzero_static(ext.reshape(V, -1), cap)
    regs = upright(
        torch.stack([idx % Wd, idx // Wd], -1).to(torch.float32),
        torch.full((V, cap), 10.0 / 5.1962, device=dev),  # scaleKeypoint
        torch.gather(score.reshape(V, -1), 1, idx), valid)
    return compact_topk(regs, cap, by="response")
