"""Separable Gaussian blur (mirrors ``mods_tpu/ops/gaussian.py``).

The reference's ``gaussianBlur`` (helpers.cpp): kernel size
``int(6*sigma+1)`` forced odd, replicate border, sampled-Gaussian taps.
Here it is two 1-D ``conv2d`` passes (rows, then columns) over a
replicate-padded input, with the same taps as the JAX package.  TF32 is
off for cuDNN (``mods_tpu_torch/__init__.py``), so the convolutions run
in full float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=256)
def gauss_kernel_1d(sigma: float) -> np.ndarray:
    """OpenCV-style sampled Gaussian taps, normalized to sum 1."""
    size = int(2.0 * 3.0 * float(sigma) + 1.0)
    if size % 2 == 0:
        size += 1
    size = max(size, 3)
    half = size // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * float(sigma) * float(sigma)))
    k /= k.sum()
    return k.astype(np.float32)


@functools.lru_cache(maxsize=256)
def blur_band_matrix(n: int, sigma: float) -> np.ndarray:
    """(n, n) banded matrix M with ``M @ x`` == replicate-border Gaussian
    filtering of a length-n signal."""
    taps = gauss_kernel_1d(sigma)
    half = len(taps) // 2
    M = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    for k, t in enumerate(taps):
        j = np.clip(idx + k - half, 0, n - 1)
        np.add.at(M, (idx, j), t)
    return M


def _conv1d(x4: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Replicate-border 1-D filter of (B, 1, H, W) along H (axis=-2) or
    W (axis=-1)."""
    half = len(taps) // 2
    k = torch.as_tensor(taps, device=x4.device)
    if axis == -1:
        x = F.pad(x4, (half, half, 0, 0), mode="replicate")
        w = k.reshape(1, 1, 1, -1)
    else:
        x = F.pad(x4, (0, 0, half, half), mode="replicate")
        w = k.reshape(1, 1, -1, 1)
    return F.conv2d(x, w)


def gaussian_blur(img: torch.Tensor, sigma: float,
                  sigma_y: float | None = None) -> torch.Tensor:
    """Blur (..., H, W) with a replicate-border separable Gaussian;
    ``sigma_y`` gives an anisotropic blur."""
    if sigma_y is None:
        sigma_y = sigma
    lead = img.shape[:-2]
    h, w = img.shape[-2:]
    x = img.reshape(-1, 1, h, w)
    x = _conv1d(x, gauss_kernel_1d(float(sigma_y)), axis=-2)
    x = _conv1d(x, gauss_kernel_1d(float(sigma)), axis=-1)
    return x.reshape(lead + (h, w))


def _taps_rt(sigma, radius: int, device=None) -> torch.Tensor:
    """(2*radius+1,) Gaussian taps from a runtime sigma (a float or a
    0-dim tensor), windowed to the reference's ``int(6*sigma+1)`` odd
    support: taps outside are zero.  Computed in float32 on the device."""
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=device)
    sigma = torch.clamp(sigma, min=1e-6)
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    size = torch.floor(6.0 * sigma + 1.0)
    size = size + (1.0 - torch.remainder(size, 2.0))      # force odd
    size = torch.clamp(size, min=3.0)
    half = (size - 1.0) / 2.0
    taps = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    taps = torch.where(x.abs() <= half, taps, 0.0)
    return taps / taps.sum()


def _shift_blur(img: torch.Tensor, taps: torch.Tensor,
                axis: int) -> torch.Tensor:
    """Replicate-border 1-D blur of (..., H, W) along ``axis`` (-2 or -1)
    with a tap tensor: out = sum_k taps[k] * img shifted by (k - r).  The
    JAX package writes the sum out as shifted adds; here it is one
    ``conv2d`` over the replicate-padded input (same taps, another order
    of summation)."""
    r = taps.shape[0] // 2
    lead = img.shape[:-2]
    h, w = img.shape[-2:]
    x = img.reshape(-1, 1, h, w)
    if axis == -1:
        x = F.pad(x, (r, r, 0, 0), mode="replicate")
        k = taps.reshape(1, 1, 1, -1)
    else:
        x = F.pad(x, (0, 0, r, r), mode="replicate")
        k = taps.reshape(1, 1, -1, 1)
    return F.conv2d(x, k).reshape(lead + (h, w))


# fixed band radius of the runtime-sigma blur: covers int(6*sigma+1) for
# every sigma the synthesis grids produce (tilt <= 12 at initSigma 0.8
# -> sigma 4.8 -> half-window 14)
RT_BLUR_RADIUS = 15


def gaussian_blur_rt(img: torch.Tensor, sigma_x, sigma_y,
                     radius: int = RT_BLUR_RADIUS) -> torch.Tensor:
    """Anisotropic replicate-border blur of (..., H, W) with runtime
    sigmas: the anti-alias blur of view synthesis, whose sigmas vary per
    tilt and zoom (synth-detection.cpp:349-363)."""
    out = _shift_blur(img, _taps_rt(sigma_y, radius, img.device), axis=-2)
    return _shift_blur(out, _taps_rt(sigma_x, radius, img.device), axis=-1)
