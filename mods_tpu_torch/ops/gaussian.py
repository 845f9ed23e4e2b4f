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
