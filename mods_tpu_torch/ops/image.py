"""Image primitives (mirrors ``mods_tpu/ops/image.py``).

Float32, value range 0..255, (..., H, W) layout with no channel axis.
"""

from __future__ import annotations

import numpy as np
import torch


def to_gray(img: torch.Tensor) -> torch.Tensor:
    """RGB (H, W, 3) or gray (H, W) uint8/float -> float32 equal-weight
    mean gray (synth-detection.cpp:257-262), on the tensor's device."""
    img = img.to(torch.float32)
    if img.ndim == 3:                    # XLA's mean: sum x (1 / n)
        img = img.sum(dim=-1) * (1.0 / img.shape[-1])
    return img


def pad_to(img: torch.Tensor, h: int, w: int,
           value: float = 0.0) -> torch.Tensor:
    """Pad (..., H, W) at the bottom and right to the canvas (h, w)."""
    ph, pw = h - img.shape[-2], w - img.shape[-1]
    assert ph >= 0 and pw >= 0, (tuple(img.shape), h, w)
    return torch.nn.functional.pad(img, (0, pw, 0, ph), value=value)


def double_image(img: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample of (..., H, W) to (2H-1, 2W-1), the original
    samples at even positions and the means of neighbours between them
    (the reference's doubleImage, helpers.cpp)."""
    h, w = img.shape[-2], img.shape[-1]
    rows = img.new_zeros(img.shape[:-2] + (2 * h - 1, w))
    rows[..., 0::2, :] = img
    rows[..., 1::2, :] = 0.5 * (img[..., :-1, :] + img[..., 1:, :])
    out = img.new_zeros(img.shape[:-2] + (2 * h - 1, 2 * w - 1))
    out[..., :, 0::2] = rows
    out[..., :, 1::2] = 0.5 * (rows[..., :, :-1] + rows[..., :, 1:])
    return out


def half_image(img: torch.Tensor) -> torch.Tensor:
    """2x downsample by 2x2 mean pooling over (..., H, W); an odd tail
    row or column is cropped (the reference's next-octave step,
    pyramid.cpp:516-518)."""
    h, w = img.shape[-2], img.shape[-1]
    img = img[..., :h - (h % 2), :w - (w % 2)]
    x = img.reshape(img.shape[:-2] + (h // 2, 2, w // 2, 2))
    return x.mean(dim=(-3, -1))


def gradient(img: torch.Tensor):
    """Central-difference gradient, zero on the 1 px border
    (reference computeGradient, helpers.cpp:800-838)."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[..., 1:-1, 1:-1] = img[..., 1:-1, 2:] - img[..., 1:-1, :-2]
    gy[..., 1:-1, 1:-1] = img[..., 2:, 1:-1] - img[..., :-2, 1:-1]
    return gx, gy


def patch_gradient(p: torch.Tensor):
    """Gradient with one-sided differences at the borders, as used on
    descriptor patches (reference siftdesc.cpp:300-325)."""
    gx = torch.cat([p[..., :, 1:2] - p[..., :, 0:1],
                    p[..., :, 2:] - p[..., :, :-2],
                    p[..., :, -1:] - p[..., :, -2:-1]], dim=-1)
    gy = torch.cat([p[..., 1:2, :] - p[..., 0:1, :],
                    p[..., 2:, :] - p[..., :-2, :],
                    p[..., -1:, :] - p[..., -2:-1, :]], dim=-2)
    return gx, gy


def circular_gauss_mask(size: int, sigma: float = 0.0) -> np.ndarray:
    """computeCircularGaussMask (helpers.cpp): exp(-d^2/sigma2) inside the
    strictly inscribed circle; sigma == 0 selects 0.9 * halfSize^2."""
    half = size >> 1
    r2 = float(half * half)
    sigma2 = 0.9 * r2 if sigma == 0 else 2.0 * float(sigma) * float(sigma)
    ys, xs = np.mgrid[0:size, 0:size].astype(np.float64)
    d2 = (xs - half) ** 2 + (ys - half) ** 2
    mask = np.where(d2 < r2, np.exp(-d2 / sigma2), 0.0)
    return mask.astype(np.float32)


def gauss_mask(size: int) -> np.ndarray:
    """Separable Gaussian mask with 3*sigma fit into halfSize — the
    Baumberg SMM window (computeGaussMask, helpers.cpp)."""
    half = size >> 1
    scale = half / 3.0
    i = np.arange(-half, size - half, dtype=np.float64)
    t = np.exp(-(i * i) / (2.0 * scale * scale))
    return np.outer(t, t).astype(np.float32)


def const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A host constant (mask, taps, bin weights) on ``like``'s device."""
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def to_gray_np(img: np.ndarray) -> np.ndarray:
    """RGB (H, W, 3) or gray (H, W) -> float32 equal-weight mean gray on
    the host (synth-detection.cpp:257-262)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 3:
        img = img.mean(axis=-1, dtype=np.float32)
    return img


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
