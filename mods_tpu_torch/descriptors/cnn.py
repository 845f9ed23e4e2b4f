"""CNN patch descriptor, the reference's Caffe descriptor slot
(imagerepresentation.cpp:1343-1534; mirrors ``mods_tpu/descriptors/cnn.py``).

The reference extracts patches at CaffeDescParam.{mrSize,patchSize},
mean-subtracts, runs a batched Caffe forward, reads a named layer blob
and L1/L2/RootL2-normalizes it.  Here the patch batch is already a
tensor on the card, and the forward is ``CnnDescriptor``: 5x5 conv ->
ReLU -> 2x2 max pool -> 5x5 conv -> ReLU -> 2x2 max pool -> a head conv
over the whole map, in float32 (TF32 off, ``mods_tpu_torch/__init__.py``).

Weights are the JAX package's numpy tuple (w1, b1, w2, b2, w3, b3) in
OIHW: an ``.npz`` (WeightsFile), the trained net that ships at
``mods_tpu_torch/data/cnn_patch128.npz`` (a byte-identical copy of the
JAX package's), or a procedural bank (Gabor first layer, orthogonalized
random deeper layers) that needs no file.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# input patches are uint8-quantized gray in the reference; per-channel
# means B104 G117 R123 average to this
MEAN_GRAY = (104.0 + 117.0 + 123.0) / 3.0

WEIGHT_KEYS = ("w1", "b1", "w2", "b2", "w3", "b3")


def _gabor_bank(k: int, n: int, rng) -> np.ndarray:
    """(n, 1, k, k) oriented Gabor + centre-surround filters."""
    half = k // 2
    y, x = np.mgrid[-half:half + 1, -half:half + 1].astype(np.float64)
    out = []
    n_ori = max(n - 2, 1)
    for i in range(n):
        if i == n - 1:          # DoG centre-surround
            f = (np.exp(-(x**2 + y**2) / (2 * 1.0**2))
                 - 0.55 * np.exp(-(x**2 + y**2) / (2 * 2.0**2)))
        elif i == n - 2:        # low-pass
            f = np.exp(-(x**2 + y**2) / (2 * 1.5**2))
        else:
            th = np.pi * i / n_ori
            lam = 3.0 + 2.0 * (i % 2)
            xr = x * np.cos(th) + y * np.sin(th)
            yr = -x * np.sin(th) + y * np.cos(th)
            f = (np.exp(-(xr**2 + 0.5 * yr**2) / (2 * 1.8**2))
                 * np.cos(2 * np.pi * xr / lam))
        f = f - f.mean()
        f = f / max(np.abs(f).sum(), 1e-9)
        out.append(f)
    return np.asarray(out, np.float32)[:, None]


def _ortho(rng, shape) -> np.ndarray:
    """Random matrix with orthonormal rows (QR), reshaped to ``shape``.
    The signs of LAPACK's QR may depend on its build:
    ``weights_sha256`` names the result so two machines can be held to
    each other."""
    fan_out = shape[0]
    fan_in = int(np.prod(shape[1:]))
    n = max(fan_out, fan_in)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return (q[:fan_out, :fan_in] * np.sqrt(2.0)).reshape(shape) \
        .astype(np.float32)


@functools.lru_cache(maxsize=8)
def procedural_weights(patch_size: int = 32, dim: int = 128,
                       seed: int = 0):
    """Deterministic default net: 5x5 Gabor conv (16ch) -> pool2 ->
    5x5 conv (32ch) -> pool2 -> global conv head to ``dim``."""
    rng = np.random.default_rng(seed)
    c1, c2 = 16, 32
    w1 = _gabor_bank(5, c1, rng)                      # (16,1,5,5)
    b1 = np.zeros((c1,), np.float32)
    w2 = _ortho(rng, (c2, c1, 5, 5)) / 5.0
    b2 = np.zeros((c2,), np.float32)
    s = ((patch_size - 4) // 2 - 4) // 2    # VALID conv, pool, conv, pool
    w3 = _ortho(rng, (dim, c2, s, s)) / float(s)
    b3 = np.zeros((dim,), np.float32)
    return (w1, b1, w2, b2, w3, b3)


@functools.lru_cache(maxsize=8)
def load_weights(path: str):
    """WeightsFile: an .npz with w1, b1, w2, b2, w3, b3 (OIHW)."""
    z = np.load(path)
    return tuple(np.asarray(z[k], np.float32) for k in WEIGHT_KEYS)


DEFAULT_WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "cnn_patch128.npz")


def weights_for(path: str, patch_size: int, dim: int):
    """WeightsFile resolution: an explicit path, then the packaged
    trained net (P = 32, dim = 128), then the procedural bank."""
    if path:
        return load_weights(path)
    if (patch_size == 32 and dim == 128
            and os.path.exists(DEFAULT_WEIGHTS)):
        return load_weights(DEFAULT_WEIGHTS)
    return procedural_weights(patch_size, dim)


def weights_sha256(weights) -> str:
    """SHA-256 of a weight tuple's float32 bytes, in key order."""
    import hashlib
    h = hashlib.sha256()
    for a in weights:
        h.update(np.ascontiguousarray(a, np.float32).tobytes())
    return h.hexdigest()


class CnnDescriptor(nn.Module):
    """The conv stack on ``device``: (N, P, P) gray patches in [0, 255]
    -> (N, dim) descriptors, normalized L2, L1, RootL2 or not at all
    (imagerepresentation.cpp:1497-1527)."""

    def __init__(self, weights, device="cpu", normalization: str = "L2"):
        super().__init__()
        for key, a in zip(WEIGHT_KEYS, weights, strict=True):
            self.register_buffer(key, torch.as_tensor(
                np.asarray(a, np.float32), device=device))
        self.normalization = normalization

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        x = (patches[:, None] - MEAN_GRAY) / 128.0
        x = F.max_pool2d(F.relu(F.conv2d(x, self.w1, self.b1)), 2)
        x = F.max_pool2d(F.relu(F.conv2d(x, self.w2, self.b2)), 2)
        v = F.conv2d(x, self.w3, self.b3).reshape(x.shape[0], -1)
        if self.normalization == "L2":
            v = v / torch.clamp(torch.sqrt(torch.sum(v * v, -1,
                                                     keepdim=True)),
                                min=1e-9)
        elif self.normalization in ("L1", "RootL2"):
            v = v / torch.clamp(torch.sum(v.abs(), -1, keepdim=True),
                                min=1e-9)
            if self.normalization == "RootL2":
                v = torch.sign(v) * torch.sqrt(v.abs())
        return v


@functools.lru_cache(maxsize=16)
def net_for(path: str, patch_size: int, dim: int, normalization: str,
            device: str) -> CnnDescriptor:
    """``weights_for``'s net on ``device``, uploaded once."""
    return CnnDescriptor(weights_for(path, patch_size, dim), device,
                         normalization)


def cnn_forward(patches: torch.Tensor, weights,
                normalization: str = "L2") -> torch.Tensor:
    """``mods_tpu.descriptors.cnn.cnn_forward``: the forward of the numpy
    weight tuple ``weights`` on ``patches``' device."""
    return CnnDescriptor(weights, patches.device, normalization)(patches)
