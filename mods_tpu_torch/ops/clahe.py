"""CLAHE, contrast-limited adaptive histogram equalization (mirrors
``mods_tpu/ops/clahe.py``: ``clahe`` on a tensor's device, ``clahe_np``
on the host).

Reference: the optional photometric normalization pass of
mods.cpp:139-189 (cv::createCLAHE, clip limit 4.0, on the gray input
before detection).  ``TwoViewMatcher.match`` applies ``clahe_np`` on the
host when ``cfg.do_clahe`` is set, as the JAX pipeline does, so each
image crosses to the card once, already normalized, and host-stage
detectors see the same pixels.  Per-tile 256-bin histograms, clip and
redistribute, CDF lookup tables, and each pixel blends the mappings of
its four nearest tile centres.
"""

from __future__ import annotations

import numpy as np
import torch


def clahe(img: torch.Tensor, clip_limit: float = 4.0, tiles_x: int = 8,
          tiles_y: int = 8, bins: int = 256) -> torch.Tensor:
    """img (H, W) float in [0, 255] on any device -> equalized float32,
    same range, same device.  The tile histograms are exact integer
    counts (one ``bincount`` over tile-offset bins, no float atomics)."""
    img = img.to(torch.float32)
    dev = img.device
    h, w = img.shape
    th = -(-h // tiles_y)
    tw = -(-w // tiles_x)
    ph, pw = th * tiles_y, tw * tiles_x
    # pad to a multiple of the tile grid by replication, as cv does
    rows = torch.clamp(torch.arange(ph, device=dev), max=h - 1)
    cols = torch.clamp(torch.arange(pw, device=dev), max=w - 1)
    imgp = img[rows[:, None], cols[None, :]]

    lut_scale = (bins - 1) / 255.0
    binned = torch.clamp(torch.round(imgp * lut_scale), 0, bins - 1).to(
        torch.int64)
    tiles = binned.reshape(tiles_y, th, tiles_x, tw).permute(0, 2, 1, 3)
    tiles = tiles.reshape(tiles_y * tiles_x, th * tw)
    n_tiles = tiles_y * tiles_x
    offs = torch.arange(n_tiles, device=dev)[:, None] * bins
    hist = torch.bincount((tiles + offs).reshape(-1),
                          minlength=n_tiles * bins).reshape(
                              n_tiles, bins).to(torch.float32)
    clip = torch.clamp(torch.tensor(clip_limit, dtype=torch.float32,
                                    device=dev) * (th * tw) / bins, min=1.0)
    excess = torch.clamp(hist - clip, min=0.0).sum(-1, keepdim=True)
    hist = torch.minimum(hist, clip) + excess / bins
    cdf = torch.cumsum(hist, -1)
    luts = (cdf / cdf[:, -1:] * 255.0).reshape(tiles_y, tiles_x, bins)

    # bilinear interpolation between tile-centre mappings
    yy = (torch.arange(ph, dtype=torch.float32, device=dev) - th / 2.0
          + 0.5) / th
    xx = (torch.arange(pw, dtype=torch.float32, device=dev) - tw / 2.0
          + 0.5) / tw
    y0 = torch.clamp(torch.floor(yy), 0, tiles_y - 1).to(torch.int64)
    x0 = torch.clamp(torch.floor(xx), 0, tiles_x - 1).to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=tiles_y - 1)
    x1 = torch.clamp(x0 + 1, max=tiles_x - 1)
    fy = torch.clamp(yy - y0, 0.0, 1.0)[:, None]
    fx = torch.clamp(xx - x0, 0.0, 1.0)[None, :]

    b = binned
    v00 = luts[y0[:, None], x0[None, :], b]
    v01 = luts[y0[:, None], x1[None, :], b]
    v10 = luts[y1[:, None], x0[None, :], b]
    v11 = luts[y1[:, None], x1[None, :], b]
    out = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
           + fy * ((1 - fx) * v10 + fx * v11))
    return out[:h, :w]


def clahe_np(img: np.ndarray, clip_limit: float = 4.0, tiles_x: int = 8,
             tiles_y: int = 8, bins: int = 256) -> np.ndarray:
    """img (H, W) float in [0, 255] -> equalized float32, same range."""
    img = np.asarray(img, np.float32)
    h, w = img.shape
    th = -(-h // tiles_y)
    tw = -(-w // tiles_x)
    ph, pw = th * tiles_y, tw * tiles_x
    imgp = np.pad(img, ((0, ph - h), (0, pw - w)), mode="edge")

    lut_scale = (bins - 1) / 255.0
    binned = np.clip(np.round(imgp * lut_scale), 0, bins - 1
                     ).astype(np.int32)
    tiles = binned.reshape(tiles_y, th, tiles_x, tw).transpose(0, 2, 1, 3)
    tiles = tiles.reshape(tiles_y * tiles_x, th * tw)

    clip = max(clip_limit * (th * tw) / bins, 1.0)
    luts = np.empty((tiles_y * tiles_x, bins), np.float32)
    for i in range(tiles.shape[0]):
        hist = np.bincount(tiles[i], minlength=bins).astype(np.float32)
        excess = np.maximum(hist - clip, 0.0).sum()
        hist = np.minimum(hist, clip) + excess / bins
        cdf = np.cumsum(hist)
        luts[i] = cdf / cdf[-1] * 255.0
    luts = luts.reshape(tiles_y, tiles_x, bins)

    yy = (np.arange(ph, dtype=np.float32) - th / 2.0 + 0.5) / th
    xx = (np.arange(pw, dtype=np.float32) - tw / 2.0 + 0.5) / tw
    y0 = np.clip(np.floor(yy), 0, tiles_y - 1).astype(np.int32)
    x0 = np.clip(np.floor(xx), 0, tiles_x - 1).astype(np.int32)
    y1 = np.minimum(y0 + 1, tiles_y - 1)
    x1 = np.minimum(x0 + 1, tiles_x - 1)
    fy = np.clip(yy - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xx - x0, 0.0, 1.0)[None, :]

    b = binned
    v00 = luts[y0[:, None], x0[None, :], b]
    v01 = luts[y0[:, None], x1[None, :], b]
    v10 = luts[y1[:, None], x0[None, :], b]
    v11 = luts[y1[:, None], x1[None, :], b]
    out = ((1 - fy) * ((1 - fx) * v00 + fx * v01)
           + fy * ((1 - fx) * v10 + fx * v11))
    return out[:h, :w].astype(np.float32)
