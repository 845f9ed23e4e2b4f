"""CLAHE, contrast-limited adaptive histogram equalization, on the host
(mirrors ``mods_tpu/ops/clahe.py::clahe_np``).

Reference: the optional photometric normalization pass of
mods.cpp:139-189 (cv::createCLAHE, clip limit 4.0, on the gray input
before detection).  ``TwoViewMatcher.match`` applies it on the host
when ``cfg.do_clahe`` is set, so each image crosses to the card once,
already normalized, and host-stage detectors see the same pixels.
Per-tile 256-bin histograms, clip and redistribute, CDF lookup tables,
and each pixel blends the mappings of its four nearest tile centres.
"""

from __future__ import annotations

import numpy as np


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
