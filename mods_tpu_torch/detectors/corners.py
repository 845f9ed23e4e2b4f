"""Standalone corner detectors: FAST and STAR (CenSurE) (mirrors
``mods_tpu/detectors/corners.py``; OpenCV's FastFeatureDetector and
StarFeatureDetector in the reference, imagerepresentation.cpp:1077-1224).

FAST is the ORB module's FAST-9 stencil with Harris ranking at one
scale.  STAR's bi-level centre-surround octagons are integral-image box
differences (inner box minus surround ring) at every scale, with a 3-D
NMS across the scale stack, on SURF's box machinery.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mods_tpu_torch.config import CapacityParams
from mods_tpu_torch.detectors.orb import detect_orb_level
from mods_tpu_torch.detectors.surf import _box, integral_image
from mods_tpu_torch.ops.select import nonzero_static
from mods_tpu_torch.regions import Regions, compact_topk, upright

# CenSurE scale ladder (OpenCV StarDetector sizes, halved to radii)
STAR_RADII = (1, 2, 3, 4, 6, 8, 11, 16)


def detect_fast(views: torch.Tensor, valid_hw: torch.Tensor,
                caps: CapacityParams, threshold: float = 20.0,
                keypoint_size: float = 7.0,
                mr_size: float = 5.1962) -> Regions:
    """Single-scale FAST-9 with Harris ordering (cv::FAST semantics) over
    (V, H, W).  Keypoints carry OpenCV's fixed size 7 -> s = size/mrSize."""
    xy, resp, m = detect_orb_level(views, valid_hw, threshold,
                                   caps.per_view, 3)
    return upright(xy, torch.full(m.shape, keypoint_size / mr_size,
                                  device=views.device), resp, m)


def _star_response(ii: torch.Tensor, r: int, H: int, W: int) -> torch.Tensor:
    """Centre-surround response at radius r: inner (2r+1) box mean minus
    surround ring mean (boxes approximate CenSurE's octagons)."""
    R = 2 * r
    inner_n = (2 * r + 1) ** 2
    outer_n = (2 * R + 1) ** 2 - inner_n
    inner = _box(ii, 2 * r + 1, 2 * r + 1, -r, -r, H, W)
    outer_full = _box(ii, 2 * R + 1, 2 * R + 1, -R, -R, H, W)
    return inner / inner_n - (outer_full - inner) / outer_n


def detect_star(views: torch.Tensor, valid_hw: torch.Tensor,
                caps: CapacityParams, threshold: float = 4.0) -> Regions:
    """(V, H, W) -> Regions (V, caps.per_view).  ``threshold`` is on the
    mean-difference response (OpenCV's responseThreshold = 30 applies to
    a ~7x-scaled kernel sum)."""
    V, H, W = views.shape
    dev = views.device
    cap = caps.per_view
    ii = integral_image(views)
    vol = torch.stack([_star_response(ii, r, H, W) for r in STAR_RADII], 1)
    avol = vol.abs()
    mx = F.max_pool3d(avol[:, None], 3, stride=1, padding=1)[:, 0]
    rows = torch.arange(H, device=dev)[None, None, :, None]
    cols = torch.arange(W, device=dev)[None, None, None, :]
    radii = torch.tensor(STAR_RADII, dtype=torch.int64,
                         device=dev)[None, :, None, None]
    vh = valid_hw[:, 0, None, None, None]
    vw = valid_hw[:, 1, None, None, None]
    inb = ((rows >= 2 * radii) & (rows < vh - 2 * radii)
           & (cols >= 2 * radii) & (cols < vw - 2 * radii))
    L = len(STAR_RADII)
    ext = (avol > threshold) & (avol >= mx) & inb
    ext[:, 0] = False
    ext[:, L - 1] = False
    idx, valid = nonzero_static(ext.reshape(V, -1), cap)
    lvl = idx // (H * W)
    r = (idx // W) % H
    c = idx % W
    regs = upright(
        torch.stack([c, r], -1).to(torch.float32),
        torch.tensor(STAR_RADII, dtype=torch.float32, device=dev)[lvl],
        torch.gather(vol.reshape(V, -1), 1, idx), valid)
    return compact_topk(regs, cap, by="response")
