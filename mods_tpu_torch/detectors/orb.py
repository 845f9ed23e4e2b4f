"""ORB: FAST corners + Harris ranking + centroid orientation + rBRIEF over
view batches (mirrors ``mods_tpu/detectors/orb.py``).

The reference uses OpenCV's cv::ORB (imagerepresentation.cpp:1077-1108)
with HARRIS_SCORE, scaleFactor 1.2, nlevels 8, patchSize 31, and converts
keypoints to regions with A = R(angle), s = size/mrSize.  Here:

  * FAST-9/16 is 16 shifted copies + a circular run-length test over the
    whole view batch.
  * Harris scores rank corners; per-level budgets follow the OpenCV
    area-proportional retention.  The top-k is the tie-stable one of
    ``ops/select.py``: FAST corners tie often on flat images.
  * Orientation is the intensity centroid of a 31x31 disc on gathered
    patches (plain bilinear reads, as in the JAX package).
  * The BRIEF pattern is OpenCV's learned rBRIEF 256-pair table (public
    constant data from OpenCV's orb.cpp bit_pattern_31_, BSD license),
    this package's own copy of the JAX package's constant.

Descriptor bits are float 0/1, so the Hamming distance is the squared L2
distance of ``matching/fginn.py::match_distance``.
"""

from __future__ import annotations

import base64
import functools

import numpy as np
import torch
import torch.nn.functional as F

from mods_tpu_torch.config import CapacityParams
from mods_tpu_torch.detectors.scale_space import harris_response
from mods_tpu_torch.ops.gaussian import blur_band_matrix
from mods_tpu_torch.ops.image import const
from mods_tpu_torch.ops.select import top_k
from mods_tpu_torch.ops.warp import (_bilinear_combine4, extract_patches,
                                     gather_4plane_level, patch_grid,
                                     to_index)
from mods_tpu_torch.regions import Regions, compact_topk, concat_regions

# FAST circle of radius 3 (dx, dy), standard Bresenham ring order
FAST_RING = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2),
             (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1),
             (-2, -2), (-1, -3))

DET_ORB = 40


def _shift2d(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """Shift (V, H, W) by (dx, dy) with edge padding."""
    h, w = img.shape[-2:]
    py = (max(dy, 0), max(-dy, 0))
    px = (max(dx, 0), max(-dx, 0))
    x = F.pad(img[:, None], px + py, mode="replicate")[:, 0]
    return x[..., py[1]:py[1] + h, px[1]:px[1] + w]


def fast_corners(img: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """FAST-9/16 corner mask for (V, H, W)."""
    ring = torch.stack([_shift2d(img, dx, dy) for dx, dy in FAST_RING])
    bright = ring > img[None] + threshold
    dark = ring < img[None] - threshold

    def has_run9(m):
        mm = torch.cat([m, m[:8]])          # wrap for circular runs
        acc = mm[:16]
        for k in range(1, 9):
            acc = acc & mm[k:k + 16]
        return acc.any(0)

    return has_run9(bright) | has_run9(dark)


# OpenCV's learned rBRIEF pattern (orb.cpp bit_pattern_31_, BSD): 256
# rows of (x1, y1, x2, y2) int8 point pairs in the 31 px patch frame.
_BIT_PATTERN_31_B64 = (
    "CP0JBQQCB/T1CfgCB/QM8wLzAgwB+QEG/vb+/PPz9fjz/fT3CgQLCfP4+Pf1B/cMBwcM"
    "Bvz7/QDzAvT99wD5BQz6DP/9Bv4M+vP8+AvzDPgEBwUBBf0K/QP5Bgz4+fr+/gv/9vMM"
    "+Ar5A/v9/AL9B/b0+gsF9Ab5BfoH/wEABPsJCwvzBAcEDAL/BAT89P4H+Pv59gQLCQwA"
    "+AHz8/74Av3+/gP6Cfz3CAwKBwAJAQMH+wv28/r1AAoHDAH6/foMCvcM/PMI+PTzAPj8"
    "AwMHCAUHCvn/BwH0A/YFBgL8A/bzAPMF8/n0DPMD9Qj5DPwHBvYMCPf/+fr++wAM9AX5"
    "BQP2CPP5+fwF/f7/+QIJBfX18/vz/wYA/wX9BQL88/wM9/r3BvT2+PwKAgz9BwwMDPnz"
    "+gX8Cf0EB/8MAvkG+wHzC/QF/Qf++gf4DPnz+fX0Af0MDAL6AwD8A/7z//MBCQcBCPoB"
    "/wMMCQEMBv/3/wPz8/YFBwcKDAz7DAkGAwcLBfMGCgL0AgMDCAT6AgYM8wn0CgP4BPkJ"
    "9Qz8+gEMAvgG9wf8AgMD/gYDCwAD/Qj4BwgJA/X7+vz2C/sK+/j9DPYF9wAI/wz6BPoG"
    "9fYM+AcE/gYH/gD+DPv4+wIH+goM9/P4+Pvz+/4I+Anz9/X3AAH4Af4H/AkB/gH//Av6"
    "DPX09/oEAwcHDAUFCggA/AII9wz78wAHAgz/AgEHBQsH9wMFBvjz/PgJ+wn9/fz5/fQG"
    "BQgA+Qb6DPMG+/4B9gMKBAEI/P7+AvMC9AwM/vMA+gQBCQP69v37/fP/AQcFDPUE/gX5"
    "8wn3+wcBCAYH+AcG+fz5AfgL+fjzBvT4AgQDCQr7DAP6+/oHCP0J+AL0Agj1/vYD9PP5"
    "9/UA9vsF/QsI/vP/DP/4AAnz9fT79v72C/0J/vMC/QMC9/P8APwG/fb8DP75+vX8CQb9"
    "BgvzC/sFCwsMBgf7DP7/DAAH/Pj9/vkB+gfz9Pjz+f76+PgF+vf7//wF8wf4CgEFBfMB"
    "AArzCQwK/wX4Cvf/CwHz9/36Av/2AQzzAfj2CPUK+gLzA/oH8wz39vb7+fb4+PME+ggF"
    "AwwI8/wC/f0F8wr0BPMF//cJ/AMAAwP39AH6AQMCBPj29vYJCPMMDPj0+vsCAgMHCgYL"
    "+AYICPT5CvoF/ff9Cf/z/wX9+f0E+P74AwQCDAwC+wMLBvcL8wP/BwwL/wwE/QD9BgT1"
    "BAwC/AIB9vr4AfMH9QHzDPXzBgAL8wD/AQTzA/f+9wj6/fP6+P4F9wgKAgcD9//6//8J"
    "BQv+C/0M+AMAAwX/BAAKA/oEBfMA9gUFCAwLCAkJ+gf8CPT2BPYJBwMMBAn5Cv4HAAz+"
    "//oA9Q=="
)


@functools.lru_cache(maxsize=8)
def brief_pattern(n_bits: int = 256, patch: int = 31,
                  seed: int = 7) -> np.ndarray:
    """(n_bits, 2, 2) point pairs.  256 bits = OpenCV's learned table;
    other widths use a seeded Gaussian pair set (the original BRIEF
    construction), clipped to the patch."""
    if n_bits == 256 and patch == 31:
        raw = np.frombuffer(base64.b64decode(_BIT_PATTERN_31_B64), np.int8)
        return raw.astype(np.float32).reshape(256, 2, 2)
    rng = np.random.default_rng(seed)
    half = patch // 2
    pts = rng.normal(0.0, patch / 5.0, (n_bits, 2, 2))
    return np.clip(pts, -half + 1, half - 1).astype(np.float32)


@functools.lru_cache(maxsize=4)
def _ic_disc(patch: int = 31) -> np.ndarray:
    half = patch // 2
    ys, xs = np.mgrid[0:patch, 0:patch].astype(np.float32)
    d2 = (xs - half) ** 2 + (ys - half) ** 2
    return (d2 <= half * half).astype(np.float32)


def _sample_views(imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                  fill: float = 0.0) -> torch.Tensor:
    """``ops/warp.py::bilinear_sample`` on every plane of (V, H, W) at
    once: x, y of shape (V, ...) are sampled in their own plane."""
    V, h, w = imgs.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = to_index(x0)
    y0i = to_index(y0)
    valid = (x0i >= 0) & (y0i >= 0) & (x0i < w - 1) & (y0i < h - 1)
    plane = torch.arange(V, device=imgs.device).reshape(
        (V,) + (1,) * (x.ndim - 1))
    val = _bilinear_combine4(*gather_4plane_level(imgs, plane, y0i, x0i),
                             wx, wy)
    return torch.where(valid, val, torch.full_like(val, fill))


def _resize(imgs: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear resize (V, H, W) -> (V, oh, ow) with the pixel-centre
    convention of cv::resize INTER_LINEAR; samples that leave the image
    read 0, as ``bilinear_sample`` gives them."""
    V, h, w = imgs.shape
    dev = imgs.device
    ys = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) \
        * (h / oh) - 0.5
    xs = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) \
        * (w / ow) - 0.5
    return _sample_views(imgs, xs[None, None, :].expand(V, oh, ow),
                         ys[None, :, None].expand(V, oh, ow))


def detect_orb_level(imgs: torch.Tensor, valid_hw: torch.Tensor,
                     threshold: float, cap: int, border: int):
    """One pyramid level of (V, H, W): FAST -> 3x3 NMS on Harris ->
    top-cap.  valid_hw (V, 2) at this level.  Returns (xy (V, cap, 2),
    response (V, cap), mask (V, cap)) in level coords."""
    V, h, w = imgs.shape
    dev = imgs.device
    corners = fast_corners(imgs, threshold)
    harris = harris_response(imgs, 1.0)
    # reduce_window max with SAME padding pads with -inf, and so does
    # max_pool2d on a float input with padding=1
    mx = F.max_pool2d(harris[:, None], 3, stride=1, padding=1)[:, 0]
    rows = torch.arange(h, device=dev)[None, :, None]
    cols = torch.arange(w, device=dev)[None, None, :]
    vh = valid_hw[:, 0, None, None]
    vw = valid_hw[:, 1, None, None]
    inb = ((rows >= border) & (rows < vh - border)
           & (cols >= border) & (cols < vw - border))
    good = corners & (harris >= mx) & inb
    score = torch.where(good, harris, -float("inf"))
    vals, idx = top_k(score.reshape(V, -1), cap)
    xy = torch.stack([idx % w, idx // w], -1).to(torch.float32)
    return xy, vals, vals > -float("inf")


def orientation_ic(imgs: torch.Tensor, xy: torch.Tensor,
                   patch: int = 31) -> torch.Tensor:
    """Intensity-centroid angle per keypoint (ORB's IC operator): imgs
    (V, H, W), xy (V, K, 2) -> (V, K)."""
    disc = const(_ic_disc(patch), imgs)
    half = patch // 2
    r = torch.arange(-half, half + 1, dtype=torch.float32,
                     device=imgs.device)
    g = patch_grid(patch, imgs.device)                   # (P, P, 2)
    coords = xy[:, :, None, None, :] + g
    p = _sample_views(imgs, coords[..., 0], coords[..., 1])
    pw = p * disc
    m10 = (pw * r[None, None, None, :]).sum((-2, -1))
    m01 = (pw * r[None, None, :, None]).sum((-2, -1))
    return torch.atan2(m01, m10)


def detect_orb(imgs: torch.Tensor, valid_hw: torch.Tensor,
               caps: CapacityParams, n_features: int = 500,
               scale_factor: float = 1.2, n_levels: int = 8,
               edge_threshold: int = 31, fast_threshold: float = 20.0,
               mr_size: float = 5.1962, patch_size: int = 31) -> Regions:
    """(V, H, W) view batch -> Regions (V, caps.per_view) with
    A = R(theta), s = patch_size*level_scale/mr_size (the reference's
    conversion, imagerepresentation.cpp:1096-1106).  valid_hw (V, 2)
    int32 on the views' device."""
    V, H, W = imgs.shape
    dev = imgs.device
    inv_total = sum(scale_factor ** -(2 * l) for l in range(n_levels))
    level_out = []
    for lv in range(n_levels):
        sc = scale_factor ** lv
        oh, ow = max(int(H / sc), 32), max(int(W / sc), 32)
        budget = max(int(n_features * (scale_factor ** (-2 * lv))
                         / inv_total), 16)
        budget = min(budget, caps.per_view)
        lvl_imgs = _resize(imgs, oh, ow) if lv else imgs
        vh = (valid_hw.to(torch.float32) / sc).to(torch.int32).clamp(min=1)
        xy, resp, m = detect_orb_level(
            lvl_imgs, vh, fast_threshold, budget, edge_threshold // 2)
        ang = orientation_ic(lvl_imgs, xy)
        ca, sa = torch.cos(ang), torch.sin(ang)
        A = torch.stack([torch.stack([ca, sa], -1),
                         torch.stack([-sa, ca], -1)], -2)
        level_out.append(Regions(
            xy=xy * sc, A=A,
            s=torch.full(m.shape, patch_size * sc / mr_size,
                         dtype=torch.float32, device=dev),
            response=resp,
            sub_type=torch.full(m.shape, DET_ORB, dtype=torch.int32,
                                device=dev),
            mask=m))
    regs = concat_regions(level_out)
    return compact_topk(regs, caps.per_view, by="response")


def brief_descriptors(img: torch.Tensor, xy: torch.Tensor, A: torch.Tensor,
                      s: torch.Tensor, mr_size: float = 5.1962,
                      n_bits: int = 256) -> torch.Tensor:
    """rBRIEF bits as float 0/1 of (K,) regions on an (H, W) image: the
    31 px pattern frame scaled to the region (s * mr_size / 31) and
    turned by A, sampled through ``ops/warp.py::extract_patches``."""
    scale = (s * mr_size / 31)[:, None, None]
    return brief_from_patches(extract_patches(img, xy, A * scale, 31),
                              n_bits)


def brief_from_patches(p: torch.Tensor, n_bits: int = 256) -> torch.Tensor:
    """rBRIEF bits as float 0/1 from sampled (K, 31, 31) patches.
    cv::ORB prefilters with GaussianBlur(7, 7, sigma=2) before reading
    single pixels at the pattern points; bit = value at the pair's first
    point < value at its second.  An intensity tie gives 0."""
    patch = p.shape[-1]
    pat = const(brief_pattern(n_bits), p)                # (B, 2, 2)
    M = const(blur_band_matrix(patch, 2.0), p)
    p = torch.einsum("ij,kjc->kic", M, p)
    p = torch.einsum("kic,jc->kij", p, M)
    half = patch // 2
    px = (pat[..., 0] + half).clamp(0, patch - 1)        # (B, 2)
    py = (pat[..., 1] + half).clamp(0, patch - 1)
    K = p.shape[0]
    vals = _sample_views(p, px[None].expand(K, -1, -1),
                         py[None].expand(K, -1, -1))     # (K, B, 2)
    return (vals[..., 0] < vals[..., 1]).to(torch.float32)
