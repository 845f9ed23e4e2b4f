"""Batched scale-space detector, Hessian response (mirrors
``mods_tpu/detectors/scale_space.py``; the flagship uses HessianAffine).

Images are (V, H, W) float32; responses per octave are (V, L+2, H, W)
with L = n_scales.  NMS is a 3x3x3 max/min pool, candidates are a
fixed-size scan-order extraction, and localization runs five vectorized
steps over precomputed dense fields.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from mods_tpu_torch.config import DetectorType, PyramidParams
from mods_tpu_torch.ops.gaussian import gaussian_blur
from mods_tpu_torch.ops.image import gradient, half_image
from mods_tpu_torch.ops.select import nonzero_static

MAX_SUBPIXEL_SHIFT = 0.6   # pyramid.cpp:27
POINT_SAFETY_BORDER = 3    # pyramid.cpp:30

HESSIAN_DARK, HESSIAN_BRIGHT, HESSIAN_SADDLE = 0, 1, 2


def hessian_response(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """norm^2-scaled det-of-Hessian, 3x3 stencils
    (reference pyramid.cpp:223-280). img: (..., H, W)."""
    out = torch.zeros_like(img)
    c = img[..., 1:-1, 1:-1]
    lxx = img[..., 1:-1, :-2] - 2 * c + img[..., 1:-1, 2:]
    lyy = img[..., :-2, 1:-1] - 2 * c + img[..., 2:, 1:-1]
    lxy = (img[..., :-2, 2:] - img[..., :-2, :-2]
           + img[..., 2:, :-2] - img[..., 2:, 2:]) / 4.0
    norm2 = (sigma * sigma) ** 2
    out[..., 1:-1, 1:-1] = (lxx * lyy - lxy * lxy) * norm2
    return out


def harris_response(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Harris corner measure on (..., H, W) (reference
    pyramid.cpp:283-305, norm = sigma^2).  The ORB detector ranks its
    FAST corners by it; the Harris scale space itself is not ported."""
    norm = sigma * sigma
    sigmasq = 0.6 * norm
    s = math.sqrt(sigmasq)
    lx, ly = gradient(img)
    dx2 = sigmasq * gaussian_blur(lx * lx, s)
    dy2 = sigmasq * gaussian_blur(ly * ly, s)
    dxdy = sigmasq * gaussian_blur(lx * ly, s)
    tr = dx2 + dy2
    return dx2 * dy2 - dxdy * dxdy - 0.04 * tr * tr


@dataclass
class Octave:
    blurs: torch.Tensor   # (V, L+2, H, W)
    resps: torch.Tensor   # (V, L+2, H, W)
    sigmas: tuple         # L+2 floats, octave-relative
    pixel_distance: float


def num_octaves(h: int, w: int, border: int = 5) -> int:
    n = 0
    min_size = 2 * border + 2
    while h > min_size and w > min_size:
        n += 1
        h //= 2
        w //= 2
    return n


def build_pyramid(imgs: torch.Tensor, p: PyramidParams,
                  n_octaves: int | None = None) -> list[Octave]:
    """Gaussian pyramid of L+2 blur levels + Hessian responses per octave
    (reference pyramid.cpp:455-573).  imgs (V, H, W) carry sigma=0.5."""
    if p.detector_type != DetectorType.HESSIAN or p.do_on_wld:
        raise NotImplementedError(
            "the port's scale-space detector has the Hessian response only")
    L = p.n_scales
    step = 2.0 ** (1.0 / L)
    cur_sigma = 0.5
    first = imgs
    if p.initial_sigma > cur_sigma:
        first = gaussian_blur(
            first, math.sqrt(p.initial_sigma ** 2 - cur_sigma ** 2))
    if n_octaves is None:
        n_octaves = num_octaves(imgs.shape[-2], imgs.shape[-1], p.border)
    octaves = []
    pd = 1.0
    for _ in range(n_octaves):
        sigmas = [p.initial_sigma * step ** i for i in range(L + 2)]
        blurs = [first]
        for i in range(1, L + 2):
            inc = sigmas[i - 1] * math.sqrt(step * step - 1.0)
            blurs.append(gaussian_blur(blurs[-1], inc))
        resps = [hessian_response(b, s) for b, s in zip(blurs, sigmas)]
        octaves.append(Octave(blurs=torch.stack(blurs, 1),
                              resps=torch.stack(resps, 1),
                              sigmas=tuple(sigmas), pixel_distance=pd))
        first = half_image(blurs[L])
        pd *= 2.0
    return octaves


def _nms_mask(resps: torch.Tensor, pos_th: float,
              neg_th: float) -> torch.Tensor:
    """3x3x3 non-max/min mask for detection levels 1..L
    (pyramid.cpp:432-452).  (V, L+2, H, W) -> bool (V, L, H, W); the
    pools pad with -inf/+inf like ``reduce_window`` with SAME padding."""
    x = resps[:, None]
    mx = F.max_pool3d(x, 3, stride=1, padding=1)[:, 0]
    mn = -F.max_pool3d(-x, 3, stride=1, padding=1)[:, 0]
    c = resps[:, 1:-1]
    is_max = (c > pos_th) & (c >= mx[:, 1:-1])
    is_min = (c < neg_th) & (c <= mn[:, 1:-1])
    return is_max | is_min


def _dense_local_fields(resps: torch.Tensor, edge_th: float):
    """Per-voxel localization fields of the (L+2, H, W) volume: the
    Newton step (solx, soly, sols), the interpolated value and the edge
    flag, so each localization step gathers four values per candidate
    (mirrors scale_space.py:230-288)."""
    v = resps
    c = v[1:-1, 1:-1, 1:-1]
    lo = v[:-2, 1:-1, 1:-1]
    hi = v[2:, 1:-1, 1:-1]
    dxx = v[1:-1, 1:-1, :-2] - 2 * c + v[1:-1, 1:-1, 2:]
    dyy = v[1:-1, :-2, 1:-1] - 2 * c + v[1:-1, 2:, 1:-1]
    dss = lo - 2 * c + hi
    dxy = 0.25 * (v[1:-1, 2:, 2:] - v[1:-1, 2:, :-2]
                  - v[1:-1, :-2, 2:] + v[1:-1, :-2, :-2])
    dxs = 0.25 * (v[2:, 1:-1, 2:] - v[2:, 1:-1, :-2]
                  - v[:-2, 1:-1, 2:] + v[:-2, 1:-1, :-2])
    dys = 0.25 * (v[2:, 2:, 1:-1] - v[2:, :-2, 1:-1]
                  - v[:-2, 2:, 1:-1] + v[:-2, :-2, 1:-1])
    dx = 0.5 * (v[1:-1, 1:-1, 2:] - v[1:-1, 1:-1, :-2])
    dy = 0.5 * (v[1:-1, 2:, 1:-1] - v[1:-1, :-2, 1:-1])
    ds = 0.5 * (hi - lo)
    det = (dxx * (dyy * dss - dys * dys)
           - dxy * (dxy * dss - dys * dxs)
           + dxs * (dxy * dys - dyy * dxs))
    b0, b1, b2 = -dx, -dy, -ds
    d0 = (b0 * (dyy * dss - dys * dys)
          - dxy * (b1 * dss - dys * b2)
          + dxs * (b1 * dys - dyy * b2))
    d1 = (dxx * (b1 * dss - b2 * dys)
          - b0 * (dxy * dss - dys * dxs)
          + dxs * (dxy * b2 - b1 * dxs))
    d2 = (dxx * (dyy * b2 - dys * b1)
          - dxy * (dxy * b2 - b1 * dxs)
          + b0 * (dxy * dys - dyy * dxs))
    solx = d0 / det
    soly = d1 / det
    sols = d2 / det
    newval = c + 0.5 * (dx * solx + dy * soly + ds * sols)
    edge_score = (dxx + dyy) * (dxx + dyy) / (dxx * dyy - dxy * dxy)
    edge_bad = (edge_score >= edge_th) | (edge_score < 0)

    def pad(a):
        out = torch.zeros(v.shape, dtype=a.dtype, device=v.device)
        out[1:-1, 1:-1, 1:-1] = a
        return out

    return pad(solx), pad(soly), pad(sols), pad(newval), pad(edge_bad)


def localize_keypoints(resps: torch.Tensor, blurs: torch.Tensor,
                       lvl: torch.Tensor, r0: torch.Tensor, c0: torch.Tensor,
                       valid: torch.Tensor, p: PyramidParams,
                       final_threshold: float, detector_type: str):
    """Vectorized subpixel/subscale localization (pyramid.cpp:308-430).
    resps/blurs (L+2, H, W) of one view and octave; lvl/r0/c0 (K,) int64
    candidates.  Returns per-candidate tensors, octave-local coords."""
    L2, H, W = resps.shape
    edge_th = ((p.edge_eigen_value_ratio + 1.0) ** 2
               / p.edge_eigen_value_ratio)
    f_solx, f_soly, f_sols, f_newval, f_edge = _dense_local_fields(
        resps, edge_th)
    flat_fields = [f.reshape(-1) for f in (f_solx, f_soly, f_sols,
                                           f_newval)]
    flat_edge = f_edge.reshape(-1)
    n_flat = L2 * H * W

    K = lvl.shape[0]
    dev = resps.device
    r, c = r0, c0
    b = torch.zeros((K, 3), dtype=torch.float32, device=dev)
    val = torch.zeros((K,), dtype=torch.float32, device=dev)
    alive = valid
    edge_ok = torch.ones((K,), dtype=torch.bool, device=dev)
    for it in range(5):
        base = ((lvl * H + r) * W + c).clamp(0, n_flat - 1)
        solx, soly, sols, new_val = (f[base] for f in flat_fields)
        sol = torch.stack([solx, soly, sols], -1)
        if it == 0:
            edge_ok = ~flat_edge[base]
        nan_bad = (~torch.isfinite(sol)).any(-1)
        stepc = ((sol[:, 0] > MAX_SUBPIXEL_SHIFT).long()
                 - (sol[:, 0] < -MAX_SUBPIXEL_SHIFT).long())
        stepr = ((sol[:, 1] > MAX_SUBPIXEL_SHIFT).long()
                 - (sol[:, 1] < -MAX_SUBPIXEL_SHIFT).long())
        # the reference bails out instead of moving past the safety
        # border (pyramid.cpp:384-406)
        border_bad = (((stepc > 0) & ~(c < W - POINT_SAFETY_BORDER))
                      | ((stepc < 0) & ~(c > POINT_SAFETY_BORDER))
                      | ((stepr > 0) & ~(r < H - POINT_SAFETY_BORDER))
                      | ((stepr < 0) & ~(r > POINT_SAFETY_BORDER)))
        moved = (stepc != 0) | (stepr != 0)
        update = alive & ~nan_bad & ~border_bad
        still = update & moved
        r = torch.where(still, r + stepr, r)
        c = torch.where(still, c + stepc, c)
        b = torch.where(update[:, None], sol, b)
        val = torch.where(update, new_val, val)
        alive = update

    ok = (alive & edge_ok & (b.abs() <= 1.5).all(-1)
          & (val.abs() >= final_threshold))

    # point type from the blur image at the final location
    rr = r.clamp(1, H - 2)
    cc = c.clamp(1, W - 2)
    lxx = (blurs[lvl, rr, cc - 1] - 2 * blurs[lvl, rr, cc]
           + blurs[lvl, rr, cc + 1])
    if detector_type != DetectorType.HESSIAN:
        raise NotImplementedError(detector_type)
    sub_type = torch.where(
        val < 0, HESSIAN_SADDLE,
        torch.where(lxx < 0, HESSIAN_DARK, HESSIAN_BRIGHT)).to(torch.int32)

    # octaveMap dedup: the first candidate (scan order) claiming a final
    # (r, c) wins (pyramid.cpp:416-421).  jnp.argsort(stable=True) becomes
    # torch.sort(stable=True): equal positions keep candidate order.
    flat = torch.where(ok, r * W + c,
                       H * W + torch.arange(K, device=dev))
    sorted_flat, order = torch.sort(flat, stable=True)
    first_of_run = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                              sorted_flat[1:] != sorted_flat[:-1]])
    keep = torch.zeros((K,), dtype=torch.bool, device=dev)
    keep[order] = first_of_run
    return dict(r=r, c=c, b=b, val=val, ok=ok & keep, sub_type=sub_type)


def candidate_indices(nms: torch.Tensor, border: int, valid_w: int,
                      valid_h: int, cap: int):
    """Fixed-size extraction of NMS candidates of ONE view: (L, H, W)
    bool -> (lvl, r, c, valid) of length ``cap`` in (level, row, col)
    scan order, the reference's loop order.  ``jnp.nonzero(size=cap)``
    semantics: the first ``cap`` hits, padded with index 0 and flagged
    by ``valid`` (ops/select.py)."""
    L, H, W = nms.shape
    dev = nms.device
    rows = torch.arange(H, device=dev)[None, :, None]
    cols = torch.arange(W, device=dev)[None, None, :]
    inb = ((rows >= border) & (rows < valid_h - border)
           & (cols >= border) & (cols < valid_w - border))
    m = nms & inb
    idx, valid = nonzero_static(m.reshape(-1), cap)
    lvl = idx // (H * W)
    r = (idx // W) % H
    c = idx % W
    return lvl + 1, r, c, valid
