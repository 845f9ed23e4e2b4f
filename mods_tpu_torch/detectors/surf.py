"""SURF detector: FastHessian over integral-image box filters (mirrors
``mods_tpu/detectors/surf.py``; OpenSURF ``fasthessian.cpp``, dispatched
at imagerepresentation.cpp:1046-1076).

Every box sum over the whole image is four shifted slices of the
integral image, so a response layer is a handful of elementwise
operations over the view batch.  Scale-space NMS runs on the
stride-subsampled response volumes, and the subpixel/subscale refinement
is a batched one-shot 3x3x3 quadratic fit (Cramer's rule).

The integral image is summed in float64 and rounded to float32 once: a
float32 prefix sum over a whole view depends on its order of summation
(sequential on the CPU, a parallel scan on the card), and the box sums
are differences of its large values.  Rounded once, it is the same on
both devices.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mods_tpu_torch.config import CapacityParams
from mods_tpu_torch.ops.select import nonzero_static
from mods_tpu_torch.regions import Regions, compact_topk, upright

# filter sizes per octave (OpenSURF fasthessian.cpp filter_map)
OCTAVE_FILTERS = ((9, 15, 21, 27), (15, 27, 39, 51), (27, 51, 75, 99),
                  (51, 99, 147, 195))


def integral_image(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H+1, W+1) with ii[i, j] = sum(img[:i, :j])."""
    ii = torch.cumsum(torch.cumsum(img.to(torch.float64), -2), -1)
    return F.pad(ii.to(torch.float32), (1, 0, 1, 0))


def _box(ii: torch.Tensor, h: int, w: int, dr: int, dc: int,
         H: int, W: int) -> torch.Tensor:
    """Box sums over [r+dr, r+dr+h) x [c+dc, c+dc+w) for every (r, c) of
    (..., H, W), the box clipped to the image: ``ii`` is padded with its
    edge values (OpenSURF's BoxIntegral clamps into [0, H] x [0, W])."""
    r0, c0 = dr, dc
    r1, c1 = dr + h, dc + w
    pad_top = max(0, -min(r0, r1))
    pad_left = max(0, -min(c0, c1))
    pad_bot = max(0, max(r0, r1))
    pad_right = max(0, max(c0, c1))
    lead = ii.shape[:-2]
    iip = F.pad(ii.reshape((-1, 1) + ii.shape[-2:]),
                (pad_left, pad_right, pad_top, pad_bot), mode="replicate")
    iip = iip.reshape(lead + iip.shape[-2:])

    def sl(r, c):
        return iip[..., r + pad_top:r + pad_top + H,
                   c + pad_left:c + pad_left + W]

    return sl(r1, c1) - sl(r0, c1) - sl(r1, c0) + sl(r0, c0)


def response_layer(ii: torch.Tensor, filt: int, H: int, W: int):
    """det-of-Hessian response + laplacian sign for one filter size
    (buildResponseLayer, opensurf/fasthessian.cpp)."""
    b = (filt - 1) // 2
    l = filt // 3
    inv_area = 1.0 / (filt * filt)
    dxx = (_box(ii, 2 * l - 1, filt, -l + 1, -b, H, W)
           - 3.0 * _box(ii, 2 * l - 1, l, -l + 1, -(l // 2), H, W))
    dyy = (_box(ii, filt, 2 * l - 1, -b, -l + 1, H, W)
           - 3.0 * _box(ii, l, 2 * l - 1, -(l // 2), -l + 1, H, W))
    dxy = (_box(ii, l, l, -l, 1, H, W) + _box(ii, l, l, 1, -l, H, W)
           - _box(ii, l, l, -l, -l, H, W) - _box(ii, l, l, 1, 1, H, W))
    dxx = dxx * inv_area
    dyy = dyy * inv_area
    dxy = dxy * inv_area
    resp = dxx * dyy - 0.81 * dxy * dxy
    lap = (dxx + dyy) >= 0
    return resp, lap


def _quad_interp(win: torch.Tensor):
    """One-shot 3-D quadratic refinement of (..., 3, 3, 3) windows
    [scale, row, col] (interpolateExtremum): Cramer's rule with
    ``linalg.det``, as the JAX package solves it.  Returns offsets
    (..., 3) as (ds, dr, dc) and their validity."""
    c = win[..., 1, 1, 1]
    dx = 0.5 * (win[..., 1, 1, 2] - win[..., 1, 1, 0])
    dy = 0.5 * (win[..., 1, 2, 1] - win[..., 1, 0, 1])
    ds = 0.5 * (win[..., 2, 1, 1] - win[..., 0, 1, 1])
    dxx = win[..., 1, 1, 2] - 2 * c + win[..., 1, 1, 0]
    dyy = win[..., 1, 2, 1] - 2 * c + win[..., 1, 0, 1]
    dss = win[..., 2, 1, 1] - 2 * c + win[..., 0, 1, 1]
    dxy = 0.25 * (win[..., 1, 2, 2] - win[..., 1, 2, 0]
                  - win[..., 1, 0, 2] + win[..., 1, 0, 0])
    dxs = 0.25 * (win[..., 2, 1, 2] - win[..., 2, 1, 0]
                  - win[..., 0, 1, 2] + win[..., 0, 1, 0])
    dys = 0.25 * (win[..., 2, 2, 1] - win[..., 2, 0, 1]
                  - win[..., 0, 2, 1] + win[..., 0, 0, 1])
    A = torch.stack([torch.stack([dxx, dxy, dxs], -1),
                     torch.stack([dxy, dyy, dys], -1),
                     torch.stack([dxs, dys, dss], -1)], -2)
    rhs = -torch.stack([dx, dy, ds], -1)
    # one batched det of the matrix and its three column replacements
    mats = [A]
    for i in range(3):
        Ai = A.clone()
        Ai[..., :, i] = rhs
        mats.append(Ai)
    dets = torch.linalg.det(torch.stack(mats))
    sol = dets[1:] / dets[0]
    off = torch.stack([sol[2], sol[1], sol[0]], -1)     # (ds, dr, dc)
    okf = torch.isfinite(off).all(-1) & (off.abs() < 1.0).all(-1)
    return off, okf


def _window3(vol: torch.Tensor, lvl, r, c) -> torch.Tensor:
    """(V, K, 3, 3, 3) windows of (V, L, H, W) around (lvl, r, c) of
    shape (V, K), indices clipped into the volume."""
    V, L, H, W = vol.shape
    d = torch.arange(-1, 2, device=vol.device)
    li = (lvl[..., None, None, None] + d[:, None, None]).clamp(0, L - 1)
    ri = (r[..., None, None, None] + d[None, :, None]).clamp(0, H - 1)
    ci = (c[..., None, None, None] + d[None, None, :]).clamp(0, W - 1)
    flat = (li * H + ri) * W + ci
    return torch.gather(vol.reshape(V, -1), 1,
                        flat.reshape(V, -1)).reshape(flat.shape)


def _detect(views: torch.Tensor, valid_hw: torch.Tensor, n_octaves: int,
            threshold: float, cap_per_view: int) -> Regions:
    """``surf.py::_detect_one`` over the whole (V, H, W) batch."""
    V, H, W = views.shape
    dev = views.device
    ii = integral_image(views / 255.0)
    sizes = sorted({f for o in OCTAVE_FILTERS[:n_octaves] for f in o})
    resp, lap = {}, {}
    for f in sizes:
        resp[f], lap[f] = response_layer(ii, f, H, W)

    vh = valid_hw[:, 0, None, None, None]
    vw = valid_hw[:, 1, None, None, None]
    out = []
    per_oct = max(cap_per_view // n_octaves, 16)
    for o in range(n_octaves):
        filters = OCTAVE_FILTERS[o]
        step = 2 ** o
        vol = torch.stack([resp[f][:, ::step, ::step] for f in filters], 1)
        _, Ls, Hs, Ws = vol.shape
        # max_pool3d pads with -inf, as reduce_window's SAME padding
        mx = F.max_pool3d(vol[:, None], 3, stride=1, padding=1)[:, 0]
        # candidate levels 1..Ls-2; border from the largest filter
        b = (filters[-1] + 1) // (2 * step) + 1
        rows = torch.arange(Hs, device=dev)[None, None, :, None]
        cols = torch.arange(Ws, device=dev)[None, None, None, :]
        inb = ((rows >= b) & (rows < vh // step - b)
               & (cols >= b) & (cols < vw // step - b))
        is_ext = (vol > threshold) & (vol >= mx) & inb
        is_ext[:, 0] = False
        is_ext[:, Ls - 1] = False
        idx, valid = nonzero_static(is_ext.reshape(V, -1), per_oct)
        lvl = idx // (Hs * Ws)
        r = (idx // Ws) % Hs
        c = idx % Ws
        off, okf = _quad_interp(_window3(vol, lvl, r, c))
        valid = valid & okf
        f_arr = torch.tensor(filters, dtype=torch.float32, device=dev)
        filt_c = f_arr[lvl]
        filt_step = f_arr[(lvl + 1).clamp(max=Ls - 1)] - f_arr[lvl]
        filt_i = filt_c + off[..., 0] * filt_step
        lap_o = torch.stack([lap[f][:, ::step, ::step] for f in filters], 1)
        out.append(dict(
            xy=torch.stack([(c.to(torch.float32) + off[..., 2]) * step,
                            (r.to(torch.float32) + off[..., 1]) * step], -1),
            s=1.2 * filt_i / 9.0,                      # SURF scale law
            response=torch.gather(vol.reshape(V, -1), 1, idx),
            mask=valid,
            sub_type=torch.gather(lap_o.reshape(V, -1), 1, idx).to(
                torch.int32)))
    return upright(*(torch.cat([o[k] for o in out], 1)
                     for k in ("xy", "s", "response", "mask", "sub_type")))


def detect_surf(views: torch.Tensor, valid_hw: torch.Tensor,
                caps: CapacityParams, threshold: float = 0.0004,
                n_octaves: int = 4) -> Regions:
    """views (V, H, W), valid_hw (V, 2) on the views' device -> Regions
    (V, caps.per_view).  ``threshold`` is OpenSURF's ``thresh`` on the
    normalized det-of-Hessian."""
    H, W = views.shape[-2:]
    n_oct = min(n_octaves, max(1, int(math.log2(min(H, W) / 32)) + 1))
    regs = _detect(views, valid_hw, n_oct, threshold, caps.per_octave)
    return compact_topk(regs, caps.per_view, by="response")
