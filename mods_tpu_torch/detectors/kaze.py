"""KAZE/AKAZE detector: nonlinear diffusion scale space (mirrors
``mods_tpu/detectors/kaze.py``; the vendored AKAZE library's
``Create_Nonlinear_Scale_Space`` / ``Feature_Detection``, dispatched at
imagerepresentation.cpp:1132-1152).

Fast-Explicit-Diffusion cycles of 4-neighbour stencil updates over the
whole view batch, a Perona-Malik g2 conductivity whose contrast factor is
the 70th percentile of the gradient magnitude (one quantile a view), and
per-level spatial NMS with a same-pixel dedup across levels.  The FED
loops stay Python loops, as in the JAX package.

Evolution layout per AKAZE defaults: 4 octaves x 4 sublevels,
sigma_i = 1.6 * 2^(o + s/4), evolution time t_i = sigma_i^2 / 2.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mods_tpu_torch.config import CapacityParams
from mods_tpu_torch.ops.gaussian import gaussian_blur
from mods_tpu_torch.ops.image import half_image
from mods_tpu_torch.ops.select import nonzero_static
from mods_tpu_torch.regions import Regions, compact_topk, upright


def _fed_tau_steps(T: float, tau_max: float = 0.25):
    """FED cycle step sizes covering total time T (Weickert/Grewenig FED:
    tau_j = tau_max / (2 cos^2(pi (2j+1) / (4n+2))), scaled to sum T)."""
    n = max(1, int(math.ceil(math.sqrt(3.0 * T / tau_max + 0.25) - 0.5)))
    taus = [tau_max / (2.0 * math.cos(
        math.pi * (2 * j + 1) / (4 * n + 2)) ** 2) for j in range(n)]
    scale = T / sum(taus)
    return [t * scale for t in taus]


def _next_x(a):
    """a shifted one column left, the last column repeated."""
    return torch.cat([a[..., :, 1:], a[..., :, -1:]], -1)


def _next_y(a):
    return torch.cat([a[..., 1:, :], a[..., -1:, :]], -2)


def _prev_x(a):
    return torch.cat([a[..., :, :1], a[..., :, :-1]], -1)


def _prev_y(a):
    return torch.cat([a[..., :1, :], a[..., :-1, :]], -2)


def _diffusion_step(L: torch.Tensor, g: torch.Tensor,
                    tau: float) -> torch.Tensor:
    """One explicit diffusion step with conductivity g over (..., H, W)
    (nld_step_scalar semantics): flux between 4-neighbours with averaged
    conductivity, no flux through the image border."""
    fx = 0.5 * (g + _next_x(g)) * (_next_x(L) - L)     # to the right
    fy = 0.5 * (g + _next_y(g)) * (_next_y(L) - L)     # downward
    fxl = F.pad(fx[..., :, :-1], (1, 0))
    fyu = F.pad(fy[..., :-1, :], (0, 0, 1, 0))
    return L + tau * (fx - fxl + fy - fyu)


def _grad(L: torch.Tensor):
    return (0.5 * (_next_x(L) - _prev_x(L)),
            0.5 * (_next_y(L) - _prev_y(L)))


def _hessian_det(L: torch.Tensor, sigma: float) -> torch.Tensor:
    """Scale-normalized det-of-Hessian with sigma-dilated stencils of
    (V, H, W) (AKAZE's Compute_Multiscale_Derivatives step
    round(sigma))."""
    d = max(1, int(round(sigma)))
    H, W = L.shape[-2:]
    Lp = F.pad(L[:, None], (d, d, d, d), mode="replicate")[:, 0]

    def sh(dy, dx):
        return Lp[:, d + dy:d + dy + H, d + dx:d + dx + W]

    lxx = sh(0, -d) - 2 * L + sh(0, d)
    lyy = sh(-d, 0) - 2 * L + sh(d, 0)
    lxy = 0.25 * (sh(-d, d) - sh(-d, -d) + sh(d, -d) - sh(d, d))
    norm = (sigma / d) ** 2
    return (lxx * lyy - lxy * lxy) * (norm * norm)


def contrast_factor(img: torch.Tensor) -> torch.Tensor:
    """(V, H, W) 0..255 -> (V,) the KPM contrast factor: the 70th
    percentile ("nearest") of the gradient magnitudes above 1e-5 of each
    view blurred by 1, floored at 1e-3; 0.03 where a view has none.  One
    ``nanquantile`` a view: its input is capped at 2^24 elements."""
    gx, gy = _grad(gaussian_blur(img / 255.0, 1.0))
    mag = torch.sqrt(gx * gx + gy * gy)
    mag = torch.where(mag > 1e-5, mag, torch.nan)
    k = torch.stack([torch.nanquantile(m.reshape(-1), 0.7,
                                       interpolation="nearest")
                     for m in mag])
    return torch.where(torch.isfinite(k), k.clamp(min=1e-3),
                       torch.full_like(k, 0.03))


def _detect(views: torch.Tensor, valid_hw: torch.Tensor, n_oct: int,
            n_sub: int, threshold: float, cap: int) -> Regions:
    """``kaze.py::_detect_one`` over the whole (V, H, W) batch."""
    V = views.shape[0]
    dev = views.device
    base_sigma = 1.6
    L = gaussian_blur(views / 255.0, base_sigma)
    k2 = (contrast_factor(views) ** 2)[:, None, None]

    out = []
    per_oct = max(cap // n_oct, 16)
    pd = 1.0
    vh = valid_hw[:, 0, None, None, None]
    vw = valid_hw[:, 1, None, None, None]
    t_prev = 0.5 * base_sigma ** 2
    for o in range(n_oct):
        H, W = L.shape[-2:]
        resps, sigmas = [], []
        for s in range(n_sub + 2):
            sigma = base_sigma * (2.0 ** ((s - 1) / n_sub + o))
            sig_local = sigma / pd
            t = 0.5 * sig_local ** 2
            if t > t_prev:
                for tau in _fed_tau_steps(t - t_prev):
                    gx, gy = _grad(L)
                    g = 1.0 / (1.0 + (gx * gx + gy * gy) / k2)
                    L = _diffusion_step(L, g, tau)
                t_prev = t
            sigmas.append(sig_local)
            resps.append(_hessian_det(L, sig_local))
        vol = torch.stack(resps, 1)                  # (V, n_sub+2, H, W)
        # AKAZE's Find_Scale_Space_Extrema: spatial 3x3 NMS per level and
        # a same-pixel dedup across levels, not a strict 3-D NMS (the
        # scale-dilated stencils make responses jump across levels)
        mx = F.max_pool2d(vol.reshape(-1, 1, H, W), 3, stride=1,
                          padding=1).reshape(vol.shape)
        rows = torch.arange(H, device=dev)[None, None, :, None]
        cols = torch.arange(W, device=dev)[None, None, None, :]
        b = 6
        inb = ((rows >= b) & (rows < vh - b) & (cols >= b) & (cols < vw - b))
        ext = (vol > threshold) & (vol >= mx) & inb
        ext[:, 0] = False
        ext[:, n_sub + 1] = False
        ninf = torch.full_like(vol[:, :1], -float("inf"))
        stronger_lo = vol >= torch.cat([ninf, vol[:, :-1]], 1)
        stronger_hi = vol > torch.cat([vol[:, 1:], ninf], 1)
        ext = ext & stronger_lo & stronger_hi
        idx, valid = nonzero_static(ext.reshape(V, -1), per_oct)
        lvl = idx // (H * W)
        r = (idx // W) % H
        c = idx % W
        # 2-D subpixel refinement at the detection level
        dl = torch.arange(-1, 2, device=dev)
        ri = (r[..., None, None] + dl[:, None]).clamp(0, H - 1)
        ci = (c[..., None, None] + dl[None, :]).clamp(0, W - 1)
        flat = (lvl[..., None, None] * H + ri) * W + ci
        win2 = torch.gather(vol.reshape(V, -1), 1,
                            flat.reshape(V, -1)).reshape(flat.shape)
        cc0 = win2[..., 1, 1]
        dx = 0.5 * (win2[..., 1, 2] - win2[..., 1, 0])
        dy = 0.5 * (win2[..., 2, 1] - win2[..., 0, 1])
        dxx = win2[..., 1, 2] - 2 * cc0 + win2[..., 1, 0]
        dyy = win2[..., 2, 1] - 2 * cc0 + win2[..., 0, 1]
        dxy = 0.25 * (win2[..., 2, 2] - win2[..., 2, 0]
                      - win2[..., 0, 2] + win2[..., 0, 0])
        det2 = dxx * dyy - dxy * dxy
        den = torch.where(det2 != 0, det2, torch.full_like(det2, 1e-12))
        ox = -(dyy * dx - dxy * dy) / den
        oy = -(dxx * dy - dxy * dx) / den
        okf = (torch.isfinite(ox) & torch.isfinite(oy)
               & (ox.abs() < 1.0) & (oy.abs() < 1.0))
        ox = torch.where(okf, ox, 0.0)
        oy = torch.where(okf, oy, 0.0)
        sig_arr = torch.tensor(sigmas, dtype=torch.float32, device=dev)
        out.append(dict(
            xy=torch.stack([(c.to(torch.float32) + ox) * pd,
                            (r.to(torch.float32) + oy) * pd], -1),
            s=sig_arr[lvl] * pd,
            response=torch.gather(vol.reshape(V, -1), 1, idx),
            mask=valid, sub_type=torch.zeros_like(lvl, dtype=torch.int32)))
        # next octave: downsample the last evolution image; time rescales
        # with the pixel distance squared
        L = half_image(L)
        t_prev = t_prev / 4.0
        pd *= 2.0
        vh = vh // 2
        vw = vw // 2
    return upright(*(torch.cat([o[k] for o in out], 1)
                     for k in ("xy", "s", "response", "mask", "sub_type")))


def detect_kaze(views: torch.Tensor, valid_hw: torch.Tensor,
                caps: CapacityParams, threshold: float = 0.001,
                n_octaves: int = 4, n_sublevels: int = 4) -> Regions:
    """views (V, H, W), valid_hw (V, 2) on the views' device -> Regions
    (V, caps.per_view).  ``threshold`` is AKAZE's ``dthreshold`` on the
    normalized det-of-Hessian."""
    H, W = views.shape[-2:]
    n_oct = min(n_octaves, max(1, int(math.log2(min(H, W) / 48)) + 1))
    regs = _detect(views, valid_hw, n_oct, n_sublevels, threshold,
                   caps.per_octave)
    return compact_topk(regs, caps.per_view, by="response")
