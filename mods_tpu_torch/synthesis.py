"""On-demand affine view synthesis: the view grid and the render plans
(mirrors the host half of ``mods_tpu/synthesis.py``).

Reference: ``SetVSPars`` (synth-detection.cpp:103-234) builds the
tilt x scale x rotation grid with dedup against previous iterations;
``GenerateSynthImageCorr`` (:236-430) renders each view as
rotate -> anisotropic anti-alias blur -> tilt/zoom squash, tracking the
original->synth homography H.  This module is pure Python float math and
gives the same tuples as the JAX package's; the rendering itself is
``pipeline.py::_make_render_fn``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from mods_tpu_torch.config import IterationParams, ViewParams
from mods_tpu_torch.ops.image import round_up

EPS1 = 0.001


def expand_views(it: IterationParams,
                 prev: list[ViewParams]) -> tuple[list[ViewParams],
                                                  list[ViewParams]]:
    """The SetVSPars grid: for each (scale, tilt), n_rot = floor(
    180*tilt/phi_base) rotations phi = k*pi/n_rot; tilt==1 -> single
    upright view; negative tilt -> vertical-tilt single view.  Views equal
    (eps 1e-3) to any previous iteration's view are dropped (the
    "on-demand" escalation dedup)."""
    out: list[ViewParams] = []
    for zoom in it.scale_set:
        for tilt in it.tilt_set:
            if abs(tilt - 1.0) <= EPS1:
                out.append(ViewParams(tilt=1.0, phi=0.0, zoom=zoom,
                                      init_sigma=it.init_sigma,
                                      do_blur=it.do_blur))
                continue
            n_rot = math.floor(180.0 * tilt / it.phi_base)
            if n_rot < 0:  # vertical-tilt mode (negative tilt in the set)
                out.append(ViewParams(tilt=-tilt, phi=0.0, zoom=zoom,
                                      init_sigma=it.init_sigma,
                                      do_blur=it.do_blur, vertical=True))
                continue
            delta = math.pi / n_rot if n_rot > 0 else 0.0
            for r in range(n_rot):
                out.append(ViewParams(tilt=tilt, phi=delta * r, zoom=zoom,
                                      init_sigma=it.init_sigma,
                                      do_blur=it.do_blur))
    uniq = []
    for v in out:
        dup = any(
            abs(v.zoom - p.zoom) <= EPS1
            and abs((v.tilt if not v.vertical else -v.tilt)
                    - (p.tilt if not p.vertical else -p.tilt)) <= EPS1
            and abs(v.phi - p.phi) <= EPS1
            for p in prev)
        if not dup:
            uniq.append(v)
    return uniq, prev + uniq


@dataclass(frozen=True)
class ViewPlan:
    """Host-computed render plan for one view of a (w, h) image —
    the scalar math of GenerateSynthImageCorr:236-430."""
    view: ViewParams
    H: tuple            # 3x3 original->synth homography (row-major)
    w_new: int
    h_new: int
    w_rot: int
    h_rot: int
    rot: tuple          # 2x3 forward rotation warp
    sigma_x: float
    sigma_y: float
    tilt_scale: tuple   # (sx, sy) of the squash warp
    identity: bool


def plan_view(v: ViewParams, w: int, h: int) -> ViewPlan:
    tilt, phi, zoom = v.tilt, v.phi, v.zoom
    if (abs(tilt - 1.0) <= 0.1 and abs(phi) <= 0.2
            and abs(zoom - 1.0) <= 0.1):
        return ViewPlan(view=v, H=(1, 0, 0, 0, 1, 0, 0, 0, 1),
                        w_new=w, h_new=h, w_rot=w, h_rot=h,
                        rot=(1, 0, 0, 0, 1, 0), sigma_x=0.0, sigma_y=0.0,
                        tilt_scale=(1.0, 1.0), identity=True)
    zoomed = abs(zoom - 1.0) >= 0.05
    wS1 = int(w * zoom)
    hS1 = int(h * zoom)
    kV = w / wS1 if zoomed else 1.0
    kH = h / hS1 if zoomed else 1.0
    cp, sp = math.cos(phi), math.sin(phi)

    if v.vertical:
        if 0 <= phi < math.pi / 2:
            w_new = math.floor((0.5 + cp * w + sp * h) / kH)
            h_new = math.floor((0.5 + sp * w + cp * h) / (tilt * kV))
            H = (cp / kH, sp / kH, 0.0,
                 -sp / (tilt * kV), cp / (tilt * kV),
                 math.floor(0.5 + sp * w / (tilt * kV)),
                 0.0, 0.0, 1.0)
        else:
            w_new = math.floor((0.5 - cp * w + sp * h) / kH)
            h_new = math.floor((0.5 + sp * w - cp * h) / (tilt * kV))
            d = -math.floor(cp * w / kH)
            d2 = math.floor(0.5 + (sp * w - cp * h) / (tilt * kV))
            H = (cp / kH, sp / kH, d,
                 -sp / (tilt * kV), cp / (tilt * kV), d2, 0.0, 0.0, 1.0)
    else:
        if 0 <= phi < math.pi / 2:
            w_new = math.floor((0.5 + cp * w + sp * h) / (tilt * kH))
            h_new = math.floor((0.5 + sp * w + cp * h) / kV)
            H = (cp / (tilt * kH), sp / (tilt * kH), 0.0,
                 -sp / kV, cp / kV, math.floor(0.5 + sp * w / kV),
                 0.0, 0.0, 1.0)
        else:
            w_new = math.floor((0.5 - cp * w + sp * h) / (tilt * kH))
            h_new = math.floor((0.5 + sp * w - cp * h) / kV)
            d = -math.floor(cp * w / (tilt * kH))
            d2 = math.floor(0.5 + (sp * w - cp * h) / kV)
            H = (cp / (tilt * kH), sp / (tilt * kH), d,
                 -sp / kV, cp / kV, d2, 0.0, 0.0, 1.0)

    # anti-alias sigmas (synth-detection.cpp:349-363)
    init = v.init_sigma
    sigma_aa_2 = init / (4.0 * zoom) if zoomed else init / 2.0
    sigma_aa = init * tilt / (2.0 * zoom)
    if v.vertical:
        sigma_x, sigma_y = sigma_aa_2, sigma_aa
    else:
        sigma_x, sigma_y = sigma_aa, sigma_aa_2

    # rotation stage (synth-detection.cpp:364-388)
    if 0 <= phi < math.pi / 2:
        w_rot = math.floor(0.5 + cp * w + sp * h)
        h_rot = math.floor(0.5 + sp * w + cp * h)
        rot = (cp, sp, 0.0, -sp, cp, math.floor(0.5 + sp * w))
    else:
        w_rot = math.floor(0.5 - cp * w + sp * h)
        h_rot = math.floor(0.5 + sp * w - cp * h)
        rot = (cp, sp, -math.floor(cp * w),
               -sp, cp, math.floor(0.5 + (sp * w - cp * h)))

    # squash stage scales (synth-detection.cpp:414-424)
    if v.vertical:
        ts = (1.0 / kH, 1.0 / (tilt * kV))
    else:
        ts = (1.0 / (tilt * kH), 1.0 / kV)
    return ViewPlan(view=v, H=H, w_new=w_new, h_new=h_new,
                    w_rot=w_rot, h_rot=h_rot, rot=rot,
                    sigma_x=sigma_x, sigma_y=sigma_y, tilt_scale=ts,
                    identity=False)


# Shape buckets of the JAX package (there they bound the number of
# compiled programs).  The canvas size decides the pyramid's octave count
# and the replicate padding a detector sees, so the port snaps alike and
# finds the same regions.
SNAP_DIMS = (128, 256, 384, 512, 640, 768, 896, 1024, 1280, 1536,
             1792, 2048, 2560, 3072, 3584, 4096)
SNAP_VIEWS = (1, 2, 4, 6, 8, 12, 16, 24, 32)


def snap_dim(n: int) -> int:
    for s in SNAP_DIMS:
        if s >= n:
            return s
    return round_up(n, 512)


def snap_views(v: int) -> int:
    for s in SNAP_VIEWS:
        if s >= v:
            return s
    return round_up(v, 8)


def group_views(plans: list[ViewPlan]) -> list[list[ViewPlan]]:
    """Group by (tilt, zoom, vertical, do_blur) — same sigmas and squash,
    batchable rotations."""
    groups: dict = {}
    for p in plans:
        k = (round(p.view.tilt, 4), round(p.view.zoom, 4),
             p.view.vertical, p.view.do_blur, p.identity)
        groups.setdefault(k, []).append(p)
    return list(groups.values())
