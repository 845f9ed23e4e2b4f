"""Affine-covariant scale-space detection, assembled (mirrors
``mods_tpu/detectors/hessaff.py``; reference ``DetectAffineKeypoints``,
scale-space-detector.cpp:43-85).

pyramid -> per-octave NMS -> localization -> Baumberg over all views at
once -> fixed-capacity Regions in image coordinates -> detection-mode
budget filter (prepareKeysForExport, scale-space-detector.hpp:127-198).
"""

from __future__ import annotations

import torch

from mods_tpu_torch.config import (AffineShapeParams, CapacityParams,
                                   DetectionMode, DetectorType,
                                   PyramidParams)
from mods_tpu_torch.detectors import scale_space as ss
from mods_tpu_torch.detectors.baumberg import baumberg_adapt
from mods_tpu_torch.ops.select import top_k
from mods_tpu_torch.regions import Regions, compact_topk, concat_regions


def _thresholds(p: PyramidParams) -> tuple[float, float]:
    """(positive_threshold, final_threshold) — pyramid.h:47-66; final is
    squared for Hessian, and non-FixedTh modes zero both."""
    pos = 0.8 * p.threshold
    fin = p.threshold
    if p.detector_type == DetectorType.HESSIAN:
        fin = p.threshold * p.threshold
    if p.detector_mode != DetectionMode.FIXED_TH:
        return 0.0, 0.0
    return pos, fin


def _detect_one_octave(oct_blurs, oct_resps, valid_hw, p: PyramidParams,
                       cap: int, baum_cap: int, pos_th, fin_th, sigmas):
    """NMS, candidates and localization for ONE view and octave.

    oct_blurs/oct_resps (L+2, H, W); valid_hw (2,) the un-padded (h, w)
    at this octave.  Survivors are compacted, strongest first, to
    ``baum_cap`` for Baumberg.  Returns octave-local
    (xy, s, lvl, ok, val, sub_type), each with ``baum_cap`` rows.
    """
    L = p.n_scales
    nms = ss._nms_mask(oct_resps[None], pos_th, -pos_th)[0]
    lvl, r, c, valid = ss.candidate_indices(
        nms, p.border, valid_hw[1], valid_hw[0], cap)
    loc = ss.localize_keypoints(
        oct_resps, oct_blurs, lvl, r, c, valid, p, fin_th, p.detector_type)
    ok = loc["ok"]
    x_oct = loc["c"].to(torch.float32) + loc["b"][:, 0]
    y_oct = loc["r"].to(torch.float32) + loc["b"][:, 1]
    sig = torch.tensor(sigmas, dtype=torch.float32, device=ok.device)[lvl]
    s_oct = sig * torch.exp2(loc["b"][:, 2] / L)

    # Baumberg's slab is narrower than the candidate slab: keep the
    # strongest.  lax.top_k breaks ties to the lower index; top_k here is
    # a stable sort, so equal keys keep that order (ops/select.py).
    key = torch.where(ok, loc["val"].abs(),
                      torch.tensor(-float("inf"), device=ok.device))
    kk, idx = top_k(key, baum_cap)
    ok = ok[idx] & (kk > -float("inf"))
    xy_oct = torch.stack([x_oct[idx], y_oct[idx]], -1)
    return (xy_oct, s_oct[idx], lvl[idx], ok, loc["val"][idx],
            loc["sub_type"][idx])


def apply_detection_mode(regs: Regions, p: PyramidParams, out_cap: int,
                         reg_number: torch.Tensor | None = None) -> Regions:
    """Budget filter: (V, K) -> (V, out_cap) ordered by |response|."""
    out = compact_topk(regs, out_cap, by="response")
    mode = p.detector_mode
    if mode == DetectionMode.FIXED_TH:
        return out
    dev = out.mask.device
    n = out.count()[..., None].to(torch.float32)
    rank = torch.arange(out.capacity, dtype=torch.float32,
                        device=dev).expand(out.mask.shape)
    absresp = out.response.abs()
    if reg_number is None:
        reg_number = torch.full(regs.mask.shape[:-1], p.reg_number,
                                dtype=torch.int32, device=dev)
    regn = reg_number[..., None].to(torch.float32)
    if mode == DetectionMode.RELATIVE_TH:
        mx = torch.where(out.mask, absresp, 0.0).amax(-1, keepdim=True)
        keep = absresp >= mx * p.rel_threshold
    elif mode == DetectionMode.FIXED_REG_NUMBER:
        keep = rank < regn
    elif mode == DetectionMode.RELATIVE_REG_NUMBER:
        keep = rank < torch.floor(p.rel_reg_number * n)
    elif mode == DetectionMode.NOT_LESS_THAN_REGIONS:
        n_th = torch.where(out.mask, (absresp >= p.threshold).float(),
                           0.0).sum(-1, keepdim=True)
        keep = rank < torch.maximum(regn, n_th)
    else:
        raise ValueError(mode)
    return out.masked_where(keep)


def octave_keypoints(imgs: torch.Tensor, valid_hw: torch.Tensor,
                     p: PyramidParams, caps: CapacityParams):
    """Per octave, the localized keypoints of all views as Baumberg takes
    them: yields (pixel_distance, stack, lvl_flat, xy, s, ok, val,
    sub_type) with the views folded into the level axis of one
    (V*(L+2), H, W) stack (hessaff.py:144-152) and xy (V, cap, 2), the
    rest (V, cap), octave-local."""
    pos_th, fin_th = _thresholds(p)
    octaves = ss.build_pyramid(imgs, p)
    hw_host = [tuple(int(v) for v in row) for row in valid_hw.tolist()]
    for octv in octaves:
        pd = octv.pixel_distance
        oh, ow = octv.blurs.shape[-2:]
        cap = min(caps.per_octave, max(256, (oh * ow) // 64))
        baum_cap = min(cap, caps.per_view, caps.per_octave_baum)
        V, L2 = octv.blurs.shape[:2]
        outs = [_detect_one_octave(
            octv.blurs[v], octv.resps[v],
            (int(hw_host[v][0] / pd), int(hw_host[v][1] / pd)), p, cap,
            baum_cap, pos_th, fin_th, octv.sigmas) for v in range(V)]
        xy_o, s_o, lvl_o, ok_o, val_o, sub_o = (
            torch.stack(t) for t in zip(*outs))
        stack = octv.blurs.reshape(V * L2, oh, ow)
        lvl_flat = (torch.arange(V, device=imgs.device)[:, None] * L2
                    + lvl_o - 1).reshape(-1)
        yield pd, stack, lvl_flat, xy_o, s_o, ok_o, val_o, sub_o


def detect_affine_keypoints(imgs: torch.Tensor, valid_hw: torch.Tensor,
                            p: PyramidParams, aff: AffineShapeParams,
                            caps: CapacityParams,
                            reg_number: torch.Tensor | None = None
                            ) -> Regions:
    """Full detector over a view batch: imgs (V, H, W) float32 (0..255);
    valid_hw (V, 2) int32 actual (h, w) per view.  Returns Regions
    (V, caps.per_view) in view coordinates, |response|-ordered."""
    per_oct = []
    for pd, stack, lvl_flat, xy_o, s_o, ok_o, val_o, sub_o in \
            octave_keypoints(imgs, valid_hw, p, caps):
        # Baumberg over ALL views at once
        A_f, ok_f = baumberg_adapt(
            stack, lvl_flat, xy_o.reshape(-1, 2), s_o.reshape(-1),
            ok_o.reshape(-1), aff)
        per_oct.append(Regions(
            xy=xy_o * pd, A=A_f.reshape(ok_o.shape + (2, 2)), s=s_o * pd,
            response=val_o, sub_type=sub_o, mask=ok_f.reshape(ok_o.shape)))
    regs = concat_regions(per_oct)
    return apply_detection_mode(regs, p, caps.per_view, reg_number)
