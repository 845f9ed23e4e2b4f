"""The flagship two-view matching step (mirrors
``mods_tpu/models/flagship.py``): detect -> orient -> describe -> FGINN
match -> LO-RANSAC H, for one identity view per image.

Every patch the step reads is sampled by a hand-written kernel: the
Baumberg iteration inside ``csrc/baumberg_smm.cu``
(``detectors/baumberg.py::baumberg_adapt``), orientation and descriptor
patches by ``csrc/window_sampler.cu``
(``ops/sampler.py::sample_affine_patches``).  The stages run inside ``torch.profiler`` ranges
(``mods.detect``, ``mods.orient``, ``mods.describe``, ``mods.match``,
``mods.ransac``), which cost nothing unless a profiler is recording
(``chip_smoke.py`` phase 5).
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from mods_tpu_torch.config import CapacityParams
from mods_tpu_torch.descriptors.describe import (
    DESC_MIP_LEVELS, extract_descriptor_patches_mip)
from mods_tpu_torch.descriptors.orientation import (detect_orientations,
                                                    rotate_shapes)
from mods_tpu_torch.descriptors.sift import compute_sift
from mods_tpu_torch.detectors.hessaff import detect_affine_keypoints
from mods_tpu_torch.device import resolve_device
from mods_tpu_torch.matching.fginn import duplicate_filter, match_fginn
from mods_tpu_torch.ops.sampler import mip_stack
from mods_tpu_torch.pipeline import MIN_POINTS, EngineConfig
from mods_tpu_torch.ransac.homography import ransac_h


def _features_one(img: torch.Tensor, cfg: EngineConfig):
    """(H, W) identity-view features -> (xy, A, s, desc, mask), one row
    per (region, orientation slot)."""
    h, w = img.shape
    caps = cfg.caps
    valid_hw = torch.tensor([[h, w]], dtype=torch.int32)
    with record_function("mods.detect"):
        regs = detect_affine_keypoints(
            img[None], valid_hw, cfg.pyramid, cfg.affine, caps)
    do = cfg.dom_ori
    M = caps.max_angles
    with record_function("mods.orient"):
        mips, mip_hw = mip_stack(img, DESC_MIP_LEVELS)
        angles, amask = detect_orientations(
            img, regs.xy[0], regs.A[0], regs.s[0], regs.mask[0],
            do.patch_extraction.mr_size, do.patch_extraction.patch_size,
            M, do.threshold, mip_src=(mips, mip_hw))
    with record_function("mods.describe"):
        Arot = rotate_shapes(regs.A[0], angles)         # (K, M, 2, 2)
        K = regs.capacity
        xy = regs.xy[0][:, None].expand(K, M, 2).reshape(K * M, 2)
        A = Arot.reshape(K * M, 2, 2)
        s = regs.s[0][:, None].expand(K, M).reshape(K * M)
        m = amask.reshape(K * M)
        pe = cfg.sift.patch_extraction
        patches = extract_descriptor_patches_mip(
            mips, mip_hw, xy, A, s, pe.mr_size, pe.patch_size,
            photo_norm=pe.photo_norm)
        desc = compute_sift(patches, cfg.sift)
    return xy, A, s, desc, m


def two_view_step(img1: torch.Tensor, img2: torch.Tensor,
                  generator: torch.Generator, cfg: EngineConfig) -> dict:
    """Single-rung (identity view) two-view match of two (H, W) float32
    images on one device -> dict(H, n_tentatives, n_inliers)."""
    xy1, _, _, d1, m1 = _features_one(img1, cfg)
    xy2, _, _, d2, m2 = _features_one(img2, cfg)
    with record_function("mods.match"):
        t = match_fginn(d1, m1, d2, m2, xy2, cfg.match.ratio_threshold,
                        cfg.match.contrad_dist, cfg.match.knn)
        txy2 = xy2[t.idx2]
        keep = duplicate_filter(xy1, txy2, t.mask, cfg.match.duplicate_dist)
        tmask = t.mask & keep
    with record_function("mods.ransac"):
        H, inl, n_inl = ransac_h(xy1, txy2, tmask, cfg.ransac, generator)
    n_tent = tmask.to(torch.int32).sum()
    n_inl = torch.where(n_tent >= MIN_POINTS, n_inl, 0)
    return dict(H=H, n_tentatives=n_tent, n_inliers=n_inl)


def batched_pair_step(imgs1: torch.Tensor, imgs2: torch.Tensor,
                      generators: list, cfg: EngineConfig) -> dict:
    """(P, H, W) x2 pair batch -> ``two_view_step``'s outputs stacked
    along the pair axis (``mods_tpu/models/flagship.py::batched_pair_step``,
    a ``jax.vmap`` there).  Here it is a loop over the pairs with one
    ``torch.Generator`` a pair; the truly batched form belongs with the
    pair-batched serving path (ROADMAP.md item 22)."""
    outs = [two_view_step(a, b, g, cfg)
            for a, b, g in zip(imgs1, imgs2, generators, strict=True)]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}


def default_config() -> EngineConfig:
    """The caps of ``mods_tpu/models/flagship.py:75-80``."""
    return EngineConfig(caps=CapacityParams(
        per_octave=512, per_view=512, per_image=1024, max_angles=2))


def make_two_view_step(cfg: EngineConfig | None = None,
                       device: str | torch.device = "cuda"):
    """``step(img1, img2, generator)`` on ``device`` (the card unless the
    caller asks for the CPU).  Images may be numpy arrays or tensors;
    the generator must live on the same device."""
    cfg = default_config() if cfg is None else cfg
    dev = resolve_device(device)

    def step(img1, img2, generator: torch.Generator) -> dict:
        return two_view_step(
            torch.as_tensor(img1, dtype=torch.float32, device=dev),
            torch.as_tensor(img2, dtype=torch.float32, device=dev),
            generator, cfg)

    return step
