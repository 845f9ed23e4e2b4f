"""The flagship two-view matching step (mirrors
``mods_tpu/models/flagship.py``): detect -> orient -> describe -> FGINN
match -> LO-RANSAC H, for one identity view per image, on one pair or on
a batch of pairs that goes through each stage at once.

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
from mods_tpu_torch.ops.select import take_rows
from mods_tpu_torch.pipeline import MIN_POINTS, EngineConfig
from mods_tpu_torch.ransac.homography import ransac_h


def _features(imgs: torch.Tensor, cfg: EngineConfig):
    """(P, H, W) identity views -> (xy, A, s, desc, mask), each (P, K*M,
    ...): one row per (region, orientation slot) of each image.  The P
    images go through each stage together: one detector call (Baumberg
    once an octave for all of them), one orientation and one descriptor
    sampler launch."""
    P, h, w = imgs.shape
    caps = cfg.caps
    valid_hw = torch.tensor([[h, w]], dtype=torch.int32).repeat(P, 1)
    with record_function("mods.detect"):
        regs = detect_affine_keypoints(imgs, valid_hw, cfg.pyramid,
                                       cfg.affine, caps)
    do = cfg.dom_ori
    M = caps.max_angles
    with record_function("mods.orient"):
        mips, mip_hw = mip_stack(imgs, DESC_MIP_LEVELS)
        angles, amask = detect_orientations(
            imgs, regs.xy, regs.A, regs.s, regs.mask,
            do.patch_extraction.mr_size, do.patch_extraction.patch_size,
            M, do.threshold, mip_src=(mips, mip_hw))
    with record_function("mods.describe"):
        Arot = rotate_shapes(regs.A, angles)            # (P, K, M, 2, 2)
        K = regs.capacity
        xy = regs.xy[:, :, None].expand(P, K, M, 2).reshape(P, K * M, 2)
        A = Arot.reshape(P, K * M, 2, 2)
        s = regs.s[:, :, None].expand(P, K, M).reshape(P, K * M)
        m = amask.reshape(P, K * M)
        pe = cfg.sift.patch_extraction
        patches = extract_descriptor_patches_mip(
            mips, mip_hw, xy, A, s, pe.mr_size, pe.patch_size,
            photo_norm=pe.photo_norm)
        desc = compute_sift(patches, cfg.sift).reshape(P, K * M, -1)
    return xy, A, s, desc, m


def two_view_step(img1: torch.Tensor, img2: torch.Tensor,
                  generator: torch.Generator, cfg: EngineConfig) -> dict:
    """Single-rung (identity view) two-view match of two (H, W) float32
    images on one device -> dict(H, n_tentatives, n_inliers): the pair
    batch of one."""
    out = batched_pair_step(img1[None], img2[None], [generator], cfg)
    return {k: v[0] for k, v in out.items()}


def batched_pair_step(imgs1: torch.Tensor, imgs2: torch.Tensor,
                      generators: list, cfg: EngineConfig) -> dict:
    """(P, H, W) x2 pair batch -> ``two_view_step``'s outputs stacked
    along the pair axis (``mods_tpu/models/flagship.py::batched_pair_step``,
    a ``jax.vmap`` there), with one ``torch.Generator`` a pair.  The P
    pairs go through each stage at once: each side's detection,
    orientation and description (``_features``), FGINN matching and the
    duplicate filter as batched products, and LO-RANSAC H with one host
    read of the P best counts a round; so a batch launches the kernels as
    often as one pair does (12 ``baumberg_smm``, 4 ``window_sampler``)."""
    if len(generators) != imgs1.shape[0]:
        raise ValueError(f"{len(generators)} generators for "
                         f"{imgs1.shape[0]} pairs")
    xy1, _, _, d1, m1 = _features(imgs1, cfg)
    xy2, _, _, d2, m2 = _features(imgs2, cfg)
    with record_function("mods.match"):
        t = match_fginn(d1, m1, d2, m2, xy2, cfg.match.ratio_threshold,
                        cfg.match.contrad_dist, cfg.match.knn)
        txy2 = take_rows(xy2, t.idx2, 1)
        keep = duplicate_filter(xy1, txy2, t.mask, cfg.match.duplicate_dist)
        tmask = t.mask & keep
    with record_function("mods.ransac"):
        H, inl, n_inl = ransac_h(xy1, txy2, tmask, cfg.ransac, generators)
    n_tent = tmask.to(torch.int32).sum(-1)
    n_inl = torch.where(n_tent >= MIN_POINTS, n_inl, 0)
    return dict(H=H, n_tentatives=n_tent, n_inliers=n_inl)


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
