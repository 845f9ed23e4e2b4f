"""Engine-level constants and the configuration the flagship step reads
(mirrors ``mods_tpu/pipeline.py:52,117-132``; the escalation ladder
itself is a later slice of the port)."""

from __future__ import annotations

from dataclasses import dataclass, field

from mods_tpu_torch.config import (AffineShapeParams, CapacityParams,
                                   DominantOrientationParams, MatchParams,
                                   PyramidParams, RansacParams,
                                   SIFTDescriptorParams)

MIN_POINTS = 8  # matching.hpp MIN_POINTS


@dataclass(frozen=True)
class EngineConfig:
    pyramid: PyramidParams = field(default_factory=PyramidParams)
    affine: AffineShapeParams = field(default_factory=AffineShapeParams)
    dom_ori: DominantOrientationParams = field(
        default_factory=lambda: DominantOrientationParams(max_angles=1))
    sift: SIFTDescriptorParams = field(
        default_factory=lambda: SIFTDescriptorParams(root_sift=True))
    match: MatchParams = field(default_factory=MatchParams)
    ransac: RansacParams = field(default_factory=RansacParams)
    caps: CapacityParams = field(default_factory=CapacityParams)
