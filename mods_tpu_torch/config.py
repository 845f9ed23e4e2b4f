"""Typed configuration tree for the flagship two-view step.

A copy of the dataclasses of ``mods_tpu/config.py`` that the flagship
path reads, with the same field names and defaults (the reference's
constructor defaults: detectors/structures.hpp:127-167, affine.h:91-132,
descriptors_parameters.hpp:23-37, matching.hpp:97-171).  The port keeps
its own copy because importing anything of ``mods_tpu`` imports JAX.

``from_dict`` turns ``dataclasses.asdict`` of a JAX-side ``EngineConfig``
into this package's ``EngineConfig``.  The flagship path has no learned
weights (SIFT bins, Gaussian taps and masks all derive from the config),
so this is all the state the two packages share.
"""

from __future__ import annotations

import dataclasses
import math
import typing
from dataclasses import dataclass, field


class DetectorType:
    HESSIAN = "Hessian"
    DOG = "DoG"
    HARRIS = "Harris"


class DetectionMode:
    FIXED_TH = "FixedTh"
    RELATIVE_TH = "RelativeTh"
    FIXED_REG_NUMBER = "FixedRegNumber"
    RELATIVE_REG_NUMBER = "RelativeRegNumber"
    NOT_LESS_THAN_REGIONS = "NotLessThanRegions"


@dataclass(frozen=True)
class PyramidParams:
    """reference detectors/structures.hpp:127-167."""
    upscale_input_image: int = 0
    n_scales: int = 3
    initial_sigma: float = 1.6
    threshold: float = 16.0 / 3.0
    rel_threshold: float = -1.0
    reg_number: int = -1
    rel_reg_number: float = -1.0
    edge_eigen_value_ratio: float = 10.0
    border: int = 5
    detector_mode: str = DetectionMode.FIXED_TH
    detector_type: str = DetectorType.HESSIAN
    ii_dog: bool = False
    do_on_wld: bool = False
    wld_a: float = 3.0
    wld_b: float = 5.0
    wld_g: float = 5.0
    tilde_filters: str = ""


@dataclass(frozen=True)
class AffineShapeParams:
    """Baumberg adaptation params (reference affine.h:91-132)."""
    max_iterations: int = 16
    convergence_threshold: float = 0.05
    smm_window_size: int = 19
    patch_size: int = 41
    initial_sigma: float = 1.6
    mr_size: float = 3.0 * math.sqrt(3.0)
    do_baumberg: bool = True


@dataclass(frozen=True)
class PatchExtractionParams:
    """reference detectors/structures.hpp:246-258."""
    patch_size: int = 41
    mr_size: float = 5.1962
    fast_extraction: bool = False
    photo_norm: bool = True


@dataclass(frozen=True)
class DominantOrientationParams:
    """reference descriptors_parameters.hpp:23-37."""
    max_angles: int = -1          # -1 = all peaks above threshold
    threshold: float = 0.8
    add_up_right: bool = False
    half_sift_mode: bool = False
    patch_extraction: PatchExtractionParams = field(
        default_factory=PatchExtractionParams)


@dataclass(frozen=True)
class SIFTDescriptorParams:
    """reference matching/siftdesc.h:24-70."""
    spatial_bins: int = 4
    orientation_bins: int = 8
    max_bin_value: float = 0.2
    root_sift: bool = False
    half_sift: bool = False
    magn_less: bool = False
    do_norm: bool = True
    patch_extraction: PatchExtractionParams = field(
        default_factory=PatchExtractionParams)

    @property
    def dim(self) -> int:
        ob = self.orientation_bins // 2 if self.half_sift \
            else self.orientation_bins
        return self.spatial_bins * self.spatial_bins * ob


@dataclass(frozen=True)
class MatchParams:
    """reference matching.hpp:97-146 (the fields the flagship reads,
    plus the ones a JAX-side config carries, so ``from_dict`` is total)."""
    ratio_threshold: float = 0.8
    distance_threshold: float = 64.0
    contrad_dist: float = 10.0
    knn: int = 50
    standard_2nd_closest: bool = False
    duplicate_dist: float = 3.0
    duplicate_mode: str = "random"
    fginn_per_desc: tuple = ()
    dist_per_desc: tuple = ()
    use_db_for_fginn: bool = False
    sift_db_file: str = ""


class RansacErrorType:
    SAMPSON = "sampson"
    SYMM_MAX = "symm_max"
    SYMM_SUM = "symm_sum"


@dataclass(frozen=True)
class RansacParams:
    """reference matching.hpp:147-171, plus the batching knobs of the
    JAX package (hypotheses per round, rounds, LO sizes)."""
    use_f: bool = False
    err_threshold: float = 2.0
    confidence: float = 0.99
    max_samples: int = 100000
    local_optimization: bool = True
    laf_coef: float = 3.0
    h_laf_coef: float = 10.0
    error_type: str = RansacErrorType.SYMM_SUM
    do_symm_check: bool = False
    batch_hypotheses: int = 2048
    max_rounds: int = 48
    lo_inner_samples: int = 10
    lo_sample_size: int = 14
    lo_iters: int = 4


@dataclass(frozen=True)
class CapacityParams:
    """Static capacities: the region and tentative slabs are fixed-size
    tensors with validity masks, as in the JAX package."""
    per_octave: int = 8192
    per_octave_baum: int = 256
    per_view: int = 2048
    per_group: int = 768
    per_image: int = 8192
    max_angles: int = 4
    tentatives: int = 2048


def from_dict(d: dict, cls=None):
    """``dataclasses.asdict(<mods_tpu EngineConfig>)`` -> this package's
    ``EngineConfig`` (or ``cls``, for one parameter group such as
    ``PyramidParams``).  Keys this package has no field for (the
    ladder's other detectors and descriptors) are ignored."""
    if cls is None:
        from mods_tpu_torch.pipeline import EngineConfig
        cls = EngineConfig
    return _build(cls, d)


def _build(cls, d: dict):
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        t = hints[f.name]
        if dataclasses.is_dataclass(t):
            v = _build(t, v)
        elif isinstance(v, list):
            v = tuple(tuple(x) if isinstance(x, list) else x for x in v)
        kw[f.name] = v
    return cls(**kw)
