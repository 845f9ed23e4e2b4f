"""Typed configuration tree for the flagship step and the escalation
ladder.

A copy of the dataclasses of ``mods_tpu/config.py`` that the ported
paths read, with the same field names and defaults (the reference's
constructor defaults: detectors/structures.hpp:127-167, affine.h:91-132,
descriptors_parameters.hpp:23-37, matching.hpp:97-171).  The port keeps
its own copy because importing anything of ``mods_tpu`` imports JAX.

``from_dict`` turns ``dataclasses.asdict`` of a JAX-side ``EngineConfig``
(or of one ladder rung, with ``cls=IterationParams``) into this
package's.  The ported paths have no learned weights (SIFT bins,
Gaussian taps and masks all derive from the config), so this is all the
state the two packages share.
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
class OrbParams:
    """reference ORBParams (detectors_parameters.hpp:203-233)."""
    nfeatures: int = 500
    scale_factor: float = 1.2
    nlevels: int = 8
    edge_threshold: int = 31
    first_level: int = 0
    wta_k: int = 2
    do_nms: int = 1
    fast_threshold: float = 20.0    # cv::ORB internal default


@dataclass(frozen=True)
class FastParams:
    """reference FASTParams (detectors_parameters.hpp:144-157)."""
    threshold: float = 10.0
    nonmax_suppression: bool = True
    type: int = 0


@dataclass(frozen=True)
class StarParams:
    """reference STARParams (detectors_parameters.hpp:158-175)."""
    max_size: int = 45
    response_threshold: int = 30
    line_threshold_projected: int = 10
    line_threshold_binarized: int = 8
    suppress_nonmax_size: int = 5


@dataclass(frozen=True)
class SurfDetParams:
    """reference SURFParams (detectors_parameters.hpp:120-142)."""
    octaves: int = 4
    intervals: int = 4
    init_sample: int = 2
    thresh: float = 0.0004


@dataclass(frozen=True)
class BriskDetParams:
    """reference BRISKParams (detectors_parameters.hpp:176-196)."""
    thresh: int = 30
    octaves: int = 3
    pattern_scale: float = 1.0


@dataclass(frozen=True)
class FreakParams:
    """reference FREAKParams (descriptors/freakdescriptor.hpp)."""
    orientation_normalized: bool = False
    scale_normalized: bool = False
    pattern_scale: float = 22.0
    n_octaves: int = 4


@dataclass(frozen=True)
class CnnParams:
    """reference CaffeDescriptorParams (descriptors_parameters.hpp:39-68)
    as the JAX package re-cut it for its conv-stack descriptor."""
    weights_file: str = ""
    patch_size: int = 32
    mr_size: float = 12.0
    dim: int = 128
    normalization: str = "L2"       # L2 | L1 | RootL2 | none
    mean_gray: float = (104.0 + 117.0 + 123.0) / 3.0
    do_sift_like_orientation: bool = True


@dataclass(frozen=True)
class DaisyParams:
    """reference DAISYParams (descriptors/daisydescriptor.hpp)."""
    rad: int = 15
    radq: int = 3
    thq: int = 8
    histq: int = 8
    nrm_type: str = "partial"

    @property
    def dim(self) -> int:
        return (1 + self.radq * self.thq) * self.histq


@dataclass(frozen=True)
class LiopParams:
    """reference LIOPDescriptorParams (matching/liopdesc.hpp:20-33)."""
    neighbours: int = 4
    bins: int = 6
    radius: float = 6.0
    threshold: float = 5.0

    @property
    def dim(self) -> int:
        return self.bins * math.factorial(self.neighbours)


@dataclass(frozen=True)
class SsimParams:
    """reference SSIMParams (descriptors/ssimdescriptor.hpp)."""
    window_size: int = 5
    desc_rad: int = 40
    nrad: int = 4
    nang: int = 10
    cor_size: int = 20
    var_noise: float = 300000.0
    saliency_thresh: float = 0.7
    homogeneity_thresh: float = 0.7
    snn_thresh: float = 0.85

    @property
    def dim(self) -> int:
        return self.nrad * self.nang


@dataclass(frozen=True)
class MroghParams:
    """reference MROGHParams (descriptors/mroghdesc.hpp)."""
    n_dir: int = 8
    n_order: int = 6
    n_multi_region: int = 3

    @property
    def dim(self) -> int:
        return self.n_dir * self.n_order * self.n_multi_region


@dataclass(frozen=True)
class PixelsParams:
    """reference PIXELSDescriptorParams (descriptors/pixelsdesc.hpp)."""
    norm_type: str = "L2"


@dataclass(frozen=True)
class DetectorParams:
    """One scale-space detector slot = pyramid + affine shape params."""
    pyramid: PyramidParams = field(default_factory=PyramidParams)
    affine: AffineShapeParams = field(default_factory=AffineShapeParams)
    do_baumberg: bool = True


@dataclass(frozen=True)
class MatchParams:
    """reference matching.hpp:97-146."""
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

    def group_fginn(self, desc: str) -> float:
        return dict(self.fginn_per_desc).get(desc, 0.0)

    def group_distance(self, desc: str) -> float:
        return dict(self.dist_per_desc).get(desc, 0.0)


@dataclass(frozen=True)
class MatchPlan:
    """Per-rung matching plan (the reference ``WhatToMatch`` struct,
    io_mods.cpp:487-501): each descriptor in ``group_descriptors`` is
    matched once over the pooled regions of all ``group_detectors`` with
    the global thresholds; each (detector, descriptor) of
    ``separate_detectors`` x ``separate_descriptors`` on its own with the
    rung's thresholds, and only when that detector ran this rung."""
    group_descriptors: tuple = ()
    group_detectors: tuple = ()
    separate_detectors: tuple = ()
    separate_descriptors: tuple = ()


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
class OrsaParams:
    """A-contrario verification (reference orsa.cpp; acceptance rule
    matching.cpp:1035-1040).  ``rounds`` bounds the hypothesis rounds;
    once log10-NFA has improved by less than ``min_improvement`` for
    ``stall_rounds`` rounds in a row, the rest are skipped."""
    max_log_nfa: float = -2.0
    batch_hypotheses: int = 512
    rounds: int = 8
    stall_rounds: int = 2
    min_improvement: float = 0.5


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


@dataclass(frozen=True)
class ViewParams:
    """One synthetic view: (tilt, phi, zoom), reference
    ViewSynthParameters (structures.hpp:219-231).  phi in radians; a
    negative tilt in a tilt set means vertical-tilt mode and is stored
    with ``vertical=True`` and positive tilt."""
    tilt: float = 1.0
    phi: float = 0.0
    zoom: float = 1.0
    init_sigma: float = 0.5
    do_blur: bool = True
    vertical: bool = False


@dataclass(frozen=True)
class IterationParams:
    """One rung of the escalation ladder: detector -> views -> descriptors
    with per-descriptor match thresholds (reference iters_*.ini sections,
    io_mods.cpp:653-688)."""
    detector: str = "HessianAffine"
    descriptors: tuple[str, ...] = ("RootSIFT",)
    tilt_set: tuple[float, ...] = (1.0,)
    scale_set: tuple[float, ...] = (1.0,)
    phi_base: float = 360.0
    init_sigma: float = 0.5
    do_blur: bool = True
    fginn_threshold: tuple[float, ...] = (0.8,)
    distance_threshold: tuple[float, ...] = (0.0,)

    def fginn_for(self, desc: str) -> float:
        m = dict(zip(self.descriptors, self.fginn_threshold))
        return m.get(desc, 0.0)

    def distance_for(self, desc: str) -> float:
        m = dict(zip(self.descriptors, self.distance_threshold))
        return m.get(desc, 0.0)


@dataclass(frozen=True)
class Rung:
    """One ladder step: the detector iterations that run (the reference
    allows several per step, io_mods.cpp:663-688) plus the step's
    matching plan."""
    dets: tuple[IterationParams, ...] = (IterationParams(),)
    plan: MatchPlan | None = None

    @property
    def detectors(self) -> tuple[str, ...]:
        return tuple(d.detector for d in self.dets)

    def default_plan(self) -> MatchPlan:
        """With no plan given: match each of this rung's (detector,
        descriptor) pairs separately."""
        descs = []
        for d in self.dets:
            for name in d.descriptors:
                if name not in descs:
                    descs.append(name)
        return MatchPlan(separate_detectors=self.detectors,
                         separate_descriptors=tuple(descs))


def as_rungs(ladder) -> list:
    """Normalize a ladder given as IterationParams list / Rung list."""
    out = []
    for item in ladder:
        if isinstance(item, Rung):
            out.append(item)
        elif isinstance(item, IterationParams):
            out.append(Rung(dets=(item,)))
        else:
            out.append(Rung(dets=tuple(item)))
    return out


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def from_dict(d: dict, cls=None):
    """``dataclasses.asdict(<mods_tpu EngineConfig>)`` -> this package's
    ``EngineConfig`` (or ``cls``, for one parameter group such as
    ``PyramidParams`` or ``IterationParams``).  Keys this package has
    no field for (the detectors and descriptors not ported yet) are
    ignored."""
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
