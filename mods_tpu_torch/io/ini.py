"""Reference-compatible INI configuration import (mirrors
``mods_tpu/io/ini.py`` on the port's dataclasses).

Parses the reference's two config files (SURVEY.md §5.6):
  * `config_iter_*.ini` — per-stage parameters (io_mods.cpp:104-652)
  * `iters_*.ini` — the escalation ladder (io_mods.cpp:653-688):
    `[Iterations] Steps/minMatches` then per-step `[<Detector><step>]`
    sections with TiltSet/ScaleSet/Phi/initSigma/Descriptors/
    FGINNThreshold/DistanceThreshold and `[Matching<step>]` grouping.

The reference uses inih with `;` comments and values like
"1;,5,9;  comment" where everything after the first `;` is commentary.
"""

from __future__ import annotations

import configparser
import re

from mods_tpu_torch.config import (DetectionMode, IterationParams,
                                   MatchParams, MatchPlan, PyramidParams,
                                   RansacErrorType, RansacParams, Rung)

KNOWN_DETECTORS = (
    "HessianAffine", "DoG", "HarrisAffine", "MSER", "ORB", "TILDE",
    "ReadAffs", "FOCI", "SURF", "FAST", "STAR", "BRISK", "Saddle",
    "WAVE", "WASH", "SFOP", "TOS-MSER", "MIK-MSER", "KAZE",
)


def _strip_value(v: str) -> str:
    """Drop inih-style `;` trailing comments."""
    return v.split(";", 1)[0].strip()


def load_ini(path: str) -> dict[str, dict[str, str]]:
    cp = configparser.ConfigParser(strict=False, interpolation=None,
                                   comment_prefixes=(";", "#"),
                                   inline_comment_prefixes=None)
    cp.optionxform = str  # keep case
    with open(path) as f:
        text = f.read()
    cp.read_string(text)
    out: dict[str, dict[str, str]] = {}
    for sec in cp.sections():
        out[sec] = {k: _strip_value(v) for k, v in cp[sec].items()}
    return out


def _floats(v: str) -> tuple[float, ...]:
    v = _strip_value(v)
    return tuple(float(x) for x in re.split(r"[,\s]+", v) if x)


def _strs(v: str) -> tuple[str, ...]:
    v = _strip_value(v)
    return tuple(x for x in re.split(r"[,\s]+", v) if x)


def parse_iters_file(path: str):
    """-> (steps, min_matches, ladder: list[Rung]).

    Each step may declare several `[<Detector><step>]` sections (the
    reference scans all DetectorNames per step, io_mods.cpp:663-688)
    plus a `[Matching<step>]` plan (io_mods.cpp:487-501)."""
    ini = load_ini(path)
    its = ini.get("Iterations", {})
    steps = int(float(its.get("Steps", "1")))
    min_matches = int(float(its.get("minMatches", "15")))
    ladder: list[Rung] = []
    for step in range(steps):
        dets: list[IterationParams] = []
        for d in KNOWN_DETECTORS:
            sec = ini.get(f"{d}{step}")
            if sec is None:
                continue
            descs = _strs(sec.get("Descriptors", "RootSIFT"))
            dets.append(IterationParams(
                detector=d,
                descriptors=descs,
                tilt_set=_floats(sec.get("TiltSet", "1")),
                scale_set=_floats(sec.get("ScaleSet", "1")),
                phi_base=_floats(sec.get("Phi", "360"))[0],
                init_sigma=_floats(sec.get("initSigma", "0.5"))[0],
                fginn_threshold=_floats(sec.get("FGINNThreshold", "0.8")),
                distance_threshold=_floats(
                    sec.get("DistanceThreshold", "0")),
            ))
        if not dets:
            break
        plan = None
        msec = ini.get(f"Matching{step}")
        if msec is not None:
            plan = MatchPlan(
                group_descriptors=_strs(msec.get("GroupDescriptors", "")),
                group_detectors=_strs(msec.get("GroupDetectors", "")),
                separate_detectors=_strs(
                    msec.get("SeparateDetectors", "")),
                separate_descriptors=_strs(
                    msec.get("SeparateDescriptors", "")),
            )
        ladder.append(Rung(dets=tuple(dets), plan=plan))
    return steps, min_matches, ladder


def parse_detector_config(ini: dict, section: str = "HessianAffine"
                          ) -> PyramidParams:
    """[HessianAffine]/[DoG]/[HarrisAffine] sections
    (io_mods.cpp Get*Pars)."""
    sec = ini.get(section, {})
    g = lambda k, d: float(_strip_value(sec.get(k, str(d))))
    mode = sec.get("mode", "FixedTh")
    mode_map = {
        "FixedTh": DetectionMode.FIXED_TH,
        "RelativeTh": DetectionMode.RELATIVE_TH,
        "FixedRegNumber": DetectionMode.FIXED_REG_NUMBER,
        "RelativeRegNumber": DetectionMode.RELATIVE_REG_NUMBER,
        "NotLessThanRegions": DetectionMode.NOT_LESS_THAN_REGIONS,
    }
    det_type = {"HessianAffine": "Hessian", "DoG": "DoG",
                "HarrisAffine": "Harris"}.get(section, "Hessian")
    return PyramidParams(
        n_scales=int(g("numberOfScales", 3)),
        initial_sigma=g("initialSigma", 1.6),
        threshold=g("threshold", 16.0 / 3.0),
        rel_threshold=g("relativeThreshold", -1),
        reg_number=int(g("regionsNumber", -1)),
        rel_reg_number=g("relativeRegionsNumber", -1),
        edge_eigen_value_ratio=g("edgeEigenValueRatio", 10.0),
        border=int(g("border", 5)),
        detector_mode=mode_map.get(mode, DetectionMode.FIXED_TH),
        detector_type=det_type,
        ii_dog=bool(int(g("iiDoGMode", 0))),
        do_on_wld=bool(int(g("doOnWLD", 0))),
        wld_a=g("WLDa", 3.0), wld_b=g("WLDb", 5.0), wld_g=g("WLDg", 5.0),
    )


def parse_affine_config(ini: dict, section: str = "HessianAffine"):
    """Baumberg-adaptation keys of a scale-space detector section
    (io_mods.cpp: max_iter/convergenceThreshold/smmWindowSize/patch_size/
    doBaumberg)."""
    from mods_tpu_torch.config import AffineShapeParams
    sec = ini.get(section, {})
    g = lambda k, d: float(_strip_value(sec.get(k, str(d))))
    return AffineShapeParams(
        max_iterations=int(g("max_iter", 16)),
        convergence_threshold=g("convergenceThreshold", 0.05),
        smm_window_size=int(g("smmWindowSize", 19)),
        patch_size=int(g("patch_size", 41)),
        initial_sigma=g("initialSigma", 1.6),
        do_baumberg=bool(int(g("doBaumberg", 1))),
    )


def parse_mser_config(ini: dict):
    """[MSER] section (io_mods.cpp GetMSERPars)."""
    from mods_tpu_torch.pipeline import MserParams
    sec = ini.get("MSER", {})
    g = lambda k, d: float(_strip_value(sec.get(k, str(d))))
    backend = _strip_value(sec.get("backend", "host")).lower()
    if backend not in ("host", "device"):
        backend = "host"
    return MserParams(
        min_size=int(g("min_size", 30)),
        max_area=g("max_area", 0.05),
        min_margin=int(g("min_margin", 8)),
        backend=backend,
        levels=int(g("levels", 32)),
        passes=int(g("passes", 3)),
    )


def _sec_reader(ini: dict, section: str):
    sec = ini.get(section, {})

    def g(key, default):
        return float(_strip_value(sec.get(key, str(default))))

    def gb(key, default):
        v = _strip_value(sec.get(key, str(default))).lower()
        return v in ("1", "true", "yes")

    def gs(key, default):
        return _strip_value(sec.get(key, default))
    return g, gb, gs


def parse_descriptor_sections(ini: dict) -> dict:
    """The remaining per-detector/per-descriptor Get*Pars sections
    (io_mods.cpp:104-652) -> EngineConfig keyword overrides."""
    from mods_tpu_torch.config import (BriskDetParams, DaisyParams,
                                       FastParams, FreakParams, LiopParams,
                                       MroghParams, OrbParams, PixelsParams,
                                       SsimParams, StarParams,
                                       SurfDetParams)
    out = {}
    g, gb, gs = _sec_reader(ini, "ORB")
    out["orb"] = OrbParams(
        nfeatures=int(g("nfeatures", 500)),
        scale_factor=g("scaleFactor", 1.2),
        nlevels=int(g("nlevels", 8)),
        edge_threshold=int(g("edgeThreshold", 31)),
        first_level=int(g("firstLevel", 0)),
        wta_k=int(g("WTA_K", 2)),
        do_nms=int(g("doNMS", 1)))
    g, gb, gs = _sec_reader(ini, "FAST")
    out["fast"] = FastParams(
        threshold=g("threshold", 10.0),
        nonmax_suppression=gb("nonmaxSuppression", True),
        type=int(g("type", 0)))
    g, gb, gs = _sec_reader(ini, "STAR")
    out["star"] = StarParams(
        max_size=int(g("maxSize", 45)),
        response_threshold=int(g("responseThreshold", 30)),
        line_threshold_projected=int(g("lineThresholdProjected", 10)),
        line_threshold_binarized=int(g("lineThresholdBinarized", 8)),
        suppress_nonmax_size=int(g("suppressNonmaxSize", 5)))
    g, gb, gs = _sec_reader(ini, "SURF")
    out["surf_det"] = SurfDetParams(
        octaves=int(g("octaves", 4)),
        intervals=int(g("intervals", 4)),
        init_sample=int(g("init_sample", 2)),
        thresh=g("thres", 0.0004))
    g, gb, gs = _sec_reader(ini, "BRISK")
    out["brisk"] = BriskDetParams(
        thresh=int(g("thresh", 30)),
        octaves=int(g("octaves", 3)),
        pattern_scale=g("patternScale", 1.0))
    g, gb, gs = _sec_reader(ini, "FREAK")
    out["freak"] = FreakParams(
        orientation_normalized=gb("orientationNormalized", False),
        scale_normalized=gb("scaleNormalized", False),
        pattern_scale=g("patternScale", 22.0),
        n_octaves=int(g("nOctaves", 4)))
    g, gb, gs = _sec_reader(ini, "DAISY")
    out["daisy"] = DaisyParams(
        rad=int(g("rad", 15)), radq=int(g("radq", 3)),
        thq=int(g("thq", 8)), histq=int(g("histq", 8)))
    g, gb, gs = _sec_reader(ini, "LIOP")
    out["liop"] = LiopParams(
        neighbours=int(g("neighbours", 4)), bins=int(g("bins", 6)),
        radius=g("radius", 6.0), threshold=g("threshold", 5.0))
    g, gb, gs = _sec_reader(ini, "SSIM")
    out["ssim"] = SsimParams(
        window_size=int(g("window_size", 5)),
        desc_rad=int(g("desc_rad", 40)),
        nrad=int(g("nrad", 4)), nang=int(g("nang", 10)),
        cor_size=int(g("cor_size", 20)),
        var_noise=g("var_noise", 300000.0),
        saliency_thresh=g("saliency_thresh", 0.7),
        homogeneity_thresh=g("homogeneity_thresh", 0.7),
        snn_thresh=g("snn_thresh", 0.85))
    g, gb, gs = _sec_reader(ini, "MROGHDescriptor")
    out["mrogh"] = MroghParams(
        n_dir=int(g("nDir", 8)), n_order=int(g("nOrder", 6)),
        n_multi_region=int(g("nMultiRegion", 3)))
    g, gb, gs = _sec_reader(ini, "PixelDescriptor")
    out["pixels"] = PixelsParams(norm_type=gs("normType", "L2"))
    # GetCaffePars (io_mods.cpp:467-485); WeightsFile carries over as the
    # .npz path of the JAX package's conv stack (descriptors/cnn.py)
    from mods_tpu_torch.config import CnnParams
    g, gb, gs = _sec_reader(ini, "CaffeDescriptor")
    out["cnn"] = CnnParams(
        weights_file=gs("WeightsFile", ""),
        patch_size=int(g("patchSize", 32)),
        mr_size=g("mrSize", 12.0),
        normalization=gs("Normalization", "L2"),
        do_sift_like_orientation=gb("DoSIFTLikeOrientation", True))
    # external-binary plugin (imagerepresentation.cpp:747-1026)
    from mods_tpu_torch.pipeline import ExternalCmdParams
    g, gb, gs = _sec_reader(ini, "ExternalDetector")
    out["external"] = ExternalCmdParams(
        command=gs("command", ""), format=gs("format", "oxford"),
        cap=int(g("cap", 512)),
        # BICE-pattern external descriptor (bicedescriptor.hpp;
        # dispatch imagerepresentation.cpp:1610)
        desc_command=gs("descCommand", ""),
        desc_dim=int(g("descDim", 128)))
    return out


def parse_dom_ori_config(ini: dict):
    """[DominantOrientation] section (io_mods.cpp GetDomOriPars)."""
    from mods_tpu_torch.config import (DominantOrientationParams,
                                       PatchExtractionParams)
    sec = ini.get("DominantOrientation", {})
    g = lambda k, d: float(_strip_value(sec.get(k, str(d))))
    def gb(k, d):
        v = _strip_value(sec.get(k, str(d))).lower()
        return v in ("1", "true", "yes")
    return DominantOrientationParams(
        max_angles=int(g("maxAngles", -1)),
        threshold=g("threshold", 0.8),
        add_up_right=gb("addUpright", False),
        half_sift_mode=gb("halfSIFTMode", False),
        patch_extraction=PatchExtractionParams(
            patch_size=int(g("patchSize", 41)),
            mr_size=g("mrSize", 5.1962)),
    )


def parse_sift_desc_config(ini: dict):
    """[SIFTDescriptor] section (io_mods.cpp GetSIFTDescPars)."""
    from mods_tpu_torch.config import (PatchExtractionParams,
                                       SIFTDescriptorParams)
    sec = ini.get("SIFTDescriptor", {})
    g = lambda k, d: float(_strip_value(sec.get(k, str(d))))
    def gb(k, d):
        v = _strip_value(sec.get(k, str(d))).lower()
        return v in ("1", "true", "yes")
    return SIFTDescriptorParams(
        spatial_bins=int(g("spatialBins", 4)),
        orientation_bins=int(g("orientationBins", 8)),
        max_bin_value=g("maxBinValue", 0.2),
        root_sift=True,
        patch_extraction=PatchExtractionParams(
            patch_size=int(g("patchSize", 41)),
            mr_size=g("mrSize", 5.1962),
            fast_extraction=gb("FastPatchExtraction", False),
            photo_norm=gb("photoNorm", True)),
    )


def parse_flags_config(ini: dict) -> dict:
    """Engine-level flags scattered over [Matching]/[SURF]
    (doCLAHE io_mods.cpp:746; doBothRANSACgroundTruth/RANSACforStopping
    GetMatchPars)."""
    m = ini.get("Matching", {})
    g = lambda k, d: float(_strip_value(m.get(k, str(d))))
    surf = ini.get("SURF", {})
    gs = lambda k, d: float(_strip_value(surf.get(k, str(d))))
    return dict(
        do_clahe=bool(int(g("doCLAHE", 0))),
        do_both_ransac_gt=bool(int(g("doBothRANSACgroundTruth", 1))),
        surf_threshold=gs("thres", 0.0004),
    )


def parse_ransac_config(ini: dict) -> RansacParams:
    sec = ini.get("RANSAC", {})
    g = lambda k, d: float(_strip_value(sec.get(k, str(d))))
    et = sec.get("ErrorType", "SymmSum").strip()
    emap = {"Sampson": RansacErrorType.SAMPSON,
            "SymmMax": RansacErrorType.SYMM_MAX,
            "SymmSum": RansacErrorType.SYMM_SUM}
    return RansacParams(
        err_threshold=g("err_threshold", 2.0),
        confidence=g("confidence", 0.99),
        max_samples=int(g("max_samples", 1e5)),
        local_optimization=bool(int(g("localOptimization", 1))),
        laf_coef=g("LAFcoef", 3.0),
        h_laf_coef=g("HLAFcoef", 10.0),
        error_type=emap.get(et, RansacErrorType.SYMM_SUM),
        do_symm_check=bool(int(g("doSymmCheck", 0))),
    )


def parse_matching_config(ini: dict) -> MatchParams:
    sec = ini.get("Matching", {})
    g = lambda k, d: float(_strip_value(sec.get(k, str(d))))
    dup = ini.get("DuplicateFiltering", {})
    gd = lambda k, d: float(_strip_value(dup.get(k, str(d))))
    mode = dup.get("whichCorrespondenceRemains", "random").strip()
    mode_map = {"random": "random", "bestFGINN": "fginn",
                "bestDistance": "distance", "biggerRegion": "bigger_region"}
    fginn_map = []
    dist_map = []
    for k, v in sec.items():
        if k.startswith("matchRatio"):
            fginn_map.append((k[len("matchRatio"):],
                              float(_strip_value(v))))
        elif k.startswith("matchDistance"):
            dist_map.append((k[len("matchDistance"):],
                             float(_strip_value(v))))
    return MatchParams(
        contrad_dist=g("contradDist", 10.0),
        duplicate_dist=gd("duplicateDist", 3.0),
        duplicate_mode=mode_map.get(mode, "random"),
        knn=int(g("kNN", 50)),
        fginn_per_desc=tuple(sorted(fginn_map)),
        dist_per_desc=tuple(sorted(dist_map)),
        standard_2nd_closest=bool(int(g("doStandard_2nd_closestToo", 0))),
        use_db_for_fginn=bool(int(g("useDBforFGINN", 0))),
        sift_db_file=sec.get("SIFTDBfile", "").strip(),
    )
