"""Descriptor registry: name -> parameters and behaviour (mirrors
``mods_tpu/descriptors/registry.py``; the reference's descriptor
dispatch, imagerepresentation.cpp:1274-1985).

Kinds: ``sift`` (the SIFT family shares patch extraction and histograms
and differs in folding and normalization), ``pixels`` (the normalized
raw patch, descriptors/pixelsdesc.hpp), ``binary`` (ORB's rBRIEF,
``detectors/orb.py``), ``patch`` (the patch functors of
``descriptors/patch_descs.py``), ``cnn`` (``descriptors/cnn.py``) and
``external`` (the rows that the External detector's descriptor command
writes on the host, ``pipeline.py::ExternalCmdParams``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from mods_tpu_torch.config import SIFTDescriptorParams


@dataclass(frozen=True)
class DescriptorSpec:
    name: str
    # "sift" | "pixels" | "binary" | "patch" | "cnn" | "external"
    kind: str
    sift: SIFTDescriptorParams | None = None
    half_sift_like: bool = False   # uses half-SIFT orientation folding
    dim: int = 128
    dsp_levels: int = 0        # >0 = domain-size pooling (DSP-SIFT)
    # keyword arguments of the patch functors and the CNN as a hashable
    # (key, value) tuple, from the engine config's per-descriptor INI
    # sections (``spec_for``)
    params: tuple = ()


def sift_spec(name: str, **kw) -> DescriptorSpec:
    p = SIFTDescriptorParams(**kw)
    return DescriptorSpec(name=name, kind="sift", sift=p,
                          half_sift_like=p.half_sift, dim=p.dim)


REGISTRY: dict[str, DescriptorSpec] = {
    "SIFT": sift_spec("SIFT"),
    "RootSIFT": sift_spec("RootSIFT", root_sift=True),
    "HalfSIFT": sift_spec("HalfSIFT", half_sift=True),
    "HalfRootSIFT": sift_spec("HalfRootSIFT", root_sift=True,
                              half_sift=True),
    "MagnLessSIFT": sift_spec("MagnLessSIFT", magn_less=True),
    "DSPSIFT": DescriptorSpec(
        name="DSPSIFT", kind="sift",
        sift=SIFTDescriptorParams(root_sift=True), dim=128, dsp_levels=3),
    "Pixels": DescriptorSpec(
        name="Pixels", kind="pixels",
        sift=SIFTDescriptorParams(), dim=41 * 41),
    "ORB": DescriptorSpec(name="ORB", kind="binary", dim=256),
    # patch functors; dims from patch_descs.PATCH_DIMS
    "SURF": DescriptorSpec(name="SURF", kind="patch", dim=64),
    "LIOP": DescriptorSpec(name="LIOP", kind="patch", dim=144),
    "DAISY": DescriptorSpec(name="DAISY", kind="patch", dim=200),
    "SSIM": DescriptorSpec(name="SSIM", kind="patch", dim=40),
    "KAZE": DescriptorSpec(name="KAZE", kind="patch", dim=64),
    "MLDB": DescriptorSpec(name="MLDB", kind="patch", dim=486),
    "FREAK": DescriptorSpec(name="FREAK", kind="patch", dim=512),
    "BRISK": DescriptorSpec(name="BRISK", kind="patch", dim=512),
    "MROGH": DescriptorSpec(name="MROGH", kind="patch", dim=144),
    # the Caffe CNN slot (imagerepresentation.cpp:1343-1534)
    "CNN": DescriptorSpec(name="CNN", kind="cnn", dim=128),
    # the external-binary descriptor plugin (the BICE pattern,
    # bicedescriptor.hpp, imagerepresentation.cpp:1610)
    "External": DescriptorSpec(name="External", kind="external", dim=128),
}


def get_spec(name) -> DescriptorSpec:
    if isinstance(name, DescriptorSpec):
        return name
    if name not in REGISTRY:
        raise KeyError(f"unknown descriptor {name!r}; known: "
                       f"{sorted(REGISTRY)}")
    return REGISTRY[name]


def spec_for(name: str, cfg=None) -> DescriptorSpec:
    """Engine-config-aware spec: the per-descriptor INI sections
    (GetDAISYPars/GetLIOPPars/GetSSIMPars/GetMROGHPars/GetFREAKPars/
    GetBRISKPars/GetPixelPars, io_mods.cpp:104-652) applied to the
    descriptor's keyword arguments and output dimension."""
    base = get_spec(name)
    if cfg is None:
        return base
    rep = dataclasses.replace
    if name == "DAISY":
        d = cfg.daisy
        return rep(base, dim=d.dim,
                   params=(("n_rings", d.radq), ("n_segs", d.thq),
                           ("n_ori", d.histq)))
    if name == "LIOP":
        p = cfg.liop
        return rep(base, dim=p.dim,
                   params=(("radius", p.radius), ("n_neigh", p.neighbours),
                           ("n_bins", p.bins)))
    if name == "SSIM":
        s = cfg.ssim
        return rep(base, dim=s.dim,
                   params=(("inner", s.window_size), ("n_rad", s.nrad),
                           ("n_ang", s.nang)))
    if name == "MROGH":
        m = cfg.mrogh
        supports = tuple(max(41 - 10 * i, 11)
                         for i in range(m.n_multi_region))
        return rep(base, dim=m.dim,
                   params=(("n_groups", m.n_order), ("n_ori", m.n_dir),
                           ("supports", supports)))
    if name == "FREAK":
        return rep(base, params=(("pattern_scale",
                                  cfg.freak.pattern_scale),))
    if name == "BRISK":
        return rep(base, params=(("pattern_scale",
                                  cfg.brisk.pattern_scale),))
    if name == "Pixels":
        return rep(base, params=(("norm_type", cfg.pixels.norm_type),))
    if name == "CNN":
        c = cfg.cnn
        return rep(base, dim=c.dim,
                   params=(("weights_file", c.weights_file),
                           ("patch_size", c.patch_size),
                           ("mr_size", c.mr_size),
                           ("normalization", c.normalization)))
    if name == "External":
        return rep(base, dim=cfg.external.desc_dim)
    return base
