"""Descriptor registry: name -> parameters and behaviour (mirrors
``mods_tpu/descriptors/registry.py``; the reference's descriptor
dispatch, imagerepresentation.cpp:1274-1985).

Ported kinds: ``sift`` (the SIFT family shares patch extraction and
histograms and differs in folding and normalization) and ``binary``
(ORB's rBRIEF, ``detectors/orb.py``).  The other names of the JAX
registry are known here, so a ladder that lists one fails with the
ROADMAP.md item that ports it instead of producing nothing.
"""

from __future__ import annotations

from dataclasses import dataclass

from mods_tpu_torch.config import SIFTDescriptorParams


@dataclass(frozen=True)
class DescriptorSpec:
    name: str
    kind: str                  # "sift" | "binary"
    sift: SIFTDescriptorParams | None = None
    half_sift_like: bool = False   # uses half-SIFT orientation folding
    dim: int = 128
    dsp_levels: int = 0        # >0 = domain-size pooling (DSP-SIFT)
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
    "ORB": DescriptorSpec(name="ORB", kind="binary", dim=256),
}

# descriptor names of the JAX registry that wait for a later slice, with
# the ROADMAP.md item that ports each
NOT_PORTED = {
    **{n: ("patch", 20) for n in ("SURF", "LIOP", "DAISY", "SSIM", "KAZE",
                                  "MLDB", "FREAK", "BRISK", "MROGH")},
    "Pixels": ("pixels", 20), "CNN": ("cnn", 20),
    "External": ("external", 21),
}


def get_spec(name) -> DescriptorSpec:
    if isinstance(name, DescriptorSpec):
        return name
    if name in NOT_PORTED:
        kind, item = NOT_PORTED[name]
        raise NotImplementedError(
            f"descriptor {name!r} (kind {kind!r}) is not ported yet: "
            f"ROADMAP.md item {item}")
    if name not in REGISTRY:
        raise KeyError(f"unknown descriptor {name!r}; known: "
                       f"{sorted(REGISTRY) + sorted(NOT_PORTED)}")
    return REGISTRY[name]


def spec_for(name: str, cfg=None) -> DescriptorSpec:
    """Engine-config-aware spec.  The ``sift`` and ``binary`` kinds take
    nothing from the engine config (the per-descriptor INI sections
    belong to the kinds that are not ported yet)."""
    return get_spec(name)
