"""The two-view matching engine: the escalation ladder (mirrors
``mods_tpu/pipeline.py``).

Reference call stack (mods.cpp:229-415): per iteration,
SynthDetectDescribeKeypoints on both images
(imagerepresentation.cpp:603), MatchImgReps
(correspondencebank.cpp:237), DuplicateFiltering, geometric
verification; stop when verified matches >= minMatches.

Per (tilt, zoom) view group three stages run one after the other, all
batched over the group's rotations: render (shear rotation, anti-alias
blur, squash), detect (HessianAffine, DoG, HarrisAffine, ORB, SURF,
KAZE, TILDE, FAST, STAR, BRISK and device-backend MSER on the device;
host-backend MSER on the host, over views that ``native/render.cpp``
renders there) and describe (orientation families + shared patch
extraction + the SIFT-variant normalizations, rBRIEF, the patch
functors, Pixels or the CNN).  Matching and verification run over
fixed-capacity per-descriptor feature stores on the device, with
tentative lists
concatenated across descriptors like the reference's
CorrespondenceBank.

Every patch the ladder samples goes through
``ops/sampler.py::sample_affine_patches`` and every Baumberg call through
``detectors/baumberg.py::baumberg_adapt``: on the card these launch the
hand-written kernels ``csrc/window_sampler.cu`` and
``csrc/baumberg_smm.cu``.

Ported here: every device detector of the JAX package, the host-stage
detectors (MSER, prefetched for the whole ladder by a pool of two threads
that run native code and never touch the card; ReadAffs, keypoints read
from a file; External, keypoints from a command run on each rendered
view), every descriptor kind (``external``: rows a command writes for
the External detector's keypoints), FGINN with a descriptor database,
the verification modes LORANSACH, LORANSACF (DEGENSAC), ORSA and
GR_TRUTH (with its dual mode), the ``sync``, ``async`` and
``pipelined`` stop modes and CLAHE.  The monolith ladder program is not
ported yet and raises ``NotImplementedError`` naming its ROADMAP.md
item.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from mods_tpu_torch import synthesis
from mods_tpu_torch.config import (AffineShapeParams, BriskDetParams,
                                   CapacityParams, CnnParams, DaisyParams,
                                   DetectionMode, DominantOrientationParams,
                                   FastParams, FreakParams, IterationParams,
                                   LiopParams, MatchParams, MroghParams,
                                   OrbParams, OrsaParams, PixelsParams,
                                   PyramidParams, RansacParams, Rung,
                                   SIFTDescriptorParams, SsimParams,
                                   StarParams, SurfDetParams, as_rungs,
                                   replace)
from mods_tpu_torch.descriptors.cnn import net_for
from mods_tpu_torch.descriptors.describe import (DESC_MIP_LEVELS,
                                                 aa_filter_patches,
                                                 image_to_patch_scale)
from mods_tpu_torch.descriptors.orientation import (find_peaks,
                                                    orientation_histograms,
                                                    rotate_shapes,
                                                    smooth_circular)
from mods_tpu_torch.descriptors.patch_descs import (PATCH_FNS,
                                                    pixels_descriptor)
from mods_tpu_torch.descriptors.registry import get_spec, spec_for
from mods_tpu_torch.descriptors.sift import sift_histograms, sift_norm
from mods_tpu_torch.detectors.hessaff import detect_affine_keypoints
from mods_tpu_torch.detectors.mser import detect_msers_padded
from mods_tpu_torch.device import resolve_device
from mods_tpu_torch.io.oxford import read_kps, read_oxford
from mods_tpu_torch.io.png import write_png
from mods_tpu_torch.matching.fginn import (duplicate_filter, match_distance,
                                           match_fginn)
from mods_tpu_torch.ops.clahe import clahe_np
from mods_tpu_torch.ops.gaussian import gaussian_blur_rt
from mods_tpu_torch.ops.host_render import render_group_np
from mods_tpu_torch.ops.image import to_gray_np
from mods_tpu_torch.ops.sampler import (mip_stack, sample_affine_patches,
                                        select_level)
from mods_tpu_torch.ops.select import nonzero_static, take_rows
from mods_tpu_torch.ops.warp import (separable_scale, shear_rotate,
                                     touches_border)
from mods_tpu_torch.ransac.fundamental import ransac_f
from mods_tpu_torch.ransac.homography import ransac_h
from mods_tpu_torch.ransac.laf_check import K_SIGMA, f_laf_check, h_laf_check
from mods_tpu_torch.ransac.orsa import orsa_f
from mods_tpu_torch.timing import TimeLog
from mods_tpu_torch.verify import gt_h_inliers

MIN_POINTS = 8  # matching.hpp MIN_POINTS

# Border-rejection band cap as a fraction of the original image extent:
# the reprojection filter (ReprojectRegions, synth-detection.cpp:567-580)
# equals the reference's whenever region supports are below this fraction
# of the image, and degrades gracefully on tiny images.
BORDER_CLAMP_FRAC = 0.2

# detectors that run fully on the device; the rest (host-backend MSER,
# ReadAffs, External) need a host stage
DEVICE_DETECTORS = ("HessianAffine", "DoG", "HarrisAffine", "ORB", "SURF",
                    "KAZE", "TILDE", "FAST", "STAR", "BRISK")


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md item {item}")


def _empty_regions(V: int, cap: int) -> dict:
    """Padded host-stage region slabs of V views, ``cap`` rows each."""
    return dict(xy=np.zeros((V, cap, 2), np.float32),
                A=np.tile(np.eye(2, dtype=np.float32), (V, cap, 1, 1)),
                s=np.zeros((V, cap), np.float32),
                response=np.zeros((V, cap), np.float32),
                mask=np.zeros((V, cap), bool))


def _put_regions(out: dict, v: int, xy, A, s) -> int:
    """The first rows of a keypoint file into view ``v`` of ``out``, up
    to its cap, each with response 1; returns how many."""
    n = min(len(xy), out["xy"].shape[1])
    out["xy"][v, :n] = xy[:n]
    out["A"][v, :n] = A[:n]
    out["s"][v, :n] = s[:n]
    out["response"][v, :n] = 1.0
    out["mask"][v, :n] = True
    return n


class _HostLog:
    """The ``TimeLog`` of a prefetch job: it attributes nothing (the
    main thread logs the residual wait) and touches no torch state."""

    def phase(self, name: str):
        return contextlib.nullcontext()


@dataclass(frozen=True)
class MserParams:
    """reference [MSER] config section (io_mods.cpp).  ``backend``:
    "host" (the default) is the native component tree over host-rendered
    views; "device" is the JAX package's opt-in level sweep
    (``detectors/mser_tpu.py``), which quantizes grey levels and is not
    at parity with the host backend."""
    min_size: int = 30
    max_area: float = 0.05
    min_margin: int = 8
    backend: str = "host"
    levels: int = 32
    passes: int = 3
    # padded host-slab rows per view: MSER yields <= ~300 regions a view
    # on benchmark images
    host_cap: int = 512


@dataclass(frozen=True)
class ExternalCmdParams:
    """Generic external-process detector/descriptor ([ExternalDetector];
    the reference's external-binary branches,
    imagerepresentation.cpp:747-1026, and the BICE descriptor,
    descriptors/bicedescriptor.hpp, dispatched at
    imagerepresentation.cpp:1610).  ``command`` is a shell template with
    {img} and {out}, run on each rendered view (a PNG in, a keypoint file
    out, parsed as Oxford ellipses or ``kp`` x/y/scale rows); the regions
    are described on the device like any host-stage detector's.

    ``desc_command`` is the descriptor counterpart, listed as descriptor
    "External" in a rung of detector "External": a template with {img},
    {pts} (``x y s`` rows of the view's keypoints) and {out}, which must
    write one row ``x y v0 .. v{desc_dim-1}`` a point, in order."""
    command: str = ""
    format: str = "oxford"       # "oxford" | "kp"
    cap: int = 512               # padded keypoint rows per view
    desc_command: str = ""
    desc_dim: int = 128


def _f(factory, **kw):
    return field(default_factory=lambda: factory(**kw))


@dataclass(frozen=True)
class EngineConfig:
    """``mods_tpu/pipeline.py::EngineConfig``, field for field."""
    pyramid: PyramidParams = _f(PyramidParams)           # HessianAffine
    pyramid_dog: PyramidParams = _f(PyramidParams, detector_type="DoG",
                                    threshold=8.0)
    pyramid_harris: PyramidParams = _f(PyramidParams,
                                       detector_type="Harris",
                                       threshold=15.0)
    mser: MserParams = _f(MserParams)
    affine: AffineShapeParams = _f(AffineShapeParams)
    dom_ori: DominantOrientationParams = _f(DominantOrientationParams,
                                            max_angles=1)
    sift: SIFTDescriptorParams = _f(SIFTDescriptorParams, root_sift=True)
    match: MatchParams = _f(MatchParams)
    ransac: RansacParams = _f(RansacParams)
    orsa: OrsaParams = _f(OrsaParams)
    caps: CapacityParams = _f(CapacityParams)
    min_matches: int = 10
    max_steps: int = 7
    surf_threshold: float = 0.0004   # OpenSURF `thresh` default
    kaze_threshold: float = 0.001    # AKAZE `dthreshold` default
    tilde_filters: str = ""          # path to a TILDE filter file
    # per-detector/per-descriptor INI sections (io_mods.cpp:104-652)
    orb: OrbParams = _f(OrbParams)
    fast: FastParams = _f(FastParams)
    star: StarParams = _f(StarParams)
    surf_det: SurfDetParams = _f(SurfDetParams)
    brisk: BriskDetParams = _f(BriskDetParams)
    freak: FreakParams = _f(FreakParams)
    daisy: DaisyParams = _f(DaisyParams)
    liop: LiopParams = _f(LiopParams)
    ssim: SsimParams = _f(SsimParams)
    mrogh: MroghParams = _f(MroghParams)
    pixels: PixelsParams = _f(PixelsParams)
    cnn: CnnParams = _f(CnnParams)
    external: ExternalCmdParams = _f(ExternalCmdParams)
    # GR_TRUTH | LORANSACH | LORANSACF | ORSA (mods.cpp:310-371); empty
    # defers to ransac.use_f
    ver_type: str = ""
    # photometric normalization before matching (mods.cpp:139-189)
    do_clahe: bool = False
    # GR_TRUTH dual mode: additionally run RANSAC and GT-check its output
    # (doBothRANSACgroundTruth, mods.cpp:320-334)
    do_both_ransac_gt: bool = False
    # tentative-bank drops at given steps: mods.cpp:288-289 hardcodes
    # ClearCorrespondences("ORB","ORB") at step 2 of the CVIU ladder
    clear_tentatives: tuple = ((2, "ORB", "ORB"),)

    def pyramid_for(self, detector: str) -> PyramidParams:
        return {"HessianAffine": self.pyramid,
                "DoG": self.pyramid_dog,
                "HarrisAffine": self.pyramid_harris}[detector]


def autosize_caps(cfg: EngineConfig) -> EngineConfig:
    """The capacities from the INI's region-number modes
    (scale-space-detector.hpp:127-198): a ladder that runs
    FixedRegNumber or NotLessThanRegions with N regions a view needs
    per-view, per-group and per-image slabs sized to N, at the JAX
    package's ratios (per_group ~1.05 N, per_image ~2.75 N)."""
    def want(p: PyramidParams) -> int:
        if p.detector_mode in (DetectionMode.FIXED_REG_NUMBER,
                               DetectionMode.NOT_LESS_THAN_REGIONS):
            return max(p.reg_number, 0)
        return 0

    n = max(want(cfg.pyramid), want(cfg.pyramid_dog),
            want(cfg.pyramid_harris))
    if n <= 0 or n <= cfg.caps.per_group:
        return cfg

    def rnd(x, m):
        return -(-int(x) // m) * m

    caps = replace(
        cfg.caps,
        per_view=max(cfg.caps.per_view, rnd(n, 256)),
        per_group=max(cfg.caps.per_group, rnd(1.05 * n, 256)),
        per_image=max(cfg.caps.per_image, rnd(2.75 * n, 1024)))
    return replace(cfg, caps=caps)


class DeviceStore:
    """Device-resident fixed-capacity feature store of one image for one
    (detector, descriptor): the reference's ImageRepresentation slot
    (imagerepresentation.h:66).  ``append`` scatters a group's compacted
    rows in place at the running count; rows past the capacity go to a
    spare row that no consumer reads.  Nothing crosses to the host until
    a consumer asks (``.xy``/``.count`` properties).  ``lead`` = (P,)
    gives every buffer a leading pair axis and each pair its own count
    (``parallel/multi.py::BatchedDeviceStore``)."""

    def __init__(self, cap: int, dim: int, device="cpu", lead: tuple = ()):
        self.cap = cap
        self.dim = dim
        z = dict(dtype=torch.float32, device=device)
        self._xy = torch.zeros(lead + (cap + 1, 2), **z)
        self._A = torch.zeros(lead + (cap + 1, 2, 2), **z)
        self._s = torch.zeros(lead + (cap + 1,), **z)
        self._r = torch.zeros(lead + (cap + 1,), **z)
        self._d = torch.zeros(lead + (cap + 1, dim), **z)
        self._n = torch.zeros(lead, dtype=torch.int64, device=device)

    def reset(self) -> None:
        """New pair: rewind the count.  Rows past the count are never
        read (every consumer masks by the count prefix)."""
        self._n.zero_()

    def append(self, xy, A, s, r, d, n) -> None:
        """Write the first ``n`` (a 0-dim tensor; (P,) with a pair axis)
        of the C given rows ((C, ...); (P, C, ...)) at offset count,
        dropping what does not fit."""
        C = xy.shape[-2]
        row = torch.arange(C, device=xy.device)
        pos = self._n[..., None] + row
        pos = torch.where((row < n[..., None]) & (pos < self.cap), pos,
                          self.cap)
        if pos.dim() == 2:
            pos = (torch.arange(pos.shape[0], device=pos.device)[:, None],
                   pos)
        self._xy[pos] = xy
        self._A[pos] = A
        self._s[pos] = s
        self._r[pos] = r
        self._d[pos] = d
        self._n = torch.clamp(self._n + n, max=self.cap)

    def device_arrays(self):
        """(xy, A, s, desc, count), all on the device."""
        c = self.cap
        return (self._xy[..., :c, :], self._A[..., :c, :, :],
                self._s[..., :c], self._d[..., :c, :], self._n)

    # host views (tests and export paths only: these synchronize)
    @property
    def count(self) -> int:
        return int(self._n)

    @property
    def xy(self):
        return self._xy[: self.count].cpu().numpy()

    @property
    def A(self):
        return self._A[: self.count].cpu().numpy()

    @property
    def s(self):
        return self._s[: self.count].cpu().numpy()

    @property
    def response(self):
        return self._r[: self.count].cpu().numpy()

    @property
    def desc(self):
        return self._d[: self.count].cpu().numpy()


class BatchedDeviceStore(DeviceStore):
    """``DeviceStore`` with a leading pair axis: (P, cap, ...) rows and
    (P,) counts, each pair's compacted rows appended at its own count
    (``mods_tpu/parallel/multi.py::BatchedDeviceStore``)."""

    def __init__(self, P: int, cap: int, dim: int, device="cpu"):
        super().__init__(cap, dim, device, lead=(P,))
        self.P = P


def stores_from_numpy(xy, A, s, response, desc, cap: int,
                      device="cpu") -> DeviceStore:
    """A ``DeviceStore`` holding the given (N, ...) host rows: carries a
    JAX-side store across, so matching and verification can be checked on
    identical input."""
    n = min(len(xy), cap)
    st = DeviceStore(cap, np.asarray(desc).shape[-1], device)
    for buf, a in ((st._xy, xy), (st._A, A), (st._s, s), (st._r, response),
                   (st._d, desc)):
        buf[:n] = torch.as_tensor(np.asarray(a)[:n], dtype=torch.float32,
                                  device=device)
    st._n = torch.tensor(n, dtype=torch.int64, device=device)
    return st


# --------------------------------------------------------------------------
# per-group stages

def _make_render_fn(V: int, h0: int, w0: int, hr: int, wr: int, hc: int,
                    wc: int, do_blur: bool, identity: bool):
    """Batched view-group renderer: ``render(img, rot_inv, squash_inv,
    sig_x, sig_y, valid_hw)`` -> (V, hc, wc) views.  The per-group
    geometry (rotation maps, anti-alias sigmas, squash scales) arrives as
    device tensors that ``_prep_groups`` caches.  A (P, h0, w0) stack of
    images renders P groups at once: (P*V, hc, wc) views, pair-major, from
    (P*V, ...) rotation maps and extents."""

    def clamp_pad(views, valid_hw):
        # replicate the last valid row/col into the bucketed-canvas pad:
        # a constant-fill pad would manufacture a strong artificial edge
        # at the valid boundary and spawn junk detections there
        dev = views.device
        vh = valid_hw[:, 0].clamp(min=1).to(torch.int64)
        vw = valid_hw[:, 1].clamp(min=1).to(torch.int64)
        rows = torch.minimum(torch.arange(hc, device=dev)[None],
                             vh[:, None] - 1)
        cols = torch.minimum(torch.arange(wc, device=dev)[None],
                             vw[:, None] - 1)
        v = torch.arange(views.shape[0], device=dev)[:, None, None]
        return views[v, rows[:, :, None], cols[:, None, :]]

    def render(img, rot_inv, squash_inv, sig_x, sig_y, valid_hw):
        imgs = img.reshape((-1, h0, w0))
        P = imgs.shape[0]
        if identity:
            views = torch.full((P, V, hc, wc), 128.0, dtype=img.dtype,
                               device=img.device)
            views[:, :, :h0, :w0] = imgs[:, None]
            views = views.reshape(P * V, hc, wc)
        else:
            # rotation as 3 shears, the tilt squash as a separable
            # axis-aligned resample (ops/warp.py); one view at a time
            # bounds the gather indices to a single canvas
            rots = torch.stack([shear_rotate(imgs[v // V], rot_inv[v], hr,
                                             wr) for v in range(P * V)])
            if do_blur:
                rots = gaussian_blur_rt(rots, sig_x, sig_y)
            views = separable_scale(rots, squash_inv[0, 0],
                                    squash_inv[1, 1], hc, wc)
        return clamp_pad(views, valid_hw)

    return render


def _take_fill(a: torch.Tensor, idx: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """``jnp.take(a, idx, axis=0, mode="fill", fill_value=0)`` for the
    (idx, valid) of ``nonzero_static``: the padding slots read 0, and no
    out-of-range index reaches the device.  (P, C) indices take the rows
    of each pair of a (P, N, ...) ``a``."""
    out = take_rows(a, idx, idx.dim() - 1)
    return torch.where(valid.reshape(valid.shape + (1,) * (out.ndim
                                                          - valid.ndim)),
                       out, torch.zeros_like(out))


def _make_desc_fn(V: int, hc: int, wc: int, h0: int, w0: int, K: int,
                  specs: tuple, dom_ori: DominantOrientationParams,
                  pe_mr: float, pe_patch: int, pe_photo: bool,
                  caps: CapacityParams, pairs: int | None = None):
    """views + Regions(V, K) + hinv -> per-descriptor compacted regions,
    appended to the descriptors' ``DeviceStore``.

    ``pairs`` = P folds P images' groups into the view axis: views,
    extents, regions and hinv come as (P*V, ...), pair-major, each pair
    is compacted to its own C1 and C2 rows, and pair p's rows go to row p
    of ``BatchedDeviceStore``s.  Every patch set of all P pairs is still
    one kernel launch, from one (P*V*L, Hp, Wp) mip stack.

    Detections are compacted across the whole view group to
    C1 = caps.per_group rows (with a per-row source-view index) before any
    patch work, so orientation and description each sample C rows in one
    kernel launch instead of V*K padded rows.  Orientation families
    (SIFT-like vs HalfSIFT-like, imagerepresentation.cpp:1253-1269) share
    one gradient histogram and differ only in peak folding; SIFT variants
    share patches and histograms and differ only in folding and
    normalization (siftdesc.cpp operator()); the patch functors and
    Pixels read the same patches, and each CNN spec samples its own
    (CaffeDescParam.patchSize, P = 32 by default).  An ``external`` spec
    takes the rows of ``ext_desc``, the (P*V, K, dim) host slab that the
    External detector's command wrote, through the same compaction as the
    region geometry, unchanged."""
    specs = tuple(get_spec(s) for s in specs)
    M = caps.max_angles
    P = pairs or 1
    C1 = min(caps.per_group, V * K)          # detection-stage rows
    C2 = min(caps.per_group, C1 * M)         # descriptor-stage rows
    L = DESC_MIP_LEVELS

    def fam_key(sp):
        if sp.kind in ("binary", "external"):
            # detected frames used directly, no dominant orientation
            return "none"
        return "half" if sp.half_sift_like else "sift"

    families = sorted({fam_key(sp) for sp in specs})

    def program(views, valid_hw, regs_xy, regs_A, regs_s, regs_resp,
                regs_mask, hinv, stores, ext_desc=None):
        dev = views.device
        mips_v, mip_hw = mip_stack(views, L)          # (P*V, L, Hp, Wp)
        Hp, Wp = mips_v.shape[-2:]
        src = mips_v.reshape(P * V * L, Hp, Wp)
        hw_flat = mip_hw.repeat(P * V, 1)             # (P*V*L, 2)
        first = torch.arange(P, device=dev)[:, None]  # a pair's first row

        # stage 1: compact each pair's detections across its views
        # (bucket-padded views carry valid_hw == 0 and are dropped here);
        # the pairs' rows then run flat, (P*C1, ...)
        view_ok = valid_hw[:, 0] > 0
        flat0 = (regs_mask.reshape(P * V, K)
                 & view_ok[:, None]).reshape(P, V * K)
        idx1, ok1 = nonzero_static(flat0, C1)
        vidx = (idx1 // K + first * V).reshape(-1)    # view in P*V
        ok1 = ok1.reshape(-1)

        def take1(a):
            return _take_fill(a.reshape((P, V * K) + a.shape[2:]), idx1,
                              ok1.reshape(P, C1)).reshape(
                                  (P * C1,) + a.shape[2:])

        xy1 = take1(regs_xy)
        A1 = take1(regs_A)
        s1 = take1(regs_s)
        r1 = take1(regs_resp)
        hv = hinv[vidx]                               # (P*C1, 2, 3)
        lin = hv[:, :, :2]
        xy_r1 = torch.einsum("cab,cb->ca", lin, xy1) + hv[:, :, 2]
        inside1 = ((xy_r1[:, 0] > 0) & (xy_r1[:, 0] < w0)
                   & (xy_r1[:, 1] > 0) & (xy_r1[:, 1] < h0))

        # shared orientation histogram (families differ only in folding)
        o_pe = dom_ori.patch_extraction
        P_o = o_pe.patch_size
        if any(f != "none" for f in families):
            patch_image_size = 2 * int(o_pe.mr_size) + 1
            img_to_patch = patch_image_size / P_o
            # The reference also drops regions whose orientation support
            # leaves the view (synth-detection.cpp:877-886).  Canvases
            # are replicate-padded and the sampler clamps its reads, so
            # the reprojection filter against the original image below
            # (ReprojectRegions, synth-detection.cpp:567-580) is the gate.
            As_o = A1 * (img_to_patch * s1)[:, None, None]
            lvl_o, sc_o = select_level(As_o, P_o, L)
            patches_o = sample_affine_patches(
                src, vidx * L + lvl_o, xy1 / sc_o[:, None],
                As_o / sc_o[:, None, None], P_o, hw_flat)
            hist_o = smooth_circular(orientation_histograms(patches_o))

        half = torch.ceil(K_SIGMA * s1 / 2.0)

        def stage2(fam, extra=None):
            """-> compacted descriptor-stage rows for one family, and the
            rows of ``extra`` (P*C1, ...) through the same compaction."""
            if fam == "none":
                # detected regions used directly
                # (imagerepresentation.cpp:1299-1302), compacted to the
                # front so the store's count prefix holds
                A_r = torch.einsum("cab,cbd->cad", lin, A1)
                tb = touches_border(float(w0), float(h0), xy_r1, A_r, half,
                                    half, clamp_frac=BORDER_CLAMP_FRAC)
                idx2, ok2 = nonzero_static(
                    (ok1 & inside1 & ~tb).reshape(P, C1), C1)

                def takeN(a):
                    return _take_fill(a.reshape((P, C1) + a.shape[1:]),
                                      idx2, ok2).reshape(a.shape)
                return (takeN(xy1), takeN(A1), takeN(s1), takeN(r1),
                        takeN(vidx), takeN(xy_r1), takeN(A_r),
                        ok2.sum(-1), None if extra is None
                        else extra[(idx2 + first * C1).reshape(-1)])
            angles, pmask = find_peaks(
                hist_o, M, dom_ori.threshold,
                half_sift=(fam == "half" or dom_ori.half_sift_mode))
            amask = pmask & ok1[:, None]
            if dom_ori.max_angles >= 0:
                amask = amask & (torch.arange(M, device=dev)
                                 < dom_ori.max_angles)[None]
            if dom_ori.add_up_right:
                # keep one un-rotated copy of every region in the last
                # angle slot (addUpRight, synth-detection.cpp:913-915)
                angles = angles.clone()
                amask = amask.clone()
                angles[:, M - 1] = 0.0
                amask[:, M - 1] = ok1
            Arot = rotate_shapes(A1, angles)          # (P*C1, M, 2, 2)
            A_rf = torch.einsum("cab,cmbd->cmad", lin, Arot)
            tb = touches_border(
                float(w0), float(h0), xy_r1[:, None].expand(-1, M, 2), A_rf,
                half[:, None], half[:, None], clamp_frac=BORDER_CLAMP_FRAC)
            m_f = amask & inside1[:, None] & ~tb      # (P*C1, M)
            idx2, ok2 = nonzero_static(m_f.reshape(P, C1 * M), C2)
            row = (idx2 // M + first * C1).reshape(-1)

            def takeA(a):   # (P*C1, M, ...) -> (P*C2, ...)
                return _take_fill(a.reshape((P, C1 * M) + a.shape[2:]), idx2,
                                  ok2).reshape((P * C2,) + a.shape[2:])

            return (xy1[row], takeA(Arot), s1[row], r1[row], vidx[row],
                    xy_r1[row], takeA(A_rf), ok2.sum(-1),
                    None if extra is None else extra[row])

        out = {}
        base = SIFTDescriptorParams()  # raw histogram params
        for fam in families:
            fam_specs = [sp for sp in specs if fam_key(sp) == fam]
            ext = None
            if any(sp.kind == "external" for sp in fam_specs):
                if ext_desc is None:
                    raise ValueError(
                        "descriptor 'External' needs detector 'External' "
                        "with [ExternalDetector] descCommand set")
                # host rows (BICE semantics: one descriptor a detected
                # region, no re-orientation) ride through the same
                # compaction chain as the region geometry
                ext = take1(ext_desc)
            xyv, Av, sv, rv, vi, xy_r, A_r, n2, ext = stage2(fam, ext)

            def sample(t, size):
                """(patches, mip level) of the family's rows at scale t."""
                As = Av * t[:, None, None]
                lvl, sc = select_level(As, size, L)
                return sample_affine_patches(
                    src, vi * L + lvl, xyv / sc[:, None],
                    As / sc[:, None, None], size, hw_flat), lvl

            def desc_patches(scale_coef=1.0):
                t = image_to_patch_scale(sv * scale_coef, pe_mr, pe_patch)
                raw, lvl = sample(t, pe_patch)
                return aa_filter_patches(raw, lvl, t, photo_norm=pe_photo)

            res = {}
            if ext is not None:
                for sp in fam_specs:
                    if sp.kind == "external":
                        res[sp.name] = ext
            if any(sp.kind == "binary" for sp in fam_specs):
                from mods_tpu_torch.detectors.orb import brief_from_patches
                bits = brief_from_patches(sample(sv * 5.1962 / 31.0, 31)[0])
                for sp in fam_specs:
                    if sp.kind == "binary":
                        res[sp.name] = bits
            for sp in fam_specs:
                if sp.kind != "cnn":
                    continue
                # the CNN slot's own patch geometry (CaffeDescParam.mrSize,
                # patchSize) and a batched conv forward
                pp = dict(sp.params) or dict(
                    weights_file="", patch_size=32, mr_size=12.0,
                    normalization="L2")
                Pc = int(pp["patch_size"])
                pc, _ = sample(image_to_patch_scale(sv, float(pp["mr_size"]),
                                                    Pc), Pc)
                res[sp.name] = net_for(pp["weights_file"], Pc, sp.dim,
                                       pp["normalization"], str(dev))(pc)
            kinds = {sp.kind for sp in fam_specs}
            if kinds & {"sift", "pixels", "patch"}:
                patches = desc_patches()
            for sp in fam_specs:
                if sp.kind == "patch":
                    res[sp.name] = PATCH_FNS[sp.name](patches,
                                                      **dict(sp.params))
                elif sp.kind == "pixels":
                    res[sp.name] = pixels_descriptor(patches,
                                                     **dict(sp.params))
            if "sift" in kinds:
                hist = sift_histograms(patches, base)
                for sp in fam_specs:
                    if sp.kind != "sift":
                        continue
                    h = hist
                    if sp.dsp_levels > 0:
                        # DSP-SIFT: pool histograms over region scales
                        # (imagerepresentation.cpp:1547-1598)
                        for c in np.linspace(0.5, 1.5, sp.dsp_levels):
                            if abs(c - 1.0) < 1e-6:
                                continue
                            h = h + sift_histograms(
                                desc_patches(float(c)), base)
                    p = sp.sift
                    if p.half_sift:
                        ob = p.orientation_bins
                        h = h[..., :ob // 2] + h[..., ob // 2:]
                    v = h.reshape(h.shape[0], -1)
                    if p.do_norm:
                        v = sift_norm(v, p.max_bin_value, p.root_sift)
                    res[sp.name] = v
            for sp in fam_specs:
                out[sp.name] = (xy_r, A_r, sv, rv, res[sp.name], n2)

        for st, sp in zip(stores, specs, strict=True):
            rows = out[sp.name]
            if pairs is None:                 # one image: unbatched store
                st.append(*rows[:-1], rows[-1][0])
            else:
                st.append(*(a.reshape((P, -1) + a.shape[1:])
                            for a in rows[:-1]), rows[-1])

    return program


def _make_detect_fn(det: str, cfg: EngineConfig):
    """Detection dispatch (the reference's 20-way if-else,
    imagerepresentation.cpp:717-1224) for the device detectors, branch
    for branch as ``mods_tpu/pipeline.py::_make_detect_fn``:
    ``detect(views, valid_hw, valid_hw_host, reg_number)`` -> Regions
    (V, K).  ``valid_hw_host`` is the same (V, 2) extents as a CPU
    tensor, which the scale-space detector reads without a device
    sync."""
    caps = cfg.caps
    if det in ("HessianAffine", "DoG", "HarrisAffine"):
        pyr = cfg.pyramid_for(det)
        aff = cfg.affine
        return lambda v, hw, hw_host, rn: detect_affine_keypoints(
            v, hw_host, pyr, aff, caps, rn)
    if det == "ORB":
        from mods_tpu_torch.detectors.orb import detect_orb
        o = cfg.orb
        return lambda v, hw, hw_host, rn: detect_orb(
            v, hw, caps, n_features=o.nfeatures,
            scale_factor=o.scale_factor, n_levels=o.nlevels,
            edge_threshold=o.edge_threshold,
            fast_threshold=o.fast_threshold)
    if det == "BRISK":
        # BRISK's AGAST pyramid as multi-scale FAST (cv::BRISK octaves)
        from mods_tpu_torch.detectors.orb import detect_orb
        b = cfg.brisk
        return lambda v, hw, hw_host, rn: detect_orb(
            v, hw, caps, n_levels=max(b.octaves, 1) * 2,
            scale_factor=1.4142135, fast_threshold=float(b.thresh))
    if det == "SURF":
        from mods_tpu_torch.detectors.surf import detect_surf
        thr = cfg.surf_threshold
        oc = cfg.surf_det.octaves
        return lambda v, hw, hw_host, rn: detect_surf(v, hw, caps, thr,
                                                      n_octaves=oc)
    if det == "KAZE":
        from mods_tpu_torch.detectors.kaze import detect_kaze
        thr = cfg.kaze_threshold
        return lambda v, hw, hw_host, rn: detect_kaze(v, hw, caps, thr)
    if det == "TILDE":
        from mods_tpu_torch.detectors.tilde import detect_tilde, tilde_bank
        return lambda v, hw, hw_host, rn: detect_tilde(
            v, hw, caps, tilde_bank(cfg.tilde_filters, str(v.device)))
    if det == "STAR":
        from mods_tpu_torch.detectors.corners import detect_star
        # OpenCV's responseThreshold (default 30) is on a ~7x-scaled
        # kernel sum; mean-difference units are ~responseThreshold/7.5
        thr = cfg.star.response_threshold / 7.5
        return lambda v, hw, hw_host, rn: detect_star(v, hw, caps, thr)
    if det == "FAST":
        from mods_tpu_torch.detectors.corners import detect_fast
        thr = cfg.fast.threshold
        return lambda v, hw, hw_host, rn: detect_fast(v, hw, caps, thr)
    if det == "MSER":
        # the device backend; the host backend has no device detect stage
        # (``_host_stage_regions``)
        from mods_tpu_torch.detectors.mser_tpu import detect_mser_tpu
        mp = cfg.mser
        return lambda v, hw, hw_host, rn: detect_mser_tpu(
            v, hw, caps, min_size=mp.min_size, max_area=mp.max_area,
            min_margin=mp.min_margin, levels=mp.levels, passes=mp.passes)
    raise KeyError(det)


def _pool_match_parts(parts1, parts2, ratio, dist_thr, db, cap, knn,
                      contrad, dup_mode, run_fginn, run_dist, binary,
                      standard_2nd):
    """One matching step over pooled store parts (grouped matching pools
    several detectors' stores, correspondencebank.cpp:248-288).  Emits
    fixed-shape tentative parts with the image-2 endpoints already
    gathered.  ``db``: the FGINN+DB database (desc, mask) on the device,
    or None.  Parts with a leading pair axis ((P, cap, ...) arrays, (P,)
    counts) match each pair on its own."""
    lead = parts1[0][0].dim() - 2

    def pool(parts):
        xy = torch.cat([p[0] for p in parts], lead)
        A = torch.cat([p[1] for p in parts], lead)
        s = torch.cat([p[2] for p in parts], lead)
        d = torch.cat([p[3] for p in parts], lead)
        m = torch.cat([torch.arange(cap, device=xy.device) < p[4][..., None]
                       for p in parts], -1)
        return xy, A, s, d, m

    xy1, A1, s1, d1, m1 = pool(parts1)
    xy2, A2, s2, d2, m2 = pool(parts2)

    def finish(t):
        if dup_mode == "fginn":
            prio = t.ratio
        elif dup_mode == "distance":
            prio = t.d1
        elif dup_mode == "bigger_region":
            prio = -s1
        else:
            prio = torch.arange(s1.shape[-1], dtype=torch.float32,
                                device=xy1.device).expand(s1.shape)
        return dict(xy1=xy1, A1=A1, s1=s1, xy2=take_rows(xy2, t.idx2, lead),
                    A2=take_rows(A2, t.idx2, lead),
                    s2=take_rows(s2, t.idx2, lead), prio=prio, mask=t.mask)

    outs = []
    if run_fginn:
        t = match_fginn(d1, m1, d2, m2, xy2, ratio, contrad, knn,
                        standard_2nd=standard_2nd, db=db)
        outs.append(finish(t))
    if run_dist:
        t = match_distance(d1, m1, d2, m2, dist_thr,
                           squared_threshold=binary)
        outs.append(finish(t))
    return outs


def _concat_compact_parts(parts, tcap: int):
    """Concatenate tentative parts and compact the masked rows to the
    tentative capacity (GetCorresponcesVector, mods.cpp:298); each pair
    of a leading pair axis on its own."""
    keys_ = ("xy1", "A1", "s1", "xy2", "A2", "s2", "prio")
    lead = parts[0]["mask"].dim() - 1
    mask_all = torch.cat([p["mask"] for p in parts], lead)
    idx, valid = nonzero_static(mask_all, tcap)
    comb = {k: _take_fill(torch.cat([p[k] for p in parts], lead), idx, valid)
            for k in keys_}
    comb["mask"] = valid
    return comb


def _verify_core(cfg: EngineConfig, w: int, h: int, xy1, A1, s1, xy2, A2,
                 s2, prio, mask, generator: torch.Generator):
    """duplicate filter -> RANSAC -> LAF check.  Verification dispatch
    mirrors mods.cpp:310-371: ORSA and LORANSACF fit F, anything else
    LO-RANSAC H (as in the JAX package).  LORANSACF also returns
    DEGENSAC's ``degen`` flag.

    A leading pair axis ((P, N, ...) rows, ``generator`` a sequence of P
    generators) verifies each pair on its own: LO-RANSAC H batched over
    the pairs, the F estimators pair by pair."""
    ver = cfg.ver_type or ("LORANSACF" if cfg.ransac.use_f else "LORANSACH")
    if xy1.dim() == 3 and ver in ("ORSA", "LORANSACF"):
        outs = [_verify_core(cfg, w, h, *(a[p] for a in (
            xy1, A1, s1, xy2, A2, s2, prio, mask)), generator[p])
            for p in range(xy1.shape[0])]
        return {k: torch.stack([torch.as_tensor(o[k], device=xy1.device)
                                for o in outs]) for k in outs[0]}
    keep = duplicate_filter(xy1, xy2, mask, cfg.match.duplicate_dist,
                            priority=prio)
    tmask = mask & keep
    n_tent = tmask.sum(-1)
    extra = {}
    if ver in ("ORSA", "LORANSACF"):
        if ver == "ORSA":
            M, inl, _, extra["log_nfa"] = orsa_f(
                xy1, xy2, tmask, max(w, 1), max(h, 1), cfg.orsa, generator)
        else:
            M, inl, _, extra["degen"] = ransac_f(xy1, xy2, tmask,
                                                 cfg.ransac, generator)
        lafm = f_laf_check(
            M, xy1, A1, s1, xy2, A2, s2, inl,
            cfg.ransac.laf_coef * cfg.ransac.err_threshold,
            sampson=cfg.ransac.error_type == "sampson")
    else:
        M, inl, _ = ransac_h(xy1, xy2, tmask, cfg.ransac, generator)
        lafm = h_laf_check(
            M, xy1, A1, s1, xy2, A2, s2, inl,
            3.0 * cfg.ransac.h_laf_coef * cfg.ransac.err_threshold)
    enough = (n_tent >= MIN_POINTS) & (lafm.sum(-1) >= MIN_POINTS)
    final = lafm & enough[..., None]
    return dict(model=M, inlier_mask=final, n_tent=n_tent,
                n_inl=final.sum(-1), **extra)


def _verify_parts(parts, tcap: int, cfg: EngineConfig, w: int, h: int,
                  generator: torch.Generator, gt_h=None):
    """Bank concat -> compaction to the tentative capacity -> duplicate
    filter -> verification (``_verify_bank_program`` of the JAX package).
    With ``gt_h`` the GR_TRUTH mode, and its dual mode when
    ``cfg.do_both_ransac_gt``."""
    c = _concat_compact_parts(parts, tcap)
    if gt_h is None:
        out = _verify_core(cfg, w, h, c["xy1"], c["A1"], c["s1"], c["xy2"],
                           c["A2"], c["s2"], c["prio"], c["mask"], generator)
    else:
        keep = duplicate_filter(c["xy1"], c["xy2"], c["mask"],
                                cfg.match.duplicate_dist, priority=c["prio"])
        tmask = c["mask"] & keep
        inl = gt_h_inliers(gt_h, c["xy1"], c["xy2"], tmask,
                           cfg.ransac.err_threshold, cfg.ransac.error_type)
        out = dict(model=torch.as_tensor(gt_h, dtype=torch.float32,
                                         device=tmask.device),
                   inlier_mask=inl, n_tent=tmask.sum(), n_inl=inl.sum())
        if cfg.do_both_ransac_gt:
            # dual mode (mods.cpp:320-334): LO-RANSAC on the same
            # tentatives, GT-checked
            r = _verify_core(replace(cfg, ver_type="LORANSACH"), w, h,
                             c["xy1"], c["A1"], c["s1"], c["xy2"], c["A2"],
                             c["s2"], c["prio"], c["mask"], generator)
            rtrue = gt_h_inliers(gt_h, c["xy1"], c["xy2"], r["inlier_mask"],
                                 cfg.ransac.err_threshold,
                                 cfg.ransac.error_type)
            out["ransac_matches"] = r["inlier_mask"].sum()
            out["ransac_true"] = rtrue.sum()
    out["xy1_all"] = c["xy1"]
    out["xy2_all"] = c["xy2"]
    return out


def _group_arrays(group, Vb: int):
    """One view group's host arrays, padded to ``Vb`` view slots (a
    padded slot repeats view 0's maps and has extent 0): inverse rotation
    maps (Vb, 2, 3), zero for an identity group; valid extents (Vb, 2);
    inverse homographies (Vb, 2, 3)."""
    V = len(group)
    rot_inv = np.zeros((Vb, 2, 3), np.float32)
    if not group[0].identity:
        for v, p in enumerate(group):
            a, b, tx, c, d, ty = p.rot
            det = a * d - b * c
            ia, ib = d / det, -b / det
            ic, id_ = -c / det, a / det
            rot_inv[v] = [[ia, ib, -(ia * tx + ib * ty)],
                          [ic, id_, -(ic * tx + id_ * ty)]]
        rot_inv[V:] = rot_inv[0]
    valid = np.zeros((Vb, 2), np.int32)
    valid[:V] = [[p.h_new, p.w_new] for p in group]
    hinv = np.asarray(
        [np.linalg.inv(np.asarray(p.H, np.float64).reshape(3, 3))[:2, :]
         for p in group], np.float32)
    return rot_inv, valid, np.concatenate(
        [hinv, np.repeat(hinv[:1], Vb - V, 0)])


@dataclass
class MatchResult:
    H: np.ndarray
    xy1: np.ndarray
    xy2: np.ndarray
    n_matches: int
    n_tentatives: int
    steps_used: int
    log: TimeLog
    # dual GR_TRUTH+RANSAC mode counters (doBothRANSACgroundTruth,
    # mods.cpp:320-334): {"ransac_matches": N, "ransac_true": N}; the F
    # modes' diagnostics: {"degen": bool} (LORANSACF), {"log_nfa": x}
    # (ORSA)
    extras: dict = field(default_factory=dict)


def stop_and_best(inls, nstops, min_matches: int) -> tuple[int, int]:
    """The rung that ends the ladder, the first whose stop count crossed
    min_matches (mods.cpp:229-230), else the last; and the rung reported,
    the most verified up to there (the first of equals).  ``inls`` and
    ``nstops``: each rung's verified and stop counts."""
    stop_i = next((i for i, s in enumerate(nstops) if s >= min_matches),
                  len(nstops) - 1)
    return stop_i, max(range(stop_i + 1), key=lambda i: inls[i])


class TwoViewMatcher:
    """The ``mods`` CLI equivalent: escalation-laddered two-view matching
    on ``device`` (the card unless the caller passes ``"cpu"``)."""

    def __init__(self, ladder: list | None = None,
                 cfg: EngineConfig | None = None, seed: int = 0,
                 sync_timing: bool = False, stop_mode: str = "sync",
                 monolith: bool = False,
                 device: str | torch.device = "cuda"):
        if monolith:
            raise _not_ported("the monolith ladder program", 23)
        if stop_mode not in ("sync", "async", "pipelined"):
            raise ValueError(f"unknown stop_mode {stop_mode!r}")
        self.device = resolve_device(device)
        self.cfg = EngineConfig() if cfg is None else cfg
        self.ladder = ladder if ladder is not None else [IterationParams()]
        self._seed = seed
        # keypoint files of the ReadAffs detector, one an image
        self.affs_paths: tuple = (None, None)
        # per-(rung, image-size) geometry cache (see _prep_groups)
        self._prep_cache: dict = {}
        # sync_timing=True waits for the device at phase boundaries so
        # the TimeLog attributes wall-clock to the right phase; False
        # lets the kernels of a rung queue up behind the host
        self.sync_timing = sync_timing
        # "sync" reads each rung's match count before deciding to
        # escalate (the reference's control flow, mods.cpp:229-230);
        # "async" runs every rung and reads all counts in one transfer at
        # the end, selecting the first rung that crossed min_matches;
        # "pipelined" never blocks either, but reads the counts of the
        # rungs whose verification the card has finished (an event polled
        # after each rung) and stops at the first that crossed
        self.stop_mode = stop_mode
        # peak device memory of each rung of the last match() call, and
        # how many rungs it ran (pipelined mode may run past its stop)
        self.rung_peak_bytes: list = []
        self.rungs_run = 0
        # host-stage (MSER) seconds of the last match() call: the pool's
        # own render + detect time of the jobs consumed ("job_s"), the
        # main thread's wait for them ("wait_s"), and jobs run inline
        # ("inline_s")
        self.host_stage = dict(job_s=0.0, wait_s=0.0, inline_s=0.0)
        self._host_pool: ThreadPoolExecutor | None = None
        self._host_jobs: dict = {}        # step -> planned, not submitted
        self._host_futures: dict = {}
        self._fginn_db_cache = None

    def close(self) -> None:
        """Cancel pending host-stage jobs and stop the prefetch pool."""
        for f in self._host_futures.values():
            f.cancel()
        self._host_futures = {}
        if self._host_pool is not None:
            self._host_pool.shutdown(wait=True)
            self._host_pool = None

    def _specs(self, it: IterationParams) -> tuple:
        return tuple(spec_for(n, self.cfg) for n in it.descriptors)

    def _device_det(self, det: str) -> bool:
        if det == "MSER":
            return self.cfg.mser.backend == "device"
        return det in DEVICE_DETECTORS

    def _new_log(self) -> TimeLog:
        if self.sync_timing and self.device.type == "cuda":
            return TimeLog(sync=lambda: torch.cuda.synchronize(self.device))
        return TimeLog()

    # -- feature extraction ------------------------------------------------

    def _region_budgets(self, plans, det, vb: int | None = None):
        """Per-view region budget scaling
        (scale-space-detector.cpp:50-51), padded to ``vb`` rows for
        bucketed view batches."""
        cfg = self.cfg
        regn = []
        base_rn = cfg.pyramid_for(det).reg_number \
            if det in ("HessianAffine", "DoG", "HarrisAffine") else -1
        for p in plans:
            t, z = p.view.tilt, p.view.zoom
            rn = base_rn
            if base_rn > 0 and (t > 2.0 or z < 0.5):
                rn = int(np.floor(z * base_rn / t))
            regn.append(rn if rn > 0 else 10**9)
        if vb is not None:
            regn += [10**9] * (vb - len(regn))
        return torch.tensor(regn, dtype=torch.int32, device=self.device)

    def _prep_groups(self, it: IterationParams, h: int, w: int,
                     prev_views: list, sizes: tuple | None = None):
        """Per-(rung, image-size) group preparation, cached across pairs:
        the view grid, bucketed canvas shapes, inverse-rotation maps,
        H inverses and budgets are computed once and uploaded once, and
        the group's stage functions resolved once.  A steady-state pair
        then runs on device-resident arguments.

        ``sizes``: the (h, w) of each of P images padded onto one (h, w)
        canvas (a batch of ``parallel/multi.py``, ``_process_gallery`` of
        the JAX package): each image's views are planned at its own
        size, a group's canvases are the largest over the P images, and
        its arrays and stages take the P images folded into the view
        axis, pair-major ((P*Vb, ...); ``groups`` holds each image's
        plans, ``group`` the first's)."""
        key = (it, h, w, tuple(prev_views), sizes)
        hit = self._prep_cache.get(key)
        if hit is not None:
            return hit
        cfg = self.cfg
        dev = self.device
        views, new_prev = synthesis.expand_views(it, prev_views)
        grouped = [synthesis.group_views([synthesis.plan_view(v, wi, hi)
                                          for v in views])
                   for hi, wi in (sizes or [(h, w)])]
        P = len(grouped)
        specs = self._specs(it)
        pe = cfg.sift.patch_extraction
        device_det = self._device_det(it.detector)
        # host-stage detectors hand the describe stage their own rows a
        # view (host_k of the JAX package's _prep_groups)
        if device_det:
            detect, K = _make_detect_fn(it.detector, cfg), cfg.caps.per_view
        else:
            detect = None
            K = {"MSER": cfg.mser.host_cap,
                 "External": cfg.external.cap}.get(it.detector,
                                                   cfg.caps.per_view)
        preps = []
        for groups in zip(*grouped):
            p0 = groups[0][0]
            V = len(groups[0])
            # bucketed shapes, as the JAX package's: padded view slots
            # carry valid_hw == 0 and produce nothing
            Vb = synthesis.snap_views(V)
            plans = [p for g in groups for p in g]
            if p0.identity:
                hr = wr = 0
                hc = synthesis.snap_dim(h)
                wc = synthesis.snap_dim(w)
            else:
                hr = synthesis.snap_dim(max(p.h_rot for p in plans))
                wr = synthesis.snap_dim(max(p.w_rot for p in plans))
                hc = synthesis.snap_dim(max(p.h_new for p in plans))
                wc = synthesis.snap_dim(max(p.w_new for p in plans))
            rot_inv, valid_np, hinv = (np.concatenate(a) for a in zip(
                *(_group_arrays(g, Vb) for g in groups)))
            sx, sy = p0.tilt_scale
            squash_inv = np.asarray(
                [[1.0 / sx, 0.0, 0.0], [0.0, 1.0 / sy, 0.0]], np.float32)
            preps.append(dict(
                group=groups[0], groups=groups, V=V, Vb=Vb, hr=hr, wr=wr,
                hc=hc, wc=wc, identity=p0.identity, do_blur=p0.view.do_blur,
                rot_inv_np=rot_inv,
                rot_inv=torch.as_tensor(rot_inv, device=dev),
                squash_inv=torch.as_tensor(squash_inv, device=dev),
                sig_x=torch.tensor(p0.sigma_x, dtype=torch.float32,
                                   device=dev),
                sig_y=torch.tensor(p0.sigma_y, dtype=torch.float32,
                                   device=dev),
                valid_hw=torch.as_tensor(valid_np, device=dev),
                valid_hw_host=torch.as_tensor(valid_np),
                hinv=torch.as_tensor(hinv, device=dev),
                regn=self._region_budgets(groups[0], it.detector,
                                          Vb).repeat(P),
                render=_make_render_fn(Vb, h, w, hr, wr, hc, wc,
                                       p0.view.do_blur, p0.identity),
                detect=detect,
                describe=_make_desc_fn(
                    Vb, hc, wc, h, w, K, specs, cfg.dom_ori, pe.mr_size,
                    pe.patch_size, pe.photo_norm, cfg.caps,
                    pairs=P if sizes else None)))
        hit = (new_prev, preps)
        self._prep_cache[key] = hit
        return hit

    def _host_stage_regions(self, det: str, g_host: np.ndarray, group,
                            rot_inv: np.ndarray, hr: int, wr: int, hc: int,
                            wc: int, log: TimeLog, img_idx=0) -> dict:
        """Host-stage detection (MSER, ReadAffs, External): the regions as
        padded numpy (V, K, ...) arrays in view coordinates, over views
        that ``native/render.cpp`` renders on the host (never read back
        from the card).  ReadAffs reads the keypoint file of image
        ``img_idx`` (``affs_paths``) into the identity view; External runs
        its command on each view and, with a descriptor command, adds the
        (V, K, dim) rows it writes as ``ext_desc``.  MSER runs on the
        prefetch pool's threads: numpy and native code only, nothing of
        torch."""
        cfg = self.cfg
        V = len(group)
        p0 = group[0]
        if det == "ReadAffs":
            # keypoints ingested from a file as a "detector"
            # (imagerepresentation.cpp:721-746); identity view only
            path = (self.affs_paths[img_idx]
                    if img_idx < len(self.affs_paths) else None)
            if not path:
                raise ValueError("ReadAffs detector needs "
                                 "TwoViewMatcher.affs_paths set")
            with log.phase("DetectTime"):
                try:
                    xy, A, s, _ = read_oxford(path)
                except (ValueError, IndexError):
                    xy, A, s = read_kps(path)
            out = _empty_regions(V, cfg.caps.per_view)
            iv = next((i for i, p in enumerate(group) if p.identity), 0)
            _put_regions(out, iv, xy, A, s)
            return out
        valid_hw = np.asarray([[p.h_new, p.w_new] for p in group], np.int32)
        if det == "External" and not cfg.external.command:
            raise ValueError("External detector needs [ExternalDetector] "
                             "command set")
        with log.phase("SynthTime"):
            views_np = render_group_np(
                g_host, rot_inv, hr, wr, p0.view.do_blur, p0.sigma_x,
                p0.sigma_y, p0.tilt_scale[0], p0.tilt_scale[1], valid_hw,
                hc, wc, p0.identity)
        if det == "External":
            with log.phase("DetectTime"):
                return self._external_regions(views_np, valid_hw)
        if det != "MSER":
            raise KeyError(f"unknown host-stage detector {det!r}")
        caps = replace(cfg.caps, per_view=cfg.mser.host_cap)
        with log.phase("DetectTime"):
            # threaded across views: the native component tree releases
            # the GIL
            with ThreadPoolExecutor(max_workers=min(V, 8)) as ex:
                outs = list(ex.map(
                    lambda v: detect_msers_padded(
                        views_np[v], valid_hw[v], caps,
                        min_size=cfg.mser.min_size,
                        max_area=cfg.mser.max_area,
                        min_margin=cfg.mser.min_margin), range(V)))
        stack = {k: np.stack([o[k] for o in outs]) for k in outs[0]}
        stack.pop("sub_type")
        return stack

    def _external_regions(self, views_np: np.ndarray,
                          valid_hw: np.ndarray) -> dict:
        """The External plugin (imagerepresentation.cpp:747-1026) on one
        group's host-rendered views: each view's valid extent written as a
        PNG, ``command`` run on it, its keypoint file read as Oxford
        ellipses or ``kp`` rows; with ``desc_command``, the view's points
        handed to it and its rows (bicedescriptor.hpp) read as
        ``ext_desc``."""
        ext = self.cfg.external
        V = len(valid_hw)
        out = _empty_regions(V, ext.cap)
        if ext.desc_command:
            out["ext_desc"] = np.zeros((V, ext.cap, ext.desc_dim), np.float32)
        with tempfile.TemporaryDirectory() as td:
            for v in range(V):
                h_v, w_v = int(valid_hw[v, 0]), int(valid_hw[v, 1])
                ip, op = f"{td}/v{v}.png", f"{td}/v{v}.keys"
                write_png(ip, np.clip(views_np[v, :h_v, :w_v], 0,
                                      255).astype(np.uint8))
                subprocess.run(ext.command.format(img=ip, out=op),
                               shell=True, check=True, timeout=600,
                               capture_output=True)
                if ext.format == "kp":
                    xy, A, s = read_kps(op)
                else:
                    xy, A, s, _ = read_oxford(op)
                n = _put_regions(out, v, xy, A, s)
                if not (ext.desc_command and n):
                    continue
                pp, dp = f"{td}/v{v}.pts", f"{td}/v{v}.descs"
                with open(pp, "w") as f:
                    for i in range(n):
                        f.write(f"{xy[i, 0]} {xy[i, 1]} {s[i]}\n")
                subprocess.run(ext.desc_command.format(img=ip, pts=pp,
                                                       out=dp),
                               shell=True, check=True, timeout=600,
                               capture_output=True)
                rows = np.loadtxt(dp, dtype=np.float32, ndmin=2)
                if rows.shape[1] != ext.desc_dim + 2:
                    raise ValueError(
                        f"external descriptor wrote {rows.shape[1] - 2} "
                        f"dims, config says {ext.desc_dim}")
                m = min(len(rows), n)
                out["ext_desc"][v, :m] = rows[:m, 2:]
        return out

    def _host_stage_group(self, det: str, imgs_np: np.ndarray, gp: dict,
                          log, img_idx=0) -> dict:
        """One view group's host-stage regions for each of the P images
        of ``imgs_np`` (P, h, w) -> (P, V, K, ...) numpy arrays.  Several
        images run on a pool of threads (numpy and native code, which
        releases the GIL), as the JAX package's ``_host_stage_batch``.
        ``img_idx`` picks ReadAffs's file (which a batch refuses)."""
        P = imgs_np.shape[0]
        V, Vb = gp["V"], gp["Vb"]
        rot = gp["rot_inv_np"].reshape(P, Vb, 2, 3)[:, :V]

        def one(p, lg=log):
            return self._host_stage_regions(
                det, imgs_np[p], gp["groups"][p], rot[p], gp["hr"],
                gp["wr"], gp["hc"], gp["wc"], lg, img_idx)

        if P == 1:
            regs = [one(0)]
        else:
            with log.phase("DetectTime"), \
                    ThreadPoolExecutor(max_workers=min(P, 8)) as ex:
                regs = list(ex.map(lambda p: one(p, _HostLog()), range(P)))
        return {k: np.stack([r[k] for r in regs]) for k in regs[0]}

    def _timed_host_stage(self, *args) -> tuple:
        """A prefetch job: the host-stage regions and the job's seconds."""
        t0 = time.perf_counter()
        regs = self._host_stage_group(*args, log=_HostLog())
        return regs, time.perf_counter() - t0

    def _prefetch_host_stages(self, rungs, images) -> None:
        """Plan every host-stage (MSER) render + detect job of the ladder
        for this pair; ``_submit_host_stages`` hands a rung's jobs to a
        pool of two threads when the rung before it starts, so its host
        slabs are computed under that rung's device work (the reference's
        nested image/synthesis OpenMP parallelism,
        imagerepresentation.cpp:612-622, is the analogous overlap).  The
        JAX package submits the whole ladder's jobs before rung 0; here a
        pair that stops before an MSER rung runs none of its jobs, which
        would take the host cores that launch its kernels.  A new pair
        cancels the previous pair's unconsumed jobs.  ``images``: (key,
        (P, h, w) numpy images, their sizes or None) per image or batch
        side (an (h, w) image is a batch of one); a job is one view
        group of one key."""
        for f in self._host_futures.values():
            f.cancel()
        self._host_futures = {}
        self._host_jobs = {}
        prev_sim: dict = {}
        for step, rung in enumerate(rungs):
            for it in rung.dets:
                # ReadAffs reads a file and External runs its command
                # inline, as in the JAX package
                if self._device_det(it.detector) or it.detector != "MSER":
                    continue
                for img_key, imgs_np, sizes in images:
                    h, w = imgs_np.shape[-2:]
                    imgs_np = imgs_np.reshape((-1, h, w))
                    key = (it.detector, img_key)
                    new_prev, preps = self._prep_groups(
                        it, h, w, prev_sim.get(key, []), sizes)
                    prev_sim[key] = new_prev
                    for gi, gp in enumerate(preps):
                        self._host_jobs.setdefault(step, []).append((
                            (step, it.detector, img_key, gi),
                            (it.detector, imgs_np, gp)))

    def _submit_host_stages(self, upto: int) -> None:
        """Submit the planned host-stage jobs of rungs ``<= upto``."""
        for step in sorted(s for s in self._host_jobs if s <= upto):
            if self._host_pool is None:
                self._host_pool = ThreadPoolExecutor(max_workers=2)
            for key, args in self._host_jobs.pop(step):
                self._host_futures[key] = self._host_pool.submit(
                    self._timed_host_stage, *args)

    def _host_regions(self, imgs_np: np.ndarray, gp: dict, it, log: TimeLog,
                      key: tuple):
        """One group's host-stage regions of the P images of ``imgs_np``
        (P, h, w) on the device: the prefetched job's result (only the
        residual wait lands in ``DetectTime``) or the job run inline,
        padded with empty rows to the group's Vb view slots and uploaded
        in one copy, (P*Vb, K, ...); then the External descriptor rows,
        (P*Vb, K, dim) in a second copy, or None."""
        V, Vb = gp["V"], gp["Vb"]
        fut = self._host_futures.pop(key, None)
        if fut is not None:
            t0 = time.perf_counter()
            with log.phase("DetectTime"):
                regs, job_s = fut.result()
            self.host_stage["wait_s"] += time.perf_counter() - t0
            self.host_stage["job_s"] += job_s
        else:
            t0 = time.perf_counter()
            regs = self._host_stage_group(it.detector, imgs_np, gp, log,
                                          key[2])
            self.host_stage["inline_s"] += time.perf_counter() - t0
        P, _, K = regs["xy"].shape[:3]
        # one (P, Vb, K, 9) float32 slab: xy, A, s, response, mask
        slab = np.zeros((P, Vb, K, 9), np.float32)
        slab[:, :V, :, 0:2] = regs["xy"]
        slab[:, :V, :, 2:6] = regs["A"].reshape(P, V, K, 4)
        slab[:, :V, :, 6] = regs["s"]
        slab[:, :V, :, 7] = regs["response"]
        slab[:, :V, :, 8] = regs["mask"]
        t = torch.from_numpy(slab).to(self.device).reshape(P * Vb, K, 9)
        ext = None
        if "ext_desc" in regs:
            # the command's float32 rows, carried bit for bit
            ed = np.zeros((P, Vb) + regs["ext_desc"].shape[2:], np.float32)
            ed[:, :V] = regs["ext_desc"]
            ext = torch.from_numpy(ed).to(self.device).reshape(
                (P * Vb,) + ed.shape[2:])
        return (t[..., 0:2], t[..., 2:6].reshape(P * Vb, K, 2, 2), t[..., 6],
                t[..., 7], t[..., 8] > 0.5), ext

    def _process_image(self, img: torch.Tensor, it: IterationParams,
                       prev_views: list, stores: dict, log: TimeLog,
                       img_idx=0, img_np: np.ndarray | None = None,
                       step: int = -1, sizes: tuple | None = None):
        """Synthesize, detect and describe one image for one detector
        iteration: per view group render -> detect -> describe, the
        group's rows appended to the (detector, descriptor) stores.  One
        group's views and pyramids are alive at a time.  A host-stage
        detector's regions come from the host (``img_np`` is the image
        there; ``(step, detector, img_idx, group)`` keys its prefetched
        job), and the card renders the views again for description.

        With ``sizes`` (``_prep_groups``), ``img`` and ``img_np`` are a
        (P, h, w) batch of padded images that go through each stage
        together, into ``BatchedDeviceStore``s (the JAX package's
        ``MultiMatcher._process_gallery``)."""
        cfg = self.cfg
        h, w = img.shape[-2:]
        new_prev, preps = self._prep_groups(it, h, w, prev_views, sizes)
        sts = []
        for sp in self._specs(it):
            key = (it.detector, sp.name)
            st = stores.get(key)
            if st is None:
                stores[key] = st = (
                    BatchedDeviceStore(len(sizes), cfg.caps.per_image,
                                       sp.dim, self.device) if sizes else
                    DeviceStore(cfg.caps.per_image, sp.dim, self.device))
            sts.append(st)
        ext = None
        for gi, gp in enumerate(preps):
            if gp["detect"] is None:
                if img_np is None:
                    img_np = img.cpu().numpy()
                regs, ext = self._host_regions(
                    img_np.reshape((-1, h, w)), gp, it, log,
                    (step, it.detector, img_idx, gi))
            with log.phase("SynthTime"):
                views = gp["render"](img, gp["rot_inv"], gp["squash_inv"],
                                     gp["sig_x"], gp["sig_y"],
                                     gp["valid_hw"])
            if gp["detect"] is not None:
                with log.phase("DetectTime"):
                    r = gp["detect"](views, gp["valid_hw"],
                                     gp["valid_hw_host"], gp["regn"])
                    regs = (r.xy, r.A, r.s, r.response, r.mask)
            with log.phase("DescTime"):
                gp["describe"](views, gp["valid_hw"], *regs, gp["hinv"],
                               sts, ext)
        return new_prev

    # -- matching ----------------------------------------------------------

    def _fginn_db(self, spec) -> tuple | None:
        """The descriptor database of FGINN+DB mode (RootSIFT only, as in
        correspondencebank.cpp:337-341; file = [Matching] SIFTDBfile):
        whitespace-separated rows, padded to a power-of-two row count as
        the JAX package pads them, on the device; reloaded when the file
        changes."""
        cfg = self.cfg
        path = cfg.match.sift_db_file
        if not (cfg.match.use_db_for_fginn and spec.name == "RootSIFT"
                and path):
            return None
        stamp = (path, os.path.getmtime(path))
        if self._fginn_db_cache is not None \
                and self._fginn_db_cache[0] == stamp:
            return self._fginn_db_cache[1]
        arr = np.loadtxt(path, dtype=np.float32, ndmin=2)
        if arr.shape[1] != spec.dim:
            raise ValueError(
                f"SIFT DB dim {arr.shape[1]} != descriptor {spec.dim}")
        n = arr.shape[0]
        cap = max(128, 1 << (n - 1).bit_length())
        desc = np.zeros((cap, spec.dim), np.float32)
        desc[:n] = arr
        mask = np.zeros((cap,), bool)
        mask[:n] = True
        db = (torch.as_tensor(desc, device=self.device),
              torch.as_tensor(mask, device=self.device))
        self._fginn_db_cache = (stamp, db)
        return db

    def _match_one(self, parts1: list, parts2: list, spec,
                   ratio: float, dist_thr: float, log: TimeLog) -> list:
        """FGINN and/or distance matching over pooled device stores.
        Both run when both thresholds are positive
        (correspondencebank.cpp:281-285).  FGINN+DB: the database
        contributes an extra impostor distance
        (correspondencebank.cpp:337-341).  Where one side's stores carry
        a pair axis (``BatchedDeviceStore``), the other side's unbatched
        stores are broadcast along it: one query against a gallery."""
        cfg = self.cfg
        run_f = ratio > 0
        run_d = dist_thr > 0
        if not (run_f or run_d):
            return []
        db = self._fginn_db(spec) if run_f else None
        arrs1 = [p.device_arrays() for p in parts1]
        arrs2 = [p.device_arrays() for p in parts2]
        lead = [a[4].shape for a in arrs1 + arrs2 if a[4].dim()]
        if lead:
            arrs1, arrs2 = ([tuple(t.expand(lead[0] + t.shape) for t in a)
                             if not a[4].dim() else a for a in arrs]
                            for arrs in (arrs1, arrs2))
        with log.phase("MatchingTime"):
            return _pool_match_parts(
                arrs1, arrs2, ratio, dist_thr, db,
                cfg.caps.per_image, cfg.match.knn, cfg.match.contrad_dist,
                cfg.match.duplicate_mode, run_f, run_d,
                spec.kind == "binary", cfg.match.standard_2nd_closest)

    def _execute_plan(self, stores1: dict, stores2: dict, rung: Rung,
                      log: TimeLog, bank: dict | None = None) -> None:
        """Run the rung's matching plan, replacing the recomputed keys in
        the persistent tentative bank (MatchImgReps,
        correspondencebank.cpp:237-351): the matcher's own, or ``bank``
        (``parallel/multi.py``'s, over batched stores)."""
        cfg = self.cfg
        plan = rung.plan or rung.default_plan()
        bank = self._bank if bank is None else bank

        # grouped: pool stores across group_detectors per descriptor,
        # thresholds from the global [Matching] maps
        for desc in plan.group_descriptors:
            spec = spec_for(desc, cfg)
            pooled1 = [stores1[(det, desc)] for det in plan.group_detectors
                       if (det, desc) in stores1]
            pooled2 = [stores2[(det, desc)] for det in plan.group_detectors
                       if (det, desc) in stores2]
            key = ("Group", desc)
            bank.pop(key, None)
            if not (pooled1 and pooled2):
                continue
            parts = self._match_one(pooled1, pooled2, spec,
                                    cfg.match.group_fginn(desc),
                                    cfg.match.group_distance(desc), log)
            if parts:
                bank[key] = parts

        # separate: per (detector, descriptor), detector must have run
        # this rung; thresholds from the rung's per-descriptor maps
        rung_dets = {d.detector: d for d in rung.dets}
        for det in plan.separate_detectors:
            it = rung_dets.get(det)
            if it is None:
                continue      # not synthesized this step -> keep stale key
            for desc in plan.separate_descriptors:
                key = (det, desc)
                bank.pop(key, None)
                if key not in stores1 or key not in stores2:
                    continue
                parts = self._match_one(
                    [stores1[key]], [stores2[key]], spec_for(desc, cfg),
                    it.fginn_for(desc), it.distance_for(desc), log)
                if parts:
                    bank[key] = parts

    def _verify_bank(self, log: TimeLog):
        """Concatenate the tentative bank (GetCorresponcesVector,
        mods.cpp:298) -> duplicate filter -> geometric verification, all
        on the device."""
        cfg = self.cfg
        tent_parts = [p for parts in self._bank.values() for p in parts]
        if not tent_parts:
            return None
        w, h = self._wh
        gt = self._gt_h if cfg.ver_type == "GR_TRUTH" else None
        with log.phase("RANSACTime"):
            return _verify_parts(tent_parts, cfg.caps.tentatives, cfg, w, h,
                                 self._generator, gt)

    def _escalate(self, sides: tuple, stores: tuple, bank: dict,
                  log: TimeLog, verify, stop) -> int:
        """The escalation ladder (mods.cpp:200-230), of ``match`` and of
        the batched matchers of ``parallel/multi.py``.  ``sides``: (key,
        device image, numpy image, sizes) per side, an image or a (P, h,
        w) batch with each image's sizes (``_process_image``).  Per rung:
        each side's views into its ``stores``, the rung's matching plan
        into the tentative ``bank``, ``verify()``, and, where it verified
        anything, ``stop(rungs run, verification)`` ends the ladder.  A
        rung's host-stage jobs are submitted when the rung before it
        starts.  Returns the rungs run."""
        cfg, dev = self.cfg, self.device
        rungs = as_rungs(self.ladder)[:cfg.max_steps]
        self.host_stage = dict(job_s=0.0, wait_s=0.0, inline_s=0.0)
        self._prefetch_host_stages(rungs, [(s[0], s[2], s[3])
                                           for s in sides])
        prev = tuple({} for _ in sides)   # per-detector accumulated views
        self.rung_peak_bytes = []
        steps = 0
        for step, rung in enumerate(rungs):
            steps += 1
            self._submit_host_stages(step + 1)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            for it in rung.dets:
                for (key, img, img_np, sizes), st, pv in zip(sides, stores,
                                                             prev):
                    pv[it.detector] = self._process_image(
                        img, it, pv.get(it.detector, []), st, log, key,
                        img_np, step, sizes)
            # hardcoded tentative drops (mods.cpp:288-289)
            for cstep, cdet, cdesc in cfg.clear_tentatives:
                if step == cstep:
                    bank.pop((cdet, cdesc), None)
            self._execute_plan(stores[0], stores[1], rung, log, bank)
            out = verify()
            if dev.type == "cuda":
                self.rung_peak_bytes.append(
                    torch.cuda.max_memory_allocated(dev))
            if out is not None and stop(steps, out):
                break
        self.rungs_run = steps
        self._host_jobs = {}          # the rungs after the stop never run
        return steps

    def match(self, img1, img2, gt_h=None) -> MatchResult:
        cfg = self.cfg
        dev = self.device
        self._gt_h = gt_h
        # deterministic per pair: one generator, seeded anew for each
        # pair, feeds every rung's RANSAC draws in order
        self._generator = torch.Generator(device=dev).manual_seed(self._seed)
        log = self._new_log()
        g1 = to_gray_np(img1)
        g2 = to_gray_np(img2)
        if cfg.do_clahe:
            # photometric normalization (mods.cpp:139-189, clip limit 4,
            # mods.cpp:144), on the host so each image crosses once
            with log.phase("MiscTime"):
                g1 = clahe_np(g1, clip_limit=4.0)
                g2 = clahe_np(g2, clip_limit=4.0)
        self._wh = (max(g1.shape[1], g2.shape[1]),
                    max(g1.shape[0], g2.shape[0]))
        self._bank = {}
        # store pooling: buffers persist across pairs (only the counts
        # rewind), so a steady-state pair allocates no store
        if not hasattr(self, "_stores"):
            self._stores = ({}, {})
        for side in self._stores:
            for st in side.values():
                st.reset()
        outs: list = []               # (step_1based, out) per rung
        stop_counts: list = []        # host ints, sync mode only
        pending = 0                   # first unread rung, pipelined mode

        def stop(steps: int, out: dict) -> bool:
            nonlocal pending
            if self.stop_mode == "pipelined" and dev.type == "cuda":
                # marks the end of this rung's verification on the stream
                out["done"] = torch.cuda.Event()
                out["done"].record()
            outs.append((steps, out))
            if self.stop_mode == "sync":
                # the rung's one read for the stop rule: its match count
                # (dual GR_TRUTH mode stops on the RANSAC match count,
                # mods.cpp:412-414)
                n_inl, n_stop = torch.stack(
                    [out["n_inl"],
                     out.get("ransac_matches", out["n_inl"])]).tolist()
                stop_counts.append((n_inl, n_stop))
                return n_stop >= cfg.min_matches
            if self.stop_mode == "pipelined":
                # non-blocking early stop: read the counts of the rungs the
                # card has finished, and only those (a read of a pending
                # rung's count would wait for it); on the CPU every rung
                # is finished
                while pending < len(outs):
                    o = outs[pending][1]
                    if "done" in o and not o["done"].query():
                        break
                    if int(o.get("ransac_matches", o["n_inl"])) \
                            >= cfg.min_matches:
                        return True
                    pending += 1
            return False

        # one upload per image per pair; every rung reuses these
        steps = self._escalate(
            ((0, torch.as_tensor(g1, device=dev), g1, None),
             (1, torch.as_tensor(g2, device=dev), g2, None)),
            self._stores, self._bank, log, lambda: self._verify_bank(log),
            stop)
        if not outs:
            log.finalize()
            return MatchResult(H=np.eye(3), xy1=np.zeros((0, 2)),
                               xy2=np.zeros((0, 2)), n_matches=0,
                               n_tentatives=0, steps_used=steps, log=log)
        if self.stop_mode == "sync":
            inls = [n for n, _ in stop_counts]
            nstops = [s for _, s in stop_counts]
        else:
            # one batched count read for the whole ladder
            with log.phase("MiscTime"):
                counts = torch.stack(
                    [torch.stack([o["n_inl"],
                                  o.get("ransac_matches", o["n_inl"])])
                     for _, o in outs]).tolist()
            inls = [c[0] for c in counts]
            nstops = [c[1] for c in counts]
        stop_i, best_i = stop_and_best(inls, nstops, cfg.min_matches)
        steps_used = (outs[stop_i][0]
                      if nstops[stop_i] >= cfg.min_matches else steps)
        n_inl, out = inls[best_i], outs[best_i][1]
        log.finalize()
        extras = {}
        if "ransac_matches" in out:
            extras = dict(ransac_matches=int(out["ransac_matches"]),
                          ransac_true=int(out["ransac_true"]))
        if "degen" in out:
            extras["degen"] = bool(out["degen"])
        if "log_nfa" in out:
            extras["log_nfa"] = float(out["log_nfa"])
        # the only bulk read, after the ladder stops: the verified rows,
        # compacted on the device
        tcap = out["inlier_mask"].shape[0]
        idx, valid = nonzero_static(out["inlier_mask"], tcap)
        cxy1 = _take_fill(out["xy1_all"], idx, valid)
        cxy2 = _take_fill(out["xy2_all"], idx, valid)
        return MatchResult(
            H=out["model"].cpu().numpy(),
            xy1=cxy1[:n_inl].cpu().numpy(), xy2=cxy2[:n_inl].cpu().numpy(),
            n_matches=n_inl, n_tentatives=int(out["n_tent"]),
            steps_used=steps_used, log=log, extras=extras)
