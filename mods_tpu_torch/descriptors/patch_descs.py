"""Patch-functor descriptors: SURF (and KAZE's M-SURF), LIOP, DAISY, SSIM,
M-LDB, MROGH, FREAK and BRISK (mirrors
``mods_tpu/descriptors/patch_descs.py``).

The reference computes these on the normalized 41x41 patch through the
``DescribeRegions`` template (synth-detection.hpp:169-255) with per-
descriptor functors: SURF (opensurf/surf.cpp), LIOP (vlfeat
vl_liopdesc_process), DAISY single-point (libdaisy), SSIM
self-similarity (ssdesc-cpp), M-LDB (AKAZE), MROGH and the OpenCV
FREAK/BRISK extractors.

Each is a batched (K, P, P) -> (K, D) tensor program on the patches'
device: spatial poolings are matrix products, neighbour samplings are
fixed gathers, orderings are sorts.  Histograms are products with
one-hot factors, never scatters with float atomics, so two runs on the
card agree bit for bit.  Every table (sampling offsets, bins, pair
lists) is built on the host with numpy by the JAX package's own calls.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from mods_tpu_torch.ops.gaussian import gaussian_blur
from mods_tpu_torch.ops.image import const, patch_gradient


def _l2_normalize(v: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    n = torch.sqrt(torch.sum(v * v, -1, keepdim=True))
    return v / torch.clamp(n, min=eps)


def _pool(W: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """``einsum("rb,krc,cd->kbd", W, f, W)``: (K, P, P) -> (K, g, g)."""
    return torch.einsum("rb,krc,cd->kbd", W, f, W)


class _Taps:
    """Bilinear reads at fixed float coordinates: the floors, fractions
    and validity of ``ops/warp.py::bilinear_sample`` (fill 0) computed
    once on the host in float32, as the JAX package computes them.  A
    read is from a stack of (size, size) planes flattened to its last
    axis, each coordinate from its ``plane``."""

    def __init__(self, x: np.ndarray, y: np.ndarray, size: int, plane=0):
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        x0 = np.floor(x)
        y0 = np.floor(y)
        self.wx = (x - x0).astype(np.float32)
        self.wy = (y - y0).astype(np.float32)
        x0i = x0.astype(np.int64)
        y0i = y0.astype(np.int64)
        self.valid = ((x0i >= 0) & (y0i >= 0) & (x0i < size - 1)
                      & (y0i < size - 1))
        self.base = ((np.asarray(plane, np.int64) * size
                      + np.clip(y0i, 0, size - 2)) * size
                     + np.clip(x0i, 0, size - 2))
        self.size = size

    def read(self, flat: torch.Tensor) -> torch.Tensor:
        """(..., size*size) -> (..., *coordinate shape)."""
        dev = flat.device
        base = torch.as_tensor(self.base.reshape(-1), device=dev)
        w = self.size
        p00, p01, p10, p11 = (flat[..., base + o] for o in (0, 1, w, w + 1))
        shape = flat.shape[:-1] + self.base.shape
        wx = const(self.wx.reshape(-1), flat)
        wy = const(self.wy.reshape(-1), flat)
        top = p00 + wx * (p01 - p00)
        bot = p10 + wx * (p11 - p10)
        val = top + wy * (bot - top)
        valid = torch.as_tensor(self.valid.reshape(-1), device=dev)
        return torch.where(valid, val, torch.zeros_like(val)).reshape(shape)


# --------------------------------------------------------------------------
# SURF (64-d): 4x4 cells x (sum dx, sum |dx|, sum dy, sum |dy|)

@functools.lru_cache(maxsize=8)
def _cell_weights(P: int, cells: int) -> np.ndarray:
    """(P, cells) assignment of rows/cols to grid cells with a Gaussian
    window over the whole patch (sigma = 0.33 P)."""
    W = np.zeros((P, cells), np.float32)
    bounds = np.linspace(0, P, cells + 1)
    for i in range(P):
        c = np.searchsorted(bounds, i + 0.5) - 1
        W[i, min(max(c, 0), cells - 1)] = 1.0
    g = np.exp(-0.5 * ((np.arange(P) - P / 2.0) / (0.33 * P)) ** 2)
    return (W * g[:, None]).astype(np.float32)


def surf_descriptor(patches: torch.Tensor, cells: int = 4) -> torch.Tensor:
    """(K, P, P) -> (K, 64) M-SURF-style descriptor, L2-normalized."""
    P = patches.shape[-1]
    gx, gy = patch_gradient(patches)
    W = const(_cell_weights(P, cells), patches)
    v = torch.stack([_pool(W, f) for f in (gx, gx.abs(), gy, gy.abs())],
                    -1).reshape(patches.shape[0], -1)
    return _l2_normalize(v)


# --------------------------------------------------------------------------
# LIOP (144-d): local intensity order patterns (vlfeat vl/liop.c)

_LIOP_NEIGHBORS = 4
_LIOP_BINS = 6


@functools.lru_cache(maxsize=4)
def _liop_tables(P: int, n_neigh: int, radius: float):
    """Sampling offsets for the neighbour circle, support mask and each
    pixel's radial angle."""
    ang = 2.0 * np.pi * np.arange(n_neigh) / n_neigh
    offs = np.stack([radius * np.cos(ang), radius * np.sin(ang)],
                    -1).astype(np.float32)          # (n, 2) dx, dy
    yy, xx = np.mgrid[0:P, 0:P].astype(np.float32)
    c = (P - 1) / 2.0
    rr = np.hypot(xx - c, yy - c)
    support = rr <= (c - radius - 1.0)
    theta = np.arctan2(yy - c, xx - c)
    return offs, support.astype(np.float32), theta.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _liop_taps(P: int, n_neigh: int, radius: float) -> _Taps:
    """The rotated neighbour coordinates of every pixel, (n, P, P):
    neighbours are sampled relative to the outward radial direction so
    the pattern is rotation-covariant (liop.c)."""
    offs, _, theta = _liop_tables(P, n_neigh, radius)
    yy, xx = np.mgrid[0:P, 0:P].astype(np.float32)
    ct, st = np.cos(theta), np.sin(theta)
    nx = xx[None] + offs[:, 0, None, None] * ct[None] \
        - offs[:, 1, None, None] * st[None]
    ny = yy[None] + offs[:, 0, None, None] * st[None] \
        + offs[:, 1, None, None] * ct[None]
    return _Taps(nx, ny, P)


def rank_index(vals: torch.Tensor) -> torch.Tensor:
    """(..., n) neighbour intensities -> permutation index (0..n!-1): the
    Lehmer code of the ranks, ties broken by position (a stable sort)."""
    n = vals.shape[-1]
    pos = torch.arange(n, device=vals.device)
    less = vals[..., None, :] < vals[..., :, None]
    tie = vals[..., None, :] == vals[..., :, None]
    rank = torch.sum(less | (tie & (pos[None, :] < pos[:, None])), -1)
    later_smaller = ((rank[..., None, :] < rank[..., :, None])
                     & (pos[None, :] > pos[:, None]))
    lehmer = torch.sum(later_smaller, -1)
    fact = torch.as_tensor([math.factorial(n - 1 - i) for i in range(n)],
                           device=vals.device)
    return torch.sum(lehmer * fact, -1)


def _order_bins(patches: torch.Tensor, inside: np.ndarray,
                n_bins: int) -> torch.Tensor:
    """Each pixel's intensity-order bin over the support ``inside``
    (a (P, P) host mask): equal-count quantile thresholds from the sorted
    supported intensities (liop.c, MROGH's order groups) -> (K, P, P) in
    0..n_bins-1."""
    K = patches.shape[0]
    n_sup = int(inside.sum())
    flat = torch.where(torch.as_tensor(inside, device=patches.device)[None],
                       patches, torch.full_like(patches, 1e30)).reshape(K, -1)
    svals = torch.sort(flat, -1).values
    qpos = torch.as_tensor((np.arange(1, n_bins) * n_sup) // n_bins,
                           device=patches.device)
    ths = svals[:, qpos]                             # (K, n_bins-1)
    return torch.sum(patches[..., None] >= ths[:, None, None, :], -1)


def _hist2(a: torch.Tensor, na: int, b: torch.Tensor, nb: int,
           w: torch.Tensor) -> torch.Tensor:
    """Weighted 2-D histogram of the (K, N) bin ids ``a`` and ``b``:
    ``out[k, i, j] = sum_n w[k, n] [a == i] [b == j]`` as a batched product
    of one-hot factors (deterministic, no atomics) -> (K, na * nb)."""
    oa = (a[..., None] == torch.arange(na, device=a.device)).to(
        w.dtype) * w[..., None]                          # (K, N, na)
    ob = (b[..., None] == torch.arange(nb, device=b.device)).to(
        w.dtype)                                         # (K, N, nb)
    return torch.bmm(oa.transpose(1, 2), ob).reshape(a.shape[0], na * nb)


def liop_permutations(patches: torch.Tensor, radius: float = 6.0,
                      n_neigh: int = _LIOP_NEIGHBORS):
    """(K, P, P) -> ((K, P, P) permutation index of each pixel's rotated
    neighbours, (K, P, P, n) their intensities)."""
    K, P, _ = patches.shape
    neigh = _liop_taps(P, n_neigh, float(radius)).read(
        patches.reshape(K, -1))                          # (K, n, P, P)
    neigh = neigh.permute(0, 2, 3, 1)
    return rank_index(neigh), neigh


def liop_descriptor(patches: torch.Tensor, radius: float = 6.0,
                    n_neigh: int = _LIOP_NEIGHBORS,
                    n_bins: int = _LIOP_BINS) -> torch.Tensor:
    """(K, P, P) -> (K, n_bins * n_neigh!) LIOP."""
    K, P, _ = patches.shape
    _, support, _ = _liop_tables(P, n_neigh, float(radius))
    pidx, _ = liop_permutations(patches, radius, n_neigh)
    binid = _order_bins(patches, support > 0, n_bins)
    # weight: 1 within the support (vlfeat's weighting threshold off)
    w = const(support, patches).reshape(1, -1).expand(K, -1)
    v = _hist2(binid.reshape(K, -1), n_bins, pidx.reshape(K, -1),
               math.factorial(n_neigh), w)
    return _l2_normalize(v)


# --------------------------------------------------------------------------
# DAISY single-point (200-d): center + 3 rings x 8 points, 8 orientations

@functools.lru_cache(maxsize=4)
def _daisy_grid(P: int, n_rings: int, n_segs: int):
    c = (P - 1) / 2.0
    pts = [(c, c, 0)]
    for ri in range(1, n_rings + 1):
        rad = ri * (c * 0.8) / n_rings
        for si in range(n_segs):
            a = 2 * np.pi * si / n_segs
            pts.append((c + rad * np.cos(a), c + rad * np.sin(a), ri))
    xy = np.asarray([(x, y) for x, y, _ in pts], np.float32)
    lvl = np.asarray([lv for _, _, lv in pts], np.int32)
    return xy, lvl


def daisy_descriptor(patches: torch.Tensor, n_rings: int = 3,
                     n_segs: int = 8, n_ori: int = 8) -> torch.Tensor:
    """(K, P, P) -> (K, (1 + n_rings*n_segs) * n_ori) DAISY at the patch
    centre (libdaisy single-point mode)."""
    K, P, _ = patches.shape
    gx, gy = patch_gradient(patches)
    mag = torch.sqrt(gx * gx + gy * gy)
    ori = torch.atan2(gy, gx)
    # n_ori positive-clipped orientation maps (daisy's layered gradients)
    angs = const(np.arange(n_ori, dtype=np.float32)
                 * np.float32(2 * np.pi / n_ori), patches)
    layers = mag[..., None] * torch.clamp(torch.cos(ori[..., None] - angs),
                                          min=0.0)
    layers = layers.permute(0, 3, 1, 2)               # (K, n_ori, P, P)
    # cumulative smoothing per ring level
    sig = [1.0, 2.5, 5.0, 7.5][:n_rings + 1]
    smoothed = [gaussian_blur(layers, sig[0])]
    for i in range(1, n_rings + 1):
        inc = math.sqrt(max(sig[i] ** 2 - sig[i - 1] ** 2, 0.25))
        smoothed.append(gaussian_blur(smoothed[-1], inc))
    vol = torch.stack(smoothed, 1)        # (K, n_rings+1, n_ori, P, P)
    xy, lvl = _daisy_grid(P, n_rings, n_segs)
    # every point reads its ring's level: one gather of all points and
    # orientations from the flattened (level, pixel) axis
    flat = vol.permute(0, 2, 1, 3, 4).reshape(K, n_ori, -1)
    hist = _Taps(xy[:, 0], xy[:, 1], P, lvl).read(flat).transpose(1, 2)
    return _l2_normalize(hist).reshape(K, -1)


# --------------------------------------------------------------------------
# SSIM self-similarity (ssdesc.cc calc_ssdescs_alt semantics)

@functools.lru_cache(maxsize=4)
def _ssim_bins(P: int, inner: int, n_rad: int, n_ang: int):
    """Log-polar bin of each window offset -> (P', P') bin ids, -1 out."""
    out = P - inner + 1                      # correlation surface size
    c = (out - 1) / 2.0
    yy, xx = np.mgrid[0:out, 0:out].astype(np.float32)
    dx, dy = xx - c, yy - c
    r = np.hypot(dx, dy)
    a = np.mod(np.arctan2(dy, dx), 2 * np.pi)
    rmax = c
    with np.errstate(divide="ignore"):
        rbin = np.floor(n_rad * np.log1p(r) / np.log1p(rmax)).astype(int)
    rbin = np.clip(rbin, 0, n_rad - 1)
    abin = np.minimum((a * n_ang / (2 * np.pi)).astype(int), n_ang - 1)
    binid = rbin * n_ang + abin
    binid[r > rmax] = -1
    binid[r < 1.0] = -1                      # exclude the trivial centre
    return binid


def ssim_surface(patches: torch.Tensor, inner: int = 5) -> torch.Tensor:
    """(K, P, P) -> (K, P-inner+1, P-inner+1) SSD of the central inner x
    inner patch against every window, by grouped correlation:
    ssd = sum(p^2) - 2 corr + sum(c^2)."""
    K, P, _ = patches.shape
    c0 = (P - inner) // 2
    center = patches[:, c0:c0 + inner, c0:c0 + inner]
    ones = torch.ones((K, 1, inner, inner), dtype=patches.dtype,
                      device=patches.device)
    x = patches[None]                                  # (1, K, P, P)
    p2 = F.conv2d(x * x, ones, groups=K)[0]
    corr = F.conv2d(x, center[:, None], groups=K)[0]
    c2 = torch.sum(center * center, (-1, -2))[:, None, None]
    return p2 - 2.0 * corr + c2


def ssim_descriptor(patches: torch.Tensor, inner: int = 5, n_rad: int = 4,
                    n_ang: int = 10) -> torch.Tensor:
    """(K, P, P) -> (K, n_rad*n_ang) self-similarity descriptor: the SSD
    surface of ``ssim_surface`` as exp(-ssd / varnoise), max-pooled into
    log-polar bins, normalized to [0, 1]."""
    K, P, _ = patches.shape
    ssd = ssim_surface(patches, inner)
    # varnoise from the local auto-variance
    varn = torch.clamp(torch.mean(ssd, (-1, -2), keepdim=True) * 0.5,
                       min=1e-3)
    sim = torch.exp(-ssd / varn)
    binid = _ssim_bins(P, inner, n_rad, n_ang).reshape(-1)
    keep = np.flatnonzero(binid >= 0)
    # the max over each bin (prune_normalise); sim > 0, so a zero start
    # is the JAX package's max over a zero-filled mask
    idx = torch.as_tensor(binid[keep], device=patches.device)
    vals = sim.reshape(K, -1)[:, torch.as_tensor(keep,
                                                 device=patches.device)]
    v = torch.zeros((K, n_rad * n_ang), dtype=sim.dtype,
                    device=sim.device).scatter_reduce(
        1, idx.expand(K, -1), vals, "amax")
    vmin = torch.amin(v, -1, keepdim=True)
    vmax = torch.amax(v, -1, keepdim=True)
    return (v - vmin) / torch.clamp(vmax - vmin, min=1e-10)


# --------------------------------------------------------------------------
# M-LDB (AKAZE's binary descriptor, Get_MLDB_Full_Descriptor): block
# means of (intensity, dx, dy) on 2x2/3x3/4x4 grids, all pairwise
# comparisons -> 486 bits.

@functools.lru_cache(maxsize=4)
def _block_means_weights(P: int, grid: int) -> np.ndarray:
    W = np.zeros((P, grid), np.float32)
    bounds = np.linspace(0, P, grid + 1)
    for i in range(P):
        c = np.searchsorted(bounds, i + 0.5) - 1
        W[i, min(max(c, 0), grid - 1)] = 1.0
    return W / np.maximum(W.sum(0, keepdims=True), 1)


def mldb_cells(patches: torch.Tensor, grids: tuple = (2, 3, 4)) -> list:
    """The block means that M-LDB compares: per grid and channel
    (intensity, dx, dy) a (K, g*g) tensor."""
    gx, gy = patch_gradient(patches)
    out = []
    for g in grids:
        W = const(_block_means_weights(patches.shape[-1], g), patches)
        for ch in (patches, gx, gy):
            out.append(_pool(W, ch).reshape(patches.shape[0], -1))
    return out


def _cell_pairs(patches: torch.Tensor, grids: tuple):
    """The two block means of each M-LDB bit, per grid and channel."""
    for v in mldb_cells(patches, grids):
        iu, ju = (torch.as_tensor(i, device=v.device)
                  for i in np.triu_indices(v.shape[1], 1))
        yield v[:, iu], v[:, ju]


def mldb_descriptor(patches: torch.Tensor,
                    grids: tuple = (2, 3, 4)) -> torch.Tensor:
    """(K, P, P) -> (K, 486) 0/1 bits (Hamming distance = squared L2)."""
    return torch.cat([(a > b).to(torch.float32)
                      for a, b in _cell_pairs(patches, grids)], -1)


# --------------------------------------------------------------------------
# MROGH (mroghdesc.hpp): multi-support-region rotation-invariant order
# histograms.  Per support region: gradients in the local radial /
# tangential frame, pixels grouped by intensity order, an orientation
# histogram per group.  Supports are nested crops of the patch.

def _mrogh_one_support(patch: torch.Tensor, n_groups: int,
                       n_ori: int) -> torch.Tensor:
    K, P, _ = patch.shape
    gx, gy = patch_gradient(patch)
    c = (P - 1) / 2.0
    yy, xx = np.mgrid[0:P, 0:P]
    dx = xx.astype(np.float32) - np.float32(c)
    dy = yy.astype(np.float32) - np.float32(c)
    rr = np.sqrt(dx * dx + dy * dy)
    inside = rr <= c
    ur_x = const(dx / np.maximum(rr, np.float32(1e-6)), patch)
    ur_y = const(dy / np.maximum(rr, np.float32(1e-6)), patch)
    gr = gx * ur_x[None] + gy * ur_y[None]
    gt = -gx * ur_y[None] + gy * ur_x[None]
    mag = torch.sqrt(gr * gr + gt * gt)
    ang = torch.atan2(gt, gr)             # rotation-invariant angle
    o = (ang + math.pi) * n_ori / (2 * math.pi)
    ob = torch.clamp(o.to(torch.int64), 0, n_ori - 1)
    gid = _order_bins(patch, inside, n_groups)
    w = (mag * const(inside, patch)[None]).reshape(K, -1)
    return _hist2(gid.reshape(K, -1), n_groups, ob.reshape(K, -1), n_ori, w)


def mrogh_descriptor(patches: torch.Tensor, n_groups: int = 6,
                     n_ori: int = 8,
                     supports: tuple = (41, 31, 21)) -> torch.Tensor:
    """(K, P, P) -> (K, len(supports)*n_groups*n_ori) MROGH."""
    P = patches.shape[-1]
    outs = []
    for sup in supports:
        off = (P - sup) // 2
        outs.append(_mrogh_one_support(
            patches[:, off:off + sup, off:off + sup], n_groups, n_ori))
    return _l2_normalize(torch.cat(outs, -1))


# --------------------------------------------------------------------------
# FREAK / BRISK binary pattern descriptors: deterministic retinal /
# concentric sampling patterns (the JAX package's, not OpenCV's learned
# tables), receptive-field means, pair comparisons.  The pair lists come
# from ``np.argsort`` over distances with exact ties, numpy's default
# (unstable) sort as the JAX package calls it: ``pattern_sha256`` names
# the tables so that two machines can be held to each other.

@functools.lru_cache(maxsize=8)
def _freak_pattern(P: int, scale: float = 1.0):
    """43 receptive fields: centre + 6 rings of 7, radius and field size
    shrinking toward the centre.  ``scale`` stretches the ring radii (the
    reference's patternScale/22, GetFREAKPars)."""
    pts = [(0.0, 0.0, 0.8)]
    n_rings = 6
    for ri in range(n_rings):
        rad = (P / 2.0 - 2.0) * (0.9 ** ri) * (ri + 2) / (n_rings + 1)
        rad = min(rad * scale, P / 2.0 - 1.0)
        sig = max(0.6, rad * 0.35)
        for k in range(7):
            a = 2 * np.pi * k / 7 + (np.pi / 7) * (ri % 2)
            pts.append((rad * np.cos(a), rad * np.sin(a), sig))
    arr = np.asarray(pts, np.float32)
    # pairs: all C(43,2) sorted by field distance descending, top 512
    n = len(arr)
    iu, ju = np.triu_indices(n, 1)
    d = np.hypot(arr[iu, 0] - arr[ju, 0], arr[iu, 1] - arr[ju, 1])
    order = np.argsort(-d)[:512]
    return arr, iu[order].astype(np.int32), ju[order].astype(np.int32)


@functools.lru_cache(maxsize=8)
def _brisk_pattern(P: int, scale: float = 1.0):
    """BRISK concentric pattern: centre + rings of (10, 14, 15, 20)
    points; short-distance pairs -> 512 bits.  ``scale`` is the
    reference's patternScale (GetBRISKPars)."""
    pts = [(0.0, 0.0, 0.8)]
    ring_n = (10, 14, 15, 20)
    for ri, n_k in enumerate(ring_n):
        rad = (P / 2.0 - 2.0) * (ri + 1) / (len(ring_n) + 0.5)
        rad = min(rad * scale, P / 2.0 - 1.0)
        sig = max(0.6, rad * 0.25)
        for k in range(n_k):
            a = 2 * np.pi * k / n_k
            pts.append((rad * np.cos(a), rad * np.sin(a), sig))
    arr = np.asarray(pts, np.float32)
    n = len(arr)
    iu, ju = np.triu_indices(n, 1)
    d = np.hypot(arr[iu, 0] - arr[ju, 0], arr[iu, 1] - arr[ju, 1])
    order = np.argsort(d)[:512]              # short-distance pairs
    return arr, iu[order].astype(np.int32), ju[order].astype(np.int32)


def pattern_sha256(pattern) -> str:
    """SHA-256 of a pattern's (fields, pair i, pair j) tables."""
    import hashlib
    h = hashlib.sha256()
    for a in pattern:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@functools.lru_cache(maxsize=8)
def _field_taps(pattern_fn, P: int, scale: float) -> _Taps:
    """The 5 reads of every receptive field (centre and 4 offsets at its
    sigma, a separable approximation of the Gaussian field): (5, n)."""
    arr, _, _ = pattern_fn(P, scale)
    c = (P - 1) / 2.0
    offs = np.asarray([(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1)],
                      np.float32)
    xs = c + arr[None, :, 0] + offs[:, None, 0] * arr[None, :, 2]
    ys = c + arr[None, :, 1] + offs[:, None, 1] * arr[None, :, 2]
    return _Taps(xs, ys, P)


def field_means(patches: torch.Tensor, pattern_fn, scale: float):
    """(K, P, P) -> (K, n_fields) receptive-field means."""
    K, P, _ = patches.shape
    v = _field_taps(pattern_fn, P, float(scale)).read(
        patches.reshape(K, -1))                       # (K, 5, n)
    return torch.mean(v, 1)


def _pair_means(patches: torch.Tensor, pattern_fn, scale: float):
    """The two receptive-field means of every pair, (K, 512) each."""
    _, pi, pj = pattern_fn(patches.shape[-1], float(scale))
    means = field_means(patches, pattern_fn, scale)
    dev = patches.device
    return (means[:, torch.as_tensor(pi, device=dev).long()],
            means[:, torch.as_tensor(pj, device=dev).long()])


def freak_descriptor(patches: torch.Tensor,
                     pattern_scale: float = 22.0) -> torch.Tensor:
    a, b = _pair_means(patches, _freak_pattern, pattern_scale / 22.0)
    return (a < b).to(torch.float32)


def brisk_descriptor(patches: torch.Tensor,
                     pattern_scale: float = 1.0) -> torch.Tensor:
    a, b = _pair_means(patches, _brisk_pattern, pattern_scale)
    return (a < b).to(torch.float32)


def pixels_descriptor(patches: torch.Tensor,
                      norm_type: str = "L2") -> torch.Tensor:
    """(K, P, P) -> (K, P*P) the raw patch, L1- or L2-normalized
    (descriptors/pixelsdesc.hpp)."""
    flat = patches.reshape(patches.shape[0], -1)
    if norm_type == "L1":
        nrm = torch.sum(flat.abs(), -1, keepdim=True)
    else:
        nrm = torch.sqrt(torch.sum(flat * flat, -1, keepdim=True))
    return flat / torch.clamp(nrm, min=1e-6)


def bit_margins(name: str, patches: torch.Tensor,
                **params) -> torch.Tensor:
    """|a - b| of the two values each bit of the binary families (MLDB,
    FREAK, BRISK) compares, (K, D): where it is at the rounding level a
    bit may flip with the summation order of a product."""
    if name == "MLDB":
        return torch.cat([(a - b).abs() for a, b in _cell_pairs(
            patches, params.get("grids", (2, 3, 4)))], -1)
    fn, scale = ((_freak_pattern, params.get("pattern_scale", 22.0) / 22.0)
                 if name == "FREAK" else
                 (_brisk_pattern, params.get("pattern_scale", 1.0)))
    a, b = _pair_means(patches, fn, scale)
    return (a - b).abs()


PATCH_FNS = {
    "SURF": surf_descriptor,
    "LIOP": liop_descriptor,
    "DAISY": daisy_descriptor,
    "SSIM": ssim_descriptor,
    "KAZE": surf_descriptor,     # M-SURF on the normalized patch
    "MLDB": mldb_descriptor,
    "FREAK": freak_descriptor,
    "BRISK": brisk_descriptor,
    "MROGH": mrogh_descriptor,
}

PATCH_DIMS = {
    "SURF": 64,
    "LIOP": _LIOP_BINS * math.factorial(_LIOP_NEIGHBORS),
    "DAISY": (1 + 3 * 8) * 8,
    "SSIM": 4 * 10,
    "KAZE": 64,
    "MLDB": sum(3 * (g * g) * (g * g - 1) // 2 for g in (2, 3, 4)),
    "FREAK": 512,
    "BRISK": 512,
    "MROGH": 3 * 6 * 8,
}
