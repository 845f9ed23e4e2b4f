"""Port vs JAX reference: pyramid, NMS, candidates, localization,
Baumberg and the assembled HessianAffine detector (CPU, small images).

Stages that consume the other package's exact inputs (NMS, candidate
extraction) must agree exactly.  Float stages are held to tolerances
relative to their dynamic range, stated per test: XLA and PyTorch sum
convolutions and reductions in other orders, so values differ in the
last bits, and a threshold decision on such a value can flip.  Region
sets are compared after sorting by (|response|, x, y), never slot by
slot.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import ndimage

from mods_tpu.config import (AffineShapeParams, CapacityParams,
                             DetectionMode, PyramidParams)
from mods_tpu.detectors import baumberg as jb
from mods_tpu.detectors import hessaff as jh
from mods_tpu.detectors import scale_space as jss
from mods_tpu import regions as jr
from mods_tpu_torch import config as tc
from mods_tpu_torch.detectors import baumberg as tb
from mods_tpu_torch.detectors import hessaff as th
from mods_tpu_torch.detectors import scale_space as tss
from mods_tpu_torch import regions as tr

torch.set_num_threads(2)


def _texture(seed, h, w):
    rng = np.random.default_rng(seed)
    base = np.kron(rng.uniform(0, 255, (h // 8 + 1, w // 8 + 1)),
                   np.ones((8, 8)))[:h, :w]
    img = ndimage.gaussian_filter(base, 1.0) + rng.normal(0, 2, (h, w))
    return np.clip(img, 0, 255).astype(np.float32)


def _port(p):
    """The port's counterpart of a JAX-side parameter dataclass."""
    return tc.from_dict(dataclasses.asdict(p), getattr(tc, type(p).__name__))


def test_pyramid_and_responses():
    img = _texture(0, 96, 128)[None]
    p = PyramidParams()
    jo = jss.build_pyramid(jnp.asarray(img), p)
    to = tss.build_pyramid(torch.from_numpy(img), _port(p))
    assert len(jo) == len(to) == tss.num_octaves(96, 128)
    for a, b in zip(jo, to):
        assert a.sigmas == b.sigmas and a.pixel_distance == b.pixel_distance
        # blurs: float32 convolutions in another order, 1e-3 on 0..255
        np.testing.assert_allclose(b.blurs.numpy(), np.asarray(a.blurs),
                                   atol=1e-3, rtol=0)
        # responses are sigma^4-scaled second-derivative products: 1e-4 of
        # their range
        rng_ = float(np.abs(np.asarray(a.resps)).max())
        np.testing.assert_allclose(b.resps.numpy(), np.asarray(a.resps),
                                   atol=1e-4 * rng_, rtol=0)


def test_nms_candidates_localize():
    img = _texture(1, 96, 128)[None]
    p = PyramidParams()
    octv = jss.build_pyramid(jnp.asarray(img), p)[0]
    resps = np.array(octv.resps)
    blurs = np.array(octv.blurs)
    pos = 0.8 * p.threshold
    jm = np.array(jss._nms_mask(jnp.asarray(resps), pos, -pos))
    tm = tss._nms_mask(torch.from_numpy(resps), pos, -pos).numpy()
    np.testing.assert_array_equal(tm, jm)           # same input: exact

    jl, jr_, jc, jv = jss.candidate_indices(jnp.asarray(jm[0]), 5, 128, 90,
                                            256)
    tl, tr_, tcc, tv = tss.candidate_indices(torch.from_numpy(jm[0]), 5,
                                             128, 90, 256)
    for a, b in ((jl, tl), (jr_, tr_), (jc, tcc), (jv, tv)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))

    fin = p.threshold ** 2
    jloc = jss.localize_keypoints(jnp.asarray(resps[0]),
                                  jnp.asarray(blurs[0]), jl, jr_, jc, jv,
                                  p, fin, p.detector_type)
    tloc = tss.localize_keypoints(torch.from_numpy(resps[0]),
                                  torch.from_numpy(blurs[0]), tl, tr_, tcc,
                                  tv, _port(p), fin, p.detector_type)
    jok = np.asarray(jloc["ok"])
    tok = tloc["ok"].numpy()
    assert jok.sum() > 20
    # the Newton fields divide by small determinants: decisions may flip
    # on a candidate or two; positions and offsets agree where both keep
    assert (jok != tok).sum() <= max(2, jok.sum() // 50)
    both = jok & tok
    np.testing.assert_array_equal(tloc["r"].numpy()[both],
                                  np.asarray(jloc["r"])[both])
    np.testing.assert_array_equal(tloc["c"].numpy()[both],
                                  np.asarray(jloc["c"])[both])
    np.testing.assert_allclose(tloc["b"].numpy()[both],
                               np.asarray(jloc["b"])[both], atol=1e-3)
    np.testing.assert_array_equal(tloc["sub_type"].numpy()[both],
                                  np.asarray(jloc["sub_type"])[both])


def test_inv_sqrt_and_eigenvalues():
    rng = np.random.default_rng(2)
    M = rng.normal(size=(200, 2, 2))
    S = (M @ M.transpose(0, 2, 1) + 0.1 * np.eye(2)).astype(np.float32)
    a, b, c = S[:, 0, 0], S[:, 0, 1], S[:, 1, 1]
    b[:5] = 0.0                                     # the b == 0 branch
    ref = jb.inv_sqrt_2x2(*(jnp.asarray(x) for x in (a, b, c)))
    got = tb.inv_sqrt_2x2(*(torch.from_numpy(x) for x in (a, b, c)))
    for x, y in zip(got, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-6)
    G = rng.normal(size=(4, 200)).astype(np.float32)
    ref = jb.eigenvalues_2x2(*(jnp.asarray(x) for x in G))
    got = tb.eigenvalues_2x2(*(torch.from_numpy(x) for x in G))
    for x, y in zip(got, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5)


def test_baumberg_adapt_same_inputs():
    img = _texture(3, 128, 160)[None]
    p = PyramidParams()
    octv = jss.build_pyramid(jnp.asarray(img), p)[0]
    blurs = np.array(octv.blurs[0])
    rng = np.random.default_rng(4)
    K = 96
    xy = np.stack([rng.uniform(10, 150, K), rng.uniform(10, 118, K)],
                  -1).astype(np.float32)
    s = rng.uniform(1.6, 6.0, K).astype(np.float32)
    lvl = rng.integers(0, 4, K).astype(np.int32)
    valid = rng.uniform(size=K) < 0.9
    aff = AffineShapeParams()
    jA, jok = jax.jit(lambda *a: jb.baumberg_adapt(*a, aff))(
        *(jnp.asarray(x) for x in (blurs, lvl, xy, s, valid)))
    tA, tok = tb.baumberg_adapt(*(torch.from_numpy(x) for x in
                                  (blurs, lvl, xy, s, valid)),
                                _port(aff))
    jok, tok = np.asarray(jok), tok.numpy()
    assert jok.sum() > K // 3
    # 16 iterations feed each SMM back into the sampler: 1e-3 on the
    # unit-det shape; convergence near the 0.05 threshold may flip one
    assert (jok != tok).sum() <= 2
    both = jok & tok
    np.testing.assert_allclose(tA.numpy()[both], np.asarray(jA)[both],
                               atol=1e-3)


def _sorted_regions(xy, A, s, resp, mask):
    xy, A, s, resp = (np.asarray(x)[np.asarray(mask)] for x in
                      (xy, A, s, resp))
    order = np.lexsort((xy[:, 1], xy[:, 0], -np.abs(resp)))
    return xy[order], A[order], s[order], resp[order]


def test_detect_affine_keypoints():
    img = _texture(5, 160, 192)[None]
    hw = np.asarray([[150, 180]], np.int32)         # a padded view
    p = PyramidParams()
    aff = AffineShapeParams()
    caps = CapacityParams(per_octave=512, per_view=256)
    ref = jax.jit(lambda i, v: jh.detect_affine_keypoints(
        i, v, p, aff, caps))(jnp.asarray(img), jnp.asarray(hw))
    got = th.detect_affine_keypoints(
        torch.from_numpy(img), torch.from_numpy(hw), _port(p), _port(aff),
        _port(caps))
    jx, jA, js, jresp = _sorted_regions(ref.xy[0], ref.A[0], ref.s[0],
                                        ref.response[0], ref.mask[0])
    tx, tA, ts, tresp = _sorted_regions(got.xy[0], got.A[0], got.s[0],
                                        got.response[0], got.mask[0])
    assert len(jx) > 40
    # a region or two may flip at a threshold (see module docstring)
    assert abs(len(jx) - len(tx)) <= max(2, len(jx) // 50)
    # match by position; all but a few must agree in shape and scale
    d = np.abs(jx[:, None] - tx[None]).max(-1)
    near = d.min(1) < 1e-2
    assert near.mean() >= 0.95
    j = d.argmin(1)[near]
    np.testing.assert_allclose(tA[j], jA[near], atol=2e-3)
    # scale = sigma * 2^(subscale offset / L): the Newton offset carries
    # the responses' rounding, ~1e-4 relative
    np.testing.assert_allclose(ts[j], js[near], rtol=5e-4)
    np.testing.assert_allclose(tresp[j], jresp[near], rtol=1e-3)


@pytest.mark.parametrize("mode", [DetectionMode.FIXED_REG_NUMBER,
                                  DetectionMode.RELATIVE_TH,
                                  DetectionMode.RELATIVE_REG_NUMBER,
                                  DetectionMode.NOT_LESS_THAN_REGIONS])
def test_apply_detection_mode(mode):
    rng = np.random.default_rng(6)
    shape = (2, 30)
    d = dict(xy=rng.uniform(0, 99, shape + (2,)).astype(np.float32),
             A=rng.normal(size=shape + (2, 2)).astype(np.float32),
             s=rng.uniform(1, 4, shape).astype(np.float32),
             response=rng.normal(0, 20, shape).astype(np.float32),
             sub_type=rng.integers(0, 3, shape).astype(np.int32),
             mask=rng.uniform(size=shape) < 0.7)
    p = PyramidParams(detector_mode=mode, reg_number=7, rel_threshold=0.3,
                      rel_reg_number=0.5)
    ref = jh.apply_detection_mode(
        jr.Regions(**{k: jnp.asarray(v) for k, v in d.items()}), p, 16)
    got = th.apply_detection_mode(
        tr.Regions(**{k: torch.from_numpy(v) for k, v in d.items()}),
        _port(p), 16)
    for f in ("xy", "A", "s", "response", "sub_type", "mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    assert th._thresholds(_port(p)) == jh._thresholds(p)
