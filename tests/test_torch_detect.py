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
from mods_tpu_torch.ops import sampler as tb_sampler
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


def _smm_case(seed, K, s_lo, s_hi, edge):
    """An octave blur stack and K keypoints with scales log-uniform in
    [s_lo, s_hi];
    ``edge``: every third keypoint lies within 45 px of the canvas edge."""
    img = _texture(seed, 200, 300)[None]
    octv = jss.build_pyramid(jnp.asarray(img), PyramidParams())[0]
    blurs = np.array(octv.blurs[0])
    rng = np.random.default_rng(seed + 1)
    xy = np.stack([rng.uniform(50, 250, K), rng.uniform(50, 150, K)],
                  -1).astype(np.float32)
    if edge:
        side = rng.integers(0, 4, K)
        d = rng.uniform(1, 45, K).astype(np.float32)
        near = np.stack([np.where(side == 0, d, np.where(side == 1, 300 - d,
                                                         xy[:, 0])),
                         np.where(side == 2, d, np.where(side == 3, 200 - d,
                                                         xy[:, 1]))], -1)
        xy[::3] = near[::3]
    s = np.exp(rng.uniform(np.log(s_lo), np.log(s_hi), K)).astype(np.float32)
    lvl = rng.integers(0, 4, K).astype(np.int32)
    valid = rng.uniform(size=K) < 0.9
    return blurs, lvl, xy, s, valid


def test_baumberg_adapt_decimated_and_edges():
    """Keypoints large enough to read the 2x-decimated copy of the stack
    (s up to 20), a third of them within 45 px of the canvas edge."""
    blurs, lvl, xy, s, valid = _smm_case(11, 96, 1.6, 20.0, edge=True)
    aff = AffineShapeParams()
    max_norm = np.sqrt(6.0) * s / aff.initial_sigma
    use_half = max_norm * 9 * 1.4143 > 42.0
    assert min(use_half.sum(), (~use_half).sum()) >= 5    # both branches
    jA, jok = jax.jit(lambda *a: jb.baumberg_adapt(*a, aff))(
        *(jnp.asarray(x) for x in (blurs, lvl, xy, s, valid)))
    tA, tok = tb.baumberg_adapt(*(torch.from_numpy(x) for x in
                                  (blurs, lvl, xy, s, valid)),
                                _port(aff))
    jok, tok = np.asarray(jok), tok.numpy()
    assert jok.sum() > 10 and (jok & use_half).sum() > 3
    # as test_baumberg_adapt_same_inputs: 1e-3 on the unit-det shape;
    # convergence near the 0.05 threshold may flip one
    assert (jok != tok).sum() <= 2
    both = jok & tok
    np.testing.assert_allclose(tA.numpy()[both], np.asarray(jA)[both],
                               atol=1e-3)


def test_baumberg_early_exit_equals_plain():
    """A per-keypoint loop that stops at the first iteration its keypoint
    fails or converges gives ``baumberg_adapt_plain``'s result bit for
    bit: ``done`` is absorbing.  The fused kernel relies on this."""
    blurs, lvl, xy, s, valid = (torch.from_numpy(x) for x in
                                _smm_case(12, 64, 1.6, 8.0, edge=True))
    aff = _port(AffineShapeParams())
    ru, rok = tb.baumberg_adapt_plain(blurs, lvl, xy, s, valid, aff)
    big, lvl_eff, xy_eff, inv_scale, ratio, mask = tb._smm_inputs(
        blurs, lvl, xy, s, aff)
    ws = tb._prepare_smm_windows(big, lvl_eff, xy_eff)
    npix = float(mask.numel())
    iters = []
    for k in range(xy.shape[0]):
        w1 = tb.WindowSource(*(getattr(ws, f)[k:k + 1] for f in
                               ("windows", "y0", "x0", "vw", "vh")))
        u = torch.eye(2)[None]
        act = torch.zeros(1)
        conv, it = False, 0
        while bool(valid[k]) and it < aff.max_iterations:
            it += 1
            A = (u * ratio[k]) * inv_scale[k]
            patch = tb.sample_from_windows_plain(w1, xy_eff[k:k + 1], A,
                                                 mask.shape[-1])
            fx, fy = tb.patch_gradient(patch)
            a, b, c = ((g * mask).sum((1, 2)) / npix
                       for g in (fx * fx, fx * fy, fy * fy))
            na, nb, nc, l1s, l2s = tb.inv_sqrt_2x2(a, b, c)
            new_act = 1.0 - l2s / l1s
            nu = torch.stack([
                torch.stack([na * u[:, 0, 0] + nb * u[:, 1, 0],
                             na * u[:, 0, 1] + nb * u[:, 1, 1]], -1),
                torch.stack([nb * u[:, 0, 0] + nc * u[:, 1, 0],
                             nb * u[:, 0, 1] + nc * u[:, 1, 1]], -1)], -2)
            e1, e2, real = tb.eigenvalues_2x2(
                nu[:, 0, 0], nu[:, 0, 1], nu[:, 1, 0], nu[:, 1, 1])
            if (not bool(torch.isfinite(na) & torch.isfinite(nb)
                         & torch.isfinite(nc)) or not bool(real)
                    or bool((e1 / e2 > 6.0) | (e2 / e1 > 6.0))):
                break
            conv = bool((new_act < aff.convergence_threshold)
                        & (act < aff.convergence_threshold))
            u, act = nu, new_act
            if conv:
                break
        iters.append(it)
        assert torch.equal(u[0], ru[k]), k
        assert conv == bool(rok[k]), k
    # the loop really stops early, and at different iterations
    assert 1 < max(iters) and len(set(iters)) > 3
    assert sum(iters) < 0.7 * aff.max_iterations * len(iters)


def test_baumberg_samples_stay_in_window():
    """For every shape of anisotropy <= 6 (the loop fails a keypoint
    beyond it) and the scales the detector yields (the top level's sigma
    is 1.6 * 2^(4/3) < 4.3), each Baumberg sample has its taps inside the
    keypoint's 96 x 128 window or is filled: one window a keypoint serves
    all iterations."""
    blurs, lvl, xy, s, _ = (torch.from_numpy(x) for x in
                            _smm_case(13, 200, 1.6, 4.3, edge=True))
    aff = _port(AffineShapeParams())
    big, lvl_eff, xy_eff, inv_scale, ratio, mask = tb._smm_inputs(
        blurs, lvl, xy, s, aff)
    assert 0 < (inv_scale < 1).sum() < 200
    ws = tb._prepare_smm_windows(big, lvl_eff, xy_eff)
    rng = np.random.default_rng(14)
    K = xy.shape[0]
    th, ph = rng.uniform(0, 2 * np.pi, (2, K))
    for aniso in (1.0, 3.0, 6.0):
        def rot(t):
            return np.stack([np.stack([np.cos(t), -np.sin(t)], -1),
                             np.stack([np.sin(t), np.cos(t)], -1)], -2)
        D = np.zeros((K, 2, 2))
        D[:, 0, 0], D[:, 1, 1] = np.sqrt(aniso), 1.0 / np.sqrt(aniso)
        u = torch.from_numpy((rot(th) @ D @ rot(ph)).astype(np.float32))
        A = (u * ratio[:, None, None]) * inv_scale[:, None, None]
        gx, gy, relx, rely = tb_sampler._sample_coords(ws, xy_eff, A, 19)
        filled = ~((torch.floor(gx) >= 0) & (torch.floor(gy) >= 0)
                   & (torch.floor(gx) < (ws.vw - 1.0)[:, None])
                   & (torch.floor(gy) < (ws.vh - 1.0)[:, None]))
        inside = ((torch.floor(relx) >= 0) & (torch.floor(relx) <= 126)
                  & (torch.floor(rely) >= 0) & (torch.floor(rely) <= 94))
        assert bool((inside | filled).all()), aniso
        assert 0 < int(filled.sum()) < filled.numel() // 2


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
