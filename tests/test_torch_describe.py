"""Port vs JAX reference: dominant orientation, mip-stack descriptor
patches and SIFT (CPU, small batches).

Tolerances, stated per check: histogram and patch values are float32
sums in another order (relative 1e-4 on histograms; 1e-3 on 0..255
patches that pass through the sampler and a 2-D blur, 1e-2 after
photometric normalization, 2e-3 for the blur and normalization alone).
Quantized SIFT entries floor(512 v + 0.5) may flip by 1 when v sits on a
rounding edge: at most 1 apart, in at most 0.5 % of the values.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import ndimage

from mods_tpu.config import SIFTDescriptorParams
from mods_tpu.descriptors import describe as jd
from mods_tpu.descriptors import orientation as jo
from mods_tpu.descriptors import sift as js
from mods_tpu.ops import sampler as jsam
from mods_tpu_torch import config as tc
from mods_tpu_torch.descriptors import describe as td
from mods_tpu_torch.descriptors import orientation as to
from mods_tpu_torch.descriptors import sift as ts
from mods_tpu_torch.ops import sampler as tsam

torch.set_num_threads(2)


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    return ndimage.gaussian_filter(rng.uniform(0, 255, (h, w)),
                                   1.5).astype(np.float32)


def _patches(seed, k, P):
    rng = np.random.default_rng(seed)
    p = ndimage.gaussian_filter(rng.uniform(0, 255, (k, P, P)),
                                (0, 1.2, 1.2))
    return p.astype(np.float32)


def _regions(seed, k, h, w):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(0, w, k), rng.uniform(0, h, k)],
                  -1).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, k)
    an = rng.uniform(0.7, 1.4, k)
    R = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                  np.stack([np.sin(th), np.cos(th)], -1)], -2)
    A = R @ np.stack([np.diag([a, 1 / a]) for a in an])
    s = rng.uniform(1.5, 12.0, k).astype(np.float32)
    return xy, A.astype(np.float32), s


def test_orientation_histogram_peaks_rotate():
    pt = _patches(0, 48, 41)
    jh = np.array(jo.smooth_circular(jo.orientation_histograms(
        jnp.asarray(pt))))
    thh = to.smooth_circular(to.orientation_histograms(
        torch.from_numpy(pt))).numpy()
    np.testing.assert_allclose(thh, jh, rtol=1e-4, atol=1e-3 * jh.max())
    # peaks from the SAME histograms: exact bins, float angles
    for M in (1, 2, 4):
        ja, jm = jo.find_peaks(jnp.asarray(jh), M, 0.8)
        ta, tm = to.find_peaks(torch.from_numpy(jh), M, 0.8)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    A = np.random.default_rng(1).normal(size=(48, 2, 2)).astype(np.float32)
    np.testing.assert_allclose(
        to.rotate_shapes(torch.from_numpy(A), ta).numpy(),
        np.asarray(jo.rotate_shapes(jnp.asarray(A), ja)), atol=1e-5)


def test_detect_orientations_mip():
    img = _image(2, 160, 200)
    xy, A, s = _regions(3, 64, 160, 200)
    valid = np.random.default_rng(4).uniform(size=64) < 0.9
    jm = jsam.mip_stack(jnp.asarray(img), jd.DESC_MIP_LEVELS)
    tm = tsam.mip_stack(torch.from_numpy(img), td.DESC_MIP_LEVELS)
    ja, jmask = jax.jit(lambda *a: jo.detect_orientations(
        *a, 5.1962, 41, 2, 0.8, mip_src=jm))(
        *(jnp.asarray(x) for x in (img, xy, A, s, valid)))
    ta, tmask = to.detect_orientations(
        *(torch.from_numpy(x) for x in (img, xy, A, s, valid)),
        5.1962, 41, 2, 0.8, mip_src=tm)
    jmask, tmask = np.asarray(jmask), tmask.numpy()
    assert jmask.sum() > 20
    # a secondary peak sitting at 0.8 x max may flip: one slot at most
    assert (jmask != tmask).sum() <= 1
    both = jmask & tmask
    np.testing.assert_allclose(ta.numpy()[both], np.asarray(ja)[both],
                               atol=1e-3)


# photometric normalization rescales each patch by 50 / std, up to ~10x
# on low-contrast patches, so its tolerance is 10x the raw patches'
@pytest.mark.parametrize("photo_norm,atol", [(False, 1e-3), (True, 1e-2)])
def test_descriptor_patches_mip(photo_norm, atol):
    img = _image(5, 160, 200)
    xy, A, s = _regions(6, 64, 160, 200)
    s[:8] = 0.3                     # t <= 0.4: the direct, unblurred path
    jm = jsam.mip_stack(jnp.asarray(img), jd.DESC_MIP_LEVELS)
    tm = tsam.mip_stack(torch.from_numpy(img), td.DESC_MIP_LEVELS)
    ref = np.asarray(jax.jit(lambda *a: jd.extract_descriptor_patches_mip(
        *jm, *a, 5.1962, 41, photo_norm=photo_norm))(
        *(jnp.asarray(x) for x in (xy, A, s))))
    got = td.extract_descriptor_patches_mip(
        *tm, *(torch.from_numpy(x) for x in (xy, A, s)), 5.1962, 41,
        photo_norm=photo_norm).numpy()
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    np.testing.assert_array_equal(
        td.image_to_patch_scale(torch.from_numpy(s), 5.1962, 41).numpy(),
        np.asarray(jd.image_to_patch_scale(jnp.asarray(s), 5.1962, 41)))


def _sift_compare(got, ref):
    d = np.abs(got - ref)
    assert d.max() <= 1.0
    assert (d > 0).mean() <= 0.005


@pytest.mark.parametrize("root,half", [(True, False), (False, False),
                                       (True, True)])
def test_compute_sift(root, half):
    pt = _patches(7, 96, 41)
    p = SIFTDescriptorParams(root_sift=root, half_sift=half)
    tp = tc.from_dict(dataclasses.asdict(p), tc.SIFTDescriptorParams)
    ref = np.asarray(js.compute_sift(jnp.asarray(pt), p))
    got = ts.compute_sift(torch.from_numpy(pt), tp).numpy()
    assert got.shape == ref.shape == (96, p.dim)
    _sift_compare(got, ref)
    np.testing.assert_array_equal(ts.spatial_bin_weights(41, 4),
                                  js.spatial_bin_weights(41, 4))


def test_aa_filter_and_photometric():
    pt = _patches(8, 40, 41)
    rng = np.random.default_rng(9)
    lvl = rng.integers(0, 3, 40)
    t = rng.uniform(0.2, 3.0, 40).astype(np.float32)
    ref = np.asarray(jd.aa_filter_patches(jnp.asarray(pt), jnp.asarray(lvl),
                                          jnp.asarray(t), photo_norm=True))
    got = td.aa_filter_patches(torch.from_numpy(pt), torch.from_numpy(lvl),
                               torch.from_numpy(t), photo_norm=True).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-3, rtol=0)
