"""Port vs JAX reference: image ops, Gaussian blur, bilinear gathers,
fixed-size selections and the Regions container (CPU, small shapes).

Inputs are made with numpy from a seed and fed to both packages.
Tolerances: exact where both sides do the same float32 operations in the
same order; 1e-3 absolute on 0..255 images where the summation order of
a convolution or a gather-combine differs between XLA and PyTorch.
"""

import numpy as np
import jax.numpy as jnp
import jax
import pytest
import torch

from mods_tpu.ops import gaussian as jg
from mods_tpu.ops import image as ji
from mods_tpu.ops import warp as jw
from mods_tpu import regions as jr
from mods_tpu_torch.ops import gaussian as tg
from mods_tpu_torch.ops import image as ti
from mods_tpu_torch.ops import select as tsel
from mods_tpu_torch.ops import warp as tw
from mods_tpu_torch import regions as tr

torch.set_num_threads(2)


def _img(seed, h, w, lead=()):
    return np.random.default_rng(seed).uniform(
        0, 255, lead + (h, w)).astype(np.float32)


@pytest.mark.parametrize("sigma", [0.5, 1.2, 1.6, 2.7, 4.1])
def test_gauss_taps_and_band_matrix(sigma):
    # the host-side taps are the same numpy code: bit-identical
    np.testing.assert_array_equal(tg.gauss_kernel_1d(sigma),
                                  jg.gauss_kernel_1d(sigma))
    np.testing.assert_array_equal(tg.blur_band_matrix(23, sigma),
                                  jg.blur_band_matrix(23, sigma))


@pytest.mark.parametrize("sigma,sigma_y", [(1.6, None), (0.9, 2.3)])
def test_gaussian_blur(sigma, sigma_y):
    x = _img(1, 37, 53, (2,))
    ref = np.asarray(jg.gaussian_blur(jnp.asarray(x), sigma, sigma_y))
    got = tg.gaussian_blur(torch.from_numpy(x), sigma, sigma_y).numpy()
    # float32 convolutions, summation order differs: 1e-3 on 0..255
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_half_image_gradients_masks():
    x = _img(2, 31, 44, (3,))
    # 2x2 mean: the four adds run in another order, one ulp at 255
    np.testing.assert_allclose(
        ti.half_image(torch.from_numpy(x)).numpy(),
        np.asarray(ji.half_image(jnp.asarray(x))), atol=1e-4, rtol=0)
    for tf, jf in ((ti.gradient, ji.gradient),
                   (ti.patch_gradient, ji.patch_gradient)):
        for a, b in zip(tf(torch.from_numpy(x)), jf(jnp.asarray(x))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for size in (19, 41):
        np.testing.assert_array_equal(ti.circular_gauss_mask(size, 4.0),
                                      ji.circular_gauss_mask(size, 4.0))
        np.testing.assert_array_equal(ti.gauss_mask(size),
                                      ji.gauss_mask(size))


def _regions(seed, k, h, w, max_scale):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(-5, w + 5, k), rng.uniform(-5, h + 5, k)],
                  -1).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, k)
    sc = rng.uniform(0.3, max_scale, k)
    R = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                  np.stack([np.sin(th), np.cos(th)], -1)], -2)
    return xy, (R * sc[:, None, None]).astype(np.float32)


def test_bilinear_and_extract_patches():
    img = _img(3, 60, 80)
    xy, A = _regions(4, 32, 60, 80, 2.0)
    ref = np.asarray(jw.extract_patches(jnp.asarray(img), jnp.asarray(xy),
                                        jnp.asarray(A), 15, fill=3.0))
    got = tw.extract_patches(torch.from_numpy(img), torch.from_numpy(xy),
                             torch.from_numpy(A), 15, fill=3.0).numpy()
    # same 4-tap combine; coordinates from a 2-term einsum: 1e-3
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    np.testing.assert_array_equal(tw.patch_grid(7).numpy(),
                                  np.asarray(jw.patch_grid(7)))


def test_gather_4plane_level():
    vol = _img(5, 20, 30, (3,))
    rng = np.random.default_rng(6)
    y0 = rng.integers(-3, 23, 50)
    x0 = rng.integers(-3, 33, 50)
    lvl = rng.integers(0, 3, 50)
    ref = jw.gather_4plane_level(jnp.asarray(vol), jnp.asarray(lvl),
                                 jnp.asarray(y0), jnp.asarray(x0))
    got = tw.gather_4plane_level(torch.from_numpy(vol), torch.from_numpy(lvl),
                                 torch.from_numpy(y0), torch.from_numpy(x0))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("clamp", [None, 0.2])
def test_touches_border(clamp):
    xy, A = _regions(7, 64, 90, 120, 3.0)
    s = np.random.default_rng(8).uniform(1, 9, 64).astype(np.float32)
    ref = jw.touches_border(120, 90, jnp.asarray(xy), jnp.asarray(A),
                            jnp.asarray(s * 2.5), jnp.asarray(s * 2.5),
                            clamp_frac=clamp)
    got = tw.touches_border(120, 90, torch.from_numpy(xy),
                            torch.from_numpy(A), torch.from_numpy(s * 2.5),
                            torch.from_numpy(s * 2.5), clamp_frac=clamp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_top_k_tie_order():
    # many ties, including -inf: lax.top_k takes the lower index first
    rng = np.random.default_rng(9)
    key = rng.integers(0, 4, (5, 40)).astype(np.float32)
    key[key == 0] = -np.inf
    jv, ji_ = jax.lax.top_k(jnp.asarray(key), 17)
    tv, ti_ = tsel.top_k(torch.from_numpy(key), 17)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti_.numpy(), np.asarray(ji_))


@pytest.mark.parametrize("density,size", [(0.1, 16), (0.1, 400), (0.0, 8)])
def test_nonzero_static(density, size):
    m = np.random.default_rng(10).uniform(size=300) < density
    (ref,) = jnp.nonzero(jnp.asarray(m), size=size, fill_value=0)
    idx, valid = tsel.nonzero_static(torch.from_numpy(m), size)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))
    assert valid.sum().item() == min(m.sum(), size)


def _jax_regions(d):
    return jr.Regions(**{k: jnp.asarray(v) for k, v in d.items()})


def _torch_regions(d):
    return tr.Regions(**{k: torch.from_numpy(v) for k, v in d.items()})


def _region_arrays(seed, shape):
    rng = np.random.default_rng(seed)
    resp = rng.integers(-5, 6, shape).astype(np.float32)   # ties
    return dict(
        xy=rng.uniform(0, 100, shape + (2,)).astype(np.float32),
        A=rng.normal(size=shape + (2, 2)).astype(np.float32),
        s=rng.uniform(1, 5, shape).astype(np.float32),
        response=resp, sub_type=rng.integers(0, 3, shape).astype(np.int32),
        mask=rng.uniform(size=shape) < 0.6)


@pytest.mark.parametrize("by,k", [("response", 9), ("mask", 9),
                                  ("response", 40)])
def test_compact_topk_and_concat(by, k):
    a = _region_arrays(11, (2, 20))
    b = _region_arrays(12, (2, 13))
    ref = jr.compact_topk(jr.concat_regions(
        [_jax_regions(a), _jax_regions(b)]), k, by=by)
    got = tr.compact_topk(tr.concat_regions(
        [_torch_regions(a), _torch_regions(b)]), k, by=by)
    for f in ("xy", "A", "s", "response", "sub_type", "mask"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))
