"""Port vs JAX reference: the window sampler's plain version and the mip
stack (CPU).  The CUDA kernel against its plain version is in
test_torch_kernels.py, which runs on the card without JAX.

Tolerances: 1e-3 absolute (values 0..255) against the JAX default einsum
path, whose index rule the port keeps.  The one-hot matmul and the 4-tap
combine add the same nonzero terms, and XLA's two-term contraction for
the sample coordinates can round one ulp away from the port's products
(3e-5 px at 300 px).  That moves a sample by the image gradient times
3e-5, so the images are smoothed like the pyramid levels the main path
samples (Gaussian, sigma 2): on white noise (255/px) it would be 8e-3.
6e-3 against the Pallas kernel in interpret mode, as
tests/test_sampler.py holds it against the einsum path (tent weights
round differently).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy import ndimage

import mods_tpu.ops.sampler as JS
import mods_tpu_torch.ops.sampler as TS

torch.set_num_threads(2)


def _regions(rng, k, h, w, max_scale):
    xy = np.stack([rng.uniform(0, w, k), rng.uniform(0, h, k)],
                  -1).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, k)
    sc = rng.uniform(0.2, max_scale, k)
    shear = rng.uniform(0.7, 1.4, k)
    R = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                  np.stack([np.sin(th), np.cos(th)], -1)], -2)
    S = np.zeros((k, 2, 2), np.float32)
    S[:, 0, 0] = sc * shear
    S[:, 1, 1] = sc / shear
    return xy, (R @ S).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("P,h,w,fill", [(21, 160, 300, 0.0),
                                        (19, 136, 256, 7.5),
                                        (41, 200, 320, 0.0)])
def test_sample_affine_patches_matches_einsum(P, h, w, fill):
    rng = np.random.default_rng(P)
    img = ndimage.gaussian_filter(rng.uniform(0, 255, (2, h, w)),
                                  (0, 2.0, 2.0)).astype(np.float32)
    canvas = np.asarray(JS.pad_canvas(jnp.asarray(img)))
    k = 64
    # centers spread past the borders so fill positions are exercised
    xy, A = _regions(rng, k, h, w, max_scale=1.4)
    xy[:4] = [[1.0, 1.0], [w - 2.0, h - 2.0], [-30.0, 50.0], [w + 3, 9]]
    lvl = rng.integers(0, 2, k).astype(np.int32)
    vhw = np.asarray([[h, w], [h - 20, w - 33]], np.int32)
    ref = np.asarray(JS.sample_affine_patches(
        jnp.asarray(canvas), jnp.asarray(lvl), jnp.asarray(xy),
        jnp.asarray(A), P, jnp.asarray(vhw), fill=fill, chunk=16))
    got = TS.sample_affine_patches(*_t(canvas, lvl, xy, A), P,
                                   torch.from_numpy(vhw), fill=fill).numpy()
    np.testing.assert_array_equal(got == fill, ref == fill)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


@pytest.mark.parametrize("P", [19, 31, 32, 41])
def test_sample_affine_patches_patch_sizes(P):
    """The patch sizes the engine uses (odd and even), with a NaN center
    and a center outside the canvas among the keypoints."""
    rng = np.random.default_rng(100 + P)
    h, w = 150, 290
    img = ndimage.gaussian_filter(rng.uniform(0, 255, (3, h, w)),
                                  (0, 2.0, 2.0)).astype(np.float32)
    canvas = np.asarray(JS.pad_canvas(jnp.asarray(img)))
    k = 48
    xy, A = _regions(rng, k, h, w, max_scale=1.4)
    xy[:4] = [[np.nan, 40.0], [w + 200.0, h + 50.0], [3.0, h - 1.5],
              [w - 0.5, 2.0]]
    lvl = rng.integers(0, 3, k).astype(np.int32)
    vhw = np.asarray([[h, w], [h - 9, w - 17], [h // 2, w // 2]], np.int32)
    fill = 3.25
    ref = np.asarray(JS.sample_affine_patches(
        jnp.asarray(canvas), jnp.asarray(lvl), jnp.asarray(xy),
        jnp.asarray(A), P, jnp.asarray(vhw), fill=fill, chunk=16))
    got = TS.sample_affine_patches(*_t(canvas, lvl, xy, A), P,
                                   torch.from_numpy(vhw), fill=fill).numpy()
    assert got.shape == (k, P, P)
    assert (got[:2] == fill).all()
    np.testing.assert_array_equal(got == fill, ref == fill)
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)


def test_prepare_windows_identical():
    rng = np.random.default_rng(3)
    src = rng.uniform(0, 255, (3, 144, 384)).astype(np.float32)
    xy = np.stack([rng.uniform(-10, 395, 40), rng.uniform(-10, 150, 40)],
                  -1).astype(np.float32)
    lvl = rng.integers(0, 3, 40).astype(np.int32)
    vhw = np.asarray([[144, 384], [72, 192], [36, 96]], np.int32)
    ref = JS.prepare_windows(jnp.asarray(src), jnp.asarray(lvl),
                             jnp.asarray(xy), jnp.asarray(vhw), rows=96)
    got = TS.prepare_windows(*_t(src, lvl, xy, vhw), rows=96)
    for f in ("windows", "y0", "x0", "vw", "vh"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)))


def test_matches_pallas_interpret(monkeypatch):
    """The port against the Pallas kernel itself (interpret mode)."""
    rng = np.random.default_rng(5)
    L, H, W = 2, 136, 256
    src = rng.uniform(0, 255, (L, H, W)).astype(np.float32)
    vhw = np.asarray([[H, W]] * L, np.int32)
    K, P = 16, 19
    xy = np.stack([rng.uniform(40, W - 40, K),
                   rng.uniform(40, H - 40, K)], -1).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, K)
    sc = rng.uniform(0.5, 1.4, K)
    A = (np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                   np.stack([np.sin(th), np.cos(th)], -1)], -2)
         * sc[:, None, None]).astype(np.float32)
    lvl = rng.integers(0, L, K).astype(np.int32)
    monkeypatch.setenv("MODS_SAMPLER", "pallas")
    ref = np.asarray(JS.sample_affine_patches(
        *(jnp.asarray(a) for a in (src, lvl, xy, A)), P, jnp.asarray(vhw)))
    got = TS.sample_affine_patches(*_t(src, lvl, xy, A), P,
                                   torch.from_numpy(vhw)).numpy()
    np.testing.assert_allclose(got, ref, atol=6e-3)


def test_mip_stack_and_levels():
    rng = np.random.default_rng(7)
    img = rng.uniform(0, 255, (200, 320)).astype(np.float32)
    js, jhw = JS.mip_stack(jnp.asarray(img), 4)
    ts, thw = TS.mip_stack(torch.from_numpy(img), 4)
    np.testing.assert_array_equal(thw.numpy(), np.asarray(jhw))
    # blurs in float32 with another summation order: 1e-3 on 0..255
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-3)
    A = np.asarray([np.eye(2) * s for s in (0.5, 1.0, 3.0, 8.0, 30.0)]
                   + [[[2.0, 1.5], [-0.3, 0.9]]], np.float32)
    jl, jsc = JS.select_level(jnp.asarray(A), 41, 6)
    tl, tsc = TS.select_level(torch.from_numpy(A), 41, 6)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    np.testing.assert_allclose(TS.op_norm_2x2(torch.from_numpy(A)).numpy(),
                               np.asarray(JS.op_norm_2x2(jnp.asarray(A))),
                               rtol=1e-6)
    for P in (15, 19, 31, 41):
        assert TS.rows_for_patch(P) == JS.rows_for_patch(P)
