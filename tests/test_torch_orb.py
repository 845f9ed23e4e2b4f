"""Port vs JAX reference: the ORB detector and rBRIEF (CPU).

The FAST mask is boolean stencil work and must be equal.  The Harris
measure is a product of blurred gradient products (values up to 1e7):
rtol 1e-3 of the largest magnitude.  Region sets are compared by their (x, y, s) keys, as the slot order of
a capped compaction is not part of the result.  BRIEF compares
blurred intensities: a tie, or a pair closer than float32 rounding,
flips a bit, so the bits are held as a share (>= 99.5 % equal).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch
from scipy import ndimage

from mods_tpu.config import CapacityParams as JaxCaps
from mods_tpu.detectors import orb as jorb
from mods_tpu.detectors.scale_space import harris_response as jax_harris
from mods_tpu_torch import config as tc
from mods_tpu_torch.detectors import orb as torb
from mods_tpu_torch.detectors.scale_space import harris_response

torch.set_num_threads(2)


def _views(seed=0, V=2, h=120, w=160):
    """Block textures with corners, lightly smoothed, one per view."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(V):
        b = np.kron(rng.uniform(0, 255, (h // 8, w // 8)), np.ones((8, 8)))
        b = ndimage.gaussian_filter(b, 0.7) + rng.uniform(0, 4, b.shape)
        out.append(np.clip(b, 0, 255))
    return np.stack(out).astype(np.float32)


def test_brief_table_is_the_jax_table():
    np.testing.assert_array_equal(torb.brief_pattern(), jorb.brief_pattern())
    np.testing.assert_array_equal(torb.brief_pattern(64), jorb.brief_pattern(64))
    np.testing.assert_array_equal(torb._ic_disc(), jorb._ic_disc())
    assert torb.FAST_RING == tuple(map(tuple, jorb.FAST_RING.tolist()))


def test_fast_corners_equal():
    v = _views(1)
    # integer intensities make ring ties with the threshold exact
    v[1] = np.round(v[1])
    for thr in (20.0, 7.0):
        ref = np.asarray(jorb.fast_corners(jnp.asarray(v), thr))
        got = torb.fast_corners(torch.from_numpy(v), thr).numpy()
        np.testing.assert_array_equal(got, ref)
        assert 50 < ref.sum() < ref.size // 2


def test_harris_response():
    v = _views(2)
    ref = np.asarray(jax_harris(jnp.asarray(v), 1.0))
    got = harris_response(torch.from_numpy(v), 1.0).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-3 * np.abs(ref).max())


def test_resize_and_orientation():
    v = _views(3)
    for oh, ow in ((100, 133), (32, 32), (57, 76)):
        ref = np.stack([np.asarray(jorb._resize(jnp.asarray(im), oh, ow))
                        for im in v])
        got = torb._resize(torch.from_numpy(v), oh, ow).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-3, rtol=0)
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 160, (2, 40, 2)).astype(np.float32)
    xy[..., 1] *= 120 / 160
    xy[0, :5] = [[1.0, 2.0], [159.0, 119.0], [0.0, 0.0], [80.5, 60.25],
                 [158.0, 3.0]]                      # patches leaving the image
    ref = np.stack([np.asarray(jorb.orientation_ic(jnp.asarray(im),
                                                   jnp.asarray(p)))
                    for im, p in zip(v, xy)])
    got = torb.orientation_ic(torch.from_numpy(v),
                              torch.from_numpy(xy)).numpy()
    d = np.abs(np.angle(np.exp(1j * (got - ref))))
    assert d.max() < 1e-3


def _by_key(regs, i, np_of):
    """{(x, y, s): (response, A)} of view i's valid regions."""
    xy, A, s, r, m = (np_of(getattr(regs, f))[i] for f in
                      ("xy", "A", "s", "response", "mask"))
    return {(float(x), float(y), float(sc)): (float(rr), a.reshape(4))
            for (x, y), sc, rr, a in zip(xy[m], s[m], r[m], A[m])}


def test_detect_orb_region_sets():
    """Region sets by (x, y, s) key.  Levels above the first are bilinear
    resizes, where a pixel within float32 rounding of the FAST threshold
    or of its 3x3 Harris maximum may fall to the other side (JAX's own
    jit and eager runs differ by 2 of 198 regions on this input): at
    least 98 % of each view's regions are common, and on those the
    response agrees to rtol 1e-3 and the frame to 2e-3."""
    v = _views(4, V=3)
    valid = np.array([[120, 160], [100, 150], [0, 0]], np.int32)
    caps = dict(per_view=256)
    kw = dict(n_features=200, n_levels=4, edge_threshold=15,
              fast_threshold=12.0)
    ref = jax.jit(lambda a, b: jorb.detect_orb(a, b, JaxCaps(**caps), **kw))(
        jnp.asarray(v), jnp.asarray(valid))
    got = torb.detect_orb(torch.from_numpy(v), torch.from_numpy(valid),
                          tc.CapacityParams(**caps), **kw)
    assert got.mask.shape == (3, 256)
    assert int(got.mask[2].sum()) == int(np.asarray(ref.mask)[2].sum()) == 0
    for i, least in ((0, 60), (1, 40)):
        a = _by_key(ref, i, np.asarray)
        b = _by_key(got, i, lambda t: t.numpy())
        common = set(a) & set(b)
        assert len(a) > least
        assert len(common) >= 0.98 * max(len(a), len(b))
        for k in common:
            np.testing.assert_allclose(b[k][0], a[k][0], rtol=1e-3)
            np.testing.assert_allclose(b[k][1], a[k][1], atol=2e-3, rtol=0)
    assert (np.asarray(ref.sub_type)[np.asarray(ref.mask)]
            == torb.DET_ORB).all()
    assert (got.sub_type[got.mask] == torb.DET_ORB).all()


def test_brief_bits_share():
    rng = np.random.default_rng(5)
    p = ndimage.gaussian_filter(rng.uniform(0, 255, (300, 31, 31)),
                                (0, 1.0, 1.0)).astype(np.float32)
    p[:20] = np.round(p[:20] / 16) * 16          # coarse levels: ties
    ref = np.asarray(jorb.brief_from_patches(jnp.asarray(p)))
    got = torb.brief_from_patches(torch.from_numpy(p)).numpy()
    assert got.shape == ref.shape == (300, 256)
    assert set(np.unique(got)) <= {0.0, 1.0}
    assert (got == ref).mean() >= 0.995
    assert 0.3 < ref.mean() < 0.7
