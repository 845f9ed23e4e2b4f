"""Port vs JAX reference: the device CLAHE and densification by
homography (CPU).

* ``ops/clahe.py::clahe`` against ``mods_tpu.ops.clahe.clahe`` on
  ``tests/test_aux.py:40-56``'s images and on random ones: max |d| <=
  1e-3 grey levels (the tile histograms are exact counts in both; the
  clip excess and the CDF are float32 sums in another order), and the
  same properties the JAX tests check.  ``clahe_np`` (what
  ``cfg.do_clahe`` runs) is the JAX package's too.
* ``matching/densify.py`` against ``mods_tpu/matching/densify.py`` on
  ``tests/test_densify.py``'s three cases: the same accepted pairs (index
  for index), errors within 1e-4, and the JAX tests' own assertions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mods_tpu.matching import densify as jd
from mods_tpu.ops import clahe as jcl
from mods_tpu_torch.matching import densify as td
from mods_tpu_torch.ops import clahe as tcl

CLAHE_TOL = 1e-3


def _clahe_images():
    rng = np.random.default_rng(2)
    low = (100.0 + 8.0 * rng.standard_normal((96, 128))).astype(np.float32)
    return {
        "low contrast": np.clip(low, 0, 255),
        "flat": np.full((64, 64), 128.0, np.float32),
        "random": np.random.default_rng(5).uniform(0, 255, (77, 101)).astype(
            np.float32),
        # a size that is no multiple of the tile grid, and a gradient
        "ramp": np.add.outer(np.arange(150.0), np.arange(203.0)).astype(
            np.float32) % 256,
    }


@pytest.mark.parametrize("name", sorted(_clahe_images()))
def test_clahe_against_jax(name):
    img = _clahe_images()[name]
    ref = np.asarray(jcl.clahe(jnp.asarray(img)))
    got = tcl.clahe(torch.as_tensor(img))
    assert got.dtype == torch.float32 and got.shape == img.shape
    got = got.numpy()
    assert np.abs(got - ref).max() <= CLAHE_TOL
    np.testing.assert_allclose(tcl.clahe_np(img), jcl.clahe_np(img),
                               atol=CLAHE_TOL)
    assert np.isfinite(got).all()
    assert got.min() >= 0.0 and got.max() <= 255.0
    if name == "low contrast":
        assert got.std() > 1.5 * img.std()
    if name == "flat":
        assert got.std() < 60.0


@pytest.mark.parametrize("clip,tiles", [(2.0, (4, 6)), (40.0, (8, 8))])
def test_clahe_options_against_jax(clip, tiles):
    img = _clahe_images()["random"]
    ref = np.asarray(jcl.clahe(jnp.asarray(img), clip_limit=clip,
                               tiles_x=tiles[0], tiles_y=tiles[1]))
    got = tcl.clahe(torch.as_tensor(img), clip_limit=clip, tiles_x=tiles[0],
                    tiles_y=tiles[1]).numpy()
    assert np.abs(got - ref).max() <= CLAHE_TOL


def _t(*a):
    return [torch.as_tensor(np.asarray(x)) for x in a]


def test_overlap_error_against_jax():
    xy = np.asarray([[10.0, 10.0]], np.float32)
    C = np.asarray([[[9.0, 0.0], [0.0, 4.0]]], np.float32)
    for dx in (0.0, 5.0, 1.5):
        got = td.overlap_error(*_t(xy, C, xy + dx, C)).numpy()
        ref = np.asarray(jd.overlap_error(*(jnp.asarray(a) for a in
                                            (xy, C, xy + dx, C))))
        np.testing.assert_allclose(got, ref, atol=1e-6)
    assert td.overlap_error(*_t(xy, C, xy, C)).numpy()[0] < 1e-5
    assert td.overlap_error(*_t(xy, C, xy + 5.0, C)).numpy()[0] > 0.5


def _recover_case():
    """tests/test_densify.py::test_densify_recovers_pairs's regions."""
    rng = np.random.default_rng(0)
    n = 40
    xy1 = rng.uniform(50, 450, (n, 2)).astype(np.float32)
    ang = rng.uniform(0, np.pi, n)
    sq = rng.uniform(0.7, 1.4, n)
    A1 = np.zeros((n, 2, 2), np.float32)
    A1[:, 0, 0] = np.cos(ang) * sq
    A1[:, 0, 1] = -np.sin(ang) / sq
    A1[:, 1, 0] = np.sin(ang) * sq
    A1[:, 1, 1] = np.cos(ang) / sq
    s1 = rng.uniform(3, 8, n).astype(np.float32)
    H = np.array([[0.9, 0.1, 30.0], [-0.05, 1.1, -12.0],
                  [1e-5, -2e-5, 1.0]])
    p = np.concatenate([xy1, np.ones((n, 1))], 1) @ H.T
    xy2 = (p[:, :2] / p[:, 2:3]).astype(np.float32)
    lin = (H[None, :2, :2] - xy2[:, :, None] * H[None, 2:3, :2]) \
        / p[:, 2:3, None]
    A2s = np.einsum("nij,njk->nik", lin, A1 * s1[:, None, None])
    s2 = np.sqrt(np.abs(np.linalg.det(A2s))).astype(np.float32)
    A2 = (A2s / s2[:, None, None]).astype(np.float32)
    perm = rng.permutation(n)
    m = np.ones(n, bool)
    return (xy1, A1, s1, m, xy2[perm], A2[perm], s2[perm], m, H), {}, perm


def _wrong_h_case():
    """tests/test_densify.py::test_densify_rejects_wrong_h's regions."""
    rng = np.random.default_rng(1)
    n = 20
    xy1 = rng.uniform(50, 450, (n, 2)).astype(np.float32)
    A = np.tile(np.eye(2, dtype=np.float32), (n, 1, 1))
    s = np.full(n, 5.0, np.float32)
    m = np.ones(n, bool)
    xy2 = rng.uniform(50, 450, (n, 2)).astype(np.float32)
    return (xy1, A, s, m, xy2, A, s, m, np.eye(3)), dict(max_error=0.3), None


def _masked_case():
    """The recovery case with a third of list 2 masked out and a smaller
    k: the masked regions' partners must go unmatched or elsewhere."""
    args, _, perm = _recover_case()
    args = list(args)
    m2 = np.ones(len(perm), bool)
    m2[::3] = False
    args[7] = m2
    return tuple(args), dict(knn=5), perm


CASES = {"recovers pairs": _recover_case, "rejects a wrong H": _wrong_h_case,
         "masked, k = 5": _masked_case}


@pytest.mark.parametrize("case", sorted(CASES))
def test_densify_against_jax(case):
    args, kw, perm = CASES[case]()
    arrays, H = args[:-1], args[-1]
    ref = jax.jit(lambda *a: jd.densify_by_homography(
        *a, jnp.asarray(H), **kw))(*(jnp.asarray(a) for a in arrays))
    got = td.densify_by_homography(*_t(*arrays), H, **kw)
    (ri, re_, rok), (gi, ge, gok) = ([np.asarray(x) for x in ref],
                                     [x.numpy() for x in got])
    np.testing.assert_array_equal(gok, rok)
    np.testing.assert_array_equal(gi[gok], ri[rok])
    np.testing.assert_allclose(ge[gok], re_[rok], atol=1e-4)
    if case == "recovers pairs":
        assert gok.mean() > 0.9
        assert (perm[gi[gok]] == np.arange(len(gok))[gok]).mean() > 0.95
    elif case == "rejects a wrong H":
        assert gok.mean() < 0.3
    else:
        assert not np.isin(gi[gok], np.nonzero(~args[7])[0]).any()
