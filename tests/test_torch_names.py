"""Port vs JAX reference: the JAX package's remaining public names (CPU).

``test_every_public_name_has_a_counterpart`` reads both packages with
``ast`` (nothing is imported) and fails where a public top-level name of
a ``mods_tpu`` module (a function, a class or an assignment) has no name
of the same module path in ``mods_tpu_torch`` (defined there or imported
into it), apart from ``NO_COUNTERPART``.

The other tests hold each name ported for that to its JAX function on
numpy inputs from a seed, on the CPU:
* exact: ``DetectorParams`` (as ``dataclasses.asdict``), ``to_gray``,
  ``pad_to``, ``double_image``, ``window_origins``, ``extract_windows``,
  ``Regions.empty`` / ``flatten``, ``FeatureStore``, an empty
  ``BatchedDeviceStore``;
* atol 1e-3 on 0..255 values: ``affine_warp``, ``render_group`` and
  ``blur_patches`` (``floor`` of a fused multiply-add may move by an ulp
  between XLA and PyTorch, and the interpolation is continuous across
  it; the blur sums its taps in another order);
* ``extract_descriptor_patches``: atol 1e-2 (two folded 83-tap
  contractions a side, summed in another order);
* ``brief_descriptors``: at most 0.2 % of the bits differ, each a
  pattern pair whose two blurred values lie within 1e-3 of each other
  (a comparison of two equal numbers rounded apart).
"""

import ast
import dataclasses
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from mods_tpu import config as jc
from mods_tpu import pipeline as jp
from mods_tpu import regions as jr
from mods_tpu import synthesis as jsyn
from mods_tpu.descriptors import describe as jd
from mods_tpu.detectors import orb as jorb
from mods_tpu.ops import image as ji
from mods_tpu.ops import sampler as js
from mods_tpu.ops import warp as jw
from mods_tpu.parallel import multi as jm
from mods_tpu_torch import config as tc
from mods_tpu_torch import pipeline as tp
from mods_tpu_torch import regions as tr
from mods_tpu_torch import synthesis as tsyn
from mods_tpu_torch.descriptors import describe as td
from mods_tpu_torch.detectors import orb as torb
from mods_tpu_torch.ops import host_render as th
from mods_tpu_torch.ops import image as ti
from mods_tpu_torch.ops import sampler as ts
from mods_tpu_torch.ops import warp as tw
from mods_tpu_torch.parallel import multi as tm

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-3

# names that have no counterpart by design, with the reason
NO_COUNTERPART = {
    # the JAX compile cache and XLA's virtual CPU devices
    "runtime.py": "*",
    # picks the Pallas or the XLA sampler on a TPU; the port has one
    # sampler, csrc/window_sampler.cu, and its plain version on the CPU
    "ops/sampler.py": {"use_pallas_sampler"},
}


def _public_names(root: str) -> dict:
    """module path -> (its public top-level names defined by a def, a
    class or an assignment, those imported into it)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        if "__pycache__" in dirpath or "_build" in dirpath:
            continue
        for f in files:
            if not f.endswith(".py"):
                continue
            p = os.path.join(dirpath, f)
            with open(p) as fh:
                tree = ast.parse(fh.read())
            defined, imported = set(), set()
            for node in tree.body:
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    defined.add(node.name)
                elif isinstance(node, ast.Assign):
                    defined |= {t.id for t in node.targets
                                if isinstance(t, ast.Name)}
                elif isinstance(node, ast.AnnAssign) and isinstance(
                        node.target, ast.Name):
                    defined.add(node.target.id)
                elif isinstance(node, ast.ImportFrom):
                    imported |= {a.asname or a.name for a in node.names}
            out[os.path.relpath(p, root)] = (
                {n for n in defined if not n.startswith("_")},
                {n for n in imported if not n.startswith("_")})
    return out


def test_every_public_name_has_a_counterpart():
    jax_names = _public_names(os.path.join(REPO, "mods_tpu"))
    port_names = _public_names(os.path.join(REPO, "mods_tpu_torch"))
    missing = {}
    for mod, (defined, _) in sorted(jax_names.items()):
        skip = NO_COUNTERPART.get(mod, set())
        if skip == "*":
            continue
        have = set().union(*port_names.get(mod, (set(), set())))
        lost = sorted(defined - have - skip)
        if lost:
            missing[mod] = lost
    assert not missing, missing
    # the exceptions are still names of the JAX package
    assert "runtime.py" in jax_names
    assert "use_pallas_sampler" in jax_names["ops/sampler.py"][0]
    # Regions' two static helpers of item 24
    for name in ("empty", "flatten"):
        assert hasattr(jr.Regions, name) and hasattr(tr.Regions, name)


def _image(h=96, w=128, seed=0):
    rng = np.random.default_rng(seed)
    return ndimage.gaussian_filter(
        rng.uniform(0, 255, (h, w)), 1.5).astype(np.float32)


def _regions(k=64, seed=1, h=96, w=128):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(10, w - 10, k), rng.uniform(10, h - 10, k)],
                  -1).astype(np.float32)
    th = rng.uniform(-math.pi, math.pi, k)
    sq = rng.uniform(0.7, 1.4, k)
    A = np.stack([np.stack([np.cos(th) * sq, -np.sin(th) / sq], -1),
                  np.stack([np.sin(th) * sq, np.cos(th) / sq], -1)],
                 -2).astype(np.float32)
    s = rng.uniform(0.8, 4.0, k).astype(np.float32)
    return xy, A, s


def test_detector_params():
    j = jc.DetectorParams(do_baumberg=False)
    t = tc.DetectorParams(do_baumberg=False)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert tc.from_dict(dataclasses.asdict(j), cls=tc.DetectorParams) == t


def test_to_gray_pad_to_double_image():
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)
    for a in (rgb, rgb[..., 0], rgb.astype(np.float32) / 3):
        np.testing.assert_array_equal(
            ti.to_gray(torch.from_numpy(a)).numpy(),
            np.asarray(ji.to_gray(jnp.asarray(a))))
    img = _image(13, 17)
    for h, w, v in ((13, 17, 0.0), (16, 32, 128.0), (20, 17, -1.0)):
        np.testing.assert_array_equal(
            ti.pad_to(torch.from_numpy(img), h, w, v).numpy(),
            np.asarray(ji.pad_to(jnp.asarray(img), h, w, v)))
    stack = np.stack([img, img[::-1]])
    np.testing.assert_array_equal(
        ti.double_image(torch.from_numpy(stack)).numpy(),
        np.asarray(ji.double_image(jnp.asarray(stack))))


@pytest.mark.parametrize("deg,scale", [(0.0, 1.0), (33.0, 0.8),
                                       (-120.0, 1.7)])
def test_affine_warp(deg, scale):
    img = _image()
    c, s = math.cos(math.radians(deg)) * scale, math.sin(
        math.radians(deg)) * scale
    lin = np.array([[c, s], [-s, c]])
    # the output's centre (70, 45) maps to the image's (64, 48)
    m = np.c_[lin, np.array([64.0, 48.0]) - lin @ [70.0, 45.0]].astype(
        np.float32)
    ref = np.asarray(jw.affine_warp(jnp.asarray(img), jnp.asarray(m), 90,
                                    140))
    got = tw.affine_warp(torch.from_numpy(img), torch.from_numpy(m), 90,
                         140).numpy()
    assert got.shape == ref.shape == (90, 140)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert (ref != 128.0).mean() > 0.2


@pytest.mark.parametrize("tilts", [(1.0,), (1.0, 4.0), (1.0, -2.0)])
def test_render_group(tilts):
    """Every group of a tilt grid (identity, tilt 4, vertical tilt 2) of
    a 96x128 image: views, extents and homographies."""
    img = _image()
    kw = dict(tilt_set=tilts, scale_set=(1.0,), phi_base=72.0,
              init_sigma=0.8)
    jv, _ = jsyn.expand_views(jc.IterationParams(**kw), [])
    tv, _ = tsyn.expand_views(tc.IterationParams(**kw), [])
    jg = jsyn.group_views([jsyn.plan_view(v, 128, 96) for v in jv])
    tg = tsyn.group_views([tsyn.plan_view(v, 128, 96) for v in tv])
    assert len(jg) == len(tg) == len(tilts)
    for jgrp, tgrp in zip(jg, tg):
        jviews, jvalid, jH = jsyn.render_group(jnp.asarray(img), jgrp,
                                               pad_multiple=32)
        tviews, tvalid, tH = tsyn.render_group(torch.from_numpy(img), tgrp,
                                               pad_multiple=32)
        assert tviews.shape == jviews.shape
        np.testing.assert_allclose(tviews.numpy(), np.asarray(jviews),
                                   atol=ATOL, rtol=0)
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(tH, jH)


def test_window_origins_and_extract_windows():
    rng = np.random.default_rng(3)
    src = rng.uniform(0, 255, (3, 272, 512)).astype(np.float32)
    xy = np.concatenate([rng.uniform(-20, 540, (40, 2)),
                         [[0, 0], [511.9, 271.9], [63.5, 70.2]]]
                        ).astype(np.float32)
    lvl = rng.integers(-1, 4, len(xy)).astype(np.int32)
    jy, jx = js.window_origins(jnp.asarray(xy), 272, 512)
    ty, tx = ts.window_origins(torch.from_numpy(xy), 272, 512)
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    # origins past the clip range too (the gather clips them)
    y0 = np.asarray(jy) + rng.integers(-8, 200, len(xy)).astype(np.int32)
    x0 = np.asarray(jx) + rng.integers(-128, 300, len(xy)).astype(np.int32)
    ref = np.asarray(js.extract_windows(jnp.asarray(src), jnp.asarray(lvl),
                                        jnp.asarray(y0), jnp.asarray(x0)))
    got = ts.extract_windows(torch.from_numpy(src), torch.from_numpy(lvl),
                             torch.from_numpy(y0),
                             torch.from_numpy(x0)).numpy()
    assert got.shape == ref.shape == (len(xy), ts.WIN_Y, ts.WIN_X)
    np.testing.assert_array_equal(got, ref)


def test_blur_patches():
    rng = np.random.default_rng(4)
    p = rng.uniform(0, 255, (12, 41, 41)).astype(np.float32)
    for sigma in (0.9, 1.5, 2.0):
        np.testing.assert_allclose(
            td.blur_patches(torch.from_numpy(p), sigma).numpy(),
            np.asarray(jd.blur_patches(jnp.asarray(p), sigma)),
            atol=ATOL, rtol=0)


@pytest.mark.parametrize("photo_norm", [False, True])
def test_extract_descriptor_patches(photo_norm):
    img = _image()
    xy, A, s = _regions()
    s[:8] = 0.05                          # t <= 0.4: the direct path
    args_t = [torch.from_numpy(a) for a in (img, xy, A, s)]
    ref = np.asarray(jd.extract_descriptor_patches(
        *map(jnp.asarray, (img, xy, A, s)), 3.0 * math.sqrt(3.0), 41,
        photo_norm=photo_norm))
    got = td.extract_descriptor_patches(*args_t, 3.0 * math.sqrt(3.0), 41,
                                        photo_norm=photo_norm).numpy()
    assert got.shape == ref.shape == (64, 41, 41)
    np.testing.assert_allclose(got, ref, atol=1e-2, rtol=0)


def test_brief_descriptors():
    img = _image()
    xy, A, s = _regions(k=128, seed=5)
    ref = np.asarray(jorb.brief_descriptors(*map(jnp.asarray,
                                                 (img, xy, A, s))))
    got = torb.brief_descriptors(*[torch.from_numpy(a)
                                   for a in (img, xy, A, s)]).numpy()
    assert got.shape == ref.shape == (128, 256)
    differ = got != ref
    assert differ.mean() <= 0.002, differ.mean()
    if differ.any():
        # each differing bit compares two blurred values that tie to
        # within the rounding of the two packages' sums
        from mods_tpu_torch.ops.gaussian import blur_band_matrix
        p = tw.extract_patches(torch.from_numpy(img), torch.from_numpy(xy),
                               torch.from_numpy(A) * torch.from_numpy(
                                   s * 5.1962 / 31)[:, None, None],
                               31).numpy()
        M = blur_band_matrix(31, 2.0)
        p = np.einsum("ij,kjc,lc->kil", M, p, M)
        pat = torb.brief_pattern(256)
        px = np.clip(pat[..., 0] + 15, 0, 30).astype(int)
        py = np.clip(pat[..., 1] + 15, 0, 30).astype(int)
        for k, b in zip(*np.nonzero(differ)):
            v = p[k, py[b], px[b]]
            assert abs(v[0] - v[1]) <= 1e-3, (k, b, v)


def test_regions_empty_and_flatten():
    for shape in (5, (2, 3)):
        j = jr.Regions.empty(shape)
        t = tr.Regions.empty(shape)
        for f in ("xy", "A", "s", "response", "sub_type", "mask"):
            a, b = getattr(t, f).numpy(), np.asarray(getattr(j, f))
            assert a.shape == b.shape and a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b)
        jf, tf = j.flatten(), t.flatten()
        for f in ("xy", "A", "s", "response", "sub_type", "mask"):
            np.testing.assert_array_equal(getattr(tf, f).numpy(),
                                          np.asarray(getattr(jf, f)))


def test_feature_store():
    rng = np.random.default_rng(6)
    jst, tst = jp.FeatureStore(), tp.FeatureStore()
    assert jst.count == tst.count == 0
    for n in (7, 5):
        rows = (rng.normal(size=(n, 2)), rng.normal(size=(n, 2, 2)),
                rng.uniform(1, 3, n), rng.normal(size=n),
                rng.normal(size=(n, 8)), rng.uniform(size=n) > 0.3)
        jst.add(*rows)
        tst.add(*rows)
    assert tst.count == jst.count
    for cap in (3, 64):
        for a, b in zip(tst.padded(cap, 8), jst.padded(cap, 8)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_batched_device_store_and_native_dir():
    """``BatchedDeviceStore`` is importable from the JAX module's path:
    an empty store exposes the JAX store's arrays, all zero; an append
    lands at each pair's own count.  ``NATIVE_DIR`` is where the port
    builds its native libraries."""
    j = jm.BatchedDeviceStore(2, 6, 4)
    t = tm.BatchedDeviceStore(2, 6, 4)
    assert (t.P, t.cap, t.dim) == (j.P, j.cap, j.dim)
    for a, b in zip(t.device_arrays(), j.device_arrays()):
        assert tuple(a.shape) == b.shape
        assert not a.numpy().any() and not np.asarray(b).any()
    xy = torch.arange(2 * 3 * 2, dtype=torch.float32).reshape(2, 3, 2)
    t.append(xy, torch.zeros(2, 3, 2, 2), torch.ones(2, 3),
             torch.zeros(2, 3), torch.zeros(2, 3, 4), torch.tensor([2, 3]))
    t.append(xy + 100, torch.zeros(2, 3, 2, 2), torch.ones(2, 3),
             torch.zeros(2, 3), torch.zeros(2, 3, 4), torch.tensor([3, 3]))
    got_xy, _, _, _, n = t.device_arrays()
    assert n.tolist() == [5, 6]
    np.testing.assert_array_equal(got_xy[0, :5].numpy(), np.concatenate(
        [xy[0, :2].numpy(), xy[0].numpy() + 100]))
    np.testing.assert_array_equal(got_xy[1, :6].numpy(), np.concatenate(
        [xy[1].numpy(), xy[1].numpy() + 100]))
    from mods_tpu_torch.detectors.mser import BUILD_DIR
    assert th.NATIVE_DIR == BUILD_DIR
