"""Port vs JAX reference: the other descriptor families (CPU).

Each function of ``mods_tpu_torch/descriptors/patch_descs.py`` against
its ``mods_tpu`` counterpart on the same seeded patches: 64 textured
41x41 patches and 6 that are flat 128 in part or in whole (the fill of
rotated views).  Tolerances, stated per family: the float families
(SURF/KAZE, DAISY) to 1e-6 (they differ by summation order), MROGH
to 1e-6 on 99 % of its entries and 2e-3 everywhere (an orientation bin
truncates an atan2, which can round across a bin edge);
SSIM to 1e-4 on textured patches, and only its range on flat ones,
where ``exp(-ssd / varnoise)`` divides the float32 rounding of
``p2 - 2 corr + c2`` by a varnoise near its floor; LIOP's permutation
index exactly wherever the four neighbours are more than 1e-4 apart and
the descriptor to 0.01; the bits of M-LDB, FREAK and BRISK exactly
wherever the two compared values are more than 1e-5 of the patch's
largest value apart (its range, where the patch has black pixels; a
flat patch's range is 0, and its block means round at the level of its
values).  Also the FREAK and BRISK pair tables index for index, and
``spec_for`` field for field.

Run as a script, ``python tests/test_torch_descriptors.py --descriptors
NAME[,NAME...] PAIR``, this file prints what the JAX matcher finds on a
``.parity_work`` pair at full size with
``chip_smoke.py::DESCRIPTOR_LADDERS[NAME]`` (seed 0): the figures of
``chip_smoke.py::JAX_DESCRIPTOR_REFERENCE``; with ``--seeds N``, each
seed's outcome instead (``JAX_DESCRIPTOR_SPREAD``).  One pair a process.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from scipy import ndimage  # noqa: E402

from mods_tpu import pipeline as jp  # noqa: E402
from mods_tpu.descriptors import patch_descs as J  # noqa: E402
from mods_tpu_torch import config as tc  # noqa: E402
from mods_tpu_torch.descriptors import patch_descs as T  # noqa: E402
from mods_tpu_torch.descriptors import registry as tr  # noqa: E402

torch.set_num_threads(2)

FLAT = 6          # the last FLAT patches are flat 128 in part or whole


def patch_set(K=64, P=41, seed=0):
    """(K + FLAT, P, P) float32 patches in [0, 255]: blurred noise under a
    sinusoid; then patches flat 128 over a half, a quarter, a band and
    all of the patch."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 255, (K + FLAT, P, P))
    base = np.stack([ndimage.gaussian_filter(b, 1.5) for b in base])
    yy, xx = np.mgrid[0:P, 0:P]
    for k in range(K + FLAT):
        base[k] += 60 * np.sin(xx / (2 + k % 5)) * np.cos(yy / (3 + k % 7))
    base = np.clip(base, 0, 255).astype(np.float32)
    h = P // 2
    base[K, :h] = 128.0
    base[K + 1, :h, :h] = 128.0
    base[K + 2, h - 4:h + 4] = 128.0
    base[K + 3, :, h:] = 128.0
    base[K + 4:] = 128.0
    base[K + 5, 0, 0] = 130.0                   # flat but for one pixel
    return base


@pytest.fixture(scope="module")
def patches():
    return patch_set()


def _both(name, p, **kw):
    a = np.asarray(jax.jit(lambda x: J.PATCH_FNS[name](x, **kw))(
        jnp.asarray(p)))
    b = T.PATCH_FNS[name](torch.from_numpy(p), **kw).numpy()
    assert a.shape == b.shape == (len(p), J.PATCH_DIMS[name]
                                  if not kw else a.shape[1])
    return a, b


@pytest.mark.parametrize("name,kw", [
    ("SURF", {}), ("KAZE", {}), ("DAISY", {}), ("MROGH", {}),
    ("DAISY", dict(n_rings=2, n_segs=6, n_ori=4)),
    ("MROGH", dict(n_groups=4, n_ori=6, supports=(41, 31))),
    ("SURF", dict(cells=3))])
def test_float_families_against_jax(patches, name, kw):
    a, b = _both(name, patches, **kw)
    if name == "MROGH":
        # a pixel's orientation bin truncates its atan2, which the two
        # packages round apart at a bin edge: its gradient moves bins
        np.testing.assert_allclose(b, a, atol=2e-3, rtol=0)
        assert (np.abs(b - a) <= 1e-6).mean() >= 0.99
    else:
        np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw", [{}, dict(inner=7, n_rad=3, n_ang=8)])
def test_ssim_against_jax(patches, kw):
    a, b = _both("SSIM", patches, **kw)
    np.testing.assert_allclose(b[:-FLAT], a[:-FLAT], atol=1e-4, rtol=0)
    # flat patches: the rounding of the SSD over a varnoise at its floor
    # decides; both stay finite descriptors in [0, 1]
    for d in (a[-FLAT:], b[-FLAT:]):
        assert np.isfinite(d).all() and d.min() >= 0 and d.max() <= 1


def _jax_liop_neighbours(p, radius=6.0, n_neigh=4):
    """The rotated neighbours of ``mods_tpu``'s liop_descriptor."""
    from mods_tpu.ops.warp import bilinear_sample
    P = p.shape[-1]
    offs, _, theta = J._liop_tables(P, n_neigh, radius)
    yy, xx = jnp.mgrid[0:P, 0:P]
    xx, yy = xx.astype(jnp.float32), yy.astype(jnp.float32)
    ct, st = jnp.cos(theta), jnp.sin(theta)
    nx = xx[None] + offs[:, 0, None, None] * ct[None] \
        - offs[:, 1, None, None] * st[None]
    ny = yy[None] + offs[:, 0, None, None] * st[None] \
        + offs[:, 1, None, None] * ct[None]
    neigh = jax.vmap(lambda q: bilinear_sample(q, nx, ny))(jnp.asarray(p))
    return jnp.moveaxis(neigh, 1, -1)


@pytest.mark.parametrize("kw", [{}, dict(radius=4.0, n_bins=4)])
def test_liop_against_jax(patches, kw):
    a, b = _both("LIOP", patches, **kw)
    r = kw.get("radius", 6.0)
    jn = _jax_liop_neighbours(patches, r)
    jidx = np.asarray(J._rank_index(jn))
    tidx, tn = T.liop_permutations(torch.from_numpy(patches), r)
    s = np.sort(tn.numpy(), -1)
    apart = np.diff(s, axis=-1).min(-1) > 1e-4
    assert apart.mean() > 0.5
    np.testing.assert_array_equal(tidx.numpy()[apart], jidx[apart])
    np.testing.assert_allclose(np.asarray(jn), tn.numpy(), atol=1e-3)
    np.testing.assert_allclose(b, a, atol=1e-2, rtol=0)
    assert (np.abs(b - a) <= 1e-6).mean() >= 0.99


@pytest.mark.parametrize("name,kw", [
    ("MLDB", {}), ("FREAK", {}), ("BRISK", {}),
    ("FREAK", dict(pattern_scale=33.0)), ("BRISK", dict(pattern_scale=1.5)),
    ("MLDB", dict(grids=(2, 3)))])
def test_binary_families_against_jax(patches, name, kw):
    a, b = _both(name, patches, **kw)
    assert set(np.unique(b)) <= {0.0, 1.0}
    margin = T.bit_margins(name, torch.from_numpy(patches), **kw).numpy()
    near = margin <= 1e-5 * patches.max((1, 2))[:, None]
    flips = a != b
    assert not (flips & ~near).any(), np.argwhere(flips & ~near)[:5]
    assert flips.sum() <= near.sum()


@pytest.mark.parametrize("P", [31, 41])
@pytest.mark.parametrize("scale", [1.0, 0.5, 1.5, 2.0])
def test_freak_and_brisk_tables_equal_jax(P, scale):
    for j, t in ((J._freak_pattern, T._freak_pattern),
                 (J._brisk_pattern, T._brisk_pattern)):
        for x, y in zip(j(P, scale), t(P, scale), strict=True):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


def test_pattern_hashes_name_the_default_tables():
    """The default tables' SHA-256, which ``chip_smoke.py`` phase 11
    holds the card machine's numpy to."""
    import chip_smoke
    for name, fn in (("FREAK", T._freak_pattern),
                     ("BRISK", T._brisk_pattern)):
        assert T.pattern_sha256(fn(41, 1.0)) \
            == chip_smoke.PATTERN_SHA256[name], name


def _engine_cfgs():
    """The JAX package's EngineConfig with every descriptor section off
    its default, and the port's copy."""
    from mods_tpu import config as jc
    cfg = jp.EngineConfig(
        daisy=jc.DaisyParams(radq=2, thq=6, histq=4),
        liop=jc.LiopParams(neighbours=3, bins=5, radius=5.0),
        ssim=jc.SsimParams(window_size=7, nrad=3, nang=8),
        mrogh=jc.MroghParams(n_dir=6, n_order=4, n_multi_region=2),
        freak=jc.FreakParams(pattern_scale=33.0),
        brisk=jc.BriskDetParams(pattern_scale=1.5),
        pixels=jc.PixelsParams(norm_type="L1"),
        cnn=jc.CnnParams(weights_file="w.npz", patch_size=48, mr_size=10.0,
                         dim=64, normalization="RootL2"))
    return cfg, tc.from_dict(dataclasses.asdict(cfg))


@pytest.mark.parametrize("with_cfg", [False, True])
def test_spec_for_equals_jax(with_cfg):
    jcfg, tcfg = _engine_cfgs() if with_cfg else (None, None)
    from mods_tpu.descriptors import registry as jr
    for name in jr.REGISTRY:
        ref = jr.spec_for(name, jcfg)
        got = tr.spec_for(name, tcfg)
        assert tr.get_spec(name) == tr.REGISTRY[name]
        for f in ("name", "kind", "half_sift_like", "dim", "dsp_levels",
                  "params"):
            assert getattr(got, f) == getattr(ref, f), (name, f)
        assert (got.sift is None) == (ref.sift is None)
        if got.sift is not None:
            assert dataclasses.asdict(got.sift) == dataclasses.asdict(
                ref.sift)
    assert set(tr.REGISTRY) == set(jr.REGISTRY)
    assert T.PATCH_DIMS == J.PATCH_DIMS
    assert set(T.PATCH_FNS) == set(J.PATCH_FNS)


@pytest.mark.parametrize("name", ["LIOP", "DAISY", "SSIM", "MROGH", "FREAK",
                                  "BRISK"])
def test_spec_params_drive_the_functions(patches, name):
    """The spec of a non-default config feeds the same keyword arguments
    to both packages' functions, with the dimension the spec states."""
    jcfg, tcfg = _engine_cfgs()
    sp = tr.spec_for(name, tcfg)
    p = patches[:8]
    a, b = (np.asarray(J.PATCH_FNS[name](jnp.asarray(p), **dict(sp.params))),
            T.PATCH_FNS[name](torch.from_numpy(p), **dict(sp.params)).numpy())
    assert a.shape == b.shape == (8, sp.dim)
    if name in ("FREAK", "BRISK"):
        assert (a != b).mean() < 0.01
    else:
        np.testing.assert_allclose(b, a, atol=1e-2 if name == "LIOP"
                                   else 1e-4)


def _full_pair(pair):
    from PIL import Image
    imgs = [np.asarray(Image.open(os.path.join(
        REPO, ".parity_work", f"{pair}_{i}.png")), np.float32)
        for i in (1, 2)]
    return imgs[0], imgs[1], np.loadtxt(os.path.join(
        REPO, ".parity_work", f"{pair}_H.txt"))


def _descriptor_main(names, pairs, n_seeds=0):
    """The JAX matcher on ``chip_smoke.py::DESCRIPTOR_LADDERS[name]``,
    full-size pairs: rungs used, store rows of each image at each rung,
    each rung's tentatives, verified matches, those within 3 px and the
    corner error (``JAX_DESCRIPTOR_REFERENCE``).  With ``n_seeds``, each
    pair's outcome over RANSAC seeds 0..n-1 (``JAX_DESCRIPTOR_SPREAD``)."""
    import chip_smoke
    from mods_tpu import config as jax_config
    from mods_tpu import pipeline as jp
    for name in names:
        ladder, cfg = chip_smoke.descriptor_matcher_args(jp, jax_config,
                                                         name)
        m = jp.TwoViewMatcher(ladder, cfg, seed=0)
        rows = chip_smoke.store_rows_per_rung(m, lambda st: st.count)
        tents = chip_smoke.tentatives_per_rung(m)
        for pair in pairs:
            img1, img2, H_gt = _full_pair(pair)
            if n_seeds:
                per_seed = []
                for seed in range(n_seeds):
                    m._seed = seed
                    per_seed.append(chip_smoke.pair_outcome(
                        m.match(img1, img2), H_gt, img1.shape))
                m._seed = 0
                print(json.dumps({f"{name} {pair}": dict(
                    outcomes=per_seed, **chip_smoke.spread_figures(
                        per_seed, dict(zip(
                            ("steps", "matches", "gt_consistent",
                             "corner_error_px"), per_seed[0])),
                        cfg.min_matches))}), flush=True)
                continue
            del rows[:], tents[:]
            t0 = time.time()
            r = m.match(img1, img2)
            steps, n, true, err = chip_smoke.pair_outcome(r, H_gt,
                                                          img1.shape)
            print(json.dumps({f"{name} {pair}": dict(
                steps=steps, tentatives=r.n_tentatives, matches=n,
                gt_consistent=true, corner_error_px=err,
                regions=list(rows),
                tentatives_per_rung=[int(t) for t in tents],
                seconds=round(time.time() - t0, 1))}), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    opts = {}
    for opt in ("--seeds", "--descriptors"):
        if opt in args:
            i = args.index(opt)
            opts[opt] = args[i + 1]
            del args[i:i + 2]
    if "--descriptors" in opts:
        _descriptor_main(opts["--descriptors"].split(","),
                         args or ["zoom2x", "tilt4"],
                         int(opts.get("--seeds", 0)))
