"""Port vs JAX reference: KAZE, TILDE and the device MSER backend (CPU,
small images).

Each test feeds the same numpy inputs, made from a seed, to the
``mods_tpu`` function and its ``mods_tpu_torch`` counterpart.

Tolerances.  Diffusion steps, gradients and determinants are float32
stencils: relative 1e-5 of the largest magnitude.  The TILDE bank's
21x21 convolutions sum 2,646 products in another order: 2e-5.  The MSER
labels, areas and candidate records are integers and exact counts, so
they are equal; the moment sums are float32 sums in another order, so
the region centres agree to 1e-3 px and the ellipses to 1e-3 relative
(on the card ``index_add_``'s atomics reorder them from run to run:
``chip_smoke.py`` holds the card's regions to 0.5 px of the CPU's).
Region sets are compared as in ``test_torch_detectors.py``.  End to end
as there.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mods_tpu import config as jc  # noqa: E402
from mods_tpu import pipeline as jp  # noqa: E402
from mods_tpu.detectors import kaze as jkaze  # noqa: E402
from mods_tpu.detectors import mser_tpu as jmser  # noqa: E402
from mods_tpu.detectors import tilde as jtilde  # noqa: E402
from mods_tpu_torch import config as tc  # noqa: E402
from mods_tpu_torch import pipeline as tp  # noqa: E402
from mods_tpu_torch.detectors import kaze as tkaze  # noqa: E402
from mods_tpu_torch.detectors import mser_tpu as tmser  # noqa: E402
from mods_tpu_torch.detectors import tilde as ttilde  # noqa: E402
from test_torch_detectors import (assert_matcher_agrees,  # noqa: E402
                                  assert_same_regions, rel_close, textured,
                                  views_and_hw)

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# KAZE


def test_fed_tau_steps_equal():
    for T in (0.05, 0.5, 3.0, 20.0):
        assert tkaze._fed_tau_steps(T) == jkaze._fed_tau_steps(T)


def test_kaze_stencils_against_jax():
    rng = np.random.default_rng(1)
    L = rng.uniform(0, 1, (37, 53)).astype(np.float32)
    g = rng.uniform(0.2, 1, (37, 53)).astype(np.float32)
    want = np.asarray(jkaze._diffusion_step(jnp.asarray(L), jnp.asarray(g),
                                            0.21))
    got = tkaze._diffusion_step(torch.as_tensor(L)[None],
                                torch.as_tensor(g)[None], 0.21)[0].numpy()
    rel_close(want, got, 1e-6)
    for a, b in zip(jkaze._grad(jnp.asarray(L)),
                    tkaze._grad(torch.as_tensor(L))):
        rel_close(np.asarray(a), b.numpy(), 1e-6)
    for sigma in (1.6, 2.7, 4.4):
        want = np.asarray(jkaze._hessian_det(jnp.asarray(L), sigma))
        got = tkaze._hessian_det(torch.as_tensor(L)[None], sigma)[0].numpy()
        rel_close(want, got, 1e-5)


@pytest.mark.parametrize("n", [16, 17, 1000, 1001])
def test_contrast_quantile_nearest(n):
    """``jnp.nanpercentile(..., 70, method="nearest")`` and
    ``torch.nanquantile(..., 0.7, interpolation="nearest")`` pick the
    same element, at the even lengths too, where 0.7 * (n - 1) lies on a
    half (n = 16: 10.5) and the two libraries' rounding of the index
    could differ; NaNs are skipped."""
    rng = np.random.default_rng(n)
    x = rng.permutation(np.arange(n, dtype=np.float32) + 0.5)
    nans = np.full(7, np.nan, np.float32)
    xs = np.concatenate([x, nans])
    want = float(jnp.nanpercentile(jnp.asarray(xs), 70.0, method="nearest"))
    got = float(torch.nanquantile(torch.as_tensor(xs), 0.7,
                                  interpolation="nearest"))
    assert got == want


def test_contrast_factor_against_jax():
    imgs, _ = views_and_hw(2, 96, 112)
    imgs[1] = 0.0        # no gradient above 1e-5: the 0.03 fallback
    got = tkaze.contrast_factor(torch.as_tensor(imgs)).numpy()
    for v in range(2):
        gx, gy = jkaze._grad(jkaze.gaussian_blur(jnp.asarray(imgs[v])
                                                 / 255.0, 1.0))
        mag = jnp.sqrt(gx * gx + gy * gy)
        k = jnp.nanpercentile(jnp.where(mag > 1e-5, mag, jnp.nan), 70.0,
                              method="nearest")
        k = jnp.where(jnp.isfinite(k), jnp.maximum(k, 1e-3),
                      jnp.float32(0.03))
        np.testing.assert_allclose(got[v], float(k), rtol=1e-6)
    assert got[1] == np.float32(0.03)


def test_kaze_against_jax():
    imgs, hw = views_and_hw(2, 160, 192)
    caps = dict(per_octave=512, per_view=256)
    want = jax.jit(lambda v, w: jkaze.detect_kaze(
        v, w, jc.CapacityParams(**caps)))(jnp.asarray(imgs),
                                          jnp.asarray(hw))
    got = tkaze.detect_kaze(torch.as_tensor(imgs), torch.as_tensor(hw),
                            tc.CapacityParams(**caps))
    assert_same_regions(want, got, min_count=20)


# ---------------------------------------------------------------------------
# TILDE


def test_procedural_filters_equal():
    W_j, b_j = jtilde.procedural_filters()
    W_t, b_t = ttilde.procedural_filters()
    assert W_t.shape == (4, 4, 6, 21, 21)
    np.testing.assert_array_equal(W_t, W_j)
    np.testing.assert_array_equal(b_t, b_j)


def test_tilde_loader_on_a_written_file(tmp_path):
    """The reference's text format (2 cascades of 3 filters, 6 channels,
    5x5, a repeated header line between cascades) read by both
    loaders, and the bank it gives applied by both packages."""
    rng = np.random.default_rng(2)
    W = rng.normal(0, 1, (2, 3, 6, 5, 5)).round(4)
    b = rng.normal(0, 1, (2, 3)).round(4)
    lines = ["1.5 0 0", "3 6 5"]
    for s in range(2):
        if s:
            lines.append("3 6 5")
        for m in range(3):
            for c in range(6):
                lines += [" ".join(f"{v:g}" for v in row)
                          for row in W[s, m, c]]
            lines.append(f"{b[s, m]:g}")
    path = tmp_path / "filters.txt"
    path.write_text("\n".join(lines) + "\n")
    Wt, bt, rt = ttilde.load_tilde_filters(str(path))
    Wj, bj, rj = jtilde.load_tilde_filters(str(path))
    assert rt == rj == 1.5
    np.testing.assert_array_equal(Wt, Wj)
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_allclose(Wt, W, rtol=1e-6)
    np.testing.assert_allclose(bt, b, rtol=1e-6)
    img = textured(64, 72, seed=4)
    want = np.asarray(jtilde.tilde_response(jnp.asarray(img),
                                            jnp.asarray(Wj), jnp.asarray(bj)))
    got = ttilde.tilde_response(torch.as_tensor(img), Wt, bt).numpy()
    rel_close(want, got, 2e-5)


def test_tilde_response_against_jax():
    img = textured(80, 96, seed=5)
    W, b = jtilde.procedural_filters()
    want = np.asarray(jtilde._channels(jnp.asarray(img)))
    got = ttilde._channels(torch.as_tensor(img)[None])[0].numpy()
    rel_close(want, got, 1e-6)
    want = np.asarray(jtilde.tilde_response(jnp.asarray(img),
                                            jnp.asarray(W), jnp.asarray(b)))
    got = ttilde.tilde_response(torch.as_tensor(img), W, b).numpy()
    rel_close(want, got, 2e-5)


def test_tilde_against_jax():
    imgs, hw = views_and_hw(2, 128, 160)
    caps = dict(per_view=256)
    want = jtilde.detect_tilde(jnp.asarray(imgs), jnp.asarray(hw),
                               jc.CapacityParams(**caps))
    got = ttilde.detect_tilde(torch.as_tensor(imgs), torch.as_tensor(hw),
                              tc.CapacityParams(**caps))
    assert_same_regions(want, got, min_count=50, resp_rel=2e-5)


def test_tilde_flat_patch_scores_the_banks_rounding():
    """On a flat patch TILDE's zero-mean bank scores the rounding of its
    sums: +3.3e-7 exactly (float64 from the float32 bank), and within
    1e-6 of 0, of either sign, in the JAX package's and the port's CPU
    convolutions (the figures of ``tilde.py``'s docstring)."""
    import chip_smoke
    got = chip_smoke.tilde_flat_scores("cpu")
    np.testing.assert_allclose(got["exact"], 3.2867e-7, rtol=1e-4)
    W, b = jtilde.procedural_filters()
    flat = np.full((64, 64), 128.0, np.float32)
    want = float(np.asarray(jtilde.tilde_response(
        jnp.asarray(flat), jnp.asarray(W), jnp.asarray(b)))[32, 32])
    assert abs(want) < 1e-6 and abs(got["computed"]) < 1e-6
    assert ttilde.tilde_bank("", "cpu") is ttilde.tilde_bank("", "cpu")


def test_tilde_card_vs_cpu_splits_at_the_noise_level():
    """``chip_smoke.tilde_card_vs_cpu`` (run here with the CPU on both
    sides) splits a rung's TILDE extrema before the cap at
    ``TILDE_NOISE``, 20x a flat patch's score on either device."""
    import chip_smoke
    flat = chip_smoke.tilde_flat_scores("cpu")
    assert 20 * abs(flat["exact"]) < chip_smoke.TILDE_NOISE
    its = [dict(detector="TILDE", descriptors=("RootSIFT",)),
           dict(detector="TILDE", descriptors=("RootSIFT",),
                tilt_set=(1.0, 4.0), phi_base=360.0)]
    m = tp.TwoViewMatcher([tc.IterationParams(**d) for d in its],
                          tp.EngineConfig(), device="cpu")
    img = torch.as_tensor(textured(192, 256, seed=4))
    views = chip_smoke.tilde_card_vs_cpu(m, img, 1)
    assert len(views) >= 2 and max(v["card"] for v in views) > 0
    for v in views:
        assert v["twin_share"] == 1.0 and v["card"] == v["cpu"]
        assert v["noise_card"] == v["noise_cpu"]


# ---------------------------------------------------------------------------
# device MSER


@pytest.mark.parametrize("axis", [-1, -2])
@pytest.mark.parametrize("reverse", [False, True])
def test_seg_min_against_jax(axis, reverse):
    """``cummin`` over value - seg_id * BIG is JAX's segmented min
    (``lax.associative_scan``) in both scan directions."""
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 500, (3, 17, 23)).astype(np.int32)
    bnd = rng.uniform(0, 1, vals.shape) < 0.3
    want = np.asarray(jmser._seg_min(jnp.asarray(vals), jnp.asarray(bnd),
                                     axis, reverse=reverse))
    got = tmser._seg_min(torch.as_tensor(vals, dtype=torch.int64),
                         torch.as_tensor(bnd), axis, 501, reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), want)


def test_label_components_against_jax():
    rng = np.random.default_rng(4)
    m = np.stack([rng.uniform(0, 1, (40, 52)) < p for p in (0.45, 0.6)])
    want = np.asarray(jmser._label_components(jnp.asarray(m), 3))
    got = tmser._label_components(torch.as_tensor(m), 3).numpy()
    np.testing.assert_array_equal(got, want)


def test_mser_sweep_records_against_jax():
    imgs, hw = views_and_hw(1, 64, 80)
    valid = np.ones((2, 64, 80), bool)
    g2 = np.concatenate([imgs, 255.0 - imgs]).astype(np.float32)
    max_size = np.full((2, 1), 0.05 * 64 * 80, np.float32)
    want = jmser._mser_sweep(jnp.asarray(g2), jnp.asarray(valid), 32, 3,
                             256, 30, jnp.asarray(max_size), 8)
    got = tmser._mser_sweep(torch.as_tensor(g2), torch.as_tensor(valid), 32,
                            3, 256, 30, torch.as_tensor(max_size), 8)
    np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))
    assert (np.asarray(want["b"]) >= 0).sum() > 10
    np.testing.assert_allclose(got["margin"].numpy(),
                               np.asarray(want["margin"]), rtol=1e-6)
    mom_w = np.asarray(want["mom"])
    np.testing.assert_array_equal(got["mom"].numpy()[..., 0], mom_w[..., 0])
    np.testing.assert_allclose(got["mom"].numpy(), mom_w, rtol=1e-5)


def test_mser_device_against_jax():
    imgs, hw = views_and_hw(2, 128, 160)
    caps = dict(per_view=256)
    want = jmser.detect_mser_tpu(jnp.asarray(imgs), jnp.asarray(hw),
                                 jc.CapacityParams(**caps))
    got = tmser.detect_mser_tpu(torch.as_tensor(imgs), torch.as_tensor(hw),
                                tc.CapacityParams(**caps))
    assert_same_regions(want, got, min_count=20)
    subs = set(np.unique(got.sub_type.numpy()[got.mask.numpy()]))
    assert subs == {tmser.MSER_PLUS, tmser.MSER_MIN}


# ---------------------------------------------------------------------------
# the matcher end to end


@pytest.mark.parametrize("det", ["KAZE", "TILDE", "MSER"])
def test_matcher_against_jax(det):
    kw = ({"mser": jp.MserParams(backend="device")} if det == "MSER"
          else None)
    assert_matcher_agrees(det, kw)
