"""Port vs JAX reference: view synthesis (CPU).

The view grid, the render plans, the grouping and the shape buckets are
pure Python float math and must give identical tuples.  The warps and the
blur are held to atol 1e-3 on 0..255 values on a seeded smoothed 96x128
image: ``floor`` of a fused multiply-add may move by an ulp between XLA
and PyTorch, and linear interpolation is continuous across that flip.
The last test checks, for every canvas the ladder of the card run builds,
that the rows the window sampler copies are 16-byte aligned.
"""

import dataclasses
import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy import ndimage

from mods_tpu import synthesis as jsyn
from mods_tpu.config import IterationParams as JaxIteration
from mods_tpu.ops import gaussian as jg
from mods_tpu.ops import warp as jw
from mods_tpu.pipeline import TwoViewMatcher as JaxMatcher
from mods_tpu.pipeline import _make_render_fn as jax_render_fn
from mods_tpu_torch import config as tc
from mods_tpu_torch import synthesis as tsyn
from mods_tpu_torch.ops import gaussian as tg
from mods_tpu_torch.ops import sampler as tsamp
from mods_tpu_torch.ops import warp as tw
from mods_tpu_torch.pipeline import TwoViewMatcher as TorchMatcher

torch.set_num_threads(2)

ATOL = 1e-3

# CVIU-shaped grids: (tilt_set, scale_set, phi_base)
GRIDS = [
    ((1.0,), (1.0,), 360.0),
    ((1.0, 5.0, 9.0), (1.0,), 360.0),
    ((1.0, 2.0, 4.0, 6.0, 8.0), (1.0,), 360.0),
    ((1.0, 2.0, 4.0, 6.0, 8.0), (1.0,), 120.0),
    ((1.0, 3.0, 5.0, 7.0, 9.0), (1.0, 0.25), 60.0),
    ((1.0, -2.0, 4.0), (1.0, 0.25), 360.0),       # vertical tilt
]


def _image(h=96, w=128, seed=0):
    rng = np.random.default_rng(seed)
    return ndimage.gaussian_filter(
        rng.uniform(0, 255, (h, w)), 1.5).astype(np.float32)


def _its(grid):
    tilts, scales, phi = grid
    kw = dict(tilt_set=tilts, scale_set=scales, phi_base=phi,
              init_sigma=0.8)
    return JaxIteration(**kw), tc.IterationParams(**kw)


@pytest.mark.parametrize("grid", GRIDS)
def test_view_grid_plans_and_groups_equal(grid):
    jit, tit = _its(grid)
    jprev, tprev = [], []
    # two expansions: the second sees the first as previous views, then
    # a wider grid escalates over both
    for j_it, t_it in ((jit, tit), (jit, tit),
                       _its(((1.0, 2.0, 4.0, 6.0, 8.0, 9.0), (1.0, 0.25),
                             120.0))):
        jv, jprev = jsyn.expand_views(j_it, jprev)
        tv, tprev = tsyn.expand_views(t_it, tprev)
        assert [dataclasses.astuple(v) for v in tv] == \
            [dataclasses.astuple(v) for v in jv]
        for w, h in ((1000, 598), (128, 96), (640, 480)):
            jp = [jsyn.plan_view(v, w, h) for v in jv]
            tp = [tsyn.plan_view(v, w, h) for v in tv]
            assert [dataclasses.astuple(p) for p in tp] == \
                [dataclasses.astuple(p) for p in jp]
            jgrp = jsyn.group_views(jp)
            tgrp = tsyn.group_views(tp)
            assert [[dataclasses.astuple(p) for p in g] for g in tgrp] == \
                [[dataclasses.astuple(p) for p in g] for g in jgrp]
    assert len(jprev) == len(tprev) > 0


def test_snap_buckets_equal():
    assert tsyn.SNAP_DIMS == jsyn.SNAP_DIMS
    assert tsyn.SNAP_VIEWS == jsyn.SNAP_VIEWS
    for n in list(range(1, 140)) + [511, 512, 513, 1000, 1281, 4096, 4097,
                                    5000]:
        assert tsyn.snap_dim(n) == jsyn.snap_dim(n)
        assert tsyn.snap_views(n) == jsyn.snap_views(n)


@pytest.mark.parametrize("sx,sy", [(0.3, 0.3), (0.8, 0.4), (2.4, 0.4),
                                   (4.8, 0.25), (1e-9, 1.0)])
def test_gaussian_blur_rt(sx, sy):
    img = np.stack([_image(seed=s) for s in (0, 1)])
    ref = np.asarray(jg.gaussian_blur_rt(jnp.asarray(img), jnp.float32(sx),
                                         jnp.float32(sy)))
    got = tg.gaussian_blur_rt(torch.from_numpy(img), sx, sy).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tg._taps_rt(sx, tg.RT_BLUR_RADIUS).numpy(),
        np.asarray(jg._taps_rt(sx, jg.RT_BLUR_RADIUS)), atol=1e-6, rtol=0)
    assert tg.RT_BLUR_RADIUS == jg.RT_BLUR_RADIUS


def _rot_inv(theta, w, h):
    """Inverse map of a rotation by theta about the image centre."""
    c, s = math.cos(theta), math.sin(theta)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    return np.array([[c, s, cx - c * cx - s * cy + 20.0],
                     [-s, c, cy + s * cx - c * cy + 12.0]], np.float32)


# all four quadrants; |theta| > pi/2 takes the flipped-source branch
@pytest.mark.parametrize("deg", [0.0, 17.0, 80.0, -35.0, -89.0, 100.0,
                                 135.0, 179.0, -120.0, -170.0])
def test_shear_rotate(deg):
    img = _image()
    m = _rot_inv(math.radians(deg), 128, 96)
    ref = np.asarray(jw.shear_rotate(jnp.asarray(img), jnp.asarray(m),
                                     160, 192))
    got = tw.shear_rotate(torch.from_numpy(img), torch.from_numpy(m),
                          160, 192).numpy()
    assert got.shape == ref.shape == (160, 192)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert (ref != 128.0).mean() > 0.15          # the image is in view


def test_shear_x_clips_like_jax():
    # an offset far outside the row exercises the clip of the block origin
    img = _image()
    for slope, off in ((0.5, -400.0), (-0.9, 900.0), (0.0, 3.25)):
        ref = np.asarray(jw._shear_x(jnp.asarray(img), jnp.float32(slope),
                                     jnp.float32(off), 150, 128.0))
        got = tw._shear_x(torch.from_numpy(img), torch.tensor(slope),
                          torch.tensor(off), 150, 128.0).numpy()
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("isx,isy,oh,ow", [(4.0, 1.0, 128, 128),
                                           (1.0, 2.5, 64, 128),
                                           (0.5, 0.5, 256, 256),
                                           (8.0, 4.0, 128, 128)])
def test_separable_scale(isx, isy, oh, ow):
    img = _image()
    ref = np.asarray(jw.separable_scale(jnp.asarray(img), jnp.float32(isx),
                                        jnp.float32(isy), oh, ow))
    got = tw.separable_scale(torch.from_numpy(img), isx, isy, oh, ow).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    batch = tw.separable_scale(torch.from_numpy(np.stack([img, img])),
                               torch.tensor(isx), torch.tensor(isy), oh, ow)
    np.testing.assert_array_equal(batch[1].numpy(), got)


def _preps(grid, h, w, detector="HessianAffine"):
    """Both packages' ``_prep_groups`` for one rung on an (h, w) image."""
    jit, tit = _its(grid)
    jit = dataclasses.replace(jit, detector=detector)
    tit = dataclasses.replace(tit, detector=detector)
    _, jpreps = JaxMatcher([jit])._prep_groups(jit, h, w, [])
    _, tpreps = TorchMatcher([tit], device="cpu")._prep_groups(tit, h, w, [])
    return jpreps, tpreps


@pytest.mark.parametrize("grid", GRIDS)
def test_prep_groups_geometry_equal(grid):
    """Bucketed shapes, inverse rotations, squash, sigmas, extents,
    H inverses and region budgets of every group, as uploaded."""
    jpreps, tpreps = _preps(grid, 598, 1000)
    assert len(tpreps) == len(jpreps) > 0
    for jp_, tp_ in zip(jpreps, tpreps):
        for k in ("V", "Vb", "hr", "wr", "hc", "wc", "identity", "do_blur"):
            assert tp_[k] == jp_[k], k
        for k, jk in (("rot_inv", "rot_inv_np"), ("squash_inv", "squash_np"),
                      ("valid_hw", "valid_np"), ("hinv", "hinv_np"),
                      ("regn", "regn_np")):
            np.testing.assert_array_equal(tp_[k].numpy(), jp_[jk], err_msg=k)
        np.testing.assert_array_equal(tp_["valid_hw_host"].numpy(),
                                      jp_["valid_np"])
        assert (float(tp_["sig_x"]), float(tp_["sig_y"])) == tuple(
            float(x) for x in jp_["sig_np"])


@pytest.mark.parametrize("grid", [GRIDS[0], GRIDS[1], GRIDS[3], GRIDS[5]])
def test_render_function(grid):
    """The whole render function, every group of the grid: identity
    canvas, shears, blur, squash and the clamp-pad of bucketed canvases
    (padded view slots included)."""
    img = _image()
    h, w = img.shape
    _, tpreps = _preps(grid, h, w)
    assert len(tpreps) == len(grid[0]) * len(grid[1])
    for gp in tpreps:
        args = (gp["Vb"], h, w, gp["hr"], gp["wr"], gp["hc"], gp["wc"],
                gp["do_blur"], gp["identity"])
        geom = [gp[k] for k in ("rot_inv", "squash_inv", "sig_x", "sig_y",
                                "valid_hw")]
        ref = np.asarray(jax_render_fn(*args)(
            jnp.asarray(img), *(jnp.asarray(t.numpy()) for t in geom)))
        got = gp["render"](torch.from_numpy(img), *geom).numpy()
        assert got.shape == ref.shape == (gp["Vb"], gp["hc"], gp["wc"])
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_every_ladder_canvas_has_aligned_rows():
    """The window sampler copies rows in 16-byte pieces (W % 4 == 0) and
    its windows must fit the planes.  Every canvas of the card run's
    ladder on a 1000x598 image, as the mip stack and as each octave of
    the Baumberg stack pad it."""
    seen = {(gp["hc"], gp["wc"]) for grid in GRIDS[:4]
            for shape in ((1000, 598), (1000, 150), (1130, 189))
            for gp in _preps(grid, *shape)[1]}
    assert len(seen) >= 8
    for hc, wc in seen:
        h, w = hc, wc
        while h >= 1 and w >= 1:          # the canvas and every octave
            ph, pw = tsamp.pad_canvas(torch.zeros(1, h, w)).shape[-2:]
            assert pw % 4 == 0 and pw >= tsamp.PALLAS_COLS
            assert ph >= tsamp.rows_for_patch(41) >= tsamp.rows_for_patch(31)
            assert ph >= 96                # the Baumberg window's rows
            h, w = h // 2, w // 2
        mips, hw = tsamp.mip_stack(torch.zeros(2, 8, 16), 4)
        assert mips.shape == (2, 4, 136, 256) and hw.shape == (4, 2)
