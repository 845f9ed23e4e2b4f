"""The hand-written CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor ``mods_tpu``, so it runs on the card
machine, which has no JAX:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py configures JAX).  Tests marked
``gpu`` skip here, inside the ``cuda`` fixture, when there is no card.

Tolerances, kernel vs plain version:

* window sampler: 1e-3 absolute on 0..255 values and identical fill
  positions.  Both round every float operation the same way in the same
  order (see csrc/sampling.cuh), so they agree bit for bit in practice.
* Baumberg: ``ok`` differs on at most 1 % of the valid keypoints, shapes
  within 1e-3 where both converged.  The kernel's block reduction adds
  the second-moment sums in another order than ``torch.sum``, and 16
  fed-back iterations can carry a keypoint across a threshold.
"""

import numpy as np
import pytest
import torch

import mods_tpu_torch.detectors.baumberg as TB
import mods_tpu_torch.ops.sampler as TS
from mods_tpu_torch.config import (AffineShapeParams, CapacityParams,
                                   PyramidParams, RansacParams)
from mods_tpu_torch.detectors.hessaff import octave_keypoints
from mods_tpu_torch.models.flagship import default_config
from mods_tpu_torch.models.flagship import make_two_view_step
from mods_tpu_torch.pipeline import EngineConfig

torch.set_num_threads(2)


def _regions(rng, k, h, w, max_scale):
    xy = np.stack([rng.uniform(0, w, k), rng.uniform(0, h, k)],
                  -1).astype(np.float32)
    th = rng.uniform(0, 2 * np.pi, k)
    sc = rng.uniform(0.2, max_scale, k)
    R = np.stack([np.stack([np.cos(th), -np.sin(th)], -1),
                  np.stack([np.sin(th), np.cos(th)], -1)], -2)
    return xy, (R * sc[:, None, None]).astype(np.float32)


def _stack_inputs(K, P, device, L=6, H=1000, W=640, seed=0):
    """A (L, H, W) stack and K keypoints at patch size P, as the main
    path's Baumberg (P=19) and descriptor (P=41) calls see them."""
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.uniform(0, 255, (L, H, W))
                           .astype(np.float32)).to(device)
    xy, A = _regions(rng, K, H, W, max_scale=1.4)
    xy[:3] = [[-20.0, 5.0], [W + 1.0, H - 1.5], [np.nan, 3.0]]
    lvl = torch.from_numpy(rng.integers(0, L, K)).to(device)
    vhw = torch.tensor([[H - 7, W - 3]] * L, dtype=torch.int32,
                       device=device)
    xy, A = (torch.from_numpy(a).to(device) for a in (xy, A))
    return src, lvl, vhw, xy, A


def _inputs(K, P, device, **kw):
    """The same keypoints with their windows prefetched."""
    src, lvl, vhw, xy, A = _stack_inputs(K, P, device, **kw)
    ws = TS.prepare_windows(src, lvl, xy, vhw, rows=96)
    return ws, xy, A


def test_cpu_runs_plain_without_counting():
    ws, xy, A = _inputs(32, 19, "cpu", L=2, H=160, W=256)
    before = TS.sample_from_windows.launches
    a = TS.sample_from_windows(ws, xy, A, 19, fill=2.5)
    b = TS.sample_from_windows_plain(ws, xy, A, 19, fill=2.5)
    assert TS.sample_from_windows.launches == before
    assert torch.equal(a, b)
    # out-of-extent and NaN centers give fill
    assert (a[0, :, :10] == 2.5).all() and (a[2] == 2.5).all()


def test_cpu_stack_runs_plain_without_counting():
    src, lvl, vhw, xy, A = _stack_inputs(32, 41, "cpu", L=2, H=160, W=256)
    before = TS.sample_affine_patches.launches
    a = TS.sample_affine_patches(src, lvl, xy, A, 41, vhw, fill=2.5)
    b = TS.sample_affine_patches_plain(src, lvl, xy, A, 41, vhw, fill=2.5)
    assert TS.sample_affine_patches.launches == before
    assert torch.equal(a, b)
    assert (a[2] == 2.5).all()                      # NaN center


def test_cpu_baumberg_runs_plain_without_counting():
    rng = np.random.default_rng(1)
    blurs = torch.from_numpy(rng.uniform(0, 255, (5, 140, 260))
                             .astype(np.float32))
    K = 8
    lvl = torch.from_numpy(rng.integers(0, 4, K))
    xy = torch.from_numpy(rng.uniform(20, 120, (K, 2)).astype(np.float32))
    s = torch.full((K,), 2.0)
    valid = torch.ones(K, dtype=torch.bool)
    before = TB.baumberg_adapt.launches
    got = TB.baumberg_adapt(blurs, lvl, xy, s, valid, AffineShapeParams())
    ref = TB.baumberg_adapt_plain(blurs, lvl, xy, s, valid,
                                  AffineShapeParams())
    assert TB.baumberg_adapt.launches == before
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _small_cfg():
    return EngineConfig(
        caps=CapacityParams(per_octave=128, per_view=128, per_group=256,
                            per_image=256, max_angles=1, tentatives=512),
        ransac=RansacParams(batch_hypotheses=128, max_rounds=1))


def _small_pair():
    rng = np.random.default_rng(0)
    i1 = np.kron(rng.uniform(0, 255, (22, 22)), np.ones((12, 12)))[:256, :256]
    i2 = np.roll(i1, (7, -5), (0, 1))
    return i1.astype(np.float32), i2.astype(np.float32)


def test_cpu_step_on_shifted_pair():
    i1, i2 = _small_pair()
    out = make_two_view_step(_small_cfg(), device="cpu")(
        i1, i2, torch.Generator().manual_seed(0))
    H = out["H"].numpy() / out["H"].numpy()[2, 2]
    assert int(out["n_inliers"]) >= 20
    np.testing.assert_allclose(H[:2, 2], [-5.0, 7.0], atol=0.5)


# -- card only --------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _same_patches(got, ref, fill=0.0):
    assert torch.equal(got == fill, ref == fill)
    assert (got - ref).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("K,P", [(1536, 19), (256, 19), (1024, 41)])
def test_kernel_matches_plain(cuda, K, P):
    ws, xy, A = _inputs(K, P, cuda)
    before = TS.sample_from_windows.launches
    got = TS.sample_from_windows(ws, xy, A, P, fill=0.0)
    torch.cuda.synchronize()
    assert TS.sample_from_windows.launches == before + 1
    _same_patches(got, TS.sample_from_windows_plain(ws, xy, A, P, fill=0.0))


@pytest.mark.gpu
@pytest.mark.parametrize("K,P,L,H,W", [
    (1024, 41, 4, 1000, 640),       # orientation and descriptor patches
    (4096, 41, 4, 640, 1280),       # scripts/pallas_sampler_probe.py
    (256, 19, 12, 1000, 640), (300, 31, 3, 144, 384), (300, 32, 3, 144, 384),
    (300, 21, 3, 144, 384)])        # 21: the generic instance
def test_stack_kernel_matches_plain(cuda, K, P, L, H, W):
    src, lvl, vhw, xy, A = _stack_inputs(K, P, cuda, L=L, H=H, W=W)
    before = TS.sample_affine_patches.launches
    got = TS.sample_affine_patches(src, lvl, xy, A, P, vhw, fill=0.0)
    torch.cuda.synchronize()
    assert TS.sample_affine_patches.launches == before + 1
    ref = TS.sample_affine_patches_plain(src, lvl, xy, A, P, vhw, fill=0.0)
    _same_patches(got, ref)
    _same_patches(
        TS.sample_affine_patches(src, lvl, xy, A, P, vhw, fill=7.0),
        TS.sample_affine_patches_plain(src, lvl, xy, A, P, vhw, fill=7.0),
        fill=7.0)


@pytest.mark.gpu
def test_kernel_rejects_bad_inputs(cuda):
    ws, xy, A = _inputs(8, 19, cuda, L=1, H=160, W=256)
    with pytest.raises(ValueError):
        TS.sample_from_windows(ws, xy.double(), A, 19)
    with pytest.raises(ValueError):
        TS.sample_from_windows(ws, xy.cpu(), A, 19)
    src, lvl, vhw, xy, A = _stack_inputs(8, 41, cuda, L=1, H=160, W=256)
    with pytest.raises(ValueError):
        TS.sample_affine_patches(src.double(), lvl, xy, A, 41, vhw)
    with pytest.raises(ValueError):
        TS.sample_affine_patches(src, lvl.cpu(), xy, A, 41, vhw)
    with pytest.raises(ValueError):
        TS.sample_affine_patches(src[:, :64], lvl, xy, A, 41, vhw)
    with pytest.raises(ValueError):             # rows not 16-byte aligned
        TS.sample_affine_patches(src[:, :, :253], lvl, xy, A, 41, vhw)


def _zoom2x_octaves(device):
    """Baumberg's inputs on the main path: per octave of the zoom2x
    image, (stack, lvl, xy, s, ok) from the detector's own stages."""
    from pathlib import Path
    from mods_tpu_torch.io.png import read_png_gray
    png = Path(__file__).resolve().parent.parent / ".parity_work" \
        / "zoom2x_1.png"
    img = torch.as_tensor(read_png_gray(png), dtype=torch.float32,
                          device=device)
    hw = torch.tensor([list(img.shape)], dtype=torch.int32)
    return [(stack, lvl, xy.reshape(-1, 2), s.reshape(-1), ok.reshape(-1))
            for _, stack, lvl, xy, s, ok, _, _ in octave_keypoints(
                img[None], hw, PyramidParams(), default_config().caps)]


@pytest.mark.gpu
@pytest.mark.parametrize("octave", [0, 3])
def test_baumberg_kernel_matches_plain(cuda, octave):
    stack, lvl, xy, s, ok = _zoom2x_octaves(cuda)[octave]
    aff = AffineShapeParams()
    assert lvl.shape[0] == 256 and int(ok.sum()) >= 5
    before = TB.baumberg_adapt.launches
    u, good = TB.baumberg_adapt(stack, lvl, xy, s, ok, aff)
    torch.cuda.synchronize()
    assert TB.baumberg_adapt.launches == before + 1
    ru, rgood = TB.baumberg_adapt_plain(stack, lvl, xy, s, ok, aff)
    assert int(rgood.sum()) >= 3
    assert int((good != rgood).sum()) <= 0.01 * int(ok.sum())
    both = good & rgood
    assert (u - ru)[both].abs().max().item() <= 1e-3
    assert not good[~ok].any()


@pytest.mark.gpu
def test_baumberg_rejects_bad_inputs(cuda):
    stack, lvl, xy, s, ok = _zoom2x_octaves(cuda)[3]
    aff = AffineShapeParams()
    with pytest.raises(ValueError):
        TB.baumberg_adapt(stack, lvl, xy.double(), s, ok, aff)
    with pytest.raises(ValueError):
        TB.baumberg_adapt(stack, lvl, xy, s.cpu(), ok, aff)
    with pytest.raises(ValueError):
        TB.baumberg_adapt(stack, lvl.float(), xy, s, ok, aff)


@pytest.mark.gpu
def test_step_on_card_matches_cpu(cuda):
    i1, i2 = _small_pair()
    before = (TS.sample_affine_patches.launches, TB.baumberg_adapt.launches)
    card = make_two_view_step(_small_cfg())(
        i1, i2, torch.Generator(device="cuda").manual_seed(0))
    assert TS.sample_affine_patches.launches == before[0] + 4
    assert TB.baumberg_adapt.launches > before[1]
    cpu = make_two_view_step(_small_cfg(), device="cpu")(
        i1, i2, torch.Generator().manual_seed(0))
    for k in ("n_tentatives", "n_inliers"):
        assert abs(int(card[k]) - int(cpu[k])) <= 0.1 * int(cpu[k])
    Hc = card["H"].cpu().numpy()
    Hp = cpu["H"].numpy()
    np.testing.assert_allclose(Hc / Hc[2, 2], Hp / Hp[2, 2], atol=0.05)


# -- the ladder's geometries --------------------------------------------------

def _ladder_pair():
    """A block texture and its copy squashed to a third of the width: the
    identity rung fails on it, the tilt rung recovers it."""
    rng = np.random.default_rng(3)
    b = np.kron(rng.uniform(0, 255, (14, 19)), np.ones((12, 12)))
    i1 = b[:160, :224].astype(np.float32)
    xs = np.arange(224) * 3.0
    x0 = np.clip(np.floor(xs).astype(int), 0, 222)
    i2 = np.full_like(i1, 128.0)
    i2[:, :74] = i1[:, x0[:74]]
    return i1, i2


def _ladder_matcher(device):
    from mods_tpu_torch.config import IterationParams
    from mods_tpu_torch.pipeline import TwoViewMatcher
    cfg = EngineConfig(
        caps=CapacityParams(per_octave=512, per_view=512, per_image=1024,
                            max_angles=2),
        ransac=RansacParams(err_threshold=3.0, batch_hypotheses=256,
                            max_rounds=3, error_type="sampson"))
    ladder = [
        IterationParams(detector="ORB", descriptors=("ORB",),
                        fginn_threshold=(0.0,), distance_threshold=(60.0,)),
        IterationParams(tilt_set=(1.0, 3.0), phi_base=360.0)]
    return TwoViewMatcher(ladder, cfg, device=device)


def test_cpu_ladder_runs_plain_without_counting():
    i1, i2 = _ladder_pair()
    before = (TS.sample_affine_patches.launches, TB.baumberg_adapt.launches)
    r = _ladder_matcher("cpu").match(i1, i2)
    assert (TS.sample_affine_patches.launches,
            TB.baumberg_adapt.launches) == before
    assert r.steps_used == 2 and r.n_matches >= 10


@pytest.mark.gpu
@pytest.mark.parametrize("P", [41, 31])
def test_stack_kernel_on_a_view_group_stack(cuda, P):
    """caps.per_group rows from the 12 x 4 mip planes of a view group,
    the last view's planes with extent 0 (a bucket-padded view)."""
    src, lvl, vhw, xy, A = _stack_inputs(768, P, cuda, L=48, H=256, W=1280)
    vhw[44:] = 0
    got = TS.sample_affine_patches(src, lvl, xy, A, P, vhw)
    torch.cuda.synchronize()
    ref = TS.sample_affine_patches_plain(src, lvl, xy, A, P, vhw)
    _same_patches(got, ref)
    on_empty = lvl >= 44
    assert on_empty.any() and (got[on_empty] == 0).all()
    assert (got[~on_empty] != 0).any()


@pytest.mark.gpu
def test_baumberg_kernel_over_views(cuda):
    """K = V x 256 keypoints over a (V (L + 2), h, w) stack, one view
    bucket-padded: its keypoints are invalid and leave before staging."""
    from pathlib import Path
    from mods_tpu_torch.io.png import read_png_gray
    png = Path(__file__).resolve().parent.parent / ".parity_work"
    views = torch.stack([
        torch.as_tensor(read_png_gray(png / f"{n}_1.png")[:512, :512],
                        dtype=torch.float32, device=cuda)
        for n in ("zoom2x", "tilt4", "rot90")])
    views[2] = 128.0
    hw = torch.tensor([[512, 512], [500, 480], [0, 0]], dtype=torch.int32)
    stack, lvl, xy, s, ok = [
        (stack, lvl, xy.reshape(-1, 2), s.reshape(-1), ok.reshape(-1))
        for _, stack, lvl, xy, s, ok, _, _ in octave_keypoints(
            views, hw, PyramidParams(), EngineConfig().caps)][0]
    assert stack.shape[0] == 3 * 5 and lvl.shape[0] == 3 * 256
    assert not ok[512:].any() and int(ok[:512].sum()) >= 100
    aff = AffineShapeParams()
    before = TB.baumberg_adapt.launches
    u, good = TB.baumberg_adapt(stack, lvl, xy, s, ok, aff)
    torch.cuda.synchronize()
    assert TB.baumberg_adapt.launches == before + 1
    ru, rgood = TB.baumberg_adapt_plain(stack, lvl, xy, s, ok, aff)
    assert int((good != rgood).sum()) <= 0.01 * int(ok.sum())
    both = good & rgood
    assert int(both.sum()) >= 50
    assert (u - ru)[both].abs().max().item() <= 1e-3
    assert not good[~ok].any()


@pytest.mark.gpu
def test_ladder_on_card_matches_cpu(cuda):
    i1, i2 = _ladder_pair()
    before = (TS.sample_affine_patches.launches, TB.baumberg_adapt.launches)
    card = _ladder_matcher("cuda").match(i1, i2)
    # 2 images x (1 ORB group: BRIEF patches; 2 HessianAffine groups:
    # orientation + descriptor patches each)
    assert TS.sample_affine_patches.launches == before[0] + 2 * (1 + 2 * 2)
    assert TB.baumberg_adapt.launches > before[1]
    cpu = _ladder_matcher("cpu").match(i1, i2)
    assert card.steps_used == cpu.steps_used == 2
    assert abs(card.n_matches - cpu.n_matches) <= 0.2 * cpu.n_matches
    Hc, Hp = card.H / card.H[2, 2], cpu.H / cpu.H[2, 2]
    np.testing.assert_allclose(Hc, Hp, atol=0.1)


# -- pair batches ---------------------------------------------------------

def _batched_group(device, P=2):
    """The tilt-3 view group of ``_ladder_matcher``'s second rung for a
    batch of P copies of ``_ladder_pair``'s first image (the copies
    shifted), rendered and detected on the CPU: (group prep on
    ``device``, views, regions), both on ``device``."""
    i1, _ = _ladder_pair()
    imgs = np.stack([np.roll(i1, 9 * p, 1) for p in range(P)])
    sizes = ((i1.shape[0], i1.shape[1]),) * P
    m = _ladder_matcher("cpu")
    it = m.ladder[1]
    _, (_, gp) = m._prep_groups(it, *i1.shape, [], sizes)
    views = gp["render"](torch.from_numpy(imgs), gp["rot_inv"],
                         gp["squash_inv"], gp["sig_x"], gp["sig_y"],
                         gp["valid_hw"])
    r = gp["detect"](views, gp["valid_hw"], gp["valid_hw_host"], gp["regn"])
    md = _ladder_matcher(device)
    _, (_, gpd) = md._prep_groups(it, *i1.shape, [], sizes)
    regs = [t.to(device) for t in (r.xy, r.A, r.s, r.response, r.mask)]
    return gpd, views.to(device), regs


@pytest.mark.gpu
def test_batched_describe_on_card_matches_cpu(cuda):
    """The describe stage of a pair batch (each pair compacted to its own
    rows, both pairs' patches in one launch a patch set) on the card
    against the same stage on the CPU, from the same views and regions:
    each pair's rows, sorted by (response, x, y), the same positions,
    scales and responses within 2e-3, shapes within 1e-2 and descriptors
    within 1 (a quantization step) on >= 99 % of them.  The mip stack's
    blur rounds otherwise on the card, which moves the interpolated
    orientation peak, and with it the rotated shape A, by about 1e-3 rad
    (0.0024 on an entry of a card run)."""
    from mods_tpu_torch.pipeline import BatchedDeviceStore
    P = 2
    out = {}
    for dev in ("cpu", "cuda"):
        gp, views, regs = _batched_group(dev, P)
        st = BatchedDeviceStore(P, 1024, 128, dev)
        before = TS.sample_affine_patches.launches
        gp["describe"](views, gp["valid_hw"], *regs, gp["hinv"], [st])
        launched = TS.sample_affine_patches.launches - before
        # orientation and descriptor patches of both pairs: 2 launches
        assert launched == (2 if dev == "cuda" else 0)
        out[dev] = st
    for p in range(P):
        rows = []
        for st in (out["cpu"], out["cuda"]):
            n = int(st._n[p])
            r = torch.cat([st._xy[p, :n], st._A[p, :n].reshape(n, 4),
                           st._s[p, :n, None], st._r[p, :n, None],
                           st._d[p, :n]], 1).cpu().numpy()
            rows.append(r[np.lexsort((r[:, 1], r[:, 0], r[:, 7]))])
        cpu, card = rows
        assert len(cpu) >= 50 and len(card) == len(cpu)
        np.testing.assert_allclose(card[:, [0, 1, 6, 7]],
                                   cpu[:, [0, 1, 6, 7]], atol=2e-3)
        np.testing.assert_allclose(card[:, 2:6], cpu[:, 2:6], atol=1e-2)
        close = np.abs(card[:, 8:] - cpu[:, 8:]).max(1) <= 1.0
        assert close.mean() >= 0.99


def _ransac_batch(device):
    """Three pairs of 160 correspondences under three homographies, 20,
    40 and 70 % outliers: (xy1, xy2, mask) on ``device``."""
    rng = np.random.default_rng(5)
    P, N = 3, 160
    xy1 = rng.uniform(0, 300, (P, N, 2))
    xy2 = np.empty_like(xy1)
    for p in range(P):
        H = np.array([[1.0, 0.02, 5.0], [-0.01, 0.97, -3.0],
                      [1e-4, 0.0, 1.0]]) * (1 + 0.1 * p)
        q = np.c_[xy1[p], np.ones(N)] @ H.T
        xy2[p] = q[:, :2] / q[:, 2:] + rng.normal(0, 0.3, (N, 2))
        out = rng.uniform(0, 1, N) < (0.2, 0.4, 0.7)[p]
        xy2[p, out] = rng.uniform(0, 300, (out.sum(), 2))
    mask = rng.uniform(0, 1, (P, N)) < 0.9
    return (torch.from_numpy(xy1.astype(np.float32)).to(device),
            torch.from_numpy(xy2.astype(np.float32)).to(device),
            torch.from_numpy(mask).to(device))


@pytest.mark.gpu
def test_batched_ransac_h_on_card_matches_cpu(cuda):
    """LO-RANSAC H over a pair batch on the card against the CPU: the
    generators' streams differ by device, so the outcome is held: each
    pair's H within 0.5 px at the corners of its 300 px square and its
    inlier set the same bar 2 % of the points."""
    from mods_tpu_torch.ransac.homography import ransac_h
    pars = RansacParams(err_threshold=2.0, batch_hypotheses=64, max_rounds=6)
    res = {}
    for dev in ("cpu", "cuda"):
        res[dev] = ransac_h(*_ransac_batch(dev), pars, [
            torch.Generator(device=dev).manual_seed(s) for s in range(3)])
    c = np.array([[0, 0, 1], [300, 0, 1], [0, 300, 1], [300, 300, 1.0]])
    for p in range(3):
        corners = []
        for dev in ("cpu", "cuda"):
            q = c @ res[dev][0][p].cpu().numpy().astype(np.float64).T
            corners.append(q[:, :2] / q[:, 2:])
        assert np.abs(corners[0] - corners[1]).max() <= 0.5
        differ = (res["cpu"][1][p] != res["cuda"][1][p].cpu()).sum()
        assert int(differ) <= 0.02 * 160
        assert int(res["cuda"][2][p]) >= 0.5 * 160 * (0.8, 0.6, 0.3)[p]


@pytest.mark.gpu
def test_descriptor_families_on_card_match_cpu(cuda):
    """Every patch descriptor family, Pixels and the CNN on the card
    against the CPU on the same patches (``chip_smoke.py`` phase 11's
    bounds): float families within 1e-5 (the CNN 1e-4); LIOP and MROGH,
    whose pixels can move bins where the devices round across an edge,
    on 99 % of the entries and within 5e-3; the bits of M-LDB, FREAK and
    BRISK only where the compared values are within 1e-5 of the patch's
    largest value; SSIM on these textured patches within 1e-3."""
    from mods_tpu_torch.descriptors import patch_descs as pd
    from mods_tpu_torch.descriptors.cnn import net_for
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:41, 0:41]
    p = rng.uniform(0, 255, (96, 41, 41)) * 0.5 + 60 * np.sin(
        xx / 3.0)[None] * np.cos(yy / 4.0)[None] + 64
    cpu = torch.from_numpy(np.clip(p, 0, 255).astype(np.float32))
    card = cpu.cuda()
    for name, fn in pd.PATCH_FNS.items():
        a, b = fn(card).cpu(), fn(cpu)
        d = (a - b).abs()
        if name in ("MLDB", "FREAK", "BRISK"):
            near = (pd.bit_margins(name, cpu)
                    <= 1e-5 * cpu.amax((1, 2))[:, None])
            assert not ((d > 0) & ~near).any(), name
        elif name in ("LIOP", "MROGH"):
            assert d.max() <= 5e-3 and (d <= 1e-5).float().mean() >= 0.99
        else:
            assert d.max() <= (1e-3 if name == "SSIM" else 1e-5), name
    d = (pd.pixels_descriptor(card).cpu() - pd.pixels_descriptor(cpu)).abs()
    assert d.max() <= 1e-6
    p32 = cpu[:, 4:36, 4:36].contiguous()
    a, b = (net_for("", 32, 128, "L2", dev)(p32.to(dev)).cpu()
            for dev in ("cuda", "cpu"))
    assert (a - b).abs().max() <= 1e-4
