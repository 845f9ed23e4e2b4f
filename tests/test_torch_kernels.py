"""The hand-written CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor ``mods_tpu``, so it runs on the card
machine, which has no JAX:

    python -m pytest -m gpu --noconftest tests/test_torch_kernels.py

(``--noconftest``: tests/conftest.py configures JAX).  Tests marked
``gpu`` skip here, inside the ``cuda`` fixture, when there is no card.

Tolerance, kernel vs plain version: 1e-3 absolute on 0..255 values and
identical fill positions.  Both round every float operation the same
way in the same order (see csrc/window_sampler.cu), so they agree bit
for bit in practice.
"""

import numpy as np
import pytest
import torch

import mods_tpu_torch.ops.sampler as TS
from mods_tpu_torch.config import CapacityParams, RansacParams
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


def _inputs(K, P, device, L=6, H=1000, W=640, seed=0):
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
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("K,P", [(1536, 19), (1024, 41)])
def test_kernel_matches_plain(cuda, K, P):
    ws, xy, A = _inputs(K, P, cuda)
    before = TS.sample_from_windows.launches
    got = TS.sample_from_windows(ws, xy, A, P, fill=0.0)
    torch.cuda.synchronize()
    assert TS.sample_from_windows.launches == before + 1
    ref = TS.sample_from_windows_plain(ws, xy, A, P, fill=0.0)
    assert torch.equal(got == 0.0, ref == 0.0)
    assert (got - ref).abs().max().item() <= 1e-3


@pytest.mark.gpu
def test_kernel_rejects_bad_inputs(cuda):
    ws, xy, A = _inputs(8, 19, cuda, L=1, H=160, W=256)
    with pytest.raises(ValueError):
        TS.sample_from_windows(ws, xy.double(), A, 19)
    with pytest.raises(ValueError):
        TS.sample_from_windows(ws, xy.cpu(), A, 19)


@pytest.mark.gpu
def test_step_on_card_matches_cpu(cuda):
    i1, i2 = _small_pair()
    before = TS.sample_from_windows.launches
    card = make_two_view_step(_small_cfg())(
        i1, i2, torch.Generator(device="cuda").manual_seed(0))
    assert TS.sample_from_windows.launches > before
    cpu = make_two_view_step(_small_cfg(), device="cpu")(
        i1, i2, torch.Generator().manual_seed(0))
    for k in ("n_tentatives", "n_inliers"):
        assert abs(int(card[k]) - int(cpu[k])) <= 0.1 * int(cpu[k])
    Hc = card["H"].cpu().numpy()
    Hp = cpu["H"].numpy()
    np.testing.assert_allclose(Hc / Hc[2, 2], Hp / Hp[2, 2], atol=0.05)
