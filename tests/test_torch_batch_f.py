"""Port vs JAX reference: F verification over a pair batch (CPU).

``ransac/fundamental.py::ransac_f`` (LORANSACF, DEGENSAC) and
``ransac/orsa.py::orsa_f`` with a leading pair axis, as ``ransac_h`` has
one, and the pair-batched matchers that verify with them.

Tolerances.
* Batched against pair-by-pair calls: each pair draws from its own
  generator exactly what the serial call draws, and every other step
  computes a pair's rows as the serial call does, so F, the inlier
  masks, the counts, ``degen`` and ``log_nfa`` are equal.
* ``PairBatchMatcher`` with LORANSACF and ORSA against the JAX package's
  (``mods_tpu/parallel/multi.py``, which vmaps ``_verify_core`` over the
  pairs): the same ``steps_used``, tentatives within 10 % and verified
  counts under ROADMAP.md's RNG rule (the packages draw other samples):
  on the same side of ``min_matches`` and within max(6, 0.4 n); and
  against the port's own serial matcher, ``tests/test_torch_batch.py``'s
  bounds of the blurs' batch rounding.
* ``chip_smoke.py``'s round-by-round witness of ORSA (``orsa_trace``,
  ``orsa_rounds``, ``orsa_parting``, ``orsa_ops_alone``), which on the
  card finds where a batch parts from its pairs alone: on the CPU
  nothing parts, and a pair moved by 2e-3 px parts where it should.
"""

import dataclasses
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytest  # noqa: E402
import torch  # noqa: E402

import chip_smoke  # noqa: E402

from mods_tpu import config as jc  # noqa: E402
from mods_tpu import pipeline as jp  # noqa: E402
from mods_tpu.parallel import multi as jm  # noqa: E402
from mods_tpu_torch import config as tc  # noqa: E402
from mods_tpu_torch import pipeline as tp  # noqa: E402
from mods_tpu_torch.parallel import multi as tm  # noqa: E402
from mods_tpu_torch.ransac.fundamental import ransac_f  # noqa: E402
from mods_tpu_torch.ransac.orsa import orsa_f  # noqa: E402
from test_pipeline import textured_image, warp_np  # noqa: E402

torch.set_num_threads(2)


def _two_views(seed=5, P=3, N=160):
    """P pairs of N projections of random 3-D points into two cameras
    (a rotation about y of 0.1 p rad and a baseline), 0.3 px noise, 20 /
    40 / 60 % outliers, ~90 % of the rows valid."""
    rng = np.random.default_rng(seed)
    K = np.array([[300.0, 0, 150], [0, 300, 150], [0, 0, 1]])
    xy1 = np.zeros((P, N, 2))
    xy2 = np.zeros((P, N, 2))
    for p in range(P):
        X = np.c_[rng.uniform(-1, 1, (N, 2)), rng.uniform(3, 6, N)]
        a = 0.1 * (p + 1)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        x1 = X @ K.T
        x2 = (X @ R.T + [0.5, 0.1, 0.0]) @ K.T
        xy1[p] = x1[:, :2] / x1[:, 2:]
        xy2[p] = x2[:, :2] / x2[:, 2:] + rng.normal(0, 0.3, (N, 2))
        out = rng.uniform(0, 1, N) < (0.2, 0.4, 0.6)[p]
        xy2[p, out] = rng.uniform(0, 300, (out.sum(), 2))
    mask = torch.from_numpy(rng.uniform(0, 1, (P, N)) < 0.9)
    return (torch.from_numpy(xy1.astype(np.float32)),
            torch.from_numpy(xy2.astype(np.float32)), mask)


@pytest.mark.parametrize("symm", [False, True])
def test_batched_ransac_f_equals_serial_calls(symm):
    """DEGENSAC on three pairs with three generators against the serial
    call with each, though the pairs need different round counts."""
    xy1, xy2, mask = _two_views()
    pars = tc.RansacParams(err_threshold=2.0, batch_hypotheses=64,
                           max_rounds=6, do_symm_check=symm)
    F, inl, n, degen = ransac_f(xy1, xy2, mask, pars,
                                [torch.Generator().manual_seed(s)
                                 for s in range(3)])
    assert F.shape == (3, 3, 3) and degen.shape == (3,)
    for p in range(3):
        Fp, ip, np_, dp = ransac_f(xy1[p], xy2[p], mask[p], pars,
                                   torch.Generator().manual_seed(p))
        assert torch.equal(F[p], Fp) and torch.equal(inl[p], ip)
        assert int(n[p]) == int(np_) and bool(degen[p]) == bool(dp)
    assert int(n[0]) >= 0.7 * int(mask[0].sum())


def test_batched_orsa_f_equals_serial_calls():
    """ORSA on three pairs against the serial call with each: the same
    F, inliers and log10 NFA."""
    xy1, xy2, mask = _two_views(seed=7)
    pars = tc.OrsaParams()
    F, inl, n, nfa = orsa_f(xy1, xy2, mask, 300, 300, pars,
                            [torch.Generator().manual_seed(s)
                             for s in range(3)])
    for p in range(3):
        Fp, ip, np_, nfp = orsa_f(xy1[p], xy2[p], mask[p], 300, 300, pars,
                                  torch.Generator().manual_seed(p))
        assert torch.equal(F[p], Fp) and torch.equal(inl[p], ip)
        assert int(n[p]) == int(np_) and float(nfa[p]) == float(nfp)
        assert float(nfa[p]) < pars.max_log_nfa


def _orsa_traces(xy1, xy2, mask, nudge=None):
    """``chip_smoke.orsa_trace`` of ``pipeline._verify_core``'s ORSA on a
    pair batch (a generator a pair, all seeded 0) and on each pair alone
    from the same seed, cut into rounds; ``nudge(p, xy2_p)`` changes a
    pair's points in its run alone."""
    P, N = mask.shape
    cfg = tp.EngineConfig(ver_type="ORSA")
    A = torch.eye(2).expand(P, N, 2, 2).contiguous()
    s = torch.ones(P, N)
    prio = torch.arange(N, dtype=torch.float32).expand(P, N).contiguous()
    rows = [xy1, A, s, xy2, A, s, prio, mask]
    gens = [torch.Generator().manual_seed(0) for _ in range(P)]
    batch = chip_smoke.orsa_rounds(chip_smoke.orsa_trace(
        lambda: tp._verify_core(cfg, 300, 300, *rows, gens))[1], gens)
    alone = []
    for p in range(P):
        r = [x[p] for x in rows]
        if nudge:
            r[3] = nudge(p, r[3])
        g = [torch.Generator().manual_seed(0)]
        alone.append(chip_smoke.orsa_rounds(chip_smoke.orsa_trace(
            lambda: tp._verify_core(cfg, 300, 300, *r, g[0]))[1], g))
    return batch, alone


def test_orsa_round_by_round_witness_batched_against_alone():
    """``chip_smoke.py --probe-batched-f``'s round-by-round comparison on
    the CPU, where a batch and each pair alone are bit-equal: nothing
    parts, and every op of a round gives a pair's row alone as in the
    batch.  A pair's points moved by 2e-3 px in its run alone part first
    in the prologue's normalization, from unequal inputs, and its best
    model then parts in round 0."""
    xy1, xy2, mask = _two_views(seed=7)
    batch, alone = _orsa_traces(xy1, xy2, mask)
    assert [len(a["rounds"]) for a in alone] == [
        sum(p in act for act in batch["acts"]) for p in range(3)]
    for rec in chip_smoke.orsa_parting(batch, alone)["pairs"]:
        assert rec["first_op"] is None and rec["first_state"] is None \
            and rec["first_draw"] is None, rec
    assert all(v is None for v in chip_smoke.orsa_ops_alone(
        batch, 0, 1, "cpu").values())
    assert all(v is None for v in chip_smoke.orsa_ops_alone(
        batch, None, 2, "cpu").values())

    def nudge(p, xy):
        return xy + torch.tensor([2e-3, 0.0]) if p == 1 else xy
    _, moved = _orsa_traces(xy1, xy2, mask, nudge)
    recs = chip_smoke.orsa_parting(batch, moved)["pairs"]
    assert recs[0]["first_op"] is None and recs[2]["first_op"] is None
    first = recs[1]["first_op"]
    assert first["part"] == "prologue" and first["op"] == "_normalization"
    assert first["inputs"]["max_abs_diff"] > 0
    assert recs[1]["first_state"]["round"] == 0


# tests/test_torch_batch.py's pairs (a shift, two unrelated textures, the
# shift again) at its small caps, on one HessianAffine rung
IMG_A = textured_image(128, 160, seed=3)
IMG_B = warp_np(IMG_A, np.array([[1.0, 0.0, 8.0], [0.0, 1.0, -5.0],
                                 [0, 0, 1.0]]), 128, 160)
PAIRS = [(IMG_A, IMG_B), (textured_image(128, 160, seed=77),
                          textured_image(128, 160, seed=88)),
         (IMG_A, IMG_B)]


def _cfg(ver):
    return jp.EngineConfig(
        caps=jc.CapacityParams(per_octave=128, per_view=128, per_group=256,
                               per_image=256, max_angles=1, tentatives=256),
        ransac=jc.RansacParams(err_threshold=3.0, batch_hypotheses=128,
                               max_rounds=2), ver_type=ver)


@pytest.mark.parametrize("ver", ["LORANSACF", "ORSA"])
def test_pair_batch_f_modes_against_jax_and_serial(ver):
    """A pair batch verified by F: the port against the JAX package's
    ``PairBatchMatcher`` per pair, and against the port's serial matcher
    on each pair."""
    cfg = _cfg(ver)
    ladder = [jc.IterationParams()]
    ref = jm.PairBatchMatcher(ladder, cfg).match_batch(PAIRS)
    tcfg = tc.from_dict(dataclasses.asdict(cfg), tp.EngineConfig)
    tladder = [tc.from_dict(dataclasses.asdict(i), tc.IterationParams)
               for i in ladder]
    m = tm.PairBatchMatcher(tladder, tcfg, device="cpu")
    got = m.match_batch(PAIRS)
    m.close()
    mm = cfg.min_matches
    assert got.counts[0] >= mm and got.counts[2] >= mm, got.counts
    assert got.counts[1] < got.counts[0]
    for p in range(3):
        assert got.steps_used[p] == ref.steps_used[p]
        j = int(ref.n_tentatives[p])
        assert abs(int(got.n_tentatives[p]) - j) <= max(0.1 * j, 1), (p, j)
        g, r = int(got.counts[p]), int(ref.counts[p])
        assert (g >= mm) == (r >= mm) and abs(g - r) <= max(6, 0.4 * r)
        assert len(got.xy1[p]) == g
    for p in (0, 1):
        s = tp.TwoViewMatcher(tladder, tcfg, device="cpu").match(*PAIRS[p])
        assert s.steps_used == got.steps_used[p]
        assert abs(s.n_tentatives - int(got.n_tentatives[p])) \
            <= max(2, 0.05 * s.n_tentatives)
        g = int(got.counts[p])
        assert (g >= mm) == (s.n_matches >= mm)
        assert abs(g - s.n_matches) <= max(6, 0.4 * s.n_matches)
