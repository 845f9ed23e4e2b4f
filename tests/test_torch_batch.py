"""Port vs JAX reference: pair-batched and one-vs-many matching (CPU).

``mods_tpu_torch.parallel.multi`` against ``mods_tpu.parallel.multi``
(``mesh=None``) on the textured 128x160 pairs of ``tests/test_mesh.py``,
and against the port's own serial matcher.

Tolerances.
* Batched vs the port's serial ``TwoViewMatcher`` on an unpadded pair:
  each pair draws from a generator seeded as the serial matcher seeds
  it, and every stage computes a pair's rows as it does alone but for
  the rounding of the blurs: oneDNN convolves a batch of images
  otherwise than one image alone, by up to 2.1e-7 of a blurred level's
  largest value (one or two float32 ulps, on the pyramid levels past the
  first octave of this file's pairs).  That moves keypoints by up to
  2.3e-3 px and may add or drop one at a threshold.  Held: the same
  steps, tentatives within max(2, 5 %), counts under the RNG rule below,
  H's image corners within 0.1 px where the pair verified
  ``min_matches``, and at every rung each store within 2 rows of the
  serial store with >= 95 % of its rows twinned (``_twins``).
* Batched vs the JAX package's matchers: the same ``steps_used``,
  tentatives within 10 %, and verified counts under ROADMAP.md's RNG
  rule (the two packages draw other RANSAC samples): on the same side of
  ``min_matches`` and within max(6, 0.4 n).
* Batched helpers vs their per-pair calls on random inputs: equal.

Run as a script, ``JAX_PLATFORMS=cpu python tests/test_torch_batch.py
--jax-batch [--seeds N] PAIR...``, this file prints what the JAX
package's ``PairBatchMatcher`` finds on the ``.parity_work`` pairs at
full size, run as one batch on ``chip_smoke.py::CVIU_LADDER``: per pair
its rungs used, its tentatives at each rung the batch ran, its verified
matches, those within 3 px of the ground truth and its H's worst corner
error (``chip_smoke.py::JAX_BATCH_REFERENCE``); with ``--seeds N`` the
same for the matcher's seeds 0..N-1 (about 4 minutes for the first seed
of zoom2x, rot90 and tilt4 on 8 cores, 50 s each further seed).  With
``--jax-multi`` in place of ``--jax-batch`` it prints the same for the
JAX package's ``MultiMatcher(mesh=None)``: the pairs' shared image 1 as
the query against their image 2s as a gallery, run until every gallery
image is matched (``chip_smoke.py::JAX_MULTI_REFERENCE``).
"""

import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytest  # noqa: E402
import torch  # noqa: E402

from mods_tpu import config as jc  # noqa: E402
from mods_tpu import pipeline as jp  # noqa: E402
from mods_tpu.parallel import multi as jm  # noqa: E402
from mods_tpu_torch import config as tc  # noqa: E402
from mods_tpu_torch import pipeline as tp  # noqa: E402
from mods_tpu_torch.matching import fginn as tf  # noqa: E402
from mods_tpu_torch.parallel import manifest as tman  # noqa: E402
from mods_tpu_torch.parallel import multi as tm  # noqa: E402
from mods_tpu_torch.ransac.homography import ransac_h  # noqa: E402
from test_pipeline import textured_image, warp_np  # noqa: E402

torch.set_num_threads(2)

# tests/test_mesh.py's images: a textured image, its shift, and two
# unrelated textures
IMG_A = textured_image(128, 160, seed=3)
IMG_B = warp_np(IMG_A, np.array([[1.0, 0.0, 8.0], [0.0, 1.0, -5.0],
                                 [0, 0, 1.0]]), 128, 160)
IMG_C = textured_image(128, 160, seed=77)
IMG_D = textured_image(128, 160, seed=88)
PAIRS = [(IMG_A, IMG_B), (IMG_C, IMG_D), (IMG_A, IMG_B)]
# tests/test_mesh.py's config at smaller caps: a quarter of the keypoints
# and hypotheses, as the JAX package's batched programs take most of a
# minute on the CPU at its own
CFG = jp.EngineConfig(
    caps=jc.CapacityParams(per_octave=128, per_view=128, per_group=256,
                           per_image=256, max_angles=1, tentatives=256),
    ransac=jc.RansacParams(err_threshold=3.0, batch_hypotheses=128,
                           max_rounds=2))
LADDER = [jc.IterationParams(),
          jc.IterationParams(tilt_set=(2.0,), phi_base=120.0)]


def _port(obj, cls=None):
    return tc.from_dict(dataclasses.asdict(obj),
                        cls or getattr(tc, type(obj).__name__, None))


def _port_cfg(cfg):
    return tc.from_dict(dataclasses.asdict(cfg), tp.EngineConfig)


def _rows(st, p=None) -> np.ndarray:
    """A store's rows (xy, A, s, response, desc), pair p's where it has a
    pair axis, sorted by (response, x, y)."""
    def sel(a):
        return (a[:int(st._n)] if p is None
                else a[p, :int(st._n[p])]).numpy()

    xy, A, s, r, d = (sel(a) for a in (st._xy, st._A, st._s, st._r,
                                       st._d))
    rows = np.concatenate([xy, A.reshape(-1, 4), s[:, None], r[:, None], d],
                          1)
    return rows[np.lexsort((xy[:, 1], xy[:, 0], r))]


def _record_stores(matcher) -> list:
    """Each rung's store contents at its matching: wraps the matcher's
    ``_execute_plan``; appends {(side, detector, descriptor): store} a
    rung, the stores copied."""
    seen = []
    inner = matcher._execute_plan

    def execute_plan(stores1, stores2, *a, **kw):
        seen.append({(i,) + k: (st._xy.clone(), st._A.clone(),
                                st._s.clone(), st._r.clone(), st._d.clone(),
                                st._n.clone())
                     for i, side in enumerate((stores1, stores2))
                     for k, st in side.items()})
        return inner(stores1, stores2, *a, **kw)

    matcher._execute_plan = execute_plan
    return seen


def _twins(a: np.ndarray, b: np.ndarray) -> float:
    """The share of the rows of ``a`` (``_rows``) with a twin in ``b``:
    a row within 0.01 px whose affine frame, scale, response and
    descriptor agree within 0.02, 0.01, 0.05 and 2 (the descriptors are
    quantized to integers; the moves measured between a batched and a
    serial run are 2.3e-3 px, 6.6e-3, 7.5e-4, 7.2e-3 and 1)."""
    if not len(a):
        return float(not len(b))
    d = np.sqrt(((a[:, None, :2] - b[None, :, :2]) ** 2).sum(-1))
    j = d.argmin(1)
    diff = np.abs(a - b[j])
    ok = ((d[np.arange(len(a)), j] < 0.01)
          & (diff[:, 2:6].max(1) <= 0.02) & (diff[:, 6] <= 0.01)
          & (diff[:, 7] <= 0.05) & (diff[:, 8:].max(1) <= 2))
    return float(ok.mean())


def _corners(H) -> np.ndarray:
    """The image corners of a 128 x 160 image under H."""
    c = np.array([[0, 0, 1], [159, 0, 1], [0, 127, 1], [159, 127, 1.0]])
    q = c @ np.asarray(H, np.float64).T
    return q[:, :2] / q[:, 2:]


def _store(t):
    st = tp.DeviceStore.__new__(tp.DeviceStore)
    st._xy, st._A, st._s, st._r, st._d, st._n = t
    return st


@pytest.fixture(scope="module")
def port_batch():
    m = tm.PairBatchMatcher([_port(i) for i in LADDER], _port_cfg(CFG),
                            device="cpu")
    rungs = _record_stores(m.mm.qmatcher)
    r = m.match_batch(PAIRS)
    m.close()
    return r, rungs


@pytest.fixture(scope="module")
def jax_batch():
    return jm.PairBatchMatcher(LADDER, CFG).match_batch(PAIRS)


@pytest.fixture(scope="module")
def serial_runs():
    """The port's serial matcher on pairs 0 and 1 (pair 2 is pair 0)."""
    out = {}
    for p in (0, 1):
        m = tp.TwoViewMatcher([_port(i) for i in LADDER], _port_cfg(CFG),
                              seed=0, device="cpu")
        rungs = _record_stores(m)
        out[p] = out[p + 2] = (m.match(*PAIRS[p]), rungs)
    return out


def _rng_rule(got: int, ref: int, min_matches: int) -> None:
    assert (got >= min_matches) == (ref >= min_matches), (got, ref)
    assert abs(got - ref) <= max(6, 0.4 * ref), (got, ref)


def test_pair_batch_matcher_against_jax(port_batch, jax_batch):
    """tests/test_mesh.py::test_pair_batch_matcher's assertions on the
    port, and the port per pair against the JAX ``PairBatchMatcher``."""
    r, _ = port_batch
    mm = CFG.min_matches
    assert r.counts.shape == (3,)
    assert r.counts[0] >= mm and r.counts[2] >= mm, r.counts
    assert r.counts[1] < r.counts[0], r.counts
    assert len(r.xy1[0]) == r.counts[0]
    for p in range(3):
        assert r.steps_used[p] == jax_batch.steps_used[p]
        j = int(jax_batch.n_tentatives[p])
        assert abs(int(r.n_tentatives[p]) - j) <= 0.1 * j, (p, j)
        _rng_rule(int(r.counts[p]), int(jax_batch.counts[p]), mm)


@pytest.mark.parametrize("p", [0, 1, 2])
def test_pair_batch_equals_serial_run(port_batch, serial_runs, p):
    """Pair p of the batch (unpadded: all images 128x160) against the
    port's serial matcher with the generator seeded as the batch seeds
    pair p, within the bounds of the blurs' batch rounding (module
    docstring), at every rung the serial run reached (pair 1 runs both
    rungs, pairs 0 and 2 stop at rung 1 while the batch goes on)."""
    r, brungs = port_batch
    s, srungs = serial_runs[p]
    mm = CFG.min_matches
    assert int(r.steps_used[p]) == s.steps_used
    assert abs(int(r.n_tentatives[p]) - s.n_tentatives) \
        <= max(2, 0.05 * s.n_tentatives), (r.n_tentatives[p], s.n_tentatives)
    _rng_rule(int(r.counts[p]), s.n_matches, mm)
    assert len(r.xy1[p]) == r.counts[p]
    if s.n_matches >= mm:
        np.testing.assert_allclose(_corners(r.H[p]), _corners(s.H), atol=0.1)
    assert len(srungs) == s.steps_used
    for brung, srung in zip(brungs, srungs):
        assert brung.keys() == srung.keys()
        for k in srung:
            a, b = _rows(_store(brung[k]), p), _rows(_store(srung[k]))
            assert abs(len(a) - len(b)) <= 2, (k, len(a), len(b))
            assert _twins(a, b) >= 0.95, k


def _gallery_cases():
    """tests/test_mesh.py's two one-vs-many cases, mesh=None: (query,
    gallery, ladder, config, stop_at_first, the gallery index of the true
    match)."""
    q = IMG_A
    H = np.array([[1.0, 0.0, 6.0], [0.0, 1.0, -4.0], [0, 0, 1.0]])
    hess = (q, [textured_image(128, 160, seed=50), IMG_B,
                textured_image(128, 160, seed=51)],
            [jc.IterationParams()], CFG, True)
    orb_mser = (q, [IMG_C, warp_np(q, H, 128, 160)], [
        jc.IterationParams(detector="ORB", descriptors=("ORB",),
                           fginn_threshold=(0.0,),
                           distance_threshold=(60.0,)),
        jc.IterationParams(detector="MSER", descriptors=("RootSIFT",),
                           fginn_threshold=(0.85,))],
        dataclasses.replace(CFG, min_matches=1000), False)
    return {"hessaff": hess, "orb_mser": orb_mser}


@pytest.mark.parametrize("case", ["hessaff", "orb_mser"])
def test_multi_matcher_against_jax(case):
    """One query against a gallery (mods_multi): the port's
    ``MultiMatcher`` against the JAX package's with ``mesh=None`` per
    gallery image, and tests/test_mesh.py's own assertions
    (``test_multi_matcher_pair_sharded`` with three gallery images, and
    ``test_multi_matcher_cviu_subset_with_mser``: an ORB and a host-stage
    MSER rung, both run)."""
    q, gallery, ladder, cfg, first = _gallery_cases()[case]
    ref = jm.MultiMatcher(ladder, cfg).match(q, gallery, stop_at_first=first)
    m = tm.MultiMatcher([_port(i) for i in ladder], _port_cfg(cfg),
                        device="cpu")
    r = m.match(q, gallery, stop_at_first=first)
    m.close()
    assert r.counts.shape == (len(gallery),)
    assert r.steps_used == ref.steps_used
    for p in range(len(gallery)):
        j = int(ref.n_tentatives[p])
        assert abs(int(r.n_tentatives[p]) - j) <= max(0.1 * j, 1), (p, j)
        _rng_rule(int(r.counts[p]), int(ref.counts[p]), cfg.min_matches)
        assert len(r.xy1[p]) == r.counts[p]
    if case == "hessaff":
        assert r.counts[1] >= cfg.min_matches, r.counts
        assert r.counts[1] == r.counts.max(), r.counts
    else:
        assert r.steps_used == 2
        assert r.counts[1] > r.counts[0], r.counts
        assert r.counts[1] >= 10, r.counts


def _random_lists(P=3, N=96, D=32, seed=0):
    """Integer-valued descriptors (as SIFT's, so distance products are
    exact) with ~80 % valid rows, and their coordinates, a pair batch."""
    rng = np.random.default_rng(seed)
    d = torch.from_numpy(rng.integers(0, 6, (2, P, N, D)).astype(np.float32))
    m = torch.from_numpy(rng.uniform(0, 1, (2, P, N)) < 0.8)
    xy = torch.from_numpy(rng.uniform(0, 40, (P, N, 2)).astype(np.float32))
    return d[0], m[0], d[1], m[1], xy


def _same(batched, one_by_one):
    for k in ("idx2", "d1", "d2", "ratio", "mask"):
        assert torch.equal(getattr(batched, k), torch.stack(
            [getattr(t, k) for t in one_by_one])), k


@pytest.mark.parametrize("helper", ["fginn", "fginn_db", "distance",
                                    "duplicate_filter", "store_append"])
def test_batched_helpers_equal_per_pair_calls(helper):
    """Each helper on a (P, ...) batch against P calls, one a pair."""
    d1, m1, d2, m2, xy = _random_lists()
    P = d1.shape[0]
    if helper in ("fginn", "fginn_db"):
        db = None
        if helper == "fginn_db":
            g = torch.Generator().manual_seed(1)
            db = (torch.randint(0, 6, (40, 32), generator=g).float(),
                  torch.arange(40) < 33)
        _same(tf.match_fginn(d1, m1, d2, m2, xy, 0.9, 5.0, 8, db=db),
              [tf.match_fginn(d1[p], m1[p], d2[p], m2[p], xy[p], 0.9, 5.0,
                              8, db=db) for p in range(P)])
    elif helper == "distance":
        _same(tf.match_distance(d1, m1, d2, m2, 6.0, row_tile=40),
              [tf.match_distance(d1[p], m1[p], d2[p], m2[p], 6.0)
               for p in range(P)])
    elif helper == "duplicate_filter":
        xy2 = xy.flip(1) * 0.5
        prio = torch.from_numpy(np.random.default_rng(3).uniform(
            0, 1, m1.shape).astype(np.float32))
        got = tf.duplicate_filter(xy, xy2, m1, 6.0, priority=prio)
        assert (got != m1).any()           # the filter drops some rows
        assert torch.equal(got, torch.stack([tf.duplicate_filter(
            xy[p], xy2[p], m1[p], 6.0, priority=prio[p])
            for p in range(P)]))
    else:
        batched = tp.BatchedDeviceStore(P, 100, 32)
        alone = [tp.DeviceStore(100, 32) for _ in range(P)]
        for n in ([50, 60, 0], [40, 7, 96]):         # past the capacity
            n = torch.tensor(n)
            A = xy[..., None].expand(P, 96, 2, 2)
            batched.append(xy, A, xy[..., 0], xy[..., 1], d1, n)
            for p, st in enumerate(alone):
                st.append(xy[p], A[p], xy[p, :, 0], xy[p, :, 1], d1[p],
                          n[p])
        assert batched._n.tolist() == [90, 67, 96]
        for p, st in enumerate(alone):
            for a, b in zip(batched.device_arrays(), st.device_arrays()):
                assert torch.equal(a[p], b)


def test_batched_ransac_h_equals_serial_calls():
    """LO-RANSAC H on a pair batch with P generators against the serial
    call with each: pair p draws exactly the serial draws, so H, inliers
    and counts are equal, though the pairs need different round counts
    (pair 2's outliers keep its adaptive count high)."""
    rng = np.random.default_rng(5)
    P, N = 3, 160
    Hs = [np.array([[1.0, 0.02, 5.0], [-0.01, 0.97, -3.0],
                    [1e-4, 0.0, 1.0]]) * (1 + 0.1 * p) for p in range(P)]
    xy1 = rng.uniform(0, 300, (P, N, 2))
    xy2 = np.empty_like(xy1)
    for p in range(P):
        q = np.c_[xy1[p], np.ones(N)] @ Hs[p].T
        xy2[p] = q[:, :2] / q[:, 2:] + rng.normal(0, 0.3, (N, 2))
        out = rng.uniform(0, 1, N) < (0.2, 0.4, 0.7)[p]
        xy2[p, out] = rng.uniform(0, 300, (out.sum(), 2))
    mask = rng.uniform(0, 1, (P, N)) < 0.9
    xy1, xy2 = (torch.from_numpy(a.astype(np.float32)) for a in (xy1, xy2))
    mask = torch.from_numpy(mask)
    pars = tc.RansacParams(err_threshold=2.0, batch_hypotheses=64,
                           max_rounds=6)
    H, inl, n = ransac_h(xy1, xy2, mask, pars,
                         [torch.Generator().manual_seed(s)
                          for s in (0, 1, 2)])
    for p, s in enumerate((0, 1, 2)):
        Hp, inlp, nnp = ransac_h(xy1[p], xy2[p], mask[p], pars,
                                 torch.Generator().manual_seed(s))
        assert torch.equal(H[p], Hp) and torch.equal(inl[p], inlp)
        assert int(n[p]) == int(nnp) >= 0.5 * N * (0.8, 0.6, 0.3)[p]


def test_run_manifest_resume_and_retries(tmp_path):
    """tests/test_aux.py::test_run_manifest_resume on the port's
    ``RunManifest``, and ``with_retries``: a transient error is retried,
    any other raises at once."""
    mpath = str(tmp_path / "run.manifest.json")
    m = tman.RunManifest.load(mpath, query="q.png")
    paths = ["a.png", "b.png", "c.png"]
    assert m.pending(paths) == paths
    m.record("a.png", 12, 40, 2)
    m.save()
    m2 = tman.RunManifest.load(mpath, query="q.png")
    assert m2.pending(paths) == ["b.png", "c.png"]
    assert m2.result("a.png")["n_matches"] == 12
    m3 = tman.RunManifest.load(mpath, query="other.png")
    assert m3.pending(paths) == paths

    calls = []

    def flaky():
        calls.append(None)
        if len(calls) < 3:
            raise RuntimeError("CUDA error: UNAVAILABLE")
        return 7

    assert tman.with_retries(flaky, base_delay=0.0) == 7 and len(calls) == 3

    def broken():
        calls.append(None)
        raise RuntimeError("CUDA error: an illegal memory access")

    del calls[:]
    with pytest.raises(RuntimeError):
        tman.with_retries(broken, base_delay=0.0)
    assert len(calls) == 1


@pytest.mark.parametrize("cls", ["MultiMatcher", "PairBatchMatcher"])
def test_matchers_default_to_the_card(cls):
    """Both matchers run on the card unless the caller asks for the CPU:
    without a card the default raises, nothing falls back; a mesh of
    several GPUs is ROADMAP.md item 22."""
    make = getattr(tm, cls)
    if torch.cuda.is_available():
        assert make().cfg is not None
    else:
        with pytest.raises(RuntimeError, match="no GPU"):
            make()
    with pytest.raises(NotImplementedError, match="item 22"):
        make(mesh=object(), device="cpu")


def _jax_batch_main(pairs, n_seeds=1, multi=False):
    from PIL import Image
    import chip_smoke

    def load(pair):
        imgs = [np.asarray(Image.open(os.path.join(
            REPO, ".parity_work", f"{pair}_{i}.png")), np.float32)
            for i in (1, 2)]
        return imgs + [np.loadtxt(os.path.join(REPO, ".parity_work",
                                               f"{pair}_H.txt"))]

    data = [load(p) for p in pairs]
    for seed in range(n_seeds):
        if multi:
            m = jm.MultiMatcher(chip_smoke.cviu_rungs(jc), jp.EngineConfig(),
                                seed=seed)
            hook = m
        else:
            m = jm.PairBatchMatcher(chip_smoke.cviu_rungs(jc),
                                    jp.EngineConfig(), seed=seed)
            hook = m.mm
        tents = []
        verify = hook._verify_bank

        def keep(bank, log):
            out = verify(bank, log)
            tents.append(None if out is None
                         else np.asarray(out["n_tent"]).tolist())
            return out

        hook._verify_bank = keep
        t0 = time.time()
        if multi:
            # the pairs share their image 1: one query against the image
            # 2s, until every gallery image is matched
            r = m.match(data[0][0], [b for _, b, _ in data],
                        stop_at_first=False)
        else:
            r = m.match_batch([(a, b) for a, b, _ in data])
        dt = time.time() - t0
        for i, (pair, (a, _, H_gt)) in enumerate(zip(pairs, data)):
            h, w = a.shape
            print(json.dumps({pair: dict(
                seed=seed,
                steps=int(r.steps_used if multi else r.steps_used[i]),
                tentatives_per_rung=[t[i] if t else 0 for t in tents],
                tentatives=int(r.n_tentatives[i]),
                matches=int(r.counts[i]),
                gt_consistent=chip_smoke._gt_consistent(H_gt, r.xy1[i],
                                                        r.xy2[i]),
                corner_error_px=round(chip_smoke._corner_error(
                    r.H[i], H_gt, w, h), 3),
                batch_seconds=round(dt, 1))}), flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    seeds = 1
    if "--seeds" in args:
        i = args.index("--seeds")
        seeds = int(args[i + 1])
        del args[i:i + 2]
    if args[:1] in (["--jax-batch"], ["--jax-multi"]):
        _jax_batch_main(args[1:] or ["zoom2x", "rot90", "tilt4"], seeds,
                        multi=args[0] == "--jax-multi")
