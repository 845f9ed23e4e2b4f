"""Port vs JAX reference: the CNN descriptor, the Oxford and benchmark
files, and the ``export_descriptors`` and ``extract_benchmark`` commands
(CPU).

Tolerances.  ``cnn_forward`` to 2e-6 with either weight set and every
normalization (float32 convolutions in another order); the
nearest-neighbour accuracies of ``tests/test_cnn.py``'s quality protocol
on the same patches equal to the JAX package's within 1/128 (one patch
of 128).  The files: byte for byte.  The commands: the same stores and
row counts, rows paired by position within 5e-3 px (each package runs
its own detection, which rounds keypoints apart by up to 3e-3 px), the
descriptors of each family within the describe stage's bounds of
``test_torch_desc_ladder.py`` on 95 % of the rows.
"""

import dataclasses
import hashlib
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mods_tpu.descriptors import cnn as JC  # noqa: E402
from mods_tpu.io import oxford as JO  # noqa: E402
from mods_tpu_torch.descriptors import cnn as TC  # noqa: E402
from mods_tpu_torch.io import oxford as TO  # noqa: E402
from test_oxford_io import random_regions  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """The procedural bank's QR in one BLAS thread: OpenBLAS's threads
    spin for minutes when the test workers fill the machine (a 800x800
    QR: 17.6 s against 0.14 s on a loaded 8-core host); the result is the
    same (``chip_smoke.PROCEDURAL_SHA256``)."""
    from threadpoolctl import threadpool_limits
    with threadpool_limits(1, user_api="blas"):
        yield


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_trained_weights_are_the_jax_packages():
    assert _sha(TC.DEFAULT_WEIGHTS) == _sha(JC.DEFAULT_WEIGHTS)


@pytest.mark.parametrize("norm", ["L2", "L1", "RootL2", "none"])
@pytest.mark.parametrize("weights", ["trained", "procedural"])
def test_cnn_forward_against_jax(norm, weights):
    rng = np.random.default_rng(0)
    p = rng.uniform(0, 255, (16, 32, 32)).astype(np.float32)
    p[-2:] = 128.0                                  # flat patches
    w = (JC.weights_for("", 32, 128) if weights == "trained"
         else JC.procedural_weights(32, 128))
    a = np.asarray(JC.cnn_forward(jnp.asarray(p), w, norm))
    b = TC.cnn_forward(torch.from_numpy(p), w, norm).numpy()
    assert b.shape == (16, 128)
    np.testing.assert_allclose(b, a, atol=2e-6, rtol=0)
    net = TC.CnnDescriptor(w, "cpu", norm)
    assert torch.equal(net(torch.from_numpy(p)), torch.from_numpy(b))


def test_weights_resolve_as_jax(tmp_path):
    """An explicit path, then the packaged net at P = 32 and dim 128,
    then the procedural bank; the procedural bank's hash is the one
    ``chip_smoke.py`` holds the card machine's to."""
    import chip_smoke
    path = str(tmp_path / "w.npz")
    w = JC.procedural_weights(24, 64)
    np.savez(path, **dict(zip(TC.WEIGHT_KEYS, w)))
    for args in ((path, 32, 128), ("", 32, 128), ("", 24, 64)):
        ref, got = JC.weights_for(*args), TC.weights_for(*args)
        assert len(ref) == len(got) == 6
        for x, y in zip(ref, got):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)
    assert TC.weights_sha256(TC.procedural_weights(32, 128)) \
        == TC.weights_sha256(JC.procedural_weights(32, 128)) \
        == chip_smoke.PROCEDURAL_SHA256
    net = TC.net_for("", 32, 128, "L2", "cpu")
    assert net is TC.net_for("", 32, 128, "L2", "cpu")
    assert net.w3.shape == (128, 32, 5, 5)


def test_quality_protocol_on_a_parity_pair():
    """``tests/test_cnn.py``'s quality protocol on ``.parity_work``'s
    zoom2x image 1 in place of the reference's cat: 128 points, a
    patch set and its rotated, rescaled, photometrically jittered twin,
    nearest-neighbour accuracy.  The port's accuracies with the trained
    and the procedural weights equal the JAX package's on the same
    patches within 1/128."""
    from PIL import Image
    from mods_tpu.ops.warp import extract_patches
    img = np.asarray(Image.open(os.path.join(
        REPO, ".parity_work", "zoom2x_1.png")).convert("L"), np.float32)
    h, w = img.shape
    rng = np.random.default_rng(4)
    N = 128
    xy = np.stack([rng.uniform(80, w - 80, N),
                   rng.uniform(80, h - 80, N)], -1).astype(np.float32)

    def patch_set(P, jitter):
        th = rng.uniform(0, 2 * np.pi, N) if jitter is None else jitter[0]
        dth = rng.uniform(-0.15, 0.15, N)
        sc = np.exp(rng.uniform(-0.25, 0.25, N))
        thh = th + (0 if jitter is None else dth)
        A = np.stack([np.stack([np.cos(thh), -np.sin(thh)], -1),
                      np.stack([np.sin(thh), np.cos(thh)], -1)], -2)
        A = (A * (sc * 12.0 / (P / 2))[:, None, None]).astype(np.float32)
        p = np.asarray(extract_patches(jnp.asarray(img), jnp.asarray(xy),
                                       jnp.asarray(A), P))
        if jitter is not None:
            p = np.clip(p * np.exp(rng.uniform(-0.2, 0.2))
                        + rng.uniform(-15, 15)
                        + rng.normal(0, 2, p.shape), 0, 255)
        return th, p.astype(np.float32)

    def nn_acc(da, db):
        d = ((da[:, None] - db[None]) ** 2).sum(-1)
        return float((d.argmin(1) == np.arange(N)).mean())

    th, pa = patch_set(32, None)
    _, pb = patch_set(32, (th,))
    acc = {}
    for name, weights in (("trained", JC.weights_for("", 32, 128)),
                          ("procedural", JC.procedural_weights(32, 128))):
        ref = nn_acc(*(np.asarray(JC.cnn_forward(jnp.asarray(p), weights))
                       for p in (pa, pb)))
        got = nn_acc(*(TC.cnn_forward(torch.from_numpy(p), weights).numpy()
                       for p in (pa, pb)))
        assert abs(got - ref) <= 1 / 128, (name, got, ref)
        acc[name] = got
    assert acc["trained"] > acc["procedural"], acc


# ---------------------------------------------------------------------------
# io/oxford.py

def test_ellipse_frame_roundtrip():
    xy, A, s = random_regions()
    abc = TO.frames_to_ellipses(A, s)
    np.testing.assert_array_equal(abc, JO.frames_to_ellipses(A, s))
    A2, s2 = TO.ellipses_to_frames(abc)
    cov1 = np.einsum("nij,nkj->nik", A, A) * (s ** 2)[:, None, None]
    cov2 = np.einsum("nij,nkj->nik", A2, A2) * (s2 ** 2)[:, None, None]
    np.testing.assert_allclose(cov1, cov2, rtol=1e-8)
    np.testing.assert_allclose(np.linalg.det(A2), 1.0, rtol=1e-8)


@pytest.mark.parametrize("with_desc", [True, False])
def test_oxford_files_equal_jax(tmp_path, with_desc):
    xy, A, s = random_regions(11, 1)
    desc = (np.random.default_rng(2).uniform(0, 1, (11, 16))
            if with_desc else None)
    pj, pt = str(tmp_path / "j.oxf"), str(tmp_path / "t.oxf")
    JO.write_oxford(pj, xy, A, s, desc)
    TO.write_oxford(pt, xy, A, s, desc)
    assert _sha(pj) == _sha(pt)
    for a, b in zip(JO.read_oxford(pj), TO.read_oxford(pj)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)
    xy2, A2, s2, d2 = TO.read_oxford(pt)
    np.testing.assert_allclose(xy2, xy, rtol=1e-6)
    if with_desc:
        np.testing.assert_allclose(d2, desc, rtol=1e-6)


def test_kps_and_benchmark_files_equal_jax(tmp_path):
    xy, A, s = random_regions(7, 3)
    pj, pt = str(tmp_path / "j.kps"), str(tmp_path / "t.kps")
    JO.write_kps(pj, xy, A, s)
    TO.write_kps(pt, xy, A, s)
    assert _sha(pj) == _sha(pt)
    for a, b, ref in zip(TO.read_kps(pt), JO.read_kps(pj), (xy, A, s)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, ref, rtol=1e-6)
    desc = np.random.default_rng(4).normal(size=(5, 8))
    dj, dt = str(tmp_path / "j.desc"), str(tmp_path / "t.desc")
    JO.write_descriptors_benchmark(dj, desc)
    TO.write_descriptors_benchmark(dt, desc)
    assert _sha(dj) == _sha(dt)
    np.testing.assert_array_equal(TO.read_descriptors_benchmark(dt),
                                  JO.read_descriptors_benchmark(dj))
    np.testing.assert_allclose(TO.read_descriptors_benchmark(dt), desc,
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the exporter commands

EXPORTED = ("SURF", "LIOP", "MLDB", "CNN", "RootSIFT")


@pytest.fixture(scope="module")
def exporter_inputs(tmp_path_factory):
    """A 160x192 textured PNG, its shift's H, and chip_smoke.py's INI
    files for one HessianAffine iteration with several families."""
    from PIL import Image
    import chip_smoke
    from test_pipeline import textured_image
    d = tmp_path_factory.mktemp("exporters")
    img = str(d / "a.png")
    Image.fromarray(textured_image(160, 192, seed=21).astype(np.uint8)).save(
        img)
    H = str(d / "H.txt")
    np.savetxt(H, [[1.0, 0.05, 12.0], [-0.03, 1.0, -9.0], [1e-4, 0, 1.0]])
    n = len(EXPORTED)
    (d / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
    (d / "iters.ini").write_text(chip_smoke.cviu_iters_ini([([dict(
        chip_smoke._HESAFF, tilt_set=(1.0,), descriptors=EXPORTED,
        fginn_threshold=(0.8,) * n, distance_threshold=(0.0,) * n)],
        None)]))
    return d, img, H, [str(d / "config.ini"), str(d / "iters.ini")]


def _files(out: str) -> dict:
    return {name: f"{out}.HessianAffine.{name}" for name in EXPORTED}


def _pair_rows(a, b, key_cols=2):
    """Rows of ``b`` paired with ``a``'s by the nearest position."""
    d = np.sqrt(((a[:, None, :key_cols] - b[None, :, :key_cols]) ** 2)
                .sum(-1))
    j = d.argmin(1)
    return b[j], d[np.arange(len(a)), j]


def _hold_descriptors(name, a, b):
    """The describe stage's bounds, on 95 % of the rows where they are
    99 % there: detection itself runs in both packages here, and its
    float32 rounding moves keypoints by up to 3e-3 px, which moves the
    patches."""
    dd = np.abs(a - b)
    if name == "RootSIFT":
        assert (dd.max(1) <= 1.0).mean() >= 0.95
    elif name == "MLDB":
        assert (dd == 0).mean() >= 0.99
    elif name == "LIOP":
        # a rank descriptor: a pixel moving bins moves a row by about
        # 0.012 (one of 16 % of the rows here), a few pixels by 0.05
        assert (dd.max(1) <= 0.05).mean() >= 0.95
        assert (dd.max(1) <= 1e-3).mean() >= 0.8
    else:
        assert dd.max() <= 0.01 and (dd.max(1) <= 1e-3).mean() >= 0.95, (
            name, dd.max(), (dd.max(1) <= 1e-3).mean())


def test_export_descriptors_against_jax(exporter_inputs, capsys):
    from mods_tpu import cli as jcli
    from mods_tpu_torch import cli as tcli
    d, img, _, inis = exporter_inputs
    assert jcli.cmd_export_descriptors([img, str(d / "j")] + inis) == 0
    assert tcli.main(["export_descriptors", img, str(d / "t")] + inis
                     + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for name, (fj, ft) in zip(EXPORTED, zip(_files(str(d / "j")).values(),
                                            _files(str(d / "t")).values())):
        a, b = (TO.read_descriptors_benchmark(f) for f in (fj, ft))
        assert a.shape == b.shape and len(a) > 20, name
        assert f"HessianAffine/{name}: {len(b)} descriptors -> {ft}" in out
        _hold_descriptors(name, a, b)


def test_extract_benchmark_against_jax(exporter_inputs):
    from mods_tpu import cli as jcli
    from mods_tpu_torch import cli as tcli
    d, img, H, inis = exporter_inputs
    assert jcli.cmd_extract_benchmark([img, str(d / "jr"), H] + inis) == 0
    assert tcli.cmd_extract_benchmark([img, str(d / "tr"), H] + inis,
                                      device="cpu") == 0
    for name in EXPORTED:
        (xa, Aa, sa, da), (xb, Ab, sb, db) = (
            TO.read_oxford(f"{d / p}.HessianAffine.{name}")
            for p in ("jr", "tr"))
        assert len(xa) == len(xb) > 20, name
        rows, dist = _pair_rows(np.c_[xa, da], np.c_[xb, db])
        assert dist.max() <= 5e-3, name
        cov = [np.einsum("nij,nkj->nik", A, A) * (s ** 2)[:, None, None]
               for A, s in ((Aa, sa), (Ab, sb))]
        np.testing.assert_allclose(cov[1], cov[0], rtol=2e-3, atol=1e-3)
        _hold_descriptors(name, da, rows[:, 2:])


def test_exporters_without_a_ground_truth(exporter_inputs, tmp_path):
    """One store and no H: the file is ``out`` itself, its frames the
    detected ones."""
    from mods_tpu import cli as jcli
    from mods_tpu_torch import cli as tcli
    import chip_smoke
    _, img, _, inis = exporter_inputs
    iters = tmp_path / "iters.ini"
    iters.write_text(chip_smoke.cviu_iters_ini([([dict(
        chip_smoke._HESAFF, tilt_set=(1.0,), descriptors=("DAISY",))],
        None)]))
    args = [inis[0], str(iters)]
    assert jcli.cmd_extract_benchmark([img, str(tmp_path / "j"), "0"]
                                      + args) == 0
    assert tcli.cmd_extract_benchmark([img, str(tmp_path / "t"), "0"] + args,
                                      device="cpu") == 0
    (xa, _, _, da), (xb, _, _, db) = (TO.read_oxford(str(tmp_path / p))
                                      for p in ("j", "t"))
    assert len(xa) == len(xb) > 20 and db.shape[1] == 200
    rows, dist = _pair_rows(np.c_[xa, da], np.c_[xb, db])
    assert dist.max() <= 5e-3
    _hold_descriptors("DAISY", da, rows[:, 2:])


def test_engine_config_carries_every_descriptor_section():
    """The port's EngineConfig takes the JAX package's per-descriptor
    sections (what ``spec_for`` reads) field for field."""
    from mods_tpu import pipeline as jp
    from mods_tpu_torch import config as tc
    cfg = tc.from_dict(dataclasses.asdict(jp.EngineConfig()))
    ref = jp.EngineConfig()
    for sec in ("daisy", "liop", "ssim", "mrogh", "freak", "brisk",
                "pixels", "cnn"):
        assert dataclasses.asdict(getattr(cfg, sec)) \
            == dataclasses.asdict(getattr(ref, sec)), sec
