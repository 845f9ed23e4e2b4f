"""Port vs JAX reference: the flagship two-view step end to end, the
configuration bridge, device selection, the PNG reader and the import
boundary (the port never imports JAX or ``mods_tpu``).

End to end, detection and description agree to float32 rounding, which
can flip a region or a match at a threshold, and RANSAC draws from
another random stream: tentatives and inliers are held within 10 % and
the homographies within 1 px at the image corners.
"""

import dataclasses
import glob
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import jax
import pytest
import torch
from scipy import ndimage

from mods_tpu.models.flagship import two_view_step as jax_step
from mods_tpu.pipeline import EngineConfig as JaxEngineConfig
from mods_tpu_torch import config as tc
from mods_tpu_torch.device import resolve_device
from mods_tpu_torch.io.png import read_png_gray
from mods_tpu_torch.models.flagship import (batched_pair_step,
                                            default_config,
                                            make_two_view_step,
                                            two_view_step)
from mods_tpu_torch.pipeline import EngineConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_cfg():
    """The JAX package's small-caps config (__graft_entry__.py:8-15)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from __graft_entry__ import _tiny_cfg as cfg
    return cfg()


def _pair():
    """A 256x256 block texture and its copy rotated by 8 degrees and
    shifted by (7, -5) px."""
    rng = np.random.default_rng(0)
    b = np.kron(rng.uniform(0, 255, (22, 22)), np.ones((12, 12)))[:256, :256]
    b += 20 * rng.uniform(0, 1, b.shape)
    i1 = np.clip(b, 0, 255).astype(np.float32)
    i2 = np.roll(ndimage.rotate(i1, 8, reshape=False, order=1, cval=128),
                 (7, -5), (0, 1)).astype(np.float32)
    return i1, i2


def _corners(H, w=256, h=256):
    c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], np.float64)
    p = c @ np.asarray(H, np.float64).T
    return p[:, :2] / p[:, 2:]


def test_two_view_step_matches_jax():
    cfg = _tiny_cfg()
    i1, i2 = _pair()
    ref = jax.jit(lambda a, b, k: jax_step(a, b, k, cfg))(
        i1, i2, jax.random.PRNGKey(0))
    step = make_two_view_step(tc.from_dict(dataclasses.asdict(cfg)),
                              device="cpu")
    got = step(i1, i2, torch.Generator().manual_seed(0))
    jt, jn = int(ref["n_tentatives"]), int(ref["n_inliers"])
    tt, tn = int(got["n_tentatives"]), int(got["n_inliers"])
    assert jn >= 20
    assert abs(tt - jt) <= 0.1 * jt
    assert abs(tn - jn) <= 0.1 * jn
    d = np.abs(_corners(got["H"].numpy()) - _corners(ref["H"])).max()
    assert d < 1.0


def test_config_bridge_and_defaults():
    # every default the port's EngineConfig carries is the JAX one: the
    # parameter groups field by field, the ladder's scalars as they are
    jd = dataclasses.asdict(JaxEngineConfig())
    td = dataclasses.asdict(EngineConfig())
    assert {"orb", "min_matches", "max_steps", "ver_type",
            "do_both_ransac_gt", "clear_tentatives"} <= set(td)
    for group, fields in td.items():
        if not isinstance(fields, dict):
            assert jd[group] == fields, group
            continue
        for k, v in fields.items():
            assert jd[group][k] == v, (group, k)
    assert EngineConfig().dom_ori.max_angles == 1
    assert EngineConfig().sift.root_sift
    cfg = _tiny_cfg()
    port = tc.from_dict(dataclasses.asdict(cfg))
    assert port.caps.per_view == cfg.caps.per_view == 128
    assert port.ransac.max_rounds == 1
    assert default_config().caps == tc.CapacityParams(
        per_octave=512, per_view=512, per_image=1024, max_angles=2)
    # the ladder's own state crosses the same bridge
    from mods_tpu.config import IterationParams as JaxIteration
    jcfg = dataclasses.replace(cfg, min_matches=12, ver_type="GR_TRUTH",
                               clear_tentatives=((1, "ORB", "ORB"),))
    port = tc.from_dict(dataclasses.asdict(jcfg))
    assert (port.min_matches, port.ver_type) == (12, "GR_TRUTH")
    assert port.clear_tentatives == ((1, "ORB", "ORB"),)
    assert port.orb == tc.OrbParams()
    jit = JaxIteration(detector="ORB", descriptors=("ORB",),
                       tilt_set=(1.0, 5.0), fginn_threshold=(0.0,),
                       distance_threshold=(60.0,))
    it = tc.from_dict(dataclasses.asdict(jit), tc.IterationParams)
    assert dataclasses.asdict(it) == dataclasses.asdict(jit)
    assert it.distance_for("ORB") == 60.0 and it.fginn_for("SIFT") == 0.0


def test_device_selection():
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            make_two_view_step()


def test_cpu_step_accepts_tensors_and_arrays():
    i1, i2 = _pair()
    cfg = tc.from_dict(dataclasses.asdict(_tiny_cfg()))
    a = two_view_step(torch.from_numpy(i1), torch.from_numpy(i2),
                      torch.Generator().manual_seed(3), cfg)
    b = make_two_view_step(cfg, device="cpu")(
        i1, i2, torch.Generator().manual_seed(3))
    assert torch.equal(a["H"], b["H"])
    assert int(a["n_inliers"]) == int(b["n_inliers"])


def test_batched_pair_step_equals_the_step_pair_by_pair():
    """The batched step's pair p equals the step on pair p alone.  The
    convolutions run on PyTorch's own CPU kernels, not oneDNN's: oneDNN
    picks its algorithm, and so its rounding, by the batch size (one or
    two float32 ulps of a blurred level, ``test_torch_batch.py``), which
    is not the port's code."""
    i1, i2 = _pair()
    cfg = tc.from_dict(dataclasses.asdict(_tiny_cfg()))
    a = torch.from_numpy(np.stack([i1, i2]))
    b = torch.from_numpy(np.stack([i2, i1]))
    with torch.backends.mkldnn.flags(enabled=False):
        out = batched_pair_step(
            a, b, [torch.Generator().manual_seed(s) for s in (3, 4)], cfg)
        assert out["H"].shape == (2, 3, 3) and out["n_inliers"].shape == (2,)
        for p, seed in enumerate((3, 4)):
            one = two_view_step(a[p], b[p],
                                torch.Generator().manual_seed(seed), cfg)
            for k in one:
                assert torch.equal(out[k][p], one[k]), (p, k)
    with pytest.raises(ValueError):
        batched_pair_step(a, b, [torch.Generator()], cfg)


def _write_png(path, img, filters):
    """An 8-bit grayscale PNG whose row r uses filter filters[r % 5]."""
    h, w = img.shape
    prev = np.zeros(w, np.int64)
    raw = bytearray()
    for r in range(h):
        x = img[r].astype(np.int64)
        left = np.r_[0, x[:-1]]
        upleft = np.r_[0, prev[:-1]]
        f = filters[r % len(filters)]
        if f == 0:
            y = x
        elif f == 1:
            y = x - left
        elif f == 2:
            y = x - prev
        elif f == 3:
            y = x - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
            y = x - pred
        raw += bytes([f]) + bytes((y % 256).astype(np.uint8))
        prev = x

    def chunk(t, body):
        c = struct.pack(">I", len(body)) + t + body
        return c + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF)
    data = (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def test_png_reader(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    paths = sorted(glob.glob(os.path.join(REPO, ".parity_work", "*.png")))
    assert len(paths) == 8
    for p in paths:
        np.testing.assert_array_equal(read_png_gray(p),
                                      np.asarray(Image.open(p)))
    img = np.random.default_rng(1).integers(0, 256, (23, 37))
    p = str(tmp_path / "filters.png")
    _write_png(p, img, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(read_png_gray(p), img)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)


def test_profile_reads_the_raw_records_as_the_event_tree():
    """``chip_smoke.py`` phase 5 reads its profiles from the raw Kineto
    records (``_raw_events``); on a profiled CPU run with stage ranges and
    host reads, every reading equals that of ``prof.events()`` (rel 1e-6:
    both carry the same nanosecond stamps).  Phase 5 holds the same on
    the card for the flagship step's kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(96, 96)).astype(np.float32))

    def run():
        with record_function(chip_smoke.STAGES[0]):
            y = (x @ x).relu().sum()
        with record_function(chip_smoke.STAGES[3]):
            z = (x + 1).amax()
        return float(y + z)

    run()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            run()
    raw = chip_smoke.profile_readings(chip_smoke._raw_events(prof),
                                      chip_smoke.STAGES, 3, 1e6)
    tree = chip_smoke.profile_readings(chip_smoke._function_events(prof),
                                       chip_smoke.STAGES, 3, 1e6)
    assert chip_smoke.readings_differ(raw, tree) == []
    assert raw["host_reads"] == 1.0
    assert raw["stages"][chip_smoke.STAGES[0]]["host_ms"] > 0
    assert raw["stages"][chip_smoke.STAGES[3]]["host_ms"] > 0
    tree["host_reads"] += 1
    assert chip_smoke.readings_differ(raw, tree) == ["host_reads"]


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mods_tpu_torch\n"
        "for m in pkgutil.walk_packages(mods_tpu_torch.__path__, "
        "'mods_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'mods_tpu')]\n"
        "assert not bad, bad\n"
        "for n in ('surf', 'kaze', 'tilde', 'corners', 'mser_tpu'):\n"
        "    assert 'mods_tpu_torch.detectors.' + n in sys.modules, n\n"
        "for n in ('multi', 'manifest'):\n"
        "    assert 'mods_tpu_torch.parallel.' + n in sys.modules, n\n"
        "for n in ('descriptors.patch_descs', 'descriptors.cnn', "
        "'io.oxford'):\n"
        "    assert 'mods_tpu_torch.' + n in sys.modules, n\n"
        "from mods_tpu_torch import csrc\n"
        "from mods_tpu_torch.detectors import mser\n"
        "from mods_tpu_torch.ops import host_render\n"
        "assert not csrc._libs, 'a CUDA library was loaded on import'\n"
        "assert mser._lib.cache_info().currsize == 0\n"
        "assert host_render._lib.cache_info().currsize == 0\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('mods_tpu_torch.')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_flagship.py --seeds N PAIR: the
    # JAX package's
    # flagship step at its default caps on a full-size .parity_work pair,
    # once for each RANSAC key jax.random.PRNGKey(0..N-1): per seed the
    # inliers and the worst corner error of H against the ground truth
    # (chip_smoke.py's JAX_FLAGSHIP_CORNER_SHARE).
    import json
    from PIL import Image
    from mods_tpu.models.flagship import make_two_view_step as jax_make
    import chip_smoke
    n, pair = int(sys.argv[sys.argv.index("--seeds") + 1]), sys.argv[-1]
    imgs = [np.asarray(Image.open(os.path.join(
        REPO, ".parity_work", f"{pair}_{i}.png")), np.float32) for i in (1, 2)]
    H_gt = np.loadtxt(os.path.join(REPO, ".parity_work", f"{pair}_H.txt"))
    step = jax_make()
    h, w = imgs[0].shape
    out = []
    for s in range(n):
        r = step(*imgs, jax.random.PRNGKey(s))
        out.append([int(r["n_inliers"]), chip_smoke._corner_error(
            np.asarray(r["H"]), H_gt, w, h)])
    print(json.dumps({pair: dict(
        per_seed=out, share_within_8px=float(np.mean(
            [e <= 8.0 for _, e in out])))}))
