"""Port vs JAX reference: the INI configuration and the ``match`` command
(CPU).

* ``io/ini.py``: INI text with the reference's quirks (values such as
  ``1;,5,9;  comment`` keep what precedes the first ``;``) parses into
  equal dataclasses in both packages, compared as ``dataclasses.asdict``;
  ``autosize_caps`` and ``cli._build_engine`` give equal configurations;
  ``config.from_dict`` carries a JAX ``EngineConfig`` across whole.
* ``python -m mods_tpu_torch.cli match --device cpu`` against
  ``mods_tpu.cli.cmd_match`` on a small PNG pair, for each ``ver_type``:
  the count in the matchings file within 20 % and the same ``steps``
  (RANSAC draws other random numbers in the two packages).
"""

import dataclasses
import os
import platform
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from mods_tpu import cli as jcli
from mods_tpu import pipeline as jp
from mods_tpu.io import ini as jini
from mods_tpu_torch import cli as tcli
from mods_tpu_torch import config as tc
from mods_tpu_torch import pipeline as tp
from mods_tpu_torch.io import ini as tini
from mods_tpu_torch.io import regions_io
from mods_tpu_torch.timing import RunLog
from test_pipeline import textured_image, warp_np

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the fields of the CVIU ladder that tests/test_ini.py pins, written with
# the reference's quirks: trailing ``;`` comments, ``;,`` separators
ITERS = """\
[Iterations]
Steps=7
minMatches=10; stop when this many verify

[ORB0]
TiltSet=1;,5,9;  the rest is commentary
Descriptors=ORB
FGINNThreshold=0
DistanceThreshold=60;  Hamming
[Matching0]
SeparateDetectors=ORB
SeparateDescriptors=ORB

[ORB1]
TiltSet=1,5,9
Descriptors=ORB
FGINNThreshold=0
DistanceThreshold=60
[Matching1]
SeparateDetectors=ORB
SeparateDescriptors=ORB

[MSER2]
ScaleSet=1,0.25,0.125
Descriptors=RootSIFT
FGINNThreshold=0.85
[Matching2]
SeparateDetectors=MSER,ORB
SeparateDescriptors=RootSIFT,ORB

[MSER3]
TiltSet=1,2,4,6,8
Phi=360
Descriptors=RootSIFT
FGINNThreshold=0.85

[HessianAffine4]
TiltSet=1,2,4,6,8
Phi=360
Descriptors=RootSIFT
[Matching4]
SeparateDetectors=MSER,HessianAffine
SeparateDescriptors=RootSIFT
GroupDetectors=

[HessianAffine5]
TiltSet=1,2,4,6,8
Phi=120
Descriptors=RootSIFT
[HessianAffine6]
TiltSet=1,2,4,6,8
Phi=60
Descriptors=RootSIFT
"""

CONFIG = """\
[HessianAffine]
mode=FixedRegNumber
regionsNumber=3000; per view
threshold=5.3333
[DoG]
threshold=8
[MSER]
min_size=25
max_area=0.04
min_margin=10
[DominantOrientation]
maxAngles=2
addUpright=1
[SIFTDescriptor]
patchSize=41
[RANSAC]
ErrorType=Sampson
err_threshold=3;  px
doSymmCheck=1
[Matching]
matchRatioRootSIFT=0.8
matchRatioHalfRootSIFT=0.85
matchDistanceORB=60
contradDist=12
doCLAHE=1
[DuplicateFiltering]
duplicateDist=2.5
whichCorrespondenceRemains=bestFGINN
[ORB]
nfeatures=800
"""


@pytest.fixture(scope="module")
def ini_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ini")
    (d / "iters.ini").write_text(ITERS)
    (d / "config.ini").write_text(CONFIG)
    return str(d / "config.ini"), str(d / "iters.ini")


def _same(a, b):
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_ini_parses_alike_in_both_packages(ini_files):
    config, iters = ini_files
    js, jm, jladder = jini.parse_iters_file(iters)
    ts, tm, tladder = tini.parse_iters_file(iters)
    assert (js, jm) == (ts, tm) == (7, 10)
    assert len(jladder) == len(tladder) == 7
    for a, b in zip(jladder, tladder):
        _same(a, b)
    dets = [r.dets[0] for r in tladder]
    assert dets[0].detector == "ORB" and dets[0].tilt_set == (1.0,)
    assert dets[1].tilt_set == (1.0, 5.0, 9.0)
    assert dets[2].detector == "MSER"
    assert dets[2].scale_set == (1.0, 0.25, 0.125)
    assert dets[2].descriptors == ("RootSIFT",)
    assert dets[2].fginn_threshold == (0.85,)
    assert dets[4].detector == "HessianAffine" and dets[4].phi_base == 360
    assert (dets[5].phi_base, dets[6].phi_base) == (120.0, 60.0)
    assert dets[4].tilt_set == (1.0, 2.0, 4.0, 6.0, 8.0)
    assert tladder[0].plan.separate_detectors == ("ORB",)
    assert tladder[1].plan.separate_descriptors == ("ORB",)
    assert tladder[2].plan.separate_detectors == ("MSER", "ORB")
    assert tladder[2].plan.separate_descriptors == ("RootSIFT", "ORB")
    assert tladder[4].plan.separate_detectors == ("MSER", "HessianAffine")
    assert tladder[4].plan.group_detectors == ()
    assert tladder[3].plan is None
    assert dets[0].distance_for("ORB") == 60.0
    assert dets[0].fginn_for("ORB") == 0.0

    ini_j, ini_t = jini.load_ini(config), tini.load_ini(config)
    assert ini_j == ini_t
    for name in ("HessianAffine", "DoG", "HarrisAffine"):
        _same(jini.parse_detector_config(ini_j, name),
              tini.parse_detector_config(ini_t, name))
    for fn in ("parse_affine_config", "parse_mser_config",
               "parse_dom_ori_config", "parse_sift_desc_config",
               "parse_ransac_config", "parse_matching_config"):
        _same(getattr(jini, fn)(ini_j), getattr(tini, fn)(ini_t))
    jd, td = (jini.parse_descriptor_sections(ini_j),
              tini.parse_descriptor_sections(ini_t))
    assert set(jd) == set(td)
    for k in jd:
        _same(jd[k], td[k])
    assert jini.parse_flags_config(ini_j) == tini.parse_flags_config(ini_t)
    # the quirks, as the JAX package reads them
    p = tini.parse_detector_config(ini_t)
    assert p.detector_mode == "FixedRegNumber" and p.reg_number == 3000
    r = tini.parse_ransac_config(ini_t)
    assert r.error_type == "sampson" and r.err_threshold == 3.0
    m = tini.parse_matching_config(ini_t)
    assert m.fginn_per_desc == (("HalfRootSIFT", 0.85), ("RootSIFT", 0.8))
    assert m.duplicate_mode == "fginn" and m.duplicate_dist == 2.5
    # doBothRANSACgroundTruth reads as 1 when absent (EngineConfig: False)
    assert tini.parse_flags_config(ini_t)["do_both_ransac_gt"] is True


@pytest.mark.parametrize("ver", ["LORANSACH", "LORANSACF", "ORSA",
                                 "GR_TRUTH"])
def test_build_engine_and_autosize_caps_alike(ini_files, ver):
    config, iters = ini_files
    jcfg, jladder = jcli._build_engine(config, iters, ver)
    tcfg, tladder = tcli._build_engine(config, iters, ver)
    _same(jcfg, tcfg)
    assert [dataclasses.asdict(r) for r in jladder] == \
        [dataclasses.asdict(r) for r in tladder]
    # FixedRegNumber = 3000 raises the capacities, alike
    assert tcfg.caps.per_view == 3072 and tcfg.caps.per_group == 3328
    assert tcfg.caps.per_image == 9216
    _same(jp.autosize_caps(jp.EngineConfig()),
          tp.autosize_caps(tp.EngineConfig()))
    # from_dict carries a JAX EngineConfig across whole
    _same(tc.from_dict(dataclasses.asdict(jcfg)), jcfg)


# ---------------------------------------------------------------------------
# the match command

# one MSER rung, then HessianAffine with MSER's tentatives kept
SMALL_ITERS = chip_smoke.cviu_iters_ini([
    ([dict(chip_smoke._MSER, fginn_threshold=(0.8,))], None),
    ([dict(chip_smoke._HESAFF, tilt_set=(1.0, 4.0))],
     chip_smoke._HESAFF_PLAN)], min_matches=10)
SHIFT = np.array([[1.0, 0.0, 9.0], [0.0, 1.0, -5.0], [0, 0, 1.0]])


def load_jax_native(timeout: float = 300.0) -> None:
    """Build and load the JAX package's MSER and render libraries without
    racing other test processes.  ``mods_tpu.detectors.mser.build_native``
    lets g++ write a library in place, so a process that opens it while
    a process of another test file is still linking it gets "file too
    short" (or "invalid ELF header").  Here a missing or stale library
    is linked under a temporary name and renamed (the JAX package's
    flags; its own check then finds it current), and a load that fails
    while another process links in place is retried until the link
    ends.  Loaded here, the libraries stay loaded for the JAX commands
    that follow."""
    import tempfile
    from mods_tpu.detectors import mser
    from mods_tpu.ops import host_render
    cache = os.path.join(mser.NATIVE_DIR, ".cache", platform.machine())
    os.makedirs(cache, exist_ok=True)
    deadline = time.monotonic() + timeout
    for src, so, extra, lib in (
            ("mser.cpp", "libmods_mser.so", (), mser._lib),
            ("render.cpp", "libmods_render.so", ("-fopenmp",),
             host_render._lib)):
        src = os.path.abspath(os.path.join(mser.NATIVE_DIR, src))
        so = os.path.join(cache, so)
        if (not os.path.exists(so)
                or os.path.getmtime(so) < os.path.getmtime(src)):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=cache)
            os.close(fd)
            try:
                subprocess.run(["g++", "-O3", "-march=native",
                                "-funroll-loops", "-shared", "-fPIC",
                                *extra, "-o", tmp, src], check=True)
                os.replace(tmp, so)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        while True:
            try:
                lib()
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.5)


@pytest.fixture(scope="module")
def png_pair(tmp_path_factory):
    load_jax_native()
    d = tmp_path_factory.mktemp("pair")
    img1 = textured_image(128, 176, seed=4)
    img2 = warp_np(img1, SHIFT, 128, 176)
    for name, img in (("a.png", img1), ("b.png", img2)):
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(d / name)
    np.savetxt(d / "H.txt", SHIFT)
    (d / "iters.ini").write_text(SMALL_ITERS)
    (d / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
    return d


def _args(d, tag, ver):
    return [str(d / "a.png"), str(d / "b.png"), "0", "none", "k1", "k2",
            str(d / f"m_{tag}_{ver}.txt"),
            str(d / f"log_{tag}_{ver}.txt") if tag == "torch" else "0",
            ver, str(d / "config.ini"), str(d / "iters.ini")] + (
        [str(d / "H.txt")] if ver == "GR_TRUTH" else [])


_LINE = re.compile(r"Matches: (\d+) \(tentatives (\d+), steps (\d+)\)")


@pytest.mark.parametrize("ver", ["LORANSACH", "LORANSACF", "ORSA",
                                 "GR_TRUTH"])
def test_cli_match_against_jax(png_pair, ver, capsys):
    d = png_pair
    assert jcli.cmd_match(_args(d, "jax", ver)) == 0
    jn, jt, js = map(int, _LINE.search(capsys.readouterr().out).groups())
    assert tcli.main(["match"] + _args(d, "torch", ver)
                     + ["--device", "cpu"]) == 0
    tn, tt, ts = map(int, _LINE.search(capsys.readouterr().out).groups())
    xy1, xy2 = regions_io.read_matches(str(d / f"m_torch_{ver}.txt"))
    assert len(xy1) == tn
    assert ts == js
    assert tn >= 10 and abs(tn - jn) <= 0.2 * jn, (tn, jn)
    H = regions_io.read_h(str(d / f"m_torch_{ver}.txt.H"))
    if ver in ("LORANSACH", "GR_TRUTH"):
        p = np.c_[xy1, np.ones(len(xy1))] @ H.T
        assert np.abs(p[:, :2] / p[:, 2:] - xy2).max() < 3.5
    else:
        x1, x2 = np.c_[xy1, np.ones(len(xy1))], np.c_[xy2, np.ones(len(xy2))]
        assert np.abs(np.einsum("ni,ij,nj->n", x2, H, x1)).max() < 1.0
    log = (d / f"log_torch_{ver}.txt").read_text().splitlines()
    assert log[0] == RunLog.HEADER and log[1].split()[-1] == ver
    assert len((d / f"log_torch_{ver}.txt.time").read_text().splitlines()) \
        == 2


def test_cli_runs_as_a_module(png_pair):
    """``python -m mods_tpu_torch.cli`` from the repository root, and its
    usage text without a command."""
    d = png_pair
    # two threads, as the other tests take (the suite runs in parallel)
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "mods_tpu_torch.cli", "match"]
        + _args(d, "module", "LORANSACH")[:7] + ["--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    n = int(_LINE.search(out.stdout).group(1))
    assert n == int((d / "m_module_LORANSACH.txt").read_text().split()[0])
    assert (d / "m_module_LORANSACH.txt.H").exists()
    assert tcli.main([]) == 1


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "I;16"])
def test_read_png_gray_against_pil(tmp_path, mode):
    """8-bit gray, RGB and RGBA and 16-bit gray read as the JAX command
    reads them (PIL, then ``to_gray_np``)."""
    from mods_tpu.ops.image import to_gray_np
    from mods_tpu_torch.io.png import read_png_gray
    rng = np.random.default_rng(0)
    shape = {"L": (37, 53), "RGB": (37, 53, 3), "RGBA": (37, 53, 4),
             "I;16": (37, 53)}[mode]
    a = rng.integers(0, 256, shape).astype(np.uint8)
    a[5:20, 5:30] = a[5, 5]                  # flat runs: more filter types
    path = tmp_path / "x.png"
    if mode == "I;16":
        Image.fromarray(a.astype(np.uint16) * 200).save(path)
    else:
        Image.fromarray(a, mode).save(path, optimize=True)
    got, want = read_png_gray(path), np.asarray(Image.open(path))
    np.testing.assert_array_equal(to_gray_np(got), to_gray_np(want))
    if want.ndim == 2:                       # a one-sample file as loaded
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("det", chip_smoke.OTHER_DETECTORS)
def test_cli_match_runs_every_detector(png_pair, det, tmp_path, capsys):
    """``cli match`` takes a rung of each device detector from the iters
    INI (MSER with ``backend=device`` in the config INI), on the card's
    path but on the CPU; the matchers are held against the JAX package in
    ``test_torch_detectors.py`` and ``test_torch_kaze_tilde_mser.py``."""
    d = png_pair
    binary = det in ("FAST", "BRISK")
    (tmp_path / "iters.ini").write_text(
        f"[Iterations]\nSteps=1\nminMatches=10\n\n[{det}0]\nTiltSet=1\n"
        f"Descriptors={'ORB' if binary else 'RootSIFT'}\n"
        f"FGINNThreshold={0 if binary else 0.8}\n"
        f"DistanceThreshold={60 if binary else 0}\n")
    (tmp_path / "config.ini").write_text(
        chip_smoke.CVIU_CONFIG_INI.replace(
            "[MSER]\n", "[MSER]\nbackend=device\n"))
    out = tmp_path / "m.txt"
    assert tcli.main(["match", str(d / "a.png"), str(d / "b.png"), "0",
                      "none", "k1", "k2", str(out), "0", "LORANSACH",
                      str(tmp_path / "config.ini"),
                      str(tmp_path / "iters.ini"), "--device", "cpu"]) == 0
    n, _, steps = map(int, _LINE.search(capsys.readouterr().out).groups())
    assert steps == 1
    assert n == int(out.read_text().split()[0])
