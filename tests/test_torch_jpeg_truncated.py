"""JPEG files cut short, and progressive files whose last scans are
missing, read as PIL 12.1.0 reads them (libjpeg-turbo 3.1 through
Pillow's JpegDecode.c).

PIL refuses a file ("image file is truncated") wherever libjpeg would
suspend at the end of the data: inside a scan's entropy-coded data, and,
for a progressive or multi-scan file, anywhere before its EOI marker.  A
baseline file cut only in its last bytes may still decode, as the bit
reader's look-ahead decides.  A cut file closed with an EOI marker, or
one with junk after its EOI, decodes; a progressive file missing scans
decodes with libjpeg's block smoothing.  The port
(``csrc/jpeg_decode.cpp``) is held to PIL through the JAX command's
reader ``mods_tpu/cli.py::_load_image``, bit for bit.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_jpeg_truncated.py -q
"""

from __future__ import annotations

import io
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image
from scipy import ndimage

from mods_tpu import cli as jcli
from mods_tpu.cli import _load_image
from mods_tpu_torch import cli as tcli
from mods_tpu_torch.io import image as I

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_bitmap_formats import blp1_jpeg  # noqa: E402
from test_torch_probed_formats import iptc_file  # noqa: E402


def jpeg_bytes(seed: int, shape, progressive: bool, **kw) -> bytes:
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    if seed % 2:                                    # some smooth content
        a = ndimage.uniform_filter(a.astype(np.float32), 5).astype(np.uint8)
    b = io.BytesIO()
    Image.fromarray(a).save(b, "JPEG", progressive=progressive, **kw)
    return b.getvalue()


def outcome(path):
    """PIL's array, or None where PIL refuses the file; the port's likewise,
    also through the JAX command's reader."""
    try:
        want = np.asarray(Image.open(path))
    except Exception:                               # noqa: BLE001
        want = None
    try:
        got = I.read_image(path)
    except ValueError:
        got = None
    return want, got


def assert_as_pil(path, what=""):
    want, got = outcome(path)
    assert (want is None) == (got is None), (what, want is None)
    if want is not None:
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
        np.testing.assert_array_equal(got, _load_image(str(path)))


def scan_starts(data: bytes) -> list:
    return [i for i in range(2, len(data) - 1)
            if data[i] == 0xFF and data[i + 1] == 0xDA]


# the Motivation's files: PIL's default and progressive saves of 80x64
# gray and 64x48 RGB noise
SAVES = {
    "gray_baseline": (0, (64, 80), False, {}),
    "gray_progressive": (0, (64, 80), True, {}),
    "rgb_baseline": (1, (48, 64, 3), False, {}),
    "rgb_progressive": (1, (48, 64, 3), True, {}),
    "rgb_422_restarts": (2, (37, 45, 3), False,
                         {"subsampling": 1, "restart_marker_blocks": 3}),
    "rgb_444_progressive": (3, (29, 35, 3), True, {"subsampling": 0}),
}


@pytest.mark.parametrize("name", sorted(SAVES))
def test_cut_points_as_pil(tmp_path, name):
    """Every cut in the last 160 bytes and every 7th before, from the
    first scan on, bare and closed with an EOI marker."""
    seed, shape, progressive, kw = SAVES[name]
    data = jpeg_bytes(seed, shape, progressive, **kw)
    start = scan_starts(data)[0]
    cuts = sorted(set(range(max(start, len(data) - 160), len(data)))
                  | set(range(start, len(data), 7)))
    p = tmp_path / "x.jpg"
    refused = 0
    for cut in cuts:
        for tail in (b"", b"\xff\xd9"):
            p.write_bytes(data[:cut] + tail)
            assert_as_pil(p, f"{name} cut {cut} tail {tail!r}")
            refused += outcome(p)[0] is None
    assert refused >= len(cuts) // 2


def test_refusal_names_the_truncation(tmp_path):
    """The last byte of a progressive file (its EOI) and the last data
    byte of a baseline one: PIL's reason, and ``image_size`` still the
    header's, as ``Image.open(p).size`` is."""
    for name in ("gray_progressive", "rgb_baseline"):
        seed, shape, progressive, kw = SAVES[name]
        data = jpeg_bytes(seed, shape, progressive, **kw)
        p = tmp_path / f"{name}.jpg"
        p.write_bytes(data[:-1] if progressive else data[:-3])
        with pytest.raises(OSError, match="image file is truncated"):
            np.asarray(Image.open(p))
        with pytest.raises(ValueError, match="truncated.*PIL refuses it"):
            I.read_image(p)
        assert I.image_size(p) == Image.open(p).size == shape[1::-1]


def test_baseline_without_eoi(tmp_path):
    """A baseline file less its EOI marker: PIL reads it where libjpeg's
    last fill did not run out of data, so which ones it reads depends on
    the data; the port decides each of 60 saves as PIL does (PIL reads 3
    of them)."""
    p = tmp_path / "x.jpg"
    read = 0
    for seed in range(10, 70):
        p.write_bytes(jpeg_bytes(seed, (40, 56), False)[:-2])
        assert_as_pil(p, seed)
        read += outcome(p)[0] is not None
    assert read == 3


def test_junk_after_eoi_and_closed_cuts_decode(tmp_path):
    for name in ("gray_baseline", "rgb_progressive"):
        seed, shape, progressive, kw = SAVES[name]
        data = jpeg_bytes(seed, shape, progressive, **kw)
        p = tmp_path / "x.jpg"
        p.write_bytes(data + b"junk\x00\xff")
        assert_as_pil(p)
        assert outcome(p)[0] is not None
        cut = (scan_starts(data)[-1] + len(data)) // 2  # in the last scan
        p.write_bytes(data[:cut] + b"\xff\xd9")
        assert_as_pil(p)
        assert outcome(p)[0] is not None


@pytest.mark.parametrize("name", ["gray_progressive", "rgb_progressive",
                                  "rgb_444_progressive"])
def test_missing_scans_smooth_as_libjpeg(tmp_path, name):
    """A progressive file closed with EOI before each of its scans: PIL's
    array (libjpeg's block smoothing) bit for bit."""
    seed, shape, progressive, kw = SAVES[name]
    data = jpeg_bytes(seed, shape, progressive, **kw)
    p = tmp_path / "x.jpg"
    for k, at in enumerate(scan_starts(data)[1:], 1):
        p.write_bytes(data[:at] + b"\xff\xd9")
        assert_as_pil(p, f"{name}: {k} scans")
        assert outcome(p)[0] is not None


@pytest.mark.parametrize("shape", [(40, 16), (9, 40), (40, 9), (41, 29, 3),
                                   (17, 23, 3), (57, 40)])
def test_smoothing_at_the_edges(tmp_path, shape):
    """Images two blocks wide or tall, and odd sizes under 4:2:0, where
    the 5x5 neighbourhood repeats the last row and column."""
    data = jpeg_bytes(len(shape) * 7 + shape[0], shape, True, quality=88)
    p = tmp_path / "x.jpg"
    for at in scan_starts(data)[1:]:
        p.write_bytes(data[:at] + b"\xff\xd9")
        assert_as_pil(p, str(shape))


def test_complete_files_keep_their_bytes(tmp_path):
    """Complete files are not smoothed: the port's array is PIL's."""
    p = tmp_path / "x.jpg"
    for seed, shape, progressive, kw in SAVES.values():
        p.write_bytes(jpeg_bytes(seed, shape, progressive, **kw))
        assert_as_pil(p)


@pytest.mark.parametrize("seed", [13, 49])
def test_big_file_cuts_follow_pils_reads(tmp_path, seed):
    """A baseline file just over 64 KiB, cut in its last 10 bytes: PIL
    hands libjpeg 64 KiB at a time, and its fast Huffman path runs where
    512 bytes a block are left in the buffer.  Which cuts PIL refuses
    depends on both: without the fast path the port parts from PIL at
    seed 13's cut 2 bytes short, without the 64 KiB reads at seed 49's."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, (220, 283 + seed % 18), dtype=np.uint8)
    b = io.BytesIO()
    Image.fromarray(a).save(b, "JPEG", quality=95)
    data = b.getvalue()
    assert 65536 < len(data) < 65536 + 2500
    p = tmp_path / "x.jpg"
    for cut in range(len(data) - 10, len(data)):
        p.write_bytes(data[:cut])
        assert_as_pil(p, f"cut {cut}")


def test_blp1_and_iptc_jpeg_cuts(tmp_path):
    """A JPEG cut short inside a BLP1 and inside an IPTC file is refused
    as PIL refuses it; closed with EOI it is read as PIL reads it."""
    seed, shape, progressive, kw = SAVES["rgb_baseline"]
    data = jpeg_bytes(seed, shape, progressive, **kw)
    gray = jpeg_bytes(0, (37, 53), False)
    h, w = shape[:2]
    p = tmp_path / "x"
    for cut in (len(data) - 3, len(data) // 2):
        for tail in (b"", b"\xff\xd9"):
            p.write_bytes(blp1_jpeg(w, h, data[:cut] + tail, 0, 200))
            assert_as_pil(p, f"blp cut {cut} {tail!r}")
    for cut in (len(gray) - 3, len(gray) // 2):
        for tail in (b"", b"\xff\xd9"):
            p.write_bytes(iptc_file((53, 37), 1, 0, 5, gray[:cut] + tail))
            assert_as_pil(p, f"iptc cut {cut} {tail!r}")
    p.write_bytes(blp1_jpeg(w, h, data[:-3], 0, 200))
    with pytest.raises(ValueError, match="truncated"):
        I.read_image(p)


def test_jpeg_faults_beyond_truncation(tmp_path):
    """A baseline JPEG without DHT segments (a Motion-JPEG frame): libjpeg's
    standard tables; a valid DAC segment: parsed and read past; a DC table
    with a symbol above 15, a refinement scan whose Al is not Ah - 1, an
    unsupported marker, a DAC entry out of range and a second SOI:
    refused as PIL refuses them."""
    data = jpeg_bytes(0, (32, 40), False)
    p = tmp_path / "x.jpg"
    segs, i = [], 2
    while data[i + 1] != 0xDA:
        n = int.from_bytes(data[i + 2:i + 4], "big")
        segs.append(data[i:i + 2 + n])
        i += 2 + n
    p.write_bytes(b"\xff\xd8" + b"".join(s for s in segs if s[1] != 0xC4)
                  + data[i:])
    assert_as_pil(p)
    assert outcome(p)[0] is not None
    dht = data.index(b"\xff\xc4")
    bad = bytearray(data)
    bad[dht + 5 + 16] = 0x20                        # DC symbol 32
    p.write_bytes(bytes(bad))
    assert_as_pil(p)
    assert outcome(p)[0] is None
    prog = bytearray(jpeg_bytes(0, (32, 40), True))
    at = scan_starts(bytes(prog))[0]
    prog[at + 2 + int.from_bytes(prog[at + 2:at + 4], "big") - 1] = 0x31
    p.write_bytes(bytes(prog))
    assert_as_pil(p)
    assert outcome(p)[0] is None
    for segment, read in ((b"\xff\xdf\x00\x04\x00\x00", False),
                          (b"\xff\xcc\x00\x04\x00\x10", True),
                          (b"\xff\xcc\x00\x04\x21\x10", False),
                          (b"\xff\xd8", False)):
        p.write_bytes(data[:2] + segment + data[2:])
        assert_as_pil(p, segment)
        assert (outcome(p)[0] is not None) == read, segment


def test_cli_match_on_a_cut_jpeg(tmp_path):
    """``match`` on a cut JPEG fails in both packages; the port's command
    exits non-zero and names the truncation."""
    data = jpeg_bytes(1, (48, 64), True)
    a, b = tmp_path / "a.jpg", tmp_path / "b.jpg"
    a.write_bytes(data[:-1])
    b.write_bytes(data)
    args = [str(a), str(b), "0", "none", "k1", "k2",
            str(tmp_path / "m.txt"), "0", "LORANSACH"]
    with pytest.raises(OSError, match="image file is truncated"):
        jcli.cmd_match(args)
    with pytest.raises(ValueError, match="truncated"):
        tcli.main(["match"] + args + ["--device", "cpu"])
    run = subprocess.run([sys.executable, "-m", "mods_tpu_torch.cli",
                          "match"] + args + ["--device", "cpu"],
                         capture_output=True, text=True, cwd=_REPO,
                         env={**os.environ, "PYTHONPATH": _REPO})
    assert run.returncode != 0
    assert "image file is truncated" in run.stderr


def cut_fixture_files() -> dict:
    """Phase 14zg's JPEGs: ``SAVES``' gray progressive and RGB baseline
    files (the Motivation's)."""
    return {f"jpeg_cut_{name}.jpg": jpeg_bytes(*SAVES[name][:3],
                                                **SAVES[name][3])
            for name in ("gray_progressive", "rgb_baseline")}


def pil_tables(data: bytes) -> tuple:
    """PIL's SHA-256 of each cut at ``chip_smoke.jpeg_cut_points`` that it
    reads, and of the file closed with EOI before each scan but the
    first."""
    import hashlib

    import chip_smoke

    def sha(d: bytes):
        try:
            a = np.asarray(Image.open(io.BytesIO(d)))
        except OSError:
            return None
        return hashlib.sha256(a.tobytes()).hexdigest()

    read = {cut: sha(data[:cut]) for cut in chip_smoke.jpeg_cut_points(data)}
    closed = [sha(data[:at] + b"\xff\xd9")
              for at in chip_smoke.jpeg_scan_starts(data)[1:]]
    return {c: h for c, h in read.items() if h is not None}, closed


def test_chip_smoke_tables_are_pils():
    """The committed JPEGs are ``cut_fixture_files``' bytes, and phase
    14zg's tables PIL's hashes of their cuts and closed files."""
    import chip_smoke
    files = cut_fixture_files()
    assert set(files) == set(chip_smoke.JPEG_CUT_FIXTURES)
    for name, data in files.items():
        assert (chip_smoke.IMAGE_FIXTURES / name).read_bytes() == data
        read, closed = pil_tables(data)
        assert chip_smoke.JPEG_CUT_READ_SHA256[name] == read, name
        assert chip_smoke.JPEG_CLOSED_SHA256[name] == closed, name


if __name__ == "__main__":
    import chip_smoke
    if sys.argv[1:] == ["--fixtures"]:
        for name, data in cut_fixture_files().items():
            (chip_smoke.IMAGE_FIXTURES / name).write_bytes(data)
    elif sys.argv[1:] == ["--hashes"]:
        for name, data in cut_fixture_files().items():
            read, closed = pil_tables(data)
            print(f"{name}\n  read: {read!r}\n  closed: {closed!r}")
