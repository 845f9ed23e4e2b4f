"""Port vs PIL on WebP files, and the JAX reference on a WebP pair (CPU).

Tolerances.
* Every reader case: ``io/image.py::_read`` gives
  ``np.asarray(Image.open(p))`` (the same dtype, shape and values) and
  ``Image.open(p).mode``; ``image_size`` gives ``Image.open(p).size``.
  There is no tolerance: a VP8 decoder that follows RFC 6386 is exact, so
  any difference is a fault.  Files are PIL's (Pillow 12.1.0, libwebp
  1.6.0: lossy VP8 at several qualities and methods, lossy with ALPH at
  several alpha qualities, lossless VP8L, animations, VP8X files with
  ICC, EXIF and XMP chunks), and where PIL writes no such file they are
  PIL's files edited by hand, PIL's reading of the same bytes being the
  reference: every ALPH coding (raw, VP8L) under every filter, and an
  animation whose first frame lies at an offset on its canvas.  PIL's
  encoder always writes the normal loop filter and one token partition,
  so this file writes VP8 key frames itself (``_vp8_frame``: a boolean
  encoder and RFC 6386's syntax, seeded modes and coefficients) with the
  simple filter, two to eight partitions and header fields PIL's encoder
  leaves alone; PIL's reading of them is the reference.
* Refusals: what PIL does not open either (a VP8 inter frame, a
  truncated file, missing partition sizes, a first chunk PIL does not
  know) raises a ``ValueError`` naming it.
* Writer: ``save_image`` to .webp writes a lossless file that PIL reads
  to exactly what it reads from its own ``lossless=True`` save of the
  same array (bool, gray, gray+alpha, RGB, RGBA with transparent pixels,
  uint16, int32, int8, float with NaN and infinities), and refuses, by
  name, what PIL refuses.
* ``cli match`` on ``test_torch_cli.py``'s textured pair saved by PIL as
  lossy WebP, its drawings named .webp, against ``mods_tpu.cli.
  cmd_match``: that file's rule (the same steps, the verified count
  within 20 %); the port's drawings decode in PIL to exactly ``viz``'s
  canvases of the matches it wrote.

``python tests/test_torch_webp.py --fixtures`` writes the WebP fixtures of
``chip_smoke.py`` phase 14i (``tests/data/image_io``);
``JAX_PLATFORMS=cpu python tests/test_torch_webp.py --jax-webp`` prints
the JAX command's figures on phase 14k's WebP pair
(``chip_smoke.JAX_WEBP_REFERENCE``).
"""

import functools
import hashlib
import io
import os
import re
import struct
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytest  # noqa: E402
import torch  # noqa: E402
from PIL import Image, features  # noqa: E402

import chip_smoke  # noqa: E402
from mods_tpu import cli as jcli  # noqa: E402
from mods_tpu_torch import cli as tcli  # noqa: E402
from mods_tpu_torch import viz  # noqa: E402
from mods_tpu_torch.io.image import (_read, image_size,  # noqa: E402
                                     read_image, save_image)
from mods_tpu_torch.io.regions_io import read_h, read_matches  # noqa: E402
from test_pipeline import textured_image, warp_np  # noqa: E402
from test_torch_cli import (SHIFT, SMALL_ITERS,  # noqa: E402
                            load_jax_native)
from test_torch_image_io import _jpeg_source  # noqa: E402

torch.set_num_threads(2)

pytestmark = pytest.mark.skipif(not features.check("webp"),
                                reason="this PIL reads and writes no WebP")


def _zoom(i=1):
    return np.asarray(Image.open(os.path.join(REPO, ".parity_work",
                                              f"zoom2x_{i}.png")))


def _tilt():
    return np.asarray(Image.open(os.path.join(REPO, ".parity_work",
                                              "tilt4_1.png")))


def _hold(p):
    """``_read``, ``read_image`` and ``image_size`` against PIL."""
    im = Image.open(p)
    want = np.asarray(im)
    got, mode = _read(p)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, got.shape, want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)
    assert mode == im.mode
    assert image_size(p) == im.size
    np.testing.assert_array_equal(read_image(p), want)


def _pil_webp(im, **kw) -> bytes:
    f = io.BytesIO()
    (im if isinstance(im, Image.Image) else Image.fromarray(im)).save(
        f, "WEBP", **kw)
    return f.getvalue()


def _chunks(data: bytes) -> list:
    """[(fourcc, payload)] of a RIFF WEBP file's top-level chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _riff(chunks) -> bytes:
    body = b"".join(tag + struct.pack("<I", len(p)) + p + bytes(len(p) & 1)
                    for tag, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _vp8x(flags: int, w: int, h: int) -> tuple:
    return (b"VP8X", bytes([flags, 0, 0, 0]) + (w - 1).to_bytes(3, "little")
            + (h - 1).to_bytes(3, "little"))


def _colour(h, w):
    """Photographic RGB content: crops of the zoom2x and tilt4 views."""
    return _jpeg_source(h, w)[1]


def _alpha_of(g):
    """An alpha plane with opaque, transparent and graded parts."""
    return np.clip((g.astype(np.int32) - 70) * 7, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# the fixtures of chip_smoke.py phase 14i

def write_webp_fixtures(d) -> None:
    """Phase 14i's fixtures, written by PIL: zoom2x's pair as default lossy
    files; 301x211 colour content at quality 0, 80 and 100 and methods 0,
    4 and 6; a 1x1 and a 37x53 lossy file; lossy RGBA at alpha_quality
    100 (method 0) and 50 (method 6); lossless RGB, RGBA, 16- and
    256-colour, gray and 1x1 files at methods 0 and 6; a two-frame
    animation."""
    os.makedirs(d, exist_ok=True)
    rgb = _colour(211, 301)
    g, t = _zoom()[400:496, 200:328], _tilt()[600:696, 300:428]
    rgba = np.concatenate([np.stack([g, t, 255 - g], -1),
                           _alpha_of(g)[..., None]], -1)
    rng = np.random.default_rng(13)
    pal16 = rng.integers(0, 256, (16, 3)).astype(np.uint8)
    pal256 = rng.integers(0, 256, (256, 3)).astype(np.uint8)
    files = {
        "zoom2x_1.webp": (_zoom(1), {}),
        "zoom2x_2.webp": (_zoom(2), {}),
        "color_q0_m0.webp": (rgb, dict(quality=0, method=0)),
        "color_q80_m4.webp": (rgb, dict(quality=80, method=4)),
        "color_q100_m6.webp": (rgb, dict(quality=100, method=6)),
        "lossy_1x1.webp": (rgb[:1, :1], {}),
        "lossy_37x53.webp": (rgb[:53, :37], {}),
        "rgba_aq100_m0.webp": (rgba, dict(alpha_quality=100, method=0)),
        "rgba_aq50_m6.webp": (rgba, dict(alpha_quality=50, method=6)),
        "lossless_rgb_m0.webp": (rgb[:96, :128], dict(lossless=True,
                                                      method=0)),
        "lossless_rgba_m6.webp": (rgba, dict(lossless=True, method=6)),
        "lossless_16colors_m0.webp": (pal16[g // 16], dict(lossless=True,
                                                          method=0)),
        "lossless_256colors_m6.webp": (pal256[g], dict(lossless=True,
                                                       method=6)),
        "lossless_gray_m0.webp": (g, dict(lossless=True, method=0)),
        "lossless_1x1_m6.webp": (rgb[:1, :1], dict(lossless=True, method=6)),
    }
    for name, (a, kw) in files.items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(_pil_webp(a, **kw))
    frames = [Image.fromarray(np.stack([v, v, 255 - v], -1))
              for v in (g, t)]
    with open(os.path.join(d, "animation.webp"), "wb") as f:
        f.write(_pil_webp(frames[0], save_all=True, append_images=frames[1:],
                          duration=100))


@pytest.mark.parametrize("name", sorted(chip_smoke.WEBP_FIXTURE_SHA256))
def test_webp_fixture_reads_as_pil(name):
    _hold(chip_smoke.IMAGE_FIXTURES / name)


def test_webp_fixture_hashes_are_pils():
    """Phase 14i's constants are PIL's decodes of the committed fixtures:
    the shape, the mode and the SHA-256 of the array."""
    assert len(chip_smoke.WEBP_FIXTURE_SHA256) == 16
    total = 0
    for name, (shape, mode, sha) in chip_smoke.WEBP_FIXTURE_SHA256.items():
        p = chip_smoke.IMAGE_FIXTURES / name
        total += p.stat().st_size
        im = Image.open(p)
        want = np.asarray(im)
        assert want.shape == shape and im.mode == mode, name
        assert hashlib.sha256(want.tobytes()).hexdigest() == sha, name
    assert total < 150_000


def test_fixtures_cover_the_codings():
    """Between them the fixtures hold lossy, lossless, alpha-coded and
    animated files, B_PRED and 16x16 macroblocks."""
    kinds = set()
    for name in chip_smoke.WEBP_FIXTURE_SHA256:
        data = (chip_smoke.IMAGE_FIXTURES / name).read_bytes()
        tags = [t for t, _ in _chunks(data)]
        kinds.add(tags[0])
        if b"ALPH" in tags:
            kinds.add(b"ALPH")
    assert kinds == {b"VP8 ", b"VP8L", b"VP8X", b"ALPH"}


# ---------------------------------------------------------------------------
# files written by PIL at test time

def _sweep_case(seed):
    """A seeded file: size, content, lossy or lossless, quality, method
    and alpha_quality drawn from ``seed``."""
    rng = np.random.default_rng(1000 + seed)
    h, w = (int(v) for v in rng.integers(1, 150, 2))
    y0, x0 = (int(v) for v in rng.integers(0, 400, 2))
    g = _zoom()[y0:y0 + h, x0:x0 + w]
    t = _tilt()[y0:y0 + h, x0:x0 + w]
    kind = seed % 5
    if kind == 0:
        a = g
    elif kind == 1:
        a = np.stack([g, t, 255 - g], -1)
    elif kind == 2:
        a = np.concatenate([np.stack([g, t, 255 - g], -1),
                            _alpha_of(t)[..., None]], -1)
    elif kind == 3:
        a = rng.integers(0, 256, g.shape + (3,)).astype(np.uint8)
    else:
        a = np.concatenate([np.stack([t, g, g // 2], -1), rng.integers(
            0, 256, g.shape + (1,)).astype(np.uint8)], -1)
    kw = dict(lossless=bool(seed % 3 == 0),
              quality=int(rng.integers(0, 101)),
              method=int(rng.integers(0, 7)))
    if a.ndim == 3 and a.shape[2] == 4:
        kw["alpha_quality"] = int(rng.integers(0, 101))
    return a, kw


@pytest.mark.parametrize("seed", range(40))
def test_seeded_sweep(tmp_path, seed):
    a, kw = _sweep_case(seed)
    p = tmp_path / "x.webp"
    p.write_bytes(_pil_webp(a, **kw))
    _hold(p)


@pytest.mark.parametrize("size", [(1, 1), (1, 9), (9, 1), (15, 17),
                                  (16, 16), (31, 33), (1000, 598)])
@pytest.mark.parametrize("lossless", [False, True])
def test_sizes(tmp_path, size, lossless):
    """Odd and even sizes about macroblock edges, and a full view (the
    upsampler's first and last rows and columns)."""
    h, w = size
    v = _zoom()
    a = np.stack([v, v[::-1], 255 - v[:, ::-1]], -1)[:h, :w]
    p = tmp_path / "x.webp"
    p.write_bytes(_pil_webp(a, lossless=lossless))
    _hold(p)


@pytest.mark.parametrize("colors", [2, 3, 4, 5, 16, 17, 256])
def test_palettes(tmp_path, colors):
    """Colour indexing with 1-, 2-, 4- and 8-bit bundling, with and
    without alpha in the palette."""
    rng = np.random.default_rng(colors)
    pal = rng.integers(0, 256, (colors, 4)).astype(np.uint8)
    idx = _zoom()[:45, :67].astype(np.int64) * colors // 256
    for a, m in ((pal[idx][..., :3], 0), (pal[idx], 6)):
        p = tmp_path / f"x{m}.webp"
        p.write_bytes(_pil_webp(a, lossless=True, method=m))
        _hold(p)


@pytest.mark.parametrize("filt", range(4))
@pytest.mark.parametrize("coding", ["raw", "vp8l"])
def test_alph_codings_and_filters(tmp_path, coding, filt):
    """Every ALPH coding under every filter: PIL's lossy RGBA file (raw
    alpha for noise, VP8L-coded for a photograph's alpha) with the
    filter bits of its ALPH header set by hand."""
    g = _zoom()[200:264, :80]
    alpha = (np.random.default_rng(3).integers(0, 256, g.shape)
             if coding == "raw" else _alpha_of(g)).astype(np.uint8)
    a = np.concatenate([np.stack([g, g // 2, 255 - g], -1),
                        alpha[..., None]], -1)
    chunks = _chunks(_pil_webp(a, alpha_quality=100))
    out = []
    for tag, payload in chunks:
        if tag == b"ALPH":
            assert payload[0] & 3 == (0 if coding == "raw" else 1)
            payload = bytes([payload[0] & ~0x0C | filt << 2]) + payload[1:]
        out.append((tag, payload))
    p = tmp_path / "x.webp"
    p.write_bytes(_riff(out))
    _hold(p)


@pytest.mark.parametrize("kw", [dict(), dict(lossless=True)])
def test_animation_first_frame(tmp_path, kw):
    g, t = _zoom()[:64, :80], _tilt()[:64, :80]
    frames = [Image.fromarray(np.stack([v, 255 - v, v // 2, _alpha_of(v)],
                                       -1)) for v in (g, t)]
    p = tmp_path / "x.webp"
    p.write_bytes(_pil_webp(frames[0], save_all=True,
                            append_images=frames[1:], duration=50, **kw))
    _hold(p)


@pytest.mark.parametrize("alpha", [False, True])
def test_animation_frame_at_an_offset(tmp_path, alpha):
    """A hand-made animation: its first ANMF frame, a 30x20 lossy (or
    lossy+ALPH) image, at (6, 4) on a 64x48 canvas, over the zero-filled
    canvas (WebPAnimDecoder's key frame)."""
    g = _zoom()[300:320, 100:130]
    a = np.stack([g, 255 - g, g // 2], -1)
    if alpha:
        a = np.concatenate([a, _alpha_of(g)[..., None]], -1)
    frame = [(t, p) for t, p in _chunks(_pil_webp(a)) if t != b"VP8X"]
    anmf = ((3).to_bytes(3, "little") + (2).to_bytes(3, "little")
            + (29).to_bytes(3, "little") + (19).to_bytes(3, "little")
            + (100).to_bytes(3, "little") + bytes([0])
            + b"".join(t + struct.pack("<I", len(p)) + p + bytes(len(p) & 1)
                       for t, p in frame))
    data = _riff([_vp8x(0x02 | (0x10 if alpha else 0), 64, 48),
                  (b"ANIM", bytes(4) + struct.pack("<H", 0)),
                  (b"ANMF", anmf)])
    p = tmp_path / "x.webp"
    p.write_bytes(data)
    assert Image.open(p).size == (64, 48)
    _hold(p)


def test_vp8x_metadata_chunks(tmp_path):
    """ICCP, EXIF (odd length: a padded chunk) and XMP chunks are
    skipped."""
    a = _colour(40, 56)
    exif = Image.Exif()
    exif[0x010E] = "a description of odd length"
    for kw in (dict(), dict(lossless=True)):
        data = _pil_webp(a, icc_profile=b"\x00" * 131, exif=exif.tobytes(),
                         xmp=b"<x:xmpmeta/>", **kw)
        assert [t for t, _ in _chunks(data)][0] == b"VP8X"
        p = tmp_path / "x.webp"
        p.write_bytes(data)
        _hold(p)


# ---------------------------------------------------------------------------
# VP8 frames written here: the simple loop filter, several token
# partitions and header fields PIL's encoder leaves alone

class _BoolEncoder:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = [], 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def bit(self, b, prob=128):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if b:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def literal(self, v, n):
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def signed(self, v, n):
        self.literal(abs(v), n)
        self.bit(int(v < 0))

    def flush(self) -> bytes:
        for _ in range(32):
            self.bit(0)
        return bytes(self.out)


@functools.lru_cache(maxsize=None)
def _rfc_table(name: str) -> np.ndarray:
    """A constant table of RFC 6386, as ``csrc/webp_decode.cpp`` holds it
    (the decoder PIL's reading of a frame is held against uses its own)."""
    from mods_tpu_torch.io.image import WEBP_SOURCE
    with open(WEBP_SOURCE) as f:
        src = f.read()
    decl = src[src.index(f" {name}["):]
    dims = [int(v) for v in re.findall(r"\[(\d+)\]", decl.split("=")[0])]
    body = decl.split("=", 1)[1].split("};")[0]
    return np.array([int(v) for v in re.findall(r"-?\d+", body)]).reshape(dims)


_BANDS = [0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0]
_CATS = ([173, 148, 140], [176, 155, 140, 135], [180, 157, 141, 134, 130],
         [254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129])
# the B_PRED sub-block modes' tree as (mode, [(node, bit), ...]), in the
# decoder's numbering (DC, TM, VE, HE, RD, VR, LD, VL, HD, HU)
_BMODE_PATHS = {0: [(0, 0)], 1: [(0, 1), (1, 0)], 2: [(0, 1), (1, 1), (2, 0)],
                3: [(0, 1), (1, 1), (2, 1), (3, 0), (4, 0)],
                4: [(0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 0)],
                5: [(0, 1), (1, 1), (2, 1), (3, 0), (4, 1), (5, 1)],
                6: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 0)],
                7: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 0)],
                8: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 0)],
                9: [(0, 1), (1, 1), (2, 1), (3, 1), (6, 1), (7, 1), (8, 1)]}


def _put_value(e, v, p):
    """A coefficient's magnitude v >= 1 on the token tree."""
    if v == 1:
        e.bit(0, p[2])
        return
    e.bit(1, p[2])
    if v <= 4:
        e.bit(0, p[3])
        e.bit(int(v > 2), p[4])
        if v > 2:
            e.bit(v - 3, p[5])
    elif v <= 10:
        e.bit(1, p[3])
        e.bit(0, p[6])
        e.bit(int(v > 6), p[7])
        if v <= 6:
            e.bit(v - 5, 159)
        else:
            e.bit((v - 7) >> 1, 165)
            e.bit((v - 7) & 1, 145)
    else:
        e.bit(1, p[3])
        e.bit(1, p[6])
        cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
        e.bit(cat >> 1, p[8])
        e.bit(cat & 1, p[9 + (cat >> 1)])
        extra, tab = v - (3 + (8 << cat)), _CATS[cat]
        for i, prob in enumerate(tab):
            e.bit((extra >> (len(tab) - 1 - i)) & 1, prob)


def _put_block(e, proba, typ, ctx, first, coeffs) -> int:
    """One block's tokens (coefficients in zigzag order); returns the
    index after the last coefficient, as the decoder's count."""
    nz = [n for n in range(first, 16) if coeffs[n]]
    p = proba[typ][_BANDS[first]][ctx]
    if not nz:
        e.bit(0, p[0])
        return first
    n = first
    while n <= nz[-1]:
        e.bit(1, p[0])
        while not coeffs[n]:
            e.bit(0, p[1])
            n += 1
            p = proba[typ][_BANDS[n]][0]
        e.bit(1, p[1])
        v = abs(int(coeffs[n]))
        _put_value(e, v, p)
        e.bit(int(coeffs[n] < 0))
        n += 1
        p = proba[typ][_BANDS[n]][1 if v == 1 else 2]
    if n < 16:
        e.bit(0, p[0])
    return n


def _vp8_frame(seed: int, simple: bool = None, parts_log2: int = None,
               body: bool = True) -> bytes:
    """A key frame of seeded size, header fields, modes and coefficients,
    in RFC 6386's syntax (no prediction: any syntax is a frame); with
    ``body`` False the first partition stops after the partitions'
    count."""
    rng = np.random.default_rng(seed)
    r = lambda lo, hi: int(rng.integers(lo, hi + 1))  # noqa: E731
    w, h = r(1, 70), r(1, 70)
    mb_w, mb_h = (w + 15) // 16, (h + 15) // 16
    e = _BoolEncoder()
    e.literal(0, 2)                              # colour space, clamping
    use_segment, update_map = r(0, 1), r(0, 1)
    seg_probs, quant, strength, absolute = [255] * 3, [0] * 4, [0] * 4, 1
    e.bit(use_segment)
    if use_segment:
        e.bit(update_map)
        e.bit(1)                                 # update the data
        absolute = r(0, 1)
        e.bit(absolute)
        for i in range(4):
            quant[i] = r(0, 40) if absolute else r(-15, 15)
            e.bit(1)
            e.signed(quant[i], 7)
        for i in range(4):
            strength[i] = r(10, 63) if absolute else r(-20, 20)
            e.bit(1)
            e.signed(strength[i], 6)
        if update_map:
            for i in range(3):
                seg_probs[i] = r(1, 255)
                e.bit(1)
                e.literal(seg_probs[i], 8)
    else:
        update_map = 0
    e.bit(int(r(0, 1) if simple is None else simple))
    e.literal(r(20, 63), 6)                      # filter level
    e.literal(r(0, 7), 3)                        # sharpness
    e.bit(1)                                     # loop-filter deltas
    e.bit(1)
    for _ in range(8):
        e.bit(1)
        e.signed(r(-15, 15), 6)
    parts_log2 = r(0, 3) if parts_log2 is None else parts_log2
    e.literal(parts_log2, 2)
    if not body:
        part0 = e.flush() + bytes(64)
        tag = (len(part0) << 5) | (1 << 4)
        return _riff([(b"VP8 ", tag.to_bytes(3, "little") + b"\x9d\x01\x2a"
                       + struct.pack("<HH", 16, 16) + part0 + bytes(256))])
    base_q = r(0, 40)
    e.literal(base_q, 7)
    deltas = [r(-15, 15) if r(0, 1) else 0 for _ in range(5)]
    for d in deltas:
        e.bit(int(d != 0))
        if d:
            e.signed(d, 4)
    e.bit(0)                                     # refresh entropy
    upd, proba = _rfc_table("kCoeffsUpdateProba"), \
        _rfc_table("kCoeffsProba0").copy()
    for idx in np.ndindex(*upd.shape):
        change = rng.random() < 0.1
        e.bit(int(change), int(upd[idx]))
        if change:
            proba[idx] = r(1, 255)
            e.literal(int(proba[idx]), 8)
    use_skip = r(0, 1)
    e.bit(use_skip)
    skip_p = r(1, 255)
    if use_skip:
        e.literal(skip_p, 8)
    # dequantisation of each segment, to keep coefficients in range
    dc, ac = _rfc_table("kDcTable"), _rfc_table("kAcTable")
    clip = lambda v, hi: min(max(v, 0), hi)  # noqa: E731
    dq = []
    for s in range(4):
        q = (quant[s] + (0 if absolute else base_q)) if use_segment \
            else base_q
        dq.append(max(dc[clip(q + deltas[0], 127)], ac[clip(q, 127)],
                      2 * dc[clip(q + deltas[1], 127)],
                      ac[clip(q + deltas[2], 127)] * 155 // 100,
                      dc[clip(q + deltas[3], 117)],
                      ac[clip(q + deltas[4], 127)]))
    bmodes = _rfc_table("kBModesProba")
    parts = [_BoolEncoder() for _ in range(1 << parts_log2)]
    intra_t = [0] * (4 * mb_w)
    top_nz, top_dc = [0] * mb_w, [0] * mb_w
    for mb_y in range(mb_h):
        t = parts[mb_y % len(parts)]
        intra_l, left_nz, left_dc = [0] * 4, 0, 0
        for mb_x in range(mb_w):
            seg = r(0, 3) if update_map else 0
            if update_map:
                e.bit(int(seg >= 2), seg_probs[0])
                e.bit(seg & 1, seg_probs[1 + (seg >> 1)])
            skip = r(0, 2) == 0 if use_skip else False
            if use_skip:
                e.bit(int(skip), skip_p)
            i4 = r(0, 1)
            e.bit(int(not i4), 145)
            top = intra_t[4 * mb_x:4 * mb_x + 4]
            if not i4:
                ymode = r(0, 3)          # DC, TM, V, H as the decoder numbers
                e.bit(int(ymode in (1, 3)), 156)
                e.bit(int(ymode in (1, 2)), 128 if ymode in (1, 3) else 163)
                top = [ymode] * 4
                intra_l = [ymode] * 4
            else:
                for y in range(4):
                    left = intra_l[y]
                    for x in range(4):
                        mode = r(0, 9)
                        prob = bmodes[top[x]][left]
                        for node, b in _BMODE_PATHS[mode]:
                            e.bit(b, int(prob[node]))
                        top[x] = left = mode
                    intra_l[y] = left
            intra_t[4 * mb_x:4 * mb_x + 4] = top
            uvmode = r(0, 3)
            e.bit(int(uvmode != 0), 142)
            if uvmode:
                e.bit(int(uvmode != 2), 114)
                if uvmode != 2:
                    e.bit(int(uvmode == 1), 183)
            if skip:
                top_nz[mb_x] = left_nz = 0
                if not i4:
                    top_dc[mb_x] = left_dc = 0
                continue
            limit = max(1, 1500 // int(dq[seg]))

            def coeffs():
                c = np.zeros(16, np.int64)
                k = r(0, 4) if rng.random() < 0.7 else r(0, 16)
                for n in rng.choice(16, k, replace=False):
                    v = r(1, 4) if rng.random() < 0.8 else r(5, 2114)
                    c[n] = min(v, limit) * (1 if r(0, 1) else -1)
                return c

            if not i4:
                nz = _put_block(t, proba, 1, top_dc[mb_x] + left_dc, 0,
                                coeffs())
                top_dc[mb_x] = left_dc = int(nz > 0)
                first, typ = 1, 0
            else:
                first, typ = 0, 3
            tnz, lnz = top_nz[mb_x], left_nz
            new_t, new_l = [0] * 8, [0] * 8
            for y in range(4):
                for x in range(4):
                    ctx = ((lnz >> y) & 1 if x == 0 else new_l[y]) + \
                        ((tnz >> x) & 1 if y == 0 else new_t[x])
                    nz = _put_block(t, proba, typ, ctx, first, coeffs())
                    new_t[x] = new_l[y] = int(nz > first)
            for ch in (4, 6):
                for y in range(2):
                    for x in range(2):
                        ctx = ((lnz >> (ch + y)) & 1 if x == 0
                               else new_l[ch + y]) + \
                            ((tnz >> (ch + x)) & 1 if y == 0
                             else new_t[ch + x])
                        nz = _put_block(t, proba, 2, ctx, 0, coeffs())
                        new_t[ch + x] = new_l[ch + y] = int(nz > 0)
            top_nz[mb_x] = sum(b << i for i, b in enumerate(new_t))
            left_nz = sum(b << i for i, b in enumerate(new_l))
    part0 = e.flush()
    tokens = [p.flush() for p in parts]
    frame = b"".join([
        ((len(part0) << 5) | (1 << 4)).to_bytes(3, "little"),
        b"\x9d\x01\x2a", struct.pack("<HH", w, h), part0,
        b"".join(len(x).to_bytes(3, "little") for x in tokens[:-1]),
        *tokens])
    return _riff([(b"VP8 ", frame)])


@pytest.mark.parametrize("seed", range(24))
def test_frames_written_here(tmp_path, seed):
    """Seeded key frames: the simple loop filter (even seeds) and the
    normal one, one to eight token partitions, segments with absolute
    and relative data and a map, loop-filter deltas, sharpness,
    quantiser deltas, token probability updates, skip, 16x16 and B_PRED
    modes: the port reads each as PIL does."""
    p = tmp_path / "x.webp"
    p.write_bytes(_vp8_frame(seed, simple=seed % 2 == 0,
                             parts_log2=seed % 4))
    _hold(p)


@pytest.mark.parametrize("case,match", [
    ("inter", "inter frames"),
    ("truncated", "truncated"),
    ("partition_sizes", "partition sizes are truncated"),
    ("first_chunk", "first chunk"),
])
def test_refusals_name_the_case(tmp_path, case, match):
    """What PIL does not open either raises a ValueError naming it: an
    inter frame (libwebp decodes key frames only), a truncated file, a
    header of eight token partitions without their sizes, a RIFF WEBP
    whose first chunk is not VP8, VP8L or VP8X."""
    lossy = _pil_webp(_colour(32, 48))
    if case == "inter":
        data = bytearray(lossy)
        data[20] |= 1                            # the frame tag's key bit
        data = bytes(data)
    elif case == "truncated":
        data = lossy[:len(lossy) // 2]
    elif case == "partition_sizes":
        data = _vp8_frame(7, parts_log2=3, body=False)
        chunk = _chunks(data)[0][1]
        cut = 10 + (int.from_bytes(chunk[:3], "little") >> 5) + 5
        data = _riff([(b"VP8 ", chunk[:cut])])
    else:
        data = _riff([(b"JUNK", b"\x00" * 6)] + _chunks(lossy))
    p = tmp_path / "x.webp"
    p.write_bytes(data)
    with pytest.raises(ValueError, match=match):
        read_image(p)
    with pytest.raises((OSError, ValueError, SyntaxError)):
        np.asarray(Image.open(p))


# ---------------------------------------------------------------------------
# the writer

RNG = np.random.default_rng(0)
GRAY = RNG.integers(0, 256, (37, 53)).astype(np.uint8)
RGB = np.stack([GRAY, GRAY // 2, 255 - GRAY], -1)
RGBA = np.concatenate([RGB, _alpha_of(GRAY)[..., None]], -1)
WRITES = {
    "bool": GRAY > 100,
    "L": GRAY,
    "LA": np.stack([GRAY, _alpha_of(GRAY)], -1),
    "RGB": RGB,
    "RGBA": RGBA,
    "RGBA_opaque": np.concatenate([RGB, np.full(GRAY.shape + (1,), 255,
                                                np.uint8)], -1),
    "RGBA_transparent": np.concatenate([RGB, np.zeros(GRAY.shape + (1,),
                                                      np.uint8)], -1),
    "uint16": GRAY.astype(np.uint16) * 3,
    "int32": GRAY.astype(np.int32) * 2 - 100,
    "int8": (GRAY.astype(np.int16) - 128).astype(np.int8),
    "float": np.concatenate([GRAY.astype(np.float32)[:-1] * 1.3 - 20.5,
                             np.array([[np.nan, np.inf, -np.inf, 0.5, 254.9,
                                        -0.9] + [3.0] * 47],
                                      np.float32)]),
    "photo": _zoom()[:300, :400],
    "1x1": RGB[:1, :1],
}


@pytest.mark.parametrize("case", sorted(WRITES))
def test_webp_writes_what_pil_reads_from_its_lossless_save(tmp_path, case):
    a = WRITES[case]
    ours, pils = tmp_path / "ours.webp", tmp_path / "pils.webp"
    save_image(ours, a)
    pils.write_bytes(_pil_webp(a, lossless=True))
    got, want = Image.open(ours), Image.open(pils)
    assert got.format == "WEBP"
    assert got.mode == want.mode and got.size == want.size
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    _hold(ours)


def test_webp_refusals_are_pils(tmp_path):
    """PIL refuses a 16384-pixel side, an empty image and an array it
    cannot make an image of; so does the port, naming them."""
    for a, match in ((np.zeros((1, 16384, 3), np.uint8), "16383"),
                     (np.zeros((0, 5, 3), np.uint8), "1 to 16383"),
                     (np.zeros((4, 4, 5), np.uint8), "cannot write")):
        p = tmp_path / "x.webp"
        with pytest.raises(ValueError, match=match):
            save_image(p, a)
        assert not p.exists()
        with pytest.raises((ValueError, TypeError, MemoryError)):
            _pil_webp(a, lossless=True)


def test_viz_writes_webp_drawings(tmp_path):
    g = _zoom()
    xy = np.array([[10.0, 20.0], [300.0, 400.0]])
    canvas = viz.draw_matches(g, g, xy, xy + 3)
    viz.save_image(str(tmp_path / "d.webp"), canvas)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "d.webp")), canvas)


def test_encoder_bytes_are_deterministic():
    """Phase 14j holds the encoder's bytes to hashes taken on the CPU:
    the same array gives the same bytes, the hashes chip_smoke.py carries
    are this build's, and PIL reads each file to the array that phase
    expects."""
    from mods_tpu_torch.io.image import _webp_bytes
    for name, (canvas, mode, want) in _encode_canvases().items():
        data = _webp_bytes(canvas, mode)
        assert data == _webp_bytes(canvas, mode)
        assert hashlib.sha256(data).hexdigest() == \
            chip_smoke.WEBP_ENCODE_SHA256[name], name
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(data))), want)


def _encode_canvases() -> dict:
    return chip_smoke.webp_encode_canvases(
        [_zoom(1), _zoom(2), _tilt()])


# ---------------------------------------------------------------------------
# the match command on a WebP pair, its drawings named .webp

@pytest.fixture(scope="module")
def webp_pair(tmp_path_factory):
    """test_torch_cli.py's textured pair, saved by PIL as lossy WebP."""
    load_jax_native()
    d = tmp_path_factory.mktemp("webp_pair")
    img1 = textured_image(128, 176, seed=4)
    img2 = warp_np(img1, SHIFT, 128, 176)
    for name, img in (("a", img1), ("b", img2)):
        (d / f"{name}.webp").write_bytes(
            _pil_webp(np.clip(img, 0, 255).astype(np.uint8)))
    (d / "iters.ini").write_text(SMALL_ITERS)
    (d / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
    return d


def test_cli_match_on_webp_with_webp_drawings_against_jax(webp_pair,
                                                          capsys):
    d = webp_pair
    figures = {}
    for tag, run in (("jax", jcli.cmd_match),
                     ("torch", lambda a: tcli.main(
                         ["match"] + a + ["--device", "cpu"]))):
        m = d / f"m_{tag}.txt"
        assert run([str(d / "a.webp"), str(d / "b.webp"),
                    str(d / f"o1_{tag}.webp"), str(d / f"o2_{tag}.webp"),
                    "k1", "k2", str(m), "0", "LORANSACH",
                    str(d / "config.ini"), str(d / "iters.ini")]) == 0
        figures[tag] = chip_smoke.match_figures(
            capsys.readouterr().out, str(m), SHIFT, 176, 128)
        for o in (1, 2):
            im = Image.open(d / f"o{o}_{tag}.webp")
            assert im.format == "WEBP" and im.mode == "RGB"
    j, t = figures["jax"], figures["torch"]
    assert t["steps"] == j["steps"]
    assert t["matches"] >= 10 and abs(t["matches"] - j["matches"]) \
        <= 0.2 * j["matches"], (t, j)
    # the port's drawings decode to viz's canvases exactly (lossless)
    imgs = [read_image(d / f"{n}.webp") for n in ("a", "b")]
    xy1, xy2 = read_matches(str(d / "m_torch.txt"))
    H = read_h(str(d / "m_torch.txt.H"))
    for o, canvas in ((1, viz.draw_matches(*imgs, xy1, xy2)),
                      (2, viz.draw_matches_with_error(*imgs, xy1, xy2, H))):
        np.testing.assert_array_equal(
            np.asarray(Image.open(d / f"o{o}_torch.webp")), canvas)


# ---------------------------------------------------------------------------
# the JAX figures of chip_smoke.py phase 14k

def _jax_webp_main() -> None:
    """The JAX command on phase 14k's pair: the committed zoom2x WebP
    fixtures (PIL's default lossy files), LORANSACH, the CVIU-shaped INI
    files (``JAX_WEBP_REFERENCE``)."""
    import contextlib
    import json
    import tempfile
    import time
    from pathlib import Path
    fx = chip_smoke.IMAGE_FIXTURES
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        (td / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
        (td / "iters.ini").write_text(chip_smoke.cviu_iters_ini())
        m = td / "m.txt"
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jcli.cmd_match([str(fx / "zoom2x_1.webp"),
                                   str(fx / "zoom2x_2.webp"), "0", "0",
                                   "k1", "k2", str(m), "0", "LORANSACH",
                                   str(td / "config.ini"),
                                   str(td / "iters.ini")]) == 0
        h, w = np.asarray(Image.open(fx / "zoom2x_1.webp")).shape[:2]
        figures = chip_smoke.match_figures(
            buf.getvalue(), str(m),
            np.loadtxt(chip_smoke.PAIRS / "zoom2x_H.txt"), w, h)
    print(json.dumps(dict(figures, seconds=round(time.time() - t0, 1))),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--fixtures"]:
        write_webp_fixtures(chip_smoke.IMAGE_FIXTURES)
    elif sys.argv[1:] == ["--jax-webp"]:
        _jax_webp_main()
