"""Port vs libzstd 1.5.7 and PIL on Zstandard (CPU): the port's decoder
``csrc/zstd_decode.cpp`` (``io/tiff.py::zstd_decode``) against the
libzstd that Pillow 12.1.0 bundles (``pillow.libs/libzstd-*.so``, through
ctypes: ``ZSTD_createCCtx``, ``ZSTD_CCtx_setParameter``,
``ZSTD_compress2`` and ``ZSTD_compressStream2`` write the frames,
``ZSTD_decompress`` is the reference), and Zstandard TIFFs (compression
50000) against ``np.asarray(Image.open(path))``.

Tolerance: none.  The port's bytes must equal libzstd's on every frame of
the matrix (levels 1, 3, 9, 19 and 22; checksum and content size on and
off; long-distance matching; frames of several blocks; constant and
random data; two frames; a skippable frame first; a streamed frame), and
a ValueError must be raised exactly where libzstd fails on a frame cut at
every byte or with bits flipped (``hypothesis``, derandomized), in a
subprocess so that a crash fails the test.  A TIFF must read to PIL's
array, or be refused by name where PIL fails (``hold``).
"""

import ctypes
import glob
import io
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for _p in (REPO, os.path.join(REPO, "tests")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import pytest  # noqa: E402
from PIL import Image  # noqa: E402

from mods_tpu_torch.io import tiff  # noqa: E402

# ---------------------------------------------------------------------------
# libzstd through ctypes

_ZSTD_C_LEVEL, _ZSTD_C_WINDOW_LOG = 100, 101
_ZSTD_C_CONTENT_SIZE, _ZSTD_C_CHECKSUM = 200, 201
_ZSTD_C_LDM = 160


class _Buffer(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def libzstd():
    """Pillow's bundled libzstd, with the argument types set."""
    import PIL
    found = glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..",
                                   "pillow.libs", "libzstd*.so*"))
    assert found, "Pillow bundles no libzstd"
    z = ctypes.CDLL(found[0])
    c = ctypes
    z.ZSTD_createCCtx.restype = c.c_void_p
    z.ZSTD_freeCCtx.argtypes = [c.c_void_p]
    z.ZSTD_CCtx_setParameter.argtypes = [c.c_void_p, c.c_int, c.c_int]
    z.ZSTD_CCtx_setParameter.restype = c.c_size_t
    z.ZSTD_compress2.argtypes = [c.c_void_p, c.c_void_p, c.c_size_t,
                                 c.c_char_p, c.c_size_t]
    z.ZSTD_compress2.restype = c.c_size_t
    z.ZSTD_compressStream2.argtypes = [c.c_void_p, c.POINTER(_Buffer),
                                       c.POINTER(_Buffer), c.c_int]
    z.ZSTD_compressStream2.restype = c.c_size_t
    z.ZSTD_compressBound.argtypes = [c.c_size_t]
    z.ZSTD_compressBound.restype = c.c_size_t
    z.ZSTD_decompress.argtypes = [c.c_void_p, c.c_size_t, c.c_char_p,
                                  c.c_size_t]
    z.ZSTD_decompress.restype = c.c_size_t
    z.ZSTD_isError.argtypes = [c.c_size_t]
    z.ZSTD_getErrorName.argtypes = [c.c_size_t]
    z.ZSTD_getErrorName.restype = c.c_char_p
    return z


_Z = None


def _z():
    global _Z
    if _Z is None:
        _Z = libzstd()
    return _Z


def _check(z, r):
    if z.ZSTD_isError(r):
        raise ValueError(z.ZSTD_getErrorName(r).decode())
    return r


def zstd_compress(data: bytes, level: int = 3, checksum: bool = False,
                  content_size: bool = True, ldm: bool = False,
                  window_log: int = 0, chunk: int = 0) -> bytes:
    """One frame of ``data``: ``ZSTD_compress2`` with these parameters,
    or with ``chunk`` ``ZSTD_compressStream2`` fed ``chunk`` bytes at a
    time and ended (a frame without its content size, as libtiff's
    ZSTDEncode writes it)."""
    z = _z()
    cc = z.ZSTD_createCCtx()
    try:
        for key, val in ((_ZSTD_C_LEVEL, level),
                         (_ZSTD_C_CHECKSUM, int(checksum)),
                         (_ZSTD_C_CONTENT_SIZE, int(content_size)),
                         (_ZSTD_C_LDM, int(ldm)),
                         (_ZSTD_C_WINDOW_LOG, window_log)):
            _check(z, z.ZSTD_CCtx_setParameter(cc, key, val))
        cap = z.ZSTD_compressBound(len(data)) + 1024
        out = ctypes.create_string_buffer(cap)
        if not chunk:
            n = _check(z, z.ZSTD_compress2(cc, out, cap, data, len(data)))
            return out.raw[:n]
        src = ctypes.create_string_buffer(data, len(data))
        ob = _Buffer(ctypes.cast(out, ctypes.c_void_p), cap, 0)
        for at in range(0, len(data) + 1, chunk):
            end = min(at + chunk, len(data))
            ib = _Buffer(ctypes.addressof(src) + at, end - at, 0)
            last = end == len(data)
            while True:
                left = _check(z, z.ZSTD_compressStream2(
                    cc, ctypes.byref(ob), ctypes.byref(ib), 2 if last else 0))
                if ib.pos == ib.size and (not last or left == 0):
                    break
            if last:
                break
        return out.raw[:ob.pos]
    finally:
        z.ZSTD_freeCCtx(cc)


def zstd_decompress(frame: bytes, cap: int) -> bytes:
    """``ZSTD_decompress`` into ``cap`` bytes; a ValueError where it
    fails."""
    z = _z()
    out = ctypes.create_string_buffer(max(cap, 1))
    n = _check(z, z.ZSTD_decompress(out, cap, frame, len(frame)))
    return out.raw[:n]


def skippable(payload: bytes, nibble: int = 0) -> bytes:
    return (0x184D2A50 + nibble).to_bytes(4, "little") + \
        len(payload).to_bytes(4, "little") + payload


# ---------------------------------------------------------------------------
# the matrix

def _text() -> bytes:
    # the JAX package's sources, which do not change
    parts = sorted(glob.glob(os.path.join(REPO, "mods_tpu", "**", "*.py"),
                             recursive=True))
    return b"".join(open(p, "rb").read() for p in parts)[:300_000]


def _image() -> bytes:
    return np.asarray(Image.open(os.path.join(
        REPO, ".parity_work", "zoom2x_1.png"))).tobytes()


def _runs() -> bytes:
    # 100 KB of noise, then short copies of it after the same two bytes:
    # one-byte literals (RLE literals) and same-code lengths (RLE tables)
    r = np.random.default_rng(1).integers(0, 256, 100_000,
                                          dtype=np.uint8).tobytes()
    return r + b"".join(b"zz" + r[i * 3:i * 3 + 40] for i in range(3000))


def _records() -> bytes:
    # steady statistics over many blocks: repeated tables and treeless
    # Huffman literals at high levels
    return b"".join(b"record %05d value %d\n" % (i, i * 31 % 97)
                    for i in range(40_000))


DATA = {"text": _text, "image": _image, "runs": _runs, "records": _records,
        "constant": lambda: b"\x07" * 300_000,
        "random": lambda: np.random.default_rng(2).integers(
            0, 256, 200_000, dtype=np.uint8).tobytes(),
        "short": lambda: b"Zstandard in TIFF, " * 9}

# id -> (data name, compression parameters)
MATRIX = {}
for _level in (1, 3, 9, 19, 22):
    MATRIX[f"text_level{_level}"] = ("text", dict(level=_level,
                                                  checksum=True))
for _ck in (False, True):
    for _cs in (False, True):
        MATRIX[f"image_checksum{int(_ck)}_size{int(_cs)}"] = (
            "image", dict(level=3, checksum=_ck, content_size=_cs))
MATRIX.update({
    "image_ldm": ("image", dict(level=19, ldm=True, window_log=27)),
    "image_window10": ("image", dict(level=3, window_log=10)),
    "runs_level19": ("runs", dict(level=19)),
    "runs_level1": ("runs", dict(level=1, checksum=True)),
    "records_level19": ("records", dict(level=19, content_size=False)),
    "records_level3": ("records", dict(level=3)),
    "constant": ("constant", dict(level=3, checksum=True)),
    "random": ("random", dict(level=3)),
    "short_level19": ("short", dict(level=19)),
    "short_level3": ("short", dict(level=3, content_size=False)),
    "text_streamed": ("text", dict(level=3, chunk=8192)),
})
MULTI = ("two_frames", "skippable_first", "skippable_between")


def matrix_frame(case: str) -> tuple[bytes, bytes]:
    """(frame, the data it holds) of a matrix case."""
    if case in MULTI:
        a, b = DATA["text"]()[:70_000], DATA["records"]()[:90_000]
        fa = zstd_compress(a, 9, checksum=True)
        fb = zstd_compress(b, 3, content_size=False)
        if case == "two_frames":
            return fa + fb, a + b
        if case == "skippable_first":
            return skippable(b"metadata" * 5, 3) + fa, a
        return fa + skippable(b"", 15) + fb, a + b
    name, kw = MATRIX[case]
    data = DATA[name]()
    return zstd_compress(data, **kw), data


CASES = sorted(MATRIX) + list(MULTI)


@pytest.mark.parametrize("case", CASES)
def test_frame_equals_libzstd(case):
    """The port's bytes are libzstd's (and the data's) on each case."""
    frame, data = matrix_frame(case)
    cap = len(data) + 4096
    want = zstd_decompress(frame, cap)
    assert want == data
    got = tiff.zstd_decode(frame, cap)
    assert got == want


def test_coverage_of_the_matrix():
    """The matrix reaches every block type, every literals type (raw, RLE,
    Huffman, treeless), one and four Huffman streams, the X1, X2 and fast
    4-stream Huffman decoders, the four modes (predefined, RLE, FSE,
    repeat) of each of the literal-length, match-length and offset codes,
    the three repeat offsets, windowed and single-segment frames,
    checksums and skippable frames (the decoder's counters)."""
    tiff.zstd_coverage(reset=True)
    for case in CASES:
        frame, data = matrix_frame(case)
        assert tiff.zstd_decode(frame, len(data)) == data
    cov = tiff.zstd_coverage(reset=True)
    missing = [k for k in tiff.ZSTD_COUNTERS if cov[k] == 0]
    assert not missing, (missing, cov)


def test_refusals_name_the_case():
    """A frame that names a dictionary, a window above 2^27 where the
    frame is read block by block (libtiff's streamed read), reserved bits
    and a checksum that does not match: libzstd fails on each, and the
    port raises a ValueError that holds one of ``tiff.REFUSALS``."""
    data = b"abcdefgh" * 100
    frame = bytearray(zstd_compress(data, 3, checksum=True))
    bad_sum = bytes(frame[:-1]) + bytes([frame[-1] ^ 1])
    reserved = bytearray(frame)
    reserved[4] |= 0x08
    dict_id = bytearray(frame)
    # a one-byte dictionary ID field, after the window descriptor if any
    dict_id[4] |= 1
    at = 5 if frame[4] & 0x20 else 6
    dict_id[at:at] = b"\x05"
    cases = {"checksum does not match": bad_sum,
             "reserved bits": bytes(reserved),
             "dictionary": bytes(dict_id)}
    for what, f in cases.items():
        with pytest.raises(ValueError):
            zstd_decompress(f, 10_000)
        for strip in (False, True):
            with pytest.raises(ValueError, match=what) as e:
                tiff.zstd_decode(f, 10_000 if not strip else len(data),
                                 strip)
            assert any(r in str(e.value) for r in tiff.REFUSALS)
    # a 2^28 window, streamed: one-shot decoding takes it, a strip does not
    big = zstd_compress(data, 3, window_log=28, content_size=False,
                        chunk=100)
    assert zstd_decompress(big, 10_000) == data
    assert tiff.zstd_decode(big, 10_000) == data
    with pytest.raises(ValueError, match="2\\^27") as e:
        tiff.zstd_decode(big, len(data), True)
    assert any(r in str(e.value) for r in tiff.REFUSALS)


# ---------------------------------------------------------------------------
# the fuzz: frames cut at every byte and with bits flipped, against
# ZSTD_decompress (``python tests/test_torch_zstd.py --fuzz`` runs it and
# prints its counts; the test runs that in a subprocess)

FUZZ_EXAMPLES = 3000


def fuzz_frames() -> list:
    """(frame, data) pairs that the fuzz damages: small frames that still
    reach every block, literals and table mode (raw and RLE blocks, one
    and four Huffman streams with the fast loop, treeless literals,
    repeated and RLE tables, checksums, windowed frames of many blocks)."""
    text = _text()
    records = _records()[:40_000]
    noise = np.random.default_rng(1).integers(0, 256, 8000,
                                              dtype=np.uint8).tobytes()
    runs = noise + b"".join(b"zz" + noise[i * 3:i * 3 + 40]
                            for i in range(600))
    out = []
    for data, kw in ((text[:3000], dict(level=1)),
                     (text[:20_000], dict(level=19, checksum=True)),
                     (_image()[:30_000], dict(level=3)),
                     (text[:4000], dict(level=3, window_log=10)),
                     (records, dict(level=19, window_log=12,
                                    content_size=False)),
                     (runs, dict(level=19)),
                     (b"\x00" * 3000 + text[:500] + b"\x00" * 2000,
                      dict(level=3, window_log=10)),
                     (np.random.default_rng(4).integers(
                         0, 256, 3000, dtype=np.uint8).tobytes(),
                      dict(level=3)),
                     (text[:300], dict(level=19))):
        out.append((zstd_compress(data, **kw), data))
    a, b = out[0], out[-1]
    out.append((skippable(b"abc") + a[0] + b[0], a[1] + b[1]))
    return out


def _agree(frame: bytes, cap: int) -> None:
    """The port's bytes are libzstd's, or both fail (ValueError)."""
    try:
        want = zstd_decompress(frame, cap)
    except ValueError as e:
        want = e
    try:
        got = tiff.zstd_decode(frame, cap)
    except ValueError as e:
        got = e
    if isinstance(want, ValueError) or isinstance(got, ValueError):
        assert isinstance(want, ValueError) and isinstance(got, ValueError), (
            frame.hex(), cap, str(want)[:80], str(got)[:80])
    else:
        assert got == want, (frame.hex(), cap)


def _fuzz_main() -> None:
    import json

    from hypothesis import given, settings
    from hypothesis import strategies as st
    frames = fuzz_frames()
    cuts = 0
    for frame, data in frames:
        for cut in range(len(frame)):
            _agree(frame[:cut], len(data) + 64)
            cuts += 1

    @settings(max_examples=FUZZ_EXAMPLES, derandomize=True, database=None,
              deadline=None)
    @given(st.data())
    def flips(d):
        frame, data = d.draw(st.sampled_from(frames))
        g = bytearray(frame)
        for _ in range(d.draw(st.integers(1, 4))):
            bit = d.draw(st.integers(0, 8 * len(g) - 1))
            g[bit // 8] ^= 1 << (bit % 8)
        cap = len(data) + d.draw(st.sampled_from([0, 17, 1 << 20]))
        _agree(bytes(g), cap)

    flips()
    print(json.dumps(dict(frames=len(frames), cuts=cuts,
                          flips=FUZZ_EXAMPLES)), flush=True)


def test_fuzz_against_libzstd(tmp_path):
    """Every cut and the bit flips of ``fuzz_frames``: the port's bytes
    are libzstd's where it decodes, and a ValueError where it fails; run
    in a subprocess, so that a crash of the C++ fails here (in
    ``tmp_path``, where hypothesis keeps its files)."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--fuzz"], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, (out.returncode, out.stdout[-2000:],
                                 out.stderr[-4000:])
    import json
    counts = json.loads(out.stdout.strip().splitlines()[-1])
    assert counts["cuts"] > 10_000 and counts["flips"] == FUZZ_EXAMPLES


# ---------------------------------------------------------------------------
# Zstandard TIFFs against PIL

from test_torch_tiff_variants import (assemble, hold, pil_read,  # noqa
                                      tiff_file)

# (dtype, sample format, predictors): 8-, 16- and 32-bit integers and
# 32-bit floats, with the predictors libtiff takes for each
TIFF_SAMPLES = {"u8": (np.uint8, 1, (1, 2)), "u16": (np.uint16, 1, (1, 2)),
                "i16": (np.int16, 2, (1, 2)), "i32": (np.int32, 2, (1, 2)),
                "u32": (np.uint32, 1, (1, 2)),
                "f32": (np.float32, 3, (1, 2, 3)),
                "rgb8": (np.uint8, 1, (1, 2))}


def _samples(name, h, w, seed):
    dtype = TIFF_SAMPLES[name][0]
    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if name == "rgb8" else (h, w)
    base = np.cumsum(rng.integers(-3, 4, shape), 1)  # compressible
    if dtype == np.float32:
        return (base / 7.0 - 2.5).astype(np.float32)
    info = np.iinfo(dtype)
    return (base % (int(info.max) + 1 - max(int(info.min), 0))
            + max(int(info.min), 0)).astype(dtype)


@pytest.mark.parametrize("layout", ["strips", "tiles"])
@pytest.mark.parametrize("bo", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("name", sorted(TIFF_SAMPLES))
def test_tiff_equals_pil(tmp_path, name, bo, layout):
    """Zstandard TIFFs of each sample type, under each predictor libtiff
    takes for it, in both byte orders, in strips of 7 rows and in 16 x 32
    tiles (frames of every level and content size): PIL's array."""
    dtype, fmt, predictors = TIFF_SAMPLES[name]
    # PIL's OPEN_INFO has no big-endian unsigned 32-bit key: refused
    refused = bo == ">" and name == "u32"
    a = _samples(name, 37, 53, len(name))
    kw = dict(tile=(16, 32)) if layout == "tiles" else dict(
        rows_per_strip=7)
    for predictor in predictors:
        for level in (1, 19):
            data = tiff_file(a, bo, photometric=2 if a.ndim == 3 else 1,
                             sample_format=fmt, compression=50000,
                             predictor=predictor, zstd_level=level, **kw)
            assert (hold(tmp_path, data) is None) == refused, (predictor,
                                                               level)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "1"])
def test_tiff_written_by_pil(tmp_path, mode):
    """PIL's own Zstandard TIFFs (libtiff's ZSTDEncode: streamed frames
    without their content size), with and without predictor 2."""
    rng = np.random.default_rng(3)
    a = np.cumsum(rng.integers(0, 3, (61, 75, 4)), 1).astype(np.uint8)
    im = {"L": Image.fromarray(a[..., 0]), "RGB": Image.fromarray(a[..., :3]),
          "RGBA": Image.fromarray(a), "1": Image.fromarray(a[..., 0] > 40)}[
        mode]
    for info in ({}, {317: 2}):
        if mode == "1" and info:
            continue
        f = io.BytesIO()
        im.save(f, "TIFF", compression="zstd", tiffinfo=info)
        data = f.getvalue()
        assert tiff.read_ifd(data, "x")[1][259] == (50000,)
        assert hold(tmp_path, data) is not None


def _strip_file(chunk: bytes, h=8, w=16) -> bytes:
    return assemble({256: (4, [w]), 257: (4, [h]), 258: (3, [8]),
                     259: (3, [50000]), 262: (3, [1]), 278: (4, [h])},
                    [chunk])


STRIP_DATA = np.arange(128, dtype=np.uint8).tobytes()


def _strip_cases() -> dict:
    d = STRIP_DATA
    one = zstd_compress(d, 3)
    streamed = zstd_compress(d, 3, content_size=False, chunk=50)
    check = zstd_compress(d, 3, checksum=True)
    return {
        "whole": one,
        "streamed": streamed,
        "trailing_bytes": one + b"trailing garbage",
        "trailing_frame": one + zstd_compress(b"more", 3),
        "short": zstd_compress(d[:100], 3),
        "short_streamed": zstd_compress(d[:100], 3, content_size=False,
                                        chunk=30),
        "long": zstd_compress(d + b"x" * 50, 3),
        "long_streamed": zstd_compress(d + b"x" * 50, 3,
                                       content_size=False, chunk=30),
        "two_halves": zstd_compress(d[:64], 3) + zstd_compress(d[64:], 3),
        "skippable_first": skippable(b"x") + one,
        "cut": one[:len(one) - 3],
        "cut_streamed": streamed[:len(streamed) - 3],
        "checksum": check,
        "bad_checksum": check[:-1] + bytes([check[-1] ^ 1]),
        "window_2^28": zstd_compress(d, 3, window_log=28,
                                     content_size=False, chunk=40),
        "empty": b"",
    }


@pytest.mark.parametrize("case", sorted(_strip_cases()))
def test_strip_read_as_pil(tmp_path, case):
    """One strip of 128 bytes as libtiff's ZSTDDecode reads it: the first
    frame only, bytes after it ignored, a frame that ends short (or a
    skippable frame first) refused as PIL refuses it, one that runs long
    cut to the strip, a window above 2^27 refused when streamed."""
    data = _strip_file(_strip_cases()[case])
    got = hold(tmp_path, data)
    want = pil_read(data)
    assert (got is None) == isinstance(want, Exception)


if __name__ == "__main__":
    if sys.argv[1:] == ["--fuzz"]:
        _fuzz_main()
