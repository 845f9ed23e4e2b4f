"""Port vs PIL on old-style JPEG TIFFs (compression 6), SGILog TIFFs and
AVIF files, as the JAX commands open them through PIL
(``np.asarray(Image.open(path))``, Pillow 12.1.0 with libtiff 4.7.1 and
libjpeg-turbo) (CPU).

PIL and libtiff write no compression 6, so the files are built by hand:
``baseline_jpeg`` is a small baseline JPEG encoder of any sampling
factors and restart interval (the Annex K tables; its stream only has to
be valid, PIL's reading of it is the reference), and ``ojpeg_tiff`` lays
a stream out as libtiff's tif_ojpeg.c looks for it: the interchange form
(JPEGInterchangeFormat at the stream's header or at the whole stream,
the strips or tiles at its restart intervals) or the tables form
(JPEGQTables, JPEGDCTables and JPEGACTables; the strips hold the
entropy-coded data alone).  PIL's own streams, with
``restart_marker_rows``, serve too (``pil_ojpeg_tiff``).

Tolerance: none.  ``io/image.py::_read`` must give PIL's array (dtype,
shape, every value) and mode, or, where PIL fails, raise a ValueError
that names the case ("old-style JPEG", "SGILog", "AVIF") and holds one
of ``io/tiff.py::REFUSALS``.

``python tests/test_torch_ojpeg.py --fixtures`` writes ``chip_smoke.py``
phase 14r-14s's fixtures into ``tests/data/image_io``;
``JAX_PLATFORMS=cpu python tests/test_torch_ojpeg.py --jax-tiff-ojpeg``
prints the JAX command's figures on 14s's pair
(``chip_smoke.JAX_TIFF_OJPEG_REFERENCE``).
"""

import hashlib
import io
import os
import struct
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytest  # noqa: E402
from PIL import Image  # noqa: E402

import chip_smoke  # noqa: E402
from mods_tpu_torch.io import tiff  # noqa: E402
from mods_tpu_torch.io.image import _read, image_size  # noqa: E402
from test_torch_tiff_variants import (_jax_tiff_jpeg_main, _zoom,  # noqa
                                      pil_read, tiff_file)


# ---------------------------------------------------------------------------
# a baseline JPEG encoder of any sampling

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43,
    36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53,
    60, 61, 54, 47, 55, 62, 63])
# Annex K's quantisation tables, row by row
_QUANT = (np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13,
    16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56,
    68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78, 87, 103,
    121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]), np.array(
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26,
     56, 99, 99, 99, 99, 99, 47, 66, 99, 99] + [99] * 36))


def _annex_k_huffman():
    """Annex K's Huffman tables as PIL's encoder writes them: {table
    class and id: (16 counts, symbols)}."""
    f = io.BytesIO()
    Image.new("RGB", (8, 8)).save(f, "JPEG")
    d, pos, tables = f.getvalue(), 2, {}
    while d[pos + 1] != 0xDA:
        n = int.from_bytes(d[pos + 2:pos + 4], "big")
        if d[pos + 1] == 0xC4:
            body, k = d[pos + 4:pos + 2 + n], 0
            while k < len(body):
                counts = body[k + 1:k + 17]
                tables[body[k]] = (counts, body[k + 17:k + 17 + sum(counts)])
                k += 17 + sum(counts)
        pos += 2 + n
    return tables


_HUFFMAN = _annex_k_huffman()
# the DCT's basis, and its first row (the DC) kept exact apart
_BASIS = np.cos((2 * np.arange(8)[None] + 1) * np.arange(8)[:, None]
                * np.pi / 16) * 0.5
_BASIS[0] = 0.5 / np.sqrt(2)


def _codes(table):
    counts, symbols = table
    out, code, k = {}, 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            out[symbols[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


class _Bits:
    """Huffman-coded bits, MSB first, a 0x00 after each 0xFF, each
    segment padded with 1-bits."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code, n):
        for i in range(n - 1, -1, -1):
            self.acc = self.acc << 1 | (code >> i) & 1
            self.n += 1
            if self.n == 8:
                self.out += b"\xff\x00" if self.acc == 0xFF else bytes(
                    [self.acc])
                self.acc = self.n = 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        out, self.out = bytes(self.out), bytearray()
        return out


def _coefficients(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Each 8x8 block's quantised coefficients in zigzag order: (block
    rows, block columns, 64); the DC computed exactly."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    blocks = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128.0
    coef = np.einsum("ui,abij,vj->abuv", _BASIS, blocks, _BASIS)
    coef[..., 0, 0] = blocks.sum((2, 3)) / 8
    return np.round(coef.reshape(bh, bw, 64)[..., _ZIGZAG] / q).astype(int)


def baseline_jpeg(samples: np.ndarray, sampling, quality=75, restart=0):
    """A baseline JPEG of (h, w[, n]) uint8 component samples (no colour
    transform), component i sampled ``sampling[i]`` (h, v), restart
    markers every ``restart`` MCUs: its parts {"dqt": [segments], "dht":
    [segments], "dri", "sof", "sos": segment, "segments": [the
    entropy-coded data between restart markers], "qt": [64 bytes each],
    "dc"/"ac": [(counts, symbols)] of tables 0 and 1, "tq": [table of
    each component]}."""
    samples = samples[..., None] if samples.ndim == 2 else samples
    h, w, n = samples.shape
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mx, my = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    qt = [np.clip((q * scale + 50) // 100, 1, 255)[_ZIGZAG] for q in _QUANT]
    tq = [0] + [1] * (n - 1)
    coefs = []
    for c in range(n):
        hs, vs = sampling[c]
        fx, fy = hmax // hs, vmax // vs
        pad = np.pad(samples[..., c].astype(float),
                     ((0, my * 8 * vmax - h), (0, mx * 8 * hmax - w)),
                     mode="edge")
        plane = pad.reshape(pad.shape[0] // fy, fy, pad.shape[1] // fx,
                            fx).mean((1, 3))
        coefs.append(_coefficients(plane, qt[tq[c]]))
    codes = [(_codes(_HUFFMAN[min(c, 1)]), _codes(_HUFFMAN[0x10 | min(c, 1)]))
             for c in range(n)]
    bits, segments, pred = _Bits(), [], [0] * n
    for mcu in range(mx * my):
        if restart and mcu and mcu % restart == 0:
            segments.append(bits.flush())
            pred = [0] * n
        j, i = divmod(mcu, mx)
        for c in range(n):
            hs, vs = sampling[c]
            dc, ac = codes[c]
            for v in range(vs):
                for u in range(hs):
                    z = coefs[c][j * vs + v, i * hs + u]
                    diff, pred[c] = z[0] - pred[c], z[0]
                    s = abs(int(diff)).bit_length()
                    bits.put(*dc[s])
                    bits.put(diff if diff >= 0 else diff - 1 + (1 << s), s)
                    run = 0
                    for a in z[1:]:
                        if a == 0:
                            run += 1
                            continue
                        while run > 15:
                            bits.put(*ac[0xF0])
                            run -= 16
                        s = abs(int(a)).bit_length()
                        bits.put(*ac[run << 4 | s])
                        bits.put(a if a > 0 else a - 1 + (1 << s), s)
                        run = 0
                    if run:
                        bits.put(*ac[0])
    segments.append(bits.flush())
    qt = [bytes(q.astype(np.uint8)) for q in qt]
    dht = [b"\xff\xc4" + struct.pack(">H", 19 + len(t[1])) + bytes([k])
           + t[0] + t[1] for k, t in sorted(_HUFFMAN.items())
           if k & 15 < min(n, 2)]
    return dict(
        dqt=[b"\xff\xdb\x00\x43" + bytes([t]) + qt[t]
             for t in sorted(set(tq))],
        dht=dht, qt=qt, tq=tq,
        dc=[_HUFFMAN[t] for t in range(min(n, 2))],
        ac=[_HUFFMAN[0x10 | t] for t in range(min(n, 2))],
        dri=b"\xff\xdd\x00\x04" + struct.pack(">H", restart) if restart
        else b"",
        sof=b"\xff\xc0" + struct.pack(">HBHHB", 8 + 3 * n, 8, h, w, n)
        + b"".join(bytes([c + 1, sampling[c][0] << 4 | sampling[c][1],
                          tq[c]]) for c in range(n)),
        sos=b"\xff\xda" + struct.pack(">HB", 6 + 2 * n, n) + b"".join(
            bytes([c + 1, 0x11 * min(c, 1)]) for c in range(n))
        + b"\x00\x3f\x00",
        segments=segments)


def jfif(parts, app=True) -> tuple[bytes, bytes]:
    """The stream's header (SOI to SOS) and its data (the segments joined
    by RSTn markers, then EOI)."""
    head = b"\xff\xd8" + (b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01"
                          b"\x00\x01\x00\x00" if app else b"")
    head += b"".join(parts["dqt"] + parts["dht"]) + parts["dri"] + \
        parts["sof"] + parts["sos"]
    data = b""
    for k, s in enumerate(parts["segments"]):
        data += (bytes([0xFF, 0xD0 + (k - 1) % 8]) if k else b"") + s
    return head, data + b"\xff\xd9"


# ---------------------------------------------------------------------------
# old-style JPEG TIFFs

_PACK = {3: "H", 4: "I", 5: "I", 7: "B"}


def tiff_bytes(tags, payload, bo="<") -> bytes:
    """A classic TIFF of one directory: ``tags`` {tag: (type, values, or
    a function of the payload's offsets)} (rationals as pairs), then
    ``payload``'s blobs, each at an offset that the functions get."""
    def values(typ, v):
        return [x for p in v for x in p] if typ == 5 else list(v)

    def size(tag):
        typ, v = tags[tag]
        v = v(None) if callable(v) else v
        return struct.calcsize(_PACK[typ]) * len(values(typ, v))

    order = sorted(tags)
    at = 8 + 2 + 12 * len(order) + 4
    at += sum(size(t) + size(t) % 2 for t in order if size(t) > 4)
    offsets = []
    for p in payload:
        offsets.append(at)
        at += len(p) + len(p) % 2
    entries, extra = [], b""
    where = 8 + 2 + 12 * len(order) + 4
    for t in order:
        typ, v = tags[t]
        v = v(offsets) if callable(v) else v
        raw = bytes(v) if typ == 7 else struct.pack(
            f"{bo}{len(values(typ, v))}{_PACK[typ]}", *values(typ, v))
        head = struct.pack(bo + "HHI", t, typ, len(v))
        if len(raw) > 4:
            entries.append(head + struct.pack(bo + "I", where + len(extra)))
            extra += raw + bytes(len(raw) % 2)
        else:
            entries.append(head + raw + bytes(4 - len(raw)))
    return ((b"II*\x00" if bo == "<" else b"MM\x00*")
            + struct.pack(bo + "IH", 8, len(order)) + b"".join(entries)
            + bytes(4) + extra + b"".join(p + bytes(len(p) % 2)
                                          for p in payload))


def _ycbcr(h, w, seed=0):
    """(h, w) gray and (h, w, 3) YCbCr crops of the zoom2x and tilt4
    views (PIL's RGB to YCbCr of a colour mix of them)."""
    g = _zoom(1)[100 + seed:100 + seed + h, 10 * seed:10 * seed + w]
    b = np.asarray(Image.open(chip_smoke.PAIRS / "tilt4_1.png"))[:h, :w]
    rgb = np.stack([g, b, 255 - g // 2], -1)
    return g, np.asarray(Image.fromarray(rgb).convert("YCbCr"))


def ojpeg_tiff(samples, sub=(2, 2), form="interchange", rows_per_strip=None,
               tile=None, photometric=6, bo="<", quality=75, restart=0,
               subsampling_tag=True, sof_sampling=None, whole=False,
               app=True, tags=None):
    """An old-style JPEG TIFF of (h, w[, 3]) uint8 Y[, Cb, Cr] samples:
    Y sampled ``sub`` (h, v), Cb and Cr 1x1 (or ``sof_sampling``); one
    stream of the strips (tiles stacked below each other, as libtiff
    reads them), a restart interval each, or ``restart`` in one strip.
    ``form`` "interchange": JPEGInterchangeFormat(Length) at the header
    and the strips or tiles at the segments, or with ``whole`` at the
    whole stream (``whole`` None: no tag 513, the one strip holds the
    whole stream); "tables": tags 512 and 519-521 (515 for ``restart``).
    Photometric, YCbCrSubsampling (``subsampling_tag``: True for ``sub``,
    False for none, or a pair) and ``tags`` (a value None drops the tag)
    as given."""
    samples = samples[..., None] if samples.ndim == 2 else samples
    h, w, n = samples.shape
    sampling = sof_sampling or ([sub] + [(1, 1)] * (n - 1) if n > 1
                                else [(1, 1)])
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * n), 259: (3, [6]),
         277: (3, [n])}
    if tile:
        th, tw = tile
        pad = np.pad(samples, ((0, -h % th), (0, -w % tw), (0, 0)),
                     mode="edge")
        samples = np.concatenate([pad[y:y + th, x:x + tw]
                                  for y in range(0, pad.shape[0], th)
                                  for x in range(0, pad.shape[1], tw)])
        rps, count = th, (pad.shape[0] // th) * (pad.shape[1] // tw)
        t[322], t[323] = (4, [tw]), (4, [th])
    else:
        rps = rows_per_strip or h
        count = -(-h // rps)
        t[278] = (4, [rps])
    sw = samples.shape[1]
    aligned = rps % (8 * vmax) == 0
    if count > 1 and aligned:
        restart = -(-sw // (8 * hmax)) * (rps // (8 * vmax))
    parts = baseline_jpeg(samples, sampling, quality, restart)
    head, data = jfif(parts, app)
    if count == 1:
        segments = [data[:-2]]
    elif aligned:
        segments = parts["segments"]
    else:                    # libtiff refuses such strips: any cut will do
        d = parts["segments"][0]
        segments = [d[k * len(d) // count:(k + 1) * len(d) // count]
                    for k in range(count)]
    if photometric is not None:
        t[262] = (3, [photometric])
    if subsampling_tag is True and n == 3:
        t[530] = (3, list(sub))
    elif subsampling_tag and subsampling_tag is not True:
        t[530] = (3, list(subsampling_tag))
    offsets_tag, counts_tag = (324, 325) if tile else (273, 279)
    if form == "tables":
        blobs = parts["qt"] + [bytes(c) + bytes(s) for c, s in
                               parts["dc"] + parts["ac"]]
        nq, nd = len(parts["qt"]), len(parts["dc"])
        payload = blobs + segments
        t[512] = (3, [1])
        t[519] = (4, lambda o: [o[parts["tq"][c]] if o else 0
                                for c in range(n)])
        t[520] = (4, lambda o: [o[nq + min(c, 1)] if o else 0
                                for c in range(n)])
        t[521] = (4, lambda o: [o[nq + nd + min(c, 1)] if o else 0
                                for c in range(n)])
        if restart and count == 1:
            t[515] = (3, [restart])
        first = len(blobs)
        t[offsets_tag] = (4, lambda o: o[first:] if o else [0] * count)
        t[counts_tag] = (4, [len(s) for s in segments])
    elif whole is None:
        payload = [head + data]
        t[offsets_tag] = (4, lambda o: o or [0])
        t[counts_tag] = (4, [len(head + data)])
    else:
        payload = [head + data] if whole else [head] + segments
        t[513] = (4, lambda o: o[:1] if o else [0])
        t[514] = (4, [len(payload[0])])
        if whole:
            at = [len(head)]
            for s in segments[:-1]:
                at.append(at[-1] + len(s) + 2)
            t[offsets_tag] = (4, lambda o: [o[0] + a for a in at] if o
                              else at)
        else:
            t[offsets_tag] = (4, lambda o: o[1:] if o else [0] * count)
        t[counts_tag] = (4, [len(s) for s in segments])
    t.update(tags or {})
    return tiff_bytes({k: v for k, v in t.items() if v is not None},
                      payload, bo)


def pil_ojpeg_tiff(rgb, quality=75, subsampling=2, rows_per_strip=None,
                   progressive=False, bo="<") -> bytes:
    """PIL's own JPEG stream of (h, w[, 3]) ``rgb`` in the interchange
    form: JPEGInterchangeFormat at its header, a strip at each restart
    interval (``restart_marker_rows`` MCU rows, ``rows_per_strip`` pixel
    rows)."""
    h, w = rgb.shape[:2]
    n = 1 if rgb.ndim == 2 else 3
    mcu = 16 if n == 3 and subsampling == 2 else 8       # its height
    f = io.BytesIO()
    kw = dict(restart_marker_rows=rows_per_strip // mcu) \
        if rows_per_strip else {}
    if n == 3:
        kw["subsampling"] = subsampling
    Image.fromarray(rgb).save(f, "JPEG", quality=quality,
                              progressive=progressive, **kw)
    d = f.getvalue()
    sos = d.rindex(b"\xff\xda") if progressive else d.index(b"\xff\xda")
    end = sos + 2 + int.from_bytes(d[sos + 2:sos + 4], "big")
    segments, rst = [], end
    while True:
        nxt = min((d.find(bytes([0xFF, m]), rst) for m in range(0xD0, 0xD8)
                   if d.find(bytes([0xFF, m]), rst) >= 0), default=-1)
        if nxt < 0 or progressive:
            segments.append((rst, len(d) - 2))
            break
        segments.append((rst, nxt))
        rst = nxt + 2
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * n), 259: (3, [6]),
         262: (3, [6 if n == 3 else 1]), 277: (3, [n]),
         278: (4, [rows_per_strip or h]),
         513: (4, lambda o: o or [0]), 514: (4, [end]),
         273: (4, lambda o: [o[0] + a for a, _ in segments] if o
               else [0] * len(segments)),
         279: (4, [b - a for a, b in segments])}
    return tiff_bytes(t, [d], bo)


def hold(tmp_path, data: bytes, name="x.tif"):
    """The port reads ``data`` as PIL does, or, where PIL fails, refuses
    it with a ValueError that names old-style JPEG and holds a listed
    reason; returns PIL's array, or None."""
    p = tmp_path / name
    p.write_bytes(data)
    want = pil_read(data)
    if isinstance(want, Exception):
        with pytest.raises(ValueError) as e:
            _read(p)
        assert any(r in str(e.value) for r in tiff.REFUSALS), e.value
        assert "old-style JPEG" in str(e.value), e.value
        return None
    arr, mode, size = want
    got, got_mode = _read(p)
    assert got.dtype == arr.dtype and got.shape == arr.shape, (
        got.dtype, got.shape, arr.dtype, arr.shape)
    np.testing.assert_array_equal(got, arr)
    assert got_mode == mode
    assert image_size(p) == size
    return arr


SAMPLINGS = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2)]
LAYOUTS = {"strip": {}, "strips_16": dict(rows_per_strip=16),
           "strips_32": dict(rows_per_strip=32),
           "tiles_16x64": dict(tile=(16, 64)),
           "tiles_32x32": dict(tile=(32, 32))}


@pytest.mark.parametrize("bo", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("sub", SAMPLINGS, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("form", ["interchange", "tables"])
def test_ycbcr(tmp_path, form, sub, layout, bo):
    """YCbCr at 4:4:4, 4:2:2, 1x2, 4:2:0, 4:1:1 and 4x2, 37x53: one strip,
    strips of 16 and 32 rows (a short last one; strips that are not whole
    MCU rows, which libtiff refuses), tiles of one and of several
    columns, both forms, both byte orders (libtiff skips a strip more in
    a file of the other byte order, whose BitsPerSample tag drops
    OJPEGPostDecode).  PIL reads them through libtiff's RGBA interface:
    the raw, not upsampled, samples in its sampling blocks."""
    _, ycc = _ycbcr(37, 53)
    hold(tmp_path, ojpeg_tiff(ycc, sub, form, bo=bo, **LAYOUTS[layout]))


@pytest.mark.parametrize("bo", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("form", ["interchange", "tables"])
@pytest.mark.parametrize("photometric", [0, 1])
def test_gray(tmp_path, photometric, form, layout, bo):
    """One component (photometric 0 or 1, PIL's "L" of the decoded
    samples as they are): libtiff's scanlines; past the stream's end PIL's
    strip buffer keeps the last strip's rows."""
    g, _ = _ycbcr(37, 53)
    hold(tmp_path, ojpeg_tiff(g, (1, 1), form, photometric=photometric,
                              bo=bo, **LAYOUTS[layout]))


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (17, 33), (64, 64)])
def test_sizes(tmp_path, size):
    """Sizes of less than one MCU, and of whole MCUs."""
    g, ycc = _ycbcr(*size)
    for sub in SAMPLINGS:
        hold(tmp_path, ojpeg_tiff(ycc, sub))
        hold(tmp_path, ojpeg_tiff(ycc, sub, "tables", bo=">"))
    hold(tmp_path, ojpeg_tiff(g, (1, 1), photometric=1))


@pytest.mark.parametrize("restart", [1, 2, 5])
@pytest.mark.parametrize("form", ["interchange", "tables"])
def test_restart_interval(tmp_path, form, restart):
    """A restart interval in one strip (the stream's DRI, or tag 515 in
    the tables form); a restart marker missing or out of turn, where
    libtiff's resync_to_restart fails: PIL keeps the rows of whole MCUs
    before it in YCbCr (OJPEGDecodeRaw writes no more) and fails on one
    component."""
    g, ycc = _ycbcr(37, 53)
    for bo in "<>":
        for sub in ((2, 2), (1, 1)):
            data = ojpeg_tiff(ycc, sub, form, restart=restart, bo=bo)
            assert hold(tmp_path, data) is not None
            at = data.index(b"\xff\xd0")
            for marker in (b"\x00\x00", b"\xff\xd3"):
                hold(tmp_path, data[:at] + marker + data[at + 2:])
        data = ojpeg_tiff(g, (1, 1), form, restart=restart, photometric=1,
                          bo=bo)
        assert hold(tmp_path, data) is not None
        at = data.index(b"\xff\xd0")
        assert hold(tmp_path, data[:at] + b"\xff\xd3" + data[at + 2:]) \
            is None


@pytest.mark.parametrize("sub", SAMPLINGS, ids=lambda s: f"{s[0]}x{s[1]}")
def test_subsampling_tag(tmp_path, sub):
    """YCbCrSubsampling absent (2x2 by default) or disagreeing with the
    frame: OJPEGSubsamplingCorrect takes the frame's factors, in one
    strip and in strips; in the tables form, which has no frame, the
    default is the stream's."""
    _, ycc = _ycbcr(37, 53)
    for bo in "<>":
        for tag in (False, (2, 1), (1, 1)):
            hold(tmp_path, ojpeg_tiff(ycc, sub, subsampling_tag=tag, bo=bo))
            hold(tmp_path, ojpeg_tiff(ycc, sub, subsampling_tag=tag,
                                      rows_per_strip=32, bo=bo))
    hold(tmp_path, ojpeg_tiff(ycc, (2, 2), "tables", subsampling_tag=False))
    # the tables form's frame is the tag's: entropy data coded for the
    # other samplings decodes to huge coefficients, whose pixels are those
    # of libjpeg-turbo's 16-bit SIMD inverse DCT
    for bo in "<>":
        for tag in SAMPLINGS:
            hold(tmp_path, ojpeg_tiff(ycc, sub, "tables", subsampling_tag=tag,
                                      bo=bo))


@pytest.mark.parametrize("case", [
    "whole", "whole_strips", "strip_holds_stream", "no_length", "no_app",
    "photometric_rgb", "no_photometric", "no_samples", "jpeg_proc_14",
    "coefficients", "short_length", "planar_2", "planar_2_tables"])
def test_interchange_variants(tmp_path, case):
    """JPEGInterchangeFormat at the whole stream (a strip, or the strips
    at its restart intervals, inside it), a strip that holds the whole
    stream with no tag 513, no JPEGInterchangeFormatLength or a short
    one, no APP0; photometric RGB or none (YCbCr to libtiff and PIL),
    SamplesPerPixel absent (3), JPEGProc 14 (which libtiff does not
    read), YCbCrCoefficients and ReferenceBlackWhite; PlanarConfiguration
    2 over the one strip, in either form, which TIFFReadDirectory reads
    as 1 (its "OJPEG hack": one strip offset and one byte count)."""
    _, ycc = _ycbcr(37, 53)
    kw = {"whole": dict(whole=True),
          "whole_strips": dict(whole=True, rows_per_strip=16),
          "strip_holds_stream": dict(whole=None),
          "no_length": dict(tags={514: None}),
          "short_length": dict(tags={514: (4, [40])}),
          "no_app": dict(app=False),
          "photometric_rgb": dict(photometric=2),
          "no_photometric": dict(photometric=None),
          "no_samples": dict(tags={277: None}),
          "planar_2": dict(tags={284: (3, [2])}),
          "planar_2_tables": dict(form="tables", tags={284: (3, [2])}),
          "jpeg_proc_14": dict(form="tables", tags={512: (3, [14])}),
          "coefficients": dict(tags={
              529: (5, [(299, 1000), (587, 1000), (114, 1000)]),
              532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1),
                        (240, 1)])})}[case]
    for bo in "<>":
        hold(tmp_path, ojpeg_tiff(ycc, (2, 2), bo=bo, **kw))


@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
@pytest.mark.parametrize("rows_per_strip", [None, 16, 32])
def test_pil_streams(tmp_path, subsampling, rows_per_strip):
    """PIL's own JPEG streams (quality 90, restart markers every strip's
    MCU rows), RGB and gray, both byte orders."""
    g, ycc = _ycbcr(37, 53)
    rgb = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))
    for bo in "<>":
        assert hold(tmp_path, pil_ojpeg_tiff(
            rgb, 90, subsampling, rows_per_strip, bo=bo)) is not None
        assert hold(tmp_path, pil_ojpeg_tiff(
            g, 90, rows_per_strip=rows_per_strip, bo=bo)) is not None


REFUSED = {
    "progressive": lambda g, c: pil_ojpeg_tiff(
        np.asarray(Image.fromarray(c, "YCbCr").convert("RGB")),
        progressive=True),
    "no_qtables": lambda g, c: ojpeg_tiff(c, form="tables",
                                          tags={519: None}),
    "no_dctables": lambda g, c: ojpeg_tiff(c, form="tables",
                                           tags={520: None}),
    "no_actables": lambda g, c: ojpeg_tiff(c, form="tables",
                                           tags={521: None}),
    "deflate_data": lambda g, c: tiff_file(g, compression=8,
                                           tags={259: (3, [6])}),
    "strips_of_8_rows_420": lambda g, c: ojpeg_tiff(c, rows_per_strip=8),
    "strips_of_12_rows_gray": lambda g, c: ojpeg_tiff(
        g, (1, 1), photometric=1, rows_per_strip=12),
    "ycbcr_of_one_sample": lambda g, c: ojpeg_tiff(g, (1, 1)),
    "gray_of_three_samples": lambda g, c: ojpeg_tiff(c, (1, 1),
                                                     photometric=1),
    "cmyk_of_three_samples": lambda g, c: ojpeg_tiff(c, (1, 1),
                                                     photometric=5),
    "gray_without_samples_tag": lambda g, c: ojpeg_tiff(
        g, (1, 1), photometric=1, tags={277: None}),
    "chroma_subsampled": lambda g, c: ojpeg_tiff(
        c, sof_sampling=[(2, 2), (1, 1), (2, 2)]),
    "all_2x2": lambda g, c: ojpeg_tiff(
        c, sof_sampling=[(2, 2), (2, 2), (2, 2)]),
    "gray_subsampled": lambda g, c: ojpeg_tiff(
        g, photometric=1, sof_sampling=[(2, 2)]),
    "frame_too_narrow": lambda g, c: ojpeg_tiff(c, tags={256: (4, [60])}),
    "planar_2_strips": lambda g, c: ojpeg_tiff(c, rows_per_strip=32,
                                               tags={284: (3, [2])}),
    "planar_2_tiles": lambda g, c: ojpeg_tiff(c, tile=(32, 32),
                                              tags={284: (3, [2])}),
    "planar_2_without_byte_counts": lambda g, c: ojpeg_tiff(
        c, tags={284: (3, [2]), 279: None}),
    "planar_2_tables_tiles": lambda g, c: ojpeg_tiff(
        c, (1, 1), "tables", tile=(16, 64), tags={284: (3, [2])}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals(tmp_path, case):
    """Files that PIL fails on: a progressive frame (OJPEGReadHeaderInfoSec
    takes SOF0, SOF1 and SOF3 only), the tables form without a table
    (libtiff: missing JPEG tables), Deflate data, strips that are not
    whole MCU rows, YCbCr of one sample, one component for 3 samples and
    3 samples of another photometric interpretation, a frame of other
    sampling factors than libtiff's (chroma subsampled too: libtiff
    desubsamples in libjpeg and then finds the largest factors not 1),
    a frame narrower than the image, planar configuration 2 over several
    strips or tiles or without StripByteCounts (libtiff then reads each
    plane as a stream of its own: the stream's SOS of three components
    is corrupt for it, or a plane's strips are missing).  Each raises a
    ValueError that names old-style JPEG and holds a listed reason."""
    g, ycc = _ycbcr(37, 53)
    data = REFUSED[case](g, ycc)
    assert isinstance(pil_read(data), Exception)
    assert hold(tmp_path, data) is None


def test_planar_2_tables_strips_misread(tmp_path):
    """The tables form in planar configuration 2 over two strips: libtiff
    decodes the first plane's strips (the whole interleaved stream) as a
    stream of Y alone and the missing planes' as nothing, and PIL gives
    pixels that are not the image's; the port refuses it as a file PIL
    misreads."""
    g, ycc = _ycbcr(37, 53)
    data = ojpeg_tiff(ycc, (1, 1), "tables", rows_per_strip=32,
                      tags={284: (3, [2])})
    arr, _, _ = pil_read(data)
    rgb = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))
    assert np.abs(arr.astype(int) - rgb).mean() > 40
    p = tmp_path / "x.tif"
    p.write_bytes(data)
    with pytest.raises(ValueError, match="old-style JPEG in planar "
                       "configuration 2.*PIL misreads it"):
        _read(p)


def test_read_formerly_refused(tmp_path):
    """Compression 6 is read now (it was refused by name before): 4:2:0
    YCbCr in strips of 16 rows gives PIL's RGB, within JPEG's loss of
    the view."""
    g, ycc = _ycbcr(37, 53)
    assert 6 in tiff.READ_COMPRESSIONS
    assert 6 not in tiff._COMPRESSION_NAMES
    rgb = np.asarray(Image.fromarray(ycc, "YCbCr").convert("RGB"))
    got = hold(tmp_path, ojpeg_tiff(ycc, (2, 2), rows_per_strip=16))
    assert got.shape == (37, 53, 3)
    assert np.abs(got.astype(int) - rgb).mean() < 12


# ---------------------------------------------------------------------------
# SGILog and AVIF

@pytest.mark.parametrize("photometric", [32844, 32845, 1, 2])
@pytest.mark.parametrize("compression", [34676, 34677])
def test_sgilog_refused(tmp_path, compression, photometric):
    """SGILog is never read: with photometric LogL or LogLuv PIL has no
    mode (it does not open the file); with any other libtiff's
    LogLuvSetupDecode fails (PIL refuses it).  Neither is "not
    supported"."""
    g = (np.arange(63).reshape(7, 9) * 4).astype(np.uint8)
    a = np.stack([g] * 3, -1) if photometric in (2, 32845) else g
    for bits in (8, 16):
        data = tiff_file(a.astype(np.uint16) if bits == 16 else a,
                         photometric=2 if a.ndim == 3 else 1,
                         compression=8, bits=bits,
                         tags={259: (3, [compression]),
                               262: (3, [photometric])})
        assert isinstance(pil_read(data), Exception)
        p = tmp_path / "x.tif"
        p.write_bytes(data)
        with pytest.raises(ValueError) as e:
            _read(p)
        phrase = "PIL does not open it" if photometric > 32000 else \
            "PIL refuses it"
        assert phrase in str(e.value), e.value
        assert "SGILog" in str(e.value) and "is not supported" not in \
            str(e.value), e.value


def test_avif_refused_by_name(tmp_path):
    """An AVIF that PIL writes (ftyp, major brand "avif") and reads
    back: the port refuses it by name, in ``read_image`` and in
    ``image_size``; the other brands of AvifImagePlugin._accept too."""
    p = tmp_path / "x.avif"
    Image.new("RGB", (16, 16), (10, 200, 30)).save(p)
    data = p.read_bytes()
    assert data[4:12] == b"ftypavif"
    assert Image.open(p).mode == "RGB" and np.asarray(
        Image.open(p)).shape == (16, 16, 3)
    for brand in (b"avif", b"avis", b"mif1", b"msf1"):
        p.write_bytes(data[:8] + brand + data[12:])
        for fn in (_read, image_size):
            with pytest.raises(ValueError,
                               match="AVIF images are not supported"):
                fn(p)


# ---------------------------------------------------------------------------
# the fixtures and the JAX figures of chip_smoke.py phase 14r-14s

def tiff_ojpeg_pair(i: int) -> bytes:
    """Phase 14s's file: zoom2x view ``i`` as an old-style JPEG TIFF (its
    gray in R, G and B), PIL's 4:2:0 stream at quality 75, strips of 64
    rows at its restart intervals."""
    return pil_ojpeg_tiff(np.stack([_zoom(i)] * 3, -1), 75, 2, 64)


def write_fixtures(d) -> None:
    """Phase 14r's fixtures (crops of the zoom2x and tilt4 views) and
    14s's pair."""
    os.makedirs(d, exist_ok=True)
    g, ycc = _ycbcr(96, 128, 1)
    files = {
        "ojpeg_420_strips.tif": ojpeg_tiff(ycc, (2, 2), rows_per_strip=32),
        "ojpeg_422_tables_mm.tif": ojpeg_tiff(ycc, (2, 1), "tables",
                                              rows_per_strip=16, bo=">"),
        "ojpeg_411_tiles.tif": ojpeg_tiff(ycc, (4, 1), tile=(32, 64)),
        "ojpeg_444_restart.tif": ojpeg_tiff(ycc, (1, 1), "tables",
                                            restart=7),
        "ojpeg_gray_whole.tif": ojpeg_tiff(g, (1, 1), photometric=1,
                                           whole=True, rows_per_strip=16),
        "zoom2x_1_ojpeg.tif": tiff_ojpeg_pair(1),
        "zoom2x_2_ojpeg.tif": tiff_ojpeg_pair(2),
    }
    for name, data in files.items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)


def test_ojpeg_fixtures_are_written_here():
    """The committed fixtures of phase 14r-14s are ``write_fixtures``'s
    bytes, PIL reads each, and each of 14r's has PIL's shape, mode and
    hash in ``chip_smoke.FORMAT_FIXTURE_SHA256`` (30 KB a crop, 100 KB a
    file of the pair)."""
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        write_fixtures(d)
        names = sorted(os.listdir(d))
        for name in names:
            mine = open(os.path.join(d, name), "rb").read()
            assert (chip_smoke.IMAGE_FIXTURES / name).read_bytes() == mine
            assert len(mine) < (100_000 if name.startswith("zoom2x")
                                else 30_000), (name, len(mine))
    assert set(names) == set(chip_smoke.TIFF_OJPEG_FIXTURES +
                             chip_smoke.TIFF_OJPEG_PAIR)
    for name in chip_smoke.TIFF_OJPEG_FIXTURES + chip_smoke.TIFF_OJPEG_PAIR:
        im = Image.open(chip_smoke.IMAGE_FIXTURES / name)
        a = np.asarray(im)
        got = (a.shape, im.mode, hashlib.sha256(a.tobytes()).hexdigest())
        assert chip_smoke.FORMAT_FIXTURE_SHA256[name] == got, name


def test_cli_match_against_jax(tmp_path, capsys):
    """``cli match`` (LORANSACH, the CVIU-shaped INI files, as phase 14s
    runs it) on zoom2x's pair as 14s's old-style JPEG TIFFs, against
    ``mods_tpu.cli.cmd_match`` on the same files: ``test_torch_cli.py``'s
    rule (the same steps, the verified count within 20 %) and the
    tentatives within 20 %, as 14s holds the card."""
    from mods_tpu import cli as jcli
    from mods_tpu_torch import cli as tcli
    from test_torch_cli import load_jax_native
    load_jax_native()
    imgs = [str(chip_smoke.IMAGE_FIXTURES / n)
            for n in chip_smoke.TIFF_OJPEG_PAIR]
    (tmp_path / "iters.ini").write_text(chip_smoke.cviu_iters_ini())
    (tmp_path / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
    H = np.loadtxt(chip_smoke.PAIRS / "zoom2x_H.txt")
    figures = {}
    for tag, run in (("jax", jcli.cmd_match),
                     ("torch", lambda a: tcli.main(
                         ["match"] + a + ["--device", "cpu"]))):
        m = tmp_path / f"m_{tag}.txt"
        assert run(imgs + ["0", "0", "k1", "k2", str(m), "0", "LORANSACH",
                           str(tmp_path / "config.ini"),
                           str(tmp_path / "iters.ini")]) == 0
        figures[tag] = chip_smoke.match_figures(
            capsys.readouterr().out, str(m), H, 598, 1000)
    j, t = figures["jax"], figures["torch"]
    assert t["steps"] == j["steps"]
    assert t["matches"] >= 10 and abs(t["matches"] - j["matches"]) \
        <= 0.2 * j["matches"], (t, j)
    assert abs(t["tentatives"] - j["tentatives"]) <= 0.2 * j["tentatives"]
    ref = chip_smoke.JAX_TIFF_OJPEG_REFERENCE
    assert (j["steps"], j["tentatives"], j["matches"]) == (
        ref["steps"], ref["tentatives"], ref["matches"])


if __name__ == "__main__":
    if sys.argv[1:] == ["--fixtures"]:
        write_fixtures(chip_smoke.IMAGE_FIXTURES)
    elif sys.argv[1:] == ["--jax-tiff-ojpeg"]:
        _jax_tiff_jpeg_main("ojpeg")
