"""Port vs PIL on every TIFF that the JAX commands read through PIL
(``np.asarray(Image.open(path))``, Pillow 12.1.0 with libtiff 4.7.1):
every key of ``TiffImagePlugin.OPEN_INFO`` in both byte orders, every
compression of ``COMPRESSION_INFO`` that the port reads (none, CCITT
modified Huffman, Group 3 and Group 4, tiff_raw_16 (CCITT RLEW), LZW in
both bit orders, JPEG, both Deflates, PackBits, LZMA, ThunderScan;
Zstandard in ``test_torch_zstd.py``), fill order 2, predictors 2 and 3,
YCbCr through libtiff's RGBA interface, strips, tiles, planar
configuration 2, BigTIFF and the Orientation tag (CPU).

Tolerance: none.  Every path is integer or lossless (JPEG is decoded as
libjpeg-turbo decodes it), so ``io/image.py::_read`` must give PIL's
array (dtype, shape, every value) and mode, and ``image_size`` PIL's
size; each case that PIL refuses or misreads, and each compression that
the port does not read, raises a ``ValueError`` that names it and holds
one of ``io/tiff.py::REFUSALS``.

Files are PIL's where PIL (libtiff) writes them (CCITT, JPEG, LZW,
Deflate, LZMA at full size) and written here otherwise (``tiff_file``:
any key, compression, predictor, fill order, tiling, planar
configuration and BigTIFF), PIL's reading of the same bytes being the
reference.

``python tests/test_torch_tiff_variants.py --fixtures`` writes
``chip_smoke.py`` phase 14n-14q's fixtures into ``tests/data/image_io``;
``JAX_PLATFORMS=cpu python tests/test_torch_tiff_variants.py
--jax-tiff-jpeg`` (``--jax-tiff-zstd``) prints the JAX command's figures
on phase 14o's (14q's) pair (``chip_smoke.JAX_TIFF_JPEG_REFERENCE``,
``JAX_TIFF_ZSTD_REFERENCE``).
"""

import io
import lzma
import os
import struct
import sys
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytest  # noqa: E402
from PIL import Image, TiffImagePlugin  # noqa: E402

import chip_smoke  # noqa: E402
from mods_tpu_torch.io import tiff  # noqa: E402
from mods_tpu_torch.io.image import _read, image_size, read_image  # noqa

def _zoom(i=1):
    return np.asarray(Image.open(os.path.join(REPO, ".parity_work",
                                              f"zoom2x_{i}.png")))


# ---------------------------------------------------------------------------
# a TIFF writer for any key

_CODES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 7: "B", 11: "f",
          16: "Q"}


def _value(bo, typ, vals):
    if isinstance(vals, (bytes, bytearray)):
        return bytes(vals)
    if typ == 5:
        vals = [v for pair in vals for v in pair]
    return struct.pack(f"{bo}{len(vals)}{_CODES[typ]}", *vals)


def assemble(tags, chunks, bo="<", big=False, tiles=False):
    """A TIFF (BigTIFF where ``big``) of one directory: ``tags`` {tag:
    (type, values or bytes)} and the strips or tiles ``chunks``, whose
    offsets and byte counts are filled in (LONG, or LONG8 in BigTIFF)."""
    tags = dict(tags)
    offsets_tag, counts_tag = (324, 325) if tiles else (273, 279)
    ot = 16 if big else 4
    tags[offsets_tag] = (ot, [0] * len(chunks))
    tags[counts_tag] = (ot, [len(c) for c in chunks])
    order = sorted(tags)
    inline, entry = (8, 20) if big else (4, 12)
    head = 16 if big else 8
    start = head + (8 if big else 2) + entry * len(order) + (8 if big else 4)

    def layout():
        where, pos = {}, start
        for k in order:
            v = _value(bo, *tags[k])
            if len(v) > inline:
                where[k] = pos
                pos += len(v) + len(v) % 2
        return where, pos

    at = layout()[1]
    offs = []
    for c in chunks:
        offs.append(at)
        at += len(c) + len(c) % 2
    tags[offsets_tag] = (ot, offs)
    where = layout()[0]
    ifd, extras = [], b""
    for k in order:
        typ, vals = tags[k]
        v = _value(bo, typ, vals)
        n = len(vals)
        if len(v) > inline:
            extras += v + bytes(len(v) % 2)
            ptr = struct.pack(bo + ("Q" if big else "I"), where[k])
        else:
            ptr = v + bytes(inline - len(v))
        ifd.append(struct.pack(bo + ("HHQ" if big else "HHI"), k, typ, n)
                   + ptr)
    if big:
        first = (b"II+\x00" if bo == "<" else b"MM\x00+") + struct.pack(
            bo + "HHQ", 8, 0, 16) + struct.pack(bo + "Q", len(order))
        tail = bytes(8)
    else:
        first = (b"II*\x00" if bo == "<" else b"MM\x00*") + struct.pack(
            bo + "IH", 8, len(order))
        tail = bytes(4)
    return first + b"".join(ifd) + tail + extras + b"".join(
        c + bytes(len(c) % 2) for c in chunks)


def pack_rows(block, bits, bo):
    """(h, w, s) samples -> bytes, each row padded to a byte: 8-, 16-,
    32- and 64-bit samples in byte order ``bo``, others MSB first."""
    h, w, s = block.shape
    if bits in (8, 16, 32, 64):
        kind = "f" if block.dtype.kind == "f" else (
            "i" if block.dtype.kind == "i" else "u")
        return np.ascontiguousarray(block.astype(
            np.dtype(f"{bo}{kind}{bits // 8}"))).tobytes()
    v = block.reshape(h, w * s).astype(np.uint64)
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint64)
    b = ((v[:, :, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    return np.packbits(b.reshape(h, -1), axis=1).tobytes()


_REV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def reverse_bits(b: bytes) -> bytes:
    return _REV[np.frombuffer(b, np.uint8)].tobytes()


def packbits(raw: bytes) -> bytes:
    out, i = bytearray(), 0
    while i < len(raw):
        j = i
        while j < len(raw) and j - i < 128 and raw[j] == raw[i]:
            j += 1
        if j - i >= 3:
            out += bytes([257 - (j - i), raw[i]])
            i = j
            continue
        j = i
        while j < len(raw) and j - i < 128 and not (
                j + 2 < len(raw) and raw[j] == raw[j + 1] == raw[j + 2]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + raw[i:j]
        i = j
    return bytes(out)


def lzw(raw: bytes, old=False) -> bytes:
    """TIFF LZW: codes MSB first, widened one code early (libtiff's
    encoder), or LSB first and widened late (the old form)."""
    codes, widths = [256], [9]
    table = {bytes([i]): i for i in range(256)}
    nxt, width, w = 258, 9, b""
    for c in raw:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        codes.append(table[w])
        widths.append(width)
        table[wc] = nxt
        nxt += 1
        if (nxt >= 1 << width) if not old else (nxt > 1 << width):
            width += 1
        if nxt >= 4093:
            codes.append(256)
            widths.append(width)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        w = bytes([c])
    if w:
        codes.append(table[w])
        widths.append(width)
    codes.append(257)
    widths.append(width)
    bits = "".join(format(c, f"0{n}b")[::-1] if old else format(c, f"0{n}b")
                   for c, n in zip(codes, widths))
    bits += "0" * (-len(bits) % 8)
    out = bytes(int(bits[i:i + 8][::-1] if old else bits[i:i + 8], 2)
                for i in range(0, len(bits), 8))
    return out


def _float_planes(raw: bytes, rows: int, bps: int, stride: int) -> bytes:
    """libtiff's fpDiff on little-endian samples: each row's samples as
    big-endian byte planes, then byte differences ``stride`` apart."""
    out = []
    a = np.frombuffer(raw, np.uint8).reshape(rows, -1)
    for row in a:
        s = row.reshape(-1, bps)[:, ::-1]         # each sample big-endian
        planes = s.T.reshape(-1)                  # byte plane by plane
        p = planes.astype(np.int16)
        d = p.copy()
        d[stride:] = p[stride:] - p[:-stride]
        out.append((d & 0xFF).astype(np.uint8).tobytes())
    return b"".join(out)


def encode(raw: bytes, compression, rows=1, bps=4, stride=1,
           predictor=1, zstd_level=3) -> bytes:
    if predictor == 3:
        raw = _float_planes(raw, rows, bps, stride)
    if compression in (8, 32946):
        return zlib.compress(raw)
    if compression == 50000:
        from test_torch_zstd import zstd_compress
        return zstd_compress(raw, zstd_level)
    if compression == 5:
        return lzw(raw)
    if compression == "5old":
        return lzw(raw, old=True)
    if compression == 32773:
        return packbits(raw)
    if compression == 34925:
        return lzma.compress(raw)
    return raw


def _predict2(block: np.ndarray, bits: int) -> np.ndarray:
    """Horizontal differences of (h, w, s) samples along a row, each
    channel against its own previous pixel (wrapping)."""
    u = block.view(f"u{block.dtype.itemsize}") if block.dtype.kind in "if" \
        else block
    u = u.astype(np.uint64)
    d = u.copy()
    d[:, 1:] = u[:, 1:] - u[:, :-1]
    return (d & np.uint64((1 << bits) - 1)).astype(
        f"u{max(1, bits // 8)}" if bits >= 8 else np.uint8)


def tiff_file(a, bo="<", photometric=1, sample_format=1, fill_order=1,
              extra=(), compression=1, predictor=1, planar=1, tile=None,
              rows_per_strip=None, big=False, bits=None, tags=None,
              zstd_level=3):
    """A TIFF of the (H, W[, S]) samples ``a`` (``bits`` a sample, the
    dtype's by default): strips or (th, tw) tiles, planar configuration 1
    or 2, ``compression`` 1, 5 (LZW), "5old" (LZW's old LSB-first form,
    tagged 5), 8 or 32946 (Deflate), 32773 (PackBits), 34925 (LZMA) or
    50000 (Zstandard at ``zstd_level``, through Pillow's libzstd),
    predictor 1, 2 or 3, fill order 1 or 2 (the stored bytes reversed),
    ``extra`` samples, BigTIFF where ``big``; ``tags`` adds or replaces
    tags."""
    a = a if a.ndim == 3 else a[..., None]
    h, w, spp = a.shape
    bits = bits or a.dtype.itemsize * 8
    comp_tag = 5 if compression == "5old" else compression
    planes = [slice(p, p + 1) for p in range(spp)] if planar == 2 \
        else [slice(None)]
    stride = spp if planar == 1 else 1

    def chunk(block):
        if predictor == 2:
            block = _predict2(block, bits)
        # predictor 3's byte planes do not depend on the byte order
        raw = pack_rows(block, bits, "<" if predictor == 3 else bo)
        out = encode(raw, compression, block.shape[0], bits // 8, stride,
                     predictor, zstd_level)
        return reverse_bits(out) if fill_order == 2 else out

    chunks = []
    if tile:
        th, tw = tile
        pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw, spp), a.dtype)
        pad[:h, :w] = a
        for pl in planes:
            for y in range(0, pad.shape[0], th):
                for x in range(0, pad.shape[1], tw):
                    chunks.append(chunk(pad[y:y + th, x:x + tw, pl]))
    else:
        rps = rows_per_strip or h
        for pl in planes:
            for y in range(0, h, rps):
                chunks.append(chunk(a[y:y + rps, :, pl]))
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
         259: (3, [comp_tag]), 262: (3, [photometric]), 277: (3, [spp]),
         284: (3, [planar]), 339: (3, [sample_format] * spp)}
    if fill_order != 1:
        t[266] = (3, [fill_order])
    if predictor != 1:
        t[317] = (3, [predictor])
    if extra:
        t[338] = (3, list(extra))
    if photometric == 3:
        t[320] = (3, [int(v) for v in np.random.default_rng(bits).integers(
            0, 65536, 3 << bits)])
    if tile:
        t[322], t[323] = (4, [tile[1]]), (4, [tile[0]])
    else:
        t[278] = (4, [rows_per_strip or h])
    t.update(tags or {})
    return assemble(t, chunks, bo, big, tiles=bool(tile))


def pil_parts(data: bytes):
    """The tags {tag: (type, values)} and the strips of a classic TIFF
    that PIL wrote, to assemble again with other tags."""
    bo, tags = tiff.read_ifd(data, "pil")
    offsets, counts = tags[273], tags[279]
    chunks = [data[o:o + n] for o, n in zip(offsets, counts)]
    keep = {}
    for k in (256, 257, 258, 259, 262, 266, 277, 278, 284, 292, 293, 317,
              338, 339, 530, 531):
        if k in tags:
            keep[k] = (4 if k in (256, 257, 278) else 3, list(tags[k]))
    if 347 in tags:
        keep[347] = (7, tags[347])
    return bo, keep, chunks


# ---------------------------------------------------------------------------
# holding the port to PIL

def pil_read(data: bytes):
    """PIL's array and mode, or the exception it raises."""
    try:
        im = Image.open(io.BytesIO(data))
        return np.asarray(im), im.mode, im.size
    except Exception as e:                       # noqa: BLE001
        return e


def hold(tmp_path, data: bytes, name="x.tif"):
    """The port reads ``data`` as PIL does, or refuses it by name where
    PIL fails (a refusal must name a listed reason)."""
    p = tmp_path / name
    p.write_bytes(data)
    want = pil_read(data)
    if isinstance(want, Exception):
        with pytest.raises(ValueError) as e:
            _read(p)
        assert any(r in str(e.value) for r in tiff.REFUSALS) or \
            "truncated" in str(e.value) or "holds" in str(e.value), e.value
        return None
    arr, mode, size = want
    got, got_mode = _read(p)
    assert got.dtype == arr.dtype and got.shape == arr.shape, (
        got.dtype, got.shape, arr.dtype, arr.shape)
    np.testing.assert_array_equal(got, arr)
    assert got_mode == mode
    assert image_size(p) == size
    return arr


def ycbcr_blocks(ycc: np.ndarray, hs: int, vs: int) -> bytes:
    """(h, w, 3) Y, Cb, Cr samples as TIFF's sampling blocks: hs x vs Y
    samples (the edge repeated past the image) then the block's first Cb
    and Cr, block rows top down."""
    h, w, _ = ycc.shape
    ph, pw = -(-h // vs) * vs, -(-w // hs) * hs
    pad = np.pad(ycc, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
    y = pad[..., 0].reshape(ph // vs, vs, pw // hs, hs).transpose(0, 2, 1, 3)
    blocks = np.concatenate([y.reshape(ph // vs, pw // hs, vs * hs),
                             pad[::vs, ::hs, 1:]], -1)
    return blocks.astype(np.uint8).tobytes()


def _byte_diff(raw: bytes, row_bytes: int, stride: int = 3) -> bytes:
    """libtiff's horDiff8 on rows of ``row_bytes`` bytes, where the chunk
    is whole rows (PredictorEncodeTile)."""
    b = np.frombuffer(raw, np.uint8)
    if len(b) % row_bytes:
        return raw
    r = b.reshape(-1, row_bytes).astype(np.int16)
    d = r.copy()
    d[:, stride:] = r[:, stride:] - r[:, :-stride]
    return (d & 0xFF).astype(np.uint8).tobytes()


def ycbcr_file(ycc, hs, vs, compression=8, tile=None, rows_per_strip=None,
               bo="<", big=False, tags=None, subsampling_tag=True,
               predictor=1):
    """A YCbCr TIFF (photometric 6) of subsampled blocks, in strips or
    tiles, ``compression`` as ``encode`` takes it, predictor 1 or 2 (on
    rows of a block row's bytes / vs in strips, of the tile width's
    samples in tiles, as libtiff's encoder takes them)."""
    h, w, _ = ycc.shape
    chunks = []
    block = hs * vs + 2

    def pred(raw, row_bytes):
        return _byte_diff(raw, row_bytes) if predictor == 2 else raw

    if tile:
        th, tw = tile
        pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw, 3), np.uint8)
        pad[:h, :w] = ycc
        for y in range(0, pad.shape[0], th):
            for x in range(0, pad.shape[1], tw):
                chunks.append(encode(pred(ycbcr_blocks(
                    pad[y:y + th, x:x + tw], hs, vs), 3 * tw), compression))
    else:
        rps = rows_per_strip or h
        for y in range(0, h, rps):
            chunks.append(encode(pred(ycbcr_blocks(
                ycc[y:y + rps], hs, vs), -(-w // hs) * block // vs),
                compression))
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]),
         259: (3, [5 if compression == "5old" else compression]),
         262: (3, [6]), 277: (3, [3]), 284: (3, [1])}
    if subsampling_tag:
        t[530] = (3, [hs, vs])
    if predictor != 1:
        t[317] = (3, [predictor])
    if tile:
        t[322], t[323] = (4, [tile[1]]), (4, [tile[0]])
    else:
        t[278] = (4, [rows_per_strip or h])
    t.update(tags or {})
    return assemble(t, chunks, bo, big, tiles=bool(tile))


def pil_tiff(a, **kw) -> bytes:
    f = io.BytesIO()
    Image.fromarray(a).save(f, "TIFF", **kw)
    return f.getvalue()


def retag(data: bytes, tags=None, fill_order=1, big=False, bo=None):
    """PIL's strips of ``data`` assembled again with ``tags`` changed, the
    stored bytes reversed for fill order 2, as BigTIFF where ``big``
    (the strips' bytes are kept, so the byte order is PIL's)."""
    file_bo, t, chunks = pil_parts(data)
    if fill_order == 2:
        chunks = [reverse_bits(c) for c in chunks]
        t[266] = (3, [2])
    t.update(tags or {})
    return assemble(t, chunks, bo or file_bo, big)


def bilevel(h, w, seed=0, run=None):
    """A seeded (h, w) bilevel image: random pixels, or random runs of
    mean length ``run`` along each row."""
    rng = np.random.default_rng(seed)
    if run is None:
        return rng.integers(0, 2, (h, w)).astype(bool)
    rows = []
    for _ in range(h):
        lengths = rng.geometric(1 / run, w)
        rows.append(np.repeat(np.arange(len(lengths)) % 2, lengths)[:w])
    return np.array(rows, bool) ^ (rng.integers(0, 2, (h, 1)) > 0)


def jpeg_stream(a, quality=80, subsampling=None) -> bytes:
    """PIL's JPEG of ``a`` (4 channels as CMYK)."""
    f = io.BytesIO()
    kw = {} if subsampling is None else dict(subsampling=subsampling)
    im = Image.fromarray(a, "CMYK") if a.ndim == 3 and a.shape[2] == 4 \
        else Image.fromarray(a)
    im.save(f, "JPEG", quality=quality, **kw)
    return f.getvalue()


def split_tables(stream: bytes) -> tuple[bytes, bytes]:
    """A JPEG stream as libtiff stores it: the DQT and DHT segments as an
    abbreviated tables stream (SOI ... EOI) and the rest without them."""
    tables, rest, pos = [b"\xff\xd8"], [b"\xff\xd8"], 2
    while pos < len(stream):
        m = stream[pos + 1]
        if m == 0xDA:
            rest.append(stream[pos:])
            break
        n = int.from_bytes(stream[pos + 2:pos + 4], "big")
        (tables if m in (0xDB, 0xC4) else rest).append(
            stream[pos:pos + 2 + n])
        pos += 2 + n
    return b"".join(tables) + b"\xff\xd9", b"".join(rest)


def jpeg_tiff(a, photometric, subsampling=None, tile=None,
              rows_per_strip=None, tables=False, big=False, bo="<",
              ycbcr_tag=True, quality=80):
    """A JPEG-in-TIFF (compression 7) of (h, w[, 3]) uint8 ``a``: each
    strip or tile PIL's own JPEG stream of its pixels (tiles padded with
    their edge), with the DQT and DHT moved to JPEGTables where
    ``tables``; YCbCrSubsampling from PIL's ``subsampling`` (0 4:4:4,
    1 4:2:2, 2 4:2:0) for photometric 6."""
    h, w = a.shape[:2]
    spp = 1 if a.ndim == 2 else a.shape[2]
    streams = []
    if tile:
        th, tw = tile
        pad = np.pad(a, ((0, -h % th), (0, -w % tw)) + ((0, 0),) * (a.ndim
                                                                    - 2),
                     mode="edge")
        for y in range(0, pad.shape[0], th):
            for x in range(0, pad.shape[1], tw):
                streams.append(jpeg_stream(pad[y:y + th, x:x + tw], quality,
                                           subsampling))
    else:
        rps = rows_per_strip or h
        for y in range(0, h, rps):
            streams.append(jpeg_stream(a[y:y + rps], quality, subsampling))
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * spp),
         259: (3, [7]), 262: (3, [photometric]), 277: (3, [spp]),
         284: (3, [1])}
    if tables:
        tab = split_tables(streams[0])[0]
        streams = [split_tables(s)[1] for s in streams]
        t[347] = (7, tab)
    if photometric == 6 and ycbcr_tag:
        t[530] = (3, [{None: 2, 0: 1, 1: 2, 2: 2}[subsampling],
                      {None: 2, 0: 1, 1: 1, 2: 2}[subsampling]])
    if tile:
        t[322], t[323] = (4, [tile[1]]), (4, [tile[0]])
    else:
        t[278] = (4, [rows_per_strip or h])
    return assemble(t, streams, bo, big, tiles=bool(tile))


def hold_refusal(tmp_path, data: bytes, match=None, name="x.tif"):
    """The port raises a ValueError that holds a listed reason (and
    ``match``)."""
    p = tmp_path / name
    p.write_bytes(data)
    with pytest.raises(ValueError) as e:
        _read(p)
    assert any(r in str(e.value) for r in tiff.REFUSALS), e.value
    if match:
        assert match in str(e.value), e.value
    return str(e.value)


def samples(key, h, w, seed=0):
    """Seeded (h, w, samples) values that fill a key's sample range."""
    rng = np.random.default_rng(seed)
    sf, bps = key[2], key[4]
    spp, bits = len(bps), bps[0]
    if sf == (3,):
        return rng.normal(0, 100, (h, w, spp)).astype(np.float32)
    if bits in (8, 16, 32):
        dt = np.dtype(f"{'i' if sf == (2,) else 'u'}{bits // 8}")
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, (h, w, spp), dtype=dt,
                            endpoint=True)
    return rng.integers(0, 1 << bits, (h, w, spp)).astype(np.uint16)


def key_file(key, h, w, compression=1, **kw):
    """A file of ``key``'s layout (``tiff_file``'s other arguments in
    ``kw``)."""
    bo = "<" if key[0] == b"II" else ">"
    return tiff_file(samples(key, h, w, h * w + len(key[4])), bo, key[1],
                     key[2][0], key[3], key[5], compression,
                     bits=key[4][0], **kw)


KEYS = sorted(TiffImagePlugin.OPEN_INFO, key=repr)


def _key_id(key):
    bo, photo, sf, fill, bps, extra = key
    return (f"{bo.decode()}-p{photo}-sf{sf[0]}-f{fill}-"
            f"{'.'.join(map(str, bps))}-x{''.join(map(str, extra))}")


# ---------------------------------------------------------------------------
# coverage of PIL's tables

def test_coverage_of_pils_tables(tmp_path):
    """The port's copy of OPEN_INFO is PIL's; every key, uncompressed and
    Deflate-compressed, reads as PIL reads it or is refused under a
    listed reason where PIL fails; every compression of
    COMPRESSION_INFO is read (the cases below read each) or refused by
    name, and one that PIL does not know is refused too."""
    assert tiff.OPEN_INFO == TiffImagePlugin.OPEN_INFO
    assert tiff.COMPRESSION_INFO == TiffImagePlugin.COMPRESSION_INFO
    for key in KEYS:
        for compression in (1, 8):
            hold(tmp_path, key_file(key, 5, 7, compression,
                                    rows_per_strip=2))
    read = set(tiff.READ_COMPRESSIONS)
    assert read == {1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946,
                    34925, 50000}
    for comp in sorted(set(TiffImagePlugin.COMPRESSION_INFO) - read) + [
            34661, 34712, 9]:
        data = tiff_file(GRAY_SMALL, compression=8,
                         tags={259: (3, [comp])})
        msg = hold_refusal(tmp_path, data)
        assert (tiff._COMPRESSION_NAMES.get(comp, str(comp)) in msg), msg


GRAY_SMALL = np.arange(63, dtype=np.uint8).reshape(7, 9) * 4


@pytest.mark.parametrize("compression", [1, 8], ids=["raw", "deflate"])
@pytest.mark.parametrize("key", KEYS, ids=_key_id)
def test_key_equal_to_pil(tmp_path, key, compression):
    """Each key at 1x1, 7x9, 37x53 (strips of 8 rows) and 598x1000
    (strips of 64 rows), PIL's raw path and its libtiff path."""
    for h, w, rps in ((1, 1, None), (7, 9, None), (37, 53, 8),
                      (598, 1000, 64)):
        hold(tmp_path, key_file(key, h, w, compression, rows_per_strip=rps))


LAYOUTS = {"raw_tiles": dict(compression=1, tile=(16, 32)),
           "lzw_tiles": dict(compression=5, tile=(32, 16)),
           "raw_planar2": dict(compression=1, planar=2, rows_per_strip=8),
           "deflate_planar2": dict(compression=8, planar=2,
                                   rows_per_strip=8),
           "packbits_planar2_tiles": dict(compression=32773, planar=2,
                                          tile=(16, 16))}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_layouts_of_every_key(tmp_path, layout):
    """Tiles past the right and bottom edges and planar configuration 2
    for every key at 37x53: read as PIL reads them; where the port
    refuses a planar file as one PIL misreads, PIL's reading differs
    from its reading of the same samples interleaved (or PIL fails)."""
    refused = 0
    for key in KEYS:
        kw = LAYOUTS[layout]
        data = key_file(key, 37, 53, **kw)
        want = pil_read(data)
        p = tmp_path / "x.tif"
        p.write_bytes(data)
        try:
            got, mode = _read(p)
        except ValueError as e:
            assert any(r in str(e) for r in tiff.REFUSALS), e
            if not isinstance(want, Exception):
                assert "misreads" in str(e), e
                contig = pil_read(key_file(key, 37, 53, **dict(
                    kw, planar=1)))
                assert isinstance(contig, Exception) or \
                    contig[0].shape != want[0].shape or \
                    not np.array_equal(contig[0], want[0]), (key, e)
            refused += 1
            continue
        assert not isinstance(want, Exception), (key, want)
        np.testing.assert_array_equal(got, want[0])
        assert got.dtype == want[0].dtype and mode == want[1]
    assert refused < len(KEYS)


# ---------------------------------------------------------------------------
# CCITT

CCITT = {"rle": dict(compression="tiff_ccitt"),
         "g3": dict(compression="group3"),
         "g3_2d": dict(compression="group3", tiffinfo={292: 1}),
         "g3_eol_aligned": dict(compression="group3", tiffinfo={292: 4}),
         "g3_2d_eol_aligned": dict(compression="group3",
                                   tiffinfo={292: 5}),
         "g4": dict(compression="group4")}
CCITT_WIDTHS = list(range(1, 71)) + [1000]


def ccitt_tiles(a, kw, tile):
    """Tiles of bilevel ``a``, each PIL's (libtiff's) coding of its own
    padded pixels, with the file's CCITT tags."""
    th, tw = tile
    h, w = a.shape
    pad = np.zeros((-(-h // th) * th, -(-w // tw) * tw), bool)
    pad[:h, :w] = a
    chunks, tags = [], None
    for y in range(0, pad.shape[0], th):
        for x in range(0, pad.shape[1], tw):
            bo, tags, strips = pil_parts(pil_tiff(pad[y:y + th, x:x + tw],
                                                  **kw))
            assert len(strips) == 1
            chunks.append(strips[0])
    tags.update({256: (4, [w]), 257: (4, [h]), 322: (4, [tw]),
                 323: (4, [th])})
    tags.pop(278, None)
    return assemble(tags, chunks, bo, tiles=True)


@pytest.mark.parametrize("variant", ["pil", "photometric0", "fill_order2",
                                     "bigtiff", "tiles", "strips"])
@pytest.mark.parametrize("kind", sorted(CCITT))
def test_ccitt(tmp_path, kind, variant):
    """Seeded bilevel images (random pixels, or runs up to thousands of
    pixels long) at widths 1-70 and 1000, as libtiff codes them for PIL,
    read as PIL reads them: as written, retagged WhiteIsZero, with their
    bytes reversed under fill order 2, as BigTIFF, in 16 x 32 tiles and
    in strips of 3 rows."""
    kw = CCITT[kind]
    widths = CCITT_WIDTHS if variant == "pil" else CCITT_WIDTHS[::7] + [
        1000]
    for w in widths:
        a = bilevel(11 if w < 100 else 64, w, w,
                    None if w % 3 else 40 if w < 100 else 300)
        if variant == "tiles":
            data = ccitt_tiles(a, kw, (16, 32))
        elif variant == "strips":
            data = pil_tiff(a, **dict(kw, strip_size=max(1, -(-w // 8)) * 3))
        else:
            data = pil_tiff(a, **kw)
            if variant == "photometric0":
                data = retag(data, {262: (3, [0])})
            elif variant == "fill_order2":
                data = retag(data, fill_order=2)
            elif variant == "bigtiff":
                data = retag(data, big=True)
        assert hold(tmp_path, data) is not None


def test_ccitt_uncompressed_mode_refused(tmp_path):
    """A Group 4 row and a Group 3 2-D row that enter T.4's uncompressed
    mode (extension code 0000001 111), and a Group 3 1-D row with its
    escape (000000001111): libtiff reports the code and fills the row,
    so PIL reads the row's start as the whole row; the port refuses each
    as a file PIL misreads."""
    for comp, options, bits in (
            (4, 0, "0000001111" + "1" * 14),
            (3, 5, "000000000001" + "0" + "0000001111" + "1"),
            (3, 2, "000000000001" + "000000001111")):
        bits += "0" * (-len(bits) % 8)
        chunk = int(bits, 2).to_bytes(len(bits) // 8, "big")
        data = assemble({256: (4, [8]), 257: (4, [1]), 259: (3, [comp]),
                         262: (3, [0]), 278: (4, [1]),
                         292 if comp == 3 else 293: (4, [options])},
                        [chunk])
        want = pil_read(data)
        assert isinstance(want, Exception) or want[0].all(), want
        hold_refusal(tmp_path, data, "uncompressed mode")


# ---------------------------------------------------------------------------
# tiff_raw_16 (CCITT RLEW) and ThunderScan: files written here

def _row_codes(a):
    """Each row of bilevel ``a`` as libtiff's modified Huffman code of
    that row alone (a one-row tiff_ccitt strip of PIL's, padded to a
    byte), and the tags of such a file."""
    codes = []
    for r in a:
        _, tags, strips = pil_parts(pil_tiff(r[None],
                                             compression="tiff_ccitt"))
        codes.append(strips[0])
    return codes, tags


def shift_strip(data: bytes) -> bytes:
    """``data`` (one strip, last in the file, a LONG offset) with its strip
    moved one byte on: an odd offset."""
    bo, tags = tiff.read_ifd(data, "x")
    (off,) = tags[273]
    entry = struct.pack(bo + "HHII", 273, 4, 1, off)
    at = data.index(entry)
    data = data[:at] + struct.pack(bo + "HHII", 273, 4, 1, off + 1) + \
        data[at + 12:]
    return data[:off] + b"\0" + data[off:]


def rlew_file(a, pad, rows_per_strip=None, fill_order=1, tags=None):
    """Bilevel ``a`` as tiff_raw_16: each row's modified Huffman code
    (``_row_codes``) followed by ``pad(y, bytes so far)`` zero bytes."""
    codes, t = _row_codes(a)
    h, w = a.shape
    rps = rows_per_strip or h
    chunks = []
    for y0 in range(0, h, rps):
        c = b""
        for y in range(y0, min(h, y0 + rps)):
            c += codes[y] + bytes(pad(y, len(c) + len(codes[y])))
        chunks.append(reverse_bits(c) if fill_order == 2 else c)
    t.update({256: (4, [w]), 257: (4, [h]), 259: (3, [32771]),
              278: (4, [rps])})
    if fill_order == 2:
        t[266] = (3, [2])
    t.update(tags or {})
    return assemble(t, chunks)


RLEW = ("even_rows", "unpadded", "random_padding", "odd_offset",
        "fill_order2", "photometric0", "strips", "random_bytes")


@pytest.mark.parametrize("variant", RLEW)
def test_rlew(tmp_path, variant):
    """tiff_raw_16 files of seeded bilevel images at widths 1-70 and 1000:
    rows padded to whole 16-bit words as the format asks, unpadded, with
    0-3 zero bytes after each, in a strip at an odd offset, under fill
    order 2, WhiteIsZero, in strips of 3 rows, and strips of random bytes.
    PIL reads them through libtiff's word alignment, which follows its bit
    accumulator and the strip's address and so often not the rows: the
    port reads what PIL reads (``csrc/tiff_decode.cpp::Rlew``)."""
    rng = np.random.default_rng(len(variant))
    read = 0
    for w in CCITT_WIDTHS:
        if variant == "random_bytes":
            chunk = rng.integers(0, 256, int(rng.integers(0, 40)),
                                 dtype=np.uint8).tobytes()
            data = assemble({256: (4, [w]), 257: (4, [5]),
                             259: (3, [32771]), 262: (3, [0]),
                             278: (4, [5])}, [chunk])
        else:
            a = bilevel(9 if w < 100 else 40, w, w,
                        None if w % 3 else 40 if w < 100 else 300)
            pad = {"unpadded": lambda y, n: 0,
                   "random_padding": lambda y, n: int(rng.integers(0, 4))
                   }.get(variant, lambda y, n: n % 2)
            data = rlew_file(
                a, pad, 3 if variant == "strips" else None,
                2 if variant == "fill_order2" else 1,
                {262: (3, [0])} if variant == "photometric0" else None)
            if variant == "odd_offset":
                data = shift_strip(data)
        read += hold(tmp_path, data) is not None
    assert read > 0


THUNDER_CODES = {
    "raw": [0xC1, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7],
    "runs": [0xC7, 0x04, 0xC9, 0x02, 0xC1, 0x03],
    "run_to_row_end": [0xC1, 0x03, 0xC2, 0x03, 0xC3, 0x05],
    "empty_run": [0xC7, 0x00, 0xC1, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6],
    "deltas_2bit": [0xC5, 0x40 | 1 << 4 | 3 << 2 | 2, 0x40 | 1 << 4 | 1 << 2,
                    0x40 | 3 << 4 | 3 << 2 | 3, 0x40 | 1 << 4 | 1 << 2 | 1],
    "deltas_3bit": [0xC5, 0x80 | 3 << 3 | 5, 0x80 | 4 << 3 | 1, 0x80 | 2,
                    0x80 | 3 << 3 | 3, 0x80 | 7 << 3 | 6],
    "wraps": [0xC0, 0x40 | 63, 0xCF, 0x80 | 3 << 3 | 3, 0x80 | 27],
    "too_long_run": [0xC1, 0x3F],
    "too_short": [0xC1, 0xC2],
}


def _thunder_row(rng, w) -> bytes:
    """Codes of exactly one row of ``w`` pixels: a raw value, then runs,
    2-bit and 3-bit deltas (no skip codes) and raw values."""
    out, n = [0xC0 | int(rng.integers(16))], 1
    while n < w:
        k = int(rng.integers(4))
        if k == 0:
            run = int(rng.integers(1, min(63, w - n) + 1))
            out.append(run)
            n += run
        elif k == 1 and n + 3 <= w:
            d = rng.choice([0, 1, 3], 3)
            out.append(0x40 | int(d[0]) << 4 | int(d[1]) << 2 | int(d[2]))
            n += 3
        elif k == 2 and n + 2 <= w:
            d = rng.choice([0, 1, 2, 3, 5, 6, 7], 2)
            out.append(0x80 | int(d[0]) << 3 | int(d[1]))
            n += 2
        else:
            out.append(0xC0 | int(rng.integers(64)))
            n += 1
    return bytes(out)


def thunder_file(w, h, rows, photometric=1, rows_per_strip=None,
                 fill_order=1, bits=4) -> bytes:
    rps = rows_per_strip or h
    chunks = [b"".join(rows[y:y + rps]) for y in range(0, h, rps)]
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits]), 259: (3, [32809]),
         262: (3, [photometric]), 278: (4, [rps])}
    if fill_order == 2:
        chunks = [reverse_bits(c) for c in chunks]
        t[266] = (3, [2])
    return assemble(t, chunks)


@pytest.mark.parametrize("case", sorted(THUNDER_CODES) + [
    "random_rows", "random_bytes"])
def test_thunderscan(tmp_path, case):
    """ThunderScan files written here (each code kind at widths 3-7;
    seeded rows in strips of 1-5 rows, MinIsBlack and MinIsWhite, fill
    orders 1 and 2; random bytes): PIL's arrays (mode L, 4-bit values
    times 17), or refused where libtiff's decoder fails."""
    rng = np.random.default_rng(len(case))
    read = 0
    if case in THUNDER_CODES:
        codes = bytes(THUNDER_CODES[case])
        for w in range(3, 8):
            read += hold(tmp_path, thunder_file(w, 1, [codes])) is not None
            read += hold(tmp_path, thunder_file(w, 2, [codes, codes])) \
                is not None
        assert read or case.startswith("too"), case
        return
    for _ in range(60):
        w, h = int(rng.integers(1, 70)), int(rng.integers(1, 8))
        rows = [_thunder_row(rng, w) if case == "random_rows" else
                rng.integers(0, 256, int(rng.integers(0, 30)),
                             dtype=np.uint8).tobytes() for _ in range(h)]
        data = thunder_file(w, h, rows, int(rng.integers(0, 2)),
                            int(rng.integers(1, 6)), int(rng.integers(1, 3)))
        read += hold(tmp_path, data) is not None
    assert read > (40 if case == "random_rows" else 0)


def thunder_encode(v: np.ndarray) -> list:
    """Each row of the 4-bit values ``v`` as ThunderScan codes: a raw
    first value, then runs of the last value (up to 63), 3-bit deltas of
    two values within 3 of the last, 2-bit deltas of three within 1, else
    a raw value."""
    rows = []
    for r in v.astype(int):
        out, x, w = [0xC0 | r[0]], 1, len(r)
        while x < w:
            n = 0
            while x + n < w and n < 63 and r[x + n] == r[x - 1]:
                n += 1
            if n:
                out.append(n)
                x += n
                continue
            if x + 2 < w and all(abs(r[x + i] - r[x + i - 1]) <= 1
                                 for i in range(3)):
                d = [(r[x + i] - r[x + i - 1]) % 4 for i in range(3)]
                out.append(0x40 | d[0] << 4 | d[1] << 2 | d[2])
                x += 3
            elif x + 1 < w and all(0 < abs(r[x + i] - r[x + i - 1]) <= 3
                                   for i in range(2)):
                d = [(r[x + i] - r[x + i - 1]) % 8 for i in range(2)]
                out.append(0x80 | d[0] << 3 | d[1])
                x += 2
            else:
                out.append(0xC0 | r[x])
                x += 1
        rows.append(bytes(out))
    return rows


def test_thunder_encode_reads_back(tmp_path):
    """``thunder_encode``'s codes of a view read back, through PIL and the
    port, to the values times 17."""
    v = _zoom(1)[200:240, 300:367] // 16
    data = thunder_file(v.shape[1], v.shape[0], thunder_encode(v),
                        rows_per_strip=16)
    np.testing.assert_array_equal(hold(tmp_path, data), v * 17)


def test_thunderscan_refusals(tmp_path):
    """ThunderScan of other than 4-bit samples (libtiff's
    ThunderSetupDecode refuses them) and in tiles (libtiff does not decode
    them): PIL fails, the port refuses each by name."""
    row = bytes([0xC1, 0x04])
    for bits in (1, 2, 8):
        data = thunder_file(5, 1, [row], bits=bits)
        assert isinstance(pil_read(data), Exception)
        hold_refusal(tmp_path, data, "ThunderScan")
    tiled = assemble({256: (4, [5]), 257: (4, [1]), 258: (3, [4]),
                      259: (3, [32809]), 262: (3, [1]), 322: (4, [16]),
                      323: (4, [16])}, [row * 16], tiles=True)
    assert isinstance(pil_read(tiled), Exception)
    hold_refusal(tmp_path, tiled, "ThunderScan in tiles")


# ---------------------------------------------------------------------------
# JPEG in TIFF

def _views(h, w):
    z1, z2 = _zoom(1), _zoom(2)
    return z1[:h, :w], np.stack([z1, z2, 255 - z1], -1)[:h, :w]


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (37, 53), (598, 1000)])
@pytest.mark.parametrize("mode", ["L", "RGB", "CMYK", "YCbCr"])
def test_jpeg_written_by_pil(tmp_path, mode, size):
    """PIL's own JPEG-in-TIFF (libtiff's abbreviated streams after
    JPEGTables): photometric 1, 2, 5 and 6 (4:4:4), one strip and strips
    of 4096 bytes."""
    g, c = _views(*size)
    for kw in ({}, dict(strip_size=4096)):
        f = io.BytesIO()
        Image.fromarray(g if mode == "L" else c).convert(mode).save(
            f, "TIFF", compression="jpeg", **kw)
        assert Image.open(f).tag_v2.get(347), "no JPEGTables"
        assert hold(tmp_path, f.getvalue()) is not None


JPEG_LAYOUTS = {"strip": {}, "strips_16": dict(rows_per_strip=16),
                "tiles_16x32": dict(tile=(16, 32)),
                "tiles_64x48": dict(tile=(64, 48))}


@pytest.mark.parametrize("tables", [False, True], ids=["streams",
                                                       "jpegtables"])
@pytest.mark.parametrize("layout", sorted(JPEG_LAYOUTS))
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
def test_jpeg_ycbcr(tmp_path, subsampling, layout, tables):
    """Photometric 6, planar configuration 1: libtiff decodes each strip
    or tile alone to RGB (JPEGCOLORMODE_RGB), its fancy upsampling
    stopping at the chunk's edge; at 37x53 and 598x1000."""
    for h, w in ((37, 53), (598, 1000)):
        data = jpeg_tiff(_views(h, w)[1], 6, subsampling, tables=tables,
                         **JPEG_LAYOUTS[layout])
        assert hold(tmp_path, data) is not None


@pytest.mark.parametrize("photometric", [1, 2, 5, 6])
def test_jpeg_photometric_and_tiles(tmp_path, photometric):
    """Photometric 1, 2 and 5 keep the JPEG's components as stored, in
    strips and tiles; photometric 6 without a YCbCrSubsampling tag takes
    the first stream's sampling (libtiff's JPEGFixupTags); a stream whose
    sampling the tag contradicts, and YCbCr JPEG in planar configuration
    2 subsampled, are refused as PIL refuses them."""
    g, c = _views(37, 53)
    a = {1: g, 2: c, 5: np.concatenate([c, c[..., :1]], -1), 6: c}[
        photometric]
    if photometric == 5:                  # PIL's CMYK JPEG streams
        streams_of = Image.fromarray(c).convert("CMYK")
        a = np.asarray(streams_of)
    for kw in ({}, dict(tile=(16, 16)), dict(rows_per_strip=8)):
        sub = 0 if photometric != 6 else 2
        data = jpeg_tiff(a, photometric, sub, tables=True, **kw)
        assert hold(tmp_path, data) is not None
    if photometric == 6:
        for sub in (0, 1, 2):
            assert hold(tmp_path, jpeg_tiff(c, 6, sub,
                                            ycbcr_tag=False)) is not None
        bad = jpeg_tiff(c, 6, 2, tags=None) if False else retag_jpeg(
            jpeg_tiff(c, 6, 2), {530: (3, [1, 1])})
        assert isinstance(pil_read(bad), Exception)
        hold_refusal(tmp_path, bad, "sampling")


def retag_jpeg(data, tags):
    bo, t = tiff.read_ifd(data, "x")
    chunks = [data[o:o + n] for o, n in zip(t[273], t[279])]
    keep = {k: ((4 if k in (256, 257, 278) else 3), list(v))
            for k, v in t.items() if k not in (273, 279, 347)}
    keep.update(tags)
    return assemble(keep, chunks, bo)


# ---------------------------------------------------------------------------
# YCbCr through libtiff's RGBA interface

SUBSAMPLINGS = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)]
YCBCR_LAYOUTS = {"strip": {}, "strips_8": dict(rows_per_strip=8),
                 "strips_5": dict(rows_per_strip=5),
                 "tiles_16x32": dict(tile=(16, 32)),
                 "tiles_32x48": dict(tile=(32, 48))}


@pytest.mark.parametrize("positioning", [1, 2])
@pytest.mark.parametrize("sub", SUBSAMPLINGS,
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_ycbcr(tmp_path, sub, positioning):
    """YCbCr (photometric 6) LZW, Deflate, PackBits and LZMA files of
    each subsampling libtiff reads, at 1x1, 7x9, 37x53 and 598x1000, in
    strips and tiles (clipped ones included), with predictor 2 where the
    chunk is whole rows, and with a ReferenceBlackWhite and
    YCbCrCoefficients of their own; YCbCrPositioning (centred or
    cosited) changes nothing, as in libtiff."""
    rng = np.random.default_rng(sub[0] * 10 + sub[1])
    hs, vs = sub
    tags = {531: (3, [positioning])}
    for h, w in ((1, 1), (7, 9), (37, 53), (598, 1000)):
        ycc = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        for name, kw in YCBCR_LAYOUTS.items():
            if h == 598 and name not in ("strips_8", "tiles_32x48"):
                continue
            for comp in ((8,) if h == 598 else (5, 8, 32773, 34925)):
                assert hold(tmp_path, ycbcr_file(
                    ycc, hs, vs, comp, tags=tags, **kw)) is not None
        assert hold(tmp_path, ycbcr_file(ycc, hs, vs, 8, predictor=2,
                                         rows_per_strip=4, tags=tags)) \
            is not None
        own = {**tags, 532: (5, [(16, 1), (235, 1), (128, 1), (240, 1),
                                 (128, 1), (240, 1)]),
               529: (5, [(2126, 10000), (7152, 10000), (722, 10000)])}
        assert hold(tmp_path, ycbcr_file(ycc, hs, vs, 8, tags=own)) \
            is not None


def test_ycbcr_refusals(tmp_path):
    """What libtiff's RGBA interface cannot read: a subsampling it has no
    routine for, one sample, and planar configuration 2 but 1x1; the
    port refuses each by name as PIL fails.  Uncompressed YCbCr goes
    through PIL's "RGBX" raw mode, as PIL misreads it (or finds the file
    truncated)."""
    ycc = np.random.default_rng(1).integers(0, 256, (16, 16, 3)).astype(
        np.uint8)
    for sub in ((1, 4), (2, 4), (3, 1)):
        data = ycbcr_file(ycc, *sub)
        assert isinstance(pil_read(data), Exception)
        hold_refusal(tmp_path, data, "subsampling")
    one = tiff_file(ycc[..., 0], photometric=6, compression=8)
    assert isinstance(pil_read(one), Exception)
    hold_refusal(tmp_path, one)
    planar = tiff_file(ycc, photometric=6, compression=8, planar=2)
    assert isinstance(pil_read(planar), Exception)
    hold_refusal(tmp_path, planar, "planar configuration 2")
    planar11 = tiff_file(ycc, photometric=6, compression=8, planar=2,
                         tags={530: (3, [1, 1])})
    assert hold(tmp_path, planar11) is not None
    raw = tiff_file(ycc, photometric=6, tags={530: (3, [1, 1])})
    hold(tmp_path, raw)
    raw_padded = raw + bytes(4096)            # PIL's misreading, followed
    assert hold(tmp_path, raw_padded) is not None


# ---------------------------------------------------------------------------
# predictors, LZW, BigTIFF, orientation

PREDICTED = {"L": (np.uint8, 1, 1), "I16": (np.uint16, 1, 1),
             "RGB16": (np.uint16, 2, 1), "I32": (np.int32, 1, 2),
             "F_p2": (np.float32, 1, 3), "F_p3": (np.float32, 1, 3),
             "RGBA": (np.uint8, 2, 1)}


@pytest.mark.parametrize("bo", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("case", sorted(PREDICTED))
def test_predictors(tmp_path, case, bo):
    """Horizontal predictor 2 at 8, 16 and 32 bits and the floating-point
    predictor 3, under LZW (both bit orders), both Deflates and LZMA, at
    widths 1, 2, 3, 7, 9, 53 and 1000, in strips and tiles (PackBits
    leaves the tag unused, as libtiff does)."""
    dtype, photometric, sample_format = PREDICTED[case]
    spp = {"RGB16": 3, "RGBA": 4}.get(case, 1)
    extra = (2,) if case == "RGBA" else ()
    predictor = 3 if case == "F_p3" else 2
    rng = np.random.default_rng(len(case))
    for w in (1, 2, 3, 7, 9, 53, 1000):
        if dtype == np.float32:
            a = rng.normal(0, 1e3, (6, w, spp)).astype(dtype)
        else:
            info = np.iinfo(dtype)
            a = rng.integers(info.min, info.max, (6, w, spp), dtype=dtype)
        # what the file holds, as PIL's mode shows it (in an MM file PIL
        # takes libtiff's host-order float and int32 samples as
        # big-endian: it misreads them, and the port with it)
        want = (a >> 8).astype(np.uint8) if case == "RGB16" else \
            a.astype(np.int32) if dtype == np.int32 else a
        for comp in (5, "5old", 8, 32946, 34925, 32773):
            for kw in (dict(rows_per_strip=4), dict(tile=(16, 16))):
                got = hold(tmp_path, tiff_file(
                    a, bo, photometric, sample_format, extra=extra,
                    compression=comp, predictor=predictor, **kw))
                if comp != 32773 and (bo == "<" or dtype in (np.uint8,
                                                             np.uint16)):
                    np.testing.assert_array_equal(
                        got, want if spp > 1 else want[..., 0])


def test_predictor_64_bit_samples():
    """Predictor 2 at 64 bits and predictor 3 on 64-bit floats, which no
    key of PIL's table holds: the codec's accumulation against numpy's
    wrapping sums and libtiff's byte planes."""
    import ctypes
    rng = np.random.default_rng(64)
    v = rng.integers(0, 2 ** 63, (3, 10, 2), dtype=np.uint64)
    d = v.copy()
    d[:, 1:] = v[:, 1:] - v[:, :-1]
    buf = np.ascontiguousarray(d).view(np.uint8).copy()
    err = ctypes.create_string_buffer(256)
    assert tiff._lib().mods_tiff_unpredict(buf.ctypes.data, 3, 160, 64, 2,
                                           2, 0, err, 256) == 0
    np.testing.assert_array_equal(buf.view(np.uint64).reshape(v.shape), v)
    f = rng.normal(0, 1, (3, 10)).astype(np.float64)
    planes = _float_planes(f.tobytes(), 3, 8, 1)
    buf = np.frombuffer(planes, np.uint8).copy()
    assert tiff._lib().mods_tiff_unpredict(buf.ctypes.data, 3, 80, 64, 1,
                                           3, 0, err, 256) == 0
    np.testing.assert_array_equal(buf.view(np.float64).reshape(f.shape), f)


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["tiff", "tiff_old", "gif"])
def test_lzw_kinds(kind):
    """The codec's three LZW forms on 1000x598 views and random bytes
    (table resets included): TIFF's (this file's encoder, libtiff's
    widths), the old LSB-first TIFF form, and GIF's (PIL's files, every
    minimum code size from 2 to 8)."""
    z = _zoom(1)
    rng = np.random.default_rng(kind)
    for raw in (z.tobytes(), rng.integers(0, 256, 70000, np.uint8)
                .tobytes()):
        if kind < 2:
            assert tiff.lzw_decode(lzw(raw, old=kind == 1), kind, 8,
                                   len(raw)) == raw
    if kind == 2:
        for colours in (4, 16, 64, 256):
            im = Image.fromarray(np.stack([z, z[::-1], z.T[:598, :1000]
                                           if False else 255 - z], -1))
            q = im.quantize(colours)
            f = io.BytesIO()
            q.save(f, "GIF")
            p = f.getvalue()
            got = read_image(io.BytesIO(p)) if False else None
            want = np.asarray(Image.open(io.BytesIO(p)))
            from mods_tpu_torch.io.image import _read_gif
            got = _read_gif(p, "x.gif")[0]
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("compression", [1, 5, "5old", 8, 32946, 32773,
                                         34925, "ccitt", "g3", "g4",
                                         "jpeg"])
def test_bigtiff(tmp_path, compression):
    """BigTIFF (20-byte entries, LONG8 offsets and counts) with every
    compression the port reads; LONG counts in a BigTIFF; a big-endian
    BigTIFF, which PIL cannot open, refused by name."""
    g, c = _views(37, 53)
    if compression in ("ccitt", "g3", "g4"):
        kw = {"ccitt": CCITT["rle"], "g3": CCITT["g3_2d"],
              "g4": CCITT["g4"]}[compression]
        datas = [retag(pil_tiff(g > 100, **kw), big=True)]
    elif compression == "jpeg":
        datas = [jpeg_tiff(c, 6, 2, tile=(16, 16), tables=True, big=True),
                 jpeg_tiff(c, 2, 0, big=True)]
    else:
        datas = [tiff_file(c.astype(np.uint16) * 257, photometric=2,
                           compression=compression, predictor=2
                           if compression in (5, 8) else 1,
                           rows_per_strip=8, big=True),
                 tiff_file(g, compression=compression, tile=(16, 16),
                           big=True)]
    for data in datas:
        assert data[:4] == b"II+\x00"
        assert hold(tmp_path, data) is not None
    mm = tiff_file(g, ">", compression=compression if isinstance(
        compression, int) else 8, big=True)
    assert isinstance(pil_read(mm), Exception)
    hold_refusal(tmp_path, mm, "big-endian BigTIFF")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation(tmp_path, orientation):
    """The Orientation tag turns the image as PIL's exif_transpose does,
    and swaps the size for 5-8, on the raw, libtiff and YCbCr paths."""
    rng = np.random.default_rng(orientation)
    a = rng.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    tags = {274: (3, [orientation])}
    for data in (tiff_file(a, photometric=2, tags=tags),
                 tiff_file(a, photometric=2, compression=8, tags=tags),
                 tiff_file(a[..., 0] > 100, bits=1, compression=1,
                           tags=tags),
                 ycbcr_file(a, 2, 2, rows_per_strip=4, tags=tags)):
        assert hold(tmp_path, data) is not None


REFUSED = {6: "old-style JPEG", 32771: "tiff_raw_16", 32809: "ThunderScan",
           34676: "SGILog", 34677: "SGILog24", 50000: "Zstandard",
           50001: "WebP", 34661: "JBIG", 34712: "JPEG 2000"}
# the compressions of REFUSED that the port now reads
READ_NOW = (6, 32771, 32809, 50000)


@pytest.mark.parametrize("compression", sorted(REFUSED))
def test_refused_compressions(tmp_path, compression):
    """Each compression the port does not read raises a ValueError that
    names it: SGILog, which PIL never reads (libtiff's LogLuvSetupDecode
    refuses every photometric interpretation that PIL has a mode for);
    WebP in TIFF, which this libtiff lacks; JBIG and JPEG 2000, which PIL
    does not open.  Zstandard (PIL's own file), ThunderScan, tiff_raw_16
    and old-style JPEG (written here) are read as PIL reads them."""
    g = GRAY_SMALL
    if compression in READ_NOW:
        if compression == 50000:
            data = pil_tiff(g, compression="zstd")
        elif compression == 32809:
            data = thunder_file(9, 7, [bytes([0xC0 | v >> 4 for v in row])
                                       for row in g])
        elif compression == 6:
            from test_torch_ojpeg import ojpeg_tiff
            data = ojpeg_tiff(g, (1, 1), photometric=1)
        else:
            data = rlew_file(g > 100, lambda y, n: n % 2)
        arr = hold(tmp_path, data)
        assert arr is not None
        if compression == 50000:
            np.testing.assert_array_equal(arr, g)
        return
    data = tiff_file(g, compression=8, tags={259: (3, [compression])})
    if compression in (50001, 34661, 34712, 34676, 34677):
        assert isinstance(pil_read(data), Exception)
    msg = hold_refusal(tmp_path, data, REFUSED[compression])
    if compression in (34676, 34677):
        assert "PIL refuses it" in msg and "is not supported" not in msg


# ---------------------------------------------------------------------------
# the fixtures and the JAX figures of chip_smoke.py phase 14n-14o

def _crops(h, w):
    """(h, w) gray and RGB crops of the zoom2x and tilt4 views."""
    a = _zoom(1)[100:100 + h, 0:w]
    b = np.asarray(Image.open(os.path.join(REPO, ".parity_work",
                                           "tilt4_1.png")))[:h, :w]
    return a, np.stack([a, b, 255 - a // 2], -1)


def tiff_jpeg_pair(i: int) -> bytes:
    """Phase 14o's file: zoom2x view ``i`` as YCbCr JPEG-in-TIFF (its gray
    in R, G and B), 4:2:0, quality 85, 128 x 128 tiles, JPEGTables."""
    g = _zoom(i)
    return jpeg_tiff(np.stack([g] * 3, -1), 6, 2, tile=(128, 128),
                     tables=True, quality=85)


def tiff_zstd_pair(i: int) -> bytes:
    """Phase 14q's file: zoom2x view ``i`` as a Zstandard TIFF (level 19)
    in 128 x 128 tiles with predictor 2."""
    return tiff_file(_zoom(i), compression=50000, predictor=2,
                     tile=(128, 128), zstd_level=19)


def write_fixtures(d) -> None:
    """Phase 14n's fixtures (small crops of the zoom2x and tilt4 views;
    CCITT and JPEG coded by PIL's libtiff or its JPEG encoder, the rest
    by ``tiff_file`` and ``ycbcr_file``), 14o's pair, 14p's Zstandard,
    ThunderScan and tiff_raw_16 fixtures and 14q's pair."""
    os.makedirs(d, exist_ok=True)
    g, rgb = _crops(96, 128)
    bw = g > np.median(g)
    ycc = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
    g48, rgb48 = g[:48, :64], rgb[:48, :64]
    files = {
        "ccitt_g4.tif": pil_tiff(bw, compression="group4"),
        "ccitt_g3_2d_fill2.tif": retag(pil_tiff(
            bw, compression="group3", tiffinfo={292: 5}),
            {262: (3, [0])}, fill_order=2),
        "ccitt_rle_tiles.tif": ccitt_tiles(bw, CCITT["rle"], (32, 48)),
        "jpeg_ycbcr_420_tiles.tif": jpeg_tiff(rgb, 6, 2, tile=(32, 48),
                                              tables=True),
        "jpeg_cmyk.tif": (lambda f: (Image.fromarray(rgb).convert(
            "CMYK").save(f, "TIFF", compression="jpeg"), f.getvalue())[1])(
            io.BytesIO()),
        "ycbcr_422_lzw.tif": ycbcr_file(ycc, 2, 1, 5, rows_per_strip=16),
        "ycbcr_44_tiles.tif": ycbcr_file(ycc, 4, 4, 8, tile=(32, 48)),
        "rgb16_bigtiff.tif": tiff_file(rgb48.astype(np.uint16) * 257 + 3,
                                       photometric=2, compression=8,
                                       predictor=2, rows_per_strip=16,
                                       big=True),
        "float_predictor3_lzma.tif": tiff_file(
            g48.astype(np.float32) / 7 - 3, sample_format=3,
            compression=34925, predictor=3, rows_per_strip=16),
        "cmyk16_mm.tif": tiff_file(np.concatenate(
            [rgb48, g48[..., None]], -1).astype(np.uint16) * 255, ">", 5,
            compression=8),
        "rgba_associated.tif": tiff_file(np.concatenate(
            [rgb48 // 2, 128 + g48[..., None] // 2], -1), photometric=2,
            extra=(1,), compression=5),
        "lab_tiles.tif": tiff_file(rgb48, photometric=8, tile=(16, 32)),
        "gray4_fill2.tif": tiff_file(g48 // 16, fill_order=2, bits=4),
        "gray12_old_lzw.tif": tiff_file(g48.astype(np.uint16) * 16 + 5,
                                        compression="5old", bits=12),
        "palette2_packbits.tif": tiff_file(g48 // 64, photometric=3,
                                           compression=32773, bits=2),
        "oriented_6.tif": tiff_file(rgb48, photometric=2, compression=8,
                                    tags={274: (3, [6])}),
        "zoom2x_1_ycbcr_jpeg.tif": tiff_jpeg_pair(1),
        "zoom2x_2_ycbcr_jpeg.tif": tiff_jpeg_pair(2),
        # 14p: the codecs of this slice
        "zstd_gray_predictor2.tif": tiff_file(
            g, compression=50000, predictor=2, rows_per_strip=16,
            zstd_level=19),
        "zstd_rgb16_mm_tiles.tif": tiff_file(
            rgb48.astype(np.uint16) * 257 + 5, ">", 2, compression=50000,
            predictor=2, tile=(16, 32)),
        "zstd_float_predictor3.tif": tiff_file(
            g48.astype(np.float32) / 3 - 7, sample_format=3,
            compression=50000, predictor=3, rows_per_strip=16,
            zstd_level=9),
        "zstd_pil.tif": pil_tiff(rgb, compression="zstd"),
        "thunderscan.tif": thunder_file(64, 48, thunder_encode(g48 // 16),
                                        rows_per_strip=16),
        "tiff_raw_16.tif": rlew_file(bw[:48], lambda y, n: n % 2),
        # 14q's pair
        "zoom2x_1_zstd_tiles.tif": tiff_zstd_pair(1),
        "zoom2x_2_zstd_tiles.tif": tiff_zstd_pair(2),
    }
    for name, data in files.items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)


def test_tiff_fixtures_are_written_here():
    """The committed fixtures of phase 14n-14q are ``write_fixtures``'s
    bytes (PIL's coders here, Pillow 12.1.0 with libtiff 4.7.1,
    libjpeg-turbo and libzstd 1.5.7), and every one of 14n's and 14p's has
    PIL's hash in ``chip_smoke.FORMAT_FIXTURE_SHA256``.  Sizes: 30 KB a
    crop, 100 KB a file of 14o's JPEG pair, 1.5 MB for 14q's lossless
    Zstandard pair together."""
    import tempfile
    zstd_pair = 0
    with tempfile.TemporaryDirectory() as d:
        write_fixtures(d)
        for name in sorted(os.listdir(d)):
            mine = open(os.path.join(d, name), "rb").read()
            assert (chip_smoke.IMAGE_FIXTURES / name).read_bytes() == mine
            if name in chip_smoke.TIFF_ZSTD_PAIR:
                zstd_pair += len(mine)
                continue
            assert len(mine) < (100_000 if name.startswith("zoom2x")
                                else 30_000), (name, len(mine))
            if not name.startswith("zoom2x"):
                assert name in chip_smoke.TIFF_VARIANT_FIXTURES + \
                    chip_smoke.TIFF_CODEC_FIXTURES
    assert 0 < zstd_pair < 1_500_000
    assert set(chip_smoke.TIFF_VARIANT_FIXTURES +
               chip_smoke.TIFF_CODEC_FIXTURES) <= set(
        chip_smoke.FORMAT_FIXTURE_SHA256)


def _bigtiff_rgb16(i: int) -> bytes:
    """zoom2x view ``i`` as 16-bit RGB BigTIFF: PIL's RGB of phase 14o's
    JPEG-in-TIFF file scaled to 16 bits, Deflate with predictor 2, strips
    of 64 rows."""
    rgb = np.asarray(Image.open(chip_smoke.IMAGE_FIXTURES
                                / f"zoom2x_{i}_ycbcr_jpeg.tif"))
    return tiff_file(rgb.astype(np.uint16) * 257, photometric=2,
                     compression=8, predictor=2, rows_per_strip=64, big=True)


@pytest.mark.parametrize("pair", ["ycbcr_jpeg_tiles", "rgb16_bigtiff",
                                  "zstd_tiles"])
def test_cli_match_against_jax(tmp_path, pair, capsys):
    """``cli match`` (LORANSACH, the CVIU-shaped INI files, as phase 14o
    runs it) on zoom2x's pair as phase 14o's YCbCr JPEG-in-TIFF files, as
    16-bit RGB BigTIFFs and as phase 14q's Zstandard TIFFs, against
    ``mods_tpu.cli.cmd_match`` on the same files: ``test_torch_cli.py``'s
    rule (the same steps, the verified count within 20 %)."""
    from mods_tpu import cli as jcli
    from mods_tpu_torch import cli as tcli
    from test_torch_cli import load_jax_native
    load_jax_native()
    if pair in ("ycbcr_jpeg_tiles", "zstd_tiles"):
        stem = "ycbcr_jpeg" if pair == "ycbcr_jpeg_tiles" else pair
        imgs = [str(chip_smoke.IMAGE_FIXTURES / f"zoom2x_{i}_{stem}.tif")
                for i in (1, 2)]
    else:
        imgs = []
        for i in (1, 2):
            p = tmp_path / f"zoom2x_{i}.tif"
            p.write_bytes(_bigtiff_rgb16(i))
            imgs.append(str(p))
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


def _jax_tiff_jpeg_main(stem: str = "ycbcr_jpeg") -> None:
    """The JAX command on phase 14o's pair (LORANSACH, the CVIU-shaped
    INI files): ``JAX_TIFF_JPEG_REFERENCE``; with ``stem`` "zstd_tiles"
    on 14q's pair: ``JAX_TIFF_ZSTD_REFERENCE``."""
    import contextlib
    import json
    import tempfile
    import time
    from pathlib import Path

    from mods_tpu import cli as jcli
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        (td / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
        (td / "iters.ini").write_text(chip_smoke.cviu_iters_ini())
        m = td / "m.txt"
        pair = [str(chip_smoke.IMAGE_FIXTURES / f"zoom2x_{i}_{stem}.tif")
                for i in (1, 2)]
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jcli.cmd_match(pair + ["0", "0", "k1", "k2", str(m), "0",
                                          "LORANSACH", str(td / "config.ini"),
                                          str(td / "iters.ini")]) == 0
        h, w = _zoom(1).shape
        figures = chip_smoke.match_figures(
            buf.getvalue(), str(m),
            np.loadtxt(chip_smoke.PAIRS / "zoom2x_H.txt"), w, h)
    print(json.dumps(dict(figures, seconds=round(time.time() - t0, 1))),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--fixtures"]:
        write_fixtures(chip_smoke.IMAGE_FIXTURES)
    elif sys.argv[1:] == ["--jax-tiff-jpeg"]:
        _jax_tiff_jpeg_main()
    elif sys.argv[1:] == ["--jax-tiff-zstd"]:
        _jax_tiff_jpeg_main("zstd_tiles")


def test_decompression_bomb_refused(tmp_path):
    """A TIFF of more than twice PIL's MAX_IMAGE_PIXELS: PIL refuses to
    open it, and the port refuses it by name before allocating."""
    data = assemble({256: (4, [20000]), 257: (4, [20000]), 259: (3, [1]),
                     262: (3, [1]), 278: (4, [20000])}, [b"\0"])
    assert isinstance(pil_read(data), Exception)
    hold_refusal(tmp_path, data, "decompression bomb")


def test_jpeg_ycbcr_planar2(tmp_path):
    """YCbCr JPEG in planar configuration 2 (one gray stream a plane):
    libtiff's RGBA interface reads it at 1x1 subsampling and refuses the
    default 2x2 (no YCbCrSubsampling tag), as the port does."""
    rng = np.random.default_rng(2)
    ycc = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    streams = [jpeg_stream(np.ascontiguousarray(ycc[..., c]))
               for c in range(3)]
    t = {256: (4, [53]), 257: (4, [37]), 258: (3, [8, 8, 8]),
         259: (3, [7]), 262: (3, [6]), 277: (3, [3]), 284: (3, [2]),
         278: (4, [37])}
    assert hold(tmp_path, assemble({**t, 530: (3, [1, 1])}, streams)) \
        is not None
    untagged = assemble(t, streams)
    assert isinstance(pil_read(untagged), Exception)
    hold_refusal(tmp_path, untagged, "planar configuration 2")


def test_malformed_layouts_refused(tmp_path):
    """Layouts a damaged file can claim: no pixels, no samples, a tile
    dimension of a rational type, a tile libtiff cannot allocate, palette
    indices without a ColorMap, a truncated GIF; each a ValueError, as
    PIL fails on each."""
    base = {258: (3, [8]), 259: (3, [8]), 262: (3, [1])}
    chunk = zlib.compress(bytes(64))
    cases = {
        "no pixels": assemble({**base, 256: (4, [0]), 257: (4, [5]),
                               278: (4, [5])}, [chunk]),
        "no samples": assemble({**base, 256: (4, [8]), 257: (4, [8]),
                                277: (3, [0]), 278: (4, [8])}, [chunk]),
        "rational tile width": assemble({**base, 256: (4, [8]),
                                         257: (4, [8]), 322: (5, [(16, 1)]),
                                         323: (4, [16])}, [chunk],
                                        tiles=True),
        "huge tile": assemble({**base, 256: (4, [8]), 257: (4, [8]),
                               322: (4, [1 << 20]), 323: (4, [1 << 20])},
                              [chunk], tiles=True),
        "palette without a colormap": assemble(
            {**base, 256: (4, [8]), 257: (4, [8]), 262: (3, [3]),
             278: (4, [8])}, [chunk]),
    }
    for name, data in cases.items():
        assert isinstance(pil_read(data), Exception), name
        hold_refusal(tmp_path, data)
    gif = io.BytesIO()
    Image.fromarray(GRAY_SMALL).save(gif, "GIF")
    p = tmp_path / "x.gif"
    for cut in (12, 30):
        p.write_bytes(gif.getvalue()[:cut])
        with pytest.raises(ValueError, match="GIF"):
            read_image(p)
