"""The formats that PIL 12.1.0 opens by probing a file's content (SPIDER,
GBR, XVTHUMB, IMT, FLI, FTEX, McIdas, PCD, IPTC, PIXAR): the port's
``io/image.py`` holds to PIL's array, mode and size bit for bit, through
the JAX command's reader ``mods_tpu/cli.py::_load_image``, and finds each
format where ``Image.open``'s plugin order finds it.  Every file is built
here from a seed (PIL writes only SPIDER of these).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_probed_formats.py -q

Phase 14zg of ``chip_smoke.py`` reads the files of ``fixture_files``
(``tests/data/image_io``, written by ``python
tests/test_torch_probed_formats.py --fixtures``) and its own Photo CD
files on the card machine, which has no PIL; ``--hashes`` prints PIL's
entries for its tables, and ``JAX_PLATFORMS=cpu python
tests/test_torch_probed_formats.py --jax-mcidas`` the JAX command's
figures on 14zh's McIdas pair (``JAX_MCIDAS_REFERENCE``, about 20 s).
"""

from __future__ import annotations

import hashlib
import io
import struct
import sys

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from chip_smoke import mcidas_file, pcd_file
from mods_tpu.cli import _load_image
from mods_tpu_torch.io import image as I


def _pil(p):
    """PIL's array, mode and size, or the exception it raises."""
    try:
        with Image.open(p) as im:
            return np.asarray(im), im.mode, im.size, im.format
    except Exception as e:                          # noqa: BLE001
        return e


def hold(p):
    """The port reads ``p`` as the JAX command does, bit for bit."""
    want = _pil(p)
    assert not isinstance(want, Exception), want
    a, mode, size, fmt = want
    got, got_mode = I._read(p)
    np.testing.assert_array_equal(got, _load_image(str(p)))
    assert got.dtype == a.dtype and got.shape == a.shape
    np.testing.assert_array_equal(got, a)
    assert got_mode == mode
    assert I.image_size(p) == size
    with open(p, "rb") as f:
        assert I._format(f.read(), p) == fmt.upper()


def refused(p, match=None):
    """PIL refuses ``p``, and so does the port, naming ``match``."""
    assert isinstance(_pil(p), Exception)
    with pytest.raises(ValueError, match=match):
        I._read(p)


# ---------------------------------------------------------------------------
# the files, built here

def spider_file(a: np.ndarray, big: bool = True, stack: int = 0) -> bytes:
    """A SPIDER 2-D image (or a stack of ``stack`` images) of float32 ``a``
    with PIL's header layout, in either byte order."""
    h, w = a.shape
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt
    hdr = [0.0] * (labbyt // 4)
    hdr[0], hdr[1], hdr[2], hdr[4] = 1.0, h, h, 1.0
    hdr[11], hdr[12], hdr[21], hdr[22] = w, labrec, labbyt, lenbyt
    if stack:
        hdr[23], hdr[25] = 2.0, float(stack)
    order = ">" if big else "<"
    head = struct.pack(f"{order}{len(hdr)}f", *hdr)
    px = a.astype(f"{order}f4").tobytes()
    if stack:          # the stack header, then each image's header and data
        return head + b"".join(head + px for _ in range(stack))
    return head + px


def gbr_file(a: np.ndarray, version: int = 2) -> bytes:
    h, w = a.shape[:2]
    depth = 4 if a.ndim == 3 else 1
    name = b"brush\0"
    if version == 1:
        head = struct.pack(">5I", 20 + len(name), 1, w, h, depth)
    else:
        head = struct.pack(">5I", 28 + len(name), 2, w, h, depth) \
            + b"GIMP" + struct.pack(">I", 25)
    return head + name + a.tobytes()


def xvthumb_file(a: np.ndarray) -> bytes:
    h, w = a.shape
    return (b"P7 332\n#XVVERSION:Version 2.28\n#END_OF_COMMENTS\n"
            + b"%d %d 255\n" % (w, h) + a.tobytes())


def imt_file(a: np.ndarray) -> bytes:
    h, w = a.shape
    return (b"* an IM Tools header\nwidth %d\nheight %d\npixel n8\n\x0c"
            % (w, h) + a.tobytes())


def fli_chunk(kind: int, body: bytes) -> bytes:
    return struct.pack("<IH", 6 + len(body), kind) + body


def fli_file(w: int, h: int, chunks: list, flc: bool = True,
             pad: int = 0) -> bytes:
    """An FLI/FLC file whose first frame holds ``chunks``."""
    frame = b"".join(chunks)
    frame = struct.pack("<IHH8x", 16 + len(frame) + pad, 0xF1FA,
                        len(chunks)) + frame + bytes(pad)
    head = bytearray(128)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(frame),
                     0xAF12 if flc else 0xAF11, 1, w, h, 8, 3 if flc else 0,
                     5)
    return bytes(head) + frame


def brun(rows: np.ndarray) -> bytes:
    """FLI BRUN: each line a packet byte, then runs and literals."""
    out = bytearray()
    for r in rows:
        out.append(0)
        x = 0
        while x < len(r):
            n = 1
            while x + n < len(r) and r[x + n] == r[x] and n < 127:
                n += 1
            if n >= 3:
                out += bytes([n, r[x]])
            else:
                n = min(len(r) - x, 100)
                out += bytes([256 - n]) + bytes(r[x:x + n])
            x += n
    return bytes(out)


def lc(rows: np.ndarray, y0: int) -> bytes:
    """FLI LC (byte delta) of ``rows`` from line ``y0``: a skip, a literal
    and a run a line."""
    out = bytearray(struct.pack("<HH", y0, len(rows)))
    for r in rows:
        w = len(r)
        out += bytes([2, 1, 3]) + bytes(r[1:4])            # skip 1, copy 3
        out += bytes([0, 256 - (w - 4)]) + bytes([r[4]])   # run to the end
    return bytes(out)


def ss2(rows: np.ndarray) -> bytes:
    """FLI SS2 (word delta): one line skipped, then word literals and runs,
    and an odd last byte."""
    w = rows.shape[1]
    out = bytearray(struct.pack("<H", len(rows) - 1))
    out += struct.pack("<H", 0x10000 - 1)                  # skip a line
    for r in rows[1:]:
        if w % 2:
            out += struct.pack("<H", 0x8000 | int(r[-1]))  # the odd byte
        out += struct.pack("<H", 2)
        out += bytes([0, 2]) + bytes(r[:4])                # 2 words
        n = (w - 4) // 2
        out += bytes([0, 256 - n]) + bytes(r[4:6])         # a word run
    return bytes(out)


def ftex_file(w: int, h: int, fmt: int, body: bytes) -> bytes:
    return (b"FTEX" + struct.pack("<7i", 0, w, h, 1, 1, fmt, 32)
            + struct.pack("<i", len(body)) + body)


def iptc_record(rec: int, tag: int, data: bytes) -> bytes:
    return bytes([0x1C, rec, tag]) + struct.pack(">H", len(data)) + data


def iptc_file(size, layers: int, component: int, compression: int,
              data: bytes, band: int | None = None) -> bytes:
    w, h = size
    recs = [iptc_record(3, 60, bytes([layers, component])),
            iptc_record(3, 20, struct.pack(">H", w)),
            iptc_record(3, 30, struct.pack(">H", h)),
            iptc_record(3, 120, bytes([compression]))]
    if band is not None:
        recs.append(iptc_record(3, 65, bytes([band])))
    half = len(data) // 2          # the data in two (8, 10) records
    return (b"".join(recs) + iptc_record(8, 10, data[:half])
            + iptc_record(8, 10, data[half:]) + bytes(5))


def pixar_file(a: np.ndarray, mode=(14, 2)) -> bytes:
    h, w = a.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<HH", head, 416, h, w)
    struct.pack_into("<HH", head, 424, *mode)
    return bytes(head) + a.tobytes()


def _jpeg(a: np.ndarray, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(a).save(b, "JPEG", **kw)
    return b.getvalue()


def probed_files(seed: int) -> dict:
    """One file of each format and mode, from ``seed``."""
    rng = np.random.default_rng(seed)
    h, w = 37, 53
    gray = rng.integers(0, 256, (h, w), dtype=np.uint8)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    f32 = rng.normal(0, 100, (h, w)).astype(np.float32)
    fli_rows = rng.integers(0, 256, (h, 21), dtype=np.uint8)
    palette = fli_chunk(4, struct.pack("<HBB", 1, 0, 0)
                        + rng.integers(0, 256, 768, dtype=np.uint8).tobytes())
    files = {
        "spider_be.spi": spider_file(f32, True),
        "spider_le.spi": spider_file(f32, False),
        "spider_stack.spi": spider_file(f32, True, stack=2),
        "gbr_v1_l.gbr": gbr_file(gray, 1),
        "gbr_v2_rgba.gbr": gbr_file(rgba, 2),
        "xvthumb.xv": xvthumb_file(gray),
        "imt.imt": imt_file(gray),
        "fli_brun.flc": fli_file(21, h, [palette, fli_chunk(15, brun(
            fli_rows))]),
        "fli_copy_lc.fli": fli_file(21, h, [
            fli_chunk(11, struct.pack("<HBB", 1, 4, 2) + bytes(6)),
            fli_chunk(16, fli_rows.tobytes() + bytes(1)),
            fli_chunk(12, lc(fli_rows[5:9][:, ::-1].copy(), 5))],
            flc=False),
        "fli_black_ss2.flc": fli_file(21, h, [
            fli_chunk(16, fli_rows.tobytes() + bytes(1)),
            fli_chunk(13, b""), fli_chunk(7, ss2(fli_rows[:9])),
            fli_chunk(18, bytes(10))], pad=1),
        "ftex_dxt1.ftc": ftex_file(w, h, 0, rng.integers(
            0, 256, 14 * 10 * 8, dtype=np.uint8).tobytes()),
        "ftex_rgb.ftu": ftex_file(w, h, 1, rgb.tobytes()),
        "mcidas_1.area": mcidas_file(gray),
        "mcidas_2.area": mcidas_file(
            rng.integers(0, 65536, (h, w), dtype=np.uint16), prefix=3),
        "mcidas_4.area": mcidas_file(
            rng.integers(-2**31, 2**31, (h, w), dtype=np.int64).astype(
                np.int32), prefix=4, gap=16),
        "pcd_0.pcd": pcd_file(seed + 1, 0),
        "pcd_1.pcd": pcd_file(seed + 2, 1),
        "pcd_3.pcd": pcd_file(seed + 3, 3),
        "iptc_raw_l.iim": iptc_file((w, h), 1, 0, 1, gray.tobytes()),
        "iptc_raw_rgb_band.iim": iptc_file((w, h), 3, 1, 1, gray.tobytes(),
                                           band=2),
        "iptc_jpeg_l.iim": iptc_file((w, h), 1, 0, 5, _jpeg(gray)),
        "pixar.pxr": pixar_file(rgb),
    }
    return files


FILES = probed_files(0)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    d = tmp_path_factory.mktemp("probed")
    for name, data in FILES.items():
        (d / name).write_bytes(data)
    return d


@pytest.mark.parametrize("name", sorted(FILES))
def test_reads_as_pil(built, name):
    """Each file reads to PIL's array, mode and size, found as PIL finds
    it."""
    hold(built / name)


def test_spider_as_pil_saves_it(tmp_path):
    """PIL's own SPIDER save (native little-endian floats) of each mode it
    converts to "F".  The plugin's ``_save`` is called as ``Image.save``
    calls it, less its registering the file's extension for SPIDER, which
    would outlive the test."""
    from PIL import SpiderImagePlugin
    rng = np.random.default_rng(1)
    for a in (rng.integers(0, 256, (20, 300), dtype=np.uint8),
              rng.normal(0, 1, (9, 7)).astype(np.float32)):
        p = tmp_path / "x.spi"
        with open(p, "wb") as f:
            SpiderImagePlugin._save(Image.fromarray(a), f, str(p))
        hold(p)


def test_pixar_needs_14_2(tmp_path):
    """Any channel/depth pair other than (14, 2) leaves PIL no mode: no
    plugin identifies the file."""
    p = tmp_path / "x.pxr"
    p.write_bytes(pixar_file(np.zeros((4, 5, 3), np.uint8), mode=(14, 1)))
    refused(p, "not an image format")


def test_truncated_raw_files_are_refused(tmp_path):
    """A file cut inside its pixels: PIL refuses it ("image file is
    truncated" from RawDecode.c, "buffer is not large enough" from its
    memory map, "not enough image data" from frombytes), and so does the
    port."""
    for name in ("spider_be.spi", "gbr_v2_rgba.gbr", "xvthumb.xv", "imt.imt",
                 "ftex_rgb.ftu", "ftex_dxt1.ftc", "mcidas_1.area",
                 "mcidas_2.area", "mcidas_4.area", "pcd_0.pcd", "pixar.pxr",
                 "fli_brun.flc", "iptc_raw_l.iim"):
        p = tmp_path / name
        p.write_bytes(FILES[name][:-7])
        refused(p)


def test_open_failures_give_pils_reason(tmp_path):
    """Where ``Image.open`` fails outright, the port names PIL's reason:
    an IPTC record longer than 132 bytes of length, an FTEX of two
    formats (the plugin's assertion), an FTEX format other than 0 and 1, a
    SPIDER image number without a stack, an FLI chunk of an unknown type
    (FliDecode.c) and an IMT header without its form feed."""
    f32 = np.zeros((4, 6), np.float32)
    spider = bytearray(spider_file(f32))
    struct.pack_into(">f", spider, 26 * 4, 3.0)     # imgnumber, no stack
    cases = {
        "a.iim": (b"\x1c\x03\x3c\x85" + bytes(20), "illegal field length"),
        "b.ftc": (b"FTEX" + struct.pack("<7i", 0, 4, 4, 1, 2, 1, 40)
                  + bytes(60), "format_count"),
        "c.ftc": (ftex_file(4, 4, 3, bytes(48)), "compression format"),
        "d.spi": (bytes(spider), "stkoffset"),
        "e.flc": (fli_file(4, 4, [fli_chunk(9, bytes(8))]), "unknown"),
        "f.imt": (b"width 4\nheight 4\npixel n8\n" + bytes(16),
                  "cannot load"),
    }
    for name, (data, match) in cases.items():
        p = tmp_path / name
        p.write_bytes(data)
        refused(p, match)


def test_plugin_order_decides(tmp_path):
    """``Image.open`` tries the plugins in ``Image.ID``'s order, and so does
    the port: an IMT header that is also IM text is IM's (IM comes first);
    an IPTC file holding a JPEG is IPTC, not JPEG; an FLI header that
    fails FliImagePlugin's zero checks goes on to the next plugins."""
    p = tmp_path / "a"
    p.write_bytes(b"Image type: L image\nImage size (x*y): 4*2\n\x1a"
                  + bytes(8))
    assert Image.open(p).format == "IM"
    with open(p, "rb") as f:
        assert I._format(f.read(), p) == "IM"
    data = bytearray(FILES["fli_brun.flc"])
    data[20] = 1                                     # not FLI any more
    p.write_bytes(bytes(data))
    want = _pil(p)
    got = None
    try:
        got = I._read(p)
    except ValueError:
        pass
    assert isinstance(want, Exception) == (got is None)


def test_fli_chunks_match_fli_decode(tmp_path):
    """FliDecode.c's bounds: a BRUN line that does not fill the width, an
    LC line past the image, and a chunk whose length runs past the frame
    are refused as PIL refuses them; a frame one byte short of its size is
    read where that size is even (the decoder allows one pad byte) and
    refused where it is odd."""
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 256, (6, 9), dtype=np.uint8)
    good = brun(rows)
    cases = {
        "short_brun.flc": fli_file(9, 6, [fli_chunk(15, good[:-3])]),
        "lc_past.flc": fli_file(9, 6, [fli_chunk(12, lc(rows, 3))]),
        "long_chunk.flc": fli_file(9, 6, [struct.pack("<IH", 999, 13)]),
    }
    for name, data in cases.items():
        p = tmp_path / name
        p.write_bytes(data)
        assert isinstance(_pil(p), Exception), name
        with pytest.raises(ValueError):
            I._read(p)
    p = tmp_path / "pad.flc"
    for pad in (1, 2):
        data = fli_file(9, 6, [fli_chunk(15, good)], pad=pad)
        p.write_bytes(data[:-1])
        if struct.unpack_from("<I", data, 128)[0] % 2:
            refused(p, "truncated")
        else:
            hold(p)


def fixture_files() -> dict:
    """Phase 14zg's fixtures: ``probed_files(0)`` less its Photo CD files,
    which the card machine builds itself (``chip_smoke.pcd_file``)."""
    return {n: d for n, d in FILES.items() if not n.startswith("pcd")}


def pil_entry(data: bytes) -> tuple:
    """``FORMAT_FIXTURE_SHA256``'s entry: PIL's shape, mode and SHA-256."""
    with Image.open(io.BytesIO(data)) as im:
        a = np.asarray(im)
        return a.shape, im.mode, hashlib.sha256(a.tobytes()).hexdigest()


def test_fixtures_and_hashes_are_pils():
    """The committed fixtures are ``fixture_files``' bytes, each read by
    the port as PIL reads it, and ``chip_smoke``'s tables hold PIL's
    hashes of them and of its Photo CD files; under 100 KB in all."""
    files = fixture_files()
    assert set(files) == set(chip_smoke.PROBED_FIXTURES)
    for name, data in files.items():
        path = chip_smoke.IMAGE_FIXTURES / name
        assert path.read_bytes() == data, name
        assert chip_smoke.FORMAT_FIXTURE_SHA256[name] == pil_entry(data), name
    assert sum(len(d) for d in files.values()) < 100_000
    for o in (0, 1, 3):
        data = chip_smoke.pcd_file(chip_smoke.PCD_SEED + o, o)
        assert chip_smoke.PCD_SHA256[o] == pil_entry(data), o
        got, mode = I._read_data(data, "pcd")
        assert (got.shape, mode, hashlib.sha256(got.tobytes()).hexdigest()) \
            == chip_smoke.PCD_SHA256[o]


def test_cli_match_on_the_mcidas_pair(tmp_path, capsys):
    """``cli match`` (LORANSACH, the CVIU-shaped INI files, as phase 14zh
    runs it) on zoom2x's pair as 1-byte McIdas area files: the JAX
    command's rung and verified count within 20 %
    (``JAX_MCIDAS_REFERENCE``)."""
    from mods_tpu_torch import cli as tcli
    areas = []
    for i in (1, 2):
        view = np.asarray(Image.open(chip_smoke.PAIRS / f"zoom2x_{i}.png"))
        areas.append(tmp_path / f"zoom2x_{i}.area")
        areas[-1].write_bytes(mcidas_file(view))
        np.testing.assert_array_equal(_load_image(str(areas[-1])), view)
        np.testing.assert_array_equal(I.read_image(areas[-1]), view)
    (tmp_path / "iters.ini").write_text(chip_smoke.cviu_iters_ini())
    (tmp_path / "config.ini").write_text(chip_smoke.CVIU_CONFIG_INI)
    m = tmp_path / "m.txt"
    assert tcli.main(["match", *map(str, areas), "0", "0", "k1", "k2",
                      str(m), "0", "LORANSACH",
                      str(tmp_path / "config.ini"),
                      str(tmp_path / "iters.ini"), "--device", "cpu"]) == 0
    h, w = I.read_image(areas[0]).shape
    got = chip_smoke.match_figures(
        capsys.readouterr().out, str(m),
        np.loadtxt(chip_smoke.PAIRS / "zoom2x_H.txt"), w, h)
    ref = chip_smoke.JAX_MCIDAS_REFERENCE
    assert got["steps"] == ref["steps"], (got, ref)
    assert abs(got["matches"] - ref["matches"]) <= 0.2 * ref["matches"], \
        (got, ref)


def _jax_mcidas_main() -> None:
    """The JAX command on phase 14zh's pair: ``JAX_MCIDAS_REFERENCE``."""
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
        pair = []
        for i in (1, 2):
            view = np.asarray(Image.open(chip_smoke.PAIRS / f"zoom2x_{i}.png"))
            pair.append(td / f"zoom2x_{i}.area")
            pair[-1].write_bytes(mcidas_file(view))
        m = td / "m.txt"
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jcli.cmd_match([*map(str, pair), "0", "0", "k1", "k2",
                                   str(m), "0", "LORANSACH",
                                   str(td / "config.ini"),
                                   str(td / "iters.ini")]) == 0
        h, w = np.asarray(Image.open(pair[0])).shape
        figures = chip_smoke.match_figures(
            buf.getvalue(), str(m),
            np.loadtxt(chip_smoke.PAIRS / "zoom2x_H.txt"), w, h)
    print(json.dumps(dict(figures, seconds=round(time.time() - t0, 1))),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:] == ["--fixtures"]:
        for name, data in fixture_files().items():
            (chip_smoke.IMAGE_FIXTURES / name).write_bytes(data)
    elif sys.argv[1:] == ["--hashes"]:
        for name, data in sorted(fixture_files().items()):
            print(f"    {name!r}: {pil_entry(data)!r},")
        for o in (0, 1, 3):
            print(f"PCD {o}: "
                  f"{pil_entry(chip_smoke.pcd_file(chip_smoke.PCD_SEED + o, o))!r}")
    elif sys.argv[1:] == ["--jax-mcidas"]:
        _jax_mcidas_main()
