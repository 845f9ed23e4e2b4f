"""Port vs PIL on Apple icon (ICNS) files, read and written as the JAX
commands do through PIL (``np.asarray(Image.open(path))``,
``Image.fromarray(a).save(path)``, Pillow 12.1.0) (CPU), and on the
bicubic resize the writer runs (``io/raster.py::resize_bicubic``,
``csrc/resample.cpp``).

PIL writes ICNS files of PNG entries; the entries it reads and does not
write (RLE ``it32``/``ih32``/``il32``/``is32`` with their ``*8mk`` masks,
uncompressed RGB, JPEG 2000) are built here (``icns_file``,
``icns_rle``).  The arrays come from a seeded numpy generator.

Tolerance: none.  ``io/image.py::_read`` must give PIL's array (dtype,
shape, every value) and mode, or raise where PIL fails: PIL's array of an
ICNS whose largest image is "RGB" is its RGBX bytes read as RGB, and of
one in any mode but "RGB" and "RGBA" fails ("No packer found").  The
port's ICNS is held by what PIL reads from it: the same entries, the same
``info["sizes"]``, size and mode, and every frame bit for bit as PIL
reads them from its own save.  Its PNG payloads are not Pillow's bytes
(zlib-ng), as for ICO (``test_png_payloads_are_pils_arrays_not_pils_bytes``).
"""

import io
import os
import struct
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytest  # noqa: E402
from PIL import IcnsImagePlugin, Image  # noqa: E402

from mods_tpu_torch.io import icns, raster  # noqa: E402
from mods_tpu_torch.io import image as I  # noqa: E402
from test_torch_raster_formats import MODES, arrays, hold_read  # noqa: E402


def pil_bytes(a, fmt: str, **kw) -> bytes:
    f = io.BytesIO()
    (a if isinstance(a, Image.Image) else Image.fromarray(a)).save(f, fmt,
                                                                   **kw)
    return f.getvalue()


def hold(tmp_path, data: bytes, name="x.icns"):
    p = tmp_path / name
    p.write_bytes(data)
    hold_read(p)
    try:
        return np.asarray(Image.open(p))
    except Exception:
        return None


# ---------------------------------------------------------------------------
# the bicubic resize

@pytest.mark.parametrize("mode", MODES)
def test_bicubic_equals_pillow(mode):
    """``resize_bicubic`` is ``Image.fromarray(a).resize(size)`` (BICUBIC,
    nearest neighbour for "1", "LA" and "RGBA" premultiplied) bit for bit
    in every mode of ``_mode``, up and down, to squares and not; and
    ``resizer`` gives the same from one premultiplied source."""
    a = arrays(1, 37, 53)[mode]
    resize = raster.resizer(a, mode, "bicubic")
    for size in ((32, 32), (64, 64), (128, 128), (1024, 1024), (53, 20),
                 (7, 90), (53, 37)):
        want = np.asarray(Image.fromarray(a).resize(size))
        got = raster.resize_bicubic(a, mode, size)
        assert got.dtype == want.dtype and got.shape == want.shape, size
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(resize(size), want)


def test_lanczos_resizer_premultiplies_once(monkeypatch):
    """``resizer`` premultiplies an RGBA source once for all of an ICO's
    sizes, and gives each size's ``resize_lanczos`` bits."""
    a = arrays(2, 61, 67)["RGBA"]
    calls = []
    premultiply = raster._premultiply
    monkeypatch.setattr(raster, "_premultiply",
                        lambda x: calls.append(1) or premultiply(x))
    frames = raster.ico_frames(a, "RGBA")
    assert len(calls) == 1 and len(frames) == 4
    monkeypatch.setattr(raster, "_premultiply", premultiply)
    for f in frames:
        want = np.asarray(Image.fromarray(a).resize(f.shape[1::-1],
                                                    Image.Resampling.LANCZOS))
        np.testing.assert_array_equal(f, want)


# ---------------------------------------------------------------------------
# writing

def pil_entries(data: bytes) -> dict:
    """What PIL reads from an ICNS file: the entry types, ``info["sizes"]``,
    the size and mode Image.open shows, and each size's frame (array and
    mode) as IcnsFile.dataforsize gives it."""
    f = IcnsImagePlugin.IcnsFile(io.BytesIO(data))
    im = Image.open(io.BytesIO(data))
    frames = {}
    for size in f.itersizes():
        for channel, frame in f.dataforsize(size).items():
            frame.load()
            frames[size, channel] = (frame.mode, np.asarray(frame))
    return dict(types=sorted(f.dct), sizes=im.info["sizes"], size=im.size,
                mode=im.mode, frames=frames)


def hold_icns_write(tmp_path, a: np.ndarray) -> None:
    """PIL reads from ``save_image``'s ICNS of ``a`` what it reads from its
    own, frame by frame; or both refuse the array."""
    pils, ours = tmp_path / "pil.icns", tmp_path / "port.icns"
    try:
        Image.fromarray(a).save(pils)
    except (OSError, ValueError) as e:
        with pytest.raises(ValueError) as got:
            I.save_image(ours, a)
        assert str(e) in str(got.value)
        return
    I.save_image(ours, a)
    want, got = pil_entries(pils.read_bytes()), pil_entries(ours.read_bytes())
    assert got["types"] == want["types"]
    assert (got["sizes"], got["size"], got["mode"]) == (
        want["sizes"], want["size"], want["mode"])
    assert got["frames"].keys() == want["frames"].keys()
    for key, (mode, arr) in want["frames"].items():
        assert got["frames"][key][0] == mode, key
        np.testing.assert_array_equal(got["frames"][key][1], arr)
    hold_read(ours)


@pytest.mark.parametrize("mode", MODES)
def test_writer_frames_are_pils(tmp_path, mode):
    """Every mode of ``_mode`` at 64 x 64, 37 x 53 (squashed to squares)
    and 1 x 1: eight entries of six sizes, each frame PIL's bicubic
    resize as PIL's own file holds it ("F" refused as PNG refuses it)."""
    for seed, (h, w) in enumerate(((64, 64), (37, 53), (1, 1))):
        hold_icns_write(tmp_path, arrays(seed, h, w)[mode])


def test_png_payloads_are_pils_arrays_not_pils_bytes(tmp_path):
    """The port's PNG payloads are ``io/png.py``'s (filter 0, CPython's
    zlib), not Pillow's zlib-ng bytes: the files differ, and each entry
    decodes to PIL's frame; the table of contents lists each entry's own
    length."""
    a = arrays(3, 64, 64)["RGBA"]
    pils = pil_bytes(a, "ICNS")
    I.save_image(tmp_path / "x.icns", a)
    ours = (tmp_path / "x.icns").read_bytes()
    assert ours != pils
    assert struct.unpack(">i", ours[4:8])[0] == len(ours)
    toc = ours[16:16 + 64]
    entries = icns.icns_entries(ours, "x")
    for k in range(8):
        code, length = struct.unpack_from(">4si", toc, 8 * k)
        assert entries[code][1] == length - 8
    for code, (start, length) in entries.items():
        if code == b"TOC ":
            continue
        want = IcnsImagePlugin.read_png_or_jpeg2000(
            io.BytesIO(pils), icns_entry(pils, code), None)["RGBA"]
        got = Image.open(io.BytesIO(ours[start:start + length]))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def icns_entry(data: bytes, code: bytes) -> tuple:
    return IcnsImagePlugin.IcnsFile(io.BytesIO(data)).dct[code]


# ---------------------------------------------------------------------------
# reading

def icns_file(entries: list) -> bytes:
    """An ICNS file of (type, data) entries in order."""
    body = b"".join(code + struct.pack(">I", 8 + len(d)) + d
                    for code, d in entries)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def icns_rle(band: np.ndarray) -> bytes:
    """One band in ICNS RLE: runs of 3 to 130 as 0x80 + n - 3 and the
    byte, the rest as literals of 1 to 128 (n - 1 and the bytes)."""
    v, out, i = band.ravel().tobytes(), bytearray(), 0
    lit = bytearray()

    def flush():
        while lit:
            out.append(min(len(lit), 128) - 1)
            out.extend(lit[:128])
            del lit[:128]
    while i < len(v):
        j = i
        while j < len(v) and v[j] == v[i] and j - i < 130:
            j += 1
        if j - i >= 3:
            flush()
            out += bytes([0x80 + j - i - 3, v[i]])
            i = j
        else:
            lit.append(v[i])
            i += 1
    flush()
    return bytes(out)


def rle_entry(rgb: np.ndarray) -> bytes:
    return b"".join(icns_rle(rgb[..., c]) for c in range(3))


@pytest.mark.parametrize("case", ["it32", "ih32", "il32", "is32",
                                  "it32_no_mask", "il32_raw", "is32_raw_mask",
                                  "all_rle", "png_and_rle"])
def test_rle_entries(tmp_path, case):
    """The old RLE entries (it32 after its 4 zero bytes), with their
    masks as alpha (RGBA) or without (RGB, whose array is PIL's RGBX
    bytes read as RGB), uncompressed RGB where the length is 3 bytes a
    pixel, several sizes (the largest shown), a PNG beside an RLE entry
    of the same size (the PNG wins)."""
    rng = np.random.default_rng(4)
    def pic(s):
        return np.repeat(rng.integers(0, 256, (s, s // 4, 3), np.uint8), 4, 1)
    def mask(s):
        return rng.integers(0, 256, (s, s), np.uint8).tobytes()
    entries = {
        "it32": [(b"it32", bytes(4) + rle_entry(pic(128))),
                 (b"t8mk", mask(128))],
        "ih32": [(b"ih32", rle_entry(pic(48))), (b"h8mk", mask(48))],
        "il32": [(b"il32", rle_entry(pic(32))), (b"l8mk", mask(32))],
        "is32": [(b"s8mk", mask(16)), (b"is32", rle_entry(pic(16)))],
        "it32_no_mask": [(b"it32", bytes(4) + rle_entry(pic(128)))],
        "il32_raw": [(b"il32", pic(32).tobytes())],
        "is32_raw_mask": [(b"is32", pic(16).tobytes()), (b"s8mk", mask(16))],
        "all_rle": [(b"is32", rle_entry(pic(16))), (b"s8mk", mask(16)),
                    (b"il32", rle_entry(pic(32))), (b"l8mk", mask(32)),
                    (b"ih32", rle_entry(pic(48))), (b"h8mk", mask(48))],
        "png_and_rle": [(b"il32", rle_entry(pic(32))), (b"l8mk", mask(32)),
                        (b"icp5", pil_bytes(arrays(1, 32, 32)["RGBA"],
                                            "PNG"))],
    }[case]
    assert hold(tmp_path, icns_file(entries)) is not None


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
@pytest.mark.parametrize("fmt", ["j2k", "jp2"])
def test_jpeg2000_entries(tmp_path, mode, fmt):
    """JPEG 2000 entries (a codestream or a JP2 file, PIL's own saves),
    converted to RGBA as PIL converts them."""
    a = arrays(6, 32, 32)[mode]
    data = pil_bytes(a, "JPEG2000", no_jp2=fmt == "j2k")
    assert hold(tmp_path, icns_file([(b"icp5", data)])) is not None


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "1", "I;16",
                                  "P"])
def test_pils_own_files(tmp_path, mode):
    """PIL's ICNS saves read back: RGBA as itself, RGB as PIL's RGBX bytes
    read as RGB, the other modes refused as PIL fails on them ("No
    packer found"); a palette PNG entry likewise."""
    a = arrays(7, 40, 40)["RGB" if mode == "P" else mode]
    img = Image.fromarray(a)
    if mode == "P":
        img = img.convert("P", palette=Image.Palette.ADAPTIVE, colors=16)
    got = hold(tmp_path, pil_bytes(img, "ICNS"))
    assert (got is not None) == (mode in ("RGB", "RGBA"))


REFUSED = {
    "no_resources": lambda: icns_file([(b"TOC ", bytes(8))]),
    "unsupported_subimage": lambda: icns_file([(b"ic07", bytes(64))]),
    "it32_signature": lambda: icns_file([(b"it32", b"\x01\x02\x03\x04"
                                          + bytes(64))]),
    "rle_overrun": lambda: icns_file([(b"is32", b"\xff\x01" * 300)]),
    "rle_short": lambda: icns_file([(b"is32", b"\x7f" + bytes(128))]),
    "mask_only": lambda: icns_file([(b"s8mk", bytes(256))]),
    "mask_short": lambda: icns_file([(b"is32", bytes(768)),
                                     (b"s8mk", bytes(100))]),
    "empty_block": lambda: b"icns" + struct.pack(">I", 24)
    + b"is32" + struct.pack(">I", 0) + bytes(8),
    "truncated_header": lambda: b"icns" + struct.pack(">I", 64) + b"is3",
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals(tmp_path, case):
    """PIL's failures, each a ValueError here: no icon resources, an entry
    that is neither PNG nor JPEG 2000, it32 without its zero signature,
    RLE that runs past a band or ends short, a mask without an image, a
    short mask, a block length of 0, a header cut short."""
    data = REFUSED[case]()
    with pytest.raises(Exception):
        np.asarray(Image.open(io.BytesIO(data)))
    assert hold(tmp_path, data) is None


# ---------------------------------------------------------------------------
# chip_smoke.py phase 14za's fixtures and 14zb's hashes

def fixture_files() -> dict:
    """The ICNS files of ``chip_smoke.PSD_DDS_ICNS_FIXTURES``, built from
    small sizes: PNG entries (RGBA, and RGB, whose array is PIL's RGBX
    bytes), RLE entries with masks, a JPEG 2000 entry."""
    a = arrays(20, 64, 64)
    rgba = a["RGBA"]
    return {
        "icns_png.icns": icns_file([
            (b"icp4", pil_bytes(rgba[:16, :16], "PNG")),
            (b"icp5", pil_bytes(rgba[:32, :32], "PNG")),
            (b"icp6", pil_bytes(rgba, "PNG"))]),
        "icns_png_rgb.icns": icns_file([
            (b"icp5", pil_bytes(a["RGB"][:32, :32], "PNG"))]),
        "icns_rle.icns": icns_file([
            (b"is32", rle_entry(a["RGB"][:16, :16])),
            (b"s8mk", a["L"][:16, :16].tobytes()),
            (b"ih32", rle_entry(a["RGB"][:48, :48])),
            (b"h8mk", a["L"][:48, :48].tobytes())]),
        "icns_j2k.icns": icns_file([
            (b"icp4", pil_bytes(rgba[:16, :16], "PNG")),
            (b"icp5", pil_bytes(rgba[:32, :32], "JPEG2000"))]),
    }


def test_icns_fixtures_are_written_here():
    """Phase 14za's ICNS fixtures: under 60 KB in all."""
    from test_torch_psd_dcx_fits import hold_fixtures
    hold_fixtures(fixture_files(), 60_000)


def encode_hashes(tmp) -> tuple:
    """14zb's constants, from PIL's own saves of ``dds_icns_canvases``:
    {canvas: SHA-256 of the .dds}, {canvas: ((type, width, height,
    SHA-256 of the frame), ...) of the .icns's entries as PIL reads
    them}."""
    import hashlib
    import chip_smoke
    views = [np.asarray(Image.open(chip_smoke.PAIRS / f"{n}.png"))
             for n in ("zoom2x_1", "zoom2x_2", "tilt4_1")]
    sha, frames = {}, {}
    for name, canvas in chip_smoke.dds_icns_canvases(views).items():
        p = os.path.join(tmp, "c.dds")
        Image.fromarray(canvas).save(p)
        with open(p, "rb") as f:
            sha[name] = hashlib.sha256(f.read()).hexdigest()
        data = pil_bytes(canvas, "ICNS")
        f = IcnsImagePlugin.IcnsFile(io.BytesIO(data))
        out = []
        for code in f.dct:
            if code == b"TOC ":
                continue
            im = IcnsImagePlugin.read_png_or_jpeg2000(
                io.BytesIO(data), f.dct[code], None)["RGBA"]
            out.append((code.decode(), im.width, im.height,
                        chip_smoke._frame_sha256(np.asarray(im))))
        frames[name] = tuple(out)
    return sha, frames


def test_dds_icns_encode_hashes_are_pils(tmp_path):
    """Phase 14zb's hashes are PIL's; the port's files of the same
    canvases give them (its ICNS frames through the port's own reading of
    the entries)."""
    import hashlib
    import chip_smoke
    sha, frames = encode_hashes(tmp_path)
    assert sha == chip_smoke.DDS_ENCODE_SHA256
    assert frames == chip_smoke.ICNS_ENCODE_FRAMES
    views = [np.asarray(Image.open(chip_smoke.PAIRS / f"{n}.png"))
             for n in ("zoom2x_1", "zoom2x_2", "tilt4_1")]
    for name, canvas in chip_smoke.dds_icns_canvases(views).items():
        p = tmp_path / "x.dds"
        I.save_image(p, canvas)
        assert hashlib.sha256(p.read_bytes()).hexdigest() == sha[name]
        p = tmp_path / "x.icns"
        I.save_image(p, canvas)
        assert chip_smoke.icns_frames_of(p.read_bytes(), p) == frames[name]


if __name__ == "__main__":
    if sys.argv[1:] == ["--fixtures"]:
        import chip_smoke
        for name, data in fixture_files().items():
            (chip_smoke.IMAGE_FIXTURES / name).write_bytes(data)
    elif sys.argv[1:] == ["--hashes"]:
        import pprint
        import tempfile
        with tempfile.TemporaryDirectory() as td:
            for table in encode_hashes(td):
                pprint.pprint(table, width=76)
    else:
        sys.exit("usage: python tests/test_torch_icns.py --fixtures | "
                 "--hashes")
