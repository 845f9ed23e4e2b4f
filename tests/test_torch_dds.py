"""Port vs PIL on DirectDraw Surface (DDS) files, read and written as the
JAX commands do through PIL (``np.asarray(Image.open(path))``,
``Image.fromarray(a).save(path)``, Pillow 12.1.0) (CPU).

PIL writes uncompressed files and ``pixel_format`` DXT1, DXT3, DXT5, BC2,
BC3 and BC5; the other block formats (BC4, BC5 signed, BC6H unsigned and
signed, BC7) and the uncompressed layouts PIL does not write (bit masks,
palettes, DX10's R8G8B8A8) are a hand-written header (``dds_file``) in
front of random blocks or pixels drawn with numpy from a seed.  Random
16-byte blocks reach every BC7 mode and partition and every BC6H mode
(``test_random_blocks_reach_every_mode``).

Tolerance: none.  ``io/image.py::_read`` must give PIL's array (dtype,
shape, every value) and mode, ``image_size`` its size, or raise a
ValueError where PIL fails; ``save_image(".dds")`` must write PIL's
bytes, or refuse what PIL refuses.
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
from PIL import Image  # noqa: E402

from test_torch_raster_formats import (MODES, arrays, hold_read,  # noqa
                                       hold_write)


def fourcc(s: bytes) -> int:
    return struct.unpack("<I", s)[0]


def dds_file(w: int, h: int, body: bytes, pfflags: int = 0x4,
             code: bytes = b"DX10", dxgi: int = 0, bitcount: int = 0,
             masks=(0, 0, 0, 0), palette: bytes = b"") -> bytes:
    """A DDS header (size 124) of the pixel format given, the DX10 header
    where the FourCC is DX10, a palette, then ``body``."""
    head = (b"DDS " + struct.pack("<7I", 124, 0x1007, h, w, 0, 0, 1)
            + bytes(44) + struct.pack("<4I", 32, pfflags, fourcc(code),
                                      bitcount)
            + struct.pack("<4I", *masks) + struct.pack("<5I", 0x1000, 0, 0,
                                                       0, 0))
    if pfflags & 0x4 and code == b"DX10":
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return head + palette + body


def blocks(w: int, h: int, size: int, seed: int) -> bytes:
    n = ((w + 3) // 4) * ((h + 3) // 4)
    return np.random.default_rng(seed).integers(
        0, 256, n * size, np.uint8).tobytes()


def hold(tmp_path, data: bytes, name="x.dds"):
    p = tmp_path / name
    p.write_bytes(data)
    hold_read(p)
    try:
        return np.asarray(Image.open(p))
    except Exception:
        return None


# the block formats: name -> (FourCC, DXGI format, block bytes)
BLOCK_FORMATS = {
    "DXT1": (b"DXT1", 0, 8), "DXT3": (b"DXT3", 0, 16),
    "DXT5": (b"DXT5", 0, 16), "BC4U": (b"BC4U", 0, 8),
    "ATI1": (b"ATI1", 0, 8), "BC5U": (b"BC5U", 0, 16),
    "ATI2": (b"ATI2", 0, 16), "BC5S": (b"BC5S", 0, 16),
    "BC1_TYPELESS": (b"DX10", 70, 8), "BC1_UNORM": (b"DX10", 71, 8),
    "BC2_TYPELESS": (b"DX10", 73, 16), "BC2_UNORM": (b"DX10", 74, 16),
    "BC3_TYPELESS": (b"DX10", 76, 16), "BC3_UNORM": (b"DX10", 77, 16),
    "BC4_TYPELESS": (b"DX10", 79, 8), "BC4_UNORM": (b"DX10", 80, 8),
    "BC5_TYPELESS": (b"DX10", 82, 16), "BC5_UNORM": (b"DX10", 83, 16),
    "BC5_SNORM": (b"DX10", 84, 16), "BC6H_UF16": (b"DX10", 95, 16),
    "BC6H_SF16": (b"DX10", 96, 16), "BC7_TYPELESS": (b"DX10", 97, 16),
    "BC7_UNORM": (b"DX10", 98, 16), "BC7_UNORM_SRGB": (b"DX10", 99, 16),
}


@pytest.mark.parametrize("name", sorted(BLOCK_FORMATS))
def test_random_blocks(tmp_path, name):
    """Every FourCC and DXGI block format PIL reads, under the legacy
    header and DX10's, on random blocks at 37 x 29 (edge blocks cut) and
    4 x 4 and 1 x 1."""
    code, dxgi, size = BLOCK_FORMATS[name]
    for seed, (w, h) in enumerate(((37, 29), (4, 4), (1, 1))):
        got = hold(tmp_path, dds_file(w, h, blocks(w, h, size, seed),
                                      code=code, dxgi=dxgi))
        assert got is not None and got.shape[:2] == (h, w)


def mode_blocks(kind: str, seed: int, n: int = 4096) -> bytes:
    """``n`` random 16-byte blocks whose mode bits cycle through every
    mode: BC7's 8 (the first set bit) or BC6H's 18 codes (2 and 5 bits,
    the 4 reserved ones included); every other bit random."""
    raw = np.random.default_rng(seed).integers(0, 256, (n, 16), np.int64)
    k = np.arange(n)
    if kind == "BC7":
        m = k % 8
        raw[:, 0] = ((raw[:, 0] << (m + 1)) | (1 << m)) & 0xFF
    else:
        codes = np.array([0, 1] + [2 + 4 * i for i in range(8)]
                         + [3 + 4 * i for i in range(8)])[k % 18]
        low = np.where(codes < 2, 2, 5)
        raw[:, 0] = ((raw[:, 0] >> low) << low) | codes
    return raw.astype(np.uint8).tobytes()


@pytest.mark.parametrize("kind", ["BC6H_UF16", "BC6H_SF16", "BC7_UNORM"])
def test_many_random_blocks(tmp_path, kind):
    """4096 random blocks of every mode in one 256 x 256 image each."""
    code, dxgi, size = BLOCK_FORMATS[kind]
    hold(tmp_path, dds_file(256, 256, mode_blocks(kind[:3], 11),
                            code=code, dxgi=dxgi))


def _bc6_mode(b: int) -> int:
    m = b & 0x1F
    if m & 3 < 2:
        return m & 3
    return 2 + (m >> 2) if m & 3 == 2 else 10 + (m >> 2)


def test_random_blocks_reach_every_mode():
    """The blocks of ``test_many_random_blocks`` reach every BC7 mode and
    every partition of the modes with partitions, and every BC6H mode
    (reserved ones included) and partition."""
    seen7, seen6 = set(), set()
    for blk in np.frombuffer(mode_blocks("BC7", 11), np.uint8).reshape(-1, 16):
        b = int(blk[0])
        mode = (b & -b).bit_length() - 1
        bits = int.from_bytes(blk.tobytes(), "little") >> (mode + 1)
        pb = {0: 4, 1: 6, 2: 6, 3: 6, 7: 6}.get(mode, 0)
        seen7.add((mode, bits & ((1 << pb) - 1)))
    assert {m for m, _ in seen7} == set(range(8))
    for mode, pb in ((0, 4), (1, 6), (2, 6), (3, 6), (7, 6)):
        assert {p for m, p in seen7 if m == mode} == set(range(1 << pb))
    for blk in np.frombuffer(mode_blocks("BC6", 11), np.uint8).reshape(-1, 16):
        mode = _bc6_mode(int(blk[0]))
        bits = int.from_bytes(blk.tobytes(), "little")
        seen6.add((mode, bits >> 77 & 31 if mode < 10 else 0))
    assert {m for m, _ in seen6} == set(range(18))
    for mode in range(10):
        assert {p for m, p in seen6 if m == mode} == set(range(32))


@pytest.mark.parametrize("pixel_format", ["DXT1", "DXT3", "DXT5", "BC2",
                                          "BC3", "BC5"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_pils_block_files(tmp_path, pixel_format, mode):
    """PIL's own DXT1/3/5 and BC2/3/5 saves (BC5 of RGB only) of blocky
    noise at 37 x 29."""
    f = io.BytesIO()
    try:
        Image.fromarray(arrays(4, 29, 37)[mode]).save(
            f, "DDS", pixel_format=pixel_format)
    except OSError:
        assert pixel_format == "BC5" and mode == "RGBA"
        return
    assert hold(tmp_path, f.getvalue()) is not None


MASKED = {
    "rgb24": (24, (0xFF0000, 0xFF00, 0xFF)),
    "bgr24": (24, (0xFF, 0xFF00, 0xFF0000)),
    "rgb565": (16, (0xF800, 0x7E0, 0x1F)),
    "rgb555": (16, (0x7C00, 0x3E0, 0x1F)),
    "xrgb32": (32, (0xFF0000, 0xFF00, 0xFF)),
    "zero_mask": (32, (0xFF0000, 0, 0xFF)),
    "padded_2bit": (8, (0x3, 0xC, 0x30)),
    "argb32": (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
    "argb4444": (16, (0xF00, 0xF0, 0xF, 0xF000)),
    "argb1555": (16, (0x7C00, 0x3E0, 0x1F, 0x8000)),
    "rgba_high": (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
}


@pytest.mark.parametrize("case", sorted(MASKED))
def test_bit_masks(tmp_path, case):
    """Uncompressed RGB and RGBA by their bit masks (DdsRgbDecoder: the
    value shifted down and scaled to 255 over the mask's largest, a zero
    mask 0), full and with the last pixels missing (read as zeros)."""
    bitcount, masks = MASKED[case]
    alpha = len(masks) == 4
    body = np.random.default_rng(7).integers(
        0, 256, 23 * 17 * bitcount // 8, np.uint8).tobytes()
    for cut in (0, 5):
        data = dds_file(23, 17, body[:len(body) - cut],
                        0x40 | (0x1 if alpha else 0), code=b"\0\0\0\0",
                        bitcount=bitcount, masks=tuple(masks) + (0,) * (
                            4 - len(masks)))
        assert hold(tmp_path, data) is not None


@pytest.mark.parametrize("case", ["L", "LA", "P", "R8G8B8A8",
                                  "R8G8B8A8_SRGB"])
def test_raw_layouts(tmp_path, case):
    """Luminance at 8 and 16 bits (with alpha), palette indices after a
    1024-byte palette, DX10's R8G8B8A8 (unorm and sRGB)."""
    a = arrays(9, 19, 21)
    data = {
        "L": dds_file(21, 19, a["L"].tobytes(), 0x20000, code=b"\0\0\0\0",
                      bitcount=8),
        "LA": dds_file(21, 19, a["LA"].tobytes(), 0x20001,
                       code=b"\0\0\0\0", bitcount=16),
        "P": dds_file(21, 19, a["L"].tobytes(), 0x20, code=b"\0\0\0\0",
                      bitcount=8, palette=bytes(range(256)) * 4),
        "R8G8B8A8": dds_file(21, 19, a["RGBA"].tobytes(), dxgi=28),
        "R8G8B8A8_SRGB": dds_file(21, 19, a["RGBA"].tobytes(), dxgi=29),
    }[case]
    assert hold(tmp_path, data) is not None


REFUSED = {
    "header_size": lambda: b"DDS " + struct.pack("<I", 100) + dds_file(
        4, 4, bytes(8), code=b"DXT1")[8:],
    "incomplete_header": lambda: dds_file(4, 4, b"", code=b"DXT1")[:100],
    "unknown_fourcc": lambda: dds_file(4, 4, bytes(16), code=b"DXT2"),
    "unknown_dxgi": lambda: dds_file(4, 4, bytes(16), dxgi=72),
    "luminance_24": lambda: dds_file(4, 4, bytes(48), 0x20000,
                                     code=b"\0\0\0\0", bitcount=24),
    "no_flags": lambda: dds_file(4, 4, bytes(48), 0, code=b"\0\0\0\0"),
    "truncated_blocks": lambda: dds_file(8, 8, bytes(40), code=b"DXT5"),
    "truncated_raw": lambda: dds_file(8, 8, bytes(40), 0x20000,
                                      code=b"\0\0\0\0", bitcount=8),
    "short_dx10": lambda: dds_file(4, 4, b"", dxgi=71)[:130],
    "decompression_bomb": lambda: dds_file(20000, 10000, b"", code=b"DXT1"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals(tmp_path, case):
    """PIL's failures, each a ValueError here: a header size other than
    124 or a header cut short, an unknown FourCC or DXGI format (PIL's
    NotImplementedError), luminance of 24 bits, no pixel format flags,
    block or raw data cut short, a DX10 header cut short, a size over
    twice PIL's pixel limit (its decompression bomb check)."""
    data = REFUSED[case]()
    p = tmp_path / "x.dds"
    p.write_bytes(data)
    with pytest.raises(Exception):
        np.asarray(Image.open(p))
    assert hold(tmp_path, data) is None


@pytest.mark.parametrize("mode", MODES)
def test_writer_bytes_are_pils(tmp_path, mode):
    """``save_image(".dds")`` writes PIL's default save byte for byte in
    RGB, RGBA, L and LA (at 1 x 1, 3 x 5, 17 x 70 and 64 x 7) and refuses
    the other modes with PIL's reason."""
    for seed, (h, w) in enumerate(((1, 1), (3, 5), (17, 70), (64, 7))):
        hold_write(tmp_path, "x.dds", arrays(seed, h, w)[mode])


# ---------------------------------------------------------------------------
# chip_smoke.py phase 14za's fixtures

def fixture_files() -> dict:
    """The DDS files of ``chip_smoke.PSD_DDS_ICNS_FIXTURES``: PIL's saves
    of seeded arrays (uncompressed and its block formats) and ``dds_file``'s
    of what PIL does not write, each small."""
    a = arrays(20, 47, 61)

    def pil(arr, **kw):
        f = io.BytesIO()
        Image.fromarray(arr).save(f, "DDS", **kw)
        return f.getvalue()
    masks = (0xF800, 0x7E0, 0x1F, 0)
    body565 = np.random.default_rng(22).integers(0, 256, 47 * 61 * 2,
                                                 np.uint8).tobytes()
    return {
        "dds_rgb.dds": pil(a["RGB"]), "dds_rgba.dds": pil(a["RGBA"]),
        "dds_la.dds": pil(a["LA"]),
        "dds_dxt1.dds": pil(a["RGBA"], pixel_format="DXT1"),
        "dds_dxt3.dds": pil(a["RGBA"], pixel_format="DXT3"),
        "dds_dxt5.dds": pil(a["RGBA"], pixel_format="DXT5"),
        "dds_bc5.dds": pil(a["RGB"], pixel_format="BC5"),
        "dds_bc4.dds": dds_file(61, 47, blocks(61, 47, 8, 23),
                                code=b"BC4U"),
        "dds_bc6h_uf16.dds": dds_file(64, 64, mode_blocks("BC6", 24, 256),
                                      dxgi=95),
        "dds_bc6h_sf16.dds": dds_file(64, 64, mode_blocks("BC6", 25, 256),
                                      dxgi=96),
        "dds_bc7.dds": dds_file(64, 64, mode_blocks("BC7", 26, 256),
                                dxgi=98),
        "dds_rgb565.dds": dds_file(61, 47, body565, 0x40, code=b"\0\0\0\0",
                                   bitcount=16, masks=masks),
    }


def test_dds_fixtures_are_written_here():
    """Phase 14za's DDS fixtures: under 100 KB in all."""
    from test_torch_psd_dcx_fits import hold_fixtures
    hold_fixtures(fixture_files(), 100_000)


if __name__ == "__main__":
    if sys.argv[1:] == ["--fixtures"]:
        import chip_smoke
        for name, data in fixture_files().items():
            (chip_smoke.IMAGE_FIXTURES / name).write_bytes(data)
    else:
        sys.exit("usage: python tests/test_torch_dds.py --fixtures")
