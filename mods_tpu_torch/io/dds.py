"""DirectDraw Surface (DDS) files as PIL 12.1.0 reads and writes them for
the JAX commands (``Image.open``, ``Image.fromarray(a).save``;
DdsImagePlugin).

``read_dds(data, path)`` returns PIL's array and mode, ``dds_header`` the
size and mode ``Image.open`` reports, ``dds_bytes(a, mode)`` the bytes of
PIL's default save.  DdsImageFile._open's steps:

* the 124-byte header (its size must be 124 and whole) and the pixel
  format's flags, checked in PIL's order:
  - RGB: "RGBA" with the alpha flag, else "RGB", each channel read from
    ``bitcount / 8`` little-endian bytes a pixel by its mask, shifted
    down and scaled by 255 over the mask's largest value (PIL's
    DdsRgbDecoder; past the end of the file it reads zeros);
  - luminance: "L" at 8 bits, "LA" at 16 with the alpha flag;
  - palette indices ("P", after a 1024-byte palette);
  - a FourCC: DXT1, DXT3, DXT5, BC4U/ATI1, BC5S, BC5U/ATI2, or DX10 and
    its DXGI format (BC1-BC5 typeless and unorm, BC5 snorm, BC6H UF16
    and SF16, BC7 typeless, unorm and sRGB, R8G8B8A8), the blocks
    decoded by ``csrc/bcn_decode.cpp`` (Pillow's BcnDecode.c);
  anything else raises PIL's NotImplementedError or OSError, with its
  message;
* the pixels start right after the header (and the palette, and the DX10
  header): PIL's loader never seeks to a tile's offset.

Writing is PIL's save without options: uncompressed, "RGB" as BGR and
"RGBA" as BGRA under the RGB flag, "L" and "LA" under the luminance
flag, with PIL's masks and pitch; other modes raise as PIL refuses them.
PIL's BCn encoders (``pixel_format=...``) are not needed: the commands
pass no options.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BCN_SOURCE = os.path.join(_PKG, "csrc", "bcn_decode.cpp")

# DDPF flags
_ALPHAPIXELS, _FOURCC, _PALETTE8, _RGB, _LUMINANCE = (0x1, 0x4, 0x20, 0x40,
                                                      0x20000)


def _fourcc(s: bytes) -> int:
    return struct.unpack("<I", s)[0]


# FourCC -> (mode, bcn kind, signed), DdsImageFile._open's branches
_FOURCCS = {_fourcc(b"DXT1"): ("RGBA", 1, 0), _fourcc(b"DXT3"): ("RGBA", 2, 0),
            _fourcc(b"DXT5"): ("RGBA", 3, 0), _fourcc(b"BC4U"): ("L", 4, 0),
            _fourcc(b"ATI1"): ("L", 4, 0), _fourcc(b"BC5S"): ("RGB", 5, 1),
            _fourcc(b"BC5U"): ("RGB", 5, 0), _fourcc(b"ATI2"): ("RGB", 5, 0)}
_DX10 = _fourcc(b"DX10")
# DXGI format -> (mode, bcn kind, signed); kind 0 is raw RGBA
_DXGI = {70: ("RGBA", 1, 0), 71: ("RGBA", 1, 0), 73: ("RGBA", 2, 0),
         74: ("RGBA", 2, 0), 76: ("RGBA", 3, 0), 77: ("RGBA", 3, 0),
         79: ("L", 4, 0), 80: ("L", 4, 0), 82: ("RGB", 5, 0),
         83: ("RGB", 5, 0), 84: ("RGB", 5, 1), 95: ("RGB", 6, 0),
         96: ("RGB", 6, 1), 97: ("RGBA", 7, 0), 98: ("RGBA", 7, 0),
         99: ("RGBA", 7, 0), 27: ("RGBA", 0, 0), 28: ("RGBA", 0, 0),
         29: ("RGBA", 0, 0)}


@functools.lru_cache(maxsize=1)
def _bcn_lib():
    from mods_tpu_torch.detectors.mser import build_native
    # the BC6H half floats are Pillow's float arithmetic, unfused
    lib = ctypes.CDLL(build_native(BCN_SOURCE, "libmods_bcn.so",
                                   ("-ffp-contract=off",)))
    lib.mods_bcn_decode.restype = ctypes.c_int
    lib.mods_bcn_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
    return lib


def dds_header(data: bytes, path) -> dict:
    """DdsImageFile._open: the size, the mode, how the pixels are stored
    and where they start."""
    if len(data) < 8:
        raise ValueError(f"{path}: cannot identify image file (a DDS "
                         f"header that ends early)")
    header_size = struct.unpack_from("<I", data, 4)[0]
    if header_size != 124:
        raise ValueError(f"{path}: Unsupported header size {header_size!r}")
    header = data[8:128]
    if len(header) != 120:
        raise ValueError(f"{path}: Incomplete header: {len(header)} bytes")
    _, height, width = struct.unpack_from("<3I", header)
    pfflags, fourcc, bitcount = struct.unpack_from("<3I", header, 72)
    out = dict(size=(width, height), offset=128, kind=0, sign=0)
    if pfflags & _RGB:
        alpha = bool(pfflags & _ALPHAPIXELS)
        out.update(mode="RGBA" if alpha else "RGB", bitcount=bitcount,
                   masks=struct.unpack_from(f"<{4 if alpha else 3}I",
                                            header, 84))
    elif pfflags & _LUMINANCE:
        if bitcount == 8:
            out["mode"] = "L"
        elif bitcount == 16 and pfflags & _ALPHAPIXELS:
            out["mode"] = "LA"
        else:
            raise ValueError(f"{path}: Unsupported bitcount {bitcount} for "
                             f"{pfflags}")
    elif pfflags & _PALETTE8:
        out.update(mode="P", offset=128 + 1024)
    elif pfflags & _FOURCC:
        if fourcc in _FOURCCS:
            out["mode"], out["kind"], out["sign"] = _FOURCCS[fourcc]
        elif fourcc == _DX10:
            if len(data) < 132:
                raise ValueError(f"{path}: cannot identify image file (a "
                                 f"DX10 header that ends early)")
            dxgi = struct.unpack_from("<I", data, 128)[0]
            if dxgi not in _DXGI:
                raise ValueError(f"{path}: Unimplemented DXGI format {dxgi} "
                                 f"(PIL's NotImplementedError)")
            out["mode"], out["kind"], out["sign"] = _DXGI[dxgi]
            out["offset"] = 148
        else:
            raise ValueError(f"{path}: Unimplemented pixel format "
                             f"{fourcc!r} (PIL's NotImplementedError)")
    else:
        raise ValueError(f"{path}: Unknown pixel format flags {pfflags} "
                         f"(PIL's NotImplementedError)")
    return out


def _masked(body: bytes, w: int, h: int, bitcount: int,
            masks: tuple) -> np.ndarray:
    """DdsRgbDecoder: each pixel's ``bitcount // 8`` bytes as a
    little-endian value, each mask's bits shifted down and scaled to
    0..255 (truncated), zeros past the end of the data."""
    step = bitcount // 8
    n = w * h
    raw = np.zeros(n * step, np.uint8)
    got = np.frombuffer(body[:n * step], np.uint8)
    raw[:len(got)] = got
    v = np.zeros(n, np.uint64)
    for k in range(step):
        v |= raw[k::step].astype(np.uint64) << np.uint64(8 * k)
    out = []
    for mask in masks:
        shift = (mask & -mask).bit_length() - 1 if mask else 0
        total = mask >> shift
        if not total:
            out.append(np.zeros(n, np.uint8))
            continue
        x = (v & np.uint64(mask)) >> np.uint64(shift)
        out.append((x.astype(np.float64) / total * 255).astype(np.uint8))
    return np.stack(out, -1).reshape(h, w, len(masks))


def read_dds(data: bytes, path) -> tuple[np.ndarray, str]:
    """``np.asarray(Image.open(path))`` of a DDS file and its mode."""
    hd = dds_header(data, path)
    (w, h), mode, kind = hd["size"], hd["mode"], hd["kind"]
    body = data[hd["offset"]:]
    if "masks" in hd:
        return _masked(body, w, h, hd["bitcount"], hd["masks"]), mode
    bands = {"L": 1, "P": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    if kind == 0:
        if len(body) < w * h * bands:
            raise ValueError(f"{path}: image file is truncated")
        a = np.frombuffer(body[:w * h * bands], np.uint8)
    else:
        a = np.empty(w * h * bands, np.uint8)
        if _bcn_lib().mods_bcn_decode(body, len(body), kind, hd["sign"], w, h,
                                      a.ctypes.data):
            raise ValueError(f"{path}: image file is truncated")
    return a.reshape((h, w, bands) if bands > 1 else (h, w)), mode


def dds_bytes(a: np.ndarray, mode: str) -> bytes:
    """PIL's DDS without options (DdsImagePlugin._save)."""
    if mode not in ("RGB", "RGBA", "L", "LA"):
        raise ValueError(f"cannot write mode {mode} as DDS")
    h, w = a.shape[:2]
    bitcount = 8 * len(mode)
    alpha = mode[-1] == "A"
    if mode[0] == "L":
        flags = _LUMINANCE
        masks = [0xFF] * 3 if alpha else [0xFF000000] * 3
        px = a
    else:
        flags = _RGB
        masks = [0xFF0000, 0xFF00, 0xFF]
        px = a[..., [2, 1, 0, 3][:a.shape[2]]]
    if alpha:
        flags |= _ALPHAPIXELS
    masks.append(0xFF000000 if alpha else 0)
    head = (b"DDS " + struct.pack("<7I", 124, 0x100F, h, w,
                                  (w * bitcount + 7) // 8, 0, 0)
            + bytes(44) + struct.pack("<4I", 32, flags, 0, bitcount)
            + struct.pack("<4I", *masks)
            + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    return head + np.ascontiguousarray(px, np.uint8).tobytes()
