"""Image files as the JAX package's commands read and write them.

The JAX commands read every image with ``np.asarray(Image.open(path))``
(``mods_tpu/cli.py::_load_image``) and write drawings with
``Image.fromarray(canvas).save(path)`` (``mods_tpu/viz.py::save_image``).
The card machine has no PIL, so the port reads and writes the formats
itself, with numpy, zlib and ctypes, and returns what PIL returns:

* ``read_image(path)``: the array of ``np.asarray(Image.open(path))``,
  the same dtype, shape and values, the format picked from the file's
  magic bytes as PIL picks it (``_read`` also gives PIL's mode):
  - PNG, every colour type, bit depth and Adam7 (``io/png.py``);
  - PNM (PIL's PpmImagePlugin): P1/P4 as bool with a set bit (black)
    False; P2/P5 as uint8, rescaled as value / maxval * 255 rounded half
    to even where maxval is not 255, and as int32 (PIL's "I", rescaled
    to 65535) where maxval > 255; P3/P6 as (H, W, 3) uint8, rescaled to
    255; PFM ("Pf") as float32 ("F"), rows bottom-up, little-endian
    where the scale is negative;
  - BMP (PIL's BmpImagePlugin), and DIB (a BMP without its file header,
    as PIL's DibImageFile reads it), uncompressed, RLE8, RLE4 or with the
    bitfield masks PIL reads: 1-, 4- and 8-bit palettes as indices
    ("P"), as bool ("1") or gray ("L") where the palette is black and
    white or the gray ramp; 16-bit 5-5-5 and 5-6-5 as RGB (each field
    scaled by 255 / its maximum, truncated); 24-bit and 32-bit (its
    fourth byte dropped unless a mask names alpha);
  - JPEG, baseline, progressive and lossless, Huffman- or
    arithmetic-coded, gray, YCbCr, RGB, CMYK (Adobe transform 0) and
    YCCK (any other transform), CMYK inverted as PIL inverts it, by
    ``csrc/jpeg_decode.cpp`` (libjpeg-turbo's default decode, which PIL
    runs), built with g++ at first use into
    ``mods_tpu_torch/_build/native/<machine>/``;
  - TIFF and little-endian BigTIFF (PIL's TiffImagePlugin, libtiff for
    the compressed files), the first page, by ``io/tiff.py``: every mode
    of PIL's OPEN_INFO (both byte orders, both fill orders, 1- to 32-bit
    samples, gray, palette, RGB, RGBA and associated alpha, CMYK, LAB,
    YCbCr), strips or tiles, both planar configurations as PIL reads
    them, the Orientation tag; no compression, CCITT modified Huffman,
    Group 3 and Group 4, tiff_raw_16, LZW (both bit orders), old-style
    JPEG (libtiff's tif_ojpeg.c), JPEG (with JPEGTables; YCbCr to RGB),
    Deflate, PackBits, LZMA, Zstandard and ThunderScan, predictors 2 and
    3 (``csrc/tiff_decode.cpp``, ``csrc/jpeg_decode.cpp``,
    ``csrc/zstd_decode.cpp``);
  - GIF (PIL's GifImagePlugin), the first frame: its palette indices
    ("P"), or "L" where the frame's palette is the identity gray ramp
    or missing; LZW (``csrc/tiff_decode.cpp``), interlaced or not,
    global or local palette;
  - WebP (PIL's WebPImagePlugin, libwebp's WebPAnimDecoder): lossy VP8
    key frames (either loop filter, one to eight token partitions),
    lossless VP8L, ALPH in every coding and filter, and the first frame
    of an animation on its zero-filled canvas, by
    ``csrc/webp_decode.cpp`` (built like the JPEG decoder); RGB, or RGBA
    where libwebp's WebPGetFeatures reports alpha (never "L");
  - JPEG 2000 (PIL's Jpeg2KImagePlugin on OpenJPEG 2.5's tile interface):
    a .j2k codestream or a .jp2 file, by ``csrc/j2k_decode.cpp`` (built
    like the others, with -ffp-contract=off): every marker, progression
    order, code-block style, the 5/3 and 9/7 wavelets, RCT and ICT,
    precisions of 1 to 16 bits, signed and subsampled components, tiles
    and offsets, decoded as OpenJPEG decodes them, then unpacked as
    Pillow's Jpeg2KDecode.c unpacks each tile ("L", "I;16", "LA", "RGB",
    "RGBA", "CMYK", "P" and "PA" from a pclr box, sYCC to RGB); PIL's
    mode and size from the header as the plugin reads them;
  - ICO, CUR, TGA, SGI, PCX, DCX (its first page) and QOI as their PIL
    plugins read them, by ``io/raster.py`` (a TGA, which has no signature,
    where no other format claims the file, as ``Image.open`` tries TGA
    last);
  - PSD (the composite image, every mode of PsdImagePlugin.MODES, raw
    and PackBits) by ``io/psd.py``; FITS (BITPIX 8, 16, 32, -32, -64,
    extensions, GZIP_1 tiles) by ``io/fits.py``; DDS (bit masks,
    luminance, palettes, DXT1-5 and BC1-BC7 under FourCC and DX10
    headers; ``csrc/bcn_decode.cpp``) by ``io/dds.py``; ICNS (PNG, JPEG
    2000 and RLE entries with their masks, the largest size, and PIL's
    array of it) by ``io/icns.py``;
  - IM (every "Image type" of ImImagePlugin.OPEN that Pillow can load,
    Luts, bottom-up rows) by ``io/im.py``, found by its text header as
    ``Image.open`` finds it (after ICO, before QOI); MSP (versions 1 and
    2) and Sun raster (every depth, colour maps, RLE) by ``io/raster.py``;
    XBM and XPM by ``io/x11.py``; BLP (BLP1 JPEG and palettes, BLP2
    palettes and DXT1/3/5 as the plugin decodes them) by ``io/blp.py``.
  Anything else that PIL opens (AVIF, EPS, SPIDER, GBR, ...) raises a
  ``ValueError`` naming the format, as do the variants the readers leave
  out (a VP8 inter frame,
  which PIL refuses too, and the TIFF compressions WebP, JBIG and JPEG
  2000, among them) and the files that PIL refuses (SGILog TIFFs, the
  JPEG 2000 files that OpenJPEG or Pillow fail on, hierarchical,
  arithmetic-coded lossless and 12-bit JPEGs, lossless JPEGs that name
  YCbCr or YCCK, arithmetic-coded data past PIL's reads among them,
  with PIL's reason).
* ``image_size(path)``: ``Image.open(path).size``, (width, height), from
  the header.
* ``save_image(path, array)``: the format that the extension names, as
  ``Image.fromarray(array).save(path)`` writes it: ``.png`` (bool as
  1-bit, uint8 gray, gray+alpha, RGB, RGBA, uint16 as 16-bit gray, int32
  clipped to 0..65535 as 16-bit gray); ``.pbm``/``.pgm``/``.ppm``/
  ``.pnm``/``.pfm`` (P4 for bool, P5 for uint8, P5 with maxval 65535 for
  uint16 and for int32 clipped to 0..65535, P6 for RGB and RGBA, PFM
  "Pf" for float); ``.bmp`` (bool, gray, RGB, RGBA) and ``.dib`` (the
  same without the 14-byte file header); ``.jpg``/``.jpeg``/``.jpe``/
  ``.jfif`` (bool and gray as one component, RGB as 4:2:0 YCbCr, quality
  75, by ``csrc/jpeg_encode.cpp``, byte for byte PIL's); ``.tif``/
  ``.tiff`` (PIL's uncompressed file, byte for byte: bool, gray,
  gray+alpha, RGB, RGBA, uint16, int32, float); ``.webp`` lossless
  (``csrc/webp_encode.cpp``) where PIL writes lossy VP8: the modes that
  PIL's ``WebPImagePlugin._convert_frame`` converts (bool, gray, uint16,
  int32 and float to RGB, clipped; gray+alpha to RGBA) and a file that
  PIL reads as it reads its own ``lossless=True`` save of the array;
  ``.gif`` byte for byte PIL's (GifImagePlugin's rules here, the
  quantiser and the LZW in ``csrc/gif_encode.cpp``, built like the
  others): bool and gray raw, RGB and RGBA through ``adaptive_palette``,
  the other modes converted to gray; ``.j2k`` (a codestream) and
  ``.jp2`` byte for byte PIL's default save through OpenJPEG 2.5.4
  (``csrc/j2k_encode.cpp``: one tile, one lossless layer, the 5/3
  wavelet, no component transform): gray, gray+alpha, RGB, RGBA and
  uint16 at 16 bits; a path that ends in ".j2k" (case and all, as
  Pillow tests it) is written as a codestream, every other (``.jp2``,
  ``.j2c``, ``.jpc``, ``.jpf``, ``.jpx``) as JP2, and bool, int32 and
  float raise as PIL refuses them; ``.mpo`` as ``.jpg`` (PIL's MPO save
  of one frame is its JPEG save); ``.ico`` (PIL's frames of each default
  size, Lanczos thumbnails, as PNG), ``.tga``/``.icb``/``.vda``/
  ``.vst``, ``.sgi``/``.bw``/``.rgb``/``.rgba``, ``.pcx`` and ``.qoi`` by
  ``io/raster.py``, PIL's bytes (an ICO's frames, not its PNG bytes);
  ``.dds`` (PIL's uncompressed save, byte for byte: gray, gray+alpha,
  RGB, RGBA) by ``io/dds.py``; ``.icns`` (eight PNG entries of six
  bicubic squares, PIL's frames, not its PNG bytes) by ``io/icns.py``;
  ``.im`` (PIL's bytes in every mode; the header names the file) by
  ``io/im.py``; ``.msp`` and ``.xbm`` (PIL's bytes of a bool array; every
  other mode refused as PIL refuses it) by ``io/raster.py`` and
  ``io/x11.py``; ``.blp`` refused for every array, as PIL writes BLP from
  mode "P" only; ``.pdf`` (one page: bool as CCITT Group 4 by
  ``csrc/fax4_encode.cpp``, gray and RGB as PIL's JPEG, gray+alpha and
  RGBA as its JP2; the file's stem as the title, the dates from
  ``time.gmtime()``) by ``io/pdf.py``, ``.eps`` and ``.ps`` (gray and RGB
  as hex) by ``io/eps.py`` and ``.palm`` (bool) by ``io/raster.py``, PIL's
  bytes.
  int8 arrays are PIL's unsigned "I;8" and uint32 arrays its "I;32",
  their bits as int32, in every format that writes "I".  Every other
  extension that PIL writes (``.avif``) and every array that PIL refuses
  to write in that format raise a ``ValueError`` naming them.
* ``adaptive_palette(array)``: the indices and the palette of
  ``Image.fromarray(array).convert("P", palette=Image.Palette.ADAPTIVE)``
  (Pillow's median cut for gray and RGB, its fast octree for RGBA).
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import struct

import numpy as np

from mods_tpu_torch.io import (blp, dds, eps, fits, icns, im, pdf, png,
                                probed, psd, raster, tiff, x11)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG_SOURCE = os.path.join(_PKG, "csrc", "jpeg_decode.cpp")
JPEG_ENCODER_SOURCE = os.path.join(_PKG, "csrc", "jpeg_encode.cpp")
WEBP_SOURCE = os.path.join(_PKG, "csrc", "webp_decode.cpp")
WEBP_ENCODER_SOURCE = os.path.join(_PKG, "csrc", "webp_encode.cpp")
GIF_ENCODER_SOURCE = os.path.join(_PKG, "csrc", "gif_encode.cpp")
J2K_SOURCE = os.path.join(_PKG, "csrc", "j2k_decode.cpp")
J2K_ENCODER_SOURCE = os.path.join(_PKG, "csrc", "j2k_encode.cpp")

# magic bytes of formats that PIL 12.1.0 opens and this module does not
_OTHER_FORMATS = ((b"\x00\x00\x01\xb3", "MPEG"), (b"%!PS", "EPS"),
                  (b"\xc5\xd0\xd3\xc6", "EPS"),
                  (b"\x89HDF\r\n\x1a\n", "HDF5"), (b"BUFR", "BUFR"),
                  (b"ZCZC", "BUFR"), (b"GRIB", "GRIB"),
                  (b"\xd7\xcd\xc6\x9a\x00\x00", "WMF"))
# the major brands of an ftyp box that AvifImagePlugin._accept takes
_AVIF_BRANDS = (b"avif", b"avis", b"mif1", b"msf1")
_READ_NAMES = ("PNG, JPEG, PNM, PFM, BMP, DIB, TIFF, GIF, WebP, JPEG 2000, "
               "ICO, CUR, TGA, SGI, PCX, QOI, PSD, DCX, FITS, DDS, ICNS, IM, "
               "MSP, XBM, XPM, Sun raster, BLP, SPIDER, GBR, XVTHUMB, IMT, "
               "FLI, FTEX, McIdas, PCD, IPTC and PIXAR")


def _refused(name: str):
    def refuse(data: bytes, path):
        raise ValueError(f"{path}: {name} images are not supported "
                         f"({_READ_NAMES} are)")
    return refuse


def _plugins(head: bytes, data: bytes, path) -> tuple:
    """``Image.ID`` after ``Image.init()`` in PIL 12.1.0: each plugin's name,
    whether its ``_accept`` takes the file (True where it has none), and
    the probe that runs its ``_open`` (raising ``raster.NotThisFormat``
    where ``Image.open`` goes on to the next plugin), or None where the
    port's reader takes every file accepted."""
    other = next((n for m, n in _OTHER_FORMATS if head.startswith(m)), None)
    return (
        ("AVIF", head[4:8] == b"ftyp" and head[8:12] in _AVIF_BRANDS,
         _refused("AVIF")),
        ("BLP", head.startswith((b"BLP1", b"BLP2")), None),
        ("BMP", head.startswith(b"BM"), None),
        ("DIB", len(head) >= 4 and _u32(head, 0) in _BMP_HEADER_SIZES, None),
        ("BUFR", other == "BUFR", _refused("BUFR")),
        ("CUR", head.startswith(b"\x00\x00\x02\x00"),
         lambda d, p: raster.cur_entry(d)),
        ("PCX", head[:1] == b"\x0a" and head[1:2] in (b"\x00", b"\x02",
                                                      b"\x03", b"\x05"),
         raster.pcx_header),
        ("DCX", head.startswith(b"\xb1\x68\xde\x3a"), None),
        ("DDS", head.startswith(b"DDS "), None),
        ("EPS", other == "EPS", _refused("EPS")),
        ("FITS", head.startswith(b"SIMPLE"), None),
        ("FLI", probed.fli_accept(head), probed.fli_header),
        ("FTEX", head.startswith(b"FTEX"), probed.ftex_header),
        ("GBR", probed.gbr_accept(head), probed.gbr_header),
        ("GIF", head[:6] in (b"GIF87a", b"GIF89a"), None),
        ("GRIB", other == "GRIB" and head[7:8] == b"\x01", _refused("GRIB")),
        ("HDF5", other == "HDF5", _refused("HDF5")),
        ("PNG", head.startswith(png._SIGNATURE), None),
        ("JPEG2000", head.startswith((_J2K_CODESTREAM, _JP2_SIGNATURE)),
         None),
        ("ICNS", head.startswith(b"icns"), None),
        # IcoImageFile._open loads the frame
        ("ICO", head.startswith(b"\x00\x00\x01\x00"), raster.read_ico),
        # ImImageFile, ImtImageFile, IptcImageFile: _open on every file
        ("IM", True, im.im_header),
        ("IMT", True, probed.imt_header),
        ("IPTC", True, probed.iptc_header),
        ("JPEG", head.startswith(b"\xff\xd8\xff"), None),
        ("MCIDAS", head.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04"),
         probed.mcidas_header),
        ("MPEG", other == "MPEG", _refused("MPEG")),
        ("TIFF", head[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00",
                              b"MM\x00+"), None),
        ("MSP", head.startswith((b"DanM", b"LinS")), None),
        ("PCD", True, probed.pcd_header),           # no _accept either
        ("PIXAR", head.startswith(b"\x80\xe8\x00\x00"), probed.pixar_header),
        ("PNM", head[:1] == b"P" and head[1:2] in (b"1", b"2", b"3", b"4",
                                                  b"5", b"6", b"f"), None),
        ("PSD", head.startswith(b"8BPS"), None),
        ("QOI", head.startswith(b"qoif"), lambda d, p: raster.qoi_header(d)),
        ("SGI", head.startswith(b"\x01\xda"), raster.sgi_header),
        ("SPIDER", True, probed.spider_header),     # no _accept
        ("SUN", head.startswith(b"\x59\xa6\x6a\x95"), None),
        ("TGA", True, lambda d, p: raster.tga_header(d)),   # no _accept
        ("WEBP", head.startswith(b"RIFF") and head[8:12] == b"WEBP", None),
        ("WMF", other == "WMF" or (head.startswith(b"\x01\x00\x00\x00")
                                   and data[40:44] == b" EMF"),
         _refused("WMF")),
        ("XBM", head.lstrip().startswith(b"#define"), None),
        ("XPM", head.startswith(b"/* XPM */"), None),
        ("XVTHUMB", head.startswith(b"P7 332"), probed.xvthumb_header))


def _format(data: bytes, path) -> str:
    """The format of the file ``data`` as ``Image.open`` finds it: each
    plugin in ``Image.ID``'s order whose ``_accept`` takes the file and
    whose ``_open`` does not pass it on."""
    head = data[:16]
    for fmt, accepted, probe in _plugins(head, data, path):
        if not accepted:
            continue
        if probe is None:
            return fmt
        try:
            probe(data, path)
            return fmt
        except raster.NotThisFormat:
            pass
    if head.startswith(b"#?RADIANCE"):
        raise ValueError(f"{path}: HDR images are not supported (PIL 12.1.0 "
                         f"does not open them either)")
    raise ValueError(f"{path}: not an image format this reader knows "
                     f"({_READ_NAMES})")


def _array_mode(a: np.ndarray) -> str:
    """PIL's mode of an array that a reader returns, where the array alone
    tells it."""
    if a.ndim == 3:
        return {2: "LA", 3: "RGB", 4: "RGBA"}[a.shape[2]]
    return {"b": "1", "u1": "L", "<u2": "I;16", ">u2": "I;16B",
            "<i4": "I", "<f4": "F"}.get(
        "b" if a.dtype == np.bool_ else a.dtype.str.lstrip("|="),
        str(a.dtype))


def _read(path) -> tuple[np.ndarray, str]:
    """``np.asarray(Image.open(path))`` and ``Image.open(path).mode``."""
    with open(path, "rb") as f:
        return _read_data(f.read(), path)


def _read_data(data: bytes, path) -> tuple[np.ndarray, str]:
    """``_read`` of the file's bytes ``data``."""
    fmt = _format(data, path)
    if fmt in _HEADERS:
        # Image.open's _decompression_bomb_check, before any pixel is read
        w, h = _HEADERS[fmt](data, path)["size"]
        if w * h > 2 * tiff._MAX_PIXELS:
            raise ValueError(f"{path}: {fmt} of {w}x{h} pixels: PIL refuses "
                             f"it (a decompression bomb)")
    if fmt in _RASTER_READERS:
        return _RASTER_READERS[fmt](data, path)
    if fmt == "IPTC":
        return probed.read_iptc(data, path, _read_data)
    if fmt == "PNG":
        a = png.read_png(path)
        palette = data[25:26] == b"\x03"           # IHDR colour type 3
        return a, "P" if palette else _array_mode(a)
    if fmt == "JPEG":
        a = _read_jpeg(data, path)
        return a, "CMYK" if a.ndim == 3 and a.shape[2] == 4 \
            else _array_mode(a)
    if fmt == "BMP":
        return _read_bmp(data, path)
    if fmt == "DIB":
        return _read_bmp(_dib_as_bmp(data, path), path)
    if fmt == "TIFF":
        return tiff.read_tiff(data, path)
    if fmt == "GIF":
        return _read_gif(data, path)
    if fmt == "WEBP":
        a = _read_webp(data, path)
        return a, _array_mode(a)
    if fmt == "JPEG2000":
        return _read_j2k(data, path)
    a = _read_pnm(data, path)
    return a, _array_mode(a)


_RASTER_READERS = {"ICO": raster.read_ico, "CUR": raster.read_cur,
                   "TGA": raster.read_tga, "SGI": raster.read_sgi,
                   "PCX": raster.read_pcx, "QOI": raster.read_qoi,
                   "DCX": raster.read_dcx, "PSD": psd.read_psd,
                   "FITS": fits.read_fits, "DDS": dds.read_dds,
                   "ICNS": icns.read_icns, "IM": im.read_im,
                   "MSP": raster.read_msp, "SUN": raster.read_sun,
                   "XBM": x11.read_xbm, "XPM": x11.read_xpm,
                   "BLP": blp.read_blp, "SPIDER": probed.read_spider,
                   "GBR": probed.read_gbr, "XVTHUMB": probed.read_xvthumb,
                   "IMT": probed.read_imt, "FLI": probed.read_fli,
                   "FTEX": probed.read_ftex, "MCIDAS": probed.read_mcidas,
                   "PCD": probed.read_pcd, "PIXAR": probed.read_pixar}
# the size that Image.open reports, from the header
_HEADERS = {"TGA": lambda d, p: raster.tga_header(d),
            "QOI": lambda d, p: raster.qoi_header(d),
            "SGI": raster.sgi_header, "PCX": raster.pcx_header,
            "PSD": psd.psd_header, "FITS": fits.fits_header,
            "DDS": dds.dds_header, "ICNS": icns.icns_header,
            "DCX": lambda d, p: raster.pcx_header(raster.dcx_page(d, p), p),
            "IM": im.im_header, "MSP": raster.msp_header,
            "SUN": raster.sun_header, "XBM": x11.xbm_header,
            "XPM": x11.xpm_header, "BLP": blp.blp_header,
            "SPIDER": probed.spider_header, "GBR": probed.gbr_header,
            "XVTHUMB": probed.xvthumb_header, "IMT": probed.imt_header,
            "FLI": probed.fli_header, "FTEX": probed.ftex_header,
            "MCIDAS": probed.mcidas_header, "PCD": probed.pcd_header,
            "IPTC": probed.iptc_header, "PIXAR": probed.pixar_header}


def read_image(path) -> np.ndarray:
    """``np.asarray(Image.open(path))`` (module docstring)."""
    return _read(path)[0]


def image_size(path) -> tuple[int, int]:
    """``Image.open(path).size``: (width, height) from the header (an
    icon's or a cursor's from the frame that ``Image.open`` loads)."""
    with open(path, "rb") as f:
        data = f.read()
    fmt = _format(data, path)
    if fmt in ("ICO", "CUR"):
        return _RASTER_READERS[fmt](data, path)[0].shape[1::-1]
    if fmt in _HEADERS:
        return _HEADERS[fmt](data, path)["size"]
    if fmt == "PNG":
        return png.png_size(path)
    if fmt == "JPEG":
        return _jpeg_size(path)
    if fmt in ("BMP", "DIB"):
        return _bmp_header(data if fmt == "BMP" else _dib_as_bmp(data, path),
                           path)["size"]
    if fmt == "TIFF":
        return tiff.tiff_size(data, path)
    if fmt == "GIF":
        return _gif_header(data, path)["size"]
    if fmt == "WEBP":
        return _webp_info(data, path)[:2]
    if fmt == "JPEG2000":
        return _j2k_pil_header(data, path)["size"]
    return _pnm_header(data, path)["size"]


# ---------------------------------------------------------------------------
# PNM (PIL's PpmImagePlugin)

_PNM_SPACE = b" \t\n\x0b\x0c\r"


def _pnm_header(data: bytes, path) -> dict:
    """Magic, size, maxval and the offset of the data, read token by
    token as PpmImageFile._open reads them."""
    pos = 0
    magic = b""
    while pos < len(data) and len(magic) < 6:
        c = data[pos:pos + 1]
        pos += 1
        if c in _PNM_SPACE:
            break
        magic += c
    if magic not in (b"P1", b"P2", b"P3", b"P4", b"P5", b"P6", b"Pf"):
        raise ValueError(f"{path}: PNM variant {magic!r} is not supported")

    def token():
        nonlocal pos
        tok = b""
        while len(tok) <= 10:
            if pos >= len(data):
                break
            c = data[pos:pos + 1]
            pos += 1
            if c in _PNM_SPACE:
                if not tok:
                    continue
                break
            if c == b"#":
                while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                    pos += 1
                pos += 1
                continue
            tok += c
        if not tok or len(tok) > 10:
            raise ValueError(f"{path}: bad PNM header")
        return tok

    w, h = int(token()), int(token())
    out = dict(magic=magic, size=(w, h))
    if magic == b"Pf":
        out["scale"] = float(token())
        if out["scale"] == 0.0 or not np.isfinite(out["scale"]):
            raise ValueError(f"{path}: PFM scale must be finite and "
                             f"non-zero")
    elif magic not in (b"P1", b"P4"):
        out["maxval"] = int(token())
        if not 0 < out["maxval"] < 65536:
            raise ValueError(f"{path}: PNM maxval must be 1..65535")
    out["offset"] = pos
    return out


def _strip_comments(body: bytes) -> bytes:
    """The plain formats' data without '#' comments (PpmPlainDecoder)."""
    out, pos = [], 0
    while True:
        i = body.find(b"#", pos)
        if i < 0:
            out.append(body[pos:])
            return b"".join(out)
        out.append(body[pos:i])
        ends = [e for e in (body.find(b"\n", i), body.find(b"\r", i))
                if e >= 0]
        if not ends:
            return b"".join(out)
        pos = min(ends) + 1


def _read_pnm(data: bytes, path) -> np.ndarray:
    hd = _pnm_header(data, path)
    magic, (w, h), body = hd["magic"], hd["size"], data[hd["offset"]:]
    if magic == b"Pf":
        if len(body) < 4 * w * h:
            raise ValueError(f"{path}: PFM image data is truncated")
        v = np.frombuffer(body[:4 * w * h], "<f4" if hd["scale"] < 0
                          else ">f4").reshape(h, w)
        return v[::-1].astype(np.float32)
    if magic == b"P4":
        stride = (w + 7) // 8
        if len(body) < stride * h:
            raise ValueError(f"{path}: PNM image data is truncated")
        bits = np.unpackbits(np.frombuffer(body[:stride * h], np.uint8)
                             .reshape(h, stride), axis=1)[:, :w]
        return bits == 0
    if magic == b"P1":
        digits = b"".join(_strip_comments(body).split())
        if len(digits) < w * h:
            raise ValueError(f"{path}: PNM image data is truncated")
        d = np.frombuffer(digits[:w * h], np.uint8)
        if ((d != ord("0")) & (d != ord("1"))).any():
            raise ValueError(f"{path}: P1 data holds a token other than "
                             f"0 or 1")
        return (d == ord("0")).reshape(h, w)
    maxval = hd["maxval"]
    bands = 3 if magic in (b"P3", b"P6") else 1
    wide = bands == 1 and maxval > 255           # PIL's mode "I"
    out_max = 65535 if wide else 255
    n = w * h * bands
    if magic in (b"P2", b"P3"):
        toks = _strip_comments(body).split()
        if len(toks) < n:
            raise ValueError(f"{path}: PNM image data is truncated")
        v = np.array([int(t) for t in toks[:n]], np.int64)
        if (v > maxval).any() or (v < 0).any():
            raise ValueError(f"{path}: PNM value out of 0..{maxval}")
    else:
        size = 2 if maxval > 255 else 1
        if len(body) < n * size:
            raise ValueError(f"{path}: PNM image data is truncated")
        v = np.frombuffer(body[:n * size], ">u2" if size == 2 else np.uint8)
        v = v.astype(np.int64)
    if magic in (b"P5", b"P6") and (maxval == 255 or
                                    (wide and maxval == 65535)):
        scaled = v                                   # PIL's raw decoders
    else:
        scaled = np.minimum(out_max, np.rint(v / maxval * out_max))
    a = scaled.astype(np.int32 if wide else np.uint8)
    return a.reshape((h, w, 3) if bands == 3 else (h, w))


# ---------------------------------------------------------------------------
# BMP (PIL's BmpImagePlugin)

_BMP_MASKS = {
    # (bits, masks) -> (channel byte offsets, R G B [A]) as PIL's rawmodes
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): (2, 1, 0),              # BGRX
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): (3, 2, 1),        # XBGR
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): (3, 1, 0),            # BGXR
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): (3, 2, 1, 0),    # ABGR
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): (0, 1, 2, 3),    # RGBA
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): (2, 1, 0, 3),    # BGRA
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): (3, 1, 0, 2),    # BGAR
    (32, (0x0, 0x0, 0x0, 0x0)): (2, 1, 0, 3),                    # BGRA
    (24, (0xFF0000, 0xFF00, 0xFF)): (2, 1, 0),                   # BGR
    (24, ()): (2, 1, 0),                                         # BGR
    (32, ()): (2, 1, 0),                                         # BGRX
    # 16-bit: (shift, field maximum) of R, G, B
    (16, (0xF800, 0x7E0, 0x1F)): ((11, 31), (5, 63), (0, 31)),   # BGR;16
    (16, (0x7C00, 0x3E0, 0x1F)): ((10, 31), (5, 31), (0, 31)),   # BGR;15
    (16, ()): ((10, 31), (5, 31), (0, 31)),                      # BGR;15
}


def _u16(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 2], "little")


def _u32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 4], "little")


# the info header sizes that PIL's BMP and DIB readers know
_BMP_HEADER_SIZES = (12, 40, 52, 56, 64, 108, 124)


def _bmp_header(data: bytes, path) -> dict:
    hsize = _u32(data, 14)
    hd = data[18:14 + hsize]
    pos = 14 + hsize
    if hsize == 12:
        w, h, bits = _u16(hd, 0), _u16(hd, 2), _u16(hd, 6)
        comp, colors, pad, bottom_up = 0, 0, 3, True
    elif hsize in (40, 52, 56, 64, 108, 124):
        flip = hd[7] == 0xFF
        w, bits = _u32(hd, 0), _u16(hd, 10)
        h = 2 ** 32 - _u32(hd, 4) if flip else _u32(hd, 4)
        comp, colors, pad, bottom_up = _u32(hd, 12), _u32(hd, 28), 4, \
            not flip
    else:
        raise ValueError(f"{path}: BMP header size {hsize} is not supported")
    out = dict(size=(w, h), bits=bits, comp=comp, pad=pad,
               bottom_up=bottom_up, colors=colors or 1 << bits)
    if comp == 3:
        if len(hd) >= 48:
            masks = [_u32(hd, 36 + 4 * i) for i in range(3)]
            masks.append(_u32(hd, 48) if len(hd) >= 52 else 0)
        else:
            masks = [_u32(data, pos + 4 * i) for i in range(3)] + [0]
            pos += 12
        out["masks"] = tuple(masks)
    out["palette_at"] = pos
    offset = _u32(data, 10)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * out["colors"]
    out["offset"] = offset
    return out


def _dib_as_bmp(data: bytes, path) -> bytes:
    """A DIB (a BMP without its file header) with the file header put back:
    its pixels start where PIL's DibImageFile reads them, after the info
    header, the bitfield masks read outside it and the palette."""
    hd = _bmp_header(b"BM" + bytes(12) + data, path)
    at = hd["palette_at"]
    if hd["bits"] <= 8:
        at += (3 if _u32(data, 0) == 12 else 4) * hd["colors"]
    return b"BM" + struct.pack("<IHHI", 14 + len(data), 0, 0, at) + data


def _bmp_rle(data: bytes, at: int, w: int, h: int, rle4: bool) -> bytes:
    """PIL's BmpRleDecoder: the indices of an RLE8 or RLE4 bitmap in file
    row order, from the data at byte ``at`` of the file (its 16-bit
    alignment of absolute runs is the file offset's, and its delta
    escape skips two bytes before the two it reads)."""
    out = bytearray()
    x, pos, n = 0, at, w * h
    while len(out) < n:
        if pos + 2 > len(data):
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:                                   # encoded run
            count = max(0, min(count, w - x))
            if rle4:
                out += bytes([byte >> 4, byte & 15]) * (count // 2) \
                    + bytes([byte >> 4]) * (count % 2)
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:                             # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:                             # end of bitmap
            break
        elif byte == 2:                             # delta
            if pos + 2 > len(data):
                break
            right, up = data[pos + 2], data[pos + 3]
            pos += 4
            out += bytes(right + up * w)
            x = len(out) % w
        else:                                       # absolute run
            nbytes = byte // 2 if rle4 else byte
            run = data[pos:pos + nbytes]
            pos += len(run)
            out += bytes(v for b in run for v in (b >> 4, b & 15)) \
                if rle4 else run
            if len(run) < nbytes:
                break
            x += byte
            pos += pos % 2
    if len(out) < n:
        raise ValueError("not enough image data in the RLE-compressed BMP")
    return bytes(out[:n])


def _read_bmp(data: bytes, path,
              raw_alpha: bool = False) -> tuple[np.ndarray, str]:
    """PIL's BmpImageFile; ``raw_alpha``: 32-bit pixels without bitfields
    as BGRA (a cursor's DIB at byte 22, CurImagePlugin's case)."""
    hd = _bmp_header(data, path)
    (w, h), bits, comp = hd["size"], hd["bits"], hd["comp"]
    if bits not in (1, 4, 8, 16, 24, 32):
        raise ValueError(f"{path}: BMP pixel depth {bits} is not supported")
    layout = None
    if comp == 3:
        masks = hd["masks"] if bits == 32 else hd["masks"][:3]
        layout = _BMP_MASKS.get((bits, masks))
        if layout is None:
            raise ValueError(f"{path}: BMP bitfields layout {bits}-bit "
                             f"{[hex(m) for m in masks]} is not supported")
    elif comp == 0:
        layout = None if bits <= 8 else _BMP_MASKS[(bits, ())]
        if raw_alpha and bits == 32:
            layout = (2, 1, 0, 3)
    elif comp in (1, 2):
        if bits != (8 if comp == 1 else 4):
            raise ValueError(f"{path}: an RLE{8 if comp == 1 else 4} BMP "
                             f"of {bits}-bit pixels is not supported")
    else:
        raise ValueError(f"{path}: BMP compression {comp} is not supported")
    if comp in (1, 2):
        try:
            idx = np.frombuffer(_bmp_rle(data, hd["offset"], w, h, comp == 2),
                                np.uint8).reshape(h, w)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        at = hd["offset"]
        if len(data) < at + stride * h:
            raise ValueError(f"{path}: BMP image data is truncated")
        rows = np.frombuffer(data[at:at + stride * h],
                             np.uint8).reshape(h, stride)
    if bits <= 8:
        colors, pad = hd["colors"], hd["pad"]
        if not 0 < colors <= 65536:
            raise ValueError(f"{path}: BMP palette size {colors} is not "
                             f"supported")
        pal = data[hd["palette_at"]:hd["palette_at"] + pad * colors]
        ramp = (0, 255) if colors == 2 else range(colors)
        gray = all(pal[i * pad:i * pad + 3] == bytes([v & 0xFF]) * 3
                   for i, v in enumerate(ramp))
        if comp not in (1, 2):
            per = 8 // bits
            shifts = (8 - bits * (np.arange(per) + 1)).astype(np.uint8)
            idx = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)) \
                .reshape(h, -1)[:, :w].astype(np.uint8)
        if hd["bottom_up"]:
            idx = idx[::-1]
        if gray and colors == 2:
            if bits != 1:
                raise ValueError(f"{path}: a {bits}-bit BMP with a "
                                 f"black-and-white palette is not supported")
            return idx != 0, "1"
        if gray and bits != 8:
            raise ValueError(f"{path}: a {bits}-bit BMP with a gray-ramp "
                             f"palette is not supported")
        return np.ascontiguousarray(idx), "L" if gray else "P"
    if hd["bottom_up"]:
        rows = rows[::-1]
    if bits == 16:
        # PIL's BGR;15 / BGR;16 unpackers: each field * 255 // its maximum
        v = rows[:, :2 * w].reshape(h, w, 2).astype(np.uint32)
        v = v[..., 0] | v[..., 1] << 8
        out = np.stack([(v >> sh & m) * 255 // m for sh, m in layout], -1)
        return out.astype(np.uint8), "RGB"
    step = bits // 8
    px = rows[:, :step * w].reshape(h, w, step)
    out = np.ascontiguousarray(px[..., list(layout)])
    return out, "RGBA" if len(layout) == 4 else "RGB"


# ---------------------------------------------------------------------------
# JPEG (csrc/jpeg_decode.cpp)

@functools.lru_cache(maxsize=1)
def _jpeg_lib():
    # the port's one g++ rule (``detectors/mser.py::build_native``)
    from mods_tpu_torch.detectors.mser import build_native
    lib = ctypes.CDLL(build_native(JPEG_SOURCE, "libmods_jpeg.so"))
    for fn in (lib.mods_jpeg_info, lib.mods_jpeg_decode):
        fn.restype = ctypes.c_int
    lib.mods_jpeg_info.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_int]
    lib.mods_jpeg_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
    lib.mods_jpeg_decode_tiff.restype = ctypes.c_int
    lib.mods_jpeg_decode_tiff.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
        ctypes.c_int]
    lib.mods_jpeg_decode_ojpeg.restype = ctypes.c_int
    lib.mods_jpeg_decode_ojpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
        ctypes.c_int]
    return lib


def _read_jpeg(data: bytes, path, cmyk: bool = False) -> np.ndarray:
    """PIL's array of the JPEG stream ``data``; ``cmyk``: a four-component
    stream read as the tile's jpegmode "CMYK" makes libjpeg read it (no
    YCCK conversion, whatever its Adobe marker says)."""
    _jpeg_size_of(data, path)           # JpegImageFile._open's marker walk
    lib = _jpeg_lib()
    err = ctypes.create_string_buffer(256)
    info = (ctypes.c_int32 * 4)()
    if lib.mods_jpeg_info(data, len(data), info, err, len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    w, h, c = info[0], info[1], info[2]
    out = np.empty((h, w, c) if c > 1 else (h, w), np.uint8)
    if lib.mods_jpeg_decode(data, len(data), 0 if cmyk and c == 4 else -1,
                            out.ctypes.data, out.size, err, len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    return out


def _jpeg_size(path) -> tuple[int, int]:
    """(width, height) from the first SOFn marker, as PIL reads it."""
    with open(path, "rb") as f:
        return _jpeg_size_of(f.read(), path)


def _jpeg_size_of(data: bytes, path) -> tuple[int, int]:
    """``_jpeg_size`` of the JPEG stream ``data``: the size of the last
    frame header (SOFn or DHP) before the first SOS, once
    ``JpegImageFile._open``'s walk over the markers has read that scan's
    header whole, as ``Image.open`` needs it to."""
    size = None
    pos = 2
    while True:
        if pos >= len(data):
            raise ValueError(f"{path}: the JPEG ends before its first scan: "
                             f"PIL cannot identify it")
        if data[pos] != 0xFF:                       # junk before a marker
            pos += 1
            continue
        if pos + 1 >= len(data):
            raise ValueError(f"{path}: the JPEG ends before its first scan: "
                             f"PIL cannot identify it")
        m = data[pos + 1]
        if m == 0xFF:                               # a fill byte
            pos += 1
            continue
        if m == 0x00:                               # an escaped 0xFF
            pos += 2
            continue
        if m < 0xC0:
            raise ValueError(f"{path}: no JPEG marker at byte {pos}: PIL "
                             f"cannot identify it")
        if m == 0xC8 or 0xD0 <= m <= 0xD9 or 0xF0 <= m <= 0xFD:
            pos += 2                                # no segment read
            continue
        if pos + 4 > len(data):
            raise ValueError(f"{path}: the JPEG ends before its first scan: "
                             f"PIL cannot identify it")
        n = int.from_bytes(data[pos + 2:pos + 4], "big")
        if pos + 2 + n > len(data):
            raise ValueError(f"{path}: a JPEG marker segment runs past the "
                             f"end of the file: PIL refuses it (Truncated "
                             f"File Read)")
        if (0xC0 <= m <= 0xCF and m not in (0xC4, 0xCC)) or m == 0xDE:
            if n >= 7:
                size = (int.from_bytes(data[pos + 7:pos + 9], "big"),
                        int.from_bytes(data[pos + 5:pos + 7], "big"))
        if m == 0xDA:
            if size is None:
                raise ValueError(f"{path}: JPEG without a frame header")
            return size
        pos += 2 + max(n, 2)            # a length below 2 reads nothing


# ---------------------------------------------------------------------------
# WebP (csrc/webp_decode.cpp)

@functools.lru_cache(maxsize=1)
def _webp_lib():
    from mods_tpu_torch.detectors.mser import build_native
    lib = ctypes.CDLL(build_native(WEBP_SOURCE, "libmods_webp.so"))
    for fn in (lib.mods_webp_info, lib.mods_webp_decode):
        fn.restype = ctypes.c_int
    lib.mods_webp_info.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.c_char_p, ctypes.c_int]
    lib.mods_webp_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int]
    return lib


def _webp_info(data: bytes, path) -> tuple[int, int, int]:
    """(width, height, channels) of the canvas: PIL's size, and 4 where
    PIL's mode is RGBA."""
    err = ctypes.create_string_buffer(256)
    info = (ctypes.c_int32 * 3)()
    if _webp_lib().mods_webp_info(data, len(data), info, err, len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    return info[0], info[1], info[2]


def _read_webp(data: bytes, path) -> np.ndarray:
    w, h, c = _webp_info(data, path)
    out = np.empty((h, w, c), np.uint8)
    err = ctypes.create_string_buffer(256)
    if _webp_lib().mods_webp_decode(data, len(data), out.ctypes.data,
                                    out.size, err, len(err)):
        raise ValueError(f"{path}: {err.value.decode()}")
    return out


# ---------------------------------------------------------------------------
# JPEG 2000 (PIL's Jpeg2KImagePlugin, then OpenJPEG's tile interface and
# Pillow's Jpeg2KDecode.c in csrc/j2k_decode.cpp)

_J2K_CODESTREAM = b"\xff\x4f\xff\x51"
_JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
# the modes in csrc/j2k_decode.cpp's order, and Pillow's bytes a pixel
_J2K_MODES = ("L", "P", "PA", "I;16", "LA", "RGB", "RGBA", "CMYK")
# OpenJPEG's colour space (OPJ_COLOR_SPACE) of a colr box's EnumCS:
# sRGB, greyscale, sYCC, e-sYCC, CMYK; any other is OPJ_CLRSPC_UNKNOWN
_JP2_COLOUR = {16: 1, 17: 2, 18: 3, 24: 4, 12: 5}
_J2K_BROKEN = "broken data stream when reading image file"


def _j2k_refused(path, why: str) -> ValueError:
    return ValueError(f"{path}: JPEG 2000 file that PIL refuses: {why}")


def _j2k_codestream_mode(data: bytes, at: int, path) -> tuple:
    """Jpeg2KImagePlugin._parse_codestream on the SIZ segment at ``at``
    (after SOC and the SIZ marker): PIL's size and mode."""
    try:
        lsiz = struct.unpack_from(">H", data, at)[0]
        siz = data[at:at + lsiz]
        (_, _, xsiz, ysiz, xosiz, yosiz, _, _, _, _,
         csiz) = struct.unpack_from(">HHIIIIIIIIH", siz)
        if csiz == 1:
            prec = (struct.unpack_from(">B", siz, 38)[0] & 0x7F) + 1
            mode = "I;16" if prec > 8 else "L"
        elif csiz in (2, 3, 4):
            mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
        else:
            raise _j2k_refused(path, "unable to determine J2K image mode")
    except struct.error as e:
        raise _j2k_refused(path, f"cannot identify image file ({e})") from e
    return (xsiz - xosiz, ysiz - yosiz), mode


def _pil_boxes(data: bytes, pos: int, end):
    """PIL's BoxReader from ``pos`` up to ``end`` (None: no length known):
    (type, content start, content end) of each box, raising where
    BoxReader raises."""
    def need(at, k):
        if end is None and at + k > len(data):
            raise OSError(f"Expected to read {k} bytes but only got "
                          f"{max(0, len(data) - at)}.")
        if end is not None and at + k > end:
            raise SyntaxError("Not enough data in header")
    while end is None or pos < end:
        need(pos, 8)
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 1:
            need(pos + 8, 8)
            lbox, hlen = struct.unpack_from(">Q", data, pos + 8)[0], 16
        if lbox < hlen or (end is not None and pos + lbox > end):
            raise SyntaxError("Invalid header length")
        yield tbox, pos + hlen, pos + lbox
        pos += lbox


def _j2k_pil_header(data: bytes, path) -> dict:
    """What Jpeg2KImageFile._open reads: the size and the mode, and for
    JP2 the palette's presence."""
    if data.startswith(_J2K_CODESTREAM):
        size, mode = _j2k_codestream_mode(data, 4, path)
        return dict(size=size, mode=mode)
    try:
        header = None
        for tbox, lo, hi in _pil_boxes(data, 12, None):
            if tbox == b"jp2h":
                if hi > len(data):              # BoxReader.read_boxes
                    raise OSError(f"Expected to read {hi - lo} bytes but "
                                  f"only got {len(data) - lo}.")
                header = (lo, hi)
                break
        size = mode = nc = None
        for tbox, lo, hi in _pil_boxes(data, header[0], header[1]):
            def fields(fmt, at=lo):
                if at + struct.calcsize(fmt) > hi:
                    raise SyntaxError("Not enough data in header")
                return struct.unpack_from(fmt, data, at)
            if tbox == b"ihdr":
                height, width, nc, bpc = fields(">IIHB")
                size = (width, height)
                mode = ("I;16" if nc == 1 and (bpc & 0x7F) > 8 else
                        {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}.get(nc, mode))
            elif tbox == b"colr" and nc == 4:
                meth, _, _, enumcs = fields(">BBBI")
                if meth == 1 and enumcs == 12:
                    mode = "CMYK"
            elif tbox == b"pclr" and mode in ("L", "LA"):
                ne, npc = fields(">HB")
                depths = fields(">" + "B" * npc, lo + 3)
                if max(depths, default=0) <= 8:
                    fields(">" + "B" * (npc * ne), lo + 3 + npc)
                    mode = "P" if mode == "L" else "PA"
        if size is None or mode is None:
            raise SyntaxError("Malformed JP2 header")
    except (SyntaxError, OSError, TypeError, struct.error) as e:
        raise _j2k_refused(path, str(e) or "cannot identify image file") \
            from e
    return dict(size=size, mode=mode)


def _openjpeg_jp2(data: bytes, path) -> tuple[bytes, int, tuple]:
    """OpenJPEG's opj_jp2_read_header: the codestream of the jp2c box,
    the colour space of the first colr box (opj_jp2_read_colr; -1 where
    there is none, an ICC profile or an EnumCS it does not map) and
    ihdr's (width, height), which SIZ must match; its refusals of the
    jp2h sub-boxes (a second pclr, cmap or cdef, a cmap before pclr, bad
    sizes)."""
    def broken(why):
        return _j2k_refused(path, f"{_J2K_BROKEN} ({why})")
    pos, n, state, enumcs, size = 0, len(data), 0, None, None
    while pos + 8 <= n:
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 1:
            if pos + 16 > n:
                break
            lbox, hlen = struct.unpack_from(">Q", data, pos + 8)[0], 16
        elif lbox == 0:
            lbox = n - pos
        if lbox < hlen:
            raise broken("Box length is inconsistent")
        if state == 0 and tbox != b"jP  ":
            raise broken("the first box must be the JPEG 2000 signature "
                         "box")
        if state == 1 and tbox != b"ftyp":
            raise broken("the second box must be the file type box")
        if tbox == b"jp2c":
            if size is None:
                raise broken("JP2H box missing")
            return data[pos + hlen:], _JP2_COLOUR.get(enumcs, -1), size
        if pos + lbox > n:
            raise broken("a box runs past the end of the file")
        if tbox == b"jp2h":
            seen = set()
            for sub, lo, hi in _openjpeg_subboxes(data, pos + hlen,
                                                  pos + lbox, broken):
                body = hi - lo
                if sub == b"ihdr" and size is None:
                    if body != 14:
                        raise broken("Bad image header box (bad size)")
                    h, w, nc = struct.unpack_from(">IIH", data, lo)
                    if h < 1 or w < 1 or nc < 1 or nc > 16384:
                        raise broken("Wrong values for ihdr")
                    size = (w, h)
                elif sub == b"colr" and b"colr" not in seen:
                    if body < 3 or (data[lo] == 1 and body < 7):
                        raise broken("Bad COLR header box (bad size)")
                    if data[lo] == 1:
                        enumcs = struct.unpack_from(">I", data, lo + 3)[0]
                elif sub in (b"pclr", b"cdef") and sub in seen:
                    raise broken(f"a second {sub.decode()} box")
                elif sub == b"cmap":
                    if b"pclr" not in seen:
                        raise broken("Need to read a PCLR box before the "
                                     "CMAP box.")
                    if b"cmap" in seen:
                        raise broken("Only one CMAP box is allowed.")
                elif sub == b"cdef" and (body < 2 or body < 2 + 6 * (
                        struct.unpack_from(">H", data, lo)[0] or 1)):
                    raise broken("Insufficient data for CDEF box.")
                seen.add(sub)
            if size is None:
                raise broken("no 'ihdr' box")
            state = 3
        else:
            state = max(state, {b"jP  ": 1, b"ftyp": 2}.get(tbox, state))
        pos += lbox
    raise broken("no codestream box")


def _openjpeg_subboxes(data: bytes, pos: int, end: int, broken):
    while pos + 8 <= end:
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 1:
            lbox, hlen = struct.unpack_from(">Q", data, pos + 8)[0], 16
        if lbox < hlen or pos + lbox > end:
            raise broken("Box length is inconsistent")
        yield tbox, pos + hlen, pos + lbox
        pos += lbox


@functools.lru_cache(maxsize=1)
def _j2k_lib():
    from mods_tpu_torch.detectors.mser import build_native
    # OpenJPEG's float arithmetic has no fused multiply-adds
    lib = ctypes.CDLL(build_native(J2K_SOURCE, "libmods_j2k.so",
                                   ("-ffp-contract=off",)))
    lib.mods_j2k_decode.restype = ctypes.c_int
    lib.mods_j2k_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p,
        ctypes.c_int]
    return lib


def _read_j2k(data: bytes, path) -> tuple[np.ndarray, str]:
    """``np.asarray(Image.open(path))`` and its mode for a .j2k
    codestream or a .jp2 file."""
    head = _j2k_pil_header(data, path)
    (w, h), mode = head["size"], head["mode"]
    if data.startswith(_J2K_CODESTREAM):
        cs, colour = data, 0                 # OPJ_CLRSPC_UNSPECIFIED
    else:
        cs, colour, ihdr = _openjpeg_jp2(data, path)
        # OpenJPEG holds SIZ's image area to ihdr's
        try:
            if not cs.startswith(_J2K_CODESTREAM):
                raise struct.error("expected SOC and SIZ markers")
            x1, y1, x0, y0 = struct.unpack_from(">4I", cs, 8)
        except struct.error as e:
            raise _j2k_refused(path, f"{_J2K_BROKEN} ({e})") from e
        if ihdr != (x1 - x0, y1 - y0):
            raise _j2k_refused(path, f"{_J2K_BROKEN} (Error with SIZ "
                               f"marker: IHDR {ihdr} vs. SIZ "
                               f"{(x1 - x0, y1 - y0)})")
    bpp = 1 if mode in ("L", "P") else 2 if mode == "I;16" else 4
    mem = np.zeros((h, w, bpp), np.uint8)
    err = ctypes.create_string_buffer(256)
    if _j2k_lib().mods_j2k_decode(cs, len(cs), _J2K_MODES.index(mode), colour,
                                  w, h, mem.ctypes.data, err, len(err)):
        raise _j2k_refused(path, f"{_J2K_BROKEN} ({err.value.decode()})")
    if mode in ("L", "P"):
        return mem[..., 0], mode
    if mode == "I;16":
        return mem.view("<u2")[..., 0], mode
    bands = {"LA": [0, 3], "PA": [0, 3], "RGB": [0, 1, 2]}.get(mode,
                                                              [0, 1, 2, 3])
    return np.ascontiguousarray(mem[..., bands]), mode


# ---------------------------------------------------------------------------
# GIF (PIL's GifImagePlugin: the first frame)

def _gif_palette_needed(p: bytes) -> bool:
    """GifImageFile._is_palette_needed: False for the identity gray
    ramp."""
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2])
               for i in range(0, len(p) - 2, 3))


def _gif_frame(data: bytes, path) -> dict:
    """What GifImageFile._open and _seek(0) read up to the first frame's
    image data: its extent, mode, interlace, transparency and LZW code
    size, and the image size."""
    w, h = _u16(data, 6), _u16(data, 8)
    flags, pos = data[10], 13
    global_palette = False
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        global_palette = _gif_palette_needed(data[pos:pos + n])
        pos += n

    def sub_block():
        nonlocal pos
        if pos >= len(data) or not data[pos]:
            pos += 1
            return None
        size = data[pos]
        pos += 1 + size
        return data[pos - size:pos]

    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError(f"{path}: GIF without an image")
        b = data[pos]
        pos += 1
        if b == 0x21:
            label = data[pos]
            pos += 1
            block = sub_block()
            if label == 0xF9 and block is not None and block[0] & 1:
                transparency = block[3]
            while block is not None:
                block = sub_block()
        elif b == 0x2C:
            x0, y0, fw, fh = struct.unpack_from("<4H", data, pos)
            flags = data[pos + 8]
            pos += 9
            palette = None
            if flags & 0x80:
                n = 3 << ((flags & 7) + 1)
                palette = _gif_palette_needed(data[pos:pos + n])
                pos += n
            break
    needed = palette if palette is not None else global_palette
    return dict(size=(max(w, x0 + fw), max(h, y0 + fh)),
                extent=(x0, y0, fw, fh), interlace=bool(flags & 0x40),
                mode="P" if needed else "L", transparency=transparency,
                bits=data[pos], data_at=pos + 1)


def _gif_header(data: bytes, path) -> dict:
    try:
        return _gif_frame(data, path)
    except (IndexError, struct.error):
        raise ValueError(f"{path}: GIF is truncated") from None


def _read_gif(data: bytes, path) -> tuple[np.ndarray, str]:
    fr = _gif_header(data, path)
    (w, h), (x0, y0, fw, fh) = fr["size"], fr["extent"]
    if not 1 <= fr["bits"] <= 11:
        raise ValueError(f"{path}: GIF LZW code size {fr['bits']} is not "
                         f"supported")
    blocks, pos = [], fr["data_at"]
    while pos < len(data) and data[pos]:
        blocks.append(data[pos + 1:pos + 1 + data[pos]])
        pos += 1 + data[pos]
    pixels = tiff.lzw_decode(b"".join(blocks), 2, fr["bits"], fw * fh, path)
    if len(pixels) < fw * fh:
        raise ValueError(f"{path}: GIF image data is truncated")
    frame = np.frombuffer(pixels, np.uint8).reshape(fh, fw)
    if fr["interlace"]:
        order = [y for y0_, step in ((0, 8), (4, 8), (2, 4), (1, 2))
                 for y in range(y0_, fh, step)]
        frame = frame[np.argsort(order)]
    canvas = np.full((h, w), fr["transparency"] or 0, np.uint8)
    canvas[y0:y0 + fh, x0:x0 + fw] = frame
    return canvas, fr["mode"]


# ---------------------------------------------------------------------------
# writers

_SAVE_FORMATS = {".png": "PNG", ".apng": "PNG", ".pbm": "PNM", ".pgm": "PNM",
                 ".ppm": "PNM", ".pnm": "PNM", ".pfm": "PNM", ".bmp": "BMP",
                 ".dib": "DIB", ".jpg": "JPEG", ".jpeg": "JPEG",
                 ".jpe": "JPEG", ".jfif": "JPEG", ".tif": "TIFF",
                 ".tiff": "TIFF", ".webp": "WEBP", ".gif": "GIF",
                 ".j2k": "JPEG2000", ".jp2": "JPEG2000", ".j2c": "JPEG2000",
                 ".jpc": "JPEG2000", ".jpf": "JPEG2000", ".jpx": "JPEG2000",
                 ".mpo": "JPEG", ".ico": "ICO", ".tga": "TGA", ".icb": "TGA",
                 ".vda": "TGA", ".vst": "TGA", ".sgi": "SGI", ".bw": "SGI",
                 ".rgb": "SGI", ".rgba": "SGI", ".pcx": "PCX", ".qoi": "QOI",
                 ".dds": "DDS", ".icns": "ICNS", ".im": "IM", ".msp": "MSP",
                 ".xbm": "XBM", ".blp": "BLP", ".pdf": "PDF", ".ps": "EPS",
                 ".eps": "EPS", ".palm": "PALM"}
# the extensions of the other formats that PIL 12.1.0 writes here
_NOT_WRITTEN = {".avif": "AVIF", ".avifs": "AVIF"}
# PIL's stubs: formats it names but cannot save without a handler
_STUBS = {".bufr": "BUFR", ".grib": "GRIB", ".h5": "HDF5", ".hdf": "HDF5",
          ".wmf": "WMF", ".emf": "WMF"}


def _mode(a: np.ndarray) -> str:
    """PIL's ``Image.fromarray`` mode of an array."""
    if a.ndim == 2:
        if a.dtype == np.bool_:
            return "1"
        if a.dtype == np.uint8:
            return "L"
        if a.dtype == np.uint16:
            return "I;16"
        if (a.dtype.kind == "i" and a.dtype.itemsize <= 4) or \
                a.dtype == np.uint32:
            return "I"
        if a.dtype in (np.float32, np.float64):
            return "F"
    if a.ndim == 3 and a.dtype == np.uint8 and a.shape[2] in (2, 3, 4):
        return {2: "LA", 3: "RGB", 4: "RGBA"}[a.shape[2]]
    raise ValueError(f"cannot write a {a.dtype} array of shape {a.shape} "
                     f"as an image")


def _pnm_bytes(a: np.ndarray, mode: str) -> bytes:
    h, w = a.shape[:2]
    if mode == "1":
        return b"P4\n%d %d\n" % (w, h) + np.packbits(~a, axis=1).tobytes()
    if mode == "L":
        return b"P5\n%d %d\n255\n" % (w, h) + a.tobytes()
    if mode in ("I;16", "I"):                        # PIL's "I;16B" packer
        return b"P5\n%d %d\n65535\n" % (w, h) + \
            np.clip(a, 0, 65535).astype(">u2").tobytes()
    if mode in ("RGB", "RGBA"):
        return b"P6\n%d %d\n255\n" % (w, h) + \
            np.ascontiguousarray(a[..., :3]).tobytes()
    if mode == "F":                                  # PFM, rows bottom-up
        return b"Pf\n%d %d\n-1.0\n" % (w, h) + \
            a[::-1].astype("<f4").tobytes()
    raise ValueError(f"cannot write mode {mode} as PPM")


def _bmp_bytes(a: np.ndarray, mode: str) -> bytes:
    h, w = a.shape[:2]
    if mode == "1":
        bits, pal = 1, bytes([0, 0, 0, 0, 255, 255, 255, 0])
        rows = np.packbits(a, axis=1)
    elif mode == "L":
        bits = 8
        pal = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
        pal[:, 3] = 0
        pal = pal.tobytes()
        rows = a
    elif mode in ("RGB", "RGBA"):
        bits, pal = 8 * a.shape[2], b""
        order = [2, 1, 0] if mode == "RGB" else [2, 1, 0, 3]
        rows = a[..., order].reshape(h, -1)
    else:
        raise ValueError(f"cannot write mode {mode} as BMP")
    stride = ((w * bits + 7) // 8 + 3) & ~3
    body = np.zeros((h, stride), np.uint8)
    body[:, :rows.shape[1]] = rows
    colors = len(pal) // 4
    offset = 14 + 40 + len(pal)
    ppm = int(96 * 39.3701 + 0.5)                   # PIL's default 96 dpi
    head = np.array([offset + body.size, 0, offset, 40, w, h, 1 | bits << 16,
                     0, body.size, ppm, ppm, colors, colors], "<u4")
    return b"BM" + head.tobytes() + pal + body[::-1].tobytes()


def _dib_bytes(a: np.ndarray, mode: str) -> bytes:
    """PIL's DIB: its BMP without the 14-byte file header."""
    return _bmp_bytes(a, mode)[14:]


# TiffImagePlugin.SAVE_INFO: mode -> (photometric, sample format, bits per
# sample, extra samples, little-endian sample type)
_TIFF_SAVE = {"1": (1, 1, (1,), None, None), "L": (1, 1, (8,), None, "u1"),
              "LA": (1, 1, (8, 8), 2, "u1"), "I;16": (1, 1, (16,), None,
                                                      "<u2"),
              "I": (1, 2, (32,), None, "<i4"), "F": (1, 3, (32,), None, "<f4"),
              "RGB": (2, 1, (8, 8, 8), None, "u1"),
              "RGBA": (2, 1, (8, 8, 8, 8), 2, "u1")}


def _tiff_bytes(a: np.ndarray, mode: str) -> bytes:
    """PIL's uncompressed TIFF: II, one IFD at byte 8 with its tags in
    order (LONG size, strip offset, rows per strip and byte count, SHORT
    the rest; BitsPerSample left out for 1-bit, SamplesPerPixel for one
    sample, SampleFormat for unsigned), the values that do not fit in
    their entry after it, each padded to an even length, then one strip
    of every row."""
    if mode not in _TIFF_SAVE:
        raise ValueError(f"cannot write mode {mode} as TIFF")
    h, w = a.shape[:2]
    photo, fmt, bits, extra, dtype = _TIFF_SAVE[mode]
    body = (np.packbits(a, axis=1) if mode == "1"
            else a.astype(dtype)).tobytes()
    entries = [(256, 4, (w,)), (257, 4, (h,))]
    if bits != (1,):
        entries.append((258, 3, bits))
    entries += [(259, 3, (1,)), (262, 3, (photo,)), (273, 4, (0,))]
    if len(bits) != 1:
        entries.append((277, 3, (len(bits),)))
    entries += [(278, 4, (h,)), (279, 4, (len(body),)), (284, 3, (1,))]
    if extra is not None:
        entries.append((338, 3, (extra,)))
    if fmt != 1:
        entries.append((339, 3, (fmt,)))
    end = 8 + 2 + 12 * len(entries) + 4
    extras = b"".join(
        v + bytes(len(v) % 2) for v in
        (struct.pack(f"<{len(vals)}{'H' if t == 3 else 'I'}", *vals)
         for _, t, vals in entries) if len(v) > 4)
    at = end + len(extras)
    ifd, pos = [], end
    for tag, t, vals in entries:
        if tag == 273:
            vals = (at,)
        v = struct.pack(f"<{len(vals)}{'H' if t == 3 else 'I'}", *vals)
        if len(v) > 4:
            ifd.append(struct.pack("<HHII", tag, t, len(vals), pos))
            pos += len(v) + len(v) % 2
        else:
            ifd.append(struct.pack("<HHI", tag, t, len(vals))
                       + v + bytes(4 - len(v)))
    return (b"II*\x00" + struct.pack("<IH", 8, len(entries)) + b"".join(ifd)
            + bytes(4) + extras + body)


@functools.lru_cache(maxsize=1)
def _jpeg_encoder():
    from mods_tpu_torch.detectors.mser import build_native
    lib = ctypes.CDLL(build_native(JPEG_ENCODER_SOURCE,
                                   "libmods_jpeg_encode.so"))
    lib.mods_jpeg_encode.restype = ctypes.c_int64
    lib.mods_jpeg_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
    return lib


def _jpeg_bytes(a: np.ndarray, mode: str) -> bytes:
    """PIL's JPEG (``csrc/jpeg_encode.cpp``): bool as gray 0/255 (PIL
    packs mode "1" as "L"), gray, or RGB."""
    if mode not in ("1", "L", "RGB"):
        raise ValueError(f"cannot write mode {mode} as JPEG")
    a = np.ascontiguousarray(a.astype(np.uint8) * 255 if mode == "1" else a)
    h, w = a.shape[:2]
    channels = 3 if mode == "RGB" else 1
    # a block codes in at most 64 x 27 bits, doubled by 0xFF stuffing
    blocks = (-(-h // 16) * -(-w // 16) * 6 if channels == 3
              else -(-h // 8) * -(-w // 8))
    out = np.empty(blocks * 432 + 1024, np.uint8)
    err = ctypes.create_string_buffer(256)
    n = _jpeg_encoder().mods_jpeg_encode(a.ctypes.data, w, h, channels,
                                         out.ctypes.data, out.size, err,
                                         len(err))
    if n < 0:
        raise ValueError(err.value.decode())
    return out[:n].tobytes()


@functools.lru_cache(maxsize=1)
def _webp_encoder():
    from mods_tpu_torch.detectors.mser import build_native
    lib = ctypes.CDLL(build_native(WEBP_ENCODER_SOURCE,
                                   "libmods_webp_encode.so"))
    lib.mods_webp_encode.restype = ctypes.c_int64
    lib.mods_webp_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int]
    return lib


def _webp_bytes(a: np.ndarray, mode: str) -> bytes:
    """A lossless WebP (``csrc/webp_encode.cpp``) of the image that
    ``WebPImagePlugin._convert_frame`` hands libwebp: RGB and RGBA as they
    are, gray+alpha as RGBA, and every other mode converted to RGB as
    PIL's ``convert("RGB")`` does (bool as 0/255, integers clipped to
    0..255, floats truncated toward zero and clipped, NaN as 0)."""
    if mode == "LA":
        a = a[..., [0, 0, 0, 1]]
    elif mode == "1":
        a = a.astype(np.uint8) * 255
    elif mode in ("I;16", "I", "F"):
        a = _to_l(a, mode)
    if a.ndim == 2:
        a = np.repeat(a[..., None], 3, -1)
    a = np.ascontiguousarray(a.astype(np.uint8))
    h, w, c = a.shape
    # every pixel a literal: four codes of at most 15 bits
    out = np.empty(h * w * 8 + 4096, np.uint8)
    err = ctypes.create_string_buffer(256)
    n = _webp_encoder().mods_webp_encode(a.ctypes.data, w, h, c,
                                         out.ctypes.data, out.size, err,
                                         len(err))
    if n < 0:
        raise ValueError(err.value.decode())
    return out[:n].tobytes()


@functools.lru_cache(maxsize=1)
def _gif_encoder():
    from mods_tpu_torch.detectors.mser import build_native
    lib = ctypes.CDLL(build_native(GIF_ENCODER_SOURCE,
                                   "libmods_gif_encode.so"))
    lib.mods_gif_quantize.restype = ctypes.c_int
    lib.mods_gif_quantize.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
        ctypes.c_int]
    lib.mods_gif_lzw.restype = ctypes.c_int64
    lib.mods_gif_lzw.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
        ctypes.c_int]
    return lib


def _quantize(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``csrc/gif_encode.cpp``'s ImagingQuantize(im, 256): the median cut
    of a gray or RGB array, the fast octree of an RGBA one -> (indices
    uint8 (H, W), palette uint8 (N, 4), alpha 255 but for the octree's)."""
    a = np.ascontiguousarray(a, np.uint8)
    h, w = a.shape[:2]
    if not h * w:
        raise ValueError(f"cannot quantize an empty {a.shape} array")
    index = np.empty((h, w), np.uint8)
    palette = np.zeros((256, 4), np.uint8)
    n = ctypes.c_int32()
    err = ctypes.create_string_buffer(256)
    if _gif_encoder().mods_gif_quantize(
            a.ctypes.data, h * w, 1 if a.ndim == 2 else a.shape[2],
            index.ctypes.data, palette.ctypes.data, ctypes.byref(n), err,
            len(err)):
        raise ValueError(err.value.decode())
    return index, palette[:n.value]


def adaptive_palette(array) -> tuple[np.ndarray, np.ndarray]:
    """``Image.fromarray(array).convert("P", palette=Image.Palette.
    ADAPTIVE)``: its indices, uint8 (H, W), and ``getpalette()`` as uint8
    (N, 3).  Gray and RGB arrays go through Pillow's median cut, RGBA
    through its fast octree (N = 256), as ``convert`` sends them."""
    a = np.asarray(array)
    mode = _mode(a)
    if mode not in ("L", "RGB", "RGBA"):
        raise ValueError(f"cannot quantize mode {mode} (L, RGB and RGBA "
                         f"are)")
    index, palette = _quantize(a)
    return index, np.ascontiguousarray(palette[:, :3])


def _to_l(a: np.ndarray, mode: str) -> np.ndarray:
    """PIL's ``convert("L")`` of "LA", "I;16", "I" and "F": the gray
    channel, values clipped to 0..255 (floats truncated toward zero, NaN
    as 0)."""
    if mode == "LA":
        return np.ascontiguousarray(a[..., 0])
    if mode == "F":
        return np.clip(np.trunc(np.nan_to_num(
            a.astype(np.float32), nan=0.0, posinf=255.0, neginf=0.0)),
            0, 255).astype(np.uint8)
    return np.clip(a, 0, 255).astype(np.uint8)


def _gif_table_size(palette: bytes) -> int:
    """GifImagePlugin._get_color_table_size."""
    if not palette:
        return 0
    if len(palette) < 9:
        return 1
    return math.ceil(math.log(len(palette) // 3, 2)) - 1


def _gif_bytes(a: np.ndarray, mode: str) -> bytes:
    """PIL's GIF with its defaults (``optimize=True``): GifImagePlugin's
    ``_normalize_mode`` ("1" and "L" raw, RGB and RGBA through
    ``adaptive_palette``'s quantiser, the rest converted to "L"),
    ``_normalize_palette`` and ``_get_optimize`` (an "L" image always
    remapped to the levels it uses, a "P" image below 512 x 512 pixels
    where its palette has holes or would halve), the global header and
    palette padded to a power of two, version 87a or 89a with a graphic
    control extension where an RGBA palette names a transparent entry,
    and the image data by ``csrc/gif_encode.cpp``'s LZW, interlaced unless
    a side is below 16."""
    h, w = a.shape[:2]
    if not (1 <= w <= 65535 and 1 <= h <= 65535):
        raise ValueError(f"a GIF's sides are 1 to 65535 pixels, not {w} x "
                         f"{h}")
    transparency = None
    if mode in ("RGB", "RGBA"):
        px, pal = _quantize(a)
        if mode == "RGBA":
            clear = np.flatnonzero(pal[:, 3] == 0)
            transparency = int(clear[0]) if clear.size else None
            source = pal.tobytes()
        else:
            source = pal[:, :3].tobytes()
        is_p, bands = True, 4 if mode == "RGBA" else 3
    else:
        px = (a.astype(np.uint8) * 255 if mode == "1" else
              a if mode == "L" else _to_l(a, mode))
        source = bytes(i // 3 for i in range(768))
        is_p, bands = False, 3
        if mode != "1":
            mode = "L"
    # _get_optimize
    used = None
    if is_p or mode == "L":
        if mode == "L" or w * h < 512 * 512:
            levels = np.flatnonzero(np.bincount(px.ravel(), minlength=256))
            if mode == "L" or levels[-1] >= len(levels):
                used = levels
            else:
                size = 1 << (len(source) // bands - 1).bit_length()
                if len(levels) <= size // 2 and size > 2:
                    used = levels
    if used is not None:                                 # remap_palette
        src = np.frombuffer(source, np.uint8).reshape(-1, bands)
        mapping = np.zeros(256, np.uint8)
        mapping[used] = np.arange(len(used))
        px = mapping[px]
        source = src[used].tobytes()
        if transparency is not None:
            hit = np.flatnonzero(used == transparency)
            transparency = int(hit[0]) if hit.size else None
    palette = np.frombuffer(source, np.uint8).reshape(-1, bands)[:, :3] \
        .tobytes()
    size = _gif_table_size(palette)
    palette += bytes(3 * max(0, (2 << size) - len(palette) // 3))
    interlace = 0 if min(w, h) < 16 else 1
    head = (b"GIF" + (b"87a" if transparency is None else b"89a")
            + struct.pack("<HHBBB", w, h, size + 128, 0, 0) + palette)
    if transparency is not None:
        head += b"!\xf9\x04\x01\x00\x00" + bytes([transparency, 0])
    head += b"," + struct.pack("<HHHHBB", 0, 0, w, h, 64 * interlace, 8)
    px = np.ascontiguousarray(px, np.uint8)
    # at most 12 bits of LZW a pixel, and a length byte every 255 bytes
    out = np.empty(2 * w * h + 1024, np.uint8)
    err = ctypes.create_string_buffer(256)
    n = _gif_encoder().mods_gif_lzw(px.ctypes.data, w, h, interlace,
                                    max(65536, 4 * w), out.ctypes.data,
                                    out.size, err, len(err))
    if n < 0:
        raise ValueError(err.value.decode())
    return head + out[:n].tobytes() + b"\x00;"


@functools.lru_cache(maxsize=1)
def _j2k_encoder():
    from mods_tpu_torch.detectors.mser import build_native
    lib = ctypes.CDLL(build_native(J2K_ENCODER_SOURCE,
                                   "libmods_j2k_encode.so",
                                   ("-ffp-contract=off", "-pthread")))
    lib.mods_j2k_encode.restype = ctypes.c_int64
    lib.mods_j2k_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int]
    return lib


def _j2k_bytes(a: np.ndarray, mode: str, jp2: bool = True) -> bytes:
    """PIL's default JPEG 2000 save (``csrc/j2k_encode.cpp``): a .jp2
    file, or with ``jp2`` false a .j2k codestream.  Jpeg2KEncode.c packs
    "L", "LA", "RGB" and "RGBA" as 8-bit components in channel order and
    "I;16" as one 16-bit component; it refuses the other modes."""
    if mode not in ("L", "LA", "RGB", "RGBA", "I;16"):
        raise ValueError(f"cannot write mode {mode} as JPEG 2000")
    h, w = a.shape[:2]
    planes = np.ascontiguousarray(np.moveaxis(a, -1, 0) if a.ndim == 3
                                  else a[None])
    # a lossless stream is about the size of its samples; the encoder
    # gives the length where it needs more room
    cap = planes.nbytes + planes.nbytes // 2 + 4096
    err = ctypes.create_string_buffer(256)
    while True:
        out = np.empty(cap, np.uint8)
        n = _j2k_encoder().mods_j2k_encode(
            planes.ctypes.data, w, h, planes.shape[0],
            16 if mode == "I;16" else 8, int(jp2), out.ctypes.data, cap,
            err, len(err))
        if n < 0:
            raise ValueError(err.value.decode())
        if n <= cap:
            return out[:n].tobytes()
        cap = n


def save_image(path, array) -> None:
    """``Image.fromarray(array).save(path)`` (module docstring)."""
    ext = os.path.splitext(str(path))[1].lower()
    fmt = _SAVE_FORMATS.get(ext)
    if fmt is None:
        if ext in _STUBS:
            raise ValueError(f"{path}: writing {_STUBS[ext]} images is not "
                             f"supported (PIL cannot write them either: no "
                             f"save handler is installed)")
        name = _NOT_WRITTEN.get(ext)
        raise ValueError(
            f"{path}: writing {name} images is not supported "
            f"({', '.join(_SAVE_FORMATS)} are)" if name else
            f"{path}: unknown image file extension {ext!r}")
    a = np.asarray(array)
    mode = _mode(a)
    if mode == "I":          # PIL reads int8 as "I;8" (unsigned) and uint32
        # as "I;32" (its bits as int32)
        a = (a.view(np.uint8) if a.dtype == np.int8 else
             a.view(np.int32) if a.dtype == np.uint32 else a).astype(np.int32)
    if fmt == "PNG":
        if mode == "F":
            raise ValueError(f"{path}: cannot write mode F as PNG")
        # Pillow 12 still writes "I" as 16-bit gray, clipped
        png.write_png(path, np.clip(a, 0, 65535).astype(np.uint16)
                      if mode == "I" else a)
        return
    try:
        if fmt == "JPEG2000":                  # Jpeg2KImagePlugin._save
            data = _j2k_bytes(a, mode, not str(path).endswith(".j2k"))
        elif fmt == "SGI":                     # the name goes in the header
            data = raster.sgi_bytes(a, mode, path)
        elif fmt == "IM":
            data = im.im_bytes(a, mode, path)
        elif fmt == "PDF":                     # the name is the title
            data = pdf.pdf_bytes(a, mode, path)
        else:
            data = {"PNM": _pnm_bytes, "BMP": _bmp_bytes, "DIB": _dib_bytes,
                    "TIFF": _tiff_bytes, "JPEG": _jpeg_bytes,
                    "WEBP": _webp_bytes, "GIF": _gif_bytes,
                    "ICO": raster.ico_bytes, "TGA": raster.tga_bytes,
                    "PCX": raster.pcx_bytes, "QOI": raster.qoi_bytes,
                    "DDS": dds.dds_bytes, "ICNS": icns.icns_bytes,
                    "MSP": raster.msp_bytes, "XBM": x11.xbm_bytes,
                    "BLP": blp.blp_bytes, "EPS": eps.eps_bytes,
                    "PALM": raster.palm_bytes}[fmt](a, mode)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    with open(path, "wb") as f:
        f.write(data)
