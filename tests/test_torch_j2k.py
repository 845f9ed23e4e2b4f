"""Port vs PIL on JPEG 2000 files (.j2k codestreams and .jp2 files), as
the JAX commands open them through PIL (``np.asarray(Image.open(path))``,
Pillow 12.1.0 with OpenJPEG 2.5.4) (CPU).

PIL's ``save`` writes every mode it reads ("L", "LA", "RGB", "RGBA",
"I;16", "CMYK") with its options; the codestreams that it cannot write
(code-block styles, SOP/EPH, POC, RGN, TLM, 1-, 9-, 12- and 16-bit
precision, subsampled components, an sYCC colr box) are written through
ctypes by the libopenjp2 that Pillow bundles (``opj_encode``), and the JP2
boxes that neither writes (pclr/cmap, cdef, res, an ICC colr) by hand
(``edit_jp2h``).  Two of PIL's own files read back otherwise than written,
and the port must give PIL's array: an "I;16" save in tiles (Pillow's
encoder steps a tile's rows by bytes, not samples) and a ``signed=True``
save (OpenJPEG clamps the unsigned samples to the signed range).

Tolerance: none.  ``io/image.py::_read`` must give PIL's array (dtype,
shape, every value) and mode, and ``image_size`` its size, or, where PIL
fails, raise a ValueError that says PIL refuses the file and gives PIL's
reason.

``python tests/test_torch_j2k.py --fixtures`` writes ``chip_smoke.py``
phase 14t-14u's fixtures into ``tests/data/image_io``;
``JAX_PLATFORMS=cpu python tests/test_torch_j2k.py --jax-j2k`` prints the
JAX command's figures on 14u's pair (``chip_smoke.JAX_J2K_REFERENCE``).
"""

import ctypes
import glob
import hashlib
import io
import os
import struct
import sys
import warnings

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import pytest  # noqa: E402
from PIL import Image  # noqa: E402

import chip_smoke  # noqa: E402
from mods_tpu_torch.io.image import _read, image_size, save_image  # noqa
from test_torch_tiff_variants import _zoom, pil_read  # noqa: E402


# ---------------------------------------------------------------------------
# the libopenjp2 that Pillow bundles, through ctypes

_U, _I = ctypes.c_uint32, ctypes.c_int32


class _Poc(ctypes.Structure):
    _fields_ = ([(n, _U) for n in ("resno0", "compno0", "layno1", "resno1",
                                   "compno1", "layno0", "precno0", "precno1")]
                + [("prg1", _I), ("prg", _I), ("progorder", ctypes.c_char * 5),
                   ("tile", _U)]
                + [(n, _I) for n in ("tx0", "tx1", "ty0", "ty1")]
                + [(n, _U) for n in (
                    "layS", "resS", "compS", "prcS", "layE", "resE", "compE",
                    "prcE", "txS", "txE", "tyS", "tyE", "dx", "dy", "lay_t",
                    "res_t", "comp_t", "prc_t", "tx0_t", "ty0_t")])


class _CParams(ctypes.Structure):
    """openjpeg.h's opj_cparameters_t."""
    _fields_ = [
        ("tile_size_on", _I), ("cp_tx0", _I), ("cp_ty0", _I), ("cp_tdx", _I),
        ("cp_tdy", _I), ("cp_disto_alloc", _I), ("cp_fixed_alloc", _I),
        ("cp_fixed_quality", _I), ("cp_matrice", ctypes.c_void_p),
        ("cp_comment", ctypes.c_char_p), ("csty", _I), ("prog_order", _I),
        ("POC", _Poc * 32), ("numpocs", _U), ("tcp_numlayers", _I),
        ("tcp_rates", ctypes.c_float * 100),
        ("tcp_distoratio", ctypes.c_float * 100), ("numresolution", _I),
        ("cblockw_init", _I), ("cblockh_init", _I), ("mode", _I),
        ("irreversible", _I), ("roi_compno", _I), ("roi_shift", _I),
        ("res_spec", _I), ("prcw_init", _I * 33), ("prch_init", _I * 33),
        ("infile", ctypes.c_char * 4096), ("outfile", ctypes.c_char * 4096),
        ("index_on", _I), ("index", ctypes.c_char * 4096),
        ("image_offset_x0", _I), ("image_offset_y0", _I),
        ("subsampling_dx", _I), ("subsampling_dy", _I), ("decod_format", _I),
        ("cod_format", _I), ("jpwl_epc_on", _I), ("jpwl_hprot_MH", _I),
        ("jpwl_hprot_TPH_tileno", _I * 16), ("jpwl_hprot_TPH", _I * 16),
        ("jpwl_pprot_tileno", _I * 16), ("jpwl_pprot_packno", _I * 16),
        ("jpwl_pprot", _I * 16), ("jpwl_sens_size", _I),
        ("jpwl_sens_addr", _I), ("jpwl_sens_range", _I), ("jpwl_sens_MH", _I),
        ("jpwl_sens_TPH_tileno", _I * 16), ("jpwl_sens_TPH", _I * 16),
        ("cp_cinema", _I), ("max_comp_size", _I), ("cp_rsiz", _I),
        ("tp_on", ctypes.c_char), ("tp_flag", ctypes.c_char),
        ("tcp_mct", ctypes.c_char), ("jpip_on", _I),
        ("mct_data", ctypes.c_void_p), ("max_cs_size", _I),
        ("rsiz", ctypes.c_uint16)]


class _CmptParm(ctypes.Structure):
    _fields_ = [(n, _U) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec",
                                  "bpp", "sgnd")]


class _ImageComp(ctypes.Structure):
    _fields_ = ([(n, _U) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec",
                                   "bpp", "sgnd", "resno_decoded", "factor")]
                + [("data", ctypes.POINTER(_I)), ("alpha", ctypes.c_uint16)])


class _Image(ctypes.Structure):
    _fields_ = ([(n, _U) for n in ("x0", "y0", "x1", "y1", "numcomps")]
                + [("color_space", _I), ("comps", ctypes.POINTER(_ImageComp)),
                   ("icc_profile_buf", ctypes.c_void_p),
                   ("icc_profile_len", _U)])


_MSG = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_void_p)
_ERRORS = []
_ON_ERROR = _MSG(lambda msg, _: _ERRORS.append(msg.decode().strip()))


def _openjp2():
    import PIL
    lib = ctypes.CDLL(glob.glob(os.path.join(
        os.path.dirname(PIL.__file__), "..", "pillow.libs",
        "libopenjp2-*.so*"))[0])
    vp = ctypes.c_void_p
    lib.opj_image_create.restype = ctypes.POINTER(_Image)
    lib.opj_image_create.argtypes = [_U, ctypes.POINTER(_CmptParm), _I]
    lib.opj_create_compress.restype = vp
    lib.opj_create_compress.argtypes = [_I]
    lib.opj_set_error_handler.argtypes = [vp, _MSG, vp]
    lib.opj_setup_encoder.argtypes = [vp, ctypes.POINTER(_CParams),
                                      ctypes.POINTER(_Image)]
    lib.opj_encoder_set_extra_options.argtypes = [
        vp, ctypes.POINTER(ctypes.c_char_p)]
    lib.opj_stream_create_default_file_stream.restype = vp
    lib.opj_stream_create_default_file_stream.argtypes = [ctypes.c_char_p,
                                                          _I]
    lib.opj_start_compress.argtypes = [vp, ctypes.POINTER(_Image), vp]
    for fn in (lib.opj_encode, lib.opj_end_compress):
        fn.argtypes = [vp, vp]
    for fn in (lib.opj_stream_destroy, lib.opj_destroy_codec):
        fn.argtypes = [vp]
    lib.opj_image_destroy.argtypes = [ctypes.POINTER(_Image)]
    return lib


def test_encoder_parameters_layout():
    """``_CParams`` is libopenjp2's struct: its defaults land on the
    fields that opj_set_default_encoder_parameters sets."""
    p = _CParams()
    _openjp2().opj_set_default_encoder_parameters(ctypes.byref(p))
    assert (p.numresolution, p.cblockw_init, p.cblockh_init, p.roi_compno,
            p.subsampling_dx, p.subsampling_dy, p.decod_format,
            p.cod_format) == (6, 64, 64, -1, 1, 1, -1, -1)


def opj_encode(tmp_path, planes, prec=8, sgnd=False, dxy=None, jp2=False,
               color_space=0, offset=(0, 0), extra=(), rates=(0,), poc=(),
               **params) -> bytes:
    """The codestream (or JP2 file) that libopenjp2 writes of ``planes``
    (one 2-D array a component, at its subsampled size ``dxy``) with
    opj_cparameters_t's ``params``, quality layers at ``rates`` (0:
    lossless), progression order changes ``poc`` and extra options (e.g.
    "TLM=YES")."""
    lib = _openjp2()
    n = len(planes)
    dxy = dxy or [(1, 1)] * n
    precs = prec if isinstance(prec, (list, tuple)) else [prec] * n
    cp = (_CmptParm * n)()
    for i, a in enumerate(planes):
        cp[i].dx, cp[i].dy = dxy[i]
        cp[i].h, cp[i].w = a.shape
        cp[i].x0 = -(-offset[0] // dxy[i][0])
        cp[i].y0 = -(-offset[1] // dxy[i][1])
        cp[i].prec, cp[i].sgnd = precs[i], int(sgnd)
    img = lib.opj_image_create(n, cp, color_space)
    im = img.contents
    im.x0, im.y0 = offset
    im.x1 = offset[0] + (planes[0].shape[1] - 1) * dxy[0][0] + 1
    im.y1 = offset[1] + (planes[0].shape[0] - 1) * dxy[0][1] + 1
    for i, a in enumerate(planes):
        buf = np.ascontiguousarray(a, np.int32)
        ctypes.memmove(im.comps[i].data, buf.ctypes.data, buf.nbytes)
    p = _CParams()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    p.tcp_numlayers, p.cp_disto_alloc = len(rates), 1
    for i, r in enumerate(rates):
        p.tcp_rates[i] = r
    p.image_offset_x0, p.image_offset_y0 = offset
    for i, c in enumerate(poc):
        p.POC[i].tile = 1
        for k, v in c.items():
            setattr(p.POC[i], k, v)
    p.numpocs = len(poc)
    for k, v in params.items():
        setattr(p, k, v)
    codec = lib.opj_create_compress(2 if jp2 else 0)
    lib.opj_set_error_handler(codec, _ON_ERROR, None)
    path = tmp_path / ("opj.jp2" if jp2 else "opj.j2k")
    try:
        assert lib.opj_setup_encoder(codec, ctypes.byref(p), img), _ERRORS
        if extra:
            opts = (ctypes.c_char_p * (len(extra) + 1))(
                *[e.encode() for e in extra], None)
            assert lib.opj_encoder_set_extra_options(codec, opts), _ERRORS
        st = lib.opj_stream_create_default_file_stream(str(path).encode(), 0)
        ok = (lib.opj_start_compress(codec, img, st)
              and lib.opj_encode(codec, st) and lib.opj_end_compress(codec, st))
        lib.opj_stream_destroy(st)
        assert ok, _ERRORS[-3:]
    finally:
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)
    return path.read_bytes()


# ---------------------------------------------------------------------------
# images, PIL's saves, JP2 boxes

def textured(h, w, channels=None, hi=256, seed=0) -> np.ndarray:
    """Blocks of 4x4 with noise, 0..hi-1 (int64)."""
    rng = np.random.default_rng(seed)
    tail = (channels,) if channels else ()
    base = rng.integers(0, hi, (h // 4 + 2, w // 4 + 2) + tail).astype(float)
    a = np.kron(base, np.ones((4, 4) + ((1,) if channels else ())))[:h, :w]
    a += rng.normal(0, hi / 30, a.shape)
    return np.clip(a, 0, hi - 1).astype(np.int64)


MODE_SHAPES = {"L": None, "LA": 2, "RGB": 3, "RGBA": 4, "I;16": None,
               "CMYK": 4}


def pil_image(mode: str, h: int, w: int, seed=0) -> Image.Image:
    if mode == "I;16":
        return Image.fromarray(textured(h, w, None, 65536, seed)
                               .astype(np.uint16))
    a = textured(h, w, MODE_SHAPES[mode], 256, seed).astype(np.uint8)
    if mode == "CMYK":
        return Image.frombytes("CMYK", (w, h), a.tobytes())
    return Image.fromarray(a)


def pil_save(im: Image.Image, ext: str, **kw) -> bytes:
    b = io.BytesIO()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        im.save(b, "JPEG2000", no_jp2=ext == ".j2k", **kw)
    return b.getvalue()


def boxes(data: bytes, pos=0, end=None) -> list:
    """(type, payload) of each box from ``pos`` to ``end``."""
    end = len(data) if end is None else end
    out = []
    while pos < end:
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        out.append((tbox, data[pos + 8:pos + lbox]))
        pos += lbox
    return out


def box(tbox: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), tbox) + payload


def edit_jp2h(data: bytes, edit) -> bytes:
    """A JP2 file with its jp2h box's sub-boxes ``edit(subs)``: a list of
    (type, payload) -> the list to write."""
    out = b""
    for tbox, payload in boxes(data):
        if tbox == b"jp2h":
            payload = b"".join(box(t, p) for t, p in edit(boxes(payload)))
        out += box(tbox, payload)
    return out


def colr(enumcs: int) -> tuple:
    return b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs)


def pclr(entries: np.ndarray, depth=8) -> tuple:
    """A palette of ``entries`` (NE, NPC) of ``depth`` bits."""
    ne, npc = entries.shape
    return b"pclr", (struct.pack(">HB", ne, npc) + bytes([depth - 1] * npc)
                     + entries.astype(">u1" if depth <= 8 else ">u2")
                     .tobytes())


def cmap(npc: int, direct=()) -> tuple:
    """Channel c from palette column c (and the direct components)."""
    return b"cmap", (b"".join(struct.pack(">HBB", 0, 1, c)
                              for c in range(npc))
                     + b"".join(struct.pack(">HBB", c, 0, 0)
                                for c in direct))


# ---------------------------------------------------------------------------
# the hold

def hold(tmp_path, data: bytes, name="x.j2k", reason=None):
    """The port reads ``data`` as PIL does (array, mode, size), or, where
    PIL fails, refuses it with a ValueError that says PIL refuses it and
    gives PIL's reason (``reason``, or the message PIL raises on load);
    returns PIL's array, or None."""
    p = tmp_path / name
    p.write_bytes(data)
    want = pil_read(data)
    if isinstance(want, Exception):
        with pytest.raises(ValueError) as e:
            _read(p)
        assert "PIL refuses" in str(e.value), e.value
        if reason is None and not isinstance(want, Image.UnidentifiedImageError):
            reason = str(want)
        if reason:
            assert reason in str(e.value), (e.value, want)
        return None
    arr, mode, size = want
    got, got_mode = _read(p)
    assert got.dtype == arr.dtype and got.shape == arr.shape, (
        got.dtype, got.shape, arr.dtype, arr.shape)
    np.testing.assert_array_equal(got, arr)
    assert got_mode == mode
    assert image_size(p) == size
    return arr


# ---------------------------------------------------------------------------
# every mode PIL writes, with each of its save options

SAVES = {
    "default": {}, "irreversible": dict(irreversible=True),
    "layers": dict(quality_layers=[40, 20, 10]),
    "irreversible_layers": dict(irreversible=True, quality_layers=[30, 8]),
    "tiles": dict(tile_size=(32, 24)),
    "tile_offset": dict(tile_size=(32, 32), tile_offset=(5, 7),
                        offset=(9, 11)),
    **{f"progression_{p}": dict(progression=p, quality_layers=[20, 5])
       for p in ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")},
    "precincts": dict(precinct_size=(32, 32), quality_layers=[10, 2]),
    "codeblocks": dict(codeblock_size=(16, 32)),
    "resolutions": dict(num_resolutions=3),
    "mct_irreversible": dict(mct=1, irreversible=True),
    "signed": dict(signed=True), "plt": dict(plt=True),
}


@pytest.mark.parametrize("save", sorted(SAVES))
@pytest.mark.parametrize("ext", [".j2k", ".jp2"])
@pytest.mark.parametrize("mode", sorted(MODE_SHAPES))
def test_pil_saves(tmp_path, mode, ext, save):
    """Each mode PIL writes, as a codestream and as JP2, under each save
    option (45x67 samples: no tile one sample wide, which OpenJPEG's
    irreversible encoder asserts against)."""
    data = pil_save(pil_image(mode, 45, 67), ext, **SAVES[save])
    assert hold(tmp_path, data, "x" + ext) is not None


def test_sixteen_bit_tiles_read_as_pil_reads_them(tmp_path):
    """An "I;16" save in tiles reads back otherwise than written (Pillow's
    encoder steps each tile row by bytes); the port gives PIL's array,
    and 70-80 % of its samples differ from the written ones."""
    im = pil_image("I;16", 64, 80, seed=5)
    got = hold(tmp_path, pil_save(im, ".jp2", tile_size=(16, 16)), "x.jp2")
    differ = np.count_nonzero(got != np.asarray(im)) / got.size
    assert 0.6 < differ < 0.9, differ


@pytest.mark.parametrize("mode", ["L", "I;16", "RGB", "LA"])
def test_signed_saves_read_as_pil_reads_them(tmp_path, mode):
    """``signed=True`` saves the unsigned samples as signed ones, which
    OpenJPEG clamps to the signed range: PIL reads them back offset by
    up to 128 (32768 for "I;16"), and so does the port."""
    im = pil_image(mode, 40, 50, seed=6)
    got = hold(tmp_path, pil_save(im, ".j2k", signed=True))
    d = np.abs(got.astype(np.int64) - np.asarray(im).astype(np.int64))
    assert d.max() == (32768 if mode == "I;16" else 128), d.max()


def _sweep_case(seed: int):
    """A random PIL save: mode, size, options."""
    rng = np.random.default_rng(seed)
    mode = sorted(MODE_SHAPES)[seed % len(MODE_SHAPES)]
    h, w = (int(x) for x in rng.integers(8, 90, 2))
    kw = {}
    if rng.random() < 0.5:
        kw["irreversible"] = True
    if rng.random() < 0.5:
        kw["quality_layers"] = sorted(
            (float(x) for x in rng.integers(1, 60, rng.integers(1, 4))),
            reverse=True)
    if rng.random() < 0.4:
        ts = tuple(int(x) for x in rng.integers(8, 64, 2))
        kw["tile_size"] = ts
        if rng.random() < 0.5:
            to = tuple(int(rng.integers(0, t)) for t in ts)
            kw["tile_offset"] = to
            kw["offset"] = tuple(t + int(rng.integers(0, 5)) for t in to)
    for key, chance, pick in (
            ("progression", 0.5, lambda: str(rng.choice(
                ["LRCP", "RLCP", "RPCL", "PCRL", "CPRL"]))),
            ("num_resolutions", 0.3, lambda: int(rng.integers(1, 5))),
            ("codeblock_size", 0.3, lambda: (int(2 ** rng.integers(2, 7)),
                                             int(2 ** rng.integers(2, 7)))),
            ("precinct_size", 0.3, lambda: (int(2 ** rng.integers(4, 8)),) * 2),
            ("mct", 0.3, lambda: int(rng.integers(0, 2))),
            ("signed", 0.15, lambda: True), ("plt", 0.2, lambda: True)):
        if rng.random() < chance:
            kw[key] = pick()
    return mode, h, w, kw, ".j2k" if rng.random() < 0.5 else ".jp2"


def _encodable(h, w, kw) -> bool:
    """Whether OpenJPEG's irreversible encoder takes PIL's save: it
    asserts (and aborts the process) where a tile's resolution to
    transform is one sample wide or high.  PIL lowers the resolutions to
    fit the nominal tile (Jpeg2KEncode.c), not the edge tiles."""
    if not kw.get("irreversible"):
        return True
    x0, y0 = kw.get("offset", (0, 0))
    tx0, ty0 = kw.get("tile_offset", (0, 0))
    tw, th = kw.get("tile_size", (w, h))
    numres = kw.get("num_resolutions") or 6
    while tw < 1 << (numres - 1) or th < 1 << (numres - 1):
        numres -= 1
    for start, size, t0, t in ((x0, w, tx0, tw), (y0, h, ty0, th)):
        cuts = [start] + [e for e in range(t0, start + size, t)
                          if start < e < start + size] + [start + size]
        for a, b in zip(cuts, cuts[1:]):
            if any(-(-b >> lv) - -(-a >> lv) == 1 for lv in range(numres - 1)):
                return False
    return True


@pytest.mark.parametrize("seed", range(40))
def test_seeded_sweep(tmp_path, seed):
    """40 random saves: a mode, a size from 8 to 89 a side, and a random
    draw of PIL's options (a draw that PIL cannot write is drawn again)."""
    k = seed
    while True:
        mode, h, w, kw, ext = _sweep_case(1000 + k)
        if _encodable(h, w, kw):
            try:
                data = pil_save(pil_image(mode, h, w, seed), ext, **kw)
                break
            except OSError:
                pass
        k += 40
    hold(tmp_path, data, "x" + ext)


@pytest.mark.parametrize("shape", [(1, 1), (1, 9), (9, 1), (2, 2), (3, 5),
                                   (1, 1, 3), (2, 3, 4), (17, 33)])
def test_small_sizes(tmp_path, shape):
    a = textured(shape[0], shape[1], shape[2] if len(shape) > 2 else None,
                 seed=7).astype(np.uint8)
    for ext in (".j2k", ".jp2"):
        hold(tmp_path, pil_save(Image.fromarray(a), ext), "x" + ext)


def test_full_size_lossless(tmp_path):
    """zoom2x_1 (1000x598) as PIL's lossless JP2 reads back as the view."""
    view = _zoom(1)
    got = hold(tmp_path, pil_save(Image.fromarray(view), ".jp2"), "x.jp2")
    np.testing.assert_array_equal(got, view)


# ---------------------------------------------------------------------------
# codestreams that PIL's save cannot write

CBLK_STYLES = {"bypass": 1, "reset": 2, "termall": 4, "vsc": 8, "pterm": 16,
               "segsym": 32, "all": 63, "bypass_vsc": 9,
               "termall_segsym": 36}


@pytest.mark.parametrize("layers", [(0,), (40, 20, 8)], ids=["one", "three"])
@pytest.mark.parametrize("irreversible", [0, 1])
@pytest.mark.parametrize("style", sorted(CBLK_STYLES))
def test_codeblock_styles(tmp_path, style, irreversible, layers):
    planes = [textured(45, 67, seed=8)]
    hold(tmp_path, opj_encode(tmp_path, planes, mode=CBLK_STYLES[style],
                              irreversible=irreversible, rates=layers))


def _rgb(h=45, w=67, seed=9):
    return [textured(h, w, seed=seed + c) for c in range(3)]


CODESTREAMS = {
    "sop_eph": lambda t: opj_encode(t, _rgb(), csty=6, rates=(30, 10, 1)),
    "sop_eph_irreversible": lambda t: opj_encode(
        t, _rgb(), csty=6, irreversible=1, rates=(30, 10, 1)),
    "tlm_tiles": lambda t: opj_encode(
        t, _rgb(), extra=("TLM=YES",), tile_size_on=1, cp_tdx=32, cp_tdy=16,
        numresolution=3),
    "plt_tiles": lambda t: opj_encode(
        t, _rgb(), extra=("PLT=YES",), tile_size_on=1, cp_tdx=32, cp_tdy=16,
        numresolution=3),
    "rgn": lambda t: opj_encode(t, _rgb(), roi_compno=0, roi_shift=5),
    "rgn_irreversible": lambda t: opj_encode(
        t, _rgb(), roi_compno=1, roi_shift=7, irreversible=1, rates=(20,)),
    "bits_1": lambda t: opj_encode(t, [textured(45, 67, hi=2)], prec=1),
    "bits_9_j2k": lambda t: opj_encode(t, [textured(45, 67, hi=512)],
                                       prec=9),
    "bits_9_jp2": lambda t: opj_encode(t, [textured(45, 67, hi=512)],
                                       prec=9, jp2=True, color_space=2),
    "bits_12": lambda t: opj_encode(t, [textured(45, 67, hi=4096)], prec=12),
    "bits_12_rgb": lambda t: opj_encode(
        t, [textured(45, 67, hi=4096, seed=c) for c in range(3)], prec=12),
    "bits_12_signed": lambda t: opj_encode(
        t, [textured(45, 67, hi=4096) - 2048], prec=12, sgnd=True),
    "bits_16": lambda t: opj_encode(t, [textured(45, 67, hi=65536)],
                                    prec=16),
    "signed_rgb": lambda t: opj_encode(t, [x - 128 for x in _rgb()],
                                       sgnd=True),
    "sub_2x2": lambda t: opj_encode(
        t, [textured(48, 64), textured(24, 32, seed=1),
            textured(24, 32, seed=2)], dxy=[(1, 1), (2, 2), (2, 2)]),
    "sub_2x1": lambda t: opj_encode(
        t, [textured(48, 64), textured(48, 32, seed=1),
            textured(48, 32, seed=2)], dxy=[(1, 1), (2, 1), (2, 1)]),
    "sub_odd_size": lambda t: opj_encode(
        t, [textured(47, 63), textured(24, 32, seed=1),
            textured(24, 32, seed=2)], dxy=[(1, 1), (2, 2), (2, 2)]),
    "sub_offset": lambda t: opj_encode(
        t, [textured(48, 64), textured(24, 32, seed=1),
            textured(24, 32, seed=2)], dxy=[(1, 1), (2, 2), (2, 2)],
        offset=(3, 5)),
    "sub_rgba": lambda t: opj_encode(
        t, [textured(48, 64), textured(24, 32, seed=1),
            textured(24, 32, seed=2), textured(48, 64, seed=3)],
        dxy=[(1, 1), (2, 2), (2, 2), (1, 1)]),
    "sub_gray": lambda t: opj_encode(t, [textured(24, 32)], dxy=[(2, 2)]),
    "sycc_jp2": lambda t: opj_encode(t, _rgb(), jp2=True, color_space=3),
    "sycc_sub_jp2": lambda t: opj_encode(
        t, [textured(48, 64), textured(24, 32, seed=1),
            textured(24, 32, seed=2)], dxy=[(1, 1), (2, 2), (2, 2)],
        jp2=True, color_space=3),
    "srgb_sub_jp2": lambda t: opj_encode(
        t, [textured(48, 64), textured(24, 32, seed=1),
            textured(24, 32, seed=2)], dxy=[(1, 1), (2, 2), (2, 2)],
        jp2=True, color_space=1),
    "cmyk_jp2": lambda t: opj_encode(
        t, [textured(45, 67, seed=c) for c in range(4)], jp2=True,
        color_space=5),
    "components_5": lambda t: opj_encode(
        t, [textured(40, 40, seed=c) for c in range(5)]),
    **{f"poc_{p}": (lambda t, p=p: opj_encode(
        t, _rgb(), rates=(30, 10, 1), poc=(
            dict(resno0=0, compno0=0, layno1=2, resno1=3, compno1=3,
                 prg1=p),
            dict(resno0=0, compno0=0, layno1=3, resno1=6, compno1=3,
                 prg1=(p + 2) % 5))))
       for p in range(5)},
}


@pytest.mark.parametrize("case", sorted(CODESTREAMS))
def test_codestreams_pil_cannot_write(tmp_path, case):
    data = CODESTREAMS[case](tmp_path)
    reason = ("unable to determine J2K image mode"
              if case == "components_5" else None)
    got = hold(tmp_path, data, "x.jp2" if data[4:8] == b"jP  " else "x.j2k",
               reason)
    assert (got is None) == (case in ("components_5", "sub_gray")), case


# ---------------------------------------------------------------------------
# JP2 boxes

def _jp2(mode="L", seed=10, **kw) -> bytes:
    return pil_save(pil_image(mode, 30, 41, seed), ".jp2", **kw)


def _palette(n=200, npc=3, seed=11) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, npc))


JP2_BOXES = {
    # a palette: "P" where the colour space is sRGB, as OpenJPEG's tile
    # interface leaves the indices alone
    "pclr_srgb": lambda: edit_jp2h(_jp2(), lambda s: [
        s[0], colr(16), pclr(_palette()), cmap(3)]),
    "pclr_rgba_palette": lambda: edit_jp2h(_jp2(), lambda s: [
        s[0], colr(16), pclr(_palette(npc=4)), cmap(4)]),
    # "PA": a palette over the first of two components
    "pclr_la": lambda: edit_jp2h(_jp2("LA"), lambda s: [
        s[0], colr(16), pclr(_palette()), cmap(3, direct=(1,))]),
    # a palette of greyscale images: PIL's "P" has no unpacker for it
    "pclr_greyscale": lambda: edit_jp2h(_jp2(), lambda s: [
        s[0], colr(17), pclr(_palette()), cmap(3)]),
    # 12-bit entries: PIL keeps "L", which sRGB has no unpacker for
    "pclr_12_bit": lambda: edit_jp2h(_jp2(), lambda s: [
        s[0], colr(16), pclr(_palette() * 16, depth=12), cmap(3)]),
    # PIL's RGBA file holds a cdef box (the alpha channel) already
    "cdef": lambda: edit_jp2h(_jp2("RGB"), lambda s: s + [(
        b"cdef", struct.pack(">H", 3) + b"".join(
            struct.pack(">HHH", c, 0, 3 - c) for c in range(3)))]),
    "second_cdef": lambda: edit_jp2h(_jp2("RGBA"), lambda s: s + [(
        b"cdef", struct.pack(">H", 4) + b"".join(
            struct.pack(">HHH", c, 0, c + 1) for c in range(4)))]),
    "unmapped_enumcs": lambda: edit_jp2h(_jp2("RGB"), lambda s: [
        s[0], colr(99)]),
    "srgb_gray": lambda: edit_jp2h(_jp2(), lambda s: [s[0], colr(16)]),
    "res": lambda: edit_jp2h(_jp2("RGB"), lambda s: s + [(
        b"res ", box(b"resc", struct.pack(">HHHHBB", 72, 1, 96, 1, 2, 2))
        + box(b"resd", struct.pack(">HHHHBB", 300, 1, 300, 1, 0, 0)))]),
    "icc_colr": lambda: edit_jp2h(_jp2("RGB"), lambda s: [
        s[0], (b"colr", bytes([2, 0, 0]) + bytes(128))]),
    "no_colr": lambda: edit_jp2h(_jp2(), lambda s: [s[0]]),
    "two_colr": lambda: edit_jp2h(_jp2("RGB"), lambda s: s + [colr(17)]),
    "greyscale_rgb": lambda: edit_jp2h(_jp2("RGB"), lambda s: [
        s[0], colr(17)]),
    "cmyk_colr": lambda: edit_jp2h(_jp2("RGBA"), lambda s: [s[0], colr(12)]),
    "ihdr_smaller": lambda: edit_jp2h(_jp2(), lambda s: [
        (b"ihdr", struct.pack(">IIHBBBB", 20, 30, 1, 7, 7, 0, 0))] + s[1:]),
    "ihdr_larger": lambda: edit_jp2h(_jp2(), lambda s: [
        (b"ihdr", struct.pack(">IIHBBBB", 40, 50, 1, 7, 7, 0, 0))] + s[1:]),
}


@pytest.mark.parametrize("case", sorted(JP2_BOXES))
def test_jp2_boxes(tmp_path, case):
    got = hold(tmp_path, JP2_BOXES[case](), "x.jp2")
    refused = ("pclr_greyscale", "pclr_12_bit", "greyscale_rgb",
               "ihdr_smaller", "ihdr_larger", "second_cdef", "srgb_gray")
    assert (got is None) == (case in refused), case


# ---------------------------------------------------------------------------
# refusals

def _cut(data: bytes, n: int) -> bytes:
    return data[:n]


REFUSED = {
    "truncated_data": lambda d: _cut(d, len(d) - 40),
    "no_eoc": lambda d: _cut(d, len(d) - 2),
    "truncated_header": lambda d: _cut(d, 60),
    "bad_marker": lambda d: d[:45] + b"\x00\x00" + d[47:],
}


@pytest.mark.parametrize("ext", [".j2k", ".jp2"])
@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals(tmp_path, case, ext):
    """Damaged files that OpenJPEG fails on (strict mode): PIL's "broken
    data stream when reading image file"."""
    data = REFUSED[case](pil_save(pil_image("RGB", 30, 41), ext))
    assert isinstance(pil_read(data), Exception)
    hold(tmp_path, data, "x" + ext)


def _with_marker(data: bytes, marker: int, length: int) -> bytes:
    """``data`` (a one-tile codestream) with a marker segment of Lxxx =
    ``length``: PPM at the end of the main header, PPT at the start of the
    tile-part header (its Psot grown to hold it)."""
    at = data.index(b"\xff\x90")
    seg = struct.pack(">HH", marker, length) + bytes(range(1, length - 1))
    if marker == 0xFF60:
        return data[:at] + seg + data[at:]
    psot, = struct.unpack(">I", data[at + 6:at + 10])
    if psot:
        psot += len(seg)
    return (data[:at + 6] + struct.pack(">I", psot) + data[at + 10:at + 12]
            + seg + data[at + 12:])


@pytest.mark.parametrize("length", [2, 3])
@pytest.mark.parametrize("marker", [0xFF60, 0xFF61], ids=["ppm", "ppt"])
def test_short_packed_headers_refused(tmp_path, marker, length):
    """A PPM or PPT segment too short to hold Zppm (Zppt) and one byte of
    packet headers: OpenJPEG fails ("Error reading PPM/PPT marker")."""
    data = _with_marker(pil_save(pil_image("RGB", 30, 41), ".j2k"),
                        marker, length)
    assert isinstance(pil_read(data), Exception)
    hold(tmp_path, data, "x.j2k")


def test_five_components_refused_with_pils_reason(tmp_path):
    data = opj_encode(tmp_path, [textured(40, 40, seed=c) for c in range(6)])
    p = tmp_path / "x.j2k"
    p.write_bytes(data)
    with pytest.raises(ValueError, match="unable to determine J2K image "
                                         "mode"):
        _read(p)


def test_writing_stays_refused(tmp_path):
    """Writing modes "1", "I" and "F" stays refused to both extensions,
    as PIL refuses them ("broken data stream when writing image file"),
    and leaves no file; tests/test_torch_j2k_write.py holds the modes PIL
    writes."""
    for a in (np.zeros((4, 4), bool), np.zeros((4, 4), np.int32),
              np.zeros((4, 4), np.float32)):
        for name in ("x.j2k", "x.jp2"):
            p = tmp_path / name
            with pytest.raises(ValueError, match="as JPEG 2000"):
                save_image(p, a)
            assert not p.exists()
            with pytest.raises(OSError):
                Image.fromarray(a).save(tmp_path / f"pil_{name}")


def test_jpeg2000_in_tiff_stays_refused(tmp_path):
    """Compression 34712 (JPEG 2000 in TIFF) is still refused by name."""
    from test_torch_tiff_variants import tiff_file
    p = tmp_path / "x.tif"
    p.write_bytes(tiff_file(np.zeros((8, 8), np.uint8),
                            tags={259: (3, [34712])}))
    with pytest.raises(ValueError, match="JPEG 2000"):
        _read(p)


# ---------------------------------------------------------------------------
# the fixtures and the JAX figures of chip_smoke.py phase 14t-14u

def _crops():
    """96x128 crops of zoom2x_1, zoom2x_2 and tilt4_1."""
    views = [_zoom(1), _zoom(2), np.asarray(Image.open(
        os.path.join(REPO, ".parity_work", "tilt4_1.png")).convert("L"))]
    return [v[300:396, 200:328] for v in views]


def j2k_pair(i: int) -> bytes:
    """Phase 14u's file: zoom2x view ``i`` as PIL's lossy JP2."""
    return pil_save(Image.fromarray(_zoom(i)), ".jp2", **J2K_PAIR_SAVE)


J2K_PAIR_SAVE = dict(irreversible=True, quality_layers=[20, 10],
                     tile_size=(256, 256), progression="RPCL")


def fixture_files() -> dict:
    """Phase 14t's fixtures (PIL's saves of the crops) and 14u's pair."""
    g, z2, t4 = _crops()
    rgb = np.stack([g, z2, t4], -1)
    rgba = np.concatenate([rgb, (255 - g)[..., None]], -1)
    return {
        "j2k_gray_53.j2k": pil_save(Image.fromarray(g), ".j2k"),
        "j2k_rgb_97_layers.jp2": pil_save(
            Image.fromarray(rgb), ".jp2", irreversible=True,
            quality_layers=[40, 20, 10]),
        "j2k_rgba_tiles_rpcl.jp2": pil_save(
            Image.fromarray(rgba), ".jp2", tile_size=(48, 40),
            tile_offset=(3, 5), offset=(7, 9), progression="RPCL"),
        "j2k_i16_tiles.jp2": pil_save(
            Image.fromarray(g.astype(np.uint16) * 257), ".jp2",
            tile_size=(32, 32)),
        "j2k_la_signed.j2k": pil_save(
            Image.fromarray(np.stack([g, z2], -1)), ".j2k", signed=True),
        "j2k_cmyk_cprl.jp2": pil_save(
            Image.frombytes("CMYK", (128, 96), rgba.tobytes()), ".jp2",
            progression="CPRL", precinct_size=(32, 32),
            codeblock_size=(16, 16), quality_layers=[10]),
        "zoom2x_1_lossless.jp2": pil_save(Image.fromarray(_zoom(1)), ".jp2"),
        "zoom2x_1_97.jp2": j2k_pair(1),
        "zoom2x_2_97.jp2": j2k_pair(2),
    }


def write_fixtures(d) -> None:
    os.makedirs(d, exist_ok=True)
    for name, data in fixture_files().items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)


def test_j2k_fixtures_are_written_here():
    """The committed fixtures of phase 14t-14u are ``fixture_files``'s
    bytes, and each has PIL's shape, mode and hash in
    ``chip_smoke.FORMAT_FIXTURE_SHA256``; together under 450 KB, of which
    the 1000x598 lossless view is 255 KB."""
    files = fixture_files()
    assert set(files) == set(chip_smoke.J2K_FIXTURES + chip_smoke.J2K_PAIR
                             + (chip_smoke.J2K_LOSSLESS,))
    for name, data in files.items():
        assert (chip_smoke.IMAGE_FIXTURES / name).read_bytes() == data, name
        im = Image.open(io.BytesIO(data))
        a = np.asarray(im)
        got = (a.shape, im.mode, hashlib.sha256(a.tobytes()).hexdigest())
        assert chip_smoke.FORMAT_FIXTURE_SHA256[name] == got, name
    assert sum(len(d) for d in files.values()) < 450_000


def test_cli_match_against_jax(tmp_path, capsys):
    """``cli match`` (LORANSACH, the CVIU-shaped INI files, as phase 14u
    runs it) on zoom2x's pair as 14u's lossy JP2 files, against
    ``mods_tpu.cli.cmd_match`` on the same files: ``test_torch_cli.py``'s
    rule (the same steps, the verified count within 20 %) and the
    tentatives within 20 %, as 14u holds the card."""
    from mods_tpu import cli as jcli
    from mods_tpu_torch import cli as tcli
    from test_torch_cli import load_jax_native
    load_jax_native()
    imgs = [str(chip_smoke.IMAGE_FIXTURES / n) for n in chip_smoke.J2K_PAIR]
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
    ref = chip_smoke.JAX_J2K_REFERENCE
    assert (j["steps"], j["tentatives"], j["matches"]) == (
        ref["steps"], ref["tentatives"], ref["matches"])


def _jax_j2k_main() -> None:
    """The JAX command on phase 14u's pair: ``JAX_J2K_REFERENCE``."""
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
        pair = [str(chip_smoke.IMAGE_FIXTURES / n) for n in chip_smoke.J2K_PAIR]
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
    elif sys.argv[1:] == ["--jax-j2k"]:
        _jax_j2k_main()
    else:
        sys.exit("usage: python tests/test_torch_j2k.py --fixtures | "
                 "--jax-j2k")
