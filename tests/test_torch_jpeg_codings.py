"""YCCK, lossless (SOF3) and arithmetic-coded (SOF9, SOF10) JPEGs read as
PIL 12.1.0 reads them (libjpeg-turbo 3.1 through Pillow's JpegDecode.c):
the port's ``csrc/jpeg_decode.cpp`` against ``np.asarray(Image.open)``.

PIL writes none of these but YCCK (a CMYK save with its Adobe transform
byte set to 2), so the files are built here: ``lossless_jpeg`` codes
samples with a predictor and a point transform (T.81 Annex H: each
difference's category as a Huffman symbol, then its extra bits), and
``arith_jpeg`` is a port of libjpeg's jcarith.c (the QM coder with
``jpeg_aritab``, read out of Pillow's bundled libjpeg) for sequential
and progressive files.  The encoders check themselves: a lossless file
decodes in PIL to its source, and an arithmetic file decodes in PIL to
the array of the Huffman file (``huffman_jpeg``) of the same
coefficients.

Tolerance: none.  ``read_image`` gives PIL's array (dtype, shape, every
value) or, where PIL refuses the file, raises a ValueError naming the
case and PIL's reason; ``image_size`` gives PIL's size wherever PIL
opens the file.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_jpeg_codings.py -q

``python tests/test_torch_jpeg_codings.py --fixtures`` writes
``chip_smoke.py`` phase 14zk's fixtures into ``tests/data/image_io``,
``--hashes`` prints their table (``chip_smoke.CODING_FIXTURE_SHA256``),
and ``JAX_PLATFORMS=cpu python tests/test_torch_jpeg_codings.py
--jax-lossless`` prints the JAX command's figures on 14zl's pair
(``chip_smoke.JAX_LOSSLESS_REFERENCE``).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import io
import os
import struct
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402
from PIL import Image  # noqa: E402

import chip_smoke  # noqa: E402
from mods_tpu_torch.io import image as I  # noqa: E402
from test_torch_ojpeg import (_HUFFMAN, _QUANT, _ZIGZAG, _Bits,  # noqa: E402
                              _codes, _coefficients)


# ---------------------------------------------------------------------------
# lossless JPEG (T.81 Annex H), Huffman-coded

# T.81 K.2's table of a symbol count (chip_smoke.py's, whose own lossless
# writer phase 14zk runs on the card machine without PIL)
optimal_table = chip_smoke.optimal_huffman_table


def dht(tc_th: int, table) -> bytes:
    counts, symbols = table
    return (b"\xff\xc4" + struct.pack(">H", 19 + len(symbols))
            + bytes([tc_th]) + counts + symbols)


def _category(d: int) -> int:
    return abs(d).bit_length()


def _predict(p: int, ra, rb, rc):
    if p == 1:
        return ra
    if p == 2:
        return rb
    if p == 3:
        return rc
    if p == 4:
        return ra + rb - rc
    if p == 5:
        return ra + ((rb - rc) >> 1)
    if p == 6:
        return rb + ((ra - rc) >> 1)
    return (ra + rb) >> 1


def lossless_differences(plane: np.ndarray, predictor: int, pt: int,
                         precision: int = 8, restart_rows: int = 0):
    """The differences of one component's samples (h, w), each sample
    shifted down ``pt`` bits first, predicted as jdpred.c undoes it: the
    first row of the scan and of each restart interval (every
    ``restart_rows`` rows) from its left neighbour and the first sample
    from 2^(P-Pt-1), every other row's first sample from the one above.
    Modulo 2^16, as signed values in -32767..32768."""
    x = (plane.astype(np.int64) >> pt)
    h, w = x.shape
    ra = np.zeros_like(x)
    ra[:, 1:] = x[:, :-1]
    rb = np.zeros_like(x)
    rb[1:] = x[:-1]
    rc = np.zeros_like(x)
    rc[1:, 1:] = x[:-1, :-1]
    pred = _predict(predictor, ra, rb, rc)
    pred[:, 0] = rb[:, 0]
    first = np.zeros(h, bool)
    first[0] = True
    if restart_rows:
        first[::restart_rows] = True
    pred[first, 1:] = x[first, :-1]
    pred[first, 0] = 1 << (precision - pt - 1)
    d = (x - pred) & 0xFFFF
    return np.where(d > 32768, d - 65536, d)


def lossless_jpeg(samples: np.ndarray, predictor: int = 1, pt: int = 0,
                  ids=None, sampling=None, restart: int = 0,
                  app: bytes = b"", precision: int = 8,
                  diffs=None, scans=None, se: int = 0) -> bytes:
    """A lossless (SOF3) JPEG of (h, w[, n]) uint8 component samples in
    one interleaved scan: predictor ``predictor`` (1-7), point transform
    ``pt``, component ``i`` of id ``ids[i]`` sampled ``sampling[i]``
    (its samples then the top-left ones of each h x v cell), restart
    markers every ``restart`` MCUs (the predictor restarts where that is
    a whole number of MCU rows: libjpeg refuses any other), one Huffman
    table a scan from the
    differences' categories.  ``diffs`` (a list of one plane of
    differences a component) codes those instead; ``scans`` (tuples of
    components) splits the components over several scans, each with its
    own table; ``se`` is the scan header's Se."""
    samples = samples[..., None] if samples.ndim == 2 else samples
    h, w, n = samples.shape
    ids = ids or range(1, n + 1)
    sampling = sampling or [(1, 1)] * n
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    mx, my = -(-w // hmax), -(-h // vmax)

    def planes(c, rows):
        """Component c's differences, restarting every ``rows`` rows,
        over whole MCUs: the dummy samples past the edges code a 0."""
        hs, vs = sampling[c]
        cw, ch = -(-w * hs // hmax), -(-h * vs // vmax)
        sub = samples[::vmax // vs, ::hmax // hs, c][:ch, :cw]
        d = diffs[c] if diffs is not None else lossless_differences(
            sub, predictor, pt, precision, rows)
        full = np.zeros((my * vs, mx * hs), np.int64)
        full[:d.shape[0], :d.shape[1]] = d
        return full

    scans = scans or [tuple(range(n))]
    body = b""
    for comps in scans:
        # one component alone goes over its own samples (an MCU row a
        # row), several by MCUs (an MCU row v rows of each)
        if len(comps) == 1:
            c = comps[0]
            hs, vs = sampling[c]
            cw, ch = -(-w * hs // hmax), -(-h * vs // vmax)
            rows = restart // cw if restart and restart % cw == 0 else 0
            seq = [(c, int(v)) for v in planes(c, rows)[:ch, :cw].ravel()]
            per_mcu = 1
        else:
            full = {c: planes(c, restart // mx * sampling[c][1]
                              if restart and restart % mx == 0 else 0)
                    for c in comps}
            seq = []
            for j in range(my):
                for i in range(mx):
                    for c in comps:
                        hs, vs = sampling[c]
                        cell = full[c][j * vs:(j + 1) * vs,
                                       i * hs:(i + 1) * hs]
                        seq.extend((c, int(v)) for v in cell.ravel())
            per_mcu = sum(sampling[c][0] * sampling[c][1] for c in comps)
        cats = [16 if d == 32768 else _category(d) for _, d in seq]
        table = optimal_table({s: cats.count(s) for s in set(cats)})
        code = _codes(table)
        bits, segments = _Bits(), []
        for k, ((_, d), s) in enumerate(zip(seq, cats)):
            if restart and k and k % (restart * per_mcu) == 0:
                segments.append(bits.flush())
            bits.put(*code[s])
            if 0 < s < 16:
                bits.put(d if d >= 0 else d - 1 + (1 << s), s)
        segments.append(bits.flush())
        body += (dht(0x00, table)
                 + b"\xff\xda" + struct.pack(">HB", 6 + 2 * len(comps),
                                              len(comps))
                 + b"".join(bytes([ids[c], 0]) for c in comps)
                 + bytes([predictor, se, pt]) + _join(segments))
    head = (b"\xff\xd8" + app
            + b"\xff\xc3" + struct.pack(">HBHHB", 8 + 3 * n, precision, h,
                                        w, n)
            + b"".join(bytes([ids[c], sampling[c][0] << 4 | sampling[c][1],
                              0]) for c in range(n))
            + (b"\xff\xdd\x00\x04" + struct.pack(">H", restart)
               if restart else b""))
    return head + body + b"\xff\xd9"


def _join(segments) -> bytes:
    """Entropy-coded segments joined by RST0..7 in turn."""
    out = b""
    for k, s in enumerate(segments):
        out += (bytes([0xFF, 0xD0 + (k - 1) % 8]) if k else b"") + s
    return out


# ---------------------------------------------------------------------------
# DCT coefficients, then Huffman or arithmetic coding (jcarith.c)

def coefficients(samples: np.ndarray, sampling, quality: int = 75):
    """Each component's quantised coefficients in zigzag order (block
    rows, block columns, 64) over whole MCUs, its quantisation table
    (zigzag order) and the components' tables: test_torch_ojpeg's
    baseline_jpeg's, whose Huffman file serves as the reference."""
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
    return coefs, qt, tq


def _frame(sof: int, shape, sampling, qt, tq, ids=None) -> bytes:
    h, w, n = shape
    ids = ids or list(range(1, n + 1))
    return (b"".join(b"\xff\xdb\x00\x43" + bytes([t])
                     + bytes(qt[t].astype(np.uint8)) for t in sorted(set(tq)))
            + bytes([0xFF, sof]) + struct.pack(">HBHHB", 8 + 3 * n, 8, h, w,
                                                 n)
            + b"".join(bytes([ids[c], sampling[c][0] << 4 | sampling[c][1],
                              tq[c]]) for c in range(n)))


def _sos(comps, tables, ss=0, se=63, ah=0, al=0) -> bytes:
    return (b"\xff\xda" + struct.pack(">HB", 6 + 2 * len(comps), len(comps))
            + b"".join(bytes([c + 1, t]) for c, t in zip(comps, tables))
            + bytes([ss, se, ah << 4 | al]))


def _mcu_blocks(coefs, sampling, comps, size):
    """The blocks of a scan over ``comps`` in MCU order, each with its
    place in the scan's component list: one component alone goes block
    by block over its own blocks of an image of ``size`` (h, w), not the
    padding of the last MCUs; several by whole MCUs."""
    if len(comps) == 1:
        c = comps[0]
        hs, vs = sampling[c]
        hmax = max(s[0] for s in sampling)
        vmax = max(s[1] for s in sampling)
        h, w = size
        return [[(0, coefs[c][y, x])]
                for y in range(-(-h * vs // (8 * vmax)))
                for x in range(-(-w * hs // (8 * hmax)))]
    mcus = []
    bh, bw = coefs[comps[0]].shape[:2]
    my = bh // sampling[comps[0]][1]
    mx = bw // sampling[comps[0]][0]
    for j in range(my):
        for i in range(mx):
            mcu = []
            for k, c in enumerate(comps):
                hs, vs = sampling[c]
                for v in range(vs):
                    for u in range(hs):
                        mcu.append((k, coefs[c][j * vs + v, i * hs + u]))
            mcus.append(mcu)
    return mcus


def huffman_jpeg(samples: np.ndarray, sampling, quality: int = 75,
                 app: bytes = b"") -> bytes:
    """The baseline JPEG (Annex K tables) of ``coefficients(samples,
    sampling, quality)``: one interleaved scan, ``app`` (an Adobe marker,
    say) the only marker before the frame."""
    shape = samples.shape if samples.ndim == 3 else samples.shape + (1,)
    n = shape[2]
    coefs, qt, tq = coefficients(samples, sampling, quality)
    codes = [(_codes(_HUFFMAN[min(c, 1)]), _codes(_HUFFMAN[0x10 | min(c, 1)]))
             for c in range(n)]
    bits, pred = _Bits(), [0] * n
    for mcu in _mcu_blocks(coefs, sampling, list(range(n)), shape[:2]):
        for c, z in mcu:
            dc, ac = codes[c]
            diff, pred[c] = int(z[0]) - pred[c], int(z[0])
            s = _category(diff)
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
                s = _category(int(a))
                bits.put(*ac[run << 4 | s])
                bits.put(int(a) if a > 0 else int(a) - 1 + (1 << s), s)
                run = 0
            if run:
                bits.put(*ac[0])
    tables = b"".join(dht(k, t) for k, t in sorted(_HUFFMAN.items())
                      if k & 15 < min(n, 2))
    return (b"\xff\xd8" + app + _frame(0xC0, shape, sampling, qt, tq)
            + tables
            + _sos(range(n), [0x11 * min(c, 1) for c in range(n)])
            + bits.flush() + b"\xff\xd9")


@functools.lru_cache(maxsize=1)
def aritab() -> tuple:
    """libjpeg's jpeg_aritab (jaricom.c), the QM coder's 114 states:
    Qe << 16 | next state after an MPS << 8 | switch << 7 | after an
    LPS, read out of Pillow's bundled libjpeg."""
    libs = os.path.join(os.path.dirname(os.path.dirname(Image.__file__)),
                        "pillow.libs")
    lib = ctypes.CDLL(glob.glob(os.path.join(libs, "libjpeg-*.so*"))[0])
    return tuple((ctypes.c_long * 114).in_dll(lib, "jpeg_aritab"))


class QMEncoder:
    """jcarith.c's arith_encode and finish_pass (with its "Pacman"
    termination): binary decisions coded into ``out``."""

    def __init__(self):
        self.tab = aritab()
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc = 0, 0x10000, 0, 0
        self.ct, self.buffer = 11, -1

    def _emit_pending(self, byte):
        if self.zc:
            self.out += bytes(self.zc)
            self.zc = 0
        self.out.append(byte)
        if byte == 0xFF:
            self.out.append(0)

    def encode(self, st: bytearray, i: int, val: int):
        sv = st[i]
        qe = self.tab[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        a = self.a - qe
        if val != sv >> 7:
            if a >= qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if a >= 0x8000:
                self.a = a
                return
            if a < qe:
                self.c += a
                a = qe
            st[i] = (sv & 0x80) ^ nm
        c, ct = self.c, self.ct
        while True:
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                temp = c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._emit_pending(self.buffer + 1)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._emit_pending(self.buffer)
                    if self.sc:
                        if self.zc:
                            self.out += bytes(self.zc)
                            self.zc = 0
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                c &= 0x7FFFF
                ct += 8
            if a >= 0x8000:
                break
        self.a, self.c, self.ct = a, c, ct

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._emit_pending(self.buffer + 1)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._emit_pending(self.buffer)
            if self.sc:
                if self.zc:
                    self.out += bytes(self.zc)
                    self.zc = 0
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            if self.zc:
                self.out += bytes(self.zc)
                self.zc = 0
            self._emit_pending((self.c >> 19) & 0xFF)
            if self.c & 0x7F800:
                self._emit_pending((self.c >> 11) & 0xFF)
        out, self.out = bytes(self.out), bytearray()
        self.reset()
        return out


class ArithScan:
    """jcarith.c's MCU coders for one scan: sequential (``encode_mcu``)
    or one of the four progressive passes, with DAC conditioning ``dc_lu``
    {table: (L, U)} and ``ac_k`` {table: Kx}, and restarts every
    ``restart`` MCUs (statistics and coder reset)."""

    def __init__(self, comps, dc_tbl, ac_tbl, dc_lu=None, ac_k=None,
                 progressive=False, ss=0, se=63, ah=0, al=0, restart=0):
        self.comps, self.dc_tbl, self.ac_tbl = comps, dc_tbl, ac_tbl
        self.dc_lu, self.ac_k = dc_lu or {}, ac_k or {}
        self.prog, self.ss, self.se, self.ah, self.al = (progressive, ss, se,
                                                         ah, al)
        self.restart = restart
        self.qm = QMEncoder()
        self.fixed = bytearray([113])
        self.segments = []
        self._reset_stats()

    def _reset_stats(self):
        self.dc_stats = {t: bytearray(64) for t in self.dc_tbl}
        self.ac_stats = {t: bytearray(256) for t in self.ac_tbl}
        self.last_dc = [0] * len(self.comps)
        self.dc_context = [0] * len(self.comps)

    def code(self, mcus) -> bytes:
        for k, mcu in enumerate(mcus):
            if self.restart and k and k % self.restart == 0:
                self.segments.append(self.qm.finish())
                self._reset_stats()
            if not self.prog:
                for ci, z in mcu:
                    self._dc(ci, int(z[0]))
                    self._ac_seq(ci, z)
            elif self.ss == 0 and self.ah == 0:
                for ci, z in mcu:
                    self._dc(ci, int(z[0]) >> self.al)
            elif self.ss == 0:
                for ci, z in mcu:
                    self.qm.encode(self.fixed, 0, (int(z[0]) >> self.al) & 1)
            elif self.ah == 0:
                self._ac_first(*mcu[0])
            else:
                self._ac_refine(*mcu[0])
        self.segments.append(self.qm.finish())
        return _join(self.segments)

    def _dc(self, ci, value):
        enc, tbl = self.qm.encode, self.dc_tbl[ci]
        st = self.dc_stats[tbl]
        s0 = self.dc_context[ci]
        v = value - self.last_dc[ci]
        if v == 0:
            enc(st, s0, 0)
            self.dc_context[ci] = 0
            return
        self.last_dc[ci] = value
        enc(st, s0, 1)
        if v > 0:
            enc(st, s0 + 1, 0)
            i = s0 + 2
            self.dc_context[ci] = 4
        else:
            v = -v
            enc(st, s0 + 1, 1)
            i = s0 + 3
            self.dc_context[ci] = 8
        m = 0
        v -= 1
        if v:
            enc(st, i, 1)
            m = 1
            v2 = v
            i = 20
            v2 >>= 1
            while v2:
                enc(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        enc(st, i, 0)
        lo, hi = self.dc_lu.get(tbl, (0, 1))
        if m < (1 << lo) >> 1:
            self.dc_context[ci] = 0
        elif m > (1 << hi) >> 1:
            self.dc_context[ci] += 8
        i += 14
        m >>= 1
        while m:
            enc(st, i, 1 if m & v else 0)
            m >>= 1

    def _magnitude(self, st, i, k, v, tbl):
        enc = self.qm.encode
        m = 0
        v -= 1
        if v:
            enc(st, i, 1)
            m = 1
            v2 = v >> 1
            if v2:
                enc(st, i, 1)
                m <<= 1
                i = 189 if k <= self.ac_k.get(tbl, 5) else 217
                v2 >>= 1
                while v2:
                    enc(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
        enc(st, i, 0)
        i += 14
        m >>= 1
        while m:
            enc(st, i, 1 if m & v else 0)
            m >>= 1

    def _ac_seq(self, ci, z):
        enc, tbl = self.qm.encode, self.ac_tbl[ci]
        st = self.ac_stats[tbl]
        nz = np.flatnonzero(z[1:])
        ke = int(nz[-1]) + 1 if len(nz) else 0
        k = 1
        while k <= ke:
            i = 3 * (k - 1)
            enc(st, i, 0)
            while z[k] == 0:
                enc(st, i + 1, 0)
                i += 3
                k += 1
            enc(st, i + 1, 1)
            v = int(z[k])
            enc(self.fixed, 0, 0 if v > 0 else 1)
            self._magnitude(st, i + 2, k, abs(v), tbl)
            k += 1
        if k <= 63:
            enc(st, 3 * (k - 1), 1)

    def _ac_first(self, ci, z):
        enc, tbl = self.qm.encode, self.ac_tbl[ci]
        st = self.ac_stats[tbl]
        t = np.abs(z.astype(np.int64)) >> self.al
        nz = np.flatnonzero(t[self.ss:self.se + 1])
        ke = self.ss + int(nz[-1]) if len(nz) else 0
        k = self.ss
        while k <= ke:
            i = 3 * (k - 1)
            enc(st, i, 0)
            while t[k] == 0:
                enc(st, i + 1, 0)
                i += 3
                k += 1
            enc(st, i + 1, 1)
            enc(self.fixed, 0, 0 if z[k] > 0 else 1)
            self._magnitude(st, i + 2, k, int(t[k]), tbl)
            k += 1
        if k <= self.se:
            enc(st, 3 * (k - 1), 1)

    def _ac_refine(self, ci, z):
        enc, tbl = self.qm.encode, self.ac_tbl[ci]
        st = self.ac_stats[tbl]
        t = np.abs(z.astype(np.int64)) >> self.al
        nz = np.flatnonzero(t[self.ss:self.se + 1])
        ke = self.ss + int(nz[-1]) if len(nz) else 0
        prev = np.flatnonzero((t >> 1)[1:ke + 1])
        kex = int(prev[-1]) + 1 if len(prev) else 0
        k = self.ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                enc(st, i, 0)
            while True:
                v = int(t[k])
                if v:
                    if v >> 1:
                        enc(st, i + 2, v & 1)
                    else:
                        enc(st, i + 1, 1)
                        enc(self.fixed, 0, 0 if z[k] > 0 else 1)
                    break
                enc(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= self.se:
            enc(st, 3 * (k - 1), 1)


# a progressive script to full precision: libjpeg's jpeg_simple_progression
# for three components, one for one
SCRIPT_3 = [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
            ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
            ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
            ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]
SCRIPT_1 = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
            ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]


def dac(dc_lu=None, ac_k=None) -> bytes:
    body = b"".join(bytes([t, u << 4 | lo]) for t, (lo, u) in
                    sorted((dc_lu or {}).items()))
    body += b"".join(bytes([16 + t, k]) for t, k in sorted((ac_k or
                                                            {}).items()))
    return b"\xff\xcc" + struct.pack(">H", 2 + len(body)) + body if body \
        else b""


def arith_jpeg(samples: np.ndarray, sampling, quality: int = 75,
               progressive: bool = False, script=None, restart: int = 0,
               dc_lu=None, ac_k=None, app: bytes = b"", gap: bytes = b"",
               tables=None) -> bytes:
    """An arithmetic-coded JPEG (SOF9, or SOF10 with ``progressive``) of
    ``coefficients(samples, sampling, quality)``: one interleaved scan, or
    the progressive ``script`` of (components, Ss, Se, Ah, Al) scans;
    conditioning tables 0 (luminance) and 1 (chrominance), their DAC
    values ``dc_lu`` {table: (L, U)} and ``ac_k`` {table: Kx} in a DAC
    segment, ``gap`` (an APP segment, say) between each two scans."""
    shape = samples.shape if samples.ndim == 3 else samples.shape + (1,)
    n = shape[2]
    coefs, qt, tq = coefficients(samples, sampling, quality)
    tables = tables or [min(c, 1) for c in range(n)]
    if progressive:
        script = script or (SCRIPT_3 if n == 3 else SCRIPT_1 if n == 1
                            else [(tuple(range(n)), 0, 0, 0, 0)]
                            + [((c,), 1, 63, 0, 0) for c in range(n)])
    else:
        script = [(tuple(range(n)), 0, 63, 0, 0)]
    out = (b"\xff\xd8" + app
           + _frame(0xCA if progressive else 0xC9, shape, sampling, qt, tq)
           + dac(dc_lu, ac_k)
           + (b"\xff\xdd\x00\x04" + struct.pack(">H", restart)
              if restart else b""))
    for s, (comps, ss, se, ah, al) in enumerate(script):
        scan = ArithScan(list(comps), [tables[c] for c in comps],
                         [tables[c] for c in comps], dc_lu, ac_k,
                         progressive, ss, se, ah, al, restart)
        out += (gap if s else b"") + _sos(
            comps, [tables[c] * 0x11 for c in comps], ss, se, ah, al)
        out += scan.code(_mcu_blocks(coefs, sampling, list(comps),
                                     shape[:2]))
    return out + b"\xff\xd9"


# ---------------------------------------------------------------------------
# sources, markers and other containers

def _view(name: str = "zoom2x_1") -> np.ndarray:
    return np.asarray(Image.open(chip_smoke.PAIRS / f"{name}.png"))


def source(shape, seed: int = 0) -> np.ndarray:
    """Crops of the zoom2x and tilt4 views as components, some noise on
    them: (h, w) for one component, else (h, w, n)."""
    h, w = shape[:2]
    n = shape[2] if len(shape) == 3 else 1
    rng = np.random.default_rng(seed)
    views = [_view("zoom2x_1"), _view("tilt4_1")]
    planes = []
    for c in range(n):
        v = views[c % 2]
        y = int(rng.integers(0, v.shape[0] - h))
        x = int(rng.integers(0, v.shape[1] - w))
        noise = rng.integers(-6, 7, (h, w))
        planes.append(np.clip(v[y:y + h, x:x + w] + noise, 0, 255))
    a = np.stack(planes, -1).astype(np.uint8)
    return a[..., 0] if n == 1 else a


JFIF = b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"


def adobe(transform: int) -> bytes:
    """An Adobe APP14 marker (version 100, no flags) of ``transform``."""
    return b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" + bytes(
        [transform])


def app1(size: int) -> bytes:
    """An APP1 segment of ``size`` bytes in all, zeros: room to move what
    follows past one of PIL's 64 KiB reads."""
    return b"\xff\xe1" + struct.pack(">H", size - 2) + bytes(size - 4)


def pil_cmyk_as_ycck(a: np.ndarray, transform: int = 2) -> bytes:
    """PIL's CMYK JPEG of RGB ``a`` with the Adobe transform byte set."""
    f = io.BytesIO()
    Image.fromarray(a).convert("CMYK").save(f, "JPEG", quality=90)
    data = bytearray(f.getvalue())
    data[data.index(b"Adobe") + 11] = transform
    return bytes(data)


def jpeg_in_tiff(stream: bytes, shape, photometric: int, sub=None) -> bytes:
    """A JPEG-in-TIFF (compression 7) of one strip, ``stream`` itself."""
    from test_torch_tiff_variants import assemble
    h, w = shape[:2]
    n = shape[2] if len(shape) == 3 else 1
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * n), 259: (3, [7]),
         262: (3, [photometric]), 277: (3, [n]), 278: (4, [h]),
         284: (3, [1])}
    if sub:
        t[530] = (3, list(sub))
    return assemble(t, [stream])


def ojpeg_strip(stream: bytes, shape) -> bytes:
    """An old-style JPEG TIFF (compression 6) of a gray image whose one
    strip holds the whole stream (no JPEGInterchangeFormat)."""
    from test_torch_ojpeg import tiff_bytes
    h, w = shape
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [8]), 259: (3, [6]),
         262: (3, [1]), 277: (3, [1]), 278: (4, [h]),
         273: (4, lambda o: o or [0]), 279: (4, [len(stream)])}
    return tiff_bytes(t, [stream])


def mpo(frames) -> bytes:
    """An MPO of JPEG ``frames``: an APP2 "MPF" index (version 0100, the
    frames' sizes and offsets, big-endian) after the first one's SOI."""
    n = len(frames)
    ifd = (struct.pack(">H", 3) + struct.pack(">HHI4s", 0xB000, 7, 4, b"0100")
           + struct.pack(">HHII", 0xB001, 4, 1, n)
           + struct.pack(">HHII", 0xB002, 7, 16 * n, 8 + 2 + 3 * 12 + 4)
           + struct.pack(">I", 0))
    length = 2 + 4 + 8 + len(ifd) + 16 * n
    size0 = len(frames[0]) + 2 + length
    entries, offset = struct.pack(">IIIHH", 0x20030000, size0, 0, 0, 0), size0
    for f in frames[1:]:
        # offsets count from the index's TIFF header, 10 bytes in
        entries += struct.pack(">IIIHH", 0, len(f), offset - 10, 0, 0)
        offset += len(f)
    app = (b"\xff\xe2" + struct.pack(">H", length) + b"MPF\x00"
           + b"MM\x00\x2a\x00\x00\x00\x08" + ifd + entries)
    return frames[0][:2] + app + frames[0][2:] + b"".join(frames[1:])


# ---------------------------------------------------------------------------
# holding the port to PIL

def hold(tmp_path, data: bytes, name: str = "x.jpg", match: str = ""):
    """``data`` read by PIL and by the port (``io/image.py::_read``): the
    same array bit for bit and the same mode, and PIL's size from
    ``image_size``; or, where PIL refuses it, a ValueError that says PIL
    refuses it and matches ``match``.  Returns PIL's array, or None."""
    p = tmp_path / name
    p.write_bytes(data)
    try:
        im = Image.open(p)
    except OSError:
        im = None
    try:
        want = np.asarray(im) if im is not None else None
    except OSError:
        want = None
    if im is not None and p.suffix != ".tif":
        assert I.image_size(p) == im.size
    if want is None:
        with pytest.raises(ValueError) as e:
            I._read(p)
        assert "PIL refuses it" in str(e.value) and match in str(e.value), \
            str(e.value)
        return None
    got, mode = I._read(p)
    assert mode == im.mode
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return want


def aritab_of_source() -> tuple:
    """``csrc/jpeg_decode.cpp``'s kAritab, read out of the source."""
    import re
    text = open(I.JPEG_SOURCE).read()
    body = text[text.index("kAritab[114] = {"):]
    body = body[:body.index("};")]
    return tuple(int(v, 16) for v in re.findall(r"0x[0-9a-f]{8}", body))


def test_aritab_is_libjpegs():
    """The decoder's QM probability table is libjpeg's jpeg_aritab, as
    Pillow's bundled libjpeg-turbo exports it (114 entries, the first
    0x5a1d0181)."""
    assert aritab()[0] == 0x5A1D0181
    assert aritab_of_source() == aritab()


# ---------------------------------------------------------------------------
# YCCK

@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (2, 2)])
@pytest.mark.parametrize("transform", [2, 1])
def test_ycck(tmp_path, sampling, transform):
    """Four components with an Adobe transform other than 0 are YCCK
    (jdapimin.c: 2 YCCK, any other YCCK with a warning): Y, Cb and Cr
    to RGB, each of C, M, Y 255 less that, K as stored, then PIL's
    "CMYK;I" inversion; Y and K sampled ``sampling``, Huffman- and
    arithmetic-coded, and PIL's own CMYK save relabelled."""
    a = source((37, 53, 4), 1)
    s = [sampling, (1, 1), (1, 1), sampling]
    want = hold(tmp_path, huffman_jpeg(a, s, app=adobe(transform)))
    assert want is not None and want.shape == (37, 53, 4)
    # the same with transform 0 is CMYK: YCCK converts
    assert not np.array_equal(want, hold(tmp_path, huffman_jpeg(
        a, s, app=adobe(0))))
    hold(tmp_path, arith_jpeg(a, s, app=adobe(transform)))
    hold(tmp_path, pil_cmyk_as_ycck(a[..., :3], transform))


# ---------------------------------------------------------------------------
# lossless (SOF3)

@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_predictors(tmp_path, predictor):
    """Gray samples through each predictor at point transforms 0-3: PIL
    decodes the encoder's file to its source (shifted by Pt), and the port
    to PIL's array."""
    a = source((37, 53), predictor)
    for pt in range(4):
        want = hold(tmp_path, lossless_jpeg(a, predictor, pt))
        np.testing.assert_array_equal(want, (a >> pt) << pt)


LOSSLESS_COLOUR = {
    # libjpeg-turbo reads 3 components without markers as RGB in lossless
    # mode, whatever their ids, and converts no colour
    "ids 1 2 3": dict(ids=(1, 2, 3)),
    "ids R G B": dict(ids=b"RGB"),
    "Adobe 0": dict(app=adobe(0)),
    "JFIF": dict(app=JFIF),
    "Adobe 1": dict(app=adobe(1)),
    "Adobe 2": dict(app=adobe(2)),
    "CMYK": dict(n=4),
    "CMYK Adobe 0": dict(n=4, app=adobe(0)),
    "YCCK Adobe 2": dict(n=4, app=adobe(2)),
}


@pytest.mark.parametrize("case", sorted(LOSSLESS_COLOUR))
def test_lossless_colour(tmp_path, case):
    """The colour space libjpeg guesses for a lossless file: RGB and CMYK
    are read as stored (CMYK inverted as PIL inverts it); YCbCr (JFIF,
    Adobe 1 or 2) and YCCK are refused as PIL refuses them."""
    kw = dict(LOSSLESS_COLOUR[case])
    n = kw.pop("n", 3)
    a = source((29, 41, n), 2)
    want = hold(tmp_path, lossless_jpeg(a, 4, 0, **kw), match="lossless")
    if case in ("JFIF", "Adobe 1", "Adobe 2", "YCCK Adobe 2"):
        assert want is None
    else:
        np.testing.assert_array_equal(want, a if n == 3 else 255 - a)


LOSSLESS_LAYOUTS = {
    "Y 2x1": dict(sampling=[(2, 1), (1, 1), (1, 1)]),
    "Y 2x2": dict(sampling=[(2, 2), (1, 1), (1, 1)]),
    "Y 1x2": dict(sampling=[(1, 2), (1, 1), (1, 1)]),
    "Cb 2x1": dict(sampling=[(1, 1), (2, 1), (1, 1)]),
    "Y 4x2": dict(sampling=[(4, 2), (1, 1), (1, 1)]),
    "Y 2x2 restart": dict(sampling=[(2, 2), (1, 1), (1, 1)], restart=54),
    "restart every row": dict(restart=53),
    "restart every 3 rows": dict(restart=159),
    "a scan a component": dict(scans=[(0,), (1,), (2,)]),
    # a restart every 2 rows of Y, every 4 of Cb and Cr
    "a scan a component, Y 2x2, restart": dict(
        sampling=[(2, 2), (1, 1), (1, 1)], scans=[(0,), (1,), (2,)],
        restart=108, shape=(37, 54, 3)),
    # a restart every row of Y, but jddiffct.c undoes Y's two rows of an
    # iMCU row once both are read: the second is no first row for libjpeg
    "a scan a component, Y 2x2, restart every row": dict(
        sampling=[(2, 2), (1, 1), (1, 1)], scans=[(0,), (1,), (2,)],
        restart=54, shape=(37, 54, 3)),
    "Y then Cb and Cr": dict(scans=[(0,), (1, 2)], predictor=6),
    # refused as PIL refuses them
    "Y 4x2 Cb 2x1": dict(sampling=[(4, 2), (2, 1), (1, 1)]),
    "restart of 10 MCUs": dict(restart=10),
    "Se 5": dict(se=5),
    "12-bit": dict(precision=12),
}


@pytest.mark.parametrize("case", sorted(LOSSLESS_LAYOUTS))
def test_lossless_layouts(tmp_path, case):
    """Sampling factors (upsampled by replication: no fancy upsampling
    with 1-sample blocks), restart intervals, a scan a component; a
    decoded file is its source, upsampled.  An MCU of more than 10
    blocks, a restart interval that is no whole number of MCU rows, a
    bad Se and 12-bit samples are refused with PIL's reason."""
    kw = dict(LOSSLESS_LAYOUTS[case])
    a = source(kw.pop("shape", (37, 53, 3)), 3)
    if kw.get("precision") == 12:
        a = a >> 4
    data = lossless_jpeg(a, kw.pop("predictor", 7), 0, **kw)
    want = hold(tmp_path, data)
    if case in ("Y 4x2 Cb 2x1", "restart of 10 MCUs", "Se 5", "12-bit"):
        assert want is None
        return
    if case.endswith("every row"):
        return
    sampling = kw.get("sampling", [(1, 1)] * 3)
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    up = np.stack([np.repeat(np.repeat(
        a[::vmax // v, ::hmax // h, c], vmax // v, 0), hmax // h,
        1)[:a.shape[0], :a.shape[1]] for c, (h, v) in enumerate(sampling)],
        -1)
    np.testing.assert_array_equal(want, up)


def test_lossless_differences_modulo_2_16(tmp_path):
    """Differences of every category, 16 (32768, no extra bits) among
    them: each sample is undone modulo 2^16 and put out as its low 8 bits
    after the point transform's shift, as libjpeg-turbo does."""
    rng = np.random.default_rng(5)
    for pt in (0, 3):
        d = rng.integers(-32767, 32769, (23, 31))
        d[0, :4] = d[5, 7] = 32768
        d[9] = rng.integers(-3, 4, 31)
        assert hold(tmp_path, lossless_jpeg(source((23, 31), 5), 6, pt,
                                            diffs=[d])) is not None


def test_lossless_without_huffman_table(tmp_path):
    """jdlhuff.c, unlike jdhuff.c, defines no standard tables: a lossless
    file without its DHT is refused as PIL refuses it."""
    data = lossless_jpeg(source((20, 30), 6), 1)
    at = data.index(b"\xff\xc4")
    n, = struct.unpack(">H", data[at + 2:at + 4])
    assert hold(tmp_path, data[:at] + data[at + 2 + n:],
                match="undefined Huffman table") is None


@functools.lru_cache(maxsize=1)
def large_lossless() -> bytes:
    """zoom2x_1 as a 1000x598 lossless JPEG (predictor 1): 309 KB, five of
    PIL's reads."""
    return chip_smoke.lossless_jpeg(_view())


def test_lossless_large_and_cut(tmp_path):
    """A lossless file of several of PIL's 64 KiB reads decodes to its
    source (PIL's reads suspend and resume libjpeg's Huffman decoder);
    cut inside its data it is refused as truncated, as PIL refuses it;
    closed with EOI after a cut, it decodes as PIL decodes it (the rest
    out of data: libjpeg's zeros and first rows)."""
    data = large_lossless()
    assert len(data) > 4 * 65536
    np.testing.assert_array_equal(hold(tmp_path, data), _view())
    for cut in (len(data) - 2, 65536, 65536 + 3, len(data) // 2):
        assert hold(tmp_path, data[:cut], match="truncated") is None
    for cut in (70000, len(data) - 100):
        assert hold(tmp_path, data[:cut] + b"\xff\xd9") is not None


def test_chip_smoke_writer_is_the_encoders():
    """Phase 14zk's writer (``chip_smoke.lossless_jpeg``, numpy, no PIL)
    writes this file's encoder's bytes, whose decode PIL holds above."""
    a = source((41, 67), 7)
    for p in range(1, 8):
        assert chip_smoke.lossless_jpeg(a, p) == lossless_jpeg(a, p)


# ---------------------------------------------------------------------------
# arithmetic coding (SOF9, SOF10)

ARITH_SAMPLINGS = {"gray": [(1, 1)], "4:4:4": [(1, 1)] * 3,
                   "4:2:2": [(2, 1), (1, 1), (1, 1)],
                   "4:2:0": [(2, 2), (1, 1), (1, 1)],
                   "4:4:0": [(1, 2), (1, 1), (1, 1)]}


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("sampling", sorted(ARITH_SAMPLINGS))
def test_arith_against_huffman(tmp_path, sampling, progressive):
    """The encoder checks itself: its arithmetic-coded file (sequential,
    or progressive to full precision with successive approximation)
    decodes in PIL to the array of the Huffman file of the same
    coefficients; the port decodes it to PIL's array."""
    s = ARITH_SAMPLINGS[sampling]
    a = source((37, 53) if len(s) == 1 else (37, 53, 3), 8)
    ref = hold(tmp_path, huffman_jpeg(a, s, 90))
    got = hold(tmp_path, arith_jpeg(a, s, 90, progressive))
    np.testing.assert_array_equal(got, ref)


ARITH_VARIANTS = {
    "DAC": dict(dc_lu={0: (2, 5), 1: (1, 3)}, ac_k={0: 9, 1: 2}),
    "DAC progressive": dict(progressive=True, dc_lu={0: (0, 0), 1: (3, 9)},
                            ac_k={0: 1, 1: 40}),
    "restarts": dict(restart=3),
    "restarts progressive": dict(progressive=True, restart=2),
    "restarts and DAC, tables 0 0 0": dict(
        restart=5, dc_lu={0: (1, 2)}, ac_k={0: 12}, tables=[0, 0, 0]),
    "tables 15 and 7": dict(tables=[15, 7, 7], dc_lu={15: (0, 4)},
                            ac_k={7: 63}),
    "a scan a component": dict(progressive=True, script=[
        ((0,), 0, 0, 0, 0), ((1,), 0, 0, 0, 0), ((2,), 0, 0, 0, 0),
        ((0,), 1, 63, 0, 0), ((1,), 1, 63, 0, 0), ((2,), 1, 63, 0, 0)]),
}


@pytest.mark.parametrize("case", sorted(ARITH_VARIANTS))
def test_arith_variants(tmp_path, case):
    """Non-default DAC conditioning (DC L and U, AC Kx), restart
    intervals (statistics and coder reset), other conditioning tables
    (any of 16), single-component scans: the Huffman file's array."""
    a = source((37, 53, 3), 9)
    s = ARITH_SAMPLINGS["4:2:0"]
    ref = hold(tmp_path, huffman_jpeg(a, s, 85))
    np.testing.assert_array_equal(
        hold(tmp_path, arith_jpeg(a, s, 85, **ARITH_VARIANTS[case])), ref)


@pytest.mark.parametrize("scans", [1, 2, 3, 5, 7, 9])
def test_arith_progressive_incomplete(tmp_path, scans):
    """A progressive file closed with EOI after its first ``scans`` scans:
    libjpeg's block smoothing on the coefficients so far, as PIL reads
    it."""
    a = source((45, 67, 3), 10)
    hold(tmp_path, arith_jpeg(a, ARITH_SAMPLINGS["4:2:0"], 80, True,
                              script=SCRIPT_3[:scans]))


def test_arith_corrupt_data(tmp_path):
    """Damaged arithmetic-coded data, each read as PIL reads it: a bad
    code (a run or a magnitude past its end) leaves the rest of the scan,
    or of the restart interval, at zero; a marker in the data feeds
    zeros."""
    a = source((37, 53, 3), 11)
    rng = np.random.default_rng(11)
    for kw in (dict(), dict(restart=4), dict(progressive=True),
               dict(progressive=True, restart=3)):
        data = bytearray(arith_jpeg(a, ARITH_SAMPLINGS["4:2:0"], 80, **kw))
        # the bytes of the first scan's data that are no marker's
        start = data.index(b"\xff\xda")
        start += 2 + struct.unpack(">H", data[start + 2:start + 4])[0]
        end = next(i for i in range(start, len(data) - 1)
                   if data[i] == 0xFF and data[i + 1] not in (0, *range(
                       0xD0, 0xD8)))
        spots = [i for i in range(start, end) if data[i] != 0xFF
                 and data[i - 1] != 0xFF]
        for trial in range(6):
            bad = bytearray(data)
            for at in rng.choice(spots, 1 + trial, replace=False):
                bad[at] = int(rng.integers(0, 255))
            if trial == 5:                      # a marker in the data
                at = int(rng.choice(spots[:-1]))
                bad[at:at + 2] = b"\xff\xd5"
            hold(tmp_path, bytes(bad))


@functools.lru_cache(maxsize=None)
def small_arith(progressive: bool) -> bytes:
    return arith_jpeg(source((40, 48), 12), [(1, 1)], 75, progressive,
                      restart=7 if progressive else 5)


@pytest.mark.parametrize("progressive", [False, True])
def test_arith_stops_at_pils_first_read(tmp_path, progressive):
    """libjpeg's arithmetic decoder cannot suspend, and PIL hands it the
    file 64 KiB at a time: a file of up to 65536 bytes is read; moved
    past that by an APP1 segment, its data (the decoder reads up to the
    EOI marker) runs past PIL's first read, and the file is refused,
    as PIL refuses it.  Cut inside its data it is refused alike."""
    data = small_arith(progressive)
    ref = hold(tmp_path, data)
    for end in range(65530, 65541):
        got = hold(tmp_path, data[:2] + app1(end - len(data)) + data[2:],
                   match="64 KiB reads")
        assert (got is not None) == (end <= 65536), end
        if got is not None:
            np.testing.assert_array_equal(got, ref)
    for cut in (len(data) - 2, len(data) - 9, len(data) // 2):
        assert hold(tmp_path, data[:cut]) is None


def test_arith_progressive_scans_in_later_reads(tmp_path):
    """A progressive file whose scans lie in different 64 KiB reads (APP1
    segments between them): libjpeg suspends between scans, so each scan
    is read whole if it lies within one read; where the boundary falls
    inside a scan's data the file is refused.  The boundary moved over
    the bytes of the fourth scan, each file as PIL reads it."""
    data = arith_jpeg(source((40, 48), 13), [(1, 1)], 75, True, restart=9,
                      gap=app1(12000))
    ref = hold(tmp_path, data)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    end = data.index(b"\xff\xe1", sos[3])      # the scan's data ends
    outcomes = set()
    for at in range(sos[3] - 4, end + 4):
        got = hold(tmp_path, data[:2] + app1(65536 - at) + data[2:],
                   match="64 KiB reads")
        outcomes.add(got is not None)
        if got is not None:
            np.testing.assert_array_equal(got, ref)
    assert outcomes == {True, False}


def test_arith_large_refused(tmp_path):
    """An arithmetic-coded file whose data runs past 64 KiB (noise at
    quality 95: 100 KB) is refused as PIL refuses it."""
    rng = np.random.default_rng(14)
    data = arith_jpeg(rng.integers(0, 256, (300, 400), dtype=np.uint8),
                      [(1, 1)], 95)
    assert len(data) > 65536
    assert hold(tmp_path, data, match="64 KiB reads") is None


# ---------------------------------------------------------------------------
# frames that PIL refuses

REFUSED_FRAMES = {
    0xC5: "hierarchical", 0xC6: "hierarchical", 0xC7: "hierarchical",
    0xCD: "hierarchical", 0xCE: "hierarchical", 0xCF: "hierarchical",
    0xCB: "arithmetic-coded lossless"}


@pytest.mark.parametrize("marker", sorted(REFUSED_FRAMES))
def test_refused_frames(tmp_path, marker):
    """Hierarchical frames (SOF5-7, SOF13-15) and arithmetic-coded
    lossless frames (SOF11): PIL opens each and refuses to decode it; the
    port refuses it naming the frame and PIL's reason."""
    data = bytearray(lossless_jpeg(source((20, 30), 15), 1))
    data[data.index(b"\xff\xc3") + 1] = marker
    assert hold(tmp_path, bytes(data), match=REFUSED_FRAMES[marker]) is None


# ---------------------------------------------------------------------------
# the decoder's other routes

def _streams():
    a = source((32, 48, 3), 16)
    g = a[..., 0].copy()
    return a, g, {
        "arith": arith_jpeg(a, [(1, 1)] * 3),
        "arith 4:2:0": arith_jpeg(a, ARITH_SAMPLINGS["4:2:0"]),
        "arith progressive": arith_jpeg(a, [(1, 1)] * 3, progressive=True),
        "lossless": lossless_jpeg(a, 1),
        "lossless gray": lossless_jpeg(g, 1),
        "arith gray": arith_jpeg(g, [(1, 1)]),
        "ycck": pil_cmyk_as_ycck(a),
        "lossless ycck": lossless_jpeg(source((32, 48, 4), 16), 1,
                                       app=adobe(2)),
        "arith ycck": arith_jpeg(source((32, 48, 4), 16), [(1, 1)] * 4,
                                 app=adobe(2)),
    }


ROUTES = {
    # JPEG-in-TIFF: libtiff's colour mode (none, or YCbCr -> RGB for
    # photometric 6), never the markers
    "TIFF arith RGB": ("tif", "arith", 2, (1, 1)),
    "TIFF arith YCbCr": ("tif", "arith", 6, (1, 1)),
    "TIFF arith 4:2:0 YCbCr": ("tif", "arith 4:2:0", 6, (2, 2)),
    "TIFF arith progressive": ("tif", "arith progressive", 6, (1, 1)),
    "TIFF arith gray": ("tif", "arith gray", 1, None),
    "TIFF lossless RGB": ("tif", "lossless", 2, (1, 1)),
    "TIFF lossless gray": ("tif", "lossless gray", 1, None),
    "TIFF lossless YCbCr": ("tif", "lossless", 6, (1, 1)),
    # old-style JPEG: tif_ojpeg.c rewrites the scan header (Ss 0, Se 63)
    # and takes no SOF9
    "old-style JPEG lossless": ("ojpeg", "lossless gray"),
    "old-style JPEG arith": ("ojpeg", "arith gray"),
    "BLP1 arith": ("blp", "arith"),
    "BLP1 arith progressive": ("blp", "arith progressive"),
    "BLP1 lossless": ("blp", "lossless"),
    "BLP1 YCCK": ("blp", "ycck"),
    "BLP1 lossless YCCK": ("blp", "lossless ycck"),
    "IPTC lossless": ("iptc", "lossless gray"),
    "IPTC arith": ("iptc", "arith gray"),
    "MPO arith": ("mpo", "arith"),
    "MPO lossless": ("mpo", "lossless"),
    "MPO arith YCCK": ("mpo", "arith ycck"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_other_routes(tmp_path, case):
    """Each other way into the decoder reads these codings as PIL does,
    or refuses them as PIL does: JPEG-in-TIFF strips
    (``mods_jpeg_decode_tiff``), old-style JPEG TIFFs
    (``mods_jpeg_decode_ojpeg``), BLP1 JPEG (whose CMYK stream Pillow
    reads with jpegmode "CMYK": no YCCK conversion), IPTC's embedded
    JPEG and an MPO's first frame."""
    from test_torch_bitmap_formats import blp1_jpeg
    from test_torch_probed_formats import iptc_file
    route, stream, *rest = ROUTES[case]
    a, g, streams = _streams()
    data = streams[stream]
    if route == "tif":
        photometric, sub = rest
        shape = g.shape if photometric == 1 else a.shape
        hold(tmp_path, jpeg_in_tiff(data, shape, photometric, sub), "x.tif")
    elif route == "ojpeg":
        assert hold(tmp_path, ojpeg_strip(data, g.shape), "x.tif") is None
    elif route == "blp":
        hold(tmp_path, blp1_jpeg(48, 32, data, 0, 200), "x.blp")
    elif route == "iptc":
        hold(tmp_path, iptc_file((48, 32), 1, 0, 5, data), "x.iim")
    else:
        data = mpo([data, huffman_jpeg(a, [(1, 1)] * 3)])
        assert Image.open(io.BytesIO(data)).format == "MPO"
        hold(tmp_path, data, "x.mpo")


# ---------------------------------------------------------------------------
# phase 14zk's fixtures, and 14zl's JAX figures

def coding_fixtures() -> dict:
    """{name: bytes} of phase 14zk's fixtures (crops of the zoom2x and
    tilt4 views)."""
    rgb = source((96, 128, 3), 20)
    cmyk = source((96, 128, 4), 21)
    gray = source((96, 128), 22)
    s420 = ARITH_SAMPLINGS["4:2:0"]
    past = arith_jpeg(gray, [(1, 1)], 75)
    scans = arith_jpeg(gray, [(1, 1)], 80, True, gap=app1(30000))
    return {
        "coding_ycck_pil.jpg": pil_cmyk_as_ycck(rgb),
        "coding_ycck_420.jpg": huffman_jpeg(
            cmyk, [(2, 2), (1, 1), (1, 1), (2, 2)], 85, app=adobe(2)),
        "coding_lossless_gray_p7_pt1.jpg": lossless_jpeg(gray, 7, 1),
        "coding_lossless_rgb_422_restart.jpg": lossless_jpeg(
            rgb, 4, 0, ids=b"RGB", sampling=[(2, 1), (1, 1), (1, 1)],
            restart=128),
        "coding_lossless_cmyk_scans.jpg": lossless_jpeg(
            cmyk, 5, 0, scans=[(0,), (1,), (2,), (3,)]),
        "coding_lossless_jfif.jpg": lossless_jpeg(rgb, 1, 0, app=JFIF),
        "coding_arith_420_restart_dac.jpg": arith_jpeg(
            rgb, s420, 85, restart=6, dc_lu={0: (1, 4), 1: (0, 2)},
            ac_k={0: 10, 1: 3}),
        "coding_arith_progressive.jpg": arith_jpeg(
            rgb, [(2, 1), (1, 1), (1, 1)], 80, True),
        # the scans spread over three of PIL's reads: read
        "coding_arith_progressive_reads.jpg": scans,
        # the data across the end of PIL's first read: refused
        "coding_arith_past_read.jpg": past[:2] + app1(
            65536 - len(past) + 400) + past[2:],
    }


def write_fixtures(d) -> None:
    os.makedirs(d, exist_ok=True)
    for name, data in coding_fixtures().items():
        with open(os.path.join(d, name), "wb") as f:
            f.write(data)


def pil_hashes() -> dict:
    """PIL's (shape, mode, SHA-256) of each committed fixture it reads."""
    out = {}
    for name in sorted(coding_fixtures()):
        im = Image.open(chip_smoke.IMAGE_FIXTURES / name)
        try:
            a = np.asarray(im)
        except OSError:
            continue
        out[name] = (a.shape, im.mode, hashlib.sha256(a.tobytes()).hexdigest())
    return out


def test_coding_fixtures_are_pils(tmp_path):
    """The committed fixtures of phase 14zk are ``write_fixtures``'s
    bytes; ``chip_smoke.CODING_FIXTURE_SHA256`` holds PIL's shape, mode
    and hash of each that PIL reads, ``CODING_FIXTURE_REFUSALS`` names
    the others, and the port reads or refuses each as PIL does."""
    files = coding_fixtures()
    for name, data in files.items():
        assert (chip_smoke.IMAGE_FIXTURES / name).read_bytes() == data, name
    assert set(files) == set(chip_smoke.CODING_FIXTURES)
    hashes = pil_hashes()
    assert hashes == {k: (tuple(v[0]), v[1], v[2]) for k, v in
                      chip_smoke.CODING_FIXTURE_SHA256.items()}
    assert set(hashes) | set(chip_smoke.CODING_FIXTURE_REFUSALS) == set(
        files)
    for name, why in chip_smoke.CODING_FIXTURE_REFUSALS.items():
        assert hold(tmp_path, files[name], match=why) is None
    for name in hashes:
        hold(tmp_path, files[name])


def _jax_lossless_main() -> None:
    """The JAX command on phase 14zl's pair (LORANSACH, the CVIU-shaped
    INI files): ``JAX_LOSSLESS_REFERENCE``."""
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
            pair.append(str(td / f"zoom2x_{i}_lossless.jpg"))
            Path(pair[-1]).write_bytes(
                chip_smoke.lossless_jpeg(_view(f"zoom2x_{i}")))
        m = td / "m.txt"
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert jcli.cmd_match(pair + ["0", "0", "k1", "k2", str(m), "0",
                                          "LORANSACH", str(td / "config.ini"),
                                          str(td / "iters.ini")]) == 0
        h, w = _view().shape
        figures = chip_smoke.match_figures(
            buf.getvalue(), str(m), np.loadtxt(chip_smoke.PAIRS /
                                               "zoom2x_H.txt"), w, h)
        print(json.dumps(dict(figures, seconds=round(time.time() - t0, 1))))


if __name__ == "__main__":
    if sys.argv[1:] == ["--fixtures"]:
        write_fixtures(chip_smoke.IMAGE_FIXTURES)
    elif sys.argv[1:] == ["--hashes"]:
        for name, (shape, mode, sha) in pil_hashes().items():
            print(f'    "{name}": (\n        {shape}, "{mode}",\n'
                  f'        "{sha[:32]}"\n        "{sha[32:]}"),')
    elif sys.argv[1:] == ["--jax-lossless"]:
        _jax_lossless_main()
