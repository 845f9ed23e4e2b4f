"""Feature files in the reference's text and binary formats (mirrors
``mods_tpu/io/regions_io.py``, function for function; SURVEY.md §5.4).

Formats:
  * native MODS hierarchical keypoint file (``SaveRegions``/
    ``LoadRegions``, imagerepresentation.cpp:2139-2215; per-region record
    ``saveAR`` :89-99 with two ``saveKP`` keypoint blocks det_kp/reproj_kp
    x y a11 a12 a21 a22 pyramid_scale octave_number s sub_type);
  * the Michal per-descriptor files, binary or text
    (``SaveRegionsMichal``, imagerepresentation.cpp:2049-2146);
  * match list ``x1 y1 x2 y2 [extra]`` (``WriteMatchings``,
    matching.cpp:2923-2982) and 3x3 H/F files (``WriteH``).

Host numpy only: the writers produce the JAX package's bytes for the
same arrays.
"""

from __future__ import annotations

import numpy as np


class RegionSet:
    """Host-side region bundle for one (detector, descriptor) pair."""

    def __init__(self, det_xy, det_A, det_s, reproj_xy, reproj_A,
                 reproj_s, sub_type, desc):
        self.det_xy = np.asarray(det_xy, np.float64)
        self.det_A = np.asarray(det_A, np.float64)
        self.det_s = np.asarray(det_s, np.float64)
        self.reproj_xy = np.asarray(reproj_xy, np.float64)
        self.reproj_A = np.asarray(reproj_A, np.float64)
        self.reproj_s = np.asarray(reproj_s, np.float64)
        self.sub_type = np.asarray(sub_type, np.int64)
        self.desc = np.asarray(desc, np.float64)

    @property
    def n(self):
        return self.det_xy.shape[0]


def _fmt(x: float) -> str:
    return f"{x:.10g}"


def save_regions(path: str,
                 store: dict[str, dict[str, RegionSet]]) -> None:
    """store: {detector: {descriptor: RegionSet}}."""
    with open(path, "w") as f:
        f.write(f"{len(store)}\n")
        for det, descs in store.items():
            f.write(f"{det} {len(descs)}\n")
            for desc_name, rs in descs.items():
                f.write(f"{desc_name} {rs.n}\n")
                dim = rs.desc.shape[1] if rs.n else 0
                f.write(f"{dim}\n")
                for i in range(rs.n):
                    rec = [i, 0, 0, -1]
                    for xy, A, s in ((rs.det_xy, rs.det_A, rs.det_s),
                                     (rs.reproj_xy, rs.reproj_A,
                                      rs.reproj_s)):
                        rec += [xy[i, 0], xy[i, 1],
                                A[i, 0, 0], A[i, 0, 1],
                                A[i, 1, 0], A[i, 1, 1],
                                1.0, 0, s[i], int(rs.sub_type[i])]
                    rec += [dim]
                    rec += list(rs.desc[i])
                    f.write(" ".join(_fmt(v) if isinstance(v, float)
                                     else str(v) for v in rec) + "\n")


def load_regions(path: str) -> dict[str, dict[str, RegionSet]]:
    with open(path) as f:
        tok = f.read().split()
    pos = 0

    def nxt():
        nonlocal pos
        v = tok[pos]
        pos += 1
        return v

    out: dict[str, dict[str, RegionSet]] = {}
    n_det = int(nxt())
    for _ in range(n_det):
        det = nxt()
        n_desc = int(nxt())
        out[det] = {}
        for _ in range(n_desc):
            desc_name = nxt()
            n_kp = int(nxt())
            dim = int(nxt())
            det_xy = np.zeros((n_kp, 2))
            det_A = np.zeros((n_kp, 2, 2))
            det_s = np.zeros(n_kp)
            rep_xy = np.zeros((n_kp, 2))
            rep_A = np.zeros((n_kp, 2, 2))
            rep_s = np.zeros(n_kp)
            st = np.zeros(n_kp, np.int64)
            desc = np.zeros((n_kp, dim))
            for i in range(n_kp):
                nxt(); nxt(); nxt(); nxt()  # id img_id reproj_id parent
                for xy, A, s_arr, st_arr in (
                        (det_xy, det_A, det_s, st),
                        (rep_xy, rep_A, rep_s, None)):
                    xy[i, 0] = float(nxt())
                    xy[i, 1] = float(nxt())
                    A[i, 0, 0] = float(nxt())
                    A[i, 0, 1] = float(nxt())
                    A[i, 1, 0] = float(nxt())
                    A[i, 1, 1] = float(nxt())
                    nxt()  # pyramid_scale
                    nxt()  # octave_number
                    s_arr[i] = float(nxt())
                    t = int(float(nxt()))
                    if st_arr is not None:
                        st_arr[i] = t
                d = int(nxt())
                for j in range(d):
                    desc[i, j] = float(nxt())
            out[det][desc_name] = RegionSet(
                det_xy, det_A, det_s, rep_xy, rep_A, rep_s, st, desc)
    return out


def write_matches(path: str, xy1: np.ndarray, xy2: np.ndarray,
                  extra: np.ndarray | None = None) -> None:
    """`WriteMatchings` format: one line per match `x1 y1 x2 y2 [extra]`
    (matching.cpp:2923-2982), preceded by the match count."""
    with open(path, "w") as f:
        f.write(f"{xy1.shape[0]}\n")
        for i in range(xy1.shape[0]):
            line = (f"{xy1[i, 0]:.10g} {xy1[i, 1]:.10g} "
                    f"{xy2[i, 0]:.10g} {xy2[i, 1]:.10g}")
            if extra is not None:
                line += f" {extra[i]:.10g}"
            f.write(line + "\n")


def read_matches(path: str):
    data = np.loadtxt(path, skiprows=1, ndmin=2)
    return data[:, :2], data[:, 2:4]


def write_h(path: str, H: np.ndarray) -> None:
    """3x3 matrix text file (`WriteH`, matching.cpp:3049)."""
    np.savetxt(path, np.asarray(H).reshape(3, 3), fmt="%.10g")


def read_h(path: str) -> np.ndarray:
    return np.loadtxt(path).reshape(3, 3)


def _rectify_up_is_up(A: np.ndarray) -> np.ndarray:
    """rectifyAffineTransformationUpIsUp (helpers.cpp:380-389): rotate
    each 2x2 frame so its first row is axis-aligned (a12 = 0), keeping
    the shape; vectorized over (N, 2, 2)."""
    a = A[:, 0, 0]
    b = A[:, 0, 1]
    c = A[:, 1, 0]
    d = A[:, 1, 1]
    det = np.sqrt(np.abs(a * d - b * c))
    b2a2 = np.sqrt(b * b + a * a)
    out = np.zeros_like(A)
    out[:, 0, 0] = b2a2 / det
    out[:, 0, 1] = 0.0
    out[:, 1, 0] = (d * b + c * a) / (b2a2 * det)
    out[:, 1, 1] = det / b2a2
    return out


MICHAL_MAGIC = 0x01666661      # the reference's int magic '\1ffa'


def save_regions_michal(prefix: str, regions, img_w: int, img_h: int,
                        binary: bool = True, response=None) -> list:
    """SaveRegionsMichal (imagerepresentation.cpp:2049-2146): one file
    per DESCRIPTOR name (``prefix + desc_name``), regions pooled across
    detectors.  Per record (saveKPMichalBin, :52-87): x y s' a11 a12
    a21 a22 sub_type response then the descriptor — s' = s * sqrt|det A|
    * 3*sqrt(3) and the frame rectified up-is-up, uint8-clamped
    descriptor bytes in binary mode (SIFT-family descriptors are
    0..255-quantized on both sides, siftdesc.cpp:247-278).

    ``regions``: {(det_name, desc_name): RegionSet}.  Returns the list
    of files written.
    """
    import struct
    by_desc: dict = {}
    for (det, desc), rs in regions.items():
        if desc == "None" or rs.n == 0:
            continue
        by_desc.setdefault(desc, []).append(rs)
    written = []
    for desc_name, sets in by_desc.items():
        path = prefix + desc_name
        n_total = sum(rs.n for rs in sets)
        dim = sets[0].desc.shape[1]
        mr = 3.0 * np.sqrt(3.0)
        if binary:
            with open(path, "wb") as f:
                f.write(struct.pack("<iiiii", MICHAL_MAGIC, n_total,
                                    dim, img_w, img_h))
                for rs in sets:
                    A = np.asarray(rs.reproj_A, np.float64)
                    det_a = np.sqrt(np.abs(np.linalg.det(A)))
                    s_out = rs.reproj_s * det_a * mr
                    R = _rectify_up_is_up(A)
                    resp = (np.zeros(rs.n) if response is None
                            else np.asarray(response))
                    dq = np.clip(rs.desc, 0, 255).astype(np.uint8)
                    for i in range(rs.n):
                        f.write(struct.pack(
                            "<fffffffif", rs.reproj_xy[i, 0],
                            rs.reproj_xy[i, 1], s_out[i],
                            R[i, 0, 0], R[i, 0, 1], R[i, 1, 0],
                            R[i, 1, 1], int(rs.sub_type[i]),
                            float(resp[i] if i < len(resp) else 0.0)))
                        f.write(dq[i].tobytes())
        else:
            with open(path, "w") as f:
                for rs in sets:
                    A = np.asarray(rs.reproj_A, np.float64)
                    det_a = np.sqrt(np.abs(np.linalg.det(A)))
                    s_out = rs.reproj_s * det_a * mr
                    R = _rectify_up_is_up(A)
                    resp = (np.zeros(rs.n) if response is None
                            else np.asarray(response))
                    for i in range(rs.n):
                        row = [rs.reproj_xy[i, 0], rs.reproj_xy[i, 1],
                               s_out[i], R[i, 0, 0], R[i, 0, 1],
                               R[i, 1, 0], R[i, 1, 1]]
                        f.write(" ".join(_fmt(v) for v in row)
                                + f" {int(rs.sub_type[i])} "
                                + _fmt(float(resp[i] if i < len(resp)
                                             else 0.0)) + " "
                                + " ".join(_fmt(v) for v in rs.desc[i])
                                + "\n")
        written.append(path)
    return written


def load_regions_michal(path: str):
    """Binary Michal reader (inverse of save_regions_michal): returns
    (xy (N,2), s (N,), A (N,2,2), sub_type (N,), response (N,),
    desc (N,dim) float32)."""
    import struct
    with open(path, "rb") as f:
        magic, n, dim, w, h = struct.unpack("<iiiii", f.read(20))
        if magic != MICHAL_MAGIC:
            raise ValueError(f"bad magic {magic:#x} in {path}")
        xy = np.zeros((n, 2), np.float32)
        s = np.zeros((n,), np.float32)
        A = np.zeros((n, 2, 2), np.float32)
        st = np.zeros((n,), np.int32)
        resp = np.zeros((n,), np.float32)
        desc = np.zeros((n, dim), np.float32)
        for i in range(n):
            vals = struct.unpack("<fffffffif", f.read(9 * 4))
            xy[i] = vals[0:2]
            s[i] = vals[2]
            A[i] = [[vals[3], vals[4]], [vals[5], vals[6]]]
            st[i] = vals[7]
            resp[i] = vals[8]
            desc[i] = np.frombuffer(f.read(dim), np.uint8)
    return xy, s, A, st, resp, desc
