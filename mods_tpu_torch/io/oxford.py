"""Oxford/Mikolajczyk-format keypoint interchange (mirrors
``mods_tpu/io/oxford.py``).

Reference readers/writers: `ReadKPsMik` (synth-detection.cpp:1125-1170),
`WriteKPs`/`ReadKPs` (synth-detection.cpp:1076-1124), the Oxford-style
exporter `SaveRegionsMichal` (imagerepresentation.cpp:2049-2137) and the
benchmark dumps `SaveRegionsBenchmark`/`SaveDescriptorsBenchmark`
(imagerepresentation.cpp:2216-2305).  The Oxford format is the standard
affine-covariant-features benchmark file:

    dim
    n
    x y a b c d_0 ... d_{dim-1}

where (a, b, c) define the ellipse  a x^2 + 2 b x y + c y^2 = 1  around
(x, y).  Our regions carry an affine frame A and scale s mapping the unit
circle to the region: the ellipse matrix is  M = (s^2 A A^T)^{-1}.
"""

from __future__ import annotations

import numpy as np


def frames_to_ellipses(A: np.ndarray, s: np.ndarray) -> np.ndarray:
    """(N, 2, 2) frames + (N,) scales -> (N, 3) ellipse (a, b, c)."""
    A = np.asarray(A, np.float64)
    s = np.asarray(s, np.float64)
    cov = np.einsum("nij,nkj->nik", A, A) * (s ** 2)[:, None, None]
    M = np.linalg.inv(cov)
    return np.stack([M[:, 0, 0], M[:, 0, 1], M[:, 1, 1]], -1)


def ellipses_to_frames(abc: np.ndarray):
    """(N, 3) ellipse (a, b, c) -> (A normalized, s) with A upright
    (rectifyAffineTransformationUpIsUp semantics, helpers.cpp): s is
    sqrt(sqrt(det(cov))) so that det(A) = 1."""
    abc = np.asarray(abc, np.float64)
    M = np.empty((len(abc), 2, 2))
    M[:, 0, 0] = abc[:, 0]
    M[:, 0, 1] = M[:, 1, 0] = abc[:, 1]
    M[:, 1, 1] = abc[:, 2]
    cov = np.linalg.inv(M)
    # symmetric square root via eigendecomposition
    w, V = np.linalg.eigh(cov)
    w = np.maximum(w, 1e-12)
    R = np.einsum("nij,nj,nkj->nik", V, np.sqrt(w), V)   # cov^(1/2)
    dR = np.maximum(np.linalg.det(R), 1e-12)   # = (det cov)^1/2
    s = np.sqrt(dR)                            # s^2 = det(R) -> det(A) = 1
    A = R / s[:, None, None]
    return A, s


def write_oxford(path: str, xy: np.ndarray, A: np.ndarray, s: np.ndarray,
                 desc: np.ndarray | None = None) -> None:
    xy = np.asarray(xy, np.float64)
    abc = frames_to_ellipses(A, s)
    dim = 0 if desc is None else desc.shape[1]
    with open(path, "w") as f:
        f.write(f"{float(dim):g}\n{len(xy)}\n")
        for i in range(len(xy)):
            rec = [xy[i, 0], xy[i, 1], abc[i, 0], abc[i, 1], abc[i, 2]]
            if desc is not None:
                rec += list(np.asarray(desc[i], np.float64))
            f.write(" ".join(f"{v:.10g}" for v in rec) + "\n")


def read_oxford(path: str):
    """-> (xy, A, s, desc|None).  Mikolajczyk reader semantics
    (ReadKPsMik, synth-detection.cpp:1125-1170)."""
    with open(path) as f:
        tok = f.read().split()
    dim = int(float(tok[0]))
    n = int(float(tok[1]))
    rec = 5 + dim
    data = np.asarray(tok[2:2 + n * rec], np.float64).reshape(n, rec)
    xy = data[:, :2]
    A, s = ellipses_to_frames(data[:, 2:5])
    desc = data[:, 5:] if dim else None
    return xy, A, s, desc


def write_kps(path: str, xy: np.ndarray, A: np.ndarray,
              s: np.ndarray) -> None:
    """Simple keypoint dump (WriteKPs, synth-detection.cpp:1076):
    count then `x y s a11 a12 a21 a22` per line."""
    xy = np.asarray(xy, np.float64)
    A = np.asarray(A, np.float64)
    s = np.asarray(s, np.float64)
    with open(path, "w") as f:
        f.write(f"{len(xy)}\n")
        for i in range(len(xy)):
            f.write(f"{xy[i, 0]:.10g} {xy[i, 1]:.10g} {s[i]:.10g} "
                    f"{A[i, 0, 0]:.10g} {A[i, 0, 1]:.10g} "
                    f"{A[i, 1, 0]:.10g} {A[i, 1, 1]:.10g}\n")


def read_kps(path: str):
    with open(path) as f:
        tok = f.read().split()
    n = int(tok[0])
    data = np.asarray(tok[1:1 + 7 * n], np.float64).reshape(n, 7)
    xy = data[:, :2]
    s = data[:, 2]
    A = data[:, 3:7].reshape(n, 2, 2)
    return xy, A, s


def write_descriptors_benchmark(path: str, desc: np.ndarray) -> None:
    """Descriptor-only dump (SaveDescriptorsBenchmark,
    imagerepresentation.cpp:2216): n dim then rows."""
    desc = np.asarray(desc, np.float64)
    with open(path, "w") as f:
        f.write(f"{desc.shape[0]} {desc.shape[1]}\n")
        for row in desc:
            f.write(" ".join(f"{v:.10g}" for v in row) + "\n")


def read_descriptors_benchmark(path: str) -> np.ndarray:
    with open(path) as f:
        n, dim = (int(x) for x in f.readline().split())
        return np.loadtxt(f, ndmin=2).reshape(n, dim)
