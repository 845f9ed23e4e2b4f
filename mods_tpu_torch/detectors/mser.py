"""MSER detector: the native component tree of ``native/mser.cpp``
through ctypes (mirrors ``mods_tpu/detectors/mser.py``).

The union-find over gray-sorted pixels is sequential, so it runs as host
C++ while orientation and description run on the device.  Conversion to
affine regions follows the reference (extrema.cpp:141-190): centroid and
the symmetric square root of the second-moment matrix as the
(non-unit-det) A, s = 1, response = margin, sub_type 21 (MSER+, dark) /
20 (MSER-, bright).

The port builds ``native/*.cpp`` itself, with the JAX package's compiler
flags, into ``mods_tpu_torch/_build/native/<machine>/``: at first use,
never at import.  The same source and flags give the same numbers as the
JAX package's library on one machine.
"""

from __future__ import annotations

import ctypes
import functools
import os
import platform
import subprocess
import tempfile

import numpy as np

from mods_tpu_torch.config import CapacityParams

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build", "native", platform.machine())
# the JAX package's flags (mods_tpu/detectors/mser.py:44-46): -march=native
# is safe because the build directory is per machine and never committed
CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC")

MSER_PLUS = 21   # dark regions (reference sub_type, extrema.cpp)
MSER_MIN = 20


def build_native(src_name: str, so_name: str,
                 extra_flags: tuple = ()) -> str:
    """Compile ``native/<src_name>`` (or the source at the absolute path
    ``src_name``) with g++ into the port's build directory and return the
    library's path; rebuilt when the source is newer.  The library is
    written under a temporary name and renamed, so processes that build
    at once never load a half-written file.  A failed build raises with
    the compiler's output."""
    src = os.path.join(NATIVE_DIR, src_name)
    so = os.path.join(BUILD_DIR, so_name)
    if (os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(src)):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, *extra_flags, "-o", tmp, src]
    try:
        try:
            out = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"cannot build {src_name}: no g++ ({e})") \
                from e
        if out.returncode != 0:
            raise RuntimeError(
                f"building {src_name} failed ({' '.join(cmd)}):\n"
                f"{out.stdout}{out.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(build_native("mser.cpp", "libmods_mser.so"))
    lib.mods_mser_detect.restype = ctypes.c_int
    lib.mods_mser_detect.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int]
    return lib


def detect_msers_np(img: np.ndarray, min_size: int = 30,
                    max_area: float = 0.05, min_margin: int = 8,
                    max_out: int = 8192) -> dict:
    """img: (H, W) uint8 or float 0..255 -> dict of numpy arrays (xy, A,
    s, response, sub_type), like an unmasked Regions batch."""
    lib = _lib()
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    img = np.ascontiguousarray(img)
    h, w = img.shape
    out = np.zeros((max_out, 8), np.float64)
    n = lib.mods_mser_detect(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        int(min_size), float(max_area), int(min_margin),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_out)
    out = out[:n]
    A = out[:, 2:6].reshape(-1, 2, 2)
    sub = np.where(out[:, 7] == 0, MSER_PLUS, MSER_MIN)
    return dict(
        xy=out[:, 0:2].astype(np.float32),
        A=A.astype(np.float32),
        s=np.ones(n, np.float32),
        response=out[:, 6].astype(np.float32),
        sub_type=sub.astype(np.int32),
    )


def detect_msers_padded(img: np.ndarray, valid_hw, caps: CapacityParams,
                        **kw) -> dict:
    """Detect on the valid sub-image; the ``caps.per_view`` strongest
    regions (by margin) in slots, the rest padded and masked off."""
    h, w = int(valid_hw[0]), int(valid_hw[1])
    d = detect_msers_np(img[:h, :w], max_out=caps.per_view, **kw)
    K = caps.per_view
    out = dict(
        xy=np.zeros((K, 2), np.float32),
        A=np.tile(np.eye(2, dtype=np.float32), (K, 1, 1)),
        s=np.ones(K, np.float32),
        response=np.zeros(K, np.float32),
        sub_type=np.zeros(K, np.int32),
        mask=np.zeros(K, bool),
    )
    n = min(d["xy"].shape[0], K)
    order = np.argsort(-d["response"])[:n]
    for k in ("xy", "A", "s", "response", "sub_type"):
        out[k][:n] = d[k][order]
    out["mask"][:n] = True
    return out
