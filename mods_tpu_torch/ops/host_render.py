"""Host-side view-group renderer: ``native/render.cpp`` through ctypes
(mirrors ``mods_tpu/ops/host_render.py``).

The MSER component tree runs on the host, so its input views are
rendered on the host too, and rendered views never cross from the card.
The semantics are the device render's (rotate -> anti-alias blur ->
squash, synth-detection.cpp:236-430; ``pipeline.py::_make_render_fn``).
The library is built with ``-fopenmp`` at first use, by the rule of
``detectors/mser.py::build_native``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from mods_tpu_torch.detectors.mser import BUILD_DIR, build_native

# where the port's native libraries are built (the JAX package builds
# them under its NATIVE_DIR, in native/.cache)
NATIVE_DIR = BUILD_DIR


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(build_native("render.cpp", "libmods_render.so",
                                   extra_flags=("-fopenmp",)))
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mods_render_group.restype = None
    lib.mods_render_group.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int,                  # img, h, w
        f32p, ctypes.c_int,                                # rot_inv, V
        ctypes.c_int, ctypes.c_int,                        # hr, wr
        ctypes.c_int, ctypes.c_float, ctypes.c_float,      # blur, sigmas
        ctypes.c_float, ctypes.c_float,                    # squash inv
        ctypes.POINTER(ctypes.c_int32),                    # valid_hw
        ctypes.c_int, ctypes.c_int,                        # hc, wc
        ctypes.c_int, f32p]                                # identity, out
    lib.omp_get_max_threads.restype = ctypes.c_int
    lib.omp_get_max_threads.argtypes = []
    return lib


def omp_max_threads() -> int:
    """The OpenMP team size the renderer's parallel loops use."""
    return int(_lib().omp_get_max_threads())


def render_group_np(img: np.ndarray, rot_inv: np.ndarray, hr: int,
                    wr: int, do_blur: bool, sigma_x: float,
                    sigma_y: float, sx: float, sy: float,
                    valid_hw: np.ndarray, hc: int, wc: int,
                    identity: bool) -> np.ndarray:
    """img (H, W) float32; rot_inv (V, 2, 3); valid_hw (V, 2) int32 ->
    (V, hc, wc) float32 views, laid out as the device render's."""
    lib = _lib()
    img = np.ascontiguousarray(img, np.float32)
    rot_flat = np.ascontiguousarray(rot_inv, np.float32).reshape(-1)
    vhw = np.ascontiguousarray(valid_hw, np.int32)
    V = int(vhw.shape[0])
    if rot_flat.shape[0] < 6 * V:
        raise ValueError(f"rot_inv holds {rot_flat.shape[0] // 6} maps "
                         f"for {V} views")
    out = np.empty((V, hc, wc), np.float32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mods_render_group(
        img.ctypes.data_as(f32p), img.shape[0], img.shape[1],
        rot_flat.ctypes.data_as(f32p), V, int(hr), int(wr),
        int(bool(do_blur)), float(sigma_x), float(sigma_y),
        float(1.0 / sx), float(1.0 / sy),
        vhw.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(hc), int(wc), int(bool(identity)),
        out.ctypes.data_as(f32p))
    return out
