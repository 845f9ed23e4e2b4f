"""Build and load the hand-written CUDA kernels under this directory.

Each ``<name>.cu`` has a plain C interface.  It is compiled with ``nvcc``
for Hopper (``sm_90a``) into ``mods_tpu_torch/_build/`` at first use and
bound with ``ctypes``; nothing here runs at import.  The library's file
name carries a hash of its source and of the ``*.cuh`` headers beside it,
so an edited kernel or header is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parent / "_build"
# -fmad=false: nvcc must not contract a multiply and an add into an FMA,
# which rounds once where the plain PyTorch versions round twice.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, tmp path, final path)
    or None when the library is already built."""
    so = _lib_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so


def _finish(name: str, job) -> None:
    proc, tmp, so = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    so.with_suffix(".log").write_text(out)
    os.replace(tmp, so)     # atomic: a reader never sees half a library


def build_all() -> dict[str, str]:
    """Compile every kernel source not built yet, one nvcc each, all
    started together.  Returns the compiler's report per source
    (``-Xptxas -v``: registers, shared memory, spills), kept beside the
    library for sources built earlier."""
    jobs = {name: _start(name) for name in sources()}
    for name, job in jobs.items():
        if job:
            _finish(name, job)
    return {name: _lib_path(name).with_suffix(".log").read_text()
            for name in jobs}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        job = _start(name)
        if job:
            _finish(name, job)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib
