"""Match and homography files of the ``mods`` CLI (mirrors the
``write_matches``, ``read_matches``, ``write_h`` and ``read_h`` of
``mods_tpu/io/regions_io.py``; the region and descriptor formats are
ROADMAP.md item 21)."""

from __future__ import annotations

import numpy as np


def write_matches(path: str, xy1: np.ndarray, xy2: np.ndarray,
                  extra: np.ndarray | None = None) -> None:
    """``WriteMatchings`` format (matching.cpp:2923-2982): the match count,
    then one line ``x1 y1 x2 y2 [extra]`` a match."""
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
    """3x3 matrix text file (``WriteH``, matching.cpp:3049)."""
    np.savetxt(path, np.asarray(H).reshape(3, 3), fmt="%.10g")


def read_h(path: str) -> np.ndarray:
    return np.loadtxt(path).reshape(3, 3)
