"""Ground-truth homography verification (mirrors ``mods_tpu/verify.py``;
reference ``HMatrixFiltering``, matching/matching.cpp:1074-1170, and the
GR_TRUTH verification mode, mods.cpp:312-335)."""

from __future__ import annotations

import numpy as np
import torch

from mods_tpu_torch.ransac.errors import h_error_sampson, h_error_symm


def load_h_file(path: str) -> np.ndarray:
    """Read a 3x3 homography text file."""
    return np.loadtxt(path).reshape(3, 3)


def gt_h_inliers(H, xy1: torch.Tensor, xy2: torch.Tensor,
                 mask: torch.Tensor, threshold: float = 3.0,
                 error_type: str = "sampson") -> torch.Tensor:
    """Inlier mask of correspondences under a known H (image1 -> image2);
    the metric follows the config's RANSAC error type as the reference's
    HMatrixFiltering does (matching.cpp:1080-1098)."""
    H = torch.as_tensor(H, dtype=torch.float32, device=xy1.device)
    if error_type == "symm_max":
        e = h_error_symm(H, xy1, xy2, mode="max")
    elif error_type == "symm_sum":
        e = h_error_symm(H, xy1, xy2)
    else:
        e = h_error_sampson(H, xy1, xy2)
    return mask & (e < threshold * threshold)
