"""Match and region drawing (mirrors ``mods_tpu/viz.py``).

Reference: the drawing suite in matching/matching.cpp:1203-2922
(``DrawMatches`` side-by-side canvases with correspondence lines and
optional reprojection/epipolar overlays, ``DrawRegions`` affine-ellipse
overlays, ``DrawMatchesWithError`` error-colored lines), invoked from
mods.cpp:480-527.  Host-side numpy: drawing is I/O, not compute.  The
rasterisation is the JAX package's, call for call (float64 sampling,
``np.round``), so both packages draw the same pixels; ``save_image``
writes the format the file's extension names with ``io/image.py`` (the
card machine has no PIL).
"""

from __future__ import annotations

import numpy as np
import torch

from mods_tpu_torch.io import image as image_io
from mods_tpu_torch.ransac.errors import h_transfer


def _to_rgb(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return img[..., :3].copy()


def side_by_side(img1: np.ndarray, img2: np.ndarray,
                 horizontal: bool = True):
    """Compose the two-image canvas (DrawMatches layout,
    matching.cpp:1216-1260).  Returns (canvas, offset_xy_for_img2)."""
    a, b = _to_rgb(img1), _to_rgb(img2)
    if horizontal:
        h = max(a.shape[0], b.shape[0])
        canvas = np.zeros((h, a.shape[1] + b.shape[1], 3), np.uint8)
        canvas[:a.shape[0], :a.shape[1]] = a
        canvas[:b.shape[0], a.shape[1]:] = b
        return canvas, np.array([a.shape[1], 0], np.float32)
    w = max(a.shape[1], b.shape[1])
    canvas = np.zeros((a.shape[0] + b.shape[0], w, 3), np.uint8)
    canvas[:a.shape[0], :a.shape[1]] = a
    canvas[a.shape[0]:, :b.shape[1]] = b
    return canvas, np.array([0, a.shape[0]], np.float32)


def _draw_line(canvas, p0, p1, color):
    """Integer Bresenham-free line via dense parameter sampling."""
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    t = np.linspace(0.0, 1.0, n)
    xs = np.round(p0[0] + t * (p1[0] - p0[0])).astype(int)
    ys = np.round(p0[1] + t * (p1[1] - p0[1])).astype(int)
    ok = (xs >= 0) & (ys >= 0) & (xs < canvas.shape[1]) \
        & (ys < canvas.shape[0])
    canvas[ys[ok], xs[ok]] = color


def _draw_circle(canvas, c, r, color):
    th = np.linspace(0, 2 * np.pi, max(int(2 * np.pi * r), 8),
                     endpoint=False)
    xs = np.round(c[0] + r * np.cos(th)).astype(int)
    ys = np.round(c[1] + r * np.sin(th)).astype(int)
    ok = (xs >= 0) & (ys >= 0) & (xs < canvas.shape[1]) \
        & (ys < canvas.shape[0])
    canvas[ys[ok], xs[ok]] = color


def _draw_ellipse(canvas, xy, A, scale, color, n_pts: int = 64):
    """Affine frame boundary: x = xy + scale * A @ [cos t, sin t]."""
    th = np.linspace(0, 2 * np.pi, n_pts, endpoint=False)
    circ = np.stack([np.cos(th), np.sin(th)])           # (2, n)
    pts = xy[:, None] + scale * (A @ circ)              # (2, n)
    xs = np.round(pts[0]).astype(int)
    ys = np.round(pts[1]).astype(int)
    ok = (xs >= 0) & (ys >= 0) & (xs < canvas.shape[1]) \
        & (ys < canvas.shape[0])
    canvas[ys[ok], xs[ok]] = color


GREEN = np.array([0, 255, 0], np.uint8)
RED = np.array([255, 0, 0], np.uint8)
BLUE = np.array([0, 100, 255], np.uint8)
YELLOW = np.array([255, 255, 0], np.uint8)


def draw_matches(img1, img2, xy1: np.ndarray, xy2: np.ndarray,
                 inlier_mask: np.ndarray | None = None,
                 horizontal: bool | None = None,
                 circle_radius: float = 3.0) -> np.ndarray:
    """Side-by-side correspondence plot (DrawMatches,
    matching.cpp:1216-1458): green lines for inliers, red for outliers."""
    img1 = np.asarray(img1)
    img2 = np.asarray(img2)
    if horizontal is None:
        horizontal = img1.shape[0] >= img1.shape[1]
    canvas, off = side_by_side(img1, img2, horizontal)
    xy1 = np.asarray(xy1, np.float32)
    xy2 = np.asarray(xy2, np.float32) + off
    if inlier_mask is None:
        inlier_mask = np.ones(len(xy1), bool)
    for p, q, ok in zip(xy1, xy2, inlier_mask):
        color = GREEN if ok else RED
        _draw_line(canvas, p, q, color)
        _draw_circle(canvas, p, circle_radius, color)
        _draw_circle(canvas, q, circle_radius, color)
    return canvas


def draw_matches_with_error(img1, img2, xy1, xy2, H: np.ndarray,
                            threshold: float = 3.0) -> np.ndarray:
    """DrawMatchesWithError (matching.cpp:2650-2922): color by
    reprojection error under H (1->2): green below threshold, red above,
    and a yellow tick to the reprojected position."""
    xy1 = np.asarray(xy1, np.float32)
    xy2 = np.asarray(xy2, np.float32)
    proj = h_transfer(torch.as_tensor(np.asarray(H, np.float32)),
                      torch.as_tensor(xy1)).numpy()
    err = np.hypot(*(proj - xy2).T)
    canvas, off = side_by_side(img1, img2, True)
    for p, q, pr, e in zip(xy1, xy2 + off, proj + off, err):
        color = GREEN if e < threshold else RED
        _draw_line(canvas, p, q, color)
        if e >= threshold:
            _draw_line(canvas, q, pr, YELLOW)
    return canvas


def draw_regions(img, xy: np.ndarray, A: np.ndarray, s: np.ndarray,
                 mask: np.ndarray | None = None,
                 color=GREEN) -> np.ndarray:
    """Affine-ellipse overlays (DrawRegions, matching.cpp:1460-1640)."""
    canvas = _to_rgb(img)
    xy = np.asarray(xy, np.float32)
    A = np.asarray(A, np.float32)
    s = np.asarray(s, np.float32)
    if mask is None:
        mask = np.ones(len(xy), bool)
    for i in np.nonzero(mask)[0]:
        _draw_ellipse(canvas, xy[i], A[i] * s[i], 1.0, color)
    return canvas


def draw_epipolar(img1, img2, xy1, xy2, F: np.ndarray,
                  max_lines: int = 50) -> np.ndarray:
    """Epipolar-line overlay for F-verified matches
    (DrawMatches F branch, matching.cpp:1950-2100)."""
    canvas, off = side_by_side(img1, img2, True)
    xy1 = np.asarray(xy1, np.float32)[:max_lines]
    xy2 = np.asarray(xy2, np.float32)[:max_lines]
    F = np.asarray(F, np.float64)
    h2, w2 = np.asarray(img2).shape[:2]
    for p, q in zip(xy1, xy2):
        l = F @ np.array([p[0], p[1], 1.0])             # line in image 2
        if abs(l[1]) > 1e-9:
            x0, x1 = 0.0, float(w2 - 1)
            y0 = -(l[0] * x0 + l[2]) / l[1]
            y1 = -(l[0] * x1 + l[2]) / l[1]
            _draw_line(canvas, (x0 + off[0], y0 + off[1]),
                       (x1 + off[0], y1 + off[1]), BLUE)
        _draw_circle(canvas, q + off, 3.0, GREEN)
        _draw_circle(canvas, p, 3.0, GREEN)
    return canvas


def save_image(path: str, canvas: np.ndarray) -> None:
    image_io.save_image(path, canvas)
