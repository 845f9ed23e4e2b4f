"""Windowed affine patch sampling (mirrors ``mods_tpu/ops/sampler.py``).

Orientation and descriptor patches (P=41) go through
``sample_affine_patches``; the Baumberg iteration (P=19) samples the same
way inside its own kernel (``detectors/baumberg.py``).  Per keypoint the
samples are taken inside one (rows, 128) window of its level, centred on
the keypoint and clipped into the canvas.

``sample_affine_patches`` and ``sample_from_windows`` are the wrappers of
the hand-written CUDA kernel ``csrc/window_sampler.cu`` (the port of the
TPU kernel ``_make_sample_kernel`` and of the window gather that feeds
it).  On the card the kernel reads the (L, H, W) level stack directly and
computes each window's origin itself: no (K, rows, 128) window tensor is
built.  ``sample_from_windows`` hands the same kernel prefetched windows
as a K-plane stack.  A CUDA tensor launches the kernel or raises; a CPU
tensor runs the plain version (``prepare_windows`` +
``sample_from_windows_plain``), the same arithmetic in PyTorch.  There is
no fallback from the one to the other.

A patch sample is valid iff floor(x) in [0, Wv-2] and floor(y) in
[0, Hv-2] of its level's valid extent; everything else returns ``fill``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from mods_tpu_torch.ops.warp import to_index

WIN_Y = 136          # minimum canvas height
WIN_X = 256          # minimum canvas width
# Max patch half-extent the samplers guarantee to cover, in source-level
# pixels; select_level keeps every standard patch size below it.
MAX_HALF_EXTENT = 44.0
PALLAS_COLS = 128    # window width


def pad_canvas(img: torch.Tensor) -> torch.Tensor:
    """Edge-pad (..., H, W) up to the window-aligned minimum canvas
    (H a multiple of 8 and >= 136, W a multiple of 128 and >= 256)."""
    h, w = img.shape[-2:]
    ph = max(WIN_Y, -(-h // 8) * 8)
    pw = max(WIN_X, -(-w // 128) * 128)
    if ph == h and pw == w:
        return img
    lead = img.shape[:-2]
    x = torch.nn.functional.pad(img.reshape(-1, 1, h, w),
                                (0, pw - w, 0, ph - h), mode="replicate")
    return x.reshape(lead + (ph, pw))


def rows_for_patch(patch_size: int, max_step: float = 2.0) -> int:
    """Window rows covering a patch's worst-case vertical extent (+2 px
    margin), rounded to 8 and kept within [48, 96]."""
    ext = max_step * (patch_size // 2) * 1.4143 + 2.0
    return min(max(-(-int(2 * ext + 2) // 8) * 8, 48), 96)


@dataclass(frozen=True)
class WindowSource:
    """Prefetched per-keypoint windows, reusable across resampling rounds
    with different A (Baumberg iterations)."""
    windows: torch.Tensor  # (K, rows, 128) float32
    y0: torch.Tensor       # (K,) int32 window origin row
    x0: torch.Tensor       # (K,) int32 window origin column
    vw: torch.Tensor       # (K,) float32 valid width of the kp's level
    vh: torch.Tensor       # (K,) float32 valid height


def prepare_windows(src: torch.Tensor, lvl: torch.Tensor, xy: torch.Tensor,
                    valid_hw: torch.Tensor, rows: int) -> WindowSource:
    """Fetch the (rows, 128) windows once.  src (L, H, W); lvl (K,);
    xy (K, 2) level coords; valid_hw (L, 2).  Windows are centered on the
    keypoint and clipped into the canvas (the JAX ``rows=`` path)."""
    nl, hc, wc = src.shape
    cy = to_index(torch.floor(xy[:, 1]))
    cx = to_index(torch.floor(xy[:, 0]))
    y0 = (cy - (rows // 2 - 1)).clamp(0, hc - rows)
    x0 = (cx - (PALLAS_COLS // 2 - 1)).clamp(0, wc - PALLAS_COLS)
    lv = lvl.to(torch.int64).clamp(0, nl - 1)
    ry = y0[:, None] + torch.arange(rows, device=src.device)
    rx = x0[:, None] + torch.arange(PALLAS_COLS, device=src.device)
    win = src[lv[:, None, None], ry[:, :, None], rx[:, None, :]]
    vhw = valid_hw.to(torch.float32)[lv]
    return WindowSource(win, y0.to(torch.int32), x0.to(torch.int32),
                        vhw[:, 1].contiguous(), vhw[:, 0].contiguous())


def _sample_coords(ws: WindowSource, xy: torch.Tensor, A: torch.Tensor,
                   P: int):
    """Global (gx, gy) and window-relative (relx, rely) coords, (K, P*P),
    in the kernel's order of operations."""
    half = P // 2
    n = torch.arange(P * P, device=xy.device)
    dx = (n % P - half).to(torch.float32)
    dy = (n // P - half).to(torch.float32)
    gx = (A[:, 0, 0, None] * dx + A[:, 0, 1, None] * dy) + xy[:, 0, None]
    gy = (A[:, 1, 0, None] * dx + A[:, 1, 1, None] * dy) + xy[:, 1, None]
    relx = gx - ws.x0.to(torch.float32)[:, None]
    rely = gy - ws.y0.to(torch.float32)[:, None]
    return gx, gy, relx, rely


def _tap(f: torch.Tensor, n: int) -> torch.Tensor:
    """clamp(floor index, 0, n-2), NaN to 0, as the kernel does."""
    return torch.nan_to_num(f, nan=-1.0).clamp(-1.0, float(n)).to(
        torch.int64).clamp(0, n - 2)


def sample_from_windows_plain(ws: WindowSource, xy: torch.Tensor,
                              A: torch.Tensor, patch_size: int,
                              fill: float = 0.0) -> torch.Tensor:
    """The kernel's plain PyTorch version: a 4-tap gather with the einsum
    path's index rule (``_sample_chunk``, mods_tpu/ops/sampler.py:92-114)
    -> (K, P, P)."""
    K = xy.shape[0]
    P = patch_size
    _, R, X = ws.windows.shape
    gx, gy, relx, rely = _sample_coords(ws, xy, A, P)
    xf = torch.floor(relx)
    yf = torch.floor(rely)
    wx = relx - xf
    wy = rely - yf
    xi = _tap(xf, X)
    yi = _tap(yf, R)
    flat = ws.windows.reshape(K, R * X)
    base = yi * X + xi
    p00 = torch.gather(flat, 1, base)
    p01 = torch.gather(flat, 1, base + 1)
    p10 = torch.gather(flat, 1, base + X)
    p11 = torch.gather(flat, 1, base + X + 1)
    uy = 1.0 - wy
    c0 = uy * p00 + wy * p10
    c1 = uy * p01 + wy * p11
    val = (1.0 - wx) * c0 + wx * c1
    gxf = torch.floor(gx)
    gyf = torch.floor(gy)
    ok = ((gxf >= 0) & (gyf >= 0) & (gxf < (ws.vw - 1.0)[:, None])
          & (gyf < (ws.vh - 1.0)[:, None]))
    return torch.where(ok, val, torch.full_like(val, fill)).reshape(K, P, P)


@functools.lru_cache(maxsize=None)
def _window_sample_fn():
    from mods_tpu_torch import csrc
    fn = csrc.load("window_sampler").window_sample
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _require(what: str, t: torch.Tensor, dtype, dev, shape) -> torch.Tensor:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"window sampler: {what} must be {dtype} {shape} on {dev}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    return t.contiguous()


def _window_sample_cuda(src: torch.Tensor, xy: torch.Tensor,
                        A: torch.Tensor, patch_size: int, fill: float,
                        rows: int, cols: int, *, lvl=None, valid_hw=None,
                        origin=None) -> torch.Tensor:
    """Launch the window-sampler kernel (no launch is counted here).

    Stack mode: ``lvl`` (K,) and ``valid_hw`` (planes, 2) given; the
    kernel places each (rows, cols) window in plane ``lvl_k`` of ``src``.
    Window mode: ``origin`` = (y0, x0, vw, vh), each (K,); plane k of
    ``src`` is keypoint k's window.  The kernel copies rows in 16-byte
    pieces, so W must be a multiple of 4 (every canvas of ``pad_canvas``
    and every window is).
    """
    dev = src.device
    K = xy.shape[0]
    if not src.is_cuda or src.dtype != torch.float32 or src.dim() != 3:
        raise ValueError(f"window sampler: source must be a float32 "
                         f"(planes, H, W) CUDA tensor, got {src.dtype} "
                         f"{tuple(src.shape)} on {dev}")
    planes, H, W = src.shape
    if not 2 <= rows <= H or not 2 <= cols <= W:
        raise ValueError(f"window sampler: a ({rows}, {cols}) window does "
                         f"not fit planes of ({H}, {W})")
    src = src.contiguous()
    if W % 4 or src.data_ptr() % 16:
        raise ValueError(f"window sampler: rows of {W} floats at "
                         f"{src.data_ptr():#x} are not 16-byte aligned")
    xy = _require("xy", xy, torch.float32, dev, (K, 2))
    A = _require("A", A, torch.float32, dev, (K, 2, 2))
    if origin is None:
        if lvl.is_floating_point() or valid_hw.is_floating_point():
            raise ValueError("window sampler: lvl and valid_hw are integers")
        lvl = _require("lvl", lvl.to(torch.int32), torch.int32, dev, (K,))
        valid_hw = _require("valid_hw", valid_hw.to(torch.int32),
                            torch.int32, dev, (planes, 2))
        per_kp = (lvl, valid_hw, None, None, None, None)
    else:
        if planes != K:
            raise ValueError(f"window sampler: {planes} windows for {K} "
                             "keypoints")
        y0, x0, vw, vh = origin
        per_kp = (None, None,
                  _require("y0", y0, torch.int32, dev, (K,)),
                  _require("x0", x0, torch.int32, dev, (K,)),
                  _require("vw", vw, torch.float32, dev, (K,)),
                  _require("vh", vh, torch.float32, dev, (K,)))
    out = torch.empty((K, patch_size, patch_size), dtype=torch.float32,
                      device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _window_sample_fn()(
            src.data_ptr(), planes, H, W,
            *(None if t is None else t.data_ptr() for t in per_kp),
            xy.data_ptr(), A.data_ptr(), out.data_ptr(), K, patch_size,
            rows, cols, float(fill), stream)
    if err != 0:
        raise RuntimeError(f"window_sampler launch failed: CUDA error {err}")
    return out


def sample_from_windows(ws: WindowSource, xy: torch.Tensor, A: torch.Tensor,
                        patch_size: int, fill: float = 0.0) -> torch.Tensor:
    """Sample (K, P, P) patches from prefetched windows.

    xy must be the centers the windows were prepared around (level
    coords); A is the current sampling matrix.  CUDA tensors launch the
    window-sampler kernel on the windows as a K-plane stack (and count
    the launch); CPU tensors run the plain version.
    """
    if ws.windows.is_cuda:
        _, R, X = ws.windows.shape
        out = _window_sample_cuda(ws.windows, xy, A, patch_size, fill, R, X,
                                  origin=(ws.y0, ws.x0, ws.vw, ws.vh))
        sample_from_windows.launches += 1
        return out
    return sample_from_windows_plain(ws, xy, A, patch_size, fill)


sample_from_windows.launches = 0    # kernel launches, for chip_smoke.py


def sample_affine_patches_plain(src: torch.Tensor, lvl: torch.Tensor,
                                xy: torch.Tensor, A: torch.Tensor,
                                patch_size: int, valid_hw: torch.Tensor,
                                fill: float = 0.0) -> torch.Tensor:
    """The kernel's plain PyTorch version on a level stack: gather the
    (K, rows, 128) windows, then the 4-tap gather inside them."""
    ws = prepare_windows(src, lvl, xy, valid_hw,
                         rows=rows_for_patch(patch_size))
    return sample_from_windows_plain(ws, xy, A, patch_size, fill)


def sample_affine_patches(src: torch.Tensor, lvl: torch.Tensor,
                          xy: torch.Tensor, A: torch.Tensor,
                          patch_size: int, valid_hw: torch.Tensor,
                          fill: float = 0.0) -> torch.Tensor:
    """Batched affine patch sampling from a (L, H, W) level stack:
    patch[k, j, i] = src[lvl_k](xy_k + A_k @ [di, dj]), bilinear, with the
    reference's out-of-bounds fill.  CUDA tensors launch the
    window-sampler kernel on the stack (and count the launch); CPU
    tensors run the plain version."""
    if src.is_cuda:
        out = _window_sample_cuda(
            src, xy, A, patch_size, fill, rows_for_patch(patch_size),
            PALLAS_COLS, lvl=lvl, valid_hw=valid_hw)
        sample_affine_patches.launches += 1
        return out
    return sample_affine_patches_plain(src, lvl, xy, A, patch_size,
                                       valid_hw, fill)


sample_affine_patches.launches = 0  # kernel launches, for chip_smoke.py


def sample_mip_patches(mips: torch.Tensor, valid_hw: torch.Tensor,
                       lvl: torch.Tensor, xy: torch.Tensor, A: torch.Tensor,
                       patch_size: int) -> torch.Tensor:
    """``sample_affine_patches`` from the levels of ``mip_stack``: one
    image's (L, Hc, Wc) stack with (K,) rows, or a batch's (..., L, Hc,
    Wc) stacks with (..., K) rows, each row read from its own image's
    levels -> (rows, P, P), all in one launch."""
    L, Hc, Wc = mips.shape[-3:]
    n = mips[..., 0, 0, 0].numel()                     # images
    plane = lvl + L * torch.arange(n, device=lvl.device).reshape(
        lvl.shape[:-1] + (1,))
    return sample_affine_patches(
        mips.reshape(n * L, Hc, Wc), plane.reshape(-1), xy.reshape(-1, 2),
        A.reshape(-1, 2, 2), patch_size, valid_hw.repeat(n, 1))


# ---------------------------------------------------------------------------
# Mip stack: bounded-step sampling for arbitrarily large regions
# ---------------------------------------------------------------------------

MIP_SIGMA = 1.3      # cumulative blur of each level in its own pixels


def _mip_step_sigma() -> float:
    # after 2x decimation the previous level's blur is MIP_SIGMA/2 in new
    # pixels; top up to MIP_SIGMA
    return math.sqrt(MIP_SIGMA ** 2 - (MIP_SIGMA / 2.0) ** 2)


def mip_stack(img: torch.Tensor, n_levels: int):
    """(..., H, W) -> (levels (..., n, Hc, Wc), valid_hw (n, 2) int32).
    Level l is the image 2x-decimated l times with cumulative blur
    ~MIP_SIGMA in its own pixels, stored top-left in the padded canvas.
    Leading axes (the views of a group) share the level extents."""
    from mods_tpu_torch.ops.gaussian import gaussian_blur
    h, w = img.shape[-2:]
    img = pad_canvas(img)
    levels = [img]
    valids = [(h, w)]
    cur = img
    for _ in range(1, n_levels):
        blurred = gaussian_blur(cur, _mip_step_sigma())
        h, w = max(h // 2, 1), max(w // 2, 1)
        dec = blurred[..., ::2, ::2]
        cur = torch.zeros_like(img)
        cur[..., :dec.shape[-2], :dec.shape[-1]] = dec
        levels.append(cur)
        valids.append((h, w))
    stack = torch.stack(levels, dim=-3)
    valid_hw = torch.tensor(valids, dtype=torch.int32, device=img.device)
    return stack, valid_hw


def op_norm_2x2(A: torch.Tensor) -> torch.Tensor:
    """Largest singular value of (..., 2, 2) matrices (closed form)."""
    a, b = A[..., 0, 0], A[..., 0, 1]
    c, d = A[..., 1, 0], A[..., 1, 1]
    q = a * a + b * b + c * c + d * d
    det = a * d - b * c
    r = torch.sqrt(torch.clamp(q * q - 4.0 * det * det, min=0.0))
    return torch.sqrt(torch.clamp((q + r) / 2.0, min=0.0))


def select_level(A: torch.Tensor, patch_size: int, n_levels: int,
                 max_step: float = 1.5):
    """Mip level per keypoint so the per-step sampling norm is <=
    max_step and the patch extent fits the window -> (lvl (K,) int64,
    scale (K,) = 2^lvl)."""
    m = op_norm_2x2(A)
    lvl = torch.ceil(torch.log2(torch.clamp(m / max_step, min=1e-12)))
    lvl = lvl.clamp(0, n_levels - 1).to(torch.int64)
    half = patch_size // 2
    scale = torch.exp2(lvl.to(torch.float32))
    ext = m / scale * half * math.sqrt(2.0)
    extra = torch.ceil(torch.log2(torch.clamp(ext / MAX_HALF_EXTENT,
                                              min=1e-12)))
    lvl2 = (lvl + torch.clamp(extra, min=0).to(torch.int64)).clamp(
        0, n_levels - 1)
    return lvl2, torch.exp2(lvl2.to(torch.float32))
