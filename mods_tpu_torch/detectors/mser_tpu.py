"""Device MSER: maximally-stable extremal regions as a batched level
sweep on the device (mirrors ``mods_tpu/detectors/mser_tpu.py``, the JAX
package's ``mser.backend = "device"``).

The grey-level sweep is a Python loop over L quantized thresholds (the
JAX package's ``lax.scan``).  Per level, the connected components of the
threshold mask are labelled by min-index label propagation: segmented
running minima along rows and columns, plus pointer jumping.  A
segmented prefix minimum is one ``cummin`` over ``value - seg_id * BIG``
(int64, BIG > H*W): a later segment's keys lie below every earlier
one's, so the running minimum never crosses a segment boundary, and
``seg_id * BIG`` added back restores the values.  Component areas and
raw moments are label-keyed ``index_add_`` sums (float atomics on the
card: the moment sums round in another order from run to run, the
areas are exact counts).  Stability follows the native twin's
``best_rate`` (native/mser.cpp:175-179).  MSER+ (dark) and MSER- (bright)
run as one batch on (img, 255 - img).

Like the JAX package's, this backend quantizes grey levels and is not at
parity with the host MSER: it is held to the JAX device backend.
"""

from __future__ import annotations

import torch

from mods_tpu_torch.config import CapacityParams
from mods_tpu_torch.ops.select import nonzero_static, top_k
from mods_tpu_torch.regions import Regions

MSER_PLUS = 21   # dark regions (reference sub_type)
MSER_MIN = 20


def _seg_min(values: torch.Tensor, boundary: torch.Tensor, axis: int,
             big: int, reverse: bool = False) -> torch.Tensor:
    """Segmented running min of int64 ``values`` in [0, big) along
    ``axis``; ``boundary`` True starts a new segment in the scan's
    direction (with ``reverse`` the scan runs from the end)."""
    if reverse:
        return _seg_min(values.flip(axis), boundary.flip(axis), axis,
                        big).flip(axis)
    seg = torch.cumsum(boundary.to(torch.int64), axis) * big
    return torch.cummin(values - seg, axis).values + seg


def _line_pass(lab: torch.Tensor, m: torch.Tensor, axis: int,
               big: int) -> torch.Tensor:
    """Full segmented min along ``axis`` (forward and backward prefix
    minima): every pixel of a mask run gets the run's min label."""
    n = m.shape[axis]
    shape = [1] * m.ndim
    shape[axis] = n
    idx = torch.arange(n, device=m.device).reshape(shape)
    prev = torch.roll(m, 1, dims=axis)
    nxt = torch.roll(m, -1, dims=axis)
    bf = (idx == 0) | ~m | ~prev
    bb = (idx == n - 1) | ~m | ~nxt
    fwd = _seg_min(lab, bf, axis, big)
    bwd = _seg_min(lab, bb, axis, big, reverse=True)
    return torch.minimum(fwd, bwd)


def _label_components(m: torch.Tensor, passes: int) -> torch.Tensor:
    """Min-index connected-component labels of the mask m (B, H, W):
    flat labels (B, H*W) int64, H*W on pixels outside the mask."""
    B, H, W = m.shape
    HW = H * W
    big = HW + 1
    idx = torch.arange(HW, device=m.device).reshape(1, H, W)
    lab = torch.where(m, idx, HW)
    for _ in range(passes):
        lab = _line_pass(lab, m, -1, big)
        lab = _line_pass(lab, m, -2, big)
        # pointer jump: the label of the label contracts label chains
        flat = lab.reshape(B, HW)
        jump = torch.gather(flat, 1, flat.clamp(max=HW - 1))
        lab = torch.where(m, torch.minimum(lab, jump.reshape(B, H, W)), HW)
    return torch.where(m, lab, HW).reshape(B, HW)


def _mser_sweep(gray2: torch.Tensor, valid: torch.Tensor, levels: int,
                passes: int, r_step: int, min_size: int,
                max_size: torch.Tensor, min_margin: int) -> dict:
    """gray2 (B, H, W), B = 2V (dark polarity first, inverted second);
    valid (B, H, W) bool; max_size (B, 1).  Returns the candidate records
    of every level stacked to (levels, r_step, ...)."""
    B, H, W = gray2.shape
    HW = H * W
    dev = gray2.device
    step = 256.0 / levels
    xs = torch.arange(W, dtype=torch.float32, device=dev).repeat(H)[None]
    ys = torch.arange(H, dtype=torch.float32,
                      device=dev).repeat_interleave(W)[None]
    iota = torch.arange(HW, device=dev)[None]
    row_base = (torch.arange(B, device=dev) * (HW + 1))[:, None]
    a_m1 = torch.zeros((B, HW), dtype=torch.float32, device=dev)
    q_m1 = torch.full((B, HW), float("inf"), device=dev)
    recs = {"b": [], "margin": [], "mom": []}
    for lvl in range(levels):
        t = (lvl + 1.0) * step - 1.0
        m = (gray2 <= t) & valid
        lab = _label_components(m, passes)              # (B, HW)
        mf = m.reshape(B, HW)
        labc = torch.where(mf, lab, HW)
        w = mf.to(torch.float32)
        # six label-keyed sums, one index_add_ over the flat (B*(HW+1))
        # bins each.  A pixel outside the mask adds its weight 0 to its
        # own bin, which no label uses (a label is the index of a mask
        # pixel), not to the shared bin H*W as the JAX package does: on
        # the card every atomic add of the background would land on one
        # address
        key = (row_base + torch.where(mf, lab, iota)).reshape(-1)
        sums = []
        for wt in (w, xs * w, ys * w, xs * xs * w, xs * ys * w,
                   ys * ys * w):
            acc = torch.zeros(B * (HW + 1), dtype=torch.float32,
                              device=dev)
            sums.append(acc.index_add_(0, key, wt.reshape(-1)).reshape(
                B, HW + 1))
        area = sums[0]
        a_map = torch.where(mf, torch.gather(area, 1, labc), 0.0)
        root = mf & (lab == iota)
        # backward growth rate of the containing component
        # (native/mser.cpp:175, rate = (n - size_prev)/n)
        q = torch.where(a_map > 0, (a_map - a_m1) / a_map.clamp(min=1.0),
                        float("inf"))
        margin = step / q.clamp(min=1e-6)
        ok = (root & (q < q_m1) & (a_map >= min_size)
              & (a_map <= max_size) & (margin > min_margin))
        cand, cvalid = nonzero_static(ok.reshape(-1), r_step)
        bidx = cand // HW
        clab = lab.reshape(-1)[cand].clamp(max=HW)
        mom = torch.stack([s[bidx, clab] for s in sums], -1)
        recs["b"].append(torch.where(cvalid, bidx, -1))
        recs["margin"].append(torch.where(cvalid, margin.reshape(-1)[cand],
                                          0.0))
        recs["mom"].append(torch.where(cvalid[:, None], mom, 0.0))
        # pixels new to the mask inherit their component's rate once
        # computed
        a_m1 = a_map
        q_m1 = torch.where(mf, q, float("inf"))
    return {k: torch.stack(v) for k, v in recs.items()}


def _sym_sqrt(cxx, cxy, cyy):
    """Vectorized 2x2 symmetric square root (native/mser.cpp sym_sqrt,
    after the reference's schur_sym ellipse fit)."""
    tr = cxx + cyy
    det = (cxx * cyy - cxy * cxy).clamp(min=1e-12)
    disc = (tr * tr / 4.0 - det).clamp(min=0.0)
    l1 = tr / 2.0 + torch.sqrt(disc)
    l2 = (tr / 2.0 - torch.sqrt(disc)).clamp(min=1e-12)
    use = cxy.abs() > 1e-12
    vx = torch.where(use, l1 - cyy, 1.0)
    vy = torch.where(use, cxy, 0.0)
    nv = torch.sqrt(vx * vx + vy * vy)
    vx, vy = vx / nv, vy / nv
    s1, s2 = torch.sqrt(l1), torch.sqrt(l2)
    a11 = s1 * vx * vx + s2 * vy * vy
    a12 = (s1 - s2) * vx * vy
    a22 = s1 * vy * vy + s2 * vx * vx
    return a11, a12, a12, a22


def _select_regions(recs: dict, V: int, K: int):
    """(levels, r_step) records -> per-view top-K by margin, all views at
    once.  Batch index b in [0, 2V): b % V the view, b // V the polarity
    (0 dark = MSER+, 1 bright = MSER-).  Ties go to the lower record, as
    ``lax.top_k`` breaks them (ops/select.py)."""
    b = recs["b"].reshape(-1)
    margin = recs["margin"].reshape(-1)
    mom = recs["mom"].reshape(-1, 6)
    n = mom[:, 0].clamp(min=1.0)
    mx = mom[:, 1] / n
    my = mom[:, 2] / n
    cxx = (mom[:, 3] / n - mx * mx).clamp(min=1e-9)
    cxy = mom[:, 4] / n - mx * my
    cyy = (mom[:, 5] / n - my * my).clamp(min=1e-9)
    a11, a12, a21, a22 = _sym_sqrt(cxx, cxy, cyy)
    view = torch.where(b >= 0, b % V, -1)
    pol = torch.where(b >= 0, b // V, 0)
    mine = view[None] == torch.arange(V, device=b.device)[:, None]
    score = torch.where(mine, margin[None], -1.0)           # (V, N)
    val, idx = top_k(score, K)
    ok = val > 0

    def take(a):
        return torch.where(ok, a[idx], 0.0)
    xy = torch.stack([take(mx), take(my)], -1)
    A = torch.stack([take(a11), take(a12), take(a21), take(a22)],
                    -1).reshape(V, K, 2, 2)
    A = torch.where(ok[..., None, None], A,
                    torch.eye(2, device=b.device))
    sub = torch.where(pol[idx] == 0, MSER_PLUS, MSER_MIN)
    return (xy, A, torch.where(ok, 1.0, 0.0), take(margin),
            torch.where(ok, sub, 0).to(torch.int32), ok)


def detect_mser_tpu(views: torch.Tensor, valid_hw: torch.Tensor,
                    caps: CapacityParams, min_size: int = 30,
                    max_area: float = 0.05, min_margin: int = 8,
                    levels: int = 32, passes: int = 3,
                    r_step: int = 1024) -> Regions:
    """views (V, H, W) float 0..255, valid_hw (V, 2) on the views'
    device -> Regions (V, caps.per_view)."""
    V, H, W = views.shape
    dev = views.device
    ys = torch.arange(H, device=dev)[None, :, None]
    xs = torch.arange(W, device=dev)[None, None, :]
    valid = (ys < valid_hw[:, 0, None, None]) & (xs < valid_hw[:, 1, None,
                                                              None])
    npx = (valid_hw[:, 0] * valid_hw[:, 1]).to(torch.float32)
    # polarity batch: dark on the image, bright on the inversion
    g2 = torch.cat([views, 255.0 - views])
    v2 = torch.cat([valid, valid])
    max_size = torch.cat([npx, npx])[:, None] * max_area
    recs = _mser_sweep(g2, v2, levels, passes, r_step, min_size, max_size,
                       min_margin)
    xy, A, s, resp, sub, mask = _select_regions(recs, V, caps.per_view)
    return Regions(xy=xy, A=A, s=torch.where(mask, 1.0, 0.0),
                   response=resp, sub_type=sub, mask=mask)
