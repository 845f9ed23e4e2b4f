"""FGINN 2NN matching as a distance product plus exact top-k (mirrors
``mods_tpu/matching/fginn.py``; reference ``MatchFlannFGINN``,
matching.cpp:357-461).

SIFT values are integers 0..255, so squared L2 distances are exact in
float32 (128 * 255^2 < 2^24) and FGINN decisions are exact given
identical descriptors.  The JAX package's ``approx_max_k`` runs only on
a TPU; the port uses exact top-k, as the JAX CPU reference does.

Every function takes an optional leading pair axis, (P, N, D) lists
with (P, N) masks, and treats each pair on its own (the JAX package's
``vmap``): batched products and a batched top-k.  FGINN+DB's database
is shared by every pair.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mods_tpu_torch.ops.select import take_rows


@dataclass(frozen=True)
class Tentatives:
    """Fixed-capacity tentative correspondences, one slot per list1 row."""
    idx2: torch.Tensor    # (..., N1) int64 matched index into list2
    d1: torch.Tensor      # (..., N1) distance^2 to the first NN
    d2: torch.Tensor      # (..., N1) distance^2 to the FGINN second
    ratio: torch.Tensor   # (..., N1) sqrt(d1 / d2)
    mask: torch.Tensor    # (..., N1) bool

    def count(self) -> torch.Tensor:
        return self.mask.to(torch.int32).sum(-1)


def knn_squared_l2(desc1: torch.Tensor, mask1: torch.Tensor,
                   desc2: torch.Tensor, mask2: torch.Tensor, k: int,
                   row_tile: int = 1024):
    """Exact k smallest squared-L2 neighbours in list2 for each list1 row
    -> (dists (..., N1, k), idx (..., N1, k)); invalid list2 rows are at
    +inf.  A list2 without the pair axis is shared by every pair.

    Ties go to the lower list2 index, as ``lax.top_k`` breaks them: the
    selection is a stable ascending sort, sliced (ops/select.py)."""
    sq2 = (desc2 * desc2).sum(-1)
    bad2 = torch.where(mask2, 0.0, float("inf"))
    d2t = desc2.transpose(-1, -2)
    dists, idx = [], []
    for t in torch.split(desc1, row_tile, dim=-2):
        sq1 = (t * t).sum(-1)
        dist = (sq1[..., :, None] + sq2[..., None, :] + bad2[..., None, :]
                - 2.0 * (t @ d2t))
        dist = torch.clamp(dist, min=0.0)
        d, i = torch.sort(dist, dim=-1, stable=True)
        dists.append(d[..., :k])
        idx.append(i[..., :k])
    return torch.cat(dists, -2), torch.cat(idx, -2)


def match_fginn(desc1: torch.Tensor, mask1: torch.Tensor,
                desc2: torch.Tensor, mask2: torch.Tensor,
                reproj_xy2: torch.Tensor, ratio_threshold: float,
                contrad_dist: float = 10.0, knn: int = 50,
                row_tile: int = 1024, standard_2nd: bool = False,
                db: tuple | None = None) -> Tentatives:
    """FGINN matching of list1 against list2.  reproj_xy2 (..., N2, 2): list2
    coordinates in the original image frame, where the contradiction
    distance is measured.

    The effective "second" neighbour is the first geometric
    contradictor within the knn list, else the last retrieved neighbour
    (the reference's scan, matching.cpp:431-458).

    db: optional (desc_db (Ndb, D), mask_db (Ndb,)), the FGINN+DB mode
    (MatchFlannFGINNPlusDB, matching.cpp:462-566): the effective ratio is
    max(FGINN ratio, d0 / d_nearest_in_DB), so a match must also beat its
    nearest database impostor."""
    dists, idx = knn_squared_l2(desc1, mask1, desc2, mask2, knn, row_tile)
    xy = take_rows(reproj_xy2, idx, desc1.dim() - 2)
    dxy = xy - xy[..., 0:1, :]
    geo = (dxy * dxy).sum(-1)
    contra = geo > (contrad_dist * contrad_dist)
    contra[..., 0] = False
    any_contra = contra.any(-1)
    last_finite = torch.clamp(torch.isfinite(dists).sum(-1) - 1, min=1)
    # argmax of a bool row = first True (torch.argmax returns the first
    # maximal index, as jnp.argmax does)
    first_contra = torch.argmax(contra.to(torch.uint8), dim=-1)
    jstar = torch.where(any_contra, first_contra, last_finite)
    if standard_2nd:
        jstar = torch.ones_like(jstar)
    d0 = dists[..., 0]
    dj = torch.gather(dists, -1, jstar[..., None])[..., 0]
    ratio_sq = d0 / torch.where(dj > 0, dj, float("inf"))
    if db is not None:
        ddb, _ = knn_squared_l2(desc1, mask1, db[0], db[1], 1, row_tile)
        # an identical DB impostor (d_db -> 0) gives ratio -> inf
        ratio_sq = torch.maximum(ratio_sq,
                                 d0 / torch.clamp(ddb[..., 0], min=1e-12))
    thr = float(ratio_threshold)
    ok = (mask1 & (ratio_sq <= thr * thr) & torch.isfinite(d0)
          & torch.isfinite(dj))
    return Tentatives(
        idx2=idx[..., 0], d1=d0, d2=dj,
        ratio=torch.sqrt(torch.where(ratio_sq > 0, ratio_sq, 0.0)),
        mask=ok)


def match_distance(desc1: torch.Tensor, mask1: torch.Tensor,
                   desc2: torch.Tensor, mask2: torch.Tensor, threshold,
                   row_tile: int = 1024,
                   squared_threshold: bool = False) -> Tentatives:
    """Absolute-distance matching (``MatchFLANNDistance``,
    matching.cpp:607-666): the nearest neighbour with distance <=
    threshold.  For binary (0/1 float) descriptors the squared L2 is the
    Hamming distance: pass ``squared_threshold=True`` with the Hamming
    budget (the ladder's distance threshold of 60 for ORB).  The product
    of 0/1 rows is exact in float32 only with TF32 off, which the package
    sets at import."""
    dists, idx = knn_squared_l2(desc1, mask1, desc2, mask2, 2, row_tile)
    d0 = dists[..., 0]
    thr = float(threshold)
    thr2 = thr if squared_threshold else thr * thr
    ok = mask1 & (d0 <= thr2) & torch.isfinite(d0)
    return Tentatives(idx2=idx[..., 0], d1=d0, d2=dists[..., 1],
                      ratio=torch.sqrt(d0 / torch.clamp(dists[..., 1],
                                                        min=1e-12)),
                      mask=ok)


def duplicate_filter(xy1: torch.Tensor, xy2: torch.Tensor,
                     mask: torch.Tensor, radius: float, iters: int = 8,
                     priority: torch.Tensor | None = None) -> torch.Tensor:
    """Duplicate tentative suppression (``DuplicateFiltering``,
    matching.cpp:2983-3047): j is dropped when a kept higher-priority i
    has both endpoints within ``radius``; the greedy scan is computed by
    fixed-point iteration, as in the JAX package."""
    if radius <= 0:
        return mask
    n = xy1.shape[-2]
    r2 = radius * radius
    dev = xy1.device
    if priority is None:
        priority = torch.arange(n, dtype=torch.float32, device=dev)

    def close(a):
        d = a[..., :, None, :] - a[..., None, :, :]
        return (d * d).sum(-1) <= r2

    dup = close(xy1) & close(xy2)
    pr = priority + torch.arange(n, dtype=priority.dtype, device=dev) * 1e-9
    higher = pr[..., None, :] < pr[..., :, None]      # [j, i]: i beats j
    pair_bad = dup & higher & mask[..., :, None] & mask[..., None, :]
    keep = mask
    for _ in range(iters):
        keep = mask & ~(pair_bad & keep[..., None, :]).any(-1)
    return keep
