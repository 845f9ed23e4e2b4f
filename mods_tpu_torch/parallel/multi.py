"""One-vs-many and pair-batched matching on one card (mirrors
``mods_tpu/parallel/multi.py`` with ``mesh=None``).

The reference loops gallery images serially (mods_multi.cpp:232-260) and
escalates until at least one image matches (GetAtLeastOneImageMatch,
:229-234).  Here the gallery is a batch axis: the P images of a gallery
(or both sides of P independent pairs) advance the escalation ladder
together.  The JAX package ``vmap``s its fused per-group programs over
that axis; PyTorch has no ``vmap`` over these eager stages, so the P
images are folded into the view axis that every stage already batches
over (``TwoViewMatcher._process_image`` with ``sizes``): per view group
one render, one detector call and one describe stage, each pair
compacted to its own rows and every patch set of all P pairs one
window-sampler launch; per rung one matching call per (detector,
descriptor) and one verification, LO-RANSAC H batched over the pairs.
Each pair draws its RANSAC numbers from a ``torch.Generator`` of its own,
seeded as ``TwoViewMatcher`` seeds a pair, and the ladder is the serial
matcher's own loop (``TwoViewMatcher._escalate``), so an unpadded pair's
batched result is its serial one up to the rounding of the batched
convolutions (a library may pick another algorithm for a batch).
Several GPUs (the JAX package's ``mesh``) are ROADMAP.md item 22, not
ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mods_tpu_torch.config import as_rungs
from mods_tpu_torch.ops.image import to_gray_np
from mods_tpu_torch.ops.select import nonzero_static
from mods_tpu_torch.pipeline import (BatchedDeviceStore, EngineConfig,
                                     TwoViewMatcher, _not_ported, _take_fill,
                                     _verify_parts, stop_and_best)
from mods_tpu_torch.timing import TimeLog

__all__ = ["BatchResult", "BatchedDeviceStore", "MultiMatcher",
           "MultiResult", "PairBatchMatcher"]


@dataclass
class MultiResult:
    """Per-gallery-image outcomes of a one-vs-many run."""
    counts: np.ndarray          # (P,) verified matches per gallery image
    n_tentatives: np.ndarray    # (P,)
    steps_used: int
    log: TimeLog
    xy1: list                   # per-gallery (Ni, 2) matched query points
    xy2: list
    H: np.ndarray               # (P, 3, 3) estimated models


def _pad_gallery(imgs: list[np.ndarray]):
    """Stack differently-sized gallery images onto one gray canvas."""
    hs = [im.shape[0] for im in imgs]
    ws = [im.shape[1] for im in imgs]
    H, W = max(hs), max(ws)
    out = np.full((len(imgs), H, W), 128.0, np.float32)
    for i, im in enumerate(imgs):
        out[i, : im.shape[0], : im.shape[1]] = im
    return out, list(zip(hs, ws))


@dataclass
class BatchResult:
    """Per-pair outcomes of a pair-batched run (serial MatchResult
    semantics per pair: first rung crossing min_matches stops that pair,
    best rung up to there is reported)."""
    counts: np.ndarray          # (P,) verified matches
    n_tentatives: np.ndarray    # (P,)
    steps_used: np.ndarray      # (P,)
    H: np.ndarray               # (P, 3, 3)
    xy1: list                   # per-pair (Ni, 2)
    xy2: list
    log: TimeLog = None


class MultiMatcher:
    """Query vs gallery escalation matcher (mods_multi.cpp main loop) on
    ``device`` (the card unless the caller passes ``"cpu"``).  The query
    runs the serial ``TwoViewMatcher``'s stages, the gallery the same
    stages with its P images folded into the view axis."""

    def __init__(self, ladder=None, cfg: EngineConfig | None = None,
                 seed: int = 0, mesh=None,
                 device: str | torch.device = "cuda"):
        if mesh is not None:
            raise _not_ported("matching over a mesh of several GPUs", 22)
        # an empty ladder is the default one, as in the JAX package's
        # batched matchers
        self.qmatcher = TwoViewMatcher(ladder or None, cfg, seed=seed,
                                       device=device)
        self.cfg = self.qmatcher.cfg
        self.device = self.qmatcher.device
        self._seed = seed

    def close(self) -> None:
        """Cancel pending host-stage jobs and stop the prefetch pool."""
        self.qmatcher.close()

    @property
    def rung_peak_bytes(self) -> list:
        """Peak device memory of each rung of the last call."""
        return self.qmatcher.rung_peak_bytes

    @property
    def rungs_run(self) -> int:
        """The rungs the last call ran."""
        return self.qmatcher.rungs_run

    def _escalate(self, side1: tuple, side2: tuple, P: int, wh: tuple,
                  log: TimeLog, stop) -> tuple[list, int]:
        """The serial matcher's ladder (``TwoViewMatcher._escalate``) over
        two sides, each (key, device images, numpy images, their sizes or
        None for one unbatched image); every rung matches and verifies the
        P pairs at once.  After each rung, one host read of the P verified
        counts, and ``stop(counts)`` ends the escalation.  Returns ([(rungs
        run, verification, counts)], rungs run)."""
        # one generator a pair, each seeded as the serial matcher seeds a
        # pair: pair p draws what TwoViewMatcher(seed).match draws on it
        if any(it.detector == "ReadAffs"
               for rung in as_rungs(self.qmatcher.ladder) for it in rung.dets):
            raise NotImplementedError(
                "ReadAffs has no per-gallery keypoint files; use the "
                "serial path")
        generators = [torch.Generator(device=self.device).manual_seed(
            self._seed) for _ in range(P)]
        bank: dict = {}
        outs: list = []

        def read(steps: int, out: dict) -> bool:
            counts = out["n_inl"].tolist()    # the rung's one read
            outs.append((steps, out, counts))
            return stop(counts)

        steps = self.qmatcher._escalate(
            (side1, side2), ({}, {}), bank, log,
            lambda: self._verify_bank(bank, log, generators, wh), read)
        return outs, steps

    def _verify_bank(self, bank: dict, log: TimeLog, generators: list,
                     wh: tuple):
        """The batched tentative bank -> per-pair compaction, duplicate
        filter and verification (``_verify_bank_program`` of the JAX
        package, vmapped there, without the ground-truth mode)."""
        tent_parts = [p for parts in bank.values() for p in parts]
        if not tent_parts:
            return None
        with log.phase("RANSACTime"):
            return _verify_parts(tent_parts, self.cfg.caps.tentatives,
                                 self.cfg, wh[0], wh[1], generators)

    @staticmethod
    def _read_verified(outs: list, counts) -> tuple:
        """Pair p's verified rows from ``outs[p]`` (a verification of the
        batch), compacted on the device and read in one copy -> (H
        (P, 3, 3), tentatives (P,), xy1 and xy2 lists of (counts[p], 2))."""
        P = len(outs)

        def sel(k):
            return torch.stack([o[k][p] for p, o in enumerate(outs)])

        inl = sel("inlier_mask")
        idx, valid = nonzero_static(inl, inl.shape[-1])
        xy = torch.cat([_take_fill(sel("xy1_all"), idx, valid),
                        _take_fill(sel("xy2_all"), idx, valid)], -1)
        host = torch.cat([xy.reshape(P, -1), sel("model").reshape(P, 9),
                          sel("n_tent").to(torch.float32)[:, None]],
                         1).cpu().numpy()
        xy = host[:, :-10].reshape(P, -1, 4)
        return (host[:, -10:-1].reshape(P, 3, 3),
                host[:, -1].astype(np.int32),
                [xy[p, :counts[p], :2] for p in range(P)],
                [xy[p, :counts[p], 2:] for p in range(P)])

    def match(self, query_img, gallery_imgs: list,
              stop_at_first: bool = True) -> MultiResult:
        """Returns a MultiResult.  Escalates until at least one gallery
        image reaches min_matches (GetAtLeastOneImageMatch,
        mods_multi.cpp:229-234), or all do when ``stop_at_first`` is
        False."""
        dev = self.device
        log = self.qmatcher._new_log()
        q = to_gray_np(query_img)
        imgs, sizes = _pad_gallery([to_gray_np(g) for g in gallery_imgs])
        P = imgs.shape[0]
        mm = self.cfg.min_matches
        outs, steps = self._escalate(
            ("q", torch.as_tensor(q, device=dev), q, None),
            ("g", torch.as_tensor(imgs, device=dev), imgs, tuple(sizes)), P,
            (max(q.shape[1], imgs.shape[2]), max(q.shape[0], imgs.shape[1])),
            log, lambda c: (stop_at_first and max(c) >= mm) or min(c) >= mm)
        log.finalize()
        if not outs:
            zero = np.zeros(P, np.int32)
            return MultiResult(
                counts=zero, n_tentatives=zero, steps_used=steps, log=log,
                xy1=[np.zeros((0, 2))] * P, xy2=[np.zeros((0, 2))] * P,
                H=np.tile(np.eye(3, dtype=np.float32), (P, 1, 1)))
        _, out, counts = outs[-1]
        H, n_tent, xy1, xy2 = self._read_verified([out] * P, counts)
        return MultiResult(counts=np.asarray(counts, np.int32),
                           n_tentatives=n_tent, steps_used=steps, log=log,
                           xy1=xy1, xy2=xy2, H=H)


class PairBatchMatcher:
    """Pair-batched two-view serving on one card: P independent
    (imgA, imgB) pairs advance the escalation ladder TOGETHER, one
    batched call per view group / match / verify.

    Reference axis: mods_multi.cpp:232-260 batches the gallery side;
    here BOTH sides carry the pair axis.  The whole batch escalates
    until every pair crossed min_matches (or rungs run out), reading the
    P verified counts once a rung; per-pair results then follow mods.cpp's
    serial selection (first crossing rung stops the pair, best rung up to
    there reported), and the verified rows are read once, after the
    stop."""

    def __init__(self, ladder=None, cfg: EngineConfig | None = None,
                 seed: int = 0, mesh=None,
                 device: str | torch.device = "cuda"):
        self.mm = MultiMatcher(ladder, cfg, seed=seed, mesh=mesh,
                               device=device)
        self.cfg = self.mm.cfg

    def close(self) -> None:
        self.mm.close()

    def match_batch(self, pairs: list) -> BatchResult:
        mm, cfg, dev = self.mm, self.cfg, self.mm.device
        log = mm.qmatcher._new_log()
        imgs1, sizes1 = _pad_gallery([to_gray_np(a) for a, _ in pairs])
        imgs2, sizes2 = _pad_gallery([to_gray_np(b) for _, b in pairs])
        P = len(pairs)
        outs, steps = mm._escalate(
            ("a", torch.as_tensor(imgs1, device=dev), imgs1, tuple(sizes1)),
            ("b", torch.as_tensor(imgs2, device=dev), imgs2, tuple(sizes2)),
            P, (max(imgs1.shape[2], imgs2.shape[2]),
                max(imgs1.shape[1], imgs2.shape[1])), log,
            lambda c: min(c) >= cfg.min_matches)
        log.finalize()
        if not outs:
            zero = np.zeros(P, np.int32)
            return BatchResult(zero, zero, zero + steps,
                               np.tile(np.eye(3, dtype=np.float32),
                                       (P, 1, 1)),
                               [np.zeros((0, 2))] * P,
                               [np.zeros((0, 2))] * P, log)
        inls = np.asarray([c for _, _, c in outs])        # (R, P)
        # per pair, the serial matcher's stop and pick (mods.cpp:229-230)
        best, counts, steps_used = [], [], []
        for i in range(P):
            stop_i, best_i = stop_and_best(inls[:, i], inls[:, i],
                                           cfg.min_matches)
            best.append(best_i)
            counts.append(int(inls[best_i, i]))
            steps_used.append(outs[stop_i][0]
                              if inls[stop_i, i] >= cfg.min_matches
                              else steps)
        H, n_tent, xy1, xy2 = mm._read_verified(
            [outs[b][1] for b in best], counts)
        return BatchResult(counts=np.asarray(counts, np.int32),
                           n_tentatives=n_tent,
                           steps_used=np.asarray(steps_used, np.int32), H=H,
                           xy1=xy1, xy2=xy2, log=log)
