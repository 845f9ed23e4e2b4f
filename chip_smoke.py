#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mods_tpu_torch``) on one NVIDIA
GPU.  Run from the repository root:

    python3 chip_smoke.py

Phases (each raises on failure; the exit status is 0 only when all pass):

0. the card: name and power limit (nvidia-smi), torch and CUDA versions;
1. build every CUDA kernel under ``mods_tpu_torch/csrc`` for sm_90a, one
   nvcc per source, all started together, and print ptxas's report; build
   ``native/mser.cpp`` and ``native/render.cpp`` with g++ into
   ``mods_tpu_torch/_build/native``, and print the compiler, the host's
   cores and the OpenMP thread count;
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, and time kernel, plain version and the nearest
   PyTorch library call (CUDA graphs of repeated calls, CUDA events):
   the window sampler on level stacks and on prefetched windows; the fused
   Baumberg kernel on the detector's own keypoints of zoom2x, octaves 0
   and 3, beside the loop of launches it replaces; and both at the
   ladder's geometries: the sampler at (768, 41) and (768, 31) on a
   48-plane stack of 1280-wide canvases with some planes of extent 0,
   Baumberg over the two views of a rendered tilt-4 group; the sampler at
   the MSER rungs' (512, 41) on 4 planes and (768, 41) on 16;
3. drive the main path, ``make_two_view_step()`` at its default caps, on
   the zoom2x and rot90 pairs of ``.parity_work`` (1000x598): one warm-up
   and three timed steps per pair, with every kernel's launch count set
   to 0 just before and read just after; hold the result against the
   ground-truth homographies and the JAX package's figures (rot90's
   corner error, a RANSAC draw for both packages, over 50 seeds);
4. run a small pair on the card and on the CPU (the plain versions) and
   hold the two results against each other;
5. profile the main path: one ``torch.profiler`` window over three steps
   per pair giving, per step, the device busy time (the union of kernel
   intervals) and its idle share of the wall time, kernel launches, host
   reads of device values, and each stage range's (``mods.detect``,
   ``mods.orient``, ``mods.describe``, ``mods.match``, ``mods.ransac``)
   host time, device busy time and launches, and the kernels that take
   the most device time; one profiled pair (tilt4) of the ladder, per
   ``TimeLog`` phase; one profiled pair (tilt6_rot45) of the CVIU-shaped
   ladder, and the host reads of that pair in ``pipelined`` mode; one
   profiled tilt4 pair of phase 9's KAZE, SURF and device-MSER ladders.
   It reads the raw Kineto records (``_raw_events``); on zoom2x's
   flagship steps it also reads ``prof.events()`` and holds the two
   readings equal;
6. drive the escalation ladder, ``TwoViewMatcher(LADDER, EngineConfig(),
   device="cuda").match``, on all four ``.parity_work`` pairs at full
   size: one warm-up and one timed pair each (phase 7 holds the timed
   repeats), the kernels' launch counts held against those reckoned from
   the plan, the result held against the ground truth and the JAX
   matcher's figures (``JAX_LADDER_REFERENCE``);
7. hold the host render (``native/render.cpp``, what MSER sees) against
   the card's render of every MSER view group of tilt4 and tilt6_rot45
   (< 0.05 grey levels), then drive the CVIU-shaped ladder
   (``CVIU_LADDER``: ORB, MSER and HessianAffine rungs) on all four pairs:
   one warm-up and three timed pairs in ``sync`` mode and one in
   ``pipelined`` mode each, the launch counts held against the plan, the
   result against the JAX matcher's figures (``JAX_CVIU_REFERENCE``;
   on tilt6_rot45, where the JAX matcher's own stop rung is RANSAC's
   draw, over 200 seeds of the verification of each rung:
   ``JAX_CVIU_SPREAD``); it prints the MSER host time, the share the
   prefetch hid and the residual wait, and for the pairs that stop in
   the ORB rungs both ladders' seconds a pair, alternating;
8. run ``python -m mods_tpu_torch.cli match`` on tilt4 with this
   script's INI files for that ladder, once for each of LORANSACH,
   LORANSACF, ORSA and GR_TRUTH, and check its outputs;
9. drive every other device detector (DoG, HarrisAffine, SURF, KAZE,
   TILDE, FAST, STAR, BRISK and MSER with ``mser.backend = "device"``)
   on a two-rung ladder of its own (``DETECTOR_LADDERS``) on zoom2x and
   tilt4 at full size, one warm-up and one timed pair each (three for
   device MSER, the median kept): the launch counts held against the
   plan, each image's regions at each rung within 10 % of the JAX
   matcher's, each rung's tentatives within 20 % (where JAX has at least
   ``min_matches``), and the result held to
   its figures (``JAX_DETECTOR_REFERENCE``; where the card's seed 0 and
   the JAX matcher's own seeds break the rule, over 20 seeds,
   ``JAX_DETECTOR_SPREAD``), and each detector's regions on one
   full-size view on the card against its plain run on the CPU (TILDE's
   also on zoom2x's rung-2 views, its extrema above ``TILDE_NOISE``: on
   the constant fill of a rotated view the score is the rounding of a
   zero-mean bank).  Phase 2 also holds the
   sampler at these rungs' identity groups and Baumberg over DoG's and
   Harris's keypoints;
10. drive pair-batched matching (``mods_tpu_torch.parallel.multi``):
   (a) zoom2x, rot90 and tilt4 as one ``PairBatchMatcher`` batch on the
   CVIU-shaped ladder, padded onto one canvas a side: launches held to
   the batch's plan (one pair's at its canvases, not P times it), each
   pair's rungs, tentatives at each rung, verified matches and matches
   within 3 px to the JAX package's batch (``JAX_BATCH_REFERENCE``; over
   20 seeds where its own seeds break the rule, ``JAX_BATCH_SPREAD``),
   each rung's peak memory; (b) bench.py's protocol on tilt4 and zoom2x:
   batches of 8 noisy copies, one warm-up and two timed, against the
   serial matcher on the same 16 pairs (each batched pair stops at or
   before the serial rung with >= 0.8x its verified matches), one
   profiled batch and one profiled serial pair; (c)
   ``batched_pair_step`` on 4 noisy zoom2x copies, held to phase 3's
   rule and to one step's launches; (d) one-vs-many: the pairs' shared
   image 1 against the image 2s of (a) as one gallery
   (``MultiMatcher.match``), launches held to the plan, rungs,
   tentatives at each rung and verified matches to the JAX package's
   ``MultiMatcher`` (``JAX_MULTI_REFERENCE``).  The kernels line's
   ``launches_pair_batched`` counts the held batched calls only;
11. the other descriptor families: the FREAK and BRISK pair tables and
   the CNN's procedural weights held to the hashes recorded with the JAX
   reference (``PATTERN_SHA256``, ``PROCEDURAL_SHA256``); every family
   of ``OTHER_DESCRIPTORS`` on the same patches of zoom2x image 1's
   identity group on the card and on the CPU
   (``descriptors_card_vs_cpu``); each family on a two-rung ladder of its
   own (``DESCRIPTOR_LADDERS``: phase 9's shape with HessianAffine
   regions, KAZE's with the KAZE detector's) on zoom2x and tilt4 at full
   size, one warm-up and one timed pair each, held to
   ``JAX_DESCRIPTOR_REFERENCE`` and ``JAX_DESCRIPTOR_SPREAD`` by phase
   9's rules and to the launch plan; one ``PairBatchMatcher`` batch of
   both pairs on a rung of SURF and the CNN against the serial runs; and
   ``python -m mods_tpu_torch.cli export_descriptors`` and
   ``extract_benchmark`` on zoom2x image 1 with INI files that list
   several families.  Phase 2 also holds the sampler at the CNN's
   (768, 32).

The last lines are one JSON line of phase 10's batched figures under
bench.py's names, the card (nvidia-smi), one JSON line of kernel
figures and one JSON line ``{"ok": true, "device": {...}}``.  The script
needs no network and imports nothing of JAX or of ``mods_tpu``.

``python3 chip_smoke.py --seed-spread PAIR N [DET]`` instead measures how
far a pair's stop rung on the CVIU-shaped ladder (or on DET's ladder of
phase 9) is the RANSAC draw's: the tentatives of every rung on the card,
and the spread of the card's verification of them over N seeds
(``seed_spread``).
"""

from __future__ import annotations

import bisect
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PAIRS = ROOT / ".parity_work"

# The JAX package's make_two_view_step() at its default caps on these
# pairs, on the CPU: (tentatives, inliers).
JAX_REFERENCE = {"zoom2x": (83, 76), "rot90": (140, 103)}
# The share of the JAX package's RANSAC seeds whose flagship H is within
# 8 px of the ground truth at the image corners, where that is a draw
# (``PYTHONPATH=. python tests/test_torch_flagship.py --seeds 20 rot90``):
# rot90's matches cover x 34-288 of a 598 px wide image, so its corners
# are extrapolated.  zoom2x's H is the same for every seed.
JAX_FLAGSHIP_CORNER_SHARE = {"rot90": 0.85}
FLAGSHIP_SEEDS = 50
TIMED_STEPS = 3
PROFILED_STEPS = 3

# The escalation ladder of phase 6, as keywords of ``IterationParams``
# (the same in both packages): two ORB rungs matched on the Hamming
# distance, three HessianAffine rungs with RootSIFT matched by FGINN.
_ORB = dict(detector="ORB", descriptors=("ORB",), fginn_threshold=(0.0,),
            distance_threshold=(60.0,))
_HESAFF = dict(detector="HessianAffine", descriptors=("RootSIFT",),
               fginn_threshold=(0.8,), distance_threshold=(0.0,))
LADDER = [
    dict(tilt_set=(1.0,), **_ORB),
    dict(tilt_set=(1.0, 5.0, 9.0), phi_base=360.0, **_ORB),
    dict(tilt_set=(1.0,), **_HESAFF),
    dict(tilt_set=(1.0, 2.0, 4.0, 6.0, 8.0), phi_base=360.0, **_HESAFF),
    dict(tilt_set=(1.0, 2.0, 4.0, 6.0, 8.0), phi_base=120.0, **_HESAFF),
]
STAGES = ("mods.detect", "mods.orient", "mods.describe", "mods.match",
          "mods.ransac")

# The JAX package's TwoViewMatcher(LADDER, EngineConfig(), seed=0) on the
# same pairs on a CPU (``python tests/test_torch_ladder.py PAIR``, one
# pair a process): rungs used,
# tentatives, verified matches, those within 3 px of the ground-truth H,
# and the worst corner error of its H.
JAX_LADDER_REFERENCE = {
    "zoom2x": dict(steps=1, tentatives=126, matches=37, gt_consistent=37,
                   corner_error_px=4.040),
    "rot90": dict(steps=2, tentatives=562, matches=65, gt_consistent=65,
                  corner_error_px=1.139),
    "tilt4": dict(steps=5, tentatives=175, matches=18, gt_consistent=15,
                  corner_error_px=59.997),
    "tilt6_rot45": dict(steps=5, tentatives=73, matches=0, gt_consistent=0,
                        corner_error_px=584.660),
}
LADDER_TIMED_PAIRS = 1
LADDER_PHASES = ("mods.SynthTime", "mods.DetectTime", "mods.DescTime",
                 "mods.MatchingTime", "mods.RANSACTime")

# The CVIU-shaped ladder of phases 7 and 8: (detector iterations as
# ``IterationParams`` keywords, matching plan as ``MatchPlan`` keywords or
# None).  What ``tests/test_ini.py:11-38`` pins of the reference's
# iters_mods_cviu.ini is copied; what it does not pin is this script's
# choice, not the reference file's: rung 3's tilts (1, 2, 4, 6, 8) at
# phi 360, rung 3's plan, FGINN 0.85 on rung 3, and RootSIFT as the
# separate descriptor of rungs 4-6.
_MSER = dict(detector="MSER", descriptors=("RootSIFT",),
             fginn_threshold=(0.85,), distance_threshold=(0.0,))
_TILTS = (1.0, 2.0, 4.0, 6.0, 8.0)
_HESAFF_PLAN = dict(separate_detectors=("MSER", "HessianAffine"),
                    separate_descriptors=("RootSIFT",))
CVIU_LADDER = [
    ([dict(tilt_set=(1.0,), **_ORB)],
     dict(separate_detectors=("ORB",), separate_descriptors=("ORB",))),
    ([dict(tilt_set=(1.0, 5.0, 9.0), phi_base=360.0, **_ORB)],
     dict(separate_detectors=("ORB",), separate_descriptors=("ORB",))),
    ([dict(scale_set=(1.0, 0.25, 0.125), **_MSER)],
     dict(separate_detectors=("MSER", "ORB"),
          separate_descriptors=("RootSIFT", "ORB"))),
    ([dict(tilt_set=_TILTS, phi_base=360.0, **_MSER)],
     dict(separate_detectors=("MSER",), separate_descriptors=("RootSIFT",))),
    ([dict(tilt_set=_TILTS, phi_base=360.0, **_HESAFF)], _HESAFF_PLAN),
    ([dict(tilt_set=_TILTS, phi_base=120.0, **_HESAFF)], _HESAFF_PLAN),
    ([dict(tilt_set=_TILTS, phi_base=60.0, **_HESAFF)], _HESAFF_PLAN),
]


# The JAX package's TwoViewMatcher(cviu_rungs(mods_tpu.config),
# EngineConfig(), seed=0) on the same pairs on a CPU (``python
# tests/test_torch_ladder.py --cviu PAIR``, one pair a process), as
# JAX_LADDER_REFERENCE.
JAX_CVIU_REFERENCE = {
    "zoom2x": dict(steps=1, tentatives=126, matches=37, gt_consistent=37,
                   corner_error_px=4.040),
    "rot90": dict(steps=2, tentatives=562, matches=65, gt_consistent=65,
                  corner_error_px=1.139),
    "tilt4": dict(steps=4, tentatives=143, matches=24, gt_consistent=24,
                  corner_error_px=3.438),
    "tilt6_rot45": dict(steps=5, tentatives=124, matches=12,
                        gt_consistent=12, corner_error_px=44.847),
}
# Where the JAX matcher's own result is RANSAC's draw, the port is held
# over draws (``_hold_spread``).  On tilt6_rot45 the JAX matcher's
# verification of its own tentatives reaches 10 matches at rung 4 for 14
# of 100 seeds and at rung 5 for 66 (``python tests/test_torch_ladder.py
# --seeds 100 tilt6_rot45``), so it breaks the rule of PERF.md section 2
# for about 30 % of its own seeds; the port's tentatives are its rows
# (bar one outlier the card adds at rungs 4-6).  Per rung: the share of
# seeds that verify ``min_matches``; at JAX's rung the mean verified
# matches and the mean of those within 3 px of the ground truth.  Rungs
# 1-3 hold fewer than 10 tentatives within 3 px: they cannot stop.
JAX_CVIU_SPREAD = {
    "tilt6_rot45": dict(seeds=100, share={4: 0.14, 5: 0.66},
                        mean_verified=9.46, mean_within_3px=9.06),
}
SPREAD_SEEDS = 200
CVIU_TIMED_PAIRS = 3


# Phase 10: pair-batched matching (``PairBatchMatcher``) on the
# CVIU-shaped ladder.  10a runs zoom2x, rot90 and tilt4 as one batch: the
# serial ladder stops them at rungs 1, 2 and 4, so the batch runs 4 and
# each pair must stop on its own.  The JAX package's PairBatchMatcher
# (cviu_rungs(mods_tpu.config), EngineConfig(), seed=0) on the same batch
# on a CPU (``JAX_PLATFORMS=cpu python tests/test_torch_batch.py
# --jax-batch zoom2x rot90 tilt4``), per pair as JAX_CVIU_REFERENCE, and
# its tentatives at each of the batch's rungs.  The images are padded
# onto one canvas a side (image 2's is 1000 x 1000), which moves zoom2x
# and rot90 off their serial figures.
BATCH_PAIRS = ("zoom2x", "rot90", "tilt4")
JAX_BATCH_REFERENCE = {
    "zoom2x": dict(steps=1, tentatives_per_rung=[129, 409, 36, 96],
                   tentatives=129, matches=39, gt_consistent=39,
                   corner_error_px=7.834),
    "rot90": dict(steps=2, tentatives_per_rung=[141, 558, 123, 209],
                  tentatives=558, matches=66, gt_consistent=66,
                  corner_error_px=0.473),
    "tilt4": dict(steps=4, tentatives_per_rung=[41, 155, 37, 129],
                  tentatives=129, matches=19, gt_consistent=19,
                  corner_error_px=48.224),
}
# The same command with ``--seeds 20``: zoom2x and rot90 are the same for
# every seed; tilt4's seed 11 verifies 12 (10 within 3 px), which breaks
# the rule against seed 0's 19, so a tilt4 that breaks it on the card is
# held over 20 seeds, as phase 9 holds its cells.
JAX_BATCH_SPREAD = {
    "tilt4": dict(seeds=20, share_rule=0.95, mean_verified=19.5,
                  mean_within_3px=19.2),
}
# 10d, one-vs-many: the pairs share their image 1, the query; the image 2s
# of BATCH_PAIRS are the gallery, matched until each is (stop_at_first
# False).  The JAX package's MultiMatcher(cviu_rungs(mods_tpu.config),
# EngineConfig(), seed=0, mesh=None) on a CPU (``JAX_PLATFORMS=cpu python
# tests/test_torch_batch.py --jax-multi zoom2x rot90 tilt4``), per gallery
# image as JAX_BATCH_REFERENCE; a MultiResult reports the last rung.
JAX_MULTI_REFERENCE = {
    "zoom2x": dict(steps=4, tentatives_per_rung=[129, 409, 36, 96],
                   tentatives=96, matches=50, gt_consistent=50,
                   corner_error_px=13.279),
    "rot90": dict(steps=4, tentatives_per_rung=[141, 558, 123, 209],
                  tentatives=209, matches=124, gt_consistent=124,
                  corner_error_px=0.388),
    "tilt4": dict(steps=4, tentatives_per_rung=[41, 155, 37, 129],
                  tentatives=129, matches=19, gt_consistent=19,
                  corner_error_px=48.224),
}
# With ``--seeds 20``: tilt4's seeds verify 12-23 (mean 19.5), its seed 11
# breaks the rule against seed 0, as in the JAX batch; zoom2x and rot90
# meet it for every seed.
JAX_MULTI_SPREAD = {
    "tilt4": dict(seeds=20, share_rule=0.95, mean_verified=19.5,
                  mean_within_3px=19.2),
}
# 10b, bench.py's protocol (bench.py:123-170): P noisy copies of one
# pair a batch, one warm-up and BATCH_TIMED timed batches, against the
# serial matcher on the same pairs; 10c: the flagship step on a batch
BATCH_SIZE = 8
BATCH_TIMED = 2
THROUGHPUT_PAIRS = ("tilt4", "zoom2x")
FLAGSHIP_BATCH = 4

# Phase 9: every other device detector on a two-rung ladder of its own
# (tilt 1; tilts 1, 2, 4, 6, 8 at phi 360), described with RootSIFT, or
# with ORB's BRIEF where the detector is FAST or BRISK (corner
# detectors, as ORB's own), MSER with ``mser.backend = "device"``.
OTHER_DETECTORS = ("DoG", "HarrisAffine", "SURF", "KAZE", "TILDE", "FAST",
                   "STAR", "BRISK", "MSER")
DETECTOR_PAIRS = ("zoom2x", "tilt4")
# timed pairs a cell (1 where not listed): device MSER's seconds a pair
# spread most
DETECTOR_TIMED_PAIRS = {"MSER": 3}
# the detectors whose regions Baumberg adapts (``baumberg_smm``)
AFFINE_DETECTORS = ("HessianAffine", "DoG", "HarrisAffine")


def _detector_its(det: str) -> list:
    kw = dict(_ORB if det in ("FAST", "BRISK") else _HESAFF, detector=det)
    return [dict(tilt_set=(1.0,), **kw),
            dict(tilt_set=_TILTS, phi_base=360.0, **kw)]


DETECTOR_LADDERS = {det: _detector_its(det) for det in OTHER_DETECTORS}

# The JAX package's TwoViewMatcher on ``DETECTOR_LADDERS[det]`` (with
# ``detector_matcher_args``, seed 0) on the same pairs on a CPU (``python
# tests/test_torch_ladder.py --detectors DET PAIR``, one detector and pair
# a process), as JAX_LADDER_REFERENCE, and ``regions``: the rows in each
# image's feature stores at each rung run, [image 1, image 2] a rung
# (``store_rows_per_rung``), and each rung's tentatives
# (``tentatives_per_rung``; ``tentatives`` is those of the best rung).
JAX_DETECTOR_REFERENCE = {
    "DoG": {
        "zoom2x": dict(
            steps=1, tentatives=51, matches=49, gt_consistent=49,
            corner_error_px=5.853, regions=[[101, 191]],
            tentatives_per_rung=[51]),
        "tilt4": dict(
            steps=2, tentatives=22, matches=0, gt_consistent=0,
            corner_error_px=550.284, regions=[[101, 5], [234, 36]],
            tentatives_per_rung=[22, 37]),
    },
    "HarrisAffine": {
        "zoom2x": dict(
            steps=1, tentatives=118, matches=112, gt_consistent=112,
            corner_error_px=7.668, regions=[[225, 343]],
            tentatives_per_rung=[118]),
        "tilt4": dict(
            steps=2, tentatives=80, matches=17, gt_consistent=17,
            corner_error_px=8.338, regions=[[225, 20], [536, 67]],
            tentatives_per_rung=[24, 80]),
    },
    "SURF": {
        "zoom2x": dict(
            steps=1, tentatives=76, matches=63, gt_consistent=63,
            corner_error_px=13.001, regions=[[127, 159]],
            tentatives_per_rung=[76]),
        "tilt4": dict(
            steps=2, tentatives=45, matches=11, gt_consistent=11,
            corner_error_px=17.77, regions=[[127, 15], [373, 86]],
            tentatives_per_rung=[9, 45]),
    },
    "KAZE": {
        "zoom2x": dict(
            steps=1, tentatives=260, matches=136, gt_consistent=136,
            corner_error_px=6.351, regions=[[706, 712]],
            tentatives_per_rung=[260]),
        "tilt4": dict(
            steps=2, tentatives=510, matches=225, gt_consistent=225,
            corner_error_px=0.848, regions=[[706, 468], [3067, 1175]],
            tentatives_per_rung=[18, 510]),
    },
    "TILDE": {
        "zoom2x": dict(
            steps=2, tentatives=70, matches=13, gt_consistent=13,
            corner_error_px=40.347, regions=[[760, 756], [3553, 3647]],
            tentatives_per_rung=[3, 70]),
        "tilt4": dict(
            steps=2, tentatives=452, matches=286, gt_consistent=286,
            corner_error_px=0.32, regions=[[760, 741], [3553, 1562]],
            tentatives_per_rung=[4, 452]),
    },
    "FAST": {
        "zoom2x": dict(
            steps=2, tentatives=524, matches=0, gt_consistent=0,
            corner_error_px=1347.338, regions=[[731, 194], [1825, 870]],
            tentatives_per_rung=[524, 1456]),
        "tilt4": dict(
            steps=2, tentatives=1467, matches=84, gt_consistent=84,
            corner_error_px=1.426, regions=[[731, 179], [1825, 429]],
            tentatives_per_rung=[531, 1467]),
    },
    "STAR": {
        "zoom2x": dict(
            steps=1, tentatives=164, matches=139, gt_consistent=139,
            corner_error_px=4.772, regions=[[745, 609]],
            tentatives_per_rung=[164]),
        "tilt4": dict(
            steps=2, tentatives=959, matches=565, gt_consistent=565,
            corner_error_px=0.197, regions=[[745, 645], [3357, 2510]],
            tentatives_per_rung=[6, 959]),
    },
    "BRISK": {
        "zoom2x": dict(
            steps=1, tentatives=41, matches=14, gt_consistent=14,
            corner_error_px=11.462, regions=[[138, 31]],
            tentatives_per_rung=[41]),
        "tilt4": dict(
            steps=2, tentatives=10, matches=0, gt_consistent=0,
            corner_error_px=661.516, regions=[[138, 13], [399, 51]],
            tentatives_per_rung=[10, 64]),
    },
    "MSER": {
        "zoom2x": dict(
            steps=2, tentatives=0, matches=0, gt_consistent=0,
            corner_error_px=float("nan"), regions=[[12, 0], [71, 6]],
            tentatives_per_rung=[0, 3]),
        "tilt4": dict(
            steps=2, tentatives=6, matches=0, gt_consistent=0,
            corner_error_px=567.889, regions=[[12, 10], [71, 51]],
            tentatives_per_rung=[6, 12]),
    },
}


# Where the JAX matcher's own RANSAC seeds break the rule of
# ``_rule_failure`` against its seed 0 (``python tests/test_torch_ladder.py
# --detectors DET --seeds 20 PAIR``; ``spread_figures`` of its 20 seeds),
# phase 9 holds the port over as many seeds.  The other cells where JAX
# verifies >= 10 held the rule for all 20 of its seeds.
JAX_DETECTOR_SPREAD = {
    "HarrisAffine": {
        "tilt4": dict(
            seeds=20, share_rule=0.85, mean_verified=16.7,
            mean_within_3px=16.4),
        "zoom2x": dict(
            seeds=20, share_rule=0.5, mean_verified=111.65,
            mean_within_3px=111.65),
    },
    "SURF": {
        "tilt4": dict(
            seeds=20, share_rule=0.4, mean_verified=7.65,
            mean_within_3px=7.5),
    },
    "KAZE": {
        "zoom2x": dict(
            seeds=20, share_rule=0.6, mean_verified=135.9,
            mean_within_3px=135.9),
    },
    "TILDE": {
        "zoom2x": dict(
            seeds=20, share_rule=0.35, mean_verified=14.0,
            mean_within_3px=6.05),
    },
    "FAST": {
        "tilt4": dict(
            seeds=20, share_rule=0.95, mean_verified=81.15,
            mean_within_3px=81.15),
    },
}


# Phase 11: every other descriptor family on a two-rung ladder of its own,
# phase 9's shape (tilt 1; tilts 1, 2, 4, 6, 8 at phi 360) with
# HessianAffine regions, KAZE's (M-SURF on the patch) on the KAZE
# detector's regions, the pairing its INI users write.
OTHER_DESCRIPTORS = ("SURF", "LIOP", "DAISY", "SSIM", "MLDB", "MROGH",
                     "FREAK", "BRISK", "Pixels", "CNN", "KAZE")
DESCRIPTOR_PAIRS = DETECTOR_PAIRS
# the pair batch of phase 11: one rung of two families on both pairs
BATCH_DESCRIPTORS = ("SURF", "CNN")


# SHA-256 of the FREAK and BRISK pair tables at the INI defaults (P = 41,
# scale 1.0) and of the CNN's procedural weights (P = 32, dim 128) as
# numpy builds them on the machine that recorded the JAX reference
# (numpy 2.0.2, x86-64 with AVX-512): the tables come from np.argsort over
# distances with exact ties, the weights from LAPACK's QR, and either may
# differ on another build (``patch_descs.pattern_sha256``,
# ``cnn.weights_sha256``).
PATTERN_SHA256 = {
    "FREAK": "24be141e918db0160872d129bab8a6e5d2b7c348c3e66483481c5a86aac5b444",
    "BRISK": "7e135d78bece222ddf1c4c9334563135643b09d51d22f6d60aa693469514d569",
}
PROCEDURAL_SHA256 = \
    "f8b38dcc5f790ca831eea392dd0738cfc60d0806b82e26efd90cdb0f2617ef36"


def _descriptor_its(names: tuple) -> list:
    det = "KAZE" if names == ("KAZE",) else "HessianAffine"
    kw = dict(_HESAFF, detector=det, descriptors=names,
              fginn_threshold=(0.8,) * len(names),
              distance_threshold=(0.0,) * len(names))
    return [dict(tilt_set=(1.0,), **kw),
            dict(tilt_set=_TILTS, phi_base=360.0, **kw)]


DESCRIPTOR_LADDERS = {name: _descriptor_its((name,))
                      for name in OTHER_DESCRIPTORS}
DESCRIPTOR_LADDERS["+".join(BATCH_DESCRIPTORS)] = _descriptor_its(
    BATCH_DESCRIPTORS)


# The JAX package's TwoViewMatcher on ``DESCRIPTOR_LADDERS[name]`` (with
# ``descriptor_matcher_args``, seed 0) on the same pairs on a CPU (``python
# tests/test_torch_descriptors.py --descriptors NAME PAIR``, one pair a
# process), as JAX_DETECTOR_REFERENCE.
JAX_DESCRIPTOR_REFERENCE = {
    "SURF": {
        "zoom2x": dict(
            steps=1, tentatives=116, matches=109,
            gt_consistent=109, corner_error_px=2.388,
            regions=[[228, 301]],
            tentatives_per_rung=[116]),
        "tilt4": dict(
            steps=2, tentatives=95, matches=10,
            gt_consistent=8, corner_error_px=60.622,
            regions=[[228, 8], [566, 71]],
            tentatives_per_rung=[38, 95]),
    },
    "LIOP": {
        "zoom2x": dict(
            steps=1, tentatives=125, matches=112,
            gt_consistent=112, corner_error_px=4.84,
            regions=[[228, 301]],
            tentatives_per_rung=[125]),
        "tilt4": dict(
            steps=2, tentatives=42, matches=10,
            gt_consistent=8, corner_error_px=56.535,
            regions=[[228, 8], [566, 71]],
            tentatives_per_rung=[49, 42]),
    },
    "DAISY": {
        "zoom2x": dict(
            steps=1, tentatives=123, matches=110,
            gt_consistent=110, corner_error_px=1.91,
            regions=[[228, 301]],
            tentatives_per_rung=[123]),
        "tilt4": dict(
            steps=2, tentatives=91, matches=9,
            gt_consistent=8, corner_error_px=47.064,
            regions=[[228, 8], [566, 71]],
            tentatives_per_rung=[38, 91]),
    },
    "SSIM": {
        "zoom2x": dict(
            steps=1, tentatives=120, matches=100,
            gt_consistent=100, corner_error_px=1.151,
            regions=[[228, 301]],
            tentatives_per_rung=[120]),
        "tilt4": dict(
            steps=2, tentatives=133, matches=8,
            gt_consistent=6, corner_error_px=452.196,
            regions=[[228, 8], [566, 71]],
            tentatives_per_rung=[31, 133]),
    },
    "MLDB": {
        "zoom2x": dict(
            steps=1, tentatives=108, matches=105,
            gt_consistent=105, corner_error_px=1.311,
            regions=[[228, 301]],
            tentatives_per_rung=[108]),
        "tilt4": dict(
            steps=2, tentatives=37, matches=12,
            gt_consistent=10, corner_error_px=43.198,
            regions=[[228, 8], [566, 71]],
            tentatives_per_rung=[3, 37]),
    },
    "MROGH": {
        "zoom2x": dict(
            steps=1, tentatives=130, matches=112,
            gt_consistent=112, corner_error_px=5.899,
            regions=[[228, 301]],
            tentatives_per_rung=[130]),
        "tilt4": dict(
            steps=2, tentatives=77, matches=9,
            gt_consistent=7, corner_error_px=52.768,
            regions=[[228, 8], [566, 71]],
            tentatives_per_rung=[25, 77]),
    },
    "FREAK": {
        "zoom2x": dict(
            steps=1, tentatives=101, matches=96,
            gt_consistent=96, corner_error_px=1.504,
            regions=[[228, 301]],
            tentatives_per_rung=[101]),
        "tilt4": dict(
            steps=2, tentatives=21, matches=0,
            gt_consistent=0, corner_error_px=557.314,
            regions=[[228, 8], [566, 71]],
            tentatives_per_rung=[21, 67]),
    },
    "BRISK": {
        "zoom2x": dict(
            steps=1, tentatives=108, matches=107,
            gt_consistent=107, corner_error_px=1.638,
            regions=[[228, 301]],
            tentatives_per_rung=[108]),
        "tilt4": dict(
            steps=2, tentatives=14, matches=0,
            gt_consistent=0, corner_error_px=545.479,
            regions=[[228, 8], [566, 71]],
            tentatives_per_rung=[14, 40]),
    },
    "Pixels": {
        "zoom2x": dict(
            steps=1, tentatives=115, matches=108,
            gt_consistent=108, corner_error_px=2.212,
            regions=[[228, 301]],
            tentatives_per_rung=[115]),
        "tilt4": dict(
            steps=2, tentatives=74, matches=9,
            gt_consistent=7, corner_error_px=65.5,
            regions=[[228, 8], [566, 71]],
            tentatives_per_rung=[19, 74]),
    },
    "CNN": {
        "zoom2x": dict(
            steps=1, tentatives=108, matches=96,
            gt_consistent=96, corner_error_px=2.084,
            regions=[[228, 301]],
            tentatives_per_rung=[108]),
        "tilt4": dict(
            steps=2, tentatives=23, matches=0,
            gt_consistent=0, corner_error_px=606.89,
            regions=[[228, 8], [566, 71]],
            tentatives_per_rung=[23, 69]),
    },
    "KAZE": {
        "zoom2x": dict(
            steps=1, tentatives=247, matches=132,
            gt_consistent=132, corner_error_px=7.927,
            regions=[[706, 712]],
            tentatives_per_rung=[247]),
        "tilt4": dict(
            steps=2, tentatives=609, matches=228,
            gt_consistent=228, corner_error_px=0.811,
            regions=[[706, 468], [3067, 1175]],
            tentatives_per_rung=[39, 609]),
    },
}
# The JAX matcher's figures over its RANSAC seeds 0-19 (the same command
# with ``--seeds 20``; ``spread_figures`` against its seed 0) in every
# cell where it verifies ``min_matches``: where the card's seed 0 breaks
# the rule, phase 11 holds the card over as many seeds, as phase 9 does.
# On zoom2x an H fitted to 100-112 matches that cover the image's middle
# is a draw at the corners (SSIM: 1.15 px for 16 seeds, 10-43 px for 4).
JAX_DESCRIPTOR_SPREAD = {
    "SURF": {
        "zoom2x": dict(
            seeds=20, share_rule=0.95, mean_verified=109.05,
            mean_within_3px=109.05),
        "tilt4": dict(
            seeds=20, share_rule=0.4, mean_verified=5.65,
            mean_within_3px=4.4),
    },
    "LIOP": {
        "zoom2x": dict(
            seeds=20, share_rule=1.0, mean_verified=112.0,
            mean_within_3px=112.0),
        "tilt4": dict(
            seeds=20, share_rule=0.3, mean_verified=7.1,
            mean_within_3px=5.5),
    },
    "DAISY": {
        "zoom2x": dict(
            seeds=20, share_rule=0.95, mean_verified=110.05,
            mean_within_3px=110.05),
    },
    "SSIM": {
        "zoom2x": dict(
            seeds=20, share_rule=0.8, mean_verified=100.2,
            mean_within_3px=100.2),
    },
    "MLDB": {
        "zoom2x": dict(
            seeds=20, share_rule=0.85, mean_verified=105.15,
            mean_within_3px=105.15),
        "tilt4": dict(
            seeds=20, share_rule=0.65, mean_verified=7.9,
            mean_within_3px=6.6),
    },
    "MROGH": {
        "zoom2x": dict(
            seeds=20, share_rule=1.0, mean_verified=112.0,
            mean_within_3px=112.0),
    },
    "FREAK": {
        "zoom2x": dict(
            seeds=20, share_rule=1.0, mean_verified=96.0,
            mean_within_3px=96.0),
    },
    "BRISK": {
        "zoom2x": dict(
            seeds=20, share_rule=1.0, mean_verified=107.0,
            mean_within_3px=107.0),
    },
    "Pixels": {
        "zoom2x": dict(
            seeds=20, share_rule=0.9, mean_verified=108.1,
            mean_within_3px=108.1),
    },
    "CNN": {
        "zoom2x": dict(
            seeds=20, share_rule=1.0, mean_verified=96.0,
            mean_within_3px=96.0),
    },
    "KAZE": {
        "zoom2x": dict(
            seeds=20, share_rule=0.9, mean_verified=131.85,
            mean_within_3px=131.85),
        "tilt4": dict(
            seeds=20, share_rule=1.0, mean_verified=228.0,
            mean_within_3px=228.0),
    },
}


def descriptor_matcher_args(pipeline_module, config_module, name: str):
    """(ladder, EngineConfig) of ``DESCRIPTOR_LADDERS[name]`` in one
    package (the port's, or the JAX package's for the reference)."""
    return ([config_module.IterationParams(**kw)
             for kw in DESCRIPTOR_LADDERS[name]],
            pipeline_module.EngineConfig())


def pair_outcome(r, H_gt, shape) -> list:
    """[rungs used, verified, within 3 px, worst corner error] of one
    ``match`` result (either package's)."""
    import numpy as np
    err = (_corner_error(r.H, H_gt, shape[1], shape[0])
           if np.isfinite(r.H).all() else float("nan"))
    return [r.steps_used, r.n_matches, _gt_consistent(H_gt, r.xy1, r.xy2),
            round(err, 3)]


def store_rows_per_rung(matcher, read) -> list:
    """Record, at each rung's matching, the rows in each image's feature
    stores so far (all stores summed): wraps the matcher's
    ``_execute_plan``.  ``read(store)`` reads a store's count (the port's
    as a device tensor, with no host read).  Returns the list that each
    rung appends ``[image 1, image 2]`` to."""
    seen = []
    inner = matcher._execute_plan

    def execute_plan(stores1, stores2, *a, **kw):
        seen.append([sum(read(st) for st in side.values())
                     for side in (stores1, stores2)])
        return inner(stores1, stores2, *a, **kw)

    matcher._execute_plan = execute_plan
    return seen


def tentatives_per_rung(matcher) -> list:
    """Record each rung's tentatives (``n_tent`` of its verification: the
    matches left after FGINN and the duplicate filter): wraps the
    matcher's ``_verify_bank``.  ``MatchResult.n_tentatives`` is those of
    the best rung up to the stop (the most verified, the first of equals),
    so it can name another rung in each package where their RANSAC draws
    differ; these are per rung.  Returns the list that each rung appends
    its count to (the port's as a device tensor, with no host read)."""
    seen = []
    inner = matcher._verify_bank

    def verify_bank(log):
        out = inner(log)
        seen.append(0 if out is None else out["n_tent"])
        return out

    matcher._verify_bank = verify_bank
    return seen


def detector_matcher_args(pipeline_module, config_module, det: str):
    """(ladder, EngineConfig) of ``DETECTOR_LADDERS[det]`` in one package
    (the port's, or the JAX package's for the reference figures)."""
    cfg = pipeline_module.EngineConfig()
    if det == "MSER":
        cfg = config_module.replace(
            cfg, mser=pipeline_module.MserParams(backend="device"))
    return ([config_module.IterationParams(**kw)
             for kw in DETECTOR_LADDERS[det]], cfg)


def cviu_iters_ini(ladder=CVIU_LADDER, min_matches: int = 10) -> str:
    """An iters INI (the reference's iters_*.ini layout, io_mods.cpp:
    653-688) for ``ladder``: this script's own text, not the reference's
    file."""
    def num(v):
        return ",".join(f"{x:g}" for x in v)

    lines = ["[Iterations]", f"Steps={len(ladder)}",
             f"minMatches={min_matches}; ladder stop count", ""]
    for step, (dets, plan) in enumerate(ladder):
        for d in dets:
            lines += [f"[{d['detector']}{step}]",
                      f"TiltSet={num(d.get('tilt_set', (1.0,)))}",
                      f"ScaleSet={num(d.get('scale_set', (1.0,)))}",
                      f"Phi={d.get('phi_base', 360.0):g}",
                      "initSigma=0.5",
                      f"Descriptors={','.join(d['descriptors'])}",
                      f"FGINNThreshold={num(d['fginn_threshold'])}",
                      f"DistanceThreshold={num(d['distance_threshold'])}",
                      ""]
        if plan:
            lines += [f"[Matching{step}]"] + [
                f"{key}={','.join(plan.get(field, ()))}"
                for key, field in (("SeparateDetectors", "separate_detectors"),
                                   ("SeparateDescriptors",
                                    "separate_descriptors"),
                                   ("GroupDetectors", "group_detectors"),
                                   ("GroupDescriptors",
                                    "group_descriptors"))] + [""]
    return "\n".join(lines)


# A config INI that gives the port's ``EngineConfig()`` for the fields the
# CVIU-shaped ladder reads: the INI parsers' own defaults differ in
# maxAngles (-1 there, 1 in EngineConfig), so it is set.  The parsers
# turn doBothRANSACgroundTruth on by default (as the JAX package's do).
CVIU_CONFIG_INI = """\
[HessianAffine]
mode=FixedTh
[MSER]
min_size=30
max_area=0.05
min_margin=8
[DominantOrientation]
maxAngles=1
threshold=0.8
[SIFTDescriptor]
patchSize=41
[RANSAC]
ErrorType=SymmSum
err_threshold=2.0
LAFcoef=3.0
HLAFcoef=10.0
[Matching]
contradDist=10.0
kNN=50
[DuplicateFiltering]
duplicateDist=3.0
whichCorrespondenceRemains=random
"""


def cviu_rungs(config_module) -> list:
    """``CVIU_LADDER`` as ``Rung`` objects of ``config_module`` (the
    port's ``mods_tpu_torch.config``, or the JAX package's for the
    reference figures)."""
    c = config_module
    return [c.Rung(dets=tuple(c.IterationParams(**d) for d in dets),
                   plan=c.MatchPlan(**plan) if plan else None)
            for dets, plan in CVIU_LADDER]

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32 rate
# outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# float32 operations per sample in csrc/sampling.cuh: coordinates 10,
# floors 4, fractions and weights 4, bilinear mix 9
SAMPLER_OPS_PER_SAMPLE = 27
# per sample and iteration in csrc/baumberg_smm.cu: the sampler's, two
# gradient differences and three masked multiply-accumulates (3 each)
BAUMBERG_OPS_PER_SAMPLE = SAMPLER_OPS_PER_SAMPLE + 2 + 9
# a step runs Baumberg once per octave and image (6 x 2) and the sampler
# for orientation and descriptor patches of each image (2 x 2)
EXPECTED_LAUNCHES = {"baumberg_smm": 12, "window_sampler": 4}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int, replays: int = 10) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events, so the host's
    launch overhead does not pad the kernel's time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                 # warm-up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def _sampler_inputs(K: int, P: int, L: int, H: int, W: int, seed: int,
                    zero_planes: int = 0):
    """A smooth (L, H, W) level stack on the card and K keypoints whose
    sampling matrices fit the (96, 128) windows, as the main path's.
    The last ``zero_planes`` planes have a valid extent of 0: every
    sample of a keypoint there is ``fill``."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)
    src = torch.rand((L, 1, H, W), generator=g, device="cuda") * 255.0
    src = F.avg_pool2d(src, 5, stride=1, padding=2)[:, 0].contiguous()
    xy = torch.rand((K, 2), generator=g, device="cuda") * torch.tensor(
        [W, H], dtype=torch.float32, device="cuda")
    th = torch.rand((K,), generator=g, device="cuda") * 6.2832
    sc = 0.3 + torch.rand((K,), generator=g, device="cuda")
    c, s = torch.cos(th) * sc, torch.sin(th) * sc
    A = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    lvl = torch.randint(0, L, (K,), generator=g, device="cuda")
    vhw = torch.tensor([[H - 3, W - 5]] * (L - zero_planes)
                       + [[0, 0]] * zero_planes, dtype=torch.int32,
                       device="cuda")
    return src, lvl, vhw, xy, A


def _touched_bytes(ws, xy, A, P: int, stack=None) -> int:
    """Bytes of the distinct texels that this run's samples interpolate
    from (the samples left at ``fill`` need none): the least the function
    must read.  ``ws`` holds the keypoints' windows; with ``stack`` =
    (lvl, (L, H, W)) the windows are views into a level stack, and a
    texel that several keypoints touch counts once."""
    import torch
    from mods_tpu_torch.ops import sampler as S
    K, R, X = ws.windows.shape
    gx, gy, relx, rely = S._sample_coords(ws, xy, A, P)
    ok = ((torch.floor(gx) >= 0) & (torch.floor(gy) >= 0)
          & (torch.floor(gx) < (ws.vw - 1.0)[:, None])
          & (torch.floor(gy) < (ws.vh - 1.0)[:, None]))
    yi = S._tap(torch.floor(rely), R)
    xi = S._tap(torch.floor(relx), X)
    if stack is None:
        row, size = X, K * R * X
        base = (torch.arange(K, device=xi.device)[:, None] * R + yi) * X + xi
    else:
        lvl, (L, H, W) = stack
        row, size = W, L * H * W
        base = ((lvl.clamp(0, L - 1)[:, None] * H + ws.y0[:, None] + yi) * W
                + ws.x0[:, None] + xi)
    base = base[ok]
    touched = torch.zeros(size, dtype=torch.bool, device=base.device)
    for off in (0, 1, row, row + 1):
        touched[base + off] = True
    return int(touched.sum()) * ws.windows.element_size()


def _check_patches(name: str, got, ref, shape) -> float:
    import torch
    if got.shape != shape or not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: kernel output bad shape or not finite")
    fill_ok = torch.equal(got == 0.0, ref == 0.0)
    err = (got - ref).abs().max().item()
    if err > 1e-3 or not fill_ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain "
                           f"version: max |d| {err}, fill positions "
                           f"{'equal' if fill_ok else 'differ'}")
    return err


def _check_sampler(name: str, K: int, P: int, L: int, H: int, W: int,
                   reps: int, from_stack: bool, zero_planes: int = 0) -> dict:
    """The window sampler's wrapper against its plain version at one
    geometry, plus times.  ``from_stack``: ``sample_affine_patches`` on
    the level stack; else ``sample_from_windows`` on windows prefetched
    from it.
    Tolerance 1e-3 on 0..255 values and identical fill positions (kernel
    and plain version round every operation alike)."""
    import torch
    import torch.nn.functional as F
    from mods_tpu_torch.ops import sampler as S
    src, lvl, vhw, xy, A = _sampler_inputs(K, P, L, H, W, seed=K + P,
                                           zero_planes=zero_planes)
    lvl = lvl.to(torch.int32)       # as the kernel takes it: no cast timed
    rows = S.rows_for_patch(P) if from_stack else 96

    def windows():
        return S.prepare_windows(src, lvl, xy, vhw, rows=rows)

    ws = windows()
    R, X = ws.windows.shape[1:]
    if from_stack:
        def kernel():
            return S.sample_affine_patches(src, lvl, xy, A, P, vhw)

        def plain():
            return S.sample_affine_patches_plain(src, lvl, xy, A, P, vhw)
    else:
        def kernel():
            return S.sample_from_windows(ws, xy, A, P)

        def plain():
            return S.sample_from_windows_plain(ws, xy, A, P)

    err = _check_patches(name, kernel(), plain(), (K, P, P))
    torch.cuda.synchronize()
    # the nearest library call: bilinear grid_sample on prefetched
    # windows, replicate border, no fill mask.  From a stack that route
    # must build the windows first; that time is part of it.
    _, _, relx, rely = S._sample_coords(ws, xy, A, P)
    grid = torch.stack([relx / (X - 1) * 2 - 1, rely / (R - 1) * 2 - 1],
                       -1).reshape(K, P, P, 2)
    win4 = ws.windows[:, None]
    ms = _time_ms(kernel, reps)
    plain_ms = _time_ms(plain, 5)
    grid_sample_ms = _time_ms(lambda: F.grid_sample(
        win4, grid, mode="bilinear", padding_mode="border",
        align_corners=True), reps)
    windows_ms = _time_ms(windows, 5)
    library_ms = grid_sample_ms + (windows_ms if from_stack else 0.0)
    nbytes = _touched_bytes(ws, xy, A, P,
                            (lvl, src.shape) if from_stack else None)
    nbytes += K * P * P * 4 + sum(
        t.numel() * t.element_size()
        for t in ((xy, A, lvl, vhw) if from_stack
                  else (xy, A, ws.y0, ws.x0, ws.vw, ws.vh)))
    ops = SAMPLER_OPS_PER_SAMPLE * K * P * P
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return dict(geometry=name, source="stack" if from_stack else "windows",
                K=K, P=P, rows=R, planes=L, plane_hw=[H, W],
                zero_extent_planes=zero_planes, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                grid_sample_ms=grid_sample_ms, build_windows_ms=windows_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, operations=ops)


def _octaves(views, hw, caps, pyramid=None) -> list:
    """Baumberg's inputs as the detector makes them: per octave of the
    (V, H, W) views, (stack, lvl, xy, s, ok) from the detector's own
    stages, all views' keypoints together (HessianAffine's pyramid
    unless ``pyramid`` is given)."""
    from mods_tpu_torch.config import PyramidParams
    from mods_tpu_torch.detectors.hessaff import octave_keypoints
    return [(stack, lvl, xy.reshape(-1, 2), s.reshape(-1), ok.reshape(-1))
            for _, stack, lvl, xy, s, ok, _, _ in octave_keypoints(
                views, hw, pyramid or PyramidParams(), caps)]


def _zoom2x_octaves(det: str = "HessianAffine") -> list:
    """zoom2x's first image, one view, with ``det``'s pyramid of the
    default ``EngineConfig`` (HessianAffine's is the flagship path's)."""
    import torch
    from mods_tpu_torch.models.flagship import default_config
    from mods_tpu_torch.pipeline import EngineConfig
    img, _, _ = _load_pair("zoom2x")
    hw = torch.tensor([list(img.shape)], dtype=torch.int32)
    return _octaves(img[None], hw, default_config().caps,
                    EngineConfig().pyramid_for(det))


def _tilt4_group_octaves() -> list:
    """On the ladder's path: the tilt-4 view group (two rotations) of
    tilt4's first image, rendered by the matcher's own render stage."""
    from mods_tpu_torch.config import IterationParams
    from mods_tpu_torch.pipeline import EngineConfig, TwoViewMatcher
    img, _, _ = _load_pair("tilt4")
    m = TwoViewMatcher([IterationParams(tilt_set=(4.0,))], EngineConfig(),
                       device="cuda")
    _, (gp,) = m._prep_groups(m.ladder[0], *img.shape, [])
    if gp["V"] < 2:
        raise RuntimeError(f"the tilt-4 group has {gp['V']} view")
    views = gp["render"](img, gp["rot_inv"], gp["squash_inv"], gp["sig_x"],
                         gp["sig_y"], gp["valid_hw"])
    return _octaves(views, gp["valid_hw_host"], m.cfg.caps)


def _check_baumberg(where: str, octave: int, inputs, reps: int) -> dict:
    """``baumberg_adapt`` on the card (the fused kernel's wrapper) against
    ``baumberg_adapt_plain`` on one octave's real keypoints, plus times of
    the kernel alone and of the loops it stands for.

    Tolerance: ``ok`` differs on at most 1 % of the valid keypoints and
    the shapes agree to 1e-3 where both converged.  The kernel copies the
    plain version's operations, but its block reduction adds the 361
    terms of each second-moment sum in another order than ``torch.sum``;
    over up to 16 fed-back iterations a keypoint on a threshold (0.05,
    6.0) may fall to the other side."""
    import torch
    from mods_tpu_torch.config import AffineShapeParams
    from mods_tpu_torch.detectors import baumberg as B
    from mods_tpu_torch.ops import sampler as S
    stack, lvl, xy, s, ok = inputs
    aff = AffineShapeParams()
    K = lvl.shape[0]
    name = f"baumberg_smm {where} octave {octave}"
    u, good = B.baumberg_adapt(stack, lvl, xy, s, ok, aff)
    torch.cuda.synchronize()
    ru, rgood = B.baumberg_adapt_plain(stack, lvl, xy, s, ok, aff)
    n_valid = int(ok.sum())
    flips = int((good != rgood).sum())
    both = good & rgood
    err = (u - ru)[both].abs().max().item() if both.any() else 0.0
    if (u.shape != (K, 2, 2) or not torch.isfinite(u).all()
            or good[~ok].any() or flips > 0.01 * n_valid or err > 1e-3):
        raise RuntimeError(
            f"{name}: kernel disagrees with its plain version: {flips} of "
            f"{n_valid} valid keypoints differ in ok, max |du| {err}")

    # the times are the loop's alone, kernel and plain version on the same
    # prepared inputs: the raw launcher, which also returns the iterations
    # that each keypoint ran
    big, lvl_eff, xy_eff, inv_scale, ratio, mask = B._smm_inputs(
        stack, lvl, xy, s, aff)
    lvl_eff = lvl_eff.to(torch.int32)   # as the kernel takes it
    P = mask.shape[-1]

    def kernel():
        return B._smm_loop_cuda(big, lvl_eff, xy_eff, ratio, inv_scale, ok,
                                mask, aff)

    iters = kernel()[2]
    ws = B._prepare_smm_windows(big, lvl_eff, xy_eff)

    def loop():
        return B.smm_loop_plain(ws, xy_eff, ratio, inv_scale, ok, mask, aff)

    ms = _time_ms(kernel, reps)
    plain_ms = _time_ms(loop, 1, replays=5)
    # the loop as it ran before the fused kernel: one window-sampler launch
    # and the eager operations per iteration
    B.sample_from_windows_plain = S.sample_from_windows
    try:
        loop_ms = _time_ms(loop, 1, replays=5)
    finally:
        B.sample_from_windows_plain = S.sample_from_windows_plain
    # bytes: the texels that the first iteration's samples (u = I) touch;
    # every valid keypoint runs that iteration, later ones only add to it
    A0 = (torch.eye(2, device="cuda") * (ratio * inv_scale)[:, None, None])
    ws_valid = S.WindowSource(ws.windows[ok], ws.y0[ok], ws.x0[ok],
                              ws.vw[ok], ws.vh[ok])
    nbytes = _touched_bytes(ws_valid, xy_eff[ok], A0[ok], P,
                            (lvl_eff[ok], big.shape))
    nbytes += mask.numel() * 4 + sum(
        t.numel() * t.element_size()
        for t in (lvl_eff, xy_eff, inv_scale, ratio, ok,
                  u, good, iters))
    total_iters = int(iters.sum())
    ops = BAUMBERG_OPS_PER_SAMPLE * P * P * total_iters
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return dict(geometry=f"{where} octave {octave}", K=K, P=P,
                stack=list(stack.shape), valid=n_valid,
                ok_kernel=int(good.sum()), ok_plain=int(rgood.sum()),
                ok_flips=flips, max_abs_err=err, iterations=total_iters,
                max_iterations_run=int(iters.max()), ms=ms,
                plain_ms=plain_ms, earlier_loop_ms=loop_ms, library_ms=None,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, operations=ops)


def _corner_error(H, H_gt, w: int, h: int) -> float:
    import numpy as np
    c = np.array([[0, 0, 1], [w, 0, 1], [0, h, 1], [w, h, 1]], np.float64)
    a = c @ np.asarray(H, np.float64).T
    b = c @ np.asarray(H_gt, np.float64).T
    d = a[:, :2] / a[:, 2:] - b[:, :2] / b[:, 2:]
    return float(np.sqrt((d * d).sum(-1)).max())


def _load_pair(pair: str):
    """A ``.parity_work`` pair on the card and its ground-truth H."""
    import numpy as np
    import torch
    from mods_tpu_torch.io.png import read_png_gray
    imgs = [torch.as_tensor(read_png_gray(PAIRS / f"{pair}_{i}.png"),
                            dtype=torch.float32, device="cuda")
            for i in (1, 2)]
    return imgs[0], imgs[1], np.loadtxt(PAIRS / f"{pair}_H.txt")


def _run_step(step, img1, img2, seed: int = 0) -> dict:
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = step(img1, img2, g)
    torch.cuda.synchronize()
    return out


def _drive_main_path(wrappers: dict) -> dict:
    """Phase 3.  ``wrappers``: kernel name -> the wrappers that count its
    launches.  Returns each kernel's launches over the whole drive."""
    import numpy as np
    import torch
    from mods_tpu_torch.models.flagship import make_two_view_step

    def counts():
        return {k: sum(w.launches for w in ws) for k, ws in wrappers.items()}

    step = make_two_view_step()
    for ws in wrappers.values():  # every kernel's count, just before
        for w in ws:
            w.launches = 0
    for pair, (j_tent, j_inl) in JAX_REFERENCE.items():
        img1, img2, H_gt = _load_pair(pair)

        def run():
            return _run_step(step, img1, img2)

        t0 = time.perf_counter()
        run()                                          # warm-up
        warm_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        per_step, launches = [], []
        t0 = time.perf_counter()
        for _ in range(TIMED_STEPS):
            before = counts()
            ts = time.perf_counter()
            out = run()
            per_step.append(time.perf_counter() - ts)
            launches.append({k: n - before[k] for k, n in counts().items()})
            if launches[-1] != EXPECTED_LAUNCHES:
                raise RuntimeError(
                    f"{pair}: a step launched {launches[-1]}, expected "
                    f"{EXPECTED_LAUNCHES} (a count of 0: the step never "
                    "reached that kernel)")
        total = time.perf_counter() - t0
        H = out["H"].cpu().numpy()
        n_tent = int(out["n_tentatives"])
        n_inl = int(out["n_inliers"])
        if not np.isfinite(H).all():
            raise RuntimeError(f"{pair}: H is not finite: {H}")
        err = _corner_error(H, H_gt, img1.shape[1], img1.shape[0])
        res = dict(
            shapes=[list(img1.shape), list(img2.shape)],
            tentatives=n_tent, inliers=n_inl, corner_error_px=err,
            jax_cpu=dict(tentatives=j_tent, inliers=j_inl),
            pairs_per_s=TIMED_STEPS / total,
            median_step_s=statistics.median(per_step), step_s=per_step,
            warmup_s=warm_s, peak_mem_bytes=torch.cuda.max_memory_allocated(),
            kernel_launches_per_step=launches,
            expected_launches_per_step=EXPECTED_LAUNCHES)
        print(f"[3] {pair}: {json.dumps(res)}", flush=True)
        if abs(n_tent - j_tent) > 0.2 * j_tent:
            raise RuntimeError(f"{pair}: {n_tent} tentatives, JAX {j_tent}")
        if n_inl < 0.8 * j_inl:
            raise RuntimeError(f"{pair}: {n_inl} inliers, JAX {j_inl}")
        if pair not in JAX_FLAGSHIP_CORNER_SHARE:
            if err > 8.0:
                raise RuntimeError(f"{pair}: corner error {err:.2f} px > 8")
            continue
        # the corner error is RANSAC's draw here: held over draws
        errs = [_corner_error(_run_step(step, img1, img2, s)["H"].cpu()
                              .numpy(), H_gt, img1.shape[1], img1.shape[0])
                for s in range(FLAGSHIP_SEEDS)]
        share = sum(e <= 8.0 for e in errs) / len(errs)
        spread = dict(seeds=FLAGSHIP_SEEDS, share_within_8px=share,
                      median_px=statistics.median(errs),
                      jax_share=JAX_FLAGSHIP_CORNER_SHARE[pair])
        print(f"[3] {pair}, RANSAC draws: {json.dumps(spread)}", flush=True)
        if share < 0.8 * JAX_FLAGSHIP_CORNER_SHARE[pair]:
            raise RuntimeError(f"{pair}: {share:.2f} of the draws within 8 "
                               f"px at the corners, JAX "
                               f"{JAX_FLAGSHIP_CORNER_SHARE[pair]}")
    return counts()                                    # read just after


def _small_pair_card_vs_cpu():
    """A 256x256 block texture and its 8-degree rotation, on the card and
    on the CPU (plain versions), at small caps."""
    import numpy as np
    import torch
    from mods_tpu_torch.config import CapacityParams, RansacParams
    from mods_tpu_torch.models.flagship import make_two_view_step
    from mods_tpu_torch.pipeline import EngineConfig
    cfg = EngineConfig(
        caps=CapacityParams(per_octave=128, per_view=128, per_group=256,
                            per_image=256, max_angles=1, tentatives=512),
        ransac=RansacParams(batch_hypotheses=128, max_rounds=1))
    rng = np.random.default_rng(0)
    base = np.kron(rng.uniform(0, 255, (22, 22)), np.ones((12, 12)))
    i1 = torch.as_tensor(base[:256, :256], dtype=torch.float32)
    th = np.deg2rad(8.0)
    theta = torch.tensor([[np.cos(th), -np.sin(th), 0.05],
                          [np.sin(th), np.cos(th), -0.03]],
                         dtype=torch.float32)[None]
    grid = torch.nn.functional.affine_grid(theta, (1, 1, 256, 256),
                                           align_corners=False)
    i2 = torch.nn.functional.grid_sample(i1[None, None], grid,
                                         align_corners=False,
                                         padding_mode="border")[0, 0]
    out = {}
    for dev in ("cuda", "cpu"):
        g = torch.Generator(device=dev).manual_seed(0)
        r = make_two_view_step(cfg, device=dev)(i1, i2, g)
        out[dev] = (int(r["n_tentatives"]), int(r["n_inliers"]),
                    r["H"].cpu().numpy())
    (ct, ci, cH), (pt, pi, pH) = out["cuda"], out["cpu"]
    err = _corner_error(cH, pH, 256, 256)
    print(f"[4] small pair: card {ct}/{ci}, cpu {pt}/{pi} "
          f"(tentatives/inliers), H corners {err:.3f} px apart", flush=True)
    if pi < 20 or abs(ct - pt) > 0.1 * pt or abs(ci - pi) > 0.1 * pi \
            or err > 1.0:
        raise RuntimeError("small pair: card and CPU disagree")


def _busy_us(spans) -> float:
    """Length of the union of [start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _raw_events(prof) -> list:
    """(name, on the card, start µs, end µs, user annotation) of every
    event of a finished ``torch.profiler`` window, read from its raw
    Kineto records: ``prof.events()`` builds a Python event tree at about
    65 µs an event, minutes for the 10^6 events of a ladder pair."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    # stamps from the window's first event: nanoseconds since the epoch
    # are ~1.8e18, which a float64 of microseconds holds to 0.25 us only
    t0 = min((e.start_ns() for e in events), default=0)
    return [(e.name(), e.device_type() == DeviceType.CUDA,
             (e.start_ns() - t0) / 1e3,
             (e.start_ns() - t0 + e.duration_ns()) / 1e3,
             e.is_user_annotation()) for e in events]


def _function_events(prof) -> list:
    """The tuples of ``_raw_events`` read from ``prof.events()``, the
    profiler's own event tree (slow): what ``_raw_events`` replaces."""
    from torch.autograd import DeviceType
    return [(e.name, e.device_type == DeviceType.CUDA, e.time_range.start,
             e.time_range.end, bool(getattr(e, "is_user_annotation", False)))
            for e in prof.events()]


def profile_readings(events: list, stages, n: int, wall_us: float) -> dict:
    """What phase 5 reads from one profiler window's events (tuples of
    ``_raw_events``) over ``n`` calls taking ``wall_us``: per call the
    device busy time (the union of kernel intervals), its idle share,
    kernel launches, host reads of device values, per stage range host
    time, device busy time and launches, and the kernels that take the
    most device time."""
    # the stage ranges also appear on the device timeline, as
    # annotations spanning their kernels; they are not kernels
    kernels = [e for e in events if e[1] and e[0] not in stages
               and not e[4]]
    spans = sorted((e[2], e[3]) for e in kernels)
    starts = [s0 for s0, _ in spans]
    busy = _busy_us(spans)
    by_kernel = defaultdict(float)
    for name, _, s0, s1, _ in kernels:
        by_kernel[name] += s1 - s0
    per_stage = {}
    for name in stages:
        mine = [e for e in events if e[0] == name]
        host_us = sum(e[3] - e[2] for e in mine if not e[1])
        ranges = [(e[2], e[3]) for e in mine if e[1]]
        inside = []
        for a0, b0 in ranges:
            # kernels run in order on one stream: those that overlap
            # [a0, b0) start no earlier than the one before a0
            i = max(bisect.bisect_left(starts, a0) - 1, 0)
            while i < len(spans) and spans[i][0] < b0:
                if spans[i][1] > a0:
                    inside.append((max(spans[i][0], a0),
                                   min(spans[i][1], b0)))
                i += 1
        per_stage[name] = dict(
            host_ms=host_us / n / 1e3,
            device_busy_ms=(_busy_us(inside) / n / 1e3) if ranges else None,
            kernel_launches=len(inside) / n if ranges else None)
    reads = sum(1 for e in events if e[0] == "aten::_local_scalar_dense")
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return dict(
        profiled_call_s=wall_us / n / 1e6,
        device_busy_ms=busy / n / 1e3,
        device_idle_share=1.0 - busy / wall_us,
        kernel_launches=len(kernels) / n,
        host_reads=reads / n, stages=per_stage,
        top_kernels_ms=[(k[:90], t / n / 1e3) for k, t in top])


def readings_differ(a: dict, b: dict, rel: float = 1e-6) -> list:
    """The keys (dotted) where two ``profile_readings`` differ by more
    than ``rel`` of the larger value plus 1e-6 (1 ns of a ms reading).
    The top kernels are compared by name: two with near-equal times may
    swap places, or across the cut of the list."""
    def far(x, y):
        return abs(x - y) > rel * max(abs(x), abs(y)) + 1e-6

    out = []
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, dict):
            out += [f"{k}.{d}" for d in readings_differ(x, y, rel)]
        elif isinstance(x, list):
            dx, dy = dict(x), dict(y)
            both = dx.keys() & dy.keys()
            if len(both) < len(dx) - 1 or any(far(dx[n], dy[n])
                                              for n in both):
                out.append(k)
        elif (x is None) != (y is None) or (x is not None and far(x, y)):
            out.append(k)
    return out


def _profile(label: str, run, n: int, stages,
             check_events: bool = False, phase: int = 5) -> dict:
    """One ``torch.profiler`` window over ``n`` calls of ``run()`` (after
    a warm-up call), read by ``profile_readings`` and returned.  With
    ``check_events``, also read from ``prof.events()`` and held equal."""
    from torch.profiler import ProfilerActivity, profile
    run()                                              # warm-up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
        wall_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    res = profile_readings(_raw_events(prof), stages, n, wall_us)
    raw_s = time.perf_counter() - t0
    if not res["kernel_launches"]:
        raise RuntimeError(f"{label}: the profiler saw no kernel")
    if check_events:
        t0 = time.perf_counter()
        slow = profile_readings(_function_events(prof), stages, n, wall_us)
        differ = readings_differ(res, slow)
        print(f"[5] {label}: raw records read in {raw_s:.2f} s, "
              f"prof.events() in {time.perf_counter() - t0:.2f} s; "
              f"readings that differ: {differ}", flush=True)
        if differ:
            raise RuntimeError(f"{label}: the raw records and "
                               f"prof.events() read {differ} apart")
    print(f"[{phase}] {label}: {json.dumps(res)}", flush=True)
    return res


def _profile_main_path() -> None:
    """Where the time of one flagship step goes, per pair (phase 5)."""
    from mods_tpu_torch.models.flagship import make_two_view_step
    step = make_two_view_step()
    for pair in JAX_REFERENCE:
        img1, img2, _ = _load_pair(pair)
        _profile(f"flagship step, {pair}",
                 lambda: _run_step(step, img1, img2), PROFILED_STEPS, STAGES,
                 check_events=pair == "zoom2x")


# ---------------------------------------------------------------------------
# phase 6: the escalation ladder

def _ladder_matcher():
    from mods_tpu_torch.config import IterationParams
    from mods_tpu_torch.pipeline import EngineConfig, TwoViewMatcher
    return TwoViewMatcher([IterationParams(**kw) for kw in LADDER],
                          EngineConfig(), seed=0, device="cuda")


def _load_pair_np(pair: str):
    import numpy as np
    from mods_tpu_torch.io.png import read_png_gray
    return (read_png_gray(PAIRS / f"{pair}_1.png"),
            read_png_gray(PAIRS / f"{pair}_2.png"),
            np.loadtxt(PAIRS / f"{pair}_H.txt"))


def _planned_launches(matcher, shapes, rungs_run: int,
                      sizes=(None, None)) -> dict:
    """Kernel launches of one ``match`` call that ran ``rungs_run`` rungs,
    reckoned from the plan: for every view group of every rung and image,
    one ``baumberg_smm`` launch an octave of its canvas where the
    detector is affine-adapted (HessianAffine, DoG, HarrisAffine), one
    ``window_sampler`` launch for the orientation patches where a
    descriptor family needs them, and one per patch set a family samples
    (its descriptor patches, which its SIFT, Pixels and patch-functor
    kinds share, one more per extra DSP-SIFT scale; the BRIEF patches;
    each CNN spec's own), for device and host-stage detectors alike.  A
    pair batch (phase 10) gives each side's padded canvas in ``shapes``
    and its images' sizes in ``sizes``: its groups fold every pair into
    the view axis, so it launches as often as one pair at those
    canvases."""
    from mods_tpu_torch.config import as_rungs
    from mods_tpu_torch.detectors.scale_space import num_octaves
    cfg = matcher.cfg

    def family(sp):
        if sp.kind == "binary":
            return "none"
        return "half" if sp.half_sift_like else "sift"

    n = {"baumberg_smm": 0, "window_sampler": 0}
    for (h, w), side_sizes in zip(shapes, sizes):
        prev: dict = {}
        for rung in as_rungs(matcher.ladder)[:rungs_run]:
            for it in rung.dets:
                prev[it.detector], preps = matcher._prep_groups(
                    it, h, w, prev.get(it.detector, []), side_sizes)
                specs = matcher._specs(it)
                fams = {family(sp) for sp in specs}
                per_group = 1 if fams - {"none"} else 0     # orientation
                for fam in fams:
                    mine = [sp for sp in specs if family(sp) == fam]
                    kinds = [sp.kind for sp in mine]
                    per_group += ("binary" in kinds) + kinds.count("cnn")
                    if {"sift", "pixels", "patch"} & set(kinds):
                        per_group += 1 + sum(
                            max(sp.dsp_levels - 1, 0) for sp in mine)
                for gp in preps:
                    n["window_sampler"] += per_group
                    if it.detector in AFFINE_DETECTORS:
                        n["baumberg_smm"] += num_octaves(
                            gp["hc"], gp["wc"],
                            cfg.pyramid_for(it.detector).border)
    return n


def _gt_consistent(H_gt, xy1, xy2, px: float = 3.0) -> int:
    """Matches whose image-2 point lies within ``px`` of the ground-truth
    homography's image of their image-1 point."""
    import numpy as np
    if len(xy1) == 0:
        return 0
    p = np.c_[xy1, np.ones(len(xy1))] @ np.asarray(H_gt, np.float64).T
    d = np.sqrt(((p[:, :2] / p[:, 2:] - xy2) ** 2).sum(-1))
    return int((d < px).sum())


def _drive_ladder(wrappers: dict) -> dict:
    """Phase 6.  Returns each kernel's launches over the whole drive."""
    import numpy as np
    import torch

    def counts():
        return {k: sum(w.launches for w in ws) for k, ws in wrappers.items()}

    matcher = _ladder_matcher()
    min_matches = matcher.cfg.min_matches
    for ws in wrappers.values():  # every kernel's count, just before
        for w in ws:
            w.launches = 0
    for pair in ("zoom2x", "rot90", "tilt4", "tilt6_rot45"):
        img1, img2, H_gt = _load_pair_np(pair)
        ref = JAX_LADDER_REFERENCE[pair]

        def run():
            r = matcher.match(img1, img2)
            torch.cuda.synchronize()
            return r

        t0 = time.perf_counter()
        run()                                          # warm-up
        warm_s = time.perf_counter() - t0
        per_pair, launches = [], []
        for _ in range(LADDER_TIMED_PAIRS):
            before = counts()
            ts = time.perf_counter()
            r = run()
            per_pair.append(time.perf_counter() - ts)
            launches.append({k: n - before[k] for k, n in counts().items()})
            planned = _planned_launches(
                matcher, (img1.shape, img2.shape), r.steps_used)
            if launches[-1] != planned:
                raise RuntimeError(
                    f"{pair}: a pair launched {launches[-1]}, the plan of "
                    f"its {r.steps_used} rungs gives {planned}")
        if not np.isfinite(r.H).all():
            raise RuntimeError(f"{pair}: H is not finite: {r.H}")
        err = _corner_error(r.H, H_gt, img1.shape[1], img1.shape[0])
        true = _gt_consistent(H_gt, r.xy1, r.xy2)
        res = dict(
            shapes=[list(img1.shape), list(img2.shape)],
            steps_used=r.steps_used, tentatives=r.n_tentatives,
            matches=r.n_matches, gt_consistent_3px=true,
            corner_error_px=err, jax_cpu=ref,
            median_pair_s=statistics.median(per_pair), pair_s=per_pair,
            warmup_s=warm_s,
            peak_mem_bytes=max(matcher.rung_peak_bytes),
            rung_peak_mem_bytes=matcher.rung_peak_bytes,
            kernel_launches_per_pair=launches[-1],
            time_log_s={k: round(v, 4) for k, v in r.log.times.items()})
        print(f"[6] {pair}: {json.dumps(res)}", flush=True)
        _hold_to_jax(pair, r, true, err, ref, min_matches)
    return counts()                                    # read just after


def _rule_failure(pair: str, steps: int, n: int, true: int, err: float,
                  ref: dict, min_matches: int):
    """The rule of PERF.md section 2 against the JAX matcher's figures
    (phases 6, 7 and 9): stop at JAX's rung or one earlier; >= 10
    verified matches and as many within 3 px of the ground truth as 0.8x
    JAX's at JAX's rung (0.8x the stop rule's count one rung earlier); a
    worst corner error <= 8 px where the JAX matcher's own H meets that
    (on tilt4 of ``LADDER`` its matches span a 150 px wide image and its
    H is 60 px off at the corners, so there the matches are held, not the
    extrapolation).  Returns what fails, or None."""
    if ref["matches"] < min_matches:
        return None           # the JAX matcher does not solve it either
    if steps not in (ref["steps"], ref["steps"] - 1):
        return f"{pair}: stopped at rung {steps}, JAX at {ref['steps']}"
    matches, gt = ((ref["matches"], ref["gt_consistent"])
                   if steps == ref["steps"] else (min_matches, min_matches))
    if n < min_matches or n < 0.8 * matches:
        return (f"{pair}: {n} verified matches at rung {steps}, JAX "
                f"{ref['matches']} at rung {ref['steps']}")
    if true < 0.8 * gt:
        return (f"{pair}: {true} matches within 3 px of the ground truth "
                f"at rung {steps}, JAX {ref['gt_consistent']} at rung "
                f"{ref['steps']}")
    if ref["corner_error_px"] <= 8.0 and not err <= 8.0:
        return (f"{pair}: corner error {err:.2f} px > 8, JAX "
                f"{ref['corner_error_px']:.2f}")
    return None


def _hold_to_jax(pair: str, r, true: int, err: float, ref: dict,
                 min_matches: int) -> None:
    """Raises unless one result of the port meets ``_rule_failure``."""
    failure = _rule_failure(pair, r.steps_used, r.n_matches, true, err, ref,
                            min_matches)
    if failure:
        raise RuntimeError(failure)


def spread_figures(outcomes: list, ref: dict, min_matches: int) -> dict:
    """Over ``pair_outcome`` lists of several RANSAC seeds: the share that
    meets the rule of ``_rule_failure`` against ``ref`` (the JAX
    matcher's seed 0), the mean verified matches and the mean within
    3 px of the ground truth."""
    n = len(outcomes)
    return dict(
        seeds=n,
        share_rule=sum(_rule_failure("", *o, ref, min_matches) is None
                       for o in outcomes) / n,
        mean_verified=sum(o[1] for o in outcomes) / n,
        mean_within_3px=sum(o[2] for o in outcomes) / n)


def _profile_ladder() -> None:
    """Where the time of one ladder pair goes (tilt4: all five rungs)."""
    import torch
    matcher = _ladder_matcher()
    img1, img2, _ = _load_pair_np("tilt4")

    def run():
        matcher.match(img1, img2)
        torch.cuda.synchronize()

    _profile("ladder, tilt4", run, 1, LADDER_PHASES)


# ---------------------------------------------------------------------------
# phases 7 and 8: the CVIU-shaped ladder, with its MSER rungs, and the
# ``match`` command

def _build_native() -> None:
    """Phase 1, host side: the port's own builds of ``native/mser.cpp``
    and ``native/render.cpp`` (g++, into ``mods_tpu_torch/_build/native``);
    raises when g++ or OpenMP is missing."""
    import os
    from mods_tpu_torch.detectors import mser
    from mods_tpu_torch.ops import host_render
    out = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"g++ --version failed: {out.stderr.strip()}")
    t0 = time.perf_counter()
    mser._lib()
    host_render._lib()
    print(f"[1] g++: {out.stdout.splitlines()[0]}; native/mser.cpp and "
          f"native/render.cpp built into {mser.BUILD_DIR} in "
          f"{time.perf_counter() - t0:.1f} s; host cores {os.cpu_count()}, "
          f"OpenMP threads {host_render.omp_max_threads()}", flush=True)


def _cviu_matcher(stop_mode: str = "sync"):
    from mods_tpu_torch import config
    from mods_tpu_torch.pipeline import EngineConfig, TwoViewMatcher
    return TwoViewMatcher(cviu_rungs(config), EngineConfig(), seed=0,
                          stop_mode=stop_mode, device="cuda")


def _check_host_render(pair: str) -> list:
    """Every view group of the MSER rungs (2 and 3) of ``pair``'s first
    image: ``native/render.cpp``'s views against the port's render on the
    card, inside the valid extent; raises at a difference >= 0.05 grey
    levels (the JAX package's bound, tests/test_host_render.py)."""
    import numpy as np
    import torch
    from mods_tpu_torch.ops.host_render import render_group_np
    m = _cviu_matcher()
    img = _load_pair_np(pair)[0].astype(np.float32)
    img_dev = torch.as_tensor(img, device="cuda")
    h, w = img.shape
    out, prev = [], []
    for step in (2, 3):
        it = m.ladder[step].dets[0]
        prev, preps = m._prep_groups(it, h, w, prev)
        for gp in preps:
            p0, V = gp["group"][0], gp["V"]
            valid = np.asarray([[p.h_new, p.w_new] for p in gp["group"]],
                               np.int32)
            host = render_group_np(
                img, gp["rot_inv_np"][:V], gp["hr"], gp["wr"],
                p0.view.do_blur, p0.sigma_x, p0.sigma_y, p0.tilt_scale[0],
                p0.tilt_scale[1], valid, gp["hc"], gp["wc"], p0.identity)
            dev = gp["render"](img_dev, gp["rot_inv"], gp["squash_inv"],
                               gp["sig_x"], gp["sig_y"],
                               gp["valid_hw"]).cpu().numpy()
            d = max(float(np.abs(host[v, :a, :b] - dev[v, :a, :b]).max())
                    for v, (a, b) in enumerate(valid))
            geom = dict(rung=step, tilt=p0.view.tilt, zoom=p0.view.zoom,
                        views=V, canvas=[gp["hc"], gp["wc"]],
                        max_abs_diff=d)
            out.append(geom)
            if d >= 0.05:
                raise RuntimeError(f"{pair}: host and card renders of the "
                                   f"MSER group {geom} differ by {d}")
    print(f"[7] host render vs card render, {pair} image 1: "
          f"{json.dumps(out)}", flush=True)
    return out


def _drive_cviu(wrappers: dict) -> dict:
    """Phase 7.  Returns each kernel's launches over the whole drive."""
    import numpy as np
    import torch

    def counts():
        return {k: sum(w.launches for w in ws) for k, ws in wrappers.items()}

    matchers = {mode: _cviu_matcher(mode) for mode in ("sync", "pipelined")}
    ladder = _ladder_matcher()
    min_matches = matchers["sync"].cfg.min_matches
    for ws in wrappers.values():  # every kernel's count, just before
        for w in ws:
            w.launches = 0
    for pair in ("zoom2x", "rot90", "tilt4", "tilt6_rot45"):
        img1, img2, H_gt = _load_pair_np(pair)
        ref = JAX_CVIU_REFERENCE[pair]
        runs = []
        for i, mode in enumerate(["sync"] * (1 + CVIU_TIMED_PAIRS)
                                 + ["pipelined"]):
            m = matchers[mode]
            before = counts()
            t0 = time.perf_counter()
            r = m.match(img1, img2)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launched = {k: n - before[k] for k, n in counts().items()}
            rungs_run = m.rungs_run
            planned = _planned_launches(m, (img1.shape, img2.shape),
                                        rungs_run)
            if launched != planned:
                raise RuntimeError(
                    f"{pair} ({mode}): a pair launched {launched}, the "
                    f"plan of its {rungs_run} rungs gives {planned}")
            if not np.isfinite(r.H).all():
                raise RuntimeError(f"{pair}: H is not finite: {r.H}")
            runs.append(dict(mode=mode, warmup=i == 0, s=dt, r=r,
                             rungs_run=rungs_run, launches=launched,
                             host_stage=dict(m.host_stage),
                             peak=max(m.rung_peak_bytes, default=0)))
        timed = [x for x in runs[1:] if x["mode"] == "sync"]
        last = timed[-1]
        r = last["r"]
        err = _corner_error(r.H, H_gt, img1.shape[1], img1.shape[0])
        true = _gt_consistent(H_gt, r.xy1, r.xy2)
        hs = last["host_stage"]
        pipe = runs[-1]
        res = dict(
            shapes=[list(img1.shape), list(img2.shape)],
            steps_used=r.steps_used, tentatives=r.n_tentatives,
            matches=r.n_matches, gt_consistent_3px=true,
            corner_error_px=err, jax_cpu=ref,
            median_pair_s=statistics.median(x["s"] for x in timed),
            pair_s=[x["s"] for x in timed], warmup_s=runs[0]["s"],
            time_log_s={k: round(v, 4) for k, v in r.log.times.items()},
            mser_host_s=hs["job_s"] + hs["inline_s"],
            mser_residual_wait_s=hs["wait_s"],
            mser_prefetched_share=(
                1.0 - hs["wait_s"] / hs["job_s"] if hs["job_s"] else None),
            peak_mem_bytes=last["peak"],
            kernel_launches_per_pair=last["launches"],
            pipelined=dict(s=pipe["s"], steps_used=pipe["r"].steps_used,
                           rungs_run=pipe["rungs_run"],
                           matches=pipe["r"].n_matches,
                           kernel_launches=pipe["launches"]))
        if r.steps_used <= 2:
            # a pair that stops in the ORB rungs runs the same rungs as
            # LADDER's first two: both ladders alternating, pair by pair,
            # show what the CVIU-shaped ladder's MSER rungs cost it
            res["alternating_median_s"] = _alternate(
                dict(cviu=matchers["sync"], ladder=ladder), img1, img2)
        print(f"[7] {pair}: {json.dumps(res)}", flush=True)
        if pipe["r"].steps_used != r.steps_used:
            raise RuntimeError(f"{pair}: pipelined stopped at rung "
                               f"{pipe['r'].steps_used}, sync at "
                               f"{r.steps_used}")
        if pair in JAX_CVIU_SPREAD:
            _hold_spread(pair, r, img1, img2, H_gt, ref,
                         JAX_CVIU_SPREAD[pair], min_matches)
        else:
            _hold_to_jax(pair, r, true, err, ref, min_matches)
    for m in matchers.values():
        m.close()
    return counts()                                    # read just after


def _alternate(matchers: dict, img1, img2, rounds: int = 3) -> dict:
    """Median seconds a pair of each matcher, the matchers alternating
    pair by pair."""
    import torch
    times = {k: [] for k in matchers}
    for _ in range(rounds):
        for k, m in matchers.items():
            t0 = time.perf_counter()
            m.match(img1, img2)
            torch.cuda.synchronize()
            times[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) for k, v in times.items()}


def _hold_spread(pair: str, r, img1, img2, H_gt, ref: dict, spread: dict,
                 min_matches: int) -> None:
    """The rule of PERF.md section 2 held over RANSAC draws, for a pair
    where the JAX matcher's own draws break it (``JAX_CVIU_SPREAD``): the
    port's tentatives of every rung on the card (``ladder_banks``), the
    rungs up to JAX's that hold ``min_matches`` tentatives within 3 px
    verified with seeds 0..SPREAD_SEEDS-1 (``verify_spread``).  The
    chance to stop at JAX's rung or one earlier, and at JAX's rung the
    mean verified matches and the mean within 3 px, must each be at
    least 0.8x the JAX matcher's; the seed-0 ladder run (``r``) must not
    stop earlier than that."""
    import numpy as np
    steps = ref["steps"]
    if r.steps_used < steps - 1:
        raise RuntimeError(f"{pair}: stopped at rung {r.steps_used}, JAX "
                           f"at {steps}")
    m = _cviu_matcher("async")
    banks = ladder_banks(m, img1, img2)
    m.close()
    share, at = {}, None
    for rung in range(1, steps + 1):
        mask = banks[f"{rung}_mask"]
        if rung < steps and _gt_consistent(
                H_gt, banks[f"{rung}_xy1"][mask],
                banks[f"{rung}_xy2"][mask]) < min_matches:
            share[rung] = 0.0                          # cannot stop
            continue
        c = np.asarray(verify_spread(m.cfg, banks, rung, range(SPREAD_SEEDS),
                                     H_gt, "cuda"))
        share[rung] = float((c[:, 0] >= min_matches).mean())
        at = c.mean(0) if rung == steps else at

    def p_stop(sh):              # first stop at rung steps - 1 or steps
        before = np.prod([1.0 - sh.get(k, 0.0) for k in range(1, steps - 1)])
        return before * (1.0 - (1.0 - sh.get(steps - 1, 0.0))
                         * (1.0 - sh.get(steps, 0.0)))

    res = dict(seeds=SPREAD_SEEDS, share_reaching_min_matches=share,
               p_stop_by_jax_rung=p_stop(share),
               mean_verified_at_jax_rung=float(at[0]),
               mean_within_3px_at_jax_rung=float(at[1]),
               jax=dict(spread, p_stop_by_jax_rung=p_stop(spread["share"])))
    print(f"[7] {pair}, RANSAC draws: {json.dumps(res)}", flush=True)
    for key, mine, jax in (
            ("chance to stop by JAX's rung", res["p_stop_by_jax_rung"],
             res["jax"]["p_stop_by_jax_rung"]),
            ("mean verified at JAX's rung", at[0], spread["mean_verified"]),
            ("mean within 3 px at JAX's rung", at[1],
             spread["mean_within_3px"])):
        if mine < 0.8 * jax:
            raise RuntimeError(f"{pair}: {key} {mine:.3f}, JAX {jax:.3f}")


def _profile_detectors() -> None:
    """Where the time of one tilt4 pair of the detectors with eager
    per-view loops goes: KAZE (its FED steps), SURF (its response
    layers) and device MSER (32 levels x 3 passes of scans)."""
    import torch
    img1, img2, _ = _load_pair_np("tilt4")
    for det in ("KAZE", "SURF", "MSER"):
        matcher = _detector_matcher(det)

        def run():
            matcher.match(img1, img2)
            torch.cuda.synchronize()

        _profile(f"{det} ladder, tilt4", run, 1, LADDER_PHASES)
        matcher.close()


def _profile_cviu() -> None:
    """Phase 5: where the time of one CVIU-shaped ladder pair goes
    (tilt6_rot45, every rung, ``sync`` mode), and the host reads of the
    same pair in ``pipelined`` mode, counted as ``_profile`` counts them
    but without the device trace (a second full profile would double the
    phase: 270k launches a pair)."""
    import torch
    img1, img2, _ = _load_pair_np("tilt6_rot45")
    for mode in ("sync", "pipelined"):
        m = _cviu_matcher(mode)

        def run():
            m.match(img1, img2)
            torch.cuda.synchronize()

        label = f"CVIU ladder ({mode}), tilt6_rot45"
        if mode == "sync":
            _profile(label, run, 1, LADDER_PHASES)
        else:
            _count_host_reads(5, label, run)
        m.close()


def _count_host_reads(phase: int, label: str, fn) -> None:
    """One call of ``fn`` under ``torch.profiler`` (after a warm-up
    call): its wall time and its host reads of device values (each an
    ``aten::_local_scalar_dense``, a synchronization)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    reads = sum(1 for e in _raw_events(prof)
                if e[0] == "aten::_local_scalar_dense")
    print(f"[{phase}] {label}: {json.dumps(dict(s=dt, host_reads=reads))}",
          flush=True)


def _profile_f_estimators() -> None:
    """Host reads of one ``ransac_f`` and one ``orsa_f`` call on the card
    at the main path's capacity (2048 tentative slots, 1200 of them set:
    400 correspondences of a non-planar scene, the rest uniform
    outliers), with the default parameters (2048 hypotheses a round)."""
    import numpy as np
    import torch
    from mods_tpu_torch.config import OrsaParams, RansacParams
    from mods_tpu_torch.ransac.fundamental import ransac_f
    from mods_tpu_torch.ransac.orsa import orsa_f
    rng = np.random.default_rng(0)
    n, n_in, n_set = 2048, 400, 1200
    X = rng.uniform([-2, -2, 4], [2, 2, 8], (n_in, 3))
    K = np.array([[800.0, 0, 500], [0, 800.0, 300], [0, 0, 1]])
    a = 0.2
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])

    def proj(Xc):
        x = Xc @ K.T
        return x[:, :2] / x[:, 2:]
    xy1 = rng.uniform(0, 1000, (n, 2))
    xy2 = rng.uniform(0, 1000, (n, 2))
    xy1[:n_in] = proj(X)
    xy2[:n_in] = proj(X @ R.T + [1.0, 0.1, 0.2]) + rng.normal(
        0, 0.5, (n_in, 2))
    t1, t2, mask = (torch.as_tensor(xy1, dtype=torch.float32, device="cuda"),
                    torch.as_tensor(xy2, dtype=torch.float32, device="cuda"),
                    torch.arange(n, device="cuda") < n_set)

    def run_f():
        g = torch.Generator(device="cuda").manual_seed(0)
        return ransac_f(t1, t2, mask, RansacParams(use_f=True), g)

    def run_orsa():
        g = torch.Generator(device="cuda").manual_seed(0)
        return orsa_f(t1, t2, mask, 1000, 1000, OrsaParams(), g)

    for label, fn in (("ransac_f, one call", run_f),
                      ("orsa_f, one call", run_orsa)):
        _count_host_reads(8, label, fn)
        inl = fn()[1]
        found = int(inl[:n_in].sum())
        if found < 0.8 * n_in or int(inl[n_in:].sum()) > 0.1 * n_in:
            raise RuntimeError(f"{label}: {found} of {n_in} inliers found, "
                               f"{int(inl[n_in:].sum())} outliers taken")


def _drive_cli() -> None:
    """Phase 8: ``python -m mods_tpu_torch.cli match`` on tilt4 with this
    script's INI files for the CVIU-shaped ladder, once a ``ver_type``."""
    import re
    import tempfile
    import numpy as np
    import torch
    from mods_tpu_torch.cli import _build_engine
    from mods_tpu_torch.io.regions_io import read_h, read_matches
    from mods_tpu_torch.pipeline import TwoViewMatcher
    from mods_tpu_torch.ransac.errors import f_error_sampson
    pair = "tilt4"
    line = re.compile(r"Matches: (\d+) \(tentatives (\d+), steps (\d+)\)")
    results = {}
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        (d / "config.ini").write_text(CVIU_CONFIG_INI)
        (d / "iters.ini").write_text(cviu_iters_ini())
        for ver in ("LORANSACH", "LORANSACF", "ORSA", "GR_TRUTH"):
            m_path, log = d / f"m_{ver}.txt", d / f"log_{ver}.txt"
            argv = [str(PAIRS / f"{pair}_1.png"), str(PAIRS / f"{pair}_2.png"),
                    "0", "0", "k1", "k2", str(m_path), str(log), ver,
                    str(d / "config.ini"), str(d / "iters.ini")]
            if ver == "GR_TRUTH":
                argv.append(str(PAIRS / f"{pair}_H.txt"))
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "mods_tpu_torch.cli", "match", *argv],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            dt = time.perf_counter() - t0
            if out.returncode != 0:
                raise RuntimeError(f"cli match {ver}: exit {out.returncode}"
                                   f"\n{out.stderr[-3000:]}")
            found = line.search(out.stdout)
            if found is None:
                raise RuntimeError(f"cli match {ver}: no Matches line in "
                                   f"{out.stdout[-2000:]}")
            n, tent, steps = map(int, found.groups())
            for f in (m_path, Path(f"{m_path}.H"), log, Path(f"{log}.time")):
                if not f.exists():
                    raise RuntimeError(f"cli match {ver}: {f.name} missing")
            if int(m_path.read_text().split()[0]) != n:
                raise RuntimeError(f"cli match {ver}: the Matches line says "
                                   f"{n}, the matchings file differs")
            res = dict(matches=n, tentatives=tent, steps=steps, s=dt)
            if ver in ("LORANSACF", "ORSA"):
                cfg, ladder = _build_engine(str(d / "config.ini"),
                                            str(d / "iters.ini"), ver)
                xy1, xy2 = read_matches(str(m_path)) if n else (
                    np.zeros((0, 2)), np.zeros((0, 2)))
                e = f_error_sampson(*(torch.as_tensor(a) for a in (
                    read_h(f"{m_path}.H"), xy1, xy2))).numpy()
                res["max_sampson_px"] = float(np.sqrt(e.max())) if n else 0.0
                # LORANSACF's inliers are within err_threshold (Sampson <=
                # symmetric epipolar); ORSA's pass F_LAF_check's bound
                bound = cfg.ransac.err_threshold * (
                    1.0 if ver == "LORANSACF" else cfg.ransac.laf_coef)
                if res["max_sampson_px"] > bound:
                    raise RuntimeError(f"cli match {ver}: a verified match "
                                       f"is {res['max_sampson_px']:.3f} px "
                                       f"from its epipolar line (> {bound})")
                # the same run in this process, for DEGENSAC's degen flag
                # (and ORSA's log10 NFA), which the command does not print
                m = TwoViewMatcher(ladder, cfg, device="cuda")
                r = m.match(*_load_pair_np(pair)[:2])
                m.close()
                res.update(in_process_matches=r.n_matches, **r.extras)
            results[ver] = res
    print(f"[8] cli match, {pair}: {json.dumps(results)}", flush=True)
    for ver in ("LORANSACF", "ORSA"):
        if results["LORANSACH"]["matches"] >= 10 \
                and results[ver]["matches"] < 10:
            raise RuntimeError(f"cli match {ver}: {results[ver]['matches']} "
                               f"verified where LORANSACH verifies "
                               f"{results['LORANSACH']['matches']}")


# ---------------------------------------------------------------------------
# phase 9: the other device detectors

def _detector_matcher(det: str, stop_mode: str = "sync"):
    from mods_tpu_torch import config as tc
    from mods_tpu_torch import pipeline as tp
    ladder, cfg = detector_matcher_args(tp, tc, det)
    return tp.TwoViewMatcher(ladder, cfg, seed=0, device="cuda",
                             stop_mode=stop_mode)


def _regions_card_vs_cpu(det: str, matcher, img, rung: int = 0) -> list:
    """The detector's regions on each view group of ``rung`` of ``img``
    (rung 0: one full-size view, the identity), rendered by the matcher's
    own render stage, on the card and in the port's plain run on the
    CPU: per view the counts and the share of the card's regions with a
    CPU region within 0.5 px."""
    import numpy as np
    import torch
    prev: list = []
    for it in matcher.ladder[:rung + 1]:
        prev, preps = matcher._prep_groups(it, *img.shape, prev)
    out = []
    for gp in preps:
        views = gp["render"](img, gp["rot_inv"], gp["squash_inv"],
                             gp["sig_x"], gp["sig_y"], gp["valid_hw"])
        args = (views, gp["valid_hw"], gp["valid_hw_host"], gp["regn"])
        card = gp["detect"](*args)
        cpu = gp["detect"](*(a.cpu() for a in args))
        for v in range(gp["V"]):
            a, b = (r.xy[v][r.mask[v]].cpu().numpy().astype(np.float64)
                    for r in (card, cpu))
            if len(a) and len(b):
                d = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1)).min(1)
                twins = float((d < 0.5).mean())
            else:
                twins = 1.0 if len(a) == len(b) else 0.0
            out.append(dict(view=list(views.shape[1:]), card=len(a),
                            cpu=len(b), twin_share=twins))
    torch.cuda.synchronize()
    return out


# TILDE extrema at or below this score are at the rounding level of its
# zero-mean bank: a flat patch scores +4.8e-7 on the card and -2.3e-7 on
# the CPU (``tilde_flat_scores``), and a patch that is flat but for some
# texture at the edge of the bank's envelope scores its rounding plus a
# trace.  On zoom2x's rung-2 views the CPU's extrema leave a gap above
# it: 0-2 a view between 1e-5 and 1e-4, up to 104 below.
TILDE_NOISE = 1e-5


def tilde_card_vs_cpu(matcher, img, rung: int = 1) -> list:
    """TILDE's extrema before its raster-order cap (``tilde_extrema``) on
    each view of ``rung`` of ``img``, rendered once on the matcher's
    device, computed there and on the CPU, split at ``TILDE_NOISE``.
    Per view: above it, the count on each device and the share of the
    matcher's device's extrema at a CPU extremum; at or below it, the
    count on each device."""
    from mods_tpu_torch.detectors.tilde import tilde_extrema
    prev: list = []
    for it in matcher.ladder[:rung + 1]:
        prev, preps = matcher._prep_groups(it, *img.shape, prev)
    out = []
    for gp in preps:
        views = gp["render"](img, gp["rot_inv"], gp["squash_inv"],
                             gp["sig_x"], gp["sig_y"], gp["valid_hw"])
        dev = [t.cpu() for t in tilde_extrema(views, gp["valid_hw"])]
        cpu = tilde_extrema(views.cpu(), gp["valid_hw"].cpu())
        (ds, de), (cs, ce) = dev, cpu
        for v in range(gp["V"]):
            a = de[v] & (ds[v] > TILDE_NOISE)
            b = ce[v] & (cs[v] > TILDE_NOISE)
            n = int(a.sum())
            out.append(dict(
                view=list(views.shape[1:]), card=n, cpu=int(b.sum()),
                twin_share=float((a & b).sum()) / n if n else
                float(n == int(b.sum())),
                noise_card=int((de[v] & ~a).sum()),
                noise_cpu=int((ce[v] & ~b).sum())))
    return out


def tilde_flat_scores(device: str) -> dict:
    """TILDE's score (procedural bank) on a flat 128 patch: in float64
    from the float32 bank, the exact value, and as ``tilde_response``
    computes it on ``device``.  The bank is zero-mean up to its float32
    rounding, so the sign of the latter is that of the convolution's
    rounding, and decides whether a flat patch passes ``score > 0``."""
    import numpy as np
    import torch
    from mods_tpu_torch.detectors.tilde import (procedural_filters,
                                                tilde_bank, tilde_response)
    W, b = procedural_filters()
    S, _, _, K, _ = W.shape
    lum = np.float64(np.float32(128.0) / np.float32(255.0))
    resp = W.astype(np.float64)[:, :, 3:].sum((2, 3, 4)) * lum * K * K + b
    sign = np.array([-((-1.0) ** s) for s in range(S)])
    img = torch.full((64, 64), 128.0, device=device)
    got = tilde_response(img, *tilde_bank("", device))
    return dict(exact=float((sign * resp.max(1)).sum()),
                computed=float(got[32, 32]))


def _hold_card_vs_cpu(det: str, views: list) -> None:
    """>= 95 % of the card's regions have a CPU twin and the counts agree
    to 2 %: the blurs and convolutions round in another order on the two
    devices, so a region at a threshold may flip."""
    for res in views:
        if (res["twin_share"] < 0.95
                or abs(res["card"] - res["cpu"]) > 0.02 * max(res["cpu"], 1)):
            raise RuntimeError(f"{det}: card vs CPU regions {res}")


def _hold_regions(label: str, rows: list, ref_rows: list) -> None:
    """Each image's regions (store rows) at each rung both packages ran,
    within 10 % of the JAX matcher's."""
    for rung, (got, ref) in enumerate(zip(rows, ref_rows), 1):
        for img, (g, r) in enumerate(zip(got, ref), 1):
            if abs(g - r) > 0.1 * r:
                raise RuntimeError(
                    f"{label}: image {img} has {g} regions at rung {rung}, "
                    f"JAX {r}")


def hold_tentatives(label: str, got: list, ref: list,
                    min_matches: int) -> None:
    """Each rung's tentatives (``tentatives_per_rung``) within 20 % of the
    JAX matcher's, at each rung both packages ran where JAX has at least
    ``min_matches``: only such a rung can stop the ladder.  Below that
    the count is a few FGINN choices among a handful of regions, and one
    region at a threshold moves several (SURF on tilt4's 150 px wide
    image 2: one region at 0.0004002 against the threshold 0.0004 takes
    rung 1 from 9 to 12 or 13)."""
    for rung, (g, r) in enumerate(zip(got, ref), 1):
        if r >= min_matches and abs(g - r) > 0.2 * r:
            raise RuntimeError(f"{label}: {g} tentatives at rung {rung}, "
                               f"JAX {r}")


def _drive_detectors(wrappers: dict) -> dict:
    """Phase 9: each detector of ``OTHER_DETECTORS`` on its two-rung
    ladder, on ``DETECTOR_PAIRS`` at full size (one warm-up and
    ``DETECTOR_TIMED_PAIRS`` timed pairs each), held to
    ``JAX_DETECTOR_REFERENCE`` (the regions per image and the tentatives
    at each rung everywhere; where the JAX matcher verifies
    ``min_matches``, the rule of ``_hold_to_jax``, and where the card's
    seed 0 breaks it and the JAX matcher's own seeds do too, the rule
    over the seeds of ``JAX_DETECTOR_SPREAD``) and to its own plain run
    on the CPU (``_regions_card_vs_cpu``; TILDE's rung 2 above the
    rounding level of its bank, ``tilde_card_vs_cpu``).  Returns each kernel's launches over
    the first timed pair of each cell."""
    import torch

    def counts():
        return {k: sum(w.launches for w in ws) for k, ws in wrappers.items()}

    total = {k: 0 for k in wrappers}
    for det in OTHER_DETECTORS:
        matcher = _detector_matcher(det)
        rows = store_rows_per_rung(matcher, lambda st: st._n.clone())
        tents = tentatives_per_rung(matcher)
        img, _, _ = _load_pair("zoom2x")
        cvc = _regions_card_vs_cpu(det, matcher, img)
        _hold_card_vs_cpu(det, cvc)
        if det == "TILDE":
            # the rotated views' fill scores the rounding of the bank's
            # sums, whose sign differs by device: held above that level
            flat = dict(cuda=tilde_flat_scores("cuda"),
                        cpu=tilde_flat_scores("cpu"))
            views = tilde_card_vs_cpu(matcher, img, 1)
            print(f"[9] TILDE on a flat patch: {json.dumps(flat)}; "
                  f"extrema of zoom2x's rung-2 views, card vs CPU: "
                  f"{json.dumps(views)}", flush=True)
            if any(abs(f["computed"]) > 0.1 * TILDE_NOISE
                   for f in flat.values()):
                raise RuntimeError(f"TILDE: a flat patch scores {flat}, "
                                   f"not 10x below {TILDE_NOISE}")
            _hold_card_vs_cpu(
                f"TILDE rung 2, scores above {TILDE_NOISE}", views)
        del img
        for pair in DETECTOR_PAIRS:
            img1, img2, H_gt = _load_pair_np(pair)
            ref = JAX_DETECTOR_REFERENCE[det][pair]
            label = f"{det} {pair}"
            t0 = time.perf_counter()
            matcher.match(img1, img2)                   # warm-up
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            pair_s = []
            for i in range(DETECTOR_TIMED_PAIRS.get(det, 1)):
                del rows[:], tents[:]
                for ws in wrappers.values():  # every count, just before
                    for w in ws:
                        w.launches = 0
                t0 = time.perf_counter()
                r = matcher.match(img1, img2)
                torch.cuda.synchronize()
                pair_s.append(time.perf_counter() - t0)
                launches = counts()                     # read just after
                planned = _planned_launches(
                    matcher, (img1.shape, img2.shape), matcher.rungs_run)
                if launches != planned:
                    raise RuntimeError(
                        f"{label}: a pair launched {launches}, the plan of "
                        f"its rungs gives {planned}")
                if i == 0:
                    for k in total:
                        total[k] += launches[k]
            region_rows = [[int(n) for n in rung] for rung in rows]
            rung_tents = [int(t) for t in tents]
            outcome = pair_outcome(r, H_gt, img1.shape)
            res = dict(
                steps_used=r.steps_used, regions=region_rows,
                tentatives_per_rung=rung_tents,
                tentatives=r.n_tentatives, matches=r.n_matches,
                gt_consistent_3px=outcome[2], corner_error_px=outcome[3],
                jax_cpu=ref, pair_s=statistics.median(pair_s),
                pair_s_each=pair_s, warmup_s=warm_s,
                kernel_launches_per_pair=launches,
                peak_mem_bytes=max(matcher.rung_peak_bytes, default=None),
                card_vs_cpu=cvc if pair == DETECTOR_PAIRS[0] else None)
            min_matches = matcher.cfg.min_matches
            _hold_regions(label, region_rows, ref["regions"])
            hold_tentatives(label, rung_tents, ref["tentatives_per_rung"],
                            min_matches)
            failure = _rule_failure(label, *outcome, ref, min_matches)
            spread = JAX_DETECTOR_SPREAD.get(det, {}).get(pair)
            if failure and spread:
                # the JAX matcher's own seeds break the rule against its
                # seed 0 too: hold the port's figures over as many seeds
                outcomes = []
                for seed in range(spread["seeds"]):
                    matcher._seed = seed
                    outcomes.append(pair_outcome(matcher.match(img1, img2),
                                                 H_gt, img1.shape))
                matcher._seed = 0
                res["spread"] = got = spread_figures(outcomes, ref,
                                                     min_matches)
                res["spread_jax"] = spread
                failure = next((
                    f"{label}: over {spread['seeds']} seeds {key} "
                    f"{got[key]}, JAX {spread[key]}"
                    for key in ("share_rule", "mean_verified",
                                "mean_within_3px")
                    if got[key] < 0.8 * spread[key]), None)
            print(f"[9] {label}: {json.dumps(res)}", flush=True)
            if failure:
                raise RuntimeError(failure)
        matcher.close()
    return total


# ---------------------------------------------------------------------------
# phase 10: pair-batched matching

def _batch_matcher(seed: int = 0):
    from mods_tpu_torch import config
    from mods_tpu_torch.parallel.multi import PairBatchMatcher
    from mods_tpu_torch.pipeline import EngineConfig
    return PairBatchMatcher(cviu_rungs(config), EngineConfig(), seed=seed,
                            device="cuda")


def batch_planned_launches(bm, pairs: list) -> dict:
    """``_planned_launches`` of one ``match_batch`` call on ``pairs``:
    each side's images padded onto one canvas (``_pad_gallery``)."""
    from mods_tpu_torch.parallel.multi import _pad_gallery
    sides = [_pad_gallery([p[i] for p in pairs]) for i in (0, 1)]
    return _planned_launches(bm.mm.qmatcher,
                             [imgs.shape[1:] for imgs, _ in sides],
                             bm.mm.rungs_run,
                             [tuple(sizes) for _, sizes in sides])


def batch_tentatives_per_rung(mm) -> list:
    """Record each rung's (P,) tentatives of a ``MultiMatcher`` (that of
    a ``PairBatchMatcher`` too): wraps its ``_verify_bank``
    (``tentatives_per_rung`` of a batch)."""
    seen = []
    inner = mm._verify_bank

    def verify_bank(*a, **kw):
        out = inner(*a, **kw)
        seen.append(None if out is None else out["n_tent"])
        return out

    mm._verify_bank = verify_bank
    return seen


def _batch_outcomes(r, data: list) -> list:
    """``pair_outcome`` of each pair of a ``BatchResult`` (each gallery
    image of a ``MultiResult``)."""
    import numpy as np
    steps = np.broadcast_to(r.steps_used, r.counts.shape)
    out = []
    for i, (img1, _, H_gt) in enumerate(data):
        err = (_corner_error(r.H[i], H_gt, img1.shape[1], img1.shape[0])
               if np.isfinite(r.H[i]).all() else float("nan"))
        out.append([int(steps[i]), int(r.counts[i]),
                    _gt_consistent(H_gt, r.xy1[i], r.xy2[i]),
                    round(err, 3)])
    return out


def _hold_batch(label: str, r, data: list, tents: list, refs: dict,
                spreads: dict, min_matches: int, rerun) -> None:
    """Holds each pair of a batched result (10a, 10d): its tentatives at
    each rung (``tents``, the rungs' (P,) tentatives) to the JAX figures
    of ``refs`` (``hold_tentatives``), its rungs, verified matches and
    matches within 3 px by ``_rule_failure``, and where the card's seed 0
    and the JAX matcher's own seeds break that rule (``spreads``), over
    as many seeds (``rerun(seed)`` runs the batch again)."""
    rung_tents = [[int(n) for n in t.tolist()] for t in tents
                  if t is not None]
    for i, (pair, outcome) in enumerate(zip(BATCH_PAIRS,
                                            _batch_outcomes(r, data))):
        ref = refs[pair]
        per_rung = [t[i] for t in rung_tents]
        res = dict(steps_used=outcome[0], tentatives_per_rung=per_rung,
                   tentatives=int(r.n_tentatives[i]), matches=outcome[1],
                   gt_consistent_3px=outcome[2],
                   corner_error_px=outcome[3], jax_cpu=ref)
        hold_tentatives(f"{label} {pair}", per_rung,
                        ref["tentatives_per_rung"], min_matches)
        failure = _rule_failure(pair, *outcome, ref, min_matches)
        spread = spreads.get(pair)
        if failure and spread:
            outcomes = [_batch_outcomes(rerun(seed), data)[i]
                        for seed in range(spread["seeds"])]
            res["spread"] = got = spread_figures(outcomes, ref, min_matches)
            res["spread_jax"] = spread
            failure = next((
                f"{pair}: over {spread['seeds']} seeds {key} "
                f"{got[key]}, JAX {spread[key]}"
                for key in ("share_rule", "mean_verified", "mean_within_3px")
                if got[key] < 0.8 * spread[key]), None)
        print(f"[10] {label} {pair}: {json.dumps(res)}", flush=True)
        if failure:
            raise RuntimeError(f"{label} {failure}")


def _drive_batch_mixed(counts, tally) -> None:
    """Phase 10a: zoom2x, rot90 and tilt4 as one batch on the CVIU-shaped
    ladder (one warm-up batch, one held), its launches held to the batch
    plan, each pair's rungs, tentatives at each rung, verified matches
    and those within 3 px to ``JAX_BATCH_REFERENCE`` (where the card's
    seed 0 and the JAX matcher's own seeds break the rule, over the
    seeds of ``JAX_BATCH_SPREAD``); prints each rung's peak memory."""
    import torch
    data = [_load_pair_np(p) for p in BATCH_PAIRS]
    pairs = [(a, b) for a, b, _ in data]
    bm = _batch_matcher()
    tents = batch_tentatives_per_rung(bm.mm)
    bm.match_batch(pairs)                              # warm-up
    torch.cuda.synchronize()
    del tents[:]
    before = counts()
    t0 = time.perf_counter()
    r = bm.match_batch(pairs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = {k: n - before[k] for k, n in counts().items()}
    tally(launched)
    planned = batch_planned_launches(bm, pairs)
    print(f"[10] mixed batch {list(BATCH_PAIRS)}: " + json.dumps(dict(
        s=dt, rungs_run=bm.mm.rungs_run, kernel_launches=launched,
        planned_launches=planned,
        rung_peak_mem_bytes=bm.mm.rung_peak_bytes,
        time_log_s={k: round(v, 4) for k, v in r.log.times.items()})),
        flush=True)
    if launched != planned:
        raise RuntimeError(f"mixed batch: launched {launched}, the plan of "
                           f"its {bm.mm.rungs_run} rungs gives {planned}")

    def rerun(seed):
        bm.mm._seed = seed
        return bm.match_batch(pairs)

    _hold_batch("batch", r, data, tents, JAX_BATCH_REFERENCE,
                JAX_BATCH_SPREAD, bm.cfg.min_matches, rerun)
    bm.mm._seed = 0
    bm.close()


def _noisy_copies(img1, img2, n: int, rng) -> list:
    """bench.py's batch: ``n`` copies of a pair, each image with its own
    uniform [0, 0.5) noise."""
    import numpy as np
    return [(img1 + rng.uniform(0, 0.5, img1.shape).astype(np.float32),
             img2 + rng.uniform(0, 0.5, img2.shape).astype(np.float32))
            for _ in range(n)]


def _drive_batch_throughput(pair: str, counts, tally) -> dict:
    """Phase 10b, bench.py's protocol (bench.py:123-170): batches of
    ``BATCH_SIZE`` noisy copies of ``pair`` on the CVIU-shaped ladder, one
    warm-up and ``BATCH_TIMED`` timed, each batch's launches held to its
    plan; the serial matcher on the same pairs, timed; every pair of the
    batch must stop at or before the serial matcher's rung on the same
    pair with >= 0.8x its verified matches.  Then one profiled batch and
    one profiled serial pair (device busy time, idle share, launches,
    host reads).  Returns bench.py's figures."""
    import numpy as np
    import torch
    img1, img2, H_gt = _load_pair_np(pair)
    rng = np.random.default_rng(7)
    bm = _batch_matcher()
    serial = _cviu_matcher()
    warm = _noisy_copies(img1, img2, BATCH_SIZE, rng)
    bm.match_batch(warm)
    serial.match(*warm[0])
    torch.cuda.synchronize()
    batches = [_noisy_copies(img1, img2, BATCH_SIZE, rng)
               for _ in range(BATCH_TIMED)]
    results, batch_s, launches = [], [], []
    for pairs in batches:
        before = counts()
        t0 = time.perf_counter()
        results.append(bm.match_batch(pairs))
        torch.cuda.synchronize()
        batch_s.append(time.perf_counter() - t0)
        launches.append({k: n - before[k] for k, n in counts().items()})
        tally(launches[-1])
        planned = batch_planned_launches(bm, pairs)
        if launches[-1] != planned:
            raise RuntimeError(f"batch of {pair}: launched {launches[-1]}, "
                               f"the plan gives {planned}")
    serial_s, serial_r = [], []
    for pairs in batches:
        for a, b in pairs:
            t0 = time.perf_counter()
            serial_r.append(serial.match(a, b))
            torch.cuda.synchronize()
            serial_s.append(time.perf_counter() - t0)
    bp = BATCH_SIZE * BATCH_TIMED / sum(batch_s)
    sp = len(serial_s) / sum(serial_s)
    for j, (r, pairs) in enumerate(zip(results, batches)):
        for i in range(BATCH_SIZE):
            s = serial_r[j * BATCH_SIZE + i]
            if r.steps_used[i] > s.steps_used \
                    or r.counts[i] < 0.8 * s.n_matches:
                raise RuntimeError(
                    f"batch of {pair}, pair {j * BATCH_SIZE + i}: rung "
                    f"{r.steps_used[i]}, {r.counts[i]} verified; serial "
                    f"rung {s.steps_used}, {s.n_matches}")

    def run_batch():
        bm.match_batch(batches[0])
        torch.cuda.synchronize()

    def run_serial():
        serial.match(*batches[0][0])
        torch.cuda.synchronize()

    prof_b = _profile(f"batch of {BATCH_SIZE} {pair}", run_batch, 1,
                      LADDER_PHASES, phase=10)
    prof_s = _profile(f"serial {pair} pair", run_serial, 1, LADDER_PHASES,
                      phase=10)
    last = results[-1]
    res = dict(
        pair=pair, batched_pairs_per_sec=bp,
        batched_speedup_vs_serial=bp / sp, batch_size=BATCH_SIZE,
        batched_verified=[int(c) for c in last.counts],
        batched_gt_checked=[_gt_consistent(H_gt, a, b)
                            for a, b in zip(last.xy1, last.xy2)],
        batched_steps=[int(c) for c in last.steps_used],
        serial_pairs_per_sec=sp, batch_s=batch_s, serial_pair_s=serial_s,
        kernel_launches_per_batch=launches[-1],
        launches_per_batch=prof_b["kernel_launches"],
        launches_per_serial_pair=prof_s["kernel_launches"],
        device_busy_ms_per_batch=prof_b["device_busy_ms"],
        device_idle_share_batch=prof_b["device_idle_share"],
        host_reads_per_batch=prof_b["host_reads"],
        device_busy_ms_per_serial_pair=prof_s["device_busy_ms"],
        device_idle_share_serial=prof_s["device_idle_share"],
        host_reads_per_serial_pair=prof_s["host_reads"],
        rung_peak_mem_bytes=bm.mm.rung_peak_bytes,
        serial_peak_mem_bytes=max(serial.rung_peak_bytes, default=None),
        mser_host_s=bm.mm.qmatcher.host_stage)
    print(f"[10] batched {pair}: {json.dumps(res)}", flush=True)
    bm.close()
    serial.close()
    return res


def _drive_flagship_batch(counts, tally) -> None:
    """Phase 10c: ``batched_pair_step`` on FLAGSHIP_BATCH noisy copies of
    zoom2x, each pair held to phase 3's rule, and the batch's launches to
    one step's (12 ``baumberg_smm``, 4 ``window_sampler``)."""
    import numpy as np
    import torch
    from mods_tpu_torch.models.flagship import (batched_pair_step,
                                                default_config,
                                                make_two_view_step)
    img1, img2, H_gt = _load_pair_np("zoom2x")
    pairs = _noisy_copies(img1, img2, FLAGSHIP_BATCH,
                          np.random.default_rng(7))
    a, b = (torch.as_tensor(np.stack([p[i] for p in pairs]), device="cuda")
            for i in (0, 1))
    cfg = default_config()

    def run():
        gens = [torch.Generator(device="cuda").manual_seed(s)
                for s in range(FLAGSHIP_BATCH)]
        out = batched_pair_step(a, b, gens, cfg)
        torch.cuda.synchronize()
        return out

    run()                                              # warm-up
    before = counts()
    t0 = time.perf_counter()
    out = run()
    dt = time.perf_counter() - t0
    launched = {k: n - before[k] for k, n in counts().items()}
    tally(launched)
    step = make_two_view_step(cfg)
    t0 = time.perf_counter()
    for s, (x, y) in enumerate(pairs):
        _run_step(step, torch.as_tensor(x, device="cuda"),
                  torch.as_tensor(y, device="cuda"), s)
    serial_dt = time.perf_counter() - t0
    j_tent, j_inl = JAX_REFERENCE["zoom2x"]
    rows = []
    for p in range(FLAGSHIP_BATCH):
        H = out["H"][p].cpu().numpy()
        rows.append(dict(tentatives=int(out["n_tentatives"][p]),
                         inliers=int(out["n_inliers"][p]),
                         corner_error_px=_corner_error(
                             H, H_gt, img1.shape[1], img1.shape[0])
                         if np.isfinite(H).all() else float("nan")))
    print("[10] flagship batch, zoom2x: " + json.dumps(dict(
        pairs=rows, kernel_launches=launched, batch_s=dt,
        pairs_per_s=FLAGSHIP_BATCH / dt,
        serial_pairs_per_s=FLAGSHIP_BATCH / serial_dt,
        jax_cpu=dict(tentatives=j_tent, inliers=j_inl))), flush=True)
    if launched != EXPECTED_LAUNCHES:
        raise RuntimeError(f"flagship batch: launched {launched}, one step "
                           f"launches {EXPECTED_LAUNCHES}")
    for p, row in enumerate(rows):
        if abs(row["tentatives"] - j_tent) > 0.2 * j_tent \
                or row["inliers"] < 0.8 * j_inl \
                or not row["corner_error_px"] <= 8.0:
            raise RuntimeError(f"flagship batch, pair {p}: {row}, JAX "
                               f"{j_tent} / {j_inl}")


def _drive_multi(counts, tally) -> None:
    """Phase 10d, one-vs-many: the pairs' shared image 1 as one query
    against the image 2s of ``BATCH_PAIRS`` as a padded gallery
    (``MultiMatcher.match``, until every gallery image is matched; the
    query's unbatched stores broadcast against the gallery's), one
    warm-up and one held run: its launches held to the plan, its rungs to
    the JAX package's ``MultiMatcher(mesh=None)`` and each gallery image's
    tentatives at each rung and its verified matches to
    ``JAX_MULTI_REFERENCE`` by the rules of 10a."""
    import torch
    from mods_tpu_torch import config
    from mods_tpu_torch.parallel.multi import MultiMatcher, _pad_gallery
    from mods_tpu_torch.pipeline import EngineConfig
    data = [_load_pair_np(p) for p in BATCH_PAIRS]
    query, gallery = data[0][0], [b for _, b, _ in data]
    mm = MultiMatcher(cviu_rungs(config), EngineConfig(), device="cuda")
    tents = batch_tentatives_per_rung(mm)
    mm.match(query, gallery, stop_at_first=False)             # warm-up
    torch.cuda.synchronize()
    del tents[:]
    before = counts()
    t0 = time.perf_counter()
    r = mm.match(query, gallery, stop_at_first=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = {k: n - before[k] for k, n in counts().items()}
    tally(launched)
    canvas, sizes = _pad_gallery(gallery)
    planned = _planned_launches(mm.qmatcher, (query.shape, canvas.shape[1:]),
                                mm.rungs_run, (None, tuple(sizes)))
    print(f"[10] one-vs-many, query {BATCH_PAIRS[0]}'s image 1: "
          + json.dumps(dict(
              s=dt, steps_used=r.steps_used, kernel_launches=launched,
              planned_launches=planned,
              rung_peak_mem_bytes=mm.rung_peak_bytes,
              time_log_s={k: round(v, 4) for k, v in r.log.times.items()})),
          flush=True)
    if launched != planned:
        raise RuntimeError(f"one-vs-many: launched {launched}, the plan of "
                           f"its {mm.rungs_run} rungs gives {planned}")

    def rerun(seed):
        mm._seed = seed
        return mm.match(query, gallery, stop_at_first=False)

    _hold_batch("one-vs-many", r, data, tents, JAX_MULTI_REFERENCE,
                JAX_MULTI_SPREAD, mm.cfg.min_matches, rerun)
    mm.close()


def _drive_batches(wrappers: dict) -> tuple[dict, list]:
    """Phase 10.  Returns each kernel's launches over the held batched
    calls (``match_batch``, ``MultiMatcher.match``, ``batched_pair_step``;
    the counts read just before and just after each, so the warm-ups and
    the serial runs they are compared with do not count) and 10b's
    figures."""
    def counts():
        return {k: sum(w.launches for w in ws) for k, ws in wrappers.items()}

    batched = dict.fromkeys(wrappers, 0)

    def tally(launched: dict) -> None:
        for k, n in launched.items():
            batched[k] += n

    for ws in wrappers.values():
        for w in ws:
            w.launches = 0
    _drive_batch_mixed(counts, tally)
    figures = [_drive_batch_throughput(pair, counts, tally)
               for pair in THROUGHPUT_PAIRS]
    _drive_flagship_batch(counts, tally)
    _drive_multi(counts, tally)
    return batched, figures


# ---------------------------------------------------------------------------
# phase 11: every other descriptor family

# Card vs CPU, the same patches through each family's functions on the
# card and in the port's plain run on the CPU.  The float families differ
# by the order of their sums and products: max |d| within FLOAT_TOL.
# MROGH's orientation bin truncates an atan2 and LIOP's order of four
# neighbours breaks ties by position, so a pixel can move bins where the
# two devices round across an edge: their entries hold FLOAT_TOL on 99 %
# and BIN_EDGE_TOL everywhere, and LIOP's permutation indices are equal
# wherever the neighbours are more than 1e-4 apart.  SSIM divides the
# rounding of p2 - 2 corr + c2 (p2 up to 1.6e6) by varnoise: held to
# SSIM_TOL where varnoise >= SSIM_TEXTURED, the flat rows reported.  The
# bits of M-LDB, FREAK and BRISK flip only where the two compared values
# are within 1e-5 of the patch's largest value.
FLOAT_TOL = 1e-5
CNN_TOL = 1e-4
BIN_EDGE_TOL = 5e-3
SSIM_TOL = 1e-3
SSIM_TEXTURED = 1e3
NEAR_TIE = 1e-5


def _descriptor_matcher(name: str, seed: int = 0):
    from mods_tpu_torch import config as tc
    from mods_tpu_torch import pipeline as tp
    ladder, cfg = descriptor_matcher_args(tp, tc, name)
    return tp.TwoViewMatcher(ladder, cfg, seed=seed, device="cuda")


def descriptor_patches(matcher, img) -> dict:
    """The regions of the identity view group of ``img`` (the first rung
    of the matcher's ladder), rendered and detected by its own stages on
    its device (the first ``caps.per_group`` of them), and their patches
    as its describe stage samples them, orientation aside: the SIFT
    family's (P = 41, ``aa_filter_patches``) and the CNN's (P = 32,
    mrSize 12).  Returns {P: (patches, max |d| of the sampler's output
    against its plain version on CPU copies of the same stack and
    coordinates)}."""
    import torch
    from mods_tpu_torch.descriptors.describe import (DESC_MIP_LEVELS,
                                                     aa_filter_patches,
                                                     image_to_patch_scale)
    from mods_tpu_torch.ops.sampler import (mip_stack, sample_affine_patches,
                                            select_level)
    L = DESC_MIP_LEVELS
    _, preps = matcher._prep_groups(matcher.ladder[0], *img.shape, [])
    gp = preps[0]
    views = gp["render"](img, gp["rot_inv"], gp["squash_inv"], gp["sig_x"],
                         gp["sig_y"], gp["valid_hw"])
    regs = gp["detect"](views, gp["valid_hw"], gp["valid_hw_host"],
                        gp["regn"])
    keep = regs.mask[0]
    cap = matcher.cfg.caps.per_group
    xy, A, s = (a[0][keep][:cap] for a in (regs.xy, regs.A, regs.s))
    mips, hw = mip_stack(views[:1], L)
    src = mips.reshape((L,) + mips.shape[-2:])
    pe = matcher.cfg.sift.patch_extraction
    out = {}
    for P, mr in ((pe.patch_size, pe.mr_size), (32, 12.0)):
        t = image_to_patch_scale(s, mr, P)
        As = A * t[:, None, None]
        lvl, sc = select_level(As, P, L)
        args = (src, lvl, xy / sc[:, None], As / sc[:, None, None], P, hw)
        raw = sample_affine_patches(*args)
        plain = sample_affine_patches(*(a.cpu() if hasattr(a, "cpu") else a
                                        for a in args))
        err = float((raw.cpu() - plain).abs().max())
        if P == pe.patch_size:
            raw = aa_filter_patches(raw, lvl, t, photo_norm=pe.photo_norm)
        out[P] = (raw, err)
    return out


def descriptors_card_vs_cpu(patches: dict, cfg) -> dict:
    """Each family's descriptors of the same patches on the card and on
    the CPU, held by the bounds above; returns what was measured."""
    import torch
    from mods_tpu_torch.descriptors import patch_descs as pd
    from mods_tpu_torch.descriptors.cnn import net_for
    from mods_tpu_torch.descriptors.registry import spec_for
    p41, p32 = patches[41][0], patches[32][0]
    cpu41 = p41.cpu()
    out = {}
    for name in OTHER_DESCRIPTORS:
        sp = spec_for(name, cfg)
        kw = dict(sp.params)
        if sp.kind == "cnn":
            card, cpu = (net_for(kw["weights_file"], kw["patch_size"],
                                 sp.dim, kw["normalization"], str(dev))(
                                     p32.to(dev)).cpu()
                         for dev in (p32.device, "cpu"))
        elif sp.kind == "pixels":
            card = pd.pixels_descriptor(p41, **kw).cpu()
            cpu = pd.pixels_descriptor(cpu41, **kw)
        else:
            card = pd.PATCH_FNS[name](p41, **kw).cpu()
            cpu = pd.PATCH_FNS[name](cpu41, **kw)
        d = (card - cpu).abs()
        res = dict(rows=card.shape[0], dim=card.shape[1],
                   max_abs_err=float(d.max()))
        if name in ("MLDB", "FREAK", "BRISK"):
            near = (pd.bit_margins(name, cpu41, **kw)
                    <= NEAR_TIE * cpu41.amax((1, 2))[:, None])
            res.update(flips=int((d > 0).sum()),
                       flips_off_ties=int(((d > 0) & ~near).sum()),
                       near_ties=int(near.sum()))
            ok = res["flips_off_ties"] == 0
        elif name in ("LIOP", "MROGH"):
            res["share_within_float_tol"] = float((d <= FLOAT_TOL).float()
                                                  .mean())
            ok = (res["max_abs_err"] <= BIN_EDGE_TOL
                  and res["share_within_float_tol"] >= 0.99)
            if name == "LIOP":
                (ci, cn), (pi, _) = (pd.liop_permutations(p, kw["radius"],
                                                          kw["n_neigh"])
                                     for p in (p41, cpu41))
                gaps = torch.diff(torch.sort(cn.cpu(), -1).values, dim=-1)
                apart = gaps.amin(-1) > 1e-4
                res.update(pixels_apart=float(apart.float().mean()),
                           perm_mismatch_apart=int(
                               (ci.cpu() != pi)[apart].sum()))
                ok = ok and res["perm_mismatch_apart"] == 0
        elif name == "SSIM":
            ssd = pd.ssim_surface(cpu41, kw["inner"])
            varn = ssd.mean((-1, -2)) * 0.5
            tex = varn >= SSIM_TEXTURED
            res.update(textured_rows=int(tex.sum()),
                       max_abs_err_textured=float(d[tex].max()),
                       flat_rows=int((~tex).sum()),
                       flat_rows_over_tol=int((d[~tex].amax(1)
                                               > SSIM_TOL).sum()))
            ok = res["max_abs_err_textured"] <= SSIM_TOL
        else:
            ok = res["max_abs_err"] <= (CNN_TOL if sp.kind == "cnn"
                                        else FLOAT_TOL)
        out[name] = res
        if not ok:
            raise RuntimeError(f"{name}: card vs CPU on the same patches "
                               f"{res}")
    return out


def _check_tables() -> dict:
    """The FREAK and BRISK tables and the CNN's procedural weights as this
    machine's numpy builds them, against the hashes recorded with the JAX
    reference (``PATTERN_SHA256``, ``PROCEDURAL_SHA256``)."""
    import numpy as np
    from mods_tpu_torch.descriptors import patch_descs as pd
    from mods_tpu_torch.descriptors.cnn import (procedural_weights,
                                                weights_sha256)
    got = dict(FREAK=pd.pattern_sha256(pd._freak_pattern(41, 1.0)),
               BRISK=pd.pattern_sha256(pd._brisk_pattern(41, 1.0)),
               procedural=weights_sha256(procedural_weights(32, 128)))
    ref = dict(PATTERN_SHA256, procedural=PROCEDURAL_SHA256)
    print(f"[11] numpy {np.__version__}: table and weight hashes "
          f"{json.dumps(got)}", flush=True)
    bad = [k for k in got if got[k] != ref[k]]
    if bad:
        raise RuntimeError(f"{bad} differ from the JAX reference's "
                           f"machine: {got} vs {ref}")
    return got


def _drive_descriptor_cell(name: str, counts, reset) -> dict:
    """One family's ladder on ``DESCRIPTOR_PAIRS`` (one warm-up, one timed
    pair each), held as phase 9 holds its cells; returns the launches of
    the timed pairs."""
    import torch
    matcher = _descriptor_matcher(name)
    rows = store_rows_per_rung(matcher, lambda st: st._n.clone())
    tents = tentatives_per_rung(matcher)
    total = defaultdict(int)
    for pair in DESCRIPTOR_PAIRS:
        img1, img2, H_gt = _load_pair_np(pair)
        ref = JAX_DESCRIPTOR_REFERENCE[name][pair]
        label = f"{name} {pair}"
        t0 = time.perf_counter()
        matcher.match(img1, img2)                       # warm-up
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        del rows[:], tents[:]
        reset()                                   # every count, just before
        t0 = time.perf_counter()
        r = matcher.match(img1, img2)
        torch.cuda.synchronize()
        pair_s = time.perf_counter() - t0
        launches = counts()                             # read just after
        planned = _planned_launches(matcher, (img1.shape, img2.shape),
                                    matcher.rungs_run)
        if launches != planned:
            raise RuntimeError(f"{label}: a pair launched {launches}, the "
                               f"plan of its rungs gives {planned}")
        for k, n in launches.items():
            total[k] += n
        region_rows = [[int(n) for n in rung] for rung in rows]
        rung_tents = [int(t) for t in tents]
        outcome = pair_outcome(r, H_gt, img1.shape)
        res = dict(
            steps_used=r.steps_used, regions=region_rows,
            tentatives_per_rung=rung_tents, tentatives=r.n_tentatives,
            matches=r.n_matches, gt_consistent_3px=outcome[2],
            corner_error_px=outcome[3], jax_cpu=ref, pair_s=pair_s,
            warmup_s=warm_s, kernel_launches_per_pair=launches,
            peak_mem_bytes=max(matcher.rung_peak_bytes, default=None))
        min_matches = matcher.cfg.min_matches
        _hold_regions(label, region_rows, ref["regions"])
        hold_tentatives(label, rung_tents, ref["tentatives_per_rung"],
                        min_matches)
        failure = _rule_failure(label, *outcome, ref, min_matches)
        spread = JAX_DESCRIPTOR_SPREAD.get(name, {}).get(pair)
        if failure and spread:
            outcomes = []
            for seed in range(spread["seeds"]):
                matcher._seed = seed
                outcomes.append(pair_outcome(matcher.match(img1, img2),
                                             H_gt, img1.shape))
            matcher._seed = 0
            res["spread"] = got = spread_figures(outcomes, ref, min_matches)
            res["spread_jax"] = spread
            failure = next((
                f"{label}: over {spread['seeds']} seeds {key} {got[key]}, "
                f"JAX {spread[key]}"
                for key in ("share_rule", "mean_verified", "mean_within_3px")
                if got[key] < 0.8 * spread[key]), None)
        print(f"[11] {label}: {json.dumps(res)}", flush=True)
        if failure:
            raise RuntimeError(failure)
    matcher.close()
    return dict(total)


def _drive_descriptor_batch(counts, reset) -> dict:
    """One ``PairBatchMatcher`` batch of ``DESCRIPTOR_PAIRS`` on the
    ladder of ``BATCH_DESCRIPTORS`` (one warm-up, one held): each pair
    stops at or before its serial card run's rung with >= 0.8x its
    verified matches; launches equal the batch's plan."""
    import torch
    from mods_tpu_torch import config as tc
    from mods_tpu_torch import pipeline as tp
    from mods_tpu_torch.parallel.multi import PairBatchMatcher
    name = "+".join(BATCH_DESCRIPTORS)
    data = [_load_pair_np(p) for p in DESCRIPTOR_PAIRS]
    pairs = [(a, b) for a, b, _ in data]
    serial = _descriptor_matcher(name)
    alone = [serial.match(a, b) for a, b in pairs]
    serial.close()
    ladder, cfg = descriptor_matcher_args(tp, tc, name)
    bm = PairBatchMatcher(ladder, cfg, seed=0, device="cuda")
    bm.match_batch(pairs)                               # warm-up
    torch.cuda.synchronize()
    reset()
    t0 = time.perf_counter()
    r = bm.match_batch(pairs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = counts()
    planned = batch_planned_launches(bm, pairs)
    outcomes = _batch_outcomes(r, data)
    print(f"[11] pair batch {list(DESCRIPTOR_PAIRS)} on {name}: " + json.dumps(
        dict(s=dt, rungs_run=bm.mm.rungs_run, kernel_launches=launched,
             planned_launches=planned, outcomes=outcomes,
             serial=[[s.steps_used, s.n_matches] for s in alone])),
        flush=True)
    if launched != planned:
        raise RuntimeError(f"{name} batch: launched {launched}, the plan "
                           f"of its {bm.mm.rungs_run} rungs gives {planned}")
    for pair, (steps, n, _, _), s in zip(DESCRIPTOR_PAIRS, outcomes, alone):
        if steps > s.steps_used or n < 0.8 * s.n_matches:
            raise RuntimeError(f"{name} batch, {pair}: rung {steps} with "
                               f"{n} verified, alone rung {s.steps_used} "
                               f"with {s.n_matches}")
    bm.close()
    return launched


# The exporters' INI files: ``CVIU_CONFIG_INI`` and one HessianAffine
# iteration with several families
EXPORT_DESCRIPTORS = ("SURF", "LIOP", "MLDB", "CNN", "RootSIFT")


def _drive_exporters() -> list:
    """``python -m mods_tpu_torch.cli export_descriptors`` and
    ``extract_benchmark`` (with zoom2x's ground-truth H) on zoom2x's image
    1, on the card: exit code 0, one file per store whose row count is the
    store's and whose rows read back with the port's ``io/oxford.py``."""
    import re

    import numpy as np
    from mods_tpu_torch.descriptors.registry import spec_for
    from mods_tpu_torch.io.oxford import (read_descriptors_benchmark,
                                          read_oxford)
    work = ROOT / "chiprun_out" / "exporters"
    work.mkdir(parents=True, exist_ok=True)
    (work / "config.ini").write_text(CVIU_CONFIG_INI)
    n = len(EXPORT_DESCRIPTORS)
    (work / "iters.ini").write_text(cviu_iters_ini([([dict(
        _HESAFF, tilt_set=(1.0,), descriptors=EXPORT_DESCRIPTORS,
        fginn_threshold=(0.8,) * n, distance_threshold=(0.0,) * n)],
        None)]))
    img = str(PAIRS / "zoom2x_1.png")
    cfgs = [str(work / "config.ini"), str(work / "iters.ini")]
    runs = (("export_descriptors", [img, str(work / "desc")] + cfgs),
            ("extract_benchmark", [img, str(work / "regions"),
                                   str(PAIRS / "zoom2x_H.txt")] + cfgs))
    out = []
    for cmd, args in runs:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "mods_tpu_torch.cli", cmd]
                           + args, cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
        res = dict(command=cmd, rc=p.returncode,
                   s=time.perf_counter() - t0, files={})
        if p.returncode != 0:
            raise RuntimeError(f"{cmd}: exit {p.returncode}\n{p.stdout}\n"
                               f"{p.stderr}")
        lines = re.findall(r"^(\S+)/(\S+): (\d+) \S+ -> (\S+)$", p.stdout,
                           re.M)
        if sorted(d for _, d, _, _ in lines) != sorted(EXPORT_DESCRIPTORS):
            raise RuntimeError(f"{cmd}: stores {lines}\n{p.stdout}")
        for det, name, count, path in lines:
            dim = spec_for(name).dim
            if cmd == "export_descriptors":
                desc = read_descriptors_benchmark(path)
                rows = len(desc)
            else:
                xy, A, s, desc = read_oxford(path)
                rows = len(xy)
            ok = (rows == int(count) > 0 and desc.shape == (rows, dim)
                  and bool(np.isfinite(desc).all()))
            res["files"][name] = dict(rows=rows, store=int(count),
                                      dim=desc.shape[1], ok=ok)
            if not ok:
                raise RuntimeError(f"{cmd} {det}/{name}: {res['files']}")
        print(f"[11] {json.dumps(res)}", flush=True)
        out.append(res)
    return out


def _drive_descriptors(wrappers: dict) -> dict:
    """Phase 11: the table hashes, each family card vs CPU on the same
    patches, each family's ladder (``OTHER_DESCRIPTORS``) on
    ``DESCRIPTOR_PAIRS``, one pair batch and the two exporter commands.
    Returns each kernel's launches over the cells' timed pairs and the
    held batch."""
    import torch
    from mods_tpu_torch.pipeline import EngineConfig

    def counts():
        return {k: sum(w.launches for w in ws) for k, ws in wrappers.items()}

    def reset():
        for ws in wrappers.values():
            for w in ws:
                w.launches = 0

    _check_tables()
    img, _, _ = _load_pair("zoom2x")
    patches = descriptor_patches(_descriptor_matcher("SURF"), img)
    print(f"[11] identity group of zoom2x image 1: {patches[41][0].shape[0]} "
          f"regions; window_sampler vs its plain version, max |d| "
          f"{json.dumps({P: e for P, (_, e) in patches.items()})}",
          flush=True)
    if any(e != 0.0 for _, e in patches.values()):
        raise RuntimeError("window_sampler differs from its plain version")
    cvc = descriptors_card_vs_cpu(patches, EngineConfig())
    print(f"[11] card vs CPU on the same patches: {json.dumps(cvc)}",
          flush=True)
    del img, patches
    torch.cuda.empty_cache()
    total = defaultdict(int)
    for name in OTHER_DESCRIPTORS:
        for k, n in _drive_descriptor_cell(name, counts, reset).items():
            total[k] += n
    for k, n in _drive_descriptor_batch(counts, reset).items():
        total[k] += n
    _drive_exporters()
    return dict(total)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    if not (ROOT / "mods_tpu_torch").is_dir():
        print(f"chip_smoke: {ROOT} holds no mods_tpu_torch package",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import mods_tpu_torch  # noqa: F401  (sets the float32 policy)
    from mods_tpu_torch import csrc
    from mods_tpu_torch.detectors import baumberg as B
    from mods_tpu_torch.ops import sampler as S

    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 is on: Hamming distances through a float "
                           "product and the blurs need full float32")
    start = time.perf_counter()

    def clock(phase: str) -> None:
        dt = time.perf_counter() - start
        print(f"[t] phases up to {phase} done {dt:.1f} s after the start",
              flush=True)

    card = _card()
    print(f"[0] card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}", flush=True)

    t0 = time.perf_counter()
    for name, log in csrc.build_all().items():
        print(f"[1] nvcc {name}.cu:\n{log.strip()}", flush=True)
    print(f"[1] build {time.perf_counter() - t0:.1f} s", flush=True)
    _build_native()
    clock("1")

    # the sampler on level stacks, as the main path calls it for
    # orientation and descriptor patches (per_view 512 x max_angles 2,
    # P=41), and at the TPU probe's shape
    # (scripts/pallas_sampler_probe.py: K=4096, P=41 over 4 x 640 x 1280);
    # and on prefetched windows at the Baumberg geometries (all six
    # octaves at once, and the K=256 of one baumberg_adapt call)
    geoms = [
        _check_sampler("descriptors", 1024, 41, 4, 1000, 640, 20, True),
        _check_sampler("probe", 4096, 41, 4, 640, 1280, 20, True),
        _check_sampler("baumberg windows", 1536, 19, 12, 1000, 640, 20,
                       False),
        _check_sampler("baumberg windows, one call", 256, 19, 12, 1000, 640,
                       20, False)]
    # the ladder's shapes: caps.per_group = 768 rows from the 12 x 4 mip
    # planes of a view group's 1280-wide canvases, 4 planes of extent 0
    # (a bucket-padded view), at P = 41 (orientation, SIFT) and P = 31
    # (BRIEF)
    geoms += [
        _check_sampler("ladder descriptors", 768, 41, 48, 640, 1280, 20,
                       True, zero_planes=4),
        _check_sampler("ladder BRIEF", 768, 31, 48, 640, 1280, 20, True,
                       zero_planes=4)]
    # the MSER rungs' shapes: orientation patches of an identity group
    # (one view, host_cap = 512 rows: K = 512 over the 4 mip planes of a
    # 1024 x 640 canvas), and a tilt-8 group (4 views: K = 768 over 16
    # planes of 1280 x 256)
    geoms += [
        _check_sampler("MSER orientation, identity group", 512, 41, 4,
                       1024, 640, 20, True),
        _check_sampler("MSER describe, tilt-8 group", 768, 41, 16, 1280,
                       256, 20, True)]
    # phase 9's identity groups of a device detector: caps.per_group =
    # 768 rows over the 4 mip planes of one 1024 x 640 canvas, at P = 41
    # (RootSIFT) and P = 31 (BRIEF of FAST and BRISK)
    geoms += [
        _check_sampler("device detector, identity group", 768, 41, 4, 1024,
                       640, 20, True),
        _check_sampler("device detector BRIEF, identity group", 768, 31, 4,
                       1024, 640, 20, True)]
    # phase 11's CNN patches (P = 32, CaffeDescParam.patchSize) of an
    # identity group: 768 rows over the 4 mip planes of a 1024 x 640 canvas
    geoms.append(_check_sampler("CNN patches, identity group", 768, 32, 4,
                                1024, 640, 20, True))
    for g in geoms:
        print(f"[2] window_sampler {json.dumps(g)}", flush=True)
    octaves = _zoom2x_octaves()
    smm = [_check_baumberg("zoom2x", o, octaves[o], 20) for o in (0, 3)]
    octaves = _tilt4_group_octaves()
    smm += [_check_baumberg("tilt4 group of 2 views", o, octaves[o], 20)
            for o in (0, 2)]
    # phase 9's affine detectors: DoG's and Harris's keypoints, whose
    # scales and counts differ from Hessian's
    for det in ("DoG", "HarrisAffine"):
        octaves = _zoom2x_octaves(det)
        smm += [_check_baumberg(f"zoom2x {det}", o, octaves[o], 20)
                for o in (0, 2)]
    del octaves
    for g in smm:
        print(f"[2] baumberg_smm {json.dumps(g)}", flush=True)
    clock("2")

    wrappers = {
        "baumberg_smm": [B.baumberg_adapt],
        "window_sampler": [S.sample_affine_patches, S.sample_from_windows]}
    launches = _drive_main_path(wrappers)
    print(f"[3] kernel launches on the flagship path: "
          f"{json.dumps(launches)}", flush=True)

    _small_pair_card_vs_cpu()
    clock("4")
    _profile_main_path()
    _profile_ladder()
    _profile_cviu()
    _profile_detectors()
    clock("5")

    ladder_launches = _drive_ladder(wrappers)
    print(f"[6] kernel launches on the ladder's path: "
          f"{json.dumps(ladder_launches)}", flush=True)
    clock("6")
    for pair in ("tilt4", "tilt6_rot45"):
        _check_host_render(pair)
    cviu_launches = _drive_cviu(wrappers)
    print(f"[7] kernel launches on the CVIU-shaped ladder's path: "
          f"{json.dumps(cviu_launches)}", flush=True)
    for name in wrappers:
        if min(launches[name], ladder_launches[name],
               cviu_launches[name]) <= 0:
            raise RuntimeError(f"{name} was not launched on a main path")
    clock("7")
    _drive_cli()
    _profile_f_estimators()
    clock("8")
    detector_launches = _drive_detectors(wrappers)
    print(f"[9] kernel launches on the other detectors' paths: "
          f"{json.dumps(detector_launches)}", flush=True)
    for name in wrappers:
        if detector_launches[name] <= 0:
            raise RuntimeError(f"{name} was not launched on phase 9's paths")
    clock("9")
    batch_launches, batched = _drive_batches(wrappers)
    print(f"[10] kernel launches on the pair-batched paths: "
          f"{json.dumps(batch_launches)}", flush=True)
    for name in wrappers:
        if batch_launches[name] <= 0:
            raise RuntimeError(f"{name} was not launched on phase 10's "
                               "paths")
    clock("10")
    descriptor_launches = _drive_descriptors(wrappers)
    print(f"[11] kernel launches on the other descriptors' paths: "
          f"{json.dumps(descriptor_launches)}", flush=True)
    for name in wrappers:
        if descriptor_launches.get(name, 0) <= 0:
            raise RuntimeError(f"{name} was not launched on phase 11's "
                               "paths")
    clock("11")

    kernels = []
    for name, replaces, checks in (
            ("baumberg_smm", "mods_tpu/ops/sampler.py:190", smm),
            ("window_sampler", "mods_tpu/ops/sampler.py:190", geoms)):
        main_geom = checks[0]          # the main path's shape
        kernels.append(dict(
            name=name, route="cuda",
            source=f"mods_tpu_torch/csrc/{name}.cu", replaces=replaces,
            launches=(launches[name] + ladder_launches[name]
                      + cviu_launches[name] + detector_launches[name]
                      + batch_launches[name] + descriptor_launches[name]),
            launches_flagship=launches[name],
            launches_ladder=ladder_launches[name],
            launches_cviu_ladder=cviu_launches[name],
            launches_other_detectors=detector_launches[name],
            launches_pair_batched=batch_launches[name],
            launches_other_descriptors=descriptor_launches[name],
            max_abs_err=max(g["max_abs_err"] for g in checks),
            ms=main_geom["ms"], plain_ms=main_geom["plain_ms"],
            bound_ms=main_geom["bound_ms"], bound_by=main_geom["bound_by"],
            library_ms=main_geom["library_ms"], geometries=checks))
    print(json.dumps({"batched": [{k: f[k] for k in (
        "pair", "batched_pairs_per_sec", "batched_speedup_vs_serial",
        "batch_size", "batched_verified", "batched_gt_checked",
        "launches_per_batch", "device_busy_ms_per_batch",
        "device_idle_share_batch", "host_reads_per_batch")}
        for f in batched]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---------------------------------------------------------------------------
# ``--seed-spread``: the RANSAC draw's share in a pair's stop rung

BANK_KEYS = ("xy1", "A1", "s1", "xy2", "A2", "s2", "prio", "mask")


def ladder_banks(matcher, img1, img2) -> dict:
    """The tentatives that each rung of ``matcher``'s ladder verifies on a
    pair (one run of every rung: ``matcher`` in ``async`` mode),
    compacted as ``_concat_compact_parts`` compacts them: numpy arrays
    keyed ``"{rung}_{name}"`` (rungs from 1), and ``wh``."""
    import numpy as np
    from mods_tpu_torch.pipeline import _concat_compact_parts
    banks, calls, verify = {}, [], matcher._verify_bank

    def keep(log):
        calls.append(None)                             # one call a rung
        parts = [p for ps in matcher._bank.values() for p in ps]
        if parts:
            c = _concat_compact_parts(parts, matcher.cfg.caps.tentatives)
            banks.update({f"{len(calls)}_{k}": v.cpu().numpy()
                          for k, v in c.items()})
        return verify(log)

    matcher._verify_bank = keep
    try:
        matcher.match(img1, img2)
    finally:
        del matcher._verify_bank
    banks["wh"] = np.asarray(matcher._wh)
    return banks


def bank_rungs(banks: dict) -> list:
    return sorted({int(k.split("_")[0]) for k in banks if k != "wh"})


def verify_spread(cfg, banks: dict, rung: int, seeds, H_gt,
                  device: str) -> list:
    """The port's verification (``_verify_core``) of one rung's bank on
    ``device``, once for each ``torch.Generator`` seed: per seed the
    verified matches and those within 3 px of the ground truth."""
    import numpy as np
    import torch
    from mods_tpu_torch.pipeline import _verify_core
    w, h = (int(v) for v in banks["wh"])
    args = [torch.as_tensor(banks[f"{rung}_{k}"], device=device)
            for k in BANK_KEYS]
    out = []
    for s in seeds:
        g = torch.Generator(device=device).manual_seed(s)
        inl = _verify_core(cfg, w, h, *args, g)["inlier_mask"].cpu().numpy()
        xy1, xy2 = banks[f"{rung}_xy1"], banks[f"{rung}_xy2"]
        out.append([int(inl.sum()), _gt_consistent(H_gt, xy1[inl],
                                                   xy2[inl])])
    return out


def spread_summary(counts: list, min_matches: int) -> dict:
    """Per-seed [verified, within 3 px] -> the shares and means that a
    comparison of two verifiers reads."""
    import numpy as np
    c = np.asarray(counts, np.float64).reshape(-1, 2)
    v, n = np.unique(c[:, 0].astype(int), return_counts=True)
    return dict(seeds=len(c), verified_hist=dict(zip(map(str, v),
                                                      map(int, n))),
                share_stops=float((c[:, 0] >= min_matches).mean()),
                share_zero=float((c[:, 0] == 0).mean()),
                mean_verified=float(c[:, 0].mean()),
                mean_within_3px=float(c[:, 1].mean()))


def fit_accuracy(cfg, banks: dict, rung: int, device: str,
                 n: int = 100000) -> dict:
    """The minimal 4-point fits of ``ransac_h`` against the same fits in
    float64 on the CPU, on ``n`` random samples of one rung's
    deduplicated tentatives: as the port fits them on ``device`` and on
    the CPU (``_fit_h``: float32 on the CPU, the normal equations in
    float64 on the card), and with ``eigh`` in float32 on ``device``.
    For each, the share of samples whose inlier count differs from
    float64's, and the mean count over the samples whose float64 fit has
    >= 8 inliers."""
    import numpy as np
    import torch
    from mods_tpu_torch.pipeline import duplicate_filter
    from mods_tpu_torch.ransac import homography as RH
    from mods_tpu_torch.ransac.errors import inv_3x3

    def fit_float32(q1, q2):
        rows = RH._dlt_rows(q1, q2).reshape(q1.shape[:-2] + (-1, 9))
        h = torch.linalg.eigh(rows.transpose(-1, -2) @ rows)[1][..., :, 0]
        return h.reshape(h.shape[:-1] + (3, 3))

    b = {k: torch.as_tensor(banks[f"{rung}_{k}"]) for k in BANK_KEYS}
    keep = duplicate_filter(b["xy1"], b["xy2"], b["mask"],
                            cfg.match.duplicate_dist, priority=b["prio"])
    valid = np.nonzero((b["mask"] & keep).numpy())[0]
    idx = torch.as_tensor(np.random.default_rng(0).choice(valid, (n, 4)))
    th = cfg.ransac.err_threshold ** 2
    err_fn = RH._error_fn(cfg.ransac)
    counts = {}
    for name, dev, dt, fit in (
            (f"{device}_as_fit", device, torch.float32, RH._fit_h),
            (f"{device}_eigh_float32", device, torch.float32, fit_float32),
            ("cpu_as_fit", "cpu", torch.float32, RH._fit_h),
            ("float64", "cpu", torch.float64, RH._fit_h)):
        xy1, xy2 = (b[k].to(dev, dt) for k in ("xy1", "xy2"))
        m = torch.zeros(len(xy1), dtype=torch.bool, device=dev)
        m[torch.as_tensor(valid, device=dev)] = True
        T1, T2 = RH._normalization(xy1, m), RH._normalization(xy2, m)
        p1, p2 = RH._apply_T(T1, xy1), RH._apply_T(T2, xy2)
        c = []
        for i in idx.to(dev).split(2048):       # ransac_h's batch of fits
            H = inv_3x3(T2) @ fit(p1[i], p2[i]) @ T1
            c.append(((err_fn(H, xy1, xy2) < th) & m).sum(-1).cpu())
        counts[name] = torch.cat(c).numpy()
    ref = counts.pop("float64")
    good = ref >= 8
    return dict(rung=rung, samples=n, tentatives=len(valid),
                good_samples=int(good.sum()),
                mean_count_good_float64=float(ref[good].mean()),
                **{k: dict(share_count_differs=float((c != ref).mean()),
                           mean_count_good=float(c[good].mean()))
                   for k, c in counts.items()})


def seed_spread(pair: str, n_seeds: int, det: str = "") -> int:
    """``python3 chip_smoke.py --seed-spread PAIR N [DET]``: the
    CVIU-shaped ladder's (or ``DETECTOR_LADDERS[DET]``'s) tentatives of
    every rung on the card (saved to
    ``chiprun_out/banks_[<DET>_]<pair>_cuda.npz`` for the CPU side,
    ``python tests/test_torch_ladder.py --seeds N --banks FILE PAIR``, or
    ``--detectors DET --tentatives --seeds N --banks FILE PAIR``), then,
    per rung with at least ``min_matches`` tentatives within 3 px of the
    ground truth, the spread of the port's verification on the card over
    seeds 0..N-1 and its minimal fits against float64.  Needs the
    card."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    print(_card(), flush=True)
    m = _detector_matcher(det, "async") if det else _cviu_matcher("async")
    img1, img2, H_gt = _load_pair_np(pair)
    banks = ladder_banks(m, img1, img2)
    m.close()
    out = ROOT / "chiprun_out" / (f"banks_{det}_{pair}_cuda.npz" if det
                                  else f"banks_{pair}_cuda.npz")
    out.parent.mkdir(exist_ok=True)
    np.savez(out, **banks)
    print(f"banks: {out.relative_to(ROOT)}", flush=True)
    cfg = m.cfg
    for rung in bank_rungs(banks):
        mask = banks[f"{rung}_mask"]
        row = dict(rung=rung, tentatives=int(mask.sum()),
                   within_3px=_gt_consistent(H_gt, banks[f"{rung}_xy1"][mask],
                                             banks[f"{rung}_xy2"][mask]))
        if row["within_3px"] >= cfg.min_matches:       # a stop is possible
            t0 = time.perf_counter()
            row["cuda"] = spread_summary(verify_spread(
                cfg, banks, rung, range(n_seeds), H_gt, "cuda"),
                cfg.min_matches)
            row["cuda"]["s_a_seed"] = (time.perf_counter() - t0) / n_seeds
        print(json.dumps({pair: row}), flush=True)
        if "cuda" in row:
            print(json.dumps({pair: dict(rung=rung, fits=fit_accuracy(
                cfg, banks, rung, "cuda"))}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--seed-spread"]:
        sys.exit(seed_spread(*sys.argv[2:3], int(sys.argv[3]),
                             *sys.argv[4:5]))
    sys.exit(main())
