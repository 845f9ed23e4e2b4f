"""The ``mods`` two-view matcher and the descriptor-benchmark exporters
as commands (mirrors ``mods_tpu/cli.py``; the reference's CLI,
mods.cpp:62-79, export_descriptors.cpp and
extract_regions_for_benchmark).

Usage, from the repository root:
  python -m mods_tpu_torch.cli match img1 img2 out1 out2 k1 k2 matchings \\
      log [ver_type] [config.ini] [iters.ini] [gt_h_file]
  python -m mods_tpu_torch.cli export_descriptors img out [config.ini] \\
      [iters.ini]
  python -m mods_tpu_torch.cli extract_benchmark img out [gt_h_file] \\
      [config.ini] [iters.ini]

``ver_type`` is LORANSACH (the default), LORANSACF, ORSA or GR_TRUTH
(with ``gt_h_file``).  The exporters describe the image with every
detector of the ladder's first iteration and write one file per
(detector, descriptor) store, ``out.DET.DESC`` when there are several:
descriptor rows (``n dim`` then rows), or Oxford region files with
their descriptors, reprojected by ``gt_h_file`` when one is given.
Each runs on the card; ``--device cpu`` runs the plain versions on the
CPU instead (the tests' mode).  Images are 8-bit PNGs.  Drawn outputs
(``out1``, ``out2`` other than 0 or none) and the ``extract`` and
``match_multi`` commands are not ported yet: ROADMAP.md item 21.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from mods_tpu_torch.config import IterationParams, as_rungs, replace
from mods_tpu_torch.io import ini as ini_mod
from mods_tpu_torch.io.oxford import write_descriptors_benchmark, write_oxford
from mods_tpu_torch.io.png import read_png_gray
from mods_tpu_torch.io.regions_io import write_h, write_matches
from mods_tpu_torch.ops.image import to_gray_np
from mods_tpu_torch.pipeline import (EngineConfig, TwoViewMatcher,
                                     _not_ported, autosize_caps)
from mods_tpu_torch.timing import RunLog, TimeLog
from mods_tpu_torch.verify import load_h_file

OTHER_COMMANDS = ("extract", "match_multi")


def _build_engine(config_path: str | None, iters_path: str | None,
                  ver_type: str = "LORANSACH"):
    """(EngineConfig, ladder or None) from the two INI files, as
    ``mods_tpu/cli.py::_build_engine`` builds them."""
    cfg = EngineConfig()
    ladder = None
    min_matches = 10
    if config_path:
        ini = ini_mod.load_ini(config_path)
        cfg = replace(
            cfg,
            pyramid=ini_mod.parse_detector_config(ini, "HessianAffine"),
            pyramid_dog=ini_mod.parse_detector_config(ini, "DoG"),
            pyramid_harris=ini_mod.parse_detector_config(
                ini, "HarrisAffine"),
            affine=ini_mod.parse_affine_config(ini, "HessianAffine"),
            mser=ini_mod.parse_mser_config(ini),
            dom_ori=ini_mod.parse_dom_ori_config(ini),
            sift=ini_mod.parse_sift_desc_config(ini),
            ransac=ini_mod.parse_ransac_config(ini),
            match=ini_mod.parse_matching_config(ini),
            **ini_mod.parse_descriptor_sections(ini),
            **ini_mod.parse_flags_config(ini))
    if iters_path:
        _, min_matches, ladder = ini_mod.parse_iters_file(iters_path)
    use_f = ver_type in ("LORANSACF", "ORSA")
    cfg = replace(cfg, ransac=replace(cfg.ransac, use_f=use_f),
                  min_matches=min_matches, ver_type=ver_type)
    return autosize_caps(cfg), ladder


def cmd_match(argv: list[str], device: str = "cuda") -> int:
    img1p, img2p = argv[0], argv[1]
    out1 = argv[2] if len(argv) > 2 else ""
    out2 = argv[3] if len(argv) > 3 else ""
    matchings = argv[6] if len(argv) > 6 else "matchings.txt"
    logf = argv[7] if len(argv) > 7 else ""
    ver_type = argv[8] if len(argv) > 8 else "LORANSACH"
    config = argv[9] if len(argv) > 9 else None
    iters = argv[10] if len(argv) > 10 else None
    gt_h_path = argv[11] if len(argv) > 11 else None
    for out in (out1, out2):
        if out and out not in ("0", "none"):
            raise _not_ported(f"the drawn output {out!r} (viz.py)", 21)

    cfg, ladder = _build_engine(config, iters, ver_type)
    gt_h = load_h_file(gt_h_path) if gt_h_path else None
    # per-phase wall-clock attribution (reference time.log parity) needs
    # a sync at each phase boundary; skipped when no log is written
    matcher = TwoViewMatcher(ladder, cfg,
                             sync_timing=bool(logf and logf != "0"),
                             device=device)
    try:
        res = matcher.match(read_png_gray(img1p), read_png_gray(img2p),
                            gt_h=gt_h)
    finally:
        matcher.close()
    print(f"Matches: {res.n_matches} (tentatives {res.n_tentatives}, "
          f"steps {res.steps_used})")
    write_matches(matchings, res.xy1, res.xy2)
    write_h(matchings + ".H", res.H)
    if logf and logf not in ("0", "none"):
        nt = max(res.n_tentatives, 1)
        RunLog(tentatives=res.n_tentatives, true_matches=res.n_matches,
               inlier_ratio=res.n_matches / nt, steps=res.steps_used,
               total_time=res.log.times["TotalTime"],
               ver_type=ver_type).write(logf)
        res.log.write(logf + ".time")
    print(res.log.summary())
    return 0


def _extract_stores(imgp: str, config, iters, device: str) -> dict:
    """Single-image extraction for the exporters: the ladder's first
    iteration, all of its detectors (extract_features.cpp:121).  Returns
    the stores keyed (detector, descriptor)."""
    cfg, ladder = _build_engine(config, iters)
    matcher = TwoViewMatcher(ladder or [IterationParams()], cfg,
                             device=device)
    g = to_gray_np(read_png_gray(imgp))
    img = torch.as_tensor(g, device=matcher.device)
    stores: dict = {}
    log = TimeLog()
    try:
        for it in as_rungs(matcher.ladder)[0].dets:
            matcher._process_image(img, it, [], stores, log, img_np=g)
    finally:
        matcher.close()
    return stores


def _out_path(outp: str, stores: dict, det: str, name: str) -> str:
    return outp if len(stores) == 1 else f"{outp}.{det}.{name}"


def cmd_export_descriptors(argv: list[str], device: str = "cuda") -> int:
    """image -> one descriptor dump per store (export_descriptors.cpp;
    SaveDescriptorsBenchmark, imagerepresentation.cpp:2216)."""
    imgp, outp = argv[0], argv[1]
    config = argv[2] if len(argv) > 2 else None
    iters = argv[3] if len(argv) > 3 else None
    stores = _extract_stores(imgp, config, iters, device)
    for (det, name), store in stores.items():
        path = _out_path(outp, stores, det, name)
        write_descriptors_benchmark(path, store.desc)
        print(f"{det}/{name}: {store.count} descriptors -> {path}")
    return 0


def cmd_extract_benchmark(argv: list[str], device: str = "cuda") -> int:
    """image [+ ground-truth H] -> one Oxford region file per store,
    reprojected into the second image's frame by the H when one is given
    (SynthDetectDescribeKeypointsBench, imagerepresentation.cpp:2306;
    SaveRegionsBenchmark :2257)."""
    imgp, outp = argv[0], argv[1]
    h_path = argv[2] if len(argv) > 2 else None
    config = argv[3] if len(argv) > 3 else None
    iters = argv[4] if len(argv) > 4 else None
    stores = _extract_stores(imgp, config, iters, device)
    H = (load_h_file(h_path)
         if h_path and h_path not in ("0", "none", "") else None)
    for (det, name), store in stores.items():
        xy, A, s = store.xy, store.A, store.s
        if H is not None:
            p = np.concatenate([xy, np.ones((len(xy), 1))], 1) @ H.T
            xy = p[:, :2] / p[:, 2:3]
            # the local linearization of H scales the frames
            lin = (H[:2, :2][None]
                   - p[:, :2, None] / p[:, 2:3, None] * H[2, :2][None,
                                                                 None])
            A = np.einsum("nij,njk->nik", lin / p[:, 2:3, None], A)
        path = _out_path(outp, stores, det, name)
        write_oxford(path, xy, A, s, store.desc)
        print(f"{det}/{name}: {store.count} regions -> {path}")
    return 0


COMMANDS = {"match": cmd_match, "export_descriptors": cmd_export_descriptors,
            "extract_benchmark": cmd_extract_benchmark}


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    if not argv:
        print(__doc__)
        return 1
    cmd, args = argv[0], argv[1:]
    if cmd in COMMANDS:
        return COMMANDS[cmd](args, device)
    if cmd in OTHER_COMMANDS:
        raise _not_ported(f"the {cmd!r} command", 21)
    print(__doc__)
    return 1


if __name__ == "__main__":
    sys.exit(main())
