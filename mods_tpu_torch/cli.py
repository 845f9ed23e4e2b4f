"""The reference's command-line applications (mirrors
``mods_tpu/cli.py``; SURVEY.md §1): the ``mods`` two-view matcher
(mods.cpp:62-79), ``mods_multi`` one-vs-many (mods_multi.cpp),
``extract_features`` (extract_features.cpp), ``export_descriptors`` and
``extract_regions_for_benchmark``.

Usage, from the repository root:
  python -m mods_tpu_torch.cli match img1 img2 out1 out2 k1 k2 matchings \\
      log [ver_type] [config.ini] [iters.ini] [gt_h_file]
  python -m mods_tpu_torch.cli extract img out_keys [config.ini] \\
      [iters.ini] [mods|michal|michal-text]
  python -m mods_tpu_torch.cli match_multi query list [config.ini] \\
      [iters.ini] [log_prefix] [out_prefix] [manifest]
  python -m mods_tpu_torch.cli export_descriptors img out [config.ini] \\
      [iters.ini]
  python -m mods_tpu_torch.cli extract_benchmark img out [gt_h_file] \\
      [config.ini] [iters.ini]

``ver_type`` is LORANSACH (the default), LORANSACF, ORSA or GR_TRUTH
(with ``gt_h_file``).  ``out1`` and ``out2`` (0 or none for no drawing)
are PNG drawings of the matches: the correspondences, and the epipolar
lines (LORANSACF, ORSA) or the reprojection errors under the H.  The
exporters describe the image with every detector of the ladder's first
iteration: ``extract`` writes one keypoint file of every store (or the
Michal per-descriptor files), the others one file per (detector,
descriptor) store, ``out.DET.DESC`` when there are several: descriptor
rows (``n dim`` then rows), or Oxford region files with their
descriptors, reprojected by ``gt_h_file`` when one is given.
``match_multi`` matches the query against each image of ``list`` (one
path a line), writes ``<log_prefix>-<name>.log`` a gallery image and,
with ``out_prefix``, its drawing; a ``manifest`` (JSON) lets a rerun
skip the images already done.  Each command runs on the card;
``--device cpu`` runs the plain versions on the CPU instead (the tests'
mode).  Images are 8-bit PNGs.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from mods_tpu_torch import viz
from mods_tpu_torch.config import IterationParams, as_rungs, replace
from mods_tpu_torch.io import ini as ini_mod
from mods_tpu_torch.io.oxford import write_descriptors_benchmark, write_oxford
from mods_tpu_torch.io.png import png_size, read_png
from mods_tpu_torch.io.regions_io import (RegionSet, save_regions,
                                          save_regions_michal, write_h,
                                          write_matches)
from mods_tpu_torch.ops.image import to_gray_np
from mods_tpu_torch.parallel.manifest import RunManifest, with_retries
from mods_tpu_torch.parallel.multi import MultiMatcher
from mods_tpu_torch.pipeline import EngineConfig, TwoViewMatcher, autosize_caps
from mods_tpu_torch.timing import RunLog, TimeLog
from mods_tpu_torch.verify import load_h_file


def _given(arg: str) -> bool:
    """An optional output argument that names a file (not 0 or none)."""
    return bool(arg) and arg not in ("0", "none")


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

    cfg, ladder = _build_engine(config, iters, ver_type)
    gt_h = load_h_file(gt_h_path) if gt_h_path else None
    # per-phase wall-clock attribution (reference time.log parity) needs
    # a sync at each phase boundary; skipped when no log is written
    matcher = TwoViewMatcher(ladder, cfg,
                             sync_timing=bool(logf and logf != "0"),
                             device=device)
    # the images as loaded: the drawings are made on them, the matcher
    # converts them to gray
    img1, img2 = read_png(img1p), read_png(img2p)
    try:
        res = matcher.match(img1, img2, gt_h=gt_h)
    finally:
        matcher.close()
    print(f"Matches: {res.n_matches} (tentatives {res.n_tentatives}, "
          f"steps {res.steps_used})")
    write_matches(matchings, res.xy1, res.xy2)
    write_h(matchings + ".H", res.H)
    # drawn outputs (mods.cpp:480-527)
    if _given(out1):
        viz.save_image(out1, viz.draw_matches(img1, img2, res.xy1, res.xy2))
    if _given(out2):
        canvas = (viz.draw_epipolar(img1, img2, res.xy1, res.xy2, res.H)
                  if ver_type in ("LORANSACF", "ORSA") else
                  viz.draw_matches_with_error(img1, img2, res.xy1, res.xy2,
                                              res.H))
        viz.save_image(out2, canvas)
    if _given(logf):
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
    g = to_gray_np(read_png(imgp))
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


def cmd_extract(argv: list[str], device: str = "cuda") -> int:
    """image -> keypoint file (extract_features.cpp:121-135): every store
    in the MODS hierarchical format, or with a trailing ``michal`` /
    ``michal-text`` the Michal per-descriptor files (SaveRegionsMichal,
    imagerepresentation.cpp:2049-2146), whose header takes the image size
    from the PNG header."""
    imgp, outp = argv[0], argv[1]
    config = argv[2] if len(argv) > 2 else None
    iters = argv[3] if len(argv) > 3 else None
    fmt = argv[4] if len(argv) > 4 else "mods"
    stores = _extract_stores(imgp, config, iters, device)
    out: dict = {}
    flat = {}
    for (det, name), store in stores.items():
        rs = RegionSet(
            det_xy=store.xy, det_A=store.A, det_s=store.s,
            reproj_xy=store.xy, reproj_A=store.A, reproj_s=store.s,
            sub_type=np.zeros(store.count, np.int64), desc=store.desc)
        out.setdefault(det, {})[name] = rs
        flat[(det, name)] = rs
    if fmt.startswith("michal"):
        w0, h0 = png_size(imgp)
        files = save_regions_michal(outp, flat, w0, h0,
                                    binary=(fmt == "michal"))
        print(f"Saved Michal files: {files}")
    else:
        save_regions(outp, out)
    total = sum(s.count for s in stores.values())
    print(f"Saved {total} regions to {outp}")
    return 0


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


def cmd_match_multi(argv: list[str], device: str = "cuda") -> int:
    """mods_multi: the query against a gallery of images, escalating until
    at least one gallery image matches (GetAtLeastOneImageMatch,
    mods_multi.cpp:229-260).

    args: query list [config] [iters] [log_prefix] [out_prefix] [manifest]

    The gallery runs as one batch (``parallel/multi.py::MultiMatcher``) on
    the one device given; several GPUs are ROADMAP.md item 22.  A ladder
    with ReadAffs or External takes the serial loop instead, one
    ``TwoViewMatcher`` pair a gallery image, recorded in the manifest
    after each.  ``manifest``: a JSON checkpoint (SURVEY.md §5.3); a rerun
    with the same manifest skips the images already done, and a transient
    device error retries, then marks the image failed without ending the
    run."""
    query = argv[0]
    list_file = argv[1]
    cfg, ladder = _build_engine(argv[2] if len(argv) > 2 else None,
                                argv[3] if len(argv) > 3 else None)
    log_prefix = argv[4] if len(argv) > 4 else ""
    out_prefix = argv[5] if len(argv) > 5 else ""
    manifest_path = argv[6] if len(argv) > 6 else ""
    with open(list_file) as f:
        paths = [ln.strip() for ln in f if ln.strip()]
    qimg = read_png(query)

    manifest = None
    todo = paths
    if _given(manifest_path):
        manifest = RunManifest.load(manifest_path, query)
        todo = manifest.pending(paths)
        if len(todo) < len(paths):
            print(f"manifest: {len(paths) - len(todo)}/{len(paths)} "
                  f"gallery images already done, resuming")
    imgs = {p: read_png(p) for p in todo}

    results: dict = {}          # path -> (n, tents, steps, xy1, xy2)
    total_time = 0.0
    dets = {d.detector for r in as_rungs(ladder or []) for d in r.dets}
    if todo and not {"ReadAffs", "External"} & dets:
        m = MultiMatcher(ladder, cfg, device=device)
        try:
            res = with_retries(lambda: m.match(qimg, [imgs[p] for p in todo]))
        finally:
            m.close()
        for i, p in enumerate(todo):
            results[p] = (int(res.counts[i]), int(res.n_tentatives[i]),
                          int(res.steps_used), res.xy1[i], res.xy2[i])
        total_time = res.log.times["TotalTime"]
    elif todo:
        # host-stage plugins: the reference's serial gallery loop
        # (mods_multi.cpp:250+), a checkpoint after every image
        matcher = TwoViewMatcher(ladder, cfg, device=device)
        try:
            for p in todo:
                try:
                    r = with_retries(lambda: matcher.match(qimg, imgs[p]))
                except Exception as e:          # mark failed, keep going
                    if manifest is None:
                        raise
                    manifest.record(p, 0, 0, 0, error=str(e)[:200])
                    manifest.save()
                    continue
                results[p] = (r.n_matches, r.n_tentatives, r.steps_used,
                              r.xy1, r.xy2)
                total_time += r.log.times["TotalTime"]
                if manifest is not None:
                    manifest.record(p, r.n_matches, r.n_tentatives,
                                    r.steps_used)
                    manifest.save()
        finally:
            matcher.close()
    if manifest is not None:
        for p in todo:
            if p in results:
                n, t, s, _, _ = results[p]
                manifest.record(p, n, t, s)
        manifest.save()

    counts, tents, steps, pairs = [], [], [], []
    z = np.zeros((0, 2))
    for p in paths:
        if p in results:
            n, t, s, xy1, xy2 = results[p]
        elif manifest is not None and manifest.result(p) is not None:
            d = manifest.result(p)
            n, t, s = d["n_matches"], d["n_tentatives"], d["steps"]
            xy1 = xy2 = z       # match points are not kept for resumes
        else:
            n, t, s, xy1, xy2 = 0, 0, 0, z, z
        counts.append(n)
        tents.append(t)
        steps.append(s)
        pairs.append((xy1, xy2))

    # per gallery image (mods_multi.cpp:386-433): <log_prefix>-<img2
    # basename>.log and, with out_prefix, the drawing of its matches
    for i, p in enumerate(paths):
        n, t = int(counts[i]), int(tents[i])
        print(f"{p}: {n} matches ({t} tentatives)")
        prefix = os.path.splitext(os.path.basename(p))[0]
        if _given(log_prefix):
            RunLog(tentatives=t, true_matches=n,
                   inlier_ratio=n / max(t, 1), steps=int(steps[i]),
                   total_time=total_time,
                   ver_type="LORANSACH").write(f"{log_prefix}-{prefix}.log")
        if _given(out_prefix) and p in imgs:
            xy1, xy2 = pairs[i]
            viz.save_image(f"{out_prefix}{prefix}-1.png",
                           viz.draw_matches(qimg, imgs[p], xy1, xy2))
    matched = sum(1 for c in counts if int(c) >= cfg.min_matches)
    print(f"{matched}/{len(paths)} gallery images matched "
          f"(minMatches={cfg.min_matches})")
    return 0


COMMANDS = {"match": cmd_match, "extract": cmd_extract,
            "match_multi": cmd_match_multi,
            "export_descriptors": cmd_export_descriptors,
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
    print(__doc__)
    return 1


if __name__ == "__main__":
    sys.exit(main())
