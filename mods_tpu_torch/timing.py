"""Phase-level wall-clock ledger and per-run log (mirrors
``mods_tpu/timing.py``; reference ``TimeLog``,
detectors/structures.hpp:51-74, phases
Synth/Detect/Orient/Desc/SCV/Match/RANSAC/Misc/Total).

Kernels run asynchronously on the card: a phase's wall-clock is the
host's time inside it unless the log was made with a ``sync`` callable
(the matcher's ``sync_timing`` passes ``torch.cuda.synchronize``), which
is then called as each phase ends.  Each phase is also a
``torch.profiler`` range ``mods.<phase>``, which costs nothing unless a
profiler is recording (``chip_smoke.py``'s profile phase reads them).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable

from torch.profiler import record_function

PHASES = ("SynthTime", "DetectTime", "OrientTime", "DescTime", "SCVTime",
          "MatchingTime", "RANSACTime", "MiscTime", "TotalTime")


@dataclass
class TimeLog:
    times: dict = field(default_factory=lambda: {p: 0.0 for p in PHASES})
    sync: Callable[[], None] | None = None

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with record_function("mods." + name):
                yield
                if self.sync is not None:
                    self.sync()
        finally:
            self.times[name] += time.perf_counter() - t0

    def add(self, name: str, dt: float):
        self.times[name] += dt

    def finalize(self):
        known = sum(v for k, v in self.times.items()
                    if k not in ("TotalTime", "MiscTime"))
        if self.times["TotalTime"] == 0.0:
            self.times["TotalTime"] = known + self.times["MiscTime"]
        else:
            self.times["MiscTime"] = max(
                0.0, self.times["TotalTime"] - known)
        return self

    def summary(self) -> str:
        t = self.times
        total = max(t["TotalTime"], 1e-9)
        lines = ["Timings: (sec/%)"]
        for p in PHASES:
            lines.append(f"{p[:-4]}: {t[p]:.3f} ({100.0 * t[p] / total:.1f}%)")
        return "\n".join(lines)

    def write(self, path: str) -> None:
        """Two-line time log: names then seconds (WriteTimeLog,
        io_mods.cpp:69-102)."""
        t = self.times
        with open(path, "w") as f:
            f.write(" ".join(p[:-4] for p in PHASES) + "\n")
            f.write(" ".join(f"{t[p]:.4f}" for p in PHASES) + "\n")


@dataclass
class RunLog:
    """Per-run quality log: the reference ``logs`` struct
    (configuration.hpp:137-203), one line a run as WriteLog writes it
    (io_mods.cpp:10-68)."""
    tentatives: int = 0
    true_matches: int = 0
    inlier_ratio: float = 0.0
    regions1: int = 0
    regions2: int = 0
    steps: int = 0
    total_time: float = 0.0
    ver_type: str = "LORANSACH"
    final_step: int = 0

    HEADER = ("Tentatives TrueMatches InlierRatio Regions1 Regions2 "
              "Steps TotalTime VerType")

    def line(self) -> str:
        return (f"{self.tentatives} {self.true_matches} "
                f"{self.inlier_ratio:.4f} {self.regions1} {self.regions2} "
                f"{self.steps} {self.total_time:.3f} {self.ver_type}")

    def write(self, path: str, append: bool = False) -> None:
        mode = "a" if append else "w"
        with open(path, mode) as f:
            if not append:
                f.write(self.HEADER + "\n")
            f.write(self.line() + "\n")
