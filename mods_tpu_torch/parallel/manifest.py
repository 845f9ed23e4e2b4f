"""Batch-run checkpoint/retry for one-vs-many matching (mirrors
``mods_tpu/parallel/manifest.py``; SURVEY.md §5.3).

The reference has no failure recovery: a mid-run crash of mods_multi
re-runs the whole gallery (mods_multi.cpp ignores prior results).  The
gallery run carries a manifest: per gallery image the verdict
(matches/tentatives/steps) once computed, written atomically after every
completed shard.  A rerun with the same manifest skips done images and
only executes pending ones; transient device errors retry with
exponential backoff before the image is marked failed.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from dataclasses import dataclass, field


@dataclass
class RunManifest:
    """Per-gallery-image done/pending state, persisted as JSON."""
    path: str
    query: str = ""
    done: dict = field(default_factory=dict)   # img path -> result dict

    @classmethod
    def load(cls, path: str, query: str) -> "RunManifest":
        if os.path.exists(path):
            with open(path) as f:
                data = json.load(f)
            if data.get("query") not in ("", query):
                # a manifest for a different query must not suppress work
                return cls(path=path, query=query)
            return cls(path=path, query=query,
                       done=data.get("done", {}))
        return cls(path=path, query=query)

    def pending(self, paths: list[str]) -> list[str]:
        return [p for p in paths if p not in self.done]

    def record(self, img_path: str, n_matches: int, n_tentatives: int,
               steps: int, error: str = "") -> None:
        self.done[img_path] = dict(
            n_matches=int(n_matches), n_tentatives=int(n_tentatives),
            steps=int(steps), error=error)

    def result(self, img_path: str) -> dict | None:
        return self.done.get(img_path)

    def save(self) -> None:
        """Atomic write (tmp + rename): a crash mid-save never corrupts
        the manifest."""
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".manifest.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"query": self.query, "done": self.done}, f,
                          indent=1)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise


def with_retries(fn, retries: int = 2, base_delay: float = 1.0,
                 transient=("INTERNAL", "UNAVAILABLE", "DEADLINE",
                            "RESOURCE_EXHAUSTED")):
    """Run fn(); retry on transient device errors.  CUDA errors reach
    Python as ``RuntimeError`` from torch; only those whose message
    carries a transient marker are retried."""
    last = None
    for attempt in range(retries + 1):
        try:
            return fn()
        except RuntimeError as e:
            last = e
            if not any(t in str(e) for t in transient) \
                    or attempt == retries:
                raise
            time.sleep(base_delay * (2 ** attempt))
    raise last
