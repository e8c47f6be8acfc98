"""Structured metrics and per-stage timing.

The reference's only observability is cout/printf timing prints
(SURVEY.md §5: rgbd_tum median/mean track time rgbd_tum.cc:125-133,
MergeSG plane-segmentation prints MergeSG.cc:346-362). This module is
the engine-wide replacement: named stage timers with streaming
statistics, counters, and a JSON-lines emitter — cheap enough to stay
on in production.

On-device work is asynchronously dispatched, so a stage timer measures
HOST-VISIBLE latency; wrap the fetch (np.asarray of the result) inside
the stage to time completed device work. For kernel-level truth, use
utils.profiling (JAX profiler traces).
"""

from __future__ import annotations

import json
import math
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class StageStat:
    """Streaming timing statistics for one named stage."""

    count: int = 0
    total_s: float = 0.0
    min_s: float = math.inf
    max_s: float = 0.0
    _mean: float = 0.0
    _m2: float = 0.0  # Welford

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)
        d = dt - self._mean
        self._mean += d / self.count
        self._m2 += d * (dt - self._mean)

    @property
    def mean_s(self) -> float:
        return self._mean

    @property
    def std_s(self) -> float:
        return math.sqrt(self._m2 / self.count) if self.count > 1 else 0.0

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "total_ms": round(self.total_s * 1e3, 3),
            "mean_ms": round(self.mean_s * 1e3, 3),
            "std_ms": round(self.std_s * 1e3, 3),
            "min_ms": round((0.0 if self.count == 0 else self.min_s) * 1e3, 3),
            "max_ms": round(self.max_s * 1e3, 3),
        }


@dataclass
class Metrics:
    """Named stage timers + counters for one engine instance."""

    stages: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    enabled: bool = True

    @contextmanager
    def stage(self, name: str):
        """Time a stage: `with metrics.stage("track"): ...`"""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.setdefault(name, StageStat()).add(
                time.perf_counter() - t0
            )

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value) -> None:
        self.counters[name] = value

    # ---- reporting --------------------------------------------------------

    def summary(self) -> dict:
        return {
            "stages": {k: v.to_dict() for k, v in sorted(self.stages.items())},
            "counters": dict(sorted(self.counters.items())),
        }

    def dump_json(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.summary(), f, indent=2)

    def report(self) -> str:
        """Human-readable per-stage table."""
        lines = [f"{'stage':<28}{'count':>8}{'mean ms':>10}{'std':>8}{'max':>9}{'total s':>10}"]
        for k, v in sorted(self.stages.items(), key=lambda kv: -kv[1].total_s):
            lines.append(
                f"{k:<28}{v.count:>8}{v.mean_s*1e3:>10.2f}{v.std_s*1e3:>8.2f}"
                f"{v.max_s*1e3:>9.2f}{v.total_s:>10.2f}"
            )
        if self.counters:
            lines.append("counters: " + ", ".join(
                f"{k}={v}" for k, v in sorted(self.counters.items())
            ))
        return "\n".join(lines)


class JsonlLogger:
    """Append-only JSON-lines event log (one dict per line), the
    machine-readable replacement for the reference's console prints."""

    def __init__(self, path: str):
        self._f = open(path, "a", encoding="utf-8")

    def log(self, event: str, **fields) -> None:
        rec = {"t": time.time(), "event": event}
        rec.update(fields)
        self._f.write(json.dumps(rec) + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()
