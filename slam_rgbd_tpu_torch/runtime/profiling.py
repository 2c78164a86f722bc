"""Stage timing, structured metrics and a device trace.

Counterpart of `slam_rgbd_tpu/runtime/profiling.py:30-127`:

  * `StageTimer`: named host-side sections with count / mean / EMA / min /
    max summaries;
  * `MetricsLog`: JSON-lines records (`frame_window` from the session,
    `backend` from its merges, `queue` from the pipeline runner), in memory
    and optionally to a file;
  * `device_trace`: a `torch.profiler` trace of the block (host and CUDA
    activity), written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from dataclasses import dataclass


@dataclass
class StageStats:
    count: int = 0
    total_s: float = 0.0
    ema_s: float = 0.0
    min_s: float = math.inf
    max_s: float = 0.0

    def add(self, dt: float, ema_alpha: float = 0.1):
        self.count += 1
        self.total_s += dt
        self.ema_s = dt if self.count == 1 else (
            ema_alpha * dt + (1 - ema_alpha) * self.ema_s
        )
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


class StageTimer:
    """Named section timing: `with timer.section("track"): ...`."""

    def __init__(self):
        self.stages: dict[str, StageStats] = {}

    def add(self, name: str, seconds: float):
        """Record a duration measured elsewhere under `name`."""
        self.stages.setdefault(name, StageStats()).add(seconds)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages.setdefault(name, StageStats()).add(
                time.perf_counter() - t0
            )

    def report(self) -> dict:
        """{stage: {count, mean_ms, ema_ms, min_ms, max_ms}}."""
        return {
            k: {
                "count": s.count,
                "mean_ms": round(s.mean_s * 1e3, 3),
                "ema_ms": round(s.ema_s * 1e3, 3),
                "min_ms": round(s.min_s * 1e3, 3),
                "max_ms": round(s.max_s * 1e3, 3),
            }
            for k, s in self.stages.items()
        }

    def summary(self) -> str:
        rows = [
            f"{k:<16} n={v['count']:<6} mean={v['mean_ms']:>8.3f}ms "
            f"ema={v['ema_ms']:>8.3f}ms max={v['max_ms']:>8.3f}ms"
            for k, v in self.report().items()
        ]
        return "\n".join(rows)


class MetricsLog:
    """Structured JSON-lines metrics sink (file or in-memory)."""

    def __init__(self, path: str | None = None):
        self.path = path
        self.records: list[dict] = []
        self._fh = open(path, "a") if path else None

    def log(self, kind: str, **fields):
        rec = {"t": time.time(), "kind": kind, **fields}
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def by_kind(self, kind: str) -> list[dict]:
        return [r for r in self.records if r["kind"] == kind]


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A `torch.profiler` trace of everything inside the block (host
    operations, and CUDA kernels and copies when a card is present), written
    to `log_dir/trace.json` in the Chrome trace format. Yields the profiler,
    whose `key_averages()` sums the events by name."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
