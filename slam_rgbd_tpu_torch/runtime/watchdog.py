"""Watchdog and bounded-time shutdown.

Counterpart of `slam_rgbd_tpu/runtime/watchdog.py`, the port's own copy:
  * `Watchdog` polls a heartbeat every `period_s` (100 ms by default) and
    calls `on_stall` once a stall when no frame completed within
    `stall_timeout_s`;
  * `GracefulShutdown.request` gives workers `timeout_s` to finish, then
    logs an ERROR and calls `on_force` (the embedder decides what forcing
    means).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

log = logging.getLogger("slam_rgbd_tpu_torch.watchdog")


class Watchdog:
    def __init__(
        self,
        heartbeat_fn: Callable[[], float],
        stall_timeout_s: float = 5.0,
        period_s: float = 0.1,
        on_stall: Optional[Callable[[float], None]] = None,
    ):
        self._heartbeat_fn = heartbeat_fn
        self.stall_timeout_s = stall_timeout_s
        self.period_s = period_s
        self.on_stall = on_stall
        self.stalls = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stalled_since: Optional[float] = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True, name="slam-watchdog")
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.period_s):
            age = time.monotonic() - self._heartbeat_fn()
            if age > self.stall_timeout_s:
                if self._stalled_since is None:
                    self._stalled_since = time.monotonic()
                    self.stalls += 1
                    log.warning("watchdog: worker stalled (%.1fs since heartbeat)", age)
                    if self.on_stall:
                        self.on_stall(age)
            else:
                self._stalled_since = None

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)


class GracefulShutdown:
    """Bounded-time shutdown: drain workers, then force."""

    def __init__(self, timeout_s: float = 10.0, on_force: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.on_force = on_force
        self.requested = threading.Event()
        self.forced = False

    def request(self, workers: list[threading.Thread]):
        """Signal shutdown and join workers with a global deadline."""
        self.requested.set()
        deadline = time.monotonic() + self.timeout_s
        for t in workers:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            t.join(timeout=remaining)
        stuck = [t for t in workers if t.is_alive()]
        if stuck:
            self.forced = True
            log.error("graceful shutdown timed out; %d workers stuck: %s",
                      len(stuck), [t.name for t in stuck])
            if self.on_force:
                self.on_force()
        return not stuck
