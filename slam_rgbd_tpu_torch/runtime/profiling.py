"""Spans, structured metrics, and the card's peaks and timings.

Counterpart of `slam_rgbd_tpu/runtime/profiling.py:30-127`:

  * `StageTimer`: the span recorder. `with timer.section("session.insert"):`
    marks a stage. Given a `MetricsLog` made with `spans=True`, it keeps
    every span as a `Span` in the sink's `spans` list: its host clock
    (`time.perf_counter`) ends, its thread, its parent (the innermost
    section open on that thread when it opened) and its call id (the frame
    that made the work; a nested section inherits its parent's); `report`
    sums them by name as the reference's count / mean / EMA / min / max.
    While a `torch.profiler` profile records on the thread, a section is
    also a host range of its name, so the span lies in the same timeline
    as the device's kernels and copies. The range is a plain host
    operation (`_RecordFunctionFast`), not a user annotation: the profiler
    mirrors a user annotation onto the device as an event spanning its
    kernels, which a trace's reader would count as device work. With
    neither, a section is a shared context that does nothing;
  * `MetricsLog`: JSON-lines records (`frame_window` from the session,
    `backend` from its merges, `queue` from the pipeline runner), in memory
    and optionally to a file, and the spans above when asked for.

and the card's side of `slam_rgbd_tpu/runtime/profiling.py:162-229`
(`tpu_generation`, `roofline`, `speed_of_light`): the card's published
peaks by name (`card_peaks`), its name and power limit (`card_and_power`),
`roofline` against those peaks, and the two timings that `benchmarks` and
`chip_smoke.py` share: `device_ms` (CUDA events, the host's queueing held
off by a spin kernel) and `host_ms` (host clock around synchronised calls).
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple

import torch


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


class Span(NamedTuple):
    """One recorded section: host clock (`time.perf_counter`) seconds."""

    name: str
    start: float
    end: float
    thread: int  # the OS thread id (`threading.get_native_id`)
    parent: str | None  # the enclosing section on that thread
    call: int  # the frame that made the work; -1 if none was given


_NO_SECTION = contextlib.nullcontext()


class _Section:
    __slots__ = ("timer", "name", "call", "parent", "start", "_range", "_open")

    def __init__(self, timer: "StageTimer", name: str, call: int | None):
        self.timer, self.name, self.call = timer, name, call
        self.parent = None

    def __enter__(self):
        # the thread's open sections matter only to a kept span
        self._open = None if self.timer._kept is None else self.timer._thread()
        if self._open is not None:
            st = self._open.stack
            if st:
                self.parent = st[-1].name
                if self.call is None:
                    self.call = st[-1].call
            st.append(self)
        if self.call is None:
            self.call = -1
        self._range = None
        if torch.autograd._profiler_enabled():  # a profile records this thread
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(None, None, None)
        if self._open is not None:
            self._open.stack.pop()
            # (one list.append: safe from any thread)
            self.timer._kept.append(Span(self.name, self.start, end,
                                         self._open.tid, self.parent, self.call))
        return False


class StageTimer:
    """The span recorder: `with timer.section("track"): ...`; `sink`: a
    `MetricsLog` whose `spans` list, if it has one, keeps every span. Safe
    to record from more than one thread."""

    def __init__(self, sink: "MetricsLog | None" = None):
        self.sink = sink
        self._kept: list | None = None if sink is None else sink.spans
        # .stack: this thread's open sections, innermost last; .tid
        self._local = threading.local()

    def _thread(self):
        """This thread's record: its open sections and its OS thread id."""
        local = self._local
        if not hasattr(local, "stack"):
            local.stack, local.tid = [], threading.get_native_id()
        return local

    def section(self, name: str, call: int | None = None):
        """A context manager marking its block as the span `name`; `call`
        defaults to the enclosing section's call id. Kept spans and a
        recording profiler aside, it does nothing."""
        if self._kept is None and not torch.autograd._profiler_enabled():
            return _NO_SECTION
        return _Section(self, name, call)

    def span(self, name: str, start: float, end: float, call: int = -1):
        """Keep a span whose ends were read elsewhere (`time.perf_counter`),
        such as one that starts on one thread and ends on another: it has
        no parent and is not in the profiler's timeline."""
        if self._kept is not None:
            self._kept.append(Span(name, start, end, self._thread().tid, None, call))

    def report(self) -> dict:
        """{stage: {count, mean_ms, ema_ms, min_ms, max_ms}} over the kept
        spans, in the order they closed."""
        stages: dict[str, StageStats] = {}
        for s in self._kept or ():
            stages.setdefault(s.name, StageStats()).add(s.end - s.start)
        return {
            k: {
                "count": s.count,
                "mean_ms": round(s.mean_s * 1e3, 3),
                "ema_ms": round(s.ema_s * 1e3, 3),
                "min_ms": round(s.min_s * 1e3, 3),
                "max_ms": round(s.max_s * 1e3, 3),
            }
            for k, s in stages.items()
        }


class MetricsLog:
    """Structured JSON-lines metrics sink (file or in-memory). With
    `spans=True`, a `StageTimer` given this sink keeps its spans in the
    in-memory `spans` list (a few entries a frame); otherwise `spans` is
    None."""

    def __init__(self, path: str | None = None, spans: bool = False):
        self.path = path
        self.records: list[dict] = []
        self.spans: list[Span] | None = [] if spans else None
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


# ---------------------------------------------------------------- the card
# Published peaks (NVIDIA's data sheet, dense rates) by the name
# `torch.cuda.get_device_name` gives: device memory bytes/s, float32
# operations/s outside the tensor cores, int8 operations/s in the tensor
# cores. The rates assume the card's full power limit (700 W for the SXM
# part); `card_and_power` reads the limit the card is set to.
CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_s": 3.35e12, "f32_s": 67e12, "int8_s": 1979e12},
}


def card_peaks(name: str | None) -> dict | None:
    """The peaks of the card named `name`; None for a card the table lacks."""
    return CARD_PEAKS.get(name) if name else None


def card_and_power() -> str:
    """The card's name and power limit, one line of `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` (the first card's);
    raises if nvidia-smi fails."""
    import subprocess

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def sol_s(n_bytes: float, f32_ops: float = 0.0, int8_ops: float = 0.0,
          card: str | None = None) -> tuple[float, str] | None:
    """(seconds, binding term): the least time the card could take for the
    work, the largest of `n_bytes` (each input read once, each output
    written once) over the memory rate, `f32_ops` over the float32 rate and
    `int8_ops` over the tensor cores' int8 rate. The two kinds of operation
    run on separate units that overlap, so their times do not add. The term
    is "bytes", "f32" or "int8". `card`: a name of `CARD_PEAKS` (default:
    the current CUDA device's); None for a card the table lacks."""
    if card is None and torch.cuda.is_available():
        card = torch.cuda.get_device_name()
    peaks = card_peaks(card)
    if peaks is None:
        return None
    terms = {"bytes": n_bytes / peaks["bytes_s"], "f32": f32_ops / peaks["f32_s"],
             "int8": int8_ops / peaks["int8_s"]}
    term = max(terms, key=terms.get)  # the first of equals: bytes before operations
    return terms[term], term


def roofline(n_bytes: float, measured_s: float, f32_ops: float = 0.0,
             int8_ops: float = 0.0, card: str | None = None) -> dict:
    """A call's time against `sol_s`, the least time the card could take
    for its work; `bound` names the binding term. `card`: a name of
    `CARD_PEAKS` (default: the current CUDA device's). For a card the table
    lacks, `sol_us`, `fraction` and `bound` are None: no other card's peaks
    stand in. The fraction is never capped: above 1 the measurement or the
    count of work is wrong."""
    if card is None and torch.cuda.is_available():
        card = torch.cuda.get_device_name()
    out = {
        "measured_us": measured_s * 1e6,
        "sol_us": None,
        "fraction": None,
        "bound": None,
        "achieved_gbps": n_bytes / measured_s / 1e9,
        "achieved_tops": (f32_ops + int8_ops) / measured_s / 1e12,
        "card": card,
    }
    sol = sol_s(n_bytes, f32_ops, int8_ops, card)
    if sol is not None:
        out.update(sol_us=sol[0] * 1e6, fraction=sol[0] / measured_s, bound=sol[1])
    return out


def device_ms(fn, n: int = 50) -> tuple[float, float]:
    """(median device ms of one `fn()` call over n calls, share of the
    timed span the device was busy), on the current CUDA device.

    A spin kernel holds the card while the host queues all n calls, so the
    event pairs bracket device work and not the host's launch overhead
    (which exceeds it for small calls). A pass in which the host took
    longer to queue them than the spin lasts is taken once more with a
    longer spin (a call of many operations fills the launch queue and waits
    for the spin to end whatever its length: its time is the host's). The
    busy share is the sum of the pairs over the span from the first to the
    last event: near 1 when the queue never ran dry."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    enqueue_s = time.perf_counter() - t0
    spin_s = 3.0 * enqueue_s + 1e-3
    for _ in range(2):
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(n)]
        t0 = time.perf_counter()
        torch.cuda._sleep(int(spin_s * 2.0e9))  # cycles; the clock is below 2 GHz
        for a, b in pairs:
            a.record()
            fn()
            b.record()
        queued_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        if queued_s < spin_s:
            break
        spin_s = 2.0 * queued_s  # the host fell behind the spin: again, longer
    times = [a.elapsed_time(b) for a, b in pairs]
    span = pairs[0][0].elapsed_time(pairs[-1][1])
    return statistics.median(times), sum(times) / span


def host_ms(fn, n: int = 5) -> float:
    """Median host-clock ms of one `fn()` call that ends synchronised (on
    the current CUDA device, where there is one): what a stage of many
    small device operations costs, launch overhead included."""
    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    fn()
    times = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)
