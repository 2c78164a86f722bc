"""The traced run's slice: `torch.profiler` over a fixed span of the window,
events kept in memory, reduced to the device's busy time (the union of the
intervals in which a kernel, copy or fill ran, so that the worker's stream
overlapping the main one is counted once), the slice's wall time, the
device time by kernel name, and the longest idle gaps labelled by the
innermost host operation open during each. The slice's start and end are
also kept on the window's clock (`slice_s`), so that spans can be told
apart by whether they overlap it."""

from __future__ import annotations

import time

import torch

SLICE = "portbench.slice"


def _ns(e, what: str) -> int:
    if hasattr(e, f"{what}_ns"):
        return int(getattr(e, f"{what}_ns")())
    return int(getattr(e, f"{what}_us")() * 1000)


class Tracer:
    """Starts the profiler at the first call after `after_s` seconds of the
    window and stops it after the first call that ends `span_s` later."""

    def __init__(self, after_s: float, span_s: float, device):
        self.after_s, self.span_s = after_s, span_s
        self.device = device
        self.state = "idle"
        self.prof = self.mark = None
        self.t_on = self.start_s = 0.0
        self.slice_s = None  # [start, end] on the window's clock
        self.summary = None
        self._prime()

    def _acts(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _prime(self) -> None:
        """Start and stop the profiler once before the window: its first
        start in a process sets up the device tracing, which on a card takes
        seconds."""
        with torch.profiler.profile(activities=self._acts()):
            torch.zeros(1, device=self.device).add_(1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def wants(self, t: float) -> bool:
        """Whether the call about to start at `t` seconds of the window is
        traced."""
        if self.state == "idle" and t >= self.after_s:
            called = time.perf_counter()
            self.prof = torch.profiler.profile(activities=self._acts())
            self.prof.start()
            self.mark = torch.profiler.record_function(SLICE)
            self.mark.__enter__()
            # the span counts from when the profiler runs: starting it can
            # take seconds
            self.t_on, self.state = time.perf_counter(), "on"
            self.start_s = self.t_on - called
            self.slice_s = [t + self.start_s, None]
        elif self.state == "on" and time.perf_counter() >= self.t_on + self.span_s:
            self._stop()
        return self.state == "on"

    def close(self) -> None:
        if self.state == "on":
            self._stop()

    def _stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        span_s = time.perf_counter() - self.t_on
        self.slice_s[1] = self.slice_s[0] + span_s
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.state = "done"
        t0 = time.perf_counter()
        self.summary = reduce(self.prof)
        self.summary.update(reduce_s=time.perf_counter() - t0, start_s=self.start_s,
                            host_span_s=span_s, slice_s=list(self.slice_s))
        self.prof = self.mark = None


def reduce(prof) -> dict:
    """The slice's numbers from the profiler's events."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    busy, host, by_name = [], [], {}
    lo = hi = None
    n_cpu = 0
    for e in events:
        start, dur = _ns(e, "start"), _ns(e, "duration")
        if e.device_type() == cuda and e.name() != SLICE:  # not the marker's device copy
            busy.append((start, start + dur))
            name = e.name()
            by_name[name] = by_name.get(name, 0) + dur
        else:
            name = e.name()
            if name == SLICE:
                if e.device_type() != cuda:
                    lo, hi = start, start + dur
            else:
                host.append((start, start + dur, name))
                n_cpu += 1
    if lo is None:  # no slice marker: the span of everything recorded
        lo = min([b[0] for b in busy] + [h[0] for h in host])
        hi = max([b[1] for b in busy] + [h[1] for h in host])
    busy.sort()
    merged = []
    for a, b in busy:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_ns = sum(b - a for a, b in merged)
    gaps = []
    prev = lo
    for a, b in merged:
        if a > prev:
            gaps.append((a - prev, prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((hi - prev, prev, hi))
    gaps.sort(reverse=True)
    labelled = []
    for length, a, b in gaps[:10]:
        mid = (a + b) // 2
        open_ops = [(e - s, n) for s, e, n in host if s <= mid <= e]
        labelled.append([min(open_ops)[1] if open_ops else "host (no operation)", length / 1e9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (hi - lo) / 1e9,
        "kernel_s": {k: v / 1e9 for k, v in by_name.items()},
        "device_ops": [[k, v / 1e9] for k, v in top],
        "idle_gaps": labelled,
        "n_device_events": len(busy),
        "n_host_events": n_cpu,
        "first_last_ns": [min([b[0] for b in busy] + [h[0] for h in host], default=0),
                          max([b[1] for b in busy] + [h[1] for h in host], default=0)],
    }
