"""Input-stream fault injection for robustness tests.

Counterpart of `slam_rgbd_tpu/io/faults.py`, the port's own copy.
`FaultInjector` wraps any loader-protocol source (`TUMSequence`,
`ICLNUIMSequence`, `SyntheticSequence`, a stream reader) and yields the same
`(ts, depth_u16, rgb_u8)` host tuples with a deterministic schedule of faults
applied: dropped, blacked-out, partly zeroed, frozen and noisy frames, the
noise drawn from `numpy.random.default_rng(spec.seed)` in the reference's
order, so the same seed gives the same frames.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class FaultSpec:
    """Deterministic fault schedule (all indices are source frame indices)."""

    # Drop (skip) these frames entirely — the mq-full / frame-drop case
    # (reference bounds queues at depth 10 and drops SLAM input >10 -> 5,
    # `SLAM.cpp:162-168`).
    drop_frames: tuple = ()
    # All-zero depth (sensor read failure / IR blackout) on these frames —
    # the consecutive-error path (`sensorModule.c:216-239`).
    blackout_frames: tuple = ()
    # Zero a rectangular block of depth on these frames (partial dropout).
    corrupt_frames: tuple = ()
    corrupt_block: tuple = (0.25, 0.25, 0.5, 0.5)  # (v0, u0, h, w) fractions
    # Additive zero-mean depth noise (millimetres, std) on every frame.
    noise_mm: float = 0.0
    # Repeat the previous frame (stuck sensor) on these frames.
    freeze_frames: tuple = ()
    seed: int = 0


@dataclass
class FaultReport:
    dropped: int = 0
    blacked_out: int = 0
    corrupted: int = 0
    frozen: int = 0
    noised: int = 0
    log: list = field(default_factory=list)


class FaultInjector:
    """Iterable wrapper applying a `FaultSpec` to a frame source."""

    def __init__(self, source, spec: FaultSpec):
        self.source = source
        self.spec = spec
        self.report = FaultReport()
        self._rng = np.random.default_rng(spec.seed)

    def __len__(self):
        return len(self.source) - len(self.spec.drop_frames)

    def __iter__(self):
        prev = None
        for i, (ts, depth, rgb) in enumerate(iter(self.source)):
            s = self.spec
            if i in s.drop_frames:
                self.report.dropped += 1
                self.report.log.append((i, "drop"))
                continue
            depth = np.asarray(depth).copy()
            rgb = np.asarray(rgb)
            if i in s.freeze_frames and prev is not None:
                self.report.frozen += 1
                self.report.log.append((i, "freeze"))
                yield (ts,) + prev
                continue
            if i in s.blackout_frames:
                depth[:] = 0
                self.report.blacked_out += 1
                self.report.log.append((i, "blackout"))
            elif i in s.corrupt_frames:
                h, w = depth.shape
                v0, u0, bh, bw = s.corrupt_block
                depth[
                    int(v0 * h) : int((v0 + bh) * h),
                    int(u0 * w) : int((u0 + bw) * w),
                ] = 0
                self.report.corrupted += 1
                self.report.log.append((i, "corrupt"))
            if s.noise_mm > 0:
                valid = depth > 0
                noise = self._rng.normal(0.0, s.noise_mm, size=depth.shape)
                noisy = depth.astype(np.float64) + noise
                depth = np.where(
                    valid, np.clip(np.round(noisy), 1, 65535), 0
                ).astype(np.uint16)
                self.report.noised += 1
            prev = (depth, rgb)
            yield ts, depth, rgb

    def groundtruth(self):
        gt = getattr(self.source, "groundtruth", lambda: None)()
        if gt is None:
            return None
        keep = [
            i for i in range(len(self.source)) if i not in self.spec.drop_frames
        ]
        return gt[keep]
