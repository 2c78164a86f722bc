"""The one traffic generator: which rendered frame each stream reads at each
call, from a mix's parameters.

A mix file holds:
  * `frames`: frames rendered along the trajectory;
  * `span`, `stream_start`, `stream_phase`: stream b reads frame
    `stream_start * b + bounce(stream_phase * b + t, span)` at call t of a
    recording, where `bounce` runs back and forth over 0 .. span - 1,
    reversing at both ends, so every stream's motion stays continuous;
  * `recording_calls`: calls a recording lasts before the next one starts
    from a fresh state (positive);
  * `rooms`: rooms the trajectory is rendered in. The seed draws their
    order: a single stream's recordings go through them in turn, and in a
    batch stream b stays in one room (the b-th of the order, cyclically),
    so every step holds every room. A window holds whole rounds of them
    (`drive.py`);
  * `warm_calls`: calls of the mix that set-up runs before the window;
  * `trace_after_s`, `trace_s`: the traced slice, in seconds of the window;
  * `check_tracked`, `checks`: the output check's sample of tracked frames
    a recording, and the numbers it compares.

Every seed gets the same frames, in the same rooms, in the same number of
calls; the seed draws which room comes when. A frame's id is
`room * frames + frame`.
"""

from __future__ import annotations

import numpy as np


def bounce(x: np.ndarray, span: int) -> np.ndarray:
    """x folded back and forth over 0 .. span - 1."""
    if span <= 1:
        return np.zeros_like(x)
    period = 2 * (span - 1)
    r = np.mod(x, period)
    return np.where(r < span, r, period - r)


def schedule(mix: dict, streams: int, calls: int) -> np.ndarray:
    """(calls, streams) frame indices of the first `calls` calls of a
    recording."""
    t = np.arange(calls)[:, None]
    b = np.arange(streams)[None, :]
    frame = mix["stream_start"] * b + bounce(mix["stream_phase"] * b + t, mix["span"])
    if frame.max(initial=0) >= mix["frames"]:
        raise ValueError(f"the mix reads frame {frame.max()} of {mix['frames']} rendered")
    return frame


def recording_calls(mix: dict) -> int:
    """Calls of one recording."""
    n = int(mix["recording_calls"])
    if n <= 0:
        raise ValueError(f"recording_calls is {n}: a recording has to hold calls")
    return n


def period(mix: dict) -> int:
    """Calls after which the schedule repeats: 2 (span - 1)."""
    return max(2 * (int(mix["span"]) - 1), 1)


def room_order(mix: dict, seed: int) -> np.ndarray:
    """The seed's order of the mix's rooms."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x2004]))
    return rng.permutation(int(mix["rooms"]))
