"""The card's published peaks and the least time of the tracker's GN work.

A frozen copy of the port's table (`runtime/profiling.py` `CARD_PEAKS`,
`sol_s`) and of its count of a GN launch's work (`benchmarks.gn_work`), so
that a change to the program cannot move the yardstick. Peaks: NVIDIA's
data sheet, SXM part, dense rates, at the full 700 W.
"""

from __future__ import annotations

CARD_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_s": 3.35e12, "f32_s": 67e12, "int8_s": 1979e12},
}

SRC_CHANNELS = 8
TGT_CHANNELS = 10


def gn_work(n_b: int, n_sets: int, n_px: int) -> tuple[float, float]:
    """(bytes, float32 operations) of one GN iteration over `n_b` problems
    on `n_sets` plane sets of `n_px` pixels: each plane set, pose and flow
    read once, 60 values a problem written (H, g, squared sum, inliers, the
    next pose); ~300 operations a pixel (projection, four-corner sampling
    of ten channels, two 7-vector outer products) and ~500 a problem for
    the pose update."""
    n_bytes = 4.0 * (n_sets * (SRC_CHANNELS + TGT_CHANNELS) * n_px + n_b * (18 + 60))
    return n_bytes, n_b * (300.0 * n_px + 500.0)


def sol_s(n_bytes: float, f32_ops: float, card: str) -> float | None:
    """The least time for the work on `card`: the larger of the bytes over
    the memory rate and the operations over the float32 rate. None for a
    card the table lacks."""
    peaks = CARD_PEAKS.get(card)
    if peaks is None:
        return None
    return max(n_bytes / peaks["bytes_s"], f32_ops / peaks["f32_s"])


def tracked_frame_gn_s(icp: dict, height: int, width: int, streams: int, card: str):
    """The least time of the GN work of one tracked frame (one step of
    `streams` sequences): at each level its configured iterations, the
    coarsest level's over its starts (`hypotheses` problems a sequence on
    that sequence's planes)."""
    levels = icp["levels"]
    iters = list(icp["iters"])
    hyp = min(max(icp["hypotheses"], 1), 3)
    total = 0.0
    for ci in range(levels):  # 0 = coarsest
        k = levels - 1 - ci
        n_px = (height >> k) * (width >> k)
        n_iter = iters[min(ci, len(iters) - 1)]
        n_b = streams * (hyp if ci == 0 else 1)
        s = sol_s(*gn_work(n_b, streams, n_px), card)
        if s is None:
            return None
        total += n_iter * s
    return total
