"""Host-clock median ms of the batch session's steps in which no stream
inserted a keyframe, outside the traced slice."""

import statistics


def read(record):
    if record["session"] != "batch":
        return None
    ms = [c["ms"] for c in record["calls"] if c["kind"] == "tracked" and not c["traced"]]
    return statistics.median(ms) if ms else None
