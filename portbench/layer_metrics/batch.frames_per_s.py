"""Sequence-frames a second of the batch session over its steps outside the
traced slice: the frames of those steps over the host-clock time inside
them. The steady-state rate of the fleet, without the new sessions between
recordings and the profiler's slice."""


def read(record):
    if record["session"] != "batch":
        return None
    ms = [c["ms"] for c in record["calls"] if not c["traced"]]
    if not ms or sum(ms) <= 0:
        return None
    return record["streams"] * len(ms) / (sum(ms) / 1e3)
