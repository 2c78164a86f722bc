"""Host-clock median ms of the single session's calls that neither inserted
a keyframe nor merged a backend result, outside the traced slice."""

import statistics


def read(record):
    if record["session"] != "single":
        return None
    ms = [c["ms"] for c in record["calls"] if c["kind"] == "tracked" and not c["traced"]]
    return statistics.median(ms) if ms else None
