"""Share in % of the backend jobs that the worker skipped (displaced by a
newer snapshot, or stale) out of those it skipped or completed, over the
window's recordings."""


def read(record):
    w = record["worker"]
    total = w["skipped"] + w["completed"]
    if record["session"] != "single" or total == 0:
        return None
    return 100.0 * w["skipped"] / total
