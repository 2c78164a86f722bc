"""Share in % of the traced slice's wall time in which no kernel, copy or
fill ran on the card (1 minus the union of the busy intervals)."""


def read(record):
    t = record["trace"]
    if not t or t["window_s"] <= 0 or t["n_device_events"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
