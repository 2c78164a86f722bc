"""Median host ms of a backend pass on the worker thread: `backend_ms` of
the session's `MetricsLog` `backend` records (the traced run hands the
session a log)."""

import statistics


def read(record):
    ms = record["backend_ms"]
    return statistics.median(ms) if ms else None
