"""Median host ms of the program's `worker.queue` span: a backend job's
wait from `submit` to the start of its pass on the worker thread; spans
outside the traced slice."""

from portbench.harness.bench import span_median_ms


def read(record):
    return span_median_ms(record, "worker.queue")
