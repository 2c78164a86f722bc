"""Median host ms of the program's `batch.fetch` span: `BatchSession`'s one
read-back of a step's summary; spans outside the traced slice."""

from portbench.harness.bench import span_median_ms


def read(record):
    return span_median_ms(record, "batch.fetch")
