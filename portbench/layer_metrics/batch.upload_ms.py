"""Median host ms of the program's `batch.upload` span: `BatchSession`'s
host widening and copy of a step's frames; spans outside the traced
slice."""

from portbench.harness.bench import span_median_ms


def read(record):
    return span_median_ms(record, "batch.upload")
