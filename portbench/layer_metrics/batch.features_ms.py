"""Median host ms of the program's `batch.features` span: `BatchSession`'s
feature stage of a step's inserts, over every stream it serves; spans
outside the traced slice."""

from portbench.harness.bench import span_median_ms


def read(record):
    return span_median_ms(record, "batch.features")
