"""Median host ms of the program's `session.wait` span: the host waiting
for the previous frame's summary (`event.synchronize`) in
`SLAMSession`'s decisions; spans outside the traced slice."""

from portbench.harness.bench import span_median_ms


def read(record):
    return span_median_ms(record, "session.wait")
