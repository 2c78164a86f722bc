"""Median host ms of the program's `session.insert.map` span: a keyframe's
`_kf_insert` in `SLAMSession`: K3 association, insert and cull; spans
outside the traced slice."""

from portbench.harness.bench import span_median_ms


def read(record):
    return span_median_ms(record, "session.insert.map")
