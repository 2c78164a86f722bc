"""Median host ms of the program's `session.insert.features` span: a
keyframe's ORB feature stage in `SLAMSession` (on a card the feature
graph's copy-in, replay and clones); spans outside the traced slice."""

from portbench.harness.bench import span_median_ms


def read(record):
    return span_median_ms(record, "session.insert.features")
