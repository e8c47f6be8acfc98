"""The 95th percentile (nearest rank) over all of the window's frames of
the host time from hand-in to the returned pose."""

from slambench.readers import p95_ms


def read(rec):
    return p95_ms(rec)
