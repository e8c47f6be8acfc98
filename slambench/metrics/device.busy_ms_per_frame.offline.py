"""Union of the device intervals of the traced sub-window (offline), ms
over its frames."""

from slambench.readers import busy_ms_per_frame


def read(rec):
    return busy_ms_per_frame(rec)
