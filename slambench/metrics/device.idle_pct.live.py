"""Share of the traced sub-window (live) in which no operation ran on
the card: 100 less the union of the device intervals over its length."""

from slambench.readers import idle_pct


def read(rec):
    return idle_pct(rec)
