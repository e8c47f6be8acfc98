"""Mean of the port's stage `track` over the window's frames
(`Tracker.metrics`: copies in, the tracking graph's replay, the stats
fetch)."""

from slambench.readers import stage_mean_ms


def read(rec):
    return stage_mean_ms(rec, "track")
