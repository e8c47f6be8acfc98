"""The port's stages `mask.flow` and `mask.geometry` together, ms a
frame of the window."""

from slambench.readers import stage_mean_ms


def read(rec):
    return stage_mean_ms(rec, "mask.flow", "mask.geometry")
