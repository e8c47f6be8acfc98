"""B1's share of its roofline in the traced sub-window (live): the least
time of its calls, from their shapes, over the device time of its two
kernels."""

from slambench import roofline
from slambench.readers import roofline_pct

KERNELS = ("window_match_partial_kernel", "window_match_merge_kernel")
# One launch of this kernel a call.
COUNT = "window_match_partial_kernel"


def read(rec):
    return roofline_pct(rec, "window_match", KERNELS, COUNT,
                        lambda s: roofline.window_match_work(*s))
