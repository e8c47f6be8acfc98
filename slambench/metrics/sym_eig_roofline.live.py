"""`sym_eig`'s share of its roofline in the traced sub-window (live):
the least time of its calls, from their shapes, over its kernel's
device time."""

from slambench import roofline
from slambench.readers import roofline_pct

KERNELS = ("sym_eig_kernel",)
# One launch of this kernel a call.
COUNT = "sym_eig_kernel"


def read(rec):
    return roofline_pct(rec, "sym_eig", KERNELS, COUNT, lambda s: roofline.sym_eig_work(*s))
