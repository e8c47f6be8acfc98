"""The host's wait on the card's segments (`SegmentedResult.scan_s`),
ms over the window's frames."""

from slambench.readers import job_sum


def read(rec):
    return job_sum(rec, "scan_s", 1e3)
