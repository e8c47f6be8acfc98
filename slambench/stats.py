"""The benchmark's arithmetic on what a run recorded: a tail over all
samples, and the union of device intervals and the gaps between them."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank `q`-th percentile (0 < q <= 100) over all values:
    the smallest value that at least q% of them do not exceed."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    return float(xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)])


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals, overlaps counted
    once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: float, end: float):
    """The (start, end) stretches of [start, end] that no interval covers."""
    out, t = [], start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]
