"""A profiled sub-window: `torch.profiler` over a bounded stretch of the
run, reduced in memory to what the per-layer readers and the breakdown
need. No trace file is written.

Busy time is the union of the intervals in which an operation ran on
the card (kernels, copies, fills); the host's ranges (the port's
`record_function` spans and the benchmark's own) name the idle gaps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from slambench import stats

_WINDOW = "slambench.subwindow"


@dataclass
class Trace:
    window_s: float  # the sub-window on the host's clock
    frames: int  # frames handed to the entry inside it
    busy_s: float = 0.0  # union of device intervals
    device_s_by_name: dict = field(default_factory=dict)  # name -> seconds (sum)
    launches_by_name: dict = field(default_factory=dict)  # name -> count
    idle_gaps: list = field(default_factory=list)  # [(host range, seconds)] summed, longest first
    n_events: int = 0


def profile(fn, frames: int) -> tuple:
    """Run `fn()` under the profiler, synchronised at both ends; returns
    (fn's result, Trace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.profiler.record_function(_WINDOW):
            out = fn()
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    tr = Trace(window_s=window_s, frames=frames)
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue
            tr.n_events += 1
            name = e.name()
            dev.append((s, s + d))
            tr.device_s_by_name[name] = tr.device_s_by_name.get(name, 0.0) + d * 1e-9
            tr.launches_by_name[name] = tr.launches_by_name.get(name, 0) + 1
        elif e.is_user_annotation() and d > 0:
            host.append((s, s + d, e.name()))
    span = [(s, e) for s, e, n in host if n == _WINDOW]
    if not span or not dev:
        return out, tr
    lo, hi = span[0]
    dev = [(max(a, lo), min(b, hi)) for a, b in dev if b > lo and a < hi]
    tr.busy_s = stats.union_length(dev) * 1e-9
    tr.idle_gaps = _name_gaps(stats.gaps(dev, lo, hi), [h for h in host if h[2] != _WINDOW])
    return out, tr


def _name_gaps(gaps, host, named: int = 2000) -> list:
    """Sum the idle gaps by the innermost host range open at each gap's
    middle ("host" where none is). The `named` longest gaps are named;
    the rest, each shorter than those, are summed as "short gaps"."""
    host = sorted(host)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    out: dict = {}
    for a, b in gaps[:named]:
        mid = (a + b) / 2
        name, width = "host", None
        for s, e, n in host:
            if s > mid:
                break
            if e >= mid and (width is None or e - s < width):
                name, width = n, e - s
        out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    rest = sum(b - a for a, b in gaps[named:])
    if rest:
        out["short gaps"] = out.get("short gaps", 0.0) + rest * 1e-9
    return sorted(out.items(), key=lambda kv: -kv[1])


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time and the longest idle
    stretches by host range, at most 10 each, in seconds."""
    top = sorted(tr.device_s_by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n[:120], s] for n, s in tr.idle_gaps[:10]]}
