"""What the metric readers under `metrics/` share. Each returns None
where the record holds nothing to read, and the run then leaves the
metric out."""

from __future__ import annotations

from slambench import roofline, stats


def job_sum(rec, key: str, scale: float):
    """The jobs' `key` summed, times `scale`, over the window's frames."""
    if not rec.jobs or not rec.frames:
        return None
    return sum(getattr(j, key) for j in rec.jobs) * scale / rec.frames


def stage_mean_ms(rec, *names):
    """Mean ms a frame of the window in the port's stages `names`
    together (their totals summed, over the window's frames); None when
    none of them ran."""
    got = [rec.stages[n] for n in names if n in rec.stages and rec.stages[n][0]]
    if not got or not rec.frames:
        return None
    if len(names) == 1:
        count, total = got[0]
        return total * 1e3 / count
    return sum(total for _, total in got) * 1e3 / rec.frames


def idle_pct(rec):
    tr = rec.trace
    if tr is None or tr.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def busy_ms_per_frame(rec):
    tr = rec.trace
    if tr is None or tr.busy_s <= 0.0:
        return None
    return tr.busy_s * 1e3 / tr.frames


def roofline_pct(rec, op: str, kernels, count: str, work):
    """Least time of operation `op`'s calls in the traced sub-window over
    the device time of `kernels`, in %. `count` is the kernel of which
    each call launches one. Notes which of bytes and operations sets the
    bound, beside the card's power limit."""
    tr = rec.trace
    if tr is None:
        return None
    device_s = sum(s for name, s in tr.device_s_by_name.items() if any(k in name for k in kernels))
    calls = sum(n for name, n in tr.launches_by_name.items() if count in name)
    got = roofline.least_time(calls, rec.shapes.get(op, ()), work)
    if got is None or device_s <= 0.0:
        return None
    rec.notes.append(
        f"roofline {op}: {calls} calls, least {got['least_s'] * 1e3:.6f} ms, bound by "
        f"{got['bound_by']}, device {device_s * 1e3:.6f} ms; shapes recorded "
        f"{sorted(rec.shapes.get(op, ()))}; card power limit {rec.power_limit}")
    return 100.0 * got["least_s"] / device_s


def p95_ms(rec):
    return stats.percentile(rec.frame_ms, 95) if rec.frame_ms else None
