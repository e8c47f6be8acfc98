"""Profiler integration (counterpart of the JAX package's
`utils/profiling.py`).

`utils.metrics` supplies host-side stage timing; this module wraps the
device-level profiler: `torch.profiler` with CPU and CUDA activities,
written as a Chrome trace (`.json`) that Perfetto and `chrome://tracing`
open, plus annotation helpers that label engine stages inside the trace
timeline (and in an NVTX range when a card is present, the ranges the
port already uses for `dense.*` and `loop.*`).
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import torch

_ACTIVE: dict = {}


def start_trace(log_dir: str | None = None) -> str:
    """Begin a profiler trace (host events and, with a card, its kernels).
    `stop_trace` writes it to `<log_dir>/trace.json` (by default
    `slam_trace` in the temporary directory)."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "slam_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _ACTIVE.update(prof=prof, log_dir=log_dir)
    return log_dir


def stop_trace() -> str:
    """End the trace begun by `start_trace`; returns the trace file."""
    prof, log_dir = _ACTIVE.pop("prof"), _ACTIVE.pop("log_dir")
    prof.stop()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """`with profiling.trace(): run_frames()`: one bounded trace."""
    log_dir = start_trace(log_dir)
    try:
        yield log_dir
    finally:
        stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Label a host-side region in the trace timeline
    (`torch.profiler.record_function`, and an NVTX range on a card)."""
    nvtx = torch.cuda.nvtx.range(name) if torch.cuda.is_available() else contextlib.nullcontext()
    with torch.profiler.record_function(name), nvtx:
        yield


def device_memory_stats() -> dict:
    """Per-CUDA-device live and peak memory and the device's capacity;
    `{}` without a card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        _, total = torch.cuda.mem_get_info(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak"),
            "bytes_limit": total,
        }
    return out
