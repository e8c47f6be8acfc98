"""The common record of one run, which every metric reader works from."""

from __future__ import annotations

from dataclasses import dataclass, field

from slambench.trace import Trace


@dataclass
class Job:
    """One offline job: a fresh map over the configuration's frames."""
    frames: int  # frames handed to `track_sequence_segmented`
    wall_s: float
    scan_s: float  # the host's wait on the card's segments (`SegmentedResult.scan_s`)
    corrections: int
    loop_events: int
    keyframes: int  # keyframes ever inserted (`kf_pose_at_insert`)
    lost: int


@dataclass
class Record:
    cell: str
    mode: str  # "offline" or "live"
    setup_s: float = 0.0
    window_s: float = 0.0  # the measured window on the host's clock
    frames: int = 0  # frames handed to the entry inside the window
    failed: int = 0  # of those, returned LOST or raised
    jobs: list = field(default_factory=list)  # [Job] (offline)
    frame_ms: list = field(default_factory=list)  # hand-in to pose, each frame (live)
    # Stage totals of the port's `Tracker.metrics` over the window (live):
    # name -> (count, seconds).
    stages: dict = field(default_factory=dict)
    shapes: dict = field(default_factory=dict)  # op -> {call shape} (set-up's captures)
    trace: Trace | None = None  # the profiled sub-window (--trace 1)
    trace_failed: int = 0  # its frames returned LOST or raised
    power_limit: str = ""  # the card's, as nvidia-smi gives it
    notes: list = field(default_factory=list)  # lines the readers leave for standard error
