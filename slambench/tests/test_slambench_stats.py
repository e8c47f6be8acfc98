"""The benchmark's arithmetic on made-up values: the tail over all
frames, the union of device intervals, the idle gaps, the spread, the
roofline bound."""

import pytest

from slambench import readers, roofline, stats
from slambench.record import Job, Record
from slambench.trace import Trace, _name_gaps


def test_p95_is_over_all_frames_nearest_rank():
    xs = list(range(1, 101))  # 1..100 ms
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(reversed(xs), 95) == 95
    assert stats.percentile([5.0] * 19 + [500.0], 95) == 5.0
    assert stats.percentile([5.0] * 18 + [500.0, 600.0], 95) == 500.0
    rec = Record(cell="c", mode="live", frame_ms=[10.0] * 90 + [100.0] * 10)
    assert readers.p95_ms(rec) == 100.0
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_union_counts_overlaps_once():
    assert stats.union_length([]) == 0
    assert stats.union_length([(0, 10), (5, 15), (20, 30)]) == 25
    assert stats.union_length([(20, 30), (0, 10), (2, 3), (10, 12)]) == 22


def test_gaps_and_idle_share():
    iv = [(10, 20), (15, 30), (50, 60)]
    assert stats.gaps(iv, 0, 100) == [(0, 10), (30, 50), (60, 100)]
    tr = Trace(window_s=1.0, frames=10, busy_s=0.25)
    rec = Record(cell="c", mode="live", trace=tr)
    assert readers.idle_pct(rec) == pytest.approx(75.0)
    assert readers.busy_ms_per_frame(rec) == pytest.approx(25.0)
    assert readers.idle_pct(Record(cell="c", mode="live")) is None


def test_gaps_named_by_the_innermost_host_range():
    host = [(0, 100, "slambench.frame"), (10, 40, "track"), (60, 90, "local_mapping")]
    got = dict(_name_gaps([(20, 30), (70, 80), (95, 99)], host))
    assert got == {"track": pytest.approx(1e-8), "local_mapping": pytest.approx(1e-8),
                   "slambench.frame": pytest.approx(4e-9)}


def test_roofline_least_time_and_share():
    t, by = roofline.bound_s(*roofline.window_match_work(1024, 1536))
    assert by == "operations" and t == pytest.approx(8 * 1024 * 1536 / 67e12)
    t_eig, by_eig = roofline.bound_s(*roofline.sym_eig_work(128, 9))
    assert by_eig == "bytes"
    got = roofline.least_time(10, {(1024, 1024), (2048, 1024)}, lambda s:
                              roofline.window_match_work(*s))
    assert got["least_s"] == pytest.approx(10 * 8 * 1024 * 1024 / 67e12)
    assert roofline.least_time(0, {(1, 9)}, lambda s: roofline.sym_eig_work(*s)) is None
    tr = Trace(window_s=1.0, frames=1, device_s_by_name={"x_sym_eig_kernel<9>": 1e-3},
               launches_by_name={"x_sym_eig_kernel<9>": 4})
    rec = Record(cell="c", mode="live", trace=tr, shapes={"sym_eig": {(1, 9)}})
    pct = readers.roofline_pct(rec, "sym_eig", ("sym_eig_kernel",), "sym_eig_kernel",
                               lambda s: roofline.sym_eig_work(*s))
    assert pct == pytest.approx(100 * 4 * roofline.bound_s(*roofline.sym_eig_work(1, 9))[0] / 1e-3)
    assert rec.notes and "power limit" in rec.notes[0]


def test_job_readers_over_the_window():
    jobs = [Job(145, 10.0, 2.0, 0, 3, 20, 0), Job(145, 12.0, 3.0, 1, 4, 22, 0)]
    rec = Record(cell="c", mode="offline", jobs=jobs, frames=290, window_s=22.0)
    assert readers.job_sum(rec, "scan_s", 1e3) == pytest.approx(5000 / 290)
    assert readers.job_sum(rec, "keyframes", 100.0) == pytest.approx(4200 / 290)
    rec = Record(cell="c", mode="live", frames=4, stages={"track": (4, 0.08),
                                                          "mask.flow": (4, 0.012)})
    assert readers.stage_mean_ms(rec, "track") == pytest.approx(20.0)
    assert readers.stage_mean_ms(rec, "mask.flow", "mask.geometry") == pytest.approx(3.0)
    assert readers.stage_mean_ms(rec, "nothing") is None


def test_the_last_lines_keys():
    from slambench import run, spec

    cell = spec.load_cell(spec.benchmark(), "walking.live")
    tr = Trace(window_s=2.0, frames=36, busy_s=1.5, device_s_by_name={"k": 1.5},
               launches_by_name={"k": 3}, idle_gaps=[("track", 0.25)])
    rec = Record(cell="walking.live", mode="live", setup_s=30.0, window_s=51.0, frames=1300,
                 frame_ms=[30.0] * 1300, stages={"track": (1300, 26.0)}, trace=tr)
    rows = [("failed_frames", 0, 0), ("ate_rmse_m", float("inf"), 0.1)]
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
           "memory_peak_bytes": 1}
    out = run.result(rec, cell["per_layer"], False, 1336, 0, rows, dev)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "check"]
    assert out["device"]["busy_s"] == 1.5 and out["device"]["window_s"] == 2.0
    assert out["check"]["ate_rmse_m"] == {"value": "inf", "limit": 0.1}
    assert out["metrics"]["process.track_ms"] == {"value": pytest.approx(20.0), "unit": "ms"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    rec.trace = None
    out = run.result(rec, cell["end_to_end"], True, 1300, 0, rows[:1], dev)
    assert set(out["metrics"]) == {"live_fps", "frame_p95_ms", "setup_s"}
    assert "breakdown" not in out and list(out)[-1] == "check"
