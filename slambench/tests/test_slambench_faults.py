"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (`run.execute`: the scene rendered,
the port's entry point, the answers judged by the reference) on the CPU
at a small size, once as the port is and once for each fault a cell can
have: a step that returns its state unchanged, half of the frames left
out, an answer altered where it is produced. The cells run on one chip,
so there is no exchange between chips to leave out. At this size the
limits are the cell's for rigidity and the test's own for the rest: a
slow QVGA circuit moves ~3 cm a frame, under what a stuck run reads on
the card's circuit (`PERF.md` gives those readings).
"""

import copy
import time

import numpy as np
import pytest
import torch

from orb_slam2_ssd_semantic_tpu_torch.tracking import segmented
from orb_slam2_ssd_semantic_tpu_torch.tracking import tracker as tk
from slambench import check, run, spec

LIMITS = {"ate_rmse_m": 0.05, "step_err_max_m": 0.1}


def small_cell(traffic: str) -> dict:
    """The static loop at QVGA, slowed to 0.85 degrees a frame: a job over
    17 frames, or a session over 40 frames forth and back."""
    cell = spec.load_cell(spec.benchmark(), "static_loop.offline")
    conf = copy.deepcopy(cell["config"])
    conf["slam"]["camera"] = dict(width=320, height=240, fx=267.7, fy=269.6, cx=160.05,
                                  cy=123.8)
    conf["scene"]["trajectory"].update(n_frames=17, laps=17 * 2.35 / 1000)
    conf["offline"].update(job_frames=17, segment_len=4)
    if traffic == "live_session":
        conf["scene"]["trajectory"].update(n_frames=40, laps=40 * 2.35 / 1000)
        t = dict(spec.load_cell(spec.benchmark(), "walking.live")["traffic"], warmup_max=30)
    else:
        t = dict(cell["traffic"], warmup_jobs=0, realizations=1)
    limits = dict(cell["limits"], **LIMITS)
    return dict(cell, config=conf, traffic=t, limits=limits)


def correct(cell: dict, seconds: float) -> bool:
    rec, answers, scene, _ = run.execute(cell, 2**31 + 11, seconds, False, torch.device("cpu"),
                                         time.perf_counter())
    ok, rows = check.decide(check.numbers(answers, scene), cell["limits"],
                            rec.frames, rec.failed)
    print(rows)
    return ok


def _offline_fault(kind: str):
    real = segmented.track_sequence_segmented

    def broken(*a, **k):
        res = real(*a, **k)
        T = np.array(res.T_all)
        if kind == "stuck":
            T[:] = T[0]
        elif kind == "half":
            T[1::2] = np.nan
        else:
            mid = len(T) // 2
            T[mid, :3, 3] -= T[mid, :3, :3] @ np.array([2.0, 0.0, 0.0], np.float32)
        return res._replace(T_all=T)

    return broken


def _live_fault(kind: str):
    real = tk.Tracker.process

    def broken(self, gray, depth, stamp, feats=None):
        T = real(self, gray, depth, stamp, feats)
        n = self.frame_id
        if kind == "stuck":
            if n == 1:
                self.first_answer = T
            return self.first_answer
        if kind == "half":
            return np.full((4, 4), np.nan, np.float32) if n % 2 else T
        if n == 33:  # after the warm-up (at most 30 frames here)
            T = T.copy()
            T[:3, 3] -= T[:3, :3] @ np.array([2.0, 0.0, 0.0], np.float32)
        return T

    return broken


@pytest.fixture(scope="module")
def offline_cell():
    return small_cell("offline_jobs")


def test_offline_sound_run_is_correct(offline_cell):
    assert correct(offline_cell, 0.1)


@pytest.mark.parametrize("kind", ["stuck", "half", "altered"])
def test_offline_fault_is_not_correct(offline_cell, kind, monkeypatch):
    monkeypatch.setattr(segmented, "track_sequence_segmented", _offline_fault(kind))
    assert not correct(offline_cell, 0.1)


@pytest.fixture(scope="module")
def live_cell():
    return small_cell("live_session")


@pytest.mark.parametrize("kind", [None, "stuck", "half", "altered"])
def test_live_run(live_cell, kind, monkeypatch):
    if kind is not None:
        monkeypatch.setattr(tk.Tracker, "process", _live_fault(kind))
    assert correct(live_cell, 8.0) == (kind is None)
