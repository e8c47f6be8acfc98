"""Loop closing through the port alone: no false loop on an open arc
(`tests/test_loop_e2e.py::test_no_false_loops_without_revisit` through
the port), and `Tracker.process` with the default loop settings, which
calls `LoopCloser.on_keyframe` on every inserted keyframe in a
`loop_closing` stage."""

import dataclasses

import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import SyntheticSequence
from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker
from test_loop_e2e import _circle_poses
from test_torch_loop import N_KF, e2e_config, render_all, run_port

N_FRAMES = 12


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def test_no_false_loops_without_revisit():
    poses = _circle_poses(2 * N_KF)[:N_KF]  # an open arc
    closed_at, _, state, lc = run_port(e2e_config(tconfig), poses,
                                       render_all(poses, tconfig.SlamConfig().camera))
    assert closed_at == [], f"false loop(s) at {closed_at}"
    assert int(state.n_kfs) == N_KF and not lc.loops


def qvga_loop_config():
    """The QVGA config of the port's tracker tests, with the default
    `LoopConfig` (loop closing and relocalization on, trained vocabulary)."""
    base = tconfig.SlamConfig()
    return tconfig.SlamConfig(
        camera=tconfig.CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=123.8, width=320,
                                    height=240, th_depth=80.0),
        orb=tconfig.OrbConfig(n_features=500, max_keypoints=512),
        tracking=dataclasses.replace(base.tracking, max_frames_between_kfs=2,
                                     local_map_candidates=1024),
        map=dataclasses.replace(base.map, max_keyframes=32, max_map_points=4096,
                                local_ba_window=4, local_ba_fixed_anchors=2,
                                triangulation_neighbors=2, fuse_neighbors=2),
    )


def test_tracker_runs_the_loop_closing_stage():
    assert Tracker(tconfig.SlamConfig(), device="cpu").loop_closer.vocab is not None
    cfg = qvga_loop_config()
    assert cfg.loop == tconfig.LoopConfig()
    # The first frames of phase 7c's sequence in `chip_smoke.py`, at QVGA.
    seq = SyntheticSequence(n_frames=90, cam=cfg.camera, trajectory="loop", loop_laps=1.35,
                            depth_noise=0.02)
    tr = Tracker(cfg, device="cpu")
    for i in range(N_FRAMES):
        tr.process(*seq.gray_depth(i), float(seq.stamps[i]))
    n_kf = tr.metrics.counters.get("keyframes", 0)
    assert n_kf >= 3, n_kf
    # Once per keyframe after the first (the first enters the database at
    # initialisation); no loop to close this early.
    assert tr.metrics.stages["loop_closing"].count == n_kf
    assert tr.n_loops_closed == 0 and "loops_closed" not in tr.metrics.counters
    assert tr.status == "OK"
    db = tr.loop_closer.database_to_numpy()["word_db"]
    live = tr.state.kfs.valid.numpy()
    assert (db[live] >= 0).any(axis=1).all()  # every live keyframe is in the database
    assert np.isfinite(tr.camera_positions()).all()
