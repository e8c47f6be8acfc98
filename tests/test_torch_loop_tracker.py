"""Loop closing through the port alone: no false loop on an open arc
(`tests/test_loop_e2e.py::test_no_false_loops_without_revisit` through
the port), and `Tracker.process` with the default loop settings, which
calls `LoopCloser.on_keyframe` on every inserted keyframe in a
`loop_closing` stage.

The Tracker's re-anchor after a closed loop (the live pose set to the
corrected keyframe's pose) runs in both packages with the same stub in
place of the loop closer: at one keyframe it moves that keyframe by a
known rigid transform and reports a closed loop. The returned poses from
there on must agree within 5 mm (`test_torch_tracker.py`'s tolerance)
and so must `n_loops_closed`.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.tracking.tracker import Tracker as JTracker
from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import SyntheticSequence
from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker
from test_loop_e2e import _circle_poses
from test_torch_loop import N_KF, e2e_config, render_all, run_port
from _torch_threads import _few_threads  # noqa: F401 (autouse)

N_FRAMES = 12
# The re-anchor test: the stub closes a "loop" at the keyframe of this uid
# (the third keyframe, frame 6 at a keyframe every third frame), moving it
# by 1 cm and 0.5 degrees.
CLOSE_AT_UID = 2


def test_no_false_loops_without_revisit():
    poses = _circle_poses(2 * N_KF)[:N_KF]  # an open arc
    closed_at, _, state, lc = run_port(e2e_config(tconfig), poses,
                                       render_all(poses, tconfig.SlamConfig().camera))
    assert closed_at == [], f"false loop(s) at {closed_at}"
    assert int(state.n_kfs) == N_KF and not lc.loops


def qvga_loop_config(mod=tconfig):
    """The QVGA config of the port's tracker tests, with the default
    `LoopConfig` (loop closing and relocalization on, trained vocabulary)."""
    base = mod.SlamConfig()
    return mod.SlamConfig(
        camera=mod.CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=123.8, width=320,
                                height=240, th_depth=80.0),
        orb=mod.OrbConfig(n_features=500, max_keypoints=512),
        tracking=dataclasses.replace(base.tracking, max_frames_between_kfs=2,
                                     local_map_candidates=1024),
        map=dataclasses.replace(base.map, max_keyframes=32, max_map_points=4096,
                                local_ba_window=4, local_ba_fixed_anchors=2,
                                triangulation_neighbors=2, fuse_neighbors=2),
    )


@pytest.fixture(scope="module")
def loop_frames():
    """The first frames of phase 7c's sequence in `chip_smoke.py`, at QVGA."""
    seq = SyntheticSequence(n_frames=90, cam=qvga_loop_config().camera, trajectory="loop",
                            loop_laps=1.35, depth_noise=0.02)
    return seq, [seq.gray_depth(i) for i in range(N_FRAMES)]


def test_tracker_runs_the_loop_closing_stage(loop_frames):
    assert Tracker(tconfig.SlamConfig(), device="cpu").loop_closer.vocab is not None
    cfg = qvga_loop_config()
    assert cfg.loop == tconfig.LoopConfig()
    seq, frames = loop_frames
    tr = Tracker(cfg, device="cpu")
    for i, (gray, depth) in enumerate(frames):
        tr.process(gray, depth, float(seq.stamps[i]))
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


def _closing_move() -> np.ndarray:
    c, s = np.cos(np.radians(0.5)), np.sin(np.radians(0.5))
    G = np.eye(4, dtype=np.float32)
    G[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    G[:3, 3] = [0.01, 0.0, 0.0]
    return G


class _ClosingStub:
    """Stands in for `LoopCloser`: at the keyframe of uid CLOSE_AT_UID it
    moves that keyframe's pose by `_closing_move()` and reports a closed
    loop; every other call closes nothing."""

    def __init__(self, set_pose):
        self.set_pose = set_pose
        self.closed_slots = []

    def on_keyframe(self, state, kf_id):
        if int(state.kfs.uid[kf_id]) != CLOSE_AT_UID:
            return state, False
        self.closed_slots.append(kf_id)
        self.moved_pose = _closing_move() @ np.asarray(state.kfs.T_cw[kf_id])
        return self.set_pose(state, kf_id, self.moved_pose), True


def _jax_set_pose(state, kf_id, T):
    return state._replace(kfs=state.kfs._replace(
        T_cw=state.kfs.T_cw.at[kf_id].set(jnp.asarray(T))))


def _port_set_pose(state, kf_id, T):
    T_cw = state.kfs.T_cw.clone()
    T_cw[kf_id] = torch.from_numpy(T)
    return state.replace(kfs=state.kfs.replace(T_cw=T_cw))


def test_reanchor_after_a_closed_loop_matches_jax(loop_frames):
    seq, frames = loop_frames
    out = {}
    for name, tracker, set_pose in (
            ("jax", JTracker(qvga_loop_config(jconfig)), _jax_set_pose),
            ("port", Tracker(qvga_loop_config(), device="cpu"), _port_set_pose)):
        tracker.loop_closer = stub = _ClosingStub(set_pose)
        poses, closed = [], []
        for i, (gray, depth) in enumerate(frames):
            poses.append(np.asarray(tracker.process(gray, depth, float(seq.stamps[i]))))
            closed.append(tracker.n_loops_closed)
        at = closed.index(1) if 1 in closed else None
        # The pose returned at the closure is the moved keyframe's.
        assert at is not None and np.allclose(poses[at], stub.moved_pose, atol=1e-6), name
        out[name] = (np.stack(poses), closed, stub.closed_slots)
    (pj, cj, sj), (pt, ct, st) = out["jax"], out["port"]
    assert ct == cj and ct[-1] == 1 and st == sj, (ct, cj, st, sj)
    at = ct.index(1)  # the frame whose keyframe closed the loop
    assert at < len(frames) - 2, "too few frames after the closure"
    cj_, ct_ = (np.einsum("nji,nj->ni", P[:, :3, :3], -P[:, :3, 3]) for P in (pj, pt))
    d = np.linalg.norm(ct_[at:] - cj_[at:], axis=1)
    assert d.max() < 5e-3, d
