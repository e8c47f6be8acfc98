"""Port parity for the slice as a whole: the JAX Tracker and the port's
Tracker on the same rendered RGB-D sequence, at a small config (QVGA
camera and 512 keypoints, as in the mapping parity test; the
loop-closure test's map settings with fewer map points; loop closing and
relocalization off; a keyframe every third frame so that local mapping
runs twice in ten frames).

Gates, and why: keyframe frames and per-frame statuses are discrete
decisions and must agree exactly; camera positions must agree within
5 mm per frame (the two implementations sum the same f32 quantities in
different orders, and local BA amplifies ulp-level differences over its
Gauss-Newton iterations, but both must land on the same trajectory);
the port's ATE against ground truth must stay under 1 cm, the tracker
test's gate.
"""

import dataclasses

import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.io.synthetic import SyntheticSequence
from orb_slam2_ssd_semantic_tpu.tracking.tracker import Tracker as JTracker
from orb_slam2_ssd_semantic_tpu_torch.eval.ate import evaluate_ate_xyz
from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker as TTracker
from _torch_threads import _few_threads  # noqa: F401 (autouse)

N_FRAMES = 10


def small_config(mod):
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
        loop=dataclasses.replace(base.loop, enabled=False, enable_relocalization=False),
    )


@pytest.fixture(scope="module")
def runs():
    seq = SyntheticSequence(n_frames=N_FRAMES, cam=small_config(jconfig).camera)
    frames = [seq.gray_depth(i) for i in range(N_FRAMES)]
    out = {}
    for name, tracker in (("jax", JTracker(small_config(jconfig))),
                          ("torch", TTracker(small_config(tconfig), device="cpu"))):
        for i, (gray, depth) in enumerate(frames):
            tracker.process(gray, depth, float(seq.stamps[i]))
        out[name] = tracker
    return seq, out["jax"], out["torch"]


def _kf_frames(tracker):
    return [i for i in range(1, len(tracker.stats))
            if tracker.stats[i]["kfs"] != tracker.stats[i - 1]["kfs"]]


def test_same_keyframes_and_statuses(runs):
    _, tj, tt = runs
    assert len(_kf_frames(tj)) >= 3, "local mapping never ran: vacuous"
    assert tt.metrics.stages["local_mapping"].count >= 2
    assert _kf_frames(tt) == _kf_frames(tj)
    assert [s["status"] for s in tt.stats] == [s["status"] for s in tj.stats]
    assert [s["kfs"] for s in tt.stats] == [s["kfs"] for s in tj.stats]


def test_camera_positions_agree(runs):
    _, tj, tt = runs
    d = np.linalg.norm(tj.camera_positions() - tt.camera_positions(), axis=1)
    assert d.max() < 5e-3, d


def test_port_ate(runs):
    seq, _, tt = runs
    assert evaluate_ate_xyz(tt.camera_positions(), seq.gt_positions()).rmse < 0.01


def test_port_trajectory_file(tmp_path, runs):
    from orb_slam2_ssd_semantic_tpu_torch.io.tum import read_trajectory

    _, tj, tt = runs
    path = str(tmp_path / "traj.txt")
    tt.save_trajectory_tum(path)
    stamps, t, q = read_trajectory(path)
    assert len(stamps) == N_FRAMES
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(t, tt.camera_positions(), atol=1e-5)
