"""Perceptual aliasing in the port's loop closing (twin of
`tests/test_perceptual_aliasing.py`, run in the port alone at that test's
gates): a camera that laps room A and then room B (same geometry and
texture statistics, another texture realization) with the keyframe store
below the insertion count, so that slots are reused, must close no loop;
a drifting revisit of one room must still close one, so the rejection is
not vacuous. The JAX test's scenes (`BoxRoom` seeds 3 and 11, its circle
of poses, its loop settings with the trained vocabulary) at 320x240, and
the views render in 3 spawn workers.
"""

import dataclasses
import multiprocessing

import numpy as np
import pytest
import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, OrbConfig, SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import BoxRoom
from orb_slam2_ssd_semantic_tpu_torch.mapping.local_mapping import fuse_map_points
from orb_slam2_ssd_semantic_tpu_torch.mapping.loop_closing import LoopCloser
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import empty_state
from orb_slam2_ssd_semantic_tpu_torch.tracking import tracker as tk
from _torch_threads import _few_threads  # noqa: F401 (autouse)

QVGA = CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=123.8, width=320, height=240)


def _circle_poses(n, room=(5.0, 3.0, 6.0), radius=0.55):
    sx, sy, sz = room
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        ca, sa = np.cos(a), np.sin(a)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32)
        T[:3, 3] = [sx / 2 + radius * np.sin(a), sy / 2, sz / 2 + radius * (np.cos(a) - 1.0) * 0.5]
        out.append(T)
    return out


def _cfg(max_kf: int) -> SlamConfig:
    base = SlamConfig()
    return SlamConfig(
        camera=QVGA, orb=OrbConfig(n_features=500, max_keypoints=512),
        map=dataclasses.replace(base.map, max_keyframes=max_kf, local_ba_window=4,
                                local_ba_fixed_anchors=2, triangulation_neighbors=2,
                                fuse_neighbors=2),
        loop=dataclasses.replace(base.loop, enabled=True, min_kfs_before_loop=3,
                                 covisibility_consistency_th=2, run_global_ba=False),
    )


def _render(task):
    seed, T_wc = task
    return BoxRoom(seed=seed, cam=QVGA).render(T_wc)


@pytest.fixture(scope="module")
def views():
    """Room A's and room B's 8 views of the circle, and 10 views of room A
    for the revisit, rendered once."""
    circle8, circle10 = _circle_poses(8), _circle_poses(10)
    tasks = [(3, T) for T in circle8] + [(11, T) for T in circle8] + [(3, T) for T in circle10]
    with multiprocessing.get_context("spawn").Pool(3) as pool:
        out = pool.map(_render, tasks)
    return dict(A=out[:8], B=out[8:16], revisit=out[16:], circle8=circle8, circle10=circle10)


def _insert(state, lc, cfg, gray, depth, T_cw, uid):
    frame = tk.build_frame(torch.from_numpy(np.asarray(gray, np.float32)),
                           torch.from_numpy(np.asarray(depth, np.float32)), cfg)
    state, _ = tk.insert_keyframe(state, frame, torch.from_numpy(T_cw),
                                  torch.full((cfg.orb.max_keypoints,), -1, dtype=torch.int64),
                                  uid, float(uid), cfg, spawn_all=True)
    if uid > 0:
        state = fuse_map_points(state, cfg)
    return lc.on_keyframe(state, int(state.last_kf))


def test_no_false_loops_across_similar_rooms_with_slot_reuse(views):
    cfg = _cfg(max_kf=12)  # 16 insertions: eviction and slot reuse
    lc = LoopCloser(cfg, device="cpu")
    state = empty_state(cfg, torch.device("cpu"))
    closed, uid = [], 0
    for tag in ("A", "B"):
        for (gray, depth), T_wc in zip(views[tag], views["circle8"]):
            T_cw = np.linalg.inv(T_wc).astype(np.float32)
            if tag == "B":  # room B lies in a disjoint region of the world
                off = np.eye(4, dtype=np.float32)
                off[:3, 3] = [-20.0, 0.0, 0.0]
                T_cw = T_cw @ off
            state, did = _insert(state, lc, cfg, gray, depth, T_cw, uid)
            if did:
                closed.append((tag, uid))
            uid += 1
    assert int(state.next_uid) == 16 and int(state.n_kfs) == 12
    assert closed == [], f"false loop closure(s): {closed}"


def test_same_room_revisit_still_closes(views):
    cfg = _cfg(max_kf=24)
    lc = LoopCloser(cfg, device="cpu")
    state = empty_state(cfg, torch.device("cpu"))
    closed = []
    for i in range(14):
        gray, depth = views["revisit"][i % 10]
        d = 0.25 * i / 13
        drift = np.eye(4, dtype=np.float32)
        drift[:3, 3] = [d, 0.0, 0.4 * d]
        T_cw = np.linalg.inv(views["circle10"][i % 10]).astype(np.float32) @ drift
        state, did = _insert(state, lc, cfg, gray, depth, T_cw, i)
        if did:
            closed.append(i)
    assert closed, "the control revisit failed to close any loop"
