"""The frozen copies of the port's scene generator and renderer equal
the port's today (at a small size on the CPU), and the reference reads
exact answers as exact and broken ones as broken."""

import dataclasses

import numpy as np
import pytest
import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig
from orb_slam2_ssd_semantic_tpu_torch.io import device_render as port_render
from orb_slam2_ssd_semantic_tpu_torch.io import synthetic as port_synthetic
from slambench.reference import truth
from slambench.scene import render, synthetic

ROOM = (8.0, 3.0, 10.0)


def test_scene_generator_equals_the_ports():
    assert np.array_equal(np.asarray(synthetic.loop_room_boxes(ROOM), np.float32),
                          np.asarray(port_synthetic.loop_room_boxes(ROOM), np.float32))
    np.testing.assert_array_equal(synthetic.loop_trajectory(145, ROOM, 2.35),
                                  port_synthetic.loop_trajectory(145, ROOM, laps=2.35))
    np.testing.assert_array_equal(synthetic.sway_trajectory(337, ROOM),
                                  port_synthetic.sway_trajectory(337, ROOM))
    np.testing.assert_array_equal(synthetic.cross_walkers(337, ROOM, 3),
                                  port_synthetic.cross_walkers(337, ROOM, n_objects=3))


@pytest.mark.parametrize("noise", [0.0, 0.01])
def test_renderer_equals_the_ports(noise):
    cam = dataclasses.replace(CameraConfig(), width=48, height=36, fx=40.0, fy=40.0, cx=24.0,
                              cy=18.0)
    scene = synthetic.build({"room": list(ROOM), "furniture": "loop_room",
                             "trajectory": {"kind": "sway", "n_frames": 337},
                             "walkers": {"kind": "cross", "n": 3}, "texture_seed": 17,
                             "depth_noise": noise}).prefix(3)
    cpu = torch.device("cpu")
    mine = render.render_frames(scene.poses_wc, cam, scene.room, scene.boxes, seed=17,
                                depth_noise=noise, moving_boxes=scene.walkers, device=cpu)
    port = port_render.render_frames(scene.poses_wc, cam, size=scene.room,
                                     boxes=tuple(map(tuple, scene.boxes.tolist())), seed=17,
                                     depth_noise=noise, moving_boxes=scene.walkers, device=cpu)
    for a, b in zip(mine, port):
        assert torch.equal(a, b)


def _poses(n, step=0.1):
    W = np.tile(np.eye(4), (n, 1, 1))
    yaw = np.arange(n) * 0.02  # radians a frame
    W[:, 0, 0] = W[:, 2, 2] = np.cos(yaw)
    W[:, 0, 2], W[:, 2, 0] = np.sin(yaw), -np.sin(yaw)
    W[:, 0, 3] = np.arange(n) * step + 2.0
    W[:, 1, 3] = 1.5
    W[:, 2, 3] = 5.0
    return W


def test_reference_reads_exact_answers_as_exact_and_faults_as_faults():
    W = _poses(20)
    # The run's world is its first camera's: T_cw = inv(W0^-1 W_i).
    T_cw = truth.inv_se3(truth.inv_se3(W[:1]) @ W)
    kf = T_cw[::5]
    pts = np.array([[0.5, 0.0, 5.0], [-1.0, 0.5, 5.0]])  # on the +z wall seen from frame 0
    args = dict(kf_T_cw=kf, kf_W_true=W[::5], points=pts, point_kf=np.array([0, 0]),
                room=ROOM, boxes=np.zeros((0, 2, 3)))
    got = truth.judge(T_cw, W, **args)
    assert got["rigid_err_max"] < 1e-12 and got["ate_rmse_m"] < 1e-12
    assert got["step_err_max_m"] < 1e-12 and got["map_local_err_p90_m"] < 1e-12
    assert got["kf_step_err_max_m"] < 1e-12 and got["rot_err_max_deg"] < 1e-6
    stuck = np.repeat(T_cw[:1], 20, axis=0)
    assert truth.judge(stuck, W, **args)["ate_rmse_m"] > 0.5
    # A stuck answer misses the whole true turn: 19 frames x 0.02 rad.
    assert truth.judge(stuck, W, **args)["rot_err_max_deg"] == pytest.approx(
        np.degrees(19 * 0.02), abs=1e-6)
    moved = T_cw.copy()
    moved[10, :3, 3] -= moved[10, :3, :3] @ np.array([2.0, 0.0, 0.0])
    assert truth.judge(moved, W, **args)["step_err_max_m"] == pytest.approx(2.0, abs=1e-9)
    half = T_cw.copy()
    half[1::2] = np.nan
    assert np.isinf(truth.judge(half, W, **args)["ate_rmse_m"])
    scaled = T_cw.copy()
    scaled[:, :3, :3] *= 1.001
    assert truth.judge(scaled, W, **args)["rigid_err_max"] > 3e-3


def test_surface_distance():
    boxes = np.array([[[1.0, 1.0, 1.0], [2.0, 2.0, 2.0]]])
    p = np.array([[4.0, 1.5, 5.0], [1.5, 1.5, 0.5], [1.5, 1.5, 1.4], [8.5, 1.5, 5.0]])
    np.testing.assert_allclose(truth.surface_distance(p, ROOM, boxes), [1.5, 0.5, 0.4, 0.5])
    walker = np.array([[[[3.5, 1.0, 4.5], [3.9, 3.0, 5.5]]]] * 4)
    np.testing.assert_allclose(truth.surface_distance(p, ROOM, boxes, walker)[0], 0.1)
