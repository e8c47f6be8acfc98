"""The port's viewers: `apps/web_viewer.LiveViewer` (twin of
`tests/test_web_viewer.py`) on a CPU `Tracker`, each `viz.plot_*` on the
port's state, and `viz.draw_trajectory_main` on two TUM files. The
viewer binds port 0 (a free port): JAX's test holds 8689 in a parallel
worker. The plots are images, so the checks are that each writes a PNG
(its magic bytes) from the port's tensors, as JAX's module does from its
arrays."""

import urllib.request

import numpy as np
import pytest
import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, LoopConfig, OrbConfig, SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import SyntheticSequence
from _torch_threads import _few_threads  # noqa: F401 (autouse)

PNG = b"\x89PNG\r\n\x1a\n"
QVGA = CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=123.8, width=320, height=240)


def _is_png(path) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == PNG


@pytest.fixture(scope="module")
def tracked():
    """A CPU Tracker after 3 QVGA frames of the synthetic orbit."""
    from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker

    cfg = SlamConfig(camera=QVGA, orb=OrbConfig(n_features=300, max_keypoints=384),
                     loop=LoopConfig(enabled=False, enable_relocalization=False))
    seq = SyntheticSequence(n_frames=3, cam=QVGA)
    tr = Tracker(cfg, device="cpu")
    frames = [seq.gray_depth(i) for i in range(3)]
    for i, (g, d) in enumerate(frames):
        tr.process(g, d, float(seq.stamps[i]))
    return tr, frames, seq


def test_viewer_serves_dashboard_and_images():
    """JAX's test, on a fresh CPU Tracker at the default config."""
    from orb_slam2_ssd_semantic_tpu_torch.apps.web_viewer import LiveViewer
    from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker

    viewer = LiveViewer(Tracker(SlamConfig(), device="cpu"), port=0)
    viewer.start()
    try:
        assert viewer.port != 0
        viewer.publish_frame(np.zeros((480, 640), np.float32))
        url = f"http://127.0.0.1:{viewer.port}"
        assert b"live viewer" in urllib.request.urlopen(url + "/", timeout=10).read()
        assert urllib.request.urlopen(url + "/frame.png", timeout=10).read()[:8] == PNG
        assert urllib.request.urlopen(url + "/map.png", timeout=10).read()[:8] == PNG
        assert b"stage" in urllib.request.urlopen(url + "/stats", timeout=10).read()
    finally:
        viewer.stop()


def test_viewer_draws_a_tracked_state(tracked):
    """The overlay and the map view of a tracker that holds keypoints, map
    points and a keyframe (the parts JAX's test leaves empty)."""
    from orb_slam2_ssd_semantic_tpu_torch.apps.web_viewer import LiveViewer

    tr, frames, _ = tracked
    assert tr.last_frame is not None and int(tr.state.points.valid.sum()) > 0
    viewer = LiveViewer(tr, port=0)
    viewer.publish_frame(frames[-1][0])
    assert viewer._frame_png[:8] == PNG and viewer._map_png[:8] == PNG


def test_viz_plots_write_pngs(tracked, tmp_path):
    from orb_slam2_ssd_semantic_tpu_torch import viz
    from orb_slam2_ssd_semantic_tpu_torch.config import DenseMapConfig
    from orb_slam2_ssd_semantic_tpu_torch.dense.occupancy import (
        empty_grid,
        insert_scan,
        occupied_centers,
    )

    tr, frames, seq = tracked
    est = tr.camera_positions()
    viz.plot_trajectories(str(tmp_path / "traj.png"),
                          {"groundtruth": seq.gt_positions(), "estimate": est})
    viz.plot_map(str(tmp_path / "map.png"), tr.state, gt_positions=seq.gt_positions(),
                 est_positions=est)
    viz.plot_frame(str(tmp_path / "frame.png"), frames[-1][0], feats=tr.last_frame.feats,
                   mask=torch.ones(frames[-1][0].shape, dtype=torch.bool),
                   stats=tr.stats[-1])
    dense = DenseMapConfig(resolution=0.2, max_ray_steps=16)
    grid = empty_grid((4.0, 2.0, 4.0), 0.2, origin=(-2.0, -1.0, -1.0), device="cpu")
    xy = torch.stack(torch.meshgrid(torch.linspace(-1, 1, 21), torch.linspace(-0.5, 0.5, 11),
                                    indexing="ij"), -1).reshape(-1, 2)
    wall = torch.cat([xy, torch.full((len(xy), 1), 2.0)], -1)  # a wall 2 m ahead
    for _ in range(3):
        grid = insert_scan(grid, torch.zeros(3), wall, torch.ones(len(wall), dtype=torch.bool),
                           colors=torch.full(wall.shape, 128.0), cfg=dense)
    assert len(occupied_centers(grid, dense)[0]) > 0
    viz.plot_occupancy(str(tmp_path / "occupancy.png"), grid, dense)
    keyframes = viz.keyframe_centres(tr.state)
    assert keyframes.shape == (tr._n_kfs, 3) and np.isfinite(keyframes).all()
    for name in ("traj", "map", "frame", "occupancy"):
        assert _is_png(tmp_path / f"{name}.png"), name


def test_draw_trajectory_main(tmp_path, capsys):
    from orb_slam2_ssd_semantic_tpu_torch import viz
    from orb_slam2_ssd_semantic_tpu_torch.io.tum import write_trajectory

    t = np.linspace(0, 1, 10)
    xyz = np.stack([np.cos(t), 0.1 * t, np.sin(t)], -1)
    q = np.tile([0.0, 0.0, 0.0, 1.0], (10, 1))
    write_trajectory(str(tmp_path / "gt.txt"), t, xyz, q)
    write_trajectory(str(tmp_path / "est.txt"), t, xyz + 0.01, q)
    out = tmp_path / "traj.png"
    viz.draw_trajectory_main([str(tmp_path / "gt.txt"), str(tmp_path / "est.txt"),
                              "-o", str(out)])
    assert _is_png(out)
    assert "groundtruth, est.txt" in capsys.readouterr().out
