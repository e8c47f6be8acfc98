"""Headless visualization: trajectory comparison plots, map renders,
frame overlays (counterpart of the JAX package's `viz.py`).

The observability surface standing in for the reference's Pangolin
viewer + OpenCV frame drawer (perfect/src/Viewer.cc, FrameDrawer.cc,
MapDrawer.cc GL half) in a display-less environment: everything renders
to PNG via matplotlib (Agg). Also covers tool/draw_trajectory.py
(ground truth vs estimated trajectory comparison plot).

Needs matplotlib, which only the viewers use; the package's `__init__`
does not import this module.

Usage:
    python -m orb_slam2_ssd_semantic_tpu_torch.viz groundtruth.txt est.txt -o traj.png
"""

from __future__ import annotations

import matplotlib
import numpy as np
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _save(fig, path: str, dpi: int) -> None:
    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)


def keyframe_centres(state) -> np.ndarray:
    """(n, 3) camera centres of the live keyframes in insertion (uid)
    order."""
    kv = _np(state.kfs.valid)
    uid = _np(state.kfs.uid)
    order = np.argsort(np.where(kv, uid, 1 << 30))[: int(kv.sum())]
    T = _np(state.kfs.T_cw)[order]
    if not len(T):
        return np.zeros((0, 3))
    return np.stack([-t[:3, :3].T @ t[:3, 3] for t in T])


def plot_trajectories(path: str, named_trajs: dict, axes=(0, 2), title="trajectory"):
    """named_trajs: {label: (N, 3) positions}. Top-down (x-z) by default,
    the tool/draw_trajectory.py comparison figure."""
    fig, ax = plt.subplots(figsize=(8, 8))
    a, b = axes
    for label, xyz in named_trajs.items():
        xyz = _np(xyz)
        ax.plot(xyz[:, a], xyz[:, b], label=label, linewidth=1.2)
        ax.scatter([xyz[0, a]], [xyz[0, b]], marker="o", s=30)
    ax.set_xlabel("xyz"[a] + " [m]")
    ax.set_ylabel("xyz"[b] + " [m]")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    _save(fig, path, 120)


def plot_map(path: str, state, max_points: int = 20000, gt_positions=None,
             est_positions=None):
    """Sparse map + keyframes top-down render (MapDrawer sparse view) of
    the port's `SlamState`."""
    fig, ax = plt.subplots(figsize=(9, 9))
    pos = _np(state.points.pos)[_np(state.points.valid)]
    if len(pos) > max_points:
        pos = pos[:: len(pos) // max_points]
    ax.scatter(pos[:, 0], pos[:, 2], s=0.5, c="black", alpha=0.4, label="map points")
    centers = keyframe_centres(state)
    if len(centers):
        ax.plot(centers[:, 0], centers[:, 2], "b.-", markersize=4, label="keyframes")
    if est_positions is not None:
        e = _np(est_positions)
        ax.plot(e[:, 0], e[:, 2], "g-", linewidth=0.8, label="trajectory")
    if gt_positions is not None:
        g = _np(gt_positions)
        ax.plot(g[:, 0], g[:, 2], "r--", linewidth=0.8, label="ground truth")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    _save(fig, path, 120)


def plot_frame(path: str, gray, feats=None, mask=None, stats=None):
    """Keypoint/state overlay (FrameDrawer::DrawFrame equivalent); `mask`
    is the static-pixel mask (its complement is tinted red)."""
    fig, ax = plt.subplots(figsize=(10, 7.5))
    ax.imshow(_np(gray), cmap="gray", vmin=0, vmax=255)
    if mask is not None:
        m = ~_np(mask)
        overlay = np.zeros(m.shape + (4,))
        overlay[m] = (1.0, 0.0, 0.0, 0.35)
        ax.imshow(overlay)
    if feats is not None:
        uv = _np(feats.uv)[_np(feats.valid)]
        ax.scatter(uv[:, 0], uv[:, 1], s=6, facecolors="none", edgecolors="lime",
                   linewidths=0.6)
    if stats:
        ax.set_title(" | ".join(f"{k}: {v}" for k, v in stats.items()), fontsize=9)
    ax.set_axis_off()
    _save(fig, path, 100)


def plot_occupancy(path: str, grid, cfg, max_voxels: int = 40000):
    """Occupied-voxel scatter of a `VoxelGrid`, top-down + side (the
    octomap view)."""
    from orb_slam2_ssd_semantic_tpu_torch.dense.occupancy import occupied_centers

    centers, colors = occupied_centers(grid, cfg)
    if len(centers) > max_voxels:
        step = len(centers) // max_voxels
        centers, colors = centers[::step], colors[::step]
    fig, axes = plt.subplots(1, 2, figsize=(14, 7))
    c = np.clip(colors / 255.0, 0, 1)
    axes[0].scatter(centers[:, 0], centers[:, 2], s=1.5, c=c)
    axes[0].set_title("top-down (x-z)")
    axes[1].scatter(centers[:, 0], centers[:, 1], s=1.5, c=c)
    axes[1].invert_yaxis()
    axes[1].set_title("front (x-y)")
    for ax in axes:
        ax.set_aspect("equal")
    _save(fig, path, 120)


def draw_trajectory_main(argv=None):
    """CLI mirror of the reference's tool/draw_trajectory.py: plot the
    ground truth against one or more estimated trajectories."""
    import argparse
    import os

    from orb_slam2_ssd_semantic_tpu_torch.io.tum import read_trajectory

    p = argparse.ArgumentParser(description="trajectory comparison plot")
    p.add_argument("groundtruth")
    p.add_argument("estimates", nargs="+", help="TUM-format trajectory files")
    p.add_argument("-o", "--out", default="trajectories.png")
    args = p.parse_args(argv)
    named = {"groundtruth": read_trajectory(args.groundtruth)[1]}
    for path in args.estimates:
        named[os.path.basename(path)] = read_trajectory(path)[1]
    plot_trajectories(args.out, named)
    print(f"wrote {args.out} ({', '.join(named)})")


if __name__ == "__main__":
    draw_trajectory_main()
