"""The benchmark's scenes: a frozen copy of the port's synthetic scene
generator (`io/synthetic.py`: the four-wall furnished room, the circuit
and the sway trajectories, the crossing walkers), so that a later change
to the port's generator does not move the yardstick.

Plain numpy. `build` turns a configuration's `scene` entry into the
camera-to-world poses, the room, its static boxes and the walkers' boxes
of every frame, which both the renderer and the reference read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def loop_room_boxes(size):
    """Furniture flush against all four vertical walls (the scene of the
    circuit and of the walkers)."""
    sx, sy, sz = size
    return [
        ((0.15 * sx, 0.20 * sy, sz - 1.4), (0.35 * sx, 0.55 * sy, sz)),
        ((0.55 * sx, 0.45 * sy, sz - 1.8), (0.75 * sx, 0.80 * sy, sz)),
        ((0.40 * sx, 0.62 * sy, sz - 1.0), (0.52 * sx, 0.90 * sy, sz)),
        ((0.20 * sx, 0.30 * sy, 0.0), (0.42 * sx, 0.70 * sy, 1.5)),
        ((0.60 * sx, 0.15 * sy, 0.0), (0.82 * sx, 0.50 * sy, 1.1)),
        ((sx - 1.3, 0.25 * sy, 0.20 * sz), (sx, 0.60 * sy, 0.38 * sz)),
        ((sx - 0.9, 0.50 * sy, 0.55 * sz), (sx, 0.85 * sy, 0.72 * sz)),
        ((0.0, 0.35 * sy, 0.30 * sz), (1.2, 0.75 * sy, 0.48 * sz)),
        ((0.0, 0.10 * sy, 0.62 * sz), (0.8, 0.45 * sy, 0.80 * sz)),
    ]


def _pose(x, y, z, yaw, pitch) -> np.ndarray:
    cy_, sy_ = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    R_yaw = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
    R_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = (R_yaw @ R_pitch).astype(np.float32)
    T[:3, 3] = [x, y, z]
    return T


def loop_trajectory(n_frames: int, room, laps: float, margin: float = 2.2,
                    look_ahead: float = 0.35) -> np.ndarray:
    """A circuit around the room, heading along the path, `laps` times
    round: (n, 4, 4) camera-to-world poses."""
    sx, sy, sz = room
    a = sx / 2 - margin
    b = sz / 2 - margin
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * laps * i / n_frames
        x = sx / 2 + a * np.sin(th)
        z = sz / 2 + b * np.cos(th)
        y = sy / 2 + 0.08 * np.sin(3.1 * th)
        yaw = np.arctan2(a * np.cos(th + look_ahead), -b * np.sin(th + look_ahead))
        poses.append(_pose(x, y, z, yaw, 0.04 * np.sin(2.3 * th)))
    return np.stack(poses)


def sway_trajectory(n_frames: int, room) -> np.ndarray:
    """A quasi-static camera near the room's centre, swaying and yawing a
    little while it looks at the furnished +z wall (TUM fr3_walking's
    regime): (n, 4, 4) camera-to-world poses."""
    sx, sy, sz = room
    poses = []
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        x = sx / 2 + 0.40 * np.sin(2 * np.pi * 1.7 * t)
        y = sy / 2 + 0.10 * np.sin(2 * np.pi * 1.1 * t + 0.7)
        z = 0.55 * sz + 0.15 * np.sin(2 * np.pi * 0.8 * t)
        poses.append(_pose(x, y, z, 0.10 * np.sin(2 * np.pi * 1.3 * t),
                           0.04 * np.sin(2 * np.pi * 0.9 * t + 1.3)))
    return np.stack(poses)


def cross_walkers(n_frames: int, room, n_objects: int) -> np.ndarray:
    """(n, M, 2, 3) boxes of person-sized walkers crossing the sway
    camera's view in front of the +z wall: two walk and stand, one
    crosses briskly without stopping."""
    sx, sy, sz = room
    cam_z = 0.55 * sz
    specs = [
        # (z plane, x start, x span, phase, stand fraction, width, brisk)
        (cam_z + 1.6, sx / 2 - 1.6, 3.0, 0.00, 0.30, 0.75, False),
        (cam_z + 2.4, sx / 2 + 1.7, -3.5, 0.45, 0.25, 0.80, False),
        (cam_z + 1.35, sx / 2 - 1.2, 2.4, 0.30, 0.00, 0.55, True),
    ][:n_objects]
    out = np.zeros((n_frames, len(specs), 2, 3), np.float32)
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        for m, (zw, x0, span, phase, stand_frac, wdt, brisk) in enumerate(specs):
            if brisk:
                u = (2.5 * t + phase) % 1.0
                prog = 2 * u if u < 0.5 else 2 * (1 - u)
            else:
                u = (t + phase) % 1.0
                for s0 in (0.22, 0.62):
                    if u > s0:
                        u = u - (min(u, s0 + stand_frac / 2) - s0)
                prog = min(max(u / (1.0 - stand_frac), 0.0), 1.0)
            xw = x0 + span * prog
            out[i, m, 0] = (xw - wdt / 2, sy - 1.6, zw - wdt / 2)
            out[i, m, 1] = (xw + wdt / 2, sy, zw + wdt / 2)
    return out


@dataclass(frozen=True)
class Scene:
    """What a configuration's scene is: `poses_wc` (n, 4, 4)
    camera-to-world, the room's extent, its static boxes (B, 2, 3), the
    walkers' boxes of every frame (n, M, 2, 3) or None, the texture seed
    and the depth noise (sigma as a share of depth)."""
    poses_wc: np.ndarray
    room: tuple
    boxes: np.ndarray
    walkers: np.ndarray | None
    texture_seed: int
    depth_noise: float
    supersample: int

    def prefix(self, n: int) -> "Scene":
        """The scene's first `n` frames."""
        return Scene(self.poses_wc[:n], self.room, self.boxes,
                     None if self.walkers is None else self.walkers[:n], self.texture_seed,
                     self.depth_noise, self.supersample)


def build(spec: dict) -> Scene:
    """The scene a configuration's `scene` entry describes."""
    room = tuple(float(x) for x in spec["room"])
    if spec["furniture"] != "loop_room":
        raise ValueError(f"unknown furniture {spec['furniture']!r}")
    traj = spec["trajectory"]
    n = int(traj["n_frames"])
    if traj["kind"] == "loop":
        poses = loop_trajectory(n, room, float(traj["laps"]))
    elif traj["kind"] == "sway":
        poses = sway_trajectory(n, room)
    else:
        raise ValueError(f"unknown trajectory {traj['kind']!r}")
    walkers = None
    if spec.get("walkers"):
        w = spec["walkers"]
        if w["kind"] != "cross":
            raise ValueError(f"unknown walkers {w['kind']!r}")
        walkers = cross_walkers(n, room, int(w["n"]))
    return Scene(poses, room, np.asarray(loop_room_boxes(room), np.float32), walkers,
                 int(spec["texture_seed"]), float(spec["depth_noise"]),
                 int(spec.get("supersample", 3)))
