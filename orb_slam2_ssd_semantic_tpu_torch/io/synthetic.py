"""Synthetic RGB-D sequence renderer with exact ground truth.

The environment has no TUM image data (zero egress), so end-to-end SLAM
tests and benchmarks run on a procedurally-textured box room rendered by
ray-casting: every frame provides (gray, depth, T_cw ground truth) at
the reference's 640x480 operating point. The texture is multi-octave
value noise plus a random-luminance cell grid, giving FAST plenty of
corners; depth is exact camera-frame z like a Kinect.

Deterministic for a given seed. Pure numpy/JAX; renders on CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig


def _hash2(ix: np.ndarray, iy: np.ndarray, seed: int) -> np.ndarray:
    """Integer lattice hash -> [0, 1) float, vectorized."""
    h = (ix.astype(np.int64) * 374761393 + iy.astype(np.int64) * 668265263 + seed * 144665461)
    h = (h ^ (h >> 13)) * 1274126177
    h = h ^ (h >> 16)
    return ((h & 0xFFFFFF).astype(np.float64) / float(0x1000000)).astype(np.float32)


def _value_noise(x: np.ndarray, y: np.ndarray, scale: float, seed: int) -> np.ndarray:
    """Bilinear value noise over a lattice of pitch `scale` meters."""
    fx = x / scale
    fy = y / scale
    ix = np.floor(fx).astype(np.int64)
    iy = np.floor(fy).astype(np.int64)
    tx = (fx - ix).astype(np.float32)
    ty = (fy - iy).astype(np.float32)
    v00 = _hash2(ix, iy, seed)
    v10 = _hash2(ix + 1, iy, seed)
    v01 = _hash2(ix, iy + 1, seed)
    v11 = _hash2(ix + 1, iy + 1, seed)
    return (
        v00 * (1 - tx) * (1 - ty)
        + v10 * tx * (1 - ty)
        + v01 * (1 - tx) * ty
        + v11 * tx * ty
    )


def _texture(u: np.ndarray, v: np.ndarray, face_id: int, seed: int) -> np.ndarray:
    """Gray texture in [0, 255] at wall-plane coords (u, v) meters."""
    s = seed * 7 + face_id
    # Random-luminance cell grids at several pitches: corner-rich at any
    # viewing distance (0.25 m cells for far walls down to 0.03 m for
    # close-up surfaces), plus smooth value noise for low-frequency
    # variation.
    cells = _hash2(np.floor(u / 0.25).astype(np.int64), np.floor(v / 0.25).astype(np.int64), s)
    cells2 = _hash2(np.floor(u / 0.08).astype(np.int64), np.floor(v / 0.08).astype(np.int64), s + 4)
    cells3 = _hash2(np.floor(u / 0.03).astype(np.int64), np.floor(v / 0.03).astype(np.int64), s + 5)
    t = 0.34 * cells + 0.22 * cells2 + 0.12 * cells3
    t = t + 0.22 * _value_noise(u, v, 0.40, s + 1)
    t = t + 0.10 * _value_noise(u, v, 0.10, s + 2)
    return 30.0 + 200.0 * t


def _default_boxes(size):
    """Furniture: boxes protruding from the +z wall INTO the camera's
    forward frustum (the default trajectory looks down +z from around
    (2.5, 1.5, 3) with a ~62x48 deg FOV, so free-standing furniture
    near other walls is never visible). Multiple depth layers break the
    single-plane yaw/translation ambiguity that otherwise makes
    point-based pose estimation ill-conditioned."""
    sx, sy, sz = size
    return [
        # (min_corner, max_corner) — all flush against the z = sz wall.
        ((1.1, 0.6, 4.6), (2.1, 1.5, sz)),   # upper-left cabinet
        ((2.9, 1.4, 4.2), (3.9, 2.4, sz)),   # right shelf, deep
        ((2.0, 1.9, 5.0), (2.9, 2.7, sz)),   # lower-middle block
        ((1.4, 2.1, 4.4), (2.0, 2.6, sz)),   # lower-left column
        ((3.2, 0.3, 5.0), (4.2, 1.1, sz)),   # upper-right box
        ((0.3, 1.0, 4.8), (0.9, 2.2, sz)),   # far-left column
    ]


def loop_room_boxes(size):
    """Furniture flush against ALL FOUR vertical walls — the scene for
    circuit (loop-closure) trajectories, where the camera faces every
    wall in turn and needs multi-depth structure everywhere (the
    single-wall `_default_boxes` layout leaves three walls bare, which
    makes sideways views nearly planar and pose estimation
    ill-conditioned)."""
    sx, sy, sz = size
    out = []
    # +z wall (same spirit as _default_boxes, scaled to the room).
    out += [
        ((0.15 * sx, 0.20 * sy, sz - 1.4), (0.35 * sx, 0.55 * sy, sz)),
        ((0.55 * sx, 0.45 * sy, sz - 1.8), (0.75 * sx, 0.80 * sy, sz)),
        ((0.40 * sx, 0.62 * sy, sz - 1.0), (0.52 * sx, 0.90 * sy, sz)),
    ]
    # -z wall.
    out += [
        ((0.20 * sx, 0.30 * sy, 0.0), (0.42 * sx, 0.70 * sy, 1.5)),
        ((0.60 * sx, 0.15 * sy, 0.0), (0.82 * sx, 0.50 * sy, 1.1)),
    ]
    # +x wall.
    out += [
        ((sx - 1.3, 0.25 * sy, 0.20 * sz), (sx, 0.60 * sy, 0.38 * sz)),
        ((sx - 0.9, 0.50 * sy, 0.55 * sz), (sx, 0.85 * sy, 0.72 * sz)),
    ]
    # -x wall.
    out += [
        ((0.0, 0.35 * sy, 0.30 * sz), (1.2, 0.75 * sy, 0.48 * sz)),
        ((0.0, 0.10 * sy, 0.62 * sz), (0.8, 0.45 * sy, 0.80 * sz)),
    ]
    return out


def loop_walkers(n_frames: int, room=(8.0, 3.0, 10.0), laps: float = 1.125,
                 n_objects: int = 2, margin: float = 2.2,
                 style: str = "stand_drift"):
    """(N, M, 2, 3) per-frame AABBs of person-sized 'walkers' circulating
    the room AHEAD of the `loop_trajectory` camera — the bench-scale
    analogue of the walking people in TUM fr3_walking (the reference's
    headline dynamic sequence, reference README.md:133-163). Each walker
    keeps a phase lead on (a scaled copy of) the camera's ellipse, so it
    is in the tangent-looking camera's view for long stretches; at
    ~1.5-3 m range a 0.5 x 1.55 m box spans 90-250 px — fr3_walking-
    person image coverage.

    `style`:
      * "sway" — continuous fast oscillation along the path (~5-10 px
        apparent motion/frame). Fast coherent motion is what per-frame
        chi2 gating rejects on its own, so this style measures mask
        COST more than benefit.
      * "stand_drift" — the DynaSLAM failure mode (and the reason the
        reference's geometry mask exists, Geometry.cc): each walker
        STANDS for ~1.5 s (long enough to be mapped into keyframes as
        'static' landmarks) then DRIFTS slowly (~2-3 px/frame apparent
        — inside the per-frame chi2 gate), dragging the pose estimate
        with it; then stands again. Per-frame outlier rejection cannot
        catch the drift; multi-view depth-reprojection (geommask) can.
    """
    sx, sy, sz = room
    a = sx / 2 - margin
    b = sz / 2 - margin
    specs = [
        # (radial scale, base phase lead, sway amp, sway freq, width)
        (1.00, 1.15, 0.14, 1.7, 0.50),
        (1.22, 0.95, 0.12, 2.3, 0.45),
        (0.85, 1.45, 0.15, 1.2, 0.42),
    ][:n_objects]
    rng = np.random.default_rng(5)
    # Per-walker stand/drift schedule: alternating segments (lengths in
    # frames at the bench's 337-frame scale, scaled with n_frames).
    scale = n_frames / 337.0
    schedules = []
    for m in range(len(specs)):
        stand = max(int((40 + 12 * m) * scale), 4)
        drift = max(int((44 - 6 * m) * scale), 4)
        # Accumulated phase-lead offset over time: 0 during stands,
        # linear slope during drifts (alternating direction).
        off = np.zeros(n_frames, np.float32)
        cur = 0.0
        i = 0
        k = 0
        rate = 0.0042 / scale  # rad/frame -> ~2.5 px/frame at 2.3 m
        while i < n_frames:
            hold = stand if k % 2 == 0 else drift
            sgn = -1.0 if (k // 2) % 2 == 0 else 1.0
            for j in range(i, min(i + hold, n_frames)):
                if k % 2 == 1:
                    cur += sgn * rate
                off[j] = cur
            i += hold
            k += 1
        schedules.append(off)
    out = np.zeros((n_frames, len(specs), 2, 3), np.float32)
    for i in range(n_frames):
        th = 2 * np.pi * laps * i / n_frames
        t = i / max(n_frames - 1, 1)
        for m, (f, lead, amp, freq, wdt) in enumerate(specs):
            if style == "sway":
                phw = th + lead + amp * np.sin(2 * np.pi * freq * t * laps)
                bob = 0.05 * np.sin(7.0 * th + m)
            else:
                phw = th + lead + schedules[m][i]
                bob = 0.0
            xw = sx / 2 + f * a * np.sin(phw)
            zw = sz / 2 + f * b * np.cos(phw)
            # Standing on the floor (y down, floor at y=sy): 1.55 m tall.
            y_top = sy - 1.55 + bob
            out[i, m, 0] = (xw - wdt / 2, y_top, zw - wdt / 2)
            out[i, m, 1] = (xw + wdt / 2, sy, zw + wdt / 2)
    return out


def sway_trajectory(n_frames: int, room=(8.0, 3.0, 10.0)):
    """fr3_walking-style trajectory: the camera hovers near the room
    center, gently swaying (lateral/vertical sinusoids, ~1 cm/frame) and
    yawing a few degrees while looking at the furnished +z wall. The
    reference's headline dynamic sequences have exactly this regime —
    a quasi-static camera with people crossing the view (TUM
    fr3_walking; reference README.md:133-163). Returns (n, 4, 4)
    camera-to-world poses."""
    sx, sy, sz = room
    poses = []
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        x = sx / 2 + 0.40 * np.sin(2 * np.pi * 1.7 * t)
        y = sy / 2 + 0.10 * np.sin(2 * np.pi * 1.1 * t + 0.7)
        z = 0.55 * sz + 0.15 * np.sin(2 * np.pi * 0.8 * t)
        yaw = 0.10 * np.sin(2 * np.pi * 1.3 * t)
        pitch = 0.04 * np.sin(2 * np.pi * 0.9 * t + 1.3)
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        R_yaw = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
        R_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = (R_yaw @ R_pitch).astype(np.float32)
        T[:3, 3] = [x, y, z]
        poses.append(T)
    return np.stack(poses)


def cross_walkers(n_frames: int, room=(8.0, 3.0, 10.0), n_objects: int = 2):
    """(N, M, 2, 3) per-frame AABBs of person-sized walkers CROSSING the
    sway_trajectory camera's view in front of the +z wall, with walk /
    stand cycles — the fr3_walking failure mode: while standing they are
    mapped as 'static' landmarks; walking at ~0.4 m/s (2-4 px/frame at
    2-3 m) they drag per-frame pose estimation, too slow for chi2
    rejection to excise cleanly. Multi-view depth reprojection
    (dynamic/geommask.py, the reference's Geometry.cc) catches both
    phases."""
    sx, sy, sz = room
    cam_z = 0.55 * sz
    specs = [
        # (z plane, x start, x span, phase, stand fraction, width, fast)
        (cam_z + 1.6, sx / 2 - 1.6, 3.0, 0.00, 0.30, 0.75, False),
        (cam_z + 2.4, sx / 2 + 1.7, -3.5, 0.45, 0.25, 0.80, False),
        # A BRISK continuous crosser (~10 px/frame at the bench's 337
        # frames): fast coherent motion is what the FLOW mask catches
        # (and slow stand/drift is what only the geometry mask catches)
        # — together they reproduce the reference's mask hierarchy
        # (flow partial, geom full; README.md:133-153).
        (cam_z + 1.35, sx / 2 - 1.2, 2.4, 0.30, 0.00, 0.55, True),
    ][:n_objects]
    out = np.zeros((n_frames, len(specs), 2, 3), np.float32)
    for i in range(n_frames):
        t = i / max(n_frames - 1, 1)
        for m, (zw, x0, span, phase, stand_frac, wdt, fast) in enumerate(specs):
            if fast:
                # Triangle wave: 2.5 full crossings over the run.
                u = (2.5 * t + phase) % 1.0
                prog = 2 * u if u < 0.5 else 2 * (1 - u)
            else:
                # Walk progress with embedded stands: a piecewise-linear
                # "stop-and-go" profile built from a clamped sawtooth.
                cyc = (t + phase) % 1.0
                # Two stand windows per pass.
                u = cyc
                for s0 in (0.22, 0.62):
                    if u > s0:
                        u_seg = min(u, s0 + stand_frac / 2) - s0
                        u = u - u_seg  # standing does not advance
                prog = u / (1.0 - stand_frac)
                prog = min(max(prog, 0.0), 1.0)
            xw = x0 + span * prog
            out[i, m, 0] = (xw - wdt / 2, sy - 1.6, zw - wdt / 2)
            out[i, m, 1] = (xw + wdt / 2, sy, zw + wdt / 2)
    return out


def loop_trajectory(n_frames: int, room=(8.0, 3.0, 10.0),
                    laps: float = 1.125, margin: float = 2.2,
                    look_ahead: float = 0.35):
    """Circuit trajectory: the camera walks an ellipse around the room
    interior, heading along the path tangent (like a person surveying a
    room), and OVERSHOOTS the full lap by `laps - 1` so it re-observes
    its starting views — the loop-closure regime (the reference's
    headline sequences are exactly such revisits). Per-frame motion at
    n_frames=120 is ~3.4 deg yaw + ~15 cm translation: enough view
    turnover to drive the keyframe cadence near the reference's ~1
    KF/8-10 frames instead of the gentle orbit's 4-KF idle.

    Returns (n, 4, 4) camera-to-world poses."""
    sx, sy, sz = room
    a = sx / 2 - margin
    b = sz / 2 - margin
    poses = []
    for i in range(n_frames):
        th = 2 * np.pi * laps * i / n_frames
        x = sx / 2 + a * np.sin(th)
        z = sz / 2 + b * np.cos(th)
        y = sy / 2 + 0.08 * np.sin(3.1 * th)
        # Tangent heading (d/dth of position), slightly smoothed ahead.
        tx = a * np.cos(th + look_ahead)
        tz = -b * np.sin(th + look_ahead)
        yaw = np.arctan2(tx, tz)  # camera +z forward
        pitch = 0.04 * np.sin(2.3 * th)
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        R_yaw = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
        R_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = (R_yaw @ R_pitch).astype(np.float32)
        T[:3, 3] = [x, y, z]
        poses.append(T)
    return np.stack(poses)


@dataclass
class BoxRoom:
    """Axis-aligned box room [0,sx]x[0,sy]x[0,sz] with box "furniture",
    camera inside. World frame: x right, y down (floor at y=sy), z fwd.
    """

    size: tuple = (5.0, 3.0, 6.0)
    seed: int = 17
    cam: CameraConfig = field(default_factory=CameraConfig)
    boxes: list = None

    def __post_init__(self):
        if self.boxes is None:
            self.boxes = _default_boxes(self.size)

    def render(self, T_wc: np.ndarray, depth_noise: float = 0.0, rng=None, ss: int = 3):
        """Render (gray (H,W) f32 [0,255], depth (H,W) f32 meters) from a
        camera-to-world pose.

        `ss`: gray-channel supersampling factor (ss x ss rays per pixel,
        box-filtered). Without it the point-sampled procedural texture
        aliases, and FAST corners drift 1-2 cm (world units) between
        viewpoints — several times worse than real-camera corner
        stability — which destabilizes any tracker run on this data.
        Depth uses the center ray (real depth sensors do not average
        across silhouettes)."""
        gray = None
        for iy in range(ss):
            for ix in range(ss):
                du = (ix + 0.5) / ss - 0.5
                dv = (iy + 0.5) / ss - 0.5
                g, d = self._render_once(T_wc, du, dv)
                gray = g if gray is None else gray + g
                if abs(du) < 0.5 / ss and abs(dv) < 0.5 / ss:
                    depth = d
        gray = gray / (ss * ss)
        if ss % 2 == 0:  # no exact center ray: render it for depth
            _, depth = self._render_once(T_wc, 0.0, 0.0)
        if depth_noise > 0.0 and rng is not None:
            depth = depth + rng.normal(0.0, depth_noise, depth.shape).astype(np.float32) * depth
            depth = np.maximum(depth, 0.0)
        return gray, depth

    def _render_once(self, T_wc: np.ndarray, du: float = 0.0, dv: float = 0.0):
        cam = self.cam
        h, w = cam.height, cam.width
        u, v = np.meshgrid(
            np.arange(w, dtype=np.float32) + du, np.arange(h, dtype=np.float32) + dv
        )
        dirs_c = np.stack(
            [(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy, np.ones_like(u)], axis=-1
        )  # (H, W, 3), unnormalized so t == z-depth
        R = T_wc[:3, :3].astype(np.float32)
        o = T_wc[:3, 3].astype(np.float32)
        dirs_w = dirs_c @ R.T  # (H, W, 3)

        sx, sy, sz = self.size
        bounds = np.array([[0.0, sx], [0.0, sy], [0.0, sz]], dtype=np.float32)
        t_best = np.full((h, w), np.inf, dtype=np.float32)
        face_best = np.full((h, w), -1, dtype=np.int32)

        # Room walls (viewed from inside).
        for axis in range(3):
            for side in range(2):
                d = dirs_w[..., axis]
                denom = np.where(np.abs(d) < 1e-9, 1e-9, d)
                t = (bounds[axis, side] - o[axis]) / denom
                ok = t > 1e-6
                hit = o[None, None, :] + t[..., None] * dirs_w
                for other in range(3):
                    if other == axis:
                        continue
                    ok &= (hit[..., other] >= -1e-4) & (hit[..., other] <= bounds[other, 1] + 1e-4)
                closer = ok & (t < t_best)
                t_best = np.where(closer, t, t_best)
                face_best = np.where(closer, axis * 2 + side, face_best)

        # Boxes (viewed from outside): slab method.
        for bi, (bmin, bmax) in enumerate(self.boxes):
            bmin = np.asarray(bmin, np.float32)
            bmax = np.asarray(bmax, np.float32)
            denom = np.where(np.abs(dirs_w) < 1e-9, 1e-9, dirs_w)
            t1 = (bmin[None, None, :] - o) / denom
            t2 = (bmax[None, None, :] - o) / denom
            tlo = np.minimum(t1, t2)
            thi = np.maximum(t1, t2)
            # The reductions over the 3 slabs as elementwise chains: the
            # same values as `tlo.max(-1)`, `thi.min(-1)` and the first
            # `argmax`, at a twentieth of the cost of numpy's reductions
            # over a last axis of 3 (they took 40% of a view's render).
            tnear = np.maximum(np.maximum(tlo[..., 0], tlo[..., 1]), tlo[..., 2])
            tfar = np.minimum(np.minimum(thi[..., 0], thi[..., 1]), thi[..., 2])
            enter_axis = np.where(tlo[..., 0] == tnear, 0, np.where(tlo[..., 1] == tnear, 1, 2))
            hit_ok = (tnear > 1e-6) & (tnear <= tfar)
            closer = hit_ok & (tnear < t_best)
            t_best = np.where(closer, tnear, t_best)
            face_best = np.where(closer, 6 + bi * 3 + enter_axis, face_best)

        hit = o[None, None, :] + t_best[..., None] * dirs_w
        gray = np.zeros((h, w), dtype=np.float32)
        for axis in range(3):
            uax, vax = [a for a in range(3) if a != axis]
            for side in range(2):
                fid = axis * 2 + side
                m = face_best == fid
                if np.any(m):
                    gray[m] = _texture(hit[..., uax][m], hit[..., vax][m], fid, self.seed)
        for bi in range(len(self.boxes)):
            for axis in range(3):
                fid = 6 + bi * 3 + axis
                m = face_best == fid
                if np.any(m):
                    uax, vax = [a for a in range(3) if a != axis]
                    gray[m] = _texture(hit[..., uax][m], hit[..., vax][m], fid, self.seed)

        depth = t_best.copy()  # t == camera z-depth by construction
        depth[~np.isfinite(depth)] = 0.0
        return gray, depth


def orbit_trajectory(n_frames: int, room=(5.0, 3.0, 6.0), radius: float = 0.4,
                     step: float = 0.012, yaw_amp: float = 0.12):
    """Smooth exploratory trajectory inside the room: forward drift with
    lateral sinusoid and gentle yaw. Returns (n, 4, 4) camera-to-world."""
    sx, sy, sz = room
    poses = []
    for i in range(n_frames):
        t = i * step
        x = sx / 2 + radius * np.sin(0.7 * t * 2 * np.pi)
        y = sy / 2 + 0.1 * np.sin(0.4 * t * 2 * np.pi)
        z = sz / 2 + 0.45 * np.sin(0.35 * t * 2 * np.pi)
        yaw = yaw_amp * np.sin(0.5 * t * 2 * np.pi)
        pitch = 0.05 * np.sin(0.3 * t * 2 * np.pi)
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        R_yaw = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
        R_pitch = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = (R_yaw @ R_pitch).astype(np.float32)
        T[:3, 3] = [x, y, z]
        poses.append(T)
    return np.stack(poses)


@dataclass
class SyntheticSequence:
    """Drop-in stand-in for TumSequence with exact ground truth.

    With ``dynamic_objects=True`` a textured box sweeps laterally through
    the view (the synthetic analogue of the walking people in TUM
    fr3_walking) — the scene every dynamic-filter test runs on. The
    ground-truth dynamic pixel mask is available via `dynamic_mask(i)`.
    """

    n_frames: int = 60
    cam: CameraConfig = field(default_factory=CameraConfig)
    seed: int = 17
    depth_noise: float = 0.0
    fps: float = 30.0
    dynamic_objects: bool = False
    # "orbit": the original gentle exploratory drift (few keyframes).
    # "loop": circuit around a larger four-wall-furnished room with a
    # revisit overshoot — reference-like keyframe cadence + loop closure.
    trajectory: str = "orbit"
    room_size: tuple | None = None
    # Circuit laps for trajectory="loop": the fraction beyond 1.0 is the
    # revisit overshoot (1.35 = 126 deg of re-observed territory, enough
    # keyframes there for the 3-consecutive-consistency loop gate).
    loop_laps: float = 1.125

    def __post_init__(self):
        if self.trajectory == "loop":
            size = self.room_size or (8.0, 3.0, 10.0)
            self.room = BoxRoom(
                size=size, seed=self.seed, cam=self.cam,
                boxes=loop_room_boxes(size),
            )
            self.poses_wc = loop_trajectory(self.n_frames, size,
                                            laps=self.loop_laps)
        elif self.trajectory == "sway":
            size = self.room_size or (8.0, 3.0, 10.0)
            self.room = BoxRoom(
                size=size, seed=self.seed, cam=self.cam,
                boxes=loop_room_boxes(size),
            )
            self.poses_wc = sway_trajectory(self.n_frames, size)
        else:
            size = self.room_size or (5.0, 3.0, 6.0)
            self.room = BoxRoom(size=size, seed=self.seed, cam=self.cam)
            self.poses_wc = orbit_trajectory(self.n_frames, size)
        self.stamps = np.arange(self.n_frames) / self.fps
        self._rng = np.random.default_rng(self.seed)

    # How many moving objects the dynamic scene carries (1-3). Three
    # objects at ~1-1.5 m cover 20-30% of typical frames — the
    # aggressive-dynamics regime of fr3_walking (VERDICT r2 #4).
    n_dynamic: int = 1

    def _moving_box(self, i: int):
        """A 0.5 x 0.9 x 0.4 box crossing the camera's forward view at
        0.9 m/s, ~1 m in front of the camera (apparent motion ~15 px per
        frame at 30 fps — comparable to a person walking through the
        fr3_walking views)."""
        t = i / self.fps
        x0 = 1.6 + 0.9 * t
        return ((x0, 1.1, 3.9), (x0 + 0.5, 2.0, 4.3))

    def _moving_boxes(self, i: int):
        """1-3 moving boxes (n_dynamic): the classic crosser plus an
        opposite-direction walker and a slow riser."""
        t = i / self.fps
        out = [self._moving_box(i)]
        if self.n_dynamic >= 2:
            x1 = 3.4 - 0.7 * t
            out.append(((x1, 0.6, 4.1), (x1 + 0.45, 1.6, 4.5)))
        if self.n_dynamic >= 3:
            y2 = 2.1 - 0.35 * t
            out.append(((2.2, y2, 4.35), (2.8, y2 + 0.8, 4.75)))
        return out

    def __len__(self):
        return self.n_frames

    def gray_depth(self, i: int):
        if self.dynamic_objects:
            saved = self.room.boxes
            self.room.boxes = saved + self._moving_boxes(i)
            try:
                return self.room.render(self.poses_wc[i], self.depth_noise, self._rng)
            finally:
                self.room.boxes = saved
        return self.room.render(self.poses_wc[i], self.depth_noise, self._rng)

    def dynamic_mask(self, i: int):
        """(H, W) bool ground truth: True where a moving object is
        visible (difference of the two depth renders)."""
        if not self.dynamic_objects:
            return np.zeros((self.cam.height, self.cam.width), bool)
        _, d_static = self.room.render(self.poses_wc[i], ss=1)
        saved = self.room.boxes
        self.room.boxes = saved + self._moving_boxes(i)
        try:
            _, d_dyn = self.room.render(self.poses_wc[i], ss=1)
        finally:
            self.room.boxes = saved
        return np.abs(d_dyn - d_static) > 1e-4

    def __getitem__(self, i: int):
        gray, depth = self.gray_depth(i)
        rgb = np.repeat(gray[..., None], 3, axis=-1).astype(np.uint8)
        return float(self.stamps[i]), rgb, depth

    def gt_positions(self):
        return self.poses_wc[:, :3, 3]
