"""The plain reference the benchmark judges the port's answers by: the
scene's exact camera trajectory and the room's surfaces, in numpy
(float64), from the frozen scene alone. It imports nothing of the port.

A SLAM run answers in its own world frame, the first camera's. Its
camera centres are compared after the evaluator's rigid fit (`eval/ate.py`
in the port, Horn and Umeyama without scale); its steps, keyframes and
map points need no fit: each is compared in its own camera's frame.
"""

from __future__ import annotations

import numpy as np


def _box_distance(p: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(P, B) distance of points p (P, 1, 3) to the surfaces of solid
    boxes [lo, hi] (P or 1, B, 3)."""
    gap = np.maximum(np.maximum(lo - p, p - hi), 0.0)
    outside = np.linalg.norm(gap, axis=2)
    depth_in = np.minimum(p - lo, hi - p).min(axis=2)  # > 0 inside a box
    return np.where(outside > 0.0, outside, np.maximum(depth_in, 0.0))


def surface_distance(points: np.ndarray, room, boxes: np.ndarray,
                     moving: np.ndarray | None = None) -> np.ndarray:
    """(P,) distance of each point to the nearest surface: the room's six
    walls (seen from inside), its furniture boxes (solid) and, where given,
    each point's own moving boxes `moving` (P, M, 2, 3): the walkers where
    they stood when the point's keyframe saw them."""
    p = np.asarray(points, np.float64)
    size = np.asarray(room, np.float64)
    inside = np.minimum(p, size - p)  # (P, 3) to each wall pair; < 0 outside
    out_room = np.linalg.norm(np.maximum(-inside, 0.0), axis=1)
    d = np.where(out_room > 0.0, out_room, inside.min(axis=1))
    b = np.asarray(boxes, np.float64).reshape(-1, 2, 3)
    if len(b):
        d = np.minimum(d, _box_distance(p[:, None], b[None, :, 0], b[None, :, 1]).min(axis=1))
    if moving is not None and moving.shape[1]:
        m = np.asarray(moving, np.float64)
        d = np.minimum(d, _box_distance(p[:, None], m[:, :, 0], m[:, :, 1]).min(axis=1))
    return d


def rigid_fit(src: np.ndarray, dst: np.ndarray):
    """(R, t) minimising sum |R src_i + t - dst_i|^2 (Horn, Umeyama
    without scale), float64."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(axis=0), dst.mean(axis=0)
    U, _, Vt = np.linalg.svd((dst - mu_d).T @ (src - mu_s) / src.shape[0])
    S = np.ones(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2] = -1.0
    R = U @ np.diag(S) @ Vt
    return R, mu_d - R @ mu_s


def inv_se3(T: np.ndarray) -> np.ndarray:
    """Inverses of (..., 4, 4) rigid transforms."""
    T = np.asarray(T, np.float64)
    R = np.swapaxes(T[..., :3, :3], -1, -2)
    out = np.zeros(T.shape)
    out[..., :3, :3] = R
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", R, T[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out


def step_errors(W_est: np.ndarray, W_true: np.ndarray) -> np.ndarray:
    """Each step's translation error between consecutive camera-to-world
    poses, in the earlier camera's axes (n-1,)."""
    A = inv_se3(W_est[:-1]) @ W_est[1:]
    B = inv_se3(W_true[:-1]) @ np.asarray(W_true[1:], np.float64)
    return np.linalg.norm(A[:, :3, 3] - B[:, :3, 3], axis=1)


def rigidity(T: np.ndarray) -> np.ndarray:
    """|R^T R - I|_F of each (..., 4, 4) pose's rotation block: 0 for a
    rotation, and a true pose is one."""
    R = np.asarray(T, np.float64)[..., :3, :3]
    return np.linalg.norm(np.swapaxes(R, -1, -2) @ R - np.eye(3), axis=(-2, -1))


def rotation_errors_deg(W_est: np.ndarray, W_true: np.ndarray) -> np.ndarray:
    """Each frame's angle (degrees) between its answered and its true
    rotation, both taken relative to the first frame's (n,): no fit, so
    an answer that does not turn reads the whole true turn."""
    R_est = np.asarray(W_est, np.float64)[:, :3, :3]
    R_true = np.asarray(W_true, np.float64)[:, :3, :3]
    rel_est = np.swapaxes(R_est[:1], -1, -2) @ R_est
    rel_true = np.swapaxes(R_true[:1], -1, -2) @ R_true
    gap = np.swapaxes(rel_true, -1, -2) @ rel_est
    cos = (np.trace(gap, axis1=-2, axis2=-1) - 1.0) / 2.0
    return np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))


def ate_rmse(est: np.ndarray, true: np.ndarray) -> float:
    """The evaluator's ATE: RMS of the gaps between answered and true
    camera centres (n, 3) after the rigid fit of the one onto the other."""
    R, t = rigid_fit(est, true)
    return float(np.sqrt(np.mean(np.sum((est @ R.T + t - true) ** 2, axis=1))))


def judge(T_cw: np.ndarray, W_true: np.ndarray, kf_T_cw: np.ndarray, kf_W_true: np.ndarray,
          points: np.ndarray, point_kf: np.ndarray, room, boxes: np.ndarray,
          kf_moving: np.ndarray | None = None, first: int = 0) -> dict:
    """The numbers one job or session is judged by.

    `T_cw` (n, 4, 4): the answered world-to-camera pose of each frame,
    `W_true` (n, 4, 4) the true camera-to-world ones; `kf_T_cw` and
    `kf_W_true` (k, 4, 4) the map's keyframes at the end, in order of
    insertion, and their frames' true poses; `points` (p, 3) the map's
    points, each with the index `point_kf` (p,) of its reference keyframe
    in those arrays; `kf_moving` (k, M, 2, 3) the walkers' boxes at each
    keyframe's frame, surfaces too for the points it made. Frames before
    `first` are context, not judged.

    - `rigid_err_max`: the largest |R^T R - I|_F of an answered pose or a
      keyframe's pose (a true pose is a rigid motion);
    - `ate_rmse_m`: the evaluator's ATE of the answered camera centres;
    - `step_err_max_m`: the widest gap between an answered step from one
      frame to the next and the true step, in the earlier camera's axes;
    - `rot_err_max_deg`: the widest angle between an answered and the
      true rotation, each relative to the first judged frame's;
    - `kf_step_err_max_m`: the same between consecutive keyframes (0 with
      one keyframe);
    - `map_local_err_p90_m`: the 90th percentile of the distance of each
      map point to the nearest surface, the point carried into the scene
      through its reference keyframe's true pose.
    Anything not finite, or a map with no point or keyframe, reads
    infinity."""
    inf = float("inf")
    T_cw = np.asarray(T_cw, np.float64)[first:]
    W_true = np.asarray(W_true, np.float64)[first:]
    kf_T_cw = np.asarray(kf_T_cw, np.float64).reshape(-1, 4, 4)
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    names = ("rigid_err_max", "ate_rmse_m", "step_err_max_m", "rot_err_max_deg",
             "kf_step_err_max_m", "map_local_err_p90_m")
    if not (np.isfinite(T_cw).all() and np.isfinite(kf_T_cw).all() and np.isfinite(pts).all()
            ) or not len(kf_T_cw) or not len(pts):
        return dict.fromkeys(names, inf)
    W = inv_se3(T_cw)
    kf_steps = step_errors(inv_se3(kf_T_cw), kf_W_true) if len(kf_T_cw) > 1 else np.zeros(1)
    moving = None if kf_moving is None else np.asarray(kf_moving)[point_kf]
    # A point through its keyframe: est world -> keyframe camera -> true world.
    local = np.einsum("pij,pj->pi", (np.asarray(kf_W_true) @ kf_T_cw)[point_kf],
                      np.concatenate([pts, np.ones((len(pts), 1))], axis=1))[:, :3]
    return {
        "rigid_err_max": float(max(rigidity(T_cw).max(), rigidity(kf_T_cw).max())),
        "ate_rmse_m": ate_rmse(W[:, :3, 3], W_true[:, :3, 3]),
        "step_err_max_m": float(step_errors(W, W_true).max()) if len(W) > 1 else 0.0,
        "rot_err_max_deg": float(rotation_errors_deg(W, W_true).max()),
        "kf_step_err_max_m": float(kf_steps.max()),
        "map_local_err_p90_m": float(np.quantile(surface_distance(local, room, boxes, moving),
                                                 0.9)),
    }
