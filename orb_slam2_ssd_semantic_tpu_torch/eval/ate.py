"""Absolute trajectory error evaluation.

Behavioral equivalent of the reference's tool/evaluate_ate.py: associate
estimated and ground-truth trajectories by timestamp (max_difference
0.02 s), align with the closed-form Horn/Umeyama estimator, report
translational error statistics. Host-side float64 numpy (the reference evaluator is numpy doubles);
the on-device f32 twin of the alignment core is `horn_sim3` in
geometry/se3.py.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from orb_slam2_ssd_semantic_tpu_torch.io.tum import associate, read_trajectory


@dataclass
class AteResult:
    rmse: float
    mean: float
    median: float
    std: float
    min: float
    max: float
    n_pairs: int
    scale: float

    def __repr__(self):
        return (
            f"AteResult(rmse={self.rmse:.6f} m, mean={self.mean:.6f}, "
            f"median={self.median:.6f}, std={self.std:.6f}, min={self.min:.6f}, "
            f"max={self.max:.6f}, n={self.n_pairs}, s={self.scale:.4f})"
        )


def ate_statistics(errors: np.ndarray, n: int, scale: float) -> AteResult:
    return AteResult(
        rmse=float(np.sqrt(np.mean(errors**2))),
        mean=float(np.mean(errors)),
        median=float(np.median(errors)),
        std=float(np.std(errors)),
        min=float(np.min(errors)),
        max=float(np.max(errors)),
        n_pairs=n,
        scale=scale,
    )


def horn_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Closed-form alignment dst ~ s*R*src + t (Horn / Umeyama), float64.

    Mirrors evaluate_ate.py `align` (with_scale=False) and `align_sim3`
    (True). Returns (s, R, t)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    sc = src - mu_s
    dc = dst - mu_d
    n = src.shape[0]
    C = dc.T @ sc / n
    var_s = (sc * sc).sum() / n
    U, D, Vt = np.linalg.svd(C)
    S = np.ones(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2] = -1.0
    R = U @ np.diag(S) @ Vt
    s = float((D * S).sum() / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def evaluate_ate_xyz(est_xyz: np.ndarray, gt_xyz: np.ndarray, with_scale: bool = False) -> AteResult:
    """ATE between already-associated position arrays (N,3). Alignment
    maps est -> gt frame; float64 like the reference's numpy evaluator."""
    est = np.asarray(est_xyz, dtype=np.float64)
    gt = np.asarray(gt_xyz, dtype=np.float64)
    s, R, t = horn_align(est, gt, with_scale=with_scale)
    aligned = s * est @ R.T + t
    errors = np.linalg.norm(aligned - gt, axis=-1)
    return ate_statistics(errors, est.shape[0], float(s))


def evaluate_ate(
    gt_file: str,
    est_file: str,
    offset: float = 0.0,
    max_difference: float = 0.02,
    with_scale: bool = False,
) -> AteResult:
    """File-level entry point matching `python evaluate_ate.py gt est`."""
    gt_stamps, gt_t, _ = read_trajectory(gt_file)
    est_stamps, est_t, _ = read_trajectory(est_file)
    matches = associate(gt_stamps, est_stamps, offset, max_difference)
    if len(matches) < 2:
        raise ValueError("trajectories do not overlap")
    gi = np.array([a for a, _ in matches])
    ei = np.array([b for _, b in matches])
    # evaluate_ate.py aligns est (model) onto gt (data).
    return evaluate_ate_xyz(est_t[ei], gt_t[gi], with_scale=with_scale)


def main(argv=None):
    """CLI twin of `python evaluate_ate.py gt.txt est.txt` (tool/evaluate_ate.py)."""
    import argparse

    p = argparse.ArgumentParser(description="Absolute trajectory error (TUM format)")
    p.add_argument("gt_file")
    p.add_argument("est_file")
    p.add_argument("--offset", type=float, default=0.0)
    p.add_argument("--max_difference", type=float, default=0.02)
    p.add_argument("--sim3", action="store_true", help="Umeyama alignment with scale")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    res = evaluate_ate(
        args.gt_file, args.est_file, args.offset, args.max_difference, with_scale=args.sim3
    )
    if args.verbose:
        print(f"compared_pose_pairs {res.n_pairs} pairs")
        print(f"absolute_translational_error.rmse {res.rmse:.6f} m")
        print(f"absolute_translational_error.mean {res.mean:.6f} m")
        print(f"absolute_translational_error.median {res.median:.6f} m")
        print(f"absolute_translational_error.std {res.std:.6f} m")
        print(f"absolute_translational_error.min {res.min:.6f} m")
        print(f"absolute_translational_error.max {res.max:.6f} m")
    else:
        print(f"{res.rmse:.6f}")
    return res


if __name__ == "__main__":
    main()


def evaluate_rpe_xyz(
    est_t: np.ndarray, est_q: np.ndarray, gt_t: np.ndarray, gt_q: np.ndarray, delta: int = 1
):
    """Relative pose error over a fixed frame delta (translational drift
    per step). Complements ATE the way TUM's evaluate_rpe.py does."""

    def to_mats(t, q):
        t = np.asarray(t, dtype=np.float64)
        q = np.asarray(q, dtype=np.float64)
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        R = np.stack(
            [
                np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
                np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
                np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
            ],
            axis=-2,
        )
        T = np.tile(np.eye(4), (len(t), 1, 1))
        T[:, :3, :3] = R
        T[:, :3, 3] = t
        return T

    def inv(T):
        Ti = np.tile(np.eye(4), (len(T), 1, 1))
        Rt = np.swapaxes(T[:, :3, :3], -1, -2)
        Ti[:, :3, :3] = Rt
        Ti[:, :3, 3] = -np.einsum("nij,nj->ni", Rt, T[:, :3, 3])
        return Ti

    E = to_mats(est_t, est_q)
    G = to_mats(gt_t, gt_q)
    rel_e = inv(E[:-delta]) @ E[delta:]
    rel_g = inv(G[:-delta]) @ G[delta:]
    err = inv(rel_g) @ rel_e
    trans_err = np.linalg.norm(err[:, :3, 3], axis=-1)
    return ate_statistics(trans_err, len(trans_err), 1.0)
