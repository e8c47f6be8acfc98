"""Monocular map initialization: homography and fundamental RANSAC, model
choice and two-view reconstruction (counterpart of the JAX package's
`mapping/initializer.py`; the reference's Initializer,
perfect/src/Initializer.cc).

Both models are scored as one batched problem each (all hypotheses in one
(S, N) residual matrix), the essential matrix decomposes in closed form,
and the four (R, t) candidates are ranked by batched triangulation checks.
As in the JAX version, the reconstruction always goes through F; the
homography's inlier count only names the model (score ratio over 0.45).

Sampling is split from scoring, as in `ops/homography.py`: the minimal
sets come from `homography.sample_minimal_sets` (a CPU generator, seed 0
for the homography's 4-point sets, 1 for the fundamental's 8-point sets;
JAX splits `PRNGKey(0)` into two keys), and the scorers take the sets, so
the tests can hand them JAX's own draws.
"""

from __future__ import annotations

import math

import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.ops.homography import (
    find_homography_ransac,
    sample_minimal_sets,
)
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import f32_reciprocal

F_SEED = 1


def _normalized(uv: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Normalized camera coordinates; the divisions by the focal lengths
    are products with their f32 reciprocals, as XLA compiles them."""
    return torch.stack([(uv[..., 0] - cam.cx) * f32_reciprocal(cam.fx),
                        (uv[..., 1] - cam.cy) * f32_reciprocal(cam.fy)], dim=-1)


def _sqrt2_over(x: torch.Tensor) -> torch.Tensor:
    """f32(sqrt 2) / x, a true division as in JAX."""
    return torch.full_like(x, math.sqrt(2.0)) / x


def _conditioner(s: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) Hartley conditioning [[s, 0, -s mx], [0, s, -s my], [0, 0, 1]]."""
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([torch.stack([s, zero, -s * m[..., 0]], -1),
                        torch.stack([zero, s, -s * m[..., 1]], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def _eight_point(n1: torch.Tensor, n2: torch.Tensor, w: torch.Tensor | None = None):
    """Rank-2 F of conditioned correspondences (..., N, 2), rows weighted
    by `w` (..., N): the least-eigenvalue eigenvector of AᵀA, its smallest
    singular value zeroed."""
    a = torch.stack([n2[..., 0] * n1[..., 0], n2[..., 0] * n1[..., 1], n2[..., 0],
                     n2[..., 1] * n1[..., 0], n2[..., 1] * n1[..., 1], n2[..., 1],
                     n1[..., 0], n1[..., 1], torch.ones_like(n1[..., 0])], dim=-1)
    if w is not None:
        a = a * w[..., None]
    _, vecs = torch.linalg.eigh(a.transpose(-1, -2) @ a)
    Fm = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    U, S, Vt = torch.linalg.svd(Fm)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ torch.diag_embed(S) @ Vt


def _solve_minimal(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """(S, 8, 2) pixel sets -> (S, 3, 3) F, Hartley-normalized per set."""
    m1, m2 = x1.mean(-2), x2.mean(-2)
    s1 = _sqrt2_over(torch.linalg.norm(x1 - m1[..., None, :], dim=-1).mean(-1) + 1e-9)
    s2 = _sqrt2_over(torch.linalg.norm(x2 - m2[..., None, :], dim=-1).mean(-1) + 1e-9)
    Fm = _eight_point((x1 - m1[..., None, :]) * s1[..., None, None],
                      (x2 - m2[..., None, :]) * s2[..., None, None])
    return _conditioner(s2, m2).transpose(-1, -2) @ Fm @ _conditioner(s1, m1)


def _solve_fundamental_weighted(uv1: torch.Tensor, uv2: torch.Tensor,
                                w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point DLT over all correspondences (w a {0, 1} mask)."""
    wsum = torch.clamp(w.sum(), min=1.0)
    m1 = (uv1 * w[:, None]).sum(0) / wsum
    m2 = (uv2 * w[:, None]).sum(0) / wsum
    s1 = _sqrt2_over((torch.linalg.norm(uv1 - m1, dim=-1) * w).sum() / wsum + 1e-9)
    s2 = _sqrt2_over((torch.linalg.norm(uv2 - m2, dim=-1) * w).sum() / wsum + 1e-9)
    Fm = _eight_point((uv1 - m1) * s1, (uv2 - m2) * s2, w)
    return _conditioner(s2, m2).T @ Fm @ _conditioner(s1, m1)


def _epipolar_inliers(F: torch.Tensor, x1h: torch.Tensor, x2h: torch.Tensor,
                      valid: torch.Tensor, threshold: float) -> torch.Tensor:
    """Symmetric point-to-epipolar-line test of F (..., 3, 3) on
    homogeneous pixels (N, 3)."""
    l2 = x1h @ F.transpose(-1, -2)  # lines in image 2
    d2 = torch.abs((l2 * x2h).sum(-1)) / (torch.linalg.norm(l2[..., :2], dim=-1) + 1e-9)
    l1 = x2h @ F  # lines in image 1
    d1 = torch.abs((l1 * x1h).sum(-1)) / (torch.linalg.norm(l1[..., :2], dim=-1) + 1e-9)
    return (d1 < threshold) & (d2 < threshold) & valid


def find_fundamental_ransac(uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
                            idx: torch.Tensor | None = None, threshold: float = 1.5,
                            n_hypotheses: int = 256):
    """8-point RANSAC for F in pixel coordinates; idx (S, 8) minimal sets,
    or None for `sample_minimal_sets(valid, n_hypotheses, F_SEED, 8)`.
    The winner is refitted on its inliers and kept if the refit has as
    many. Returns (F (3, 3), inliers (N,), n_inliers)."""
    if idx is None:
        idx = sample_minimal_sets(valid, n_hypotheses, seed=F_SEED, size=8)
    Fs = _solve_minimal(uv1[idx], uv2[idx])  # (S, 3, 3)
    ones = torch.ones_like(uv1[:, :1])
    x1h, x2h = torch.cat([uv1, ones], -1), torch.cat([uv2, ones], -1)
    inl = _epipolar_inliers(Fs, x1h, x2h, valid[None], threshold)
    counts = inl.sum(-1)
    best = torch.argmax(counts)
    F_refit = _solve_fundamental_weighted(uv1, uv2, inl[best].to(uv1.dtype))
    inl_refit = _epipolar_inliers(F_refit, x1h, x2h, valid, threshold)
    n_refit = inl_refit.sum()
    use = n_refit >= counts[best]
    return (torch.where(use, F_refit, Fs[best]), torch.where(use, inl_refit, inl[best]),
            torch.maximum(n_refit, counts[best]))


def reconstruct_from_F(F: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor,
                       inliers: torch.Tensor, cam: CameraConfig):
    """E = Kᵀ F K; the cheirality-best of its four (R, t) decompositions.
    Returns (R, t (unit), pts3d (N, 3) in camera 1, good (N,))."""
    dev = F.device
    K = torch.tensor([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], dtype=torch.float32,
                     device=dev)
    U, _, Vt = torch.linalg.svd(K.T @ F @ K)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=torch.float32, device=dev)
    R1, R2 = U @ W @ Vt, U @ W.T @ Vt
    t = U[:, 2]
    t = t / (torch.linalg.norm(t) + 1e-9)
    n1, n2 = _normalized(uv1, cam), _normalized(uv2, cam)
    e = torch.eye(4, dtype=torch.float32, device=dev)

    def count_good(R, tt):
        # Triangulate in normalized coordinates, camera 1 at the identity.
        P2 = torch.cat([R, tt[:, None]], dim=1)  # (3, 4)
        A = torch.stack([n1[:, 0, None] * e[2][None] - e[0][None],
                         n1[:, 1, None] * e[2][None] - e[1][None],
                         n2[:, 0, None] * P2[2][None] - P2[0][None],
                         n2[:, 1, None] * P2[2][None] - P2[1][None]], dim=1)  # (N, 4, 4)
        _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
        Xh = vecs[..., 0]
        w = torch.where(torch.abs(Xh[:, 3]) < 1e-9, torch.full_like(Xh[:, 3], 1e-9), Xh[:, 3])
        X = Xh[:, :3] / w[:, None]
        z2 = (X @ R.T + tt)[:, 2]
        return (X[:, 2] > 0) & (z2 > 0) & inliers, X

    candidates = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    goods, Xs = zip(*(count_good(R, tt) for R, tt in candidates))
    best = int(torch.argmax(torch.stack([g.sum() for g in goods])))
    R, tt = candidates[best]
    return R, tt, Xs[best], goods[best]


def initialize_monocular(uv1: torch.Tensor, uv2: torch.Tensor, valid: torch.Tensor,
                         cam: CameraConfig, idx_H: torch.Tensor | None = None,
                         idx_F: torch.Tensor | None = None) -> dict:
    """Two-view initialization (Initializer::Initialize). idx_H (128, 4)
    and idx_F (256, 8): minimal sets, or None to draw them. Returns
    dict(success, model ('H' or 'F'), R, t (unit scale), pts3d, good,
    n_good)."""
    _, _, n_H = find_homography_ransac(uv1, uv2, valid, idx=idx_H, threshold=3.0)
    F, inl_F, n_F = find_fundamental_ransac(uv1, uv2, valid, idx=idx_F)
    # The score-ratio rule (Initializer.cc:282-287) with inlier counts as
    # scores; the homography is only named, F reconstructs either way.
    n_H, n_F = int(n_H), int(n_F)
    model = "H" if n_H / max(n_H + n_F, 1) > 0.45 else "F"
    R, t, X, good = reconstruct_from_F(F, uv1, uv2, inl_F, cam)
    n_good = int(good.sum())
    success = n_good >= 50 and bool(se3.is_rotation_matrix(R, tol=1e-2))
    return {"success": success, "model": model, "R": R, "t": t, "pts3d": X, "good": good,
            "n_good": n_good}
