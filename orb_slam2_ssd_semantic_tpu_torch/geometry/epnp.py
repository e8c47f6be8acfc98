"""Batched EPnP: 2D-3D perspective-n-point pose inside vectorized RANSAC
(counterpart of the JAX package's `geometry/epnp.py`).

The twin of PnPsolver (perfect/src/PnPsolver.cc:61-1006), after Lepetit
et al., IJCV'09: 4 control points, barycentric coordinates, the null
space of the weighted M^T M (12x12, `eigh`) spanning the camera-frame
control points, betas from the inter-control-point distances (two
approximations, each refined by 5 Gauss-Newton steps on the 6x10
distance system), then absolute orientation for (R, t). Every function
works over leading batch dims, so all RANSAC hypotheses solve in one
batch, and the refit reuses the same closed form with an inlier mask as
weights.

Eigenvectors come with a sign that differs between LAPACK builds; the
beta sign rules and the depth-sign flip absorb it, so poses agree.
Least squares go through the pseudo-inverse (the SVD solution with the
default cut-off, as `jnp.linalg.lstsq` computes it) on every device.
"""

from __future__ import annotations

import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.geometry.ransac3d import sample_minimal_sets
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import finite_matrices, nan_where

# Pairs of control-point indices for the 6 inter-control-point distances
# (PnPsolver.cc:736-744 iterates i<j over 4 points).
_PAIR_I = [0, 0, 0, 1, 1, 2]
_PAIR_J = [1, 2, 3, 2, 3, 3]
# betas10 ordering: [b1^2, b1b2, b2^2, b1b3, b2b3, b3^2, b1b4, b2b4, b3b4, b4^2]
# (PnPsolver.cc:758-768).
_B10_I = [0, 0, 1, 0, 1, 2, 0, 1, 2, 3]
_B10_J = [0, 1, 1, 2, 2, 2, 3, 3, 3, 3]


def _eigh(a: torch.Tensor):
    """`eigh` that leaves NaN for a non-finite matrix (a diverged
    hypothesis), as XLA does, where torch would raise."""
    a, ok = finite_matrices(a)
    vals, vecs = torch.linalg.eigh(a)
    return nan_where(ok, vals), nan_where(ok, vecs)


def _sign(cond: torch.Tensor) -> torch.Tensor:
    """-1.0 where `cond`, else 1.0."""
    return 1.0 - 2.0 * cond.to(torch.float32)


def _control_points(pw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted EPnP control points: centroid + scaled principal axes
    (choose_control_points, PnPsolver.cc:273-309). Returns (..., 4, 3)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-6)
    c0 = torch.sum(pw * w[..., None], dim=-2) / wsum[..., None]
    d = (pw - c0[..., None, :]) * torch.sqrt(w)[..., None]
    cov = torch.einsum("...ni,...nj->...ij", d, d) / wsum[..., None, None]
    evals, evecs = _eigh(cov)  # ascending
    # Guard rank-deficient (planar/linear) sets so the barycentric solve
    # stays invertible; the tiny fake extent cancels in the null space.
    lam = torch.sqrt(torch.clamp(evals, min=1e-8))
    cws = c0[..., None, :] + lam[..., :, None] * evecs.transpose(-1, -2)  # rows = axes
    return torch.cat([c0[..., None, :], cws.flip(-2)], dim=-2)


def _barycentric(pw: torch.Tensor, cws: torch.Tensor) -> torch.Tensor:
    """Barycentric coordinates of pw wrt the 4 control points
    (compute_barycentric_coordinates, PnPsolver.cc:311-336). (..., N, 4)."""
    A = (cws[..., 1:, :] - cws[..., :1, :]).transpose(-1, -2)  # (..., 3, 3)
    a123 = torch.linalg.solve_ex(A, (pw - cws[..., :1, :]).transpose(-1, -2))[0]
    a123 = a123.transpose(-1, -2)  # (..., N, 3)
    return torch.cat([1.0 - torch.sum(a123, dim=-1, keepdim=True), a123], dim=-1)


def _fill_M(alphas: torch.Tensor, uv: torch.Tensor, w: torch.Tensor,
            cam: CameraConfig) -> torch.Tensor:
    """Weighted M^T M of the 2Nx12 EPnP system (fill_M,
    PnPsolver.cc:338-355). Returns (..., 12, 12)."""
    z = torch.zeros_like(alphas)
    lead = alphas.shape[:-1]
    ru = torch.stack([alphas * cam.fx, z, alphas * (cam.cx - uv[..., 0:1])], dim=-1)
    rv = torch.stack([z, alphas * cam.fy, alphas * (cam.cy - uv[..., 1:2])], dim=-1)
    M = torch.cat([ru.reshape(lead + (12,)), rv.reshape(lead + (12,))], dim=-2)
    Wd = torch.cat([w, w], dim=-1)[..., None]
    return M.transpose(-1, -2) @ (M * Wd)


def _rho(cws: torch.Tensor) -> torch.Tensor:
    d = cws[..., _PAIR_I, :] - cws[..., _PAIR_J, :]
    return torch.sum(d * d, dim=-1)


def _L6x10(V: torch.Tensor) -> torch.Tensor:
    """(..., 6, 10) distance system over the 4 null-space vectors
    (compute_L_6x10, PnPsolver.cc:848-881). V is (..., 12, 4)."""
    cc = V.transpose(-1, -2).reshape(V.shape[:-2] + (4, 4, 3))  # (vector, control point, xyz)
    dv = cc[..., _PAIR_I, :] - cc[..., _PAIR_J, :]  # (..., 4, 6, 3)
    dots = torch.einsum("...apx,...bpx->...pab", dv, dv)  # (..., 6, 4, 4)
    g = dots[..., _B10_I, _B10_J]
    scale = torch.tensor([1.0 if i == j else 2.0 for i, j in zip(_B10_I, _B10_J)],
                         dtype=V.dtype, device=V.device)
    return g * scale


def _betas10(b: torch.Tensor) -> torch.Tensor:
    return b[..., _B10_I] * b[..., _B10_J]


def _lstsq(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    A, ok = finite_matrices(A)
    return nan_where(ok, (torch.linalg.pinv(A) @ y[..., None])[..., 0])


def _betas_approx1(L: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """find_betas_approx_1 (PnPsolver.cc:621-645): least squares on
    columns [b1^2, b1b2, b1b3, b1b4]."""
    x = _lstsq(L[..., [0, 1, 3, 6]], rho)
    b1 = torch.sqrt(torch.abs(x[..., 0]))
    rest = _sign(x[..., 0] < 0)[..., None] * x[..., 1:] / torch.clamp(b1, min=1e-9)[..., None]
    return torch.cat([b1[..., None], rest], dim=-1)


def _betas_approx2(L: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """find_betas_approx_2 (PnPsolver.cc:651-681): columns
    [b1^2, b1b2, b2^2]."""
    x = _lstsq(L[..., [0, 1, 2]], rho)
    b1 = torch.sqrt(torch.abs(x[..., 0]))
    b2 = torch.sqrt(torch.abs(x[..., 2])) * (x[..., 2] > 0).to(x.dtype)
    flip = _sign(x[..., 1] < 0)
    zero = torch.zeros_like(b1)
    b = torch.stack([b1 * flip, b2, zero, zero], dim=-1)
    return b * (_sign(x[..., 0] < 0) * flip)[..., None]


def _gauss_newton(L: torch.Tensor, rho: torch.Tensor, b: torch.Tensor,
                  iters: int = 5) -> torch.Tensor:
    """Refine betas on ||L betas10(b) - rho|| (gauss_newton,
    PnPsolver.cc:891-908), 5 iterations like the reference. The Jacobian
    of betas10 is written out: d(b_i b_j)/db_k = [i=k] b_j + [j=k] b_i."""
    eye4 = torch.eye(4, dtype=b.dtype, device=b.device)
    sel_i, sel_j = eye4[_B10_I], eye4[_B10_J]  # (10, 4) one-hot rows
    for _ in range(iters):
        dB = sel_i * b[..., _B10_J, None] + sel_j * b[..., _B10_I, None]  # (..., 10, 4)
        J = L @ dB  # (..., 6, 4)
        r = rho - (L @ _betas10(b)[..., None])[..., 0]
        Jt = J.transpose(-1, -2)
        step = torch.linalg.solve_ex(Jt @ J + 1e-9 * eye4, (Jt @ r[..., None])[..., 0])[0]
        b = b + step
    return b


def _pose_from_betas(b, V, alphas, pw, w):
    """Camera-frame control points -> point cloud -> absolute orientation
    (compute_ccs/compute_pcs/compute_R_and_t, PnPsolver.cc:714-829).
    Returns (R, t)."""
    ccs = (V @ b[..., None])[..., 0].reshape(b.shape[:-1] + (4, 3))
    pcs = alphas @ ccs
    # Resolve the global sign so depths are positive (solve_for_sign,
    # PnPsolver.cc:784-793).
    pcs = pcs * _sign(torch.sum(pcs[..., 2] * w, dim=-1) < 0)[..., None, None]
    _, R, t = se3.horn_sim3(pw, pcs, mask=w, with_scale=False)
    return R, t


def _project(pc: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    z = torch.clamp(pc[..., 2], min=1e-6)
    return torch.stack([cam.fx * pc[..., 0] / z + cam.cx, cam.fy * pc[..., 1] / z + cam.cy], -1)


def _epnp(pw: torch.Tensor, uv: torch.Tensor, w: torch.Tensor, cam: CameraConfig):
    """One weighted EPnP solve over all rows with weight w (0/1 mask ok),
    batched over leading dims. Returns (R, t) with T_cw = [R|t]."""
    cws = _control_points(pw, w)
    alphas = _barycentric(pw, cws)
    _, evecs = _eigh(_fill_M(alphas, uv, w, cam))
    V = evecs[..., :, :4]  # 4 smallest — the (approximate) null space
    L = _L6x10(V)
    rho = _rho(cws)

    def candidate(b0):
        b = _gauss_newton(L, rho, b0)
        R, t = _pose_from_betas(b, V, alphas, pw, w)
        proj = _project(pw @ R.transpose(-1, -2) + t[..., None, :], cam)
        sq = torch.sum((proj - uv) ** 2, dim=-1)
        return torch.sum(torch.where(w > 0, sq, torch.zeros_like(sq)), dim=-1), R, t

    e1, R1, t1 = candidate(_betas_approx1(L, rho))
    e2, R2, t2 = candidate(_betas_approx2(L, rho))
    take1 = e1 <= e2
    return torch.where(take1[..., None, None], R1, R2), torch.where(take1[..., None], t1, t2)


def score_epnp_sets(pw, uv, valid, idx, cam: CameraConfig,
                    threshold_px: float = 5.991 ** 0.5 * 2.0):
    """One EPnP hypothesis per minimal set `idx` (S, m), scored on every
    row by reprojection. Returns ((R, t) per set, inliers (S, N))."""
    R_h, t_h = _epnp(pw[idx], uv[idx], torch.ones(idx.shape, dtype=pw.dtype, device=pw.device),
                     cam)
    pc = torch.einsum("sij,nj->sni", R_h, pw) + t_h[:, None, :]
    err = torch.linalg.norm(_project(pc, cam) - uv[None], dim=-1)
    return (R_h, t_h), (err < threshold_px) & (pc[..., 2] > 0) & valid[None, :]


def fit_epnp_sets(pw, uv, valid, idx, cam: CameraConfig,
                  threshold_px: float = 5.991 ** 0.5 * 2.0):
    """Score the minimal sets `idx` (S, m); one weighted EPnP refit on the
    best set's inliers (the first best among equals), kept unless it
    explains fewer rows than the raw hypothesis (PnPsolver.cc:229-247).
    Returns (R, t, inliers (N,), n_inliers)."""
    (R_h, t_h), inl = score_epnp_sets(pw, uv, valid, idx, cam, threshold_px)
    counts = inl.sum(-1)
    best = torch.argmax(counts)

    R, t = _epnp(pw, uv, inl[best].to(pw.dtype), cam)
    pc = pw @ R.T + t
    inliers = (torch.linalg.norm(_project(pc, cam) - uv, dim=-1) < threshold_px) \
        & (pc[:, 2] > 0) & valid
    n_ref = inliers.sum()
    keep = n_ref >= counts[best]  # else the weighted refit diverged: keep the raw hypothesis
    R = torch.where(keep, R, R_h[best])
    t = torch.where(keep, t, t_h[best])
    inliers = torch.where(keep, inliers, inl[best])
    return R, t, inliers, torch.maximum(n_ref, counts[best])


def ransac_epnp(pw: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
                generator: torch.Generator, cam: CameraConfig,
                threshold_px: float = 5.991 ** 0.5 * 2.0, n_hypotheses: int = 128,
                min_set: int = 6):
    """Robust PnP from world points pw (N, 3), pixels uv (N, 2) and valid
    (N,): every hypothesis is an EPnP on a random minimal set, all solved
    in one batch (PnPsolver::iterate, PnPsolver.cc:161-257, vectorized).
    Returns (R, t, inliers (N,), n_inliers) with T_cw = [R|t]."""
    idx = sample_minimal_sets(valid, n_hypotheses, min_set, generator)
    return fit_epnp_sets(pw, uv, valid, idx, cam, threshold_px)
