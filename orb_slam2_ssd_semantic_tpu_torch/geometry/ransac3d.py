"""Vectorized RANSAC rigid/similarity alignment of 3D-3D correspondences
(counterpart of the JAX package's `geometry/ransac3d.py`).

The twin of Sim3Solver (perfect/src/Sim3Solver.cc:126-284): every
hypothesis solves Horn's closed form on a random 3-point minimal set and
all of them are scored in one batch; the best inlier set is refit. Scale
is fixed to 1 for stereo/RGB-D. Also serves RGB-D relocalization, where
frame depth turns 2D-3D PnP into 3D-3D alignment.

Sampling, scoring and fitting are split (`sample_minimal_sets`,
`score_rigid_sets`, `fit_rigid_sets`)
so that a caller can hand in its own minimal sets: the JAX package draws
them with its own generator, whose stream torch cannot reproduce.
"""

from __future__ import annotations

import torch

from orb_slam2_ssd_semantic_tpu_torch.geometry import se3


def sample_minimal_sets(valid: torch.Tensor, n_sets: int, set_size: int,
                        generator: torch.Generator) -> torch.Tensor:
    """(n_sets, set_size) int64 row indices, each drawn uniformly from the
    valid rows with replacement (as `jax.random.categorical` over logits
    of 0 and -1e9 draws). With no valid row every index is the last row:
    the caller's validity mask then leaves no inlier."""
    cum = torch.cumsum(valid.to(torch.int64), 0)
    u = torch.rand((n_sets, set_size), generator=generator, device=valid.device)
    rank = (u * cum[-1]).to(torch.int64)  # the rank-th valid row, in [0, n_valid)
    idx = torch.searchsorted(cum, rank, right=True)
    return idx.clamp(max=valid.shape[0] - 1)


def score_rigid_sets(src, dst, valid, idx, threshold: float = 0.10, with_scale: bool = False):
    """One Horn hypothesis per minimal set `idx` (S, 3), scored on every
    row. Returns ((s, R, t) per set, inliers (S, N))."""
    s_h, R_h, t_h = se3.horn_sim3(src[idx], dst[idx], with_scale=with_scale)
    pred = s_h[:, None, None] * torch.einsum("sij,nj->sni", R_h, src) + t_h[:, None, :]
    err = torch.linalg.norm(pred - dst[None], dim=-1)  # (S, N)
    return (s_h, R_h, t_h), (err < threshold) & valid[None, :]


def fit_rigid_sets(src, dst, valid, idx, threshold: float = 0.10, with_scale: bool = False):
    """Score the minimal sets `idx` (S, 3) and refit on the best one's
    inliers (the first best among equals). Returns (s, R, t,
    inliers (N,), n_inliers)."""
    _, inl = score_rigid_sets(src, dst, valid, idx, threshold, with_scale)
    best = torch.argmax(inl.sum(-1))  # first occurrence
    s, R, t = se3.horn_sim3(src, dst, mask=inl[best].to(src.dtype), with_scale=with_scale)
    pred = s * src @ R.T + t
    inliers = (torch.linalg.norm(pred - dst, dim=-1) < threshold) & valid
    return s, R, t, inliers, inliers.sum()


def ransac_rigid(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                 generator: torch.Generator, threshold: float = 0.10,
                 n_hypotheses: int = 256, with_scale: bool = False):
    """Estimate dst ~ s R src + t robustly from src, dst (N, 3) and valid
    (N,). Returns (s, R, t, inliers (N,), n_inliers)."""
    idx = sample_minimal_sets(valid, n_hypotheses, 3, generator)
    return fit_rigid_sets(src, dst, valid, idx, threshold, with_scale)
