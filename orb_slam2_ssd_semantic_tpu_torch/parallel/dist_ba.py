"""Distributed bundle-adjustment reductions over the device mesh
(counterpart of the JAX package's `parallel/dist_ba.py`).

The reference's bundle adjustment is single-threaded g2o
(perfect/src/Optimizer.cc). Here the normal-equation assembly, the part
that grows with the number of observations, is sharded: the observations
are split over the ``pt`` axis, every rank sums its partial Hessian and
gradient blocks, and one all-reduce gives every rank the whole reduced
system; the small solves then run redundantly on every rank (cheaper than
gathering). Inputs that JAX replicates are broadcast from the axis's
first rank before each call (`mesh.replicate`).
"""

from __future__ import annotations

import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.ops.linalg import cholesky_solve_small
from orb_slam2_ssd_semantic_tpu_torch.parallel.mesh import PT_AXIS, psum, replicate
from orb_slam2_ssd_semantic_tpu_torch.tracking.pose_opt import _residual_jacobian
from orb_slam2_ssd_semantic_tpu_torch.utils import precision


def pose_hessian_local(T_cw, pts_w, obs, weights, cam: CameraConfig):
    """Partial (6, 6) Hessian and (6,) gradient from a shard of
    observations."""
    e, J, behind = _residual_jacobian(T_cw, pts_w, obs, cam)
    w = (weights * (~behind))[:, None]
    H = torch.einsum("nki,nk,nkj->ij", J, w * torch.ones_like(e), J)
    b = -torch.einsum("nki,nk->i", J, w * e)
    return H, b


def make_distributed_pose_step(mesh, cam: CameraConfig):
    """One Gauss-Newton step of motion-only BA with the observations split
    over `pt`: step(T_cw, pts_w, obs, weights) with T_cw replicated and
    pts_w, obs, weights this rank's rows; returns the updated pose, the
    same on every rank."""

    @precision.scoped
    def step(T_cw, pts_w, obs, weights):
        T_cw = replicate(T_cw, mesh, PT_AXIS)
        H, b = pose_hessian_local(T_cw, pts_w, obs, weights, cam)
        H = psum(H, mesh, PT_AXIS)
        b = psum(b, mesh, PT_AXIS)
        H = H + 1e-6 * torch.eye(6, dtype=H.dtype, device=H.device)
        dx = cholesky_solve_small(H, b)
        return se3.se3_exp(dx) @ T_cw

    return step


def make_distributed_global_ba(mesh, cam: CameraConfig, cfg, cg_iters: int = 20):
    """Full-map bundle adjustment (the implicit-Schur PCG of
    `mapping/global_ba.py`) with the M observation slots split over `pt`.

    run(prob) takes a `GlobalBAProblem` whose obs_* fields are this rank's
    rows (pad M to a multiple of the axis size with `obs_valid=False`
    rows) and whose poses, points and validity are replicated (F*16 + P*3
    floats, broadcast from the axis's first rank). The per-observation
    Jacobian blocks, the O(M) memory and work, stay on their rank; each sum
    into the (F, 6, 6) / (P, 3, 3) / (F, 6) / (P, 3) aggregates is a local
    `index_add_` and one all-reduce, and every rank runs the same small PCG
    (SURVEY.md §2.6 P12). Returns a `GlobalBAResult` with replicated poses
    and points and this rank's rows of `inlier` and `chi2`."""
    from orb_slam2_ssd_semantic_tpu_torch.mapping.global_ba import global_ba_core

    group = mesh.get_group(PT_AXIS)

    @precision.scoped
    def run(prob):
        prob = prob.replace(**{k: replicate(getattr(prob, k), mesh, PT_AXIS)
                               for k in ("T_cw", "fixed", "points", "point_valid")})
        return global_ba_core(prob, cam, cfg, cg_iters, group=group)

    return run
