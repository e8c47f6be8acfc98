"""Sim3 refinement between two keyframes on bidirectional reprojection
(counterpart of the JAX package's `mapping/sim3_opt.py`).

Equivalent of Optimizer::OptimizeSim3 (perfect/src/Optimizer.cc:
1310-1525): the forward edge projects KF-i points through T_ji into KF
j's image, the inverse edge projects KF-j points through T_ji^-1 into KF
i's image; Huber kernels, a chi2 > th2 (= 10) outlier cut, then further
iterations on the survivors. Scale is optimized for monocular loops and
frozen for RGB-D (bFixScale).

A batched Gauss-Newton over the 7-dof Sim(3) tangent: the (N, 2, 2, 7)
Jacobian comes from `torch.func.jacfwd` over the multiplicative
perturbation at 0 (the JAX module's `jax.jacfwd`), and the 7x7 normal
equations go through the unrolled `cholesky_solve_small`. Each schedule
is a host loop of fixed length that never reads the device.
"""

from __future__ import annotations

import dataclasses

import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.ops.linalg import cholesky_solve_small


@dataclasses.dataclass
class Sim3OptResult:
    s: torch.Tensor  # () scale of T_ji
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int64


def _project(p: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    z = torch.clamp(p[..., 2], min=1e-6)
    return torch.stack([cam.fx * p[..., 0] / z + cam.cx, cam.fy * p[..., 1] / z + cam.cy], -1)


def _residuals(x, s0, R0, t0, p_i, p_j, uv_i, uv_j, cam: CameraConfig):
    """Bidirectional reprojection residuals (N, 2, 2) and the behind-camera
    mask (N,) for the multiplicative perturbation exp(x) o (s0, R0, t0).

    Everything carries a leading batch dim of 1: torch's forward-mode AD
    gives a float64 tangent to a 0-d float32 dual combined with a Python
    scalar, which then fails the next matmul."""
    ds, dR, dt = se3.sim3_exp(x[None])
    s, R, t = se3.sim3_compose(ds, dR, dt, s0.reshape(1), R0[None], t0[None])
    q_j = se3.sim3_apply(s, R, t, p_i)[0]  # KF-i points in KF j's frame
    si, Ri, ti = se3.sim3_inverse(s, R, t)
    q_i = se3.sim3_apply(si, Ri, ti, p_j)[0]  # KF-j points in KF i's frame
    r_fwd = _project(q_j, cam) - uv_j  # g2o EdgeSim3ProjectXYZ
    r_bwd = _project(q_i, cam) - uv_i  # g2o EdgeInverseSim3ProjectXYZ
    behind = (q_j[..., 2] <= 1e-6) | (q_i[..., 2] <= 1e-6)
    return torch.stack([r_fwd, r_bwd], dim=-2), behind


def optimize_sim3(s0, R0, t0, p_i, p_j, uv_i, uv_j, inv_sigma2_i, inv_sigma2_j, valid,
                  cam: CameraConfig, fix_scale: bool = True, chi2_th: float = 10.0,
                  iters: int = 5) -> Sim3OptResult:
    """Refine T_ji = (s0, R0, t0) with p_j ~ T_ji p_i. p_i, p_j (N, 3)
    matched points in each keyframe's camera frame; uv_i, uv_j (N, 2)
    their observations; inv_sigma2_* (N,) the observations' information;
    valid (N,) bool.

    OptimizeSim3's schedule: `iters` robust iterations, drop edges with
    chi2 > chi2_th in either direction, then 2 x iters plain iterations on
    the survivors; returns the final inliers."""
    huber2 = chi2_th  # deltaHuber = sqrt(th2) (Optimizer.cc:1407)
    dtype, dev = p_i.dtype, p_i.device
    w_dir = torch.stack([inv_sigma2_j, inv_sigma2_i], dim=-1)  # (N, 2)
    x0 = torch.zeros((7,), dtype=dtype, device=dev)
    s0 = torch.as_tensor(s0, dtype=dtype, device=dev).reshape(())
    eye7 = torch.eye(7, dtype=dtype, device=dev)

    def step(sRt, w_edge, use_huber: bool):
        s, R, t = sRt

        def res(x):
            r, behind = _residuals(x, s, R, t, p_i, p_j, uv_i, uv_j, cam)
            return r, (r, behind)

        J, (r, behind) = torch.func.jacfwd(res, has_aux=True)(x0)  # (N, 2, 2, 7)
        chi = torch.sum(r * r, -1) * w_dir  # (N, 2)
        if use_huber:
            rho = torch.where(chi > huber2, torch.sqrt(huber2 / torch.clamp(chi, min=1e-12)),
                              torch.ones_like(chi))
            # Gross mismatches (Huber influence still grows as sqrt(chi))
            # must not steer the solve at all.
            rho = torch.where(chi > 1e5 * huber2, torch.zeros_like(rho), rho)
        else:
            rho = torch.ones_like(chi)
        w = w_dir * rho * (w_edge * (~behind).to(dtype))[:, None]
        H = torch.einsum("ndci,nd,ndcj->ij", J, w, J)
        b = -torch.einsum("ndci,ndc->i", J, w[..., None] * r)
        if fix_scale:  # freeze the sigma coordinate (bFixScale)
            H = H.clone()
            H[6, :] = 0.0
            H[:, 6] = 0.0
            H[6, 6] = 1.0
            b = torch.cat([b[:6], b.new_zeros(1)])
        dx = cholesky_solve_small(H + 1e-6 * eye7, b)
        ds, dR, dt = se3.sim3_exp(dx[None])
        s1, R1, t1 = se3.sim3_compose(ds, dR, dt, s.reshape(1), R[None], t[None])
        return s1[0], R1[0], t1[0]

    def inliers(sRt):
        r, behind = _residuals(x0, *sRt, p_i, p_j, uv_i, uv_j, cam)
        chi = torch.sum(r * r, -1) * w_dir
        return valid & (~behind) & torch.all(chi < chi2_th, dim=-1)

    sRt = (s0, R0, t0)
    w_edge = valid.to(dtype)
    for _ in range(iters):
        sRt = step(sRt, w_edge, True)
    keep = inliers(sRt)  # outlier rejection on both directions, then more iterations
    for _ in range(2 * iters):
        sRt = step(sRt, keep.to(dtype), False)
    inl = inliers(sRt)
    s, R, t = sRt
    return Sim3OptResult(s=s, R=R, t=t, inliers=inl, num_inliers=inl.sum())
