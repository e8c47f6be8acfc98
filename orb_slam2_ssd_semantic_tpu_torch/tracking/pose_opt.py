"""Motion-only bundle adjustment (counterpart of the JAX package's
`tracking/pose_opt.py`): rounds of Gauss-Newton iterations on all
observations at once with Huber weights in the early rounds and a chi2
outlier gate between rounds. Residual model: stereo/RGB-D observation
(u, v, uR) with uR = u - bf/z; monocular observations weight uR by 0."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, OptimizerConfig
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.ops.linalg import cholesky_solve_small
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import device_constant


@dataclasses.dataclass
class PoseOptResult:
    T_cw: torch.Tensor  # (4, 4)
    inliers: torch.Tensor  # (N,) bool
    num_inliers: torch.Tensor  # () int64
    chi2: torch.Tensor  # (N,)


def _residual_jacobian(T_cw, pts_w, obs, cam: CameraConfig):
    """Residual (N, 3) and Jacobian (N, 3, 6) wrt a left se3 perturbation."""
    R, t = se3.mat_to_rt(T_cw)
    p = pts_w @ R.T + t
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    z_safe = torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    iz = 1.0 / z_safe
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.depth_bf * iz
    e = torch.stack([u, v, ur], dim=-1) - obs
    zero = torch.zeros_like(iz)
    du = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
    dv = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    dur = du + torch.stack([zero, zero, cam.depth_bf * iz2], dim=-1)
    duvr_dp = torch.stack([du, dv, dur], dim=-2)  # (N, 3, 3)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[0], 3, 3)
    dp_dxi = torch.cat([eye, -se3.hat(p)], dim=-1)  # (N, 3, 6)
    J = duvr_dp @ dp_dxi
    return e, J, z <= 1e-6


def _chi2(e, w_info, comp_w):
    return torch.sum(e * e * comp_w, dim=-1) * w_info


@device_constant
def _component_weights() -> np.ndarray:
    """(2, 1, 3): the residual components a stereo and a monocular
    observation weigh (uR only for stereo)."""
    return np.array([[[1.0, 1.0, 1.0]], [[1.0, 1.0, 0.0]]], np.float32)


@device_constant
def _per_observation(chi2_stereo, chi2_mono, delta_stereo, delta_mono) -> np.ndarray:
    """(2, 2) float32: [chi2 gate, Huber delta] x [stereo, monocular]."""
    return np.array([[chi2_stereo, chi2_mono], [delta_stereo, delta_mono]], np.float32)


def pose_optimize(T_init, pts_w, obs_uvr, inv_sigma2, is_stereo, valid, cam: CameraConfig,
                  cfg: OptimizerConfig = OptimizerConfig()) -> PoseOptResult:
    """Optimize T_cw from 3D-2D(3) correspondences. pts_w (N, 3),
    obs_uvr (N, 3), inv_sigma2 (N,), is_stereo / valid (N,) bool."""
    dev = pts_w.device
    comp_w = torch.where(is_stereo[:, None], *_component_weights(device=dev))
    chi2_th, delta = _per_observation(cfg.chi2_stereo, cfg.chi2_mono, cfg.huber_delta_stereo,
                                      cfg.huber_delta_mono, device=dev)
    chi2_th = torch.where(is_stereo, chi2_th[0], chi2_th[1])
    delta = torch.where(is_stereo, delta[0], delta[1])
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    lam = cfg.lm_lambda_init

    def gn_iters(T, inl, use_huber: bool, n_iters: int):
        for _ in range(n_iters):
            e, J, behind = _residual_jacobian(T, pts_w, obs_uvr, cam)
            w = inv_sigma2 * inl * (~behind)
            chi = _chi2(e, 1.0, comp_w) * inv_sigma2
            if use_huber:
                rho_w = torch.where(chi > delta * delta,
                                    delta / torch.sqrt(torch.clamp(chi, min=1e-12)),
                                    torch.ones_like(chi))
            else:
                rho_w = torch.ones_like(chi)
            wc = (w * rho_w)[:, None] * comp_w  # (N, 3)
            H = torch.einsum("nki,nk,nkj->ij", J, wc, J)
            b = -torch.einsum("nki,nk->i", J, wc * e)
            H = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye6
            dx = cholesky_solve_small(H, b)
            T = se3.se3_exp(dx) @ T
        return T

    T = T_init
    inl = valid.to(torch.float32)
    for rnd in range(cfg.pose_rounds):
        T = gn_iters(T, inl, rnd < 2, cfg.pose_iters_per_round)
        e, _, behind = _residual_jacobian(T, pts_w, obs_uvr, cam)
        chi = _chi2(e, inv_sigma2, comp_w)
        inl = (valid & (chi < chi2_th) & (~behind)).to(torch.float32)

    e, _, behind = _residual_jacobian(T, pts_w, obs_uvr, cam)
    chi = _chi2(e, inv_sigma2, comp_w)
    inliers = valid & (chi < chi2_th) & (~behind)
    return PoseOptResult(T_cw=T, inliers=inliers, num_inliers=inliers.sum(), chi2=chi)
