"""Two-view triangulation of new map points (counterpart of the JAX
package's `mapping/triangulation.py`): epipolar-gated Hamming matching
between two keyframes, inhomogeneous DLT, and the cheirality, parallax,
reprojection and scale-consistency checks. Batched over keyframe pairs:
every argument may carry a leading pair dimension B."""

from __future__ import annotations

import dataclasses

import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, OrbConfig
from orb_slam2_ssd_semantic_tpu_torch.frontend.extractor import scale_factors
from orb_slam2_ssd_semantic_tpu_torch.geometry import camera as cam_ops
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.ops import match as match_ops
from orb_slam2_ssd_semantic_tpu_torch.ops.linalg import inv3x3


@dataclasses.dataclass
class TriangulationResult:
    pts_w: torch.Tensor  # (B, K, 3) new world points (indexed by kf1 keypoint)
    idx2: torch.Tensor  # (B, K) matched keypoint in kf2 (-1 invalid)
    valid: torch.Tensor  # (B, K)


def _intrinsics(cam: CameraConfig, device) -> torch.Tensor:
    return cam_ops.intrinsics_matrix(cam, device=device)


def fundamental_from_poses(T1_cw, T2_cw, cam: CameraConfig):
    """F12 (..., 3, 3) with x2^T F12 x1 = 0 (pixel coords)."""
    K = _intrinsics(cam, T1_cw.device)
    T12 = T1_cw @ se3.se3_inverse(T2_cw)
    T21 = se3.se3_inverse(T12)
    E = se3.hat(T21[..., :3, 3]) @ T21[..., :3, :3]
    K_inv = torch.linalg.inv_ex(K)[0]  # `inv` without its host-side check
    return K_inv.T @ E @ K_inv


def triangulate_pair(uv1, desc1, level1, valid1, uv2, desc2, level2, valid2, T1_cw, T2_cw,
                     cam: CameraConfig, orb: OrbConfig, max_reproj_chi2: float = 5.991):
    """Match under the epipolar constraint and triangulate. Keypoint
    arrays (B, K, ...), poses (B, 4, 4). Returns TriangulationResult."""
    dev = uv1.device
    sf = scale_factors(orb, dev)
    L = orb.n_levels
    B, K1 = uv1.shape[:2]
    K2 = uv2.shape[1]
    F12 = fundamental_from_poses(T1_cw, T2_cw, cam)

    x1h = torch.cat([uv1, torch.ones((B, K1, 1), dtype=torch.float32, device=dev)], dim=-1)
    l2 = x1h @ F12.transpose(-1, -2)  # (B, K1, 3)
    num = torch.abs(l2[:, :, None, 0] * uv2[:, None, :, 0]
                    + l2[:, :, None, 1] * uv2[:, None, :, 1] + l2[:, :, None, 2])
    den = torch.sqrt(l2[..., 0] ** 2 + l2[..., 1] ** 2)[:, :, None] + 1e-9
    ep_dist = num / den  # (B, K1, K2)
    sigma2 = sf[level2.clamp(0, L - 1)] ** 2
    ep_ok = ep_dist * ep_dist < 3.84 * sigma2[:, None, :]

    idx, valid_m = [], []
    for b in range(B):
        dist = match_ops.hamming_matrix(desc1[b], desc2[b])
        mask = ep_ok[b] & valid1[b][:, None] & valid2[b][None, :]
        m = match_ops.masked_best_match(dist, mask, max_dist=match_ops.TH_LOW, ratio=0.9)
        m = match_ops.resolve_duplicate_targets(m, K2)
        idx.append(m.idx)
        valid_m.append(m.valid)
    m_idx = torch.stack(idx)
    m_valid = torch.stack(valid_m)
    j = m_idx.clamp(0, K2 - 1)

    Kmat = _intrinsics(cam, dev)
    P1 = Kmat @ T1_cw[:, :3, :]  # (B, 3, 4)
    P2 = Kmat @ T2_cw[:, :3, :]
    u1, v1 = uv1[..., 0], uv1[..., 1]
    uv2j = torch.gather(uv2, 1, j[..., None].expand(B, K1, 2))
    u2, v2 = uv2j[..., 0], uv2j[..., 1]
    A = torch.stack([
        u1[..., None] * P1[:, None, 2] - P1[:, None, 0],
        v1[..., None] * P1[:, None, 2] - P1[:, None, 1],
        u2[..., None] * P2[:, None, 2] - P2[:, None, 0],
        v2[..., None] * P2[:, None, 2] - P2[:, None, 1],
    ], dim=2)  # (B, K, 4, 4)
    A3 = A[..., :3]
    b3 = -A[..., 3]
    M = A3.transpose(-1, -2) @ A3 + 1e-9 * torch.eye(3, dtype=A.dtype, device=dev)
    rhs3 = (A3.transpose(-1, -2) @ b3[..., None])[..., 0]
    X = (inv3x3(M) @ rhs3[..., None])[..., 0]  # (B, K, 3)

    p1 = se3.transform_points(T1_cw, X)
    p2 = se3.transform_points(T2_cw, X)
    cheir = (p1[..., 2] > 0.05) & (p2[..., 2] > 0.05)
    c1 = se3.se3_inverse(T1_cw)[:, None, :3, 3]
    c2 = se3.se3_inverse(T2_cw)[:, None, :3, 3]
    r1 = X - c1
    r2 = X - c2
    n1 = torch.linalg.norm(r1, dim=-1)
    n2 = torch.linalg.norm(r2, dim=-1)
    cos_par = torch.sum(r1 * r2, dim=-1) / (n1 * n2 + 1e-9)
    parallax_ok = cos_par < 0.9998

    uvp1, _ = cam_ops.project(p1, cam)
    uvp2, _ = cam_ops.project(p2, cam)
    l1 = level1.clamp(0, L - 1)
    l2j = torch.gather(level2, 1, j).clamp(0, L - 1)
    e1 = torch.sum((uvp1 - uv1) ** 2, dim=-1) / sf[l1] ** 2
    e2 = torch.sum((uvp2 - uv2j) ** 2, dim=-1) / sf[l2j] ** 2
    reproj_ok = (e1 < max_reproj_chi2) & (e2 < max_reproj_chi2)

    ratio = n1 / torch.clamp(n2, min=1e-9)
    octave_ratio = sf[l1] / sf[l2j]
    scale_ok = (ratio < octave_ratio * 1.5 * orb.scale_factor) & (
        ratio > octave_ratio / (1.5 * orb.scale_factor))

    ok = m_valid & cheir & parallax_ok & reproj_ok & scale_ok
    return TriangulationResult(
        pts_w=torch.where(ok[..., None], X, torch.zeros_like(X)),
        idx2=torch.where(ok, m_idx, torch.full_like(m_idx, -1)),
        valid=ok,
    )
