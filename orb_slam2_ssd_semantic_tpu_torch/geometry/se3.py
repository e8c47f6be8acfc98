"""SO(3)/SE(3) Lie-group utilities on tensors (counterpart of the JAX
package's `geometry/se3.py`): SO(3) and SE(3) for tracking and
relocalization, and the Sim(3) algebra of loop closing.

Poses are world-to-camera 4x4 matrices `T_cw`; every function works over
leading batch dims. Contractions run in full f32: the entry points turn
TF32 off (`utils/precision.py`), the torch counterpart of the JAX
module's per-call `Precision.HIGHEST`.
"""

from __future__ import annotations

import math

import torch

from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import finite_matrices, nan_where


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator. w: (..., 3) -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat. W: (..., 3, 3) -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye3(ref: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=ref.dtype, device=ref.device).expand(shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map (Taylor-safe near 0). (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-32)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    return _eye3(w, W.shape) + a[..., None, None] * W + b[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map. R: (..., 3, 3) -> w (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    w_raw = vee(R - R.transpose(-1, -2)) / 2.0  # = sin(theta) * axis
    sin_theta = torch.sqrt(torch.sum(w_raw * w_raw, dim=-1) + 1e-32)
    theta = torch.atan2(sin_theta, cos_theta)
    small = theta < 1e-6
    scale = torch.where(
        small, 1.0 + theta * theta / 6.0,
        theta / torch.where(small, torch.ones_like(sin_theta), sin_theta + 1e-32),
    )
    w = w_raw * scale[..., None]
    # theta ~ pi branch: axis from the diagonal of (R + I)/2.
    near_pi = theta > (math.pi - 1e-3)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) / 2.0, 0.0, 1.0))
    one = torch.ones_like(theta)
    sx = torch.where(R[..., 2, 1] - R[..., 1, 2] >= 0, one, -one)
    sy = torch.where(R[..., 0, 2] - R[..., 2, 0] >= 0, one, -one)
    sz = torch.where(R[..., 1, 0] - R[..., 0, 1] >= 0, one, -one)
    axis = axis * torch.stack([sx, sy, sz], dim=-1)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-32)
    w_pi = axis * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) exp. xi = (v, w): (..., 6) translation-first -> T (..., 4, 4)."""
    v, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-32)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    eye = _eye3(xi, W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    t = (V @ v[..., None])[..., 0]
    return rt_to_mat(R, t)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log. T: (..., 4, 4) -> xi (..., 6), translation-first."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + 1e-32)
    W = hat(w)
    W2 = W @ W
    small = theta2 < 1e-12
    half = theta / 2.0
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / (torch.sin(half) + 1e-32)) / (theta2 + 1e-32),
    )
    V_inv = _eye3(T, W.shape) - 0.5 * W + cot_term[..., None, None] * W2
    v = (V_inv @ t[..., None])[..., 0]
    return torch.cat([v, w], dim=-1)


def rt_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R (...,3,3), t (...,3)) -> T (...,4,4)."""
    T = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    T[..., 3, 3].fill_(1.0)  # an assignment of a host number to one element copies it over
    return T


def mat_to_rt(T: torch.Tensor):
    return T[..., :3, :3], T[..., :3, 3]


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    R, t = mat_to_rt(T)
    Rt = R.transpose(-1, -2)
    return rt_to_mat(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply T (...,4,4) to pts (..., N, 3) -> (..., N, 3)."""
    R, t = mat_to_rt(T)
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def horn_sim3(src: torch.Tensor, dst: torch.Tensor, mask: torch.Tensor | None = None,
              with_scale: bool = True):
    """Closed-form similarity/rigid alignment dst ~ s*R*src + t (Umeyama
    least squares, the estimator of Sim3Solver::ComputeSim3). Batched over
    leading dims; `mask` (..., N) weights the correspondences (0/1 selects
    them). The sign fix det(U)·det(Vt) keeps R a rotation.

    Returns (s, R, t)."""
    if mask is None:
        mask = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    m = mask[..., None]
    n = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    mu_s = torch.sum(src * m, dim=-2) / n[..., None]
    mu_d = torch.sum(dst * m, dim=-2) / n[..., None]
    sc = (src - mu_s[..., None, :]) * m
    dc = (dst - mu_d[..., None, :]) * m
    C = torch.einsum("...ni,...nj->...ij", dc, sc) / n[..., None, None]  # cross-covariance
    var_s = torch.sum(sc * sc, dim=(-1, -2)) / n
    C, ok = finite_matrices(C)  # a NaN hypothesis stays NaN instead of failing the SVD
    U, D, Vt = torch.linalg.svd(C)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    S = torch.ones_like(D)
    S[..., 2] = torch.sign(det)
    R = nan_where(ok, U @ (S[..., :, None] * Vt))
    D = nan_where(ok, D)
    if with_scale:
        s = torch.sum(D * S, dim=-1) / torch.clamp(var_s, min=1e-32)
    else:
        s = torch.ones(R.shape[:-2], dtype=src.dtype, device=src.device)
    t = mu_d - s[..., None] * (R @ mu_s[..., None])[..., 0]
    return s, R, t


# ---- Sim(3) ---------------------------------------------------------------


def sim3_apply(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply similarity (s, R, t) to pts (..., N, 3)."""
    return s[..., None, None] * (pts @ R.transpose(-1, -2)) + t[..., None, :]


def sim3_inverse(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0]


def sim3_compose(s1, R1, t1, s2, R2, t2):
    """(s1,R1,t1) o (s2,R2,t2): first apply 2, then 1."""
    return s1 * s2, R1 @ R2, s1[..., None] * (R1 @ t2[..., None])[..., 0] + t1


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim(3) translation coupling matrix W(phi, sigma) with
    exp([rho, phi, sigma]) = (e^sigma, so3_exp(phi), W rho) (Strasdat,
    eq. 5.7), in the JAX module's branch-free safe form: every denominator
    of a branch that `where` leaves unselected is substituted with 1, so
    forward-mode derivatives at phi = 0, sigma = 0 (where `optimize_sim3`
    takes its Jacobian) carry no NaN."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + 1e-32)
    s = torch.exp(sigma)
    Phi = hat(phi)
    Phi2 = Phi @ Phi
    one = torch.ones_like(theta2)

    sig_small = torch.abs(sigma) < 1e-5
    th_small = theta2 < 1e-10
    sigma_safe = torch.where(sig_small, one, sigma)
    theta_safe = torch.where(th_small, one, theta)
    theta2_safe = torch.where(th_small, one, theta2)
    denom = sigma_safe * sigma_safe + theta2

    # C = (s - 1) / sigma, -> 1 as sigma -> 0.
    C = torch.where(sig_small, 1.0 + sigma / 2.0, (s - 1.0) / sigma_safe)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    A_g = (s * sin_t * sigma_safe + (1.0 - s * cos_t) * theta) / (theta_safe * denom)
    B_g = (C - ((s * cos_t - 1.0) * sigma_safe + s * sin_t * theta) / denom) / theta2_safe
    # sigma -> 0 limits: A -> (1 - cos)/theta^2, B -> (theta - sin)/theta^3.
    A_0 = torch.where(th_small, 0.5 * one, (1.0 - cos_t) / theta2_safe)
    B_0 = torch.where(th_small, one / 6.0,
                      (theta - sin_t) / torch.where(th_small, one, theta2 * theta_safe))
    # theta -> 0 limits (sigma != 0), from the Taylor expansion in theta.
    A_t0 = (s * sigma_safe - s + 1.0) / (sigma_safe * sigma_safe)
    B_t0 = (s - 1.0) / sigma_safe ** 3 - (s - s * sigma_safe / 2.0) / (sigma_safe * sigma_safe)
    A = torch.where(sig_small, A_0, torch.where(th_small, A_t0, A_g))
    B = torch.where(sig_small, B_0, torch.where(th_small, B_t0, B_g))
    return (C[..., None, None] * _eye3(phi, Phi.shape) + A[..., None, None] * Phi
            + B[..., None, None] * Phi2)


def sim3_exp(v: torch.Tensor):
    """Sim(3) exponential. v (..., 7) = [rho, phi, sigma] ->
    (s (...,), R (..., 3, 3), t (..., 3))."""
    rho, phi, sigma = v[..., 0:3], v[..., 3:6], v[..., 6]
    W = _sim3_W(phi, sigma)
    return torch.exp(sigma), so3_exp(phi), (W @ rho[..., None])[..., 0]


def sim3_log(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Sim(3) logarithm -> (..., 7) = [rho, phi, sigma]. W is never
    singular (its scale part C > 0); `solve_ex` keeps the solve free of
    the error check that would wait for the device."""
    sigma = torch.log(s)
    phi = so3_log(R)
    rho = torch.linalg.solve_ex(_sim3_W(phi, sigma), t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) (TUM order) -> rotation matrix (..., 3, 3)."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-32)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (x, y, z, w), branch-free Shepperd."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def sq(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2.0

    sw = sq(tr + 1.0)
    qw = torch.stack([(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw, sw / 4.0], -1)
    sx = sq(1.0 + m00 - m11 - m22)
    qx = torch.stack([sx / 4.0, (m01 + m10) / sx, (m02 + m20) / sx, (m21 - m12) / sx], -1)
    sy = sq(1.0 - m00 + m11 - m22)
    qy = torch.stack([(m01 + m10) / sy, sy / 4.0, (m12 + m21) / sy, (m02 - m20) / sy], -1)
    sz = sq(1.0 - m00 - m11 + m22)
    qz = torch.stack([(m02 + m20) / sz, (m12 + m21) / sz, sz / 4.0, (m10 - m01) / sz], -1)
    use_w = tr > 0
    use_x = (~use_w) & (m00 >= m11) & (m00 >= m22)
    use_y = (~use_w) & (~use_x) & (m11 >= m22)
    q = torch.where(
        use_w[..., None], qw,
        torch.where(use_x[..., None], qx, torch.where(use_y[..., None], qy, qz)),
    )
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-32)


def is_rotation_matrix(R: torch.Tensor, tol: float = 1e-4) -> torch.Tensor:
    """Orthonormality check (reference: Geometry.cc:555 assert): the
    Frobenius norm of R Rᵀ - I under `tol`."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    return torch.linalg.norm(R @ R.transpose(-1, -2) - eye, dim=(-2, -1)) < tol
