"""Global (full-map) bundle adjustment via implicit Schur complement + CG
(counterpart of the JAX package's `mapping/global_ba.py`).

Equivalent of Optimizer::GlobalBundleAdjustemnt (perfect/src/
Optimizer.cc:72-363) and of the GBA thread spawned on loop closure
(LoopClosing.cc:773-826). The reduced camera system

    S = Hcc - Hcp Hpp^-1 Hcp^T

is never formed. Observations live in flat padded arrays (M = F*K
slots, one per keyframe-keypoint cell); each Gauss-Newton iteration
builds per-observation residual and Jacobian blocks, the block diagonals
Hcc (F, 6, 6) and Hpp (P, 3, 3) and the coupling blocks
B_m = J_pose^T W J_point (M, 6, 3), and solves S dx_c = rhs with
block-Jacobi preconditioned CG whose matvec is two gathers and two
segment sums (Agarwal et al., "Bundle Adjustment in the Large").

The JAX module keeps every per-observation quantity as lists of (M,)
component vectors, a layout that exists only to dodge the TPU's (8, 128)
tile padding; here the blocks are stacked (M, 3, 6) / (M, 3, 3) / (M, 6, 3)
tensors contracted by batched einsums. Sums over points are `index_add_`
in slot order (the JAX module's point sort served its sorted
`segment_sum` only); sums over keyframes are reshape reductions on the
slot layout (`obs_per_kf`) or `index_add_` without it. An empty slot
adds its zeros to one of `_SPREAD_ROWS` spare rows past the real ones
(`_spread`), not to a real row: the entry points run deterministic
kernels (`utils/precision.py`), whose scatter-add walks the repeats of
one index in order, and half a million empty slots on one row made each
sum take ~0.1 s on an H100 (`chip_smoke.py` phase 7).

The form distributes: with the observations split over the mesh's `pt`
axis (`group`, the JAX module's `axis_name`), every sum over keyframes or
points is a local `index_add_` followed by one all-reduce
(`parallel/dist_ba.py`, `global_ba_step_state_sharded`).

Gauge: fixed keyframes keep zeroed pose Jacobians and an identity block
on their Hcc diagonal (g2o setFixed).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, OptimizerConfig, SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.frontend.extractor import scale_factors
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import SlamState
from orb_slam2_ssd_semantic_tpu_torch.ops.linalg import cholesky_solve_small, inv3x3
from orb_slam2_ssd_semantic_tpu_torch.parallel import dist_ba
from orb_slam2_ssd_semantic_tpu_torch.parallel.mesh import PT_AXIS, axis_size, gather_rows, shard_rows
from orb_slam2_ssd_semantic_tpu_torch.utils import precision


@dataclasses.dataclass
class GlobalBAProblem:
    """Full-map BA problem over flat observation slots: F keyframes, P
    points, M observation slots (padded; `obs_valid` masks real ones)."""

    T_cw: torch.Tensor  # (F, 4, 4)
    fixed: torch.Tensor  # (F,) bool: gauge keyframes
    points: torch.Tensor  # (P, 3)
    point_valid: torch.Tensor  # (P,) bool
    obs_kf: torch.Tensor  # (M,) int64 keyframe index
    obs_pt: torch.Tensor  # (M,) int64 point index
    obs_uvr: torch.Tensor  # (M, 3) [u, v, uR]
    inv_sigma2: torch.Tensor  # (M,)
    is_stereo: torch.Tensor  # (M,) bool
    obs_valid: torch.Tensor  # (M,) bool

    def replace(self, **kw) -> "GlobalBAProblem":
        return dataclasses.replace(self, **kw)


# Spare rows for the sums' empty slots (module docstring): at full width
# (512 x 1024 slots) each takes at most 64 of them.
_SPREAD_ROWS = 8192


def _spread(idx: torch.Tensor, used: torch.Tensor, n: int) -> torch.Tensor:
    """`idx` where `used`, else one of the `_SPREAD_ROWS` rows after the
    `n` real ones, by slot."""
    spare = n + torch.arange(idx.shape[0], device=idx.device) % _SPREAD_ROWS
    return torch.where(used, idx, spare)


def _row_sum(v: torch.Tensor, key: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """(M, ...) -> (n, ...): v summed onto rows `key` (from `_spread`), and
    over the ranks of `group` when one is given."""
    out = v.new_zeros((n + _SPREAD_ROWS,) + v.shape[1:]).index_add_(0, key, v)[:n]
    if group is not None:
        dist.all_reduce(out, group=group)
    return out


@dataclasses.dataclass
class GlobalBAResult:
    T_cw: torch.Tensor  # (F, 4, 4)
    points: torch.Tensor  # (P, 3)
    inlier: torch.Tensor  # (M,) final chi2 inlier mask
    chi2: torch.Tensor  # (M,)


def _residual_components(T_cw, points, prob: GlobalBAProblem, cam: CameraConfig):
    """Per-observation residuals e (M, 3), pose Jacobians (M, 3, 6)
    (translation-first left perturbation), point Jacobians (M, 3, 3) and
    the behind-camera mask (M,)."""
    R = T_cw[prob.obs_kf, :3, :3]
    p = (R @ points[prob.obs_pt][..., None])[..., 0] + T_cw[prob.obs_kf, :3, 3]
    x, y, z = p.unbind(-1)
    iz = 1.0 / torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    iz2 = iz * iz
    zeros = torch.zeros_like(iz)
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.depth_bf * iz
    behind = z <= 1e-6
    # Zero dead residuals: behind-camera projections overflow f32, and
    # 0-weight * inf residual = NaN downstream.
    dead = behind | (~prob.obs_valid)
    e = torch.where(dead[:, None], torch.zeros_like(prob.obs_uvr),
                    torch.stack([u, v, ur], -1) - prob.obs_uvr)
    # d(u, v, uR)/dp rows.
    du = torch.stack([cam.fx * iz, zeros, -cam.fx * x * iz2], -1)
    dv = torch.stack([zeros, cam.fy * iz, -cam.fy * y * iz2], -1)
    dur = torch.stack([du[:, 0], zeros, du[:, 2] + cam.depth_bf * iz2], -1)
    duvr = torch.stack([du, dv, dur], -2)  # (M, 3, 3)
    # dp/dxi = [I | -hat(p)].
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[0], 3, 3)
    dp_dxi = torch.cat([eye, -se3.hat(p)], dim=-1)  # (M, 3, 6)
    return e, duvr @ dp_dxi, duvr @ R, behind


def _gn_direction(e, J_pose, J_point, wc, prob: GlobalBAProblem, cfg: OptimizerConfig,
                  cg_iters: int, obs_per_kf: int | None = None, group=None):
    """One Gauss-Newton direction (dx_c (F, 6), dx_p (P, 3)) for the
    weighted problem; `wc` (M, 3) are the robust per-component weights.
    With `group`, the observation arrays are this rank's rows and each sum
    is all-reduced over the group (the reshape path is off then: a rank's
    rows are not slot-aligned)."""
    F = prob.T_cw.shape[0]
    P = prob.points.shape[0]
    kf, pt = prob.obs_kf, prob.obs_pt
    # Every per-slot term of an empty slot is 0 (its weight is).
    kf_key, pt_key = _spread(kf, prob.obs_valid, F), _spread(pt, prob.obs_valid, P)

    def kf_sum(v):  # (M, ...) -> (F, ...)
        if obs_per_kf is not None and group is None:
            return v.reshape(F, obs_per_kf, *v.shape[1:]).sum(1)
        return _row_sum(v, kf_key, F, group)

    def pt_sum(v):  # (M, ...) -> (P, ...)
        return _row_sum(v, pt_key, P, group)

    JtW = J_pose * wc[..., None]  # (M, 3, 6) pre-weighted pose rows
    B = torch.einsum("mri,mrj->mij", JtW, J_point)  # (M, 6, 3) coupling blocks
    Hcc = kf_sum(torch.einsum("mri,mrj->mij", JtW, J_pose))
    Hpp = pt_sum(torch.einsum("mri,mr,mrj->mij", J_point, wc, J_point))
    b_c = kf_sum(-torch.einsum("mri,mr->mi", JtW, e))
    b_p = pt_sum(-torch.einsum("mri,mr->mi", J_point, wc * e))

    lam = cfg.lm_lambda_init
    eye3 = torch.eye(3, dtype=Hpp.dtype, device=Hpp.device)
    eye6 = torch.eye(6, dtype=Hcc.dtype, device=Hcc.device)
    # Marquardt scaling: damping proportional to the block diagonal, with
    # an absolute floor for empty blocks.
    dpp = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
    Hpp_inv = inv3x3(Hpp + (lam * dpp / 3.0 + 1e-6)[:, None, None] * eye3)
    dcc = torch.diagonal(Hcc, dim1=-2, dim2=-1).sum(-1)
    Hcc = Hcc + (lam * dcc / 6.0 + 1e-5 + prob.fixed.to(Hcc.dtype))[:, None, None] * eye6

    def down_project(x):  # x (F, 6) -> Hpp^-1 Hcp^T x (P, 3)
        t_p = pt_sum(torch.einsum("mij,mi->mj", B, x[kf]))
        return (Hpp_inv @ t_p[..., None])[..., 0]

    def up_project(y):  # y (P, 3) -> Hcp y (F, 6)
        return kf_sum(torch.einsum("mij,mj->mi", B, y[pt]))

    def matvec(x):  # S x
        return (Hcc @ x[..., None])[..., 0] - up_project(down_project(x))

    # Reduced RHS: b_c - Hcp Hpp^-1 b_p.
    rhs = b_c - up_project((Hpp_inv @ b_p[..., None])[..., 0])

    # Block-Jacobi preconditioned CG on S dx_c = rhs (unrolled 6x6 Cholesky).
    def prec(r):
        return cholesky_solve_small(Hcc, r)

    x = torch.zeros_like(rhs)
    r = rhs
    d = prec(r)
    rz = torch.sum(r * d)
    tiny = torch.tensor(1e-20, dtype=rhs.dtype, device=rhs.device)
    for _ in range(cg_iters):
        Sd = matvec(d)
        dSd = torch.sum(d * Sd)
        alpha = rz / torch.where(torch.abs(dSd) > 1e-20, dSd, tiny)
        x = x + alpha * d
        r = r - alpha * Sd
        z = prec(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.where(torch.abs(rz) > 1e-20, rz, tiny)
        d = z + beta * d
        rz = rz_new
    x = x * (~prob.fixed)[:, None]

    # Back-substitute points: dx_p = Hpp^-1 (b_p - Hcp^T dx_c).
    t_p = pt_sum(torch.einsum("mij,mi->mj", B, x[kf]))
    dx_p = (Hpp_inv @ (b_p - t_p)[..., None])[..., 0] * prob.point_valid[:, None]
    return x, dx_p


def _gn_iteration(T_cw, points, prob: GlobalBAProblem, cam: CameraConfig, cfg: OptimizerConfig,
                  comp_w, delta, cg_iters: int, obs_per_kf=None, group=None):
    """One robust (Huber) Gauss-Newton step; returns (T_cw, points)."""
    e, J_pose, J_point, behind = _residual_components(T_cw, points, prob, cam)
    w = prob.inv_sigma2 * prob.obs_valid * (~behind)
    chi = torch.sum(e * e * comp_w, -1) * prob.inv_sigma2
    rho = torch.where(chi > delta * delta, delta / torch.sqrt(torch.clamp(chi, min=1e-12)),
                      torch.ones_like(chi))
    wc = (w * rho)[:, None] * comp_w  # (M, 3)
    # Fixed keyframes contribute to points but not to pose blocks.
    J_pose = J_pose * (~prob.fixed)[prob.obs_kf].to(J_pose.dtype)[:, None, None]
    dx_c, dx_p = _gn_direction(e, J_pose, J_point, wc, prob, cfg, cg_iters, obs_per_kf, group)
    return se3.se3_exp(dx_c) @ T_cw, points + dx_p


def global_ba_core(prob: GlobalBAProblem, cam: CameraConfig, cfg: OptimizerConfig,
                   cg_iters: int, obs_per_kf: int | None = None, group=None) -> GlobalBAResult:
    """The full robust GN loop: `cfg.global_ba_iters` iterations as a host
    loop that never reads the device. `obs_per_kf`: set when obs_kf ==
    repeat(arange(F), K) (`problem_from_state` builds that layout), which
    turns the keyframe sums into reshape reductions. With `group` (a
    process group: the JAX module's `axis_name`), the observation arrays
    of `prob` are this rank's rows and every sum is all-reduced over it
    (`parallel/dist_ba.py`); `inlier` and `chi2` are then this rank's rows."""
    F = prob.T_cw.shape[0]
    ones3 = prob.obs_uvr.new_ones(3)
    comp_w = torch.where(prob.is_stereo[:, None], ones3, prob.obs_uvr.new_tensor([1.0, 1.0, 0.0]))
    chi2_th = torch.where(prob.is_stereo, torch.full_like(prob.inv_sigma2, cfg.chi2_stereo),
                          torch.full_like(prob.inv_sigma2, cfg.chi2_mono))
    delta = torch.where(prob.is_stereo, torch.full_like(prob.inv_sigma2, cfg.huber_delta_stereo),
                        torch.full_like(prob.inv_sigma2, cfg.huber_delta_mono))
    # A keyframe with fewer than 6 observations has an underdetermined
    # 6-DoF pose: freeze it (it still constrains its points).
    n_obs_kf = torch.zeros((F,), dtype=torch.int64, device=prob.T_cw.device).index_add_(
        0, prob.obs_kf, prob.obs_valid.to(torch.int64))
    if group is not None:
        dist.all_reduce(n_obs_kf, group=group)
    prob = prob.replace(fixed=prob.fixed | (n_obs_kf < 6))

    T_cw, points = prob.T_cw, prob.points
    for _ in range(cfg.global_ba_iters):
        T_cw, points = _gn_iteration(T_cw, points, prob, cam, cfg, comp_w, delta, cg_iters,
                                     obs_per_kf, group)
    e, _, _, behind = _residual_components(T_cw, points, prob, cam)
    chi = torch.sum(e * e * comp_w, -1) * prob.inv_sigma2
    inlier = prob.obs_valid & (chi < chi2_th) & (~behind)
    return GlobalBAResult(T_cw, points, inlier, chi)


@precision.scoped
def global_bundle_adjust(prob: GlobalBAProblem, cam: CameraConfig,
                         cfg: OptimizerConfig = OptimizerConfig(), cg_iters: int = 20,
                         obs_per_kf: int | None = None) -> GlobalBAResult:
    """Full-map BA: `cfg.global_ba_iters` robust GN iterations, each
    solving the reduced camera system with `cg_iters` PCG steps."""
    return global_ba_core(prob, cam, cfg, cg_iters, obs_per_kf=obs_per_kf)


def problem_from_state(state: SlamState, cfg: SlamConfig, fixed_kf=None) -> GlobalBAProblem:
    """The full-map problem of `state`: one observation slot per
    (keyframe, keypoint) cell (M = F*K). Gauge: slot `fixed_kf` if given,
    else the oldest live keyframe (minimum uid; slot 0 may be reused)."""
    kfs = state.kfs
    F, K = kfs.kp_point.shape
    P = state.points.pos.shape[0]
    dev = kfs.valid.device
    if fixed_kf is None:
        uid_eff = torch.where(kfs.valid & (kfs.uid >= 0), kfs.uid,
                              torch.full_like(kfs.uid, 2 ** 30))
        fixed_kf = torch.argmin(uid_eff)
    sf = scale_factors(cfg.orb, dev)
    kp_point = kfs.kp_point.reshape(-1)
    obs_kf = torch.arange(F, device=dev).repeat_interleave(K)
    obs_pt = kp_point.clamp(0, P - 1)
    obs_valid = ((kp_point >= 0) & state.points.valid[obs_pt] & kfs.kp_valid.reshape(-1)
                 & kfs.valid[obs_kf])
    inv_sigma2 = (1.0 / (sf[kfs.level.clamp(0, cfg.orb.n_levels - 1)] ** 2)).reshape(-1)
    depth = kfs.depth.reshape(-1)
    uv = kfs.uv.reshape(-1, 2)
    has_d = depth > 1e-6
    ur = torch.where(has_d, uv[:, 0] - cfg.camera.depth_bf
                     / torch.where(has_d, depth, torch.ones_like(depth)),
                     torch.full_like(depth, -1.0))
    return GlobalBAProblem(
        T_cw=kfs.T_cw,
        fixed=(torch.arange(F, device=dev) == fixed_kf) | (~kfs.valid),
        points=state.points.pos,
        point_valid=state.points.valid,
        obs_kf=obs_kf,
        obs_pt=obs_pt,
        obs_uvr=torch.cat([uv, ur[:, None]], dim=-1),
        inv_sigma2=inv_sigma2,
        is_stereo=has_d,
        obs_valid=obs_valid,
    )


def _write_back(state: SlamState, prob: GlobalBAProblem, res: GlobalBAResult) -> SlamState:
    """Refined poses and points into the state, and the observations the
    final chi2 test rejects pruned (RunGlobalBundleAdjustment's
    write-back, LoopClosing.cc:826-940, with the local-BA erase step)."""
    kfs, pts = state.kfs, state.points
    F, K = kfs.kp_point.shape
    P = pts.pos.shape[0]
    T_cw = torch.where((kfs.valid & ~prob.fixed)[:, None, None], res.T_cw, kfs.T_cw)
    pos = torch.where(pts.valid[:, None], res.points, pts.pos)
    pruned = (prob.obs_valid & ~res.inlier).reshape(F, K)
    kp_point = torch.where(pruned, torch.full_like(kfs.kp_point, -1), kfs.kp_point)
    n_obs = _row_sum(torch.ones_like(prob.obs_pt, dtype=pts.n_obs.dtype),
                     _spread(prob.obs_pt, pruned.reshape(-1), P), P)
    return state.replace(
        points=pts.replace(pos=pos, n_obs=torch.clamp(pts.n_obs - n_obs, min=0)),
        kfs=kfs.replace(T_cw=T_cw, kp_point=kp_point))


@precision.scoped
def global_ba_step_state(state: SlamState, cfg: SlamConfig, cg_iters: int = 20) -> SlamState:
    """Global BA over the whole state, written back: refined poses and
    points, outlier observations pruned (RunGlobalBundleAdjustment; here
    direct, since no concurrent tracking mutates the state meanwhile)."""
    prob = problem_from_state(state, cfg)
    res = global_ba_core(prob, cfg.camera, cfg.optimizer, cg_iters,
                         obs_per_kf=state.kfs.kp_point.shape[1])
    return _write_back(state, prob, res)


@precision.scoped
def global_ba_step_state_sharded(state: SlamState, cfg: SlamConfig, mesh,
                                 cg_iters: int = 20) -> SlamState:
    """`global_ba_step_state` with the O(M) observation sums split over
    the mesh's `pt` axis (`parallel/dist_ba.make_distributed_global_ba`):
    the engine path of `SlamSystem(mesh=...)`. M is padded to a multiple
    of the axis size with `obs_valid=False` rows (which add nothing), each
    rank takes its rows, and the inlier rows are gathered for the
    write-back. The refined poses and points are the same on every rank
    (all-reduced sums); every rank of the mesh must call this together."""
    prob = problem_from_state(state, cfg)
    M = prob.obs_kf.shape[0]
    pad = (-M) % axis_size(mesh, PT_AXIS)

    def rows(x):
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
        return shard_rows(x, mesh, PT_AXIS)

    local = prob.replace(**{k: rows(getattr(prob, k)) for k in (
        "obs_kf", "obs_pt", "obs_uvr", "inv_sigma2", "is_stereo", "obs_valid")})
    res = dist_ba.make_distributed_global_ba(mesh, cfg.camera, cfg.optimizer, cg_iters)(local)
    res = GlobalBAResult(res.T_cw, res.points, gather_rows(res.inlier, mesh, PT_AXIS)[:M],
                         gather_rows(res.chi2, mesh, PT_AXIS)[:M])
    return _write_back(state, prob, res)
