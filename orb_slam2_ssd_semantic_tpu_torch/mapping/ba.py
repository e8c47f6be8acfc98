"""Local bundle adjustment with Schur-complement reduction (counterpart of
the JAX package's `mapping/ba.py`).

W keyframes, N local points, K keypoint slots per keyframe; observations
are padded (W, K) tensors with `point_slot` = -1 for none. Per
Gauss-Newton step: residuals and analytic Jacobians as component lists of
(W, K) tensors, the per-(pose, point) coupling blocks and point sums by
one index_add over (w, slot) keys, the reduced camera system
S = Hcc - Hcp Hpp^-1 Hcp', its damped solve, and point back-substitution.
The solve goes through the SPD kernel (`ops/cuda_solve.py`) when
6W <= 128, else torch.linalg.solve_ex — the JAX package's routing. With
`ba_reduction_dtype="bfloat16"` the two Schur products take operands
rounded to bfloat16 and multiply them in f32 (exact for bf16 values),
which is what a TPU's default matmul precision does. Two
phases (Huber, then clean after a chi2 gate) with best-state tracking
and gain-based early exit.

Nothing here waits on the card, so a caller can dispatch the whole
adjustment and go on (the tracker's `async_mapping`). The early exit is
JAX's `while_loop` as a fixed loop of `n_iters` steps whose carry
freezes on the device once the gain test fires; the last-vs-best choice
is a select; the large solve skips `torch.linalg.solve`'s host check
for a singular matrix (a non-finite step is zeroed, as in JAX).
"""

from __future__ import annotations

import dataclasses

import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, OptimizerConfig
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_solve
from orb_slam2_ssd_semantic_tpu_torch.ops.linalg import inv3x3_cols
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import put


@dataclasses.dataclass
class BAProblem:
    T_cw: torch.Tensor  # (W, 4, 4) initial poses
    fixed: torch.Tensor  # (W,) bool
    points: torch.Tensor  # (N, 3)
    point_valid: torch.Tensor  # (N,) bool
    point_slot: torch.Tensor  # (W, K) int64 local point index, -1 = none
    obs_uvr: torch.Tensor  # (W, K, 3)
    inv_sigma2: torch.Tensor  # (W, K)
    is_stereo: torch.Tensor  # (W, K) bool


@dataclasses.dataclass
class BAResult:
    T_cw: torch.Tensor
    points: torch.Tensor
    inlier: torch.Tensor  # (W, K) bool
    chi2: torch.Tensor  # (W, K)
    iters: torch.Tensor  # (2,) int32 Gauss-Newton steps each phase took before its exit


def _residual_components(T_cw, points, prob: BAProblem, cam: CameraConfig):
    """Residuals and Jacobians as component lists of (W, K) tensors:
    (e [3], J_pose [3][6], J_point [3][3], behind)."""
    slot = prob.point_slot.clamp(0, points.shape[0] - 1)
    X = points[slot]  # (W, K, 3)
    R = T_cw[:, :3, :3]
    t = T_cw[:, :3, 3]
    Rg = [[R[:, i, j][:, None] for j in range(3)] for i in range(3)]
    Xc = [X[..., j] for j in range(3)]
    p = [sum(Rg[i][j] * Xc[j] for j in range(3)) + t[:, i][:, None] for i in range(3)]
    x, y, z = p
    z_safe = torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    iz = 1.0 / z_safe
    iz2 = iz * iz
    zeros = torch.zeros_like(iz)
    ones = torch.ones_like(iz)
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    ur = u - cam.depth_bf * iz
    e = [u - prob.obs_uvr[..., 0], v - prob.obs_uvr[..., 1], ur - prob.obs_uvr[..., 2]]
    du = [cam.fx * iz, zeros, -cam.fx * x * iz2]
    dv = [zeros, cam.fy * iz, -cam.fy * y * iz2]
    dur = [du[0], du[1], du[2] + cam.depth_bf * iz2]
    duvr = [du, dv, dur]
    hat = [[zeros, -z, y], [z, zeros, -x], [-y, x, zeros]]
    eye = [[ones if i == k else zeros for i in range(3)] for k in range(3)]
    dp_dxi = [[eye[k][0], eye[k][1], eye[k][2], -hat[k][0], -hat[k][1], -hat[k][2]]
              for k in range(3)]
    J_pose = [[sum(duvr[r][k] * dp_dxi[k][i] for k in range(3)) for i in range(6)]
              for r in range(3)]
    J_point = [[sum(duvr[r][k] * Rg[k][i] for k in range(3)) for i in range(3)]
               for r in range(3)]
    return e, J_pose, J_point, z <= 1e-6


def _residuals(T_cw, points, prob: BAProblem, cam: CameraConfig):
    """Stacked residuals (W, K, 3) and the behind-camera mask."""
    slot = prob.point_slot.clamp(0, points.shape[0] - 1)
    X = points[slot]
    R = T_cw[:, :3, :3]
    t = T_cw[:, :3, 3]
    p = torch.einsum("wij,wkj->wki", R, X) + t[:, None, :]
    z = p[..., 2]
    z_safe = torch.where(z > 1e-6, z, torch.full_like(z, 1e-6))
    iz = 1.0 / z_safe
    u = cam.fx * p[..., 0] * iz + cam.cx
    v = cam.fy * p[..., 1] * iz + cam.cy
    ur = u - cam.depth_bf * iz
    e = torch.stack([u - prob.obs_uvr[..., 0], v - prob.obs_uvr[..., 1],
                     ur - prob.obs_uvr[..., 2]], dim=-1)
    return e, z <= 1e-6


def _huber_cost(chi, delta, use_huber: bool):
    if not use_huber:
        return chi
    return torch.where(chi > delta * delta,
                       delta * (2.0 * torch.sqrt(torch.clamp(chi, min=1e-12)) - delta), chi)


def solve_reduced(S_mat: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The damped SPD reduced camera system: the SPD kernel up to 128
    unknowns (its plain version on the CPU), torch.linalg.solve_ex above
    (the same LU as `solve`, without its host-side singularity check)."""
    if S_mat.shape[0] <= cuda_solve.PAD:
        return cuda_solve.spd_solve(S_mat, rhs)
    return torch.linalg.solve_ex(S_mat, rhs)[0]


def _reduction_operand(dtype: str):
    """The rounding applied to the Schur products' operands: none for
    "float32"; for "bfloat16" a round trip through bfloat16, so that the
    f32 matmul (TF32 off) sums exact products of bf16 values with f32
    accumulation, as a TPU's `Precision.DEFAULT` does on every device."""
    if dtype == "float32":
        return lambda x: x
    if dtype == "bfloat16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"ba_reduction_dtype must be 'float32' or 'bfloat16', not {dtype!r}")


def local_bundle_adjust(prob: BAProblem, cam: CameraConfig,
                        cfg: OptimizerConfig = OptimizerConfig()) -> BAResult:
    schur_operand = _reduction_operand(cfg.ba_reduction_dtype)
    W, K = prob.point_slot.shape
    N = prob.points.shape[0]
    dev = prob.points.device
    f32 = torch.float32
    # Residual component weights: (1, 1, 1) stereo, (1, 1, 0) mono.
    comp_w = torch.cat([torch.ones((W, K, 2), dtype=f32, device=dev),
                        prob.is_stereo[..., None].to(f32)], dim=-1)
    chi2_th = torch.where(prob.is_stereo, cfg.chi2_stereo, cfg.chi2_mono)
    delta = torch.where(prob.is_stereo, cfg.huber_delta_stereo, cfg.huber_delta_mono)
    slot = prob.point_slot.clamp(0, N - 1)
    obs_valid = (prob.point_slot >= 0) & prob.point_valid[slot]
    free_pose = (~prob.fixed).to(f32)
    fixed_diag = prob.fixed.repeat(6).to(f32)  # (i, w) order
    # Combined (w, slot) key of each observation: one index_add gives the
    # per-(pose, point) blocks; summed over w, the point sums.
    slot_eff = torch.where(obs_valid, slot, torch.full_like(slot, N))
    key = (torch.arange(W, device=dev)[:, None] * (N + 1) + slot_eff).reshape(-1)

    def gn_step(T_cw, points, inlier_w, use_huber: bool):
        e, J_pose, J_point, behind = _residual_components(T_cw, points, prob, cam)
        w = prob.inv_sigma2 * inlier_w * (~behind)
        chi = sum(e[r] * e[r] * comp_w[..., r] for r in range(3)) * prob.inv_sigma2
        cost_here = torch.sum(_huber_cost(chi, delta, use_huber) * inlier_w * (~behind))
        if use_huber:
            rho = torch.where(chi > delta * delta,
                              delta / torch.sqrt(torch.clamp(chi, min=1e-12)), torch.ones_like(chi))
        else:
            rho = torch.ones_like(chi)
        wr = w * rho
        wc = [wr * comp_w[..., r] for r in range(3)]
        fp = free_pose[:, None]
        JtW = [[J_pose[r][i] * wc[r] * fp for i in range(6)] for r in range(3)]
        Hcc = torch.stack(
            [sum((JtW[r][i] * J_pose[r][j] * fp).sum(-1) for r in range(3))
             for i in range(6) for j in range(6)], dim=-1).reshape(W, 6, 6)
        b_c = torch.stack([-sum((JtW[r][i] * e[r]).sum(-1) for r in range(3)) for i in range(6)],
                          dim=-1)  # (W, 6)
        pp12 = [sum(J_point[r][i] * wc[r] * J_point[r][j] for r in range(3))
                for i in range(3) for j in range(3)]
        pp12 += [-sum(J_point[r][i] * wc[r] * e[r] for r in range(3)) for i in range(3)]
        hcp = [sum(JtW[r][i] * J_point[r][j] for r in range(3)) for i in range(6) for j in range(3)]
        stacked = torch.stack(hcp + pp12, dim=-1).reshape(W * K, 30)
        red = put(torch.zeros((W * (N + 1), 30), dtype=f32, device=dev), key, stacked,
                  accumulate=True)
        red = red.reshape(W, N + 1, 30)[:, :N].permute(2, 0, 1)  # (30, W, N)
        Hcp = red[:18]
        red_p = red[18:].sum(dim=1)  # (12, N)
        Hpp_cols = red_p[:9].reshape(3, 3, N).clone()
        b_p = red_p[9:]
        lam = cfg.lm_lambda_init
        for i in range(3):
            Hpp_cols[i, i] += lam + 1e-6
        Hpp_inv = inv3x3_cols(Hpp_cols)

        A = [[sum(Hcp[i * 3 + b] * Hpp_inv[b, c][None, :] for b in range(3)) for c in range(3)]
             for i in range(6)]
        A_mat = [schur_operand(torch.stack([A[i][c] for i in range(6)], 0).reshape(6 * W, N))
                 for c in range(3)]
        H_mat = [schur_operand(torch.stack([Hcp[i * 3 + c] for i in range(6)], 0)
                               .reshape(6 * W, N)) for c in range(3)]
        S_mat = -sum(A_mat[c] @ H_mat[c].T for c in range(3))  # (6W, 6W) iw order
        # Hcc onto the (w, w) blocks, through the diagonal view of the
        # (6, W, 6, W) layout (an index assignment would check its
        # indices on the host).
        S_mat.view(6, W, 6, W).diagonal(dim1=1, dim2=3).add_(Hcc.permute(1, 2, 0))
        rhs = b_c.T - sum((A_mat[c] @ schur_operand(b_p[c])).reshape(6, W) for c in range(3))
        S_diag = torch.abs(torch.diagonal(S_mat))
        S_mat = S_mat + torch.diag(1e-3 * S_diag + fixed_diag + 1e-5)
        dx = solve_reduced(S_mat, rhs.reshape(-1)).reshape(6, W)
        dx = dx * free_pose[None, :]
        dx = torch.clamp(torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx)), -0.5, 0.5)
        corr = [sum((Hcp[i * 3 + c] * dx[i][:, None]).sum(0) for i in range(6)) for c in range(3)]
        resid = torch.stack([b_p[c] - corr[c] for c in range(3)], 0)  # (3, N)
        dx_p = torch.einsum("bcn,cn->bn", Hpp_inv, resid).T
        dx_p = dx_p * prob.point_valid[:, None]
        dx_p = torch.clamp(torch.where(torch.isfinite(dx_p), dx_p, torch.zeros_like(dx_p)), -2.0, 2.0)
        T_new = se3.se3_exp(dx.T) @ T_cw
        return T_new, points + dx_p, cost_here

    def phase(T, pts, inlier, use_huber: bool, n_iters: int):
        """Best-state tracking with gain-based early exit: JAX's
        `while_loop`, run for all `n_iters` steps with the carry frozen
        once `done` is set, so the host never reads the gain test."""
        best_T, best_pts = T, pts
        best_cost = torch.full((), torch.finfo(f32).max, dtype=f32, device=dev)
        prev_cost = best_cost
        done = torch.zeros((), dtype=torch.bool, device=dev)
        taken = torch.zeros((), dtype=torch.int32, device=dev)
        for _ in range(n_iters):
            T_new, pts_new, cost_here = gn_step(T, pts, inlier, use_huber)
            live = ~done
            taken = taken + live.to(torch.int32)
            better = live & (cost_here < best_cost)
            best_T = torch.where(better, T, best_T)
            best_pts = torch.where(better, pts, best_pts)
            best_cost = torch.where(better, cost_here, best_cost)
            done = done | (cost_here > (1.0 - cfg.local_ba_min_rel_decrease) * prev_cost)
            T = torch.where(live, T_new, T)
            pts = torch.where(live, pts_new, pts)
            prev_cost = torch.where(live, cost_here, prev_cost)
        return T, pts, (best_T, best_pts, best_cost), taken

    def eval_state(T, pts, inlier, use_huber: bool):
        e, behind = _residuals(T, pts, prob, cam)
        chi = torch.sum(e * e * comp_w, dim=-1) * prob.inv_sigma2
        cost = torch.sum(_huber_cost(chi, delta, use_huber) * inlier * (~behind))
        return cost, chi, behind

    def finish_phase(T_last, pts_last, best, inlier, use_huber: bool):
        """The last state if it beats the best one seen, else the best:
        both evaluated, then selected (JAX's `where` and `cond`)."""
        best_T, best_pts, best_cost = best
        cost_l, chi_l, behind_l = eval_state(T_last, pts_last, inlier, use_huber)
        _, chi_b, behind_b = eval_state(best_T, best_pts, inlier, use_huber)
        use_last = cost_l < best_cost
        return (torch.where(use_last, T_last, best_T), torch.where(use_last, pts_last, best_pts),
                torch.where(use_last, chi_l, chi_b), torch.where(use_last, behind_l, behind_b))

    inlier = obs_valid.to(f32)
    T_last, pts_last, best, taken_1 = phase(prob.T_cw, prob.points, inlier, True,
                                            cfg.local_ba_iters_initial)
    T_cw, points, chi, behind = finish_phase(T_last, pts_last, best, inlier, True)
    inlier = (obs_valid & (chi < chi2_th) & (~behind)).to(f32)
    T_last, pts_last, best, taken_2 = phase(T_cw, points, inlier, False,
                                            cfg.local_ba_iters_refine)
    T_cw, points, chi, behind = finish_phase(T_last, pts_last, best, inlier, False)
    final_inlier = obs_valid & (chi < chi2_th) & (~behind)
    return BAResult(T_cw, points, final_inlier, chi, torch.stack([taken_1, taken_2]))
