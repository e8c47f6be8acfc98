"""Pose-graph optimization over keyframe poses (counterpart of the JAX
package's `mapping/pose_graph.py`, its SE(3) half).

Equivalent of Optimizer::OptimizeEssentialGraph (perfect/src/
Optimizer.cc:995-1308) for RGB-D, where the scale is fixed: after a loop
closure, distribute the loop correction over the keyframe graph by
minimizing relative-pose residuals on spanning-chain, strong-covisibility
and loop edges with batched Gauss-Newton. Two solvers:

- `optimize_pose_graph`: the dense (6F, 6F) normal system, LU-solved
  (`torch.linalg.solve_ex`), for F <= 1024 keyframes (3072^2 at the
  default 512);
- `optimize_pose_graph_pcg`: matrix-free preconditioned CG whose
  preconditioner is the block-tridiagonal Hessian of the spanning chain,
  solved by parallel cyclic reduction (6x6 inverses by `inv_ex`).

Both run 20 Gauss-Newton steps as a host loop that never reads the
device: the monotonicity guard is a `torch.where`, and a non-finite
solve is zeroed, not raised. Every contraction runs in true f32
(`precision.scoped`), as the JAX module's HIGHEST einsums.

Edges are padded fixed-capacity arrays (`build_graph_arrays`, host
numpy).

`optimize_pose_graph_sim3` is the monocular form over Sim(3) vertices,
which also absorbs scale drift: Jacobians by forward-mode autodiff of
the edge residual, a dense (7F, 7F) solve a step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.utils import precision


@dataclasses.dataclass
class PoseGraph:
    edge_i: torch.Tensor  # (E,) int64
    edge_j: torch.Tensor  # (E,) int64
    T_ji: torch.Tensor  # (E, 4, 4) measured T_j_cw @ inv(T_i_cw)
    weight: torch.Tensor  # (E,) float32 (covis weight / loop boost)
    valid: torch.Tensor  # (E,) bool


def _adjoint(T: torch.Tensor) -> torch.Tensor:
    """(E, 4, 4) -> (E, 6, 6) adjoint [[R, hat(t) R], [0, R]]."""
    R = T[:, :3, :3]
    t = T[:, :3, 3]
    top = torch.cat([R, se3.hat(t) @ R], dim=2)
    bot = torch.cat([torch.zeros_like(R), R], dim=2)
    return torch.cat([top, bot], dim=1)


def _setup(T_cw, kf_valid, graph, fixed):
    F = T_cw.shape[0]
    if fixed is None:
        fixed = torch.arange(F, device=T_cw.device) == 0
    free = (~fixed) & kf_valid
    ei = graph.edge_i.clamp(0, F - 1)
    ej = graph.edge_j.clamp(0, F - 1)
    w = torch.where(graph.valid & kf_valid[ei] & kf_valid[ej], graph.weight,
                    torch.zeros_like(graph.weight))
    return F, free, ei, ej, w


def _edge_residuals(T, graph: PoseGraph, ei, ej):
    """(M = T_ji_meas @ T_i @ inv(T_j), r = log(M)) per edge."""
    M = graph.T_ji @ T[ei] @ se3.se3_inverse(T[ej])
    return M, se3.se3_log(M)


def _edge_cost(T, graph, ei, ej, w):
    _, r = _edge_residuals(T, graph, ei, ej)
    return torch.sum(w[:, None] * r * r)


def _gradient(F, ei, ej, J_i, J_j, Wr):
    g = torch.zeros((F, 6), dtype=Wr.dtype, device=Wr.device)
    g.index_add_(0, ei, torch.einsum("eab,ea->eb", J_i, Wr))
    g.index_add_(0, ej, torch.einsum("eab,ea->eb", J_j, Wr))
    return g


@precision.scoped
def optimize_pose_graph(T_cw: torch.Tensor, kf_valid: torch.Tensor, graph: PoseGraph,
                        fixed: torch.Tensor | None = None, iters: int = 20) -> torch.Tensor:
    """Minimize sum_e w_e || log(T_ji_meas @ T_i @ inv(T_j)) ||^2 over
    T_cw (F, 4, 4) with a dense (6F, 6F) Gauss-Newton solve per step;
    `fixed` (F,) bool is the gauge (default: keyframe 0)."""
    F, free, ei, ej, w = _setup(T_cw, kf_valid, graph, fixed)
    free_f = free.to(torch.float32)
    diag_fix = (~free).to(torch.float32).repeat_interleave(6)
    # Small-residual Jacobians of left perturbations: J_i ~ Ad(T_ji_meas)
    # (constant), J_j ~ -Ad(M) (standard pose-graph GN; exact at r = 0).
    J_i = _adjoint(graph.T_ji)
    T = T_cw
    for _ in range(iters):
        M, r = _edge_residuals(T, graph, ei, ej)
        J_j = -_adjoint(M)
        Wr = w[:, None] * r
        g = _gradient(F, ei, ej, J_i, J_j, Wr)
        Hii = torch.einsum("eab,e,eac->ebc", J_i, w, J_i)
        Hjj = torch.einsum("eab,e,eac->ebc", J_j, w, J_j)
        Hij = torch.einsum("eab,e,eac->ebc", J_i, w, J_j)
        # Repeated (i, j) pairs accumulate.
        H = torch.zeros((F, F, 6, 6), dtype=T.dtype, device=T.device)
        H.index_put_((torch.cat([ei, ej, ei, ej]), torch.cat([ei, ej, ej, ei])),
                     torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]), accumulate=True)
        H = H * free_f[:, None, None, None] * free_f[None, :, None, None]
        g = g * free_f[:, None]
        Hm = H.permute(0, 2, 1, 3).reshape(6 * F, 6 * F)
        # Relative (Levenberg-style) damping: the absolute 1e-5 floor is
        # nothing against edge weights of 100-500.
        Hm = Hm + torch.diag(1e-3 * torch.abs(torch.diagonal(Hm)) + diag_fix + 1e-5)
        dx = torch.linalg.solve_ex(Hm, -g.reshape(-1))[0].reshape(F, 6)
        dx = dx * free_f[:, None]
        dx = torch.clamp(torch.where(torch.isfinite(dx), dx, torch.zeros_like(dx)), -1.0, 1.0)
        T_new = se3.se3_exp(dx) @ T
        # Monotonicity guard (see mapping/ba.py): reject cost increases.
        ok = _edge_cost(T_new, graph, ei, ej, w) < torch.sum(w[:, None] * r * r)
        T = torch.where(ok, T_new, T)
    return T


def _shift_down(x: torch.Tensor, s: int) -> torch.Tensor:
    """out[k] = x[k - s], zero-filled."""
    if s >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([torch.zeros_like(x[:s]), x[: x.shape[0] - s]], dim=0)


def _shift_up(x: torch.Tensor, s: int) -> torch.Tensor:
    """out[k] = x[k + s], zero-filled."""
    if s >= x.shape[0]:
        return torch.zeros_like(x)
    return torch.cat([x[s:], torch.zeros_like(x[:s])], dim=0)


def _pcr_factor(D, L, U, n_levels: int):
    """Parallel cyclic reduction of the block-tridiagonal (D, L, U): after
    log2(F) levels every equation decouples; per level the (alpha, beta)
    that make the solve two block matvecs, and the final inverse
    diagonal."""
    alphas, betas = [], []
    for lev in range(n_levels):
        s = 1 << lev
        Dinv = torch.linalg.inv_ex(D)[0]
        alpha = -(L @ _shift_down(Dinv, s))
        beta = -(U @ _shift_up(Dinv, s))
        D = D + alpha @ _shift_down(U, s) + beta @ _shift_up(L, s)
        L, U = alpha @ _shift_down(L, s), beta @ _shift_up(U, s)
        alphas.append(alpha)
        betas.append(beta)
    return alphas, betas, torch.linalg.inv_ex(D)[0]


@precision.scoped
def optimize_pose_graph_pcg(T_cw: torch.Tensor, kf_valid: torch.Tensor, graph: PoseGraph,
                            fixed: torch.Tensor | None = None, iters: int = 20,
                            cg_iters: int = 50,
                            chain_perm: torch.Tensor | None = None) -> torch.Tensor:
    """Matrix-free essential-graph Gauss-Newton for large graphs: CG
    applies H through edge-wise gathers and Jacobian products (O(E) work
    and memory). Its preconditioner is the exact block-tridiagonal Hessian
    restricted to the spanning chain, solved by parallel cyclic
    reduction, which carries a loop correction along the whole chain in
    one application. `chain_perm` (F,) lists the slots in chain (uid)
    order; default arange(F). Same residuals, Jacobians and gauge as
    `optimize_pose_graph`."""
    F, free, ei, ej, w = _setup(T_cw, kf_valid, graph, fixed)
    dev = T_cw.device
    if chain_perm is None:
        chain_perm = torch.arange(F, device=dev)
    chain_perm = chain_perm.to(torch.int64)
    free_f = free.to(torch.float32)
    pos = torch.argsort(chain_perm)  # rank along the chain of each slot
    n_levels = max(1, int(np.ceil(np.log2(F)))) if F > 1 else 1
    eye6 = torch.eye(6, dtype=T_cw.dtype, device=dev)
    J_i = _adjoint(graph.T_ji)  # constant per edge

    fc = free_f[chain_perm]  # free mask in chain order
    up_pair = fc * torch.cat([fc[1:], fc.new_zeros(1)])
    pi, pj = pos[ei], pos[ej]
    up_idx = torch.where(pj == pi + 1, pi, torch.full_like(pi, F))  # i precedes j
    dn_idx = torch.where(pi == pj + 1, pj, torch.full_like(pj, F))  # j precedes i

    T = T_cw
    for _ in range(iters):
        M, r = _edge_residuals(T, graph, ei, ej)
        J_j = -_adjoint(M)
        g = _gradient(F, ei, ej, J_i, J_j, w[:, None] * r) * free_f[:, None]

        def hv(x):  # x (F, 6) -> H @ x, gauge rows/cols masked
            xm = x * free_f[:, None]
            y = w[:, None] * (torch.einsum("eab,eb->ea", J_i, xm[ei])
                              + torch.einsum("eab,eb->ea", J_j, xm[ej]))
            return _gradient(F, ei, ej, J_i, J_j, y) * free_f[:, None] + 1e-5 * xm

        # Chain preconditioner: diagonal blocks from ALL edges (so the
        # tridiagonal factor is SPD), chain-adjacent couplings above and
        # below the diagonal; off-chain couplings are left to CG.
        diag = torch.zeros((F, 6, 6), dtype=T.dtype, device=dev)
        diag.index_add_(0, ei, torch.einsum("eab,e,eac->ebc", J_i, w, J_i))
        diag.index_add_(0, ej, torch.einsum("eab,e,eac->ebc", J_j, w, J_j))
        diag = diag + 1e-5 * eye6
        Hij = torch.einsum("eab,e,eac->ebc", J_i, w, J_j)
        # Off-chain edges land in the dropped row F.
        Uc = torch.zeros((F + 1, 6, 6), dtype=T.dtype, device=dev).index_add_(
            0, torch.cat([up_idx, dn_idx]), torch.cat([Hij, Hij.transpose(-1, -2)]))[:F]
        # Gauge/invalid rows: identity diagonal, severed couplings.
        Dc = diag[chain_perm] * fc[:, None, None] + (1.0 - fc)[:, None, None] * eye6
        Uc = Uc * up_pair[:, None, None]
        Lc = _shift_down(Uc.transpose(-1, -2), 1)  # L[k] = Uc[k-1]^T
        p_alpha, p_beta, p_dinv = _pcr_factor(Dc, Lc, Uc, n_levels)

        def prec(x):
            bb = x[chain_perm] * fc[:, None]
            for lev in range(n_levels):
                s = 1 << lev
                bb = (bb + (p_alpha[lev] @ _shift_down(bb, s)[..., None])[..., 0]
                      + (p_beta[lev] @ _shift_up(bb, s)[..., None])[..., 0])
            z = (p_dinv @ bb[..., None])[..., 0] * fc[:, None]
            return z[pos] * free_f[:, None]  # back to slot order

        # PCG on H dx = -g.
        rr = -g
        x = torch.zeros_like(g)
        p = prec(rr)
        rz = torch.sum(rr * p)
        for _ in range(cg_iters):
            Hp = hv(p)
            denom = torch.sum(p * Hp)
            alpha = torch.where(denom > 1e-12, rz / denom, torch.zeros_like(rz))
            x = x + alpha * p
            rr = rr - alpha * Hp
            z = prec(rr)
            rz_new = torch.sum(rr * z)
            beta = torch.where(rz > 1e-12, rz_new / rz, torch.zeros_like(rz))
            p = z + beta * p
            rz = rz_new
        dx = torch.clamp(x * free_f[:, None], -1.0, 1.0)
        T_new = se3.se3_exp(dx) @ T
        # Monotonicity guard: one overshooting inexact-CG step must not
        # explode the chain.
        ok = _edge_cost(T_new, graph, ei, ej, w) < _edge_cost(T, graph, ei, ej, w)
        T = torch.where(ok, T_new, T)
    return T


@dataclasses.dataclass
class Sim3Graph:
    """Sim(3) pose-graph edges: the measured similarity j <- i is
    (s_ji, T_ji[:3, :3], T_ji[:3, 3])."""

    edge_i: torch.Tensor  # (E,) int64
    edge_j: torch.Tensor  # (E,) int64
    s_ji: torch.Tensor  # (E,) float32 measured relative scale
    T_ji: torch.Tensor  # (E, 4, 4) measured rotation | translation
    weight: torch.Tensor  # (E,) float32
    valid: torch.Tensor  # (E,) bool


@precision.scoped
def optimize_pose_graph_sim3(T_cw: torch.Tensor, log_s: torch.Tensor, kf_valid: torch.Tensor,
                             graph: Sim3Graph, fixed: torch.Tensor | None = None,
                             iters: int = 20):
    """7-DoF essential-graph optimization, the monocular form of
    Optimizer::OptimizeEssentialGraph (perfect/src/Optimizer.cc:995-1308),
    where loop closure must also absorb accumulated scale drift
    (g2o::VertexSim3Expmap vertices). Minimizes
    sum_e w_e || sim3_log(S_ji * S_i * S_j^-1) ||^2 over the vertices
    S_i = (exp(log_s_i), R_i, t_i); `fixed` (F,) bool is the gauge
    (default: keyframe 0).

    Each step takes the edge Jacobians of left-multiplicative sim3
    perturbations by `torch.func.jacfwd` (one perturbation shared by every
    edge: each edge's residual depends on its own copy alone), scatters the
    normal equations with `index_add_`, and solves the damped dense
    (7F, 7F) system by LU (`solve_ex`, no host sync), as JAX does with
    `jnp.linalg.solve`.

    Returns (T_cw_opt (F, 4, 4), log_s_opt (F,)). Map points must be
    corrected with the full similarity: p' = S'_ref^-1 (S_ref p)."""
    D = 7
    dev, f32 = T_cw.device, T_cw.dtype
    F, free, ei, ej, w = _setup(T_cw, kf_valid, graph, fixed)
    free_f = free.to(f32)
    diag_fix = (~free).to(f32).repeat_interleave(D)
    s_m, R_m, t_m = graph.s_ji, graph.T_ji[:, :3, :3], graph.T_ji[:, :3, 3]
    zero = torch.zeros((2 * D,), dtype=f32, device=dev)
    # Flat (i, j) block index of each term of the normal matrix.
    k_ii, k_jj, k_ij, k_ji = ei * F + ei, ej * F + ej, ei * F + ej, ej * F + ei

    def residual(xi, si, Ri, ti, sj, Rj, tj):
        # A leading dim of 1 keeps the perturbation's scalars 1-d under
        # forward AD (sim3_opt.py).
        dsi, dRi, dti = se3.sim3_exp(xi[None, :D])
        dsj, dRj, dtj = se3.sim3_exp(xi[None, D:])
        si_, Ri_, ti_ = se3.sim3_compose(dsi, dRi, dti, si, Ri, ti)
        sj_, Rj_, tj_ = se3.sim3_compose(dsj, dRj, dtj, sj, Rj, tj)
        s1, R1, t1 = se3.sim3_compose(si_, Ri_, ti_, *se3.sim3_inverse(sj_, Rj_, tj_))
        r = se3.sim3_log(*se3.sim3_compose(s_m, R_m, t_m, s1, R1, t1))
        return r, r

    T, ls = T_cw, log_s
    for _ in range(iters):
        s_all, R_all, t_all = torch.exp(ls), T[:, :3, :3], T[:, :3, 3]
        J, r = torch.func.jacfwd(residual, has_aux=True)(
            zero, s_all[ei], R_all[ei], t_all[ei], s_all[ej], R_all[ej], t_all[ej])
        J_i, J_j = J[..., :D], J[..., D:]  # (E, 7, 7) each
        Wr = w[:, None] * r
        g = torch.zeros((F, D), dtype=f32, device=dev)
        g.index_add_(0, ei, torch.einsum("eab,ea->eb", J_i, Wr))
        g.index_add_(0, ej, torch.einsum("eab,ea->eb", J_j, Wr))
        Hij = torch.einsum("eab,e,eac->ebc", J_i, w, J_j)
        H = torch.zeros((F * F, D, D), dtype=f32, device=dev)
        H.index_add_(0, k_ii, torch.einsum("eab,e,eac->ebc", J_i, w, J_i))
        H.index_add_(0, k_jj, torch.einsum("eab,e,eac->ebc", J_j, w, J_j))
        H.index_add_(0, k_ij, Hij)
        H.index_add_(0, k_ji, Hij.transpose(-1, -2))
        H = H.reshape(F, F, D, D) * free_f[:, None, None, None] * free_f[None, :, None, None]
        g = g * free_f[:, None]
        Hm = H.permute(0, 2, 1, 3).reshape(D * F, D * F) + torch.diag(diag_fix + 1e-5)
        dx = torch.linalg.solve_ex(Hm, -g.reshape(-1))[0].reshape(F, D) * free_f[:, None]
        ds, dR, dt = se3.sim3_exp(dx)
        T = T.clone()
        T[:, :3, :3] = dR @ R_all
        T[:, :3, 3] = ds[:, None] * torch.einsum("fij,fj->fi", dR, t_all) + dt
        ls = ls + dx[:, 6]
    return T, ls


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def build_graph_arrays(covis, kf_valid, threshold: int, max_edges: int, T_cw,
                       extra_edges=None, uid=None, device=None) -> PoseGraph:
    """Host-side edge assembly from a covisibility matrix: the spanning
    chain (keyframes consecutive in insertion order: slots are reused, so
    the chain follows uids), strong covisibility edges (weight >=
    `threshold`, row-major over i < j, skipping chain pairs), then the
    explicit `extra_edges` [(i, j, weight, T_ji)] (loop edges, which carry
    their own measured transform). Normal edges measure the current
    relative poses. Returns a PoseGraph padded to `max_edges` on `device`
    (default: T_cw's)."""
    if device is None:
        device = T_cw.device if torch.is_tensor(T_cw) else torch.device("cpu")
    W = _numpy(covis)
    v = _numpy(kf_valid)
    T = _numpy(T_cw)
    F = len(v)
    if uid is None:
        order = [i for i in range(F) if v[i]]
    else:
        u = _numpy(uid)
        order = sorted((i for i in range(F) if v[i] and u[i] >= 0), key=lambda i: u[i])
    edges = []
    chain = np.zeros((F, F), bool)
    for a, b in zip(order[:-1], order[1:]):
        edges.append((a, b, max(W[a, b], 1.0)))
        chain[min(a, b), max(a, b)] = True
    # Emitting a chain pair again would double-weight the odometry.
    strong = np.triu((W >= threshold) & v[:, None] & v[None, :], 1) & ~chain
    edges.extend((i, j, W[i, j]) for i, j in zip(*np.nonzero(strong)))
    edges = [(i, j, wt, T[j] @ np.linalg.inv(T[i])) for (i, j, wt) in edges]
    if extra_edges:
        edges.extend(extra_edges)
    edges = edges[:max_edges]
    E = max_edges
    ei = np.zeros(E, np.int64)
    ej = np.zeros(E, np.int64)
    Tji = np.tile(np.eye(4, dtype=np.float32), (E, 1, 1))
    wts = np.zeros(E, np.float32)
    val = np.zeros(E, bool)
    for k, (i, j, wt, Tm) in enumerate(edges):
        ei[k], ej[k], wts[k], val[k] = i, j, wt, True
        Tji[k] = np.asarray(Tm, np.float32)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return PoseGraph(dev(ei), dev(ej), dev(Tji), dev(wts), dev(val))
