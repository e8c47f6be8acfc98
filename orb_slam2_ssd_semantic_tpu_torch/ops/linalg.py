"""Small fixed-size linear algebra (counterpart of the JAX package's
`ops/linalg.py`): an unrolled Cholesky solve for the 6x6 pose systems,
closed-form 3x3 inverses, and a Jacobi-preconditioned CG for one
mid-size SPD system."""

from __future__ import annotations

import torch

from orb_slam2_ssd_semantic_tpu_torch.utils import precision


def cholesky_solve_small(H: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Solve H x = b for SPD H of small static size n (unrolled, with the
    pivot clamped at `eps` like the JAX version). H: (..., n, n),
    b: (..., n) -> (..., n)."""
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=eps))
            else:
                L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


@precision.scoped
def pcg_solve(A: torch.Tensor, b: torch.Tensor, iters: int = 32) -> torch.Tensor:
    """Jacobi-preconditioned conjugate gradients for one SPD system
    A (n, n), b (n,), a fixed `iters` steps with no host sync. The matvecs
    run in true f32 (no TF32): on the cancellation-heavy normal systems a
    reduced-precision product exceeds their weak eigenvalues. Where the
    curvature p'Ap is not positive the step is 0 (x stays, the recurrences
    stay finite)."""
    dinv = 1.0 / torch.clamp(torch.abs(torch.diagonal(A)), min=1e-12)
    x = torch.zeros_like(b)
    r = b
    p = dinv * r
    rz = r @ p
    zero = torch.zeros_like(rz)
    for _ in range(iters):
        Ap = A @ p
        curv = p @ Ap
        ok = curv > 1e-12 * torch.clamp(p @ p, min=1e-20)
        alpha = torch.where(ok, rz / torch.clamp(curv, min=1e-20), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_new = r @ z
        p = z + (rz_new / torch.clamp(rz, min=1e-20)) * p
        rz = rz_new
    return x


def _adjugate(a, b, c, d, e, f, g, h, i, eps):
    co = [
        [e * i - f * h, c * h - b * i, b * f - c * e],
        [f * g - d * i, a * i - c * g, c * d - a * f],
        [d * h - e * g, b * g - a * h, a * e - b * d],
    ]
    det = a * co[0][0] + b * co[1][0] + c * co[2][0]
    tiny = torch.where(det < 0, torch.full_like(det, -eps), torch.full_like(det, eps))
    det = torch.where(torch.abs(det) < eps, tiny, det)
    return co, det


def inv3x3_cols(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Closed-form 3x3 inverse, batch-LAST layout (3, 3, N) -> (3, 3, N)."""
    co, det = _adjugate(A[0, 0], A[0, 1], A[0, 2], A[1, 0], A[1, 1], A[1, 2],
                        A[2, 0], A[2, 1], A[2, 2], eps)
    inv = torch.stack([torch.stack(r, dim=0) for r in co], dim=0)
    return inv / det[None, None]


def inv3x3(A: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (..., 3, 3) via the adjugate."""
    co, det = _adjugate(A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
                        A[..., 1, 0], A[..., 1, 1], A[..., 1, 2],
                        A[..., 2, 0], A[..., 2, 1], A[..., 2, 2], eps)
    inv = torch.stack([torch.stack(r, dim=-1) for r in co], dim=-2)
    return inv / det[..., None, None]
