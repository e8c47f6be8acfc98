"""Batched eigendecomposition of small symmetric matrices: the CUDA kernel
`csrc/sym_eig.cu` and its plain PyTorch versions.

The port's own kernel, with no Pallas counterpart: the JAX package takes
the homography DLT's null vector from `jnp.linalg.eigh`
(`ops/homography.py:34` there), which XLA keeps on the device.
`torch.linalg.eigh` on the card checks its result on the host after every
call, a wait that also keeps the flow mask out of a CUDA graph; the
kernel (cyclic Jacobi in registers, a matrix's columns and those of its
eigenvectors in lanes of one warp, exchanged by shuffles; see its source)
reads nothing on the host and allocates nothing.

`eigh_small(M)` takes M (..., n, n) float32, contiguous, 1 <= n <= 16,
and returns (eigenvalues (..., n) ascending, eigenvectors (..., n, n) as
columns), `torch.linalg.eigh`'s layout, from M's lower triangle. It
checks its argument on every device, then dispatches on the device: CPU
tensors take `eigh_small_reference` (`torch.linalg.eigh`, so the CPU
results are those of the library call), CUDA tensors launch the kernel
(or raise). `eigh_small.launches` counts kernel launches, a launch into a
CUDA graph being captured once (`cuda_build.captured`), a replay never.
`eigh_jacobi_reference` is the kernel's algorithm step for step in
PyTorch, for tests of its arithmetic where no card is.
"""

from __future__ import annotations

import math

import torch

from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_build

MAX_N = 16
MAX_SWEEPS = 16  # `kMaxSweeps` in `csrc/sym_eig.cu`
TOL = 1e-16  # `kTol`: squared off-diagonal norm over squared norm at the stop
TINY = 2.0**-64  # `kTiny`: a pair whose scaled |a_pq| is no larger is not rotated


def _check(M: torch.Tensor) -> int:
    if M.dtype != torch.float32:
        raise ValueError(f"eigh_small: need float32, got {M.dtype}")
    if M.dim() < 2 or M.shape[-1] != M.shape[-2] or not 1 <= M.shape[-1] <= MAX_N:
        raise ValueError(f"eigh_small: need (..., n, n) with 1 <= n <= {MAX_N}, got "
                         f"{tuple(M.shape)}")
    if not M.is_contiguous():
        raise ValueError("eigh_small: need a contiguous tensor")
    return M.shape[-1]


def eigh_small_reference(M: torch.Tensor):
    """Plain PyTorch version: `torch.linalg.eigh` (lower triangle)."""
    return torch.linalg.eigh(M)


def _round_pairs(m: int, r: int):
    """The m / 2 disjoint pairs (p < q) of round r of the circle method."""
    pairs = []
    for k in range(m // 2):
        a, b = (r, m - 1) if k == 0 else ((r + k) % (m - 1), (r - k + m - 1) % (m - 1))
        pairs.append((min(a, b), max(a, b)))
    return pairs


def _times_pow2(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """x * 2^e for integer exponents e (float32), in two exact factors so
    that none overflows (|e| <= 149)."""
    e = e.to(torch.float32)
    half = torch.trunc(e / 2)
    return x * torch.exp2(half) * torch.exp2(e - half)


def eigh_jacobi_reference(M: torch.Tensor):
    """The kernel's algorithm in float32 PyTorch, batched over the leading
    dims: the lower triangle mirrored and scaled by the power of two that
    puts its largest magnitude in [0.5, 1) (exact); sweeps of the circle
    method's rounds, each round's rotations (d = a_qq - a_pp, h = 2 a_pq,
    u = rsqrt(d^2 + h^2), w = (1 + |d| u) / 2, c = sqrt(w), s = sign(d) h u
    / (2 c), t = s / c, each from the reciprocal root 1 / c = rsqrt(w);
    none where |a_pq| <= `TINY`) applied to the rows, then to the columns
    of A and V, then each rotated pair's 2 x 2 block set to its exact
    result; a matrix sweeps while its squared off-diagonal norm is not at
    most `TOL` of its squared norm (a stopped one is left as it is), at
    most `MAX_SWEEPS`; then the diagonal scaled back, sorted ascending (NaN
    last, ties by index) with V's columns."""
    n = _check(M)
    lead = M.shape[:-2]
    a = torch.tril(M.reshape(-1, n, n))
    a = a + torch.tril(a, -1).transpose(-1, -2)
    mx = a.abs().amax((-1, -2))
    e = torch.where((mx > 0) & torch.isfinite(mx), torch.frexp(mx).exponent,
                    torch.zeros_like(mx, dtype=torch.int32))
    a = _times_pow2(a, -e[:, None, None])
    v = torch.eye(n, dtype=torch.float32, device=M.device).expand_as(a).clone()
    m = n + (n & 1)
    off_diag = ~torch.eye(n, dtype=torch.bool, device=M.device)
    run = torch.ones(a.shape[0], dtype=torch.bool, device=M.device)
    for _ in range(MAX_SWEEPS):
        tot = (a * a).sum((-1, -2))
        off = (a * a * off_diag).sum((-1, -2))
        run = run & ~(off <= TOL * tot)  # (B,)
        if not bool(run.any()):
            break
        for r in range(m - 1):
            pairs = [(p, q) for p, q in _round_pairs(m, r) if q < n]
            if not pairs:
                continue
            p = torch.tensor([pq[0] for pq in pairs], device=M.device)
            q = torch.tensor([pq[1] for pq in pairs], device=M.device)
            app, aqq, apq = a[:, p, p], a[:, q, q], a[:, p, q]  # (B, k)
            rot = ~(apq.abs() <= TINY) & run[:, None]
            d, h = aqq - app, 2.0 * apq
            u = torch.rsqrt(d * d + h * h)
            w = 0.5 * (d.abs() * u) + 0.5
            rc = torch.rsqrt(w)  # 1 / c
            sp = 0.5 * (torch.where(d >= 0, h, -h) * u) * rc
            t = sp * rc
            c = torch.where(rot, w * rc, torch.ones_like(t))
            s = torch.where(rot, sp, torch.zeros_like(t))
            dpp, dqq = app - t * apq, aqq + t * apq
            x, y = a[:, p, :], a[:, q, :]  # rows
            a[:, p, :] = c[..., None] * x - s[..., None] * y
            a[:, q, :] = s[..., None] * x + c[..., None] * y
            for mat in (a, v):  # columns
                x, y = mat[:, :, p], mat[:, :, q]
                mat[:, :, p] = c[:, None, :] * x - s[:, None, :] * y
                mat[:, :, q] = s[:, None, :] * x + c[:, None, :] * y
            zero = torch.zeros_like(dpp)
            a[:, p, p] = torch.where(rot, dpp, a[:, p, p])
            a[:, q, q] = torch.where(rot, dqq, a[:, q, q])
            a[:, p, q] = torch.where(rot, zero, a[:, p, q])
            a[:, q, p] = torch.where(rot, zero, a[:, q, p])
    lam = _times_pow2(torch.diagonal(a, dim1=-2, dim2=-1), e[:, None])
    key = torch.where(torch.isnan(lam), torch.full_like(lam, math.inf), lam)
    order = torch.sort(key, dim=-1, stable=True).indices
    w = torch.gather(lam, -1, order)
    vecs = torch.gather(v, -1, order[:, None, :].expand_as(v))
    return w.reshape(lead + (n,)), vecs.reshape(lead + (n, n))


def eigh_small(M: torch.Tensor):
    """(eigenvalues (..., n) ascending, eigenvectors (..., n, n) as
    columns) of the symmetric float32 M (..., n, n), n <= 16, contiguous;
    its lower triangle is read."""
    _check(M)
    if M.device.type == "cpu":
        return eigh_small_reference(M)
    prepared, w, v = prepare(M)
    if prepared is not None:
        launch(prepared)
    return w, v


def prepare(M: torch.Tensor):
    """Check `eigh_small`'s CUDA argument and allocate the outputs. Returns
    the prepared launch (None for an empty batch) and the eigenvalues and
    eigenvectors, which `launch` writes."""
    if M.device.type != "cuda":
        raise ValueError(f"eigh_small: unsupported device {M.device}")
    n = _check(M)
    lead = M.shape[:-2]
    batch = math.prod(lead)
    w = torch.empty(lead + (n,), dtype=torch.float32, device=M.device)
    v = torch.empty(lead + (n, n), dtype=torch.float32, device=M.device)
    if batch == 0:
        return None, w, v
    args = (M.data_ptr(), batch, n, w.data_ptr(), v.data_ptr(),
            torch.cuda.current_stream(M.device).cuda_stream)
    return cuda_build.Prepared("sym_eig", args, (M, w, v)), w, v


def launch(prepared: cuda_build.Prepared) -> None:
    """Launch the kernel as `prepare` set it up; counts the launch."""
    cuda_build.launch(prepared)
    eigh_small.launches += 1


eigh_small.launches = 0
