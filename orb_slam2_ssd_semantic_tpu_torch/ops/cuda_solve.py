"""Small dense SPD solve: the CUDA kernel `csrc/spd_solve.cu` and its
plain PyTorch versions.

Counterpart of the JAX package's `ops/pallas_solve.py::spd_solve` (the
Pallas TPU kernel it replaces, a pivot-free Gauss-Jordan elimination):
the damped SPD reduced camera system of local BA, n <= 128.

On the card this is bound by latency, not by bytes or operations: a
chain of n dependent pivots on one SM. The kernel is a pivot-free
Cholesky factorisation in panels of 8 columns with the matrix's lower
triangle packed in shared memory: each row's thread factors a panel's
8 x 8 diagonal block itself, in registers, with its own row and the
right-hand side riding along, so a panel costs two barriers and the
forward substitution no pass of its own; the back substitution goes by panels
too. The kernel reads A through its row stride and lays the system out
itself, so the wrapper launches nothing but the kernel. See the kernel
source for the details.

`spd_solve` dispatches on the tensors' device: CPU tensors take
`spd_solve_reference`, CUDA tensors launch the kernel (or raise).
`spd_solve.launches` counts kernel launches, a launch into a CUDA graph
being captured once (see `cuda_build.captured`), a replay never.
`spd_solve_cholesky_reference` is the kernel's algorithm step for step in
PyTorch, for tests of its arithmetic where no card is.
"""

from __future__ import annotations

import torch

from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_build

PAD = 128
PANEL = 8  # columns of a panel in `csrc/spd_solve.cu` (kNb)


def _check(A: torch.Tensor, b: torch.Tensor) -> int:
    n = A.shape[0]
    if A.shape != (n, n) or b.shape != (n,) or not 1 <= n <= PAD:
        raise ValueError(f"spd_solve: need A (n, n), b (n,), 1 <= n <= {PAD}; got "
                         f"{tuple(A.shape)}, {tuple(b.shape)}")
    return n


def _pad(A: torch.Tensor, b: torch.Tensor):
    n = _check(A, b)
    a_pad = torch.zeros((PAD, PAD), dtype=torch.float32, device=A.device)
    a_pad[:n, :n] = A.to(torch.float32)
    idx = torch.arange(n, PAD, device=A.device)
    a_pad[idx, idx] = 1.0
    b_pad = torch.zeros((PAD,), dtype=torch.float32, device=A.device)
    b_pad[:n] = b.to(torch.float32)
    return a_pad, b_pad


def spd_solve_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the system padded to 128 with identity, as
    the TPU kernel takes it, through torch.linalg.solve."""
    a_pad, b_pad = _pad(A, b)
    return torch.linalg.solve(a_pad, b_pad)[: A.shape[0]]


def spd_solve_cholesky_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's algorithm in float32 PyTorch, column by column.

    Right-looking Cholesky A = L L^T over the lower triangle in panels of
    `PANEL` columns: a panel's columns are eliminated inside the panel
    (diagonal block, the rows below it and the right-hand side together,
    which yields y = L^-1 b), then the trailing triangle takes the
    panel's rank-8 update. A partial last panel is completed with
    identity. L^T x = y is then solved by panels from the last to the
    first. No pivoting and no clamp: a non-positive pivot gives NaN."""
    n = _check(A, b)
    m = torch.tril(A.to(torch.float32)).clone()
    rhs = b.to(torch.float32).clone()
    inv_diag = torch.ones((n,), dtype=torch.float32, device=A.device)
    y = torch.zeros_like(rhs)
    for k0 in range(0, n, PANEL):
        k1 = min(k0 + PANEL, n)
        for k in range(k0, k1):
            inv = torch.rsqrt(m[k, k])
            inv_diag[k] = inv
            m[k:, k] = m[k:, k] * inv  # the diagonal becomes L[k][k]
            y[k] = rhs[k] * inv
            col = m[k + 1:, k]
            # Inside the panel only its own columns are updated ...
            m[k + 1:, k + 1:k1] -= torch.tril(col[:, None] * col[None, :k1 - k - 1])
            rhs[k + 1:] -= col * y[k]
        # ... and the trailing triangle takes the whole panel at once.
        low = m[k1:, k0:k1]
        m[k1:, k1:] -= torch.tril(low @ low.T)
    x = torch.zeros_like(rhs)
    for k0 in range((n - 1) // PANEL * PANEL, -1, -PANEL):
        k1 = min(k0 + PANEL, n)
        for k in range(k1 - 1, k0 - 1, -1):
            x[k] = (y[k] - (m[k + 1:k1, k] * x[k + 1:k1]).sum()) * inv_diag[k]
        y[:k0] -= m[k0:k1, :k0].T @ x[k0:k1]
    return x


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A (n, n) float32, b (n,), n <= 128."""
    if A.device.type == "cpu":
        return spd_solve_reference(A, b)
    prepared, x = prepare(A, b)
    launch(prepared)
    return x


def prepare(A: torch.Tensor, b: torch.Tensor):
    """Check `spd_solve`'s CUDA arguments and allocate the solution.
    Returns the prepared launch and x (n,), which `launch` writes. A is
    taken through its row stride; only a view whose columns are strided
    (a transpose) is copied first."""
    if A.device.type != "cuda" or b.device != A.device:
        raise ValueError(f"spd_solve: unsupported devices {A.device}, {b.device}")
    n = _check(A, b)
    A = A.to(torch.float32)
    if A.stride(1) != 1 or A.stride(0) < n:
        A = A.contiguous()
    b = b.to(torch.float32).contiguous()
    x = torch.empty((n,), dtype=torch.float32, device=A.device)
    args = (A.data_ptr(), A.stride(0), b.data_ptr(), n, x.data_ptr(),
            torch.cuda.current_stream(A.device).cuda_stream)
    return cuda_build.Prepared("spd_solve", args, (A, b, x)), x


def launch(prepared: cuda_build.Prepared) -> None:
    """Launch the kernel as `prepare` set it up; counts the launch."""
    cuda_build.launch(prepared)
    spd_solve.launches += 1


spd_solve.launches = 0
