"""Kernel rooflines: the chip's published peaks, the least time of an
operation from its call shapes, and the least time of its traced calls.

The work is the operation's, counted from the shapes its wrapper was
called with (each input byte read once, each output byte written once),
so whatever implements it later is held to the same work. The card's
trace does not say which shape a launch inside a CUDA graph ran (its
kernel events carry no grid), so each traced call is counted at the
least work of the shapes recorded: the share is a lower bound.
"""

from __future__ import annotations

import contextlib
import math

# One NVIDIA H100 SXM (data sheet, at 700 W): HBM bandwidth, and float32
# and int32 operations outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12


def bound_s(n_bytes: float, n_ops: float):
    """(least seconds, "bytes" or "operations": whichever sets it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / CUDA_CORE_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def window_match_work(q: int, t: int):
    """B1 (windowed Hamming match) on Q queries and T targets: bytes of
    descriptors, centres, radius and validity in, best/second/index per
    query and a claim key per target out; operations, the window and
    validity test and top-2 update of every pair (~8). The popcounts of
    the pairs inside a window depend on the data and are not counted, so
    the bound is a lower one."""
    n_bytes = q * (32 + 8 + 4 + 1) + t * (32 + 8 + 1) + q * 12 + t * 4
    return n_bytes, 8.0 * q * t


def sym_eig_work(batch: int, n: int):
    """`sym_eig` on a batch of symmetric n x n matrices: the matrices in,
    eigenvalues and vectors out; 9 n^3 flops a matrix (symmetric QR with
    vectors, Golub and Van Loan)."""
    return 4.0 * batch * (2 * n * n + n), 9.0 * n**3 * batch


class ShapeRecorder:
    """Records the shapes the port's wrappers of B1 and `sym_eig` are
    called with (their `prepare`), while `recording()` is open: calls
    made while a CUDA graph is captured are the shapes its replays run."""

    def __init__(self):
        self.shapes = {"window_match": set(), "sym_eig": set()}

    @contextlib.contextmanager
    def recording(self):
        from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_eigh, cuda_match

        orig_b1, orig_eig = cuda_match.prepare, cuda_eigh.prepare

        def b1(desc_q, desc_t, *a, **k):
            self.shapes["window_match"].add((int(desc_q.shape[0]), int(desc_t.shape[0])))
            return orig_b1(desc_q, desc_t, *a, **k)

        def eig(M):
            self.shapes["sym_eig"].add((math.prod(M.shape[:-2]), int(M.shape[-1])))
            return orig_eig(M)

        cuda_match.prepare, cuda_eigh.prepare = b1, eig
        try:
            yield self
        finally:
            cuda_match.prepare, cuda_eigh.prepare = orig_b1, orig_eig


def least_time(calls: int, shapes, work) -> dict | None:
    """The least time of `calls` traced calls of an operation, each
    counted at the least work among the call `shapes` recorded
    (`work(shape)` -> (bytes, operations)). None when nothing was called
    or no shape was recorded."""
    if not calls or not shapes:
        return None
    t, by = min(bound_s(*work(s)) for s in shapes)
    return {"least_s": calls * t, "calls": calls, "bound_by": by}
