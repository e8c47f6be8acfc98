"""Small dense SPD solve: the CUDA kernel `csrc/spd_solve.cu` and its
plain PyTorch version.

Counterpart of the JAX package's `ops/pallas_solve.py::spd_solve` (the
Pallas TPU kernel it replaces): a pivot-free Gauss-Jordan solve of the
damped SPD reduced camera system of local BA, n <= 128, padded to 128
with identity on the padded diagonal.

On the card this is bound by latency (n dependent elimination steps on
one SM); see the kernel source for its design.

`spd_solve` dispatches on the tensors' device: CPU tensors take
`spd_solve_reference`, CUDA tensors launch the kernel (or raise).
`spd_solve.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_build

PAD = 128


def _pad(A: torch.Tensor, b: torch.Tensor):
    n = A.shape[0]
    if A.shape != (n, n) or b.shape != (n,) or n > PAD:
        raise ValueError(f"spd_solve: need A (n, n), b (n,), n <= {PAD}; got "
                         f"{tuple(A.shape)}, {tuple(b.shape)}")
    a_pad = torch.zeros((PAD, PAD), dtype=torch.float32, device=A.device)
    a_pad[:n, :n] = A.to(torch.float32)
    idx = torch.arange(n, PAD, device=A.device)
    a_pad[idx, idx] = 1.0
    b_pad = torch.zeros((PAD,), dtype=torch.float32, device=A.device)
    b_pad[:n] = b.to(torch.float32)
    return a_pad, b_pad


def spd_solve_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the padded system through torch.linalg.solve."""
    a_pad, b_pad = _pad(A, b)
    return torch.linalg.solve(a_pad, b_pad)[: A.shape[0]]


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for SPD A (n, n) float32, b (n,), n <= 128."""
    if A.device.type == "cpu":
        return spd_solve_reference(A, b)
    prepared, x = prepare(A, b)
    launch(prepared)
    return x


def prepare(A: torch.Tensor, b: torch.Tensor):
    """Check `spd_solve`'s CUDA arguments, pad the system and allocate the
    solution. Returns the prepared launch and x (n,), which `launch`
    writes."""
    if A.device.type != "cuda" or b.device != A.device:
        raise ValueError(f"spd_solve: unsupported devices {A.device}, {b.device}")
    n = A.shape[0]
    a_pad, b_pad = _pad(A, b)
    x = torch.empty((PAD,), dtype=torch.float32, device=A.device)
    args = (a_pad.data_ptr(), b_pad.data_ptr(), n, x.data_ptr(),
            torch.cuda.current_stream(A.device).cuda_stream)
    return cuda_build.Prepared("spd_solve", args, (a_pad, b_pad, x)), x[:n]


def launch(prepared: cuda_build.Prepared) -> None:
    """Launch the kernel as `prepare` set it up; counts the launch."""
    cuda_build.launch(prepared)
    spd_solve.launches += 1


spd_solve.launches = 0
