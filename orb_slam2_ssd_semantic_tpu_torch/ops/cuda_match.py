"""Fused windowed Hamming matcher: the CUDA kernel `csrc/window_match.cu`
and its plain PyTorch version.

Counterpart of the JAX package's `ops/pallas_match.py::fused_window_match`
(the Pallas TPU kernel it replaces). For each query, over all targets:
Hamming distance, square search window and validity (masked pairs score
BIG), best / second-best / first-argmin, and per target the minimum
claim key `best * 2^20 + q` over the queries whose best it is at
`best <= max_dist` — the duplicate-target resolution.

On the card this is bound by operations (Q*T popcounts and window tests,
a few hundred KB moved); see the kernel source for its design.

`window_match` dispatches on the tensors' device: CPU tensors take
`window_match_reference`, CUDA tensors launch the kernel (or raise).
`window_match.launches` counts kernel launches.
"""

from __future__ import annotations

import torch

from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_build
from orb_slam2_ssd_semantic_tpu_torch.ops.match import BIG, hamming_matrix, window_mask

Q_STRIDE = 1 << 20
BIG_KEY = BIG * Q_STRIDE


def window_match_reference(desc_q, desc_t, centers, uv_t, radius, valid_q, valid_t,
                           max_dist: int = 256):
    """Plain PyTorch version: the full (Q, T) distance matrix, then the
    top-2 and the claim-key scatter-min. Returns (best, second, idx,
    key_min), int32."""
    Q, T = desc_q.shape[0], desc_t.shape[0]
    d = hamming_matrix(desc_q, desc_t)
    mask = window_mask(centers, uv_t, radius, valid_q, valid_t)
    d = torch.where(mask, d, torch.full_like(d, BIG))
    best = torch.amin(d, dim=1)
    idx = torch.argmin(d, dim=1)  # first occurrence
    cols = torch.arange(T, device=d.device)[None, :]
    second = torch.amin(torch.where(cols == idx[:, None], torch.full_like(d, BIG), d), dim=1)
    qg = torch.arange(Q, dtype=torch.int32, device=d.device)
    claim = torch.where(best <= max_dist, best * Q_STRIDE + qg, torch.full_like(best, BIG_KEY))
    key_min = torch.full((T,), BIG_KEY, dtype=torch.int32, device=d.device)
    key_min = key_min.scatter_reduce(0, idx, claim, "amin")
    return best, second, idx.to(torch.int32), key_min


def window_match(desc_q, desc_t, centers, uv_t, radius, valid_q, valid_t, max_dist: int = 256):
    """Best/second-best windowed Hamming match + claim keys.

    desc_q (Q, 8) / desc_t (T, 8) int32 (256-bit patterns), centers (Q, 2)
    and uv_t (T, 2) float32, radius scalar or (Q,) float32, valid_q (Q,) /
    valid_t (T,) bool. Returns (best, second, idx, key_min) int32."""
    if desc_q.device.type == "cpu":
        return window_match_reference(desc_q, desc_t, centers, uv_t, radius, valid_q, valid_t,
                                      max_dist)
    prepared, outputs = prepare(desc_q, desc_t, centers, uv_t, radius, valid_q, valid_t,
                                max_dist)
    launch(prepared)
    return outputs


def prepare(desc_q, desc_t, centers, uv_t, radius, valid_q, valid_t, max_dist: int = 256):
    """Check `window_match`'s CUDA arguments and allocate its outputs.
    Returns the prepared launch and the outputs (best, second, idx,
    key_min) that `launch` writes."""
    if desc_q.device.type != "cuda":
        raise ValueError(f"window_match: unsupported device {desc_q.device}")
    Q, T = desc_q.shape[0], desc_t.shape[0]
    dev = desc_q.device
    if Q >= Q_STRIDE:
        raise ValueError(f"window_match: Q={Q} must be < 2^20 for the claim key")
    radius = torch.as_tensor(radius, dtype=torch.float32, device=dev).expand(Q).contiguous()
    args = dict(desc_q=desc_q, desc_t=desc_t, centers=centers, uv_t=uv_t, radius=radius,
                valid_q=valid_q, valid_t=valid_t)
    want = dict(desc_q=(torch.int32, (Q, 8)), desc_t=(torch.int32, (T, 8)),
                centers=(torch.float32, (Q, 2)), uv_t=(torch.float32, (T, 2)),
                radius=(torch.float32, (Q,)), valid_q=(torch.bool, (Q,)),
                valid_t=(torch.bool, (T,)))
    for k, t in args.items():
        dt, shape = want[k]
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"window_match: {k} must be {dt} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        args[k] = t.contiguous()
    best = torch.empty((Q,), dtype=torch.int32, device=dev)
    second = torch.empty_like(best)
    idx = torch.empty_like(best)
    key_min = torch.full((T,), BIG_KEY, dtype=torch.int32, device=dev)
    outputs = (best, second, idx, key_min)
    c_args = (*[args[k].data_ptr() for k in want], Q, T, int(max_dist),
              *[o.data_ptr() for o in outputs], torch.cuda.current_stream(dev).cuda_stream)
    return cuda_build.Prepared("window_match", c_args, (*args.values(), *outputs)), outputs


def launch(prepared: cuda_build.Prepared) -> None:
    """Launch the kernel as `prepare` set it up; counts the launch."""
    cuda_build.launch(prepared)
    window_match.launches += 1


window_match.launches = 0
