"""Fused windowed Hamming matcher: the CUDA kernels of
`csrc/window_match.cu` and their plain PyTorch versions.

Counterpart of the JAX package's `ops/pallas_match.py::fused_window_match`
(the Pallas TPU kernel it replaces). For each query, over all targets:
Hamming distance, square search window and validity (masked pairs score
BIG), best / second-best / first-argmin, and per target the minimum
claim key `best * 2^20 + q` over the queries whose best it is at
`best <= max_dist`: the duplicate-target resolution.

On the card the work is a few microseconds for one SM (Q*T window tests,
popcounts for the few pairs inside a window, a few hundred KB moved), so
the design spreads it: a first kernel on a 2-D grid of query tiles x
target splits (`tiles` picks the split: 128 x 64 at the tracker's shapes,
one to two blocks per SM) leaves a partial top-2 per query and split in
scratch, and a second, one thread per query, folds the splits in
ascending order, writes the outputs and makes the claims. See the kernel
source for the tie rules and the inner loop.

`window_match` dispatches on the tensors' device: CPU tensors take
`window_match_reference`, CUDA tensors launch the kernels (or raise).
`window_match.launches` counts calls of the wrapper that reached the
card: one per call, although a call launches two CUDA kernels. A call
made while a CUDA graph is captured counts once (and in
`cuda_build.captured`); the graph's replays call no wrapper and count
nothing.
`window_match_split_reference` is the two kernels' algorithm step for
step in PyTorch, for tests of the merge's tie rules where no card is.
"""

from __future__ import annotations

import torch

from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_build
from orb_slam2_ssd_semantic_tpu_torch.ops.match import BIG, hamming_matrix, window_mask

Q_STRIDE = 1 << 20
BIG_KEY = BIG * Q_STRIDE
Q_TILE = 128  # queries of a block of the first kernel (kTile)
SPLIT_UNIT = 64
MAX_SPLITS = 16


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


def window_match_split_reference(desc_q, desc_t, centers, uv_t, radius, valid_q, valid_t,
                                 max_dist: int = 256, split: int | None = None):
    """The two kernels' algorithm in plain PyTorch: a partial
    (best, idx, second) per split of `split` targets (default: what
    `tiles` gives the kernels), then the merge over splits in ascending
    order with the strict-less rule, then the claims."""
    Q, T = desc_q.shape[0], desc_t.shape[0]
    split = tiles(Q, T)[0] if split is None else split
    d = hamming_matrix(desc_q, desc_t)
    mask = window_mask(centers, uv_t, radius, valid_q, valid_t)
    d = torch.where(mask, d, torch.full_like(d, BIG))
    best = second = idx = None
    for t0 in range(0, T, split):
        ds = d[:, t0:t0 + split]
        b = torch.amin(ds, dim=1)
        i = torch.argmin(ds, dim=1)  # first occurrence within the split
        cols = torch.arange(ds.shape[1], device=d.device)[None, :]
        s = torch.amin(torch.where(cols == i[:, None], torch.full_like(ds, BIG), ds), dim=1)
        i = i + t0
        if best is None:
            best, second, idx = b, s, i
            continue
        wins = b < best  # an equal best of a later split only lowers `second`
        second = torch.where(wins, torch.minimum(best, s), torch.minimum(second, b))
        idx = torch.where(wins, i, idx)
        best = torch.where(wins, b, best)
    qg = torch.arange(Q, dtype=torch.int32, device=d.device)
    claim = torch.where(best <= max_dist, best * Q_STRIDE + qg, torch.full_like(best, BIG_KEY))
    key_min = torch.full((T,), BIG_KEY, dtype=torch.int32, device=d.device)
    key_min = key_min.scatter_reduce(0, idx, claim, "amin")
    return best, second, idx.to(torch.int32), key_min


def tiles(Q: int, T: int) -> tuple[int, int]:
    """The first kernel's split of a (Q, T) problem: targets per split and
    number of splits. Its grid is ceil(Q / Q_TILE) x n_splits blocks.

    A split is a multiple of `SPLIT_UNIT` targets, as short as keeps the
    number of splits at `MAX_SPLITS` or under: short splits spread the
    walk over more blocks, but every split is one more partial result for
    the merge to read, and a large T must not mean more scratch."""
    split_len = SPLIT_UNIT * max(1, -(-T // (SPLIT_UNIT * MAX_SPLITS)))
    return split_len, -(-T // split_len)


def window_match(desc_q, desc_t, centers, uv_t, radius, valid_q, valid_t, max_dist: int = 256):
    """Best/second-best windowed Hamming match + claim keys.

    desc_q (Q, 8) / desc_t (T, 8) int32 (256-bit patterns), centers (Q, 2)
    and uv_t (T, 2) float32, radius scalar or (Q,) float32, valid_q (Q,) /
    valid_t (T,) bool. Returns (best, second, idx, key_min) int32.

    On CUDA tensors a call launches two kernels and adds one to
    `window_match.launches`."""
    if desc_q.device.type == "cpu":
        return window_match_reference(desc_q, desc_t, centers, uv_t, radius, valid_q, valid_t,
                                      max_dist)
    prepared, outputs = prepare(desc_q, desc_t, centers, uv_t, radius, valid_q, valid_t,
                                max_dist)
    launch(prepared)
    return outputs


def _aligned(t: torch.Tensor, n_bytes: int) -> torch.Tensor:
    """`t` contiguous at an address the kernel's vector loads can take."""
    t = t.contiguous()
    return t if t.data_ptr() % n_bytes == 0 else t.clone()


def prepare(desc_q, desc_t, centers, uv_t, radius, valid_q, valid_t, max_dist: int = 256):
    """Check `window_match`'s CUDA arguments and allocate its outputs and
    its scratch (per call: a call on another stream must not share it).
    Returns the prepared launch and the outputs (best, second, idx,
    key_min) that `launch` writes. Nothing here launches a kernel when the
    arguments are contiguous device tensors, as the tracker's are."""
    if desc_q.device.type != "cuda":
        raise ValueError(f"window_match: unsupported device {desc_q.device}")
    Q, T = desc_q.shape[0], desc_t.shape[0]
    dev = desc_q.device
    if not 0 < Q < Q_STRIDE or T < 1:
        raise ValueError(f"window_match: need 0 < Q < 2^20 (the claim key) and T > 0, "
                         f"got Q={Q}, T={T}")
    if isinstance(radius, torch.Tensor):
        radius = radius.to(device=dev, dtype=torch.float32)
    else:
        radius = torch.full((1,), radius, dtype=torch.float32, device=dev)
    # One radius for all queries is read through a stride of 0, one per
    # query through its own stride: no copy either way.
    scalar_radius = radius.numel() == 1
    radius = radius.reshape(1) if scalar_radius else radius
    args = dict(desc_q=desc_q, desc_t=desc_t, centers=centers, uv_t=uv_t, radius=radius,
                valid_q=valid_q, valid_t=valid_t)
    want = dict(desc_q=(torch.int32, (Q, 8), 16), desc_t=(torch.int32, (T, 8), 16),
                centers=(torch.float32, (Q, 2), 8), uv_t=(torch.float32, (T, 2), 8),
                radius=(torch.float32, (1,) if scalar_radius else (Q,), None),
                valid_q=(torch.bool, (Q,), 1), valid_t=(torch.bool, (T,), 1))
    for k, t in args.items():
        dt, shape, align = want[k]
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"window_match: {k} must be {dt} {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if align is not None:
            args[k] = _aligned(t, align)
    split_len, n_splits = tiles(Q, T)
    # The scratch (n_splits x Q pairs) is its own allocation, freed once the
    # launch is dropped; the outputs are views of one buffer, which lives
    # as long as any of them does.
    part = torch.empty((2 * n_splits * Q,), dtype=torch.int32, device=dev)
    out = torch.empty((3 * Q + T,), dtype=torch.int32, device=dev)
    outputs = out.split((Q, Q, Q, T))
    ptr = {k: t.data_ptr() for k, t in args.items()}
    c_args = (ptr["desc_q"], ptr["desc_t"], ptr["centers"], ptr["uv_t"], ptr["radius"],
              0 if scalar_radius else radius.stride(0), ptr["valid_q"], ptr["valid_t"], Q, T,
              int(max_dist), split_len, part.data_ptr(), *[o.data_ptr() for o in outputs],
              torch.cuda.current_stream(dev).cuda_stream)
    return cuda_build.Prepared("window_match", c_args, (*args.values(), part, out)), outputs


def launch(prepared: cuda_build.Prepared) -> None:
    """Launch the two kernels as `prepare` set them up; counts one launch."""
    cuda_build.launch(prepared)
    window_match.launches += 1


window_match.launches = 0
