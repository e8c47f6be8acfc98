"""Tensor idioms the JAX package gets from XLA, with the same semantics.

- `top_k`: `lax.top_k` order — descending, ties resolved to the LOWER
  index first. `torch.topk` promises no order among ties, and several
  selections (candidate gathers, keypoint selection, window assembly)
  feed that order into later tie-breaks, so a stable sort is used.
- `scatter`: `.at[idx].set/add/min/max(..., mode="drop")` — indices
  outside the array are dropped (torch raises on them), and the input is
  never modified (JAX arrays are immutable; callers keep pre-update
  snapshots of the map state). Duplicate `set` indices resolve
  arbitrarily on the card, as they do under XLA, except under
  deterministic algorithms, where the last one wins; the CPU writes in
  order. Nothing in it waits on the card: dropped indices are sent to a
  spare row (a mask compaction would read the count on the host), and
  the write skips PyTorch's host-side range check (`index_add_`-style
  `put`, below).
- `put`: `index_put_` (or `index_add_` with `accumulate`) on indices the
  caller keeps in range, without the check that reads their extremes on
  the host. On the card, every `index_add_` and every deterministic
  `index_put_` makes that check, a stream sync.
- `row`: `t[i]` for a 0-d index tensor, as a gather: indexing with a 0-d
  tensor reads it on the host (`item`).
- `device_constant`: a table computed on the host (scale factors, an
  intrinsics matrix, a sampling pattern), uploaded once per device
  without a pageable copy and shared: a `torch.tensor(..., device=cuda)`
  on every call is a copy the host waits for.
- `nanmedian`: `jnp.nanmedian` — for an even count of numbers it
  averages the two middle ones, where `torch.nanmedian` returns the lower.
- `finite_matrices`: XLA's decompositions return NaN for a matrix holding
  NaN or Inf, where torch's (LAPACK, cuSOLVER) raise; a batched RANSAC
  meets such matrices in hypotheses from degenerate minimal sets.
- `f32_reciprocal`: under `jit` XLA turns a division by a constant into a
  product with the constant's f32 reciprocal; the port multiplies by it
  where the last bits decide a bin or a voxel.
- `valid_rows`: uniform draws over the rows a mask keeps, as
  `jax.random.categorical` over logits of 0 and -1e9 draws them.
- `last_write_wins`: XLA's CPU scatter with repeated indices, made
  explicit and order-free.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, lowest
    index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def put(t: torch.Tensor, idx: torch.Tensor, val: torch.Tensor, accumulate: bool = False):
    """`t.index_put_((idx,), val, accumulate)` in place on the leading dim,
    indices in range (the caller's guarantee: nothing checks them)."""
    return torch._index_put_impl_(t, (idx,), val, accumulate=accumulate, unsafe=True)


def scatter(t: torch.Tensor, idx, val, op: str = "set") -> torch.Tensor:
    """Functional scatter into the leading `len(idx)` dims of `t`.

    idx: one index tensor or a tuple of them (broadcast together);
    val: a tensor or a Python scalar, broadcastable to
    idx.shape + t.shape[len(idx):];
    op: "set", "add", "amin" or "amax" (the last two for 1-D scalar
    entries). Out-of-range indices are dropped: they write to a spare
    row past the end, which the result leaves out."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    idx = torch.broadcast_tensors(*idx)
    n_lead = len(idx)
    lead = t.shape[:n_lead]
    trail = t.shape[n_lead:]
    n = 1
    ok = None
    lin = None
    for d, i in zip(lead, idx):
        in_range = (i >= 0) & (i < d)
        ok = in_range if ok is None else ok & in_range
        lin = i.to(torch.int64) if lin is None else lin * d + i
        n *= d
    lin = torch.where(ok, lin, n).reshape(-1)
    if isinstance(val, torch.Tensor):
        val = val.to(device=t.device, dtype=t.dtype)
    else:
        val = torch.full((), val, dtype=t.dtype, device=t.device)
    val = val.expand(idx[0].shape + trail).reshape((-1,) + trail)
    flat = torch.cat([t.reshape((n,) + trail), t.new_zeros((1,) + trail)])
    if op in ("set", "add"):
        put(flat, lin, val, accumulate=op == "add")
    elif op in ("amin", "amax"):
        flat.scatter_reduce_(0, lin, val, reduce=op, include_self=True)
    else:
        raise ValueError(op)
    return flat[:n].view(t.shape)


def row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] for a 0-d int64 tensor `i`, read on the device."""
    return t.index_select(0, i.reshape(1))[0]


def device_constant(fn):
    """Decorator for a function of hashable arguments that returns a host
    table (a numpy array or a CPU tensor): the wrapped function takes a `device=` keyword
    as well and returns the table as a tensor there, built once per
    (arguments, device) and uploaded from pinned memory without waiting.
    Every caller shares the tensor: never write into it."""

    @functools.lru_cache(maxsize=None)
    def cached(args, device):
        host = fn(*args)
        host = torch.from_numpy(np.array(host)) if isinstance(host, np.ndarray) else host.clone()
        if device.type == "cuda":
            return host.pin_memory().to(device, non_blocking=True)
        return host.to(device)

    @functools.wraps(fn)
    def wrapped(*args, device=None):
        device = torch.device("cpu" if device is None else device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return cached(args, device)

    return wrapped


def f32_reciprocal(v: float) -> float:
    """The f32 reciprocal of `v`, as XLA folds a constant divisor."""
    return float(np.float32(1.0) / np.float32(v))


def valid_rows(u: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """int64 indices (u's shape) of rows where `valid` is set: uniforms
    `u` in [0, 1) from a CPU generator (the same draws on every device;
    on the host they are uploaded first, on the device taken as they are)
    pick the r-th valid row, r = floor(u * n_valid), found on the device
    from the running count, so `valid` is never fetched. With no valid
    row every index is the last row."""
    if valid.is_cuda and not u.is_cuda:
        u = u.pin_memory().to(valid.device, non_blocking=True)
    cnt = torch.cumsum(valid.to(torch.int64), dim=0)
    n = cnt[-1]
    rank = torch.clamp(torch.floor(u * n.to(torch.float32)).to(torch.int64),
                       max=torch.clamp(n - 1, min=0))
    idx = torch.searchsorted(cnt, (rank + 1).reshape(-1)).reshape(rank.shape)
    return torch.clamp(idx, max=valid.shape[0] - 1)


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN entries of `x` (all of it), averaging the two
    middle values of an even count as `jnp.nanmedian` does; NaN if every
    entry is NaN. Linear interpolation at q = 0.5 is exactly that average."""
    return torch.nanquantile(x.reshape(-1), 0.5)


def finite_matrices(a: torch.Tensor):
    """(a with every non-finite matrix over the last two dims zeroed, (...)
    mask of the finite ones). Decompose the first and put NaN where the
    mask is False, as XLA leaves it."""
    ok = torch.isfinite(a).all(-1).all(-1)
    return torch.where(ok[..., None, None], a, torch.zeros_like(a)), ok


def nan_where(ok: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x with NaN in the batch entries where `ok` (x's leading dims) is False."""
    ok = ok.reshape(ok.shape + (1,) * (x.dim() - ok.dim()))
    return torch.where(ok, x, torch.full_like(x, float("nan")))


def last_write_wins(flat_idx: torch.Tensor, keep: torch.Tensor, values: torch.Tensor,
                     n: int):
    """Scatter `values` into n targets where `keep` (an index outside
    [0, n) is dropped), the update with the largest position winning
    among those aimed at one target. Returns
    ((n,) f32 values, 0 where nothing landed; (n,) bool hit). XLA's CPU
    scatter lets the last write win; this makes that rule explicit and
    independent of the order in which the device applies the writes."""
    pos = torch.arange(flat_idx.shape[0], device=flat_idx.device)
    keep = keep & (flat_idx >= 0) & (flat_idx < n)
    tgt = torch.where(keep, flat_idx, torch.full_like(flat_idx, n))
    winner = torch.full((n + 1,), -1, dtype=torch.int64, device=flat_idx.device)
    winner = winner.scatter_reduce(0, tgt, pos, reduce="amax", include_self=True)[:n]
    hit = winner >= 0
    got = values[winner.clamp(min=0)]
    return torch.where(hit, got, torch.zeros_like(got)), hit
