"""Batched Hamming descriptor matching (counterpart of the JAX package's
`ops/match.py`).

Descriptors are (N, 8) int32 tensors holding 256-bit patterns; distances
are int32 in [0, 256], and BIG = 1024 marks masked pairs. The windowed
search (`match_by_window`) runs through the fused window matcher
(`ops/cuda_match.py`: a CUDA kernel on the card, its plain PyTorch
version on the CPU) whenever the JAX package would take its Pallas
kernel: not mutual, Q % 256 == 0, T % 128 == 0 — on every device, so the
CPU tests exercise the same claim-key duplicate resolution.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import top_k

BIG = 1024  # sentinel distance for masked pairs (> any real Hamming distance)
TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int32 words (SWAR; torch has no popcount op). The
    sign bit is counted apart so the shifts never see a negative."""
    v = x & 0x7FFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    v = v + (v >> 16)
    return (v & 0x3F) + (x < 0).to(x.dtype)


def hamming_matrix(desc_q: torch.Tensor, desc_t: torch.Tensor) -> torch.Tensor:
    """(Q, 8) x (T, 8) int32 -> (Q, T) int32 Hamming distances."""
    acc = None
    for w in range(desc_q.shape[1]):
        c = popcount32(torch.bitwise_xor(desc_q[:, w, None], desc_t[None, :, w]))
        acc = c if acc is None else acc + c
    return acc


@dataclasses.dataclass
class MatchResult:
    """Per-query best match into the target set."""

    idx: torch.Tensor  # (Q,) int64 target index, -1 if unmatched
    dist: torch.Tensor  # (Q,) int32 best distance (BIG if unmatched)
    valid: torch.Tensor  # (Q,) bool


def _masked_result(keep, idx, dist) -> MatchResult:
    return MatchResult(
        idx=torch.where(keep, idx, torch.full_like(idx, -1)),
        dist=torch.where(keep, dist, torch.full_like(dist, BIG)),
        valid=keep,
    )


def masked_best_match(dist, pair_mask, max_dist: int = TH_LOW, ratio: float | None = None,
                      mutual: bool = False) -> MatchResult:
    """Per-row best target under a pair mask, with an optional ratio test
    and mutual-best check. Ties go to the lowest target index."""
    d = torch.where(pair_mask, dist, torch.full_like(dist, BIG))
    neg, idx2 = top_k(-d, 2)
    best = -neg[:, 0]
    second = -neg[:, 1]
    best_idx = idx2[:, 0]
    ok = best <= max_dist
    if ratio is not None:
        ok = ok & (best.to(torch.float32) < ratio * second.to(torch.float32))
    if mutual:
        col_best = torch.argmin(d, dim=0)  # first occurrence
        ok = ok & (col_best[best_idx] == torch.arange(d.shape[0], device=d.device))
    return _masked_result(ok, best_idx, best)


def resolve_duplicate_targets(m: MatchResult, num_targets: int) -> MatchResult:
    """Keep only the lowest-distance query per target (lowest query index
    among equals), as two scatter-mins over target bins."""
    dev = m.idx.device
    tgt = torch.where(m.valid, m.idx, torch.full_like(m.idx, num_targets))
    best_per_tgt = torch.full((num_targets + 1,), BIG, dtype=torch.int32, device=dev)
    best_per_tgt = best_per_tgt.scatter_reduce(0, tgt, m.dist, "amin")
    keep = m.valid & (m.dist == best_per_tgt[tgt])
    qidx = torch.arange(m.idx.shape[0], dtype=torch.int64, device=dev)
    first_q = torch.full((num_targets + 1,), m.idx.shape[0], dtype=torch.int64, device=dev)
    first_q = first_q.scatter_reduce(
        0, torch.where(keep, tgt, torch.full_like(tgt, num_targets)), qidx, "amin")
    keep = keep & (first_q[tgt] == qidx)
    return _masked_result(keep, m.idx, m.dist)


def rotation_consistency_mask(angle_q, angle_t, m: MatchResult, histo_length: int = HISTO_LENGTH,
                              keep_bins: int = 3) -> torch.Tensor:
    """Keep matches whose orientation delta falls in the 3 most populated
    of 30 bins (dropping bins under 10% of the best). Returns (Q,) bool."""
    tgt_angle = angle_t[m.idx.clamp(0, angle_t.shape[0] - 1)]
    two_pi = 2.0 * math.pi
    delta = torch.remainder(angle_q - tgt_angle, two_pi)
    bins = (delta * histo_length / two_pi).to(torch.int32).clamp(0, histo_length - 1).to(torch.int64)
    counts = torch.zeros((histo_length,), dtype=torch.int32, device=bins.device)
    counts = counts.index_add(0, torch.where(m.valid, bins, torch.zeros_like(bins)),
                              m.valid.to(torch.int32))
    top_counts, top_bins = top_k(counts, keep_bins)
    good = top_counts.to(torch.float32) > 0.1 * top_counts[0].to(torch.float32)
    in_top = torch.any((bins[:, None] == top_bins[None, :]) & good[None, :], dim=-1)
    return m.valid & in_top


def window_mask(centers, uv_t, radius, valid_q, valid_t) -> torch.Tensor:
    """(Q, T) mask: target inside the square window of half-size
    radius[q] (scalar or (Q,)) around each query centre."""
    if isinstance(radius, torch.Tensor):
        r = radius.to(device=centers.device, dtype=torch.float32)
    else:
        r = torch.full((), radius, dtype=torch.float32, device=centers.device)
    r = r.expand(centers.shape[0])
    du = torch.abs(uv_t[None, :, 0] - centers[:, None, 0])
    dv = torch.abs(uv_t[None, :, 1] - centers[:, None, 1])
    inside = (du <= r[:, None]) & (dv <= r[:, None])
    return inside & valid_q[:, None] & valid_t[None, :]


def level_mask(level_q: torch.Tensor, level_t: torch.Tensor, min_delta: int,
               max_delta: int) -> torch.Tensor:
    """(Q, T) mask: target pyramid level within [lq + min_delta,
    lq + max_delta] (the octave gate of projection searches,
    ORBmatcher.cc:105-110)."""
    d = level_t[None, :] - level_q[:, None]
    return (d >= min_delta) & (d <= max_delta)


def match_by_window(desc_q, desc_t, centers, uv_t, valid_q, valid_t, radius,
                    angle_q=None, angle_t=None, max_dist: int = TH_HIGH,
                    mutual: bool = False) -> MatchResult:
    """Projection-style guided search: per query, the best target inside
    the window around its predicted position, then an optional rotation
    filter and duplicate-target resolution."""
    from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_match

    Q, T = desc_q.shape[0], desc_t.shape[0]
    if not mutual and Q % 256 == 0 and T % 128 == 0:
        best, _, best_idx, key_min = cuda_match.window_match(
            desc_q, desc_t, centers, uv_t, radius, valid_q, valid_t, max_dist=max_dist)
        best_idx = best_idx.to(torch.int64)
        ok = best <= max_dist
        m = _masked_result(ok, best_idx, best)
        if angle_q is None or angle_t is None:
            # q keeps its target iff its (dist, q) claim key IS the
            # per-target minimum the kernel accumulated.
            q_key = best * cuda_match.Q_STRIDE + torch.arange(Q, dtype=torch.int32, device=best.device)
            keep = m.valid & (q_key == key_min[m.idx.clamp(0, T - 1)])
            return _masked_result(keep, m.idx, m.dist)
    else:
        dist = hamming_matrix(desc_q, desc_t)
        mask = window_mask(centers, uv_t, radius, valid_q, valid_t)
        m = masked_best_match(dist, mask, max_dist=max_dist, mutual=mutual)
    if angle_q is not None and angle_t is not None:
        keep = rotation_consistency_mask(angle_q, angle_t, m)
        m = _masked_result(keep, m.idx, m.dist)
    return resolve_duplicate_targets(m, T)
