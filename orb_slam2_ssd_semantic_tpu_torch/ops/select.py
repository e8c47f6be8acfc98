"""Spatially-uniform keypoint selection on dense score maps (counterpart
of the JAX package's `ops/select.py`): per-cell top-k, then a global
top-k keyed by (cell rank, score). Both top-k's keep `lax.top_k`'s
lower-index-first tie order (utils/tensor_ops.top_k)."""

from __future__ import annotations

import torch

from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import top_k


def select_keypoints(
    score: torch.Tensor,
    ini_th: float,
    min_th: float,
    cell_size: int = 16,
    max_per_cell: int = 4,
    quota: int = 256,
    border: int = 19,
):
    """Up to `quota` keypoints from a dense (NMS'd) score map with the
    two-threshold per-cell rule. Returns (uv (quota, 2) [x, y],
    scores (quota,), valid (quota,)), best-in-cell corners first."""
    h, w = score.shape
    dev = score.device
    row = torch.arange(h, device=dev)[:, None]
    col = torch.arange(w, device=dev)[None, :]
    inb = (row >= border) & (row < h - border) & (col >= border) & (col < w - border)
    score = torch.where(inb, score, torch.zeros_like(score))

    hp = -(-h // cell_size) * cell_size
    wp = -(-w // cell_size) * cell_size
    sp = torch.nn.functional.pad(score, (0, wp - w, 0, hp - h))
    ncy, ncx = hp // cell_size, wp // cell_size
    cells = sp.reshape(ncy, cell_size, ncx, cell_size).permute(0, 2, 1, 3)
    cells = cells.reshape(ncy * ncx, cell_size * cell_size)

    cell_max = cells.amax(dim=1, keepdim=True)
    eligible = (cells >= ini_th) | ((cell_max < ini_th) & (cells >= min_th))
    cells = torch.where(eligible & (cells > 0), cells, torch.zeros_like(cells))

    top_s, top_i = top_k(cells, max_per_cell)  # (ncells, k)

    cell_ids = torch.arange(ncy * ncx, device=dev)[:, None]
    cy = cell_ids // ncx
    cx = cell_ids % ncx
    py = cy * cell_size + top_i // cell_size
    px = cx * cell_size + top_i % cell_size

    rank = torch.arange(max_per_cell, device=dev)[None, :].expand(top_s.shape)
    flat_s = top_s.reshape(-1)
    flat_rank = rank.reshape(-1)
    flat_x = px.reshape(-1).to(torch.float32)
    flat_y = py.reshape(-1).to(torch.float32)
    valid_c = flat_s > 0
    smax = torch.amax(flat_s) + 1.0
    key = torch.where(
        valid_c, -flat_rank.to(torch.float32) * smax + flat_s,
        torch.full_like(flat_s, -float("inf")),
    )

    k = min(quota, key.shape[0])
    best_key, best_idx = top_k(key, k)
    uv = torch.stack([flat_x[best_idx], flat_y[best_idx]], dim=-1)
    out_s = flat_s[best_idx]
    out_valid = torch.isfinite(best_key) & (out_s > 0)
    if k < quota:
        pad = quota - k
        uv = torch.nn.functional.pad(uv, (0, 0, 0, pad))
        out_s = torch.nn.functional.pad(out_s, (0, pad))
        out_valid = torch.nn.functional.pad(out_valid, (0, pad))
    uv = torch.where(out_valid[:, None], uv, torch.zeros_like(uv))
    return uv, torch.where(out_valid, out_s, torch.zeros_like(out_s)), out_valid


def subpixel_refine(score: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Quadratic subpixel refinement on the pre-NMS score map (parabola
    fits along x and y, offsets clamped to +-0.5 px)."""
    h, w = score.shape
    x = torch.round(uv[:, 0]).to(torch.int64).clamp(1, w - 2)
    y = torch.round(uv[:, 1]).to(torch.int64).clamp(1, h - 2)

    def tap(dy, dx):
        return score[y + dy, x + dx]

    s0 = tap(0, 0)
    dxn, dxp = tap(0, -1), tap(0, 1)
    dyn, dyp = tap(-1, 0), tap(1, 0)
    denx = dxn - 2.0 * s0 + dxp
    deny = dyn - 2.0 * s0 + dyp
    zero = torch.zeros_like(s0)
    offx = torch.where(denx < -1e-6, 0.5 * (dxn - dxp) / denx, zero).clamp(-0.5, 0.5)
    offy = torch.where(deny < -1e-6, 0.5 * (dyn - dyp) / deny, zero).clamp(-0.5, 0.5)
    off = torch.stack([offx, offy], dim=-1)
    return torch.where(valid[:, None], uv + off, uv)


def level_quotas(n_features: int, n_levels: int, scale_factor: float):
    """Geometric per-level feature budget (ORBextractor ctor)."""
    q = 1.0 / scale_factor
    first = n_features * (1 - q) / (1 - q**n_levels)
    quotas = [int(round(first * q**i)) for i in range(n_levels - 1)]
    quotas.append(max(0, n_features - sum(quotas)))
    return quotas
