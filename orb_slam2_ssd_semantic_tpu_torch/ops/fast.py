"""Dense FAST-9-16 corner scores and 3x3 non-max suppression
(counterpart of the JAX package's `ops/fast.py`). Integer arithmetic on
rounded pixels, so the scores are exact on every device."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3: 16 (dy, dx) offsets in circular order.
FAST_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # contiguous run length for FAST-9


def fast_score_map(img: torch.Tensor, border: int = 3) -> torch.Tensor:
    """Dense FAST-9-16 corner score (H, W) float32 (OpenCV semantics: the
    largest threshold at which the pixel is still a corner)."""
    h, w = img.shape
    c = torch.round(img).to(torch.int16)
    pad = 3
    xp = F.pad(c[None, None].float(), (pad, pad, pad, pad), mode="replicate")[0, 0]
    xp = xp.to(torch.int16)
    circ = torch.stack(
        [xp[pad + int(dy): pad + int(dy) + h, pad + int(dx): pad + int(dx) + w]
         for dy, dx in FAST_OFFSETS],
        dim=0,
    )
    d = circ - c[None]

    mn = mx = d
    for shift in (1, 2, 4):
        mn = torch.minimum(mn, torch.roll(mn, -shift, dims=0))
        mx = torch.maximum(mx, torch.roll(mx, -shift, dims=0))
    last = torch.roll(d, -(ARC_LEN - 1), dims=0)
    mn9 = torch.minimum(mn, last)
    mx9 = torch.maximum(mx, last)
    bright = torch.amax(mn9, dim=0)
    dark = torch.amax(-mx9, dim=0)
    score = torch.clamp(torch.maximum(bright, dark), min=0).to(torch.float32)

    row = torch.arange(h, device=img.device)[:, None]
    col = torch.arange(w, device=img.device)[None, :]
    interior = (row >= border) & (row < h - border) & (col >= border) & (col < w - border)
    return torch.where(interior, score, torch.zeros_like(score))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only strict 3x3 local maxima, plateau ties kept at the
    top-left pixel."""
    h, w = score.shape
    sp = F.pad(score, (1, 1, 1, 1), value=-1.0)
    best = torch.full_like(score, -float("inf"))
    before = torch.full_like(score, -float("inf"))
    for dy in range(3):
        for dx in range(3):
            if dy == 1 and dx == 1:
                continue
            nb = sp[dy: dy + h, dx: dx + w]
            best = torch.maximum(best, nb)
            if dy < 1 or (dy == 1 and dx < 1):
                before = torch.maximum(before, nb)
    keep = (score > 0) & (score >= best) & (score > before)
    return torch.where(keep, score, torch.zeros_like(score))
