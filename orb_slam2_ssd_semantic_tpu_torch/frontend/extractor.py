"""ORB feature extraction: pyramid -> FAST -> uniform selection -> IC angle
-> steered BRIEF (counterpart of the JAX package's `frontend/extractor.py`).
Keypoints land in fixed-capacity padded tensors with a validity mask."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch.config import OrbConfig
from orb_slam2_ssd_semantic_tpu_torch.ops import fast as fast_ops
from orb_slam2_ssd_semantic_tpu_torch.ops import image as image_ops
from orb_slam2_ssd_semantic_tpu_torch.ops import select as select_ops
from orb_slam2_ssd_semantic_tpu_torch.ops.orb_descriptor import (
    BLUR_PAD,
    HALF_PATCH,
    binned_brief,
    blur_patches,
    extract_patches,
    ic_angle_from_patches,
)
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import device_constant, top_k


@dataclasses.dataclass
class Features:
    """Fixed-capacity keypoint set; leading dim K = OrbConfig.max_keypoints."""

    uv: torch.Tensor  # (K, 2) float32, level-0 pixel coords [x, y]
    level: torch.Tensor  # (K,) int64 pyramid level
    angle: torch.Tensor  # (K,) float32 radians
    score: torch.Tensor  # (K,) float32 FAST corner score
    desc: torch.Tensor  # (K, 8) int32 (uint32 bit patterns)
    valid: torch.Tensor  # (K,) bool

    @property
    def capacity(self) -> int:
        return self.uv.shape[0]

    def map(self, fn) -> "Features":
        return Features(**{f.name: fn(getattr(self, f.name)) for f in dataclasses.fields(self)})


@device_constant
def _level_scales(scale_factor: float, n_levels: int) -> np.ndarray:
    return np.array([scale_factor**i for i in range(n_levels)], np.float32)


def scale_factors(cfg: OrbConfig, device=None) -> torch.Tensor:
    """(L,) per-level scale (1.2^l): Python's double power rounded to f32,
    built once per device and shared (never written into)."""
    return _level_scales(cfg.scale_factor, cfg.n_levels, device=device)


def sigma2_per_level(cfg: OrbConfig, device=None) -> torch.Tensor:
    """(L,) per-level variance scale^2l (the reference's mvLevelSigma2),
    the measurement covariance that weights BA residuals."""
    return scale_factors(cfg, device) ** 2


def extract(img: torch.Tensor, cfg: OrbConfig) -> Features:
    """ORB features of a gray image (H, W) float32 in [0, 255]; coordinates
    in level-0 pixels with the half-pixel-centre level mapping."""
    dev = img.device
    h, w = img.shape
    quotas = select_ops.level_quotas(cfg.n_features, cfg.n_levels, cfg.scale_factor)
    levels = image_ops.build_pyramid(img, cfg.n_levels, cfg.scale_factor)

    uv_all, lvl_all, score_all, valid_all, patches_all = [], [], [], [], []
    for lvl, (lv_img, quota) in enumerate(zip(levels, quotas)):
        score_raw = fast_ops.fast_score_map(lv_img)
        score = fast_ops.nms3x3(score_raw)
        uv, s, valid = select_ops.select_keypoints(
            score, float(cfg.ini_th_fast), float(cfg.min_th_fast),
            cell_size=cfg.cell_size, max_per_cell=cfg.max_per_cell,
            quota=max(quota, 1), border=cfg.edge_threshold,
        )
        uv = select_ops.subpixel_refine(score_raw, uv, valid)
        patches_all.append(extract_patches(lv_img, uv, half=HALF_PATCH + BLUR_PAD))
        lh, lw = lv_img.shape
        sx = w / lw
        sy = h / lh
        uv_base = torch.stack([(uv[:, 0] + 0.5) * sx - 0.5, (uv[:, 1] + 0.5) * sy - 0.5], dim=-1)
        uv_all.append(torch.where(valid[:, None], uv_base, torch.zeros_like(uv_base)))
        lvl_all.append(torch.full((uv.shape[0],), lvl, dtype=torch.int64, device=dev))
        score_all.append(s)
        valid_all.append(valid)

    patches_raw = torch.cat(patches_all, dim=0)  # (N, 37, 37)
    valid = torch.cat(valid_all, dim=0)
    ang = ic_angle_from_patches(patches_raw[:, BLUR_PAD:-BLUR_PAD, BLUR_PAD:-BLUR_PAD], valid)
    desc = binned_brief(blur_patches(patches_raw), ang, valid)
    feats = Features(
        uv=torch.cat(uv_all, dim=0),
        level=torch.cat(lvl_all, dim=0),
        angle=ang,
        score=torch.cat(score_all, dim=0),
        desc=desc,
        valid=valid,
    )

    k = cfg.max_keypoints
    n = feats.capacity
    if n < k:
        pad = k - n

        def pad_rows(a):
            return torch.cat([a, torch.zeros((pad,) + a.shape[1:], dtype=a.dtype, device=dev)])

        feats = feats.map(pad_rows)
    elif n > k:
        key = torch.where(feats.valid, feats.score, torch.full_like(feats.score, -float("inf")))
        _, idx = top_k(key, k)
        feats = feats.map(lambda a: a[idx])
    return feats
