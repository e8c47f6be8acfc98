"""Optical-flow dynamic-pixel mask (counterpart of the JAX package's
`dynamic/flowmask.py`, the reference's Flow::ComputeMask, Flow.cc:14-80):

  1. (optional) warp the current image by an ego-motion homography;
  2. downsample by `flow_downscale`;
  3. dense flow against the previous frame (`ops/flow.py`);
  4. threshold the squared flow magnitude at max(flow, floor) / s²;
  5. erode twice, dilate once with an ellipse of `flow_morph_kernel / s`;
  6. upsample the static mask to full resolution.

The masks are (H, W) bool, True = STATIC (keep), the reference's
convention: keypoints on dynamic pixels are dropped (Frame.cc:356-374).
"""

from __future__ import annotations

import torch

from orb_slam2_ssd_semantic_tpu_torch.config import DynamicConfig
from orb_slam2_ssd_semantic_tpu_torch.ops import flow as flow_ops
from orb_slam2_ssd_semantic_tpu_torch.ops import image as image_ops
from orb_slam2_ssd_semantic_tpu_torch.ops.homography import (
    apply_homography,
    find_homography_ransac,
)


def _grid_points(h: int, w: int, device) -> torch.Tensor:
    """(h * w, 2) pixel coordinates (x, y), row-major."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys], dim=-1).reshape(-1, 2)


def downscaled_flow(prev_gray, cur_gray, cfg: DynamicConfig) -> torch.Tensor:
    """Dense flow between the two images downsampled by `flow_downscale`
    (the reference's pyrDown, Flow.cc:21), (H / s, W / s, 2)."""
    s = cfg.flow_downscale
    h, w = cur_gray.shape
    ph = image_ops.resize_linear(prev_gray, h // s, w // s)
    ch = image_ops.resize_linear(cur_gray, h // s, w // s)
    return flow_ops.dense_flow(ph, ch, levels=cfg.flow_levels, window=cfg.flow_window,
                               iters=cfg.flow_iters)


def _static_from_mag2(mag2: torch.Tensor, cfg: DynamicConfig, h: int, w: int) -> torch.Tensor:
    """Threshold (the reference's floor rule, Flow.cc:33-38), morphology,
    and the full-resolution static mask."""
    s = cfg.flow_downscale
    dynamic = mag2 > max(cfg.flow_threshold, cfg.flow_threshold_floor) / (s * s)
    k = max(3, cfg.flow_morph_kernel // s)
    dynamic = image_ops.erode(dynamic, k, iterations=2)
    dynamic = image_ops.dilate(dynamic, k, iterations=1)
    return image_ops.resize_linear((~dynamic).to(torch.float32), h, w) > 0.5


def flow_dynamic_mask(prev_gray: torch.Tensor, cur_gray: torch.Tensor,
                      cfg: DynamicConfig = DynamicConfig(),
                      homography: torch.Tensor | None = None) -> torch.Tensor:
    """(H, W) bool static mask from flow consistency; with `homography`,
    the current frame is first sampled at H(p) so static pixels align
    with the previous frame."""
    h, w = cur_gray.shape
    prev_gray = prev_gray.to(torch.float32)
    cur = cur_gray.to(torch.float32)
    if homography is not None:
        src = apply_homography(homography, _grid_points(h, w, cur.device))
        vals, _ = image_ops.bilinear_sample(cur, src)
        cur = vals.reshape(h, w)
    f = downscaled_flow(prev_gray, cur, cfg)
    return _static_from_mag2(flow_ops.flow_magnitude_sq(f), cfg, h, w)


def grid_correspondences(f: torch.Tensor, grid_stride: int = 8):
    """The ego-motion fit's correspondences from a flow field f (h, w, 2):
    grid points x every `grid_stride` px and x + f(x), valid where x + f(x)
    stays 2 px inside the image. Returns (src, dst (N, 2), valid (N,))."""
    hs, ws = f.shape[:2]
    gy = torch.arange(0, hs - grid_stride + 1, grid_stride, device=f.device)
    gx = torch.arange(0, ws - grid_stride + 1, grid_stride, device=f.device)
    yy, xx = torch.meshgrid(gy, gx, indexing="ij")
    yy, xx = yy.reshape(-1), xx.reshape(-1)
    src = torch.stack([xx, yy], dim=-1).to(torch.float32)
    dst = src + f[yy, xx]
    margin = 2.0
    valid = ((dst[:, 0] >= margin) & (dst[:, 0] < ws - margin)
             & (dst[:, 1] >= margin) & (dst[:, 1] < hs - margin))
    return src, dst, valid


def flow_dynamic_mask_fitted(prev_gray: torch.Tensor, cur_gray: torch.Tensor,
                             cfg: DynamicConfig = DynamicConfig(), grid_stride: int = 8,
                             idx: torch.Tensor | None = None) -> torch.Tensor:
    """(H, W) bool static mask with an ego-motion homography FITTED to the
    flow itself: grid points (x, x + flow(x)) feed the RANSAC homography
    (`idx`: its (S, 4) minimal sets, default `sample_minimal_sets` seeded
    0), the identity replaces a fit of fewer than 20 inliers, and the
    dynamic test thresholds the residual flow ||flow(x) - (Hx - x)||²."""
    h, w = cur_gray.shape
    f = downscaled_flow(prev_gray.to(torch.float32), cur_gray.to(torch.float32), cfg)
    hs, ws = f.shape[:2]
    src, dst, valid = grid_correspondences(f, grid_stride)
    H, _, n_inl = find_homography_ransac(src, dst, valid, idx=idx, threshold=2.0)
    # A degenerate fit falls back to the raw-flow threshold (the
    # reference's no-homography Flow::ComputeMask path).
    H = torch.where(n_inl >= 20, H, torch.eye(3, dtype=torch.float32, device=f.device))

    grid = _grid_points(hs, ws, f.device)
    resid = f - (apply_homography(H, grid) - grid).reshape(hs, ws, 2)
    mag2 = resid[..., 0] ** 2 + resid[..., 1] ** 2
    return _static_from_mag2(mag2, cfg, h, w)


def static_area_fraction(mask: torch.Tensor) -> torch.Tensor:
    """Fraction of static pixels; the frame applies a mask only if at
    least `min_static_area` of the image is static (Frame.cc:357-374)."""
    return mask.to(torch.float32).mean()
