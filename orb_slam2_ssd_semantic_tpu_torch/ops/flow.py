"""Dense optical flow as iterative pyramidal Lucas-Kanade (counterpart of
the JAX package's `ops/flow.py`, its stand-in for the reference's
cv::calcOpticalFlowFarneback, Flow.cc:26).

Per level, a fixed number of Gauss-Newton updates of the flow field from
window-averaged structure tensors (box filters), coarse to fine with the
flow upsampled between levels. The output is an (H, W, 2) flow in pixels:
position in `prev` + flow = position in `cur`.

The JAX version's `_shift_warp` evaluates bilinear sampling at a bounded
residual as a sum of (2 r_max + 2)² shifted slices, so that the TPU needs
no gather. On the card the same function is one gather of the four taps
at x + clip(r), edge-clamped, with the JAX version's hat weights and its
order of summation. Its `_box_filter_batch` is `ops/image.box_filter`,
which filters the last two axes of a (C, H, W) stack.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch.ops import image as image_ops


def _pixel_grid(h: int, w: int, device):
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return xs, ys


def _warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Sample img at (x + flow_x, y + flow_y), bilinear, edge-clamped."""
    h, w = img.shape
    xs, ys = _pixel_grid(h, w, img.device)
    u = torch.clamp(xs + flow[..., 0], 0.0, w - 1.0)
    v = torch.clamp(ys + flow[..., 1], 0.0, h - 1.0)
    vals, _ = image_ops.bilinear_sample(img, torch.stack([u, v], dim=-1).reshape(-1, 2))
    return vals.reshape(h, w)


def _shift_warp(img: torch.Tensor, res: torch.Tensor, r_max: int) -> torch.Tensor:
    """out(x) = bilinear(img, x + clip(res(x), ±r_max)) with edge-clamped
    taps. The weights are the JAX version's hats max(0, 1 - |r - d|) at
    the two integer neighbours d of each axis, summed in its order: the
    x taps of each row first, then the two rows."""
    h, w = img.shape
    u = torch.clamp(res[..., 0], -r_max, r_max)
    v = torch.clamp(res[..., 1], -r_max, r_max)
    dx0 = torch.floor(u)
    dy0 = torch.floor(v)
    wx0 = torch.clamp(1.0 - torch.abs(u - dx0), 0.0, 1.0)
    wx1 = torch.clamp(1.0 - torch.abs(u - (dx0 + 1.0)), 0.0, 1.0)
    wy0 = torch.clamp(1.0 - torch.abs(v - dy0), 0.0, 1.0)
    wy1 = torch.clamp(1.0 - torch.abs(v - (dy0 + 1.0)), 0.0, 1.0)
    xs = torch.arange(w, device=img.device)[None, :] + dx0.to(torch.int64)
    ys = torch.arange(h, device=img.device)[:, None] + dy0.to(torch.int64)
    x0, x1 = xs.clamp(0, w - 1), (xs + 1).clamp(0, w - 1)
    y0, y1 = ys.clamp(0, h - 1), (ys + 1).clamp(0, h - 1)
    row0 = wx0 * img[y0, x0] + wx1 * img[y0, x1]
    row1 = wx0 * img[y1, x0] + wx1 * img[y1, x1]
    return wy0 * row0 + wy1 * row1


def _lk_level(prev, cur, flow, window: int, iters: int, eps: float = 1e-4,
              r_max: int = 4, base_warp: bool = True):
    """Iterative LK refinement of `flow` on one level: the incoming flow
    is applied once as a general warp (skipped at the top level, where it
    is zero), then `iters` Gauss-Newton steps refine a residual bounded by
    ±r_max px (each step clamped to ±window)."""
    gx, gy = image_ops.sobel(prev)
    gx = gx / 8.0
    gy = gy / 8.0
    g_stack = image_ops.box_filter(torch.stack([gx * gx, gx * gy, gy * gy]), window)
    ixx, ixy, iyy = g_stack[0], g_stack[1], g_stack[2]
    det = ixx * iyy - ixy * ixy
    det_safe = torch.where(torch.abs(det) < eps, torch.full_like(det, eps), det)
    ok = (torch.abs(det) > eps).to(torch.float32)

    warped_base = _warp(cur, flow) if base_warp else cur
    r = torch.zeros_like(flow)
    for _ in range(iters):
        it = _shift_warp(warped_base, r, r_max) - prev
        t_stack = image_ops.box_filter(torch.stack([gx * it, gy * it]), window)
        ixt, iyt = t_stack[0], t_stack[1]
        du = -(iyy * ixt - ixy * iyt) / det_safe
        dv = -(ixx * iyt - ixy * ixt) / det_safe
        step = torch.clamp(torch.stack([du * ok, dv * ok], dim=-1), -window, window)
        r = torch.clamp(r + step, -float(r_max), float(r_max))
    return flow + r


def dense_flow(prev: torch.Tensor, cur: torch.Tensor, levels: int = 3, window: int = 9,
               iters: int = 5) -> torch.Tensor:
    """Dense flow prev -> cur, (H, W, 2) float32 pixels."""
    prevs = image_ops.build_pyramid(prev, levels, 2.0)
    curs = image_ops.build_pyramid(cur, levels, 2.0)
    h_top, w_top = prevs[-1].shape
    flow = torch.zeros((h_top, w_top, 2), dtype=torch.float32, device=prev.device)
    for lvl in range(levels - 1, -1, -1):
        if lvl < levels - 1:
            h, w = prevs[lvl].shape
            fh, fw = flow.shape[:2]
            # Per channel, each scaled by its f32 factor (no host copy).
            scale = np.float32([w / fw, h / fh])
            flow = torch.stack([image_ops.resize_linear(flow[..., c], h, w) * float(scale[c])
                                for c in range(2)], dim=-1)
        flow = _lk_level(prevs[lvl], curs[lvl], flow, window, iters,
                         base_warp=lvl < levels - 1)
    return flow


def flow_magnitude_sq(flow: torch.Tensor) -> torch.Tensor:
    return flow[..., 0] ** 2 + flow[..., 1] ** 2
