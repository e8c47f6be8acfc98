"""Per-keyframe point clouds and the ground split (counterpart of the JAX
package's `dense/pointcloud.py`, MapDrawer::GeneratePointCloud,
perfect/src/MapDrawer.cc:641-939): an organized world-frame cloud from a
keyframe's depth with the reference's gates (depth 0.5-4 m, |y| < 3 m,
stride decimation), and a RANSAC split of the ground from the rest by
heights along the gravity axis, all hypotheses scored in one (S, N)
residual matrix.

Sampling is split from scoring, as in `ops/homography.py`: JAX draws the
hypotheses with `jax.random.categorical` from a key split per keyframe;
`sample_ground_hypotheses` draws the same distribution (uniform over the
valid points, with replacement) from an explicit CPU `torch.Generator`,
so the CPU and the card see the same points, and `split_ground` takes the
indices, so the tests can hand it JAX's own draws.
"""

from __future__ import annotations

import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, DenseMapConfig
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import f32_reciprocal, valid_rows


def keyframe_cloud(depth_img: torch.Tensor, T_cw: torch.Tensor, cam: CameraConfig,
                   cfg: DenseMapConfig = DenseMapConfig(), gray_img: torch.Tensor | None = None):
    """(N, 3) world points and (N,) valid mask (and (N, 3) gray colors
    when `gray_img` is given) of the stride-decimated depth image in
    metres. The division by the focal length is a product with its f32
    reciprocal, as XLA compiles the JAX version under `jit`."""
    s = cfg.cloud_stride
    d = depth_img[::s, ::s].to(torch.float32)
    h, w = d.shape
    ys = (torch.arange(h, dtype=torch.float32, device=d.device) * s)[:, None]
    xs = (torch.arange(w, dtype=torch.float32, device=d.device) * s)[None, :]
    z = d
    x = (xs - cam.cx) * f32_reciprocal(cam.fx) * z
    y = (ys - cam.cy) * f32_reciprocal(cam.fy) * z
    ok = (z > cfg.cloud_min_depth) & (z < cfg.cloud_max_depth) & (torch.abs(y) < cfg.cloud_max_y)
    pts_c = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    pts_w = se3.transform_points(se3.se3_inverse(T_cw.to(torch.float32)), pts_c)
    if gray_img is not None:
        g = gray_img[::s, ::s].reshape(-1).to(torch.float32)
        return pts_w, ok.reshape(-1), torch.stack([g, g, g], dim=-1)
    return pts_w, ok.reshape(-1)


def sample_ground_hypotheses(valid: torch.Tensor, n_hypotheses: int,
                             generator: torch.Generator) -> torch.Tensor:
    """(S,) int64 point indices, uniform over the points where `valid` is
    set, with replacement; the uniforms come from `generator`, a CPU
    generator, so every device sees the same draws
    (`tensor_ops.valid_rows`)."""
    u = torch.rand((n_hypotheses,), generator=generator, dtype=torch.float32)
    return valid_rows(u, valid)


def split_ground(pts_w: torch.Tensor, valid: torch.Tensor, idx: torch.Tensor, up_axis: int = 1,
                 cfg: DenseMapConfig = DenseMapConfig()):
    """RANSAC ground split on the hypotheses `idx` (S,). Returns
    (is_ground (N,), plane (4,)).

    A hypothesis is the height of a valid point along `up_axis` (the
    reference's plane perpendicular to gravity, MapDrawer.cc:855-866); a
    ground plane must sit more than `ground_min_offset` from the camera
    plane (MapDrawer.cc:900-905). With no qualifying hypothesis nothing is
    ground."""
    up = pts_w[:, up_axis]
    heights = up[idx]  # (S,)
    resid = torch.abs(up[None, :] - heights[:, None])  # (S, N)
    counts = ((resid < cfg.ground_inlier_threshold) & valid[None, :]).sum(-1)
    counts = torch.where(torch.abs(heights) > cfg.ground_min_offset, counts,
                         torch.full_like(counts, -1))
    best = torch.argmax(counts)
    h_best = heights[best]
    is_ground = (torch.abs(up - h_best) < cfg.ground_inlier_threshold) & valid
    plane = torch.zeros((4,), dtype=torch.float32, device=pts_w.device)
    plane[up_axis] = 1.0
    plane[3] = -h_best
    return is_ground & (counts[best] > 0), plane
