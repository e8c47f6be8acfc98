"""Multi-view geometry dynamic-pixel mask, the DynaSLAM method (counterpart
of the JAX package's `dynamic/geommask.py`, the reference's
Geometry::GeometricModelCorrection, Geometry.cc:50-518).

A ring buffer holds recent keyframe views. For the current frame the
`geom_ref_frames` best views by 0.7·distance + 0.3·rotation are chosen
(Geometry.cc:83-127); each view's keypoints are back-projected with
their depth and reprojected into the current frame, and a point is
dynamic where the projected depth exceeds the measured one by more than
`geom_depth_diff_th` with a low local depth variance (Geometry.cc:136-471:
depth gates, parallax under 30 degrees, the image border). Each dynamic
point seeds a depth-conditioned region growing over the depth image
(DepthRegionGrowing, Geometry.cc:475-518), and the grown mask is dilated.

Returns (H, W) bool, True = STATIC.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, DynamicConfig
from orb_slam2_ssd_semantic_tpu_torch.geometry import camera as cam_ops
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.ops import image as image_ops
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import last_write_wins, top_k


@dataclasses.dataclass
class GeomRefViews:
    """Fixed-capacity ring buffer of reference views (Geometry.h:19,
    vector<DynKeyFrame> of 20)."""

    T_cw: torch.Tensor  # (D, 4, 4)
    uv: torch.Tensor  # (D, K, 2) keypoint pixel coords
    depth: torch.Tensor  # (D, K) keypoint depths
    kp_valid: torch.Tensor  # (D, K) bool
    valid: torch.Tensor  # (D,) bool
    cursor: torch.Tensor  # () int64 ring position


def empty_ref_views(db_size: int, max_kps: int, device=None) -> GeomRefViews:
    return GeomRefViews(
        T_cw=torch.eye(4, dtype=torch.float32, device=device).repeat(db_size, 1, 1),
        uv=torch.zeros((db_size, max_kps, 2), dtype=torch.float32, device=device),
        depth=torch.zeros((db_size, max_kps), dtype=torch.float32, device=device),
        kp_valid=torch.zeros((db_size, max_kps), dtype=torch.bool, device=device),
        valid=torch.zeros((db_size,), dtype=torch.bool, device=device),
        cursor=torch.zeros((), dtype=torch.int64, device=device),
    )


def insert_ref_view(db: GeomRefViews, T_cw, uv, depth, kp_valid) -> GeomRefViews:
    """Ring-buffer insert (GeometricModelUpdateDB, Geometry.cc:532-546).
    Returns a new database; `db` is left as it was."""
    at = torch.arange(db.valid.shape[0], device=db.valid.device) == db.cursor % db.valid.shape[0]

    def put(old, new):
        return torch.where(at.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)

    return GeomRefViews(
        T_cw=put(db.T_cw, T_cw), uv=put(db.uv, uv), depth=put(db.depth, depth),
        kp_valid=put(db.kp_valid, kp_valid), valid=db.valid | at, cursor=db.cursor + 1)


def geometry_dynamic_mask(db: GeomRefViews, T_cw: torch.Tensor, depth_img: torch.Tensor,
                          cam: CameraConfig, cfg: DynamicConfig = DynamicConfig(),
                          n_refs: int | None = None) -> torch.Tensor:
    """(H, W) bool static mask for the current frame at pose `T_cw`."""
    h, w = depth_img.shape
    depth_img = depth_img.to(torch.float32)
    R = n_refs or cfg.geom_ref_frames

    # ---- reference views by 0.7*dist + 0.3*rot (Geometry.cc:83-127) ------
    T_wc = se3.se3_inverse(T_cw)
    Rdb = db.T_cw[:, :3, :3]
    centers = -(Rdb.transpose(1, 2) @ db.T_cw[:, :3, 3:4])[..., 0]
    c_cur = T_wc[:3, 3]
    dist = torch.linalg.norm(centers - c_cur, dim=-1)
    rel_R = Rdb @ T_wc[:3, :3]
    tr = rel_R[:, 0, 0] + rel_R[:, 1, 1] + rel_R[:, 2, 2]
    rot = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    score = torch.where(db.valid, 0.7 * dist + 0.3 * rot, torch.full_like(dist, math.inf))
    _, ref_ids = top_k(-score, R)
    ref_ok = torch.isfinite(score[ref_ids])

    # ---- batched backproject/reproject (Geometry.cc:136-471) -------------
    uv_r = db.uv[ref_ids]  # (R, K, 2)
    d_r = db.depth[ref_ids]  # (R, K)
    kv_r = db.kp_valid[ref_ids] & ref_ok[:, None]
    T_r = db.T_cw[ref_ids]
    T_wr = se3.se3_inverse(T_r)

    pts_c = cam_ops.backproject(uv_r, d_r, cam)  # (R, K, 3) in the reference cameras
    pc = se3.transform_points(T_cw[None] @ T_wr, pts_c)  # in the current camera
    uv_c, z_proj = cam_ops.project(pc, cam)
    usable = (kv_r & (d_r > 1e-3) & (d_r < cfg.geom_max_ref_depth)
              & (z_proj > 1e-3) & (z_proj < cfg.geom_max_cur_depth)
              & cam_ops.in_image(uv_c, cam, border=cfg.geom_border))

    # Parallax gate (Geometry.cc:211-228): the angle between the two
    # viewing rays of the point.
    pts_w = se3.transform_points(T_wr, pts_c)
    v1 = pts_w - centers[ref_ids][:, None, :]
    v2 = pts_w - c_cur[None, None, :]
    cosang = (v1 * v2).sum(-1) / (torch.linalg.norm(v1, dim=-1) * torch.linalg.norm(v2, dim=-1)
                                  + 1e-9)
    usable = usable & (cosang > math.cos(math.radians(cfg.geom_max_parallax_deg)))

    # Patch mean and variance maps of the valid depth (the batched form of
    # the reference's per-point 20x20 scan, Geometry.cc:378-461).
    valid_d = (depth_img > 1e-3).to(torch.float32)
    p = cfg.geom_patch_size | 1
    mean_num = image_ops.box_filter(depth_img * valid_d, p)
    mean_den = image_ops.box_filter(valid_d, p)
    mean_map = mean_num / torch.clamp(mean_den, min=1e-6)
    var_map = image_ops.box_filter((depth_img - mean_map) ** 2 * valid_d, p) / torch.clamp(
        mean_den, min=1e-6)

    d_meas, meas_ok = image_ops.nearest_sample(depth_img, uv_c)
    var_at, _ = image_ops.nearest_sample(var_map, uv_c)
    # Dynamic: the projected depth lies behind the measured one (something
    # moved in front of the old surface) where the local depth is smooth.
    dynamic_pt = (usable & meas_ok & (d_meas > 1e-3)
                  & ((z_proj - d_meas) > cfg.geom_depth_diff_th)
                  & (var_at < cfg.geom_patch_var_th))

    # ---- seeds + depth-conditioned region growing -------------------------
    dyn = dynamic_pt.reshape(-1)
    xi = torch.round(uv_c[..., 0]).to(torch.int64).clamp(0, w - 1).reshape(-1)
    yi = torch.round(uv_c[..., 1]).to(torch.int64).clamp(0, h - 1).reshape(-1)
    ref_d, seeds = last_write_wins(yi * w + xi, dyn, d_meas.reshape(-1), h * w)
    ref_d, seeds = ref_d.reshape(h, w), seeds.reshape(h, w)

    # Per iteration: a 3x3 dilation of (mask, reference depth); a neighbour
    # grows into a pixel of valid depth within `geom_grow_threshold` of the
    # neighbour's reference depth, and a newly reached pixel takes its own
    # depth as its reference.
    depth_ok = depth_img > 1e-3
    mask = seeds
    for _ in range(cfg.geom_grow_iters):
        mp = torch.nn.functional.pad(mask.to(torch.float32), (1, 1, 1, 1))
        dp = torch.nn.functional.pad(ref_d, (1, 1, 1, 1))
        nb_m = torch.stack([mp[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]) > 0.5
        nb_d = torch.stack([dp[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)])
        grow = (nb_m & (torch.abs(depth_img - nb_d) < cfg.geom_grow_threshold)).any(0) & depth_ok
        ref_d = torch.where(grow & (ref_d == 0.0), depth_img, ref_d)
        mask = mask | grow
    dynamic = image_ops.dilate(mask, max(3, cfg.geom_dilate_kernel // 4), iterations=1)
    return ~dynamic
