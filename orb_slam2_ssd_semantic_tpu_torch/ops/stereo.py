"""Rectified stereo keypoint matching to per-keypoint depth (counterpart of
the JAX package's `ops/stereo.py`; Frame::ComputeStereoMatches, reference
perfect/src/Frame.cc, Frame.h:94).

For every left keypoint, the best Hamming match among the right keypoints
in the same row band (+-2 px scaled by the right keypoint's pyramid
level), one level apart at most, inside the disparity range; depth is
bf / disparity. One masked (K, K) distance problem, the band and bounds
its mask. The reference's SAD sub-pixel refinement is left out, as in the
JAX version (keypoints are refined at detection).
"""

from __future__ import annotations

import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, OrbConfig
from orb_slam2_ssd_semantic_tpu_torch.frontend.extractor import Features, scale_factors
from orb_slam2_ssd_semantic_tpu_torch.ops import match as match_ops


def stereo_match(feats_l: Features, feats_r: Features, cam: CameraConfig, orb: OrbConfig,
                 max_dist: int = (match_ops.TH_HIGH + match_ops.TH_LOW) // 2):
    """Returns (depth (K,), ur (K,), valid (K,)) for the left keypoints.
    Disparities lie in [0.3, fx] (the reference's maxD = bf / minZ with
    minZ the baseline; the floor keeps depth finite)."""
    sf = scale_factors(orb, feats_l.uv.device)
    max_disp = cam.fx
    min_disp = 0.3
    band = 2.0 * sf[feats_r.level.clamp(0, orb.n_levels - 1)]  # (K,)
    uv_l, uv_r = feats_l.uv, feats_r.uv
    dv = torch.abs(uv_l[:, None, 1] - uv_r[None, :, 1])
    disp = uv_l[:, None, 0] - uv_r[None, :, 0]
    lvl_ok = torch.abs(feats_l.level[:, None] - feats_r.level[None, :]) <= 1
    mask = ((dv <= band[None, :]) & (disp >= min_disp) & (disp <= max_disp) & lvl_ok
            & feats_l.valid[:, None] & feats_r.valid[None, :])
    dist = match_ops.hamming_matrix(feats_l.desc, feats_r.desc)
    m = match_ops.masked_best_match(dist, mask, max_dist=max_dist)
    j = m.idx.clamp(0, uv_r.shape[0] - 1)
    d = uv_l[:, 0] - uv_r[j, 0]
    ok = m.valid & (d >= min_disp)
    # f32(bf) / d, as JAX divides (a Python number over a tensor would be
    # the tensor's reciprocal times the number in torch).
    depth = torch.where(ok, torch.full_like(d, cam.bf) / torch.clamp(d, min=min_disp),
                        torch.zeros_like(d))
    ur = torch.where(ok, uv_r[j, 0], torch.full_like(d, -1.0))
    return depth, ur, ok


def sparse_depth_image(uv: torch.Tensor, depth: torch.Tensor, ok: torch.Tensor,
                       cam: CameraConfig) -> torch.Tensor:
    """(H, W) depth image holding each matched keypoint's depth at its
    rounded pixel, 0 elsewhere. Where keypoints share a pixel the later
    keypoint's depth wins: XLA's CPU scatter lets the last write win; here
    the rule is explicit and independent of the device's write order."""
    from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import last_write_wins

    x = torch.round(uv[:, 0]).to(torch.int64)
    y = torch.round(uv[:, 1]).to(torch.int64)
    inside = ok & (x >= 0) & (x < cam.width) & (y >= 0) & (y < cam.height)
    img, _ = last_write_wins(y * cam.width + x, inside, depth, cam.height * cam.width)
    return img.reshape(cam.height, cam.width)
