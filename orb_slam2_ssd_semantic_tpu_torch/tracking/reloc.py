"""Relocalization: recover the camera pose after tracking loss
(counterpart of the JAX package's `tracking/reloc.py`).

Equivalent of Tracking::Relocalization (perfect/src/Tracking.cc:
2714-2889): retrieve candidate keyframes by appearance
(DetectRelocalizationCandidates), match descriptors against each
candidate, solve the pose robustly, refine with motion-only BA, accept
at >= min_inliers_reloc (50).

An RGB-D frame carries depth for its keypoints, so the 2D-3D problem
becomes 3D-3D rigid alignment (`geometry/ransac3d.py`); a frame with too
few depth keypoints takes the 2D-3D path, EPnP RANSAC against the
candidate keyframe's map points (`geometry/epnp.py`). Each candidate's
random minimal sets come from a generator seeded with the candidate's
slot, on the frame's device: the same seeds as the JAX package's
`PRNGKey(kf)`, but another random stream.

Profiler ranges `reloc.candidates`, `reloc.match`, `reloc.ransac` and
`reloc.pose_optimize` split a call for `chip_smoke.py`'s breakdown; with
no profiler running they cost about 10 us each on the host.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.frontend.extractor import scale_factors
from orb_slam2_ssd_semantic_tpu_torch.geometry import camera as cam_ops
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.geometry.epnp import ransac_epnp
from orb_slam2_ssd_semantic_tpu_torch.geometry.ransac3d import ransac_rigid
from orb_slam2_ssd_semantic_tpu_torch.mapping import place_recognition as pr
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import SlamState
from orb_slam2_ssd_semantic_tpu_torch.ops import match as match_ops
from orb_slam2_ssd_semantic_tpu_torch.tracking.pose_opt import pose_optimize
from orb_slam2_ssd_semantic_tpu_torch.utils import precision


def _candidates(state: SlamState, frame, bow_db, max_candidates: int):
    """(ids, ok) numpy: the best-scoring database keyframes."""
    if hasattr(bow_db, "frame_scores"):  # LoopCloser (either backend)
        scores = bow_db.frame_scores(frame.feats.desc, frame.feats.valid)
        s = np.where(state.kfs.valid.cpu().numpy(), scores, -1.0)
        ids = np.argsort(-s)[:max_candidates]  # numpy's default sort, as the JAX package
        return ids, s[ids] > 0.0
    F = bow_db.shape[0]
    ids, _, ok = pr.detect_candidates(
        pr.bow_vector(frame.feats.desc, frame.feats.valid), bow_db, state.kfs.valid,
        torch.zeros((F,), dtype=torch.bool, device=bow_db.device), 0.0,
        max_candidates=max_candidates)
    return ids.cpu().numpy(), ok.cpu().numpy()


@precision.scoped
def relocalize(state: SlamState, frame, bow_db, cfg: SlamConfig, max_candidates: int = 3):
    """Try to relocalize `frame` (a `tracking.tracker.Frame`) against the
    keyframe database `bow_db`: a `LoopCloser`, or an (F, VOCAB_SIZE)
    flat-codebook array. Returns (success, T_cw (4, 4), n_inliers)."""
    cam = cfg.camera
    dev = frame.feats.uv.device
    with record_function("reloc.candidates"):
        ids, ok = _candidates(state, frame, bow_db, max_candidates)

    feats = frame.feats
    pf = cam_ops.backproject(feats.uv, frame.kp_depth, cam)
    vf = feats.valid & frame.is_stereo
    sf = scale_factors(cfg.orb, dev)
    inv_sigma2 = 1.0 / (sf[feats.level.clamp(0, sf.shape[0] - 1)] ** 2)
    # Monocular frames have no keypoint depth: 3D-3D alignment is
    # impossible, so fall back to true 2D-3D EPnP against map points.
    use_epnp = int(vf.sum()) < 3 * cfg.loop.sim3_min_inliers
    P = state.points.pos.shape[0]

    best = (False, torch.eye(4, dtype=torch.float32, device=dev), 0)
    for c in range(len(ids)):
        if not ok[c]:
            continue
        kf = int(ids[c])
        gen = torch.Generator(device=dev)
        gen.manual_seed(kf)
        with record_function("reloc.match"):
            dist = match_ops.hamming_matrix(feats.desc, state.kfs.desc[kf])
            if use_epnp:
                pid = state.kfs.kp_point[kf]
                vk = state.kfs.kp_valid[kf] & (pid >= 0)
                m = match_ops.masked_best_match(dist, feats.valid[:, None] & vk[None, :],
                                                max_dist=match_ops.TH_LOW, ratio=0.75,
                                                mutual=True)
                pk_world = state.points.pos[pid.clamp(0, P - 1)][m.idx.clamp(0, pid.shape[0] - 1)]
            else:
                vk = state.kfs.kp_valid[kf] & (state.kfs.depth[kf] > 0)
                m = match_ops.masked_best_match(dist, vf[:, None] & vk[None, :],
                                                max_dist=match_ops.TH_LOW, ratio=0.75,
                                                mutual=True)
                # Frame keypoints' 3D (frame camera) vs matched keyframe
                # keypoints' 3D (world, via the keyframe's pose and depth).
                pk_cam = cam_ops.backproject(state.kfs.uv[kf], state.kfs.depth[kf], cam)
                pk_world_all = se3.transform_points(se3.se3_inverse(state.kfs.T_cw[kf]), pk_cam)
                pk_world = pk_world_all[m.idx.clamp(0, pk_world_all.shape[0] - 1)]
        with record_function("reloc.ransac"):
            if use_epnp:
                R, t, inl, n_inl = ransac_epnp(pk_world, feats.uv, m.valid, gen, cam)
            else:
                # dst = frame-camera points, src = world points -> T_cw estimate.
                _, R, t, inl, n_inl = ransac_rigid(pk_world, pf, m.valid, gen, threshold=0.10,
                                                   with_scale=False)
            n_inl = int(n_inl)
        if n_inl < cfg.loop.sim3_min_inliers:
            continue
        # Reprojection refinement on the matched pairs.
        with record_function("reloc.pose_optimize"):
            res = pose_optimize(se3.rt_to_mat(R, t), pk_world, frame.obs_uvr, inv_sigma2,
                                frame.is_stereo, m.valid & inl, cam, cfg.optimizer)
            n = int(res.num_inliers)
        if n >= cfg.tracking.min_inliers_reloc and n > best[2]:
            best = (True, res.T_cw, n)
    return best
