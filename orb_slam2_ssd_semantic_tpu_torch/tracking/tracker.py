"""RGB-D tracking with local mapping, loop closing and relocalization
(counterpart of the JAX package's `tracking/tracker.py`): frame build,
motion-model tracking, reference-keyframe fallback, local-map tracking,
keyframe insertion, and the host-side `Tracker` that sequences them, runs
loop closing (`mapping/loop_closing.py`) and local mapping per keyframe
and relocalizes a LOST frame (`tracking/reloc.py`).

The tracking step (`fused_track_step`) never reads the card on the host:
JAX's two `lax.cond`s in it (the doubled-window retry, the
reference-keyframe fallback) are `mapping/graph_cond.py::device_cond`s,
conditional nodes of the step's CUDA graph whose bodies run only on the
frames that take them, and the frame counter and reference inlier count
enter as device scalars. `Tracker.process` replays it from the tracker's
`TrackStepRunner` (`tracking/graphed_track.py`): on the card one CUDA
graph per kind of frame, captured at the first tracked frame (stage
`track.capture`), and
a tracked frame then makes its two image uploads, the copies into the
graph's inputs, one `cudaGraphLaunch` and one fetch of the packed stats
(stage `track`), as JAX's compiled step makes one transfer. Local mapping
goes through the tracker's `LocalMappingRunner`
(`mapping/graphed_step.py`) the same way: captured at the first keyframe
that maps (stage `local_mapping.capture`, whose first replay maps that
keyframe), replayed at every later one (stage `local_mapping`), and so
does keyframe insertion, as JAX jits it, through the tracker's
`InsertKeyframeRunner` (`tracking/graphed_track.py`; stage
`keyframe.insert`, one graph per `spawn_all`). Host reads per frame:
  - every tracked frame: 1, the packed per-frame stats;
  - a keyframe: the reference count after insertion, the retirement
    records (`_capture_retirements`) and +5 host mirrors, all before
    local mapping is dispatched; the full-store test in insertion is a
    select (JAX's `lax.cond`). Local mapping itself never waits on the
    card, so with `async_mapping` the frame goes on while it runs and
    the next frame's stats fetch is where the host meets it, as in JAX;
    with loop closing on, its database fetch, and past the recency gate
    the host copies of detection and, per candidate, of the transform
    estimate and the correction (`chip_smoke.py` phase 7 counts them);
  - a LOST frame (or WEAK, in localization-only mode): relocalization's
    candidate scores, and per candidate its RANSAC and refinement
    inlier counts.
  - a masked frame: none more. Each mask is replayed from a CUDA graph
    of the tracker's `MaskRunner` (`dynamic/graphed_masks.py`; stages
    `mask.flow` and `mask.geometry`, each graph captured once in stage
    `mask.capture`), as JAX jits each into a program of its own
    (`chip_smoke.py` phase 9c profiles a steady masked frame).
`chip_smoke.py` phase 4 counts the stream synchronisations of a steady
frame (one) and of a keyframe frame on the card, and those inside the
`local_mapping` range (none).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.frontend.extractor import Features, extract, scale_factors
from orb_slam2_ssd_semantic_tpu_torch.geometry import camera as cam_ops
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.mapping.graph_cond import device_cond
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import (
    SlamState,
    alloc_slots,
    covisibility_row,
    empty_state,
    push_retired,
)
from orb_slam2_ssd_semantic_tpu_torch.ops import image as image_ops
from orb_slam2_ssd_semantic_tpu_torch.ops import match as match_ops
from orb_slam2_ssd_semantic_tpu_torch.tracking.pose_opt import pose_optimize
from orb_slam2_ssd_semantic_tpu_torch.utils import precision
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import device_constant, row, scatter, top_k


@dataclasses.dataclass
class Frame:
    feats: Features
    kp_depth: torch.Tensor  # (K,) float32, 0 = no depth
    obs_uvr: torch.Tensor  # (K, 3) [u, v, uR]
    is_stereo: torch.Tensor  # (K,) bool


def _eye4(device) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=device)


@device_constant
def _f32_scalar(v: float) -> np.ndarray:
    return np.array(v, np.float32)


def depth_metres(depth_img: torch.Tensor) -> torch.Tensor:
    """float32 metres from uint16 millimetres; any other dtype is taken
    as metres."""
    if depth_img.dtype == torch.uint16:
        return depth_img.to(torch.float32) * 1e-3
    return depth_img.to(torch.float32)


def build_frame(gray: torch.Tensor, depth_img: torch.Tensor, cfg: SlamConfig,
                static_mask: torch.Tensor | None = None) -> Frame:
    """ORB extraction + keypoint depth association; with a dynamic-pixel
    mask, keypoints on dynamic pixels are dropped."""
    if gray.dtype != torch.float32:
        gray = gray.to(torch.float32)
    return frame_from_features(extract(gray, cfg.orb), depth_img, cfg, static_mask)


def frame_from_features(feats: Features, depth_img: torch.Tensor, cfg: SlamConfig,
                        static_mask: torch.Tensor | None = None) -> Frame:
    """Frame from already-extracted raw-pixel features: the dynamic mask
    (keypoints on pixels it marks dynamic are invalidated, unless less than
    `min_static_area` of the image is static, Frame.cc:357-374),
    undistortion and discontinuity-aware subpixel depth sampling."""
    depth_img = depth_metres(depth_img)
    if static_mask is not None:
        mf = static_mask.to(torch.float32)
        ms, _ = image_ops.nearest_sample(mf, feats.uv)
        apply = mf.mean() >= cfg.dynamic.min_static_area
        feats = dataclasses.replace(feats, valid=feats.valid & ((ms > 0.5) | ~apply))
    uv_ud = cam_ops.undistort_points(feats.uv, cfg.camera)
    feats = dataclasses.replace(
        feats, uv=torch.where(feats.valid[:, None], uv_ud, torch.zeros_like(uv_ud)))
    if cfg.tracking.subpixel_depth:
        d, dv = image_ops.robust_depth_sample(depth_img, feats.uv)
    else:
        d, dv = image_ops.nearest_sample(depth_img, feats.uv)
    kp_depth = torch.where(feats.valid & dv & (d > 1e-6), d, torch.zeros_like(d))
    ur = cam_ops.stereo_right_u(feats.uv, kp_depth, cfg.camera)
    obs = torch.cat([feats.uv, ur[:, None]], dim=-1)
    return Frame(feats, kp_depth, obs, kp_depth > 0)


@dataclasses.dataclass
class TrackResult:
    T_cw: torch.Tensor
    n_matches: torch.Tensor
    n_inliers: torch.Tensor
    kp_point: torch.Tensor  # (K,) int64 keypoint -> map point id


def _pose_from_matches(T0, pts_w, frame: Frame, m, cfg: SlamConfig):
    sf = scale_factors(cfg.orb, pts_w.device)
    K = frame.feats.capacity
    tgt = m.idx.clamp(0, K - 1)
    inv_sigma2 = 1.0 / (sf[frame.feats.level[tgt].clamp(0, sf.shape[0] - 1)] ** 2)
    res = pose_optimize(T0, pts_w, frame.obs_uvr[tgt], inv_sigma2, frame.is_stereo[tgt],
                        m.valid, cfg.camera, cfg.optimizer)
    return res, tgt


def track_motion_model(frame: Frame, last_frame: Frame, last_T_cw, T_pred, cfg: SlamConfig,
                       map_pos, map_valid, last_kp_point):
    """Frame-to-frame tracking seeded by the motion model; last-frame
    keypoints bound to map points use the map's 3D."""
    cam = cfg.camera
    lf = last_frame.feats
    dev = lf.uv.device
    sf = scale_factors(cfg.orb, dev)
    pts_w = se3.transform_points(se3.se3_inverse(last_T_cw),
                                 cam_ops.backproject(lf.uv, last_frame.kp_depth, cam))
    has3d = last_frame.is_stereo & lf.valid
    P = map_pos.shape[0]
    lkp = last_kp_point.clamp(0, P - 1)
    assoc = (last_kp_point >= 0) & map_valid[lkp]
    pts_w = torch.where(assoc[:, None], map_pos[lkp], pts_w)
    enough = assoc.sum() >= 100
    has3d = torch.where(enough, assoc, has3d | assoc)

    radius = cfg.matcher.mm_search_radius * sf[lf.level.clamp(0, sf.shape[0] - 1)]
    centers, z = cam_ops.project(se3.transform_points(T_pred, pts_w), cam)
    vis = has3d & (z > 0.05) & cam_ops.in_image(centers, cam)

    def match_r(r):
        return match_ops.match_by_window(
            lf.desc, frame.feats.desc, centers, frame.feats.uv, vis, frame.feats.valid, r,
            angle_q=lf.angle, angle_t=frame.feats.angle, max_dist=match_ops.TH_HIGH)

    # The doubled-window retry when the first window is thin (JAX's
    # `lax.cond`): only a frame that needs it matches the second window.
    m1 = match_r(radius)
    thin = m1.valid.sum() < cfg.tracking.min_matches_track
    m = device_cond(thin, lambda _: match_r(2.0 * radius), lambda _: m1, (), name="retry")
    res, _ = _pose_from_matches(T_pred, pts_w, frame, m, cfg)
    return res.T_cw, m.valid.sum(), res.num_inliers


def track_reference_kf(state: SlamState, frame: Frame, last_T_cw, cfg: SlamConfig):
    """Appearance fallback: match against the newest keyframe's map-point
    descriptors (ratio 0.7, mutual, rotation-consistent) and optimize
    from the last pose."""
    kf = state.last_kf
    P = state.points.pos.shape[0]
    K = frame.feats.capacity
    pid = row(state.kfs.kp_point, kf)
    pidc = pid.clamp(0, P - 1)
    vk = row(state.kfs.kp_valid, kf) & (pid >= 0) & state.points.valid[pidc]
    dist = match_ops.hamming_matrix(row(state.kfs.desc, kf), frame.feats.desc)
    m = match_ops.masked_best_match(dist, vk[:, None] & frame.feats.valid[None, :],
                                    max_dist=match_ops.TH_LOW, ratio=0.7, mutual=True)
    keep = match_ops.rotation_consistency_mask(row(state.kfs.angle, kf), frame.feats.angle, m)
    m = match_ops._masked_result(keep, m.idx, m.dist)
    m = match_ops.resolve_duplicate_targets(m, K)
    res, _ = _pose_from_matches(last_T_cw, state.points.pos[pidc], frame, m, cfg)
    return res.T_cw, res.num_inliers


def track_local_map(state: SlamState, frame: Frame, T_cur, cfg: SlamConfig):
    """Refine the pose against the map's in-frustum candidates and
    associate keypoints to map points; update visible/found counts."""
    cam = cfg.camera
    pts = state.points
    dev = pts.pos.device
    sf = scale_factors(cfg.orb, dev)
    P = pts.pos.shape[0]
    K = frame.feats.capacity
    pc = se3.transform_points(T_cur, pts.pos)
    uv, z = cam_ops.project(pc, cam)
    dist = torch.linalg.norm(pc, dim=-1)
    in_frustum = (pts.valid & (z > 0.05) & cam_ops.in_image(uv, cam)
                  & (dist > 0.8 * pts.min_dist) & (dist < 1.3 * pts.max_dist))
    C = min(cfg.tracking.local_map_candidates, P)
    _, cand = top_k(in_frustum.to(torch.float32), C)  # lower index first among ties
    c_valid = in_frustum[cand]
    c_pos = pts.pos[cand]
    ratio = torch.clamp(pts.max_dist[cand] / torch.clamp(dist[cand], min=1e-6), min=1e-6)
    log_s = torch.log(_f32_scalar(cfg.orb.scale_factor, device=dev))
    pred_level = torch.ceil(torch.log(ratio) / log_s).to(torch.int64).clamp(0, cfg.orb.n_levels - 1)
    radius = cfg.matcher.lm_search_radius * sf[pred_level]
    c_uv, c_z = cam_ops.project(se3.transform_points(T_cur, c_pos), cam)
    round_valid = c_valid & (c_z > 0.05) & cam_ops.in_image(c_uv, cam)
    m = match_ops.match_by_window(pts.desc[cand], frame.feats.desc, c_uv, frame.feats.uv,
                                  round_valid, frame.feats.valid, radius,
                                  max_dist=match_ops.TH_HIGH)
    res, tgt = _pose_from_matches(T_cur, c_pos, frame, m, cfg)

    ok = m.valid & res.inliers
    kp_point = scatter(torch.full((K,), -1, dtype=torch.int64, device=dev),
                       torch.where(ok, tgt, torch.full_like(tgt, K)), cand)
    vis_ids = torch.where(c_valid, cand, torch.full_like(cand, P - 1))
    found_ids = torch.where(ok, cand, torch.full_like(cand, P - 1))
    pts = pts.replace(n_visible=scatter(pts.n_visible, vis_ids, c_valid.to(torch.int32), "add"),
                      n_found=scatter(pts.n_found, found_ids, ok.to(torch.int32), "add"))
    return state.replace(points=pts), TrackResult(res.T_cw, m.valid.sum(), res.num_inliers, kp_point)


def _spawn_points(state: SlamState, frame: Frame, T_cw, kp_point, kf_id, kf_uid,
                  cfg: SlamConfig, spawn_all: bool = False):
    """Allocate map points for keypoints with depth and no association:
    all close ones, then far ones nearest-first up to the spawn budget
    (every valid-depth keypoint with spawn_all)."""
    cam = cfg.camera
    dev = T_cw.device
    sf = scale_factors(cfg.orb, dev)
    K = frame.feats.capacity
    P = state.points.pos.shape[0]
    depth_ok = frame.kp_depth > 0
    if not spawn_all:
        close = depth_ok & (frame.kp_depth < cam.depth_threshold)
        candidate = frame.feats.valid & depth_ok & (kp_point < 0)
        order = torch.argsort(torch.where(candidate, frame.kp_depth,
                                          torch.full_like(frame.kp_depth, float("inf"))), stable=True)
        depth_rank = scatter(torch.zeros((K,), dtype=torch.int64, device=dev), order,
                             torch.arange(K, device=dev))
        depth_ok = close | (depth_rank < cfg.tracking.max_new_points_per_kf)
    new_mask = frame.feats.valid & depth_ok & (kp_point < 0)
    T_wc = se3.se3_inverse(T_cw)
    pts_w = se3.transform_points(T_wc, cam_ops.backproject(frame.feats.uv, frame.kp_depth, cam))
    cam_center = T_wc[:3, 3]

    free = alloc_slots(state.points.valid, K)
    rank = torch.cumsum(new_mask.to(torch.int64), 0) - 1
    slot = free[rank.clamp(0, K - 1)]
    ok = new_mask & (slot < P)
    slot_safe = torch.where(ok, slot, torch.full_like(slot, P))

    dist = torch.linalg.norm(pts_w - cam_center, dim=-1)
    level = frame.feats.level.clamp(0, cfg.orb.n_levels - 1)
    max_dist = dist * sf[level]
    min_dist = max_dist / sf[-1]
    normal = (pts_w - cam_center) / torch.clamp(dist, min=1e-6)[:, None]
    pts = state.points
    pts = pts.replace(
        pos=scatter(pts.pos, slot_safe, pts_w),
        desc=scatter(pts.desc, slot_safe, frame.feats.desc),
        normal=scatter(pts.normal, slot_safe, normal),
        min_dist=scatter(pts.min_dist, slot_safe, min_dist),
        max_dist=scatter(pts.max_dist, slot_safe, max_dist),
        n_obs=scatter(pts.n_obs, slot_safe, 1),
        n_visible=scatter(pts.n_visible, slot_safe, 1),
        n_found=scatter(pts.n_found, slot_safe, 1),
        ref_kf=scatter(pts.ref_kf, slot_safe, kf_id),
        first_kf_uid=scatter(pts.first_kf_uid, slot_safe, kf_uid),
        valid=scatter(pts.valid, slot_safe, True),
    )
    kp_point = torch.where(ok, slot, kp_point)
    return state.replace(points=pts, n_points=state.n_points + ok.sum().to(torch.int32)), kp_point


def _retire_evicted(state: SlamState, slot, was_valid) -> SlamState:
    """Where `was_valid` (the slot held a live keyframe, which insertion
    evicts): record its spanning-tree link and re-point landmarks anchored
    on it at a surviving observer; elsewhere `state` as it was. JAX runs
    this under `lax.cond`; here both sides are one computation, masked on
    the card, so a full store costs no host read."""
    kfs = state.kfs
    F, K = kfs.kp_point.shape
    P = state.points.pos.shape[0]
    dev = kfs.valid.device
    covrow = covisibility_row(kfs.kp_point, kfs.valid, slot, P).to(torch.float32)
    eligible = kfs.valid & (torch.arange(F, device=dev) != slot)
    par_sc = torch.where(eligible, covrow, torch.full_like(covrow, -1.0))
    parent = torch.argmax(par_sc)
    parent = torch.where(row(par_sc, parent) > 0, parent, state.last_kf)
    T_rel = row(kfs.T_cw, slot) @ se3.se3_inverse(row(kfs.T_cw, parent))
    retired = push_retired(state.retired, was_valid.reshape(1), row(kfs.uid, slot)[None],
                           row(kfs.uid, parent)[None], T_rel[None])
    tracked_all = (kfs.kp_point >= 0) & kfs.kp_valid
    surv_obs = torch.where(eligible[:, None] & tracked_all, kfs.kp_point,
                           torch.full_like(kfs.kp_point, P)).reshape(-1)
    surv_ref = scatter(torch.full((P + 1,), -1, dtype=torch.int64, device=dev), surv_obs,
                       torch.arange(F, device=dev).repeat_interleave(K), "amax")[:P]
    ref_kf = state.points.ref_kf
    orphan = state.points.valid & (ref_kf == slot) & was_valid
    new_ref = torch.where(orphan, torch.where(surv_ref >= 0, surv_ref, parent), ref_kf)
    return state.replace(retired=retired, points=state.points.replace(ref_kf=new_ref))


def insert_keyframe(state: SlamState, frame: Frame, T_cw, kp_point, frame_id: int, stamp: float,
                    cfg: SlamConfig, spawn_all: bool = False):
    """Write the frame into the lowest free keyframe slot (evicting the
    oldest keyframe when the store is full) and spawn close points.
    Returns (state, kp_point)."""
    kfs = state.kfs
    F = kfs.valid.shape[0]
    P = state.points.pos.shape[0]
    dev = kfs.valid.device
    free = alloc_slots(kfs.valid, 1)[0]
    evict_score = torch.where(
        kfs.valid & (torch.arange(F, device=dev) != state.last_kf) & (kfs.uid > 0),
        -kfs.uid, torch.full_like(kfs.uid, -(2**30)))
    slot = torch.where(free < F, free, torch.argmax(evict_score))
    was_valid = row(kfs.valid, slot)
    state = _retire_evicted(state, slot, was_valid)

    old = row(kfs.kp_point, slot)
    n_obs = scatter(state.points.n_obs, torch.where(was_valid & (old >= 0), old, torch.full_like(old, P)),
                    -1, "add")
    n_obs = scatter(n_obs, torch.where(kp_point >= 0, kp_point, torch.full_like(kp_point, P)), 1, "add")
    state = state.replace(points=state.points.replace(n_obs=torch.clamp(n_obs, min=0)))

    kf_uid = state.next_uid
    state, kp_point = _spawn_points(state, frame, T_cw, kp_point, slot, kf_uid, cfg, spawn_all)
    kfs = state.kfs
    f = frame.feats
    kfs = kfs.replace(
        T_cw=scatter(kfs.T_cw, slot, T_cw),
        uv=scatter(kfs.uv, slot, f.uv),
        level=scatter(kfs.level, slot, f.level),
        angle=scatter(kfs.angle, slot, f.angle),
        desc=scatter(kfs.desc, slot, f.desc),
        depth=scatter(kfs.depth, slot, frame.kp_depth),
        kp_valid=scatter(kfs.kp_valid, slot, f.valid),
        kp_point=scatter(kfs.kp_point, slot, kp_point),
        frame_id=scatter(kfs.frame_id, slot, frame_id),
        stamp=scatter(kfs.stamp, slot, stamp),
        uid=scatter(kfs.uid, slot, kf_uid),
        parent_uid=scatter(kfs.parent_uid, slot, -1),
        T_rel_parent=scatter(kfs.T_rel_parent, slot, _eye4(dev)),
        valid=scatter(kfs.valid, slot, True),
    )
    state = state.replace(kfs=kfs, n_kfs=state.n_kfs + 1 - was_valid.to(torch.int32),
                          last_kf=slot, next_uid=state.next_uid + 1)
    return state, kp_point


def motion_velocity(T_cw, last_T_cw, status, cfg: SlamConfig) -> torch.Tensor:
    """The damped constant-velocity model's next velocity (the identity
    after a LOST frame, status 2)."""
    rel = T_cw @ se3.se3_inverse(last_T_cw)
    return torch.where(status == 2, _eye4(T_cw.device),
                       se3.se3_exp(cfg.tracking.velocity_damping * se3.se3_log(rel)))


def fused_track_step(state: SlamState, gray, depth_img, last_frame: Frame, last_T_cw,
                     last_kp_point, velocity, frames_since_kf, ref_kf_inliers,
                     cfg: SlamConfig, feats: Features | None = None,
                     static_mask: torch.Tensor | None = None):
    """The per-frame hot path: frame build (dropping keypoints on the
    pixels `static_mask` marks dynamic), motion-model tracking (with
    the reference-keyframe fallback), local-map tracking, pose selection,
    keyframe decision, velocity update. `frames_since_kf` and
    `ref_kf_inliers`: 0-d int64 tensors (a Python int is made one).
    Returns (state, frame, T_cw, velocity, kp_point, packed) with packed =
    [T_cw flat (16), status, need_kf, n_inliers, n_matches, n_inl_mm]
    float32.

    Nothing in it reads the card on the host: JAX's two `lax.cond`s (the
    doubled-window retry, the reference-keyframe fallback) are
    `device_cond`s, so one CUDA graph holds the step
    (`tracking/graphed_track.py`) and a frame runs only the branches it
    takes; on the CPU each predicate is read on the host."""
    t = cfg.tracking
    dev = last_T_cw.device
    if not isinstance(frames_since_kf, torch.Tensor):
        frames_since_kf = torch.full((), frames_since_kf, dtype=torch.int64, device=dev)
    if not isinstance(ref_kf_inliers, torch.Tensor):
        ref_kf_inliers = torch.full((), ref_kf_inliers, dtype=torch.int64, device=dev)
    frame = (frame_from_features(feats, depth_img, cfg, static_mask) if feats is not None
             else build_frame(gray, depth_img, cfg, static_mask))
    T_pred = velocity @ last_T_cw
    T_mm, _, n_inl_mm = track_motion_model(
        frame, last_frame, last_T_cw, T_pred, cfg, map_pos=state.points.pos,
        map_valid=state.points.valid, last_kp_point=last_kp_point)
    mm_jump = torch.linalg.norm(T_mm[:3, 3] - T_pred[:3, 3])
    ok_mm = (n_inl_mm >= t.min_inliers_track) & (mm_jump < 0.5)
    # The reference-keyframe fallback where the motion model failed (JAX's
    # `lax.cond`); where it held, the motion model's own result.
    T_ref, n_inl_ref = device_cond(
        ok_mm, lambda _: (T_mm, n_inl_mm),
        lambda _: track_reference_kf(state, frame, last_T_cw, cfg), (), name="fallback")
    ok_ref = (~ok_mm) & (n_inl_ref >= t.min_inliers_track)
    ok_pre = ok_mm | ok_ref
    T_seed = torch.where(ok_mm, T_mm, torch.where(ok_ref, T_ref, T_pred))

    state, res = track_local_map(state, frame, T_seed, cfg)
    ok_lm = res.n_inliers >= t.min_inliers_local_map
    T_cw = torch.where(ok_lm, res.T_cw, torch.where(ok_pre, T_seed, last_T_cw))
    status = torch.where(ok_lm, 0, torch.where(ok_pre, 1, 2))

    close = frame.feats.valid & (frame.kp_depth > 0) & (frame.kp_depth < cfg.camera.depth_threshold)
    n_close_tracked = (close & (res.kp_point >= 0)).sum()
    n_close_untracked = (close & (res.kp_point < 0)).sum()
    need_close = (n_close_tracked < t.min_close_points) & (n_close_untracked > t.max_non_tracked_close)
    need_kf = ok_lm & (
        (frames_since_kf >= t.max_frames_between_kfs)
        | need_close
        | (res.n_inliers < t.kf_ref_ratio * torch.clamp(ref_kf_inliers, min=1))
        | (res.n_inliers < t.kf_min_inliers)
    ) & (res.n_inliers >= t.min_inliers_track)

    vel_new = motion_velocity(T_cw, last_T_cw, status, cfg)
    stats = torch.stack([s.to(torch.float32) for s in
                         (status, need_kf, res.n_inliers, res.n_matches, n_inl_mm)])
    packed = torch.cat([T_cw.reshape(-1), stats])
    return state, frame, T_cw, vel_new, res.kp_point, packed


class Tracker:
    """Host-side per-frame sequencing; owns the map state and the motion
    model. `device=None` runs on the card (raises without one), or on the
    mesh's device. `mesh`: a (kf, pt) mesh from `parallel/mesh.make_mesh`,
    handed to the loop closer (its database and global BA shard over it);
    tracking itself runs whole on every rank."""

    def __init__(self, cfg: SlamConfig, device=None, mesh=None):
        from orb_slam2_ssd_semantic_tpu_torch.utils.metrics import Metrics

        if mesh is not None and device is None:
            from orb_slam2_ssd_semantic_tpu_torch.parallel.mesh import mesh_device

            device = mesh_device(mesh)
        self.device = device_mod.resolve(device)
        self.mesh = mesh
        self.cfg = cfg
        self.metrics = Metrics()
        self.state = empty_state(cfg, self.device)
        self.last_frame: Frame | None = None
        self.last_kp_point = torch.full((cfg.orb.max_keypoints,), -1, dtype=torch.int64,
                                        device=self.device)
        self.last_T_cw = _eye4(self.device)
        self.velocity = _eye4(self.device)
        # The dynamic masks' state: the previous gray image (flow mask) and
        # the ring of keyframe views (geometry mask).
        self.prev_gray = None
        if cfg.dynamic.enable_geometry:
            from orb_slam2_ssd_semantic_tpu_torch.dynamic.geommask import empty_ref_views

            self.geom_db = empty_ref_views(cfg.dynamic.geom_db_size, cfg.orb.max_keypoints,
                                           self.device)
        else:
            self.geom_db = None
        self.initialized = False
        self.frame_id = 0
        # Loop closing and the keyframe database of relocalization. With
        # loop closing off the database holds only the keyframe that
        # initialisation puts in slot 0, as in the JAX package: later
        # keyframes enter it only through loop closing.
        if cfg.loop.enabled or cfg.loop.enable_relocalization:
            from orb_slam2_ssd_semantic_tpu_torch.mapping.loop_closing import LoopCloser

            self.loop_closer = LoopCloser(cfg, device=self.device, mesh=mesh)
        else:
            self.loop_closer = None
        self.n_loops_closed = 0
        self.frames_since_kf = 0
        self.ref_kf_inliers = 0
        self.allow_new_keyframes = True
        self.trajectory: list = []  # (stamp, ref_kf_uid, T_rel np)
        self.stats: list = []
        self.status = "INIT"
        self._n_kfs = 0
        self._n_points = 0
        self._last_kf = 0
        self._ref_kf_uid = 0
        self._ref_kf_pose_np = np.eye(4, dtype=np.float32)
        self._retired: dict = {}
        self._lost_streak = 0
        self._mapper = None
        self._track_runner = None
        self._insert_runner = None
        self._mask_runner = None

    def _to_device(self, a) -> torch.Tensor:
        """A host image on the tracker's device. The card's copy goes from
        pinned memory without waiting, so a frame's upload does not wait
        for the previous keyframe's local mapping to finish."""
        t = torch.as_tensor(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    @precision.scoped
    def process(self, gray: np.ndarray, depth: np.ndarray, stamp: float,
                feats: Features | None = None) -> np.ndarray:
        """Track one RGB-D frame (gray float32 [0, 255] or uint8; depth
        float32 meters or uint16 millimeters); returns T_cw (4, 4) numpy.
        `feats`: optional pre-extracted raw-pixel features.

        The dynamic masks run first when enabled (the reference's
        pre-tracking stage, Tracking.cc:688-719): the flow mask against the
        previous gray image, from the second frame on, with an ego-motion
        homography fitted to the flow; the geometry mask against the
        recent keyframe views at the motion model's predicted pose, once
        the tracker is initialized. Both together are ANDed."""
        cfg = self.cfg
        gray = self._to_device(gray)
        depth = self._to_device(depth)
        static_mask = None
        if cfg.dynamic.enable_flow and self.prev_gray is not None:
            masks = self.mask_runner()
            if not masks.ready_flow(self.prev_gray, gray, cfg.dynamic):
                with self.metrics.stage("mask.capture"), record_function("mask.capture"):
                    masks.capture_flow(self.prev_gray, gray, cfg.dynamic)
            with self.metrics.stage("mask.flow"), record_function("mask.flow"):
                static_mask = masks.flow(self.prev_gray, gray, cfg.dynamic)
        if cfg.dynamic.enable_geometry and self.initialized:
            masks = self.mask_runner()
            geom_args = (self.geom_db, self.velocity @ self.last_T_cw, depth_metres(depth),
                         cfg.camera, cfg.dynamic)
            if not masks.ready_geometry(*geom_args):
                with self.metrics.stage("mask.capture"), record_function("mask.capture"):
                    masks.capture_geometry(*geom_args)
            with self.metrics.stage("mask.geometry"), record_function("mask.geometry"):
                gmask = masks.geometry(*geom_args)
            static_mask = gmask if static_mask is None else (static_mask & gmask)
        self.prev_gray = gray
        if not self.initialized:
            if feats is not None:
                frame = frame_from_features(feats, depth, cfg, static_mask)
            else:
                frame = build_frame(gray, depth, cfg, static_mask)
            T_cw = _eye4(self.device)
            kp_point = torch.full((frame.feats.capacity,), -1, dtype=torch.int64, device=self.device)
            self.state, kp_point = self.insert_runner().step(
                self.state, frame, T_cw, kp_point, self.frame_id, stamp, cfg, spawn_all=True)
            self.initialized = True
            self.status = "OK"
            self.ref_kf_inliers = int((frame.is_stereo & frame.feats.valid).sum())
            if self.loop_closer is not None:
                self.state, _ = self.loop_closer.on_keyframe(self.state, 0)
            self._on_keyframe_inserted()
            self._record(frame, T_cw, np.eye(4, dtype=np.float32), kp_point, _eye4(self.device),
                         stamp, 0, 0)
            return np.eye(4, dtype=np.float32)

        args = (self.state, gray, depth, self.last_frame, self.last_T_cw, self.last_kp_point,
                self.velocity, self.frames_since_kf, self.ref_kf_inliers, cfg)
        runner = self.track_runner()
        if not runner.ready(cfg, static_mask, feats):
            with self.metrics.stage("track.capture"), record_function("track.capture"):
                runner.capture(*args, feats=feats, static_mask=static_mask)
        with self.metrics.stage("track"), record_function("track"):
            self.state, frame, T_cw, velocity, kp_point, packed = runner.step(
                *args, feats=feats, static_mask=static_mask)
            p = packed.cpu().numpy()  # the per-frame stats fetch
        T_np = p[:16].reshape(4, 4).astype(np.float32)
        status_code, need_kf = int(p[16]), bool(p[17] > 0.5)
        n_inl, n_matches = int(p[18]), int(p[19])
        self.status = ("OK", "WEAK", "LOST")[status_code]
        if self.status == "LOST":
            self.metrics.count("lost")  # as tracked, before any relocalization

        if need_kf and self.allow_new_keyframes:
            self._capture_retirements()
            with self.metrics.stage("keyframe.insert"):
                with record_function("keyframe.insert"):
                    self.state, kp_point = self.insert_runner().step(
                        self.state, frame, T_cw, kp_point, self.frame_id, stamp, cfg)
                kf_slot = int(self.state.last_kf)
            self.metrics.count("keyframes")
            self.frames_since_kf = 0
            self.ref_kf_inliers = int((kp_point >= 0).sum())
            if self.geom_db is not None:
                # The geometry mask's view ring takes every keyframe
                # (GeometricModelUpdateDB, Geometry.cc:73-79, 532-546).
                from orb_slam2_ssd_semantic_tpu_torch.dynamic.geommask import insert_ref_view

                self.geom_db = insert_ref_view(self.geom_db, T_cw, frame.feats.uv, frame.kp_depth,
                                               frame.feats.valid & frame.is_stereo)
            # Loop closing on the post-insert state, before local mapping;
            # a closed loop re-anchors the live pose on the corrected
            # keyframe.
            if self.loop_closer is not None and cfg.loop.enabled:
                with self.metrics.stage("loop_closing"):
                    self.state, closed = self.loop_closer.on_keyframe(self.state, kf_slot)
                if closed:
                    self.n_loops_closed += 1
                    self.metrics.count("loops_closed")
                    T_cw = self.state.kfs.T_cw[kf_slot]
                    T_np = T_cw.cpu().numpy()
            # The host mirrors read the post-insert, pre-BA state, before
            # local mapping is dispatched: with `async_mapping` nothing
            # after the dispatch waits on the card until the next frame's
            # stats fetch.
            n_kfs_before = self._n_kfs
            self._on_keyframe_inserted()
            if n_kfs_before + 1 >= 3:
                mapper = self.local_mapper()
                if not mapper.ready(cfg):
                    with self.metrics.stage("local_mapping.capture"), \
                            record_function("local_mapping.capture"):
                        mapper.capture(self.state, cfg)
                with self.metrics.stage("local_mapping"), record_function("local_mapping"):
                    self.state = mapper.step(self.state, cfg)
                    if not cfg.tracking.async_mapping:
                        T_cw = self.state.kfs.T_cw[kf_slot]
                        T_np = T_cw.cpu().numpy()
        else:
            self.frames_since_kf += 1
            # Relocalize when LOST and, in localization-only mode, also
            # while WEAK: the mbVO fallback (Tracking.cc:986-1047), which
            # rides on temporal points and re-anchors to the map the
            # moment relocalization succeeds.
            vo_mode = self.status == "WEAK" and not self.allow_new_keyframes
            if (self.status == "LOST" or vo_mode) and cfg.loop.enable_relocalization \
                    and self.loop_closer is not None and self._n_kfs >= 1:
                from orb_slam2_ssd_semantic_tpu_torch.tracking.reloc import relocalize

                with self.metrics.stage("relocalization"):
                    ok_reloc, T_reloc, n_reloc = relocalize(self.state, frame,
                                                            self.loop_closer, cfg)
                if ok_reloc:
                    self.status = "OK"
                    T_cw = T_reloc
                    T_np = T_reloc.cpu().numpy()
                    velocity = _eye4(self.device)
                    n_inl = n_reloc

        self._lost_streak = self._lost_streak + 1 if self.status == "LOST" else 0
        if self._lost_streak >= 10 and self._n_kfs <= cfg.tracking.reset_if_lost_with_kfs:
            self.state = empty_state(cfg, self.device)
            self.initialized = False
            self._lost_streak = 0
            self._n_kfs = 0
            self._n_points = 0
            self._last_kf = 0
            self._ref_kf_uid = 0
            self._retired = {}

        self._record(frame, T_cw, T_np, kp_point, velocity, stamp, n_matches, n_inl)
        return T_np

    def track_runner(self):
        """The tracker's runner of `fused_track_step` (one CUDA graph of the
        step per configuration and kind of frame on the card), made at the
        first call."""
        if self._track_runner is None:
            from orb_slam2_ssd_semantic_tpu_torch.tracking.graphed_track import TrackStepRunner

            self._track_runner = TrackStepRunner(self.device)
        return self._track_runner

    def insert_runner(self):
        """The tracker's runner of `insert_keyframe` (one CUDA graph per
        configuration and `spawn_all` on the card), made at the first
        call."""
        if self._insert_runner is None:
            from orb_slam2_ssd_semantic_tpu_torch.tracking.graphed_track import (
                InsertKeyframeRunner,
            )

            self._insert_runner = InsertKeyframeRunner(self.device)
        return self._insert_runner

    def mask_runner(self):
        """The tracker's runner of the dynamic masks (one CUDA graph per
        mask and configuration on the card), made at the first call."""
        if self._mask_runner is None:
            from orb_slam2_ssd_semantic_tpu_torch.dynamic.graphed_masks import MaskRunner

            self._mask_runner = MaskRunner(self.device)
        return self._mask_runner

    def local_mapper(self):
        """The tracker's local-mapping runner (one CUDA graph of the step
        per configuration on the card), made at the first call."""
        if self._mapper is None:
            from orb_slam2_ssd_semantic_tpu_torch.mapping.graphed_step import LocalMappingRunner

            self._mapper = LocalMappingRunner(self.device)
        return self._mapper

    def _on_keyframe_inserted(self):
        """Refresh the host mirrors from the state (post-insert, pre-BA)."""
        state = self.state
        self._n_kfs = int(state.n_kfs)
        self._n_points = int(state.n_points)
        self._last_kf = int(state.last_kf)
        self._ref_kf_uid = int(state.kfs.uid[self._last_kf])
        self._ref_kf_pose_np = state.kfs.T_cw[self._last_kf].cpu().numpy()

    def _capture_retirements(self):
        """Record spanning-tree info of culled keyframes before their
        slots can be reused."""
        kfs = self.state.kfs
        uid = kfs.uid.cpu().numpy()
        valid = kfs.valid.cpu().numpy()
        parent = kfs.parent_uid.cpu().numpy()
        retired_idx = np.nonzero((uid >= 0) & ~valid)[0]
        if len(retired_idx):
            Trel = kfs.T_rel_parent.cpu().numpy()
            for i in retired_idx:
                u = int(uid[i])
                if u not in self._retired:
                    self._retired[u] = (int(parent[i]), Trel[i])
        self._merge_ring_retirements()

    def _merge_ring_retirements(self):
        ring = self.state.retired
        r_uid = ring.uid.cpu().numpy()
        idx = np.nonzero(r_uid >= 0)[0]
        if len(idx):
            r_parent = ring.parent_uid.cpu().numpy()
            r_Trel = ring.T_rel.cpu().numpy()
            for i in idx:
                u = int(r_uid[i])
                if u not in self._retired:
                    self._retired[u] = (int(r_parent[i]), r_Trel[i])

    def _record(self, frame, T_cw, T_np, kp_point, velocity, stamp, n_matches, n_inliers):
        self.last_kp_point = kp_point
        self.velocity = velocity
        self.last_frame = frame
        self.last_T_cw = T_cw
        self.frame_id += 1
        T_rel = T_np @ np.linalg.inv(self._ref_kf_pose_np)
        self.trajectory.append((stamp, self._ref_kf_uid, T_rel))
        self.stats.append({"matches": n_matches, "inliers": n_inliers, "status": self.status,
                           "kfs": self._n_kfs, "points": self._n_points})

    # -- outputs ------------------------------------------------------------

    def _kf_pose_by_uid(self):
        """uid -> current T_cw resolver, walking the spanning tree for
        retired reference keyframes."""
        kfs = self.state.kfs
        uid = kfs.uid.cpu().numpy()
        valid = kfs.valid.cpu().numpy()
        T = kfs.T_cw.cpu().numpy()
        parent = kfs.parent_uid.cpu().numpy()
        Trel = kfs.T_rel_parent.cpu().numpy()
        live = {int(u): T[i] for i, u in enumerate(uid) if valid[i] and u >= 0}
        self._merge_ring_retirements()
        retired = dict(self._retired)
        for i, u in enumerate(uid):
            if u >= 0 and not valid[i] and int(u) not in retired:
                retired[int(u)] = (int(parent[i]), Trel[i])

        def resolve(u: int):
            chain = []
            seen = set()
            while u not in live:
                if u not in retired or u in seen:
                    cands = [lu for lu in live if lu <= u]
                    return live[max(cands)] if cands else np.eye(4, dtype=np.float32)
                seen.add(u)
                chain.append(retired[u][1])
                u = retired[u][0]
            out = live[u]
            for R in reversed(chain):
                out = R @ out
            return out

        return resolve

    def absolute_poses(self) -> list:
        """[(stamp, T_cw)] resolved against the current keyframe poses."""
        resolve = self._kf_pose_by_uid()
        return [(s, T_rel @ resolve(ref_uid)) for s, ref_uid, T_rel in self.trajectory]

    def camera_positions(self) -> np.ndarray:
        """(N, 3) camera centres in the world frame."""
        return np.stack([-T[:3, :3].T @ T[:3, 3] for _, T in self.absolute_poses()])

    def save_trajectory_tum(self, path: str):
        """TUM-format camera trajectory."""
        from orb_slam2_ssd_semantic_tpu_torch.io.tum import write_trajectory

        stamps, ts, qs = [], [], []
        for s, T in self.absolute_poses():
            R, t = T[:3, :3], T[:3, 3]
            stamps.append(s)
            ts.append(-R.T @ t)
            qs.append(se3.rot_to_quat(torch.from_numpy(np.ascontiguousarray(R.T))).numpy())
        write_trajectory(path, stamps, ts, qs)
