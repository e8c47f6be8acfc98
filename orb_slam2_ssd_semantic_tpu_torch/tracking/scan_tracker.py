"""Whole-sequence tracking (counterpart of the JAX package's
`tracking/scan_tracker.py`): the offline mode in which all frames are
uploaded once and the full per-frame SLAM update runs over them, with
only the trajectory and per-frame stats coming back.

The JAX module runs the sequence as one `lax.scan` with the keyframe
branch under `lax.cond`. Here the scan is a host loop over the frames:
- the per-frame half of a step is the tracker's `fused_track_step`
  (frame build, motion model with the reference-keyframe fallback,
  local-map tracking, keyframe decision, velocity), replayed from the
  carry's `TrackStepRunner` graph (`tracking/graphed_track.py`);
- the keyframe branch is a Python branch on `need_kf`, one stream sync a
  frame (the `Tracker.process` stats fetch, in another place), and in it
  local mapping waits on one more (`n_kfs >= 3`); local mapping replays
  the carry's `LocalMappingRunner` graph (`mapping/graphed_step.py`).
  The carries of one run share both runners, so a run captures each
  once. (JAX's keyframe branch is a `lax.cond` inside its one `lax.scan`;
  on the card that would need conditional graph nodes.)
- with a vocabulary, every keyframe event runs loop DETECTION
  (`_detect_loop`) after local mapping, in the JAX scan's order
  (`Tracker.process` runs loop closing before local mapping);
- per-frame poses, stats and keyframe-relative records stay on the
  device until the caller fetches them.

With `use_flow` the flow mask runs on every frame against the frame
before it (`prev_grays`); with `use_geom` the geometry mask runs against
the carry's ring of keyframe views (seeded with frame 0 by `init_scan`,
fed by every keyframe event), at the motion model's predicted pose.

Nothing writes into its input: a segment run twice from one carry gives
the same result, which the segmented runner (`tracking/segmented.py`)
relies on when it corrects the map between segments.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.dynamic.flowmask import flow_dynamic_mask_fitted
from orb_slam2_ssd_semantic_tpu_torch.dynamic.geommask import (
    GeomRefViews,
    empty_ref_views,
    geometry_dynamic_mask,
    insert_ref_view,
)
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.io import vocabulary as voc
from orb_slam2_ssd_semantic_tpu_torch.mapping.graphed_step import LocalMappingRunner
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import (
    SlamState,
    covisibility_row,
    empty_state,
)
from orb_slam2_ssd_semantic_tpu_torch.tracking import tracker as tk
from orb_slam2_ssd_semantic_tpu_torch.tracking.graphed_track import TrackStepRunner
from orb_slam2_ssd_semantic_tpu_torch.utils import precision
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import scatter

# The JAX module's device-resident vocabulary arrays: here the port's
# `DeviceVocabulary` (children, desc, word_id, idf and depth), made with
# `VocabArrays.from_vocabulary(vocab, device)`.
VocabArrays = voc.DeviceVocabulary


@dataclasses.dataclass
class ScanCarry:
    state: SlamState
    last_frame: tk.Frame
    last_T_cw: torch.Tensor
    last_kp_point: torch.Tensor
    velocity: torch.Tensor
    frames_since_kf: int
    ref_kf_inliers: int
    frame_idx: int
    word_db: torch.Tensor  # (F, K) int64 per-keyframe BoW words (-1 empty)
    val_db: torch.Tensor  # (F, K) f32 deduplicated TF-IDF values
    cons_count: torch.Tensor  # (F,) int32 consecutive-consistency counters
    # Local mapping's runner (its CUDA graph on the card), made by
    # `init_scan` and shared by every carry that follows.
    mapper: LocalMappingRunner
    # The tracking step's runner, the same way.
    track: TrackStepRunner
    # The geometry mask's reference views (`use_geom`), else None.
    geom_db: GeomRefViews | None = None

    def replace(self, **kw) -> "ScanCarry":
        return dataclasses.replace(self, **kw)


def _empty_bow_db(cfg: SlamConfig, device):
    F, K = cfg.map.max_keyframes, cfg.orb.max_keypoints
    return (torch.full((F, K), -1, dtype=torch.int64, device=device),
            torch.zeros((F, K), dtype=torch.float32, device=device),
            torch.zeros((F,), dtype=torch.int32, device=device))


def _bow_add(word_db, val_db, slot, desc, valid, vocab: VocabArrays):
    words = voc.quantize(vocab, desc, valid)
    vals = voc.bow_columns(words, vocab.idf)
    return scatter(word_db, slot, words), scatter(val_db, slot, vals), words, vals


@precision.scoped
def init_scan(state: SlamState, gray0, depth0, cfg: SlamConfig,
              vocab: VocabArrays | None = None, use_geom: bool = False) -> ScanCarry:
    """Frame 0 becomes the first keyframe at the identity pose, with every
    keypoint of valid depth spawned as a map point; with `use_geom` it is
    also the first view of the geometry mask's ring."""
    dev = state.kfs.valid.device
    frame = tk.build_frame(gray0, depth0, cfg)
    T0 = torch.eye(4, dtype=torch.float32, device=dev)
    kp_point = torch.full((frame.feats.capacity,), -1, dtype=torch.int64, device=dev)
    state, kp_point = tk.insert_keyframe(state, frame, T0, kp_point, 0, 0.0, cfg, spawn_all=True)
    word_db, val_db, cons = _empty_bow_db(cfg, dev)
    if vocab is not None:
        word_db, val_db, _, _ = _bow_add(word_db, val_db, state.last_kf, frame.feats.desc,
                                         frame.feats.valid, vocab)
    geom_db = None
    if use_geom:
        geom_db = insert_ref_view(
            empty_ref_views(cfg.dynamic.geom_db_size, cfg.orb.max_keypoints, dev), T0,
            frame.feats.uv, frame.kp_depth, frame.feats.valid & frame.is_stereo)
    return ScanCarry(
        state=state, last_frame=frame, last_T_cw=T0, last_kp_point=kp_point,
        velocity=torch.eye(4, dtype=torch.float32, device=dev), frames_since_kf=0,
        ref_kf_inliers=int((frame.is_stereo & frame.feats.valid).sum()), frame_idx=1,
        word_db=word_db, val_db=val_db, cons_count=cons, geom_db=geom_db,
        mapper=LocalMappingRunner(dev), track=TrackStepRunner(dev))


def _detect_loop(state: SlamState, frame, word_db, val_db, cons, cfg: SlamConfig,
                 vocab: VocabArrays):
    """LoopClosing::DetectLoop (LoopClosing.cc:119-290) on the device, for
    the keyframe in slot `state.last_kf`:

    1. quantize the frame and write its BoW column into the database;
    2. score it against every stored keyframe (L1 TF-IDF);
    3. min-score gate: candidates must reach the lowest score among the
       keyframe's covisible neighbours (1.0 when it has none) and
       `min_abs_score`;
    4. exclude the covisible and recent keyframes (a uid gap of
       `min_kfs_before_loop`);
    5. consecutive consistency over uid neighbourhoods: a candidate
       continues a chain when a keyframe within 2 uids of it was counted
       at the last event; a chain of `covisibility_consistency_th` makes
       it confident, and the best-scored confident candidate (the lowest
       slot among equal scores) is the loop candidate.

    Returns (word_db, val_db, cons, loop_cand slot (-1 none)) as tensors."""
    F = word_db.shape[0]
    P = state.points.pos.shape[0]
    dev = word_db.device
    slot = state.last_kf
    uid = state.kfs.uid
    uid_cur = uid[slot]
    valid = state.kfs.valid

    word_db, val_db, words, vals = _bow_add(word_db, val_db, slot, frame.feats.desc,
                                            frame.feats.valid, vocab)
    scores = voc.l1_scores(words, vals, word_db, val_db, vocab.n_words)  # (F,)

    covrow = covisibility_row(state.kfs.kp_point, valid, slot, P)
    covis_nb = (covrow >= cfg.map.covis_weight_threshold) & valid
    min_score = torch.min(torch.where(covis_nb, scores, torch.full_like(scores, float("inf"))))
    min_score = torch.where(torch.isfinite(min_score), min_score, torch.ones_like(min_score))

    db_ok = valid & (uid >= 0) & (torch.arange(F, device=dev) != slot)
    old_enough = (uid_cur - uid) >= cfg.loop.min_kfs_before_loop
    cand = (db_ok & old_enough & (covrow < cfg.map.covis_weight_threshold)
            & (scores >= torch.clamp(min_score, min=cfg.loop.min_abs_score)))

    du = torch.abs(uid[:, None] - uid[None, :])
    nb = (du <= 2) & db_ok[None, :]
    prev_best = torch.amax(torch.where(nb, cons[None, :], torch.zeros_like(cons)[None, :]), dim=1)
    cons_new = torch.where(cand, prev_best + 1, torch.zeros_like(prev_best))

    confident = cons_new >= cfg.loop.covisibility_consistency_th
    best = torch.argmax(torch.where(confident, scores, torch.full_like(scores, -1.0)))
    loop_cand = torch.where(confident.any(), best, torch.full_like(best, -1))
    return word_db, val_db, cons_new, loop_cand


@precision.scoped
def track_sequence_scan(carry: ScanCarry, grays: torch.Tensor, depths: torch.Tensor,
                        cfg: SlamConfig, vocab: VocabArrays | None = None,
                        prev_grays: torch.Tensor | None = None, use_flow: bool = False,
                        use_geom: bool = False, with_rel: bool = False):
    """grays (N, H, W) uint8 (or float32 [0, 255]) and depths (N, H, W)
    uint16 mm (or float32 metres) on the carry's device.

    Returns (carry, T_cw (N, 4, 4), stats (N, 4) int64 [status, n_inl,
    n_kfs, loop_cand slot (-1 none)]), all on the device. With `vocab`,
    every keyframe event also runs loop detection. With `with_rel`, also
    (T_rel (N, 4, 4), ref_uid (N,)): each frame's pose relative to its
    reference keyframe's pose as the map holds it right after the frame
    (post-insert, post-local-BA), the SaveTrajectoryTUM record
    (System.cc:476-502) that `segmented.resolve_trajectory` resolves
    against the final keyframe poses. `carry` is left as it was.

    `use_flow` masks each frame with the flow against `prev_grays[i]`
    (the frames before these; None: the frame before within `grays`, and
    for the first frame the frame itself). `use_geom` needs a carry from
    `init_scan(..., use_geom=True)`."""
    t = cfg.tracking
    if use_flow and prev_grays is None:
        prev_grays = torch.cat([grays[:1], grays[:-1]])
    geom_db = carry.geom_db
    if use_geom and geom_db is None:
        raise ValueError("use_geom needs a carry made by init_scan(..., use_geom=True)")
    state = carry.state
    last_frame, last_T_cw, last_kp_point = carry.last_frame, carry.last_T_cw, carry.last_kp_point
    velocity = carry.velocity
    frames_since_kf, ref_kf_inliers, frame_idx = (carry.frames_since_kf, carry.ref_kf_inliers,
                                                  carry.frame_idx)
    word_db, val_db, cons = carry.word_db, carry.val_db, carry.cons_count
    no_cand = torch.full((), -1, dtype=torch.int64, device=last_T_cw.device)
    T_out, stats_out, rel_out, uid_out = [], [], [], []
    for i in range(grays.shape[0]):
        mask = None
        if use_flow:
            mask = flow_dynamic_mask_fitted(prev_grays[i], grays[i], cfg.dynamic)
        if use_geom:
            gmask = geometry_dynamic_mask(geom_db, velocity @ last_T_cw,
                                          tk.depth_metres(depths[i]), cfg.camera, cfg.dynamic)
            mask = gmask if mask is None else mask & gmask
        state, frame, T_cw, vel, kp_point, packed = carry.track.step(
            state, grays[i], depths[i], last_frame, last_T_cw, last_kp_point, velocity,
            frames_since_kf, ref_kf_inliers, cfg, static_mask=mask)
        status = packed[16].to(torch.int64)
        loop_cand = no_cand
        if bool(packed[17] > 0.5):  # need_kf: host sync
            state, kp_point = tk.insert_keyframe(state, frame, T_cw, kp_point, frame_idx,
                                                 float(frame_idx), cfg)
            if int(state.n_kfs) >= 3:  # host sync
                state = carry.mapper.step(state, cfg)
            if vocab is not None:
                word_db, val_db, cons, loop_cand = _detect_loop(state, frame, word_db, val_db,
                                                                cons, cfg, vocab)
            if use_geom:
                geom_db = insert_ref_view(geom_db, T_cw, frame.feats.uv, frame.kp_depth,
                                          frame.feats.valid & frame.is_stereo)
            if t.reanchor_on_kf:
                # Re-anchor on the BA-refined pose; the velocity follows it.
                T_cw = state.kfs.T_cw[state.last_kf]
                vel = tk.motion_velocity(T_cw, last_T_cw, status, cfg)
            frames_since_kf = 0
            # Reference count: the new keyframe's landmark associations
            # (tracked + spawned), NeedNewKeyFrame's nRefMatches.
            ref_kf_inliers = int((kp_point >= 0).sum())
        else:
            frames_since_kf += 1
        last_frame, last_T_cw, last_kp_point, velocity = frame, T_cw, kp_point, vel
        frame_idx += 1
        T_out.append(T_cw)
        stats_out.append(torch.stack([status, packed[18].to(torch.int64),
                                      state.n_kfs.to(torch.int64), loop_cand]))
        if with_rel:
            ref_slot = state.last_kf
            rel_out.append(T_cw @ se3.se3_inverse(state.kfs.T_cw[ref_slot]))
            uid_out.append(state.kfs.uid[ref_slot])
    new_carry = carry.replace(
        state=state, last_frame=last_frame, last_T_cw=last_T_cw, last_kp_point=last_kp_point,
        velocity=velocity, frames_since_kf=frames_since_kf, ref_kf_inliers=ref_kf_inliers,
        frame_idx=frame_idx, word_db=word_db, val_db=val_db, cons_count=cons, geom_db=geom_db)
    out = (new_carry, torch.stack(T_out), torch.stack(stats_out))
    if with_rel:
        out = out + (torch.stack(rel_out), torch.stack(uid_out))
    return out


@precision.scoped
def track_sequence(grays, depths, cfg: SlamConfig, vocab: voc.Vocabulary | None = None,
                   device=None):
    """Host entry: numpy (N, H, W) uint8 grays + uint16 mm depths (or
    float32 [0, 255] and metres) -> (poses (N, 4, 4) numpy including frame
    0, the final SlamState, stats (N - 1, 4) numpy). `vocab`: an
    `io/vocabulary.Vocabulary` for in-scan loop detection (optional).
    The frames are uploaded once. `device=None` runs on the card (raises
    without one)."""
    dev = device_mod.resolve(device)
    g = torch.as_tensor(np.ascontiguousarray(grays)).to(dev)
    d = torch.as_tensor(np.ascontiguousarray(depths)).to(dev)
    va = None if vocab is None else VocabArrays.from_vocabulary(vocab, dev)
    carry = init_scan(empty_state(cfg, dev), g[0], d[0], cfg, vocab=va)
    carry, T_all, stats = track_sequence_scan(carry, g[1:], d[1:], cfg, vocab=va)
    T0 = np.eye(4, dtype=np.float32)[None]
    return np.concatenate([T0, T_all.cpu().numpy()]), carry.state, stats.cpu().numpy()
