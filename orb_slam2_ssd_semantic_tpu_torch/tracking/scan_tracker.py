"""Whole-sequence tracking (counterpart of the JAX package's
`tracking/scan_tracker.py`): the offline mode in which all frames are
uploaded once and the full per-frame SLAM update runs over them, with
only the trajectory and per-frame stats coming back.

The JAX module runs the sequence as one `lax.scan` with the keyframe
branch under `lax.cond`. Here the scan is a host loop over the frames
that never reads the card: each frame is two CUDA-graph replays,
- the per-frame half of a step, the tracker's `fused_track_step` (frame
  build, motion model with the reference-keyframe fallback, local-map
  tracking, keyframe decision, velocity), replayed from the carry's
  `TrackStepRunner` graph (`tracking/graphed_track.py`);
- the keyframe branch and the carry's update (`_keyframe_branch`),
  replayed from the carry's `KeyframeBranchRunner` graph: insertion,
  local mapping under a nested `device_cond` on `n_kfs >= 3`, loop
  DETECTION with a vocabulary (`_detect_loop`, in the JAX scan's order:
  `Tracker.process` runs loop closing before local mapping), the
  geometry mask's view ring with `use_geom` and the re-anchor, all under
  `mapping/graph_cond.py::device_cond` on `need_kf`: conditional graph
  nodes on the card, whose bodies run only where the device's predicate
  holds. The frame counters (`frames_since_kf`, `ref_kf_inliers`,
  `frame_idx`) are 0-d device tensors, as in JAX's carry.
The carries of one run share the runners (made by `init_scan`), so a
run captures each graph once. Per-frame poses, stats and keyframe-relative
records stay on the device until the caller fetches them: nothing in a
segment waits on the card, and the host queues frame i + 1 while the
card runs frame i.

With `use_flow` the flow mask runs on every frame against the frame
before it (`prev_grays`); with `use_geom` the geometry mask runs against
the carry's ring of keyframe views (seeded with frame 0 by `init_scan`,
fed by every keyframe event), at the motion model's predicted pose. Each
mask is replayed from its graph in the carry's `MaskRunner`
(`dynamic/graphed_masks.py`) before the frame's tracking graph, as JAX
runs both masks inside its scan body: a masked frame is then three or
four graph launches, and a masked segment waits on nothing either.

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
from orb_slam2_ssd_semantic_tpu_torch.dynamic.geommask import (
    GeomRefViews,
    empty_ref_views,
    insert_ref_view,
)
from orb_slam2_ssd_semantic_tpu_torch.dynamic.graphed_masks import MaskRunner
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.io import vocabulary as voc
from orb_slam2_ssd_semantic_tpu_torch.mapping import local_mapping
from orb_slam2_ssd_semantic_tpu_torch.mapping.graph_cond import device_cond
from orb_slam2_ssd_semantic_tpu_torch.mapping.graphed_step import (
    GraphedStep,
    GraphRunner,
    config_key,
)
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import (
    SlamState,
    covisibility_row,
    empty_state,
)
from orb_slam2_ssd_semantic_tpu_torch.tracking import tracker as tk
from orb_slam2_ssd_semantic_tpu_torch.tracking.graphed_track import (
    InsertKeyframeRunner,
    TrackStepRunner,
)
from orb_slam2_ssd_semantic_tpu_torch.utils import precision
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import row, scatter

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
    frames_since_kf: torch.Tensor  # () int64
    ref_kf_inliers: torch.Tensor  # () int64
    frame_idx: torch.Tensor  # () int64
    word_db: torch.Tensor  # (F, K) int64 per-keyframe BoW words (-1 empty)
    val_db: torch.Tensor  # (F, K) f32 deduplicated TF-IDF values
    cons_count: torch.Tensor  # (F,) int32 consecutive-consistency counters
    # The keyframe branch's runner (its CUDA graph on the card), made by
    # `init_scan` and shared by every carry that follows.
    branch: "KeyframeBranchRunner"
    # The tracking step's runner, the same way.
    track: TrackStepRunner
    # The geometry mask's reference views (`use_geom`), else None.
    geom_db: GeomRefViews | None = None
    # The dynamic masks' runner, made by `init_scan` (or by the first
    # masked scan from a carry without one) and shared the same way.
    masks: MaskRunner | None = None

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
    keypoint of valid depth spawned as a map point (inserted through an
    `InsertKeyframeRunner`'s graph); with `use_geom` it is also the first
    view of the geometry mask's ring. Reads nothing on the host."""
    dev = state.kfs.valid.device
    frame = tk.build_frame(gray0, depth0, cfg)
    T0 = torch.eye(4, dtype=torch.float32, device=dev)
    kp_point = torch.full((frame.feats.capacity,), -1, dtype=torch.int64, device=dev)
    state, kp_point = InsertKeyframeRunner(dev).step(state, frame, T0, kp_point, 0, 0.0, cfg,
                                                     spawn_all=True)
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
        velocity=torch.eye(4, dtype=torch.float32, device=dev),
        frames_since_kf=torch.zeros((), dtype=torch.int64, device=dev),
        ref_kf_inliers=(frame.is_stereo & frame.feats.valid).sum(),
        frame_idx=torch.ones((), dtype=torch.int64, device=dev),
        word_db=word_db, val_db=val_db, cons_count=cons, geom_db=geom_db,
        branch=KeyframeBranchRunner(dev), track=TrackStepRunner(dev), masks=MaskRunner(dev))


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
    uid_cur = row(uid, slot)
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


@dataclasses.dataclass
class BranchArgs:
    """The keyframe branch's tensor arguments, as its graph takes them:
    what the tracking step returned for the frame and the carry it
    updates."""

    state: SlamState
    frame: tk.Frame
    T_cw: torch.Tensor
    velocity: torch.Tensor
    kp_point: torch.Tensor
    packed: torch.Tensor  # the tracking step's [T_cw (16), status, need_kf, n_inliers, ...]
    last_T_cw: torch.Tensor
    frames_since_kf: torch.Tensor
    ref_kf_inliers: torch.Tensor
    frame_idx: torch.Tensor
    word_db: torch.Tensor
    val_db: torch.Tensor
    cons_count: torch.Tensor
    geom_db: GeomRefViews | None


def _keyframe_branch(a: BranchArgs, cfg: SlamConfig, vocab: VocabArrays | None,
                     use_geom: bool, with_rel: bool):
    """JAX's `do_insert` under `lax.cond(need_kf, ...)` and its carry
    update (`scan_tracker.py:315-383` of the JAX package): on a keyframe,
    insertion, local mapping once three keyframes exist, loop detection
    with a vocabulary, the geometry mask's view ring with `use_geom` and,
    with `reanchor_on_kf`, the re-anchor on the mapped pose and its
    velocity. Returns (state, T_cw, velocity, kp_point, frames_since_kf,
    ref_kf_inliers, frame_idx, word_db, val_db, cons_count, geom_db, stats
    (4,) [status, n_inl, n_kfs, loop_cand], and with `with_rel` T_rel
    (4, 4) and the reference keyframe's uid, else None twice)."""
    t = cfg.tracking
    need_kf = a.packed[17] > 0.5
    status = a.packed[16].to(torch.int64)
    no_cand = torch.full((), -1, dtype=torch.int64, device=a.T_cw.device)

    def do_insert(op):
        state, kp_point, word_db, val_db, cons, geom_db = op
        state, kp_point = tk.insert_keyframe(state, a.frame, a.T_cw, kp_point, a.frame_idx,
                                             a.frame_idx.to(torch.float32), cfg)
        state = device_cond(state.n_kfs >= 3, lambda s: local_mapping.local_mapping_step(s, cfg),
                            lambda s: s, state)
        loop_cand = no_cand
        if vocab is not None:
            word_db, val_db, cons, loop_cand = _detect_loop(state, a.frame, word_db, val_db, cons,
                                                            cfg, vocab)
        if use_geom:
            geom_db = insert_ref_view(geom_db, a.T_cw, a.frame.feats.uv, a.frame.kp_depth,
                                      a.frame.feats.valid & a.frame.is_stereo)
        return state, kp_point, word_db, val_db, cons, geom_db, loop_cand

    state, kp_point, word_db, val_db, cons, geom_db, loop_cand = device_cond(
        need_kf, do_insert, lambda op: op + (no_cand,),
        (a.state, a.kp_point, a.word_db, a.val_db, a.cons_count, a.geom_db))
    T_cw, vel = a.T_cw, a.velocity
    if t.reanchor_on_kf:
        # Re-anchor on the BA-refined pose; the velocity follows it.
        T_cw = torch.where(need_kf, row(state.kfs.T_cw, state.last_kf), T_cw)
        vel = torch.where(need_kf, tk.motion_velocity(T_cw, a.last_T_cw, status, cfg), vel)
    zero = torch.zeros_like(a.frames_since_kf)
    frames_since_kf = torch.where(need_kf, zero, a.frames_since_kf + 1)
    # Reference count: the new keyframe's landmark associations (tracked +
    # spawned), NeedNewKeyFrame's nRefMatches.
    ref_kf_inliers = torch.where(need_kf, (kp_point >= 0).sum(), a.ref_kf_inliers)
    stats = torch.stack([status, a.packed[18].to(torch.int64), state.n_kfs.to(torch.int64),
                         loop_cand])
    T_rel = ref_uid = None
    if with_rel:
        T_rel = T_cw @ se3.se3_inverse(row(state.kfs.T_cw, state.last_kf))
        ref_uid = row(state.kfs.uid, state.last_kf)
    return (state, T_cw, vel, kp_point, frames_since_kf, ref_kf_inliers, a.frame_idx + 1,
            word_db, val_db, cons, geom_db, stats, T_rel, ref_uid)


class KeyframeBranchRunner(GraphRunner):
    """`step(args, cfg, ...)` is `_keyframe_branch`, replayed from one CUDA
    graph per (configuration, vocabulary, `use_geom`, `with_rel`) on the
    card, its keyframe body under conditional nodes. The vocabulary's
    tensors are read where they lie, not copied in: the graph keeps them,
    and they must not change. `device=None` is the card (raises without
    one)."""

    @staticmethod
    def _key(cfg: SlamConfig, vocab, use_geom: bool, with_rel: bool):
        return config_key(cfg), None if vocab is None else id(vocab), use_geom, with_rel

    def stats(self, cfg: SlamConfig, vocab=None, use_geom: bool = False,
              with_rel: bool = False) -> dict:
        """That graph's capture: host ms (and of them the first replay's,
        which uploads the graph), private pools' bytes, replays, and B1's and
        B2's launches recorded outside and inside its conditional bodies,
        with each body's record (`GraphedStep.bodies`)."""
        g = self._captured[self._key(cfg, vocab, use_geom, with_rel)]
        return dict(capture_ms=g.capture_ms, upload_ms=g.upload_ms, pool_bytes=g.pool_bytes,
                    replays=g.replays, captured=dict(g.captured), conditional=dict(g.conditional),
                    bodies=g.bodies)

    @precision.scoped
    def step(self, args: BranchArgs, cfg: SlamConfig, vocab: VocabArrays | None = None,
             use_geom: bool = False, with_rel: bool = False):
        """`_keyframe_branch(args, ...)` (capturing first if this kind has no
        graph yet), every tensor fresh or the caller's own."""
        graph = self._graph(self._key(cfg, vocab, use_geom, with_rel), lambda: GraphedStep(
            lambda a: _keyframe_branch(a, cfg, vocab, use_geom, with_rel), args, self.device,
            "KeyframeBranchRunner", "branch"))
        return graph(args)


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
    if use_flow and prev_grays is None:
        prev_grays = torch.cat([grays[:1], grays[:-1]])
    if use_geom and carry.geom_db is None:
        raise ValueError("use_geom needs a carry made by init_scan(..., use_geom=True)")
    c = carry
    if (use_flow or use_geom) and c.masks is None:
        c = c.replace(masks=MaskRunner(grays.device))
    T_out, stats_out, rel_out, uid_out = [], [], [], []
    for i in range(grays.shape[0]):
        mask = None
        if use_flow:
            mask = c.masks.flow(prev_grays[i], grays[i], cfg.dynamic)
        if use_geom:
            gmask = c.masks.geometry(c.geom_db, c.velocity @ c.last_T_cw,
                                     tk.depth_metres(depths[i]), cfg.camera, cfg.dynamic)
            mask = gmask if mask is None else mask & gmask
        state, frame, T_cw, vel, kp_point, packed = c.track.step(
            c.state, grays[i], depths[i], c.last_frame, c.last_T_cw, c.last_kp_point, c.velocity,
            c.frames_since_kf, c.ref_kf_inliers, cfg, static_mask=mask)
        (state, T_cw, vel, kp_point, frames_since_kf, ref_kf_inliers, frame_idx, word_db, val_db,
         cons, geom_db, stats, T_rel, ref_uid) = c.branch.step(
            BranchArgs(state, frame, T_cw, vel, kp_point, packed, c.last_T_cw, c.frames_since_kf,
                       c.ref_kf_inliers, c.frame_idx, c.word_db, c.val_db, c.cons_count,
                       c.geom_db if use_geom else None),
            cfg, vocab, use_geom, with_rel)
        c = c.replace(
            state=state, last_frame=frame, last_T_cw=T_cw, last_kp_point=kp_point, velocity=vel,
            frames_since_kf=frames_since_kf, ref_kf_inliers=ref_kf_inliers, frame_idx=frame_idx,
            word_db=word_db, val_db=val_db, cons_count=cons,
            geom_db=geom_db if use_geom else c.geom_db)
        T_out.append(T_cw)
        stats_out.append(stats)
        if with_rel:
            rel_out.append(T_rel)
            uid_out.append(ref_uid)
    out = (c, torch.stack(T_out), torch.stack(stats_out))
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
