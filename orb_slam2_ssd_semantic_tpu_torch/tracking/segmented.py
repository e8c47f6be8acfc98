"""Segmented whole-sequence tracking with mid-run loop correction
(counterpart of the JAX package's `tracking/segmented.py`).

`scan_tracker.track_sequence_scan` tracks, maps and flags loop
candidates; the reference corrects the map the moment a loop verifies
(LoopClosing::CorrectLoop, LoopClosing.cc:544-640), so that every later
frame tracks against the corrected map. Here the sequence runs as
equal-length scan segments, and between two segments the host:

  1. reads the segment's per-frame stats (status, inliers, flagged loop
     candidate slots) and keyframe snapshot in one fetch;
  2. verifies each flagged candidate geometrically
     (`LoopCloser._estimate_loop_transform`), and applies a correction
     only when two estimates from different keyframes imply the same
     correction;
  3. applies it (`LoopCloser._correct`: pose graph, rigid point carry,
     SearchAndFuse, global BA, guards);
  4. remaps the live tracking anchor (`last_T_cw`) by its reference
     keyframe's correction, so the next segment runs from the corrected
     carry without a pose jump.

As the JAX module does, the runner dispatches segment s+1 on the
uninspected carry before it fetches segment s, so that the host's read
and the verification hide behind the card's work, and after a
correction dispatches s+1 again from the corrected carry. A segment's
scan reads nothing on the host (`scan_tracker.py`), so its dispatch
returns once every frame is queued; its fetch is one device-to-host copy
into pinned memory, queued right behind the segment, whose event the
host waits on. The carries of one run share one `KeyframeBranchRunner`
and one `TrackStepRunner` (made by `init_scan`), so the keyframe branch
and the per-frame tracking step are each captured into one CUDA graph
once a run and replayed in every segment; what they return is never
overwritten by a later replay, so a carry kept for a correction stays as
it was.

The per-frame trajectory is kept keyframe-relative (uid + T_rel), as the
reference's SaveTrajectoryTUM (System.cc:476-502) keeps it: a correction
applied at any later point moves every earlier frame through its
reference keyframe (`resolve_trajectory`).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.mapping.loop_closing import LoopCloser
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import empty_state
from orb_slam2_ssd_semantic_tpu_torch.tracking import scan_tracker
from orb_slam2_ssd_semantic_tpu_torch.utils import precision


def _pack_segment(T_seg, stats_seg, T_rel, ref_uid, uid, valid, fid) -> torch.Tensor:
    """Poses, stats, the keyframe-relative records and the keyframe
    snapshot of a segment in one float32 tensor on the device."""
    return torch.cat([
        T_seg.reshape(-1),
        stats_seg.to(torch.float32).reshape(-1),
        T_rel.reshape(-1),
        ref_uid.to(torch.float32),
        uid.to(torch.float32),
        valid.to(torch.float32),
        fid.to(torch.float32),
    ])


def _start_fetch(packed: torch.Tensor):
    """Queue the segment's one device-to-host copy behind its work:
    (host tensor, event the copy records, None off the card)."""
    if packed.device.type != "cuda":
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _fetch(host: torch.Tensor, done) -> np.ndarray:
    """Wait for `_start_fetch`'s copy: the segment's values on the host."""
    if done is not None:
        done.synchronize()
    return host.numpy()


class SegmentedResult(NamedTuple):
    carry: object  # final ScanCarry
    T_all: np.ndarray  # (N, 4, 4) tracked world->camera poses (frame 0 = I)
    stats: np.ndarray  # (N-1, 4) per-frame [status, inliers, n_kfs, cand]
    traj: list  # per-frame (ref_kf_uid, T_rel) keyframe-relative records
    corrections: list  # (frame_idx, kf_slot, cand_slot, wall_s)
    n_loop_events: int  # flagged candidate events (pre-verification)
    # Host time spent waiting for the segments' fetches (JAX's `scan_s`):
    # what the card's tracking took beyond the host's own work.
    scan_s: float
    correct_s: float  # wall time inside verification + correction
    kf_pose_at_insert: dict  # uid -> (frame_idx, tracked pose at insert)


def resolve_trajectory(result: SegmentedResult) -> np.ndarray:
    """(N, 3) camera centres with every keyframe-relative record resolved
    against the FINAL (corrected) keyframe poses."""
    kfs = result.carry.state.kfs
    uid = kfs.uid.cpu().numpy()
    valid = kfs.valid.cpu().numpy()
    T_kf = kfs.T_cw.cpu().numpy()
    by_uid = {int(u): T_kf[i] for i, u in enumerate(uid) if valid[i] and u >= 0}
    uids_sorted = sorted(by_uid)
    insert = result.kf_pose_at_insert

    def kf_pose(u: int) -> np.ndarray:
        if u in by_uid:
            return by_uid[u]
        # A culled or evicted reference: chain through the nearest earlier
        # surviving keyframe with both keyframes' insertion poses:
        # T_u_final ~ (T_u_ins @ inv(T_a_ins)) @ T_a_final.
        earlier = [x for x in uids_sorted if x <= u]
        a = earlier[-1] if earlier else uids_sorted[0]
        if u in insert and a in insert:
            return (insert[u][1] @ np.linalg.inv(insert[a][1])) @ by_uid[a]
        return by_uid[a]

    out = []
    for ref_uid, T_rel in result.traj:
        T = T_rel @ kf_pose(ref_uid)
        out.append(-T[:3, :3].T @ T[:3, 3])
    return np.stack(out)


@precision.scoped
def track_sequence_segmented(
    g_dev,
    d_dev,
    cfg: SlamConfig,
    vocab: scan_tracker.VocabArrays | None = None,
    segment_len: int = 48,
    loop_closer: LoopCloser | None = None,
    use_flow: bool = False,
    use_geom: bool = False,
    verbose: bool = False,
    device=None,
) -> SegmentedResult:
    """g_dev (N, H, W) uint8 grays and d_dev (N, H, W) uint16 mm depths
    (tensors or numpy; moved to the device once). N must satisfy
    (N - 1) % segment_len == 0: frame 0 seeds `init_scan`. `vocab`: the
    vocabulary on the device, for in-scan loop detection. `device=None`
    runs on the card (raises without one). `use_flow` runs the flow mask
    on every frame of every segment against the frame before it
    (Tracking.cc:688-719); `use_geom` runs the geometry mask against the
    scan's ring of keyframe views (Geometry.cc:50-518)."""
    dev = device_mod.resolve(device)
    g_dev = torch.as_tensor(g_dev).to(dev)
    d_dev = torch.as_tensor(d_dev).to(dev)
    n = g_dev.shape[0]
    if (n - 1) % segment_len != 0:
        raise ValueError(f"{n} frames do not split into segments of {segment_len} after frame 0")
    n_seg = (n - 1) // segment_len

    lc = loop_closer or LoopCloser(cfg, device=dev)
    carry = scan_tracker.init_scan(empty_state(cfg, dev), g_dev[0], d_dev[0], cfg, vocab=vocab,
                                   use_geom=use_geom)
    T_parts: list = [np.eye(4, dtype=np.float32)[None]]
    stats_parts: list = []
    traj: list = [(0, np.eye(4, dtype=np.float32))]
    # uid -> (frame_idx, tracked pose at insertion) for every keyframe
    # ever seen live (survives culling; resolution anchors culled refs on
    # the nearest earlier surviving keyframe).
    kf_pose_at_insert: dict = {0: (0, np.eye(4, dtype=np.float32))}
    corrections: list = []
    n_loop_events = 0
    scan_s = 0.0
    correct_s = 0.0
    last_corrected_uid = -(10**9)
    # Transform-level consistency confirmation: a correction applies only
    # after TWO independently verified loop-transform estimates (from
    # different query keyframes) imply the SAME correction. Aliased
    # estimates lock onto different texture cells from one keyframe to
    # the next and disagree; true revisits re-measure the same drift (the
    # reference's consistency idea, LoopClosing.cc:200-290, lifted from
    # detection to the transform).
    pending_est = None  # (uid, cand_uid, D_t (3,))
    S = segment_len

    def dispatch(carry_in, s: int):
        """Queue segment s on the card from `carry_in` and its fetch behind
        it: (carry after it, (host buffer, event)). Waits on nothing."""
        lo = 1 + s * S
        hi = lo + S
        carry_out, T_seg, stats_seg, T_rel, ref_uid = scan_tracker.track_sequence_scan(
            carry_in, g_dev[lo:hi], d_dev[lo:hi], cfg, vocab=vocab, with_rel=True,
            prev_grays=g_dev[lo - 1:hi - 1] if use_flow else None, use_flow=use_flow,
            use_geom=use_geom)
        kfs = carry_out.state.kfs
        return carry_out, _start_fetch(_pack_segment(T_seg, stats_seg, T_rel, ref_uid, kfs.uid,
                                                     kfs.valid, kfs.frame_id))

    # Speculative pipeline: segment s+1 is queued on the uninspected carry
    # before segment s's values are fetched. A correction invalidates it,
    # and it is queued again from the corrected carry.
    pending = (0, *dispatch(carry, 0))
    while pending is not None:
        s, carry_after, fetch = pending
        pending = (s + 1, *dispatch(carry_after, s + 1)) if s + 1 < n_seg else None
        lo = 1 + s * S
        hi = lo + S
        t_scan = time.perf_counter()
        packed = _fetch(*fetch)
        scan_s += time.perf_counter() - t_scan
        F = carry_after.state.kfs.uid.shape[0]
        T_host = packed[:S * 16].reshape(S, 4, 4)
        stats_host = packed[S * 16:S * 20].reshape(S, 4)
        rel_host = packed[S * 20:S * 36].reshape(S, 4, 4)
        ruid_host = packed[S * 36:S * 37].astype(np.int64)
        k_uid = packed[S * 37:S * 37 + F].astype(np.int64)
        k_valid = packed[S * 37 + F:S * 37 + 2 * F] > 0.5
        k_fid = packed[S * 37 + 2 * F:S * 37 + 3 * F].astype(np.int64)
        carry = carry_after
        T_parts.append(T_host)
        stats_parts.append(stats_host)
        if verbose:
            print(f"# segment {s}: frames {lo}..{hi - 1} "
                  f"n_points={int(carry.state.points.valid.sum())} "
                  f"n_kfs={int(carry.state.n_kfs)} inl_min={int(stats_host[:, 1].min())}")

        # Keyframe-relative records, measured in the scan against the
        # reference keyframe's pose at track time: resolving them against
        # the final poses applies exactly the refinements each frame never
        # saw.
        live = k_valid & (k_uid >= 0)
        for slot in np.nonzero(live)[0]:
            u, f = int(k_uid[slot]), int(k_fid[slot])
            if u not in kf_pose_at_insert and lo <= f < hi:
                kf_pose_at_insert[u] = (f, T_host[f - lo])
        for i in range(S):
            traj.append((int(ruid_host[i]), rel_host[i]))

        # ---- mid-run loop verification + correction ----------------------
        cands = stats_host[:, 3]
        events = np.nonzero(cands >= 0)[0]
        n_loop_events += len(events)
        if len(events) == 0:
            continue
        t_corr = time.perf_counter()
        state = carry.state
        valid, fid, uid = k_valid, k_fid, k_uid
        corrected = False
        for i in events:
            cand = int(cands[i])
            if not valid[cand]:
                if verbose:
                    print(f"# segmented: frame {lo + int(i)} cand slot {cand} no longer valid")
                continue
            slots = np.nonzero(valid & (fid == lo + i))[0]
            if not len(slots):
                if verbose:
                    print(f"# segmented: frame {lo + int(i)} flagged but its keyframe was culled")
                continue
            kf = int(slots[0])
            # Throttle: one correction per revisit neighbourhood
            # (LoopClosing's mLastLoopKFid gate, LoopClosing.cc:129).
            if int(uid[kf]) - last_corrected_uid < cfg.loop.min_kfs_before_loop:
                if verbose:
                    print(f"# segmented: frame {lo + int(i)} throttled "
                          f"(uid {int(uid[kf])} vs last {last_corrected_uid})")
                continue
            ok, T_ji, n_inl = lc._estimate_loop_transform(state, kf, cand)
            if not ok:
                if verbose:
                    print(f"# segmented: frame {lo + int(i)} loop-transform estimate failed "
                          f"({n_inl} inliers)")
                continue
            # Implied correction D = measured vs current relative pose.
            T_kf = state.kfs.T_cw.cpu().numpy()
            T_cur_rel = T_kf[kf] @ np.linalg.inv(T_kf[cand])
            D_t = (np.asarray(T_ji) @ np.linalg.inv(T_cur_rel))[:3, 3]
            est = (int(uid[kf]), int(uid[cand]), D_t)
            if pending_est is None or est[0] - pending_est[0] > cfg.loop.min_kfs_before_loop:
                pending_est = est
                if verbose:
                    print(f"# segmented: frame {lo + int(i)} first verified estimate "
                          f"(|D|={np.linalg.norm(D_t):.3f} m), awaiting confirmation")
                continue
            diff = float(np.linalg.norm(D_t - pending_est[2]))
            scale = max(float(np.linalg.norm(D_t)), float(np.linalg.norm(pending_est[2])))
            if diff > 0.25 * scale + 0.02:
                if verbose:
                    print(f"# segmented: frame {lo + int(i)} estimate disagrees with pending "
                          f"({diff:.3f} m vs |D|={scale:.3f}), aliasing suspected; replaced")
                pending_est = est
                continue
            state_new, accepted = lc._correct(state, kf, cand, T_ji)
            if not accepted:
                if verbose:
                    print(f"# segmented: correction at frame {lo + int(i)} rejected by the "
                          "consistency guard")
                continue
            Tn = state_new.kfs.T_cw.cpu().numpy()
            if not np.isfinite(Tn[state_new.kfs.valid.cpu().numpy()]).all():
                if verbose:
                    print("# segmented: correction produced non-finite poses; skipped")
                continue
            state = state_new
            corrected = True
            pending_est = None
            last_corrected_uid = int(uid[kf])
            corrections.append((lo + int(i), kf, cand, time.perf_counter() - t_corr))
            if verbose:
                print(f"# segmented: loop corrected at frame {lo + int(i)} "
                      f"(kf slot {kf} -> cand {cand}, {n_inl} inliers)")
            break  # one correction per segment; the rest re-detect later

        if corrected:
            # Remap the live anchor by its reference keyframe's correction
            # (CorrectLoop's current-frame update): T'_cur = T_rel_to_ref @
            # T'_ref, with T_rel measured against the pre-correction pose.
            ref = int(carry.state.last_kf)
            T_ref_old = carry.state.kfs.T_cw[ref].cpu().numpy()
            T_ref_new = state.kfs.T_cw[ref].cpu().numpy()
            T_last = carry.last_T_cw.cpu().numpy()
            T_last_new = (T_last @ np.linalg.inv(T_ref_old)) @ T_ref_new
            carry = carry.replace(
                state=state,
                last_T_cw=torch.from_numpy(T_last_new.astype(np.float32)).to(dev),
                # Reset the consistency chains: the corrected map's
                # geometry changed under the counters.
                cons_count=torch.zeros_like(carry.cons_count),
            )
            # The next segment ran on the uncorrected carry: queue it again
            # from the corrected one.
            if pending is not None:
                pending = (pending[0], *dispatch(carry, pending[0]))
        correct_s += time.perf_counter() - t_corr

    T_all = np.concatenate(T_parts)
    stats = np.concatenate(stats_parts) if stats_parts else np.zeros((0, 4))
    return SegmentedResult(carry, T_all, stats, traj, corrections, n_loop_events, scan_s,
                           correct_s, kf_pose_at_insert)
