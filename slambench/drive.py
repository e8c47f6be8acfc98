"""The general generator: it builds what a configuration describes (the
port's `SlamConfig`, the vocabulary, the scene's frames on the card) and
drives the port's entry points as a traffic file says, in one of the two
modes users run:

- `offline_jobs`: back-to-back jobs, each a fresh map over the
  configuration's offline frames through `track_sequence_segmented` with
  a `LoopCloser`;
- `live_session`: one `Tracker.process` session, closed loop, each frame
  handed in as host arrays when the previous pose returns, the scene's
  frames replayed forth and back so that camera and walkers move without
  a jump.

A traffic file's `mode` names one of these two, and its other keys are
that mode's parameters: a mix in either mode is data alone, while a mix
that drives the port some other way (another entry point, open-loop
arrivals) needs code here and in `run.py`.

From the port it takes the entry points and their spans and counters;
what it keeps of each answer is what the reference judges.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from slambench.record import Job, Record
from slambench.scene import render, synthetic

STATUS_LOST = 2  # `stats[:, 0]` of a segmented run: 0 OK, 1 WEAK, 2 LOST


def noise_seed(run_seed: int, k: int = 0) -> int:
    """The key of render `k`'s depth noise for a run's `--seed` (any whole
    number)."""
    return (int(run_seed) * 2654435761 + k * 40503 + 0x5EED) % (1 << 31)


def slam_config(overrides: dict, vocabulary_path: str):
    """The port's `SlamConfig` with the configuration's overrides, group by
    group, and the vocabulary's file."""
    from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig

    base = SlamConfig()
    groups = {g: dataclasses.replace(getattr(base, g), **fields) for g, fields in overrides.items()}
    cfg = base.replace(**groups)
    return cfg.replace(loop=dataclasses.replace(cfg.loop, vocabulary_path=vocabulary_path))


def vocabulary_file(spec: dict, build_dir: Path) -> str:
    """The configuration's vocabulary, made once from its seed into a
    fixed file of the checkout's build directory."""
    from orb_slam2_ssd_semantic_tpu_torch.io import vocabulary as voc

    if spec["kind"] != "random_tree":
        raise ValueError(f"unknown vocabulary {spec['kind']!r}")
    path = build_dir / f"orbvoc_random_s{spec['seed']}_k{spec['k']}_d{spec['depth']}.npz"
    if not path.exists():
        build_dir.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.stem + f".{os.getpid()}.tmp.npz")
        voc.save_binary(voc.make_random_vocabulary(seed=int(spec["seed"]), k=int(spec["k"]),
                                                   depth=int(spec["depth"])), str(tmp))
        os.replace(tmp, path)
    return str(path)


def render_scene(scene: synthetic.Scene, cam, run_seed: int, device, k: int = 0):
    """The scene's frames on `device`, with render `k`'s depth noise:
    (grays (n, H, W) uint8, depths (n, H, W) uint16 mm)."""
    return render.render_frames(scene.poses_wc, cam, scene.room, scene.boxes,
                                seed=scene.texture_seed, ss=scene.supersample,
                                depth_noise=scene.depth_noise, moving_boxes=scene.walkers,
                                device=device, noise_seed=noise_seed(run_seed, k))


def map_answers(state, scene, scene_frame) -> dict:
    """The map a run left: its keyframes in order of insertion with the
    true poses of their frames and the walkers there (`scene_frame(frame
    ids)` gives the scene's indices), and its points with the index of
    each one's reference keyframe among them."""
    kfs, pts = state.kfs, state.points
    valid = kfs.valid.cpu().numpy()
    slots = np.nonzero(valid)[0]
    slots = slots[np.argsort(kfs.uid.cpu().numpy()[slots], kind="stable")]
    at = np.full(valid.shape[0], -1)
    at[slots] = np.arange(len(slots))
    ref = pts.ref_kf.cpu().numpy()
    keep = pts.valid.cpu().numpy() & (ref >= 0) & (at[np.clip(ref, 0, len(at) - 1)] >= 0)
    at_scene = scene_frame(kfs.frame_id.cpu().numpy()[slots])
    return dict(kf_T_cw=kfs.T_cw.cpu().numpy()[slots], kf_W_true=scene.poses_wc[at_scene],
                kf_moving=None if scene.walkers is None else scene.walkers[at_scene],
                points=pts.pos.cpu().numpy()[keep], point_kf=at[ref[keep]])


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---- offline jobs -------------------------------------------------------------


class OfflineJobs:
    """Whole jobs over the configuration's offline frames, taking turns
    over the renders `frames` [(grays, depths)]."""

    def __init__(self, cfg, vocab_path: str, frames: list, segment_len: int, device):
        from orb_slam2_ssd_semantic_tpu_torch.io import vocabulary as voc

        self.cfg, self.frames = cfg, frames
        self.turn = 0  # jobs run so far
        self.segment_len, self.device = segment_len, device
        self.vocab = voc.to_device(voc.load_binary(vocab_path), device)
        self.use_flow = cfg.dynamic.enable_flow
        self.use_geom = cfg.dynamic.enable_geometry

    @property
    def n_frames(self) -> int:
        return self.frames[0][0].shape[0]

    def run(self, n_frames: int | None = None):
        """The next job, on the next render in turn, over its first
        `n_frames` frames (all by default): (SegmentedResult or None where
        it raised, its wall seconds)."""
        from orb_slam2_ssd_semantic_tpu_torch.mapping.loop_closing import LoopCloser
        from orb_slam2_ssd_semantic_tpu_torch.tracking.segmented import track_sequence_segmented

        n = n_frames or self.n_frames
        grays, depths = self.frames[self.turn % len(self.frames)]
        self.turn += 1
        t0 = time.perf_counter()
        try:
            with record_function("slambench.job"):
                res = track_sequence_segmented(
                    grays[:n], depths[:n], self.cfg, vocab=self.vocab,
                    segment_len=self.segment_len,
                    loop_closer=LoopCloser(self.cfg, device=self.device),
                    use_flow=self.use_flow, use_geom=self.use_geom, device=self.device)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        except Exception:  # noqa: BLE001 - a job that raises is counted failed and reported
            _log("a job raised:\n" + traceback.format_exc())
            res = None
        return res, time.perf_counter() - t0

    @staticmethod
    def job(res, n: int, wall_s: float) -> Job:
        if res is None:
            return Job(n, wall_s, 0.0, 0, 0, 0, n)
        return Job(n, wall_s, res.scan_s, len(res.corrections), res.n_loop_events,
                   len(res.kf_pose_at_insert), int((res.stats[:, 0] == STATUS_LOST).sum()))

    @staticmethod
    def answers(res, scene: synthetic.Scene, n: int) -> dict:
        """What the reference judges of one job: every frame's pose as the
        scan tracked it and the map the job left, beside the scene's
        truth."""
        W_true = scene.poses_wc[:n]
        if res is None:
            nan = np.full((n, 4, 4), np.nan)
            return dict(T_cw=nan, W_true=W_true, kf_T_cw=nan[:0], kf_W_true=W_true[:0],
                        kf_moving=None, points=np.zeros((0, 3)), point_kf=np.zeros(0, int))
        return dict(T_cw=res.T_all, W_true=W_true,
                    **map_answers(res.carry.state, scene, lambda fid: fid))


def run_offline(rec: Record, jobs: OfflineJobs, scene, seconds: float):
    """The window: whole jobs back to back until `seconds` have passed.
    Returns the answers of each job."""
    n = jobs.n_frames
    out = []
    t0 = time.perf_counter()
    while True:
        res, wall = jobs.run()
        rec.jobs.append(jobs.job(res, n, wall))
        out.append(jobs.answers(res, scene, n))
        del res
        if time.perf_counter() - t0 >= seconds:
            break
    rec.window_s = time.perf_counter() - t0
    rec.frames = sum(j.frames for j in rec.jobs)
    rec.failed = sum(j.lost for j in rec.jobs)
    return out


def trace_offline(rec: Record, jobs: OfflineJobs, scene) -> dict:
    """The traced sub-window: one more job, over the first segment.
    Returns its answers."""
    from slambench import trace

    n = 1 + jobs.segment_len
    (res, wall), rec.trace = trace.profile(lambda: jobs.run(n), n)
    rec.trace_failed = jobs.job(res, n, wall).lost
    return jobs.answers(res, scene, n)


# ---- the live session ---------------------------------------------------------


class LiveSession:
    """One `Tracker.process` session over host frames."""

    def __init__(self, cfg, grays_host, depths_host, fps: float, device):
        from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker

        self.tracker = Tracker(cfg, device=device)
        self.grays, self.depths, self.fps = grays_host, depths_host, fps
        self.k = 0  # frames handed in so far
        self.scene_index: list = []  # each frame's index in the scene
        self.poses: list = []  # each frame's returned T_cw (NaN where it raised)
        self.lost: list = []

    def index(self, k: int) -> int:
        n = self.grays.shape[0]
        p = k % (2 * (n - 1))
        return p if p < n else 2 * (n - 1) - p

    def step(self) -> float:
        """Hand in the next frame; returns the host ms to its pose."""
        i = self.index(self.k)
        t0 = time.perf_counter()
        try:
            with record_function("slambench.frame"):
                T = self.tracker.process(self.grays[i], self.depths[i], self.k / self.fps)
            lost = self.tracker.status == "LOST"
        except Exception:  # noqa: BLE001 - a frame that raises is counted failed and reported
            _log(f"frame {self.k} raised:\n" + traceback.format_exc())
            T, lost = np.full((4, 4), np.nan, np.float32), True
        ms = (time.perf_counter() - t0) * 1e3
        self.scene_index.append(i)
        self.poses.append(T)
        self.lost.append(lost)
        self.k += 1
        return ms

    def stage_totals(self) -> dict:
        return {k: (v.count, v.total_s) for k, v in self.tracker.metrics.stages.items()}

    def answers(self, scene: synthetic.Scene, first: int) -> dict:
        """What the reference judges: the poses returned for frames
        `first` on (those before are context), and the map now."""
        idx = np.asarray(self.scene_index)
        return dict(T_cw=np.stack(self.poses), W_true=scene.poses_wc[idx], first=first,
                    **map_answers(self.tracker.state, scene, lambda fid: idx[fid]))


def warm_live(session: LiveSession, traffic: dict) -> int:
    """Set-up's frames: until each stage of `warmup_until` that the
    configuration runs has run (every graph captured), then
    `warmup_after` more; at most `warmup_max`. Returns frames handed in."""
    cfg = session.tracker.cfg
    want = [s for s in traffic["warmup_until"]
            if not (s == "mask.flow" and not cfg.dynamic.enable_flow)
            and not (s == "mask.geometry" and not cfg.dynamic.enable_geometry)]
    after = None
    while session.k < traffic["warmup_max"]:
        session.step()
        stages = session.tracker.metrics.stages
        if after is None and all(s in stages for s in want):
            after = session.k + traffic["warmup_after"]
        if after is not None and session.k >= after:
            break
    missing = [s for s in want if s not in session.tracker.metrics.stages]
    if missing:
        _log(f"warm-up: stages {missing} had not run after {session.k} frames")
    return session.k


def run_live(rec: Record, session: LiveSession, seconds: float):
    """The window: the session goes on frame by frame until `seconds`
    have passed."""
    before = session.stage_totals()
    first = session.k
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        rec.frame_ms.append(session.step())
    rec.window_s = time.perf_counter() - t0
    after = session.stage_totals()
    rec.stages = {k: (c - before.get(k, (0, 0.0))[0], s - before.get(k, (0, 0.0))[1])
                  for k, (c, s) in after.items()}
    rec.frames = session.k - first
    rec.failed = int(sum(session.lost[first:]))
    return first


def trace_live(rec: Record, session: LiveSession, traffic: dict):
    """The traced sub-window: the session's next `trace_frames` frames."""
    from slambench import trace

    n = int(traffic["trace_frames"])
    _, rec.trace = trace.profile(lambda: [session.step() for _ in range(n)], n)
    rec.trace_failed = int(sum(session.lost[-n:]))
