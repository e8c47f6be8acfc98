#!/usr/bin/env python3
"""The scenarios of `chip_smoke.py`'s phase 7 (loop closing), run through
the JAX package on the CPU: the numbers the port's run on the card is
read against.

    JAX_PLATFORMS=cpu python loop_reference_jax.py [closure] [tracker]

- `closure` (7a): `tests/test_loop_e2e.py`'s forced closure (BoxRoom
  seed 3, 18 keyframes over 1.3 laps, 0.30 m of injected drift) at that
  test's own small map config (32 keyframes), on the named vocabulary,
  with global BA off and on, and the open arc of the same length. Prints
  where each run closed and the closure keyframe's position error before
  and after.
- `tracker` (7c): `Tracker.process` on
  `SyntheticSequence(trajectory="loop", n_frames=90, loop_laps=1.35,
  depth_noise=0.02)` at 640x480 with the default `SlamConfig` on the
  named vocabulary, with loop closing on (`min_kfs_before_loop=6`) and
  off. Prints both ATEs, the loops closed and the relocalizations.

The named vocabulary is the one `chip_smoke.py` builds: a DBoW2 tree of
k = 10, depth = 4 from seed 3 (`make_random_vocabulary`), saved under
`build/loop_reference/`. Each result is one JSON line on stdout.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402

from orb_slam2_ssd_semantic_tpu.config import SlamConfig  # noqa: E402
from orb_slam2_ssd_semantic_tpu.eval.ate import evaluate_ate_xyz  # noqa: E402
from orb_slam2_ssd_semantic_tpu.io import vocabulary as voc  # noqa: E402
from orb_slam2_ssd_semantic_tpu.io.synthetic import BoxRoom, SyntheticSequence  # noqa: E402
from orb_slam2_ssd_semantic_tpu.mapping.local_mapping import fuse_map_points  # noqa: E402
from orb_slam2_ssd_semantic_tpu.mapping.loop_closing import LoopCloser  # noqa: E402
from orb_slam2_ssd_semantic_tpu.mapping.map_state import empty_state  # noqa: E402
from orb_slam2_ssd_semantic_tpu.tracking import tracker as tk  # noqa: E402

VOCAB_SEED, VOCAB_K, VOCAB_DEPTH = 3, 10, 4


def named_vocabulary() -> str:
    d = Path(__file__).resolve().parent / "build" / "loop_reference"
    d.mkdir(parents=True, exist_ok=True)
    path = d / f"orbvoc_random_k{VOCAB_K}_d{VOCAB_DEPTH}.npz"
    voc.save_binary(voc.make_random_vocabulary(seed=VOCAB_SEED, k=VOCAB_K, depth=VOCAB_DEPTH),
                    str(path))
    return str(path)


def circle_poses(n, radius=0.55, room=(5.0, 3.0, 6.0)):
    """`tests/test_loop_e2e.py::_circle_poses`: a circle on which the
    camera yaws a full turn."""
    sx, sy, sz = room
    out = []
    for i in range(n):
        a = 2 * np.pi * i / n
        ca, sa = np.cos(a), np.sin(a)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.asarray([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]], np.float32)
        T[:3, 3] = [sx / 2 + radius * np.sin(a), sy / 2, sz / 2 + radius * (np.cos(a) - 1.0) * 0.5]
        out.append(T)
    return out


def closure_config(vocab: str, run_global_ba: bool) -> SlamConfig:
    base = SlamConfig()
    return SlamConfig(
        camera=base.camera,
        map=dataclasses.replace(base.map, max_keyframes=32, local_ba_window=4,
                                local_ba_fixed_anchors=2, triangulation_neighbors=2,
                                fuse_neighbors=2),
        loop=dataclasses.replace(base.loop, enabled=True, min_kfs_before_loop=4,
                                 covisibility_consistency_th=2, run_global_ba=run_global_ba,
                                 vocabulary_path=vocab),
    )


def run_closure(cfg: SlamConfig, n_kf=18, drift_total=0.30, revisit=True) -> dict:
    room = BoxRoom(seed=3, cam=cfg.camera)
    if revisit:
        n_pose = max(int(n_kf / 1.3), 4)
        poses = [circle_poses(n_pose)[i % n_pose] for i in range(n_kf)]
    else:
        poses = circle_poses(2 * n_kf)[:n_kf]
    state = empty_state(cfg)
    lc = LoopCloser(cfg)
    closed_at, errs = [], None
    t0 = time.perf_counter()
    for i, T_wc in enumerate(poses):
        gray, depth = room.render(T_wc)
        frame = tk.build_frame(jnp.asarray(gray, jnp.float32), jnp.asarray(depth), cfg)
        d = drift_total * i / max(n_kf - 1, 1)
        T_cw_true = np.linalg.inv(T_wc).astype(np.float32)
        T_drift = np.eye(4, dtype=np.float32)
        T_drift[:3, 3] = [d, 0.0, 0.4 * d]
        kp = jnp.full((cfg.orb.max_keypoints,), -1, jnp.int32)
        state, kp = tk.insert_keyframe(state, frame, jnp.asarray(T_cw_true @ T_drift), kp, i,
                                       float(i), cfg, spawn_all=True)
        slot = int(state.last_kf)
        if i > 0:
            state = fuse_map_points(state, cfg)
        e_pre = float(np.linalg.norm(np.asarray(state.kfs.T_cw[slot])[:3, 3] - T_cw_true[:3, 3]))
        state, closed = lc.on_keyframe(state, slot)
        if closed:
            closed_at.append(i)
            if errs is None:
                errs = (e_pre, float(np.linalg.norm(
                    np.asarray(state.kfs.T_cw[slot])[:3, 3] - T_cw_true[:3, 3])))
    return dict(closed_at=closed_at, err_before_m=None if errs is None else errs[0],
                err_after_m=None if errs is None else errs[1],
                seconds=time.perf_counter() - t0)


def tracker_configs(vocab: str):
    base = SlamConfig()
    on = dataclasses.replace(base, loop=dataclasses.replace(
        base.loop, enabled=True, min_kfs_before_loop=6, vocabulary_path=vocab))
    off = dataclasses.replace(base, loop=dataclasses.replace(
        base.loop, enabled=False, enable_relocalization=False))
    return on, off


def run_tracker(cfg: SlamConfig, seq, frames) -> dict:
    tr = tk.Tracker(cfg)
    t0 = time.perf_counter()
    for i, (g, d) in enumerate(frames):
        tr.process(g, d, float(seq.stamps[i]))
    ate = evaluate_ate_xyz(tr.camera_positions(), seq.gt_positions()[: tr.frame_id]).rmse
    st = tr.metrics.stages
    return dict(ate_m=float(ate), status=tr.status,
                loops_closed=tr.metrics.counters.get("loops_closed", 0),
                lost=tr.metrics.counters.get("lost", 0),
                relocalizations=st["relocalization"].count if "relocalization" in st else 0,
                loop_closing_calls=st["loop_closing"].count if "loop_closing" in st else 0,
                keyframes=tr.metrics.counters.get("keyframes", 0),
                seconds=time.perf_counter() - t0)


def main(argv) -> int:
    parts = argv or ["closure", "tracker"]
    vocab = named_vocabulary()
    if "closure" in parts:
        for gba in (False, True):
            res = run_closure(closure_config(vocab, gba))
            print(json.dumps(dict(scenario="7a closure", run_global_ba=gba) | res), flush=True)
        res = run_closure(closure_config(vocab, True), revisit=False)
        print(json.dumps(dict(scenario="7a open arc", run_global_ba=True) | res), flush=True)
    if "tracker" in parts:
        seq = SyntheticSequence(n_frames=90, trajectory="loop", loop_laps=1.35, depth_noise=0.02)
        frames = [seq.gray_depth(i) for i in range(90)]
        on, off = tracker_configs(vocab)
        r_on = run_tracker(on, seq, frames)
        print(json.dumps(dict(scenario="7c loop on") | r_on), flush=True)
        r_off = run_tracker(off, seq, frames)
        print(json.dumps(dict(scenario="7c loop off") | r_off), flush=True)
        print(json.dumps(dict(scenario="7c gate", jax_meets_own_gate=bool(
            r_on["ate_m"] < 0.75 * r_off["ate_m"]))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
