#!/usr/bin/env python3
"""The scenario of `chip_smoke.py`'s phase 8b (the segmented whole-sequence
runner), run through the JAX package on the CPU: the numbers the port's
run on the card is read against.

    JAX_PLATFORMS=cpu python scan_reference_jax.py [agree] [disagree] [plain]

The circuit is `tests/test_segmented.py`'s at 640x480:
`SyntheticSequence(n_frames=145, trajectory="loop", loop_laps=2.35,
depth_noise=0.01)`, frames quantized to uint8 gray and uint16 mm depth,
`segment_len=36`. The config is `bench.py`'s widths (`th_depth=80`, 128
keyframes, 16,384 map points, 1536 local-map candidates) with the test's
`max_frames_between_kfs=8` and `min_kfs_before_loop=6`, on the named
vocabulary of `chip_smoke.py` (a DBoW2 tree of k = 10, depth = 4 from
seed 3, saved under `build/scan_reference/`). Three runs:

- `agree`: a verifier whose `_estimate_loop_transform` returns the map's
  current relative pose (an implied correction D = 0, so every two
  estimates agree) and the real `_correct`. The config's minimum
  discrepancy (`min_correction_translation`, `min_correction_rotation_deg`)
  is 0 in this run, or `_correct` would refuse a D = 0 loop at its first
  gate;
- `disagree`: `test_segmented.py`'s stub, whose estimates alternate
  D = [0.3, 0, 0] and [-0.3, 0, 0.2], with a no-op `_correct`;
- `plain`: the real `LoopCloser`.

Each prints one JSON line: loop events, corrections (frame, keyframe
slot, candidate slot), per-frame statuses, raw and resolved ATE, and
the wall times; `agree` also, per correction, the resolved ATE of the
frames tracked before it (up to the end of its segment) against the
keyframe poses before and after `_correct`, and after the port's
`_correct` applied to JAX's pre-correction state, with the pose and point
differences between the two results. The views render
in a pool of worker processes, each frame's depth noise drawn as a
sequential render draws it.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

N_FRAMES, LAPS, DEPTH_NOISE, SEGMENT_LEN = 145, 2.35, 0.01, 36
VOCAB_SEED, VOCAB_K, VOCAB_DEPTH = 3, 10, 4
RENDER_WORKERS = 6

_SEQ = None


def _sequence():
    from orb_slam2_ssd_semantic_tpu.io.synthetic import SyntheticSequence

    return SyntheticSequence(n_frames=N_FRAMES, trajectory="loop", loop_laps=LAPS,
                             depth_noise=DEPTH_NOISE)


def _render_init():
    global _SEQ
    _SEQ = _sequence()


def _render(i: int):
    """Frame i, its depth noise drawn as a sequential render draws it (the
    draws of frames 0..i-1 skipped), quantized as the tests quantize."""
    seq = _SEQ
    rng = np.random.default_rng(seq.seed)
    for _ in range(i):
        rng.normal(0.0, seq.depth_noise, (seq.cam.height, seq.cam.width))
    g, d = seq.room.render(seq.poses_wc[i], seq.depth_noise, rng)
    return np.clip(g, 0, 255).astype(np.uint8), (d * 1000).astype(np.uint16)


def config(mod, vocabulary_path: str, agree: bool = False):
    """`bench.py`'s widths with the test's cadence and loop gap, from the
    config module `mod` (the JAX package's or the port's copy); with
    `agree`, no minimum discrepancy."""
    base = mod.SlamConfig()
    loop = dataclasses.replace(base.loop, enabled=True, min_kfs_before_loop=6,
                               vocabulary_path=vocabulary_path)
    if agree:
        loop = dataclasses.replace(loop, min_correction_translation=0.0,
                                   min_correction_rotation_deg=0.0)
    return dataclasses.replace(
        base, camera=dataclasses.replace(base.camera, th_depth=80.0),
        map=dataclasses.replace(base.map, max_keyframes=128, max_map_points=16384),
        tracking=dataclasses.replace(base.tracking, local_map_candidates=1536,
                                     max_frames_between_kfs=8),
        loop=loop)


def _tree(nt):
    if hasattr(nt, "_asdict"):
        return {k: _tree(v) for k, v in nt._asdict().items()}
    return np.array(nt)


def _port_on_jax_state(res, correction, applied, cfg, gt) -> dict:
    """One agreeing correction: the resolved ATE of the frames tracked
    before it (up to the end of its segment) against the keyframe poses
    before and after JAX's `_correct`, and after the port's `_correct` on
    JAX's pre-correction state (carried with `state_from_numpy`; `cfg` is
    the port's config), with the largest keyframe-pose and point
    differences between the two results."""
    import torch

    from orb_slam2_ssd_semantic_tpu.eval.ate import evaluate_ate_xyz
    from orb_slam2_ssd_semantic_tpu.tracking.segmented import resolve_trajectory
    from orb_slam2_ssd_semantic_tpu_torch.mapping.loop_closing import LoopCloser as TCloser
    from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import state_from_numpy

    frame = int(correction[0])
    kf, cand, T_ji, before, after = applied
    port_after, accepted = TCloser(cfg, device="cpu")._correct(
        state_from_numpy(_tree(before), torch.device("cpu")), kf, cand, T_ji)
    hi = 1 + ((frame - 1) // SEGMENT_LEN + 1) * SEGMENT_LEN
    part = res._replace(traj=res.traj[:hi])

    def ate(kfs):
        carry = SimpleNamespace(state=SimpleNamespace(kfs=kfs))
        return float(evaluate_ate_xyz(resolve_trajectory(part._replace(carry=carry)), gt[:hi]).rmse)

    port_kfs = SimpleNamespace(uid=port_after.kfs.uid.numpy(), valid=port_after.kfs.valid.numpy(),
                               T_cw=port_after.kfs.T_cw.numpy())
    live = np.asarray(after.kfs.valid)
    pts = np.asarray(after.points.valid) & port_after.points.valid.numpy()
    return dict(frame=frame, up_to_frame=hi - 1, ate_before_m=ate(before.kfs),
                ate_after_m=ate(after.kfs), port_accepted=bool(accepted),
                port_ate_after_m=ate(port_kfs),
                port_pose_max_diff=float(np.abs(port_kfs.T_cw[live]
                                                - np.asarray(after.kfs.T_cw)[live]).max()),
                port_point_max_diff=float(np.abs(port_after.points.pos.numpy()[pts]
                                                 - np.asarray(after.points.pos)[pts]).max()),
                points_live_in_one_only=int((np.asarray(after.points.valid)
                                             != port_after.points.valid.numpy()).sum()))


def main(argv) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import orb_slam2_ssd_semantic_tpu.config as jconfig
    import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
    from orb_slam2_ssd_semantic_tpu.eval.ate import evaluate_ate_xyz
    from orb_slam2_ssd_semantic_tpu.io import vocabulary as voc
    from orb_slam2_ssd_semantic_tpu.mapping.loop_closing import LoopCloser
    from orb_slam2_ssd_semantic_tpu.tracking import scan_tracker
    from orb_slam2_ssd_semantic_tpu.tracking.segmented import (
        resolve_trajectory,
        track_sequence_segmented,
    )

    class AgreeingCloser(LoopCloser):
        """Every estimate is the map's current relative pose (D = 0); the
        real `_correct`."""

        def __init__(self, cfg, vocab):
            super().__init__(cfg, vocab=vocab)
            self.calls = 0
            self.applied = []  # (state before, state after) of each accepted correction

        def _estimate_loop_transform(self, state, kf_id, cand):
            self.calls += 1
            T = np.asarray(state.kfs.T_cw[kf_id]) @ np.linalg.inv(np.asarray(state.kfs.T_cw[cand]))
            return True, jnp.asarray(T.astype(np.float32)), 999

        def _correct(self, state, kf_id, cand, T_ji):
            out, accepted = super()._correct(state, kf_id, cand, T_ji)
            if accepted:
                self.applied.append((kf_id, cand, np.asarray(T_ji), state, out))
            return out, accepted

    class StubCloser(LoopCloser):
        """`tests/test_segmented.py::_StubCloser`."""

        def __init__(self, cfg, vocab, d_seq):
            super().__init__(cfg, vocab=vocab)
            self.d_seq = [np.asarray(d, np.float32) for d in d_seq]
            self.calls = 0
            self.applied = []

        def _estimate_loop_transform(self, state, kf_id, cand):
            T_cur_rel = np.asarray(state.kfs.T_cw[kf_id]) @ np.linalg.inv(
                np.asarray(state.kfs.T_cw[cand]))
            D = np.eye(4, dtype=np.float32)
            D[:3, 3] = self.d_seq[self.calls % len(self.d_seq)]
            self.calls += 1
            return True, jnp.asarray(D @ T_cur_rel), 999

        def _correct(self, state, kf_id, cand, T_ji):
            self.applied.append((kf_id, cand))
            return state, True

    runs = argv or ["agree", "disagree", "plain"]
    d = Path(__file__).resolve().parent / "build" / "scan_reference"
    d.mkdir(parents=True, exist_ok=True)
    vpath = d / f"orbvoc_random_k{VOCAB_K}_d{VOCAB_DEPTH}.npz"
    voc.save_binary(voc.make_random_vocabulary(seed=VOCAB_SEED, k=VOCAB_K, depth=VOCAB_DEPTH),
                    str(vpath))
    vocab = voc.load_binary(str(vpath))
    va = scan_tracker.VocabArrays.from_vocabulary(vocab)

    cfg = config(jconfig, str(vpath))
    cfg_agree = config(jconfig, str(vpath), agree=True)

    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(RENDER_WORKERS, initializer=_render_init) as pool:
        frames = pool.map(_render, range(N_FRAMES))
    seq = _sequence()
    print(json.dumps(dict(scenario="render", frames=N_FRAMES,
                          seconds=time.perf_counter() - t0)), flush=True)
    g = jnp.asarray(np.stack([f[0] for f in frames]))
    dd = jnp.asarray(np.stack([f[1] for f in frames]))
    gt = seq.gt_positions()

    for name in runs:
        if name == "agree":
            run_cfg, closer = cfg_agree, AgreeingCloser(cfg_agree, vocab)
        elif name == "disagree":
            run_cfg, closer = cfg, StubCloser(cfg, vocab, [[0.3, 0.0, 0.0], [-0.3, 0.0, 0.2]])
        elif name == "plain":
            run_cfg, closer = cfg, LoopCloser(cfg, vocab=vocab)
        else:
            raise SystemExit(f"unknown run {name}")
        t = time.perf_counter()
        res = track_sequence_segmented(g, dd, run_cfg, vocab=va, voc_k=vocab.k,
                                       voc_depth=vocab.depth, voc_words=vocab.n_words,
                                       segment_len=SEGMENT_LEN, loop_closer=closer)
        wall = time.perf_counter() - t
        raw = np.stack([-T[:3, :3].T @ T[:3, 3] for T in res.T_all])
        status = res.stats[:, 0].astype(int)
        out = dict(
            scenario=f"8b {name}", n_loop_events=int(res.n_loop_events),
            event_frames=[int(i) + 1 for i in np.nonzero(res.stats[:, 3] >= 0)[0]],
            corrections=[[int(c[0]), int(c[1]), int(c[2])] for c in res.corrections],
            verifier_calls=getattr(closer, "calls", None),
            statuses={s: int((status == k).sum()) for k, s in enumerate(("OK", "WEAK", "LOST"))},
            n_kfs_end=int(res.stats[-1, 2]),
            ate_raw_m=float(evaluate_ate_xyz(raw, gt).rmse),
            ate_resolved_m=float(evaluate_ate_xyz(resolve_trajectory(res), gt).rmse),
            scan_s=res.scan_s, correct_s=res.correct_s, wall_s=wall,
            note="first run includes the JAX compile" if name == runs[0] else "")
        if name == "agree":
            tcfg = config(tconfig, str(vpath), agree=True)
            out["correction_effect"] = [_port_on_jax_state(res, *a, tcfg, gt)
                                        for a in zip(res.corrections, closer.applied)]
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
