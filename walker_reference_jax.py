#!/usr/bin/env python3
"""The scenario of `chip_smoke.py`'s phase 9d (the segmented runner on
`bench.py`'s walker scene, unmasked, with the flow mask and with the
geometry mask), run through the JAX package on the CPU: the numbers the
port's run on the card is read against.

    JAX_PLATFORMS=cpu python walker_reference_jax.py [unmasked] [flow] [geom]
    python walker_reference_jax.py --port      # the port, on one CUDA card

The scene is `bench.py`'s `sway_dyn` cut as phase 9d cuts it: the first
97 of `SyntheticSequence(n_frames=337, trajectory="sway")`'s frames with
`cross_walkers(337, room, n_objects=3)`, 640x480, `depth_noise=0.01`,
rendered by the JAX package's `io/device_render.render_frames` and saved
to `results/walker_reference/frames.npz`; `segment_len=48`. The config is
`bench.py`'s `cfg_dyn` (`th_depth=80`, 128 keyframes, 16,384 map points,
1536 local-map candidates, `min_static_area=0.45`) on the named vocabulary
of `chip_smoke.py` (a DBoW2 tree of k = 10, depth = 4 from seed 3, saved
under `build/walker_reference/`), with the plain `LoopCloser`. Each run
prints one JSON line: loop events, corrections, per-frame statuses, raw
and resolved ATE, and the wall times (the first run's includes the JAX
compile).

`--port` runs phase 9d's own function (`chip_smoke.run_masked_segmented`,
with its gates) on the saved JAX frames on the card, so that the two
packages are compared on the same pixels; it imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

SEQ_FRAMES, N_FRAMES, SEGMENT_LEN, DEPTH_NOISE = 337, 97, 48, 0.01
VOCAB_SEED, VOCAB_K, VOCAB_DEPTH = 3, 10, 4
ROOT = Path(__file__).resolve().parent
FRAMES = ROOT / "results" / "walker_reference" / "frames.npz"


def render_jax(cam):
    """The walker prefix through the JAX renderer: (uint8 grays, uint16 mm
    depths, ground-truth positions), saved to FRAMES."""
    import jax.numpy as jnp

    from orb_slam2_ssd_semantic_tpu.io.device_render import render_frames
    from orb_slam2_ssd_semantic_tpu.io.synthetic import SyntheticSequence, cross_walkers

    seq = SyntheticSequence(n_frames=SEQ_FRAMES, trajectory="sway")
    poses = np.stack(seq.poses_wc).astype(np.float32)[:N_FRAMES]
    walkers = cross_walkers(SEQ_FRAMES, seq.room.size, n_objects=3)[:N_FRAMES]
    boxes = tuple(tuple(map(tuple, b)) for b in seq.room.boxes)
    g, d = render_frames(jnp.asarray(poses), cam, size=seq.room.size, boxes=boxes,
                         seed=seq.seed, moving_boxes=jnp.asarray(walkers),
                         depth_noise=DEPTH_NOISE)
    g, d = np.asarray(g), np.asarray(d)
    gt = seq.gt_positions()[:N_FRAMES]
    FRAMES.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FRAMES, grays=g, depths=d, gt=gt)
    return g, d, gt


def run_jax(runs) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from orb_slam2_ssd_semantic_tpu.config import SlamConfig
    from orb_slam2_ssd_semantic_tpu.eval.ate import evaluate_ate_xyz
    from orb_slam2_ssd_semantic_tpu.io import vocabulary as voc
    from orb_slam2_ssd_semantic_tpu.mapping.loop_closing import LoopCloser
    from orb_slam2_ssd_semantic_tpu.tracking import scan_tracker
    from orb_slam2_ssd_semantic_tpu.tracking.segmented import (
        resolve_trajectory,
        track_sequence_segmented,
    )

    vdir = ROOT / "build" / "walker_reference"
    vdir.mkdir(parents=True, exist_ok=True)
    vpath = vdir / f"orbvoc_random_k{VOCAB_K}_d{VOCAB_DEPTH}.npz"
    voc.save_binary(voc.make_random_vocabulary(seed=VOCAB_SEED, k=VOCAB_K, depth=VOCAB_DEPTH),
                    str(vpath))
    vocab = voc.load_binary(str(vpath))
    va = scan_tracker.VocabArrays.from_vocabulary(vocab)
    base = SlamConfig()
    cfg = dataclasses.replace(
        base, camera=dataclasses.replace(base.camera, th_depth=80.0),
        map=dataclasses.replace(base.map, max_keyframes=128, max_map_points=16384),
        tracking=dataclasses.replace(base.tracking, local_map_candidates=1536),
        dynamic=dataclasses.replace(base.dynamic, min_static_area=0.45),
        loop=dataclasses.replace(base.loop, vocabulary_path=str(vpath)))

    t0 = time.perf_counter()
    g, d, gt = render_jax(cfg.camera)
    print(json.dumps(dict(scenario="render", frames=N_FRAMES, saved=str(FRAMES.relative_to(ROOT)),
                          seconds=time.perf_counter() - t0)), flush=True)
    g, d = jnp.asarray(g), jnp.asarray(d)
    masks = dict(unmasked={}, flow=dict(use_flow=True), geom=dict(use_geom=True))
    for name in runs:
        t = time.perf_counter()
        res = track_sequence_segmented(g, d, cfg, vocab=va, voc_k=vocab.k, voc_depth=vocab.depth,
                                       voc_words=vocab.n_words, segment_len=SEGMENT_LEN,
                                       loop_closer=LoopCloser(cfg, vocab=vocab), **masks[name])
        wall = time.perf_counter() - t
        raw = np.stack([-T[:3, :3].T @ T[:3, 3] for T in res.T_all])
        status = res.stats[:, 0].astype(int)
        print(json.dumps(dict(
            scenario=f"9d {name}", n_loop_events=int(res.n_loop_events),
            corrections=[[int(c[0]), int(c[1]), int(c[2])] for c in res.corrections],
            statuses={s: int((status == k).sum()) for k, s in enumerate(("OK", "WEAK", "LOST"))},
            n_kfs_end=int(res.stats[-1, 2]),
            ate_raw_m=float(evaluate_ate_xyz(raw, gt).rmse),
            ate_resolved_m=float(evaluate_ate_xyz(resolve_trajectory(res), gt).rmse),
            scan_s=res.scan_s, correct_s=res.correct_s, wall_s=wall,
            note="includes the JAX compile")), flush=True)
    return 0


def run_port() -> int:
    """Phase 9d's runs of the port on the saved JAX frames, on the card."""
    import torch

    import chip_smoke as cs
    from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    cs.build_kernels()
    z = np.load(FRAMES)
    n = z["grays"].shape[0]
    scene = dict(seq=cs.walker_scene(n)[0], grays=torch.from_numpy(z["grays"]).to(dev),
                 depths=torch.from_numpy(z["depths"]).to(dev))
    if not np.allclose(scene["seq"].gt_positions()[:n], z["gt"]):
        raise AssertionError("the saved frames are not phase 9d's scene")
    runs = cs.run_masked_segmented(dev, CameraConfig(), scene, cs.card_line())
    print(json.dumps({k: dict(ate_resolved_m=v["ate_resolved_m"], ate_raw_m=v["ate_raw_m"],
                              lost=v["lost"], n_kfs_end=v["n_kfs_end"],
                              corrections=v["corrections"]) for k, v in runs.items()}))
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--port"]:
        sys.exit(run_port())
    sys.exit(run_jax(args or ["unmasked", "flow", "geom"]))
