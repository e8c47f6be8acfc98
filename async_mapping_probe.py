"""Does the keyframe's local-mapping step wait on the card?

Renders the default orbit on the card (96 frames at 640x480, the room and
seed of `chip_smoke.py`'s main path), runs `Tracker.process` on it with
the default config (loop closing off) and prints, for the port found
under `--tree` (default: this file's directory):

- the frames: host ms a frame (ending in a synchronize), the keyframe
  frames, the `local_mapping` stage's host ms (what the frame loop waits
  for: with `async_mapping` the dispatch) and, on a tree that replays
  local mapping from a CUDA graph (`mapping/graphed_step.py`), the
  `local_mapping.capture` stage's; for a steady frame and the first
  keyframe frame that maps (62: on a graph tree, the capture's) the CUDA
  runtime calls (kernel launches, graph launches, copies, stream syncs)
  of the whole frame and inside `local_mapping`;
- local BA's Gauss-Newton steps: per adjustment, the steps each phase
  took before its gain test stopped it (counted as calls of the
  residual pass, which a step makes once, when the tree's BA leaves the
  loop early; from `BAResult.iters` when it runs a fixed loop); on a
  tree with the graph, only the warm-up's and the capture's adjustments
  run in Python, so only they are counted;
- local mapping called directly on the state the last keyframe met, at
  the default 16 + 8 window and at chip_smoke's 12 + 8, as the tree's
  tracker calls it (`local_mapping_step`, or a `LocalMappingRunner`
  captured first): the dispatch's host ms against the same call ending
  in a synchronize (median of 3), the runtime calls inside it, how many
  times the window matcher's and the SPD solve's kernels ran on the card
  in a traced call (a replay included), and every sync PyTorch reports
  in it (`torch.cuda.set_sync_debug_mode("warn")`), by file and line.

With `--poses FILE` it saves the poses `process` returned (numpy, N x 4 x
4), so two trees' runs can be compared.

    python3 async_mapping_probe.py [--tree DIR] [--poses FILE]

Run it on another commit's tree by unpacking that tree into a directory
and naming it with `--tree`. Needs one CUDA card. Prints one JSON object
a line, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

N_FRAMES = 96
STEADY_FRAME = 40
KEYFRAME_FRAME = 62
ROOM, SEED = (5.0, 3.0, 6.0), 17
RUNTIME_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemcpy", "cudaStreamSynchronize", "cudaDeviceSynchronize")
SYNC_CALLS = ("cudaMemcpy", "cudaStreamSynchronize", "cudaDeviceSynchronize")
REPEATS = 3


def _emit(tag: str, obj) -> None:
    print(json.dumps({tag: obj}), flush=True)


def _runtime(prof, in_range: str | None = None) -> dict:
    """CUDA runtime calls in a profile, all or inside ranges named `in_range`."""
    out = {}
    for e in prof.events():
        if e.name not in RUNTIME_CALLS:
            continue
        if in_range is not None:
            p = e.cpu_parent
            while p is not None and p.name != in_range:
                p = p.cpu_parent
            if p is None:
                continue
        out[e.name] = out.get(e.name, 0) + 1
    return out


def _kernels_run(prof) -> dict:
    """How many times the window matcher's first kernel and the SPD
    solve's kernel ran on the card in a profile, from its device events
    (a graph's replay, which calls no wrapper, included)."""
    out = dict(window_match=0, spd_solve=0)
    for e in prof.events():
        if str(e.device_type).endswith("CUDA"):
            for key, name in (("window_match", "window_match_partial_kernel"),
                              ("spd_solve", "spd_solve_kernel")):
                out[key] += name in e.name
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--poses", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve()))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import orb_slam2_ssd_semantic_tpu_torch as pkg
    from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, SlamConfig
    from orb_slam2_ssd_semantic_tpu_torch.io import device_render
    from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import orbit_trajectory
    from orb_slam2_ssd_semantic_tpu_torch.mapping import ba, local_mapping
    from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_build
    from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker
    from orb_slam2_ssd_semantic_tpu_torch.utils.precision import highest_precision

    try:
        from orb_slam2_ssd_semantic_tpu_torch.mapping.graphed_step import LocalMappingRunner
    except ImportError:
        LocalMappingRunner = None

    if not torch.cuda.is_available():
        print("async_mapping_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _emit("tree", dict(package=str(Path(pkg.__file__).parent), torch=torch.__version__))
    cuda_build.build_all(force=True)

    base = SlamConfig()
    cfg = base.replace(loop=dataclasses.replace(base.loop, enabled=False,
                                                enable_relocalization=False))
    poses = orbit_trajectory(N_FRAMES, room=ROOM).astype(np.float32)
    g, d = device_render.render_frames(poses, CameraConfig(), size=ROOM, seed=SEED, device=dev)
    frames = list(zip(g.cpu().numpy(), d.cpu().numpy()))

    # Hooks: the state each local-mapping step meets, a profiler range
    # around it, and the Gauss-Newton steps of each adjustment.
    met, steps, fixed_loop = [], [], []
    residual_passes = [0]
    step_fn, ba_fn, residual_fn = (local_mapping.local_mapping_step,
                                   local_mapping.local_bundle_adjust, ba._residual_components)

    def counted_residuals(*a, **k):
        residual_passes[0] += 1
        return residual_fn(*a, **k)

    def counted_ba(prob, cam, ocfg=None):
        residual_passes[0] = 0
        res = ba_fn(prob, cam, ocfg) if ocfg is not None else ba_fn(prob, cam)
        steps.append(residual_passes[0])
        if hasattr(res, "iters"):
            fixed_loop.append(res.iters)
        return res

    def hooked_step(state, c):
        met.append(state)
        with record_function("local_mapping"):
            return step_fn(state, c)

    ba._residual_components = counted_residuals
    local_mapping.local_bundle_adjust = counted_ba
    if LocalMappingRunner is None:
        local_mapping.local_mapping_step = hooked_step
    else:
        replay_fn = LocalMappingRunner.step

        def hooked_replay(runner, state, c):
            met.append(state)
            return replay_fn(runner, state, c)

        LocalMappingRunner.step = hooked_replay

    tracker = Tracker(cfg, device=dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    frame_ms, profiles, returned = [], {}, []
    for i, (gray, depth) in enumerate(frames):
        prof = profile(activities=acts) if i in (STEADY_FRAME, KEYFRAME_FRAME) else None
        if prof is not None:
            prof.start()
        t = time.perf_counter()
        returned.append(tracker.process(gray, depth, float(i) / 30.0))
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        if prof is not None:
            prof.stop()
            profiles[i] = dict(frame=_runtime(prof), local_mapping=_runtime(prof, "local_mapping"))
    kf_frames = [i for i in range(1, len(tracker.stats))
                 if tracker.stats[i]["kfs"] != tracker.stats[i - 1]["kfs"]]
    if args.poses:
        np.save(args.poses, np.stack(returned))
    lm = tracker.metrics.stages.get("local_mapping")
    cap = tracker.metrics.stages.get("local_mapping.capture")
    plain = [ms for i, ms in enumerate(frame_ms[1:], 1)
             if i not in kf_frames and i not in profiles]
    iters = [t.tolist() for t in fixed_loop]
    _emit("frames", dict(
        card=card, median_frame_ms=statistics.median(plain), keyframe_frames=kf_frames,
        keyframe_frame_ms=[frame_ms[i] for i in kf_frames if i not in profiles],
        local_mapping_steps=0 if lm is None else lm.count,
        local_mapping_stage_ms=None if lm is None else lm.mean_s * 1e3,
        local_mapping_capture_ms=None if cap is None else cap.total_s * 1e3,
        profiled={str(k): v for k, v in profiles.items()},
        gn_steps_per_phase=iters if iters else None, residual_passes_per_ba=steps,
        gn_schedule=[cfg.optimizer.local_ba_iters_initial, cfg.optimizer.local_ba_iters_refine]))

    # Direct calls on the state the last keyframe met.
    local_mapping.local_mapping_step = step_fn
    if LocalMappingRunner is not None:
        LocalMappingRunner.step = replay_fn
    state = met[-1]
    cfg5 = cfg.replace(map=dataclasses.replace(cfg.map, local_ba_window=12,
                                               local_ba_fixed_anchors=8))
    for label, c in (("default_16_8", cfg), ("window_12_8", cfg5)):
        runner = None if LocalMappingRunner is None else LocalMappingRunner(dev)

        def call():
            with highest_precision(), record_function("local_mapping"):
                if runner is not None:
                    return runner.step(state, c)
                return local_mapping.local_mapping_step(state, c)

        call()
        torch.cuda.synchronize()
        steps.clear()
        fixed_loop.clear()
        dispatch, synced = [], []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            dispatch.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            synced.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            call()
            torch.cuda.synchronize()
        sites = {}
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        for w in caught:
            if "synchroniz" in str(w.message):
                key = f"{Path(w.filename).name}:{w.lineno}"
                sites[key] = sites.get(key, 0) + 1
        torch.cuda.synchronize()
        _emit(label, dict(
            card=card, dispatch_ms=statistics.median(dispatch), synced_ms=statistics.median(synced),
            dispatch_over_synced=statistics.median(dispatch) / statistics.median(synced),
            runtime_calls=_runtime(prof, "local_mapping"), launches=_kernels_run(prof),
            sync_sites=dict(sorted(sites.items(), key=lambda kv: -kv[1])),
            n_syncs_reported=sum(sites.values()),
            residual_passes_per_ba=steps[:1],
            gn_steps_per_phase=[t.tolist() for t in fixed_loop[:1]] or None))
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
