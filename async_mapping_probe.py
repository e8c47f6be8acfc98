"""Does the keyframe's local-mapping step wait on the card?

Renders the default orbit on the card (96 frames at 640x480, the room and
seed of `chip_smoke.py`'s main path), runs `Tracker.process` on it with
the default config (loop closing off) and prints, for the port found
under `--tree` (default: this file's directory):

- the frames: host ms a frame (ending in a synchronize), the keyframe
  frames, the `local_mapping` stage's host ms (what the frame loop waits
  for: with `async_mapping` the dispatch), and for a steady frame and a
  keyframe frame the CUDA runtime calls (kernel launches, copies, stream
  syncs) of the whole frame and inside `local_mapping`;
- local BA's Gauss-Newton steps: per adjustment, the steps each phase
  took before its gain test stopped it (counted as calls of the
  residual pass, which a step makes once, when the tree's BA leaves the
  loop early; from `BAResult.iters` when it runs a fixed loop);
- `local_mapping_step` called directly on the state the last keyframe
  met, at the default 16 + 8 window and at chip_smoke's 12 + 8: the
  dispatch's host ms against the same call ending in a synchronize
  (median of 3), the runtime calls inside it, the window matcher's and
  the SPD solve's launches, and every sync PyTorch reports in it
  (`torch.cuda.set_sync_debug_mode("warn")`), by file and line.

    python3 async_mapping_probe.py [--tree DIR]

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
RUNTIME_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemcpy",
                 "cudaStreamSynchronize", "cudaDeviceSynchronize")
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
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
    from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_build, cuda_match, cuda_solve
    from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker
    from orb_slam2_ssd_semantic_tpu_torch.utils.precision import highest_precision

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
    local_mapping.local_mapping_step = hooked_step

    tracker = Tracker(cfg, device=dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    frame_ms, profiles = [], {}
    for i, (gray, depth) in enumerate(frames):
        prof = profile(activities=acts) if i in (STEADY_FRAME, KEYFRAME_FRAME) else None
        if prof is not None:
            prof.start()
        t = time.perf_counter()
        tracker.process(gray, depth, float(i) / 30.0)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
        if prof is not None:
            prof.stop()
            profiles[i] = dict(frame=_runtime(prof), local_mapping=_runtime(prof, "local_mapping"))
    kf_frames = [i for i in range(1, len(tracker.stats))
                 if tracker.stats[i]["kfs"] != tracker.stats[i - 1]["kfs"]]
    lm = tracker.metrics.stages.get("local_mapping")
    plain = [ms for i, ms in enumerate(frame_ms[1:], 1)
             if i not in kf_frames and i not in profiles]
    iters = [t.tolist() for t in fixed_loop]
    _emit("frames", dict(
        card=card, median_frame_ms=statistics.median(plain), keyframe_frames=kf_frames,
        keyframe_frame_ms=[frame_ms[i] for i in kf_frames if i not in profiles],
        local_mapping_steps=0 if lm is None else lm.count,
        local_mapping_stage_ms=None if lm is None else lm.mean_s * 1e3,
        profiled={str(k): v for k, v in profiles.items()},
        gn_steps_per_phase=iters if iters else None, residual_passes_per_ba=steps,
        gn_schedule=[cfg.optimizer.local_ba_iters_initial, cfg.optimizer.local_ba_iters_refine]))

    # Direct calls on the state the last keyframe met.
    local_mapping.local_mapping_step = step_fn
    state = met[-1]
    cfg5 = cfg.replace(map=dataclasses.replace(cfg.map, local_ba_window=12,
                                               local_ba_fixed_anchors=8))
    for label, c in (("default_16_8", cfg), ("window_12_8", cfg5)):
        def call():
            with highest_precision(), record_function("local_mapping"):
                return local_mapping.local_mapping_step(state, c)

        call()
        torch.cuda.synchronize()
        cuda_match.window_match.launches = cuda_solve.spd_solve.launches = 0
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
        launches = dict(window_match=cuda_match.window_match.launches // (2 * REPEATS),
                        spd_solve=cuda_solve.spd_solve.launches // (2 * REPEATS))
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
            runtime_calls=_runtime(prof, "local_mapping"), launches=launches,
            sync_sites=dict(sorted(sites.items(), key=lambda kv: -kv[1])),
            n_syncs_reported=sum(sites.values()),
            residual_passes_per_ba=steps[:1],
            gn_steps_per_phase=[t.tolist() for t in fixed_loop[:1]] or None))
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
