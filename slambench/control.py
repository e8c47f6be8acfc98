"""Readings for the limits of `correct`, on the card, at a cell's own
size: the numbers `check.py` compares, for the program as the
configuration states it on many seeds, and for a control or a planted
fault on some:

    python3 slambench/control.py --workload <cell> --seeds 1 2 ... \
        [--control none|tf32|no_local_ba|no_local_mapping ...] [--frames N]

`tf32` lets float32 matmuls and convolutions use TF32 inside the entry
points, whose scope (`utils/precision.py`) turns it off: the nearest
precision below the float32 the configurations state. The faults are
planted in the port for this process only: `no_local_ba` makes local
bundle adjustment return its window as it found it, `no_local_mapping`
makes the keyframe branch's local mapping step (triangulation, fusion,
local BA, culling) return the map unchanged. Every seed runs under each
control named, in this one process (the port keeps no graph from one job
or session to the next): a whole job for an offline cell, a session of
`--frames` frames after the warm-up for a live one. One JSON line a run
on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


@contextlib.contextmanager
def tf32_in_scope():
    """The entry points' precision scope with TF32 allowed."""
    import torch

    from orb_slam2_ssd_semantic_tpu_torch.utils import precision

    orig = precision.highest_precision

    @contextlib.contextmanager
    def with_tf32():
        with orig():
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            yield

    precision.highest_precision = with_tf32
    try:
        yield
    finally:
        precision.highest_precision = orig


@contextlib.contextmanager
def no_local_ba():
    """Local bundle adjustment returns the poses and points it was given,
    every observation an inlier."""
    import torch

    from orb_slam2_ssd_semantic_tpu_torch.mapping import ba, local_mapping

    orig = local_mapping.local_bundle_adjust

    def unchanged(prob, cam, cfg=None):
        ok = prob.point_slot >= 0
        return ba.BAResult(prob.T_cw.clone(), prob.points.clone(), ok,
                           torch.zeros(ok.shape, dtype=torch.float32, device=ok.device),
                           torch.zeros(2, dtype=torch.int32, device=ok.device))

    local_mapping.local_bundle_adjust = unchanged
    try:
        yield
    finally:
        local_mapping.local_bundle_adjust = orig


@contextlib.contextmanager
def no_local_mapping():
    """The keyframe branch's local mapping step returns the map as it
    found it."""
    from orb_slam2_ssd_semantic_tpu_torch.mapping import local_mapping

    orig = local_mapping.local_mapping_step
    local_mapping.local_mapping_step = lambda state, cfg: state
    try:
        yield
    finally:
        local_mapping.local_mapping_step = orig


SCOPES = {"none": contextlib.nullcontext, "tf32": tf32_in_scope, "no_local_ba": no_local_ba,
          "no_local_mapping": no_local_mapping}


def readings(cell: dict, seed: int, control: str, frames: int, device) -> dict:
    """The numbers of one seed's job or session, and what it failed."""
    from slambench import check, drive, spec
    from slambench.scene import synthetic

    conf, traffic = cell["config"], cell["traffic"]
    vocab_path = drive.vocabulary_file(conf["vocabulary"], spec.ROOT / "build" / "slambench")
    cfg = drive.slam_config(conf["slam"], vocab_path)
    scene = synthetic.build(conf["scene"])
    with SCOPES[control]():
        if traffic["mode"] == "offline_jobs":
            scene = scene.prefix(int(conf["offline"]["job_frames"]))
            grays, depths = drive.render_scene(scene, cfg.camera, seed, device)
            jobs = drive.OfflineJobs(cfg, vocab_path, [(grays, depths)],
                                     int(conf["offline"]["segment_len"]), device)
            res, wall = jobs.run()
            job = jobs.job(res, grays.shape[0], wall)
            answers, failed = [jobs.answers(res, scene, grays.shape[0])], job.lost
            extra = dict(wall_s=wall, corrections=job.corrections, keyframes=job.keyframes,
                         loop_events=job.loop_events)
        else:
            grays, depths = drive.render_scene(scene, cfg.camera, seed, device)
            session = drive.LiveSession(cfg, grays.cpu().numpy(), depths.cpu().numpy(),
                                        float(traffic["fps"]), device)
            drive.warm_live(session, traffic)
            first = session.k
            ms = [session.step() for _ in range(frames)]
            answers, failed = [session.answers(scene, first)], int(sum(session.lost[first:]))
            extra = dict(frames=frames, mean_ms=sum(ms) / len(ms),
                         p95_ms=sorted(ms)[int(0.95 * len(ms))],
                         counters=dict(session.tracker.metrics.counters),
                         loops_closed=session.tracker.n_loops_closed)
    values = check.numbers(answers, scene)
    return dict(seed=seed, control=control, failed=failed, **values, **extra,
                **diagnostics(answers[0], scene))


def diagnostics(a: dict, scene) -> dict:
    """The judged numbers of the same answers with a fault planted in
    them: `stuck` (every judged frame answered with the first judged
    frame's pose: a step that returns its state unchanged), `altered`
    (the middle judged frame's answer moved 2 m along x)."""
    import numpy as np

    from slambench import check

    out = dict(n_kf=len(a["kf_T_cw"]), n_points=len(a["points"]))
    first = a.get("first", 0)
    stuck = np.array(a["T_cw"])
    stuck[first:] = stuck[first]
    altered = np.array(a["T_cw"])
    mid = (first + len(altered)) // 2
    altered[mid, :3, 3] -= altered[mid, :3, :3] @ np.array([2.0, 0.0, 0.0])
    for name, T in (("stuck", stuck), ("altered", altered)):
        out[name] = check.numbers([dict(a, T_cw=T)], scene)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", choices=sorted(SCOPES), nargs="+", default=["none"])
    ap.add_argument("--frames", type=int, default=1300)
    args = ap.parse_args(argv)
    import torch

    from slambench import spec

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(spec.benchmark(), args.workload)
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    for control in args.control:
        for seed in args.seeds:
            t0 = time.perf_counter()
            out = readings(cell, seed, control, args.frames, device)
            out["s"] = time.perf_counter() - t0
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
