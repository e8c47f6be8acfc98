"""Does `Tracker.process` repeat itself on the card?

Renders `chip_smoke.py`'s main-path frames (the default orbit, 96 frames at
640x480), then runs `Tracker.process` on them several times with the
entry points' scope as shipped (deterministic kernels) and several times
with a scope that keeps only its TF32 settings (PyTorch's default
kernels). For each run it prints how far its poses lie from the first
run of the same kind, the first frame where a fingerprint of the map
(point sums and count, keyframe poses, velocity) differs, and the run's
seconds; and checks that the window matcher repeats its outputs over
repeated calls on one input.

    python3 determinism_probe.py [--runs N]

Needs one CUDA card. Prints one JSON object a line, the card's name and
power limit first.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch


def _fingerprint(tracker) -> list:
    s = tracker.state
    pos = torch.nan_to_num(s.points.pos.double(), 0.0, 0.0, 0.0)
    return [float(pos.sum()), float((pos * pos).sum()), int(s.n_points),
            float(torch.nan_to_num(s.kfs.T_cw.double()).sum()),
            float(tracker.velocity.double().sum())]


def _run(frames, seq, cfg, dev):
    from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker

    tracker = Tracker(cfg, device=dev)
    poses, prints = [], []
    t = time.perf_counter()
    for i, (gray, depth) in enumerate(frames):
        poses.append(tracker.process(gray, depth, float(seq.stamps[i])))
        prints.append(_fingerprint(tracker))
    return np.stack(poses), np.array(prints), time.perf_counter() - t


@contextlib.contextmanager
def _tf32_off_only():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("determinism_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_match
    from orb_slam2_ssd_semantic_tpu_torch.utils import precision

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    cs.build_kernels()
    b1 = {}
    for name, make in (("random", cs._b1_problem), ("ties", cs._b1_tie_problem)):
        p = make(7, 2048, 1024, dev)
        first = [o.clone() for o in cuda_match.window_match(**p, max_dist=100)]
        b1[name] = sum(any(not torch.equal(a, b) for a, b in
                           zip(first, cuda_match.window_match(**p, max_dist=100)))
                       for _ in range(200))
    print(json.dumps({"b1_calls_differing_from_the_first_of_200": b1}), flush=True)
    seq, frames, *_ = cs.render_frames(cs.N_FRAMES)
    cfg = cs.main_path_config()
    shipped = precision.highest_precision
    for kind in ("deterministic", "default_kernels"):
        precision.highest_precision = shipped if kind == "deterministic" else _tf32_off_only
        try:
            runs = [_run(frames, seq, cfg, dev) for _ in range(args.runs)]
        finally:
            precision.highest_precision = shipped
        P0, F0, _ = runs[0]
        for k, (P, F, s) in enumerate(runs):
            d = np.linalg.norm(P[:, :3, 3] - P0[:, :3, 3], axis=1)
            differ = np.nonzero((F != F0).any(axis=1))[0]
            print(json.dumps(dict(
                kernels=kind, run=k, seconds=s, max_position_diff_m=float(d.max()),
                first_frame_map_differs=int(differ[0]) if len(differ) else None,
                points_there=[int(F[differ[0], 2]), int(F0[differ[0], 2])] if len(differ)
                else None)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
