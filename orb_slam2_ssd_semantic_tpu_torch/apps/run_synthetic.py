"""End-to-end SLAM run on the synthetic RGB-D sequence (counterpart of the
JAX package's `apps/run_synthetic.py`).

The engine's equivalent of the reference's rgbd_tum program
(perfect/Examples/RGB-D/rgbd_tum.cc) for an environment with no TUM
images: renders a deterministic furnished-room sequence, tracks it, and
reports ATE against the exact ground truth plus per-frame timing
(median/mean, as rgbd_tum.cc:125-133 prints).

Usage:
    python -m orb_slam2_ssd_semantic_tpu_torch.apps.run_synthetic --frames 60
    python -m orb_slam2_ssd_semantic_tpu_torch.apps.run_synthetic --device cpu
"""

from __future__ import annotations

import argparse
import time


def track(frames, cfg, device=None, log=print):
    """`Tracker.process` on `frames`, an iterable of (gray, depth, stamp).
    Returns (tracker, the (N, 4, 4) T_cw `process` returned, per-frame
    seconds on the host clock ending in a synchronize on the card)."""
    import numpy as np
    import torch

    from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
    from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker

    dev = device_mod.resolve(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    tracker = Tracker(cfg, device=dev)
    poses, frame_times = [], []
    for i, (gray, depth, stamp) in enumerate(frames):
        t0 = time.perf_counter()
        poses.append(tracker.process(gray, depth, float(stamp)))
        sync()
        frame_times.append(time.perf_counter() - t0)
        if i % 10 == 0:
            s = tracker.stats[-1]
            log(f"frame {i:4d}  status={s['status']:5s} inliers={s['inliers']:4d} "
                f"kfs={s['kfs']:3d} points={s['points']:6d} t={frame_times[-1]*1e3:.1f}ms")
    return tracker, np.stack(poses), frame_times


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--depth-noise", type=float, default=0.0)
    p.add_argument("--save", default=None, help="write TUM trajectory here")
    p.add_argument("--seed", type=int, default=17)
    p.add_argument(
        "--dynamic", default="off", choices=["off", "none", "flow", "geom", "both"],
        help="render a moving object and enable the dynamic-pixel filter",
    )
    args = p.parse_args(argv)

    import numpy as np

    from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
    from orb_slam2_ssd_semantic_tpu_torch.config import DynamicConfig, SlamConfig
    from orb_slam2_ssd_semantic_tpu_torch.eval.ate import evaluate_ate_xyz
    from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import SyntheticSequence

    dev = device_mod.resolve(args.device)
    cfg = SlamConfig()
    render_dynamic = args.dynamic not in ("off",)
    if args.dynamic in ("flow", "both"):
        cfg = cfg.replace(dynamic=DynamicConfig(
            enable_flow=True, enable_geometry=args.dynamic == "both"))
    elif args.dynamic == "geom":
        cfg = cfg.replace(dynamic=DynamicConfig(enable_geometry=True))
    seq = SyntheticSequence(
        n_frames=args.frames, seed=args.seed, depth_noise=args.depth_noise,
        dynamic_objects=render_dynamic,
    )
    frames = ((*seq.gray_depth(i), seq.stamps[i]) for i in range(len(seq)))
    tracker, _, frame_times = track(frames, cfg, dev)

    ft = np.array(frame_times[1:])  # skip the first frame (kernel builds, caches)
    res = evaluate_ate_xyz(tracker.camera_positions(), seq.gt_positions())
    print()
    print(f"median tracking time: {np.median(ft)*1e3:.2f} ms")
    print(f"mean tracking time:   {np.mean(ft)*1e3:.2f} ms")
    print(f"ATE RMSE: {res.rmse:.6f} m (mean {res.mean:.6f}, median {res.median:.6f})")
    if args.save:
        tracker.save_trajectory_tum(args.save)
        print(f"trajectory written to {args.save}")
    return res


if __name__ == "__main__":
    main()
