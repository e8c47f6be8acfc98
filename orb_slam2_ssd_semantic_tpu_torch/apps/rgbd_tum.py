"""Offline TUM RGB-D runner (counterpart of the JAX package's
`apps/rgbd_tum.py`).

Drop-in equivalent of the reference's rgbd_tum executable
(perfect/Examples/RGB-D/rgbd_tum.cc): loads a TUM sequence via its
association file, tracks every frame, reports median/mean tracking time
(rgbd_tum.cc:125-133), and writes CameraTrajectory.txt and
KeyFrameTrajectory.txt (rgbd_tum.cc:136-137). Settings load from either
a reference-format OpenCV YAML (TUM1/2/3.yaml) or a JSON SlamConfig.

Usage:
  python -m orb_slam2_ssd_semantic_tpu_torch.apps.rgbd_tum \
      --sequence /data/rgbd_dataset_freiburg3_walking_xyz \
      --settings TUM3.yaml --dynamic flow \
      [--association associate.txt] [--groundtruth groundtruth.txt] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple


class RunResult(NamedTuple):
    system: object  # the SlamSystem that tracked the sequence
    frame_s: list  # seconds per frame (host clock ending in a synchronize on the card)
    ate: object  # eval.ate.AteResult against --groundtruth, or None


def load_config(settings: str | None, dynamic: str = "off"):
    """A SlamConfig from an OpenCV YAML or a JSON file (the default config
    without one), with the dynamic filter `dynamic` switched on."""
    from orb_slam2_ssd_semantic_tpu_torch.config import DynamicConfig, SlamConfig

    if settings and settings.endswith((".yaml", ".yml")):
        cfg = SlamConfig.from_opencv_yaml(settings)
    elif settings:
        with open(settings) as f:
            cfg = SlamConfig.from_json(f.read())
    else:
        cfg = SlamConfig()
    if dynamic != "off":
        cfg = cfg.replace(
            dynamic=DynamicConfig(
                enable_flow=dynamic in ("flow", "both"),
                enable_geometry=dynamic in ("geom", "both"),
                flow_threshold=cfg.dynamic.flow_threshold,
            )
        )
    return cfg


def run(frames, cfg, semantics: bool = False, dense_map: bool = False, out: str = ".",
        groundtruth: str | None = None, device=None, log=print) -> RunResult:
    """`SlamSystem.track_rgbd` on `frames`, an iterable of (stamp, rgb,
    depth) (`TumSequence` items or `NativeTumSequence`); then the
    trajectory files in `out`, the stage report, ATE against
    `groundtruth` and the object list."""
    import numpy as np
    import torch

    from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
    from orb_slam2_ssd_semantic_tpu_torch.system import SlamSystem

    dev = device_mod.resolve(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sys_ = SlamSystem(cfg, enable_semantics=semantics, enable_dense_map=dense_map, device=dev)
    times = []
    for i, (stamp, rgb, depth) in enumerate(frames):
        t0 = time.perf_counter()
        sys_.track_rgbd(rgb, depth, stamp)
        sync()
        times.append(time.perf_counter() - t0)
        if i % 50 == 0:
            s = sys_.tracker.stats[-1]
            log(f"frame {i:5d} status={s['status']:5s} inliers={s['inliers']:4d} "
                f"kfs={s['kfs']} points={s['points']}")

    ft = np.array(times[1:]) if len(times) > 1 else np.array(times)
    log(f"median tracking time: {np.median(ft)*1e3:.2f} ms")
    log(f"mean tracking time:   {np.mean(ft)*1e3:.2f} ms")
    # Per-stage breakdown (utils.metrics, the structured replacement for
    # the reference's ad-hoc chrono prints).
    log(sys_.tracker.metrics.report())

    os.makedirs(out, exist_ok=True)
    cam_path = os.path.join(out, "CameraTrajectory.txt")
    kf_path = os.path.join(out, "KeyFrameTrajectory.txt")
    sys_.save_trajectory_tum(cam_path)
    sys_.save_keyframe_trajectory_tum(kf_path)
    log(f"trajectories written to {cam_path}, {kf_path}")

    ate = None
    if groundtruth:
        from orb_slam2_ssd_semantic_tpu_torch.eval.ate import evaluate_ate

        ate = evaluate_ate(groundtruth, cam_path)
        log(f"ATE RMSE: {ate.rmse:.6f} m ({ate.n_pairs} pairs)")
    if semantics:
        for o in sys_.objects():
            log(f"object: {o}")
    return RunResult(sys_, times, ate)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sequence", required=True, help="TUM sequence directory")
    p.add_argument("--settings", default=None, help="OpenCV YAML or JSON config")
    p.add_argument("--association", default=None)
    p.add_argument("--groundtruth", default=None, help="evaluate ATE against this")
    p.add_argument("--dynamic", default="off", choices=["off", "flow", "geom", "both"])
    p.add_argument("--semantics", action="store_true")
    p.add_argument("--dense-map", action="store_true")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--out", default=".", help="output directory")
    p.add_argument("--max-frames", type=int, default=0)
    args = p.parse_args(argv)

    from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
    from orb_slam2_ssd_semantic_tpu_torch.io.tum import TumSequence

    dev = device_mod.resolve(args.device)
    cfg = load_config(args.settings, args.dynamic)
    seq = TumSequence.open(args.sequence, args.association, cfg.camera.depth_map_factor)
    n = len(seq) if args.max_frames <= 0 else min(len(seq), args.max_frames)
    print(f"sequence: {args.sequence} ({n} frames)")
    frames = (seq[i] for i in range(n))
    return run(frames, cfg, args.semantics, args.dense_map, args.out, args.groundtruth, dev)


if __name__ == "__main__":
    main()
