"""Live RGB-D camera app (counterpart of the JAX package's
`apps/live_rgbd.py`).

Equivalent of the reference's Percipio/TY live executable
(perfect/Examples/RGB-D/my_rgbd.cc): acquire RGB-D frames from a
camera-like source, optionally undistort the color image and register
the depth image into the color frame (the TY SDK doRegister/undistort
steps, my_rgbd.cc), feed TrackRGBD, and on exit save trajectories, the
sparse map, the occupancy map, and the semantic object database (the
Viewer "Save" menu, Viewer.cc:188-195).

There is no camera SDK here, so sources are pluggable:

  --source synthetic        ray-traced synthetic world (rendered on the host)
  --source watch:DIR        poll DIR for TUM-style rgb/NAME.png and
                            depth/NAME.png pairs appearing over time (a
                            live stream spooled to disk); new files are
                            tracked as they arrive
  --source v4l:INDEX        OpenCV VideoCapture, where cv2 is installed

Registration and undistortion run on the device (`ops/register.py`).
Everything runs on the card unless given `--device cpu`.

Usage:
  python -m orb_slam2_ssd_semantic_tpu_torch.apps.live_rgbd --source synthetic \\
      --frames 120 --out /tmp/live [--undistort] [--register-depth reg.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple


class LiveResult(NamedTuple):
    system: object  # the SlamSystem that tracked the frames
    frame_s: list  # seconds of `track_rgbd` a frame (ending in a synchronize on the card)


def iter_synthetic(n_frames: int, cfg):
    """The default synthetic sequence's frames as (rgb uint8, depth
    metres, stamp): the gray view in three channels, truncated to uint8."""
    import numpy as np

    from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=n_frames)
    for i in range(len(seq)):
        g, depth = seq.gray_depth(i)
        rgb = np.clip(np.stack([g, g, g], -1), 0, 255).astype("uint8")
        yield rgb, depth, i / cfg.camera.fps


def iter_watch(root: str, depth_map_factor: float, idle_timeout_s: float = 10.0):
    """Yield TUM-style (rgb, depth, stamp) pairs as files appear in
    root/rgb and root/depth (a name is taken once both exist); stop after
    idle_timeout_s without a new frame (the live analogue of the
    association file)."""
    import numpy as np
    from PIL import Image

    seen = set()
    last_new = time.time()
    while time.time() - last_new < idle_timeout_s:
        rgb_dir = os.path.join(root, "rgb")
        rgbs = sorted(os.listdir(rgb_dir)) if os.path.isdir(rgb_dir) else []
        for name in rgbs:
            if name in seen or not name.endswith(".png"):
                continue
            dpath = os.path.join(root, "depth", name)
            if not os.path.exists(dpath):
                continue
            seen.add(name)
            last_new = time.time()
            rgb = np.asarray(Image.open(os.path.join(rgb_dir, name)))
            depth = np.asarray(Image.open(dpath)).astype(np.float32) / depth_map_factor
            yield rgb, depth, float(os.path.splitext(name)[0])
        time.sleep(0.05)


def iter_v4l(index: int, cfg):
    """Frames of an OpenCV camera, with a flat 3 m depth (a webcam has no
    depth sensor; the plane keeps the pipeline running)."""
    try:
        import cv2
    except ImportError as e:
        raise SystemExit("the v4l source needs OpenCV (cv2), which is not installed") from e
    import numpy as np

    cap = cv2.VideoCapture(index)
    i = 0
    while True:
        ok, bgr = cap.read()
        if not ok:
            return
        rgb = bgr[..., ::-1]
        yield rgb, np.full(rgb.shape[:2], 3.0, np.float32), i / cfg.camera.fps
        i += 1


def load_registration(path: str, cfg):
    """(T_cd (4, 4) float32, the depth camera) from an npz with `T_cd` and
    the depth camera's `fx`, `fy`, `cx`, `cy` (its image size is the
    color camera's)."""
    import numpy as np

    from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig

    d = np.load(path)
    cam_d = CameraConfig(fx=float(d["fx"]), fy=float(d["fy"]), cx=float(d["cx"]),
                         cy=float(d["cy"]), width=cfg.camera.width, height=cfg.camera.height)
    return np.asarray(d["T_cd"], np.float32), cam_d


def run(frames, cfg, *, semantics: bool = False, dense_map: bool = False,
        undistort: bool = False, register=None, out: str = ".", device=None,
        log=print) -> LiveResult:
    """`SlamSystem.track_rgbd` on `frames`, an iterable of (rgb, depth
    metres, stamp): with `undistort` the color image is undistorted on the
    device first (and truncated back to uint8, as the JAX app does); with
    `register` = (T_cd, depth camera) the depth is registered into the
    color camera first. Then the trajectories, the map and, where on, the
    occupancy map and the object database are written to `out`."""
    import numpy as np
    import torch

    from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
    from orb_slam2_ssd_semantic_tpu_torch.ops.register import (
        register_depth_to_color,
        undistort_image,
    )
    from orb_slam2_ssd_semantic_tpu_torch.system import SlamSystem

    dev = device_mod.resolve(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cam = cfg.camera
    sys_ = SlamSystem(cfg, enable_semantics=semantics, enable_dense_map=dense_map, device=dev)
    times = []
    for n, (rgb, depth, stamp) in enumerate(frames):
        if undistort:
            rgb = undistort_image(rgb, cam, device=dev).cpu().numpy().astype(np.uint8)
        if register is not None:
            T_cd, cam_d = register
            depth = register_depth_to_color(np.asarray(depth, np.float32), T_cd, cam_d, cam,
                                            cam.height, cam.width, device=dev).cpu().numpy()
        t0 = time.perf_counter()
        sys_.track_rgbd(np.asarray(rgb), np.asarray(depth, np.float32), stamp)
        sync()
        times.append(time.perf_counter() - t0)
        if n % 30 == 0:
            s = sys_.tracker.stats[-1]
            log(f"frame {n:5d} status={s['status']:5s} inliers={s['inliers']:4d} "
                f"kfs={s['kfs']} points={s['points']} ({1.0 / max(times[-1], 1e-9):.1f} fps)")

    if not times:
        log("no frames received")
        return LiveResult(sys_, times)
    ft = np.array(times[1:]) if len(times) > 1 else np.array(times)
    log(f"{len(times)} frames; median {np.median(ft) * 1e3:.2f} ms, "
        f"mean {np.mean(ft) * 1e3:.2f} ms")
    os.makedirs(out, exist_ok=True)
    sys_.save_trajectory_tum(os.path.join(out, "CameraTrajectory.txt"))
    sys_.save_keyframe_trajectory_tum(os.path.join(out, "KeyFrameTrajectory.txt"))
    sys_.save_map(os.path.join(out, "map.npz"))
    if dense_map:
        sys_.save_octomap(os.path.join(out, "octomap.npz"))
    if semantics:
        sys_.save_objects(os.path.join(out, "objects.npz"))
    log(f"saved trajectories + map to {out}")
    return LiveResult(sys_, times)


def main(argv=None) -> LiveResult:
    p = argparse.ArgumentParser()
    p.add_argument("--source", default="synthetic")
    p.add_argument("--settings", default=None, help="OpenCV YAML or JSON config")
    p.add_argument("--frames", type=int, default=120, help="synthetic source length")
    p.add_argument("--semantics", action="store_true")
    p.add_argument("--dense-map", action="store_true")
    p.add_argument("--undistort", action="store_true",
                   help="undistort color frames on the device before tracking")
    p.add_argument("--register-depth", default=None, metavar="NPZ",
                   help="npz with T_cd (4x4) + depth-cam fx fy cx cy: register "
                        "depth into the color frame on the device")
    p.add_argument("--out", default=".", help="output directory for saves")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)

    from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
    from orb_slam2_ssd_semantic_tpu_torch.apps.rgbd_tum import load_config

    dev = device_mod.resolve(args.device)
    cfg = load_config(args.settings)
    if args.source == "synthetic":
        frames = iter_synthetic(args.frames, cfg)
    elif args.source.startswith("watch:"):
        frames = iter_watch(args.source[6:], cfg.camera.depth_map_factor)
    elif args.source.startswith("v4l:"):
        frames = iter_v4l(int(args.source[4:]), cfg)
    else:
        raise SystemExit(f"unknown source {args.source!r}")
    register = load_registration(args.register_depth, cfg) if args.register_depth else None
    return run(frames, cfg, semantics=args.semantics, dense_map=args.dense_map,
               undistort=args.undistort, register=register, out=args.out, device=dev)


if __name__ == "__main__":
    main()
