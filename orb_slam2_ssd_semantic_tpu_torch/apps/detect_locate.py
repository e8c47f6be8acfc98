"""Standalone detect + locate demo, no SLAM (counterpart of the JAX
package's `apps/detect_locate.py`).

The engine's equivalent of the reference's `realtime_dect_loc/` demo
(realtime_dect_loc/src/main.cpp:34-159): a camera-free program that runs
RGB-D frames through the SSD detector and one of the two 2D->3D fusion
schemes (2d_3d_merge.cpp: fuse_depth_window; mergeSG.cpp:
fuse_segmentation), accumulating localized objects in the semantic
object database and printing each frame's labeled detections, headless.

Frame sources:
  --source synthetic     deterministic rendered room (default)
  --source <dir>         directory of paired `rgb_*.npy` / `depth_*.npy`
                         arrays (uint8 HxWx3, float32 meters)

`--params` loads a checkpoint in the JAX package's npz layout; the
detector takes the checkpoint's class count (JAX's app keeps 21 classes
and fails on another count at the first forward).

Usage:
    python -m orb_slam2_ssd_semantic_tpu_torch.apps.detect_locate --frames 10
    python -m orb_slam2_ssd_semantic_tpu_torch.apps.detect_locate --scheme seg
"""

from __future__ import annotations

import argparse
import time


def iter_frames(source: str, n_frames: int):
    """Yield (rgb uint8 HxWx3, depth float32 m) pairs."""
    import numpy as np

    if source == "synthetic":
        from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import SyntheticSequence

        seq = SyntheticSequence(n_frames=n_frames)
        for i in range(len(seq)):
            gray, depth = seq.gray_depth(i)
            rgb = np.repeat(
                np.clip(gray, 0, 255).astype(np.uint8)[..., None], 3, axis=-1
            )
            yield rgb, depth.astype(np.float32)
    else:
        import glob
        import os

        rgbs = sorted(glob.glob(os.path.join(source, "rgb_*.npy")))[:n_frames]
        for rp in rgbs:
            dp = rp.replace("rgb_", "depth_")
            yield np.load(rp), np.load(dp).astype(np.float32)


def load_detector(sem, params_path: str | None = None, device=None):
    """A `Detector` for `sem`; with `params_path`, on that npz checkpoint at
    its class count."""
    import dataclasses

    import numpy as np

    from orb_slam2_ssd_semantic_tpu_torch.semantic.detector import Detector
    from orb_slam2_ssd_semantic_tpu_torch.semantic.ssdlite import params_from_flax

    if not params_path:
        return Detector(sem, device=device)
    with np.load(params_path) as z:
        params = params_from_flax({k: z[k] for k in z.files})
    n_cls = params["SSDLiteHead_1.Conv_1.bias"].shape[0] // 6
    return Detector(dataclasses.replace(sem, num_classes=n_cls), params=params, device=device)


def locate(frames, det, cam, sem, scheme: str = "depth", log=print):
    """Detect and fuse each (rgb, depth) of `frames` at the identity pose
    into a fresh object database on the detector's device. Returns
    (database, per-frame seconds, host clock ending in a synchronize on
    the card)."""
    import numpy as np
    import torch

    from orb_slam2_ssd_semantic_tpu_torch.semantic import fusion
    from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import add_objects, empty_db
    from orb_slam2_ssd_semantic_tpu_torch.semantic.ssdlite import VOC_CLASSES
    from orb_slam2_ssd_semantic_tpu_torch.utils.precision import highest_precision

    dev = det.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    db = empty_db(device=dev)
    T_identity = torch.eye(4, dtype=torch.float32, device=dev)
    fuse = fusion.fuse_depth_window if scheme == "depth" else fusion.fuse_segmentation
    times = []
    for i, (rgb, depth) in enumerate(frames):
        t0 = time.perf_counter()
        d = det(rgb)
        with highest_precision():
            cen, size, prob, cls, ok = fuse(d, torch.as_tensor(depth).to(dev), T_identity, cam,
                                            sem)
            db = add_objects(db, cen, size, prob, cls, ok)
        ok_np = ok.cpu().numpy()
        sync()
        times.append(time.perf_counter() - t0)
        cen_np = cen.cpu().numpy()
        labels = [
            f"{VOC_CLASSES[int(c)]}:{float(s):.2f}@{np.round(cen_np[j], 2).tolist()}"
            for j, (c, s) in enumerate(zip(d.classes.cpu().numpy(), d.scores.cpu().numpy()))
            if ok_np[j]
        ]
        log(f"frame {i:3d}  {len(labels)} localized  {labels}")
    return db, times


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--source", default="synthetic")
    p.add_argument("--scheme", default="depth", choices=["depth", "seg"],
                   help="fusion scheme: depth window (Merge2d3d) or "
                        "segmentation (MergeSG)")
    p.add_argument("--params", default=None, help="trained SSDLite params (.npz)")
    p.add_argument("--score", type=float, default=None,
                   help="detection score threshold override")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)

    import dataclasses

    import numpy as np

    from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
    from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, SemanticConfig
    from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import summarize

    dev = device_mod.resolve(args.device)
    cam = CameraConfig()
    sem = SemanticConfig()
    if args.score is not None:
        sem = dataclasses.replace(sem, det_score_threshold=args.score)
    det = load_detector(sem, args.params, dev)
    db, times = locate(iter_frames(args.source, args.frames), det, cam, det.cfg, args.scheme)

    print(f"\nmedian frame time: {np.median(times) * 1000:.1f} ms")
    print("object database:")
    for row in summarize(db):
        print(" ", row)
    return db


if __name__ == "__main__":
    main()
