"""Point-cloud -> occupancy-map converter (counterpart of the JAX package's
`apps/cloud_to_occupancy.py`).

The engine's equivalent of the reference's `tool/pcd2octomap.cc` (read a
PCD point cloud, insert every point into an octomap, write `.ot`): read
a point cloud (.npz with `points` (N,3) [+ optional `colors`], or ASCII
.xyz/.txt with one `x y z` row per line), raycast-insert it into the
log-odds voxel grid from a given sensor origin, and save the grid
(dense/occupancy.py save format, which both packages read).

Usage:
    python -m orb_slam2_ssd_semantic_tpu_torch.apps.cloud_to_occupancy \
        cloud.npz map.npz --resolution 0.05 --origin 0 0 0
"""

from __future__ import annotations

import argparse

# Points per insertion, as the JAX app inserts them: each `insert_scan` is
# one log-odds update of the voxels its chunk touches, so the chunking is
# part of the map.
CHUNK = 16384


def load_cloud(path: str):
    import numpy as np

    if path.endswith(".npz"):
        data = np.load(path)
        return np.asarray(data["points"], np.float32)
    pts = np.loadtxt(path, dtype=np.float32)
    if pts.ndim == 1:
        pts = pts[None]
    return pts[:, :3]


def cloud_to_grid(pts, origin, cfg, extent=(10.0, 6.0, 10.0), device=None):
    """Insert the (N, 3) numpy cloud `pts` seen from `origin` into an empty
    grid of `extent` at `cfg.resolution`, CHUNK points at a time (the last
    chunk padded with invalid points)."""
    import numpy as np
    import torch

    from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
    from orb_slam2_ssd_semantic_tpu_torch.dense import occupancy as occ
    from orb_slam2_ssd_semantic_tpu_torch.utils.precision import highest_precision

    dev = device_mod.resolve(device)
    grid = occ.empty_grid(tuple(extent), cfg.resolution, device=dev)
    origin_t = torch.as_tensor(np.asarray(origin, np.float32)).to(dev)
    n = len(pts)
    pad = (-n) % CHUNK
    pts_p = torch.as_tensor(np.concatenate([pts, np.zeros((pad, 3), np.float32)])).to(dev)
    valid = torch.arange(n + pad, device=dev) < n
    with highest_precision():
        for i in range(0, n + pad, CHUNK):
            grid = occ.insert_scan(grid, origin_t, pts_p[i:i + CHUNK], valid[i:i + CHUNK],
                                   cfg=cfg)
    return grid


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("cloud", help="input .npz (points key) or ASCII xyz")
    p.add_argument("out", help="output occupancy map (.npz)")
    p.add_argument("--resolution", type=float, default=0.05)
    p.add_argument("--origin", type=float, nargs=3, default=[0.0, 0.0, 0.0],
                   help="sensor origin for free-space carving")
    p.add_argument("--extent", type=float, nargs=3, default=[10.0, 6.0, 10.0])
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    args = p.parse_args(argv)

    import dataclasses

    from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
    from orb_slam2_ssd_semantic_tpu_torch.config import DenseMapConfig
    from orb_slam2_ssd_semantic_tpu_torch.dense import occupancy as occ

    dev = device_mod.resolve(args.device)
    cfg = dataclasses.replace(DenseMapConfig(), resolution=args.resolution)
    pts = load_cloud(args.cloud)
    grid = cloud_to_grid(pts, args.origin, cfg, args.extent, dev)
    occ.save_grid(args.out, grid, cfg)
    n_occ = int(occ.occupied_mask(grid, cfg).sum())
    print(f"{len(pts)} points -> {n_occ} occupied voxels @ {args.resolution} m -> {args.out}")
    return grid


if __name__ == "__main__":
    main()
