"""Batched keyframe consumers (counterpart of the JAX package's
`semantic/consume.py`): detection, fusion, the object database and
occupancy over a whole keyframe queue, and the host metrics that hold the
database against the planted ground-truth boxes.

`make_batched_consume` runs the pipeline `SlamSystem._on_new_keyframe`
runs per keyframe (the reference's RunDetect thread and the
MapDrawer::UpdateOctomap loop: RunDetect.cc:29-61, MapDrawer.cc:610-1025)
in the batch shape an offline run wants: the queue's detection as ONE
bf16 forward (`Detector.detect_batch`; RunDetect.cc:44 takes its queue
per wake), then, keyframe by keyframe in a host loop where JAX scans,
fusion, the database merge, the ground split and the raycast insertion
into one dense grid. The ground hypotheses come from the generator
handed to the call (JAX: a key split per keyframe).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.utils import precision


def make_batched_consume(cfg: SlamConfig, kf_frames, kf_slots,
                         grid_extent=(16.0, 4.0, 16.0), grid_origin=(-2.0, 0.0, -2.0),
                         grid_resolution: float = 0.1, detector=None, device=None):
    """Build `consume(g_dev, d_dev, T_cw_all, grid_lo, generator)` ->
    `(grid_log_odds, n_detections (Q,), db)` over the keyframe queue, on
    `device` (default: the card, raising without one).

    `kf_frames` (Q,): each queued keyframe's frame index into g_dev (uint8
    gray) and d_dev (uint16 millimetres); `kf_slots` (Q,): its slot in
    T_cw_all; `generator`: a CPU `torch.Generator` for the ground split's
    hypotheses. Returns (consume, detector)."""
    from orb_slam2_ssd_semantic_tpu_torch.dense import pointcloud
    from orb_slam2_ssd_semantic_tpu_torch.dense.occupancy import empty_grid, insert_scan
    from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
    from orb_slam2_ssd_semantic_tpu_torch.semantic.detector import Detector
    from orb_slam2_ssd_semantic_tpu_torch.semantic.fusion import fuse_detections
    from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import add_objects, empty_db

    dev = device_mod.resolve(device)
    det = detector or Detector(cfg.semantic, device=dev)
    dense_cfg = dataclasses.replace(
        cfg.dense, max_ray_steps=int(cfg.dense.cloud_max_depth / grid_resolution) + 8)
    kf_frames = [int(f) for f in np.asarray(kf_frames)]
    kf_slots = [int(s) for s in np.asarray(kf_slots)]

    @precision.scoped
    @torch.no_grad()
    def consume(g_dev, d_dev, T_cw_all, grid_lo, generator: torch.Generator):
        grid = empty_grid(extent=grid_extent, resolution=grid_resolution, origin=grid_origin,
                          device=dev).replace(log_odds=grid_lo.to(dev))
        grays = g_dev[kf_frames].to(dev, torch.float32)
        dets = det.detect_batch(list(grays[..., None].expand(*grays.shape, 3)))
        ndet = torch.stack([d.valid.sum() for d in dets])
        db = empty_db(cfg.semantic.max_objects, dev)
        for d_i, fi, slot in zip(dets, kf_frames, kf_slots):
            depth = d_dev[fi].to(dev, torch.float32) * 1e-3
            T_cw = T_cw_all[slot].to(dev)
            db = add_objects(db, *fuse_detections(d_i, depth, T_cw, cfg.camera, cfg.semantic))
            pts, valid = pointcloud.keyframe_cloud(depth, T_cw, cfg.camera, dense_cfg)
            # Ground rays only carve (MapDrawer.cc:946-1025), as on the
            # engine's path.
            idx = pointcloud.sample_ground_hypotheses(valid, dense_cfg.ground_ransac_iters,
                                                      generator)
            is_ground, _ = pointcloud.split_ground(pts, valid, idx, 1, dense_cfg)
            grid = insert_scan(grid, se3.se3_inverse(T_cw)[:3, 3], pts, valid,
                               carve_only=is_ground, cfg=dense_cfg)
        return grid.log_odds, ndet, db

    return consume, det


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def centroid_box_errors(db, gt_boxes) -> np.ndarray:
    """Per-valid-object distance (m) from its centroid to the NEAREST
    ground-truth axis-aligned box (0 inside the box)."""
    cen = _host(db.centroid)
    valid = _host(db.valid)
    gt = np.asarray(gt_boxes, np.float32)  # (G, 2, 3)
    errs = []
    for i in np.nonzero(valid)[0]:
        d = np.maximum(
            np.maximum(gt[:, 0] - cen[i][None], cen[i][None] - gt[:, 1]),
            0.0,
        )
        errs.append(float(np.sqrt((d ** 2).sum(-1)).min()))
    return np.asarray(errs, np.float32)


def gt_box_localization(db, gt_boxes, spurious_at: float = 0.3):
    """Per ground-truth box, the distance from the NEAREST database object
    (did the pipeline find and localize every planted object?), and the
    count of spurious objects (> `spurious_at` m from every box).

    Returns (per_gt_err (G,), n_spurious)."""
    cen = _host(db.centroid)
    valid = _host(db.valid)
    gt = np.asarray(gt_boxes, np.float32)  # (G, 2, 3)
    idx = np.nonzero(valid)[0]
    if len(idx) == 0:
        return np.full((len(gt),), np.inf, np.float32), 0
    c = cen[idx]  # (M, 3)
    d = np.maximum(
        np.maximum(gt[:, None, 0] - c[None], c[None] - gt[:, None, 1]), 0.0
    )  # (G, M, 3)
    dist = np.sqrt((d ** 2).sum(-1))  # (G, M)
    per_gt = dist.min(axis=1)
    n_spurious = int((dist.min(axis=0) > spurious_at).sum())
    return per_gt.astype(np.float32), n_spurious
