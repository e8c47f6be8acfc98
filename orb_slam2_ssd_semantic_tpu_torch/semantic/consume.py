"""Host-side metrics of the keyframe consumers (counterpart of the numpy
half of the JAX package's `semantic/consume.py`): how far the object
database's centroids lie from the planted ground-truth boxes.

The batched consumer itself (`make_batched_consume`: detection, fusion,
the object database and occupancy over a whole keyframe queue) comes with
dense mapping; `system.SlamSystem` runs the same consumers per keyframe.
"""

from __future__ import annotations

import numpy as np


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
