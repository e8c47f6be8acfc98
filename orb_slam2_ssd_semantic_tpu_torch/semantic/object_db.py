"""Persistent 3D semantic object database (counterpart of the JAX package's
`semantic/object_db.py`; the reference's ObjectDatabase,
perfect/src/ObjectDatabase.cc).

A fixed-capacity columnar store of semantic clusters
(Cluster{size, centroid, prob, class_id, object_id}, ObjectDatabase.h:18-27)
with the reference's merge rule (addObject, ObjectDatabase.cc:78-147):
among same-class entries take the nearest centroid; within the per-class
merge radius, average prob, centroid and size into it, else append.

Copied as the JAX version has them: the nearest entry of a class with no
entry is index 0 (`argmin` of an all-inf row), and the radius comes from
the per-class table, never from `SemanticConfig.default_merge_radius`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod

# Per-class merge radii, meters (ObjectDatabase.cc:22-43); index = VOC id.
MERGE_RADII = np.full((21,), 0.6, dtype=np.float32)
MERGE_RADII[5] = 0.06  # bottle
MERGE_RADII[9] = 0.5  # chair
MERGE_RADII[15] = 0.35  # person
MERGE_RADII[20] = 0.25  # tvmonitor


class ObjectDB(NamedTuple):
    centroid: torch.Tensor  # (M, 3)
    size: torch.Tensor  # (M, 3) bounding-box extents
    prob: torch.Tensor  # (M,)
    class_id: torch.Tensor  # (M,) int32
    n_merged: torch.Tensor  # (M,) int32 observation count
    valid: torch.Tensor  # (M,) bool
    cursor: torch.Tensor  # () int32


def empty_db(capacity: int = 256, device=None) -> ObjectDB:
    """An empty database on `device` (default: the card, raising without one)."""
    dev = device_mod.resolve(device)
    return ObjectDB(
        centroid=torch.zeros((capacity, 3), dtype=torch.float32, device=dev),
        size=torch.zeros((capacity, 3), dtype=torch.float32, device=dev),
        prob=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        class_id=torch.full((capacity,), -1, dtype=torch.int32, device=dev),
        n_merged=torch.zeros((capacity,), dtype=torch.int32, device=dev),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        cursor=torch.zeros((), dtype=torch.int32, device=dev),
    )


def add_objects(db: ObjectDB, centroids: torch.Tensor, sizes: torch.Tensor, probs: torch.Tensor,
                class_ids: torch.Tensor, cand_valid: torch.Tensor) -> ObjectDB:
    """Merge-or-append candidate clusters (C, ...) one after the other, as
    the JAX version's `lax.scan`: each candidate sees the database the
    earlier ones left. Each write is a row mask, so a candidate that
    neither merges nor appends (invalid, or the database full) changes
    nothing. Returns a new database; `db` is not modified. No host sync."""
    dev = db.centroid.device
    M = db.valid.shape[0]
    radii = torch.as_tensor(MERGE_RADII).to(dev)
    rows = torch.arange(M, device=dev)
    centroid, size, prob = db.centroid, db.size, db.prob
    class_id, n_merged, valid, cursor = db.class_id, db.n_merged, db.valid, db.cursor
    class_ids = class_ids.to(torch.int32)
    for i in range(centroids.shape[0]):
        c, s, p, cid, ok = centroids[i], sizes[i], probs[i], class_ids[i], cand_valid[i]
        dist = torch.linalg.vector_norm(centroid - c[None, :], dim=-1)
        same = valid & (class_id == cid)
        dist = torch.where(same, dist, torch.inf)
        # Indices stay 1-element tensors: a 0-dim tensor index is read
        # to the host.
        j = torch.argmin(dist).reshape(1)
        radius = radii[torch.clamp(cid, 0, radii.shape[0] - 1).reshape(1).to(torch.int64)][0]
        near = dist[j][0] < radius

        # Merge: running average (ObjectDatabase.cc:129-134).
        n_j = n_merged[j][0]
        w_new = 1.0 / (n_j.to(torch.float32) + 1.0)
        merged_centroid = centroid[j][0] * (1 - w_new) + c * w_new
        merged_size = size[j][0] * (1 - w_new) + s * w_new
        merged_prob = prob[j][0] * (1 - w_new) + p * w_new

        slot_new = torch.clamp(cursor, max=M - 1)
        do_merge = ok & near
        do_append = ok & ~near & (cursor < M)
        row = (rows == torch.where(do_merge, j[0], slot_new)) & (do_merge | do_append)
        row3 = row[:, None]
        centroid = torch.where(row3, torch.where(do_merge, merged_centroid, c), centroid)
        size = torch.where(row3, torch.where(do_merge, merged_size, s), size)
        prob = torch.where(row, torch.where(do_merge, merged_prob, p), prob)
        class_id = torch.where(row, cid, class_id)
        n_merged = torch.where(row, torch.where(do_merge, n_j + 1, 1), n_merged)
        valid = valid | row
        cursor = cursor + do_append.to(torch.int32)
    return ObjectDB(centroid, size, prob, class_id, n_merged, valid, cursor)


def save_objects_txt(path: str, db: ObjectDB) -> None:
    """Text dump of the semantic database, one object per line (class
    centroid_xyz size_xyz prob observations), the persistent analogue of
    the reference's objectD.txt console dump."""
    lines = []
    for o in summarize(db):
        c, s = o["centroid"], o["size"]
        lines.append(
            f"{o['class']} {c[0]:.4f} {c[1]:.4f} {c[2]:.4f} "
            f"{s[0]:.4f} {s[1]:.4f} {s[2]:.4f} {o['prob']:.3f} {o['observations']}"
        )
    with open(path, "w") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))


def save_db(path: str, db: ObjectDB) -> None:
    """Binary save of the full database: the JAX version's npz columns and
    dtypes, so either package loads what the other wrote."""
    np.savez_compressed(path, **{k: v.detach().cpu().numpy() for k, v in db._asdict().items()})


def load_db(path: str, device=None) -> ObjectDB:
    """Load a database saved by `save_db` (of either package) onto `device`
    (default: the card, raising without one)."""
    dev = device_mod.resolve(device)
    with np.load(path) as z:
        cols = {k: torch.as_tensor(np.asarray(z[k])).to(dev)
                for k in ("centroid", "size", "prob", "class_id", "n_merged", "valid")}
        cursor = torch.tensor(int(z["cursor"]), dtype=torch.int32, device=dev)
    return ObjectDB(cursor=cursor, **cols)


def summarize(db: ObjectDB) -> list:
    """Host-side listing, the analogue of the reference's objectD.txt."""
    from orb_slam2_ssd_semantic_tpu_torch.semantic.ssdlite import VOC_CLASSES

    cols = {k: v.detach().cpu().numpy() for k, v in db._asdict().items()}
    return [
        {
            "object_id": int(i),
            "class": VOC_CLASSES[int(cols["class_id"][i])],
            "centroid": cols["centroid"][i].tolist(),
            "size": cols["size"][i].tolist(),
            "prob": float(cols["prob"][i]),
            "observations": int(cols["n_merged"][i]),
        }
        for i in np.nonzero(cols["valid"])[0]
    ]
