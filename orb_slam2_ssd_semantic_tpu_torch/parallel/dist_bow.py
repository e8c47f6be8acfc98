"""Keyframe-sharded place-recognition scoring over the device mesh
(counterpart of the JAX package's `parallel/dist_bow.py`).

The scale-out of the KeyFrameDatabase query
(perfect/src/KeyFrameDatabase.cc:76-197, DetectLoopCandidates): the BoW
database, one vector per keyframe, grows with the map, so it is what gets
sharded over the ``kf`` axis. Each rank scores the replicated query
against its own rows, applies the validity, exclusion and min-score gates
there, and keeps its local top C candidates; only those C (score, global
id) pairs per rank are all-gathered for the final top C. Communication
per query: C * ranks * 8 bytes, whatever the database size.

The selections take the stable `utils/tensor_ops.top_k` (lower index
first among equal scores), so ties resolve as `lax.top_k` resolves them
and as `place_recognition.detect_candidates` does.
"""

from __future__ import annotations

import torch

from orb_slam2_ssd_semantic_tpu_torch.io import vocabulary as voc
from orb_slam2_ssd_semantic_tpu_torch.parallel.mesh import (
    KF_AXIS,
    gather_rows,
    replicate,
)
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import top_k


def make_sharded_detect(mesh, max_candidates: int = 4):
    """detect(query_vec, db_vecs, db_valid, exclude, min_score) with
    db_vecs, db_valid and exclude this rank's kf rows (the database's rows
    split evenly over the axis) and query_vec replicated. Returns
    `place_recognition.detect_candidates`'s (ids, scores, ok), the same on
    every rank."""

    def detect(query_vec, db_vecs, db_valid, exclude, min_score):
        query_vec = replicate(query_vec, mesh, KF_AXIS)
        s = db_vecs @ query_vec
        s = torch.where(db_valid & ~exclude, s, torch.full_like(s, -1.0))
        # A shard with fewer than C rows pads its candidates with -1
        # sentinels.
        k_local = min(max_candidates, s.shape[0])
        loc_s, loc_i = top_k(s, k_local)
        if k_local < max_candidates:
            pad = max_candidates - k_local
            loc_s = torch.cat([loc_s, loc_s.new_full((pad,), -1.0)])
            loc_i = torch.cat([loc_i, loc_i.new_zeros((pad,))])
        # Global ids: rank r owns rows [r * n_local, (r + 1) * n_local).
        loc_i = loc_i + mesh.get_local_rank(KF_AXIS) * s.shape[0]
        all_s = gather_rows(loc_s, mesh, KF_AXIS)
        all_i = gather_rows(loc_i, mesh, KF_AXIS)
        top_s, sel = top_k(all_s, max_candidates)
        return all_i[sel], top_s, top_s >= max(float(min_score), 0.0)

    return detect


def make_sharded_l1_scores(mesh, n_words: int):
    """The engine's keyframe-sharded DBoW2 L1 query
    (`SlamSystem(mesh=...)`): score(q_words, q_vals, db_words, db_vals)
    with the query's columns replicated and db_words/db_vals this rank's
    kf rows; each rank scores its rows (`io/vocabulary.l1_scores`) and the
    (F,) row is gathered, the same on every rank."""

    def score(q_words, q_vals, db_words, db_vals):
        q_words = replicate(q_words, mesh, KF_AXIS)
        q_vals = replicate(q_vals, mesh, KF_AXIS)
        return gather_rows(voc.l1_scores(q_words, q_vals, db_words, db_vals, n_words), mesh,
                           KF_AXIS)

    return score


def make_sharded_bow_vectors(mesh, bow_fn):
    """build(desc, valid) -> `bow_fn(desc[i], valid[i])` stacked over this
    rank's kf rows: descriptors (F/k, N, 8) in, this rank's (F/k, K) rows
    of the BoW database out (the database-build side of the sharded
    query)."""

    def build(desc, valid):
        return torch.stack([bow_fn(d, v) for d, v in zip(desc, valid)])

    return build
