"""Appearance-based place recognition with a flat codebook (counterpart
of the JAX package's `mapping/place_recognition.py`).

The vocabulary here is a FLAT random binary codebook (K words): every
frame descriptor is assigned to its nearest word with one batched
Hamming matrix, frames become L2-normalized TF histograms, and
similarity is a dot product, so scoring a keyframe against the whole
database is one matrix-vector product. `detect_candidates` keeps the
reference's gates: drop excluded keyframes and those under a minimum
score, return the top candidates (DetectLoopCandidates,
KeyFrameDatabase.cc:76-197).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch.ops.match import hamming_matrix
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import top_k

VOCAB_SIZE = 256


@functools.lru_cache()
def codebook(seed: int = 7, k: int = VOCAB_SIZE) -> np.ndarray:
    """(k, 8) uint32 random binary words. Deterministic."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(k, 8), dtype=np.uint32)


def bow_vector(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 packed descriptors -> (K,) L2-normalized TF histogram."""
    cb = torch.from_numpy(codebook().view(np.int32)).to(desc.device)
    K = cb.shape[0]
    word = torch.argmin(hamming_matrix(desc, cb), dim=-1)  # first among equals
    word = torch.where(valid, word, torch.full_like(word, K))  # K = drop slot
    hist = torch.zeros((K + 1,), dtype=torch.float32, device=desc.device).index_add(
        0, word, torch.ones(word.shape, dtype=torch.float32, device=desc.device))[:K]
    return hist / torch.clamp(torch.linalg.norm(hist), min=1e-9)


def bow_scores(query: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """query (K,) vs db (F, K) -> (F,) cosine similarities."""
    return db @ query


def detect_candidates(query_vec, db_vecs, db_valid, exclude, min_score: float,
                      max_candidates: int = 4):
    """Loop-candidate retrieval (DetectLoopCandidates semantics): score
    all database keyframes, drop excluded ones (the query's covisibility
    neighbourhood) and those below `min_score`, return the top ones.

    Returns (ids (C,), scores (C,), valid (C,))."""
    s = bow_scores(query_vec, db_vecs)
    s = torch.where(db_valid & ~exclude, s, torch.full_like(s, -1.0))
    top_s, top_i = top_k(s, max_candidates)
    return top_i, top_s, top_s >= max(float(min_score), 0.0)
