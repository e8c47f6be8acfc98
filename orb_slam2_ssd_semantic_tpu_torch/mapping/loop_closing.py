"""The keyframe database of loop closing (counterpart of the first half of
the JAX package's `mapping/loop_closing.py`, `LoopCloser`).

What is ported is what relocalization needs: the place-recognition
backend (a DBoW2 vocabulary, or the flat codebook of
`place_recognition.py`), insertion of a keyframe into the database, and
scoring of a keyframe or an arbitrary frame against it
(DetectRelocalizationCandidates' side, KeyFrameDatabase.cc:199).
Loop detection and correction (the JAX `_detect`,
`_estimate_loop_transform`, `_correct`: Sim3, pose graph, global BA) are
not ported yet: `on_keyframe` raises `NotImplementedError` where it would
reach them, which a tracker with `loop.enabled = False` never does. A
multi-device `mesh` is refused likewise.

`database_from_numpy` / `database_to_numpy` carry the database to and
from the JAX closer's arrays (`word_db`/`val_db`, or `bow_db`).
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.io import vocabulary as voc
from orb_slam2_ssd_semantic_tpu_torch.io.artifacts import find_checkpoint, warn_missing
from orb_slam2_ssd_semantic_tpu_torch.mapping import place_recognition as pr
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import SlamState
from orb_slam2_ssd_semantic_tpu_torch.utils import precision


class LoopCloser:
    def __init__(self, cfg: SlamConfig, device=None, mesh=None):
        """`cfg.loop.vocabulary_path` names a DBoW2 vocabulary (`.npz`
        binary or text); "auto" resolves the trained
        `checkpoints/orbvoc_synth.npz` and, when it is missing, warns and
        takes the flat codebook (as the JAX closer does); None takes the
        flat codebook. `device=None` runs on the card."""
        if mesh is not None:
            raise NotImplementedError("the multi-device keyframe database is not ported yet")
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        self.last_loop_uid = -(10 ** 9)
        F, K = cfg.map.max_keyframes, cfg.orb.max_keypoints
        p = cfg.loop.vocabulary_path
        if p == "auto":
            p = find_checkpoint("orbvoc_synth.npz")
            if p is None:
                warn_missing("orbvoc_synth.npz", "the flat random codebook")
        self.vocab = None  # the vocabulary's tree on the device, or None: the codebook
        if p:
            vocab = voc.load_binary(p) if p.endswith(".npz") else voc.load_text_vocabulary(p)
            self.vocab = voc.to_device(vocab, self.device)
            self.word_db = torch.full((F, K), -1, dtype=torch.int64, device=self.device)
            self.val_db = torch.zeros((F, K), dtype=torch.float32, device=self.device)
        else:
            self.bow_db = torch.zeros((F, pr.VOCAB_SIZE), dtype=torch.float32, device=self.device)

    @property
    def backend(self) -> str:
        """"vocabulary (<k>^<depth>, <n> words)" or "flat codebook (<K> words)"."""
        if self.vocab is None:
            return f"flat codebook ({pr.VOCAB_SIZE} words)"
        k = self.vocab.children.shape[1]
        return f"vocabulary ({k}^{self.vocab.depth}, {self.vocab.n_words} words)"

    # ---- carrying the database across -----------------------------------

    def database_from_numpy(self, db: dict) -> None:
        """Take the JAX closer's database: {"word_db", "val_db"} for the
        vocabulary backend, {"bow_db"} for the codebook."""
        if self.vocab is not None:
            self.word_db = torch.from_numpy(np.asarray(db["word_db"]).astype(np.int64)).to(self.device)
            self.val_db = torch.from_numpy(np.array(db["val_db"], np.float32)).to(self.device)
        else:
            self.bow_db = torch.from_numpy(np.array(db["bow_db"], np.float32)).to(self.device)

    def database_to_numpy(self) -> dict:
        """The database with the JAX closer's names and dtypes."""
        if self.vocab is not None:
            return {"word_db": self.word_db.cpu().numpy().astype(np.int32),
                    "val_db": self.val_db.cpu().numpy()}
        return {"bow_db": self.bow_db.cpu().numpy()}

    # ---- per-keyframe hooks ----------------------------------------------

    def _add_and_score(self, state: SlamState, kf_id: int) -> np.ndarray:
        """Insert keyframe kf_id into the BoW database and return its
        similarity scores against every database row (F,)."""
        desc = state.kfs.desc[kf_id]
        valid = state.kfs.kp_valid[kf_id]
        if self.vocab is not None:
            words = voc.quantize(self.vocab, desc, valid)
            vals = voc.bow_columns(words, self.vocab.idf)
            self.word_db = self.word_db.clone()
            self.val_db = self.val_db.clone()
            self.word_db[kf_id] = words
            self.val_db[kf_id] = vals
            return self._score_db(words, vals)
        vec = pr.bow_vector(desc, valid)
        self.bow_db = self.bow_db.clone()
        self.bow_db[kf_id] = vec
        return pr.bow_scores(vec, self.bow_db).cpu().numpy()

    def frame_scores(self, desc: torch.Tensor, valid: torch.Tensor) -> np.ndarray:
        """Score an arbitrary frame against the database WITHOUT
        inserting it (DetectRelocalizationCandidates side). (F,) numpy."""
        if self.vocab is not None:
            words = voc.quantize(self.vocab, desc, valid)
            return self._score_db(words, voc.bow_columns(words, self.vocab.idf))
        return pr.bow_scores(pr.bow_vector(desc, valid), self.bow_db).cpu().numpy()

    def _score_db(self, words, vals) -> np.ndarray:
        return voc.l1_scores(words, vals, self.word_db, self.val_db,
                             self.vocab.n_words).cpu().numpy()

    @precision.scoped
    def on_keyframe(self, state: SlamState, kf_id: int):
        """Update the BoW database with the keyframe in SLOT `kf_id` (recency
        is measured in uids: slots are reused). Returns (state, closed).
        Past the recency gate, loop detection and correction would run:
        they are not ported, and raise."""
        cfg = self.cfg
        self._add_and_score(state, kf_id)
        kf_uid = int(state.kfs.uid[kf_id])
        if kf_uid < cfg.loop.min_kfs_before_loop or (
            kf_uid - self.last_loop_uid < cfg.loop.min_kfs_before_loop
        ):
            return state, False
        raise NotImplementedError(
            "loop detection and correction are not ported yet: keyframes past the "
            "recency gate can only be added with LoopConfig(enabled=False)")
