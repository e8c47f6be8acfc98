"""Port parity: the DBoW2 vocabulary, the flat codebook and the keyframe
database of `LoopCloser` against the JAX package on the same numpy
inputs.

Tolerances, and why: word ids, candidate ids and every numpy-built array
(random vocabularies, the codebook) are discrete or copied code, so they
are exact; BoW values and scores are f32 sums of the same terms taken in
another order (XLA's scatter-add and reductions against torch's), so they
agree within 1e-6.
"""

import dataclasses
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.io import vocabulary as jvoc
from orb_slam2_ssd_semantic_tpu.mapping import place_recognition as jpr
from orb_slam2_ssd_semantic_tpu.mapping.loop_closing import LoopCloser as JLoopCloser
from orb_slam2_ssd_semantic_tpu.mapping.map_state import empty_state as j_empty_state
from orb_slam2_ssd_semantic_tpu_torch.io import vocabulary as tvoc
from orb_slam2_ssd_semantic_tpu_torch.mapping import loop_closing as tlc
from orb_slam2_ssd_semantic_tpu_torch.mapping import place_recognition as tpr
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import state_from_numpy
from _torch_threads import _few_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
TRAINED = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "orbvoc_synth.npz")
SCORE_ATOL = 1e-6


def _t(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a))


def _tree(state):
    if hasattr(state, "_asdict"):
        return {k: _tree(v) for k, v in state._asdict().items()}
    return np.asarray(state)


def _vocab(kind: str):
    if kind == "trained":
        return jvoc.load_binary(TRAINED)
    return jvoc.make_random_vocabulary(seed=5, k=4, depth=3, n_desc=800)


def _descriptors(vocab, n: int, seed: int):
    """Random descriptors, half of them node descriptors with a few bits
    flipped (so distances to sibling nodes tie and the first-of-equals
    rule decides), with a tenth of the rows invalid."""
    rng = np.random.default_rng(seed)
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    near = vocab.desc[rng.integers(1, vocab.desc.shape[0], n // 2)].copy()
    near[:, 0] ^= np.uint32(1) << rng.integers(0, 32, n // 2).astype(np.uint32)
    desc[: n // 2] = near
    return desc, rng.random(n) > 0.1


def test_random_vocabulary_and_codebook_are_copied_exactly():
    for args in (dict(seed=5, k=4, depth=3, n_desc=800), dict(seed=3, k=10, depth=4)):
        vj, vt = jvoc.make_random_vocabulary(**args), tvoc.make_random_vocabulary(**args)
        assert (vt.k, vt.depth, vt.n_words) == (vj.k, vj.depth, vj.n_words)
        for name in ("children", "desc", "word_id", "word_weight"):
            a, b = getattr(vj, name), getattr(vt, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jpr.codebook(), tpr.codebook())


def test_vocabulary_files_round_trip(tmp_path):
    """A JAX-written binary file loads in the port, and the port's text
    writer and reader give the same tree back."""
    v = jvoc.make_random_vocabulary(seed=2, k=4, depth=3, n_desc=500)
    jvoc.save_binary(v, str(tmp_path / "v.npz"))
    vb = tvoc.load_binary(str(tmp_path / "v.npz"))
    tvoc.save_text_vocabulary(vb, str(tmp_path / "v.txt"))
    vt = tvoc.load_text_vocabulary(str(tmp_path / "v.txt"))
    for got in (vb, vt):
        for name in ("children", "desc", "word_id", "word_weight"):
            np.testing.assert_array_equal(getattr(got, name), getattr(v, name))


@pytest.mark.parametrize("kind", ["trained", "random"])
def test_quantize_gives_the_same_words(kind):
    vocab = _vocab(kind)
    desc, valid = _descriptors(vocab, 1024, seed=11)
    wj = np.asarray(jvoc.quantize(vocab, jnp.asarray(desc), jnp.asarray(valid)))
    wt = tvoc.quantize(tvoc.to_device(vocab, CPU), _t(desc), _t(valid)).numpy()
    assert len(np.unique(wj[wj >= 0])) > 50, "vacuous: few distinct words"
    np.testing.assert_array_equal(wt, wj)


@pytest.mark.parametrize("kind", ["trained", "random"])
def test_bow_columns_and_l1_scores(kind):
    vocab = _vocab(kind)
    dv = tvoc.to_device(vocab, CPU)
    idf_j = jnp.asarray(vocab.word_weight)
    rows_j, rows_t = [], []
    for seed in range(4):
        desc, valid = _descriptors(vocab, 512, seed=20 + seed)
        wj = jvoc.quantize(vocab, jnp.asarray(desc), jnp.asarray(valid))
        rows_j.append((wj, jvoc.bow_columns(wj, idf_j)))
        wt = tvoc.quantize(dv, _t(desc), _t(valid))
        rows_t.append((wt, tvoc.bow_columns(wt, dv.idf)))
    for (wj, cj), (wt, ct) in zip(rows_j, rows_t):
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=SCORE_ATOL, rtol=0)
        assert abs(float(ct.sum()) - 1.0) < 1e-5
    db_wj = jnp.stack([w for w, _ in rows_j])
    db_vj = jnp.stack([v for _, v in rows_j])
    db_wt = torch.stack([w for w, _ in rows_t])
    db_vt = torch.stack([v for _, v in rows_t])
    for q in range(4):
        sj = jvoc.l1_scores(rows_j[q][0], rows_j[q][1], db_wj, db_vj, vocab.n_words)
        st = tvoc.l1_scores(rows_t[q][0], rows_t[q][1], db_wt, db_vt, vocab.n_words)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=SCORE_ATOL, rtol=0)
        assert st[q] > 0.999  # a frame against its own column


def test_codebook_bow_vector_and_detect_candidates():
    rng = np.random.default_rng(4)
    base = rng.integers(0, 2**32, (800, 8), dtype=np.uint32)
    frames = [base[i * 40: i * 40 + 512] for i in range(6)]  # overlapping views
    valid = rng.random(512) > 0.05
    vj = [jpr.bow_vector(jnp.asarray(f), jnp.asarray(valid)) for f in frames]
    vt = [tpr.bow_vector(_t(f), _t(valid)) for f in frames]
    for a, b in zip(vj, vt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=SCORE_ATOL, rtol=0)
    db_valid = np.array([True, True, False, True, True, True, True, False])
    exclude = np.zeros(8, bool)
    exclude[4] = True
    db_j = jnp.concatenate([jnp.stack(vj), jnp.zeros((2, tpr.VOCAB_SIZE))])
    db_t = torch.cat([torch.stack(vt), torch.zeros((2, tpr.VOCAB_SIZE))])
    for min_score in (0.0, 0.5):
        ij, sj, okj = jpr.detect_candidates(vj[1], db_j, jnp.asarray(db_valid),
                                            jnp.asarray(exclude), jnp.float32(min_score),
                                            max_candidates=4)
        it, st, okt = tpr.detect_candidates(vt[1], db_t, _t(db_valid), _t(exclude), min_score,
                                            max_candidates=4)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=SCORE_ATOL, rtol=0)


def _small_cfg(mod, vocabulary_path):
    base = mod.SlamConfig()
    return base.replace(
        orb=mod.OrbConfig(n_features=500, max_keypoints=512),
        map=dataclasses.replace(base.map, max_keyframes=8, max_map_points=1024),
        loop=dataclasses.replace(base.loop, enabled=False, enable_relocalization=True,
                                 vocabulary_path=vocabulary_path))


@pytest.fixture(scope="module")
def random_vocab_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("voc") / "voc.npz")
    jvoc.save_binary(jvoc.make_random_vocabulary(seed=5, k=4, depth=3, n_desc=800), p)
    return p


@pytest.mark.parametrize("backend", ["trained", "file", "codebook"])
def test_loopcloser_database_and_frame_scores(backend, random_vocab_path):
    path = {"trained": "auto", "file": random_vocab_path, "codebook": None}[backend]
    cj, ct = _small_cfg(jconfig, path), _small_cfg(tconfig, path)
    rng = np.random.default_rng(9)
    K = cj.orb.max_keypoints
    state = j_empty_state(cj)
    desc = rng.integers(0, 2**32, (2, K, 8), dtype=np.uint32)
    kp_valid = rng.random((2, K)) > 0.1
    kfs = state.kfs._replace(
        desc=state.kfs.desc.at[:2].set(jnp.asarray(desc)),
        kp_valid=state.kfs.kp_valid.at[:2].set(jnp.asarray(kp_valid)),
        valid=state.kfs.valid.at[:2].set(True),
        uid=state.kfs.uid.at[:2].set(jnp.arange(2, dtype=jnp.int32)))
    state = state._replace(kfs=kfs, n_kfs=jnp.int32(2))
    lj = JLoopCloser(cj)
    lt = tlc.LoopCloser(ct, device="cpu")
    assert (lt.vocab is None) == (lj.vocab is None) == (backend == "codebook")
    st = state_from_numpy(_tree(state), CPU)
    for slot in (0, 1):
        state, closed_j = lj.on_keyframe(state, slot)
        _, closed_t = lt.on_keyframe(st, slot)
        assert not closed_j and not closed_t
    db = lt.database_to_numpy()
    if backend == "codebook":
        np.testing.assert_allclose(db["bow_db"], np.asarray(lj.bow_db), atol=SCORE_ATOL, rtol=0)
    else:
        np.testing.assert_array_equal(db["word_db"], np.asarray(lj.word_db))
        np.testing.assert_allclose(db["val_db"], np.asarray(lj.val_db), atol=SCORE_ATOL, rtol=0)
    # A frame sharing most of keyframe 1's descriptors, scored by both.
    q = desc[1].copy()
    q[::4] = rng.integers(0, 2**32, q[::4].shape, dtype=np.uint32)
    qv = np.ones(K, bool)
    sj = lj.frame_scores(jnp.asarray(q), jnp.asarray(qv))
    s_t = lt.frame_scores(_t(q), _t(qv))
    np.testing.assert_allclose(s_t, sj, atol=SCORE_ATOL, rtol=0)
    assert s_t[1] > s_t[0] and s_t[1] > 0.5
    # The JAX database carried into a fresh port closer scores the same.
    fresh = tlc.LoopCloser(ct, device="cpu")
    jdb = ({"bow_db": np.asarray(lj.bow_db)} if lj.vocab is None
           else {"word_db": np.asarray(lj.word_db), "val_db": np.asarray(lj.val_db)})
    fresh.database_from_numpy(jdb)
    np.testing.assert_allclose(fresh.frame_scores(_t(q), _t(qv)), sj, atol=SCORE_ATOL, rtol=0)


def test_loopcloser_missing_vocabulary_warns_and_refuses_what_is_not_ported(monkeypatch):
    cfg = _small_cfg(tconfig, "auto")
    lc = tlc.LoopCloser(cfg, device="cpu")
    assert lc.vocab is not None and lc.backend.startswith("vocabulary (10^4")
    monkeypatch.setattr(tlc, "find_checkpoint", lambda name: None)
    with pytest.warns(UserWarning, match="orbvoc_synth.npz"):
        lc = tlc.LoopCloser(cfg, device="cpu")
    assert lc.vocab is None and lc.backend.startswith("flat codebook")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(UserWarning):
            tlc.LoopCloser(cfg, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tlc.LoopCloser(cfg, device="cpu", mesh=object())
    # A keyframe past the recency gate runs loop detection, which finds
    # no candidate in an empty map.
    from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import empty_state

    state = empty_state(cfg, CPU)
    state = state.replace(kfs=state.kfs.replace(
        uid=torch.full_like(state.kfs.uid, cfg.loop.min_kfs_before_loop)))
    lc.prev_groups = [({0}, 1)]
    out, closed = lc.on_keyframe(state, 0)
    assert out is state and not closed and lc.prev_groups == [] and not lc.loops
