"""The trained vocabulary (`checkpoints/orbvoc_synth.npz`) on the port's
`io/vocabulary` and place recognition: twins of
`tests/test_trained_vocab.py` (same-view BoW similarity above
opposite-view similarity) and `tests/test_vocab_pr.py` (two rooms and a
revisit: zero false loops, the true counterpart first, and a wider
separation margin than the flat codebook), with the same `skipif`.

The JAX tests' scenes (room seeds 5, 31 and 77, their poses) at 320x240,
rendered once in 3 spawn workers, through the port's extractor; the gates
are the JAX tests'. The scores are also held against JAX's
`quantize`/`l1_scores`/`bow_scores` on the port's descriptors: words
equal, scores within 1e-6 (f32 sums in another order,
`tests/test_torch_vocabulary.py`).
"""

import multiprocessing
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_ssd_semantic_tpu.io import vocabulary as jvoc
from orb_slam2_ssd_semantic_tpu.mapping import place_recognition as jpr
from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, OrbConfig
from orb_slam2_ssd_semantic_tpu_torch.frontend.extractor import extract
from orb_slam2_ssd_semantic_tpu_torch.io import vocabulary as voc
from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import BoxRoom
from orb_slam2_ssd_semantic_tpu_torch.mapping import place_recognition as pr
from _torch_threads import _few_threads  # noqa: F401 (autouse)

VOCAB = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "orbvoc_synth.npz")
QVGA = CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=123.8, width=320, height=240)
ORB = OrbConfig(n_features=500, max_keypoints=512)

pytestmark = pytest.mark.skipif(
    not os.path.exists(VOCAB),
    reason="trained vocabulary not present (apps/train_vocabulary.py)",
)


def _pose(x, z, yaw, y=1.5):
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(yaw), np.sin(yaw)
    T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T[:3, 3] = [x, y, z]
    return T


def _render(task):
    seed, T_wc = task
    return BoxRoom(seed=seed, cam=QVGA).render(T_wc)[0]


@pytest.fixture(scope="module")
def views():
    """The port's features of: test_trained_vocab's view, a nearly equal
    view and the opposite view of room 5; test_vocab_pr's 6 views of room
    31, 6 of room 77 and 3 revisits of room 31."""
    tasks = [(5, _pose(2.5, 3.0, 0.0)), (5, _pose(2.55, 3.02, 0.03)), (5, _pose(2.5, 3.0, np.pi))]
    tasks += [(31, _pose(2.5, 2.6, 0.25 * k - 0.5)) for k in range(6)]
    tasks += [(77, _pose(2.4, 2.8, 0.25 * k - 0.45)) for k in range(6)]
    tasks += [(31, _pose(2.53, 2.63, 0.25 * k - 0.5 + 0.02)) for k in range(3)]
    with multiprocessing.get_context("spawn").Pool(3) as pool:
        grays = pool.map(_render, tasks)
    feats = [extract(torch.from_numpy(np.asarray(g, np.float32)), ORB) for g in grays]
    return [(f.desc, f.valid) for f in feats]


@pytest.fixture(scope="module")
def vocab():
    v = voc.load_binary(VOCAB)
    return v, voc.to_device(v, torch.device("cpu")), torch.from_numpy(v.word_weight)


def _jnp_desc(desc: torch.Tensor):
    return jnp.asarray(desc.numpy().view(np.uint32))


def test_trained_vocab_discriminates_views(views, vocab):
    v, dv, idf = vocab
    assert v.n_words >= 200
    jv = jvoc.load_binary(VOCAB)
    ws = [voc.quantize(dv, d, m) for d, m in views[:3]]
    for w, (d, m) in zip(ws, views[:3]):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jvoc.quantize(
            jv, _jnp_desc(d), jnp.asarray(m.numpy()))))
    vals = [voc.bow_columns(w, idf) for w in ws]
    s = voc.l1_scores(ws[0], vals[0], torch.stack(ws[1:]), torch.stack(vals[1:]),
                      v.n_words).numpy()
    js = np.asarray(jvoc.l1_scores(jnp.asarray(ws[0].numpy()), jnp.asarray(vals[0].numpy()),
                                   jnp.asarray(torch.stack(ws[1:]).numpy()),
                                   jnp.asarray(torch.stack(vals[1:]).numpy()), v.n_words))
    np.testing.assert_allclose(s, js, atol=1e-6, rtol=0)
    assert s[0] > s[1] + 0.05, s


def _retrieval(scores):
    top1, margins = [], []
    for s in scores:
        top1.append(int(np.argmax(s)))
        margins.append(max(s[:6]) - max(s[6:]))
    return top1, margins


def test_trained_vocab_beats_codebook_on_two_rooms(views, vocab):
    v, dv, idf = vocab
    db, queries = views[3:15], views[15:]
    db_w = torch.stack([voc.quantize(dv, d, m) for d, m in db])
    db_v = torch.stack([voc.bow_columns(w, idf) for w in db_w])
    score_v = []
    for d, m in queries:
        w = voc.quantize(dv, d, m)
        s = voc.l1_scores(w, voc.bow_columns(w, idf), db_w, db_v, v.n_words).numpy()
        js = np.asarray(jvoc.l1_scores(jnp.asarray(w.numpy()),
                                       jnp.asarray(voc.bow_columns(w, idf).numpy()),
                                       jnp.asarray(db_w.numpy()), jnp.asarray(db_v.numpy()),
                                       v.n_words))
        np.testing.assert_allclose(s, js, atol=1e-6, rtol=0)
        score_v.append(s)
    db_bow = torch.stack([pr.bow_vector(d, m) for d, m in db])
    score_c = []
    for d, m in queries:
        s = pr.bow_scores(pr.bow_vector(d, m), db_bow).numpy()
        js = np.asarray(jpr.bow_scores(jpr.bow_vector(_jnp_desc(d), jnp.asarray(m.numpy())),
                                       jnp.asarray(db_bow.numpy())))
        np.testing.assert_allclose(s, js, atol=1e-6, rtol=0)
        score_c.append(s)
    top_v, marg_v = _retrieval(score_v)
    _, marg_c = _retrieval(score_c)
    for k, t in enumerate(top_v):
        assert t < 6, f"trained vocab false loop: query {k} -> view {t}"
        assert t == k, (k, t)
    assert all(m > 0 for m in marg_v), marg_v
    assert np.mean(marg_v) > np.mean(marg_c) + 0.02, (marg_v, marg_c)
