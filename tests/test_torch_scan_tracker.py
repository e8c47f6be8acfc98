"""Port parity for the whole-sequence scan (`tracking/scan_tracker.py`).

One rendered QVGA orbit of 13 frames at `test_torch_tracker.small_config`
(a keyframe every third frame, so local mapping runs), quantized to uint8
gray and uint16 mm depth, with the trained vocabulary
(`checkpoints/orbvoc_synth.npz`) so that every keyframe event runs loop
detection. Both packages run `init_scan` and `track_sequence_scan(...,
with_rel=True)` on the same arrays; the port's `Tracker.process` runs the
same frames with loop closing off.

Gates, and why:
- per-frame status, keyframe count and loop candidate, and each frame's
  reference-keyframe uid: exact (discrete decisions);
- camera positions and the keyframe-relative translations: 5 mm, the
  tracker parity test's tolerance (`test_torch_tracker.py` says why);
- the port's ATE against ground truth: under 1 cm;
- the scan against `Tracker.process`: the same tensor operations in the
  same order on the CPU, so statuses and keyframe frames are equal and
  positions agree within 1e-5 m;
- `_detect_loop` on a scripted database (a tie of two confident
  candidates included): words, consistency counters and the loop
  candidate equal; the BoW values within `test_torch_vocabulary.py`'s
  1e-6 (the L1 norm is an f32 sum that XLA and torch take in other
  orders: 1 ulp on some rows);
- frames 1-6 of the scan with every host read trapped: nothing is read
  but `device_cond`'s predicate (the one read it makes on the CPU), and
  the carry keeps its shapes and dtypes;
- a segment run twice from one carry, and `LoopCloser._correct` on a
  state, leave their inputs bit-equal (the segmented runner reads the
  pre-correction carry after `_correct` has returned);
- the scan with `use_flow`, and with `use_geom`, on 7 frames of the
  dynamic scene (two moving boxes) against `Tracker.process` with the
  same mask: the same masks feed the same `fused_track_step`, so poses,
  statuses and keyframes are equal bit for bit; the scan, masks included,
  reads nothing on the host but the predicates. The scan's view ring
  starts with frame 0 (`init_scan`, as in JAX) and the Tracker's with
  its first keyframe after frame 0 (as in JAX), so the test hands the
  Tracker frame 0's view before frame 1.
"""

import dataclasses
import multiprocessing
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.io import vocabulary as jvoc
from orb_slam2_ssd_semantic_tpu.io.artifacts import find_checkpoint
from orb_slam2_ssd_semantic_tpu.mapping.map_state import empty_state as j_empty_state
from orb_slam2_ssd_semantic_tpu.tracking import scan_tracker as jst
from orb_slam2_ssd_semantic_tpu_torch.dynamic.geommask import insert_ref_view
from orb_slam2_ssd_semantic_tpu_torch.eval.ate import evaluate_ate_xyz
from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import SyntheticSequence
from orb_slam2_ssd_semantic_tpu_torch.mapping import graph_cond
from orb_slam2_ssd_semantic_tpu_torch.mapping.loop_closing import LoopCloser
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import empty_state as t_empty_state
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import state_from_numpy
from orb_slam2_ssd_semantic_tpu_torch.tracking import scan_tracker as tst
from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker
from test_torch_tracker import small_config
from _torch_host_reads import host_reads_trapped
from _torch_threads import _few_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
N_FRAMES = 13
SCORE_ATOL = 1e-6


def _render(i):
    seq = SyntheticSequence(n_frames=N_FRAMES, cam=small_config(tconfig).camera)
    g, d = seq.gray_depth(i)
    return np.clip(g, 0, 255).astype(np.uint8), (d * 1000).astype(np.uint16)


def render_frames(n):
    """The orbit's first n frames, quantized, in three spawn workers."""
    with multiprocessing.get_context("spawn").Pool(3) as pool:
        frames = pool.map(_render, range(n))
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


def tensors(obj, prefix=""):
    """(path, tensor) of every tensor in a carry or state."""
    if torch.is_tensor(obj):
        yield prefix, obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from tensors(getattr(obj, f.name), f"{prefix}.{f.name}")


def snapshot(obj):
    return {k: v.clone() for k, v in tensors(obj)}


def assert_unchanged(obj, snap):
    now = dict(tensors(obj))
    assert now.keys() == snap.keys()
    changed = [k for k, v in now.items() if not torch.equal(v, snap[k])]
    assert not changed, changed


@pytest.fixture(scope="module")
def runs():
    path = find_checkpoint("orbvoc_synth.npz")
    assert path is not None, "the trained vocabulary is part of the repository"
    vocab = jvoc.load_binary(path)
    g, d = render_frames(N_FRAMES)
    jcfg, tcfg = small_config(jconfig), small_config(tconfig)

    jva = jst.VocabArrays.from_vocabulary(vocab)
    kw = dict(voc_k=vocab.k, voc_depth=vocab.depth)
    jc0 = jst.init_scan(j_empty_state(jcfg), jnp.asarray(g[0]), jnp.asarray(d[0]), jcfg,
                        vocab=jva, **kw)
    jc, jT, jstats, jrel, juid = jst.track_sequence_scan(
        jc0, jnp.asarray(g[1:]), jnp.asarray(d[1:]), jcfg, vocab=jva, voc_words=vocab.n_words,
        with_rel=True, **kw)

    tva = tst.VocabArrays.from_vocabulary(vocab, CPU)
    gt_, dt_ = torch.from_numpy(g), torch.from_numpy(d)
    tc0 = tst.init_scan(t_empty_state(tcfg, CPU), gt_[0], dt_[0], tcfg, vocab=tva)
    tc, tT, tstats, trel, tuid = tst.track_sequence_scan(tc0, gt_[1:], dt_[1:], tcfg, vocab=tva,
                                                         with_rel=True)

    tracker = Tracker(tcfg, device=CPU)
    process_T = np.stack([tracker.process(g[i], d[i], float(i)) for i in range(N_FRAMES)])
    gt = SyntheticSequence(n_frames=N_FRAMES, cam=tcfg.camera).gt_positions()
    return SimpleNamespace(
        g=g, d=d, gt=gt, vocab=vocab, jcfg=jcfg, tcfg=tcfg, jva=jva, tva=tva, jc=jc, tc0=tc0, tc=tc,
        jT=np.asarray(jT), jstats=np.asarray(jstats), jrel=np.asarray(jrel), juid=np.asarray(juid),
        tT=tT.numpy(), tstats=tstats.numpy(), trel=trel.numpy(), tuid=tuid.numpy(),
        tracker=tracker, process_T=process_T)


def _centres(T):
    return np.einsum("nji,nj->ni", T[:, :3, :3], -T[:, :3, 3])


def test_scan_stats_match_jax(runs):
    assert runs.tstats[-1, 2] >= 3, "local mapping never ran: vacuous"
    np.testing.assert_array_equal(runs.tstats[:, 0], runs.jstats[:, 0])  # status
    np.testing.assert_array_equal(runs.tstats[:, 2], runs.jstats[:, 2])  # n_kfs
    np.testing.assert_array_equal(runs.tstats[:, 3], runs.jstats[:, 3])  # loop_cand
    assert int(runs.tc.state.n_kfs) == int(runs.jc.state.n_kfs)


def test_scan_positions_and_records_match_jax(runs):
    d = np.linalg.norm(_centres(runs.tT) - _centres(runs.jT), axis=1)
    assert d.max() < 5e-3, d
    np.testing.assert_array_equal(runs.tuid, runs.juid)
    assert len(set(runs.tuid.tolist())) >= 3
    dr = np.linalg.norm(runs.trel[:, :3, 3] - runs.jrel[:, :3, 3], axis=1)
    assert dr.max() < 5e-3, dr


def test_scan_port_ate(runs):
    est = np.concatenate([np.zeros((1, 3)), _centres(runs.tT)])
    assert evaluate_ate_xyz(est, runs.gt).rmse < 0.01


def test_scan_equals_tracker_process(runs):
    tr = runs.tracker
    statuses = [("OK", "WEAK", "LOST")[s] for s in runs.tstats[:, 0]]
    assert statuses == [s["status"] for s in tr.stats[1:]]
    kf_scan = [i + 1 for i in range(N_FRAMES - 1)
               if runs.tstats[i, 2] != (runs.tstats[i - 1, 2] if i else 1)]
    kf_proc = [i for i in range(1, N_FRAMES) if tr.stats[i]["kfs"] != tr.stats[i - 1]["kfs"]]
    assert kf_scan == kf_proc and len(kf_scan) >= 2
    d = np.linalg.norm(_centres(runs.tT) - _centres(runs.process_T[1:]), axis=1)
    assert d.max() < 1e-5, d


# ---- _detect_loop on a scripted database --------------------------------

def _tree(nt):
    if hasattr(nt, "_asdict"):
        return {k: _tree(v) for k, v in nt._asdict().items()}
    return np.array(nt)


def _jax_tree(tree, like):
    if hasattr(like, "_asdict"):
        return type(like)(**{k: _jax_tree(tree[k], getattr(like, k)) for k in like._fields})
    return jnp.asarray(tree)


CUR, NEAR, CANDS, INVALID = 9, (5, 6, 7, 8), (1, 2, 3), 4


def _scripted_events(runs):
    """Three detection events on a state carried from the JAX run and
    rewritten: the keyframe in slot 9 (uid 20) shares its map points
    with slots 5-8 (uids 16-19: its covisible, recent neighbours); slots
    0-3 (uids 0, 3, 4, 5) share none and are old enough; slots 1-3 hold
    the current keyframe's own bag of words (equal scores), and slot 1
    (uid 3) carries a consistency chain of 2, which slots 2 and 3 continue
    (uid distances 1 and 2); slot 4 holds the same words but is not
    valid. Event 1 must pick slot 1 of the three-way tie; event 2 (slot
    10, uid 21, another keyframe's features) continues the chains event 1
    left; event 3 starts from no chains and finds no confident candidate.

    Returns (events [(state tree, features' slot, reset chains)], the
    database (word_db, val_db, cons) before event 1, descriptors, kp
    validity)."""
    kfs0 = _tree(runs.jc.state.kfs)
    live = np.nonzero(kfs0["valid"])[0]
    assert len(live) >= 4
    src = live[-1]
    tree = _tree(runs.jc.state)
    kfs = tree["kfs"]
    F, K = kfs["kp_point"].shape
    kfs["valid"][:] = False
    kfs["uid"][:] = -1
    kfs["kp_point"][:] = -1
    assert (kfs0["kp_point"][src] >= 0).sum() >= 2 * runs.tcfg.map.covis_weight_threshold
    for slot, uid in [(0, 0), (1, 3), (2, 4), (3, 5), (INVALID, 6)] + [
            (s, 16 + j) for j, s in enumerate(NEAR)] + [(CUR, 20)]:
        kfs["uid"][slot] = uid
        kfs["valid"][slot] = slot != INVALID
        if slot in NEAR or slot == CUR:
            kfs["kp_point"][slot] = kfs0["kp_point"][src]
    tree["last_kf"] = np.asarray(CUR, np.int32)
    va = runs.jva

    def words_of(slot):
        w = jvoc._quantize(va.children, va.desc, va.word_id, jnp.asarray(kfs0["desc"][slot]),
                           jnp.asarray(kfs0["kp_valid"][slot]), k=runs.vocab.k,
                           depth=runs.vocab.depth)
        return np.asarray(w), np.asarray(jvoc.bow_columns(w, va.idf))

    word_db = np.full((F, K), -1, np.int32)
    val_db = np.zeros((F, K), np.float32)
    for slot, from_slot in [(0, live[0]), (3, live[1])] + [
            (s, live[j % (len(live) - 1)]) for j, s in enumerate(NEAR)] + [
            (c, src) for c in CANDS + (INVALID,)]:
        word_db[slot], val_db[slot] = words_of(from_slot)
    cons = np.zeros((F,), np.int32)
    cons[CANDS[0]] = 2

    tree2 = _tree(runs.jc.state)
    tree2.update({k: v for k, v in tree.items() if k != "kfs"})
    tree2["kfs"] = {k: v.copy() for k, v in kfs.items()}
    tree2["last_kf"] = np.asarray(CUR + 1, np.int32)
    tree2["kfs"]["uid"][CUR + 1] = 21
    tree2["kfs"]["valid"][CUR + 1] = True
    tree2["kfs"]["kp_point"][CUR + 1] = kfs["kp_point"][CUR]
    events = [(tree, src, False), (tree2, live[-2], False), (tree2, live[-2], True)]
    return events, (word_db, val_db, cons), kfs0["desc"], kfs0["kp_valid"]


def test_detect_loop_matches_jax(runs):
    """Each package chains its own outputs from one event to the next."""
    events, db0, desc_all, valid_all = _scripted_events(runs)
    like = runs.jc.state
    jdb = tdb = db0
    picked = []
    for tree, frame_slot, reset in events:
        if reset:
            jdb = (jdb[0], jdb[1], np.zeros_like(db0[2]))
            tdb = (tdb[0], tdb[1], np.zeros_like(db0[2]))
        jframe = SimpleNamespace(feats=SimpleNamespace(desc=jnp.asarray(desc_all[frame_slot]),
                                                       valid=jnp.asarray(valid_all[frame_slot])))
        tframe = SimpleNamespace(feats=SimpleNamespace(
            desc=torch.from_numpy(desc_all[frame_slot].view(np.int32)),
            valid=torch.from_numpy(valid_all[frame_slot])))
        jout = jst._detect_loop(_jax_tree(tree, like), jframe, *(jnp.asarray(a) for a in jdb),
                                runs.jcfg, runs.jva, runs.vocab.k, runs.vocab.depth,
                                runs.vocab.n_words)
        tout = tst._detect_loop(state_from_numpy(tree, CPU), tframe,
                                torch.from_numpy(np.asarray(tdb[0]).astype(np.int64)),
                                torch.from_numpy(np.asarray(tdb[1])),
                                torch.from_numpy(np.asarray(tdb[2])), runs.tcfg, runs.tva)
        jdb, tdb = tuple(np.asarray(a) for a in jout[:3]), tuple(a.numpy() for a in tout[:3])
        np.testing.assert_array_equal(tdb[0], jdb[0])
        np.testing.assert_allclose(tdb[1], jdb[1], atol=SCORE_ATOL, rtol=0)
        np.testing.assert_array_equal(tdb[2], jdb[2])
        assert int(tout[3]) == int(jout[3])
        picked.append((int(tout[3]), tdb[2]))
    th = runs.tcfg.loop.covisibility_consistency_th
    (c1, cons1), (c2, _), (c3, cons3) = picked
    assert c1 == CANDS[0] and (cons1[list(CANDS)] >= th).all(), picked  # the tie
    assert cons1[INVALID] == 0 and (cons1[list(NEAR)] == 0).all()
    assert c2 >= 0 and c3 == -1 and cons3.max() < th, picked


# ---- no host read ------------------------------------------------------------

def _spec(tree):
    return [(p, tuple(t.shape), t.dtype) for p, t in tensors(tree)]


def test_scan_reads_nothing_on_the_host_but_the_predicates(runs):
    """Frames 1-6 from the initial carry (keyframes at 3 and 6, local
    mapping at 6, detection at both) with every host read trapped: the
    tracking step and the keyframe branch read nothing but `device_cond`'s
    predicates (the step's retry and fallback and the branch's need_kf
    every frame, n_kfs >= 3 at each keyframe), and the
    frames equal the fixture's scan bit for bit. The branch returns the
    carry's shapes and dtypes whichever way it goes (the card's
    conditional nodes copy one branch's outputs into the other's)."""
    g, d = torch.from_numpy(runs.g[1:7]), torch.from_numpy(runs.d[1:7])
    with host_reads_trapped(allowed=[(graph_cond, "predicate_on_host")]) as reads:
        c, T, stats, rel, uid = tst.track_sequence_scan(runs.tc0, g, d, runs.tcfg,
                                                        vocab=runs.tva, with_rel=True)
    assert reads == {"predicate_on_host": 2 * 6 + 6 + 2}
    assert torch.equal(T, torch.from_numpy(runs.tT[:6]))
    assert torch.equal(stats, torch.from_numpy(runs.tstats[:6]))
    assert torch.equal(uid, torch.from_numpy(runs.tuid[:6]))
    assert int(c.state.n_kfs) >= 3 and int(c.frame_idx) == 7
    assert _spec(c) == _spec(runs.tc0)


# ---- nothing writes into its input ----------------------------------------

def test_segment_run_twice_from_one_carry(runs):
    """Frames 1-7 (keyframes at 3 and 6, so local mapping and detection
    run) twice from the initial carry: the carry stays bit-equal and the
    two runs give equal results."""
    c0 = runs.tc0
    before = snapshot(c0)
    g, d = torch.from_numpy(runs.g[1:8]), torch.from_numpy(runs.d[1:8])
    a = tst.track_sequence_scan(c0, g, d, runs.tcfg, vocab=runs.tva, with_rel=True)
    assert_unchanged(c0, before)
    b = tst.track_sequence_scan(c0, g, d, runs.tcfg, vocab=runs.tva, with_rel=True)
    assert_unchanged(c0, before)
    assert int(a[0].state.n_kfs) >= 3
    for x, y in zip(a[1:], b[1:]):
        assert torch.equal(x, y)
    assert_unchanged(b[0], snapshot(a[0]))


def test_correct_leaves_its_input_state_unchanged(runs):
    """`LoopCloser._correct` past its minimum-discrepancy gate (a loop
    transform 0.13 m off the current relative pose): pose graph, point
    carry, SearchAndFuse and global BA run on the input state, which
    stays bit-equal."""
    state = runs.tc.state
    before = snapshot(state)
    lc = LoopCloser(runs.tcfg, device=CPU)
    kf, cand = int(state.last_kf), 0
    T = state.kfs.T_cw.numpy()
    D = np.eye(4, dtype=np.float32)
    D[:3, 3] = [0.13, 0.0, 0.0]
    T_ji = D @ T[kf] @ np.linalg.inv(T[cand])
    out, accepted = lc._correct(state, kf, cand, T_ji)
    assert_unchanged(state, before)
    if accepted:
        assert not torch.equal(out.kfs.T_cw, state.kfs.T_cw)


# ---- the dynamic masks in the scan ------------------------------------------

N_DYN = 7


@pytest.fixture(scope="module")
def dynamic_frames():
    cfg = small_config(tconfig)
    seq = SyntheticSequence(n_frames=N_DYN, dynamic_objects=True, n_dynamic=2, cam=cfg.camera)
    frames = [seq.gray_depth(i) for i in range(N_DYN)]
    return np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


@pytest.mark.parametrize("mask,depth_unit", [
    pytest.param("use_flow", "m", id="use_flow"),
    pytest.param("use_geom", "m", id="use_geom"),
    pytest.param("use_geom", "mm", id="use_geom-uint16"),
])
def test_scan_with_mask_equals_tracker_process(dynamic_frames, mask, depth_unit):
    """The scan with a mask against `Tracker.process`, bit for bit; with
    uint16 mm depths both hand the geometry mask metres. The scan runs
    with every host read trapped but `device_cond`'s predicate: the masks'
    graphs read nothing either."""
    g, d = dynamic_frames
    if depth_unit == "mm":
        d = np.round(d * 1000).astype(np.uint16)
    base = small_config(tconfig)
    cfg = dataclasses.replace(base, dynamic=dataclasses.replace(
        base.dynamic, enable_flow=mask == "use_flow", enable_geometry=mask == "use_geom"))
    tracker = Tracker(cfg, device=CPU)
    process_T = [tracker.process(g[0], d[0], 0.0)]
    if mask == "use_geom":
        f0 = tracker.last_frame
        tracker.geom_db = insert_ref_view(tracker.geom_db, tracker.last_T_cw, f0.feats.uv,
                                          f0.kp_depth, f0.feats.valid & f0.is_stereo)
    process_T += [tracker.process(g[i], d[i], float(i)) for i in range(1, N_DYN)]

    gt_, dt_ = torch.from_numpy(g), torch.from_numpy(d)
    c0 = tst.init_scan(t_empty_state(cfg, CPU), gt_[0], dt_[0], cfg, use_geom=mask == "use_geom")
    kw = {mask: True}
    if mask == "use_flow":
        kw["prev_grays"] = gt_[:-1]
    with host_reads_trapped(allowed=[(graph_cond, "predicate_on_host")]):
        c, T, stats = tst.track_sequence_scan(c0, gt_[1:], dt_[1:], cfg, **kw)
    stage = "mask.flow" if mask == "use_flow" else "mask.geometry"
    assert tracker.metrics.stages[stage].count == N_DYN - 1
    assert [("OK", "WEAK", "LOST")[s] for s in stats[:, 0]] == [s["status"]
                                                               for s in tracker.stats[1:]]
    assert stats[:, 2].tolist() == [s["kfs"] for s in tracker.stats[1:]]
    assert int(stats[-1, 2]) >= 3
    np.testing.assert_array_equal(T.numpy(), np.stack(process_T[1:]))
    if mask == "use_geom":
        assert int(c.geom_db.cursor) == int(tracker.geom_db.cursor) >= 2
        assert torch.equal(c.geom_db.T_cw, tracker.geom_db.T_cw)
        assert c0.geom_db is not c.geom_db and int(c0.geom_db.cursor) == 1
