"""Port parity for the segmented runner (`tracking/segmented.py`) on
scripted scans, and for `resolve_trajectory`.

The scan is replaced in both packages by the same script (the runner
calls it through the module attribute, `scan_tracker.track_sequence_scan`):
three segments of four frames whose per-frame stats flag loop candidates,
and keyframe snapshots in which every frame became a keyframe (slot =
uid = frame) except a culled one. The stub closer of `test_segmented.py`
verifies every event with a transform whose implied correction is
scripted, and its `_correct` moves every keyframe by one rigid transform
(so that the live-anchor remap is not the identity), refuses (the guard),
or returns a non-finite pose. The timeline meets every gate of the
runner: a first estimate awaiting confirmation, a confirmation, the
throttle, an invalid candidate slot, a culled keyframe, one correction
per segment, and a correction in the last segment.

Across the two packages these must be equal: the gate that each event
met (from the runners' verbose lines), the corrections (frame, keyframe
slot, candidate slot), the event count, and the scan calls one for one:
both runners dispatch segment s+1 before they read segment s and
dispatch it again after a correction, so each call has the same segment,
live anchor (within 1e-6) and consistency chains in both.
"""

import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.mapping import loop_closing as jlc
from orb_slam2_ssd_semantic_tpu.mapping.map_state import empty_state as j_empty_state
from orb_slam2_ssd_semantic_tpu.tracking import scan_tracker as jst
from orb_slam2_ssd_semantic_tpu.tracking import segmented as jseg
from orb_slam2_ssd_semantic_tpu_torch.mapping import loop_closing as tlc
from orb_slam2_ssd_semantic_tpu_torch.tracking.graphed_track import TrackStepRunner
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import empty_state as t_empty_state
from orb_slam2_ssd_semantic_tpu_torch.tracking import scan_tracker as tst
from orb_slam2_ssd_semantic_tpu_torch.tracking import segmented as tseg
from _torch_threads import _few_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
S, N_SEG, F = 4, 3, 16
N = 1 + S * N_SEG
CULLED = 7
# frame -> flagged candidate slot (slot 15 is never a keyframe). With
# agreeing estimates: 3 a first estimate, 4 its confirmation and a
# correction; 5 throttled (1 uid after it), 6 not (2 uids: the limit), a
# new first estimate; 7 culled; 8 an invalid slot; 9 replaces 6's estimate
# (3 uids on), 11 confirms it (2 uids on: the limit) and corrects in the
# last segment, so 12 is not reached.
EVENTS = {3: 0, 4: 1, 5: 0, 6: 0, 7: 0, 8: 15, 9: 0, 11: 2, 12: 2}
D_AGREE = [[0.3, 0.0, 0.1]]
D_DISAGREE = [[0.3, 0.0, 0.0], [-0.3, 0.0, 0.2]]
GATES = ("no longer valid", "culled", "throttled", "estimate failed", "first verified",
         "disagrees", "rejected", "non-finite", "loop corrected")


def config(mod):
    base = mod.SlamConfig()
    return mod.SlamConfig(
        orb=mod.OrbConfig(n_features=16, max_keypoints=16),
        map=mod.MapConfig(max_keyframes=F, max_map_points=64),
        loop=mod.LoopConfig(enabled=True, min_kfs_before_loop=2, vocabulary_path=None),
        camera=base.camera)


def kf_pose(u: int) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    c, s = np.cos(0.05 * u), np.sin(0.05 * u)
    T[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    T[:3, 3] = [0.1 * u, 0.02 * u, -0.05 * u]
    return T


def segment_script(s: int) -> dict:
    """What segment s's scan returns: frames lo..hi-1 tracked at their
    keyframe poses (each frame a keyframe in the slot of its number, the
    culled one invalid), status OK, candidates from EVENTS."""
    lo, hi = 1 + s * S, 1 + (s + 1) * S
    frames = range(lo, hi)
    uid = np.full((F,), -1, np.int32)
    uid[:hi] = np.arange(hi)
    valid = uid >= 0
    valid[CULLED] = valid[CULLED] and hi <= CULLED  # culled once a later frame came
    T_kf = np.stack([kf_pose(u) for u in range(F)])
    stats = np.array([[0, 100, hi, EVENTS.get(f, -1)] for f in frames], np.int32)
    return dict(
        T_seg=np.stack([kf_pose(f) for f in frames]), stats=stats,
        T_rel=np.stack([np.eye(4, dtype=np.float32)] * S), ref_uid=np.arange(lo, hi, dtype=np.int32),
        uid=uid, valid=valid, fid=np.where(valid, uid, -1).astype(np.int32), T_kf=T_kf,
        last_kf=hi - 1, last_T_cw=kf_pose(hi - 1))


def _estimate(T, kf, cand, call: int, mode: str):
    """(ok, T_ji): the current relative pose moved by the scripted D."""
    if mode == "estimate_fails" and call % 2 == 0:
        return False, None
    d_seq = D_DISAGREE if mode == "disagree" else D_AGREE
    D = np.eye(4, dtype=np.float32)
    D[:3, 3] = d_seq[call % len(d_seq)]
    return True, (D @ T[kf] @ np.linalg.inv(T[cand])).astype(np.float32)


def _corrected(T, mode: str):
    """(poses after the correction, accepted)."""
    if mode == "guard":
        return T, False
    G = kf_pose(3) @ np.linalg.inv(kf_pose(1))  # a rigid move of the whole map
    out = (T @ G).astype(np.float32)
    if mode == "nonfinite":
        out[0, 0, 3] = np.nan
    return out, True


class JStub(jlc.LoopCloser):
    def __init__(self, cfg, mode):
        super().__init__(cfg)
        self.mode, self.calls = mode, 0

    def _estimate_loop_transform(self, state, kf_id, cand):
        ok, T = _estimate(np.asarray(state.kfs.T_cw), kf_id, cand, self.calls, self.mode)
        self.calls += 1
        return ok, None if T is None else jnp.asarray(T), 999

    def _correct(self, state, kf_id, cand, T_ji):
        T, ok = _corrected(np.asarray(state.kfs.T_cw), self.mode)
        return state._replace(kfs=state.kfs._replace(T_cw=jnp.asarray(T))), ok


class TStub(tlc.LoopCloser):
    def __init__(self, cfg, mode):
        super().__init__(cfg, device=CPU)
        self.mode, self.calls = mode, 0

    def _estimate_loop_transform(self, state, kf_id, cand):
        ok, T = _estimate(state.kfs.T_cw.numpy(), kf_id, cand, self.calls, self.mode)
        self.calls += 1
        return ok, T, 999

    def _correct(self, state, kf_id, cand, T_ji):
        T, ok = _corrected(state.kfs.T_cw.numpy(), self.mode)
        return state.replace(kfs=state.kfs.replace(T_cw=torch.from_numpy(T))), ok


def _jax_run(mode, monkeypatch, capsys):
    cfg = config(jconfig)
    calls = []

    def state_of(sc):
        st = j_empty_state(cfg)
        return st._replace(
            kfs=st.kfs._replace(uid=jnp.asarray(sc["uid"]), valid=jnp.asarray(sc["valid"]),
                                frame_id=jnp.asarray(sc["fid"]), T_cw=jnp.asarray(sc["T_kf"])),
            last_kf=jnp.int32(sc["last_kf"]))

    def init_scan(state, g0, d0, cfg, **kw):
        z = jnp.zeros((F,), jnp.int32)
        return jst.ScanCarry(state=state, last_frame=None, last_T_cw=jnp.eye(4), last_kp_point=None,
                             velocity=None, frames_since_kf=None, ref_kf_inliers=None,
                             frame_idx=None, word_db=None, val_db=None, cons_count=z)

    def scan(carry, grays, depths, cfg, with_rel=False, **kw):
        s = (int(grays[0, 0, 0]) - 1) // S
        calls.append((s, np.asarray(carry.last_T_cw), int(carry.cons_count.sum())))
        sc = segment_script(s)
        out = carry._replace(state=state_of(sc), last_T_cw=jnp.asarray(sc["last_T_cw"]),
                             cons_count=carry.cons_count + 1)
        return (out, jnp.asarray(sc["T_seg"]), jnp.asarray(sc["stats"]), jnp.asarray(sc["T_rel"]),
                jnp.asarray(sc["ref_uid"]))

    monkeypatch.setattr(jst, "init_scan", init_scan)
    monkeypatch.setattr(jst, "track_sequence_scan", scan)
    g = jnp.asarray(np.arange(N, dtype=np.uint8).reshape(N, 1, 1))
    capsys.readouterr()
    res = jseg.track_sequence_segmented(g, g.astype(jnp.uint16), cfg, segment_len=S,
                                        loop_closer=JStub(cfg, mode), verbose=True)
    return res, calls, capsys.readouterr().out


def _port_run(mode, monkeypatch, capsys):
    cfg = config(tconfig)
    calls = []

    def state_of(sc):
        st = t_empty_state(cfg, CPU)
        return st.replace(
            kfs=st.kfs.replace(uid=torch.from_numpy(sc["uid"]), valid=torch.from_numpy(sc["valid"]),
                               frame_id=torch.from_numpy(sc["fid"]),
                               T_cw=torch.from_numpy(sc["T_kf"])),
            last_kf=torch.tensor(sc["last_kf"]))

    def init_scan(state, g0, d0, cfg, **kw):
        return tst.ScanCarry(state=state, last_frame=None, last_T_cw=torch.eye(4),
                             last_kp_point=None, velocity=None, frames_since_kf=0,
                             ref_kf_inliers=0, frame_idx=1, word_db=None, val_db=None,
                             cons_count=torch.zeros((F,), dtype=torch.int32),
                             branch=tst.KeyframeBranchRunner(CPU), track=TrackStepRunner(CPU))

    def scan(carry, grays, depths, cfg, with_rel=False, **kw):
        s = (int(grays[0, 0, 0]) - 1) // S
        calls.append((s, carry.last_T_cw.numpy().copy(), int(carry.cons_count.sum())))
        sc = segment_script(s)
        out = carry.replace(state=state_of(sc), last_T_cw=torch.from_numpy(sc["last_T_cw"]),
                            cons_count=carry.cons_count + 1)
        return (out, torch.from_numpy(sc["T_seg"]), torch.from_numpy(sc["stats"]).to(torch.int64),
                torch.from_numpy(sc["T_rel"]), torch.from_numpy(sc["ref_uid"]))

    monkeypatch.setattr(tst, "init_scan", init_scan)
    monkeypatch.setattr(tst, "track_sequence_scan", scan)
    g = torch.arange(N, dtype=torch.uint8).reshape(N, 1, 1)
    capsys.readouterr()
    res = tseg.track_sequence_segmented(g, g.to(torch.int32), cfg, segment_len=S,
                                        loop_closer=TStub(cfg, mode), verbose=True, device=CPU)
    return res, calls, capsys.readouterr().out


def _gates(out: str) -> list:
    """(frame or None, gate) per verbose gate line."""
    found = []
    for line in out.splitlines():
        if not line.startswith("# segmented:"):
            continue
        gate = next(g for g in GATES if g in line)
        m = re.search(r"frame (\d+)", line)
        found.append((int(m.group(1)) if m else None, gate))
    return found


def _from_corrected(calls) -> list:
    """(segment, anchor) of each scan call whose carry was not the
    previous segment's output, i.e. was corrected in between."""
    return [(s, T) for s, T, _ in calls
            if s > 0 and not np.array_equal(T, segment_script(s - 1)["last_T_cw"])]


@pytest.mark.parametrize("mode", ["agree", "disagree", "estimate_fails", "guard", "nonfinite"])
def test_segmented_runner_matches_jax(mode, monkeypatch, capsys):
    jres, jcalls, jout = _jax_run(mode, monkeypatch, capsys)
    tres, tcalls, tout = _port_run(mode, monkeypatch, capsys)
    gates = _gates(tout)
    assert gates == _gates(jout)
    assert [c[:3] for c in tres.corrections] == [tuple(int(x) for x in c[:3])
                                                 for c in jres.corrections]
    assert tres.n_loop_events == jres.n_loop_events == len(EVENTS)
    np.testing.assert_array_equal(tres.stats, jres.stats)
    np.testing.assert_allclose(tres.T_all, jres.T_all, atol=1e-6)

    # Both run every segment once, plus once more from the corrected carry
    # when a correction lands before the last segment: the same calls, in
    # the same order, from the same carries.
    assert [(s, c) for s, _, c in tcalls] == [(s, c) for s, _, c in jcalls]
    for (_, a, _), (_, b, _) in zip(tcalls, jcalls):
        np.testing.assert_allclose(a, b, atol=1e-6)
    jfix, tfix = _from_corrected(jcalls), _from_corrected(tcalls)
    assert [s for s, _ in tfix] == [s for s, _ in jfix]
    assert len(jcalls) == N_SEG + len(jfix)
    for (_, a), (_, b) in zip(tfix, jfix):
        np.testing.assert_allclose(a, b, atol=1e-6)
    # A corrected carry starts with its consistency chains reset.
    assert all(c == 0 for s, T, c in tcalls
               if s > 0 and not np.array_equal(T, segment_script(s - 1)["last_T_cw"]))
    np.testing.assert_allclose(tres.carry.last_T_cw.numpy(), np.asarray(jres.carry.last_T_cw),
                               atol=1e-6)
    kinds = {g for _, g in gates}
    if mode == "agree":
        assert [c[0] for c in tres.corrections] == [4, 11]  # the second in the last segment
        assert {"throttled", "first verified", "no longer valid", "culled"} <= kinds
        assert len(tfix) == 1
    elif mode == "estimate_fails":
        assert "estimate failed" in kinds and tres.corrections
    else:
        assert not tres.corrections and not tfix
        assert {"no longer valid", "culled", {"disagree": "disagrees", "guard": "rejected",
                                              "nonfinite": "non-finite"}[mode]} <= kinds


def test_resolve_trajectory_matches_jax():
    """Records referring to a live keyframe, to a culled one with and
    without insertion poses (chained through the nearest earlier
    survivor), and to one older than every survivor."""
    rng = np.random.default_rng(0)

    def pose():
        from scipy.spatial.transform import Rotation

        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.3, 3)).as_matrix()
        T[:3, 3] = rng.normal(0, 1, 3)
        return T

    uid = np.array([2, 5, 9, -1, 12], np.int32)
    valid = np.array([True, True, True, False, True])
    T_kf = np.stack([pose() for _ in uid])
    insert = {u: (u, pose()) for u in (0, 2, 5, 7, 9, 12)}
    traj = [(u, pose()) for u in (2, 5, 7, 8, 9, 12, 0, 1, 7)]
    jcarry = SimpleNamespace(state=SimpleNamespace(kfs=SimpleNamespace(
        uid=uid, valid=valid, T_cw=T_kf)))
    tcarry = SimpleNamespace(state=SimpleNamespace(kfs=SimpleNamespace(
        uid=torch.from_numpy(uid), valid=torch.from_numpy(valid), T_cw=torch.from_numpy(T_kf))))
    rest = (None, None, traj, [], 0, 0.0, 0.0, insert)
    got = tseg.resolve_trajectory(tseg.SegmentedResult(tcarry, *rest))
    want = jseg.resolve_trajectory(jseg.SegmentedResult(jcarry, *rest))
    assert got.shape == (len(traj), 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("use_flow,use_geom", [(True, False), (False, True), (True, True)],
                         ids=["flow", "geom", "both"])
def test_runner_hands_the_masks_to_every_segment(use_flow, use_geom, monkeypatch):
    """`init_scan` gets `use_geom`; every segment's scan gets `use_flow`,
    `use_geom` and, with the flow mask, `prev_grays = g[lo-1:hi-1]`, the
    frames before its own (JAX `segmented.py:183`). No loop event here,
    and each segment continues the carry the last one left."""
    cfg = config(tconfig)
    seen = {"scans": []}

    def init_scan(state, g0, d0, cfg, **kw):
        seen["init"] = kw
        return tst.ScanCarry(state=state, last_frame=None, last_T_cw=torch.eye(4),
                             last_kp_point=None, velocity=None, frames_since_kf=0,
                             ref_kf_inliers=0, frame_idx=1, word_db=None, val_db=None,
                             cons_count=torch.zeros((F,), dtype=torch.int32),
                             branch=tst.KeyframeBranchRunner(CPU), track=TrackStepRunner(CPU),
                             geom_db="ring 0")

    def scan(carry, grays, depths, cfg, with_rel=False, **kw):
        s = (int(grays[0, 0, 0]) - 1) // S
        seen["scans"].append((s, carry.geom_db, kw))
        sc = segment_script(s)
        stats = sc["stats"].copy()
        stats[:, 3] = -1
        st = t_empty_state(cfg, CPU)
        st = st.replace(kfs=st.kfs.replace(
            uid=torch.from_numpy(sc["uid"]), valid=torch.from_numpy(sc["valid"]),
            frame_id=torch.from_numpy(sc["fid"]), T_cw=torch.from_numpy(sc["T_kf"])),
            last_kf=torch.tensor(sc["last_kf"]))
        out = carry.replace(state=st, geom_db=f"ring {s + 1}")
        return (out, torch.from_numpy(sc["T_seg"]), torch.from_numpy(stats).to(torch.int64),
                torch.from_numpy(sc["T_rel"]), torch.from_numpy(sc["ref_uid"]))

    monkeypatch.setattr(tst, "init_scan", init_scan)
    monkeypatch.setattr(tst, "track_sequence_scan", scan)
    g = torch.arange(N, dtype=torch.uint8).reshape(N, 1, 1)
    res = tseg.track_sequence_segmented(g, g.to(torch.int32), cfg, segment_len=S,
                                        loop_closer=TStub(cfg, "agree"), device=CPU,
                                        use_flow=use_flow, use_geom=use_geom)
    assert seen["init"]["use_geom"] is use_geom
    assert [s for s, _, _ in seen["scans"]] == list(range(N_SEG))
    for s, ring, kw in seen["scans"]:
        lo = 1 + s * S
        assert ring == f"ring {s}"
        assert kw["use_flow"] is use_flow and kw["use_geom"] is use_geom
        if use_flow:
            assert torch.equal(kw["prev_grays"], g[lo - 1:lo - 1 + S])
            assert int(kw["prev_grays"][0, 0, 0]) == lo - 1
        else:
            assert kw["prev_grays"] is None
    assert res.n_loop_events == 0 and not res.corrections
