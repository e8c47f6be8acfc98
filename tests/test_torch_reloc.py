"""Port parity for relocalization, and the port's LOST recovery inside
`Tracker.process`.

One JAX tracker run (the small config of `test_torch_tracker.py`, with
relocalization on and loop closing off) builds a map; its state and its
keyframe database are carried into the port (`state_from_numpy`,
`LoopCloser.database_from_numpy`), and both packages relocalize the same
fresh frames against them. The two RANSACs draw their minimal sets from
different random streams (JAX's `PRNGKey(kf)` against a torch generator
seeded with `kf`), so the results cannot agree bit for bit; they must
agree as estimates do: both succeed, inlier counts within 10% of each
other, poses within 0.01 m of each other and within 0.05 m of the
tracked pose (the JAX relocalization test's gate).

The tracker tests drive the port's `Tracker`. With loop closing off, the
keyframe database holds keyframe 0 only (as in the JAX package), so the
kidnapped camera is put back at the first frames' positions, rolled by
180 degrees about its optical axis: the motion model and the newest
keyframe's matches cannot follow that jump, while relocalization against
keyframe 0 can. The JAX tracker takes the same kidnap and must go LOST
and recover too, so the port is held to the reference's behaviour.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.mapping import place_recognition as jpr
from orb_slam2_ssd_semantic_tpu.tracking import tracker as jtk
from orb_slam2_ssd_semantic_tpu.tracking.reloc import relocalize as j_relocalize
from orb_slam2_ssd_semantic_tpu_torch.eval.ate import evaluate_ate_xyz
from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import SyntheticSequence
from orb_slam2_ssd_semantic_tpu_torch.mapping import place_recognition as tpr
from orb_slam2_ssd_semantic_tpu_torch.mapping.loop_closing import LoopCloser
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import state_from_numpy
from orb_slam2_ssd_semantic_tpu_torch.tracking import tracker as ttk
from orb_slam2_ssd_semantic_tpu_torch.tracking.reloc import relocalize as t_relocalize
from _torch_threads import _few_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
N_TRACK = 10  # frames tracked before relocalizing
N_MBVO = 18  # frames of the localization-only test
RELOC_FRAME = 5


def small_config(mod):
    base = mod.SlamConfig()
    return mod.SlamConfig(
        camera=mod.CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=123.8, width=320,
                                height=240, th_depth=80.0),
        orb=mod.OrbConfig(n_features=500, max_keypoints=512),
        tracking=dataclasses.replace(base.tracking, max_frames_between_kfs=2,
                                     local_map_candidates=1024),
        map=dataclasses.replace(base.map, max_keyframes=32, max_map_points=4096,
                                local_ba_window=4, local_ba_fixed_anchors=2,
                                triangulation_neighbors=2, fuse_neighbors=2),
        loop=dataclasses.replace(base.loop, enabled=False, enable_relocalization=True),
    )


def _tree(state):
    if hasattr(state, "_asdict"):
        return {k: _tree(v) for k, v in state._asdict().items()}
    return np.asarray(state)


def _roll(T_wc, angle):
    """The camera-to-world pose rolled by `angle` about the optical axis."""
    c, s = np.cos(angle), np.sin(angle)
    Rz = np.eye(4, dtype=np.float32)
    Rz[:2, :2] = [[c, -s], [s, c]]
    return (T_wc @ Rz).astype(np.float32)


def _center(T):
    T = np.asarray(T)
    return -T[:3, :3].T @ T[:3, 3]


def _gt_center(seq, T_wc):
    """Ground-truth camera centre in the tracker's world (camera 0's frame)."""
    return (np.linalg.inv(seq.poses_wc[0]) @ T_wc)[:3, 3]


@pytest.fixture(scope="module")
def seq_frames():
    seq = SyntheticSequence(n_frames=N_MBVO, cam=small_config(tconfig).camera)
    frames = [seq.gray_depth(i) for i in range(N_MBVO)]
    kidnap = [(_roll(seq.poses_wc[i], np.pi), seq.room.render(_roll(seq.poses_wc[i], np.pi)))
              for i in range(3)]
    return seq, frames, kidnap


@pytest.fixture(scope="module")
def jax_map(seq_frames):
    """The JAX tracker's map after N_TRACK frames, carried into the port;
    then the same tracker takes the kidnap (its outcome is kept for the
    kidnap test)."""
    seq, frames, kidnap = seq_frames
    tr = jtk.Tracker(small_config(jconfig))
    for i in range(N_TRACK):
        tr.process(*frames[i], float(seq.stamps[i]))
    assert tr.loop_closer.vocab is not None  # the trained vocabulary
    closer = LoopCloser(small_config(tconfig), device="cpu")
    closer.database_from_numpy({"word_db": np.asarray(tr.loop_closer.word_db),
                                "val_db": np.asarray(tr.loop_closer.val_db)})
    # A copy: the tracker's later steps donate the buffers of its state.
    out = dict(jstate=jax.tree_util.tree_map(jnp.copy, tr.state), jcloser=tr.loop_closer,
               tstate=state_from_numpy(_tree(tr.state), CPU), tcloser=closer,
               ref=_center(tr.absolute_poses()[RELOC_FRAME][1]))
    kid = []
    for j, (T_wc, (gray, depth)) in enumerate(kidnap):
        tr.process(gray, depth, float(seq.stamps[N_TRACK - 1]) + (j + 1) / 30.0)
        st = tr.metrics.stages.get("relocalization")
        kid.append((tr.status, 0 if st is None else st.count,
                    np.linalg.norm(tr.camera_positions()[-1] - _gt_center(seq, T_wc))))
    return out | {"jax_kidnap": kid}


@pytest.mark.parametrize("branch,database", [("rgbd", "closer"), ("epnp", "closer"),
                                             ("rgbd", "array")])
def test_relocalize_matches_jax(seq_frames, jax_map, branch, database):
    seq, frames, _ = seq_frames
    tstate = jax_map["tstate"]
    jcfg, tcfg = small_config(jconfig), small_config(tconfig)
    gray, depth = frames[RELOC_FRAME]
    if branch == "epnp":  # no keypoint depth: the 2D-3D path
        depth = np.zeros_like(depth)
    jframe = jtk.build_frame(jnp.asarray(gray), jnp.asarray(depth), jcfg)
    tframe = ttk.build_frame(torch.from_numpy(gray), torch.from_numpy(depth), tcfg)
    assert (int(tframe.is_stereo.sum()) < 3 * tcfg.loop.sim3_min_inliers) == (branch == "epnp")
    if database == "closer":
        jdb, tdb = jax_map["jcloser"], jax_map["tcloser"]
    else:  # a raw flat-codebook array holding keyframe 0
        F = jcfg.map.max_keyframes
        kfs = jax_map["jstate"].kfs
        jdb = jnp.zeros((F, jpr.VOCAB_SIZE)).at[0].set(jpr.bow_vector(kfs.desc[0], kfs.kp_valid[0]))
        tdb = torch.zeros((F, tpr.VOCAB_SIZE))
        tdb[0] = tpr.bow_vector(tstate.kfs.desc[0], tstate.kfs.kp_valid[0])
        np.testing.assert_allclose(tdb.numpy(), np.asarray(jdb), atol=1e-6, rtol=0)
    ok_j, T_j, n_j = j_relocalize(jax_map["jstate"], jframe, jdb, jcfg)
    ok_t, T_t, n_t = t_relocalize(tstate, tframe, tdb, tcfg)
    assert ok_j and ok_t and min(n_j, n_t) >= tcfg.tracking.min_inliers_reloc, (n_j, n_t)
    assert abs(n_t - n_j) <= 0.1 * n_j, (n_t, n_j)
    c_j, c_t, c_ref = _center(T_j), _center(T_t.numpy()), jax_map["ref"]
    assert np.linalg.norm(c_t - c_j) < 0.01
    assert np.linalg.norm(c_t - c_ref) < 0.05 and np.linalg.norm(c_j - c_ref) < 0.05


def _port_tracker():
    return ttk.Tracker(small_config(tconfig), device="cpu")


def test_tracker_recovers_from_a_kidnap(seq_frames, jax_map):
    """The port and the JAX tracker both go LOST at the jump, relocalize
    at once and track on."""
    jax_kid = jax_map["jax_kidnap"]
    assert [k[:2] for k in jax_kid] == [("OK", 1)] * 3, jax_kid  # one relocalization, at the jump
    assert max(k[2] for k in jax_kid) < 0.05, jax_kid
    seq, frames, kidnap = seq_frames
    tr = _port_tracker()
    assert tr.loop_closer is not None and tr.loop_closer.vocab is not None
    for i in range(N_TRACK):
        tr.process(*frames[i], float(seq.stamps[i]))
    assert tr.status == "OK" and "lost" not in tr.metrics.counters
    for j, (T_wc, (gray, depth)) in enumerate(kidnap):
        tr.process(gray, depth, float(seq.stamps[N_TRACK - 1]) + (j + 1) / 30.0)
        err = np.linalg.norm(tr.camera_positions()[-1] - _gt_center(seq, T_wc))
        assert tr.status == "OK" and err < 0.05, (j, tr.status, err)
        if j == 0:  # the jump itself: LOST as tracked, then relocalized
            assert tr.metrics.counters.get("lost") == 1
            assert tr.metrics.stages["relocalization"].count == 1
    assert tr.metrics.counters.get("lost") == 1  # the frames after it track


def test_mbvo_localization_fallback(seq_frames):
    """Localization-only mode (mapping frozen): when the map's points die,
    odometry rides on temporal points with WEAK status, never LOST, and
    relocalization is tried every frame; with the map back, OK (as
    test_tracker.py::test_mbvo_localization_fallback)."""
    seq, frames, _ = seq_frames
    tr = _port_tracker()
    for i in range(N_TRACK):
        tr.process(*frames[i], float(seq.stamps[i]))
    assert tr.status == "OK"
    tr.allow_new_keyframes = False
    saved_valid = tr.state.points.valid
    tr.state = tr.state.replace(points=tr.state.points.replace(valid=torch.zeros_like(saved_valid)))
    for i in range(N_TRACK, 14):
        tr.process(*frames[i], float(seq.stamps[i]))
        assert tr.status != "LOST", tr.status
    st = tr.metrics.stages.get("relocalization")
    assert st is not None and st.count >= 1
    tr.state = tr.state.replace(points=tr.state.points.replace(valid=saved_valid))
    for i in range(14, N_MBVO):
        tr.process(*frames[i], float(seq.stamps[i]))
    assert tr.status == "OK"
    res = evaluate_ate_xyz(tr.camera_positions(), seq.gt_positions()[:N_MBVO])
    assert res.rmse < 0.05, res
