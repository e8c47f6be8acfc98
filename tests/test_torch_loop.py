"""Port parity for loop closing (`mapping/loop_closing.py`), and the
forced closure of `tests/test_loop_e2e.py` through the port.

`test_loop_e2e.py`'s pipeline (BoxRoom seed 3, 18 keyframes over 1.3
laps, 0.30 m of injected drift, its small map config, the trained
vocabulary) runs once through the JAX package, up to the keyframe that
closes the loop: the map state, the keyframe database and the closer's
consistency chains are carried into the port (`state_from_numpy`,
`database_from_numpy`, `loop_state_from_numpy`), and both packages take
that keyframe's steps on the same input:

- the database scores (1e-5) and `_detect`'s candidate list (exact);
- the essential graph of the closure (exact), and 4 Gauss-Newton steps
  of its dense solve (1e-5);
- `_correct` fed JAX's own loop transform, with global BA off and on: the
  same accept/reject, keyframe poses within 5e-4, point positions within
  1e-3, at most 5 points live in one package only. The pose graph's
  monotonicity guard is discontinuous: near convergence a step that
  changes the cost by 1e-5 relative is accepted or rejected on the last
  bits of the iterate. On this closure the port rejects the fifth step,
  JAX takes it and one more (2.4e-4 m between the answers), while the
  port's step taken from JAX's own fourth iterate agrees with JAX's
  within 6e-7; one fusion at a window's edge follows from that.
- `_estimate_loop_transform` on the port's own generators: within 5 mm
  and 0.2 degrees of JAX's transform (the RANSAC streams differ; the
  refinement and the guided confirmation pull both to the same fit).

The median of `map_median_reproj_error` is checked on an even count of
observations, where `jnp.nanmedian` averages the two middle values and
`torch.nanmedian` would not. The same rendered frames then drive the
whole pipeline through the port: the loop must close in the revisit,
cutting the closure keyframe's error below 0.6x (`test_loop_e2e.py`'s
gates).
"""

import copy
import dataclasses
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.mapping import local_mapping as jlm
from orb_slam2_ssd_semantic_tpu.mapping import loop_closing as jlc
from orb_slam2_ssd_semantic_tpu.mapping.map_state import empty_state as j_empty_state
from orb_slam2_ssd_semantic_tpu.tracking import tracker as jtk
from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import BoxRoom
from orb_slam2_ssd_semantic_tpu_torch.mapping import local_mapping as tlm
from orb_slam2_ssd_semantic_tpu_torch.mapping import loop_closing as tlc
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import empty_state as t_empty_state
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import state_from_numpy
from orb_slam2_ssd_semantic_tpu_torch.tracking import tracker as ttk
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import nanmedian
from test_loop_e2e import _circle_poses
from _torch_threads import _few_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
N_KF, DRIFT = 18, 0.30


def e2e_config(mod, run_global_ba=False):
    """`test_loop_e2e.py::_cfg`."""
    base = mod.SlamConfig()
    return mod.SlamConfig(
        camera=base.camera,
        map=dataclasses.replace(base.map, max_keyframes=32, local_ba_window=4,
                                local_ba_fixed_anchors=2, triangulation_neighbors=2,
                                fuse_neighbors=2),
        loop=dataclasses.replace(base.loop, enabled=True, min_kfs_before_loop=4,
                                 covisibility_consistency_th=2, run_global_ba=run_global_ba),
    )


def revisit_poses(n_kf=N_KF):
    n_pose = max(int(n_kf / 1.3), 4)
    return [_circle_poses(n_pose)[i % n_pose] for i in range(n_kf)]


def drifted_pose(T_wc, i, n_kf=N_KF, drift_total=DRIFT):
    """(estimated T_cw with the injected drift, true T_cw)."""
    d = drift_total * i / max(n_kf - 1, 1)
    T_true = np.linalg.inv(T_wc).astype(np.float32)
    T_drift = np.eye(4, dtype=np.float32)
    T_drift[:3, 3] = [d, 0.0, 0.4 * d]
    return (T_true @ T_drift).astype(np.float32), T_true


def render_all(poses, cam):
    """The views in three spawn workers (the renderer is single-threaded
    numpy)."""
    room = BoxRoom(seed=3, cam=cam)
    with multiprocessing.get_context("spawn").Pool(3) as pool:
        return pool.map(room.render, poses)


def run_port(cfg, poses, frames, stop_at=None):
    """The pipeline through the port: insert, fuse, `on_keyframe`. Returns
    (closed_at, (error before, after) at the first closure, state, closer)."""
    state = t_empty_state(cfg, CPU)
    lc = tlc.LoopCloser(cfg, device=CPU)
    closed_at, errs = [], None
    for i, (T_wc, (gray, depth)) in enumerate(zip(poses, frames)):
        frame = ttk.build_frame(torch.from_numpy(gray.astype(np.float32)),
                                torch.from_numpy(depth), cfg)
        T_est, T_true = drifted_pose(T_wc, i)
        kp = torch.full((cfg.orb.max_keypoints,), -1, dtype=torch.int64)
        state, kp = ttk.insert_keyframe(state, frame, torch.from_numpy(T_est), kp, i, float(i),
                                        cfg, spawn_all=True)
        slot = int(state.last_kf)
        if i > 0:
            state = tlm.fuse_map_points(state, cfg)
        if i == stop_at:
            return closed_at, errs, state, lc
        e_pre = float(np.linalg.norm(state.kfs.T_cw[slot].numpy()[:3, 3] - T_true[:3, 3]))
        state, closed = lc.on_keyframe(state, slot)
        if closed:
            closed_at.append(i)
            if errs is None:
                errs = (e_pre, float(np.linalg.norm(state.kfs.T_cw[slot].numpy()[:3, 3]
                                                    - T_true[:3, 3])))
    return closed_at, errs, state, lc


def _tree(state):
    if hasattr(state, "_asdict"):
        return {k: _tree(v) for k, v in state._asdict().items()}
    return np.array(state)


@pytest.fixture(scope="module")
def frames():
    poses = revisit_poses()
    return poses, render_all(poses, tconfig.SlamConfig().camera)


@pytest.fixture(scope="module")
def closure(frames):
    """The JAX pipeline up to the keyframe that closes the loop, and that
    keyframe's steps through both packages from one carried state."""
    poses, imgs = frames
    cfg = e2e_config(jconfig)
    state = j_empty_state(cfg)
    lc = jlc.LoopCloser(cfg)
    assert lc.vocab is not None  # the trained vocabulary
    for i, (T_wc, (gray, depth)) in enumerate(zip(poses, imgs)):
        frame = jtk.build_frame(jnp.asarray(gray, jnp.float32), jnp.asarray(depth), cfg)
        T_est, _ = drifted_pose(T_wc, i)
        kp = jnp.full((cfg.orb.max_keypoints,), -1, jnp.int32)
        state, kp = jtk.insert_keyframe(state, frame, jnp.asarray(T_est), kp, i, float(i), cfg,
                                        spawn_all=True)
        slot = int(state.last_kf)
        if i > 0:
            state = jlm.fuse_map_points(state, cfg)
        carried = dict(state=_tree(state), db={"word_db": np.array(lc.word_db),
                                               "val_db": np.array(lc.val_db)},
                       loop={"prev_groups": copy.deepcopy(lc.prev_groups),
                             "last_loop_uid": lc.last_loop_uid})
        # The keyframe's steps, as on_keyframe takes them.
        scores = lc._add_and_score(state, slot)
        uid = int(state.kfs.uid[slot])
        if uid < cfg.loop.min_kfs_before_loop:
            continue
        cands = lc._detect(state, slot, uid, scores)
        found = [(c, lc._estimate_loop_transform(state, slot, c)) for c in cands]
        found = [(c, T) for c, (ok, T, _) in found if ok]
        if found:
            break
    assert 12 <= i < N_KF, i
    cand, T_ji = found[0]
    out = dict(i=i, slot=slot, uid=uid, scores=scores, cands=cands, cand=cand,
               T_ji=np.asarray(T_ji), carried=carried, jcfg=cfg,
               jstate=jax.tree_util.tree_map(jnp.copy, state))
    for gba in (False, True):
        lc.cfg = e2e_config(jconfig, gba)
        st = jax.tree_util.tree_map(jnp.copy, state)
        st, acc = lc._correct(st, slot, cand, T_ji)
        out[f"jax_correct_{gba}"] = (acc, np.asarray(st.kfs.T_cw), np.asarray(st.points.pos),
                                     np.asarray(st.points.valid))
    return out


def _port_closer(closure, gba=False):
    c = closure["carried"]
    lc = tlc.LoopCloser(e2e_config(tconfig, gba), device=CPU)
    lc.database_from_numpy(c["db"])
    lc.loop_state_from_numpy(c["loop"])
    return lc, state_from_numpy(c["state"], CPU)


def test_detect_matches_jax(closure):
    lc, state = _port_closer(closure)
    scores = lc._add_and_score(state, closure["slot"])
    np.testing.assert_allclose(scores, closure["scores"], atol=1e-5, rtol=0)
    cands = lc._detect(state, closure["slot"], closure["uid"], scores)
    assert cands == closure["cands"] and closure["cand"] in cands


def test_essential_graph_of_the_closure_matches_jax(closure):
    from orb_slam2_ssd_semantic_tpu.mapping import map_state as jms
    from orb_slam2_ssd_semantic_tpu.mapping import pose_graph as jpg
    from orb_slam2_ssd_semantic_tpu_torch.mapping import map_state as tms
    from orb_slam2_ssd_semantic_tpu_torch.mapping import pose_graph as tpg

    js, ts = closure["jstate"], state_from_numpy(closure["carried"]["state"], CPU)
    F, P = ts.kfs.valid.shape[0], ts.points.pos.shape[0]
    extra = [(closure["cand"], closure["slot"], 100.0, closure["T_ji"])]
    jc = jms.covisibility(js.kfs.kp_point, js.kfs.valid, P)
    tc = tms.covisibility(ts.kfs.kp_point, ts.kfs.valid, P)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    jg = jpg.build_graph_arrays(jc, js.kfs.valid, 30, 4 * F, js.kfs.T_cw, extra_edges=extra,
                                uid=js.kfs.uid)
    tg = tpg.build_graph_arrays(tc, ts.kfs.valid, 30, 4 * F, ts.kfs.T_cw, extra_edges=extra,
                                uid=ts.kfs.uid)
    for a, b in zip(jg, (tg.edge_i, tg.edge_j, tg.T_ji, tg.weight, tg.valid)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a).astype(b.numpy().dtype))
    fixed = np.arange(F) == 0
    Tj = jpg.optimize_pose_graph(js.kfs.T_cw, js.kfs.valid, jg, fixed=jnp.asarray(fixed), iters=4)
    Tt = tpg.optimize_pose_graph(ts.kfs.T_cw, ts.kfs.valid, tg, fixed=torch.from_numpy(fixed),
                                 iters=4)
    live = ts.kfs.valid.numpy()
    np.testing.assert_allclose(Tt.numpy()[live], np.asarray(Tj)[live], atol=1e-5, rtol=0)


@pytest.mark.parametrize("gba", [False, True], ids=["pose_graph", "with_global_ba"])
def test_correct_on_jax_transform_matches_jax(closure, gba):
    lc, state = _port_closer(closure, gba)
    out, acc = lc._correct(state, closure["slot"], closure["cand"], closure["T_ji"])
    j_acc, j_T, j_pos, j_valid = closure[f"jax_correct_{gba}"]
    assert acc == j_acc and acc  # JAX accepts this closure with and without global BA
    live = state.kfs.valid.numpy()
    np.testing.assert_allclose(out.kfs.T_cw.numpy()[live], j_T[live], atol=5e-4, rtol=0)
    t_valid = out.points.valid.numpy()
    assert (t_valid != j_valid).sum() <= 5, (t_valid != j_valid).sum()
    both = t_valid & j_valid
    np.testing.assert_allclose(out.points.pos.numpy()[both], j_pos[both], atol=1e-3, rtol=0)
    moved = np.abs(j_T[live] - closure["carried"]["state"]["kfs"]["T_cw"][live]).max()
    assert moved > 0.05  # the correction is not vacuous


def test_estimate_loop_transform_on_port_generators(closure):
    lc, state = _port_closer(closure)
    ok, T, n = lc._estimate_loop_transform(state, closure["slot"], closure["cand"])
    assert ok and n >= e2e_config(tconfig).loop.min_total_matches, n
    Tj = closure["T_ji"]
    assert np.linalg.norm(T[:3, 3] - Tj[:3, 3]) < 0.005
    dR = T[:3, :3] @ Tj[:3, :3].T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)))
    assert ang < 0.2, ang


def test_map_median_reproj_error_on_an_even_count(closure):
    """The carried map, with one observation dropped if need be so that the
    count is even: equal to JAX's within 1e-5."""
    from orb_slam2_ssd_semantic_tpu_torch.mapping.global_ba import problem_from_state

    jstate, cfg_t = closure["jstate"], e2e_config(tconfig)
    tstate = state_from_numpy(closure["carried"]["state"], CPU)

    def counted(state):
        prob = problem_from_state(state, cfg_t)
        T = prob.T_cw[prob.obs_kf]
        z = ((T[:, :3, :3] @ prob.points[prob.obs_pt][..., None])[..., 0] + T[:, :3, 3])[:, 2]
        return torch.nonzero(prob.obs_valid & (z > 1e-6))[:, 0]

    if len(counted(tstate)) % 2:
        kp = tstate.kfs.kp_point.clone()
        kp.view(-1)[counted(tstate)[0]] = -1
        tstate = tstate.replace(kfs=tstate.kfs.replace(kp_point=kp))
        jstate = jstate._replace(kfs=jstate.kfs._replace(kp_point=jnp.asarray(kp.numpy(),
                                                                            jnp.int32)))
    n = len(counted(tstate))
    assert n % 2 == 0 and n > 1000
    ej = jlc.map_median_reproj_error(jstate, closure["jcfg"])
    et = tlc.map_median_reproj_error(tstate, cfg_t)
    assert abs(et - ej) <= 1e-5, (et, ej)


def test_nanmedian_averages_the_two_middle_values():
    x = torch.tensor([1.0, 2.0, 3.0, 4.0, float("nan")])
    assert float(nanmedian(x)) == float(jnp.nanmedian(jnp.asarray(x.numpy()))) == 2.5
    assert float(torch.nanmedian(x)) == 2.0  # what the port must not use
    assert float(nanmedian(x[1:])) == 3.0
    assert torch.isnan(nanmedian(torch.full((4,), float("nan"))))


def test_port_closes_the_loop_on_revisit(frames):
    """`test_loop_e2e.py::test_loop_closes_on_revisit_and_reduces_drift`
    through the port, on the same rendered frames."""
    poses, imgs = frames
    closed_at, errs, _, lc = run_port(e2e_config(tconfig), poses, imgs)
    assert closed_at, "no loop closed on a revisiting trajectory"
    assert min(closed_at) >= 12
    err_before, err_after = errs
    assert err_before > 0.15
    assert err_after < 0.6 * err_before, errs
    assert lc.loops and lc.last_loop_uid >= 12
