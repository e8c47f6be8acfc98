"""Port parity for loop closing's back end: global bundle adjustment
(`mapping/global_ba.py`) and the essential-graph optimization
(`mapping/pose_graph.py`), against the JAX package on the same numpy
inputs.

Tolerances: global BA poses within 2e-4 and points within 2e-3, the JAX
tests' own bound between two orderings of the same sums
(`test_global_ba.py::test_fast_segment_sum_path_matches_scatter`); pose
graphs within 1e-4 of JAX (20 Gauss-Newton steps of f32 solves), the PCG
solve within 1e-3 m of the dense one (`test_pose_graph_chain.py`'s
bound); the host-built problem and graph arrays, and the write-back's
pruning, exactly (but for one ulp of XLA's division in uR)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.config import OptimizerConfig as JOpt
from orb_slam2_ssd_semantic_tpu.mapping import global_ba as jgba
from orb_slam2_ssd_semantic_tpu.mapping import pose_graph as jpg
from orb_slam2_ssd_semantic_tpu.mapping.map_state import empty_state as j_empty_state
from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig as TCam
from orb_slam2_ssd_semantic_tpu_torch.config import OptimizerConfig as TOpt
from orb_slam2_ssd_semantic_tpu_torch.mapping import global_ba as tgba
from orb_slam2_ssd_semantic_tpu_torch.mapping import pose_graph as tpg
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import state_from_numpy, state_to_numpy
from test_global_ba import build_problem
from test_pose_graph_chain import _chain_graph, _circle_poses
from _torch_threads import _few_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
INDEX = ("obs_kf", "obs_pt", "edge_i", "edge_j")


def _tensors(nt) -> dict:
    d = {k: torch.from_numpy(np.array(v)) for k, v in nt._asdict().items()}
    return {k: v.to(torch.int64) if k in INDEX else v for k, v in d.items()}


def _tree(nt):
    if hasattr(nt, "_asdict"):
        return {k: _tree(v) for k, v in nt._asdict().items()}
    return np.asarray(nt)


@pytest.mark.parametrize("kw", [dict(), dict(outlier_frac=0.1), dict(stereo=False, noise_pose=0.02)],
                         ids=["converges", "outliers", "mono"])
def test_global_bundle_adjust_matches_jax(kw):
    prob, _, _ = build_problem(np.random.default_rng(0), **kw)
    cam = dict(depth_bf=400.0)
    jr = jgba.global_bundle_adjust(prob, jgba.CameraConfig(**cam), JOpt(), cg_iters=30)
    tr = tgba.global_bundle_adjust(tgba.GlobalBAProblem(**_tensors(prob)), TCam(**cam), TOpt(),
                                   cg_iters=30)
    np.testing.assert_allclose(tr.T_cw.numpy(), np.asarray(jr.T_cw), atol=2e-4, rtol=0)
    np.testing.assert_allclose(tr.points.numpy(), np.asarray(jr.points), atol=2e-3, rtol=0)
    np.testing.assert_array_equal(tr.inlier.numpy(), np.asarray(jr.inlier))
    if kw.get("outlier_frac"):
        assert tr.inlier.float().mean() < 0.95  # the chi2 gate flags the corrupted ones


def _small_cfg(mod):
    base = mod.SlamConfig()
    return mod.SlamConfig(map=dataclasses.replace(base.map, max_keyframes=8, max_map_points=512),
                          orb=dataclasses.replace(base.orb, max_keypoints=128))


@pytest.fixture(scope="module")
def packed_state():
    """`test_global_ba.py::test_global_ba_state_wrapper`'s packing of a BA
    problem into a SlamState (6 keyframes, 200 points), at a small map."""
    cfg = _small_cfg(jconfig)
    state = j_empty_state(cfg)
    F_use, P_use = 6, 200
    prob, _, _ = build_problem(np.random.default_rng(1), F=F_use, P=P_use, noise_pose=0.02)
    kfs = state.kfs
    F, K = kfs.kp_point.shape
    kp_point = np.full((F, K), -1, np.int32)
    uv = np.zeros((F, K, 2), np.float32)
    depth = np.zeros((F, K), np.float32)
    kp_valid = np.zeros((F, K), bool)
    obs_kf, obs_pt, obs_uvr = (np.asarray(a) for a in (prob.obs_kf, prob.obs_pt, prob.obs_uvr))
    for f in range(F_use):
        rows = np.nonzero(obs_kf == f)[0][:K]
        k = len(rows)
        kp_point[f, :k] = obs_pt[rows]
        uv[f, :k] = obs_uvr[rows, :2]
        depth[f, :k] = 400.0 / np.maximum(obs_uvr[rows, 0] - obs_uvr[rows, 2], 1e-6)
        kp_valid[f, :k] = True
    kfs = kfs._replace(
        T_cw=kfs.T_cw.at[:F_use].set(jnp.asarray(np.asarray(prob.T_cw)[:F_use])),
        uv=jnp.asarray(uv), depth=jnp.asarray(depth), kp_valid=jnp.asarray(kp_valid),
        kp_point=jnp.asarray(kp_point), valid=kfs.valid.at[:F_use].set(True),
        uid=kfs.uid.at[:F_use].set(jnp.arange(F_use) + 3))
    pts = state.points._replace(
        pos=state.points.pos.at[:P_use].set(jnp.asarray(np.asarray(prob.points)[:P_use])),
        valid=state.points.valid.at[:P_use].set(True),
        n_obs=state.points.n_obs.at[:P_use].set(3))
    return state._replace(kfs=kfs, points=pts, n_kfs=jnp.int32(F_use), n_points=jnp.int32(P_use))


def test_problem_from_state_and_write_back_are_exact(packed_state):
    jprob = jgba.problem_from_state(packed_state, _small_cfg(jconfig))
    tstate = state_from_numpy(_tree(packed_state), CPU)
    tprob = tgba.problem_from_state(tstate, _small_cfg(tconfig))
    for k, v in _tensors(jprob).items():
        if k == "obs_uvr":
            # uR = u - bf / depth: XLA's f32 division on the CPU is not
            # correctly rounded (about a quarter of quotients differ from
            # IEEE division by one ulp); u and v are exact.
            np.testing.assert_array_equal(tprob.obs_uvr[:, :2].numpy(), v[:, :2].numpy())
            np.testing.assert_allclose(tprob.obs_uvr[:, 2].numpy(), v[:, 2].numpy(),
                                       rtol=2.0 ** -23, atol=0)
        else:
            np.testing.assert_array_equal(getattr(tprob, k).numpy(), v.numpy(), err_msg=k)
    # Write-back of one result through both: every third observation
    # rejected, poses and points moved.
    rng = np.random.default_rng(4)
    M = jprob.obs_kf.shape[0]
    inlier = np.asarray(jprob.obs_valid) & (np.arange(M) % 3 != 0)
    T = np.asarray(jprob.T_cw) + rng.normal(0, 1e-3, jprob.T_cw.shape).astype(np.float32)
    X = np.asarray(jprob.points) + rng.normal(0, 1e-2, jprob.points.shape).astype(np.float32)
    chi = np.zeros(M, np.float32)
    jres = jgba.GlobalBAResult(jnp.asarray(T), jnp.asarray(X), jnp.asarray(inlier), jnp.asarray(chi))
    tres = tgba.GlobalBAResult(*(torch.from_numpy(a) for a in (T, X, inlier, chi)))
    jout = _tree(jgba._write_back(packed_state, jprob, jres))
    tout = state_to_numpy(tgba._write_back(tstate, tprob, tres))
    assert int((np.asarray(jprob.obs_valid) & ~inlier).sum()) > 100
    for part in ("kfs", "points"):
        for k, v in jout[part].items():
            np.testing.assert_array_equal(tout[part][k], v, err_msg=f"{part}.{k}")


def test_global_ba_step_state_matches_jax(packed_state):
    jout = jgba.global_ba_step_state(packed_state, _small_cfg(jconfig), cg_iters=30)
    tout = tgba.global_ba_step_state(state_from_numpy(_tree(packed_state), CPU),
                                     _small_cfg(tconfig), cg_iters=30)
    np.testing.assert_allclose(tout.kfs.T_cw.numpy(), np.asarray(jout.kfs.T_cw), atol=2e-4, rtol=0)
    np.testing.assert_allclose(tout.points.pos.numpy(), np.asarray(jout.points.pos), atol=2e-3,
                               rtol=0)
    np.testing.assert_array_equal(tout.kfs.kp_point.numpy(), np.asarray(jout.kfs.kp_point))
    moved = np.abs(np.asarray(jout.kfs.T_cw) - np.asarray(packed_state.kfs.T_cw)).max()
    assert moved > 10 * 2e-4  # the comparison is not vacuous


def _drifted_loop_graph():
    """`test_loop_reloc.py::test_pose_graph_distributes_loop_correction`'s
    12-keyframe drifted chain with a true loop edge."""
    from orb_slam2_ssd_semantic_tpu.geometry import se3

    F = 12
    T_gt, T_drift = [np.eye(4, dtype=np.float32)], [np.eye(4, dtype=np.float32)]
    rel_gt = np.asarray(se3.se3_exp(jnp.asarray([0.5, 0, 0, 0, 2 * np.pi / F, 0], jnp.float32)))
    rel_bad = np.asarray(se3.se3_exp(jnp.asarray([0.5, 0.02, 0.01, 0, 2 * np.pi / F + 0.01, 0],
                                                 jnp.float32)))
    for _ in range(1, F):
        T_gt.append(rel_gt @ T_gt[-1])
        T_drift.append(rel_bad @ T_drift[-1])
    T_gt, T_drift = np.stack(T_gt), np.stack(T_drift)
    edges = [(i - 1, i, 1.0, T_drift[i] @ np.linalg.inv(T_drift[i - 1])) for i in range(1, F)]
    edges.append((0, F - 1, 100.0, T_gt[F - 1] @ np.linalg.inv(T_gt[0])))
    graph = jpg.PoseGraph(
        edge_i=jnp.asarray([e[0] for e in edges], jnp.int32),
        edge_j=jnp.asarray([e[1] for e in edges], jnp.int32),
        T_ji=jnp.asarray(np.stack([e[3] for e in edges]).astype(np.float32)),
        weight=jnp.asarray([e[2] for e in edges], jnp.float32),
        valid=jnp.ones(len(edges), bool))
    return T_drift.astype(np.float32), graph


def _tgraph(graph) -> tpg.PoseGraph:
    return tpg.PoseGraph(**_tensors(graph))


@pytest.mark.parametrize("case", ["loop", "invalid_slots_and_gauge"])
def test_dense_pose_graph_matches_jax(case):
    T0, graph = _drifted_loop_graph()
    F = T0.shape[0]
    valid = np.ones(F, bool)
    fixed = None
    if case == "invalid_slots_and_gauge":
        valid[[3, 7]] = False  # slots whose edges must drop out
        fixed = np.arange(F) == 2
        graph = graph._replace(valid=graph.valid.at[4].set(False))
    Tj = jpg.optimize_pose_graph(jnp.asarray(T0), jnp.asarray(valid), graph,
                                 fixed=None if fixed is None else jnp.asarray(fixed))
    Tt = tpg.optimize_pose_graph(torch.from_numpy(T0), torch.from_numpy(valid), _tgraph(graph),
                                 fixed=None if fixed is None else torch.from_numpy(fixed))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-4, rtol=0)
    g = 0 if fixed is None else 2
    np.testing.assert_allclose(Tt.numpy()[g], T0[g], atol=1e-6)  # the gauge stays
    assert np.abs(Tt.numpy() - T0).max() > 0.01


def test_pcg_pose_graph_matches_jax_and_dense():
    """`test_pose_graph_chain.py`'s permuted-chain case: PCG within 1e-4 of
    JAX's PCG and within 1e-3 m of the dense solve, slots scrambled."""
    rng = np.random.default_rng(3)
    F = 48
    T_gt = _circle_poses(F)
    graph = _chain_graph(T_gt)
    from orb_slam2_ssd_semantic_tpu.geometry import se3

    T0 = T_gt.copy()
    drift = np.eye(4, dtype=np.float32)
    for f in range(1, F):
        drift = np.asarray(se3.se3_exp(jnp.asarray(rng.normal(0, 0.01, 6).astype(np.float32)))) @ drift
        T0[f] = drift @ T_gt[f]
    perm = rng.permutation(F).astype(np.int32)  # slot = perm[rank]
    graph = graph._replace(edge_i=jnp.asarray(perm[np.asarray(graph.edge_i)]),
                           edge_j=jnp.asarray(perm[np.asarray(graph.edge_j)]))
    T0s = np.empty_like(T0)
    T0s[perm] = T0
    fixed = np.arange(F) == perm[0]
    valid = np.ones(F, bool)
    Tj = np.asarray(jpg.optimize_pose_graph_pcg(jnp.asarray(T0s), jnp.asarray(valid), graph,
                                                fixed=jnp.asarray(fixed), cg_iters=25,
                                                chain_perm=jnp.asarray(perm)))
    tg = _tgraph(graph)
    Tt = tpg.optimize_pose_graph_pcg(torch.from_numpy(T0s), torch.from_numpy(valid), tg,
                                     fixed=torch.from_numpy(fixed), cg_iters=25,
                                     chain_perm=torch.from_numpy(perm)).numpy()
    Td = tpg.optimize_pose_graph(torch.from_numpy(T0s), torch.from_numpy(valid), tg,
                                 fixed=torch.from_numpy(fixed)).numpy()
    np.testing.assert_allclose(Tt, Tj, atol=1e-4, rtol=0)
    assert np.linalg.norm(Tt[:, :3, 3] - Td[:, :3, 3], axis=-1).max() < 1e-3


def test_build_graph_arrays_is_exact():
    """Chain by uid over reused slots, strong covisibility edges, a loop
    edge, invalid slots, and truncation at max_edges."""
    rng = np.random.default_rng(9)
    F = 16
    W = rng.integers(0, 80, (F, F)).astype(np.int32)
    W = np.triu(W, 1) + np.triu(W, 1).T
    valid = rng.random(F) > 0.2
    uid = rng.permutation(F).astype(np.int32) * 3
    uid[~valid] = -1
    T = _circle_poses(F)
    loop = [(1, 9, 100.0, T[9] @ np.linalg.inv(T[1]))]
    for max_edges in (4 * F, 12):
        jg = jpg.build_graph_arrays(jnp.asarray(W), jnp.asarray(valid), 30, max_edges,
                                    jnp.asarray(T), extra_edges=loop, uid=jnp.asarray(uid))
        tg = tpg.build_graph_arrays(torch.from_numpy(W), torch.from_numpy(valid), 30, max_edges,
                                    torch.from_numpy(T), extra_edges=loop,
                                    uid=torch.from_numpy(uid))
        assert int(np.asarray(jg.valid).sum()) > 8
        for k, v in _tensors(jg).items():
            np.testing.assert_array_equal(getattr(tg, k).numpy(), v.numpy(), err_msg=k)
