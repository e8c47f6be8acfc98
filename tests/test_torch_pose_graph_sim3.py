"""The port's Sim(3) pose graph (`mapping/pose_graph.py::
optimize_pose_graph_sim3` with `Sim3Graph`) against the JAX package on
`tests/test_loop_reloc.py`'s scale-drift problem (F = 10 keyframes around
a circle, 11 exact Sim(3) edges with a loop edge, perturbed poses and
log-scales from a numpy seed, 30 iterations).

Tolerances: port against JAX within 1e-4 in poses and log-scales (the
same Gauss-Newton steps in f32, other summation orders in the scatters
and the solve); both within 1e-3 of ground truth, JAX's own gate. A
second case marks one edge and one keyframe invalid: the invalid
keyframe keeps its initial pose and scale, and the rest still converge.
"""

import numpy as np
import torch

import jax.numpy as jnp

from orb_slam2_ssd_semantic_tpu.mapping import pose_graph as jax_pose_graph
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.mapping.pose_graph import (
    Sim3Graph,
    optimize_pose_graph_sim3,
)
from _torch_threads import _few_threads  # noqa: F401 (autouse)

F = 10
EDGES = [(i, i + 1) for i in range(F - 1)] + [(0, F - 1), (2, 7)]


def scale_drift_problem(seed: int = 0):
    """Ground truth on a circle, poses perturbed by 0.05 rad / m and
    log-scales by 0.15 (keyframe 0 exact), exact edge measurements."""
    rng = np.random.default_rng(seed)
    xi_gt = np.stack([[np.cos(2 * np.pi * i / F), 0.05 * i, np.sin(2 * np.pi * i / F), 0.0,
                       2 * np.pi * i / F * 0.3, 0.0] for i in range(F)]).astype(np.float32)
    T_gt = se3.se3_exp(torch.from_numpy(xi_gt)).numpy()
    T0 = T_gt.copy()
    noise = rng.normal(0, 0.05, (F - 1, 6)).astype(np.float32)
    T0[1:] = se3.se3_exp(torch.from_numpy(noise)).numpy() @ T0[1:]
    log_s0 = np.concatenate([[0.0], rng.normal(0, 0.15, F - 1)]).astype(np.float32)
    Tji = np.stack([T_gt[j] @ np.linalg.inv(T_gt[i]) for i, j in EDGES]).astype(np.float32)
    E = len(EDGES)
    graph = dict(edge_i=np.array([e[0] for e in EDGES]), edge_j=np.array([e[1] for e in EDGES]),
                 s_ji=np.ones(E, np.float32), T_ji=Tji, weight=np.ones(E, np.float32),
                 valid=np.ones(E, bool))
    return T_gt, T0, log_s0, graph


def _both(T0, log_s0, graph, kf_valid):
    jg = jax_pose_graph.Sim3Graph(**{k: jnp.asarray(v.astype(np.int32) if k.startswith("edge")
                                                    else v) for k, v in graph.items()})
    T_j, ls_j = jax_pose_graph.optimize_pose_graph_sim3(
        jnp.asarray(T0), jnp.asarray(log_s0), jnp.asarray(kf_valid), jg, iters=30)
    tg = Sim3Graph(**{k: torch.from_numpy(v.astype(np.int64) if k.startswith("edge") else v)
                      for k, v in graph.items()})
    T_t, ls_t = optimize_pose_graph_sim3(torch.from_numpy(T0), torch.from_numpy(log_s0),
                                         torch.from_numpy(kf_valid), tg, iters=30)
    T_t, ls_t = T_t.numpy(), ls_t.numpy()
    np.testing.assert_allclose(T_t, np.asarray(T_j), atol=1e-4, rtol=0)
    np.testing.assert_allclose(ls_t, np.asarray(ls_j), atol=1e-4, rtol=0)
    return (T_t, ls_t), (np.asarray(T_j), np.asarray(ls_j))


def test_sim3_pose_graph_recovers_scale_drift_as_jax():
    T_gt, T0, log_s0, graph = scale_drift_problem()
    for T, ls in _both(T0, log_s0, graph, np.ones(F, bool)):
        assert np.abs(ls).max() < 1e-3
        assert np.abs(T - T_gt).max() < 1e-3


def test_sim3_pose_graph_with_an_invalid_edge_and_keyframe():
    """Edge (2, 7) invalid and one keyframe invalid (its two chain edges
    then carry no weight): the dead keyframe stays where it started; the
    others, still joined through the loop edge, converge."""
    T_gt, T0, log_s0, graph = scale_drift_problem(seed=1)
    dead_kf = 5
    graph["valid"][EDGES.index((2, 7))] = False
    kf_valid = np.ones(F, bool)
    kf_valid[dead_kf] = False
    for T, ls in _both(T0, log_s0, graph, kf_valid):
        np.testing.assert_array_equal(T[dead_kf], T0[dead_kf])
        assert ls[dead_kf] == log_s0[dead_kf]
        # Keyframes 0-4 and 6-9 are two chains tied at 0 and 9 by the loop
        # edge; the chain 6-9 hangs from keyframe 0 through that edge.
        assert np.abs(ls[kf_valid]).max() < 1e-3
        assert np.abs(T[kf_valid] - T_gt[kf_valid]).max() < 1e-3
