"""Functions of the JAX package that no path calls, and their
counterparts in the port, on the same numpy inputs:
`ops/linalg.pcg_solve`, `geometry/se3.quat_to_rot` (with the twin of
`tests/test_se3.py::test_quat_roundtrip`), `frontend/extractor.
sigma2_per_level` and `mapping/map_state.point_positions_valid`.

Tolerances: PCG within 1e-4 relative of JAX's iterate (the same steps in
f32, other summation orders in the matvecs) on well-conditioned systems,
where it converges (then also within 1e-3 relative of the exact solve),
and on a condition number of 1e4 cut at 5 steps (run on, CG's f32
rounding grows there: the two packages' iterates parted by 1.5% after 32
steps); rotations within 1e-6 of JAX's
and 1e-5 through the round trip (JAX's test's); the per-level variances
within 1e-6 relative; positions and flags exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_ssd_semantic_tpu.config import OrbConfig as JaxOrbConfig
from orb_slam2_ssd_semantic_tpu.frontend import extractor as jax_extractor
from orb_slam2_ssd_semantic_tpu.geometry import se3 as jax_se3
from orb_slam2_ssd_semantic_tpu.ops import linalg as jax_linalg
from orb_slam2_ssd_semantic_tpu_torch.config import OrbConfig
from orb_slam2_ssd_semantic_tpu_torch.frontend import extractor
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.ops import linalg
from _torch_threads import _few_threads  # noqa: F401 (autouse)


def _spd(rng, n: int, cond: float) -> np.ndarray:
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    return ((q * np.geomspace(1.0, cond, n)) @ q.T).astype(np.float32)


@pytest.mark.parametrize("n,cond,iters", [(24, 1e2, 32), (96, 30.0, 24), (60, 1e4, 5)])
def test_pcg_solve_matches_jax(n, cond, iters):
    rng = np.random.default_rng(n + iters)
    A = _spd(rng, n, cond)
    b = rng.normal(size=n).astype(np.float32)
    x = linalg.pcg_solve(torch.from_numpy(A), torch.from_numpy(b), iters=iters).numpy()
    ref = np.asarray(jax_linalg.pcg_solve(jnp.asarray(A), jnp.asarray(b), iters=iters))
    np.testing.assert_allclose(x, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    if cond <= 1e2:
        exact = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
        np.testing.assert_allclose(x, exact, rtol=0, atol=1e-3 * np.abs(exact).max())


def test_pcg_solve_stops_on_negative_curvature():
    """An indefinite matrix: the guard freezes the iterate instead of
    stepping to infinity, in both packages."""
    A = np.diag([4.0, 1.0, -2.0]).astype(np.float32)
    b = np.array([1.0, 1.0, 1.0], np.float32)
    x = linalg.pcg_solve(torch.from_numpy(A), torch.from_numpy(b), iters=8).numpy()
    ref = np.asarray(jax_linalg.pcg_solve(jnp.asarray(A), jnp.asarray(b), iters=8))
    assert np.isfinite(x).all()
    np.testing.assert_allclose(x, ref, atol=1e-6, rtol=0)


def test_quat_to_rot_matches_jax_and_roundtrips():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(128, 3)).astype(np.float32)
    w = w / np.linalg.norm(w, axis=-1, keepdims=True) * rng.uniform(0, 3.0, (128, 1)).astype(
        np.float32)
    R = se3.so3_exp(torch.from_numpy(w))
    q = se3.rot_to_quat(R)
    np.testing.assert_allclose(se3.quat_to_rot(q).numpy(), R.numpy(), atol=1e-5)
    q_raw = rng.normal(size=(64, 4)).astype(np.float32)  # unnormalized
    np.testing.assert_allclose(se3.quat_to_rot(torch.from_numpy(q_raw)).numpy(),
                               np.asarray(jax_se3.quat_to_rot(jnp.asarray(q_raw))),
                               atol=1e-6, rtol=0)


def test_sigma2_per_level_matches_jax():
    for cfg, jcfg in ((OrbConfig(), JaxOrbConfig()),
                      (OrbConfig(n_levels=4, scale_factor=1.5),
                       JaxOrbConfig(n_levels=4, scale_factor=1.5))):
        np.testing.assert_allclose(extractor.sigma2_per_level(cfg).numpy(),
                                   np.asarray(jax_extractor.sigma2_per_level(jcfg)),
                                   rtol=1e-6, atol=0)


def test_point_positions_valid_matches_jax():
    from orb_slam2_ssd_semantic_tpu.config import MapConfig as JaxMapConfig
    from orb_slam2_ssd_semantic_tpu.config import SlamConfig as JaxSlamConfig
    from orb_slam2_ssd_semantic_tpu.mapping import map_state as jax_map_state

    from orb_slam2_ssd_semantic_tpu_torch.config import MapConfig, SlamConfig
    from orb_slam2_ssd_semantic_tpu_torch.mapping import map_state

    state = map_state.empty_state(SlamConfig(map=MapConfig(max_keyframes=4, max_map_points=64)),
                                  torch.device("cpu"))
    rng = np.random.default_rng(3)
    state.points.pos = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))
    state.points.valid = torch.from_numpy(rng.random(64) < 0.5)
    ref_state = jax_map_state.empty_state(
        JaxSlamConfig(map=JaxMapConfig(max_keyframes=4, max_map_points=64)))
    ref_state = ref_state._replace(points=ref_state.points._replace(
        pos=jnp.asarray(state.points.pos.numpy()), valid=jnp.asarray(state.points.valid.numpy())))
    pos, valid = map_state.point_positions_valid(state)
    ref_pos, ref_valid = jax_map_state.point_positions_valid(ref_state)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(ref_pos))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
