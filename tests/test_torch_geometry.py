"""Port parity: se3, camera, small linear algebra and motion-only pose
optimization against the JAX package on the same numpy inputs.

Tolerance atol 1e-5 (relative for large quantities): both sides compute
in f32 (the JAX side at HIGHEST matmul precision), but XLA and torch sum
contractions in different orders and XLA may fuse multiply-adds, so
results agree to a few ulps, not bit for bit."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_ssd_semantic_tpu.config import TUM1 as J_TUM1
from orb_slam2_ssd_semantic_tpu.config import CameraConfig as JCam
from orb_slam2_ssd_semantic_tpu.config import OptimizerConfig as JOpt
from orb_slam2_ssd_semantic_tpu.geometry import camera as jcam
from orb_slam2_ssd_semantic_tpu.geometry import se3 as jse3
from orb_slam2_ssd_semantic_tpu.ops import linalg as jla
from orb_slam2_ssd_semantic_tpu.tracking.pose_opt import pose_optimize as j_pose_optimize
from orb_slam2_ssd_semantic_tpu_torch.config import TUM1 as T_TUM1
from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig as TCam
from orb_slam2_ssd_semantic_tpu_torch.config import OptimizerConfig as TOpt
from orb_slam2_ssd_semantic_tpu_torch.geometry import camera as tcam
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3 as tse3
from orb_slam2_ssd_semantic_tpu_torch.ops import linalg as tla
from orb_slam2_ssd_semantic_tpu_torch.tracking.pose_opt import pose_optimize as t_pose_optimize
from orb_slam2_ssd_semantic_tpu_torch.utils.precision import highest_precision

ATOL = 1e-5


def _close(a, b, atol=ATOL, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(a), b.numpy() if torch.is_tensor(b) else b,
                               atol=atol, rtol=rtol)


def _twists(seed, n=64, small=False):
    rng = np.random.default_rng(seed)
    xi = rng.normal(0, 1e-7 if small else 0.6, (n, 6)).astype(np.float32)
    return xi


@pytest.mark.parametrize("small", [False, True], ids=["generic", "near_identity"])
def test_se3_exp_log_inverse_transform(small):
    xi = _twists(1, small=small)
    Tj = jse3.se3_exp(jnp.asarray(xi))
    Tt = tse3.se3_exp(torch.from_numpy(xi))
    _close(Tj, Tt)
    _close(jse3.se3_log(Tj), tse3.se3_log(Tt), atol=1e-4 if not small else ATOL)
    _close(jse3.se3_inverse(Tj), tse3.se3_inverse(Tt))
    pts = np.random.default_rng(2).normal(0, 3, (64, 50, 3)).astype(np.float32)
    _close(jse3.transform_points(Tj, jnp.asarray(pts)),
           tse3.transform_points(Tt, torch.from_numpy(pts)), atol=1e-4)
    _close(jse3.so3_exp(jnp.asarray(xi[:, 3:])), tse3.so3_exp(torch.from_numpy(xi[:, 3:])))


def test_so3_log_near_pi_and_rot_to_quat():
    rng = np.random.default_rng(3)
    axis = rng.normal(0, 1, (32, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    w = (axis * (np.pi - rng.uniform(0, 5e-4, (32, 1)))).astype(np.float32)
    w = np.concatenate([w, _twists(4, 32)[:, 3:]])
    Rj = jse3.so3_exp(jnp.asarray(w))
    Rt = tse3.so3_exp(torch.from_numpy(w))
    _close(jse3.so3_log(Rj), tse3.so3_log(Rt), atol=1e-3)
    _close(jse3.rot_to_quat(Rj), tse3.rot_to_quat(Rt), atol=1e-5)


@pytest.mark.parametrize("distorted", [False, True])
def test_camera_project_backproject_undistort(distorted):
    jc, tc = (J_TUM1.camera, T_TUM1.camera) if distorted else (JCam(), TCam())
    rng = np.random.default_rng(5)
    pc = np.concatenate([rng.uniform(-2, 2, (200, 2)), rng.uniform(0.2, 6, (200, 1))], 1)
    pc = pc.astype(np.float32)
    uj, zj = jcam.project(jnp.asarray(pc), jc)
    ut, zt = tcam.project(torch.from_numpy(pc), tc)
    _close(uj, ut, atol=1e-3)
    d = rng.uniform(0.3, 5, 200).astype(np.float32)
    uv = rng.uniform(0, 640, (200, 2)).astype(np.float32)
    _close(jcam.backproject(jnp.asarray(uv), jnp.asarray(d), jc),
           tcam.backproject(torch.from_numpy(uv), torch.from_numpy(d), tc))
    _close(jcam.undistort_points(jnp.asarray(uv), jc),
           tcam.undistort_points(torch.from_numpy(uv), tc), atol=1e-3)
    _close(jcam.stereo_right_u(jnp.asarray(uv), jnp.asarray(d), jc),
           tcam.stereo_right_u(torch.from_numpy(uv), torch.from_numpy(d), tc), atol=1e-3)


def test_small_linear_algebra():
    rng = np.random.default_rng(6)
    M = rng.normal(0, 1, (40, 6, 6)).astype(np.float32)
    H = M @ M.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)
    b = rng.normal(0, 1, (40, 6)).astype(np.float32)
    _close(jla.cholesky_solve_small(jnp.asarray(H), jnp.asarray(b)),
           tla.cholesky_solve_small(torch.from_numpy(H), torch.from_numpy(b)), atol=1e-4)
    A = rng.normal(0, 1, (50, 3, 3)).astype(np.float32) + 2 * np.eye(3, dtype=np.float32)
    _close(jla.inv3x3(jnp.asarray(A)), tla.inv3x3(torch.from_numpy(A)), atol=1e-4)
    Ac = np.ascontiguousarray(A.transpose(1, 2, 0))
    _close(jla.inv3x3_cols(jnp.asarray(Ac)), tla.inv3x3_cols(torch.from_numpy(Ac)), atol=1e-4)


def test_pose_optimize_matches_jax():
    """Synthetic 3D-2D(3) problem with outliers and mono observations:
    the same inlier set and the same pose (translation atol 1e-5 m)."""
    rng = np.random.default_rng(7)
    jc, tc = JCam(), TCam()
    n = 400
    T_true = np.asarray(jse3.se3_exp(jnp.asarray([0.05, -0.02, 0.1, 0.02, -0.03, 0.01],
                                                 jnp.float32)))
    pw = np.concatenate([rng.uniform(-2, 2, (n, 2)), rng.uniform(1, 5, (n, 1))], 1).astype(np.float32)
    pc = pw @ T_true[:3, :3].T + T_true[:3, 3]
    u = jc.fx * pc[:, 0] / pc[:, 2] + jc.cx + rng.normal(0, 0.5, n)
    v = jc.fy * pc[:, 1] / pc[:, 2] + jc.cy + rng.normal(0, 0.5, n)
    ur = u - jc.depth_bf / pc[:, 2]
    obs = np.stack([u, v, ur], 1).astype(np.float32)
    obs[:30] += rng.normal(0, 40, (30, 3)).astype(np.float32)  # outliers
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    stereo = rng.random(n) > 0.3
    valid = rng.random(n) > 0.05
    T0 = np.eye(4, dtype=np.float32)
    rj = j_pose_optimize(jnp.asarray(T0), jnp.asarray(pw), jnp.asarray(obs), jnp.asarray(inv_s2),
                         jnp.asarray(stereo), jnp.asarray(valid), jc, JOpt())
    with highest_precision():
        rt = t_pose_optimize(torch.from_numpy(T0), torch.from_numpy(pw), torch.from_numpy(obs),
                             torch.from_numpy(inv_s2), torch.from_numpy(stereo),
                             torch.from_numpy(valid), tc, TOpt())
    np.testing.assert_array_equal(np.asarray(rj.inliers), rt.inliers.numpy())
    _close(rj.T_cw, rt.T_cw, atol=ATOL)
    assert int(rt.num_inliers) == int(rj.num_inliers)
    assert dataclasses.is_dataclass(rt)
