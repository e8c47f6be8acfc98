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
from _torch_threads import _few_threads  # noqa: F401 (autouse)

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


# ---- relocalization geometry: Horn alignment, 3D-3D and EPnP RANSAC -------
#
# RANSAC parity runs on the SAME minimal sets: the test draws them with
# JAX's own `split` + `categorical` (what the JAX functions draw inside),
# so scoring and refit are compared without the two random streams. Sets
# that repeat a row are degenerate (a rotation is not determined by two
# points), and so, for EPnP, are sets that its own hypothesis does not
# reproject within the threshold (a set holding an outlier: its
# least-squares pose is off by up to radians and moves with rounding):
# their hypotheses are implementation-defined, so per-hypothesis counts
# are compared on the others. Random sampling is checked apart,
# with a torch.Generator, at the JAX tests' own gates.

import jax  # noqa: E402

from orb_slam2_ssd_semantic_tpu.geometry import epnp as jepnp  # noqa: E402
from orb_slam2_ssd_semantic_tpu.geometry.ransac3d import ransac_rigid as j_ransac_rigid  # noqa: E402
from orb_slam2_ssd_semantic_tpu_torch.geometry import epnp as tepnp  # noqa: E402
from orb_slam2_ssd_semantic_tpu_torch.geometry import ransac3d as tr3d  # noqa: E402

EPNP_CAM = (JCam(), TCam())


def _jax_sets(key, valid, n_sets, set_size):
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    keys = jax.random.split(key, n_sets)
    idx = jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(set_size,)))(keys)
    return np.asarray(idx).astype(np.int64)


def _distinct(idx):
    return np.array([len(set(r)) == len(r) for r in idx])


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _rigid_scene(rng, n=300, n_out=90):
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    R_true = tse3.so3_exp(torch.tensor([0.2, -0.1, 0.3])).numpy()
    t_true = np.array([0.5, 1.0, -0.3], np.float32)
    dst = pts @ R_true.T + t_true
    dst[:n_out] += rng.uniform(0.5, 2.0, (n_out, 3)).astype(np.float32)
    return pts, dst, R_true, t_true


def _epnp_scene(rng, n=64, rot=0.4, noise=0.0, n_out=0):
    """World points seen by a random camera (test_epnp.make_scene), with
    pixel noise and shuffled outlier pixels."""
    cam = EPNP_CAM[0]
    w = rng.normal(size=3).astype(np.float32)
    w *= rot / max(np.linalg.norm(w), 1e-6)
    R = tse3.so3_exp(torch.from_numpy(w)).numpy()
    t = rng.normal(size=3).astype(np.float32) * 0.5 + np.array([0, 0, 0.3], np.float32)
    z = rng.uniform(1.0, 6.0, size=n).astype(np.float32)
    u = rng.uniform(40, cam.width - 40, size=n).astype(np.float32)
    v = rng.uniform(40, cam.height - 40, size=n).astype(np.float32)
    pc = np.stack([(u - cam.cx) * z / cam.fx, (v - cam.cy) * z / cam.fy, z], -1)
    pw = ((pc - t) @ R).astype(np.float32)
    uv = np.stack([u, v], -1) + rng.normal(size=(n, 2)).astype(np.float32) * noise
    out = rng.choice(n, size=n_out, replace=False)
    uv[out] = rng.uniform([0, 0], [cam.width, cam.height], size=(n_out, 2))
    return pw, uv.astype(np.float32), R, t


def _pose_err(R, t, R_gt, t_gt):
    dR = np.asarray(R) @ R_gt.T
    return np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)), np.linalg.norm(np.asarray(t) - t_gt)


@pytest.mark.parametrize("with_scale", [True, False], ids=["sim3", "rigid"])
def test_horn_sim3_matches_jax(with_scale):
    rng = np.random.default_rng(5)
    src = rng.normal(0, 2, (16, 24, 3)).astype(np.float32)
    R = tse3.so3_exp(torch.from_numpy(rng.normal(0, 1, (16, 3)).astype(np.float32))).numpy()
    dst = (1.7 * np.einsum("bij,bnj->bni", R, src) + rng.normal(0, 1, (16, 1, 3))
           + rng.normal(0, 0.01, src.shape)).astype(np.float32)
    mask = (rng.random((16, 24)) > 0.3).astype(np.float32)
    for m in (None, mask):
        sj, Rj, tj = jse3.horn_sim3(jnp.asarray(src), jnp.asarray(dst),
                                    None if m is None else jnp.asarray(m), with_scale=with_scale)
        with highest_precision():
            st, Rt, tt = tse3.horn_sim3(torch.from_numpy(src), torch.from_numpy(dst),
                                        None if m is None else torch.from_numpy(m),
                                        with_scale=with_scale)
        _close(sj, st)
        _close(Rj, Rt)
        _close(tj, tt)
        assert np.abs(np.linalg.det(Rt.numpy()) - 1).max() < 1e-5


def test_ransac_rigid_on_jax_minimal_sets():
    rng = np.random.default_rng(0)
    pts, dst, _, _ = _rigid_scene(rng)
    valid = np.ones(300, bool)
    valid[rng.choice(300, 20, replace=False)] = False
    key = jax.random.PRNGKey(0)
    idx = _jax_sets(key, valid, 256, 3)
    sj, Rj, tj, inl_j, nj = j_ransac_rigid(jnp.asarray(pts), jnp.asarray(dst), jnp.asarray(valid),
                                           key, threshold=0.05)
    src_t, dst_t, valid_t = torch.from_numpy(pts), torch.from_numpy(dst), torch.from_numpy(valid)
    with highest_precision():
        _, inl_h = tr3d.score_rigid_sets(src_t, dst_t, valid_t, torch.from_numpy(idx), 0.05)
        st, Rt, tt, inl_t, nt = tr3d.fit_rigid_sets(src_t, dst_t, valid_t,
                                                    torch.from_numpy(idx), 0.05)
    # Per-hypothesis counts of JAX's own hypotheses on the same sets.
    s_h, R_h, t_h = jax.vmap(lambda i: jse3.horn_sim3(jnp.asarray(pts)[i], jnp.asarray(dst)[i],
                                                      with_scale=False))(jnp.asarray(idx))
    pred = np.einsum("sij,nj->sni", np.asarray(R_h), pts) + np.asarray(t_h)[:, None]
    counts_j = ((np.linalg.norm(pred - dst[None], axis=-1) < 0.05) & valid).sum(-1)
    keep = _distinct(idx)
    assert keep.sum() > 200
    np.testing.assert_array_equal(inl_h.sum(-1).numpy()[keep], counts_j[keep])
    assert int(nt) == int(nj) >= 180
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    _close(Rj, Rt, atol=1e-4)
    _close(tj, tt, atol=1e-4)


def test_epnp_exact_data_matches_jax():
    pw, uv, R_gt, t_gt = _epnp_scene(np.random.default_rng(1), n=32)
    w = np.ones(32, np.float32)
    Rj, tj = jax.jit(jepnp._epnp, static_argnames=("cam",))(
        jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(w), EPNP_CAM[0])
    with highest_precision():
        Rt, tt = tepnp._epnp(torch.from_numpy(pw), torch.from_numpy(uv), torch.from_numpy(w),
                             EPNP_CAM[1])
    _close(Rj, Rt, atol=1e-4)
    _close(tj, tt, atol=1e-4)
    ang, dt = _pose_err(Rt, tt, R_gt, t_gt)
    assert ang < 1e-3 and dt < 5e-3, (ang, dt)


@pytest.mark.parametrize("noise,flip_axes", [(0.0, True), (0.3, False)],
                         ids=["exact", "noisy"])
def test_epnp_eigenvector_signs_do_not_matter(noise, flip_axes):
    """EPnP's eigenvectors come with arbitrary signs (they differ between
    LAPACK builds). Flipping null-space vectors (12x12) must leave the
    pose where it was: the beta sign rules absorb them. Flipping the
    control points' principal axes (3x3) picks other, equally valid
    control points, which give the same pose on exact data only."""
    pw, uv, R_gt, t_gt = _epnp_scene(np.random.default_rng(2), n=40, noise=noise)
    pw_t, uv_t, w = torch.from_numpy(pw), torch.from_numpy(uv), torch.ones(40)
    eigh = torch.linalg.eigh
    signs = {12: torch.tensor([1.0, -1, 1, -1, 1, 1, -1, 1, 1, 1, -1, -1])}
    if flip_axes:
        signs[3] = torch.tensor([-1.0, 1, -1])

    def flipped(a):
        vals, vecs = eigh(a)
        sign = signs.get(vecs.shape[-1])
        return vals, vecs if sign is None else vecs * sign

    with highest_precision():
        R0, t0 = tepnp._epnp(pw_t, uv_t, w, EPNP_CAM[1])
        torch.linalg.eigh = flipped
        try:
            R1, t1 = tepnp._epnp(pw_t, uv_t, w, EPNP_CAM[1])
        finally:
            torch.linalg.eigh = eigh
    _close(R0, R1, atol=1e-4)
    _close(t0, t1, atol=1e-4)
    ang, dt = _pose_err(R1, t1, R_gt, t_gt)
    assert ang < 1e-2 and dt < 0.05, (ang, dt)


def test_ransac_epnp_on_jax_minimal_sets():
    rng = np.random.default_rng(3)
    pw, uv, _, _ = _epnp_scene(rng, n=96, noise=0.3, n_out=28)
    valid = np.ones(96, bool)
    valid[rng.choice(96, size=6, replace=False)] = False
    key = jax.random.PRNGKey(3)
    idx = _jax_sets(key, valid, 128, 6)
    Rj, tj, inl_j, nj = jepnp.ransac_epnp(jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(valid),
                                          key, EPNP_CAM[0])
    args = (torch.from_numpy(pw), torch.from_numpy(uv), torch.from_numpy(valid),
            torch.from_numpy(idx), EPNP_CAM[1])
    # The control points' axes are eigenvectors whose signs LAPACK builds
    # choose differently; other signs are other valid control points and
    # move a noisy pose by ~0.3 px (test above). The refit is compared with
    # the JAX side's signs: torch's 3x3 `eigh` answers with JAX's.
    eigh = torch.linalg.eigh

    def eigh_as_jax(a):
        if a.shape[-1] != 3:
            return eigh(a)
        vals, vecs = jnp.linalg.eigh(jnp.asarray(a.numpy()))
        return torch.from_numpy(np.array(vals)), torch.from_numpy(np.array(vecs))

    with highest_precision():
        _, inl_h = tepnp.score_epnp_sets(*args)
        torch.linalg.eigh = eigh_as_jax
        try:
            Rt, tt, inl_t, nt = tepnp.fit_epnp_sets(*args)
        finally:
            torch.linalg.eigh = eigh
    th = 5.991 ** 0.5 * 2.0

    def hyp_counts(i):
        R, t = jepnp._epnp(jnp.asarray(pw)[i], jnp.asarray(uv)[i], jnp.ones((6,)), EPNP_CAM[0])
        pc = jnp.asarray(pw) @ R.T + t
        z = jnp.maximum(pc[:, 2], 1e-6)
        proj = jnp.stack([EPNP_CAM[0].fx * pc[:, 0] / z + EPNP_CAM[0].cx,
                          EPNP_CAM[0].fy * pc[:, 1] / z + EPNP_CAM[0].cy], -1)
        err = jnp.linalg.norm(proj - jnp.asarray(uv), axis=-1)
        ok = (err < th) & (pc[:, 2] > 0)
        return jnp.sum(ok & jnp.asarray(valid)), jnp.max(err[i])

    counts_j, own_err = map(np.asarray, jax.jit(jax.vmap(hyp_counts))(jnp.asarray(idx)))
    keep = _distinct(idx) & (own_err < th)
    assert keep.sum() >= 8 and counts_j[keep].min() > 50
    np.testing.assert_array_equal(inl_h.sum(-1).numpy()[keep], counts_j[keep])
    assert int(nt) == int(nj) > 50
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    def proj(R, t):
        pc = pw @ np.asarray(R).T + np.asarray(t)
        return np.stack([EPNP_CAM[0].fx * pc[:, 0] / pc[:, 2] + EPNP_CAM[0].cx,
                         EPNP_CAM[0].fy * pc[:, 1] / pc[:, 2] + EPNP_CAM[0].cy], -1)

    inl = np.asarray(inl_j)
    rms_t, rms_j = (np.sqrt(np.mean(np.sum((proj(R, t) - uv)[inl] ** 2, -1)))
                    for R, t in ((Rt.numpy(), tt.numpy()), (Rj, tj)))
    d = np.linalg.norm(proj(Rt.numpy(), tt.numpy()) - proj(Rj, tj), axis=-1)[inl]
    # Pixel-consistent: both refits explain the inliers equally well
    # (RMS within 1e-3 px), and reproject each within 1e-2 px of the
    # other (3.1e-3 px measured: f32 null vectors of the 12x12 M^T M).
    assert abs(rms_t - rms_j) < 1e-3, (rms_t, rms_j)
    assert d.max() < 1e-2, d.max()


def test_port_sampling_recovers_poses_at_the_jax_gates():
    """The port's own random minimal sets pass the JAX package's RANSAC
    tests' gates (test_loop_reloc.py::test_ransac_rigid_with_outliers,
    test_epnp.py's outlier and valid-mask cases)."""
    rng = np.random.default_rng(0)
    pts, dst, R_true, t_true = _rigid_scene(rng)
    with highest_precision():
        _, R, t, _, n = tr3d.ransac_rigid(torch.from_numpy(pts), torch.from_numpy(dst),
                                          torch.ones(300, dtype=torch.bool), _gen(0),
                                          threshold=0.05)
    assert int(n) >= 200
    np.testing.assert_allclose(R.numpy(), R_true, atol=1e-3)
    np.testing.assert_allclose(t.numpy(), t_true, atol=5e-3)

    pw, uv, R_gt, t_gt = _epnp_scene(rng, n=96, noise=0.3, n_out=28)
    valid = np.ones(96, bool)
    valid[rng.choice(96, size=6, replace=False)] = False
    with highest_precision():
        R, t, _, n = tepnp.ransac_epnp(torch.from_numpy(pw), torch.from_numpy(uv),
                                       torch.from_numpy(valid), _gen(3), EPNP_CAM[1])
    ang, dt = _pose_err(R, t, R_gt, t_gt)
    assert ang < 0.01 and dt < 0.05 and int(n) > 50, (ang, dt, int(n))

    pw, uv, R_gt, t_gt = _epnp_scene(rng, n=64)
    valid = np.zeros(64, bool)
    valid[:24] = True
    with highest_precision():
        R, t, inl, _ = tepnp.ransac_epnp(torch.from_numpy(pw), torch.from_numpy(uv),
                                         torch.from_numpy(valid), _gen(0), EPNP_CAM[1])
    assert not inl.numpy()[~valid].any()
    ang, dt = _pose_err(R, t, R_gt, t_gt)
    assert ang < 1e-2 and dt < 0.05, (ang, dt)


def test_minimal_sets_and_no_valid_row():
    """Sets hold valid rows only, drawn with replacement over all of them;
    with no valid row both RANSACs return zero inliers without raising."""
    valid = torch.zeros(50, dtype=torch.bool)
    valid[[3, 7, 8, 20, 49]] = True
    idx = tr3d.sample_minimal_sets(valid, 400, 3, _gen(1))
    assert valid[idx].all() and set(idx.unique().tolist()) == {3, 7, 8, 20, 49}
    assert not _distinct(idx.numpy()).all()  # with replacement
    none = torch.zeros(50, dtype=torch.bool)
    rng = np.random.default_rng(6)
    pts = torch.from_numpy(rng.normal(size=(50, 3)).astype(np.float32))
    uv = torch.from_numpy(rng.uniform(0, 400, (50, 2)).astype(np.float32))
    with highest_precision():
        _, _, _, inl, n = tr3d.ransac_rigid(pts, pts + 1.0, none, _gen(0))
        assert int(n) == 0 and not inl.any()
        _, _, inl, n = tepnp.ransac_epnp(pts, uv, none, _gen(0), EPNP_CAM[1])
        assert int(n) == 0 and not inl.any()


def test_non_finite_hypotheses_give_nan_not_errors():
    """A diverged hypothesis (NaN or Inf in a batch element) leaves NaN in
    that element, as XLA's decompositions do, where torch's would raise;
    the other elements are untouched and the NaN one scores no inlier."""
    rng = np.random.default_rng(8)
    src = torch.from_numpy(rng.normal(size=(4, 6, 3)).astype(np.float32))
    dst = src + 0.5
    bad = dst.clone()
    bad[2, 1, 0] = float("nan")
    bad[3, 0, 2] = float("inf")
    with highest_precision():
        s0, R0, t0 = tse3.horn_sim3(src, dst)
        s1, R1, t1 = tse3.horn_sim3(src, bad)
    assert torch.isnan(R1[2:]).all() and torch.isnan(t1[2:]).all()
    assert torch.equal(R1[:2], R0[:2]) and torch.equal(t1[:2], t0[:2])
    pw, uv, _, _ = _epnp_scene(rng, n=12)
    pw_b = torch.from_numpy(np.stack([pw[:6], pw[6:]]))
    pw_b[1, 2, 1] = float("inf")
    uv_b = torch.from_numpy(np.stack([uv[:6], uv[6:]]))
    with highest_precision():
        R, t = tepnp._epnp(pw_b, uv_b, torch.ones(2, 6), EPNP_CAM[1])
    assert torch.isfinite(R[0]).all() and torch.isnan(R[1]).all()


def _sim3_twists(seed, n=64):
    """Sim(3) tangents [rho, phi, sigma], with rows at exactly zero
    rotation, exactly zero log-scale, both, and tiny values, so every
    branch of `_sim3_W` is taken."""
    v = np.random.default_rng(seed).normal(0, 0.5, (n, 7)).astype(np.float32)
    v[0] = 0.0
    v[1, 3:6] = 0.0
    v[2, 6] = 0.0
    v[3, 3:] = 0.0
    v[4, 3:6] = 1e-7
    v[5, 6] = 1e-7
    return v


def test_sim3_algebra_matches_jax():
    v = _sim3_twists(5)
    sj, Rj, tj = jse3.sim3_exp(jnp.asarray(v))
    st, Rt, tt = tse3.sim3_exp(torch.from_numpy(v))
    for a, b in ((sj, st), (Rj, Rt), (tj, tt)):
        _close(a, b)
    _close(jse3.sim3_log(sj, Rj, tj), tse3.sim3_log(st, Rt, tt))
    for a, b in zip(jse3.sim3_inverse(sj, Rj, tj), tse3.sim3_inverse(st, Rt, tt)):
        _close(a, b)
    roll = [x[::-1] for x in (sj, Rj, tj)]
    rollt = [x.flip(0) for x in (st, Rt, tt)]
    for a, b in zip(jse3.sim3_compose(sj, Rj, tj, *roll), tse3.sim3_compose(st, Rt, tt, *rollt)):
        _close(a, b)
    pts = np.random.default_rng(6).normal(0, 2, (64, 20, 3)).astype(np.float32)
    _close(jse3.sim3_apply(sj, Rj, tj, jnp.asarray(pts)),
           tse3.sim3_apply(st, Rt, tt, torch.from_numpy(pts)), atol=1e-4)


def test_sim3_exp_jacobian_at_zero_matches_jax():
    """Forward-mode derivatives at 0, where only the small-angle and
    small-sigma branches are selected: finite and equal to jax.jacfwd."""
    import jax

    def flat_j(x):
        s, R, t = jse3.sim3_exp(x)
        return jnp.concatenate([R.reshape(-1), t, s[None]])

    def flat_t(x):  # a leading batch dim of 1, as optimize_sim3 takes it
        s, R, t = tse3.sim3_exp(x[None])
        return torch.cat([R.reshape(-1), t.reshape(-1), s])

    Jj = np.asarray(jax.jacfwd(flat_j)(jnp.zeros(7, jnp.float32)))
    Jt = torch.func.jacfwd(flat_t)(torch.zeros(7))
    assert torch.isfinite(Jt).all()
    _close(Jj, Jt)


@pytest.mark.parametrize("seed,scale,fix_scale,n_out", [(0, 1.0, True, 0), (1, 1.3, False, 0),
                                                        (7, 1.0, True, 30)],
                         ids=["rgbd", "mono_scale", "outliers"])
def test_optimize_sim3_matches_jax(seed, scale, fix_scale, n_out):
    """`tests/test_sim3_opt.py`'s three cases through both packages: R and
    t within 1e-4, inlier masks exact."""
    from orb_slam2_ssd_semantic_tpu.mapping.sim3_opt import optimize_sim3 as j_opt
    from orb_slam2_ssd_semantic_tpu_torch.mapping.sim3_opt import optimize_sim3 as t_opt
    from test_sim3_opt import make_pair

    rng = np.random.default_rng(seed)
    p_i, p_j, uv_i, uv_j, s_gt, R_gt, t_gt = make_pair(rng, scale=scale)
    n = p_i.shape[0]
    if n_out:
        out = rng.choice(n, size=n_out, replace=False)
        p_j[out] = p_j[np.roll(out, 1)]
        uv_j[out] = uv_j[np.roll(out, 1)]
    dR = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(size=3).astype(np.float32) * 0.02)))
    s0 = np.float32(s_gt * (1.0 if fix_scale else 1.05))
    R0 = (dR @ R_gt).astype(np.float32)
    t0 = (t_gt + rng.normal(size=3).astype(np.float32) * 0.05).astype(np.float32)
    ones = np.ones(n, np.float32)
    args = (p_i, p_j, uv_i, uv_j, ones, ones)
    rj = j_opt(jnp.float32(s0), jnp.asarray(R0), jnp.asarray(t0), *map(jnp.asarray, args),
               jnp.ones(n, bool), JCam(), fix_scale=fix_scale)
    with highest_precision():
        rt = t_opt(torch.tensor(s0), torch.from_numpy(R0), torch.from_numpy(t0),
                   *map(torch.from_numpy, args), torch.ones(n, dtype=torch.bool), TCam(),
                   fix_scale=fix_scale)
    _close(rj.R, rt.R, atol=1e-4)
    _close(rj.t, rt.t, atol=1e-4)
    _close(rj.s, rt.s, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(rj.inliers), rt.inliers.numpy())
    assert int(rt.num_inliers) == int(rj.num_inliers) >= 98
