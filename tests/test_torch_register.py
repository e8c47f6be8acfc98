"""The port's depth registration, undistortion and live RGB-D app
(`ops/register.py`, `geometry/camera.distort`/`intrinsics_matrix`,
`apps/live_rgbd.py`) against the JAX package on the same numpy inputs:
twins of the six tests of `tests/test_register.py`, each running both
packages' function.

Tolerances, and why:
- registration: the same pixels hold depth in both, and their depths
  agree within 1e-6 m (the arithmetic is the same up to f32 rounding;
  JAX's own identity test allows 1e-5);
- undistortion: within 1e-4 gray levels with zero distortion (the map is
  bit-equal to JAX's there), within 1e-3 with distortion: XLA contracts
  the distortion polynomial into fused multiply-adds, which the port does
  not copy, so the two maps part by a few ulp, and the noise image below
  steps by up to 255 levels a pixel;
- `distort` and `intrinsics_matrix`: within 1e-7;
- the app on 8 synthetic 640x480 frames: poses within 1e-4 m of JAX's app
  and the same files written.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_ssd_semantic_tpu.config import CameraConfig as JaxCamera
from orb_slam2_ssd_semantic_tpu.geometry import camera as jax_camera
from orb_slam2_ssd_semantic_tpu.ops import register as jax_register
from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig
from orb_slam2_ssd_semantic_tpu_torch.geometry import camera
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.ops import register
from _torch_threads import _few_threads  # noqa: F401 (autouse)

SMALL = dict(width=64, height=48, fx=50.0, fy=50.0, cx=32.0, cy=24.0)
DISTORTIONS = [dict(), dict(k1=-0.2), dict(k1=0.05, k2=-0.01, p1=0.001, p2=-0.002, k3=0.001)]


def _both_registered(depth, T_cd, cam_d=SMALL, cam_c=SMALL):
    a = np.asarray(jax_register.register_depth_to_color(
        jnp.asarray(depth), jnp.asarray(T_cd), JaxCamera(**cam_d), JaxCamera(**cam_c), 48, 64))
    b = register.register_depth_to_color(depth, T_cd, CameraConfig(**cam_d),
                                         CameraConfig(**cam_c), 48, 64, device="cpu").numpy()
    np.testing.assert_array_equal(a > 0, b > 0)
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
    return b


def test_register_identity_roundtrip():
    rng = np.random.default_rng(0)
    depth = rng.uniform(1.0, 4.0, (48, 64)).astype(np.float32)
    depth[10:14, :] = 0.0
    out = _both_registered(depth, np.eye(4, dtype=np.float32))
    np.testing.assert_allclose(out, depth, atol=1e-5)


def test_register_translated_camera():
    depth = np.full((48, 64), 2.0, np.float32)
    T_cd = np.eye(4, dtype=np.float32)
    T_cd[0, 3] = 0.08
    out = _both_registered(depth, T_cd)
    filled = out > 0
    assert filled[:, 3:].all() and not filled[:, :2].any()
    np.testing.assert_allclose(out[filled], 2.0, atol=1e-5)


def test_register_rotated_camera_with_other_intrinsics():
    """A 2.5 cm baseline with a 1 degree yaw into a color camera of other
    intrinsics, over an invalid band: every collision and rounding as
    JAX's."""
    rng = np.random.default_rng(4)
    depth = rng.uniform(1.0, 4.0, (48, 64)).astype(np.float32)
    depth[10:14, :] = 0.0
    T_cd = se3.se3_exp(torch.tensor([0.025, 0.01, 0.0, 0.0, np.deg2rad(1.0), 0.0])).numpy()
    out = _both_registered(depth, T_cd.astype(np.float32),
                           cam_c=dict(width=64, height=48, fx=52.0, fy=51.0, cx=31.0, cy=25.0))
    assert (out > 0).sum() > 2000


def test_register_occlusion_scatter_min():
    depth = np.full((48, 64), 3.0, np.float32)
    depth[24, 32] = 1.0
    out = _both_registered(depth, np.eye(4, dtype=np.float32))
    assert out[24, 32] == 1.0


@pytest.mark.parametrize("extra", DISTORTIONS, ids=["none", "k1", "all"])
def test_undistort_matches_jax(extra):
    rng = np.random.default_rng(1)
    cam, jcam = CameraConfig(**SMALL, **extra), JaxCamera(**SMALL, **extra)
    tol = 1e-4 if not extra else 1e-3
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    out = register.undistort_image(img, cam, device="cpu").numpy()
    np.testing.assert_allclose(out, np.asarray(jax_register.undistort_image(
        jnp.asarray(img), jcam)), atol=tol, rtol=0)
    rgb = rng.integers(0, 256, (48, 64, 3)).astype(np.uint8)
    out_rgb = register.undistort_image(torch.from_numpy(rgb), cam).numpy()
    ref_rgb = np.asarray(jax_register.undistort_image(jnp.asarray(rgb), jcam))
    assert out_rgb.shape == (48, 64, 3)
    np.testing.assert_allclose(out_rgb, ref_rgb, atol=tol, rtol=0)
    if not extra:
        np.testing.assert_allclose(out, img, atol=1e-3)
        # The app's uint8 truncation: equal to JAX's on every pixel.
        np.testing.assert_array_equal(out_rgb.astype(np.uint8), ref_rgb.astype(np.uint8))


def test_undistort_straightens_radial():
    cam = CameraConfig(**SMALL, k1=-0.2)
    xn = (44 - cam.cx) / cam.fx
    uvd = camera.distort(torch.tensor([[xn, 0.0]], dtype=torch.float32), cam)
    u_dist = float(uvd[0, 0]) * cam.fx + cam.cx
    raw = np.zeros((48, 64), np.float32)
    raw[24, int(round(u_dist))] = 100.0
    out = register.undistort_image(raw, cam, device="cpu").numpy()
    assert np.argmax(out[24]) in (43, 44, 45)
    ref = np.asarray(jax_register.undistort_image(jnp.asarray(raw), JaxCamera(**SMALL, k1=-0.2)))
    np.testing.assert_allclose(out, ref, atol=1e-3, rtol=0)


def test_distort_and_intrinsics_match_jax():
    rng = np.random.default_rng(2)
    uv = rng.uniform(-0.6, 0.6, (500, 2)).astype(np.float32)
    for extra in DISTORTIONS:
        got = camera.distort(torch.from_numpy(uv), CameraConfig(**SMALL, **extra)).numpy()
        ref = np.asarray(jax_camera.distort(jnp.asarray(uv), JaxCamera(**SMALL, **extra)))
        np.testing.assert_allclose(got, ref, atol=1e-7, rtol=0)
    np.testing.assert_allclose(camera.intrinsics_matrix(CameraConfig()).numpy(),
                               np.asarray(jax_camera.intrinsics_matrix(JaxCamera())),
                               atol=1e-7, rtol=0)


@pytest.fixture(scope="module")
def cached_synthetic():
    """The app's synthetic source renders 640x480 views on the host
    (about 2 s each): both packages' copies of `SyntheticSequence` (bit-
    equal) serve one rendering of each view."""
    import orb_slam2_ssd_semantic_tpu.io.synthetic as jax_synthetic

    import orb_slam2_ssd_semantic_tpu_torch.io.synthetic as synthetic

    cache = {}
    base = synthetic.SyntheticSequence
    mp = pytest.MonkeyPatch()

    class Cached(base):
        def gray_depth(self, i):
            key = (self.n_frames, i)
            if key not in cache:
                cache[key] = base.gray_depth(self, i)
            return cache[key]

    mp.setattr(synthetic, "SyntheticSequence", Cached)
    mp.setattr(jax_synthetic, "SyntheticSequence", Cached)
    yield
    mp.undo()


def test_live_rgbd_app_synthetic_matches_jax(tmp_path, cached_synthetic):
    from orb_slam2_ssd_semantic_tpu.apps.live_rgbd import main as jax_main

    from orb_slam2_ssd_semantic_tpu_torch.apps.live_rgbd import main
    from orb_slam2_ssd_semantic_tpu_torch.io.tum import read_trajectory

    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    jax_out.mkdir()
    res = main(["--source", "synthetic", "--frames", "8", "--out", str(port_out),
                "--device", "cpu"])
    ref = jax_main(["--source", "synthetic", "--frames", "8", "--out", str(jax_out),
                    "--platform", "cpu"])
    assert len(res.system.tracker.stats) == len(ref.tracker.stats) == 8
    assert [s["status"] for s in res.system.tracker.stats] == \
        [s["status"] for s in ref.tracker.stats]
    assert sorted(p.name for p in port_out.iterdir()) == sorted(p.name for p in jax_out.iterdir())
    for name in ("CameraTrajectory.txt", "KeyFrameTrajectory.txt"):
        s, t, q = read_trajectory(str(port_out / name))
        s_j, t_j, q_j = read_trajectory(str(jax_out / name))
        np.testing.assert_array_equal(s, s_j)
        np.testing.assert_allclose(t, t_j, atol=1e-4, rtol=0)
        np.testing.assert_allclose(np.abs(np.sum(q * q_j, -1)), 1.0, atol=1e-4)
    with np.load(port_out / "map.npz") as a, np.load(jax_out / "map.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert int(a["n_kfs"]) == int(b["n_kfs"])
