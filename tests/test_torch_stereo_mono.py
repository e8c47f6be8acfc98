"""Port parity for the stereo and monocular front ends: `ops/stereo.py`,
`mapping/initializer.py`, `se3.is_rotation_matrix` and
`SlamSystem.track_stereo`/`track_monocular`, against the JAX package on
the same numpy inputs.

Gates, and why:
- `stereo_match` on JAX's features of `tests/test_stereo_mono.py`'s
  textured plane pair at 640x480: `ok` equal, depth within 1e-5
  relative (bf / disparity, one f32 division each);
- `sparse_depth_image` against JAX's `.at[flat].set(..., mode="drop")` on
  keypoints that share pixels: equal (the later keypoint wins);
- the initializer on `tests/test_initializer.py`'s two views: on JAX's
  own minimal sets the fundamental RANSAC's inliers and count equal and F
  within 1e-4 (normalized, up to sign: the 8-point null vector comes from
  another LAPACK); `reconstruct_from_F` on JAX's F and inliers: R and t
  within 1e-4, `good` equal; `initialize_monocular` on JAX's sets: the
  same success, model and count. On the port's own draws (a torch
  generator) the JAX tests' own gates;
- `track_stereo`: each image extracted once per frame (2 calls a frame,
  none in the tracker), the pose near identity on a repeated pair;
- `track_monocular` on 12 frames of the orbit at QVGA (the small twin of
  JAX's `slow` test): initialized, at least 2 keyframes, finite poses,
  the camera moved.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.frontend.extractor import extract as jextract
from orb_slam2_ssd_semantic_tpu.geometry import se3 as jse3
from orb_slam2_ssd_semantic_tpu.mapping import initializer as jinit
from orb_slam2_ssd_semantic_tpu.ops.stereo import stereo_match as jstereo
from orb_slam2_ssd_semantic_tpu_torch.frontend import extractor as tex
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3 as tse3
from orb_slam2_ssd_semantic_tpu_torch.io.device_render import render_frames
from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import orbit_trajectory
from orb_slam2_ssd_semantic_tpu_torch.mapping import initializer as tinit
from orb_slam2_ssd_semantic_tpu_torch.ops import stereo as tst
from orb_slam2_ssd_semantic_tpu_torch.system import SlamSystem as TSystem
from orb_slam2_ssd_semantic_tpu_torch.tracking import tracker as ttk
from test_initializer import two_view
from test_stereo_mono import stereo_pair, textured
from _torch_threads import _few_threads  # noqa: F401 (autouse)

JCFG = jconfig.SlamConfig()
TCFG = tconfig.SlamConfig()
CAM_T = tconfig.CameraConfig()
DEPTH_RTOL = 1e-5
GEOM_TOL = 1e-4


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def port_features(jf) -> tex.Features:
    """JAX Features as the port's (int64 levels, int32 descriptor words)."""
    return tex.Features(uv=t(jf.uv), level=t(jf.level, torch.int64), angle=t(jf.angle),
                        score=t(jf.score), desc=t(np.asarray(jf.desc).view(np.int32)),
                        valid=t(jf.valid))


@pytest.fixture(scope="module")
def plane_pair():
    left, right, disp = stereo_pair(np.random.default_rng(0), z=2.0)
    fl = jextract(jnp.asarray(left), JCFG.orb)
    fr = jextract(jnp.asarray(right), JCFG.orb)
    return left, right, disp, fl, fr


def test_stereo_match_matches_jax(plane_pair):
    _, _, disp, fl, fr = plane_pair
    jd, jur, jok = (np.asarray(a) for a in jstereo(fl, fr, JCFG.camera, JCFG.orb))
    td, tur, tok = (a.numpy() for a in tst.stereo_match(port_features(fl), port_features(fr),
                                                           TCFG.camera, TCFG.orb))
    np.testing.assert_array_equal(tok, jok)
    assert jok.sum() > 100
    np.testing.assert_allclose(td, jd, rtol=DEPTH_RTOL, atol=0)
    np.testing.assert_array_equal(tur, jur)
    z_true = TCFG.camera.bf / disp
    assert abs(np.median(td[tok]) - z_true) / z_true < 0.05


def test_sparse_depth_image_keeps_the_last_write_like_jax():
    cam = tconfig.CameraConfig(width=16, height=8)
    rng = np.random.default_rng(3)
    uv = np.concatenate([rng.uniform(-2, 18, (40, 2)), np.repeat([[3.2, 4.4]], 5, 0)])
    uv = uv.astype(np.float32)
    depth = rng.uniform(0.5, 4.0, 45).astype(np.float32)
    ok = rng.random(45) > 0.2
    x, y = np.round(uv[:, 0]).astype(np.int32), np.round(uv[:, 1]).astype(np.int32)
    oob = ~(ok & (x >= 0) & (x < cam.width) & (y >= 0) & (y < cam.height))
    flat = np.where(oob, cam.width * cam.height, y * cam.width + x)
    want = jnp.zeros(cam.width * cam.height, jnp.float32).at[jnp.asarray(flat)].set(
        jnp.asarray(np.where(ok, depth, 0.0)), mode="drop")
    got = tst.sparse_depth_image(t(uv), t(depth), t(ok), cam)
    np.testing.assert_array_equal(got.numpy().reshape(-1), np.asarray(want))
    assert len(set(flat[~oob])) < (~oob).sum()  # some keypoints do share a pixel


def _jax_sets(key, valid, n: int, size: int) -> np.ndarray:
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    keys = jax.random.split(key, n)
    return np.asarray(jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(size,)))(keys))


def _unit(F) -> np.ndarray:
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    return F * np.sign(F.flat[np.argmax(np.abs(F))])


@pytest.fixture(scope="module")
def views():
    pts, T2, uv1, uv2, inside = two_view(np.random.default_rng(5), outliers=40)
    return pts, T2, uv1, uv2, inside


def test_fundamental_ransac_on_jax_sets_matches_jax(views):
    _, _, uv1, uv2, inside = views
    key = jax.random.PRNGKey(2)
    F, inl, n = jinit.find_fundamental_ransac(jnp.asarray(uv1), jnp.asarray(uv2),
                                              jnp.asarray(inside), key)
    idx = _jax_sets(key, inside, 256, 8)
    Ft, inl_t, n_t = tinit.find_fundamental_ransac(t(uv1), t(uv2), t(inside),
                                                   idx=t(idx, torch.int64))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl))
    assert int(n_t) == int(n) > 0.6 * inside.sum()
    gap = float(np.abs(_unit(Ft.numpy()) - _unit(F)).max())
    assert gap <= GEOM_TOL, f"F differs by {gap}"


def test_reconstruct_from_jax_F_matches_jax(views):
    pts, T2, uv1, uv2, inside = views
    F, inl, _ = jinit.find_fundamental_ransac(jnp.asarray(uv1), jnp.asarray(uv2),
                                              jnp.asarray(inside), jax.random.PRNGKey(0))
    R, tt, X, good = jinit.reconstruct_from_F(F, jnp.asarray(uv1), jnp.asarray(uv2), inl,
                                              jconfig.CameraConfig())
    Rt, ttt, Xt, good_t = tinit.reconstruct_from_F(t(F), t(uv1), t(uv2), t(inl), CAM_T)
    np.testing.assert_array_equal(good_t.numpy(), np.asarray(good))
    for a, b, name in ((Rt, R, "R"), (ttt, tt, "t")):
        gap = float(np.abs(a.numpy() - np.asarray(b)).max())
        assert gap <= GEOM_TOL, f"{name} differs by {gap}"
    g = good_t.numpy()
    rel = np.abs(Xt.numpy()[g] - np.asarray(X)[g]) / np.abs(np.asarray(X)[g]).max()
    assert rel.max() < 1e-3
    np.testing.assert_allclose(Rt.numpy(), T2[:3, :3], atol=0.02)


def test_initialize_monocular_on_jax_sets_matches_jax(views):
    _, _, uv1, uv2, inside = views
    key = jax.random.PRNGKey(1)
    want = jinit.initialize_monocular(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(inside),
                                      jconfig.CameraConfig(), key)
    kH, kF = jax.random.split(key)
    got = tinit.initialize_monocular(t(uv1), t(uv2), t(inside), CAM_T,
                                     idx_H=t(_jax_sets(kH, inside, 128, 4), torch.int64),
                                     idx_F=t(_jax_sets(kF, inside, 256, 8), torch.int64))
    assert (got["success"], got["model"], got["n_good"]) == (
        want["success"], want["model"], want["n_good"])
    assert got["success"] and got["n_good"] >= 100
    np.testing.assert_array_equal(got["good"].numpy(), np.asarray(want["good"]))
    for k in ("R", "t"):
        gap = float(np.abs(got[k].numpy() - np.asarray(want[k])).max())
        assert gap <= GEOM_TOL, f"{k} differs by {gap}"


def test_initializer_on_the_ports_own_draws(views):
    """`tests/test_initializer.py`'s gates with the port's sampler."""
    pts, T2, uv1, uv2, inside = views
    F, inl, n = tinit.find_fundamental_ransac(t(uv1), t(uv2), t(inside))
    assert int(n) > 0.6 * inside.sum()
    assert inl.numpy()[:40].mean() < 0.25  # the corrupted points
    R, tt, X, good = tinit.reconstruct_from_F(F, t(uv1), t(uv2), inl, CAM_T)
    np.testing.assert_allclose(R.numpy(), T2[:3, :3], atol=0.02)
    t_true = T2[:3, 3] / np.linalg.norm(T2[:3, 3])
    assert np.linalg.norm(tt.numpy() - t_true) < 0.05
    g = good.numpy()
    scale = np.median(pts[g][:, 2] / X.numpy()[g][:, 2])
    assert np.median(np.linalg.norm(X.numpy()[g] * scale - pts[g], axis=-1)) < 0.15
    out = tinit.initialize_monocular(t(uv1), t(uv2), t(inside), CAM_T)
    assert out["success"] and out["n_good"] >= 100


def test_is_rotation_matrix_matches_jax():
    rng = np.random.default_rng(4)
    R = np.asarray(jse3.so3_exp(jnp.asarray(rng.normal(0, 1, (6, 3)).astype(np.float32))))
    Rs = np.concatenate([R, R * 1.001, R + rng.normal(0, 1e-3, R.shape).astype(np.float32)])
    for tol in (1e-4, 1e-2):
        np.testing.assert_array_equal(tse3.is_rotation_matrix(t(Rs), tol=tol).numpy(),
                                      np.asarray(jse3.is_rotation_matrix(jnp.asarray(Rs), tol)))


def test_track_stereo_extracts_each_image_once():
    """Two extractions a frame (left, right) and none in the tracker; the
    same pair again keeps the pose near identity."""
    cam = tconfig.CameraConfig(fx=211.0, fy=212.0, cx=126.0, cy=94.0, width=252, height=188,
                               bf=21.0)
    cfg = dataclasses.replace(TCFG, camera=cam, orb=tconfig.OrbConfig(n_features=300,
                                                                       max_keypoints=320))
    left = textured(np.random.default_rng(1), cam.height, cam.width)
    right = np.roll(left, -10, axis=1)
    calls = {"n": 0}
    orig = tex.extract

    def counting_extract(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tex, "extract", counting_extract)
        mp.setattr(ttk, "extract", counting_extract)
        sys_ = TSystem(cfg, device="cpu")
        sys_.track_stereo(left, right, 0.0)
        first = calls["n"]
        T1 = sys_.track_stereo(left, right, 1 / 30)
    assert (first, calls["n"] - first) == (2, 2)
    assert np.all(np.isfinite(T1)) and np.linalg.norm(T1[:3, 3]) < 0.05
    assert sys_.tracker._n_kfs >= 1 and sys_.status == "OK"


def test_track_monocular_initializes_and_tracks():
    """The small twin of `tests/test_stereo_mono.py`'s monocular test: 12
    frames of the orbit at QVGA."""
    cam = tconfig.CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=123.8, width=320, height=240)
    cfg = dataclasses.replace(TCFG, camera=cam, orb=tconfig.OrbConfig(n_features=500,
                                                                      max_keypoints=512),
                              loop=tconfig.LoopConfig(enabled=False, enable_relocalization=False))
    room = (5.0, 3.0, 6.0)
    g, _ = render_frames(orbit_trajectory(12, room=room).astype(np.float32), cam, size=room,
                         seed=17, device="cpu")
    sys_ = TSystem(cfg, device="cpu")
    poses = [sys_.track_monocular(g[i].numpy().astype(np.float32), i / 30.0) for i in range(12)]
    assert sys_.tracker.initialized
    assert sys_.tracker._n_kfs >= 2
    assert all(np.all(np.isfinite(T)) for T in poses)
    assert np.linalg.norm(poses[-1][:3, 3]) > 1e-3
    assert sys_.status in ("OK", "WEAK")
