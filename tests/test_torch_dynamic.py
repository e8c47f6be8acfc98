"""Port parity for the dynamic-environment masks: `ops/image.py`'s
gradients, box filter, bilinear sampler and morphology, `ops/homography.py`,
`ops/flow.py`, `dynamic/flowmask.py`, `dynamic/geommask.py`, and
`Tracker.process` with each mask on, against the JAX package on the same
numpy inputs.

Gates, and why:
- image ops: booleans exact, floats within 1e-5 (the same f32 operations
  in the same order; measured 0.0);
- the homography on JAX's own minimal sets: H within 1e-4 relative
  (`eigh` of AᵀA in LAPACK and XLA, measured 2.5e-5), inlier sets equal;
  with the port's generator (other sets of the same distribution) the
  inlier count within 5%;
- `_shift_warp` within 1e-5 (the JAX version's weights and order of
  summation; measured 0.0), `_lk_level` within 1e-4 px (measured 3.5e-6);
- `dense_flow` on a 160x120 shifted texture: 1e-3 px on 99.9% of pixels
  (measured: 2.9e-5 px at most; the pyramid's resize weights differ from
  XLA's by an ulp);
- the masks on QVGA frames of the dynamic scene: at most 0.5% of pixels
  differ (measured 0.0 for the flow mask on JAX's minimal sets, and for
  the geometry mask on one database); the port's own minimal sets part
  from JAX's by about 1% of pixels, which the Tracker gate below covers;
- the geometry mask's seed depth where several points land on one
  pixel: the update with the largest flat index wins, as XLA's CPU
  scatter lets the last write win;
- `Tracker.process` with `enable_flow`, and with `enable_geometry`, on 6
  QVGA frames of the dynamic scene: statuses and keyframes equal,
  positions within 1e-3 m (measured 1.2e-4 m, the port's own RANSAC
  draws included).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.dynamic import flowmask as jfm
from orb_slam2_ssd_semantic_tpu.dynamic import geommask as jgm
from orb_slam2_ssd_semantic_tpu.io.synthetic import SyntheticSequence
from orb_slam2_ssd_semantic_tpu.ops import flow as jflow
from orb_slam2_ssd_semantic_tpu.ops import homography as jh
from orb_slam2_ssd_semantic_tpu.ops import image as jimg
from orb_slam2_ssd_semantic_tpu.tracking.tracker import Tracker as JTracker
from orb_slam2_ssd_semantic_tpu_torch.dynamic import flowmask as tfm
from orb_slam2_ssd_semantic_tpu_torch.dynamic import geommask as tgm
from orb_slam2_ssd_semantic_tpu_torch.ops import flow as tflow
from orb_slam2_ssd_semantic_tpu_torch.ops import homography as th
from orb_slam2_ssd_semantic_tpu_torch.ops import image as timg
from orb_slam2_ssd_semantic_tpu_torch.tracking import tracker as ttk
from test_torch_tracker import small_config
from _torch_threads import _few_threads  # noqa: F401 (autouse)

N_FRAMES = 6
MASK_TOL = 0.005


@pytest.fixture(scope="module")
def scene():
    """QVGA frames of the dynamic scene (two moving boxes), float32 gray
    and metres, with the ground-truth world-to-camera poses."""
    cam = small_config(jconfig).camera
    seq = SyntheticSequence(n_frames=N_FRAMES, dynamic_objects=True, n_dynamic=2, cam=cam)
    frames = [seq.gray_depth(i) for i in range(N_FRAMES)]
    T_cw = [np.linalg.inv(p).astype(np.float32) for p in seq.poses_wc]
    return frames, T_cw


def t(a):
    return torch.from_numpy(np.array(a))


def jit(fn, *static):
    """A JAX function jitted whole: eager JAX dispatches (and compiles)
    every slice of these shifted-slice ops one by one. Where a float
    result is compared at 1e-5, the JAX side runs eagerly instead: XLA
    contracts the jitted sums into fused multiply-adds (2 ulp at 255)."""
    return jax.jit(fn, static_argnums=static)


def jax_minimal_sets(valid: np.ndarray, n: int = 128) -> np.ndarray:
    """JAX's draws: `categorical` over the valid rows from PRNGKey(0)."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    return np.asarray(jax.vmap(lambda k: jax.random.categorical(k, logits, shape=(4,)))(keys))


def jax_fitted_sets(prev, cur, cfg, stride: int = 8) -> np.ndarray:
    """The minimal sets JAX's `flow_dynamic_mask_fitted` draws: its grid
    correspondences' validity, then `jax_minimal_sets`."""
    h, w = cur.shape
    s = cfg.flow_downscale
    hs, ws = h // s, w // s
    f = np.asarray(jflow.dense_flow(jimg.resize_bilinear(jnp.asarray(prev), hs, ws),
                                    jimg.resize_bilinear(jnp.asarray(cur), hs, ws),
                                    levels=cfg.flow_levels, window=cfg.flow_window,
                                    iters=cfg.flow_iters))
    yy, xx = np.meshgrid(np.arange(0, hs - stride + 1, stride),
                         np.arange(0, ws - stride + 1, stride), indexing="ij")
    dst = np.stack([xx.ravel(), yy.ravel()], -1).astype(np.float32) + f[yy.ravel(), xx.ravel()]
    valid = ((dst[:, 0] >= 2) & (dst[:, 0] < ws - 2) & (dst[:, 1] >= 2) & (dst[:, 1] < hs - 2))
    return jax_minimal_sets(valid)


def textured(h, w, shift=(0.0, 0.0), seed=0):
    """A smooth random texture in [0, 255], optionally sub-pixel shifted."""
    from scipy.ndimage import gaussian_filter
    from scipy.ndimage import shift as nd_shift

    base = gaussian_filter(np.random.default_rng(seed).random((h, w)), 2.0)
    base = (base - base.min()) / (base.max() - base.min()) * 255.0
    return nd_shift(base, shift, mode="nearest").astype(np.float32)


# ---- image ops ---------------------------------------------------------------

def test_sobel_box_filter_and_bilinear_sample_match_jax():
    rng = np.random.default_rng(1)
    img = (rng.random((48, 64)) * 255).astype(np.float32)
    for a, b in zip(jimg.sobel(jnp.asarray(img)), timg.sobel(t(img))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)
    np.testing.assert_allclose(timg.box_filter(t(img), 9).numpy(),
                               np.asarray(jimg.box_filter(jnp.asarray(img), 9)), atol=1e-5, rtol=0)
    stack = np.stack([img, img[::-1].copy(), img * 0.5])
    np.testing.assert_allclose(timg.box_filter(t(stack), 9).numpy(),
                               np.asarray(jflow._box_filter_batch(jnp.asarray(stack), 9)),
                               atol=1e-5, rtol=0)
    uv = (rng.random((500, 2)) * [70, 55] - 3).astype(np.float32)
    a, av = jimg.bilinear_sample(jnp.asarray(img), jnp.asarray(uv), fill=-1.0)
    b, bv = timg.bilinear_sample(t(img), t(uv), fill=-1.0)
    np.testing.assert_array_equal(bv.numpy(), np.asarray(av))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, rtol=0)


@pytest.mark.parametrize("ksize", [3, 7, 10, 21])
def test_erode_and_dilate_match_jax(ksize):
    """10 gives the flow mask's 9 x 9 ellipse."""
    m = np.random.default_rng(ksize).random((48, 64)) > 0.3
    for iters in (1, 2):
        np.testing.assert_array_equal(
            timg.erode(t(m), ksize, iters).numpy(),
            np.asarray(jit(jimg.erode, 1, 2)(jnp.asarray(m), ksize, iters)))
        np.testing.assert_array_equal(
            timg.dilate(t(~m), ksize, iters).numpy(),
            np.asarray(jit(jimg.dilate, 1, 2)(jnp.asarray(~m), ksize, iters)))


# ---- homography ----------------------------------------------------------------

def _correspondences(n=200, seed=0):
    rng = np.random.default_rng(seed)
    src = (rng.random((n, 2)) * [160, 120]).astype(np.float32)
    H = np.array([[1.01, 0.02, 3.0], [-0.01, 0.99, -2.0], [1e-4, -5e-5, 1.0]], np.float32)
    ph = np.c_[src, np.ones(n)] @ H.T
    dst = (ph[:, :2] / ph[:, 2:]).astype(np.float32)
    dst[:50] += rng.standard_normal((50, 2)).astype(np.float32) * 10.0
    dst[50:] += rng.standard_normal((n - 50, 2)).astype(np.float32) * 0.3
    return src, dst, rng.random(n) > 0.1


def test_dlt_matches_jax():
    """On Hartley-normalised points, as RANSAC calls it (on raw pixels AᵀA
    is too ill-conditioned in f32 for two `eigh`s to agree), with the
    outliers weighted down; the normalisation against JAX's too."""
    src, dst, valid = _correspondences(seed=3)
    sn_j, Ts_j = jit(jh._normalize)(jnp.asarray(src), jnp.asarray(valid, jnp.float32))
    dn_j, _ = jit(jh._normalize)(jnp.asarray(dst), jnp.asarray(valid, jnp.float32))
    sn, Ts = th._normalize(t(src), t(valid).float())
    dn, _ = th._normalize(t(dst), t(valid).float())
    np.testing.assert_allclose(sn.numpy(), np.asarray(sn_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(Ts.numpy(), np.asarray(Ts_j), atol=1e-5, rtol=1e-6)
    w = np.where(np.arange(len(src)) < 50, 0.05, 1.0).astype(np.float32)
    a = np.asarray(jit(jh._dlt)(sn_j, dn_j, jnp.asarray(w)))
    b = th._dlt(sn, dn, t(w)).numpy()
    assert np.abs(a - b).max() <= 1e-4 * np.abs(a).max()


def test_ransac_on_jax_minimal_sets_matches_jax():
    src, dst, valid = _correspondences()
    Hj, inl_j, n_j = jh.find_homography_ransac(jnp.asarray(src), jnp.asarray(dst),
                                               jnp.asarray(valid), jax.random.PRNGKey(0),
                                               threshold=2.0)
    Ht, inl_t, n_t = th.find_homography_ransac(t(src), t(dst), t(valid),
                                               idx=t(jax_minimal_sets(valid)).long(),
                                               threshold=2.0)
    Hj = np.asarray(Hj)
    assert np.abs(Ht.numpy() - Hj).max() <= 1e-4 * np.abs(Hj).max()
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) >= 100


def test_ransac_with_the_port_generator():
    """Other minimal sets of the same distribution: the inlier count within
    5% of JAX's; the sets are valid rows only, and the same every call."""
    src, dst, valid = _correspondences(seed=1)
    _, _, n_j = jh.find_homography_ransac(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
                                          jax.random.PRNGKey(0), threshold=2.0)
    _, _, n_t = th.find_homography_ransac(t(src), t(dst), t(valid), threshold=2.0)
    assert abs(int(n_t) - int(n_j)) <= 0.05 * int(n_j)
    idx = th.sample_minimal_sets(t(valid))
    assert idx.shape == (128, 4) and valid[idx.numpy()].all()
    assert torch.equal(idx, th.sample_minimal_sets(t(valid)))
    assert len(np.unique(idx.numpy())) > 0.5 * valid.sum()


# ---- flow ----------------------------------------------------------------------

def test_shift_warp_and_lk_level_match_jax():
    rng = np.random.default_rng(2)
    img = textured(48, 64, seed=2)
    res = (rng.standard_normal((48, 64, 2)) * 3).astype(np.float32)  # clipped at r_max = 4
    np.testing.assert_allclose(tflow._shift_warp(t(img), t(res), 4).numpy(),
                               np.asarray(jflow._shift_warp(jnp.asarray(img), jnp.asarray(res), 4)),
                               atol=1e-5, rtol=0)
    cur = textured(48, 64, shift=(1.3, -2.1), seed=2)
    flow0 = (rng.standard_normal((48, 64, 2)) * 0.5).astype(np.float32)
    for base_warp in (True, False):
        a = jit(jflow._lk_level, 3, 4, 5, 6, 7)(jnp.asarray(img), jnp.asarray(cur),
                                                jnp.asarray(flow0), 9, 5, 1e-4, 4, base_warp)
        b = tflow._lk_level(t(img), t(cur), t(flow0), 9, 5, base_warp=base_warp)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-4, rtol=0)


def test_dense_flow_matches_jax():
    prev = textured(120, 160, seed=4)
    cur = textured(120, 160, shift=(1.3, 2.1), seed=4)
    a = np.asarray(jflow.dense_flow(jnp.asarray(prev), jnp.asarray(cur)))
    b = tflow.dense_flow(t(prev), t(cur)).numpy()
    assert b.shape == (120, 160, 2)
    d = np.abs(a - b).max(-1)
    assert (d <= 1e-3).mean() >= 0.999, (d.max(), np.quantile(d, 0.999))
    np.testing.assert_allclose(tflow.flow_magnitude_sq(t(a)).numpy(),
                               np.asarray(jflow.flow_magnitude_sq(jnp.asarray(a))), rtol=1e-6)


# ---- masks ---------------------------------------------------------------------

def test_flow_masks_match_jax(scene):
    frames, _ = scene
    jcfg, tcfg = jconfig.DynamicConfig(), tconfig.DynamicConfig()
    dynamic_px = 0
    for i in (1, 2):
        prev, cur = frames[i - 1][0], frames[i][0]
        idx = t(jax_fitted_sets(prev, cur, jcfg)).long()
        a = np.asarray(jfm.flow_dynamic_mask_fitted(jnp.asarray(prev), jnp.asarray(cur), jcfg))
        b = tfm.flow_dynamic_mask_fitted(t(prev), t(cur), tcfg, idx=idx).numpy()
        assert b.shape == a.shape and b.dtype == bool
        assert (a != b).mean() <= MASK_TOL
        dynamic_px += (~a).sum()
    assert dynamic_px > 0, "no dynamic pixel in either frame: vacuous"
    H = np.array([[1.0, 0.01, 2.0], [-0.01, 1.0, -1.0], [0.0, 0.0, 1.0]], np.float32)
    a = np.asarray(jfm.flow_dynamic_mask(jnp.asarray(frames[1][0]), jnp.asarray(frames[2][0]),
                                         jcfg, homography=jnp.asarray(H)))
    b = tfm.flow_dynamic_mask(t(frames[1][0]), t(frames[2][0]), tcfg, homography=t(H)).numpy()
    assert (a != b).mean() <= MASK_TOL
    assert float(tfm.static_area_fraction(t(b))) == pytest.approx(
        float(jfm.static_area_fraction(jnp.asarray(b))), abs=1e-7)


def _views(scene, slots=(0, 2, 4), K=512, seed=0):
    """A view ring of ground-truth keyframe poses and random keypoints
    with their rendered depth, in both packages."""
    frames, T_cw = scene
    rng = np.random.default_rng(seed)
    jdb, tdb = jgm.empty_ref_views(20, K), tgm.empty_ref_views(20, K)
    for i in slots:
        uv = (rng.random((K, 2)) * [319, 239]).astype(np.float32)
        d = frames[i][1][np.round(uv[:, 1]).astype(int), np.round(uv[:, 0]).astype(int)]
        kv = rng.random(K) > 0.1
        jdb = jgm.insert_ref_view(jdb, *(jnp.asarray(x) for x in (T_cw[i], uv, d, kv)))
        tdb = tgm.insert_ref_view(tdb, *(t(x) for x in (T_cw[i], uv, d, kv)))
    return jdb, tdb


def test_geometry_mask_matches_jax(scene):
    frames, T_cw = scene
    jdb, tdb = _views(scene)
    cam_j, cam_t = small_config(jconfig).camera, small_config(tconfig).camera
    dynamic_px = 0
    for i in (3, 5):
        a = np.asarray(jgm.geometry_dynamic_mask(jdb, jnp.asarray(T_cw[i]),
                                                 jnp.asarray(frames[i][1]), cam_j,
                                                 jconfig.DynamicConfig()))
        b = tgm.geometry_dynamic_mask(tdb, t(T_cw[i]), t(frames[i][1]), cam_t,
                                      tconfig.DynamicConfig()).numpy()
        assert (a != b).mean() <= 0.001
        dynamic_px += (~a).sum()
    assert dynamic_px > 0, "no dynamic pixel: vacuous"


def test_seed_depth_collision_matches_jax(scene):
    """Collisions of the seed-depth scatter. Directly: ten updates aimed at
    three pixels with distinct values, against `.at[].set` in XLA on the
    CPU (the last write wins). In the mask: the same view inserted twice
    sends every dynamic point to its pixel twice."""
    idx = np.array([5, 7, 5, 2, 7, 7, 11, 5, 2, 40])
    keep = np.array([1, 1, 1, 1, 1, 0, 1, 1, 1, 1], bool)
    vals = np.arange(10, dtype=np.float32) + 0.5
    n = 16
    jidx = np.where(keep, idx, n)
    want = np.asarray(jnp.zeros(n, jnp.float32).at[jnp.asarray(jidx)].set(jnp.asarray(vals),
                                                                       mode="drop"))
    got, hit = tgm.last_write_wins(t(idx), t(keep), t(vals), n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(hit.numpy(), np.isin(np.arange(n), jidx))

    frames, T_cw = scene
    jdb, tdb = _views(scene, slots=(0, 0, 2))
    cam_j, cam_t = small_config(jconfig).camera, small_config(tconfig).camera
    a = np.asarray(jgm.geometry_dynamic_mask(jdb, jnp.asarray(T_cw[4]), jnp.asarray(frames[4][1]),
                                             cam_j, jconfig.DynamicConfig()))
    b = tgm.geometry_dynamic_mask(tdb, t(T_cw[4]), t(frames[4][1]), cam_t,
                                  tconfig.DynamicConfig()).numpy()
    assert (~a).any() and (a != b).mean() <= 0.001


def test_insert_ref_view_ring_and_cursor():
    """22 inserts into a ring of 20: the last two overwrite slots 0 and 1,
    the cursor counts on, and no insert writes into its input."""
    D, K = 20, 8
    jdb, tdb = jgm.empty_ref_views(D, K), tgm.empty_ref_views(D, K)
    for n in range(22):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = n
        uv = np.full((K, 2), n, np.float32)
        d = np.full((K,), n + 0.5, np.float32)
        kv = np.arange(K) < n % K
        before = tgm.GeomRefViews(**{k: v.clone() for k, v in vars(tdb).items()})
        jdb = jgm.insert_ref_view(jdb, *(jnp.asarray(x) for x in (T, uv, d, kv)))
        new = tgm.insert_ref_view(tdb, *(t(x) for x in (T, uv, d, kv)))
        assert all(torch.equal(getattr(tdb, k), getattr(before, k)) for k in vars(tdb))
        tdb = new
    for k in vars(tdb):
        np.testing.assert_array_equal(getattr(tdb, k).numpy(), np.asarray(getattr(jdb, k)))
    assert int(tdb.cursor) == 22 and bool(tdb.valid.all())
    assert tdb.T_cw[0, 0, 3] == 20 and tdb.T_cw[1, 0, 3] == 21 and tdb.T_cw[2, 0, 3] == 2


def test_frame_mask_and_static_area_guard():
    """Keypoints on dynamic pixels are dropped; a mask with less than
    `min_static_area` static leaves every keypoint (Frame.cc:357-374)."""
    cfg = small_config(tconfig)
    K = 6
    uv = torch.tensor([[10.0, 10.0], [200.0, 100.0], [300.0, 200.0], [50.0, 220.0],
                       [160.0, 120.0], [0.0, 0.0]])
    feats = SimpleFeatures(uv=uv, valid=torch.tensor([True] * 5 + [False]),
                           level=torch.zeros(K, dtype=torch.int64))
    depth = torch.full((240, 320), 2.0)
    mask = torch.ones((240, 320), dtype=torch.bool)
    mask[90:130, 150:210] = False  # keypoints 1 and 4
    f = ttk.frame_from_features(feats, depth, cfg, mask)
    assert f.feats.valid.tolist() == [True, False, True, True, False, False]
    mostly_dynamic = torch.zeros((240, 320), dtype=torch.bool)
    mostly_dynamic[:, :100] = True  # 31% static, under the 65% floor
    f = ttk.frame_from_features(feats, depth, cfg, mostly_dynamic)
    assert f.feats.valid.tolist() == [True] * 5 + [False]


@dataclasses.dataclass
class SimpleFeatures:
    uv: torch.Tensor
    valid: torch.Tensor
    level: torch.Tensor


# ---- Tracker.process with masks -------------------------------------------------

@pytest.mark.parametrize("mask", ["flow", "geometry"])
def test_tracker_with_mask_matches_jax(scene, mask):
    frames, _ = scene

    def cfg(mod):
        c = small_config(mod)
        return dataclasses.replace(c, dynamic=dataclasses.replace(
            c.dynamic, enable_flow=mask == "flow", enable_geometry=mask == "geometry"))

    runs = {}
    for name, tracker in (("jax", JTracker(cfg(jconfig))),
                          ("torch", ttk.Tracker(cfg(tconfig), device="cpu"))):
        for i, (gray, depth) in enumerate(frames):
            tracker.process(gray, depth, float(i))
        runs[name] = tracker
    tj, tt = runs["jax"], runs["torch"]
    assert tt.metrics.stages[f"mask.{mask}"].count == N_FRAMES - 1
    assert [s["status"] for s in tt.stats] == [s["status"] for s in tj.stats]
    assert [s["kfs"] for s in tt.stats] == [s["kfs"] for s in tj.stats]
    assert tt.stats[-1]["kfs"] >= 2
    if mask == "geometry":
        assert int(tt.geom_db.cursor) == int(tj.geom_db.cursor) >= 1
    d = np.linalg.norm(tj.camera_positions() - tt.camera_positions(), axis=1)
    assert d.max() < 1e-3, d
