"""Port parity for the semantic consumers: `semantic/fusion.py` (both
schemes), `semantic/object_db.py` and `system.SlamSystem` with
`enable_semantics`, against the JAX package on the same numpy inputs.

Gates, and why:
- fusion on one QVGA keyframe of the flat-box scene (box 0 a flat gray
  band, `tests/test_semantic.py`'s scene) with 32 scripted detections:
  `segment_objects` labels and every boolean equal on every pixel (the
  same f32 operations in the same order, `jnp.roll`'s wrap included);
  normals within 1e-6; sizes (extremes, exact) and MergeSG's centroids
  (sums in the same order) within 1e-5 m; the depth window's centroids
  within 1e-4 m: there JAX's f32 sum over a box's thousands of pixels
  lies 5.2e-5 m from a float64 sum of the same pixels, the port's
  product 2.9e-6 m (measured on this scene);
- `add_objects` over a scripted stream (merge, append, class separation,
  invalid candidates, a full database) exactly equal, column by column;
- `save_db`/`load_db` across the two packages: every column and dtype;
- `test_semantic.py::test_merge_sg_scheme_selectable_in_engine`'s
  keyframe through the port's `SlamSystem._on_new_keyframe` with the
  trained 21-class checkpoint: the same database as JAX's (count and
  classes equal, centroids and sizes within 1e-5 m), and that test's gate;
- `SlamSystem.track_rgbd` on 6 frames of the flat-box orbit at 160x120
  with semantics on: the same keyframes, statuses, poses within 1e-4 m,
  and the same database (centroids within 1e-4 m: tracked poses, then
  fusion); the score gates are 0 so the boxes reach fusion.

JAX's `Detector` is built with its parameters made under `jax.jit` (the
same draws as eager; see `tests/test_torch_ssdlite.py`).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.semantic import detector as jdet
from orb_slam2_ssd_semantic_tpu.semantic import fusion as jfu
from orb_slam2_ssd_semantic_tpu.semantic import object_db as jdb
from orb_slam2_ssd_semantic_tpu.system import SlamSystem as JSystem
from orb_slam2_ssd_semantic_tpu_torch.io.device_render import render_frames
from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import _default_boxes, orbit_trajectory
from orb_slam2_ssd_semantic_tpu_torch.semantic import detector as tdet
from orb_slam2_ssd_semantic_tpu_torch.semantic import fusion as tfu
from orb_slam2_ssd_semantic_tpu_torch.semantic import object_db as tdb
from orb_slam2_ssd_semantic_tpu_torch.system import SlamSystem as TSystem
from test_torch_ssdlite import jit_init_ssdlite
from _torch_threads import _few_threads  # noqa: F401 (autouse)

ROOM = (5.0, 3.0, 6.0)
FLAT_BOX = (161.5, -1.0, -1.0, -1.0, -1.0, -1.0)  # box 0: class 2's gray band
M_TOL = 1e-5


def _qvga(mod):
    return mod.CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=123.8, width=320, height=240)


def _project_box(box, T_cw, cam):
    """Pixel bbox of a world AABB's corners."""
    lo, hi = np.asarray(box, np.float32)
    corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])], np.float32)
    pc = corners @ T_cw[:3, :3].T + T_cw[:3, 3]
    u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
    v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
    return np.array([u.min(), v.min(), u.max(), v.max()], np.float32)


@pytest.fixture(scope="module")
def keyframe():
    """One QVGA keyframe of the flat-box scene and 32 scripted detections:
    the flat box's projected bbox (and jittered copies), random boxes with
    random scores, classes and validity."""
    cam = _qvga(tconfig)
    pose = orbit_trajectory(1, room=ROOM)[0]
    g, d = render_frames(pose[None], cam, size=ROOM, seed=17, box_gray=FLAT_BOX, device="cpu")
    depth = d[0].numpy().astype(np.float32) * 1e-3
    T_cw = np.linalg.inv(pose).astype(np.float32)
    rng = np.random.default_rng(5)
    D = 32
    xy = rng.uniform(0, 260, (D, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(20, 120, (D, 2))], 1).astype(np.float32)
    boxes[0] = _project_box(_default_boxes(ROOM)[0], T_cw, cam)
    boxes[1:4] = boxes[0] + rng.uniform(-6, 6, (3, 4)).astype(np.float32)
    scores = rng.uniform(0.3, 1.0, D).astype(np.float32)
    scores[0] = 0.9
    classes = rng.integers(1, 21, D).astype(np.int32)
    classes[:4] = 2
    valid = rng.uniform(size=D) < 0.8
    valid[0] = True
    det = (boxes, scores, classes, valid)
    return cam, depth, T_cw, det


def _run(fn_name, keyframe):
    cam, depth, T_cw, det = keyframe
    jcam = _qvga(jconfig)
    jd = jdet.Detections(*(jnp.asarray(a) for a in det))
    td = tdet.Detections(*(torch.from_numpy(a) for a in det))
    jD, tD, jT, tT = jnp.asarray(depth), torch.from_numpy(depth), jnp.asarray(T_cw), \
        torch.from_numpy(T_cw)
    if fn_name == "estimate_normals":
        return jfu.estimate_normals(jD, jcam), tfu.estimate_normals(tD, cam)
    if fn_name == "segment_planes":
        return jfu.segment_planes(jD, jcam), tfu.segment_planes(tD, cam)
    if fn_name == "segment_objects":
        return (jfu.segment_objects(jD, jcam, jconfig.SemanticConfig()),
                tfu.segment_objects(tD, cam, tconfig.SemanticConfig()))
    jfn, tfn = getattr(jfu, fn_name), getattr(tfu, fn_name)
    return (jfn(jd, jD, jT, jcam, jconfig.SemanticConfig()),
            tfn(td, tD, tT, cam, tconfig.SemanticConfig()))


@pytest.mark.parametrize("fn_name", ["fuse_depth_window", "estimate_normals", "segment_planes",
                                     "segment_objects", "fuse_segmentation"])
def test_fusion_matches_jax(keyframe, fn_name):
    want, got = _run(fn_name, keyframe)
    if fn_name == "segment_objects":
        want, got = (want,), (got,)
    for i, (w, g) in enumerate(zip(want, got)):
        w, g = np.asarray(w), g.numpy()
        assert w.shape == g.shape, (fn_name, i)
        if w.dtype == np.float32:
            tol = {"estimate_normals": 1e-6}.get(fn_name, M_TOL)
            if fn_name == "fuse_depth_window" and i == 0:
                tol = 1e-4  # JAX's f32 sum of the centroids (module docstring)
            gap = float(np.abs(g - w).max())
            assert gap <= tol, f"{fn_name} output {i} differs by {gap} > {tol}"
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{fn_name} output {i}")
    if fn_name == "segment_objects":
        labels = got[0].numpy()
        assert (labels >= 0).sum() > 1000 and len(np.unique(labels[labels >= 0])) >= 2
    if fn_name.startswith("fuse_"):
        assert bool(got[4][0]) and 0 < int(got[4].sum()) < 32  # box 0 fused, not all


def _stream(rng):
    """Batches of candidates: merges within the radius, appends beyond it,
    two classes at one spot, invalid candidates, and more appends than a
    database of 6 rows holds."""
    base = np.array([[1.0, 0.0, 2.0], [1.02, 0.0, 2.0], [4.0, 0.0, 2.0], [1.0, 0.0, 2.0],
                     [1.01, 0.01, 2.0], [8.0, 1.0, 1.0], [1.0, 0.0, 2.04]], np.float32)
    cls = np.array([9, 9, 9, 15, 5, 20, 5], np.int32)  # chair, person, bottle, tvmonitor
    ok = np.array([True, True, True, True, True, False, True])
    batches = [(base, cls, ok)]
    for _ in range(3):
        c = rng.uniform(-3, 3, (8, 3)).astype(np.float32)
        c[:3] = base[:3] + rng.normal(0, 0.05, (3, 3)).astype(np.float32)
        batches.append((c, rng.integers(0, 21, 8).astype(np.int32), rng.uniform(size=8) < 0.85))
    out = []
    for c, k, v in batches:
        n = len(c)
        out.append((c, rng.uniform(0.1, 0.5, (n, 3)).astype(np.float32),
                    rng.uniform(0.5, 1.0, n).astype(np.float32), k, v))
    return out


def _db_columns(db) -> dict:
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
            for k, v in db._asdict().items()}


def test_add_objects_matches_jax_exactly():
    rng = np.random.default_rng(6)
    for cap in (16, 6):
        jd, td = jdb.empty_db(cap), tdb.empty_db(cap, "cpu")
        for batch in _stream(rng):
            jd = jdb.add_objects(jd, *(jnp.asarray(a) for a in batch))
            td = tdb.add_objects(td, *(torch.from_numpy(a) for a in batch))
            want, got = _db_columns(jd), _db_columns(td)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} (capacity {cap})")
        assert tdb.summarize(td) == jdb.summarize(jd)
    assert int(td.cursor) == 6 and bool(td.valid.all())  # the small one filled up
    first = tdb.add_objects(tdb.empty_db(16, "cpu"), *(torch.from_numpy(a)
                                                        for a in _stream(rng)[0]))
    # chair merged twice at 1.0-1.02 m, person apart, the two bottles 4 cm
    # apart (radius 0.06) merged, the invalid tvmonitor dropped.
    assert int(first.cursor) == 4 and first.n_merged[:4].tolist() == [2, 1, 1, 2]


def test_object_db_save_load_across_packages(tmp_path):
    rng = np.random.default_rng(7)
    batch = _stream(rng)[1]
    jd = jdb.add_objects(jdb.empty_db(8), *(jnp.asarray(a) for a in batch))
    td = tdb.add_objects(tdb.empty_db(8, "cpu"), *(torch.from_numpy(a) for a in batch))
    p_t, p_j = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tdb.save_db(p_t, td)
    jdb.save_db(p_j, jd)
    for a, b in ((jdb.load_db(p_t), td), (tdb.load_db(p_j, "cpu"), jd)):
        want, got = _db_columns(b), _db_columns(a)
        for k in want:
            assert np.asarray(got[k]).dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    txt = str(tmp_path / "objectD.txt")
    tdb.save_objects_txt(txt, tdb.load_db(p_j, "cpu"))
    lines = open(txt).read().strip().splitlines()
    assert len(lines) == int(td.cursor) and lines[0].split()[0] == tdb.summarize(td)[0]["class"]


def _jax_system(cfg, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdet, "init_ssdlite", jit_init_ssdlite)
        return JSystem(cfg, enable_semantics=True, **kw)


def _assert_same_db(t_db, j_db, tol):
    want, got = _db_columns(j_db), _db_columns(t_db)
    for k in ("class_id", "n_merged", "valid", "cursor"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("centroid", "size", "prob"):
        gap = float(np.abs(got[k] - want[k]).max())
        assert gap <= tol, f"object {k}s differ by {gap} > {tol}"


def test_merge_sg_engine_matches_jax():
    def cfg_of(mod):
        base = mod.SlamConfig()
        return dataclasses.replace(base, semantic=dataclasses.replace(
            base.semantic, fusion_scheme="merge_sg"))

    pose = orbit_trajectory(1, room=ROOM)
    g, d = render_frames(pose, tconfig.CameraConfig(), size=ROOM, seed=17, box_gray=FLAT_BOX,
                         device="cpu")
    rgb = np.repeat(g[0].numpy()[..., None], 3, -1)
    depth = d[0].numpy().astype(np.float32) * 1e-3
    T_cw = np.linalg.inv(pose[0]).astype(np.float32)
    js = _jax_system(cfg_of(jconfig))
    ts = TSystem(cfg_of(tconfig), enable_semantics=True, device="cpu")
    js._on_new_keyframe(rgb, depth, T_cw)
    ts._on_new_keyframe(rgb, depth, T_cw)
    objs = ts.objects()
    assert objs, "merge_sg engine fusion produced no objects"
    _assert_same_db(ts.object_db, js.object_db, M_TOL)
    cen = np.asarray([o["centroid"] for o in objs])
    lo = np.array([1.1, 0.6, 4.6]) - 0.4
    hi = np.array([2.1, 1.5, 6.0]) + 0.4
    assert any(((c >= lo) & (c <= hi)).all() for c in cen), cen


N_FRAMES = 6


def _small_sem(mod):
    base = mod.SlamConfig()
    return dataclasses.replace(
        base,
        camera=mod.CameraConfig(fx=134.0, fy=134.0, cx=80.0, cy=60.0, width=160, height=120),
        orb=mod.OrbConfig(n_features=100, max_keypoints=128),
        tracking=dataclasses.replace(base.tracking, max_frames_between_kfs=2),
        loop=dataclasses.replace(base.loop, enabled=False, enable_relocalization=False),
        semantic=dataclasses.replace(base.semantic, det_score_threshold=0.0,
                                     fusion_prob_threshold=0.0),
    )


@pytest.fixture(scope="module")
def small_runs():
    """6 frames of the flat-box orbit at 160x120 through both packages'
    `SlamSystem.track_rgbd` with semantics on (gray frames, uint16 depth)."""
    poses = orbit_trajectory(N_FRAMES, room=ROOM)
    g, d = render_frames(poses, _small_sem(tconfig).camera, size=ROOM, seed=17,
                         box_gray=FLAT_BOX, device="cpu")
    frames = [(g[i].numpy(), d[i].numpy()) for i in range(N_FRAMES)]
    js = _jax_system(_small_sem(jconfig))
    ts = TSystem(_small_sem(tconfig), enable_semantics=True, device="cpu")
    for sys_ in (js, ts):
        for i, (gray, depth) in enumerate(frames):
            sys_.track_rgbd(gray, depth, float(i) / 30.0)
    return js, ts


def _kf_frames(tracker):
    return [i for i in range(1, len(tracker.stats))
            if tracker.stats[i]["kfs"] != tracker.stats[i - 1]["kfs"]]


def test_track_rgbd_with_semantics_matches_jax(small_runs):
    js, ts = small_runs
    assert [s["status"] for s in ts.tracker.stats] == [s["status"] for s in js.tracker.stats]
    kfs = _kf_frames(ts.tracker)
    assert kfs == _kf_frames(js.tracker) and len(kfs) >= 1
    gap = float(np.abs(ts.tracker.camera_positions() - js.tracker.camera_positions()).max())
    assert gap <= 1e-4, f"positions differ by {gap} m > 1e-4"
    assert not ts._det_queue and not js._det_queue
    assert int(ts.object_db.cursor) > 0
    _assert_same_db(ts.object_db, js.object_db, 1e-4)


def test_slam_system_outputs(small_runs, tmp_path):
    from orb_slam2_ssd_semantic_tpu_torch.io.tum import read_trajectory

    _, ts = small_runs
    assert ts.status in ("OK", "WEAK")
    p = str(tmp_path / "objects.npz")
    ts.save_objects(p)
    n = int(ts.object_db.cursor)
    assert len(open(p + ".txt").read().strip().splitlines()) == n == len(ts.objects())
    ts.save_trajectory_tum(str(tmp_path / "traj.txt"))
    ts.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    ts.save_trajectory_kitti(str(tmp_path / "kitti.txt"))
    assert len(read_trajectory(str(tmp_path / "traj.txt"))[0]) == N_FRAMES
    assert 1 <= len(read_trajectory(str(tmp_path / "kf.txt"))[0]) <= N_FRAMES
    assert len(open(tmp_path / "kitti.txt").readlines()) == N_FRAMES
    ts.activate_localization_mode()
    assert ts.localization_only
    ts.deactivate_localization_mode()
    saved = ts.object_db
    ts.reset()
    assert not ts.tracker.initialized and int(ts.object_db.cursor) == 0
    ts.load_objects(p)
    _assert_same_db(ts.object_db, saved, 0.0)
