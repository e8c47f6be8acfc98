"""The port's command-line apps (`apps/*`) and `utils/profiling.py`, every
app given `--device cpu` (their default, the card, raises here).

Gates, and why:
- `run_synthetic.track` on 4 QVGA frames: the poses of `Tracker.process`
  on the same frames, exactly (one code path);
- `rgbd_tum.main` on a 6-frame QVGA TUM directory (PNGs, `associate.txt`,
  `groundtruth.txt`) with a JSON settings file: both trajectory files
  equal to those of a direct `SlamSystem` run on the same frames, in the
  line format of JAX's writer, every frame OK and the ATE under 1 cm;
- `detect_locate.main` with both fusion schemes on 2 QVGA npy frames and
  the in-repo 4-class checkpoint: the database of the library calls;
- `cloud_to_occupancy.main` on a cloud of two and a half chunks: the
  JAX app's file, log-odds equal on every voxel (each chunk is one
  update);
- `train_vocabulary.build_tree` and `tfidf`: JAX's tree and weights on
  the same descriptors, exactly;
- `train_ssdlite.main --steps 10 --batch 2 --classes 4`: an npz that
  JAX's `load_params` reads with every key and shape;
- `profiling.trace` writes a Chrome trace holding an `annotate` label.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, SemanticConfig, SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import SyntheticSequence
from _torch_threads import _few_threads  # noqa: F401 (autouse)

CKPT4 = os.path.join(os.path.dirname(__file__), "..", "checkpoints", "ssdlite_synthetic.npz")
QVGA = CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=123.8, width=320, height=240,
                    th_depth=80.0)


def qvga_config() -> SlamConfig:
    from orb_slam2_ssd_semantic_tpu_torch.config import OrbConfig

    base = SlamConfig()
    return SlamConfig(camera=QVGA, orb=OrbConfig(n_features=500, max_keypoints=512),
                      tracking=dataclasses.replace(base.tracking, max_frames_between_kfs=2),
                      loop=dataclasses.replace(base.loop, enabled=False,
                                               enable_relocalization=False))


@pytest.fixture(scope="module")
def qvga_seq():
    seq = SyntheticSequence(n_frames=6, cam=QVGA)
    return seq, [seq.gray_depth(i) for i in range(len(seq))]


def test_run_synthetic_track_equals_tracker_process(qvga_seq):
    from orb_slam2_ssd_semantic_tpu_torch.apps import run_synthetic
    from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker

    seq, frames = qvga_seq
    cfg = qvga_config()
    tracker, poses, times = run_synthetic.track(
        ((g, d, seq.stamps[i]) for i, (g, d) in enumerate(frames[:4])), cfg, "cpu",
        log=lambda s: None)
    ref = Tracker(cfg, device="cpu")
    ref_poses = [ref.process(g, d, float(seq.stamps[i])) for i, (g, d) in enumerate(frames[:4])]
    assert len(times) == 4
    np.testing.assert_array_equal(poses, np.stack(ref_poses))
    assert [s["status"] for s in tracker.stats] == [s["status"] for s in ref.stats]
    np.testing.assert_array_equal(tracker.camera_positions(), ref.camera_positions())


@pytest.fixture(scope="module")
def tum_dir(qvga_seq, tmp_path_factory):
    """The 6 QVGA frames as a TUM sequence: RGB and 16-bit depth PNGs at
    factor 5000, `associate.txt` and `groundtruth.txt`, and a JSON
    settings file of the QVGA config."""
    from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
    from orb_slam2_ssd_semantic_tpu_torch.io.tum import write_trajectory

    seq, frames = qvga_seq
    root = tmp_path_factory.mktemp("tum_qvga")
    os.makedirs(root / "rgb")
    os.makedirs(root / "depth")
    lines = []
    for i, (g, d) in enumerate(frames):
        t = f"{seq.stamps[i]:.6f}"
        rgb = np.repeat(np.clip(g, 0, 255).astype(np.uint8)[..., None], 3, axis=-1)
        Image.fromarray(rgb).save(root / "rgb" / f"{t}.png")
        Image.fromarray(np.round(d * 5000.0).astype(np.uint16)).save(
            root / "depth" / f"{t}.png")
        lines.append(f"{t} rgb/{t}.png {t} depth/{t}.png")
    (root / "associate.txt").write_text("\n".join(lines) + "\n")
    T_wc = seq.poses_wc[:len(frames)]
    qs = [se3.rot_to_quat(torch.from_numpy(np.ascontiguousarray(T[:3, :3]))).numpy()
          for T in T_wc]
    write_trajectory(str(root / "groundtruth.txt"), seq.stamps[:len(frames)],
                     T_wc[:, :3, 3], qs)
    (root / "settings.json").write_text(qvga_config().to_json())
    return root


def test_rgbd_tum_writes_the_trajectories_of_a_direct_run(tum_dir, tmp_path):
    from orb_slam2_ssd_semantic_tpu.io.tum import write_trajectory as jax_write
    from orb_slam2_ssd_semantic_tpu_torch.apps import rgbd_tum
    from orb_slam2_ssd_semantic_tpu_torch.io.tum import TumSequence, read_trajectory
    from orb_slam2_ssd_semantic_tpu_torch.system import SlamSystem

    out = tmp_path / "app"
    res = rgbd_tum.main(["--sequence", str(tum_dir), "--settings",
                         str(tum_dir / "settings.json"), "--groundtruth",
                         str(tum_dir / "groundtruth.txt"), "--out", str(out),
                         "--device", "cpu"])
    assert res.system.cfg.camera == QVGA and res.system.cfg.orb.max_keypoints == 512
    assert [s["status"] for s in res.system.tracker.stats] == ["OK"] * 6
    assert res.ate.n_pairs == 6 and res.ate.rmse < 0.01
    direct = SlamSystem(qvga_config(), device="cpu")
    seq = TumSequence.open(str(tum_dir))
    for i in range(len(seq)):
        direct.track_rgbd(*seq[i][1:], seq[i][0])
    direct.save_trajectory_tum(str(tmp_path / "cam.txt"))
    direct.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    for name, ref in (("CameraTrajectory.txt", "cam.txt"), ("KeyFrameTrajectory.txt", "kf.txt")):
        text = (out / name).read_text()
        assert text == (tmp_path / ref).read_text()
        jax_write(str(tmp_path / "jax.txt"), *read_trajectory(str(out / name)))
        assert text == (tmp_path / "jax.txt").read_text()
    assert len((out / "KeyFrameTrajectory.txt").read_text().splitlines()) == \
        direct.tracker._n_kfs >= 2


@pytest.mark.parametrize("scheme", ["depth", "seg"])
def test_detect_locate_equals_the_library_calls(scheme, qvga_seq, tmp_path):
    from orb_slam2_ssd_semantic_tpu_torch.apps import detect_locate
    from orb_slam2_ssd_semantic_tpu_torch.semantic import fusion
    from orb_slam2_ssd_semantic_tpu_torch.semantic.detector import Detector
    from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import add_objects, empty_db
    from orb_slam2_ssd_semantic_tpu_torch.semantic.ssdlite import load_params

    _, frames = qvga_seq
    pairs = []
    for i, (g, d) in enumerate(frames[:2]):
        rgb = np.repeat(np.clip(g, 0, 255).astype(np.uint8)[..., None], 3, axis=-1)
        np.save(tmp_path / f"rgb_{i:03d}.npy", rgb)
        np.save(tmp_path / f"depth_{i:03d}.npy", d.astype(np.float32))
        pairs.append((rgb, d.astype(np.float32)))
    db = detect_locate.main(["--source", str(tmp_path), "--frames", "2", "--scheme", scheme,
                             "--params", CKPT4, "--score", "0", "--device", "cpu"])
    sem = SemanticConfig(num_classes=4, det_score_threshold=0.0, checkpoint_path=None)
    det = Detector(sem, device="cpu")
    load_params(CKPT4, det.model)
    fuse = fusion.fuse_depth_window if scheme == "depth" else fusion.fuse_segmentation
    ref = empty_db(device="cpu")
    for rgb, depth in pairs:
        ref = add_objects(ref, *fuse(det(rgb), torch.from_numpy(depth), torch.eye(4),
                                     CameraConfig(), sem))
    assert int(ref.valid.sum()) > 0
    for a, b in zip(db, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _cloud(n=41000):
    """Points on the walls and floor of a 4 x 3 x 4 m box around the origin."""
    rng = np.random.default_rng(3)
    p = rng.uniform(-1.9, 1.9, (n, 3)).astype(np.float32)
    axis = rng.integers(0, 3, n)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    p[np.arange(n), axis] = (sign * np.array([1.9, 1.4, 1.9])[axis]).astype(np.float32)
    return p


def test_cloud_to_occupancy_equals_the_jax_app(tmp_path):
    from orb_slam2_ssd_semantic_tpu.apps import cloud_to_occupancy as japp
    from orb_slam2_ssd_semantic_tpu_torch.apps import cloud_to_occupancy as tapp

    cloud = _cloud()
    assert 2 * tapp.CHUNK < len(cloud) < 3 * tapp.CHUNK
    np.savez(tmp_path / "cloud.npz", points=cloud)
    args = [str(tmp_path / "cloud.npz"), "", "--resolution", "0.1", "--origin", "0.1", "0.2",
            "0.3", "--extent", "4", "3", "4"]
    args[1] = str(tmp_path / "jax.npz")
    japp.main(args)
    args[1] = str(tmp_path / "port.npz")
    tapp.main(args + ["--device", "cpu"])
    with np.load(tmp_path / "jax.npz") as j, np.load(tmp_path / "port.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert (t["log_odds"] > 0).sum() > 1000 and (t["log_odds"] < 0).sum() > 1000


def test_vocabulary_tree_and_tfidf_equal_jax():
    import jax.numpy as jnp

    from orb_slam2_ssd_semantic_tpu.apps import train_vocabulary as japp
    from orb_slam2_ssd_semantic_tpu.io import vocabulary as jvoc
    from orb_slam2_ssd_semantic_tpu_torch.apps import train_vocabulary as tapp

    rng = np.random.default_rng(4)
    base = rng.integers(0, 2**32, (40, 8), dtype=np.uint64).astype(np.uint32)
    flips = rng.integers(0, 2**32, (1500, 8), dtype=np.uint64).astype(np.uint32)
    data = base[rng.integers(0, 40, 1500)] ^ (flips & flips >> 3 & flips >> 7)
    per_image = np.split(data, [300, 650, 900, 1200])
    want = japp.build_tree(data.copy(), 5, 3, seed=1)
    got = tapp.build_tree(data.copy(), 5, 3, seed=1)
    for name in ("children", "desc", "word_id", "word_weight"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.k, got.depth) == (want.k, want.depth) and got.n_words > 20
    # JAX's app computes the weights inline in its `main`: the same loop.
    df = np.zeros(want.n_words, np.int64)
    for d in per_image:
        w = np.asarray(jvoc.quantize(want, jnp.asarray(d), jnp.ones(len(d), bool)))
        df[np.unique(w[w >= 0])] += 1
    idf = np.log(len(per_image) / np.maximum(df, 1)).astype(np.float32)
    idf[df == 0] = 0.0
    got = tapp.tfidf(got, per_image, torch.device("cpu"))
    np.testing.assert_array_equal(got.word_weight, idf)
    assert (idf > 0).sum() > 10


def test_train_ssdlite_writes_a_checkpoint_jax_reads(tmp_path):
    import jax

    from orb_slam2_ssd_semantic_tpu.semantic import ssdlite as jssd
    from orb_slam2_ssd_semantic_tpu_torch.apps import train_ssdlite

    out = str(tmp_path / "ssd4.npz")
    res = train_ssdlite.main(["--steps", "10", "--batch", "2", "--classes", "4", "--out", out,
                              "--device", "cpu"])
    assert len(res.chunk_losses) == 1 and np.isfinite(res.chunk_losses[0])
    shapes = jax.eval_shape(lambda: jssd.init_ssdlite(jax.random.PRNGKey(0), 4)[1])
    loaded = jssd.load_params(out, shapes)
    leaves = jax.tree_util.tree_leaves_with_path(loaded)
    with np.load(out) as z:
        assert len(z.files) == len(leaves) == 404
    for path, leaf in leaves:
        assert isinstance(leaf, jax.Array), jax.tree_util.keystr(path)
    for (p, a), (_, s) in zip(leaves, jax.tree_util.tree_leaves_with_path(shapes)):
        assert a.shape == s.shape and a.dtype == s.dtype, jax.tree_util.keystr(p)


@pytest.mark.parametrize("app,argv", [
    ("run_synthetic", ["--frames", "1"]),
    ("rgbd_tum", ["--sequence", "none"]),
    ("detect_locate", ["--frames", "1"]),
    ("cloud_to_occupancy", ["none.npz", "none_out.npz"]),
    ("train_ssdlite", ["--steps", "1"]),
    ("train_vocabulary", ["--frames", "1"]),
])
def test_apps_default_to_the_card(app, argv):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    mod = importlib.import_module(f"orb_slam2_ssd_semantic_tpu_torch.apps.{app}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)


def test_profiling_trace_holds_the_annotation(tmp_path):
    from orb_slam2_ssd_semantic_tpu_torch.utils import profiling

    with profiling.trace(str(tmp_path)) as log_dir:
        with profiling.annotate("slam.test_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "slam.test_region" for e in events)
    assert profiling.device_memory_stats() == {}
