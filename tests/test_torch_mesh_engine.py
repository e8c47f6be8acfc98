"""Port twins of `tests/test_mesh_engine.py`: `SlamSystem(mesh=...)` on two
spawned gloo ranks against the port's single-device engine on the same
frames (`tests/test_torch_system.py` holds the port's single-device
engine against JAX's).

One module fixture renders the orbit's first 14 frames at 160x120
(`_torch_dist.small_cfg`: loop closing on `checkpoints/orbvoc_synth.npz`,
the dense grid bounded at 0.1 m) and starts the two ranks
(`_torch_dist.engine_job`) while this process runs the single-device
engine. The gates are JAX's:
- every frame OK, ATE under 0.02 m, trajectories within 5e-3 m;
- the grid split into one X slab per rank, at most 0.5% of the touched
  voxels differing, colors agreeing on 99% (the 0.1 m grid touches about
  6,000 voxels here, so "touched" is held over 2,000 where JAX's 0.05 m
  grid held 10,000);
- BoW scores through the sharded scorer within 1e-5;
- `reset` keeps the mesh, clears the grid and the objects, and tracks OK
  again;
- the sharded GBA on the mesh run's live state within 1e-3 m of
  `global_ba_step_state` on the same state;
- keyframe-sharded detection on a (2, 1) mesh: the detection batch is
  the kf-axis size, the same object count, centroids within 0.05 m;
- and the port's own rule: only rank 0 writes files, and the octomap it
  writes holds the gathered slabs in the dense grid's layout.
"""

import numpy as np
import pytest
import torch

from orb_slam2_ssd_semantic_tpu_torch.dense.occupancy import load_grid
from orb_slam2_ssd_semantic_tpu_torch.eval.ate import evaluate_ate_xyz
from orb_slam2_ssd_semantic_tpu_torch.mapping.global_ba import global_ba_step_state
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import state_from_numpy
from orb_slam2_ssd_semantic_tpu_torch.system import SlamSystem
from _torch_dist import Ranks, detect_keyframes, frames, small_cfg
from _torch_threads import _few_threads  # noqa: F401 (autouse)

RANKS = 2
N_FRAMES = 14
N_RESET = 6
N_DETECT = 4
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cfg = small_cfg()
    out_dir = tmp_path_factory.mktemp("mesh_files")
    poses, g, d = frames(cfg.camera, N_FRAMES)
    payloads = [(np.repeat(g[i][..., None], 3, -1), d[i].astype(np.float32) * 1e-3,
                 np.linalg.inv(poses[i]).astype(np.float32)) for i in range(N_DETECT)]
    ranks = Ranks("engine_job", RANKS, g, d, N_RESET, payloads, str(out_dir))
    single = SlamSystem(cfg, enable_dense_map=True, device="cpu")
    for i in range(N_FRAMES):
        single.track_rgbd(g[i], d[i], i / 30.0)
    det = detect_keyframes(SlamSystem(cfg, enable_semantics=True, device="cpu"), payloads)
    return dict(cfg=cfg, gt=poses[:, :3, 3], single=single, single_detection=det,
                mesh=ranks.result(), out_dir=out_dir)


def test_mesh_engine_tracks_with_parity(runs):
    m, s = runs["mesh"], runs["single"]
    assert m["stats"] == ["OK"] * N_FRAMES and s.status == "OK"
    for pos in (m["positions"], s.tracker.camera_positions()):
        assert evaluate_ate_xyz(pos, runs["gt"]).rmse < 0.02
    np.testing.assert_allclose(m["positions"], s.tracker.camera_positions(), atol=5e-3)


def test_mesh_occupancy_insertion_is_sharded_and_matches(runs):
    m, s = runs["mesh"], runs["single"]
    assert m["slab_x"] * RANKS == m["grid_x"] == s.grid.shape[0], "grid not split over the ranks"
    lom, los = m["grid"]["log_odds"], s.grid.log_odds.numpy()
    touched = (lom != 0) | (los != 0)
    assert touched.sum() > 2_000, "grid barely touched: scene broken"
    ndiff = int((np.abs(lom - los) > 1e-5).sum())
    assert ndiff <= max(1, int(0.005 * touched.sum())), (ndiff, int(touched.sum()))
    cm, cs = m["grid"]["color"], s.grid.color.numpy()
    assert cm.any(), "the sharded grid accumulated no colors"
    assert np.isclose(cm, cs, atol=1e-3).all(axis=-1).mean() > 0.99


def test_mesh_bow_scoring_parity(runs):
    m, s = runs["mesh"], runs["single"]
    assert s.tracker.loop_closer.vocab is not None and m["sharded_scores"]
    state = state_from_numpy(m["state"], CPU)
    kf = m["kf"]
    s_s = s.tracker.loop_closer.frame_scores(state.kfs.desc[kf], state.kfs.kp_valid[kf])
    np.testing.assert_allclose(m["scores"], s_s, atol=1e-5)


def test_reset_preserves_mesh_and_clears_maps(runs):
    r = runs["mesh"]["reset"]
    assert r["grid_before"], "nothing mapped before the reset"
    assert r["tracker_mesh"] and r["closer_mesh"], "reset dropped the mesh"
    assert r["sharded"] and r["slab_x"] * RANKS == runs["mesh"]["grid_x"]
    assert not r["grid_after"] and r["objects"] == 0
    assert r["status"] == "OK"


def test_mesh_global_ba_matches_single_device(runs):
    m = runs["mesh"]
    state = state_from_numpy(m["state"], CPU)
    st_s = global_ba_step_state(state, runs["cfg"])
    kv, pv = state.kfs.valid.numpy(), state.points.valid.numpy()
    assert kv.sum() >= 3 and pv.sum() > 100
    np.testing.assert_allclose(st_s.kfs.T_cw.numpy()[kv], m["gba_T"][kv], atol=1e-3)
    np.testing.assert_allclose(st_s.points.pos.numpy()[pv], m["gba_pos"][pv], atol=1e-3)


def test_mesh_kf_sharded_detection_matches_single_device(runs):
    dm, ds = runs["mesh"]["detection"], runs["single_detection"]
    assert dm["det_batch"] == RANKS and ds["det_batch"] == 1
    v_m, v_s = dm["valid"], ds["valid"]
    assert v_m.sum() > 0, "keyframe-sharded detection found no objects"
    assert v_s.sum() == v_m.sum(), (int(v_s.sum()), int(v_m.sum()))
    cs = np.sort(ds["centroid"][v_s], axis=0)
    cm = np.sort(dm["centroid"][v_m], axis=0)
    np.testing.assert_allclose(cs, cm, atol=0.05)


def test_only_rank_zero_writes_the_gathered_octomap(runs):
    m, out_dir = runs["mesh"], runs["out_dir"]
    assert sorted(p.name for p in out_dir.iterdir()) == ["octo.npz", "trajectory_rank0.txt"]
    grid = load_grid(str(out_dir / "octo.npz"), device="cpu")
    assert grid.shape == runs["single"].grid.shape
    np.testing.assert_array_equal(grid.log_odds.numpy(), m["grid"]["log_odds"])
    np.testing.assert_array_equal(grid.color.numpy(), m["grid"]["color"])
    np.testing.assert_array_equal(grid.origin.numpy(), runs["single"].grid.origin.numpy())
