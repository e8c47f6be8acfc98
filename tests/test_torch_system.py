"""Port parity for the system facade with the dense map: a twin of
`tests/test_system.py` at 160x120, `SlamSystem(enable_semantics=True,
enable_dense_map=True)` in both packages on the same frames, map and
occupancy persistence across the packages, and
`semantic/consume.make_batched_consume` against the engine path and
against JAX's.

Gates, and why:
- tracking: the same keyframes and statuses, poses within 1e-4 m (the
  tolerance of `tests/test_torch_semantic.py`'s twin);
- the occupancy map: the port is handed JAX's ground hypotheses (its
  sampler monkeypatched with JAX's `PRNGKey(0)` split chain). Replaying
  JAX's keyframe payloads (rgb, depth, pose) through the port's consumers
  gives every block's log-odds equal and colors within 1e-5, as
  `tests/test_torch_dense.py`; the two runs' own maps, built at poses up to
  1e-4 m apart, differ on at most 1e-3 of the touched voxels (voxel faces
  crossed by those shifts; measured 0);
- `save_octomap`/`load_octomap` within and across the packages: the same
  occupied centres (1e-5 m) and arrays; `save_map` in one package and
  `load_map` in the other: equal arrays; localization mode on a loaded map:
  no new keyframe, status OK or WEAK; `reset` clears the map;
- `make_batched_consume` (JAX's rules, `tests/test_semantic.py:184-261`):
  against the port's engine path the same object count, centroids within
  0.10 m and at most 2% of the touched voxels differing; against JAX's own
  batched consumer with JAX's hypotheses handed over, equal log-odds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.dense import occupancy as jocc
from orb_slam2_ssd_semantic_tpu.io import map_io as jmap_io
from orb_slam2_ssd_semantic_tpu.semantic import detector as jdet
from orb_slam2_ssd_semantic_tpu.semantic.consume import make_batched_consume as j_consume
from orb_slam2_ssd_semantic_tpu_torch.dense import occupancy as tocc
from orb_slam2_ssd_semantic_tpu_torch.dense import pointcloud as tpc
from orb_slam2_ssd_semantic_tpu_torch.io import map_io as tmap_io
from orb_slam2_ssd_semantic_tpu_torch.io.device_render import render_frames
from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import orbit_trajectory
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import state_to_numpy
from orb_slam2_ssd_semantic_tpu_torch.semantic.consume import make_batched_consume as t_consume
from orb_slam2_ssd_semantic_tpu_torch.system import SlamSystem as TSystem
from test_torch_dense import assert_same_grid, jax_hypotheses
from test_torch_semantic import FLAT_BOX, ROOM, _assert_same_db, _jax_system, _kf_frames
from test_torch_ssdlite import jit_init_ssdlite
from _torch_threads import _few_threads  # noqa: F401 (autouse)

N_FRAMES = 10
POSE_TOL = 1e-4
RUN_FLIP_SHARE = 1e-3
CPU = torch.device("cpu")


def small_cfg(mod, **dense):
    base = mod.SlamConfig()
    return dataclasses.replace(
        base,
        camera=mod.CameraConfig(fx=134.0, fy=134.0, cx=80.0, cy=60.0, width=160, height=120),
        orb=mod.OrbConfig(n_features=100, max_keypoints=128),
        tracking=dataclasses.replace(base.tracking, max_frames_between_kfs=4),
        loop=dataclasses.replace(base.loop, enabled=False, enable_relocalization=False),
        semantic=dataclasses.replace(base.semantic, det_score_threshold=0.0,
                                     fusion_prob_threshold=0.0),
        dense=dataclasses.replace(base.dense, **dense),
    )


class JaxHypotheses:
    """Stands in for the port's ground sampler: JAX's draws from a key
    chain (the engine's `PRNGKey(0)` split per keyframe, or the batched
    consumer's `split(key, Q)`)."""

    def __init__(self, keys=None):
        self.key, self.keys = jax.random.PRNGKey(0), keys

    def __call__(self, valid, n, generator):
        if self.keys is None:
            self.key, sub = jax.random.split(self.key)
        else:
            sub, self.keys = self.keys[0], self.keys[1:]
        return torch.from_numpy(jax_hypotheses(sub, valid.cpu().numpy(), n).astype(np.int64))


def _frames(cam, n):
    poses = orbit_trajectory(n, room=ROOM).astype(np.float32)
    g, d = render_frames(poses, cam, size=ROOM, seed=17, box_gray=FLAT_BOX, device="cpu")
    return poses, g.numpy(), d.numpy()


@pytest.fixture(scope="module")
def runs():
    """Both packages' systems with semantics and the dense map on the same
    10 frames (gray, uint16 depth); JAX's keyframe payloads recorded."""
    _, g, d = _frames(small_cfg(tconfig).camera, N_FRAMES)
    js = _jax_system(small_cfg(jconfig), enable_dense_map=True)
    payloads = []
    on_kf = js._on_new_keyframe

    def recording(rgb, depth, T_cw):
        payloads.append((np.array(rgb), np.array(depth), np.array(T_cw, np.float32)))
        on_kf(rgb, depth, T_cw)

    js._on_new_keyframe = recording
    ts = TSystem(small_cfg(tconfig), enable_semantics=True, enable_dense_map=True, device="cpu")
    for i in range(N_FRAMES):
        js.track_rgbd(g[i], d[i], i / 30.0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpc, "sample_ground_hypotheses", JaxHypotheses())
        for i in range(N_FRAMES):
            ts.track_rgbd(g[i], d[i], i / 30.0)
    return js, ts, payloads, (g, d)


def test_tracking_and_semantics_match_jax(runs):
    js, ts, payloads, _ = runs
    assert [s["status"] for s in ts.tracker.stats] == [s["status"] for s in js.tracker.stats]
    kfs = _kf_frames(ts.tracker)
    assert kfs == _kf_frames(js.tracker) and len(kfs) >= 1
    assert len(payloads) == len(kfs) + 1
    gap = float(np.abs(ts.tracker.camera_positions() - js.tracker.camera_positions()).max())
    assert gap <= POSE_TOL, f"positions differ by {gap} m > {POSE_TOL}"
    _assert_same_db(ts.object_db, js.object_db, POSE_TOL)
    assert ts.status == "OK"


def test_occupancy_map_matches_jax(runs):
    js, ts, _, _ = runs
    assert isinstance(ts.grid, tocc.BlockGridMap) and list(ts.grid.blocks) == list(js.grid.blocks)
    touched = flips = 0
    for k, jg in js.grid.blocks.items():
        lj, lt = np.asarray(jg.log_odds), ts.grid.blocks[k].log_odds.numpy()
        touched += int(((lj != 0) | (lt != 0)).sum())
        flips += int((lj != lt).sum())
    assert flips <= RUN_FLIP_SHARE * touched, f"{flips} of {touched} touched voxels differ"
    n_occ = len(ts.grid.occupied_centers()[0])
    assert n_occ == len(js.grid.occupied_centers()[0]) > 500


def test_engine_replay_of_jax_keyframes_gives_jaxs_map(runs):
    js, _, payloads, _ = runs
    ts = TSystem(small_cfg(tconfig), enable_dense_map=True, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpc, "sample_ground_hypotheses", JaxHypotheses())
        for rgb, depth, T_cw in payloads:
            ts._on_new_keyframe(rgb, depth, T_cw)
    assert list(ts.grid.blocks) == list(js.grid.blocks) and len(ts.grid.blocks) >= 2
    for k, jg in js.grid.blocks.items():
        assert_same_grid(ts.grid.blocks[k], jg)


def test_octomap_files_across_packages(runs, tmp_path):
    js, ts, _, _ = runs
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    ts.save_octomap(pt)
    js.save_octomap(pj)
    before = np.sort(ts.grid.occupied_centers()[0], axis=0)
    ts.load_octomap(pt)
    np.testing.assert_allclose(np.sort(ts.grid.occupied_centers()[0], axis=0), before, atol=1e-5)
    in_jax = jocc.BlockGridMap.load(pt, js.cfg.dense)
    np.testing.assert_allclose(np.sort(in_jax.occupied_centers()[0], axis=0), before, atol=1e-5)
    other = TSystem(small_cfg(tconfig), enable_dense_map=True, device="cpu")
    other.load_octomap(pj)
    assert list(other.grid.blocks) == list(js.grid.blocks)
    for k, jg in js.grid.blocks.items():
        assert_same_grid(other.grid.blocks[k], jg)
    # A dense grid's file, by its keys.
    dense = str(tmp_path / "dense.npz")
    g = next(iter(ts.grid.blocks.values()))
    tocc.save_grid(dense, g, ts.cfg.dense)
    other.load_octomap(dense)
    assert isinstance(other.grid, tocc.VoxelGrid) and torch.equal(other.grid.log_odds, g.log_odds)


def _jax_tree(state) -> dict:
    def flat(nt):
        return {k: np.asarray(v) for k, v in nt._asdict().items()}

    out = {k: np.asarray(getattr(state, k)) for k in ("n_points", "n_kfs", "last_kf", "next_uid")}
    out.update(points=flat(state.points), kfs=flat(state.kfs), retired=flat(state.retired))
    return out


def _assert_same_tree(a: dict, b: dict):
    for k, v in a.items():
        if isinstance(v, dict):
            _assert_same_tree(v, b[k])
        else:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(b[k]), err_msg=k)
            assert np.asarray(v).dtype == np.asarray(b[k]).dtype, k


def test_map_files_across_packages(runs, tmp_path):
    js, ts, _, _ = runs
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    ts.save_map(pt)
    js.save_map(pj)
    with np.load(pt) as zt, np.load(pj) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zj.files:
            assert zt[k].dtype == zj[k].dtype, k
    # The port's file in JAX, and JAX's file in the port.
    _assert_same_tree(_jax_tree(jmap_io.load_map(pt, js.cfg)),
                      state_to_numpy(tmap_io.load_map(pt, ts.cfg, CPU)))
    _assert_same_tree(state_to_numpy(tmap_io.load_map(pj, ts.cfg, CPU)),
                      _jax_tree(jmap_io.load_map(pj, js.cfg)))
    got = state_to_numpy(tmap_io.load_map(pt, ts.cfg, CPU))
    want = state_to_numpy(ts.tracker.state)
    for group in ("points", "kfs"):
        for k, v in want[group].items():
            if k not in ("n_visible", "n_found"):  # reset to 1 on load
                np.testing.assert_array_equal(got[group][k], v, err_msg=k)


def test_localization_mode_after_load_map(runs, tmp_path):
    _, ts, _, (g, d) = runs
    p = str(tmp_path / "map.npz")
    ts.save_map(p)
    sys2 = TSystem(small_cfg(tconfig), device="cpu")
    sys2.load_map(p)
    assert sys2.tracker.initialized and sys2.tracker._n_kfs == ts.tracker._n_kfs
    sys2.activate_localization_mode()
    sys2.tracker.last_T_cw = ts.tracker.last_T_cw
    sys2.tracker.last_frame = ts.tracker.last_frame
    sys2.tracker.last_kp_point = ts.tracker.last_kp_point
    before = sys2.tracker._n_kfs
    for i in range(N_FRAMES - 4, N_FRAMES):
        sys2.track_rgbd(g[i], d[i], i / 30.0)
        assert sys2.status in ("OK", "WEAK")
    assert sys2.tracker._n_kfs == before


def test_reset_clears_the_map(runs):
    js, ts, _, _ = runs
    ts.reset()
    js.reset()
    assert not ts.tracker.initialized
    assert isinstance(ts.grid, tocc.BlockGridMap) and not ts.grid.blocks
    assert int(ts.object_db.cursor) == 0
    gen = torch.Generator().manual_seed(0)
    assert torch.equal(torch.rand(4, generator=ts._ground_gen), torch.rand(4, generator=gen))


@pytest.fixture(scope="module")
def batched():
    """3 keyframes of the flat-box orbit at 160x120 through the port's
    engine path (a dense 0.1 m grid), the port's batched consumer, and
    JAX's batched consumer on the same detector weights."""
    steps = int(tconfig.DenseMapConfig().cloud_max_depth / 0.1) + 8
    tcfg = small_cfg(tconfig, unbounded=False, resolution=0.1, max_ray_steps=steps)
    jcfg = small_cfg(jconfig, unbounded=False, resolution=0.1, max_ray_steps=steps)
    n = 3
    poses, g, d = _frames(tcfg.camera, n)
    T_cw = np.stack([np.linalg.inv(T) for T in poses]).astype(np.float32)
    sys_ = TSystem(tcfg, enable_semantics=True, enable_dense_map=True, device="cpu")
    for i in range(n):
        sys_._on_new_keyframe(np.repeat(g[i][..., None], 3, -1), d[i].astype(np.float32) * 1e-3,
                              T_cw[i])
    grid = dict(grid_extent=(10.0, 6.0, 10.0), grid_origin=(-2.0, -3.0, -2.0),
                grid_resolution=0.1)
    consume, _ = t_consume(tcfg, np.arange(n), np.arange(n), detector=sys_.detector, device=CPU,
                           **grid)
    lo0 = torch.zeros_like(sys_.grid.log_odds)
    args = (torch.from_numpy(g), torch.from_numpy(d), torch.from_numpy(T_cw), lo0)
    own = consume(*args, torch.Generator().manual_seed(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdet, "init_ssdlite", jit_init_ssdlite)
        jconsume, _ = j_consume(jcfg, np.arange(n), np.arange(n), **grid)
        key = jax.random.PRNGKey(0)
        want = jconsume(jnp.asarray(g), jnp.asarray(d), jnp.asarray(T_cw),
                        jnp.zeros(lo0.shape, jnp.float32), key)
        mp.setattr(tpc, "sample_ground_hypotheses", JaxHypotheses(list(jax.random.split(key, n))))
        handed = consume(*args, torch.Generator().manual_seed(0))
    return sys_, own, handed, want


def test_batched_consume_matches_engine_path(batched):
    sys_, (lo, nd, db), _, _ = batched
    v_e, v_b = sys_.object_db.valid.numpy(), db.valid.numpy()
    assert v_b.sum() > 0 and v_e.sum() == v_b.sum(), (int(v_e.sum()), int(v_b.sum()))
    ce, cb = sys_.object_db.centroid.numpy()[v_e], db.centroid.numpy()[v_b]
    for c in cb:  # bf16 batch against f32 single-image boxes
        assert np.linalg.norm(ce - c[None], axis=-1).min() < 0.10, (ce, c)
    lo_e, lo_b = sys_.grid.log_odds.numpy(), lo.numpy()
    touched = (lo_e != 0) | (lo_b != 0)
    assert touched.sum() > 5_000
    ndiff = int((np.abs(lo_e - lo_b) > 1e-4).sum())
    assert ndiff <= max(1, int(0.02 * touched.sum())), (ndiff, int(touched.sum()))
    assert int(nd.sum()) > 0


def test_batched_consume_matches_jax(batched):
    _, own, (lo, nd, db), (lo_j, nd_j, db_j) = batched
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_j))
    assert int(db.valid.sum()) == int(np.asarray(db_j.valid).sum()) > 0
    ct, cj = db.centroid.numpy()[db.valid.numpy()], np.asarray(db_j.centroid)[np.asarray(db_j.valid)]
    for c in ct:
        assert np.linalg.norm(cj - c[None], axis=-1).min() < 0.10, (cj, c)
    # The port's own hypotheses: JAX's rule between the two.
    lo_o = own[0].numpy()
    touched = (lo_o != 0) | (np.asarray(lo_j) != 0)
    assert int((np.abs(lo_o - np.asarray(lo_j)) > 1e-4).sum()) <= 0.02 * touched.sum()
