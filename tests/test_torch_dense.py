"""Port parity for the dense occupancy map: `dense/pointcloud.py` and
`dense/occupancy.py` (the dense grid and `BlockGridMap`) against the JAX
package on the same numpy inputs, and twins of `tests/test_dense.py`'s
properties on the port alone.

Gates, and why:
- `keyframe_cloud` on QVGA keyframes of the orbit room within 1e-6 m,
  with an equal mask and colors: the same f32 operations (the division by
  the focal length as a product with its f32 reciprocal, as XLA compiles
  it); measured 0.0;
- `split_ground` on JAX's own hypothesis indices: an equal mask and plane.
  The port's sampler draws from a torch generator: its indices are valid
  points, spread over them (the counts of a coarse histogram within 15%
  of uniform), and its split is the ground of the scene;
- `insert_scan` into a dense grid and into a `BlockGridMap` of 1.6 m
  blocks (several touched), three keyframes with colors and carve-only
  ground rays, over and over (clamping and decay): log-odds equal on every
  voxel (boundary flips would be counted; none were measured), `color`
  and `n_color` within 1e-5;
- `save_grid`/`load_grid` and `BlockGridMap.save`/`load` across the two
  packages: every array equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.dense import occupancy as jocc
from orb_slam2_ssd_semantic_tpu.dense import pointcloud as jpc
from orb_slam2_ssd_semantic_tpu_torch.dense import occupancy as tocc
from orb_slam2_ssd_semantic_tpu_torch.dense import pointcloud as tpc
from orb_slam2_ssd_semantic_tpu_torch.io.device_render import render_frames
from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import orbit_trajectory
from _torch_threads import _few_threads  # noqa: F401 (autouse)

ROOM = (5.0, 3.0, 6.0)
CPU = torch.device("cpu")
TCFG = tconfig.DenseMapConfig()
JCFG = jconfig.DenseMapConfig()
M_TOL = 1e-6
COLOR_TOL = 1e-5


def _qvga(mod):
    return mod.CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=123.8, width=320, height=240)


def jax_hypotheses(key, valid, n: int) -> np.ndarray:
    """The hypothesis indices JAX's `split_ground` draws from `key`."""
    logits = jnp.where(jnp.asarray(valid), 0.0, -1e9)
    keys = jax.random.split(key, n)
    return np.asarray(jax.vmap(lambda k: jax.random.categorical(k, logits))(keys))


def t(a, dtype=None):
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


@pytest.fixture(scope="module")
def scans():
    """Three QVGA keyframes of the orbit room (metres, gray) and JAX's
    cloud, colors and ground split of each (PRNGKey(0) split per scan, as
    the engine does)."""
    poses = orbit_trajectory(40, room=ROOM)[[0, 20, 39]].astype(np.float32)
    g, d = render_frames(poses, _qvga(tconfig), size=ROOM, seed=17, device="cpu")
    key = jax.random.PRNGKey(0)
    out = []
    for i in range(3):
        depth = d[i].numpy().astype(np.float32) * 1e-3
        gray = g[i].numpy().astype(np.float32)
        T_cw = np.linalg.inv(poses[i]).astype(np.float32)
        pts, valid, colors = jpc.keyframe_cloud(jnp.asarray(depth), jnp.asarray(T_cw),
                                                _qvga(jconfig), JCFG, gray_img=jnp.asarray(gray))
        key, sub = jax.random.split(key)
        ground, plane = jpc.split_ground(pts, valid, sub, 1, JCFG)
        out.append(dict(depth=depth, gray=gray, T_cw=T_cw, pts=np.asarray(pts),
                        valid=np.asarray(valid), colors=np.asarray(colors),
                        ground=np.asarray(ground), plane=np.asarray(plane),
                        idx=jax_hypotheses(sub, valid, JCFG.ground_ransac_iters),
                        origin=np.linalg.inv(T_cw)[:3, 3]))
    return out


def test_keyframe_cloud_matches_jax(scans):
    for s in scans:
        pts, valid, colors = tpc.keyframe_cloud(t(s["depth"]), t(s["T_cw"]), _qvga(tconfig), TCFG,
                                                gray_img=t(s["gray"]))
        gap = float(np.abs(pts.numpy() - s["pts"]).max())
        assert gap <= M_TOL, f"clouds differ by {gap} m"
        np.testing.assert_array_equal(valid.numpy(), s["valid"])
        np.testing.assert_array_equal(colors.numpy(), s["colors"])
        assert s["valid"].sum() > 5000
        pts2, valid2 = tpc.keyframe_cloud(t(s["depth"]), t(s["T_cw"]), _qvga(tconfig), TCFG)
        assert torch.equal(pts2, pts) and torch.equal(valid2, valid)


def test_split_ground_on_jax_hypotheses_matches_jax(scans):
    for s in scans:
        ground, plane = tpc.split_ground(t(s["pts"]), t(s["valid"]), t(s["idx"], torch.int64), 1,
                                         TCFG)
        np.testing.assert_array_equal(ground.numpy(), s["ground"])
        np.testing.assert_array_equal(plane.numpy(), s["plane"])
    assert any(s["ground"].sum() > 500 for s in scans)


def test_ground_sampler_draws_valid_points_uniformly(scans):
    s = scans[0]
    valid = t(s["valid"])
    gen = torch.Generator().manual_seed(0)
    idx = torch.cat([tpc.sample_ground_hypotheses(valid, 200, gen) for _ in range(50)])
    assert bool(valid[idx].all())
    rank = torch.cumsum(valid.to(torch.int64), 0)[idx] - 1  # rank among the valid points
    hist = np.bincount((rank.numpy() * 10) // int(valid.sum()), minlength=10)
    assert np.abs(hist / hist.mean() - 1.0).max() < 0.15, hist
    again = tpc.sample_ground_hypotheses(valid, 200, torch.Generator().manual_seed(0))
    assert torch.equal(again, idx[:200])
    # With the port's own draws the split finds the same floor height.
    ground, plane = tpc.split_ground(t(s["pts"]), valid, again, 1, TCFG)
    assert abs(float(plane[3]) - float(s["plane"][3])) < TCFG.ground_inlier_threshold
    assert int(ground.sum()) > 0.9 * int(s["ground"].sum())
    none = tpc.sample_ground_hypotheses(torch.zeros(10, dtype=torch.bool), 4, gen)
    assert torch.equal(none, torch.full((4,), 9))  # in range: split_ground then finds no ground


def _insert_both(scans, jgrid, tgrid, rounds: int):
    """Every scan `rounds` times into both packages' grid (a VoxelGrid or
    a BlockGridMap), with colors and carve-only ground rays."""
    for _ in range(rounds):
        for s in scans:
            jargs = (jnp.asarray(s["origin"]), jnp.asarray(s["pts"]), jnp.asarray(s["valid"]))
            targs = (t(s["origin"]), t(s["pts"]), t(s["valid"]))
            jkw = dict(colors=jnp.asarray(s["colors"]), carve_only=jnp.asarray(s["ground"]))
            tkw = dict(colors=t(s["colors"]), carve_only=t(s["ground"]))
            if isinstance(jgrid, jocc.BlockGridMap):
                jgrid.insert_scan(*jargs, **jkw)
                tgrid.insert_scan(*targs, **tkw)
            else:
                jgrid = jocc.insert_scan(jgrid, *jargs, cfg=JCFG, **jkw)
                tgrid = tocc.insert_scan(tgrid, *targs, cfg=TCFG, **tkw)
    return jgrid, tgrid


def assert_same_grid(tg, jg):
    """Log-odds equal on every voxel, colors within COLOR_TOL."""
    lj, lt = np.asarray(jg.log_odds), tg.log_odds.cpu().numpy()
    touched = int(((lj != 0) | (lt != 0)).sum())
    flips = int((lj != lt).sum())
    assert flips == 0, f"{flips} of {touched} touched voxels differ"
    np.testing.assert_array_equal(tg.origin.cpu().numpy(), np.asarray(jg.origin))
    for k in ("color", "n_color"):
        gap = float(np.abs(getattr(tg, k).cpu().numpy() - np.asarray(getattr(jg, k))).max())
        assert gap <= COLOR_TOL, f"{k} differs by {gap}"
    return touched


def test_insert_scan_dense_grid_matches_jax(scans):
    jg, tg = _insert_both(scans, jocc.empty_grid(), tocc.empty_grid(device=CPU), rounds=1)
    assert assert_same_grid(tg, jg) > 20_000
    # Repeated scans: hits past the 0.8 threshold, then clamping.
    jg, tg = _insert_both(scans, jg, tg, rounds=4)
    assert_same_grid(tg, jg)
    lo = tg.log_odds
    assert float(lo.max()) == pytest.approx(float(np.log(0.97 / 0.03)), abs=1e-6)
    assert float(lo.min()) == pytest.approx(float(np.log(0.12 / 0.88)), abs=1e-6)
    assert int(tocc.occupied_mask(tg, TCFG).sum()) > 1000
    cj, colj = jocc.occupied_centers(jg, JCFG)
    ct, colt = tocc.occupied_centers(tg, TCFG)
    np.testing.assert_allclose(ct, cj, atol=1e-6)
    np.testing.assert_allclose(colt, colj, atol=1e-4)


def test_insert_scan_without_colors_or_ground_matches_jax(scans):
    """At the batched consumer's 0.1 m and 48 ray steps (a step count
    whose reciprocal is inexact), no colors and no carve-only rays."""
    import dataclasses

    jcfg = dataclasses.replace(JCFG, resolution=0.1, max_ray_steps=48)
    tcfg = dataclasses.replace(TCFG, resolution=0.1, max_ray_steps=48)
    jg, tg = jocc.empty_grid(resolution=0.1), tocc.empty_grid(resolution=0.1, device=CPU)
    for s in scans:
        jg = jocc.insert_scan(jg, jnp.asarray(s["origin"]), jnp.asarray(s["pts"]),
                              jnp.asarray(s["valid"]), cfg=jcfg)
        tg = tocc.insert_scan(tg, t(s["origin"]), t(s["pts"]), t(s["valid"]), cfg=tcfg)
    assert assert_same_grid(tg, jg) > 5000
    assert float(tg.n_color.sum()) == 0.0


def test_block_map_matches_jax(scans):
    jm = jocc.BlockGridMap(JCFG, block_voxels=32)
    tm = tocc.BlockGridMap(TCFG, block_voxels=32, device=CPU)
    _insert_both(scans, jm, tm, rounds=2)
    assert list(tm.blocks) == list(jm.blocks)
    assert len(tm.blocks) >= 8, len(tm.blocks)
    for k in jm.blocks:
        assert_same_grid(tm.blocks[k], jm.blocks[k])
    cj, _ = jm.occupied_centers()
    ct, _ = tm.occupied_centers()
    assert len(ct) == len(cj) > 100
    probe = scans[0]["pts"][scans[0]["valid"]][::97]
    np.testing.assert_allclose(tm.occupancy_at(probe), jm.occupancy_at(probe), atol=1e-6)


def _grids_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


def test_grid_files_load_in_both_packages(scans, tmp_path):
    jg, tg = _insert_both(scans[:1], jocc.empty_grid(), tocc.empty_grid(device=CPU), rounds=2)
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jocc.save_grid(pj, jg, JCFG)
    tocc.save_grid(pt, tg, TCFG)
    _grids_equal(dict(np.load(pj)), dict(np.load(pt)))
    assert_same_grid(tocc.load_grid(pj, CPU), jocc.load_grid(pt))
    jm = jocc.BlockGridMap(JCFG, block_voxels=32)
    tm = tocc.BlockGridMap(TCFG, block_voxels=32, device=CPU)
    _insert_both(scans[:1], jm, tm, rounds=2)
    jm.save(pj)
    tm.save(pt)
    _grids_equal(dict(np.load(pj)), dict(np.load(pt)))
    jm2, tm2 = jocc.BlockGridMap.load(pt, JCFG), tocc.BlockGridMap.load(pj, TCFG, CPU)
    assert list(tm2.blocks) == list(jm2.blocks) == sorted(jm.blocks)
    for k in jm2.blocks:
        assert_same_grid(tm2.blocks[k], jm2.blocks[k])
    dense = str(tmp_path / "dense.npz")
    tocc.save_grid(dense, tg, TCFG)
    with pytest.raises(ValueError, match="not a BlockGridMap"):
        tocc.BlockGridMap.load(dense, TCFG, CPU)


# ---- twins of tests/test_dense.py's properties, on the port alone ----------


def small_grid():
    return tocc.empty_grid(extent=(4.0, 4.0, 4.0), resolution=0.05, origin=(-2.0, -2.0, -2.0),
                           device=CPU)


def _vox(p):
    return tuple(int(v) for v in np.floor((np.asarray(p) + 2.0) / 0.05))


def _ones(n):
    return torch.ones(n, dtype=torch.bool)


def test_insert_scan_marks_endpoint_occupied():
    grid = small_grid()
    pts = torch.tensor([[0.0, 0.0, 1.5]] * 8)
    for _ in range(3):
        grid = tocc.insert_scan(grid, torch.zeros(3), pts, _ones(8), cfg=TCFG)
    p = tocc.occupancy_prob(grid).numpy()
    assert p[_vox([0, 0, 1.5])] > 0.8
    assert p[_vox([0, 0, 0.75])] < 0.3  # carved along the ray


def test_insert_scan_clamping():
    grid = small_grid()
    for _ in range(50):
        grid = tocc.insert_scan(grid, torch.zeros(3), torch.tensor([[0.0, 0.0, 1.0]]), _ones(1),
                                cfg=TCFG)
    p = tocc.occupancy_prob(grid).numpy()
    assert p.max() <= TCFG.clamp_max + 1e-5
    assert p.min() >= TCFG.clamp_min - 1e-5


def test_carve_only_rays_do_not_occupy():
    grid = small_grid()
    for _ in range(5):
        grid = tocc.insert_scan(grid, torch.zeros(3), torch.tensor([[0.0, 0.0, 1.5]]), _ones(1),
                                carve_only=_ones(1), cfg=TCFG)
    assert not bool(tocc.occupied_mask(grid, TCFG).any())
    assert float(grid.log_odds.min()) < 0.0


def test_dynamic_object_decays():
    """A voxel hit early, then seen through, loses its occupancy."""
    grid = small_grid()
    for _ in range(3):
        grid = tocc.insert_scan(grid, torch.zeros(3), torch.tensor([[0.0, 0.0, 1.0]]), _ones(1),
                                cfg=TCFG)
    vx = _vox([0, 0, 1.0])
    assert tocc.occupancy_prob(grid).numpy()[vx] > 0.8
    for _ in range(8):
        grid = tocc.insert_scan(grid, torch.zeros(3), torch.tensor([[0.0, 0.0, 1.9]]), _ones(1),
                                cfg=TCFG)
    assert tocc.occupancy_prob(grid).numpy()[vx] < 0.5


def test_color_accumulation():
    grid = small_grid()
    for _ in range(4):
        grid = tocc.insert_scan(grid, torch.zeros(3), torch.tensor([[0.5, 0.5, 1.0]]), _ones(1),
                                colors=torch.tensor([[200.0, 100.0, 50.0]]), cfg=TCFG)
    centers, cols = tocc.occupied_centers(grid, TCFG)
    assert len(centers) == 1
    np.testing.assert_allclose(cols[0], [200, 100, 50], atol=1e-3)
    np.testing.assert_allclose(centers[0], [0.525, 0.525, 1.025], atol=0.051)


def test_endpoint_hits_dedup_per_scan():
    """30 rays into one voxel in ONE scan: one hit, and one miss on a voxel
    they all cross; the color is the first ray's."""
    import math

    base = np.array([0.5, 0.5, 1.5], np.float32)
    pts = base[None] + np.random.default_rng(0).uniform(0, 0.004, (30, 3)).astype(np.float32)
    cols = np.random.default_rng(1).uniform(0, 255, (30, 3)).astype(np.float32)
    grid = tocc.insert_scan(small_grid(), torch.zeros(3), t(pts), _ones(30), colors=t(cols),
                            cfg=TCFG)
    lo = grid.log_odds.numpy()
    assert lo[_vox(base)] == pytest.approx(math.log(0.7 / 0.3), abs=1e-5)
    assert lo[_vox(base * 0.5)] == pytest.approx(math.log(0.4 / 0.6), abs=1e-5)
    assert float(grid.n_color.numpy()[_vox(base)]) == 1.0
    np.testing.assert_array_equal(grid.color.numpy()[_vox(base)], cols[0])


def test_block_map_unbounded_extent(tmp_path):
    """Scans 8 m apart land in different blocks, all queryable, and
    survive a save and load."""
    m = tocc.BlockGridMap(TCFG, block_voxels=32, device=CPU)
    targets = []
    for k in range(4):
        o = np.asarray([8.0 * k, 0.0, 0.0], np.float32)
        tgt = o + np.asarray([0.0, 0.0, 1.5], np.float32)
        targets.append(tgt)
        for _ in range(3):
            m.insert_scan(t(o), t(np.tile(tgt, (4, 1))), _ones(4))
    assert len(m.blocks) >= 4
    probs = m.occupancy_at(np.stack(targets))
    assert (probs > 0.8).all(), probs
    assert len(m.occupied_centers()[0]) >= 4
    p = str(tmp_path / "blocks.npz")
    m.save(p)
    np.testing.assert_allclose(tocc.BlockGridMap.load(p, TCFG, CPU).occupancy_at(
        np.stack(targets)), probs, atol=1e-6)


def test_save_load_roundtrip(tmp_path):
    grid = tocc.insert_scan(small_grid(), torch.zeros(3), torch.tensor([[0.0, 0.0, 1.0]]),
                            _ones(1), cfg=TCFG)
    path = str(tmp_path / "map.npz")
    tocc.save_grid(path, grid, TCFG)
    g2 = tocc.load_grid(path, CPU)
    for k in ("log_odds", "color", "n_color", "origin"):
        assert torch.equal(getattr(g2, k), getattr(grid, k)), k


def test_keyframe_cloud_gates():
    cam = tconfig.CameraConfig()
    depth = np.full((480, 640), 2.0, np.float32)
    depth[:10, :] = 0.1  # too close
    depth[-10:, :] = 6.0  # too far
    pts, valid = tpc.keyframe_cloud(t(depth), torch.eye(4), cam, TCFG)
    p = pts.numpy()[valid.numpy()]
    assert valid.sum() > 1000
    assert np.all(np.linalg.norm(p, axis=1) < 5.0)
    assert np.all((p[:, 2] > TCFG.cloud_min_depth) & (p[:, 2] < TCFG.cloud_max_depth))


def test_split_ground():
    rng = np.random.default_rng(0)
    floor = np.stack([rng.uniform(-2, 2, 3000), np.full(3000, 1.5), rng.uniform(0, 4, 3000)], -1)
    objects = np.stack([rng.uniform(-2, 2, 800), rng.uniform(-0.5, 1.2, 800),
                        rng.uniform(0, 4, 800)], -1)
    pts = t(np.concatenate([floor, objects]).astype(np.float32))
    valid = _ones(3800)
    idx = tpc.sample_ground_hypotheses(valid, TCFG.ground_ransac_iters,
                                       torch.Generator().manual_seed(0))
    is_ground, plane = tpc.split_ground(pts, valid, idx, 1, TCFG)
    g = is_ground.numpy()
    assert g[:3000].mean() > 0.95
    assert g[3000:].mean() < 0.1
    assert abs(float(plane[3]) + 1.5) < 0.05
