"""Map hygiene in the port: keyframe eviction, the retirement record, the
retired ring's wrap, a run beyond the keyframe capacity and asynchronous
local mapping (twins of `tests/test_map_hygiene.py:197, 219, 295, 334,
397`).

Eviction, retirement and the ring run both packages on the same numpy
inputs (the JAX test's 128x96 frames, 4 keyframe slots): every integer
field of the two states equal (descriptors too), keypoint angles within
2e-3 rad and every other float field within 1e-4, and JAX's own gates
on the port's state. The extractor sums the IC angle's moments in
another order than XLA (`tests/test_torch_frontend.py`); on these noise
frames two angles of 256 part by 9.6e-4 rad, short of a BRIEF bin's
edge. The two tracker runs (20 and 14 frames at 640x480 in JAX)
run the port alone at 320x240 on the same orbit, at the JAX test's gates;
each run captures local mapping once (`local_mapping.capture`) and maps
every keyframe through the runner. The JAX test's third async gate, a
local-mapping stage under half the synchronous one, reads a host clock
that only an asynchronous device queue moves: on the CPU the runner runs
the step where it is called. `chip_smoke.py` phase 5d runs that test on
the card, gates included, at the JAX test's 640x480.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_ssd_semantic_tpu import config as jconfig
from orb_slam2_ssd_semantic_tpu.mapping import map_state as jax_map_state
from orb_slam2_ssd_semantic_tpu.tracking import tracker as jax_tracker
from orb_slam2_ssd_semantic_tpu_torch import config as tconfig
from orb_slam2_ssd_semantic_tpu_torch.mapping import map_state
from orb_slam2_ssd_semantic_tpu_torch.tracking import tracker
from _torch_threads import _few_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
K = 64


def tiny_cfg(mod, F: int = 8):
    """`tests/test_map_hygiene.py::tiny_cfg` in either package's config."""
    return mod.SlamConfig(
        camera=mod.CameraConfig(width=128, height=96, fx=100.0, fy=100.0, cx=64.0, cy=48.0),
        orb=mod.OrbConfig(n_features=K, max_keypoints=K),
        map=mod.MapConfig(max_keyframes=F, max_map_points=256, local_ba_window=4,
                          local_ba_max_points=128, local_ba_fixed_anchors=2,
                          triangulation_neighbors=2, fuse_neighbors=2),
        loop=mod.LoopConfig(enabled=False, enable_relocalization=False),
    )


def tree_of(state):
    if hasattr(state, "_asdict"):
        return {k: tree_of(v) for k, v in state._asdict().items()}
    return np.asarray(state)


def assert_same_state(port: dict, ref: dict, path: str = "state") -> None:
    if isinstance(ref, dict):
        assert port.keys() == ref.keys(), path
        for k in ref:
            assert_same_state(port[k], ref[k], f"{path}.{k}")
    elif np.issubdtype(ref.dtype, np.floating):
        atol = 2e-3 if path.endswith(".angle") else 1e-4
        np.testing.assert_allclose(port, ref, atol=atol, rtol=0, err_msg=path)
    else:
        np.testing.assert_array_equal(port, ref.astype(port.dtype), err_msg=path)


def insert_both(seed: int, poses=None, n: int = 6, F: int = 4):
    """n keyframes of random 128x96 frames at 3 m (each spawning all its
    points) into F slots, through both packages; returns the port's config
    and state, and JAX's state as numpy."""
    rng = np.random.default_rng(seed)
    jcfg, cfg = tiny_cfg(jconfig, F), tiny_cfg(tconfig, F)
    js, ts = jax_map_state.empty_state(jcfg), map_state.empty_state(cfg, CPU)
    for i in range(n):
        gray = rng.uniform(0, 255, (96, 128)).astype(np.float32)
        depth = np.full((96, 128), 3.0, np.float32)
        T = np.eye(4, dtype=np.float32) if poses is None else poses[i]
        js, _ = jax_tracker.insert_keyframe(
            js, jax_tracker.build_frame(jnp.asarray(gray), jnp.asarray(depth), jcfg),
            jnp.asarray(T), jnp.full((K,), -1, jnp.int32), i, float(i), jcfg, spawn_all=True)
        ts, _ = tracker.insert_keyframe(
            ts, tracker.build_frame(torch.from_numpy(gray), torch.from_numpy(depth), cfg),
            torch.from_numpy(T), torch.full((K,), -1, dtype=torch.int64), i, float(i), cfg,
            spawn_all=True)
    assert_same_state(map_state.state_to_numpy(ts), tree_of(js))
    return cfg, ts


def test_keyframe_eviction_when_full():
    _, state = insert_both(seed=2)
    assert int(state.n_kfs) == 4
    uids = state.kfs.uid[state.kfs.valid].tolist()
    assert 0 in uids and 5 in uids
    assert int(state.next_uid) == 6
    assert int(state.kfs.uid[state.last_kf]) == 5


def test_eviction_writes_retirement_record():
    poses = {}
    for i in range(6):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.1 * i, 0.0, 0.05 * i]
        poses[i] = T
    cfg, state = insert_both(seed=3, poses=poses)
    ring = state.retired
    recorded = {int(u): k for k, u in enumerate(ring.uid.tolist()) if u >= 0}
    assert 1 in recorded and 2 in recorded, recorded
    valid = state.kfs.valid.numpy()
    live = {int(u): state.kfs.T_cw[i].numpy() for i, u in enumerate(state.kfs.uid.tolist())
            if valid[i]}
    for u in (1, 2):
        k = recorded[u]
        p = int(ring.parent_uid[k])
        assert p in live or p in recorded, (u, p)
        if p in live:
            assert np.abs(ring.T_rel[k].numpy() @ live[p] - poses[u]).max() < 1e-4
    ref = state.points.ref_kf.numpy()
    for pid in np.nonzero(state.points.valid.numpy())[0][:50]:
        assert 0 <= ref[pid] < cfg.map.max_keyframes and valid[ref[pid]], (pid, ref[pid])


def test_retired_ring_wrap():
    R = 4

    def rings():
        return (map_state.RetiredRing(uid=torch.full((R,), -1, dtype=torch.int32),
                                      parent_uid=torch.full((R,), -1, dtype=torch.int32),
                                      T_rel=torch.eye(4).repeat(R, 1, 1),
                                      count=torch.tensor(0, dtype=torch.int32)),
                jax_map_state.RetiredRing(uid=jnp.full((R,), -1, jnp.int32),
                                          parent_uid=jnp.full((R,), -1, jnp.int32),
                                          T_rel=jnp.tile(jnp.eye(4, dtype=jnp.float32), (R, 1, 1)),
                                          count=jnp.int32(0)))

    def same(ring, jring):
        for f in ("uid", "parent_uid", "T_rel", "count"):
            np.testing.assert_array_equal(getattr(ring, f).numpy(),
                                          np.asarray(getattr(jring, f)), err_msg=f)

    ring, jring = rings()
    for batch in range(3):
        uids = np.array([batch * 2, batch * 2 + 1], np.int32)
        T = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
        T[:, 0, 3] = uids
        ring = map_state.push_retired(ring, torch.ones(2, dtype=torch.bool),
                                      torch.from_numpy(uids), torch.from_numpy(uids + 100),
                                      torch.from_numpy(T))
        jring = jax_map_state.push_retired(jring, jnp.ones((2,), bool), jnp.asarray(uids),
                                           jnp.asarray(uids + 100), jnp.asarray(T))
        same(ring, jring)
    assert int(ring.count) == 6
    assert sorted(ring.uid.tolist()) == [2, 3, 4, 5]
    for i, u in enumerate(ring.uid.tolist()):
        assert float(ring.T_rel[i, 0, 3]) == float(u)
        assert int(ring.parent_uid[i]) == u + 100
    args = (np.array([False, True]), np.array([90, 91], np.int32),
            np.array([190, 191], np.int32), np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)))
    ring2 = map_state.push_retired(ring, *(torch.from_numpy(a) for a in args))
    same(ring2, jax_map_state.push_retired(jring, *(jnp.asarray(a) for a in args)))
    assert int(ring2.count) == 7
    assert 91 in ring2.uid.tolist() and 90 not in ring2.uid.tolist()


QVGA = tconfig.CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=123.8, width=320, height=240)


@pytest.fixture(scope="module")
def orbit():
    from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import SyntheticSequence

    seq = SyntheticSequence(n_frames=20, cam=QVGA)
    return seq, [seq.gray_depth(i) for i in range(len(seq))]


def _run(frames, seq, cfg):
    from orb_slam2_ssd_semantic_tpu_torch.eval.ate import evaluate_ate_xyz

    tr = tracker.Tracker(cfg, device="cpu")
    for i, (g, d) in enumerate(frames):
        tr.process(g, d, float(seq.stamps[i]))
    return tr, evaluate_ate_xyz(tr.camera_positions(), seq.gt_positions()[:len(frames)]).rmse


def _qvga_cfg(**tracking):
    base = tconfig.SlamConfig()
    return tconfig.SlamConfig(
        camera=QVGA, orb=tconfig.OrbConfig(n_features=500, max_keypoints=512),
        tracking=tconfig.TrackingConfig(**tracking),
        map=dataclasses.replace(base.map, max_keyframes=8, local_ba_window=4,
                                local_ba_fixed_anchors=2, triangulation_neighbors=2,
                                fuse_neighbors=2),
        loop=dataclasses.replace(base.loop, enabled=False, enable_relocalization=False))


def test_long_run_beyond_keyframe_capacity(orbit):
    """A keyframe every frame into 8 slots over 20 frames: slots are
    reclaimed, tracking stays OK, and every frame's pose resolves."""
    seq, frames = orbit
    tr, ate = _run(frames, seq, _qvga_cfg(max_frames_between_kfs=0))
    assert int(tr.state.n_kfs) <= 8
    assert int(tr.state.next_uid) >= 16
    assert tr.status == "OK"
    assert len(tr.absolute_poses()) == len(frames)
    assert ate < 0.05, ate


def test_async_mapping_tracks_as_sync(orbit):
    seq, frames = orbit
    out = {}
    for name, async_on in (("sync", False), ("async", True)):
        tr, ate = _run(frames[:14], seq, _qvga_cfg(max_frames_between_kfs=2,
                                                   async_mapping=async_on))
        out[name] = (ate, tr.metrics.stages["local_mapping"].count,
                     tr.metrics.stages["local_mapping.capture"].count)
    assert out["sync"][0] < 0.02 and out["async"][0] < 0.02, out
    assert out["async"][1] >= 2, out
    assert out["sync"][2] == 1 and out["async"][2] == 1, out
