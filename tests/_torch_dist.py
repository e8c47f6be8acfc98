"""Spawned gloo ranks for the port's multi-device tests
(`test_torch_parallel.py`, `test_torch_mesh_engine.py`).

`Ranks(job, world, *args)` spawns `world` processes; each joins a gloo
group (a `file://` store in a temporary directory), holds torch at one
thread and runs `job(rank, world, *args)`, a function of this module;
`.result()` waits and returns rank 0's value. The parent computes the
JAX side meanwhile. This module imports the port, numpy and torch, never
JAX, so the children never load it.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from orb_slam2_ssd_semantic_tpu_torch import config as tconfig
from orb_slam2_ssd_semantic_tpu_torch.parallel.mesh import make_mesh

ROOM = (5.0, 3.0, 6.0)
FLAT_BOX = (161.5, -1.0, -1.0, -1.0, -1.0, -1.0)  # box 0 in class 2's gray band
VOCAB = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "checkpoints",
                     "orbvoc_synth.npz")
JOIN_TIMEOUT_S = 600


def _entry(rank, world, store, out, job, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        res = globals()[job](rank, world, *args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()


class Ranks:
    """Spawned ranks running one job; `result()` joins them."""

    def __init__(self, job: str, world: int, *args):
        self._dir = tempfile.TemporaryDirectory()
        self._out = os.path.join(self._dir.name, "rank0.pkl")
        self._ctx = mp.start_processes(
            _entry, args=(world, os.path.join(self._dir.name, "store"), self._out, job, args),
            nprocs=world, join=False, start_method="spawn")

    def result(self):
        try:
            while not self._ctx.join(timeout=JOIN_TIMEOUT_S):
                pass
            with open(self._out, "rb") as f:
                return pickle.load(f)
        finally:
            for p in self._ctx.processes:
                if p.is_alive():
                    p.terminate()
            self._dir.cleanup()


def small_cfg(**over):
    """`test_torch_system.py`'s 160x120 config with loop closing on the
    in-repo vocabulary, relocalization off, the dense grid bounded at
    0.1 m, and the score gates at 0."""
    base = tconfig.SlamConfig()
    return dataclasses.replace(
        base,
        camera=tconfig.CameraConfig(fx=134.0, fy=134.0, cx=80.0, cy=60.0, width=160, height=120),
        orb=tconfig.OrbConfig(n_features=100, max_keypoints=128),
        tracking=dataclasses.replace(base.tracking, max_frames_between_kfs=4),
        loop=dataclasses.replace(base.loop, enabled=True, enable_relocalization=False,
                                 vocabulary_path=VOCAB),
        semantic=dataclasses.replace(base.semantic, det_score_threshold=0.0,
                                     fusion_prob_threshold=0.0),
        dense=dataclasses.replace(base.dense, unbounded=False, resolution=0.1, **over),
    )


def frames(cam, n):
    """The orbit's first n poses (camera to world) in the room with box 0
    flat, rendered on the CPU: (poses, gray uint8, depth uint16 mm)."""
    from orb_slam2_ssd_semantic_tpu_torch.io.device_render import render_frames
    from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import orbit_trajectory

    poses = orbit_trajectory(n, room=ROOM).astype(np.float32)
    g, d = render_frames(poses, cam, size=ROOM, seed=17, box_gray=FLAT_BOX, device="cpu")
    return poses, g.numpy(), d.numpy()


# ---- test_torch_parallel.py: the five twins of tests/test_parallel.py -------


def parallel_job(rank, world, data):
    """The distributed GBA (and its all-reduce sizes), the pose step, the
    sharded occupancy and the sharded BoW build and detect on `world`
    ranks."""
    from orb_slam2_ssd_semantic_tpu_torch.config import DenseMapConfig, OptimizerConfig
    from orb_slam2_ssd_semantic_tpu_torch.mapping import global_ba as tgba
    from orb_slam2_ssd_semantic_tpu_torch.mapping import place_recognition as pr
    from orb_slam2_ssd_semantic_tpu_torch.parallel import dist_ba, dist_bow, dist_occupancy
    from orb_slam2_ssd_semantic_tpu_torch.parallel.mesh import (
        KF_AXIS,
        PT_AXIS,
        gather_rows,
        shard_rows,
    )

    out = {}
    cam = tconfig.CameraConfig(depth_bf=400.0)
    mesh = make_mesh(n_kf=1, n_pt=world, device="cpu")
    prob = tgba.GlobalBAProblem(**{k: torch.from_numpy(v) for k, v in data["gba"].items()})
    obs = ("obs_kf", "obs_pt", "obs_uvr", "inv_sigma2", "is_stereo", "obs_valid")
    local = prob.replace(**{k: shard_rows(getattr(prob, k), mesh, PT_AXIS) for k in obs})
    res = dist_ba.make_distributed_global_ba(mesh, cam, OptimizerConfig(), cg_iters=25)(local)
    out["gba"] = dict(T_cw=res.T_cw.numpy(), points=res.points.numpy(),
                      inlier=gather_rows(res.inlier, mesh, PT_AXIS).numpy())

    # The leading rows of every all-reduce of a 5-step run.
    sizes, reduce = [], dist.all_reduce

    def recorder(t, *a, **kw):
        sizes.append(t.shape[0] if t.dim() else 1)
        return reduce(t, *a, **kw)

    dist.all_reduce = recorder
    try:
        dist_ba.make_distributed_global_ba(mesh, cam, OptimizerConfig(), cg_iters=5)(local)
    finally:
        dist.all_reduce = reduce
    out["reduce_sizes"] = sizes

    p = data["pose"]
    step = dist_ba.make_distributed_pose_step(mesh, cam)
    out["pose"] = step(torch.eye(4), *(shard_rows(torch.from_numpy(p[k]), mesh, PT_AXIS)
                                       for k in ("pts", "obs", "w"))).numpy()

    occ = data["occ"]
    dcfg = DenseMapConfig(resolution=0.1, max_ray_steps=64)
    lo, _ = dist_occupancy.make_sharded_grid(mesh, occ["dims"], dcfg.resolution, occ["origin"])
    insert = dist_occupancy.make_sharded_insert(mesh, dcfg, occ["dims"], occ["origin"])
    for o, pts, valid, carve in occ["scans"]:
        lo = insert(lo, *(torch.from_numpy(a) for a in (o, pts, valid, carve)))
    out["occ"] = gather_rows(lo, mesh, PT_AXIS).numpy()

    bow = data["bow"]
    kf_mesh = make_mesh(n_kf=world, n_pt=1, device="cpu")
    rows = lambda a: shard_rows(torch.from_numpy(a), kf_mesh, KF_AXIS)  # noqa: E731
    db = dist_bow.make_sharded_bow_vectors(kf_mesh, pr.bow_vector)(
        rows(bow["desc"].view(np.int32)), rows(bow["valid"]))
    detect = dist_bow.make_sharded_detect(kf_mesh, max_candidates=4)
    ids, s, ok = detect(torch.from_numpy(bow["query"]), db, rows(bow["db_valid"]),
                        rows(bow["exclude"]), bow["min_score"])
    out["bow"] = dict(db=gather_rows(db, kf_mesh, KF_AXIS).numpy(), ids=ids.numpy(),
                      scores=s.numpy(), ok=ok.numpy())
    return out


# ---- test_torch_mesh_engine.py: the six twins of tests/test_mesh_engine.py --


def _grid_arrays(sys_):
    from orb_slam2_ssd_semantic_tpu_torch.parallel.mesh import PT_AXIS, gather_rows

    sg = sys_._sharded_grid
    return {k: gather_rows(sg[k], sys_.mesh, PT_AXIS).numpy() for k in ("log_odds", "color")}


def engine_job(rank, world, g, d, n_reset, payloads, out_dir):
    """`SlamSystem(mesh=...)` with the dense map on a (1, world) mesh over
    the frames (gray, depth); its grid, BoW scores and the sharded GBA on
    its state, and its octomap and trajectory written into `out_dir` by
    every rank's call; a system with semantics on the first `n_reset`
    frames, reset, and on them again; keyframe-sharded detection of
    `payloads` on a (world, 1) mesh."""
    from orb_slam2_ssd_semantic_tpu_torch.mapping.global_ba import global_ba_step_state_sharded
    from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import state_to_numpy
    from orb_slam2_ssd_semantic_tpu_torch.system import SlamSystem

    cfg = small_cfg()
    mesh = make_mesh(n_kf=1, n_pt=world, device="cpu")
    sys_ = SlamSystem(cfg, enable_dense_map=True, mesh=mesh)
    for i in range(len(g)):
        sys_.track_rgbd(g[i], d[i], i / 30.0)
    tr, lc = sys_.tracker, sys_.tracker.loop_closer
    state = tr.state
    kf = int(state.last_kf)
    gba = global_ba_step_state_sharded(state, cfg, mesh)
    sys_.save_octomap(os.path.join(out_dir, "octo.npz"))
    sys_.save_trajectory_tum(os.path.join(out_dir, f"trajectory_rank{rank}.txt"))
    out = dict(status=sys_.status, positions=tr.camera_positions(),
               stats=[s["status"] for s in tr.stats], grid=_grid_arrays(sys_),
               slab_x=int(sys_._sharded_grid["log_odds"].shape[0]),
               grid_x=int(sys_.grid.shape[0]), sharded_scores=lc._sharded_scores is not None,
               db_rows=int(lc.word_db.shape[0]), kf=kf,
               scores=lc.frame_scores(state.kfs.desc[kf], state.kfs.kp_valid[kf]),
               state=state_to_numpy(state), gba_T=gba.kfs.T_cw.numpy(),
               gba_pos=gba.points.pos.numpy())

    # System::Reset under the mesh.
    sys_ = SlamSystem(cfg, enable_dense_map=True, enable_semantics=True, mesh=mesh)
    for i in range(n_reset):
        sys_.track_rgbd(g[i], d[i], i / 30.0)
    before = bool(_grid_arrays(sys_)["log_odds"].any())
    sys_.reset()
    after = _grid_arrays(sys_)["log_odds"]
    out["reset"] = dict(
        grid_before=before, tracker_mesh=sys_.tracker.mesh is mesh,
        closer_mesh=sys_.tracker.loop_closer.mesh is mesh,
        sharded=sys_._sharded_grid is not None, slab_x=int(sys_._sharded_grid["log_odds"].shape[0]),
        grid_after=bool(after.any()), objects=int(sys_.object_db.valid.sum()))
    for i in range(n_reset):
        sys_.track_rgbd(g[i], d[i], i / 30.0)
    out["reset"]["status"] = sys_.status
    out["detection"] = detect_keyframes(
        SlamSystem(cfg, enable_semantics=True, mesh=make_mesh(n_kf=world, n_pt=1, device="cpu")),
        payloads)
    return out


def detect_keyframes(sys_, payloads) -> dict:
    """Keyframe payloads (rgb, depth in metres, T_cw) through
    `_on_new_keyframe`, then a flush: the detection batch and the object
    database."""
    for rgb, depth, T_cw in payloads:
        sys_._on_new_keyframe(rgb, depth, T_cw)
    det_batch = sys_._det_batch
    sys_.flush_detections()
    db = sys_.object_db
    return dict(det_batch=det_batch, valid=db.valid.numpy(), centroid=db.centroid.numpy())
