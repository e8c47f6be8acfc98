"""System facade: the engine's public API (counterpart of the JAX package's
`system.py`; the reference's System class, perfect/include/System.h:61-131).

Ported: per-frame `track_rgbd` with the keyframe consumers (detection,
2D-to-3D fusion and the object database with `enable_semantics`; the
occupancy map with `enable_dense_map`: the ground split and the raycast
insertion into a `BlockGridMap`, or one dense grid when
`cfg.dense.unbounded` is off), the stereo and monocular front ends
(`track_stereo`, `track_monocular`), the mode switches, reset, the
trajectory writers, the object listing and persistence, and the
persistence of the sparse map (`save_map`, `load_map`) and of the
occupancy map (`save_octomap`, `load_octomap`), in files that load in
either package.

With a device `mesh` (`parallel/mesh.make_mesh`, one process per device)
every rank runs the same system on the same frames: tracking whole on
each rank, the batch subsystems sharded. The loop closer's database over
`kf` and its global BA over `pt`; detection keyframe-sharded over `kf`
(`flush_detections`); the dense grid, when `cfg.dense.unbounded` is off,
in X slabs over `pt` (`parallel/dist_occupancy.py`). Only global rank 0
writes files (trajectories, maps, the octomap, the objects); every rank
must still call the writers that gather (`save_octomap`, `save_objects`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.parallel.mesh import (
    KF_AXIS,
    PT_AXIS,
    axis_size,
    check_mesh,
    gather_rows,
    mesh_device,
)
from orb_slam2_ssd_semantic_tpu_torch.utils import precision


class SlamSystem:
    """Tracking every frame; on each new keyframe detection, fusion and the
    object database (`enable_semantics`) and occupancy insertion
    (`enable_dense_map`). `device=None` runs on the card (raises without
    one), or on the mesh's device. `detector_params`: an `SSDLite`
    state_dict for the detector (default: the trained checkpoint, else
    seeded weights with a warning). `mesh`: a (kf, pt) mesh from
    `parallel/mesh.make_mesh` switches the batch subsystems to their
    sharded forms (module docstring)."""

    def __init__(self, cfg: SlamConfig | None = None, enable_semantics: bool = False,
                 enable_dense_map: bool = False, detector_params=None, mesh=None, device=None):
        from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker

        if mesh is not None:
            check_mesh(mesh)
            device = mesh_device(mesh) if device is None else device
        self.cfg = cfg or SlamConfig()
        self.mesh = mesh
        self.device = device_mod.resolve(device)
        self.tracker = Tracker(self.cfg, device=self.device, mesh=mesh)
        self.localization_only = False
        self.detector = None
        self.object_db = None
        # Detection queue (the reference's RunDetect condvar queue,
        # RunDetect.cc:29-61): keyframe payloads (rgb, depth in metres,
        # T_cw) on the device. On one device the batch is 1: detection on
        # insertion, like the thread waking per keyframe; with a mesh it is
        # the kf-axis size, and the forward is keyframe-sharded over it.
        self._det_queue: list = []
        self._det_batch = 1
        if enable_semantics:
            from orb_slam2_ssd_semantic_tpu_torch.semantic.detector import Detector
            from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import empty_db

            self.detector = Detector(self.cfg.semantic, params=detector_params,
                                     device=self.device)
            self.object_db = empty_db(self.cfg.semantic.max_objects, self.device)
            if mesh is not None:
                self._det_batch = axis_size(mesh, KF_AXIS)
        self._enable_dense_map = enable_dense_map
        self._build_grid()
        self._mono_seed = None

    def _build_grid(self):
        """(Re)create the occupancy map: at construction and on reset (the
        reference clears the octomap with the map, MapDrawer.cc:381-386).
        The ground split's hypotheses come from a CPU generator seeded 0,
        made anew with the map (JAX: `PRNGKey(0)` split per keyframe).
        With a mesh and `dense.unbounded` off, the one working volume is
        split into X slabs over `pt`, X padded up to a multiple of the
        axis size (`_sharded_grid`; `grid` keeps the padded grid's dims
        and origin for the writers)."""
        self.grid = None
        self._sharded_grid = None
        self._ground_gen = torch.Generator().manual_seed(0)
        if not self._enable_dense_map:
            return
        from orb_slam2_ssd_semantic_tpu_torch.dense.occupancy import BlockGridMap, empty_grid

        dense = self.cfg.dense
        if self.mesh is not None and not dense.unbounded:
            from orb_slam2_ssd_semantic_tpu_torch.parallel import dist_occupancy

            ref = empty_grid(resolution=dense.resolution, device=self.device)
            X, Y, Z = ref.shape
            n_sh = axis_size(self.mesh, PT_AXIS)
            if X % n_sh:
                # Only to the pt-axis size: the slabs split over pt alone.
                X = -(-X // n_sh) * n_sh
                res = dense.resolution
                ref = empty_grid(extent=(X * res, Y * res, Z * res), resolution=res,
                                 origin=tuple(float(o) for o in ref.origin.cpu().numpy()),
                                 device=self.device)
            dims = ref.shape
            origin = tuple(float(o) for o in ref.origin.cpu().numpy())
            lo, _ = dist_occupancy.make_sharded_grid(self.mesh, dims, dense.resolution, origin)
            color, n_color = dist_occupancy.make_sharded_colors(self.mesh, dims)
            insert = dist_occupancy.make_sharded_insert(self.mesh, dense, dims, origin)
            self._sharded_grid = dict(log_odds=lo, color=color, n_color=n_color, insert=insert,
                                      ref=ref)
            self.grid = ref
        elif dense.unbounded:
            self.grid = BlockGridMap(dense, block_voxels=dense.block_voxels, device=self.device)
        else:
            self.grid = empty_grid(resolution=dense.resolution, device=self.device)

    def _to_device(self, a) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.to(self.device)
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    # ---- per-frame entry (TrackRGBD, System.cc:262-326) -------------------

    @precision.scoped
    def track_rgbd(self, rgb: np.ndarray, depth: np.ndarray, stamp: float,
                   feats=None) -> np.ndarray:
        """rgb: (H, W, 3) uint8 (or (H, W) gray); depth: (H, W) float32
        metres or uint16 millimetres. Returns T_cw (4, 4)."""
        from orb_slam2_ssd_semantic_tpu_torch.io.tum import rgb_to_gray

        gray = rgb_to_gray(rgb) if rgb.ndim == 3 else rgb
        # Keyframe insertion is found by uid (counts can stay flat when an
        # insertion and a cull coincide; uids are monotonic).
        was_kf_uid = self.tracker._ref_kf_uid
        was_init = self.tracker.initialized
        self.tracker.allow_new_keyframes = not self.localization_only
        T_cw = self.tracker.process(gray, depth, stamp, feats=feats)
        new_kf = self.tracker._ref_kf_uid > was_kf_uid or (
            self.tracker.initialized and not was_init)
        if new_kf:
            self._on_new_keyframe(rgb, depth, T_cw)
        return T_cw

    @precision.scoped
    def track_stereo(self, left: np.ndarray, right: np.ndarray, stamp: float) -> np.ndarray:
        """TrackStereo (System.cc; the reference extracts both images in
        two threads, Frame.cc:196-197, and matches them in the Frame ctor).
        Each rectified image is extracted ONCE; the row-band matcher
        (`ops/stereo.py`) gives the left keypoints depths, scattered into a
        sparse depth image at their (undistorted, rounded) pixels
        (`stereo.sparse_depth_image`: on a shared pixel the later keypoint
        wins), and the left features go on to the RGB-D path with it."""
        from orb_slam2_ssd_semantic_tpu_torch.frontend import extractor
        from orb_slam2_ssd_semantic_tpu_torch.geometry import camera as cam_ops
        from orb_slam2_ssd_semantic_tpu_torch.io.tum import rgb_to_gray
        from orb_slam2_ssd_semantic_tpu_torch.ops.stereo import sparse_depth_image, stereo_match

        cam, orb = self.cfg.camera, self.cfg.orb
        gl = rgb_to_gray(left) if left.ndim == 3 else left
        gr = rgb_to_gray(right) if right.ndim == 3 else right
        fl = extractor.extract(self._to_device(gl).to(torch.float32), orb)
        fr = extractor.extract(self._to_device(gr).to(torch.float32), orb)
        depth, _, ok = stereo_match(fl, fr, cam, orb)
        # At the undistorted pixels, which the RGB-D frame samples again.
        d = sparse_depth_image(cam_ops.undistort_points(fl.uv, cam), depth, ok, cam)
        return self.track_rgbd(gl, d.cpu().numpy(), stamp, feats=fl)

    @precision.scoped
    def track_monocular(self, rgb: np.ndarray, stamp: float) -> np.ndarray:
        """TrackMonocular (System.cc). Before initialization, frames go to
        the two-view initializer (`mapping/initializer.py`) against the
        held seed frame; on success the triangulated structure, scaled to
        a median depth of 1 (CreateInitialMapMonocular), seeds the two
        keyframes through sparse depth images. Afterwards frames track
        without depth: monocular observations, new points only by
        local-mapping triangulation."""
        from orb_slam2_ssd_semantic_tpu_torch.io.tum import rgb_to_gray

        gray = rgb_to_gray(rgb) if rgb.ndim == 3 else rgb
        if self.tracker.initialized:
            return self.track_rgbd(gray, np.zeros(gray.shape, np.float32), stamp)
        return self._mono_initialize(gray, stamp)

    def _mono_initialize(self, gray: np.ndarray, stamp: float) -> np.ndarray:
        from orb_slam2_ssd_semantic_tpu_torch.frontend import extractor
        from orb_slam2_ssd_semantic_tpu_torch.mapping.initializer import initialize_monocular
        from orb_slam2_ssd_semantic_tpu_torch.ops import match as match_ops

        cam = self.cfg.camera
        feats = extractor.extract(self._to_device(gray).to(torch.float32), self.cfg.orb)
        if self._mono_seed is None:
            self._mono_seed = (gray, stamp, feats)
            return np.eye(4, dtype=np.float32)
        g0, t0, f0 = self._mono_seed
        # Wide-window 2D-2D match (SearchForInitialization, radius 100).
        m = match_ops.match_by_window(f0.desc, feats.desc, f0.uv, feats.uv, f0.valid,
                                      feats.valid, radius=100.0, angle_q=f0.angle,
                                      angle_t=feats.angle, max_dist=match_ops.TH_LOW)
        tgt = m.idx.clamp(0, feats.uv.shape[0] - 1)
        out = initialize_monocular(f0.uv, feats.uv[tgt], m.valid, cam)
        if not out["success"]:
            # The newest frame becomes the seed (the reference resets its
            # initializer when matching fails).
            self._mono_seed = (gray, stamp, feats)
            return np.eye(4, dtype=np.float32)
        X = out["pts3d"].cpu().numpy()
        good = out["good"].cpu().numpy()
        med = max(float(np.median(X[good][:, 2])) if good.any() else 1.0, 1e-6)
        X = X / med
        T1 = np.eye(4, dtype=np.float32)
        T1[:3, :3] = out["R"].cpu().numpy()
        T1[:3, 3] = out["t"].cpu().numpy() / med
        # Both views seed keyframes through the RGB-D path, with sparse
        # depth images of the triangulated structure.
        self.track_rgbd(g0, self._sparse_depth(f0.uv.cpu().numpy(), X[:, 2], good, cam), t0)
        z1 = (X @ T1[:3, :3].T + T1[:3, 3])[:, 2]
        uv1 = feats.uv[tgt].cpu().numpy()
        d1 = self._sparse_depth(uv1, z1, good & m.valid.cpu().numpy(), cam)
        self.tracker.frames_since_kf = 10 ** 6  # both initial views are keyframes
        T = self.track_rgbd(gray, d1, stamp)
        self._mono_seed = None
        return T

    @staticmethod
    def _sparse_depth(uv: np.ndarray, z: np.ndarray, ok: np.ndarray, cam) -> np.ndarray:
        img = np.zeros((cam.height, cam.width), np.float32)
        x = np.round(uv[:, 0]).astype(int)
        y = np.round(uv[:, 1]).astype(int)
        keep = ok & (z > 0.05) & (x >= 0) & (x < cam.width) & (y >= 0) & (y < cam.height)
        img[y[keep], x[keep]] = z[keep]
        return img

    @precision.scoped
    def flush_detections(self):
        """Drain the detection queue: one keyframe takes the f32
        single-image path, a longer queue one bf16 forward
        (`Detector.detect_batch`); then fusion (`cfg.semantic.fusion_scheme`)
        and the database merge per keyframe, in queue order (the RunDetect
        consumer processes its whole queue per wake, RunDetect.cc:44-57).

        With a mesh the queue always takes the bf16 forward, and when its
        length divides by the kf-axis size each kf rank detects its own
        slice of it and the fixed-size Detections are all-gathered; every
        rank then fuses every keyframe in queue order, so the object
        databases stay equal."""
        if self.detector is None or not self._det_queue:
            return
        from orb_slam2_ssd_semantic_tpu_torch.semantic.fusion import fuse_detections
        from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import add_objects

        queue, self._det_queue = self._det_queue, []
        if len(queue) == 1 and self.mesh is None:
            dets = [self.detector(queue[0][0])]
        elif self.mesh is not None and len(queue) % axis_size(self.mesh, KF_AXIS) == 0:
            from orb_slam2_ssd_semantic_tpu_torch.semantic.detector import Detections

            n = len(queue) // axis_size(self.mesh, KF_AXIS)
            r = self.mesh.get_local_rank(KF_AXIS)
            local = self.detector.detect_batch([q[0] for q in queue[r * n:(r + 1) * n]])
            dd = [gather_rows(torch.stack(field), self.mesh, KF_AXIS) for field in zip(*local)]
            dets = [Detections(*(x[i] for x in dd)) for i in range(len(queue))]
        else:
            dets = self.detector.detect_batch([q[0] for q in queue])
        for (_, depth, T_cw), det in zip(queue, dets):
            c, s, p, cls, ok = fuse_detections(det, depth, T_cw, self.cfg.camera,
                                               self.cfg.semantic)
            self.object_db = add_objects(self.object_db, c, s, p, cls, ok)

    def _on_new_keyframe(self, rgb, depth, T_cw):
        """Keyframe consumers: detection and semantic fusion (the
        RunDetect/ObjectDatabase path) and occupancy insertion
        (MapDrawer::UpdateOctomap): the keyframe's cloud with gray colors,
        the ground split (ground rays only carve) and the raycast from the
        camera centre."""
        from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import depth_metres

        depth_m = depth_metres(self._to_device(depth))
        T_cw = np.asarray(T_cw, np.float32)
        if self.detector is not None:
            rgb3 = self._to_device(rgb)
            if rgb3.ndim == 2:
                rgb3 = rgb3[..., None].expand(*rgb3.shape, 3)
            self._det_queue.append((rgb3.to(torch.uint8), depth_m, self._to_device(T_cw)))
            if len(self._det_queue) >= self._det_batch:
                self.flush_detections()
        if self.grid is not None:
            self._insert_keyframe_cloud(rgb, depth_m, T_cw)

    def _insert_keyframe_cloud(self, rgb, depth_m: torch.Tensor, T_cw: np.ndarray):
        from orb_slam2_ssd_semantic_tpu_torch.dense import pointcloud
        from orb_slam2_ssd_semantic_tpu_torch.dense.occupancy import BlockGridMap, insert_scan

        dense = self.cfg.dense
        with record_function("dense.cloud"):
            pts, valid, colors = pointcloud.keyframe_cloud(
                depth_m, self._to_device(T_cw), self.cfg.camera, dense,
                gray_img=self._to_device(rgb_to_gray_np(rgb)))
        with record_function("dense.ground"):
            idx = pointcloud.sample_ground_hypotheses(valid, dense.ground_ransac_iters,
                                                      self._ground_gen)
            is_ground, _ = pointcloud.split_ground(pts, valid, idx, 1, dense)
        # The camera centre from the host's f32 inverse, as JAX takes it.
        origin = self._to_device(np.linalg.inv(T_cw)[:3, 3])
        with record_function("dense.insert"):
            if self._sharded_grid is not None:
                sg = self._sharded_grid
                sg["log_odds"], sg["color"], sg["n_color"] = sg["insert"](
                    sg["log_odds"], origin, pts, valid, is_ground, colors=colors,
                    color=sg["color"], n_color=sg["n_color"])
            elif isinstance(self.grid, BlockGridMap):
                self.grid.insert_scan(origin, pts, valid, colors=colors, carve_only=is_ground)
            else:
                self.grid = insert_scan(self.grid, origin, pts, valid, colors=colors,
                                        carve_only=is_ground, cfg=dense)

    # ---- mode switches (System.cc:389-421) --------------------------------

    def activate_localization_mode(self):
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker.frames_since_kf = 0

    def reset(self):
        """System::Reset (System.cc:417, Tracking.cc:3069): a new tracker,
        an empty occupancy map (MapDrawer.cc:381-386), detection queue and
        object database. The mesh stays: the new tracker and grid shard
        over it as before."""
        from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker

        self.tracker = Tracker(self.cfg, device=self.device, mesh=self.mesh)
        self._build_grid()
        self._det_queue = []
        self._mono_seed = None
        if self.object_db is not None:
            from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import empty_db

            self.object_db = empty_db(self.cfg.semantic.max_objects, self.device)

    def shutdown(self):
        """Drain pending keyframe consumers (the reference joins its worker
        threads here, System.cc:424-451)."""
        self.flush_detections()

    # ---- outputs ----------------------------------------------------------

    @property
    def status(self) -> str:
        return self.tracker.status

    def _writes_files(self) -> bool:
        """Without a mesh, always; with one, on global rank 0 alone."""
        return self.mesh is None or dist.get_rank() == 0

    def save_trajectory_tum(self, path: str):
        if self._writes_files():
            self.tracker.save_trajectory_tum(path)

    def save_keyframe_trajectory_tum(self, path: str):
        """SaveKeyFrameTrajectoryTUM (System.cc:508-541)."""
        if not self._writes_files():
            return
        from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
        from orb_slam2_ssd_semantic_tpu_torch.io.tum import write_trajectory

        kfs = self.tracker.state.kfs
        kv = kfs.valid.cpu().numpy()
        uid = kfs.uid.cpu().numpy()
        T_all = kfs.T_cw.cpu().numpy()
        stamp = kfs.stamp.cpu().numpy()
        order = np.argsort(np.where(kv, uid, 2 ** 30))[: int(kv.sum())]
        stamps, ts, qs = [], [], []
        for i in order:
            R, t = T_all[i][:3, :3], T_all[i][:3, 3]
            stamps.append(float(stamp[i]))
            ts.append(-R.T @ t)
            qs.append(se3.rot_to_quat(torch.from_numpy(np.ascontiguousarray(R.T))).numpy())
        write_trajectory(path, stamps, ts, qs)

    def save_trajectory_kitti(self, path: str):
        if not self._writes_files():
            return
        from orb_slam2_ssd_semantic_tpu_torch.io.tum import write_trajectory_kitti

        write_trajectory_kitti(path, [np.linalg.inv(T) for _, T in self.tracker.absolute_poses()])

    def save_map(self, path: str):
        from orb_slam2_ssd_semantic_tpu_torch.io.map_io import save_map

        if self._writes_files():
            save_map(path, self.tracker.state)

    def load_map(self, path: str):
        """Load a saved sparse map into the tracker (tracking resumes
        against it, e.g. in localization mode)."""
        from orb_slam2_ssd_semantic_tpu_torch.io.map_io import load_map

        self.tracker.state = load_map(path, self.cfg, self.device)
        self.tracker.initialized = True
        self.tracker._on_keyframe_inserted()

    def save_octomap(self, path: str):
        """The occupancy map's file; a sharded grid's slabs are gathered
        into the dense grid's layout first (every rank must call)."""
        from orb_slam2_ssd_semantic_tpu_torch.dense.occupancy import BlockGridMap, save_grid

        if self.grid is None:
            raise RuntimeError("dense map not enabled")
        if self._sharded_grid is not None:
            sg = self._sharded_grid
            grid = sg["ref"].replace(**{k: gather_rows(sg[k], self.mesh, PT_AXIS)
                                        for k in ("log_odds", "color", "n_color")})
            if self._writes_files():
                save_grid(path, grid, self.cfg.dense)
            return
        if not self._writes_files():
            return
        if isinstance(self.grid, BlockGridMap):
            self.grid.save(path)
        else:
            save_grid(path, self.grid, self.cfg.dense)

    def load_octomap(self, path: str):
        """A block map's or a dense grid's file, by its keys."""
        from orb_slam2_ssd_semantic_tpu_torch.dense.occupancy import BlockGridMap, load_grid

        with np.load(path) as z:
            is_blocks = "block_keys" in z.files
        if is_blocks:
            self.grid = BlockGridMap.load(path, self.cfg.dense, self.device)
        else:
            self.grid = load_grid(path, self.device)

    def objects(self) -> list:
        from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import summarize

        self.flush_detections()
        return summarize(self.object_db) if self.object_db is not None else []

    def save_objects(self, path: str):
        """Persist the semantic object database: `path` (npz columns) plus
        `path + '.txt'` (objectD.txt-style listing)."""
        from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import (
            save_db,
            save_objects_txt,
        )

        if self.object_db is None:
            raise RuntimeError("semantics not enabled")
        self.flush_detections()
        if not self._writes_files():
            return
        save_db(path, self.object_db)
        save_objects_txt(path + ".txt", self.object_db)

    def load_objects(self, path: str):
        from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import load_db

        self.object_db = load_db(path, self.device)


def rgb_to_gray_np(rgb: np.ndarray) -> np.ndarray:
    """float32 gray of an (H, W, 3) image; a gray image as float32."""
    from orb_slam2_ssd_semantic_tpu_torch.io.tum import rgb_to_gray

    return rgb_to_gray(rgb) if rgb.ndim == 3 else np.asarray(rgb).astype(np.float32)


# Reference-name alias: the reference's facade class is `System`.
System = SlamSystem
