"""System facade: the engine's public API (counterpart of the JAX package's
`system.py`; the reference's System class, perfect/include/System.h:61-131).

Ported: per-frame `track_rgbd` with the semantic keyframe consumers
(detection, 2D-to-3D fusion, the object database), the mode switches,
reset, the trajectory writers and the object listing and persistence.
Refused with NotImplementedError until their slice is ported: the dense
occupancy map (`enable_dense_map`, `save_octomap`, `load_octomap`), the
stereo and monocular front ends, map persistence (`save_map`,
`load_map`) and a device `mesh`.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.utils import precision

_DENSE = ("dense mapping (dense/pointcloud.py, dense/occupancy.py) is not ported yet; it is the "
          "next slice")
_SENSORS = ("the stereo and monocular front ends (ops/stereo.py, mapping/initializer.py) are "
            "not ported yet; they come with the dense-mapping slice")
_MAP_IO = "map persistence (io/map_io.py) is not ported yet; it comes with the dense-mapping slice"
_MESH = "the multi-device code (parallel/) is not ported yet; it is a later slice"


class SlamSystem:
    """Tracking every frame; detection, fusion and the object database on
    each new keyframe (`enable_semantics`). `device=None` runs on the card
    (raises without one). `detector_params`: an `SSDLite` state_dict for
    the detector (default: the trained checkpoint, else seeded weights
    with a warning)."""

    def __init__(self, cfg: SlamConfig | None = None, enable_semantics: bool = False,
                 enable_dense_map: bool = False, detector_params=None, mesh=None, device=None):
        from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker

        if enable_dense_map:
            raise NotImplementedError(_DENSE)
        if mesh is not None:
            raise NotImplementedError(_MESH)
        self.cfg = cfg or SlamConfig()
        self.device = device_mod.resolve(device)
        self.tracker = Tracker(self.cfg, device=self.device)
        self.localization_only = False
        self.detector = None
        self.object_db = None
        # Detection queue (the reference's RunDetect condvar queue,
        # RunDetect.cc:29-61): keyframe payloads (rgb, depth in metres,
        # T_cw) on the device. On one device the batch is 1: detection on
        # insertion, like the thread waking per keyframe.
        self._det_queue: list = []
        self._det_batch = 1
        if enable_semantics:
            from orb_slam2_ssd_semantic_tpu_torch.semantic.detector import Detector
            from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import empty_db

            self.detector = Detector(self.cfg.semantic, params=detector_params,
                                     device=self.device)
            self.object_db = empty_db(self.cfg.semantic.max_objects, self.device)

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

    def track_stereo(self, left, right, stamp: float):
        raise NotImplementedError(_SENSORS)

    def track_monocular(self, rgb, stamp: float):
        raise NotImplementedError(_SENSORS)

    @precision.scoped
    def flush_detections(self):
        """Drain the detection queue: one keyframe takes the f32
        single-image path, a longer queue one bf16 forward
        (`Detector.detect_batch`); then fusion (`cfg.semantic.fusion_scheme`)
        and the database merge per keyframe, in queue order (the RunDetect
        consumer processes its whole queue per wake, RunDetect.cc:44-57)."""
        if self.detector is None or not self._det_queue:
            return
        from orb_slam2_ssd_semantic_tpu_torch.semantic.fusion import fuse_detections
        from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import add_objects

        queue, self._det_queue = self._det_queue, []
        if len(queue) == 1:
            dets = [self.detector(queue[0][0])]
        else:
            dets = self.detector.detect_batch([q[0] for q in queue])
        for (_, depth, T_cw), det in zip(queue, dets):
            c, s, p, cls, ok = fuse_detections(det, depth, T_cw, self.cfg.camera,
                                               self.cfg.semantic)
            self.object_db = add_objects(self.object_db, c, s, p, cls, ok)

    def _on_new_keyframe(self, rgb, depth, T_cw):
        """Keyframe consumers: detection and semantic fusion (the
        RunDetect/ObjectDatabase path). The occupancy half waits for dense
        mapping."""
        from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import depth_metres

        if self.detector is None:
            return
        rgb3 = self._to_device(rgb)
        if rgb3.ndim == 2:
            rgb3 = rgb3[..., None].expand(*rgb3.shape, 3)
        self._det_queue.append((rgb3.to(torch.uint8),
                                depth_metres(self._to_device(depth)),
                                self._to_device(np.asarray(T_cw, np.float32))))
        if len(self._det_queue) >= self._det_batch:
            self.flush_detections()

    # ---- mode switches (System.cc:389-421) --------------------------------

    def activate_localization_mode(self):
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker.frames_since_kf = 0

    def reset(self):
        """System::Reset (System.cc:417, Tracking.cc:3069): a new tracker,
        an empty detection queue and object database."""
        from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker

        self.tracker = Tracker(self.cfg, device=self.device)
        self._det_queue = []
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

    def save_trajectory_tum(self, path: str):
        self.tracker.save_trajectory_tum(path)

    def save_keyframe_trajectory_tum(self, path: str):
        """SaveKeyFrameTrajectoryTUM (System.cc:508-541)."""
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
        from orb_slam2_ssd_semantic_tpu_torch.io.tum import write_trajectory_kitti

        write_trajectory_kitti(path, [np.linalg.inv(T) for _, T in self.tracker.absolute_poses()])

    def save_map(self, path: str):
        raise NotImplementedError(_MAP_IO)

    def load_map(self, path: str):
        raise NotImplementedError(_MAP_IO)

    def save_octomap(self, path: str):
        raise NotImplementedError(_DENSE)

    def load_octomap(self, path: str):
        raise NotImplementedError(_DENSE)

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
        save_db(path, self.object_db)
        save_objects_txt(path + ".txt", self.object_db)

    def load_objects(self, path: str):
        from orb_slam2_ssd_semantic_tpu_torch.semantic.object_db import load_db

        self.object_db = load_db(path, self.device)


# Reference-name alias: the reference's facade class is `System`.
System = SlamSystem
