"""PyTorch + CUDA port of the semantic RGB-D SLAM engine.

Mirrors the layout of the JAX package `orb_slam2_ssd_semantic_tpu`
(which stays the reference): each module here has its counterpart at the
same path there. Plain tensor code is PyTorch; the JAX package's Pallas
kernels are hand-written CUDA C++ for Hopper (`csrc/`, built with nvcc
on first use, see `ops/cuda_match.py` and `ops/cuda_solve.py`).

Importing this package loads neither JAX nor Triton, and nothing of the
JAX package: the host-only modules it needs (`config`, `io/synthetic`,
`io/tum`, `eval/ate`, `utils/metrics`, `io/artifacts` and the numpy half
of `io/vocabulary`) are kept as copies here.

Ported so far:
- RGB-D tracking with local mapping (`tracking.tracker.Tracker.process`);
- relocalization after a loss (`tracking/reloc.py`);
- loop closing (`mapping/loop_closing.py`, run per keyframe by the
  Tracker with the default `LoopConfig`);
- the whole-sequence path: the scan tracker with in-scan loop detection
  (`tracking/scan_tracker.py`) and the segmented runner with mid-run loop
  correction (`tracking/segmented.py`);
- the dynamic masks: dense LK flow (`ops/flow.py`), the RANSAC
  homography (`ops/homography.py`), the flow mask (`dynamic/flowmask.py`)
  and the multi-view geometry mask (`dynamic/geommask.py`), run by the
  Tracker's `dynamic.enable_*` and by the scan's and the segmented
  runner's `use_flow` and `use_geom`;
- the device renderer of the synthetic scenes (`io/device_render.py`);
- semantics: the MobileNetV2-SSDLite detector (`semantic/ssdlite.py`,
  with Flax checkpoints carried across), preprocessing, anchor decode and
  NMS (`semantic/detector.py`), the depth-window and MergeSG fusion
  (`semantic/fusion.py`), the object database (`semantic/object_db.py`)
  and the host metrics of `semantic/consume.py`;
- the semantic half of the facade: `system.SlamSystem` with
  `enable_semantics`, its `track_rgbd` running the keyframe consumers,
  the mode switches, reset, the trajectory writers and the object
  listing and persistence.
Refused, not ported yet: dense mapping (`dense/`, the batched consumer
`semantic/consume.make_batched_consume`), the stereo and monocular front
ends, map persistence (`io/map_io.py`), training (`semantic/train.py`)
and the multi-device code (`parallel/`). `SlamSystem` raises
NotImplementedError for `enable_dense_map`, a `mesh`, `track_stereo`,
`track_monocular`, `save_map`, `load_map`, `save_octomap` and
`load_octomap`; so do `LoopCloser`'s `mesh` and the sharded global BA.
"""

__version__ = "0.1.0"

from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig  # noqa: F401
