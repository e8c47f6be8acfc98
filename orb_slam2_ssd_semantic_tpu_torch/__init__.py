"""PyTorch + CUDA port of the semantic RGB-D SLAM engine.

Mirrors the layout of the JAX package `orb_slam2_ssd_semantic_tpu`
(which stays the reference): each module here has its counterpart at the
same path there. Plain tensor code is PyTorch; the JAX package's Pallas
kernels are hand-written CUDA C++ for Hopper (`csrc/`, built with nvcc
on first use, see `ops/cuda_match.py` and `ops/cuda_solve.py`), and so
is the port's own batched eigensolver (`ops/cuda_eigh.py`), which keeps
the flow mask's homography off the host.

Importing this package loads neither JAX, Triton nor matplotlib, and
nothing of the JAX package: the host-only modules it needs (`config`,
`io/synthetic`, `io/tum`, `eval/ate`, `utils/metrics`, `io/artifacts`
and the numpy half of `io/vocabulary`) are kept as copies here.

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
  runner's `use_flow` and `use_geom`, each replayed from a CUDA graph
  (`dynamic/graphed_masks.py`);
- the device renderer of the synthetic scenes (`io/device_render.py`);
- semantics: the MobileNetV2-SSDLite detector (`semantic/ssdlite.py`,
  with Flax checkpoints carried across), preprocessing, anchor decode and
  NMS (`semantic/detector.py`), the depth-window and MergeSG fusion
  (`semantic/fusion.py`), the object database (`semantic/object_db.py`)
  and the host metrics of `semantic/consume.py`;
- the facade `system.SlamSystem`: `track_rgbd` with the keyframe
  consumers (semantics with `enable_semantics`, the occupancy map with
  `enable_dense_map`), the stereo and monocular front ends
  (`track_stereo`, `track_monocular`), the mode switches, reset, the
  trajectory writers, the object listing and persistence;
- dense mapping (`dense/`: keyframe clouds, the ground split, the dense
  grid and `BlockGridMap`) and the batched keyframe consumer
  (`semantic/consume.make_batched_consume`);
- persistence of the sparse map (`io/map_io.py`) and of the occupancy
  map, in files that load in either package;
- training of the SSDLite detector (`semantic/train.py`: anchor matching,
  the multibox loss, an Adam step over every array, the synthetic
  detection batches);
- the native prefetching TUM loader (`io/native_loader.py`, built from
  `cpp/tum_loader.cpp` at first use) and the profiler helpers
  (`utils/profiling.py`);
- the offline apps (`apps/`): `run_synthetic`, `rgbd_tum`,
  `detect_locate`, `cloud_to_occupancy`, `train_ssdlite` and
  `train_vocabulary`, each on the card unless given `--device cpu`;
- the live RGB-D app (`apps/live_rgbd.py`: the synthetic, `watch:DIR` and
  `v4l:INDEX` sources) with depth registration and undistortion on the
  device (`ops/register.py`, `geometry/camera.distort`);
- the monocular Sim(3) pose graph
  (`mapping/pose_graph.optimize_pose_graph_sim3` with `Sim3Graph`);
- the viewers: `viz.py` (PNG plots, `draw_trajectory_main`) and the live
  web dashboard `apps/web_viewer.py`; they need matplotlib, which this
  package's import does not load;
- the multi-device code (`parallel/` on `torch.distributed`, one process
  per device over a (kf, pt) `DeviceMesh`): the observation-sharded
  global BA (`global_ba_step_state_sharded`), the keyframe-sharded BoW
  database, query and detection, and the X-slab occupancy grid, behind
  `SlamSystem(mesh=...)`, `Tracker(mesh=...)` and `LoopCloser(mesh=...)`.
Everything the JAX package does is ported.
"""

__version__ = "0.1.0"

from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig  # noqa: F401
