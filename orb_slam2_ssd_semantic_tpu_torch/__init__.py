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
- the device renderer of the synthetic scenes (`io/device_render.py`).
Refused, not ported yet: semantics (`semantic/`), dense mapping
(`dense/`), persistence (`io/map_io.py`), the `system.py` facade and the
multi-device code (`parallel/`). The first four have no module here; the
multi-device entries raise NotImplementedError (`LoopCloser`'s `mesh`,
the sharded global BA).
"""

__version__ = "0.1.0"

from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig  # noqa: F401
