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
  correction (`tracking/segmented.py`).
Dynamic masks come in a later slice: the Tracker refuses any
`dynamic.enable_*` setting, and the scan and segmented runner refuse
`use_flow` and `use_geom`.
"""

__version__ = "0.1.0"

from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig  # noqa: F401
