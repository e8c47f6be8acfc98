"""True-f32 matmul and convolution precision, and deterministic kernels,
scoped to the entry points.

SLAM geometry cannot survive reduced-precision contractions (the JAX
package forces HIGHEST matmul precision for the same reason: bf16
multiplies put ~2 cm of error on 5 m coordinates). On Hopper the risk is
TF32, which keeps ~3 decimal digits: float32 matmuls default to full f32
(`torch.backends.cuda.matmul.allow_tf32 = False`) but cuDNN convolutions
default to TF32. The scope turns both off.

It also makes every CUDA op deterministic (`torch.use_deterministic_algorithms`):
by default a float `index_add_` adds in the order its atomics land, and an
index assignment with repeated indices keeps whichever write lands last.
Local mapping carries such a difference into the map at a keyframe, and
two runs on the same frames then part by up to half a millimetre (H100
runs of `chip_smoke.py` phase 8a; `determinism_probe.py`). Under the
scope a run repeats bit for bit, and an op with no deterministic
implementation raises rather than run. Such scatters sort their indices
first (about 70 more launches on a tracked frame of 12,000), and walk the
repeats of one index in order (see `mapping/global_ba.py` on empty
slots). Uninitialised memory is not filled: the port reads none.

The scope restores the caller's settings on exit, so a host application
keeps its own defaults.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.utils.deterministic


@contextlib.contextmanager
def highest_precision():
    """Context manager: no TF32 in matmuls or cuDNN convolutions, and
    deterministic algorithms only."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.utils.deterministic.fill_uninitialized_memory)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])
        torch.utils.deterministic.fill_uninitialized_memory = saved[4]


def scoped(fn):
    """Decorator: run `fn` under `highest_precision()` (applied to the
    entry points: `Tracker.process`, the scan, the segmented runner, loop
    closing, relocalization, global BA and the pose graphs)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with highest_precision():
            return fn(*args, **kwargs)

    return wrapped
