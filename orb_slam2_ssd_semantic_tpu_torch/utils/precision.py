"""True-f32 matmul and convolution precision, scoped to the entry points.

SLAM geometry cannot survive reduced-precision contractions (the JAX
package forces HIGHEST matmul precision for the same reason: bf16
multiplies put ~2 cm of error on 5 m coordinates). On Hopper the risk is
TF32, which keeps ~3 decimal digits: float32 matmuls default to full f32
(`torch.backends.cuda.matmul.allow_tf32 = False`) but cuDNN convolutions
default to TF32. The scope turns both off and restores the caller's
settings on exit, so a host application keeps its own defaults.
"""

from __future__ import annotations

import contextlib
import functools

import torch


@contextlib.contextmanager
def highest_precision():
    """Context manager: no TF32 in matmuls or cuDNN convolutions."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def scoped(fn):
    """Decorator: run `fn` under `highest_precision()` (applied to
    `Tracker.process`)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with highest_precision():
            return fn(*args, **kwargs)

    return wrapped
