"""Default trained-artifact resolution (a copy of the JAX package's
jax-free `io/artifacts.py`; the port keeps its own copy rather than
importing it).

The trained artifacts live in `checkpoints/` at the repository root, or
in `$ORB_SLAM2_TPU_CHECKPOINTS`. Components that resolve them by default
fall back to their untrained substitutes WITH A WARNING when an artifact
is missing; a caller that must not fall back turns the warning into an
error with a `warnings` filter.
"""

from __future__ import annotations

import os
import warnings
from pathlib import Path


def find_checkpoint(name: str) -> str | None:
    """Absolute path of `checkpoints/<name>` resolved relative to the
    package (repo-root layout), or $ORB_SLAM2_TPU_CHECKPOINTS/<name>;
    None if absent."""
    env = os.environ.get("ORB_SLAM2_TPU_CHECKPOINTS")
    candidates = []
    if env:
        candidates.append(Path(env) / name)
    candidates.append(Path(__file__).resolve().parents[2] / "checkpoints" / name)
    for c in candidates:
        if c.exists():
            return str(c)
    return None


def warn_missing(name: str, fallback: str) -> None:
    warnings.warn(
        f"trained artifact '{name}' not found (looked in the repo "
        f"checkpoints/ directory and $ORB_SLAM2_TPU_CHECKPOINTS); "
        f"falling back to {fallback}",
        stacklevel=3,
    )
