"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with
`device=None` they take `cuda` and raise when no card is present — a
measurement or a run never silently falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """`None` -> the CUDA device (raises without one); otherwise the
    device asked for (a `cuda` request also needs a card)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev
