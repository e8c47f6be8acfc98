"""Train MobileNetV2-SSDLite on the synthetic box world (counterpart of the
JAX package's `apps/train_ssdlite.py`).

The reference's detector weights are a pretrained ncnn binary that is
absent from its snapshot, so the engine ships the training path instead
(semantic/train.py). Batches are drawn on the device
(`synthetic_detection_batch_device`), so no image crosses from the host.
The weights are saved in the JAX package's npz layout, which both
packages' `load_params` read.

Usage:
  python -m orb_slam2_ssd_semantic_tpu_torch.apps.train_ssdlite \
      --steps 2000 --batch 16 --out ssdlite_params.npz
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

# Steps per chunk: JAX runs a chunk as one `lax.scan`; here a loop. The
# loss is reported per chunk, every 5 chunks and at the end.
INNER = 10


class TrainResult(NamedTuple):
    model: object  # the trained SSDLite
    chunk_losses: list  # mean loss of each chunk of INNER steps
    seconds: float  # training time, host clock ending in a synchronize


def train(model, steps: int, batch: int, n_cls: int, lr: float = 1e-3, seed: int = 0,
          log=print) -> TrainResult:
    """Adam on device-drawn batches of `n_cls` classes, in chunks of INNER
    steps, until at least `steps` steps have run (JAX's chunking)."""
    import torch

    from orb_slam2_ssd_semantic_tpu_torch.semantic.train import (
        adam,
        make_train_step,
        synthetic_detection_batch_device,
    )

    dev = next(model.parameters()).device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    step = make_train_step(model, adam(model, lr))
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    t0 = time.perf_counter()
    chunk_losses = []
    i = 0
    while i < steps:
        losses = [step(*synthetic_detection_batch_device(gen, batch, n_classes=n_cls))
                  for _ in range(INNER)]
        chunk_losses.append(float(torch.stack(losses).mean()))
        i += INNER
        if (i // INNER) % 5 == 0 or i >= steps:
            log(f"step {i:5d} loss {chunk_losses[-1]:8.4f} "
                f"({(time.perf_counter() - t0):6.1f}s)")
    sync()
    return TrainResult(model, chunk_losses, time.perf_counter() - t0)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--classes", type=int, default=21, help="incl. background")
    p.add_argument("--out", default="ssdlite_params.npz")
    p.add_argument("--device", default=None, help="torch device (default: the card)")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
    from orb_slam2_ssd_semantic_tpu_torch.semantic.ssdlite import init_ssdlite, save_params

    dev = device_mod.resolve(args.device)
    model = init_ssdlite(args.classes, seed=args.seed, device=dev)
    res = train(model, args.steps, args.batch, min(3, args.classes - 1), args.lr, args.seed)
    save_params(args.out, model)
    print(f"saved weights to {args.out}")
    return res


if __name__ == "__main__":
    main()
