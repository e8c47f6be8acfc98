"""`sym_eig` (`csrc/sym_eig.cu`, the flow mask's eigensolver) on the card:
held against `torch.linalg.eigh` at every n it takes, and timed beside
another commit's kernel.

Builds this tree's kernel and, with `--other DIR`, the `csrc/sym_eig.cu`
of another commit's tree unpacked into DIR (its launch function renamed
`sym_eig_other`, built into this tree's `build/`). Then:
- for n = 1..16, seeded symmetric positive semi-definite batches
  (A A^T): the eigenvalues' error against float64 `torch.linalg.eigh` over
  |M|_F, the eigenvectors' departure from orthonormality and the residual
  |M V - V diag(w)|_F / |M|_F, from this tree's kernel;
- at the flow mask's shapes, (128, 9, 9) and (9, 9), on seeded DLT
  systems of 4-point sets (the normal equations of `ops/homography.py`'s
  `_dlt`): each kernel's launch-to-end ms (CUDA events over 20 launches,
  the median of 5 rounds) and its time on the device (20 launches
  replayed from a CUDA graph), the other tree's and this tree's in turns
  (other, this, this, other), beside `torch.linalg.eigh` and an empty
  kernel's launch.

    python3 sym_eig_probe.py [--other DIR]

Needs one CUDA card. Prints one JSON object a line, the card's name and
power limit first; exits 1 if an eigenvalue error passes 1e-5 of |M|_F
(`chip_smoke.py`'s SYM_EIG_TOL).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import chip_smoke  # noqa: E402
from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_build, cuda_eigh  # noqa: E402

SIG = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
       ctypes.c_void_p]


def dlt_systems(rng, batch: int) -> np.ndarray:
    """(batch, 9, 9) A^T A of the DLT rows of 4-point sets, their targets
    1% off the sources."""
    src = rng.standard_normal((batch, 4, 2)).astype(np.float32)
    dst = src + 0.01 * rng.standard_normal((batch, 4, 2)).astype(np.float32)
    x, y, u, v = src[..., 0], src[..., 1], dst[..., 0], dst[..., 1]
    z, o = np.zeros_like(x), np.ones_like(x)
    A = np.concatenate([np.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1),
                        np.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)], -2)
    return np.ascontiguousarray(A.transpose(0, 2, 1) @ A)


def launcher(name: str, M: torch.Tensor):
    """A call of kernel `name` on M into fresh outputs, on the current
    stream (so that a graph's capture records it)."""
    n = M.shape[-1]
    batch = M.reshape(-1, n, n).shape[0]

    def call():
        w = torch.empty(batch, n, device=M.device)
        v = torch.empty(batch, n, n, device=M.device)
        cuda_build.launch(cuda_build.Prepared(
            name, (M.data_ptr(), batch, n, w.data_ptr(), v.data_ptr(),
                   torch.cuda.current_stream(M.device).cuda_stream), (M, w, v)))
    return call


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--other", help="another commit's tree, unpacked")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("sym_eig_probe: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(json.dumps({"card": chip_smoke.card_line(), "other": args.other}), flush=True)
    names = ["sym_eig"]
    if args.other:
        src = (Path(args.other) / "orb_slam2_ssd_semantic_tpu_torch" / "csrc"
               / "sym_eig.cu").read_text()
        copy = HERE / "build" / "sym_eig_probe" / "sym_eig_other.cu"
        copy.parent.mkdir(parents=True, exist_ok=True)
        copy.write_text(src.replace("int sym_eig(", "int sym_eig_other("))
        cuda_build.register("sym_eig_other", copy, SIG)
        names.append("sym_eig_other")
    cuda_build.register("launch_floor", HERE / "launch_floor.cu", [ctypes.c_void_p])
    cuda_build.build_all(force=True, extra=tuple(names[1:]) + ("launch_floor",))

    rng = np.random.default_rng(0)
    worst = 0.0
    for n in range(1, cuda_eigh.MAX_N + 1):
        A = rng.standard_normal((37, n, n)).astype(np.float32)
        M = torch.from_numpy(np.ascontiguousarray(A @ A.transpose(0, 2, 1)))
        w, v = cuda_eigh.eigh_small(M.to(dev))
        w, v = w.cpu().double(), v.cpu().double()
        wr = torch.linalg.eigh(M.double())[0]
        nrm = torch.linalg.norm(M.double(), dim=(-1, -2))
        err = float(((w - wr).abs().amax(-1) / nrm).max())
        orth = float((v.transpose(-1, -2) @ v - torch.eye(n, dtype=torch.float64)).abs().max())
        res = float((torch.linalg.norm(M.double() @ v - v * w[:, None, :], dim=(-1, -2))
                     / nrm).max())
        worst = max(worst, err)
        print(json.dumps(dict(n=n, eig_err=err, orth_err=orth, residual=res)), flush=True)

    floor = chip_smoke.launch_floor_ms()
    for M in (dlt_systems(rng, 128), dlt_systems(rng, 1)[0]):
        M = torch.from_numpy(M).to(dev)
        times = {name: [] for name in names}
        for name in names[::-1] + names:  # other, this, this, other
            call = launcher(name, M)
            times[name].append(dict(ms=chip_smoke._time_ms(call),
                                    device_ms=chip_smoke._graph_ms(call)))
        print(json.dumps(dict(shape=list(M.shape), times=times, launch_floor_ms=floor,
                              eigh_ms=chip_smoke._time_ms(lambda: torch.linalg.eigh(M)))),
              flush=True)
    return 1 if worst > chip_smoke.SYM_EIG_TOL else 0


if __name__ == "__main__":
    sys.exit(main())
