"""The device mesh and the collectives the sharded modules share
(counterpart of the JAX package's `parallel/mesh.py`).

The reference has no distributed backend; the scale-out axes are:

- ``kf``: keyframe parallelism. Batched per-keyframe work (detection,
  the BoW database and its queries) is split over keyframes.
- ``pt``: observation and point parallelism. Bundle adjustment's
  residual and Hessian-block sums are split over observations and
  all-reduced (a distributed Schur complement); the dense grid is split
  into X slabs.

The port runs one process per device (multi-process SPMD, PyTorch's idiom
for more than one device): NCCL between cards, gloo on the CPU. The
(`kf`, `pt`) mesh is a `torch.distributed.device_mesh.DeviceMesh` over
the default process group, which the caller initializes (`torchrun`, or
`torch.distributed.init_process_group`). A `shard_map` body of the JAX
package becomes a plain function on the rank's own shard:

- JAX's `psum` is `psum`: an `all_reduce` over the axis's group;
- `all_gather(tiled=True)` is `gather_rows`;
- `axis_index` is `mesh.get_local_rank(axis)`;
- a sharded global array is the rows this rank owns (`shard_rows`), which
  is what the JAX module's `kf_sharding` and `pt_sharding` place on a
  device;
- a replicated input (`P()`, the JAX module's `replicated`) is the same
  tensor on every rank, broadcast from the group's first rank before each
  sharded call (`replicate`), so replicas cannot drift.

Nothing here touches `torch.distributed` at import time.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod

KF_AXIS = "kf"
PT_AXIS = "pt"


def make_mesh(n_kf: int | None = None, n_pt: int = 1, device=None):
    """A (kf, pt) `DeviceMesh` over the default process group, with every
    rank on `kf` by default (n_kf = world size // n_pt), as JAX puts every
    device there. `device=None` takes the card (NCCL; raises without one)
    and sets `cuda:<local rank>` (`LOCAL_RANK`, else the global rank modulo
    the cards); the CPU (gloo) only when asked for."""
    dev = device_mod.resolve(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs the default process group: run under torchrun or call "
            "torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if n_kf is None:
        n_kf = world // n_pt
    if n_kf * n_pt != world:
        raise ValueError(f"a ({n_kf}, {n_pt}) mesh needs {n_kf * n_pt} ranks, the group has "
                         f"{world}")
    if dev.type == "cuda":
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else dist.get_rank() % torch.cuda.device_count())
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, (n_kf, n_pt), mesh_dim_names=(KF_AXIS, PT_AXIS))


def check_mesh(mesh) -> None:
    """Raise unless `mesh` is a DeviceMesh with the (kf, pt) axes."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh) or tuple(mesh.mesh_dim_names or ()) != (KF_AXIS, PT_AXIS):
        raise TypeError(f"expected a (kf, pt) DeviceMesh from parallel.mesh.make_mesh, got "
                        f"{mesh!r}")


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def shard_rows(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The rows [r * n / k, (r + 1) * n / k) of `x` (n rows on dim 0) that
    this rank owns along `axis` (k ranks on it, r this rank's index); n
    must divide by k."""
    n, k = x.shape[0], axis_size(mesh, axis)
    if n % k:
        raise ValueError(f"{n} rows do not divide over the {k} ranks of axis {axis!r}")
    r = mesh.get_local_rank(axis)
    return x[r * (n // k):(r + 1) * (n // k)]


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """`x` summed over the ranks of `axis`, in place; returns it."""
    dist.all_reduce(x, group=mesh.get_group(axis))
    return x


def gather_rows(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The ranks' `x` along `axis` stacked in rank order on dim 0 (JAX's
    tiled `all_gather`)."""
    group = mesh.get_group(axis)
    out = x.new_empty((x.shape[0] * dist.get_world_size(group),) + tuple(x.shape[1:]))
    # `all_gather_single` where this torch has it (later versions deprecate
    # `all_gather_into_tensor` for it; the signature is the same).
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=group)
    return out


def replicate(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """`x` as the first rank of `axis` holds it, on every rank of `axis`."""
    group = mesh.get_group(axis)
    x = x.contiguous().clone()
    dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    return x
