"""Spatially sharded occupancy mapping over the device mesh (counterpart
of the JAX package's `parallel/dist_occupancy.py`).

The dense map is the largest state object (a room at 0.05 m is ~4M
voxels), so it is what gets partitioned: the grid is split into X-axis
slabs over the mesh's ``pt`` axis, rank r holding X rows
[r * Xs, (r + 1) * Xs). Every scan's origin and endpoints (a few hundred
KB) are replicated to all ranks, and each rank applies the per-scan
free/occupied key-set update of `dense/occupancy.py` to its own slab,
dropping the marks that fall outside it. A ray that crosses slabs
therefore needs no halo exchange: each rank sees every ray and
rasterizes the part that lands in its slab. The voxel state never moves.

Each slab keeps the JAX module's slab-local arithmetic: voxel indices are
floor((p - slab_origin) / res) from the slab's own corner (origin + r *
Xs * res along X, in f32), occupied wins over free, the log-odds clamp,
and the first-ray colour dedup per slab (amin over ray numbers, marks
outside the slab dropped). It runs the same order-free marks and atomic
amin/amax as the single-device insert (`dense/occupancy._insert` on a
slab-sized grid).

Scope: the single working volume is sharded; `BlockGridMap` is not.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch.config import DenseMapConfig
from orb_slam2_ssd_semantic_tpu_torch.dense import occupancy
from orb_slam2_ssd_semantic_tpu_torch.parallel.mesh import (
    PT_AXIS,
    axis_size,
    mesh_device,
    replicate,
)


def _slab_dims(mesh, dims) -> tuple:
    n = axis_size(mesh, PT_AXIS)
    X, Y, Z = dims
    if X % n:
        raise ValueError(f"X={X} must divide over {n} slabs")
    return X // n, Y, Z


def make_sharded_grid(mesh, dims, resolution: float, origin):
    """This rank's slab of an (X, Y, Z) log-odds grid split into X slabs
    over `pt` (X must divide by the axis size), and the grid's meta:
    (log_odds (X / n, Y, Z) zeros, meta)."""
    lo = torch.zeros(_slab_dims(mesh, dims), dtype=torch.float32, device=mesh_device(mesh))
    meta = dict(dims=tuple(dims), resolution=resolution,
                origin=np.asarray(origin, np.float32), n_shards=axis_size(mesh, PT_AXIS))
    return lo, meta


def make_sharded_colors(mesh, dims):
    """This rank's slabs of the per-voxel color accumulators, in
    `make_sharded_grid`'s layout: ((X / n, Y, Z, 3) color sum,
    (X / n, Y, Z) sample count)."""
    xs = _slab_dims(mesh, dims)
    dev = mesh_device(mesh)
    return (torch.zeros(xs + (3,), dtype=torch.float32, device=dev),
            torch.zeros(xs, dtype=torch.float32, device=dev))


def make_sharded_insert(mesh, cfg: DenseMapConfig, dims, origin):
    """The sharded per-scan insert: insert(log_odds, origin_w, points_w,
    point_valid, carve_only=None) -> log_odds, or with per-point `colors`
    and the accumulators of `make_sharded_colors`,
    insert(..., colors=, color=, n_color=) -> (log_odds, color, n_color).
    log_odds, color and n_color are this rank's slabs; the scan's tensors
    are replicated (broadcast from the axis's first rank)."""
    Xs = _slab_dims(mesh, dims)[0]
    r = mesh.get_local_rank(PT_AXIS)
    # The slab's corner in f32, as JAX computes it: origin + [r * Xs * res, 0, 0].
    off = np.float32(np.float32(r) * np.float32(Xs)) * np.float32(cfg.resolution)
    slab_origin = np.asarray(origin, np.float32) + np.asarray([off, 0.0, 0.0], np.float32)
    slab_origin = torch.from_numpy(slab_origin).to(mesh_device(mesh))

    def insert(log_odds, origin_w, points_w, point_valid, carve_only=None, colors=None,
               color=None, n_color=None):
        if carve_only is None:
            carve_only = torch.zeros_like(point_valid)
        origin_w, points_w, point_valid, carve_only = (
            replicate(t, mesh, PT_AXIS) for t in (origin_w, points_w, point_valid, carve_only))
        if colors is not None:
            colors = replicate(colors, mesh, PT_AXIS)
        slab = occupancy.VoxelGrid(log_odds, color, n_color, slab_origin)
        out = occupancy._insert(slab, occupancy.ray_samples(origin_w, points_w, cfg), points_w,
                                point_valid, colors, carve_only, cfg)
        if colors is None:
            return out.log_odds
        return out.log_odds, out.color, out.n_color

    return insert
