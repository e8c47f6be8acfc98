"""Probabilistic occupancy mapping, the octomap equivalent (counterpart of
the JAX package's `dense/occupancy.py`; the reference's ColorOcTree
pipeline, perfect/src/MapDrawer.cc:376-1025).

Keyframe clouds are raycast into a log-odds voxel grid with the
reference's sensor model (hit 0.7, miss 0.4, clamping 0.12/0.97,
occupied at 0.8, MapDrawer.cc:51-56, 394):
- free space: a fixed-step DDA samples every ray, and the union of the
  crossed voxels is the scan's FREE set;
- the endpoints are its OCCUPIED set (carve-only ground rays excluded);
- each voxel takes EXACTLY ONE log-odds update per scan, occupied winning
  over free, however many rays touch it (octomap's insertScan key sets);
- color is a running mean per voxel fed by ONE sample per voxel per scan,
  the first ray's.

The marks are written by `index_fill_`, which stores the same value at
every index: it is order-free by nature, so it needs no sort under
`torch.use_deterministic_algorithms` (a deterministic `index_put_` sorts
its ~10 M sample indices and walks the repeats of one index in one
thread). Indices outside the grid go to a spread of 1024 spare slots
rather than to one sentinel, so no single address takes most of the
writes. The first ray of each voxel is a `scatter_reduce` "amin" over ray
numbers, and its color lands with "amax" on the now unique slots; both
are atomic and order-free.

The divisions by the resolution and by the step count are products with
their f32 reciprocals, as XLA compiles the JAX version under `jit`.

`BlockGridMap` tiles the world into fixed-shape blocks allocated on
demand (the octree's unbounded growth): a scan goes into every block its
rays' bounding box touches. The ray samples are made once per scan and
shared by the blocks; each block converts them to its own voxels as the
JAX version does, so a point on a block face lands where it lands there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
from orb_slam2_ssd_semantic_tpu_torch.config import DenseMapConfig
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import f32_reciprocal

SPARE = 1024  # spare mark slots for out-of-grid indices


def _logit(p: float) -> float:
    return float(np.log(p / (1.0 - p)))


@dataclasses.dataclass
class VoxelGrid:
    log_odds: torch.Tensor  # (X, Y, Z) float32
    color: torch.Tensor  # (X, Y, Z, 3) float32 sum of the color samples
    n_color: torch.Tensor  # (X, Y, Z) float32 count of the color samples
    origin: torch.Tensor  # (3,) world position of voxel (0, 0, 0)'s corner

    @property
    def shape(self):
        return tuple(self.log_odds.shape)

    def replace(self, **kw) -> "VoxelGrid":
        return dataclasses.replace(self, **kw)


def empty_grid(extent=(10.0, 6.0, 10.0), resolution: float = 0.05,
               origin=(-2.0, -3.0, -2.0), device=None) -> VoxelGrid:
    """An empty grid on `device` (default: the card, raising without one)."""
    dev = device_mod.resolve(device)
    dims = tuple(int(round(e / resolution)) for e in extent)
    return VoxelGrid(
        log_odds=torch.zeros(dims, dtype=torch.float32, device=dev),
        color=torch.zeros(dims + (3,), dtype=torch.float32, device=dev),
        n_color=torch.zeros(dims, dtype=torch.float32, device=dev),
        origin=torch.as_tensor(np.asarray(origin, np.float32)).to(dev),
    )


def ray_samples(origin_w: torch.Tensor, points_w: torch.Tensor,
                cfg: DenseMapConfig = DenseMapConfig()) -> torch.Tensor:
    """(N, S, 3) fixed-step samples of each ray from `origin_w` to half a
    voxel short of its endpoint (S = cfg.max_ray_steps), in JAX's order of
    operations."""
    S, res = cfg.max_ray_steps, cfg.resolution
    dev = points_w.device
    t = (torch.arange(S, dtype=torch.float32, device=dev) + 0.5) * f32_reciprocal(S)
    o = origin_w.to(torch.float32)
    ray = points_w - o[None, :]
    ray_len = torch.sqrt(ray[:, 0] * ray[:, 0] + ray[:, 1] * ray[:, 1]
                         + ray[:, 2] * ray[:, 2])[:, None]
    scale = torch.clamp(ray_len - res, min=0.0) / torch.clamp(ray_len, min=1e-9)
    return o[None, None, :] + t[None, :, None] * (ray * scale)[:, None, :]


def _flat_voxels(grid: VoxelGrid, p: torch.Tensor, res: float):
    """(flat index, inside) of the voxels holding points `p` (..., 3);
    outside the grid the index points into the spare slots."""
    X, Y, Z = grid.shape
    v = torch.floor((p - grid.origin) * f32_reciprocal(res))
    inside = ((v[..., 0] >= 0) & (v[..., 0] < X) & (v[..., 1] >= 0) & (v[..., 1] < Y)
              & (v[..., 2] >= 0) & (v[..., 2] < Z))
    vi = torch.where(inside[..., None], v, torch.zeros_like(v)).to(torch.int64)
    flat = (vi[..., 0] * Y + vi[..., 1]) * Z + vi[..., 2]
    return flat, inside


def _spread(flat: torch.Tensor, keep: torch.Tensor, V: int) -> torch.Tensor:
    spare = V + torch.arange(flat.numel(), device=flat.device).reshape(flat.shape) % SPARE
    return torch.where(keep, flat, spare)


def _insert(grid: VoxelGrid, samples: torch.Tensor, points_w: torch.Tensor,
            point_valid: torch.Tensor, colors, carve_only, cfg: DenseMapConfig) -> VoxelGrid:
    res = cfg.resolution
    X, Y, Z = grid.shape
    V = X * Y * Z
    dev = points_w.device

    s_flat, s_in = _flat_voxels(grid, samples, res)
    s_ok = s_in & point_valid[:, None]
    e_flat, e_in = _flat_voxels(grid, points_w, res)
    e_ok = e_in & point_valid & ~carve_only

    occ = torch.zeros((V + SPARE,), dtype=torch.bool, device=dev)
    occ.index_fill_(0, _spread(e_flat, e_ok, V), True)
    free = torch.zeros((V + SPARE,), dtype=torch.bool, device=dev)
    free.index_fill_(0, _spread(s_flat, s_ok, V).reshape(-1), True)
    occ, free = occ[:V], free[:V] & ~occ[:V]

    lo = grid.log_odds.reshape(-1)
    lo = (lo + torch.where(occ, _logit(cfg.prob_hit), 0.0)
          + torch.where(free, _logit(cfg.prob_miss), 0.0))
    lo = torch.clamp(lo, _logit(cfg.clamp_min), _logit(cfg.clamp_max))
    grid = grid.replace(log_odds=lo.reshape(X, Y, Z))

    if colors is not None:
        # One color sample per voxel per scan: the first ray's (the
        # averageNodeColor call per updated node, MapDrawer.cc:1009).
        N = e_flat.shape[0]
        ray_id = torch.arange(N, device=dev)
        tgt = _spread(e_flat, e_ok, V)
        first = torch.full((V + SPARE,), N, dtype=torch.int64, device=dev)
        first.scatter_reduce_(0, tgt, ray_id, reduce="amin")
        is_first = e_ok & (first[tgt] == ray_id)
        once = _spread(e_flat, is_first, V)
        add = torch.zeros((V + SPARE, 3), dtype=torch.float32, device=dev)
        add.scatter_reduce_(0, once[:, None].expand(N, 3), colors.to(torch.float32),
                            reduce="amax", include_self=False)
        hit = torch.zeros((V + SPARE,), dtype=torch.bool, device=dev)
        hit.index_fill_(0, once, True)
        grid = grid.replace(
            color=(grid.color.reshape(-1, 3) + add[:V]).reshape(X, Y, Z, 3),
            n_color=(grid.n_color.reshape(-1) + hit[:V].to(torch.float32)).reshape(X, Y, Z))
    return grid


def insert_scan(grid: VoxelGrid, origin_w: torch.Tensor, points_w: torch.Tensor,
                point_valid: torch.Tensor, colors: torch.Tensor | None = None,
                carve_only: torch.Tensor | None = None,
                cfg: DenseMapConfig = DenseMapConfig()) -> VoxelGrid:
    """One sensor scan (origin (3,), endpoints (N, 3), valid (N,), optional
    colors (N, 3)): free-space carving and endpoint occupancy. Rays marked
    `carve_only` (ground) only carve (MapDrawer::InsertScan,
    MapDrawer.cc:946-1025). Returns the new grid; the input is kept."""
    if carve_only is None:
        carve_only = torch.zeros_like(point_valid)
    return _insert(grid, ray_samples(origin_w, points_w, cfg), points_w, point_valid, colors,
                   carve_only, cfg)


def occupancy_prob(grid: VoxelGrid) -> torch.Tensor:
    return torch.sigmoid(grid.log_odds)


def occupied_mask(grid: VoxelGrid, cfg: DenseMapConfig = DenseMapConfig()) -> torch.Tensor:
    """Voxels at or above the render threshold (MapDrawer.cc:394-412)."""
    return occupancy_prob(grid) >= cfg.occupancy_threshold


def occupied_centers(grid: VoxelGrid, cfg: DenseMapConfig = DenseMapConfig()):
    """Host side: (M, 3) world centres and (M, 3) mean colors of the
    occupied voxels."""
    m = occupied_mask(grid, cfg).cpu().numpy()
    idx = np.argwhere(m)
    centers = (idx + 0.5) * cfg.resolution + grid.origin.cpu().numpy()
    n = np.maximum(grid.n_color.cpu().numpy()[m], 1.0)
    return centers, grid.color.cpu().numpy()[m] / n[:, None]


# ---- persistence (SaveOctoMap / LoadOctoMap) ------------------------------


def save_grid(path: str, grid: VoxelGrid, cfg: DenseMapConfig = DenseMapConfig()):
    """The JAX package's npz layout (the .ot-file capability,
    MapDrawer.cc:1103-1111): files load in either package."""
    np.savez_compressed(
        path, log_odds=grid.log_odds.cpu().numpy(), color=grid.color.cpu().numpy(),
        n_color=grid.n_color.cpu().numpy(), origin=grid.origin.cpu().numpy(),
        resolution=cfg.resolution)


def load_grid(path: str, device=None) -> VoxelGrid:
    dev = device_mod.resolve(device)
    with np.load(path) as z:
        return VoxelGrid(*(torch.from_numpy(z[k]).to(dev)
                           for k in ("log_odds", "color", "n_color", "origin")))


# ---- unbounded block map ---------------------------------------------------


class BlockGridMap:
    """The world tiled into `block_voxels`^3-voxel blocks, allocated on
    demand: a dict (bx, by, bz) -> VoxelGrid on `device` (default: the
    card, raising without one)."""

    def __init__(self, cfg: DenseMapConfig = DenseMapConfig(), block_voxels: int = 64,
                 device=None):
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        self.block_voxels = int(block_voxels)
        self.block_extent = self.block_voxels * cfg.resolution
        self.blocks: dict = {}

    def _block_origin(self, key):
        return tuple(k * self.block_extent for k in key)

    def _get_or_create(self, key) -> VoxelGrid:
        g = self.blocks.get(key)
        if g is None:
            e = self.block_extent
            g = empty_grid(extent=(e, e, e), resolution=self.cfg.resolution,
                           origin=self._block_origin(key), device=self.device)
            self.blocks[key] = g
        return g

    def insert_scan(self, origin_w, points_w, point_valid, colors=None, carve_only=None):
        """Insert one scan into every block that the bounding box of its
        origin and valid endpoints touches (every ray lies inside it), in
        bx, by, bz order. The box is one 6-float fetch."""
        p = points_w.to(torch.float32)
        pv = point_valid
        big = 1e30
        ext = torch.stack([torch.where(pv[:, None], p, big).amin(0),
                           torch.where(pv[:, None], p, -big).amax(0)]).cpu().numpy()
        o = origin_w.cpu().numpy().astype(np.float32)
        pmin, pmax = np.minimum(ext[0], o), np.maximum(ext[1], o)
        if (pmax < pmin).any() or (np.abs(pmax) > 1e29).any():
            return
        e = self.block_extent
        lo = np.floor(pmin / e).astype(int)
        hi = np.floor(pmax / e).astype(int)
        if carve_only is None:
            carve_only = torch.zeros_like(pv)
        samples = ray_samples(origin_w.to(p.device), p, self.cfg)
        for bx in range(lo[0], hi[0] + 1):
            for by in range(lo[1], hi[1] + 1):
                for bz in range(lo[2], hi[2] + 1):
                    key = (bx, by, bz)
                    self.blocks[key] = _insert(self._get_or_create(key), samples, p, pv, colors,
                                               carve_only, self.cfg)

    def occupied_centers(self):
        cs, cols = [], []
        for g in self.blocks.values():
            c, col = occupied_centers(g, self.cfg)
            cs.append(c)
            cols.append(col)
        if not cs:
            return np.zeros((0, 3)), np.zeros((0, 3))
        return np.concatenate(cs), np.concatenate(cols)

    def occupancy_at(self, points_w) -> np.ndarray:
        """Host side: occupancy probability at world points (0.5 where no
        block was ever allocated)."""
        p = np.asarray(points_w, np.float32).reshape(-1, 3)
        out = np.full(p.shape[0], 0.5, np.float32)
        keys = np.floor(p / self.block_extent).astype(int)
        for key in {tuple(k) for k in keys}:
            g = self.blocks.get(key)
            if g is None:
                continue
            sel = np.all(keys == np.asarray(key), axis=1)
            v = np.floor((p[sel] - g.origin.cpu().numpy()) / self.cfg.resolution).astype(int)
            v = np.clip(v, 0, self.block_voxels - 1)
            lo = g.log_odds.cpu().numpy()
            out[sel] = 1.0 / (1.0 + np.exp(-lo[v[:, 0], v[:, 1], v[:, 2]]))
        return out

    def save(self, path: str):
        """The JAX package's npz layout: files load in either package."""
        keys = np.asarray(sorted(self.blocks.keys()), np.int64).reshape(-1, 3)
        arrays = {"block_keys": keys, "block_voxels": self.block_voxels,
                  "resolution": self.cfg.resolution}
        for i, k in enumerate(map(tuple, keys)):
            g = self.blocks[k]
            arrays[f"lo_{i}"] = g.log_odds.cpu().numpy()
            arrays[f"color_{i}"] = g.color.cpu().numpy()
            arrays[f"nc_{i}"] = g.n_color.cpu().numpy()
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path: str, cfg: DenseMapConfig = DenseMapConfig(), device=None):
        with np.load(path) as z:
            if "block_keys" not in z.files:
                raise ValueError(f"{path} is not a BlockGridMap save")
            m = cls(cfg, block_voxels=int(z["block_voxels"]), device=device)
            for i, k in enumerate(map(tuple, z["block_keys"])):
                m.blocks[k] = VoxelGrid(
                    log_odds=torch.from_numpy(z[f"lo_{i}"]).to(m.device),
                    color=torch.from_numpy(z[f"color_{i}"]).to(m.device),
                    n_color=torch.from_numpy(z[f"nc_{i}"]).to(m.device),
                    origin=torch.as_tensor(np.asarray(m._block_origin(k), np.float32)).to(m.device))
        return m
