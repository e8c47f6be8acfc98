"""The device-resident SLAM map as dataclasses of tensors (counterpart of
the JAX package's `mapping/map_state.py`): fixed-capacity keyframe and
map-point stores with validity masks, erase+reuse slot allocation, and
covisibility derived from the keypoint->point tables.

Updates are functional (new tensors, never in place), like the JAX
pytrees: callers keep pre-update snapshots (the tracker's post-insert,
pre-BA mirror) that must not change under them.

Dtypes: descriptors are int32 holding the JAX package's uint32 bit
patterns; index-valued columns (`level`, `kp_point`, `ref_kf`, slots)
are int64 (torch's index type); counters stay int32.
`state_from_numpy` / `state_to_numpy` convert to and from the JAX
`SlamState` given as nested dicts of numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import row, scatter, top_k


def _replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


@dataclasses.dataclass
class MapPoints:
    pos: torch.Tensor  # (P, 3) world position
    desc: torch.Tensor  # (P, 8) int32 representative descriptor
    normal: torch.Tensor  # (P, 3) mean viewing direction
    min_dist: torch.Tensor  # (P,) scale-invariance range
    max_dist: torch.Tensor  # (P,)
    n_obs: torch.Tensor  # (P,) int32 keyframe observation count
    n_visible: torch.Tensor  # (P,) int32
    n_found: torch.Tensor  # (P,) int32
    ref_kf: torch.Tensor  # (P,) int64 reference keyframe SLOT
    first_kf_uid: torch.Tensor  # (P,) int32 uid of the creating keyframe
    valid: torch.Tensor  # (P,) bool
    replace = _replace


@dataclasses.dataclass
class KeyFrames:
    T_cw: torch.Tensor  # (F, 4, 4)
    uv: torch.Tensor  # (F, K, 2)
    level: torch.Tensor  # (F, K) int64
    angle: torch.Tensor  # (F, K)
    desc: torch.Tensor  # (F, K, 8) int32
    depth: torch.Tensor  # (F, K)
    kp_valid: torch.Tensor  # (F, K) bool
    kp_point: torch.Tensor  # (F, K) int64 map-point slot (-1 none)
    frame_id: torch.Tensor  # (F,) int32
    stamp: torch.Tensor  # (F,) float32
    uid: torch.Tensor  # (F,) int32 (-1 never used)
    parent_uid: torch.Tensor  # (F,) int32 spanning-tree parent at cull
    T_rel_parent: torch.Tensor  # (F, 4, 4)
    valid: torch.Tensor  # (F,) bool
    replace = _replace


@dataclasses.dataclass
class RetiredRing:
    uid: torch.Tensor  # (R,) int32
    parent_uid: torch.Tensor  # (R,) int32
    T_rel: torch.Tensor  # (R, 4, 4)
    count: torch.Tensor  # () int32 records ever pushed
    replace = _replace


@dataclasses.dataclass
class SlamState:
    points: MapPoints
    kfs: KeyFrames
    n_points: torch.Tensor  # () int32
    n_kfs: torch.Tensor  # () int32
    last_kf: torch.Tensor  # () int64 slot of the newest keyframe
    next_uid: torch.Tensor  # () int32
    retired: RetiredRing
    replace = _replace


def empty_state(cfg: SlamConfig, device) -> SlamState:
    P = cfg.map.max_map_points
    F = cfg.map.max_keyframes
    K = cfg.orb.max_keypoints
    R = cfg.map.retired_ring_capacity
    f32, i32, i64 = torch.float32, torch.int32, torch.int64

    def z(shape, dt=f32):
        return torch.zeros(shape, dtype=dt, device=device)

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    def eyes(n):
        return torch.eye(4, dtype=f32, device=device).repeat(n, 1, 1)

    points = MapPoints(
        pos=z((P, 3)), desc=z((P, 8), i32), normal=z((P, 3)), min_dist=z((P,)),
        max_dist=z((P,)), n_obs=z((P,), i32), n_visible=z((P,), i32), n_found=z((P,), i32),
        ref_kf=full((P,), -1, i64), first_kf_uid=full((P,), -1, i32),
        valid=z((P,), torch.bool),
    )
    kfs = KeyFrames(
        T_cw=eyes(F), uv=z((F, K, 2)), level=z((F, K), i64), angle=z((F, K)),
        desc=z((F, K, 8), i32), depth=z((F, K)), kp_valid=z((F, K), torch.bool),
        kp_point=full((F, K), -1, i64), frame_id=full((F,), -1, i32), stamp=z((F,)),
        uid=full((F,), -1, i32), parent_uid=full((F,), -1, i32), T_rel_parent=eyes(F),
        valid=z((F,), torch.bool),
    )
    retired = RetiredRing(uid=full((R,), -1, i32), parent_uid=full((R,), -1, i32),
                          T_rel=eyes(R), count=z((), i32))
    return SlamState(points, kfs, z((), i32), z((), i32), z((), i64), z((), i32), retired)


def push_retired(ring: RetiredRing, mask, uids, parent_uids, T_rels) -> RetiredRing:
    """Append the masked records at the ring cursor (oldest overwritten)."""
    R = ring.uid.shape[0]
    rank = torch.cumsum(mask.to(torch.int64), 0) - 1
    pos = (ring.count.to(torch.int64) + rank) % R
    pos = torch.where(mask, pos, torch.full_like(pos, R))
    return ring.replace(
        uid=scatter(ring.uid, pos, uids),
        parent_uid=scatter(ring.parent_uid, pos, parent_uids),
        T_rel=scatter(ring.T_rel, pos, T_rels),
        count=ring.count + mask.sum().to(torch.int32),
    )


def alloc_slots(valid: torch.Tensor, k: int) -> torch.Tensor:
    """(k,) lowest-index FREE slots in ascending order; `n` (capacity)
    where none is left (dropped by the callers' scatters)."""
    n = valid.shape[0]
    score = torch.where(valid, torch.zeros((), device=valid.device),
                        (n - torch.arange(n, device=valid.device)).to(torch.float32))
    top, idx = top_k(score, k)
    return torch.where(top > 0.0, idx, torch.full_like(idx, n))


def clear_point_refs(kp_point: torch.Tensor, dead: torch.Tensor) -> torch.Tensor:
    """Clear keypoint->point associations referencing dead points."""
    P = dead.shape[0]
    stale = (kp_point >= 0) & dead[kp_point.clamp(0, P - 1)]
    return torch.where(stale, torch.full_like(kp_point, -1), kp_point)


def covisibility(kp_point: torch.Tensor, kf_valid: torch.Tensor, point_capacity: int) -> torch.Tensor:
    """(F, F) int32 shared-map-point counts, diagonal zeroed."""
    F = kp_point.shape[0]
    ids = torch.where(kp_point >= 0, kp_point, torch.full_like(kp_point, point_capacity))
    obs = torch.zeros((F, point_capacity + 1), dtype=torch.float32, device=kp_point.device)
    obs[torch.arange(F, device=kp_point.device)[:, None], ids] = 1.0
    obs = obs[:, :point_capacity] * kf_valid.to(torch.float32)[:, None]
    W = (obs @ obs.T).to(torch.int32)
    return W - torch.diag(torch.diag(W))


def covisibility_row(kp_point: torch.Tensor, kf_valid: torch.Tensor, kf_id, point_capacity: int):
    """(F,) int32 shared-point counts between keyframe `kf_id` (an int or a
    0-d tensor, read on the device) and every other keyframe."""
    ids = row(kp_point, kf_id) if isinstance(kf_id, torch.Tensor) else kp_point[kf_id]
    present = torch.zeros((point_capacity + 1,), dtype=torch.float32, device=kp_point.device)
    present = scatter(present, torch.where(ids >= 0, ids, torch.full_like(ids, point_capacity)), 1.0)
    present[point_capacity].zero_()
    other = torch.where(kp_point >= 0, kp_point, torch.full_like(kp_point, point_capacity))
    shared = torch.sum(present[other], dim=1) * kf_valid.to(torch.float32)
    shared = torch.where(torch.arange(kp_point.shape[0], device=kp_point.device) == kf_id, 0.0,
                         shared)
    return shared.to(torch.int32)


def point_positions_valid(state: SlamState):
    """The map points' (P, 3) positions and (P,) validity."""
    return state.points.pos, state.points.valid


# ---- conversion to and from the JAX package's SlamState -------------------

_INDEX_FIELDS = {"level", "kp_point", "ref_kf", "last_kf"}


def _to_tensor(name: str, a, device):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(np.array(a)).to(device)
    if name in _INDEX_FIELDS:
        t = t.to(torch.int64)
    return t


def state_from_numpy(tree: dict, device) -> SlamState:
    """The JAX `SlamState`, given as nested dicts of numpy arrays (field
    names as in the JAX NamedTuples), as the port's state on `device`."""

    def build(cls, d):
        return cls(**{f.name: _to_tensor(f.name, d[f.name], device) for f in dataclasses.fields(cls)})

    return SlamState(
        points=build(MapPoints, tree["points"]),
        kfs=build(KeyFrames, tree["kfs"]),
        n_points=_to_tensor("n_points", tree["n_points"], device),
        n_kfs=_to_tensor("n_kfs", tree["n_kfs"], device),
        last_kf=_to_tensor("last_kf", tree["last_kf"], device),
        next_uid=_to_tensor("next_uid", tree["next_uid"], device),
        retired=build(RetiredRing, tree["retired"]),
    )


def _to_numpy(name: str, t: torch.Tensor):
    a = t.detach().cpu().numpy()
    if name == "desc":
        return a.view(np.uint32)
    if name in _INDEX_FIELDS:
        return a.astype(np.int32)
    return a


def state_to_numpy(state: SlamState) -> dict:
    """The port's state as nested dicts of numpy arrays with the JAX
    package's dtypes (uint32 descriptors, int32 indices)."""

    def flat(obj):
        return {f.name: _to_numpy(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)}

    out = {k: _to_numpy(k, getattr(state, k)) for k in ("n_points", "n_kfs", "last_kf", "next_uid")}
    out.update(points=flat(state.points), kfs=flat(state.kfs), retired=flat(state.retired))
    return out
