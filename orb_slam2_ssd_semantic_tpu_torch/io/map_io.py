"""Sparse map persistence (counterpart of the JAX package's `io/map_io.py`;
Map::Save / Map::Load, perfect/src/Map.cc:228-446): map points and
keyframes, with the keyframe uids and the spanning-tree retirement ring,
in the JAX package's compressed npz layout (format v3; v1-v3 load).

Arrays are written with the JAX package's dtypes (uint32 descriptors,
int32 indices; `map_state.state_to_numpy`), so a file written by either
package loads in the other. Covisibility is derived from the
keypoint-to-point tables, so only the raw arrays are stored.
"""

from __future__ import annotations

import numpy as np

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import (
    SlamState,
    empty_state,
    state_from_numpy,
    state_to_numpy,
)

FORMAT_VERSION = 3

_POINT_KEYS = ("pos", "desc", "normal", "min_dist", "max_dist", "n_obs", "ref_kf",
               "first_kf_uid", "valid")
_KF_KEYS = ("T_cw", "uv", "level", "angle", "desc", "depth", "kp_valid", "kp_point", "frame_id",
            "stamp", "uid", "parent_uid", "T_rel_parent", "valid")


def save_map(path: str, state: SlamState) -> None:
    tree = state_to_numpy(state)
    arrays = {"version": FORMAT_VERSION}
    arrays.update({k: int(tree[k]) for k in ("n_points", "n_kfs", "last_kf", "next_uid")})
    arrays.update({f"pt_{k}": tree["points"][k] for k in _POINT_KEYS})
    arrays.update({f"kf_{k}": tree["kfs"][k] for k in _KF_KEYS})
    ret = tree["retired"]
    arrays.update(ret_uid=ret["uid"], ret_parent_uid=ret["parent_uid"], ret_T_rel=ret["T_rel"],
                  ret_count=int(ret["count"]))
    np.savez_compressed(path, **arrays)


def load_map(path: str, cfg: SlamConfig, device=None) -> SlamState:
    """The saved map in a state of `cfg`'s capacities on `device`
    (default: the card, raising without one)."""
    dev = device_mod.resolve(device)
    with np.load(path) as npz:
        z = {k: npz[k] for k in npz.files}
    version = int(z["version"])
    if version not in (1, 2, 3):
        raise ValueError(f"unknown map format version {version}")
    tree = state_to_numpy(empty_state(cfg, "cpu"))
    P, F = cfg.map.max_map_points, cfg.map.max_keyframes
    sp, sf = z["pt_pos"].shape[0], z["kf_T_cw"].shape[0]
    if sp > P or sf > F:
        raise ValueError(f"saved map capacity ({sp} pts, {sf} kfs) exceeds configured "
                         f"capacity ({P}, {F})")

    def put(group, name, key):
        if key in z:
            data = z[key]
            group[name][: data.shape[0]] = data

    pts, kfs = tree["points"], tree["kfs"]
    for k in _POINT_KEYS:
        put(pts, k, f"pt_{k}")
    for k in _KF_KEYS:
        put(kfs, k, f"kf_{k}")
    # Tracking statistics restart neutral (the reference rebuilds its
    # MapPoints, resetting found and visible).
    pts["n_visible"][:sp] = 1
    pts["n_found"][:sp] = 1
    n_kfs = int(z["n_kfs"])
    if version == 1:
        # v1 stored prefix slices without uids: insertion order.
        kfs["uid"][:n_kfs] = np.arange(n_kfs, dtype=np.int32)
        pts["first_kf_uid"] = np.where(pts["valid"], np.clip(pts["ref_kf"], 0, None),
                                       pts["first_kf_uid"]).astype(np.int32)
        last_kf, next_uid = max(n_kfs - 1, 0), n_kfs
    else:
        last_kf, next_uid = int(z["last_kf"]), int(z["next_uid"])
    ret = tree["retired"]
    if version >= 3 and "ret_uid" in z:
        n_ret = min(z["ret_uid"].shape[0], ret["uid"].shape[0])
        ret["uid"][:n_ret] = z["ret_uid"][:n_ret]
        ret["parent_uid"][:n_ret] = z["ret_parent_uid"][:n_ret]
        ret["T_rel"][:n_ret] = z["ret_T_rel"][:n_ret]
        ret["count"] = np.int32(int(z["ret_count"]))
    tree.update(n_points=np.int32(int(z["n_points"])), n_kfs=np.int32(n_kfs),
                last_kf=np.int32(last_kf), next_uid=np.int32(next_uid))
    return state_from_numpy(tree, dev)
