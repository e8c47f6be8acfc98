"""Local mapping: triangulation, duplicate fusion, covisibility-window BA,
map-point maintenance and culling (counterpart of the JAX package's
`mapping/local_mapping.py`). `local_mapping_step` runs once per keyframe
from the third one on.

The step never waits on the card: every decision JAX takes with
`lax.cond` or `while_loop` is a select on the device here (the
keyframe cull, local BA's early exit), so the tracker can dispatch it
and track on (`async_mapping`). The newest keyframe's slot stays a 0-d
tensor and is read with `row`, a gather, never as a host index."""

from __future__ import annotations

import torch

from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.frontend.extractor import scale_factors
from orb_slam2_ssd_semantic_tpu_torch.geometry import camera as cam_ops
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.mapping.ba import BAProblem, local_bundle_adjust
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import (
    SlamState,
    alloc_slots,
    clear_point_refs,
    covisibility_row,
    push_retired,
)
from orb_slam2_ssd_semantic_tpu_torch.mapping.triangulation import triangulate_pair
from orb_slam2_ssd_semantic_tpu_torch.ops import match as match_ops
from orb_slam2_ssd_semantic_tpu_torch.ops.match import popcount32
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import row, scatter, top_k


def _full(ref: torch.Tensor, v):
    return torch.full_like(ref, v)


def _neighbor_slots(state: SlamState, kf1, k: int):
    """Top-k fusion/triangulation partners of keyframe `kf1`: covisible
    keyframes first, then the most recent ones. Returns (slots, ok)."""
    P = state.points.pos.shape[0]
    F = state.kfs.valid.shape[0]
    dev = state.kfs.valid.device
    covis = covisibility_row(state.kfs.kp_point, state.kfs.valid, kf1, P).to(torch.float32)
    eligible = state.kfs.valid & (torch.arange(F, device=dev) != kf1) & (state.kfs.uid >= 0)
    covis_sc = torch.where(eligible, covis, _full(covis, -1.0))
    rec_sc = torch.where(eligible, state.kfs.uid.to(torch.float32), _full(covis, -1.0))
    sc = torch.where(covis_sc > 0, 1e9 + covis_sc, rec_sc)
    top, slots = top_k(sc, k)
    return slots, top >= 0.0


def create_new_map_points(state: SlamState, cfg: SlamConfig) -> SlamState:
    """Triangulate landmarks between the newest keyframe and its best
    covisible neighbours (all pairs batched); each kf1 keypoint keeps
    its first successful neighbour."""
    kfs = state.kfs
    F = kfs.valid.shape[0]
    P = state.points.pos.shape[0]
    K = kfs.kp_point.shape[1]
    dev = kfs.valid.device
    sf = scale_factors(cfg.orb, dev)
    kf1 = state.last_kf
    neighbors, ok_nb = _neighbor_slots(state, kf1, cfg.map.triangulation_neighbors)
    Nn = neighbors.shape[0]

    T1 = row(kfs.T_cw, kf1)
    c1 = se3.se3_inverse(T1)[:3, 3]
    baseline_min = cfg.camera.depth_bf / cfg.camera.fx
    kp_point1 = row(kfs.kp_point, kf1)
    valid1 = row(kfs.kp_valid, kf1) & (kp_point1 < 0)
    uv1, desc1, level1 = row(kfs.uv, kf1), row(kfs.desc, kf1), row(kfs.level, kf1)

    T2 = kfs.T_cw[neighbors]
    c2 = se3.se3_inverse(T2)[:, :3, 3]
    ok_pair = ok_nb & kfs.valid[neighbors] & (neighbors != kf1)
    ok_pair = ok_pair & (torch.linalg.norm(c1[None] - c2, dim=-1) > baseline_min)
    valid2 = kfs.kp_valid[neighbors] & (kfs.kp_point[neighbors] < 0)

    def rep(a):
        return a[None].expand((Nn,) + a.shape)

    tri = triangulate_pair(
        rep(uv1), rep(desc1), rep(level1), valid1[None] & ok_pair[:, None],
        kfs.uv[neighbors], kfs.desc[neighbors], kfs.level[neighbors], valid2 & ok_pair[:, None],
        rep(T1), T2, cfg.camera, cfg.orb,
    )
    oks = tri.valid & ok_pair[:, None]  # (Nn, K)

    any_ok = torch.any(oks, dim=0)
    nsel = torch.argmax(oks.to(torch.int32), dim=0)  # first successful neighbour
    kcols = torch.arange(K, device=dev)
    X = tri.pts_w[nsel, kcols]
    j2 = tri.idx2[nsel, kcols]
    kf2_sel = neighbors[nsel]

    free = alloc_slots(state.points.valid, K)
    rank = torch.cumsum(any_ok.to(torch.int64), 0) - 1
    slot = free[rank.clamp(0, K - 1)]
    ok = any_ok & (slot < P)
    slot_safe = torch.where(ok, slot, _full(slot, P))

    dist = torch.linalg.norm(X - c1[None], dim=-1)
    lv = level1.clamp(0, cfg.orb.n_levels - 1)
    max_dist = dist * sf[lv]
    min_dist = max_dist / sf[-1]
    normal = (X - c1[None]) / torch.clamp(dist, min=1e-6)[:, None]

    pts = state.points
    pts = pts.replace(
        pos=scatter(pts.pos, slot_safe, X),
        desc=scatter(pts.desc, slot_safe, desc1),
        normal=scatter(pts.normal, slot_safe, normal),
        min_dist=scatter(pts.min_dist, slot_safe, min_dist),
        max_dist=scatter(pts.max_dist, slot_safe, max_dist),
        n_obs=scatter(pts.n_obs, slot_safe, 2),
        n_visible=scatter(pts.n_visible, slot_safe, 2),
        n_found=scatter(pts.n_found, slot_safe, 2),
        ref_kf=scatter(pts.ref_kf, slot_safe, kf1),
        first_kf_uid=scatter(pts.first_kf_uid, slot_safe, row(kfs.uid, kf1)),
        valid=scatter(pts.valid, slot_safe, True),
    )
    kp1 = torch.where(ok, slot, kp_point1)
    kp = scatter(kfs.kp_point, kf1, kp1)
    kp = scatter(kp, (torch.where(ok, kf2_sel, _full(kf2_sel, F)), torch.where(ok, j2, _full(j2, 0))),
                 torch.where(ok, slot, _full(slot, -1)))
    return state.replace(points=pts, kfs=kfs.replace(kp_point=kp),
                         n_points=state.n_points + ok.sum().to(torch.int32))


# ---------------------------------------------------------------------------
# Duplicate-landmark fusion
# ---------------------------------------------------------------------------

def _apply_merges(state: SlamState, loser: torch.Tensor, winner: torch.Tensor) -> SlamState:
    """Rebind every reference to loser[i] onto winner[i]; the winner
    absorbs the loser's statistics and the loser is invalidated. Losers
    equal to P are sentinels."""
    pts = state.points
    P = pts.pos.shape[0]
    dev = loser.device
    remap = torch.arange(P + 1, device=dev)
    winner_eff = torch.where(loser < P, winner, _full(winner, P))
    remap = scatter(remap, loser.clamp(0, P), winner_eff)
    for _ in range(5):  # collapse merge chains by repeated squaring
        remap = remap[remap]
    ar = torch.arange(P, device=dev)
    merged = (remap[:P] != ar) & pts.valid
    add_to = torch.where(merged, remap[:P], _full(ar, P))
    pts = pts.replace(
        n_obs=scatter(pts.n_obs, add_to, pts.n_obs, "add"),
        n_visible=scatter(pts.n_visible, add_to, pts.n_visible, "add"),
        n_found=scatter(pts.n_found, add_to, pts.n_found, "add"),
        valid=pts.valid & ~merged,
    )
    kp = state.kfs.kp_point
    kp = torch.where(kp >= 0, remap[kp.clamp(0, P)], kp)
    kp = clear_point_refs(kp, merged)
    return state.replace(points=pts, kfs=state.kfs.replace(kp_point=kp),
                         n_points=state.n_points - merged.sum().to(torch.int32))


def _fuse_directions_batched(state: SlamState, src, dst, ok_d, cfg: SlamConfig) -> SlamState:
    """All (src -> dst) fuse directions at once: a match against an
    unbound keypoint adds an observation, one against a keypoint bound to
    another landmark merges the two (more observations wins, then the
    lower id)."""
    cam = cfg.camera
    pts = state.points
    kfs = state.kfs
    P = pts.pos.shape[0]
    F = kfs.valid.shape[0]
    K = kfs.kp_point.shape[1]
    dev = src.device
    sf = scale_factors(cfg.orb, dev)
    D = src.shape[0]

    ids = kfs.kp_point[src]  # (D, K)
    idc = ids.clamp(0, P - 1)
    q_valid = ok_d[:, None] & (ids >= 0) & pts.valid[idc] & kfs.kp_valid[src]
    X = pts.pos[idc]  # (D, K, 3)
    T_dst = kfs.T_cw[dst]
    pc = se3.transform_points(T_dst, X)
    uv, z = cam_ops.project(pc, cam)
    dist = torch.linalg.norm(pc, dim=-1)
    c_dst = se3.se3_inverse(T_dst)[:, :3, 3]
    view = (X - c_dst[:, None]) / torch.clamp(dist, min=1e-6)[..., None]
    cos_view = torch.sum(view * pts.normal[idc], dim=-1)
    q_valid = (q_valid & (z > 0.05) & cam_ops.in_image(uv, cam)
               & (dist > 0.8 * pts.min_dist[idc]) & (dist < 1.3 * pts.max_dist[idc])
               & (cos_view > 0.5))
    ratio = torch.clamp(pts.max_dist[idc] / torch.clamp(dist, min=1e-6), min=1e-6)
    log_s = torch.log(torch.full((), cfg.orb.scale_factor, dtype=torch.float32, device=dev))
    pred_level = torch.ceil(torch.log(ratio) / log_s).to(torch.int64)
    pred_level = pred_level.clamp(0, cfg.orb.n_levels - 1)
    radius = cfg.map.fuse_search_radius * sf[pred_level]

    desc_t, uv_t, valid_t = kfs.desc[dst], kfs.uv[dst], kfs.kp_valid[dst]
    js = []
    for d in range(D):
        m = match_ops.match_by_window(
            pts.desc[idc[d]], desc_t[d], uv[d], uv_t[d], q_valid[d], valid_t[d], radius[d],
            max_dist=match_ops.TH_LOW)
        js.append((m.idx, m.valid))
    m_idx = torch.stack([a for a, _ in js])
    m_valid = torch.stack([b for _, b in js])
    j = m_idx.clamp(0, K - 1)

    rows = dst[:, None].expand(D, K)
    kp_lvl = kfs.level[rows, j]
    lvl_ok = (kp_lvl >= pred_level - 1) & (kp_lvl <= pred_level)
    kp_uv = kfs.uv[rows, j]
    du = kp_uv - uv
    e2_mono = torch.sum(du * du, dim=-1)
    ur_proj = uv[..., 0] - cam.depth_bf / torch.clamp(z, min=1e-6)
    kp_d = kfs.depth[rows, j]
    kp_ur = kp_uv[..., 0] - cam.depth_bf / torch.clamp(kp_d, min=1e-6)
    has_d = kp_d > 1e-6
    dur = ur_proj - kp_ur
    e2 = torch.where(has_d, e2_mono + dur * dur, e2_mono)
    inv_sigma2 = 1.0 / (sf[kp_lvl.clamp(0, sf.shape[0] - 1)] ** 2)
    chi2_th = torch.where(has_d, _full(e2, 7.8), _full(e2, 5.99))
    ok_m = m_valid & lvl_ok & (e2 * inv_sigma2 <= chi2_th)
    existing = kfs.kp_point[rows, j]
    bind = ok_m & (existing < 0)
    merge = ok_m & (existing >= 0) & (existing != ids)
    nq = pts.n_obs[idc]
    ne = pts.n_obs[existing.clamp(0, P - 1)]
    q_wins = (nq > ne) | ((nq == ne) & (ids < existing))
    winner = torch.where(q_wins, ids, existing)
    loser = torch.where(merge, torch.where(q_wins, existing, ids), _full(ids, P))

    kp = scatter(kfs.kp_point, (torch.where(bind, rows, _full(rows, F)), torch.where(bind, j, _full(j, 0))),
                 torch.where(bind, ids, _full(ids, -1)))
    new_bound = (kp >= 0) & (kfs.kp_point < 0)
    n_obs = scatter(pts.n_obs, torch.where(new_bound, kp, _full(kp, P)).reshape(-1), 1, "add")
    state = state.replace(points=pts.replace(n_obs=n_obs), kfs=kfs.replace(kp_point=kp))
    return _apply_merges(state, loser.reshape(-1), winner.reshape(-1))


def _dedup_observations(state: SlamState, rows: torch.Tensor) -> SlamState:
    """Drop duplicate (keyframe, point) observations within `rows`
    (first occurrence kept, via a scatter-min over (row, point) keys)."""
    kfs = state.kfs
    pts = state.points
    F, K = kfs.kp_point.shape
    P = pts.pos.shape[0]
    dev = rows.device
    R = rows.shape[0]
    row_ok = rows < F
    kp = kfs.kp_point[rows.clamp(0, F - 1)]
    valid = (kp >= 0) & row_ok[:, None]
    key = torch.where(valid, kp + torch.arange(R, device=dev)[:, None] * (P + 1),
                      _full(kp, R * (P + 1))).reshape(-1)
    col = torch.arange(K, device=dev).repeat(R)
    first = torch.full((R * (P + 1) + 1,), K, dtype=torch.int64, device=dev)
    first = scatter(first, key, col, "amin")
    dup = (valid.reshape(-1) & (first[key] != col)).reshape(R, K)
    dec_ids = torch.where(dup, kp, _full(kp, P)).reshape(-1)
    n_obs = torch.clamp(scatter(pts.n_obs, dec_ids, -1, "add"), min=0)
    new_rows = torch.where(dup, _full(kp, -1), kp)
    return state.replace(points=pts.replace(n_obs=n_obs),
                         kfs=kfs.replace(kp_point=scatter(kfs.kp_point, rows, new_rows)))


def fuse_map_points(state: SlamState, cfg: SlamConfig) -> SlamState:
    """Fuse the newest keyframe's landmarks into its best covisible
    neighbours and vice versa, then deduplicate observations."""
    Nf = cfg.map.fuse_neighbors
    kf1 = state.last_kf
    F = state.kfs.valid.shape[0]
    wide, ok_w = _neighbor_slots(state, kf1, min(max(31, Nf), F))
    neighbors, ok_n = wide[:Nf], ok_w[:Nf]
    kf1_rep = kf1.reshape(1).expand(Nf)
    src = torch.cat([kf1_rep, neighbors])
    dst = torch.cat([neighbors, kf1_rep])
    ok_d = torch.cat([ok_n, ok_n])
    state = _fuse_directions_batched(state, src, dst, ok_d, cfg)
    rows = torch.cat([kf1.reshape(1), torch.where(ok_w, wide, _full(wide, F))])
    return _dedup_observations(state, rows)


def fuse_pair(state: SlamState, kf_a, kf_b, cfg: SlamConfig) -> SlamState:
    """Bidirectional landmark fusion between two given keyframe slots: the
    building block of LoopClosing::SearchAndFuse (LoopClosing.cc:791-824),
    which projects loop-side landmarks into the corrected current-side
    keyframes so the two sides of a closed loop share observations."""
    dev = state.kfs.valid.device
    ab = torch.where(torch.arange(2, device=dev) == 0, kf_a, kf_b)
    state = _fuse_directions_batched(state, ab, ab.flip(0),
                                     torch.ones((2,), dtype=torch.bool, device=dev), cfg)
    return _dedup_observations(state, ab)


# ---------------------------------------------------------------------------
# Map-point maintenance
# ---------------------------------------------------------------------------

def _refresh_local_points(state: SlamState, kf_ids, row_ok, local_ids, slot, point_valid,
                          cfg: SlamConfig) -> SlamState:
    """Refresh representative descriptors (min-median Hamming over up to
    `maintenance_max_obs` observations) and viewing normals /
    scale-invariance depths of the local points."""
    pts = state.points
    P = pts.pos.shape[0]
    M = cfg.map.maintenance_max_obs
    N = local_ids.shape[0]
    Wt, K = slot.shape
    dev = slot.device
    sf = scale_factors(cfg.orb, dev)

    kp_ok = state.kfs.kp_valid[kf_ids] & row_ok[:, None]
    s = torch.where((slot >= 0) & kp_ok, slot, _full(slot, N)).reshape(-1)
    order = torch.argsort(s, stable=True)
    ss = s[order]
    start = torch.searchsorted(ss, ss, side="left")
    j = torch.arange(ss.shape[0], device=dev) - start
    keep = (ss < N) & (j < M)
    rows = torch.where(keep, ss, _full(ss, N))
    cols = torch.where(keep, j, _full(j, 0))

    desc_flat = state.kfs.desc[kf_ids].reshape(Wt * K, 8)[order]
    level_flat = state.kfs.level[kf_ids].reshape(-1)[order]
    w_flat = (torch.arange(Wt * K, device=dev) // K)[order]
    uid_flat = state.kfs.uid[kf_ids][w_flat]

    obs_desc = scatter(torch.zeros((N + 1, M, 8), dtype=torch.int32, device=dev),
                       (rows, cols), desc_flat)[:N]
    cnt = scatter(torch.zeros((N + 1,), dtype=torch.int32, device=dev), rows,
                  keep.to(torch.int32), "add")[:N]

    # descriptor: min-median pairwise Hamming
    ham = popcount32(torch.bitwise_xor(obs_desc[:, :, None, :], obs_desc[:, None, :, :])).sum(-1)
    in_cnt = torch.arange(M, device=dev)[None, :] < cnt[:, None]
    hv = torch.where(in_cnt[:, None, :], ham, _full(ham, 512))
    hs = torch.sort(hv, dim=-1).values
    med_idx = ((cnt - 1) // 2).clamp(0, M - 1).to(torch.int64)
    med = torch.gather(hs, 2, med_idx[:, None, None].expand(N, M, 1))[..., 0]
    med = torch.where(in_cnt, med, _full(med, 1 << 20))
    best = torch.argmin(med, dim=-1)
    best_desc = obs_desc[torch.arange(N, device=dev), best]
    upd = point_valid & (cnt >= 2)
    upd_ids = torch.where(upd, local_ids, _full(local_ids, P))
    pts = pts.replace(desc=scatter(pts.desc, upd_ids, best_desc))

    # normal + scale-invariance depths
    centers = se3.se3_inverse(state.kfs.T_cw[kf_ids])[:, :3, 3]
    Xl = torch.cat([pts.pos[local_ids], torch.zeros((1, 3), dtype=torch.float32, device=dev)], 0)
    v = Xl[rows] - centers[w_flat]
    d = torch.linalg.norm(v, dim=-1)
    vn = v / torch.clamp(d, min=1e-6)[:, None]
    nsum = scatter(torch.zeros((N + 1, 3), dtype=torch.float32, device=dev), rows,
                   vn * keep[:, None], "add")[:N]
    normal_new = nsum / torch.clamp(torch.linalg.norm(nsum, dim=-1), min=1e-6)[:, None]

    ref_uid = scatter(torch.full((N + 1,), -1, dtype=torch.int32, device=dev), rows,
                      torch.where(keep, uid_flat, _full(uid_flat, -1)), "amax")[:N]
    is_ref = keep & (uid_flat == ref_uid[ss.clamp(0, N - 1)]) & (ss < N)
    ref_rows = torch.where(is_ref, ss, _full(ss, N))
    dist_ref = scatter(torch.zeros((N + 1,), dtype=torch.float32, device=dev), ref_rows, d)[:N]
    level_ref = scatter(torch.zeros((N + 1,), dtype=torch.int64, device=dev), ref_rows,
                        level_flat)[:N]
    lv = level_ref.clamp(0, cfg.orb.n_levels - 1)
    max_d = dist_ref * sf[lv]
    min_d = max_d / sf[-1]
    upd_d = upd & (dist_ref > 1e-6)
    upd_d_ids = torch.where(upd_d, local_ids, _full(local_ids, P))
    pts = pts.replace(
        normal=scatter(pts.normal, upd_ids, normal_new),
        max_dist=scatter(pts.max_dist, upd_d_ids, max_d),
        min_dist=scatter(pts.min_dist, upd_d_ids, min_d),
    )
    return state.replace(points=pts)


# ---------------------------------------------------------------------------
# The per-keyframe local mapping pass
# ---------------------------------------------------------------------------

def local_mapping_step(state: SlamState, cfg: SlamConfig) -> SlamState:
    """Triangulate + fuse + local BA + maintenance + culling, anchored at
    the newest keyframe."""
    if cfg.map.triangulate_new_points:
        state = create_new_map_points(state, cfg)
    if cfg.map.fuse_neighbors > 0:
        state = fuse_map_points(state, cfg)
    return _ba_and_maintain(state, cfg)


def assemble_local_ba(state: SlamState, cfg: SlamConfig):
    """Window assembly: the newest keyframe's covisibility window, the
    local point set, fixed anchors and the observation tensors. Returns
    (prob, kf_ids, all_ids, row_ok, local_ids, point_valid,
    slot_of_point, kp_point_all)."""
    W = cfg.map.local_ba_window
    A = cfg.map.local_ba_fixed_anchors
    N = cfg.map.local_ba_max_points
    P = state.points.pos.shape[0]
    F = state.kfs.valid.shape[0]
    kfs = state.kfs
    dev = kfs.valid.device
    sf = scale_factors(cfg.orb, dev)
    last = state.last_kf

    covrow = covisibility_row(kfs.kp_point, kfs.valid, last, P).to(torch.float32)
    sc = torch.where(kfs.valid, covrow, _full(covrow, -1.0))
    sc = scatter(sc, last, 1e9)
    top_sc, kf_ids = top_k(sc, W)
    in_window = top_sc > 0.0

    kp_point = torch.where(in_window[:, None], kfs.kp_point[kf_ids], _full(kfs.kp_point[kf_ids], -1))
    ids_flat = kp_point.reshape(-1)
    present = scatter(torch.zeros((P,), dtype=torch.float32, device=dev),
                      torch.where(ids_flat >= 0, ids_flat, _full(ids_flat, P)), 1.0, "add")
    present = present * state.points.valid
    _, local_ids = top_k(present, N)
    point_valid = present[local_ids] > 0
    slot_of_point = scatter(torch.full((P + 1,), -1, dtype=torch.int64, device=dev), local_ids,
                            torch.arange(N, device=dev))

    presentN = scatter(torch.zeros((P + 1,), dtype=torch.float32, device=dev),
                       torch.where(point_valid, local_ids, _full(local_ids, P)), 1.0)
    presentN[P].zero_()
    obs_cnt_kf = torch.sum(
        presentN[torch.where(kfs.kp_point >= 0, kfs.kp_point, _full(kfs.kp_point, P))]
        * kfs.kp_valid, dim=1)
    in_win_f = scatter(torch.zeros((F,), dtype=torch.bool, device=dev), kf_ids, in_window)
    anchor_sc = torch.where(kfs.valid & ~in_win_f, obs_cnt_kf, _full(obs_cnt_kf, -1.0))
    a_sc, anchor_ids = top_k(anchor_sc, A)
    anchor_ok = a_sc > 0

    all_ids = torch.cat([kf_ids, anchor_ids])
    row_ok = torch.cat([in_window, anchor_ok])
    any_anchor = torch.any(anchor_ok)
    uid_w = torch.where(in_window, kfs.uid[kf_ids], _full(kfs.uid[kf_ids], 2**30))
    oldest_pos = torch.argmin(uid_w)
    fix_gauge = (torch.arange(W, device=dev) == oldest_pos) & (~any_anchor)
    fixed = torch.cat([fix_gauge | (~in_window), torch.ones((A,), dtype=torch.bool, device=dev)])

    kp_all = kfs.kp_point[all_ids]
    kp_point_all = torch.where(row_ok[:, None], kp_all, _full(kp_all, -1))
    slot = slot_of_point[torch.where(kp_point_all >= 0, kp_point_all, _full(kp_point_all, P))]

    lv = kfs.level[all_ids].clamp(0, cfg.orb.n_levels - 1)
    inv_sigma2 = 1.0 / (sf[lv] ** 2)
    depth = kfs.depth[all_ids]
    uv = kfs.uv[all_ids]
    has = depth > 1e-6
    z_safe = torch.where(has, depth, torch.ones_like(depth))
    ur = torch.where(has, uv[..., 0] - cfg.camera.depth_bf / z_safe, _full(depth, -1.0))
    obs_uvr = torch.cat([uv, ur[..., None]], dim=-1)
    prob = BAProblem(
        T_cw=kfs.T_cw[all_ids], fixed=fixed, points=state.points.pos[local_ids],
        point_valid=point_valid,
        point_slot=torch.where(kfs.kp_valid[all_ids], slot, _full(slot, -1)),
        obs_uvr=obs_uvr, inv_sigma2=inv_sigma2, is_stereo=has,
    )
    return prob, kf_ids, all_ids, row_ok, local_ids, point_valid, slot_of_point, kp_point_all


def _ba_and_maintain(state: SlamState, cfg: SlamConfig) -> SlamState:
    P = state.points.pos.shape[0]
    F = state.kfs.valid.shape[0]
    (prob, kf_ids, all_ids, row_ok, local_ids, point_valid, slot_of_point,
     kp_point_all) = assemble_local_ba(state, cfg)
    fixed = prob.fixed
    res = local_bundle_adjust(prob, cfg.camera, cfg.optimizer)

    # Whole-pass trust region: revert everything if a free pose jumped.
    free = (~fixed) & row_ok
    dt = torch.linalg.norm(res.T_cw[:, :3, 3] - prob.T_cw[:, :3, 3], dim=-1)
    dR = res.T_cw[:, :3, :3] @ prob.T_cw[:, :3, :3].transpose(-1, -2)
    tr = dR[:, 0, 0] + dR[:, 1, 1] + dR[:, 2, 2]
    ang = torch.rad2deg(torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)))
    oc = cfg.optimizer
    accept = ~torch.any(free & ((dt > oc.local_ba_max_pose_move) | (ang > oc.local_ba_max_pose_rot_deg)))
    res_T = torch.where(accept, res.T_cw, prob.T_cw)
    res_pts = torch.where(accept, res.points, prob.points)
    res_inlier = res.inlier | ~accept

    kfs = state.kfs
    row_ids = torch.where(row_ok, all_ids, _full(all_ids, F))
    new_T = torch.where(free[:, None, None], res_T, prob.T_cw)
    kfs = kfs.replace(T_cw=scatter(kfs.T_cw, row_ids, new_T))
    pts = state.points
    new_pos = torch.where(point_valid[:, None], res_pts, prob.points)
    pts = pts.replace(pos=scatter(pts.pos, torch.where(point_valid, local_ids, _full(local_ids, P)),
                                  new_pos))

    # observation pruning (erase BA outliers)
    pruned = (prob.point_slot >= 0) & (~res_inlier)
    if not cfg.map.prune_ba_outliers:
        pruned = torch.zeros_like(pruned)
    new_kp_point = torch.where(pruned, _full(kp_point_all, -1), kp_point_all)
    kfs = kfs.replace(kp_point=scatter(
        kfs.kp_point, row_ids,
        torch.where(row_ok[:, None], new_kp_point, state.kfs.kp_point[all_ids])))
    pruned_ids = torch.where(pruned & row_ok[:, None], kp_point_all, _full(kp_point_all, P)).reshape(-1)
    pts = pts.replace(n_obs=torch.clamp(scatter(pts.n_obs, pruned_ids, -1, "add"), min=0))
    state = state.replace(points=pts, kfs=kfs)

    kp_after = kfs.kp_point[all_ids]
    slot_after = slot_of_point[torch.where(kp_after >= 0, kp_after, _full(kp_after, P))]
    state = _refresh_local_points(state, all_ids, row_ok, local_ids, slot_after, point_valid, cfg)
    state = cull_points(state, cfg)
    return cull_keyframes(state, cfg)


# ---------------------------------------------------------------------------
# Culling (with slot release)
# ---------------------------------------------------------------------------

def cull_keyframes(state: SlamState, cfg: SlamConfig) -> SlamState:
    """Cull redundant covisible neighbours of the newest keyframe (>= 90%
    of their tracked points seen by >= 3 other keyframes), recording
    their spanning-tree parent and releasing their slots. The culled
    state is computed whatever the cull, and taken only when something
    is culled (JAX's `lax.cond`): an empty cull returns the state as it
    was, bit for bit."""
    kfs = state.kfs
    pts0 = state.points
    P = pts0.pos.shape[0]
    F, K = kfs.kp_point.shape
    dev = kfs.valid.device
    last = state.last_kf
    uid = kfs.uid
    last_uid = row(uid, last)
    covrow = covisibility_row(kfs.kp_point, kfs.valid, last, P)

    ids = torch.where(kfs.kp_point >= 0, kfs.kp_point, _full(kfs.kp_point, P))
    obs_of = torch.where(ids < P, pts0.n_obs[ids.clamp(0, P - 1)], torch.zeros_like(pts0.n_obs[0]))
    tracked = (kfs.kp_point >= 0) & kfs.kp_valid
    redundant_obs = tracked & (obs_of >= cfg.map.min_observations + 1)
    n_tracked = torch.sum(tracked.to(torch.float32), dim=1)
    ratio = torch.sum(redundant_obs.to(torch.float32), dim=1) / torch.clamp(n_tracked, min=1.0)
    C = min(32, F)
    cand_base = kfs.valid & (covrow > 0) & (uid > 0) & (uid < last_uid - 1)
    cov_sc, cand_rows = top_k(torch.where(cand_base, covrow.to(torch.float32),
                                          torch.full((F,), -1.0, device=dev)), C)
    cull_rows = ((cov_sc > 0) & (ratio[cand_rows] > cfg.map.kf_redundancy_ratio)
                 & (n_tracked[cand_rows] > 10))
    cull = scatter(torch.zeros((F,), dtype=torch.bool, device=dev), cand_rows, cull_rows)
    any_cull = torch.any(cull)

    surv_obs = torch.where((kfs.valid & ~cull)[:, None] & tracked, kfs.kp_point,
                           _full(kfs.kp_point, P)).reshape(-1)
    surv_ref = scatter(torch.full((P + 1,), -1, dtype=torch.int64, device=dev), surv_obs,
                       torch.arange(F, device=dev)[:, None].expand(F, K).reshape(-1), "amax")[:P]
    kp_rows = kfs.kp_point[cand_rows]
    pt_surv = surv_ref[kp_rows.clamp(0, P - 1)]
    vote_ok = cull_rows[:, None] & tracked[cand_rows] & (pt_surv >= 0)
    votes = scatter(torch.zeros((C, F + 1), dtype=torch.float32, device=dev),
                    (torch.arange(C, device=dev)[:, None], torch.where(vote_ok, pt_surv, _full(pt_surv, F))),
                    1.0, "add")[:, :F]
    parent_rows = torch.argmax(votes, dim=1)
    parent_rows = torch.where(torch.amax(votes, dim=1) > 0, parent_rows, last.expand(C))
    parent = scatter(last.expand(F).clone(), cand_rows, parent_rows)
    T_rel = kfs.T_cw @ se3.se3_inverse(kfs.T_cw[parent])
    ref_culled = (pts0.ref_kf >= 0) & cull[pts0.ref_kf.clamp(0, F - 1)]
    new_ref = torch.where(ref_culled, torch.where(surv_ref >= 0, surv_ref, last.expand(P)),
                          pts0.ref_kf)
    culled_ids = torch.where(cull[:, None] & tracked, kfs.kp_point, _full(kfs.kp_point, P))
    n_obs = torch.clamp(scatter(pts0.n_obs, culled_ids.reshape(-1), -1, "add"), min=0)
    ring = state.retired
    new_ring = push_retired(ring, cull, uid, uid[parent], T_rel)

    def pick(new, old):
        return torch.where(any_cull, new, old)

    pts = pts0.replace(n_obs=pick(n_obs, pts0.n_obs), ref_kf=pick(new_ref, pts0.ref_kf))
    kfs = kfs.replace(
        valid=kfs.valid & ~cull,
        kp_point=torch.where(cull[:, None], _full(kfs.kp_point, -1), kfs.kp_point),
        parent_uid=torch.where(cull, uid[parent], kfs.parent_uid),
        T_rel_parent=torch.where(cull[:, None, None], T_rel, kfs.T_rel_parent),
    )
    retired = ring.replace(uid=pick(new_ring.uid, ring.uid),
                           parent_uid=pick(new_ring.parent_uid, ring.parent_uid),
                           T_rel=pick(new_ring.T_rel, ring.T_rel),
                           count=pick(new_ring.count, ring.count))
    return state.replace(points=pts, kfs=kfs, retired=retired,
                         n_kfs=state.n_kfs - cull.sum().to(torch.int32))


def cull_points(state: SlamState, cfg: SlamConfig) -> SlamState:
    """Drop points with a poor found/visible ratio, young points that
    failed to gather observations, and points with none left."""
    pts = state.points
    cur_uid = row(state.kfs.uid, state.last_kf)
    age = cur_uid - pts.first_kf_uid
    visible = torch.clamp(pts.n_visible, min=1)
    ratio = pts.n_found.to(torch.float32) / visible.to(torch.float32)
    bad_ratio = (pts.n_visible >= 8) & (ratio < cfg.map.min_found_ratio)
    bad_young = (age >= 3) & (age <= 4) & (pts.n_obs < cfg.map.min_observations)
    cull = pts.valid & (bad_ratio | bad_young | (pts.n_obs <= 0))
    return state.replace(
        points=pts.replace(valid=pts.valid & ~cull),
        kfs=state.kfs.replace(kp_point=clear_point_refs(state.kfs.kp_point, cull)),
        n_points=state.n_points - cull.sum().to(torch.int32),
    )
