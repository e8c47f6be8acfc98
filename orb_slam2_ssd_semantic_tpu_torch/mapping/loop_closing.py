"""Loop detection and closure (counterpart of the JAX package's
`mapping/loop_closing.py`): the LoopClosing thread of the reference
(perfect/src/LoopClosing.cc:55-826), sequenced per new keyframe by
`LoopCloser.on_keyframe`:

  1. the keyframe database: the keyframe's bag of words (a DBoW2
     vocabulary, or the flat codebook of `place_recognition.py`) is
     inserted and scored against every keyframe; relocalization scores
     arbitrary frames against the same database (`frame_scores`);
  2. DetectLoop (`_detect`): candidates above the lowest covisible
     neighbour's score, outside the keyframe's covisibility group and
     recent past, accepted after `covisibility_consistency_th`
     consecutive keyframes produced chained covisibility groups;
  3. ComputeSim3 (`_estimate_loop_transform`): descriptor matching,
     3D-3D RANSAC (with a two-pass pose-guided window search through B1
     when appearance matching fails), bidirectional Sim3 refinement
     (`sim3_opt.py`), then the guided confirmation of the candidate's
     covisible landmarks in the new keyframe (`_guided_confirm`, B1 at
     4096 x K);
  4. CorrectLoop (`_correct`): the essential-graph optimization
     (`pose_graph.py`: dense for F <= 1024, chain-preconditioned CG
     above), the rigid carry of every map point with its reference
     keyframe, SearchAndFuse over the 4 x 4 keyframe neighbourhoods of
     the loop (`local_mapping.fuse_pair`, B1), global BA
     (`global_ba.py`), and the minimum-discrepancy and map-consistency
     guards.

The host sequences and keeps the small state (consistency chains, loops,
the last loop's uid); orderings that the JAX module takes from numpy's
default sort on host copies are taken from the same numpy calls here, so
ties fall the same way. Each RANSAC draws from a generator seeded with
the JAX module's integers on the keyframe's device: the same seeds, but
another random stream. Profiler ranges `loop.detect`, `loop.sim3`,
`loop.confirm`, `loop.pose_graph`, `loop.fuse` and `loop.global_ba` split
a call for `chip_smoke.py`.

With a device `mesh` (`parallel/mesh.make_mesh`), the vocabulary
database's rows are split over the `kf` axis: each rank holds and scores
its own rows and the (F,) score row is gathered
(`parallel/dist_bow.make_sharded_l1_scores`), and the global BA after a
closure runs with its observations split over `pt`
(`global_ba_step_state_sharded`). Every rank runs the same closer on the
same keyframes, so the collectives meet in order.

`database_from_numpy` / `database_to_numpy` carry the database to and
from the JAX closer's arrays (`word_db`/`val_db`, or `bow_db`), and
`loop_state_from_numpy` its consistency chains and last loop.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
from orb_slam2_ssd_semantic_tpu_torch.config import SlamConfig
from orb_slam2_ssd_semantic_tpu_torch.frontend.extractor import scale_factors
from orb_slam2_ssd_semantic_tpu_torch.geometry import camera as cam_ops
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.geometry.ransac3d import ransac_rigid
from orb_slam2_ssd_semantic_tpu_torch.io import vocabulary as voc
from orb_slam2_ssd_semantic_tpu_torch.io.artifacts import find_checkpoint, warn_missing
from orb_slam2_ssd_semantic_tpu_torch.mapping import place_recognition as pr
from orb_slam2_ssd_semantic_tpu_torch.mapping.global_ba import (
    global_ba_step_state,
    global_ba_step_state_sharded,
    problem_from_state,
)
from orb_slam2_ssd_semantic_tpu_torch.mapping.local_mapping import fuse_pair
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import (
    SlamState,
    covisibility,
    covisibility_row,
)
from orb_slam2_ssd_semantic_tpu_torch.mapping.pose_graph import (
    build_graph_arrays,
    optimize_pose_graph,
    optimize_pose_graph_pcg,
)
from orb_slam2_ssd_semantic_tpu_torch.mapping.sim3_opt import optimize_sim3
from orb_slam2_ssd_semantic_tpu_torch.ops import match as match_ops
from orb_slam2_ssd_semantic_tpu_torch.parallel import dist_bow
from orb_slam2_ssd_semantic_tpu_torch.parallel.mesh import (
    KF_AXIS,
    check_mesh,
    gather_rows,
    mesh_device,
    shard_rows,
)
from orb_slam2_ssd_semantic_tpu_torch.utils import precision
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import nanmedian

# Landmarks the guided confirmation projects (the JAX module's CAP).
CONFIRM_CAP = 4096


@precision.scoped
def map_median_reproj_error(state: SlamState, cfg: SlamConfig) -> float:
    """Median reprojection error (px) over all valid (keyframe, point)
    observations in front of their camera: the map-consistency metric of
    the loop-correction guard. An even count averages the two middle
    errors, as `jnp.nanmedian` does."""
    prob = problem_from_state(state, cfg)
    T = prob.T_cw[prob.obs_kf]
    pc = (T[:, :3, :3] @ prob.points[prob.obs_pt][..., None])[..., 0] + T[:, :3, 3]
    uv, _ = cam_ops.project(pc, cfg.camera)
    err = torch.linalg.norm(uv - prob.obs_uvr[:, :2], dim=-1)
    ok = prob.obs_valid & (pc[:, 2] > 1e-6)
    return float(nanmedian(torch.where(ok, err, torch.full_like(err, float("nan")))))


class LoopCloser:
    def __init__(self, cfg: SlamConfig, device=None, mesh=None):
        """`cfg.loop.vocabulary_path` names a DBoW2 vocabulary (`.npz`
        binary or text); "auto" resolves the trained
        `checkpoints/orbvoc_synth.npz` and, when it is missing, warns and
        takes the flat codebook (as the JAX closer does); None takes the
        flat codebook. `device=None` runs on the card, or on the mesh's
        device. `mesh`: a (kf, pt) mesh shards the vocabulary database
        over `kf` and the post-closure global BA over `pt`."""
        self.cfg = cfg
        self.mesh = mesh
        self._sharded_scores = None
        if mesh is not None:
            check_mesh(mesh)
            device = mesh_device(mesh) if device is None else device
        self.device = device_mod.resolve(device)
        # Consistency chains [(covisibility group, consecutive count)] of
        # the previous keyframe's candidates (mvConsistentGroups).
        self.prev_groups: list = []
        self.loops: list = []  # accepted (kf_i, kf_j, T_ji numpy)
        self.last_loop_uid = -(10 ** 9)
        F, K = cfg.map.max_keyframes, cfg.orb.max_keypoints
        p = cfg.loop.vocabulary_path
        if p == "auto":
            p = find_checkpoint("orbvoc_synth.npz")
            if p is None:
                warn_missing("orbvoc_synth.npz", "the flat random codebook")
        self.vocab = None  # the vocabulary's tree on the device, or None: the codebook
        if p:
            vocab = voc.load_binary(p) if p.endswith(".npz") else voc.load_text_vocabulary(p)
            self.vocab = voc.to_device(vocab, self.device)
            self.word_db = torch.full((F, K), -1, dtype=torch.int64, device=self.device)
            self.val_db = torch.zeros((F, K), dtype=torch.float32, device=self.device)
            if mesh is not None:
                self._sharded_scores = dist_bow.make_sharded_l1_scores(mesh, self.vocab.n_words)
                self.word_db = shard_rows(self.word_db, mesh, KF_AXIS)
                self.val_db = shard_rows(self.val_db, mesh, KF_AXIS)
        else:
            self.bow_db = torch.zeros((F, pr.VOCAB_SIZE), dtype=torch.float32, device=self.device)

    @property
    def backend(self) -> str:
        """"vocabulary (<k>^<depth>, <n> words)" or "flat codebook (<K> words)"."""
        if self.vocab is None:
            return f"flat codebook ({pr.VOCAB_SIZE} words)"
        k = self.vocab.children.shape[1]
        return f"vocabulary ({k}^{self.vocab.depth}, {self.vocab.n_words} words)"

    def _whole(self, db: torch.Tensor) -> torch.Tensor:
        """The whole (F, K) database (under a mesh, gathered from each
        rank's rows: a collective)."""
        return db if self._sharded_scores is None else gather_rows(db, self.mesh, KF_AXIS)

    # ---- carrying the database across -----------------------------------

    def database_from_numpy(self, db: dict) -> None:
        """Take the JAX closer's database: {"word_db", "val_db"} for the
        vocabulary backend, {"bow_db"} for the codebook."""
        if self.vocab is not None:
            self.word_db = torch.from_numpy(np.asarray(db["word_db"]).astype(np.int64)).to(self.device)
            self.val_db = torch.from_numpy(np.array(db["val_db"], np.float32)).to(self.device)
            if self._sharded_scores is not None:
                self.word_db = shard_rows(self.word_db, self.mesh, KF_AXIS)
                self.val_db = shard_rows(self.val_db, self.mesh, KF_AXIS)
        else:
            self.bow_db = torch.from_numpy(np.array(db["bow_db"], np.float32)).to(self.device)

    def database_to_numpy(self) -> dict:
        """The database with the JAX closer's names and dtypes (gathered
        from the ranks under a mesh)."""
        if self.vocab is not None:
            return {"word_db": self._whole(self.word_db).cpu().numpy().astype(np.int32),
                    "val_db": self._whole(self.val_db).cpu().numpy()}
        return {"bow_db": self.bow_db.cpu().numpy()}

    def loop_state_from_numpy(self, st: dict) -> None:
        """Take the JAX closer's host state: {"prev_groups": [(set of
        slots, consecutive count)], "last_loop_uid": int}."""
        self.prev_groups = [(set(int(f) for f in g), int(c)) for g, c in st["prev_groups"]]
        self.last_loop_uid = int(st["last_loop_uid"])

    # ---- per-keyframe hooks ----------------------------------------------

    def _add_and_score(self, state: SlamState, kf_id: int) -> np.ndarray:
        """Insert keyframe kf_id into the BoW database and return its
        similarity scores against every database row (F,)."""
        desc = state.kfs.desc[kf_id]
        valid = state.kfs.kp_valid[kf_id]
        if self.vocab is not None:
            words = voc.quantize(self.vocab, desc, valid)
            vals = voc.bow_columns(words, self.vocab.idf)
            row = kf_id
            if self._sharded_scores is not None:  # only the rank owning the slot writes it
                row -= self.mesh.get_local_rank(KF_AXIS) * self.word_db.shape[0]
            if 0 <= row < self.word_db.shape[0]:
                self.word_db = self.word_db.clone()
                self.val_db = self.val_db.clone()
                self.word_db[row] = words
                self.val_db[row] = vals
            return self._score_db(words, vals)
        vec = pr.bow_vector(desc, valid)
        self.bow_db = self.bow_db.clone()
        self.bow_db[kf_id] = vec
        return pr.bow_scores(vec, self.bow_db).cpu().numpy()

    def frame_scores(self, desc: torch.Tensor, valid: torch.Tensor) -> np.ndarray:
        """Score an arbitrary frame against the database WITHOUT
        inserting it (DetectRelocalizationCandidates side). (F,) numpy."""
        if self.vocab is not None:
            words = voc.quantize(self.vocab, desc, valid)
            return self._score_db(words, voc.bow_columns(words, self.vocab.idf))
        return pr.bow_scores(pr.bow_vector(desc, valid), self.bow_db).cpu().numpy()

    def _score_db(self, words, vals) -> np.ndarray:
        """The (F,) scores of a frame's BoW columns against the database:
        with a mesh each rank scores its rows and the row is gathered."""
        if self._sharded_scores is not None:
            return self._sharded_scores(words, vals, self.word_db, self.val_db).cpu().numpy()
        return voc.l1_scores(words, vals, self.word_db, self.val_db,
                             self.vocab.n_words).cpu().numpy()

    @precision.scoped
    def on_keyframe(self, state: SlamState, kf_id: int):
        """Update the database with the keyframe in SLOT `kf_id` (recency is
        measured in uids: slots are reused) and attempt loop detection and
        closure. Returns (state, closed)."""
        cfg = self.cfg
        with record_function("loop.detect"):
            scores = self._add_and_score(state, kf_id)
            kf_uid = int(state.kfs.uid[kf_id])
            if kf_uid < cfg.loop.min_kfs_before_loop or (
                kf_uid - self.last_loop_uid < cfg.loop.min_kfs_before_loop
            ):
                return state, False
            cands = self._detect(state, kf_id, kf_uid, scores)
        # Every consistent candidate gets a geometric attempt (the
        # reference iterates Sim3 over all mvpEnoughConsistentCandidates).
        for cand in cands:
            ok, T_ji, _ = self._estimate_loop_transform(state, kf_id, cand)
            if ok:
                state, accepted = self._correct(state, kf_id, cand, T_ji)
                if not accepted:
                    continue
                self.loops.append((cand, kf_id, np.array(T_ji, np.float32)))
                self.last_loop_uid = kf_uid
                return state, True
        return state, False

    # ---- detection --------------------------------------------------------

    def _detect(self, state: SlamState, kf_id: int, kf_uid: int, scores: np.ndarray) -> list:
        """The consistent loop candidates of keyframe `kf_id`, best score
        first (host numpy on fetched copies)."""
        cfg = self.cfg
        F = scores.shape[0]
        P = state.points.pos.shape[0]
        kfs = state.kfs
        W = covisibility_row(kfs.kp_point, kfs.valid, kf_id, P).cpu().numpy()
        neighbors = W >= cfg.map.covis_weight_threshold
        # Min covis-neighbour score normalization (LoopClosing.cc:143-160).
        min_score = float(scores[neighbors].min()) if neighbors.any() else 0.0
        exclude = np.zeros(F, bool)
        exclude[kf_id] = True
        exclude |= neighbors
        # Temporally adjacent keyframes share the view trivially.
        exclude |= kfs.uid.cpu().numpy() > kf_uid - cfg.loop.min_kfs_before_loop
        s = np.where(kfs.valid.cpu().numpy() & (~exclude), scores, -1.0)
        ok = s >= max(min_score, 1e-9)
        if not ok.any():
            self.prev_groups = []
            return []
        # Covisibility-group consistency (LoopClosing.cc:200-290).
        cand_ids = np.nonzero(ok)[0]
        cand_ids = cand_ids[np.argsort(-s[cand_ids])][:10]
        Wfull = covisibility(kfs.kp_point, kfs.valid, P).cpu().numpy()
        th = cfg.map.covis_weight_threshold
        current_groups, accepted = [], []
        for c in cand_ids:
            group = set(np.nonzero(Wfull[c] >= th)[0].tolist()) | {int(c)}
            count = 0
            for pg, pc in self.prev_groups:
                if group & pg:
                    count = max(count, pc + 1)
            current_groups.append((group, count))
            if count >= cfg.loop.covisibility_consistency_th:
                accepted.append(int(c))
        self.prev_groups = current_groups
        return accepted

    # ---- Sim3 / rigid estimation ------------------------------------------

    @precision.scoped
    def _estimate_loop_transform(self, state: SlamState, kf_id: int, cand: int):
        """(ok, T_ji (4, 4) numpy or None, matches): the rigid transform
        from candidate `cand`'s camera to keyframe `kf_id`'s, confirmed on
        the candidate's covisible landmarks."""
        cfg = self.cfg
        cam = cfg.camera
        kfs = state.kfs
        dev = kfs.valid.device
        with record_function("loop.sim3"):
            di, dj = kfs.desc[cand], kfs.desc[kf_id]
            vi = kfs.kp_valid[cand] & (kfs.depth[cand] > 0)
            vj = kfs.kp_valid[kf_id] & (kfs.depth[kf_id] > 0)
            m = match_ops.masked_best_match(match_ops.hamming_matrix(di, dj),
                                            vi[:, None] & vj[None, :], max_dist=match_ops.TH_LOW,
                                            ratio=0.75, mutual=True)
            # 3D points in each keyframe's own camera frame.
            pi = cam_ops.backproject(kfs.uv[cand], kfs.depth[cand], cam)
            pj = cam_ops.backproject(kfs.uv[kf_id], kfs.depth[kf_id], cam)
            K = pi.shape[0]
            tgt = m.idx.clamp(0, K - 1)
            src, dst = pi, pj[tgt]
            s, R, t, inl, n_inl = ransac_rigid(src, dst, m.valid, _generator(kf_id, dev),
                                               threshold=cfg.loop.sim3_ransac_threshold,
                                               with_scale=False)
            n = int(n_inl)
            if n < cfg.loop.sim3_min_inliers:
                # Pose-guided fallback: unguided appearance matching fails
                # under the viewpoint change of a typical revisit, while the
                # current pose estimates nearly align the pair; two passes
                # (SearchBySim3 -> OptimizeSim3 -> narrower
                # SearchByProjection, LoopClosing.cc:439-540): the wide
                # window's small true consensus pins an approximate
                # transform, the fine window below the texture's aliasing
                # pitch then recovers the full true set. No rotation
                # histogram: the 3D RANSAC is the consistency filter.
                T1 = kfs.T_cw[kf_id] @ se3.se3_inverse(kfs.T_cw[cand])
                for radius, ransac_th in ((cfg.loop.guided_radius_wide,
                                           cfg.loop.sim3_ransac_threshold),
                                          (cfg.loop.guided_radius_fine,
                                           cfg.loop.sim3_ransac_threshold_fine)):
                    uv_pred, z_pred = cam_ops.project(se3.transform_points(T1, pi), cam)
                    q_valid = vi & (z_pred > 0.05) & cam_ops.in_image(uv_pred, cam)
                    m = match_ops.match_by_window(
                        di, dj, uv_pred, kfs.uv[kf_id], q_valid, vj,
                        torch.full((K,), radius, dtype=torch.float32, device=dev),
                        max_dist=match_ops.TH_LOW)
                    tgt = m.idx.clamp(0, K - 1)
                    dst = pj[tgt]
                    s, R, t, inl, n_inl = ransac_rigid(src, dst, m.valid,
                                                       _generator(kf_id + 7919, dev),
                                                       threshold=ransac_th, with_scale=False)
                    if int(n_inl) < 5:
                        break
                    T1 = se3.rt_to_mat(R, t)
                n = int(n_inl)
            if n < cfg.loop.sim3_min_inliers:
                return False, None, n
            # Bidirectional-reprojection refinement of the RANSAC seed
            # (OptimizeSim3, scale frozen for RGB-D). Its inlier count
            # gates nothing: the guided confirmation below is the test.
            sf = scale_factors(cfg.orb, dev)
            isig_i = 1.0 / (sf[kfs.level[cand].clamp(0, sf.shape[0] - 1)] ** 2)
            isig_j = 1.0 / (sf[kfs.level[kf_id].clamp(0, sf.shape[0] - 1)] ** 2)
            res = optimize_sim3(s, R, t, src, dst, kfs.uv[cand], kfs.uv[kf_id][tgt], isig_i,
                                isig_j[tgt], m.valid & inl, cam, fix_scale=True)
            finite = bool(torch.isfinite(res.R).all() & torch.isfinite(res.t).all())
            T_ji = se3.rt_to_mat(res.R, res.t) if finite else se3.rt_to_mat(R, t)
            T_ji = T_ji.cpu().numpy()
        # Guided confirmation + wide refinement (SearchByProjection of the
        # candidate's neighbourhood, accept at >= min_total_matches).
        with record_function("loop.confirm"):
            ok2, T_ji2, n2 = self._guided_confirm(state, kf_id, cand, T_ji)
        if not ok2:
            return False, None, n2
        return True, T_ji2, n2

    def _guided_confirm(self, state: SlamState, kf_id: int, cand: int, T_ji: np.ndarray):
        """Project the loop-side (cand + 5 best covisible) landmarks into
        keyframe `kf_id` through T_ji @ T_cand_cw, window-match, require
        >= min_total_matches, and refit the rigid transform (Horn) on the
        matched set after a 3 x median residual trim."""
        cfg = self.cfg
        cam = cfg.camera
        kfs, pts = state.kfs, state.points
        dev = kfs.valid.device
        P = pts.pos.shape[0]
        covrow = covisibility_row(kfs.kp_point, kfs.valid, cand, P).cpu().numpy()
        kv = kfs.valid.cpu().numpy()
        nbrs = [cand] + [int(f) for f in np.argsort(-covrow)[:5] if covrow[f] > 0 and bool(kv[f])]
        obs_mask = np.zeros(P, bool)
        kp_np = kfs.kp_point.cpu().numpy()
        kpv_np = kfs.kp_valid.cpu().numpy()
        for f in nbrs:
            obs_mask[kp_np[f][(kp_np[f] >= 0) & kpv_np[f]]] = True
        obs_mask &= pts.valid.cpu().numpy()
        ids = np.nonzero(obs_mask)[0]
        if len(ids) < cfg.loop.min_total_matches:
            return False, T_ji, len(ids)
        if len(ids) > CONFIRM_CAP:  # keep the best-observed landmarks
            n_obs = pts.n_obs.cpu().numpy()[ids]
            ids = ids[np.argsort(-n_obs, kind="stable")[:CONFIRM_CAP]]
        sel = np.full(CONFIRM_CAP, P - 1, np.int64)
        sel[:len(ids)] = ids
        sel_valid = np.zeros(CONFIRM_CAP, bool)
        sel_valid[:len(ids)] = True
        sel = torch.from_numpy(sel).to(dev)

        X = pts.pos[sel]
        T_ji_t = torch.from_numpy(np.ascontiguousarray(T_ji, np.float32)).to(dev)
        uv, z = cam_ops.project(se3.transform_points(T_ji_t @ kfs.T_cw[cand], X), cam)
        q_valid = torch.from_numpy(sel_valid).to(dev) & (z > 0.05) & cam_ops.in_image(uv, cam)
        m = match_ops.match_by_window(
            pts.desc[sel], kfs.desc[kf_id], uv, kfs.uv[kf_id], q_valid, kfs.kp_valid[kf_id],
            torch.full((CONFIRM_CAP,), cfg.loop.guided_radius_fine, dtype=torch.float32,
                       device=dev),
            max_dist=match_ops.TH_LOW)
        n_m = int(m.valid.sum())
        if n_m < cfg.loop.min_total_matches:
            return False, T_ji, n_m
        # Landmarks in cand's camera frame against the matched keypoints'
        # depth backprojections in the keyframe's frame.
        src = se3.transform_points(kfs.T_cw[cand], X)
        tgt = m.idx.clamp(0, kfs.uv.shape[1] - 1)
        d_kf = kfs.depth[kf_id][tgt]
        dst = cam_ops.backproject(kfs.uv[kf_id][tgt], d_kf, cam)
        wm = (m.valid & (d_kf > 1e-6)).to(torch.float32)
        # Robust trim: drop pairs whose residual under T_ji exceeds 3x the
        # median (guards the Horn fit against residual mismatches).
        r = torch.linalg.norm(se3.transform_points(T_ji_t, src) - dst, dim=-1)
        med = nanmedian(torch.where(wm > 0, r, torch.full_like(r, float("nan"))))
        wm = wm * (r <= torch.maximum(3.0 * med, torch.full_like(med, 0.05))).to(torch.float32)
        n_w = int(wm.sum())
        if n_w < cfg.loop.min_total_matches:
            return False, T_ji, n_w
        _, R, t = se3.horn_sim3(src, dst, wm, with_scale=False)
        return True, se3.rt_to_mat(R, t).cpu().numpy(), n_m

    # ---- correction -------------------------------------------------------

    @precision.scoped
    def _correct(self, state: SlamState, kf_id: int, cand: int, T_ji):
        """CorrectLoop with the measured T_ji (4, 4): returns (state,
        accepted); a rejected correction returns the state unchanged."""
        cfg = self.cfg
        kfs = state.kfs
        dev = kfs.valid.device
        F = kfs.valid.shape[0]
        P = state.points.pos.shape[0]
        state0 = state
        T_ji = np.array(T_ji.cpu() if torch.is_tensor(T_ji) else T_ji, np.float32)

        # Minimum-discrepancy gate: a loop whose measurement matches the
        # current relative pose to within noise corrects nothing.
        T_cur_rel = (kfs.T_cw[kf_id] @ se3.se3_inverse(kfs.T_cw[cand])).cpu().numpy()
        D = T_ji @ np.linalg.inv(T_cur_rel)
        d_t = float(np.linalg.norm(D[:3, 3]))
        d_r = float(np.degrees(np.arccos(np.clip((np.trace(D[:3, :3]) - 1.0) / 2.0, -1.0, 1.0))))
        if d_t < cfg.loop.min_correction_translation and d_r < cfg.loop.min_correction_rotation_deg:
            return state0, False

        with record_function("loop.pose_graph"):
            err_before = map_median_reproj_error(state, cfg)
            covis = covisibility(kfs.kp_point, kfs.valid, P)
            T_before = kfs.T_cw
            graph = build_graph_arrays(
                covis, kfs.valid, threshold=cfg.loop.essential_graph_covis_threshold,
                max_edges=4 * F, T_cw=T_before,
                extra_edges=[(cand, kf_id, cfg.loop.loop_edge_weight, T_ji)], uid=kfs.uid)
            # Gauge: the oldest live keyframe (slot 0 can be reused).
            uid_np = kfs.uid.cpu().numpy()
            valid_np = kfs.valid.cpu().numpy()
            live_uid = np.where(valid_np & (uid_np >= 0), uid_np, 2 ** 30)
            fixed = torch.arange(F, device=dev) == int(np.argmin(live_uid))
            # Dense (6F, 6F) solve up to ~1k keyframes, chain-preconditioned
            # CG above (the dense system outgrows memory).
            if F <= 1024:
                T_after = optimize_pose_graph(T_before, kfs.valid, graph, fixed=fixed)
            else:
                order = torch.from_numpy(np.argsort(live_uid, kind="stable")).to(dev)
                T_after = optimize_pose_graph_pcg(T_before, kfs.valid, graph, fixed=fixed,
                                                  chain_perm=order)
            # Carry each map point rigidly with its reference keyframe
            # (LoopClosing.cc:606-640): p' = inv(T'_ref) @ T_ref @ p.
            ref = state.points.ref_kf.clamp(0, F - 1)
            T_old, T_new = T_before[ref], T_after[ref]
            p = state.points.pos
            p_cam = (T_old[:, :3, :3] @ p[..., None])[..., 0] + T_old[:, :3, 3]
            p_new = (T_new[:, :3, :3].transpose(-1, -2)
                     @ (p_cam - T_new[:, :3, 3])[..., None])[..., 0]
            state = state.replace(
                points=state.points.replace(pos=torch.where(state.points.valid[:, None], p_new, p)),
                kfs=kfs.replace(T_cw=T_after))

        # SearchAndFuse (LoopClosing.cc:791-824): with the loop's sides
        # aligned, fuse each loop-side keyframe (cand + 3 best covisible)
        # with each current-side one (kf_id + 3 best covisible), so both
        # sides share observations and the global BA pulls toward the data.
        with record_function("loop.fuse"):
            covis_np = covis.cpu().numpy()
            valid_np2 = state.kfs.valid.cpu().numpy()

            def side(k):
                return [k] + [int(n) for n in np.argsort(-covis_np[k])[:3]
                              if covis_np[k, n] > 0 and valid_np2[n]]

            for a in side(cand):
                for b in side(kf_id):
                    state = fuse_pair(state, a, b, cfg)

        # Full-map BA seeded by the pose-graph solution (the GBA thread,
        # LoopClosing.cc:773-826), then the monotone acceptance guard: a
        # correction must not degrade the map's internal consistency
        # (meaningful only after GBA; no reference analogue).
        if cfg.loop.run_global_ba:
            with record_function("loop.global_ba"):
                if self.mesh is not None:
                    state = global_ba_step_state_sharded(state, cfg, self.mesh)
                else:
                    state = global_ba_step_state(state, cfg)
                if cfg.loop.correction_guard:
                    err_after = map_median_reproj_error(state, cfg)
                    if not np.isfinite(err_after) or err_after > (
                            cfg.loop.correction_guard_slack * err_before + 0.1):
                        return state0, False
        return state, True


def _generator(seed: int, device) -> torch.Generator:
    """A RANSAC generator seeded with the JAX module's PRNGKey integer."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
