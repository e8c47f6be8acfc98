"""Configuration for the TPU SLAM engine.

Covers the reference's full YAML key surface (SURVEY.md §2.7: Camera.*,
ThDepth, DepthMapFactor, ORBextractor.*, octoMap.res, Dynamic.flow,
PointCloudMapping.Resolution — read in perfect/src/Tracking.cc:431-561)
and additionally lifts the constants the reference hardcodes in source
(match thresholds, RANSAC iterations, culling rules, fusion gates) into
explicit config fields, as called out in SURVEY.md §2.7.

Everything is a frozen dataclass so configs can be closed over by jitted
functions as static values. Capacity fields (``max_*``) define the fixed
array shapes of the device-resident state; they have no analogue in the
reference, whose STL containers grow without bound.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera intrinsics (reference: Camera.* yaml keys)."""

    fx: float = 535.4
    fy: float = 539.2
    cx: float = 320.1
    cy: float = 247.6
    # Radial/tangential distortion (k1 k2 p1 p2 k3). TUM3 is rectified.
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 30.0
    # Stereo baseline times fx (reference Camera.bf; TUM3.yaml: 40.0).
    bf: float = 40.0
    # 1 if images are RGB order, 0 if BGR.
    rgb: int = 1
    # Depth threshold multiplier: close/far split at bf*th_depth/fx meters
    # (reference ThDepth=40 → ~3 m; perfect/src/Tracking.cc:545).
    th_depth: float = 40.0
    # Raw depth units per meter (5000 TUM / 1000 TY; Tracking.cc:556-560).
    depth_map_factor: float = 5000.0

    # Virtual baseline-times-fx used to WEIGHT the depth residual in
    # optimization: uR = u - depth_bf/z (the reference's
    # EdgeStereoSE3ProjectXYZ with bf). Equivalent depth sigma is
    # sigma_z = sigma_px * z^2 / depth_bf. The reference's 40 remains
    # the robust operating point: r4 measured depth_bf=120 and 400 on
    # the loop circuit (after the subpixel depth sampler removed the
    # grazing-angle bias that sank 400 in r2/r3) and both still tracked
    # WORSE than 40 — residual depth error is viewpoint-correlated, and
    # over-weighting it trades the well-measured image-plane constraint
    # for it.
    depth_bf: float = 40.0

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    @property
    def depth_threshold(self) -> float:
        """Max depth considered 'close' (reliable) in meters."""
        return self.bf * self.th_depth / self.fx


@dataclass(frozen=True)
class OrbConfig:
    """ORB extractor settings (reference ORBextractor.* yaml keys,
    perfect/src/ORBextractor.cc:399-478)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # Descriptor patch: IC-angle half patch 15, BRIEF patch 31
    # (ORBextractor.cc:52-54).
    half_patch_size: int = 15
    patch_size: int = 31
    edge_threshold: int = 19
    # Grid cell size in pixels for FAST candidate binning
    # (reference uses 30 px cells, ORBextractor.cc:771+).
    cell_size: int = 16
    # Fixed capacity for padded keypoint arrays (n_features rounded up
    # to a TPU-friendly multiple).
    max_keypoints: int = 1024
    # Per-cell candidate cap before cross-level top-k selection.
    max_per_cell: int = 4


@dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching thresholds (perfect/src/ORBmatcher.cc:40-49)."""

    th_low: int = 50
    th_high: int = 100
    nn_ratio: float = 0.9
    # Rotation-consistency histogram (ORBmatcher.cc:2068): keep the 3
    # largest of 30 bins.
    histo_length: int = 30
    check_orientation: bool = True
    # Projection search radii in pixels, scaled by the keypoint's octave.
    # Motion-model search: th=7 for RGB-D (Tracking.cc:1934).
    mm_search_radius: float = 7.0
    # Local-map search: th=1 x RadiusByViewingCos(2.5) for well-tracked
    # frames (ORBmatcher.cc:63-160, Tracking.cc:2694) — tight windows
    # bound the association bias that a drifted seed can induce.
    lm_search_radius: float = 2.5


@dataclass(frozen=True)
class TrackingConfig:
    """Tracking-thread heuristics (perfect/src/Tracking.cc)."""

    # Min matches to accept motion-model / reference-KF tracking
    # (Tracking.cc:1940-1990).
    min_matches_track: int = 20
    # Min inliers after pose optimization (Tracking.cc:2000).
    min_inliers_track: int = 10
    # Min inliers for TrackLocalMap success (Tracking.cc:2166-2180).
    min_inliers_local_map: int = 30
    # Keyframe insertion throttle: reference doubles stock max
    # (mMaxFrames*2, Tracking.cc:2386) — max_frames is fps.
    min_frames_between_kfs: int = 0
    max_frames_between_kfs: int = 30
    # Reference-to-KF tracked-point ratio below which a new KF is needed
    # (Tracking.cc:2423-2480 map-overlap ratio test). The reference
    # compares against the ref KF's MATURE tracked points (>= 3
    # observations) at thRefRatio=0.75; this engine's reference count is
    # the new keyframe's TOTAL association count at insertion (tracked +
    # spawned, typically ~5x the mature count), so the equivalent
    # operating point is a lower ratio. 0.15 yields the reference-like
    # ~1 KF / 8-14 frames cadence on the bench circuit; raising it
    # toward 0.75 inserts a keyframe every 2-3 frames, tripling keyframe
    # -event cost for no accuracy gain (r4 measurements).
    kf_ref_ratio: float = 0.15
    # Absolute inlier floor: insert a keyframe whenever local-map inliers
    # drop below this, regardless of the ratio test. The reference's
    # cadence driver for RGB-D is the close-point rule (c1c,
    # Tracking.cc:2430), which cannot fire when the whole view is beyond
    # the close-depth range (a far-wall stretch of a room circuit) — the
    # exact regime where inlier decay to <100 degrades pose conditioning
    # and injects decimeter drift (r3 finding). A floor keeps geometry
    # well-conditioned everywhere. 0 disables (reference parity).
    kf_min_inliers: int = 0
    # Close-point bookkeeping for RGB-D KF decision (Tracking.cc:2430).
    min_close_points: int = 100
    max_non_tracked_close: int = 70
    # Relocalization: min inliers to accept (Tracking.cc:2714+).
    min_inliers_reloc: int = 50
    # Auto reset if LOST with <= this many keyframes (Tracking.cc:1153).
    reset_if_lost_with_kfs: int = 5
    # Constant-velocity model damping. With undamped extrapolation the
    # no-innovation error recursion is e(n+1) = 2 e(n) - e(n-1) —
    # exponentially unstable along weakly-observed directions (estimator
    # returns ~the prediction there, e.g. the z/depth mode of a
    # fronto-dominant scene once the chi2 gate culls close points).
    # Damping the velocity by alpha < 1 makes that recursion marginally
    # stable (roots 1 and alpha) at the cost of a small prediction lag.
    # The reference uses alpha = 1 and relies on relocalization to
    # recover from the resulting escapes.
    velocity_damping: float = 0.85
    # Max new map points spawned from close depth per KF
    # (Tracking.cc:2548-2605 caps at 100 when many close points).
    max_new_points_per_kf: int = 100
    # Subpixel (discontinuity-aware bilinear) keypoint depth sampling
    # (ops/image.robust_depth_sample). False = reference nearest-pixel
    # reads (Frame::ComputeStereoFromRGBD).
    subpixel_depth: bool = True
    # Snap the live pose to the BA-refined keyframe pose at insertion.
    # The reference does NOT do this (Tracking's pose evolves only
    # through per-frame optimization against the refined map points);
    # snapping feeds the BA correction into the velocity model, whose
    # next prediction then overshoots by the same jump — a period-2
    # inlier oscillation (~600 -> ~180 -> ~500) observed on the r4
    # circuit. Kept as an option for the scan regime.
    reanchor_on_kf: bool = False
    # Asynchronous mapping: dispatch local BA to the device WITHOUT
    # fetching its outputs, so the host frame loop never waits on it —
    # the functional analogue of the reference's LocalMapping thread
    # running concurrently with Tracking (SURVEY.md §2.6 P2; the
    # device pipeline serializes, but the host never stalls and the
    # trajectory re-anchors to the refined poses at save time). Set
    # False to re-anchor the live pose on BA output every keyframe.
    async_mapping: bool = True
    # Fixed candidate-set size for local-map matching (the dense-masked
    # SearchLocalPoints window, Tracking.cc:2631). The (C x K) Hamming
    # matrix is the biggest per-frame matmul; the in-frustum count on
    # room-scale maps rarely exceeds ~1.5k, so 2048 halves that traffic
    # vs round 2's hardwired 4096. Clamped to the map-point capacity.
    local_map_candidates: int = 2048


@dataclass(frozen=True)
class OptimizerConfig:
    """Nonlinear optimization schedules (perfect/src/Optimizer.cc)."""

    # Motion-only BA: 4 rounds with chi2 gates between them
    # (Optimizer.cc:365-593; mono 5.991, stereo/depth 7.815). The
    # reference runs 10 LM iterations per round; Gauss-Newton converges
    # in 3-4 on these well-conditioned problems, and on TPU every extra
    # iteration is ~20 sequential tiny fusions of pure latency — 4 per
    # round keeps the reference's outlier-gating structure at 40% of the
    # sequential depth.
    pose_rounds: int = 4
    pose_iters_per_round: int = 4
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    huber_delta_mono: float = 2.4477  # sqrt(5.991)
    huber_delta_stereo: float = 2.7955  # sqrt(7.815)
    # Local BA: the reference schedules 5 + 10 iterations
    # (Optimizer.cc:843-886) but aborts the second phase whenever a new
    # frame arrives (mbAbortBA, LocalMapping.cc:976 — at 30 fps with BA
    # slower than a frame period, it nearly always stops early). 5 + 5
    # matches that effective behavior at a deterministic cost.
    local_ba_iters_initial: int = 5
    local_ba_iters_refine: int = 5
    # Gain-based early termination (g2o's terminateAction, which the
    # reference's fixed schedules run under): stop a GN phase when the
    # objective between consecutive iterations improves by less than
    # this relative amount. Typical tracking windows converge in 2-4
    # iterations; the schedule above is the worst-case bound. 1e-4
    # stops one iteration past the noise-floor plateau (a 0.01%
    # objective gain moves cm-scale geometry by far less than the
    # 0.5 px observation noise floor); measured ATE-neutral on the
    # bench circuit and the accuracy gates.
    local_ba_min_rel_decrease: float = 1e-4
    # Global BA iterations on loop closure. The reference runs 10
    # (LoopClosing.cc:831) then keeps refining across subsequent loops;
    # 20 here lets one pass converge far enough that the cross-loop
    # fused observations (not the single measured loop transform) set
    # the final trajectory.
    global_ba_iters: int = 20
    # Essential-graph optimization iterations (Optimizer.cc:995+).
    essential_graph_iters: int = 20
    # Levenberg-Marquardt damping bounds.
    lm_lambda_init: float = 1e-4
    lm_lambda_max: float = 1e2
    lm_lambda_min: float = 1e-8
    # Whole-pass trust region for local BA: a window REFINEMENT never
    # legitimately moves a keyframe pose far (r4 measurements: median
    # refinement 2 cm) — a larger jump means the window was degenerate
    # and the step ran along a weak mode (one observed pass moved a pose
    # 80 cm while decreasing the robust cost). If any free pose moves
    # beyond these limits, the WHOLE pass (poses + points + pruning) is
    # reverted, preserving map consistency. Global BA after loop
    # closure is not subject to this (its large moves are the point).
    local_ba_max_pose_move: float = 0.25  # meters
    local_ba_max_pose_rot_deg: float = 5.0
    # Dtype of the local-BA incidence/Schur reduction GEMMs ("bfloat16"
    # or "float32"). bf16 halves the dominant HBM read of each GN
    # iteration, but its ~0.4% relative block error is ABSOLUTE error
    # ~1e4 on the 1e6-1e7-scale Schur products — larger than the weak
    # eigenvalues (~1e2-1e3) of poorly-conditioned windows (e.g. a
    # 2-keyframe window with one free pose), where it turns the reduced
    # system into noise and the GN step into a multi-meter jump (found
    # on the r3 loop-circuit scenario; exact-f64 step was 7 mm). f32 is
    # the safe default; bf16 remains available for well-conditioned
    # batch workloads. Parity on a well-conditioned window is pinned by
    # tests/test_ba_bf16_parity.py.
    ba_reduction_dtype: str = "float32"


@dataclass(frozen=True)
class MapConfig:
    """Fixed capacities for the device-resident map state. The reference
    grows STL containers unboundedly (SURVEY.md §7 'hard parts' #1); we
    pre-allocate and mask."""

    max_keyframes: int = 512
    max_map_points: int = 32768
    # Bounded covisibility degree per keyframe (reference: full weight
    # map, KeyFrame.h:54-64; we keep top-k neighbors by weight).
    max_covis_neighbors: int = 32
    covis_weight_threshold: int = 15
    # Local BA window (covisible KFs of the new KF; Optimizer.cc:624-636).
    local_ba_window: int = 16
    local_ba_max_points: int = 4096
    # Fixed anchor keyframes: KFs outside the window that observe local
    # points enter the problem with frozen poses (Optimizer.cc:661-682
    # lFixedCameras). Also provides the gauge once the map outgrows the
    # window.
    local_ba_fixed_anchors: int = 8
    # Covisible neighbors triangulated against the new KF
    # (LocalMapping::CreateNewMapPoints uses the 10 best, LocalMapping.cc:349).
    triangulation_neighbors: int = 10
    # Duplicate-landmark fusion against the covis neighborhood after each
    # keyframe (LocalMapping::SearchInNeighbors, LocalMapping.cc:652;
    # ORBmatcher::Fuse, ORBmatcher.cc:1031). 0 disables.
    fuse_neighbors: int = 10
    # Fuse projection search radius in px, scaled by predicted octave
    # (ORBmatcher.cc:1057 th=3.0).
    fuse_search_radius: float = 3.0
    # Erase BA-outlier observations after each local BA pass
    # (Optimizer.cc:962-984 vToErase). Diagnostic switch.
    prune_ba_outliers: bool = True
    # Observations gathered per point for descriptor/normal maintenance
    # (MapPoint::ComputeDistinctiveDescriptors considers all; a bounded
    # sample keeps shapes fixed).
    maintenance_max_obs: int = 8
    # Map point culling (LocalMapping.cc:270): found/visible < 0.25.
    min_found_ratio: float = 0.25
    # KF culling redundancy threshold (LocalMapping.cc:764): 90%.
    kf_redundancy_ratio: float = 0.9
    # Observations needed before a point is safe from culling.
    min_observations: int = 3
    # Triangulate far/unassociated landmarks between the new KF and its
    # covisible neighbors (LocalMapping::CreateNewMapPoints; required
    # for monocular, extends RGB-D beyond the depth range).
    triangulate_new_points: bool = True
    # Capacity of the device-side keyframe-retirement record ring
    # (map_state.RetiredRing): spanning-tree (uid, parent_uid, T_rel)
    # entries written at cull/evict time so trajectory references survive
    # slot reuse. Chains older than this many retirements fall back to
    # the broken-chain resolver.
    retired_ring_capacity: int = 2048


@dataclass(frozen=True)
class LoopConfig:
    """Loop closing / place recognition (perfect/src/LoopClosing.cc,
    KeyFrameDatabase.cc)."""

    enabled: bool = True
    # Relocalization after tracking loss (Tracking.cc:2714).
    enable_relocalization: bool = True
    # Consecutive consistent detections required (LoopClosing.cc:52).
    covisibility_consistency_th: int = 3
    # Candidate score must exceed 0.8 x best (KeyFrameDatabase.cc:76-197
    # uses minScore from covis; plus 0.75*bestAccScore accumulation).
    score_ratio: float = 0.75
    # Sim3 RANSAC (LoopClosing.cc:330 uses 300 iters / 20 inliers).
    # 10 here: this floor only gates entry to the Sim3 REFINEMENT — the
    # actual loop acceptance is the guided map-neighborhood confirmation
    # (min_total_matches) plus the correction consistency guard, which
    # the reference does not have. On repetitive texture the wide-window
    # RANSAC consensus is small even for genuine revisits (the ratio
    # test kills ambiguous true pairs); 10 verified 3D-consistent pairs
    # seed a px-accurate bidirectional Sim3 refinement.
    sim3_ransac_iters: int = 300
    sim3_min_inliers: int = 10
    # 3D-3D RANSAC inlier thresholds (meters) for the loop-transform
    # estimate: coarse pass (wide guided window) and fine re-fit pass.
    # Sensor-dependent — the defaults suit near-exact depth; a noisy
    # depth camera (sigma ~ 1.5% of z: ~0.09 m at 6 m, on BOTH sides of
    # each 3D-3D pair) needs proportionally wider gates. The reference's
    # Sim3Solver gates in PIXEL space scaled per-octave
    # (Sim3Solver.cc:343); these are the 3D-domain equivalents.
    sim3_ransac_threshold: float = 0.10
    sim3_ransac_threshold_fine: float = 0.05
    # Pose-guided re-search windows (px): the wide pass seeds matching
    # through the CURRENT pose estimates (bounded by how far drift can
    # deproject at the revisit), the fine pass re-matches below the
    # texture-aliasing pitch after the first Sim3 fit; also the guided
    # map-neighborhood confirmation window. The reference's equivalents
    # are the SearchByProjection radii th=7.5/10 scaled per octave
    # (LoopClosing.cc:480-543, ORBmatcher.cc:378-520). Larger wide
    # windows tolerate more accumulated drift at the cost of aliasing
    # pressure on repetitive texture.
    guided_radius_wide: float = 40.0
    guided_radius_fine: float = 8.0
    # Matches needed to accept a loop after the guided map-neighborhood
    # re-search (the reference requires 40 after SearchByProjection,
    # LoopClosing.cc:522). At this engine's 1024-keypoint frames genuine
    # revisits confirm with 100-700 guided matches; marginal/aliased
    # candidates sit below ~50, and the pose-graph/GBA consistency guard
    # (correction_guard) catches the rest.
    min_total_matches: int = 60
    # KFs skipped after map init before loop detection (LoopClosing.cc:129).
    min_kfs_before_loop: int = 10
    # Run full-map bundle adjustment after each accepted loop correction
    # (the GBA thread of LoopClosing.cc:773-826).
    run_global_ba: bool = True
    # Loop-edge weight in the essential graph. The reference weights all
    # essential-graph edges equally (unit information, Optimizer.cc:
    # 995-1100); an over-weighted loop edge forces any residual error of
    # the measured loop transform into an otherwise-good trajectory
    # (r4: a 3 cm T_ji error degraded a 4 cm-ATE run to 26 cm at weight
    # 500).
    loop_edge_weight: float = 100.0
    # Covisibility weight threshold for essential-graph edges
    # (Optimizer.cc:1100 uses 100; this engine's aggressive young-point
    # culling keeps per-KF observation counts leaner than the
    # reference's, so a lower threshold preserves graph connectivity).
    essential_graph_covis_threshold: int = 30
    # Minimum loop discrepancy worth correcting: if the measured loop
    # transform differs from the CURRENT relative pose by less than this
    # (translation, meters / rotation, degrees), the map already agrees
    # with the loop to within measurement noise — applying a
    # "correction" would only inject that noise into a consistent
    # trajectory. The reference has no such gate (its drifts are always
    # large); this engine's implicit revisit re-association keeps drift
    # at cm scale, where the gate matters. The floor must not sit below
    # the loop-transform MEASUREMENT floor: the fine 3D-3D inlier gate
    # is sim3_ransac_threshold_fine (0.05 m) and the guided wide-refit
    # Horn fit lands within ~5-9 cm of truth on rendered 640x480 RGB-D
    # (r5 measurements: applied corrections at 4-9 cm discrepancy
    # consistently DEGRADED 3-5 cm-ATE runs — the applied transform's
    # error exceeded the drift it "fixed", e.g. 0.053 -> 0.097 m). The
    # floor therefore sits above the transform measurement error:
    # correct only what you can measure. Real loop-closure regimes
    # (the reference's 0.4-0.7 m drifts; walker-corrupted runs here)
    # clear it by multiples.
    min_correction_translation: float = 0.12
    min_correction_rotation_deg: float = 0.5
    # Monotone acceptance: revert a loop correction whose post-GBA map
    # consistency (median reprojection error) is worse than before the
    # correction by more than this factor (+0.1 px absolute slack).
    correction_guard: bool = True
    correction_guard_slack: float = 1.3
    # DBoW2 vocabulary (.txt DBoW2 text format or .npz from
    # io/vocabulary.save_binary). Place recognition uses the hierarchical
    # vocabulary + L1 scoring (ORBVocabulary parity, System.cc:120-136
    # loads txt or bin by suffix). The default "auto" resolves the
    # TRAINED artifact checkpoints/orbvoc_synth.npz like the reference
    # always boots ORBvoc; if absent it falls back (with a warning) to
    # the flat random codebook (place_recognition.py). None forces the
    # codebook.
    vocabulary_path: str | None = "auto"
    # Absolute BoW-score floor for in-scan loop candidates
    # (scan_tracker._detect_loop): candidates must beat BOTH the
    # covis-min score (KeyFrameDatabase.cc:143-160 relative gate) and
    # this floor — the relative gate alone admits noise matches when
    # the covisible neighborhood happens to score near zero.
    min_abs_score: float = 0.015
    # Binary global descriptor dimensionality for place recognition
    # (TPU-native replacement of the 1M-node DBoW2 tree; SURVEY.md §7
    # hard part #6).
    global_desc_dim: int = 256


@dataclass(frozen=True)
class DynamicConfig:
    """Dynamic-environment filter (perfect/src/Flow.cc, Geometry.cc)."""

    enable_flow: bool = False
    enable_geometry: bool = False
    # Squared flow-magnitude threshold (Dynamic.flow yaml key; floor 40,
    # shipped 70 — Flow.cc:19,37, my_rgbd_ty_api_adj.yaml:88).
    flow_threshold: float = 70.0
    flow_threshold_floor: float = 40.0
    # Morphology kernel (Flow.cc:42-48): ellipse 21x21, erode x2 + dilate.
    flow_morph_kernel: int = 21
    # Flow runs at half resolution (Flow.cc:21 pyrDown).
    flow_downscale: int = 2
    # Pyramidal-LK schedule (ops/flow.py): coarse-to-fine levels, box
    # window, Gauss-Newton iterations per level. 3/9/5 is the operating
    # point the mask-quality gates demand (tests/test_dynamic.py,
    # test_accuracy_gates.py): r4 measured 3/9/3 and 3/7/2 — both fail
    # them (false-positive rate 0.12 > 0.08 gate; flow-masked ATE above
    # unmasked), so the remaining dynamic-config speed headroom is a
    # fused Pallas LK kernel, not a cheaper schedule. Each
    # LK iteration is a full-frame bilinear warp — the dominant flow
    # cost — so these are the knobs to trade mask fidelity for fps.
    flow_levels: int = 3
    flow_window: int = 9
    flow_iters: int = 5
    # Geometry DB of last 20 KFs, 5 reference frames chosen by
    # 0.7*dist+0.3*rot score (Geometry.h:19, Geometry.cc:83-127).
    geom_db_size: int = 20
    geom_ref_frames: int = 5
    # Back-projection depth gates (Geometry.cc:171,301).
    geom_max_ref_depth: float = 6.0
    geom_max_cur_depth: float = 7.0
    # Parallax gate in degrees (Geometry.cc:211-228).
    geom_max_parallax_deg: float = 30.0
    # Dynamic if |projected - measured depth| > 0.6 m with consistent
    # local depth (Geometry.cc:378-461). The variance gate is in SI
    # units (m^2): the box-filtered valid-pixel depth variance around the
    # reprojection must be below this. The reference thresholds raw
    # 41x41-patch variance (zeros included) at 1e-3 m^2 — a gate that
    # mostly rejects depth-edge/hole regions; our valid-only variance
    # admits those, so the tuned equivalent operating point is 0.1 m^2
    # (rejects straddling depth discontinuities > ~0.3 m spread).
    geom_depth_diff_th: float = 0.6
    geom_patch_var_th: float = 0.1
    geom_patch_size: int = 20
    # Region growing threshold 0.2 m, dilate 31x31 (Geometry.cc:475-518).
    geom_grow_threshold: float = 0.2
    geom_grow_iters: int = 16
    geom_dilate_kernel: int = 31
    # Border margin for reprojection (Geometry.cc:586-593).
    geom_border: int = 20
    # Frame is usable only if >= 65% of the image area is static
    # (Frame.cc:357-374 static-area check before keypoint masking).
    min_static_area: float = 0.65


@dataclass(frozen=True)
class SemanticConfig:
    """SSD detection + object database (perfect/src/Detector.cc,
    ObjectDatabase.cc, Merge2d3d.cc, MergeSG.cc)."""

    # Detector input resolution (Detector.cc:30).
    det_input_size: int = 300
    # SSD weights: "auto" resolves checkpoints/ssdlite_synthetic.npz (the
    # reference hardcodes and always loads its ncnn model,
    # Detector.cc:22-23); a path loads that file; None keeps random init.
    checkpoint_path: str | None = "auto"
    num_classes: int = 21  # VOC-20 + background (Detector.cc:52-57)
    # Detection probability gate for fusion (Merge2d3d.cc:48).
    fusion_prob_threshold: float = 0.54
    # Detection score threshold for keeping raw boxes.
    det_score_threshold: float = 0.5
    det_nms_iou: float = 0.45
    max_detections: int = 32
    # ObjectDatabase capacity + per-class merge radii
    # (ObjectDatabase.cc:22-43): bottle 0.06, chair 0.5, person 0.35,
    # tvmonitor 0.25, default 0.6 (meters).
    max_objects: int = 256
    default_merge_radius: float = 0.6
    # 2D->3D fusion scheme the engine runs on each keyframe's
    # detections: "depth_window" (Merge2d3d.cc — fast, the measured
    # default here) or "merge_sg" (plane-removal + clustering + IoU
    # matching, MergeSG.cc — the implementation the reference compiles
    # in, MapDrawer.cc:79; ~3x the fusion cost for cluster-tight
    # extents).
    fusion_scheme: str = "depth_window"
    # Depth-window fusion (Merge2d3d.cc:55-97): central 30-70% box for
    # mean depth, +-0.2 m window over central 20-80%.
    fusion_depth_window: float = 0.2
    # Segmentation fusion (MergeSG.cc:29-31,367-408): plane >= 10000
    # inliers, cluster >= 1000 points, 0.01 m cluster tolerance.
    seg_min_plane_inliers: int = 10000
    seg_min_cluster_size: int = 1000
    seg_cluster_tolerance: float = 0.01
    max_clusters: int = 64


@dataclass(frozen=True)
class DenseMapConfig:
    """Occupancy (octomap-equivalent) mapping (perfect/src/MapDrawer.cc)."""

    # Voxel resolution (octoMap.res; my_rgbd_ty_api_adj.yaml:82).
    resolution: float = 0.05
    # Log-odds model (MapDrawer.cc:51-56): hit 0.7, miss 0.4, clamp
    # 0.12 / 0.97 (probabilities).
    prob_hit: float = 0.7
    prob_miss: float = 0.4
    clamp_min: float = 0.12
    clamp_max: float = 0.97
    occupancy_threshold: float = 0.8  # render gate (MapDrawer.cc:394-412)
    # Point cloud depth gates (MapDrawer.cc:780-810): 0.5-4 m, |y|<3 m.
    cloud_min_depth: float = 0.5
    cloud_max_depth: float = 4.0
    cloud_max_y: float = 3.0
    # Cloud decimation stride (legacy pointcloudmapping.cc used 3).
    cloud_stride: int = 2
    # Ground RANSAC (MapDrawer.cc:849-939): 200 iters, 0.04 m inlier,
    # plane offset |d|>0.07 => ground.
    ground_ransac_iters: int = 200
    ground_inlier_threshold: float = 0.04
    ground_min_offset: float = 0.07
    # Dense block map: world is tiled into blocks of block_size^3 voxels.
    block_size: int = 16
    max_blocks: int = 8192
    # Unbounded mapping: tile the world into on-demand 64^3-voxel blocks
    # (BlockGridMap) instead of one fixed working volume — the octree's
    # grow-anywhere capability. False keeps the single dense grid.
    unbounded: bool = True
    block_voxels: int = 64
    # Raycast step cap (DDA) in voxels.
    max_ray_steps: int = 128
    voxel_leaf_size: float = 0.01  # voxel filter before insertion


@dataclass(frozen=True)
class ParallelConfig:
    """Multi-chip sharding (no reference analogue; SURVEY.md §2.6 P12)."""

    # Mesh axis names: keyframe-parallel and point-parallel.
    kf_axis: str = "kf"
    pt_axis: str = "pt"
    # Default mesh shape (total devices = product).
    mesh_shape: tuple = (1, 1)


@dataclass(frozen=True)
class SlamConfig:
    """Top-level engine configuration."""

    camera: CameraConfig = field(default_factory=CameraConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    map: MapConfig = field(default_factory=MapConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    dynamic: DynamicConfig = field(default_factory=DynamicConfig)
    semantic: SemanticConfig = field(default_factory=SemanticConfig)
    dense: DenseMapConfig = field(default_factory=DenseMapConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    def replace(self, **kwargs: Any) -> "SlamConfig":
        return dataclasses.replace(self, **kwargs)

    # ---- serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "SlamConfig":
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in d:
                sub = d[f.name]
                sub_cls = f.default_factory  # type: ignore[misc]
                if dataclasses.is_dataclass(sub_cls()):
                    known = {x.name for x in dataclasses.fields(sub_cls())}
                    filtered = {k: v for k, v in sub.items() if k in known}
                    if "mesh_shape" in filtered:
                        filtered["mesh_shape"] = tuple(filtered["mesh_shape"])
                    kwargs[f.name] = sub_cls(**filtered)
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "SlamConfig":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_opencv_yaml(cls, path: str) -> "SlamConfig":
        """Load a reference-format settings file (OpenCV FileStorage YAML
        with keys like ``Camera.fx``; perfect/Examples/RGB-D/TUM3.yaml).
        Provides drop-in compatibility for users of the reference."""
        flat = _parse_opencv_yaml(path)

        def get(key: str, default: Any) -> Any:
            return flat.get(key, default)

        cam = CameraConfig(
            fx=float(get("Camera.fx", 535.4)),
            fy=float(get("Camera.fy", 539.2)),
            cx=float(get("Camera.cx", 320.1)),
            cy=float(get("Camera.cy", 247.6)),
            k1=float(get("Camera.k1", 0.0)),
            k2=float(get("Camera.k2", 0.0)),
            p1=float(get("Camera.p1", 0.0)),
            p2=float(get("Camera.p2", 0.0)),
            k3=float(get("Camera.k3", 0.0)),
            width=int(get("Camera.width", 640)),
            height=int(get("Camera.height", 480)),
            fps=float(get("Camera.fps", 30.0)),
            bf=float(get("Camera.bf", 40.0)),
            rgb=int(get("Camera.RGB", 1)),
            th_depth=float(get("ThDepth", 40.0)),
            depth_map_factor=float(get("DepthMapFactor", 5000.0)),
        )
        orb = OrbConfig(
            n_features=int(get("ORBextractor.nFeatures", 1000)),
            scale_factor=float(get("ORBextractor.scaleFactor", 1.2)),
            n_levels=int(get("ORBextractor.nLevels", 8)),
            ini_th_fast=int(get("ORBextractor.iniThFAST", 20)),
            min_th_fast=int(get("ORBextractor.minThFAST", 7)),
        )
        dyn = DynamicConfig(
            flow_threshold=float(get("Dynamic.flow", 70.0)),
        )
        dense = DenseMapConfig(
            resolution=float(get("octoMap.res", 0.05)),
            voxel_leaf_size=float(get("PointCloudMapping.Resolution", 0.01)),
        )
        return cls(camera=cam, orb=orb, dynamic=dyn, dense=dense)


def _parse_opencv_yaml(path: str) -> dict:
    """Parse the `key: value` subset of OpenCV FileStorage YAML used by
    the reference settings files (skips the %YAML directive and any
    nested structures)."""
    flat: dict = {}
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.split("#", 1)[0].rstrip()
            if not line or line.startswith("%") or ":" not in line:
                continue
            if line.startswith((" ", "\t", "-")):
                continue
            key, _, val = line.partition(":")
            val = val.strip()
            if not val or val.startswith(("[", "{", "!!")):
                continue
            try:
                flat[key.strip()] = float(val) if "." in val or "e" in val.lower() else int(val)
            except ValueError:
                flat[key.strip()] = val.strip('"')
    return flat


# Preset matching the reference's TUM fr3 operating point
# (perfect/Examples/RGB-D/TUM3.yaml).
TUM3 = SlamConfig()

# TUM fr1 intrinsics (perfect/Examples/RGB-D/TUM1.yaml).
TUM1 = SlamConfig(
    camera=CameraConfig(
        fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
        k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
    )
)

# TUM fr2 intrinsics (perfect/Examples/RGB-D/TUM2.yaml).
TUM2 = SlamConfig(
    camera=CameraConfig(
        fx=520.908620, fy=521.007327, cx=325.141442, cy=249.701764,
        k1=0.231222, k2=-0.784899, p1=-0.003257, p2=-0.000105, k3=0.917205,
    )
)
