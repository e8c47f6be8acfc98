"""Port parity for the slice as a whole: the JAX Tracker and the port's
Tracker on the same rendered RGB-D sequence, at a small config (QVGA
camera and 512 keypoints, as in the mapping parity test; the
loop-closure test's map settings with fewer map points; loop closing and
relocalization off; a keyframe every third frame so that local mapping
runs twice in ten frames).

Gates, and why: keyframe frames and per-frame statuses are discrete
decisions and must agree exactly; camera positions must agree within
5 mm per frame (the two implementations sum the same f32 quantities in
different orders, and local BA amplifies ulp-level differences over its
Gauss-Newton iterations, but both must land on the same trajectory);
the port's ATE against ground truth must stay under 1 cm, the tracker
test's gate.

The per-frame step (`fused_track_step`) and its CUDA-graph runner
(`tracking/graphed_track.py::TrackStepRunner`): the port's step runs
with every host read trapped but its two `device_cond` predicates (the
doubled-window retry's and the reference-keyframe fallback's, JAX's
`lax.cond`s) and equals JAX's on the same numpy inputs (the JAX
tracker's state before the last frame, and that frame) on three frames:
as tracked (the motion model decides), with the predicted pose pushed
0.6 m sideways (the motion model finds nothing and the reference-keyframe
fallback decides) and with the motion model's window cut to 0.08 px (the
first window keeps under `min_matches_track` matches and the
doubled-window retry decides): statuses and keyframe decisions equal,
inlier and match counts within 1, poses within 1e-4 (extraction rounds
a few pyramid pixels the other way, `tests/test_torch_divergence_7c.py`);
and only the branches taken run: 2 window matches as tracked, 3 with the
retry, 2 and one fallback call with the fallback.
`Tracker.process` runs the runner's CPU path, which must equal the
eager step bit for bit on every frame of the port's run, leave what it
returned alone at the next step, refuse arguments of other shapes
or dtypes, and raise, naming the tensor, where the step reads a map
tensor left out of its declared reads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.io.synthetic import SyntheticSequence
from orb_slam2_ssd_semantic_tpu.tracking import tracker as jtk
from orb_slam2_ssd_semantic_tpu.tracking.tracker import Tracker as JTracker
from orb_slam2_ssd_semantic_tpu_torch.eval.ate import evaluate_ate_xyz
from orb_slam2_ssd_semantic_tpu_torch.frontend.extractor import Features as TFeatures
from orb_slam2_ssd_semantic_tpu_torch.mapping import graph_cond
from orb_slam2_ssd_semantic_tpu_torch.mapping.graphed_step import state_leaves
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import state_from_numpy
from orb_slam2_ssd_semantic_tpu_torch.tracking import tracker as ttk
from orb_slam2_ssd_semantic_tpu_torch.tracking import graphed_track
from orb_slam2_ssd_semantic_tpu_torch.tracking.graphed_track import TrackStepRunner
from orb_slam2_ssd_semantic_tpu_torch.tracking.tracker import Tracker as TTracker
from orb_slam2_ssd_semantic_tpu_torch.utils.precision import highest_precision
from _torch_host_reads import host_reads_trapped
from _torch_threads import _few_threads  # noqa: F401 (autouse)

N_FRAMES = 10


def small_config(mod):
    base = mod.SlamConfig()
    return mod.SlamConfig(
        camera=mod.CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=123.8, width=320,
                                height=240, th_depth=80.0),
        orb=mod.OrbConfig(n_features=500, max_keypoints=512),
        tracking=dataclasses.replace(base.tracking, max_frames_between_kfs=2,
                                     local_map_candidates=1024),
        map=dataclasses.replace(base.map, max_keyframes=32, max_map_points=4096,
                                local_ba_window=4, local_ba_fixed_anchors=2,
                                triangulation_neighbors=2, fuse_neighbors=2),
        loop=dataclasses.replace(base.loop, enabled=False, enable_relocalization=False),
    )


@pytest.fixture(scope="module")
def recorded():
    """What `runs` records beside the runs: the JAX tracker's step inputs
    before the last frame, and each step of the port's tracker through
    its runner with the eager step on the same arguments."""
    return {"steps": []}


def _spy_on_runner(tracker, rec):
    """Record every step the tracker's runner takes: its result, the eager
    step's on the same arguments, and whether the frame and kp_point the
    runner returned the step before are unchanged."""
    runner = tracker.track_runner()
    step = runner.step

    def spy(*args, **kwargs):
        out = step(*args, **kwargs)
        with highest_precision():
            eager = ttk.fused_track_step(*args, **kwargs)
        kept = rec.get("kept")
        if kept is not None:
            rec["steps"][-1]["kept_unchanged"] = all(torch.equal(t, c) for t, c in kept)
        rec["kept"] = [(t, t.clone()) for _, t in state_leaves((out[1], out[4]), "out")]
        rec["steps"].append(dict(runner=out, eager=eager))
        return out

    runner.step = spy


@pytest.fixture(scope="module")
def runs(recorded):
    seq = SyntheticSequence(n_frames=N_FRAMES, cam=small_config(jconfig).camera)
    frames = [seq.gray_depth(i) for i in range(N_FRAMES)]
    recorded["last_frame"] = frames[-1]
    out = {}
    for name, tracker in (("jax", JTracker(small_config(jconfig))),
                          ("torch", TTracker(small_config(tconfig), device="cpu"))):
        if name == "torch":
            _spy_on_runner(tracker, recorded)
        for i, (gray, depth) in enumerate(frames):
            if name == "jax" and i == N_FRAMES - 1:
                recorded["jax_inputs"] = jax.tree_util.tree_map(
                    lambda x: np.array(x), (tracker.state, tracker.last_frame, tracker.last_T_cw,
                                            tracker.last_kp_point, tracker.velocity)) + (
                    tracker.frames_since_kf, tracker.ref_kf_inliers)
            tracker.process(gray, depth, float(seq.stamps[i]))
        out[name] = tracker
    return seq, out["jax"], out["torch"]


def _kf_frames(tracker):
    return [i for i in range(1, len(tracker.stats))
            if tracker.stats[i]["kfs"] != tracker.stats[i - 1]["kfs"]]


def test_same_keyframes_and_statuses(runs):
    _, tj, tt = runs
    assert len(_kf_frames(tj)) >= 3, "local mapping never ran: vacuous"
    assert tt.metrics.stages["local_mapping"].count >= 2
    assert _kf_frames(tt) == _kf_frames(tj)
    assert [s["status"] for s in tt.stats] == [s["status"] for s in tj.stats]
    assert [s["kfs"] for s in tt.stats] == [s["kfs"] for s in tj.stats]


def test_camera_positions_agree(runs):
    _, tj, tt = runs
    d = np.linalg.norm(tj.camera_positions() - tt.camera_positions(), axis=1)
    assert d.max() < 5e-3, d


def test_port_ate(runs):
    seq, _, tt = runs
    assert evaluate_ate_xyz(tt.camera_positions(), seq.gt_positions()).rmse < 0.01


def test_port_trajectory_file(tmp_path, runs):
    from orb_slam2_ssd_semantic_tpu_torch.io.tum import read_trajectory

    _, tj, tt = runs
    path = str(tmp_path / "traj.txt")
    tt.save_trajectory_tum(path)
    stamps, t, q = read_trajectory(path)
    assert len(stamps) == N_FRAMES
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(t, tt.camera_positions(), atol=1e-5)


def _port_frame(f) -> ttk.Frame:
    """A JAX `Frame` of numpy arrays as the port's."""
    fe = f.feats
    feats = TFeatures(uv=torch.from_numpy(fe.uv), level=torch.from_numpy(fe.level.astype(np.int64)),
                      angle=torch.from_numpy(fe.angle), score=torch.from_numpy(fe.score),
                      desc=torch.from_numpy(fe.desc.view(np.int32)),
                      valid=torch.from_numpy(fe.valid))
    return ttk.Frame(feats, torch.from_numpy(f.kp_depth), torch.from_numpy(f.obs_uvr),
                     torch.from_numpy(f.is_stereo))


RETRY_RADIUS = 0.08  # px: 16 matches in the first window at this frame, 50 in the doubled one


def _cut_radius(cfg):
    return cfg.replace(matcher=dataclasses.replace(cfg.matcher, mm_search_radius=RETRY_RADIUS))


def _pushed(velocity: np.ndarray, metres: float) -> np.ndarray:
    out = velocity.copy()
    out[0, 3] += metres
    return out


@pytest.fixture(scope="module")
def step_cases(runs, recorded):
    """{case: (JAX's packed stats, the port's, the valid matches of each of
    the port's window matches, its reference-keyframe fallback calls, its
    host reads)} for the last frame from the JAX tracker's inputs before
    it, as tracked ("ok"), with the velocity pushed 0.6 m ("fallback") and
    with the motion model's window cut ("retry"). The port's step runs
    with every host read trapped but `device_cond`'s predicates; the
    match counts are read after it."""
    jstate, jframe, last_T_cw, last_kp_point, velocity, since_kf, ref_inl = recorded["jax_inputs"]
    gray, depth = recorded["last_frame"]
    counts, fallbacks = [], []
    match, reference_kf = ttk.match_ops.match_by_window, ttk.track_reference_kf

    def counted(*args, **kwargs):
        m = match(*args, **kwargs)
        counts.append(m.valid.sum())
        return m

    def fallback(*args, **kwargs):
        fallbacks.append(1)
        return reference_kf(*args, **kwargs)

    out = {}
    for case, vel, cut in (("ok", velocity, False), ("fallback", _pushed(velocity, 0.6), False),
                           ("retry", velocity, True)):
        jcfg, tcfg = small_config(jconfig), small_config(tconfig)
        if cut:
            jcfg, tcfg = _cut_radius(jcfg), _cut_radius(tcfg)
        j = jax.tree_util.tree_map(jnp.asarray, (jstate, jframe, last_T_cw, last_kp_point))
        packed_j = jtk.fused_track_step(
            j[0], jnp.asarray(gray), jnp.asarray(depth), j[1], j[2], j[3], jnp.asarray(vel),
            jnp.int32(since_kf), jnp.int32(ref_inl), jcfg, static_mask=None, use_mask=False,
            feats=None, use_feats=False)[-1]
        t_args = (state_from_numpy(_tree_of(jstate), "cpu"), torch.from_numpy(gray),
                  torch.from_numpy(depth), _port_frame(jframe), torch.from_numpy(last_T_cw),
                  torch.from_numpy(last_kp_point.astype(np.int64)), torch.from_numpy(vel),
                  torch.tensor(since_kf), torch.tensor(ref_inl), tcfg)
        counts.clear()
        fallbacks.clear()
        ttk.match_ops.match_by_window, ttk.track_reference_kf = counted, fallback
        try:
            with highest_precision(), host_reads_trapped(
                    allowed=[(graph_cond, "predicate_on_host")]) as reads:
                packed_t = ttk.fused_track_step(*t_args)[-1]
        finally:
            ttk.match_ops.match_by_window, ttk.track_reference_kf = match, reference_kf
        out[case] = (np.asarray(packed_j), packed_t.numpy(), [int(c) for c in counts],
                     len(fallbacks), dict(reads))
    return out


def _tree_of(state):
    if hasattr(state, "_asdict"):
        return {k: _tree_of(v) for k, v in state._asdict().items()}
    return np.asarray(state)


# What runs in each case: the window matches (the motion model's first
# window, the doubled-window retry where the first was thin, local-map
# tracking) and the reference-keyframe fallback's calls.
RUNS = {"ok": (2, 0), "fallback": (2, 1), "retry": (3, 0)}


@pytest.mark.parametrize("case", ["ok", "fallback", "retry"])
def test_track_step_matches_jax_with_host_reads_trapped(step_cases, case):
    pj, pt, counts, fallbacks, reads = step_cases[case]
    tcfg = small_config(tconfig)
    np.testing.assert_array_equal(pt[16:18], pj[16:18])  # status, need_kf
    np.testing.assert_allclose(pt[18:], pj[18:], atol=1, rtol=0)  # inliers, matches, mm inliers
    np.testing.assert_allclose(pt[:16], pj[:16], atol=1e-4, rtol=0)
    assert pj[16] == 0, "the frame did not track: vacuous"
    first = counts[0]
    ok_mm_inliers = pj[20] >= tcfg.tracking.min_inliers_track
    if case == "ok":
        assert ok_mm_inliers and first >= tcfg.tracking.min_matches_track
    elif case == "fallback":
        assert not ok_mm_inliers, "the motion model held: the fallback did not decide"
    else:
        assert first < tcfg.tracking.min_matches_track <= counts[1], counts


@pytest.mark.parametrize("case", ["ok", "fallback", "retry"])
def test_track_step_runs_only_the_branches_taken(step_cases, case):
    """The doubled-window retry and the reference-keyframe fallback are
    `device_cond`s: on the CPU each reads its predicate on the host (the
    step's only two host reads) and runs the branch it names alone, as
    JAX's `lax.cond` does."""
    _, _, counts, fallbacks, reads = step_cases[case]
    assert (len(counts), fallbacks) == RUNS[case], (counts, fallbacks)
    assert reads == {"predicate_on_host": 2}


def test_track_runner_equals_the_eager_step(runs, recorded):
    """Every step of the port's run through the runner's CPU path equals
    the eager step on the same arguments, bit for bit on every tensor."""
    steps = recorded["steps"]
    assert len(steps) == N_FRAMES - 1
    for i, s in enumerate(steps):
        got, want = state_leaves(s["runner"], "out"), state_leaves(s["eager"], "out")
        for (path, x), (_, y) in zip(got, want, strict=True):
            assert x.dtype == y.dtype and torch.equal(x, y), (i, path)


def test_track_runner_leaves_returned_frames_alone(runs, recorded):
    """The frame and kp_point a step returned are unchanged after the next
    step, which overwrote the runner's output buffers."""
    flags = [s["kept_unchanged"] for s in recorded["steps"][:-1]]
    assert len(flags) == N_FRAMES - 2 and all(flags), flags


def test_track_runner_refuses_another_shape_or_dtype(runs):
    _, _, tt = runs
    cfg = tt.cfg
    runner = TrackStepRunner("cpu")
    gray = torch.zeros((cfg.camera.height, cfg.camera.width), dtype=torch.uint8)
    depth = torch.zeros((cfg.camera.height, cfg.camera.width), dtype=torch.uint16)
    args = [tt.state, gray, depth, tt.last_frame, tt.last_T_cw, tt.last_kp_point, tt.velocity,
            0, 1, cfg]
    runner.capture(*args)
    assert runner.ready(cfg) and not runner.ready(cfg, static_mask=gray > 0)
    for i, bad, path in ((1, gray[:-1], "step.gray"), (6, tt.velocity.double(), "step.velocity"),
                         (7, torch.zeros((), dtype=torch.int32), "step.frames_since_kf")):
        with pytest.raises(ValueError, match=path.replace(".", r"\.")):
            runner.step(*args[:i], bad, *args[i + 1:])


def test_track_runner_raises_where_the_step_reads_an_undeclared_leaf(runs, monkeypatch):
    """A map tensor left out of `STATE_READS` stands in as `Unread`: the
    step raises at its first read of it, naming it, at the capture."""
    _, _, tt = runs
    monkeypatch.setattr(graphed_track, "STATE_READS", graphed_track.STATE_READS - {"points.pos"})
    cfg = tt.cfg
    gray = torch.zeros((cfg.camera.height, cfg.camera.width), dtype=torch.uint8)
    depth = torch.zeros((cfg.camera.height, cfg.camera.width), dtype=torch.uint16)
    with pytest.raises(RuntimeError, match=r"state\.points\.pos"):
        TrackStepRunner("cpu").step(tt.state, gray, depth, tt.last_frame, tt.last_T_cw,
                                    tt.last_kp_point, tt.velocity, 0, 1, cfg)


@pytest.mark.parametrize("spawn_all", [False, True], ids=["keyframe", "spawn_all"])
def test_insert_runner_equals_eager_insert_keyframe(runs, spawn_all):
    """`InsertKeyframeRunner` (`Tracker.process` and `init_scan` insert
    through it) on the port's state after the run and its last frame:
    every leaf equal to the eager `insert_keyframe`'s, its inputs left
    as they were, and nothing returned shared with the runner's buffers."""
    tracker = runs[2]
    cfg = small_config(tconfig)
    args = (tracker.state, tracker.last_frame, tracker.last_T_cw, tracker.last_kp_point)
    before = [(t, t.clone()) for _, t in state_leaves(args, "in")]
    runner = graphed_track.InsertKeyframeRunner("cpu")
    out = runner.step(*args, N_FRAMES, float(N_FRAMES), cfg, spawn_all=spawn_all)
    with highest_precision():
        eager = ttk.insert_keyframe(*args, N_FRAMES, float(N_FRAMES), cfg, spawn_all=spawn_all)
    got, want = state_leaves(out, "out"), state_leaves(eager, "out")
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [p for (p, a), (_, b) in zip(got, want) if not torch.equal(a, b)] == []
    assert all(torch.equal(t, c) for t, c in before)
    buffers = {t.data_ptr() for _, t in state_leaves(runner.graphs()[0].out, "buf")}
    assert not buffers & {t.data_ptr() for _, t in got}
    assert int(out[0].n_kfs) == int(tracker.state.n_kfs) + 1
