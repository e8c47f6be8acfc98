"""Port parity: triangulation, local BA and the whole local-mapping step
against the JAX package, on the same map.

The map comes from a short JAX tracker run (small camera, keyframe every
third frame, so local mapping has run); `state_from_numpy` hands the
same map to the port. Tolerances, and why:
- discrete outcomes (which matches, which points and keyframes survive,
  which observations are pruned): exact, or >= 99% of entries where a
  float threshold decides them (chi2 gates, ratio tests on f32 sums);
- triangulated points: 1e-3 m absolute + 1e-3 relative: the 3x3
  normal equations of the two-view DLT square its condition number,
  and at short baselines f32 sums taken in another order move a point
  at 2 m by about a millimetre along the ray;
- BA poses: 1e-4 (m / rotation-matrix entries) and points 1e-3 m: up to
  15 Gauss-Newton iterations of f32 Schur-complement sums in another
  order (segment sums on one side, index_add on the other) and an LU
  solve on one side against Gauss-Jordan on the other.

The port's local-mapping step never waits on the card (the tracker
dispatches it and tracks on). On the CPU that is held by running it with
every host read trapped (`tests/_torch_host_reads.py`, which the tracking
step's tests share): a tensor's truth value, `item`, `int`, `float`,
`tolist`, `cpu`, `numpy`, `nonzero`, indexing by a boolean mask or by a
0-d tensor (both read on the host), and `torch.tensor`/`as_tensor` of
host data or a host number assigned to one element (on the card, a
pageable copy the host waits for) all raise.

The tracker, the scan and the segmented runner map keyframes through
`mapping/graphed_step.py::LocalMappingRunner`: on the card one CUDA
graph of the step, replayed; on the CPU the same copies into its static
buffers and the step run eagerly on them. Its CPU path must equal the eager step bit for
bit over two steps, leave every state it returned alone, refuse a state
of other shapes or dtypes and read nothing on the host. Its card path
is held to the eager step by `chip_smoke.py` phase 5b.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu.config as jconfig
import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.io.synthetic import SyntheticSequence
from orb_slam2_ssd_semantic_tpu.mapping import ba as jba
from orb_slam2_ssd_semantic_tpu.mapping import local_mapping as jlm
from orb_slam2_ssd_semantic_tpu.mapping import triangulation as jtri
from orb_slam2_ssd_semantic_tpu.tracking.tracker import Tracker as JTracker
from orb_slam2_ssd_semantic_tpu_torch.mapping import ba as tba
from orb_slam2_ssd_semantic_tpu_torch.mapping import local_mapping as tlm
from orb_slam2_ssd_semantic_tpu_torch.mapping.graphed_step import (
    GraphedStep,
    LocalMappingRunner,
    state_leaves,
)
from orb_slam2_ssd_semantic_tpu_torch.mapping import triangulation as ttri
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import state_from_numpy, state_to_numpy
from orb_slam2_ssd_semantic_tpu_torch.utils.precision import highest_precision
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import scatter
from _torch_host_reads import HostRead, host_reads_trapped
from _torch_threads import _few_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")


def small_config(mod):
    """A small deployment of either package's config module: QVGA camera,
    512 keypoints, a keyframe every third frame, a 4 + 2 BA window."""
    base = mod.SlamConfig()
    return mod.SlamConfig(
        camera=mod.CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=123.8, width=320,
                                height=240, th_depth=80.0),
        orb=mod.OrbConfig(n_features=500, max_keypoints=512),
        tracking=dataclasses.replace(base.tracking, max_frames_between_kfs=2,
                                     local_map_candidates=1024),
        map=dataclasses.replace(base.map, max_keyframes=16, max_map_points=4096,
                                local_ba_window=4, local_ba_fixed_anchors=2,
                                triangulation_neighbors=2, fuse_neighbors=2),
        loop=dataclasses.replace(base.loop, enabled=False, enable_relocalization=False),
    )


def tree_of(state):
    """A JAX SlamState (nested NamedTuples) as nested dicts of numpy."""
    if hasattr(state, "_asdict"):
        return {k: tree_of(v) for k, v in state._asdict().items()}
    return np.asarray(state)


@pytest.fixture(scope="module")
def jax_map():
    cfg = small_config(jconfig)
    seq = SyntheticSequence(n_frames=10, cam=cfg.camera)
    tr = JTracker(cfg)
    for i in range(len(seq)):
        g, d = seq.gray_depth(i)
        tr.process(g, d, float(seq.stamps[i]))
    assert int(tr.state.n_kfs) >= 3, "local mapping never ran"
    return cfg, tr.state, tree_of(tr.state)


def test_state_numpy_roundtrip(jax_map):
    _, _, tree = jax_map
    back = state_to_numpy(state_from_numpy(tree, CPU))

    def check(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                check(a[k], b[k], f"{path}.{k}")
        else:
            assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=path)

    check(tree, back, "state")


def test_triangulate_pair_matches_jax(jax_map):
    cfg, jstate, tree = jax_map
    kfs = tree["kfs"]
    live = np.nonzero(kfs["valid"])[0]
    a, b = int(tree["last_kf"]), int(live[live != int(tree["last_kf"])][-1])
    args = [kfs["uv"][a], kfs["desc"][a], kfs["level"][a], kfs["kp_valid"][a],
            kfs["uv"][b], kfs["desc"][b], kfs["level"][b], kfs["kp_valid"][b],
            kfs["T_cw"][a], kfs["T_cw"][b]]
    rj = jtri.triangulate_pair(*map(jnp.asarray, args), cfg.camera, cfg.orb)
    targs = [torch.from_numpy(np.array(x.view(np.int32) if x.dtype == np.uint32 else x))[None]
             for x in args]
    targs[2], targs[6] = targs[2].long(), targs[6].long()
    tcfg = small_config(tconfig)
    with highest_precision():
        rt = ttri.triangulate_pair(*targs, tcfg.camera, tcfg.orb)
    vj = np.asarray(rj.valid)
    assert vj.sum() > 20, "vacuous pair"
    np.testing.assert_array_equal(vj, rt.valid[0].numpy())
    np.testing.assert_array_equal(np.asarray(rj.idx2), rt.idx2[0].numpy())
    np.testing.assert_allclose(np.asarray(rj.pts_w), rt.pts_w[0].numpy(), atol=1e-3, rtol=1e-3)


def test_local_bundle_adjust_matches_jax(jax_map):
    cfg, jstate, _ = jax_map
    prob_j = jlm.assemble_local_ba(jstate, cfg)[0]
    res_j = jba.local_bundle_adjust(prob_j, cfg.camera, cfg.optimizer)
    fields = {k: np.asarray(v) for k, v in prob_j._asdict().items()}
    fields["point_slot"] = fields["point_slot"].astype(np.int64)
    prob_t = tba.BAProblem(**{k: torch.from_numpy(v) for k, v in fields.items()})
    tcfg = small_config(tconfig)
    with highest_precision():
        res_t = tba.local_bundle_adjust(prob_t, tcfg.camera, tcfg.optimizer)
    moved = np.abs(np.asarray(res_j.T_cw) - fields["T_cw"]).max()
    assert moved > 1e-6, "BA left every pose where it was: vacuous"
    np.testing.assert_allclose(np.asarray(res_j.T_cw), res_t.T_cw.numpy(), atol=1e-4, rtol=0)
    pv = fields["point_valid"]
    np.testing.assert_allclose(np.asarray(res_j.points)[pv], res_t.points.numpy()[pv],
                               atol=1e-3, rtol=0)
    has_obs = fields["point_slot"] >= 0
    agree = (np.asarray(res_j.inlier) == res_t.inlier.numpy())[has_obs]
    assert agree.mean() >= 0.99, agree.mean()


@pytest.fixture(scope="module")
def jax_step(jax_map):
    """JAX's local-mapping step on the fixture's map, as numpy."""
    cfg, jstate, _ = jax_map
    return tree_of(jlm.local_mapping_step(jstate, cfg))


def _check_step(out_j, out_t, tree):
    kj, kt = out_j["kfs"], out_t["kfs"]
    np.testing.assert_array_equal(kj["valid"], kt["valid"])
    live = kj["valid"]
    np.testing.assert_allclose(kj["T_cw"][live], kt["T_cw"][live], atol=1e-4, rtol=0)
    pj, pt = out_j["points"], out_t["points"]
    assert (pj["valid"] == pt["valid"]).mean() >= 0.99
    assert abs(int(out_j["n_points"]) - int(out_t["n_points"])) <= 0.01 * int(out_j["n_points"])
    assert int(out_j["n_points"]) > int(tree["n_points"]) - 200, "step dropped the map"
    both = pj["valid"] & pt["valid"]
    np.testing.assert_allclose(pj["pos"][both], pt["pos"][both], atol=1e-3, rtol=0)
    bound = kj["kp_point"][live] >= 0
    assert bound.sum() > 100
    assert (kj["kp_point"][live] == kt["kp_point"][live]).mean() >= 0.99


def test_local_mapping_step_matches_jax(jax_map, jax_step):
    cfg, jstate, tree = jax_map
    tcfg = small_config(tconfig)
    with highest_precision():
        out_t = state_to_numpy(tlm.local_mapping_step(state_from_numpy(tree, CPU), tcfg))
    _check_step(jax_step, out_t, tree)


def test_host_read_trap_fires():
    x = torch.arange(4)
    for read in (lambda: bool(x[0] > 1), lambda: x.sum().item(), lambda: int(x[1]),
                 lambda: x.cpu(), lambda: x[x > 1], lambda: x[torch.tensor(1)],
                 lambda: torch.tensor([1.0]), lambda: torch.as_tensor(2.0), lambda: x.tolist(),
                 lambda: x.__setitem__(0, 5)):
        with host_reads_trapped(), pytest.raises(HostRead):
            read()
    with host_reads_trapped():
        y = torch.as_tensor(x)[x[:2]]
    assert y.tolist() == [0, 1]


def test_local_mapping_step_waits_on_nothing(jax_map, jax_step):
    """The whole step, with every host read trapped, still matches JAX at
    `test_local_mapping_step_matches_jax`'s tolerances."""
    cfg, jstate, tree = jax_map
    tcfg = small_config(tconfig)
    state = state_from_numpy(tree, CPU)
    with highest_precision(), host_reads_trapped():
        out = tlm.local_mapping_step(state, tcfg)
    _check_step(jax_step, state_to_numpy(out), tree)


def assert_states_equal(a, b):
    for (path, x), (_, y) in zip(state_leaves(a), state_leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y), path


@pytest.fixture(scope="module")
def runner_steps(jax_map):
    """Two successive steps through the runner's CPU path and through the
    eager step, from the fixture's map; with copies of the runner's first
    output and of its input, taken before the second step."""
    _, _, tree = jax_map
    tcfg = small_config(tconfig)
    state = state_from_numpy(tree, CPU)
    runner = LocalMappingRunner("cpu")
    with highest_precision():
        first = runner.step(state, tcfg)
        kept = {"input": [t.clone() for _, t in state_leaves(state)],
                "first": [t.clone() for _, t in state_leaves(first)]}
        second = runner.step(first, tcfg)
        eager1 = tlm.local_mapping_step(state, tcfg)
        eager2 = tlm.local_mapping_step(eager1, tcfg)
    return dict(state=state, runner=runner, first=first, second=second, eager=(eager1, eager2),
                kept=kept)


def test_runner_matches_eager_step_and_jax(jax_map, jax_step, runner_steps):
    """Two steps through the runner equal two eager steps bit for bit; the
    first equals JAX's step at `test_local_mapping_step_matches_jax`'s
    tolerances."""
    _, _, tree = jax_map
    eager1, eager2 = runner_steps["eager"]
    assert_states_equal(runner_steps["first"], eager1)
    assert_states_equal(runner_steps["second"], eager2)
    _check_step(jax_step, state_to_numpy(runner_steps["first"]), tree)
    moved = (runner_steps["second"].kfs.T_cw != runner_steps["first"].kfs.T_cw).any()
    assert bool(moved) or not torch.equal(runner_steps["second"].points.pos,
                                          runner_steps["first"].points.pos), \
        "the second step changed nothing: vacuous"


def test_runner_leaves_returned_states_alone(runner_steps):
    """The state returned for step 1 and the state given to it are
    unchanged on every leaf after step 2, which wrote the runner's output
    buffers again; an unchanged leaf is the caller's own tensor, a changed
    one no tensor the runner keeps and no memory of its outputs."""
    for name, state in (("input", runner_steps["state"]), ("first", runner_steps["first"])):
        for (path, t), kept in zip(state_leaves(state), runner_steps["kept"][name], strict=True):
            assert torch.equal(t, kept), (name, path)
    captured = runner_steps["runner"]._captured
    assert len(captured) == 1
    static = {id(t) for c in captured.values() for t in c.static_in}
    inputs = {id(t) for _, t in state_leaves(runner_steps["state"])}
    out = state_leaves(runner_steps["first"])
    assert not any(id(t) in static for _, t in out)
    graph_out = {t.untyped_storage().data_ptr() for c in captured.values()
                 for _, t in state_leaves(c.out, "out")}
    assert not any(t.untyped_storage().data_ptr() in graph_out for _, t in out)
    assert 0 < sum(id(t) in inputs for _, t in out) < len(out)


def test_runner_refuses_another_shape_or_dtype(jax_map):
    _, _, tree = jax_map
    tcfg = small_config(tconfig)
    state = state_from_numpy(tree, CPU)
    runner = LocalMappingRunner("cpu")
    runner.capture(state, tcfg)
    assert runner.ready(tcfg)
    assert runner.ready(tcfg.replace(tracking=dataclasses.replace(
        tcfg.tracking, async_mapping=not tcfg.tracking.async_mapping)))
    assert not runner.ready(tcfg.replace(map=dataclasses.replace(tcfg.map, fuse_neighbors=1)))
    wider = state.replace(kfs=state.kfs.replace(uv=torch.cat([state.kfs.uv, state.kfs.uv], 1)))
    other_dtype = state.replace(points=state.points.replace(n_obs=state.points.n_obs.long()))
    for bad, path in ((wider, "state.kfs.uv"), (other_dtype, "state.points.n_obs")):
        with pytest.raises(ValueError, match=path.replace(".", r"\.")):
            runner.step(bad, tcfg)


def test_runner_waits_on_nothing(jax_map, jax_step):
    """The runner's CPU path with every host read trapped: its copies, the
    step and the clones read nothing on the host, and the result still
    matches JAX."""
    _, _, tree = jax_map
    tcfg = small_config(tconfig)
    state = state_from_numpy(tree, CPU)
    runner = LocalMappingRunner("cpu")
    with highest_precision(), host_reads_trapped():
        out = runner.step(state, tcfg)
    _check_step(jax_step, state_to_numpy(out), tree)


def test_graphed_step_copies_every_read_leaf_each_call():
    """A call copies in every leaf the step reads, also a tensor it was
    given before, unchanged in identity and version counter (a write
    through `.data` leaves the counter alone)."""
    x, y = torch.zeros(3), torch.ones(3)
    step = GraphedStep(lambda a: (a[0] + a[1], a[1]), (x, y), CPU, "test", "a")
    assert torch.equal(step((x, y))[0], torch.ones(3))
    version = x._version
    x.data[0] = 5.0
    assert x._version == version
    assert step((x, y))[0].tolist() == [6.0, 1.0, 1.0]


def test_graphed_step_unread_leaves_pass_through_and_raise_if_read():
    """A leaf declared unread comes back as the caller's own tensor, and a
    step that reads it raises with its path."""
    x, y = torch.zeros(3), torch.ones(3)
    step = GraphedStep(lambda a: (a[0] * 2, a[1]), (x, y), CPU, "test", "a",
                       reads=lambda path: path != "a[1]")
    out = step((x, y))
    assert out[1] is y and torch.equal(out[0], torch.zeros(3))
    reads_y = GraphedStep(lambda a: (a[0] + a[1], a[1]), (x, y), CPU, "test", "a",
                          reads=lambda path: path != "a[1]")
    with pytest.raises(RuntimeError, match=r"a\[1\]"):
        reads_y((x, y))


def test_local_bundle_adjust_early_exit_matches_jax(jax_map):
    """BA rerun on its own output: the gain test stops phase 1 early, and
    the frozen fixed-length loop lands where JAX's `while_loop` does."""
    cfg, jstate, _ = jax_map
    prob_j = jlm.assemble_local_ba(jstate, cfg)[0]
    first = jba.local_bundle_adjust(prob_j, cfg.camera, cfg.optimizer)
    prob_j = prob_j._replace(T_cw=first.T_cw, points=first.points)
    res_j = jba.local_bundle_adjust(prob_j, cfg.camera, cfg.optimizer)
    fields = {k: np.asarray(v) for k, v in prob_j._asdict().items()}
    fields["point_slot"] = fields["point_slot"].astype(np.int64)
    prob_t = tba.BAProblem(**{k: torch.from_numpy(v) for k, v in fields.items()})
    tcfg = small_config(tconfig)
    with highest_precision(), host_reads_trapped():
        res_t = tba.local_bundle_adjust(prob_t, tcfg.camera, tcfg.optimizer)
    steps = res_t.iters.tolist()
    assert steps[0] < tcfg.optimizer.local_ba_iters_initial, steps
    np.testing.assert_allclose(np.asarray(res_j.T_cw), res_t.T_cw.numpy(), atol=1e-4, rtol=0)
    pv = fields["point_valid"]
    np.testing.assert_allclose(np.asarray(res_j.points)[pv], res_t.points.numpy()[pv],
                               atol=1e-3, rtol=0)


def _cull_config(mod, ratio):
    cfg = small_config(mod)
    return cfg.replace(map=dataclasses.replace(cfg.map, kf_redundancy_ratio=ratio,
                                               min_observations=0))


def test_cull_keyframes_empty_is_the_identity(jax_map):
    """With nothing to cull (a ratio no keyframe can pass) every field
    comes back bit for bit."""
    _, _, tree = jax_map
    state = state_from_numpy(tree, CPU)
    with host_reads_trapped():
        out = tlm.cull_keyframes(state, _cull_config(tconfig, 1.0))
    before, after = state_to_numpy(state), state_to_numpy(out)

    def check(a, b, path):
        if isinstance(a, dict):
            for k in a:
                check(a[k], b[k], f"{path}.{k}")
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), path

    check(before, after, "state")


def test_cull_keyframes_matches_jax(jax_map):
    """A ratio of 0 makes every candidate redundant: the same keyframes
    culled, parents, retired records and map-point bookkeeping as JAX."""
    _, jstate, tree = jax_map
    out_j = tree_of(jlm.cull_keyframes(jstate, _cull_config(jconfig, 0.0)))
    state = state_from_numpy(tree, CPU)
    with host_reads_trapped():
        out_t = tlm.cull_keyframes(state, _cull_config(tconfig, 0.0))
    out_t = state_to_numpy(out_t)
    assert int(out_j["n_kfs"]) < int(tree["n_kfs"]), "nothing culled: vacuous"
    for group, names in (("kfs", ("valid", "kp_point", "parent_uid")),
                         ("points", ("n_obs", "ref_kf")),
                         ("retired", ("uid", "parent_uid", "count"))):
        for name in names:
            np.testing.assert_array_equal(out_j[group][name], out_t[group][name],
                                          err_msg=f"{group}.{name}")
    np.testing.assert_allclose(out_j["kfs"]["T_rel_parent"], out_t["kfs"]["T_rel_parent"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(out_j["retired"]["T_rel"], out_t["retired"]["T_rel"],
                               atol=1e-6, rtol=0)
    assert int(out_j["n_kfs"]) == int(out_t["n_kfs"])


def _scatter_with_compaction(t, idx, val, op="set"):
    """`utils/tensor_ops.scatter` as it was: in-range entries picked by a
    boolean mask, the value made with `as_tensor`."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    idx = torch.broadcast_tensors(*idx)
    n_lead = len(idx)
    lead, trail = t.shape[:n_lead], t.shape[n_lead:]
    ok = torch.ones(idx[0].shape, dtype=torch.bool)
    lin = torch.zeros(idx[0].shape, dtype=torch.int64)
    for d, i in zip(lead, idx):
        ok &= (i >= 0) & (i < d)
        lin = lin * d + i.to(torch.int64)
    val = torch.as_tensor(val, dtype=t.dtype).expand(idx[0].shape + trail)
    lin, v = lin[ok], val[ok]
    out = t.clone()
    flat = out.view(-1, *trail)
    if op == "set":
        flat[lin] = v
    elif op == "add":
        flat.index_put_((lin,), v, accumulate=True)
    else:
        flat.scatter_reduce_(0, lin, v, reduce=op, include_self=True)
    return out


@pytest.mark.parametrize("op", ["set", "add", "amin", "amax"])
def test_scatter_without_compaction_matches_the_old_one(op):
    """Duplicate, negative and out-of-range indices, one and two index
    tensors, tensor and Python values, under deterministic algorithms."""
    g = torch.Generator().manual_seed(0)
    with highest_precision():
        for trial in range(40):
            dtype = (torch.float32, torch.int32, torch.int64, torch.bool)[trial % (4 if op == "set" else 3)]
            n = 1 + trial % 13
            trail = (3,) if op in ("set", "add") and trial % 2 else ()
            t = (torch.randn((n,) + trail, generator=g) * 10).to(dtype)
            idx = torch.randint(-4, n + 4, (3 * n,), generator=g)
            val = (torch.randn((3 * n,) + trail, generator=g) * 10).to(dtype) if trial % 5 else 1
            a, b = _scatter_with_compaction(t, idx, val, op), scatter(t, idx, val, op)
            assert a.dtype == b.dtype and torch.equal(a, b), (op, dtype, trial)
            if op in ("set", "add"):
                t2 = (torch.randn((n, 4) + trail, generator=g) * 10).to(dtype)
                i0 = torch.randint(-2, n + 2, (n, 1), generator=g)
                i1 = torch.randint(-2, 6, (1, 3), generator=g)
                a = _scatter_with_compaction(t2, (i0, i1), val if trial % 5 == 0 else
                                             t2[:1, :1].expand((n, 3) + trail), op)
                b = scatter(t2, (i0, i1), val if trial % 5 == 0 else
                            t2[:1, :1].expand((n, 3) + trail), op)
                assert torch.equal(a, b), (op, dtype, trial, "two index tensors")
