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
from orb_slam2_ssd_semantic_tpu_torch.mapping import triangulation as ttri
from orb_slam2_ssd_semantic_tpu_torch.mapping.map_state import state_from_numpy, state_to_numpy
from orb_slam2_ssd_semantic_tpu_torch.utils.precision import highest_precision
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


def test_local_mapping_step_matches_jax(jax_map):
    cfg, jstate, tree = jax_map
    out_j = tree_of(jlm.local_mapping_step(jstate, cfg))
    tcfg = small_config(tconfig)
    with highest_precision():
        out_t = state_to_numpy(tlm.local_mapping_step(state_from_numpy(tree, CPU), tcfg))
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
