"""Port twins of `tests/test_parallel.py`: the port's `parallel/` modules on
four spawned gloo ranks against the JAX package on the same numpy
inputs.

One module fixture starts the ranks (`_torch_dist.parallel_job`) and
computes the JAX side meanwhile. JAX runs its sharded functions on four
of the eight virtual CPU devices that `tests/conftest.py` sets up. The
gates are JAX's:
- the distributed global BA on `build_problem(F=10, P=256)`, M (2,276)
  padded with `obs_valid=False` rows to a multiple of 8, as JAX's test
  pads it to its 8 devices: pose error under 0.01 against ground truth, within
  5e-3 of the single-device poses (JAX's `global_bundle_adjust`), and of
  JAX's own distributed run, inliers agreeing on at least 99.9%;
- the distributed pose step holds a perfect pose within 1e-3;
- three scans into a 64x32x32 grid in four X slabs equal JAX's
  `insert_scan` within 1e-5;
- every all-reduce of the distributed BA has fewer rows than a rank has
  observations: its rows are keyframes or points (the reduced system
  travels, never the observations). JAX's test counts elements in the
  compiled HLO; here the (P, 3, 3) point blocks hold 2,304 elements
  against a rank's 570 observations, so rows are what tells the two
  apart at this size;
- the keyframe-sharded BoW build within 1e-5 of JAX's, and the sharded
  detect's scores within 1e-5 with equal ids and `ok` against JAX's
  `detect_candidates`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from orb_slam2_ssd_semantic_tpu.config import DenseMapConfig, OptimizerConfig
from orb_slam2_ssd_semantic_tpu.dense.occupancy import empty_grid, insert_scan
from orb_slam2_ssd_semantic_tpu.mapping import place_recognition as pr
from orb_slam2_ssd_semantic_tpu.mapping.global_ba import global_bundle_adjust
from orb_slam2_ssd_semantic_tpu.parallel.dist_ba import make_distributed_global_ba
from orb_slam2_ssd_semantic_tpu.parallel.mesh import PT_AXIS, make_mesh
from test_global_ba import CAM, build_problem, pose_errors
from test_parallel import _pad_to
from _torch_dist import Ranks
from _torch_threads import _few_threads  # noqa: F401 (autouse)

RANKS = 4
PAD_TO = 8
INDEX = ("obs_kf", "obs_pt")


def _inputs(rng):
    """The five tests' inputs, as numpy, in `test_parallel.py`'s order of
    draws."""
    prob, T_gt, _ = build_problem(rng, F=10, P=256)
    assert prob.obs_kf.shape[0] % PAD_TO, "no padding exercised"
    prob = _pad_to(prob, PAD_TO)
    gba = {k: np.asarray(v).astype(np.int64) if k in INDEX else np.asarray(v)
           for k, v in prob._asdict().items()}

    n = 64 * RANKS
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(2, 5, n)],
                   -1).astype(np.float32)
    u = CAM.fx * pts[:, 0] / pts[:, 2] + CAM.cx
    v = CAM.fy * pts[:, 1] / pts[:, 2] + CAM.cy
    obs = np.stack([u, v, u - CAM.depth_bf / pts[:, 2]], -1).astype(np.float32)
    pose = dict(pts=pts, obs=obs, w=np.ones((n,), np.float32))

    scans = []
    for scan in range(3):
        o = np.asarray([0.4 + 2.2 * scan, 1.6, 1.6], np.float32)
        p = np.stack([rng.uniform(0.2, 6.2, 256), rng.uniform(0.2, 3.0, 256),
                      rng.uniform(0.2, 3.0, 256)], -1).astype(np.float32)
        scans.append((o, p, rng.uniform(size=256) > 0.1, rng.uniform(size=256) > 0.8))
    occ = dict(dims=(64, 32, 32), origin=(0.0, 0.0, 0.0), scans=scans)

    F, N = 4 * RANKS, 64
    desc = rng.integers(0, 2 ** 32, (F, N, 8), dtype=np.uint32)
    valid = rng.uniform(size=(F, N)) > 0.2
    db_ref = np.asarray(jax.vmap(pr.bow_vector)(jnp.asarray(desc), jnp.asarray(valid)))
    query = db_ref[3] * 0.9 + db_ref[7] * 0.1
    query = (query / np.linalg.norm(query)).astype(np.float32)
    exclude = np.zeros((F,), bool)
    exclude[3] = True
    bow = dict(desc=desc, valid=valid, db_ref=db_ref, query=query,
               db_valid=rng.uniform(size=F) > 0.1, exclude=exclude, min_score=np.float32(0.05))
    return dict(prob=prob, T_gt=T_gt, gba=gba, pose=pose, occ=occ, bow=bow)


@pytest.fixture(scope="module")
def runs():
    data = _inputs(np.random.default_rng(0))
    ranks = Ranks("parallel_job", RANKS, {k: data[k] for k in ("gba", "pose", "occ", "bow")})
    prob = data["prob"]
    cfg = OptimizerConfig()
    ref = global_bundle_adjust(prob, CAM, cfg, cg_iters=25)
    mesh = make_mesh(n_kf=1, n_pt=RANKS, devices=jax.devices()[:RANKS])
    sh, rep = NamedSharding(mesh, P(PT_AXIS)), NamedSharding(mesh, P())
    obs = ("obs_kf", "obs_pt", "obs_uvr", "inv_sigma2", "is_stereo", "obs_valid")
    placed = prob._replace(**{k: jax.device_put(getattr(prob, k), sh if k in obs else rep)
                              for k in prob._fields})
    jdist = make_distributed_global_ba(mesh, CAM, cfg, cg_iters=25)(placed)

    occ = data["occ"]
    dcfg = DenseMapConfig(resolution=0.1, max_ray_steps=64)
    grid = empty_grid(extent=(6.4, 3.2, 3.2), resolution=0.1, origin=occ["origin"])
    for o, pts, valid, carve in occ["scans"]:
        grid = insert_scan(grid, jnp.asarray(o), jnp.asarray(pts), jnp.asarray(valid),
                           carve_only=jnp.asarray(carve), cfg=dcfg)

    b = data["bow"]
    det = pr.detect_candidates(jnp.asarray(b["query"]), jnp.asarray(b["db_ref"]),
                               jnp.asarray(b["db_valid"]), jnp.asarray(b["exclude"]),
                               jnp.float32(b["min_score"]), max_candidates=4)
    jax_side = dict(ref=ref, dist=jdist, grid=np.asarray(grid.log_odds),
                    detect=[np.asarray(x) for x in det])
    return data, jax_side, ranks.result()


def test_distributed_global_ba_matches_single_device(runs):
    data, j, out = runs
    T = out["gba"]["T_cw"]
    assert pose_errors(T, data["T_gt"]).max() < 0.01
    for other in (j["ref"], j["dist"]):
        dT = np.abs(T - np.asarray(other.T_cw)).max()
        assert dT < 5e-3, f"port distributed vs JAX pose drift {dT}"
        agree = (out["gba"]["inlier"] == np.asarray(other.inlier)).mean()
        assert agree > 0.999


def test_distributed_pose_step_fixed_point(runs):
    _, _, out = runs
    assert float(np.abs(out["pose"] - np.eye(4)).max()) < 1e-3


def test_sharded_occupancy_matches_single_device(runs):
    _, j, out = runs
    np.testing.assert_allclose(out["occ"], j["grid"], atol=1e-5)
    assert float(np.abs(out["occ"]).sum()) > 0


def test_distributed_ba_communicates_only_reduced_system(runs):
    data, _, out = runs
    sizes = out["reduce_sizes"]
    assert sizes, "no all-reduce recorded: is the reduction still sharded?"
    per_rank_M = data["gba"]["obs_kf"].shape[0] // RANKS
    rows = max(sizes)
    assert rows < per_rank_M, f"all-reduce of {rows} rows >= a rank's {per_rank_M} observations"


def test_sharded_bow_detect_matches_single_device(runs):
    data, j, out = runs
    np.testing.assert_allclose(out["bow"]["db"], data["bow"]["db_ref"], atol=1e-5)
    ids_r, s_r, ok_r = j["detect"]
    np.testing.assert_allclose(out["bow"]["scores"], s_r, atol=1e-5)
    np.testing.assert_array_equal(out["bow"]["ids"], ids_r)
    np.testing.assert_array_equal(out["bow"]["ok"], ok_r)
