"""`OptimizerConfig.ba_reduction_dtype` in the port's local BA
(`mapping/ba.py`): twin of `tests/test_ba_bf16_parity.py` on its
6-camera window, with "bfloat16" set explicitly (JAX's test passes the
default config, "float32", to both runs).

"bfloat16" rounds the two Schur products' operands to bfloat16 and
multiplies them in f32: a product of two bf16 values is exact in f32, so
this is a TPU's default matmul precision (one bf16 multiply, f32
accumulation) on any device. JAX on the CPU runs DEFAULT as f32, so only
the port's "float32" run is held against JAX's.

Gates: JAX's test's, each run's camera centres within 2e-2 m of ground
truth, points within 5 mm median of each other, inlier decisions over
99% equal; the port's "float32" run within 1e-4 m of JAX's (centres and
points). JAX's fourth gate, the two runs' centres within 1 mm, holds in
JAX's test because both of its runs are f32. With bf16 operands the
centres here part from the f32 run's by up to 4.55 mm along the open arc
(`dc` below, on the CPU): the reduced gradient `rhs` is a
cancellation-dominated product too, so its rounding moves the converged
state, which is why JAX's `mapping/ba.py:172-177` defaults to f32 for
small windows. This twin holds that gap to 1e-2 m, half the
ground-truth gate.
"""

import numpy as np
import pytest
import torch

from orb_slam2_ssd_semantic_tpu.config import OptimizerConfig as JaxOptimizerConfig
from orb_slam2_ssd_semantic_tpu.mapping.ba import local_bundle_adjust as jax_local_ba
from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, OptimizerConfig
from orb_slam2_ssd_semantic_tpu_torch.mapping import ba
from test_ba_bf16_parity import _centers, build_window
from _torch_threads import _few_threads  # noqa: F401 (autouse)


def _port_problem(prob) -> ba.BAProblem:
    def t(name):
        a = np.array(getattr(prob, name))
        return torch.from_numpy(a.astype(np.int64) if name == "point_slot" else a)

    return ba.BAProblem(**{f: t(f) for f in ("T_cw", "fixed", "points", "point_valid",
                                             "point_slot", "obs_uvr", "inv_sigma2",
                                             "is_stereo")})


@pytest.fixture(scope="module")
def window():
    prob, T_gt, _ = build_window(np.random.default_rng(0))
    port = _port_problem(prob)
    runs = {d: ba.local_bundle_adjust(port, CameraConfig(), OptimizerConfig(ba_reduction_dtype=d))
            for d in ("bfloat16", "float32")}
    return prob, T_gt, runs


def test_bf16_and_f32_runs_agree(window):
    _, T_gt, runs = window
    for res in runs.values():
        err = np.linalg.norm(_centers(res.T_cw.numpy()) - _centers(T_gt), axis=-1)
        assert err.max() < 2e-2, err.max()
    r16, r32 = runs["bfloat16"], runs["float32"]
    dc = np.linalg.norm(_centers(r16.T_cw.numpy()) - _centers(r32.T_cw.numpy()), axis=-1)
    assert dc.max() < 1e-2, dc.max()
    dp = np.linalg.norm(r16.points.numpy() - r32.points.numpy(), axis=-1)
    assert np.median(dp) < 5e-3, np.median(dp)
    assert (r16.inlier.numpy() == r32.inlier.numpy()).mean() > 0.99
    # The setting is read: the two runs are not the same computation.
    assert not torch.equal(r16.T_cw, r32.T_cw)


def test_f32_matches_jax(window):
    prob, _, runs = window
    ref = jax_local_ba(prob, CameraConfig(), JaxOptimizerConfig(ba_reduction_dtype="float32"))
    r32 = runs["float32"]
    np.testing.assert_allclose(_centers(r32.T_cw.numpy()), _centers(np.asarray(ref.T_cw)),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(r32.points.numpy(), np.asarray(ref.points), atol=1e-4, rtol=0)
    assert (r32.inlier.numpy() == np.asarray(ref.inlier)).mean() > 0.99


def test_bf16_rounds_the_schur_operands():
    """On a cancellation-heavy product (rows nearly equal, so A B' is a
    difference of large terms) the bf16 operands change the result, and
    the f32 matmul of the rounded operands equals their float64 product up
    to f32 accumulation: each product is exact."""
    rng = np.random.default_rng(5)
    base = rng.normal(0, 1e3, (1, 64))
    A = torch.from_numpy((base + rng.normal(0, 1e-1, (12, 64))).astype(np.float32))
    B = torch.from_numpy((base + rng.normal(0, 1e-1, (12, 64))).astype(np.float32))
    S32 = A @ B.T
    red = ba._reduction_operand("bfloat16")
    S16 = red(A) @ red(B).T
    exact16 = red(A).double() @ red(B).double().T
    assert (S16 != S32).any()
    assert torch.allclose(S16.double(), exact16, rtol=1e-6, atol=0)
    assert ba._reduction_operand("float32")(A) is A


def test_other_reduction_dtypes_raise(window):
    port = _port_problem(window[0])
    for bad in ("float16", "bf16", "tf32"):
        with pytest.raises(ValueError, match="ba_reduction_dtype"):
            ba.local_bundle_adjust(port, CameraConfig(), OptimizerConfig(ba_reduction_dtype=bad))
