"""Port parity: the SPD solve's plain version against the JAX package's
Pallas kernel (interpret mode), with the kernel tests' tolerances: both
are f32 eliminations checked against an f64 solve, so the gate is the
relative residual plus rtol 2e-2 / atol 2e-3 on the solution."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_ssd_semantic_tpu.ops.pallas_solve import spd_solve as jax_spd_solve
from orb_slam2_ssd_semantic_tpu_torch.mapping import ba
from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_solve
from _torch_threads import _few_threads  # noqa: F401 (autouse)


def _spd(rng, n, damp=1e-3):
    A = rng.normal(0, 1, (n, n)).astype(np.float32)
    A = A @ A.T
    return A + np.diag(1e-3 * np.abs(np.diag(A)) + damp)


@pytest.mark.parametrize("n", [6, 59, 108, 120, 128])
def test_spd_solve_matches_pallas_kernel(n):
    rng = np.random.default_rng(n)
    A = _spd(rng, n)
    b = rng.normal(0, 1, (n,)).astype(np.float32)
    x_t = cuda_solve.spd_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    x_j = np.asarray(jax_spd_solve(jnp.asarray(A), jnp.asarray(b), interpret=True))
    ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
    resid = np.linalg.norm(A @ x_t - b) / max(np.linalg.norm(b), 1e-9)
    assert resid < 1e-3, (n, resid)
    np.testing.assert_allclose(x_t, ref, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(x_t, x_j, rtol=2e-2, atol=2e-3)


def test_spd_solve_ill_conditioned_damped():
    rng = np.random.default_rng(1)
    n = 108
    U = np.linalg.qr(rng.normal(0, 1, (n, n)))[0].astype(np.float32)
    s = np.geomspace(1e4, 1e-2, n).astype(np.float32)
    A = (U * s) @ U.T
    A = A + np.diag(1e-3 * np.abs(np.diag(A)) + 1e-5)
    b = rng.normal(0, 1, (n,)).astype(np.float32)
    x = cuda_solve.spd_solve(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 5e-2


@pytest.mark.parametrize("n", [6, 59, 108, 120, 128])
def test_spd_solve_cholesky_reference_matches_pallas_kernel(n):
    """The card kernel's algorithm (panelled pivot-free Cholesky, float32)
    modelled in PyTorch, against the JAX kernel and an f64 solve."""
    rng = np.random.default_rng(n)
    A = _spd(rng, n)
    b = rng.normal(0, 1, (n,)).astype(np.float32)
    x_t = cuda_solve.spd_solve_cholesky_reference(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    x_j = np.asarray(jax_spd_solve(jnp.asarray(A), jnp.asarray(b), interpret=True))
    ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
    resid = np.linalg.norm(A @ x_t - b) / max(np.linalg.norm(b), 1e-9)
    assert resid < 1e-3, (n, resid)
    np.testing.assert_allclose(x_t, ref, rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(x_t, x_j, rtol=2e-2, atol=2e-3)


def test_spd_solve_cholesky_reference_ill_conditioned_damped():
    """No clamp and no pivoting: the damping alone keeps the float32
    pivots positive on the near-singular case of the kernel tests."""
    rng = np.random.default_rng(1)
    n = 108
    U = np.linalg.qr(rng.normal(0, 1, (n, n)))[0].astype(np.float32)
    s = np.geomspace(1e4, 1e-2, n).astype(np.float32)
    A = (U * s) @ U.T
    A = A + np.diag(1e-3 * np.abs(np.diag(A)) + 1e-5)
    b = rng.normal(0, 1, (n,)).astype(np.float32)
    x = cuda_solve.spd_solve_cholesky_reference(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    assert np.isfinite(x).all()
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) < 5e-2


def test_spd_solve_cholesky_reference_reads_only_the_lower_triangle():
    """Like the kernel, the model never reads above the diagonal, and a
    negative pivot comes out as NaN, not as a clamped number."""
    rng = np.random.default_rng(2)
    A = torch.from_numpy(_spd(rng, 20))
    b = torch.from_numpy(rng.normal(0, 1, (20,)).astype(np.float32))
    x = cuda_solve.spd_solve_cholesky_reference(A, b)
    junk = A + torch.triu(torch.full_like(A, 7.0), diagonal=1)
    torch.testing.assert_close(cuda_solve.spd_solve_cholesky_reference(junk, b), x, rtol=0, atol=0)
    bad = A.clone()
    bad[3, 3] = -1.0
    assert torch.isnan(cuda_solve.spd_solve_cholesky_reference(bad, b)).any()


@pytest.mark.parametrize("n", [120, 144])
def test_reduced_solve_routing(n, monkeypatch):
    """Local BA takes the SPD kernel up to 128 unknowns (its plain
    version here) and torch.linalg.solve above, like the JAX package."""
    calls = []
    real = cuda_solve.spd_solve

    def spy(A, b):
        calls.append(A.shape[0])
        return real(A, b)

    monkeypatch.setattr(cuda_solve, "spd_solve", spy)
    rng = np.random.default_rng(n)
    A = torch.from_numpy(_spd(rng, n))
    b = torch.from_numpy(rng.normal(0, 1, (n,)).astype(np.float32))
    x = ba.solve_reduced(A, b)
    assert calls == ([n] if n <= 128 else [])
    torch.testing.assert_close(A @ x, b, rtol=0, atol=1e-3 * float(b.norm()))
