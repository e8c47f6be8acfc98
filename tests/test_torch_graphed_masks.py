"""The dynamic masks without host reads: `ops/cuda_eigh.py` (the `sym_eig`
kernel's wrapper and its algorithm model), `ops/homography.py`'s minimal
sets, and `dynamic/graphed_masks.py::MaskRunner`, on QVGA frames of the
dynamic scene (two moving boxes).

Gates, and why:
- `eigh_small` on the CPU is `torch.linalg.eigh`: bit for bit (the same
  call), so every CPU result of the port stays as it was; it refuses
  n > 16, float64 and a non-contiguous input on every device;
- the kernel's algorithm (`eigh_jacobi_reference`, cyclic Jacobi in f32)
  against `torch.linalg.eigh` on the flow mask's own systems (the 128
  minimal-set systems and the refit of two frame pairs) and on seeded
  degenerate minimal sets (a repeated row, collinear points): eigenvalues
  within 1e-5 of the matrix's Frobenius norm, each eigenvector whose
  eigenvalue lies more than 1e-3 of the largest from the others within
  1 - |v . v_ref| <= 1e-4 (`chip_smoke.py` 9b's limits for the kernel);
  the homography from the Jacobi null vector within 1e-4 of JAX's `_dlt`
  (relative to its largest entry) where the null vector is so separated,
  the limit of `test_torch_dynamic.py::test_dlt_matches_jax`;
- the kernel's pair table (the circle method's rounds, `_round_pairs`):
  each round's pairs disjoint, every pair once a sweep, for n = 1-16;
- its power-of-two scaling: M times 2^k gives 2^k times the eigenvalues
  and the same eigenvectors, bit for bit (the scaling is exact), and at
  1e-30 and 1e30 (where d^2 + h^2 unscaled would underflow or overflow)
  the Jacobi model holds the limits above;
- the minimal sets' uniforms: one tensor, made once;
- both masks (the flow mask with its own minimal sets), and both
  `MaskRunner` steps, with every host read trapped: none;
- `MaskRunner`'s masks against the eager functions on two frame pairs:
  equal bit for bit (the same operations on the same inputs), one graph a
  kind, the inputs untouched.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import orb_slam2_ssd_semantic_tpu_torch.config as tconfig
from orb_slam2_ssd_semantic_tpu.ops import homography as jh
from orb_slam2_ssd_semantic_tpu_torch.dynamic import flowmask as tfm
from orb_slam2_ssd_semantic_tpu_torch.dynamic import geommask as tgm
from orb_slam2_ssd_semantic_tpu_torch.dynamic.graphed_masks import MaskRunner
from orb_slam2_ssd_semantic_tpu_torch.io.synthetic import SyntheticSequence
from orb_slam2_ssd_semantic_tpu_torch.ops import cuda_eigh
from orb_slam2_ssd_semantic_tpu_torch.ops import homography as th
from test_torch_tracker import small_config
from _torch_host_reads import host_reads_trapped
from _torch_threads import _few_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
N_FRAMES = 5
PAIRS = ((0, 1), (3, 4))  # frames 2-3 move the boxes under the flow threshold
EIG_TOL = 1e-5  # of the matrix's Frobenius norm
GAP = 1e-3  # relative eigenvalue gap above which an eigenvector is held
VEC_TOL = 1e-4  # 1 - |v . v_ref|
H_TOL = 1e-4


@pytest.fixture(scope="module")
def scene():
    """QVGA frames of the dynamic scene (float32 gray, metres), their
    world-to-camera poses, and a view ring of frames 0 and 2 (random
    keypoints with their rendered depth)."""
    cfg = small_config(tconfig)
    seq = SyntheticSequence(n_frames=N_FRAMES, dynamic_objects=True, n_dynamic=2,
                            cam=cfg.camera)
    frames = [tuple(torch.from_numpy(a) for a in seq.gray_depth(i)) for i in range(N_FRAMES)]
    T_cw = [torch.from_numpy(np.linalg.inv(p).astype(np.float32)) for p in seq.poses_wc]
    rng = np.random.default_rng(0)
    K = 512
    db = tgm.empty_ref_views(20, K, CPU)
    for i in (0, 2):
        uv = (rng.random((K, 2)) * [319, 239]).astype(np.float32)
        d = frames[i][1].numpy()[np.round(uv[:, 1]).astype(int), np.round(uv[:, 0]).astype(int)]
        db = tgm.insert_ref_view(db, T_cw[i], torch.from_numpy(uv), torch.from_numpy(d),
                                 torch.from_numpy(rng.random(K) > 0.1))
    return dict(cfg=cfg, frames=frames, T_cw=T_cw, db=db)


def _flow_systems(scene, monkeypatch) -> list:
    """The matrices the flow mask hands `eigh_small` on PAIRS, and the
    points of each 4-point set (normalised src and dst)."""
    seen = []

    def spy(M):
        seen.append(M.clone())
        return cuda_eigh.eigh_small(M)

    monkeypatch.setattr(th, "eigh_small", spy)
    f = scene["frames"]
    for a, b in PAIRS:
        tfm.flow_dynamic_mask_fitted(f[a][0], f[b][0], tconfig.DynamicConfig())
    monkeypatch.undo()
    return seen


def _degenerate_sets(seed: int = 5):
    """Normalised 4-point sets, 16 with a repeated row, 16 with three
    collinear points, and 16 well-posed ones (a jittered square):
    (src, dst) (48, 4, 2)."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((48, 4, 2)).astype(np.float32)
    square = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], np.float32)
    src[32:] = square + 0.2 * rng.standard_normal((16, 4, 2)).astype(np.float32)
    H = np.array([[1.02, 0.03, 0.1], [-0.02, 0.98, -0.05], [0.01, -0.02, 1.0]], np.float32)
    src[:16, 3] = src[:16, 1]  # a repeated row (sets drawn with replacement)
    t = rng.random((16, 1)).astype(np.float32)
    src[16:32, 2] = src[16:32, 0] + t * (src[16:32, 1] - src[16:32, 0])  # collinear
    ph = np.concatenate([src, np.ones((48, 4, 1), np.float32)], -1) @ H.T
    dst = (ph[..., :2] / ph[..., 2:]).astype(np.float32)
    dst += rng.standard_normal(dst.shape).astype(np.float32) * 1e-3
    return torch.from_numpy(src), torch.from_numpy(dst)


def _dlt_matrix(src, dst):
    x, y, u, v = src[..., 0], src[..., 1], dst[..., 0], dst[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    A = torch.cat([torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1),
                   torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)], -2)
    return (A.transpose(-1, -2) @ A).contiguous()


def _rel_gaps(lam: torch.Tensor) -> torch.Tensor:
    """Each eigenvalue's distance to the nearest other, over the largest
    magnitude (ascending eigenvalues (..., n))."""
    d = lam[..., 1:] - lam[..., :-1]
    inf = torch.full_like(lam[..., :1], float("inf"))
    near = torch.minimum(torch.cat([inf, d], -1), torch.cat([d, inf], -1))
    return near / lam.abs().amax(-1, keepdim=True)


def _check_eig(M: torch.Tensor, label: str) -> torch.Tensor:
    """Jacobi model against the library on M (..., n, n); returns the
    mask of systems whose null vector is held (gap over GAP)."""
    w, v = cuda_eigh.eigh_jacobi_reference(M)
    wr, vr = torch.linalg.eigh(M)
    nrm = torch.linalg.norm(M, dim=(-1, -2))
    err = ((w - wr).abs().amax(-1) / nrm).max()
    assert err <= EIG_TOL, (label, float(err))
    held = _rel_gaps(wr) > GAP
    off = torch.where(held, 1 - (v * vr).sum(-2).abs(), torch.zeros_like(w)).max()
    assert off <= VEC_TOL, (label, float(off))
    return held[..., 0]


def test_eigh_small_on_the_cpu_is_the_library_call():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((7, 9, 9)).astype(np.float32)
    M = torch.from_numpy(A @ A.transpose(0, 2, 1))
    for m in (M, M[3]):
        w, v = cuda_eigh.eigh_small(m)
        wr, vr = torch.linalg.eigh(m)
        assert torch.equal(w, wr) and torch.equal(v, vr)


@pytest.mark.parametrize("bad", ["n17", "float64", "strided", "not_square"])
def test_eigh_small_refuses(bad):
    M = torch.eye(9).expand(4, 9, 9).contiguous()
    arg = {"n17": torch.eye(17), "float64": M.double(), "strided": M.transpose(-1, -2),
           "not_square": torch.zeros(4, 9, 8)}[bad]
    assert bad != "strided" or not arg.is_contiguous()
    with pytest.raises(ValueError):
        cuda_eigh.eigh_small(arg)
    with pytest.raises(ValueError):
        cuda_eigh.eigh_jacobi_reference(arg)


def test_jacobi_matches_eigh_on_the_flow_masks_systems(scene, monkeypatch):
    systems = _flow_systems(scene, monkeypatch)
    assert [tuple(M.shape) for M in systems] == [(128, 9, 9), (9, 9)] * len(PAIRS)
    held = [_check_eig(M, f"flow system {i}") for i, M in enumerate(systems)]
    assert all(bool(h.all()) for h in held[1::2]), "a refit's null vector is not separated"
    assert sum(int(h.sum()) for h in held[::2]) >= 64  # of 256: minimal sets are ill-posed


def test_jacobi_on_degenerate_sets_and_its_homography_against_jax():
    src, dst = _degenerate_sets()
    M = _dlt_matrix(src, dst)
    held = _check_eig(M, "degenerate sets")
    assert not bool(held[:16].any()), "a repeated row leaves a 2-d null space"
    assert bool(held[32:].all())
    _, v = cuda_eigh.eigh_jacobi_reference(M)
    H = th._safe_div_h22(v[..., :, 0].reshape(-1, 3, 3))
    Hj = np.stack([np.asarray(jh._dlt(jnp.asarray(s), jnp.asarray(d), jnp.ones(4)))
                   for s, d in zip(src[32:].numpy(), dst[32:].numpy())])
    err = np.abs(H[32:].numpy() - Hj).max((-1, -2)) / np.abs(Hj).max((-1, -2))
    assert err.max() <= H_TOL, err.max()


@pytest.mark.parametrize("n", range(1, 17))
def test_jacobi_rounds_rotate_every_pair_once_a_sweep(n):
    m = n + (n & 1)
    seen = []
    for r in range(m - 1):
        pairs = [(p, q) for p, q in cuda_eigh._round_pairs(m, r) if q < n]
        flat = [i for pq in pairs for i in pq]
        assert len(flat) == len(set(flat)) and all(p < q for p, q in pairs), (r, pairs)
        seen += pairs
    assert sorted(seen) == [(p, q) for p in range(n) for q in range(p + 1, n)]


def test_jacobi_scaling_is_exact_and_keeps_extreme_magnitudes():
    rng = np.random.default_rng(2)
    A = rng.standard_normal((32, 9, 9)).astype(np.float32)
    M = torch.from_numpy(A @ A.transpose(0, 2, 1))
    w, v = cuda_eigh.eigh_jacobi_reference(M)
    for k in (-100, -30, 30, 100):
        wk, vk = cuda_eigh.eigh_jacobi_reference(M * 2.0**k)
        assert torch.equal(wk, w * 2.0**k) and torch.equal(vk, v), k
    for scale in (1e-30, 1e30):  # held in float64, whose squares do not leave its range
        Ms = (M * scale).contiguous()
        ws, vs = cuda_eigh.eigh_jacobi_reference(Ms)
        wr, vr = torch.linalg.eigh(Ms.double())
        err = (ws.double() - wr).abs().amax(-1) / torch.linalg.norm(Ms.double(), dim=(-1, -2))
        assert float(err.max()) <= EIG_TOL, (scale, float(err.max()))
        held = _rel_gaps(wr) > GAP
        off = torch.where(held, 1 - (vs.double() * vr).sum(-2).abs(), torch.zeros_like(wr))
        assert bool(held.any()) and float(off.max()) <= VEC_TOL, (scale, float(off.max()))


def test_minimal_set_uniforms_are_made_once():
    a = th.minimal_set_uniforms(0, 128, 4, device=CPU)
    assert a is th.minimal_set_uniforms(0, 128, 4, device="cpu")
    assert a.shape == (128, 4) and a.dtype == torch.float32
    valid = torch.arange(200) % 3 != 0
    assert torch.equal(th.sample_minimal_sets(valid), th.sample_minimal_sets(valid))


def test_masks_read_nothing_on_the_host(scene):
    f, cfg = scene["frames"], scene["cfg"]
    T = scene["T_cw"][4]
    th.minimal_set_uniforms(0, 128, 4, device=CPU)  # made before, as a warm-up makes it
    with host_reads_trapped():
        m = tfm.flow_dynamic_mask_fitted(f[3][0], f[4][0], cfg.dynamic)
        g = tgm.geometry_dynamic_mask(scene["db"], T, f[4][1], cfg.camera, cfg.dynamic)
    assert m.shape == g.shape == (240, 320)
    assert not bool(m.all()) and not bool(g.all()), "no dynamic pixel: vacuous"


def test_mask_runner_equals_the_eager_masks(scene):
    f, cfg, db = scene["frames"], scene["cfg"], scene["db"]
    runner = MaskRunner(CPU)
    before = [t.clone() for t in (f[0][0], f[1][0], db.T_cw, db.uv)]
    for a, b in PAIRS:
        prev, cur, depth = f[a][0], f[b][0], f[b][1]
        T = scene["T_cw"][b]
        with host_reads_trapped():
            m = runner.flow(prev, cur, cfg.dynamic)
            g = runner.geometry(db, T, depth, cfg.camera, cfg.dynamic)
        assert torch.equal(m, tfm.flow_dynamic_mask_fitted(prev, cur, cfg.dynamic))
        assert torch.equal(g, tgm.geometry_dynamic_mask(db, T, depth, cfg.camera, cfg.dynamic))
        assert not bool(m.all()) and not bool(g.all()), f"frames {a}, {b}: vacuous"
    assert len(runner.graphs()) == 2
    assert runner.ready_flow(f[0][0], f[1][0], cfg.dynamic)
    assert not runner.ready_flow(f[0][0], f[1][0], dataclasses.replace(cfg.dynamic,
                                                                        flow_iters=2))
    for x, y in zip(before, (f[0][0], f[1][0], db.T_cw, db.uv)):
        assert torch.equal(x, y)
