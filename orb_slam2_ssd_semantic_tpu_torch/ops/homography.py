"""Batched DLT homography estimation with vectorised RANSAC (counterpart
of the JAX package's `ops/homography.py`, the cv::findHomography(RANSAC)
of the flow mask's ego-motion fit, Flow.cc:73-80).

All hypotheses are solved and scored in one batch: S minimal 4-point
sets, one 8 x 9 DLT each through `eigh` of AᵀA, one (S, N) residual
matrix, the best by inlier count, then a weighted refit on its inliers.

Sampling is split from scoring, as in `geometry/ransac3d.py`: the JAX
version draws its sets with `jax.random.categorical` from `PRNGKey(0)`,
uniform over the valid rows with replacement. `sample_minimal_sets`
draws the same distribution from a CPU `torch.Generator` (seeded 0),
once per (seed, sets, size, device) into a device constant, and maps the
uniforms to valid rows by rank on the device, so the CPU and the card see
the same sets and nothing waits for `valid`; the tests can also hand
JAX's own sets to `find_homography_ransac`.

Nothing here reads the card on the host, as under JAX's `jit`: the null
vectors come from `ops/cuda_eigh.eigh_small` (the `sym_eig` kernel on the
card, `torch.linalg.eigh` on the CPU), the best hypothesis's row is
gathered on the device and the normalisation is inverted by `inv_ex`,
whose result nobody checks, as `jnp.linalg.inv` raises on nothing. So the
flow mask can be replayed from a CUDA graph
(`dynamic/graphed_masks.py`).
"""

from __future__ import annotations

import torch

from orb_slam2_ssd_semantic_tpu_torch.ops.cuda_eigh import eigh_small
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import device_constant, row, valid_rows


def _safe_div_h22(H: torch.Tensor) -> torch.Tensor:
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(h22) < 1e-12, torch.full_like(h22, 1e-12), h22)


def _dlt(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted DLT over a batch: src, dst (..., N, 2), w (..., N) ->
    H (..., 3, 3) scaled to H[2, 2] = 1. The null vector of the weighted
    (2N, 9) system is the eigenvector of AᵀA with the least eigenvalue;
    its sign cancels in the division. M is (..., 9, 9): `eigh_small`."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], dim=-1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)  # (..., 2N, 9)
    M = A.transpose(-1, -2) @ A
    _, vecs = eigh_small(M)
    H = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    return _safe_div_h22(H)


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """H (..., 3, 3) applied to pts (..., N, 2)."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    out = ph @ H.transpose(-1, -2)
    w = out[..., 2:3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return out[..., :2] / w


def _normalize(pts: torch.Tensor, valid: torch.Tensor):
    """Hartley normalisation over the valid rows: (normalised pts, T)."""
    n = torch.clamp(valid.sum(), min=1.0)
    mean = (pts * valid[:, None]).sum(0) / n
    d = torch.linalg.norm(pts - mean, dim=-1)
    scale = (2.0 ** 0.5) / torch.clamp((d * valid).sum() / n, min=1e-6)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[0]]),
        torch.stack([zero, scale, -scale * mean[1]]),
        torch.stack([zero, zero, one]),
    ])
    return (pts - mean) * scale, T


@device_constant
def minimal_set_uniforms(seed: int, n_hypotheses: int, size: int) -> torch.Tensor:
    """(S, size) float32 uniforms in [0, 1) from a CPU generator seeded
    `seed`: the same on every call and device, so made once per device."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((n_hypotheses, size), generator=gen, dtype=torch.float32)


def sample_minimal_sets(valid: torch.Tensor, n_hypotheses: int = 128,
                        seed: int = 0, size: int = 4) -> torch.Tensor:
    """(S, size) int64 row indices, uniform over the rows where `valid` is
    set, with replacement, from `minimal_set_uniforms`
    (`tensor_ops.valid_rows`). With no valid row every index is the last
    row."""
    u = minimal_set_uniforms(seed, n_hypotheses, size, device=valid.device)
    return valid_rows(u, valid)


def find_homography_ransac(src: torch.Tensor, dst: torch.Tensor, valid: torch.Tensor,
                           idx: torch.Tensor | None = None, threshold: float = 3.0,
                           n_hypotheses: int = 128):
    """RANSAC homography from padded correspondences.

    src, dst (N, 2) f32; valid (N,) bool; idx: (S, 4) minimal sets, or
    None for `sample_minimal_sets(valid, n_hypotheses)`.
    Returns (H (3, 3), inliers (N,) bool, n_inliers int64 tensor)."""
    vf = valid.to(torch.float32)
    sn, Ts = _normalize(src, vf)
    dn, Td = _normalize(dst, vf)
    if idx is None:
        idx = sample_minimal_sets(valid, n_hypotheses)
    S, N = idx.shape[0], src.shape[0]

    Hs = _dlt(sn[idx], dn[idx], torch.ones(idx.shape, dtype=torch.float32, device=src.device))
    proj = apply_homography(Hs, sn.expand(S, N, 2))
    err = torch.linalg.norm(proj - dn[None], dim=-1)  # (S, N)
    inl = (err < threshold * Td[0, 0]) & valid[None, :]
    best = torch.argmax(inl.sum(-1))
    best_inl = row(inl, best)

    H_norm = _dlt(sn, dn, best_inl.to(torch.float32))
    H = _safe_div_h22(torch.linalg.inv_ex(Td).inverse @ H_norm @ Ts)
    err_px = torch.linalg.norm(apply_homography(H, src) - dst, dim=-1)
    inliers = (err_px < threshold) & valid
    return H, inliers, inliers.sum()
