"""Dense image ops on (H, W) float32 tensors: separable 1-D correlation,
the pyramid resize, and keypoint depth sampling (counterpart of the JAX
package's `ops/image.py`, the functions the tracking slice uses)."""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """Matches cv::getGaussianKernel for odd ksize."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def conv1d_axis(x: torch.Tensor, k, axis: int) -> torch.Tensor:
    """Valid-mode 1-D correlation along `axis` as a sum of shifted slices,
    accumulated tap by tap in the same order as the JAX version."""
    ksize = len(k)
    n = x.shape[axis] - ksize + 1
    out = None
    for i in range(ksize):
        sl = x.narrow(axis, i, n) * float(k[i])
        out = sl if out is None else out + sl
    return out


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of `jax.image.resize(method="linear")`: a
    triangle kernel, widened by the downscale factor (antialiasing),
    column-normalised — computed in f32 with the same formulas. Plain
    bilinear interpolation (F.interpolate) does not widen the kernel and
    gives other pixels."""
    f32, f64 = torch.float32, torch.float64
    # Reproduce the arithmetic XLA compiles this to, so that the rounded
    # pyramid pixels agree: the scale is a host float64 constant rounded
    # to f32; the sample positions (i + 0.5) * s - 0.5 are one fused
    # multiply-add (one rounding: f64 then f32 here); the division by
    # the kernel scale is a multiply by its f32 reciprocal. A few weights
    # still differ by 1 ulp (XLA's remaining fusion choices), which flips
    # a few dozen rounded pixels on the coarser levels.
    inv_scale = 1.0 / (n_out / n_in)
    inv32 = float(np.float32(inv_scale))
    rk32 = float(np.float32(1.0) / np.float32(max(inv_scale, 1.0)))
    sample_f = ((torch.arange(n_out, dtype=f64) + 0.5) * inv32 - 0.5).to(f32)
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, dtype=f32)[:, None]) * rk32
    w = torch.clamp(1.0 - torch.abs(x), min=0.0)
    tot = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(
        torch.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
        w / torch.where(tot != 0, tot, torch.ones_like(tot)),
        torch.zeros_like(w),
    )
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = torch.where(inside[None, :], w, torch.zeros_like(w))
    return w.to(device)


def resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased linear resize, `jax.image.resize(..., "linear")`
    semantics, as two weight-matrix products (full f32: the entry points
    turn TF32 off)."""
    h, w = img.shape
    wh = _resize_weights(h, out_h, img.device)
    ww = _resize_weights(w, out_w, img.device)
    return (wh.T @ img) @ ww


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float):
    """Per-level (h, w) with the reference's rounding of base/scale."""
    shapes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale_factor**lvl)
        shapes.append((int(round(h * inv)), int(round(w * inv))))
    return shapes


def build_pyramid(img: torch.Tensor, n_levels: int, scale_factor: float):
    """Per-level images, level 0 = input; each level resized from the
    previous one and rounded to integers (the reference's CV_8U pyramid)."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale_factor)
    levels = [img]
    for lvl in range(1, n_levels):
        levels.append(torch.round(resize_linear(levels[-1], *shapes[lvl])))
    return levels


def nearest_sample(img: torch.Tensor, uv: torch.Tensor, fill: float = 0.0):
    """Nearest-pixel sample at uv (..., 2) -> (values, in-bounds mask)."""
    h, w = img.shape
    ui = torch.round(uv[..., 0]).to(torch.int64)
    vi = torch.round(uv[..., 1]).to(torch.int64)
    valid = (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    val = img[vi.clamp(0, h - 1), ui.clamp(0, w - 1)]
    return torch.where(valid, val, torch.full_like(val, fill)), valid


def robust_depth_sample(depth: torch.Tensor, uv: torch.Tensor, rel_tol: float = 0.02):
    """Depth at continuous coords: bilinear where the 2x2 neighbourhood is
    depth-consistent, nearest at discontinuities (see the JAX version for
    why). Returns (depth, valid)."""
    h, w = depth.shape
    u = uv[..., 0]
    v = uv[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    u0i = u0.to(torch.int64)
    v0i = v0.to(torch.int64)
    in_b = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)

    def tap(vi, ui):
        return depth[vi.clamp(0, h - 1), ui.clamp(0, w - 1)]

    d00 = tap(v0i, u0i)
    d10 = tap(v0i, u0i + 1)
    d01 = tap(v0i + 1, u0i)
    d11 = tap(v0i + 1, u0i + 1)
    taps = torch.stack([d00, d10, d01, d11], dim=-1)
    all_pos = torch.all(taps > 1e-6, dim=-1)
    spread = torch.amax(taps, dim=-1) - torch.amin(taps, dim=-1)
    mean_d = torch.mean(taps, dim=-1)
    smooth = all_pos & (spread <= rel_tol * mean_d)
    bil = (
        d00 * (1 - du) * (1 - dv)
        + d10 * du * (1 - dv)
        + d01 * (1 - du) * dv
        + d11 * du * dv
    )
    near, _ = nearest_sample(depth, uv)
    val = torch.where(smooth, bil, near)
    valid = in_b & (val > 1e-6)
    return torch.where(valid, val, torch.zeros_like(val)), valid
