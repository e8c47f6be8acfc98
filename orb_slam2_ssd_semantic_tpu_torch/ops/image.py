"""Dense image ops on (H, W) float32 tensors: separable 1-D correlation
and the Gaussian pre-blur, the pyramid resize, keypoint depth sampling,
and the gradients, box filter, bilinear sampler and binary morphology of
the dynamic masks (counterpart of the JAX package's `ops/image.py`)."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import device_constant


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    """Matches cv::getGaussianKernel for odd ksize."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur of an (H, W) image with reflect padding (the
    edge pixel not repeated), the pre-blur before BRIEF sampling
    (ORBextractor.cc:1105): rows first, then columns."""
    k = gaussian_kernel1d(ksize, sigma)
    pad = ksize // 2
    x = conv1d_axis(pad_reflect(img, pad, 0), k, axis=0)
    return conv1d_axis(pad_reflect(x, 0, pad), k, axis=1)


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


@device_constant
def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_in, n_out) weights of `jax.image.resize(method="linear")`: a
    triangle kernel, widened by the downscale factor (antialiasing),
    column-normalised — computed in f32 with the same formulas. Plain
    bilinear interpolation (F.interpolate) does not widen the kernel and
    gives other pixels. Made once per size and device: an upload on every
    call would be a copy the host waits for."""
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
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased linear resize of the last two dims, `jax.image.resize(
    ..., "linear")` semantics, as two weight-matrix products (full f32:
    the entry points turn TF32 off); leading dims are a batch."""
    h, w = img.shape[-2:]
    wh = _resize_weights(h, out_h, device=img.device)
    ww = _resize_weights(w, out_w, device=img.device)
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


def pad_reflect(x: torch.Tensor, pad_h: int, pad_w: int) -> torch.Tensor:
    """Reflect padding (`jnp.pad(mode="reflect")`, the edge pixel not
    repeated) of the last two dims of an (H, W) or (C, H, W) tensor."""
    if pad_h == 0 and pad_w == 0:
        return x
    squeeze = x.dim() == 2
    out = F.pad(x[None] if squeeze else x, (pad_w, pad_w, pad_h, pad_h), mode="reflect")
    return out[0] if squeeze else out


def sobel(img: torch.Tensor):
    """Sobel gradients (gx, gy) with reflect padding."""
    p = pad_reflect(img, 1, 1)
    kd, ks = (-1.0, 0.0, 1.0), (1.0, 2.0, 1.0)
    gx = conv1d_axis(conv1d_axis(p, kd, axis=-1), ks, axis=-2)
    gy = conv1d_axis(conv1d_axis(p, ks, axis=-1), kd, axis=-2)
    return gx, gy


def box_filter(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Mean filter with reflect padding over the last two dims of an
    (H, W) or (C, H, W) tensor: rows first, then columns."""
    k = (float(np.float32(1.0 / ksize)),) * ksize
    pad = ksize // 2
    x = conv1d_axis(pad_reflect(img, pad, 0), k, axis=-2)
    return conv1d_axis(pad_reflect(x, 0, pad), k, axis=-1)


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor, fill: float = 0.0):
    """Sample img (H, W) at continuous pixel coords uv (..., 2) = (x, y)
    with edge-clamped taps. Returns (values (...,), in-bounds mask)."""
    h, w = img.shape
    u = uv[..., 0]
    v = uv[..., 1]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = u - u0
    dv = v - v0
    u0i = u0.to(torch.int64)
    v0i = v0.to(torch.int64)
    valid = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)

    def tap(vi, ui):
        return img[vi.clamp(0, h - 1), ui.clamp(0, w - 1)]

    val = (
        tap(v0i, u0i) * (1 - du) * (1 - dv)
        + tap(v0i, u0i + 1) * du * (1 - dv)
        + tap(v0i + 1, u0i) * (1 - du) * dv
        + tap(v0i + 1, u0i + 1) * du * dv
    )
    return torch.where(valid, val, torch.full_like(val, fill)), valid


def _ellipse_se(ksize: int) -> np.ndarray:
    """Ellipse structuring element; an even ksize gives the odd size
    below it (10 -> 9 x 9), as the JAX version does."""
    r = (ksize - 1) / 2.0
    y, x = np.mgrid[-math.floor(r):math.floor(r) + 1, -math.floor(r):math.floor(r) + 1]
    return ((x / r) ** 2 + (y / r) ** 2 <= 1.0 + 1e-9).astype(np.float32)


def _dilate_se(x: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    """Grayscale dilation of (H, W) by a 0/1 structuring element: the max
    over the shifted windows where the element is set, -inf outside."""
    k = se.shape[0]
    pad = k // 2
    h, w = x.shape
    xp = F.pad(x, (pad, pad, pad, pad), value=float("-inf"))
    wins = [xp[dy:dy + h, dx:dx + w] for dy, dx in zip(*np.nonzero(se))]
    return torch.amax(torch.stack(wins), dim=0)


def erode(mask: torch.Tensor, ksize: int, iterations: int = 1) -> torch.Tensor:
    """Binary erosion with a ksize x ksize ellipse (cv::erode with
    MORPH_ELLIPSE)."""
    se = _ellipse_se(ksize)
    out = mask.to(torch.float32)
    for _ in range(iterations):
        out = -_dilate_se(-out, se)
    return out > 0.5


def dilate(mask: torch.Tensor, ksize: int, iterations: int = 1) -> torch.Tensor:
    """Binary dilation with a ksize x ksize ellipse."""
    se = _ellipse_se(ksize)
    out = mask.to(torch.float32)
    for _ in range(iterations):
        out = _dilate_se(out, se)
    return out > 0.5
