"""ORB orientation (intensity centroid) and steered BRIEF-256 (counterpart
of the JAX package's `ops/orb_descriptor.py`).

`ic_angle` and `steered_brief` are ORB-SLAM2's definitions as gathers
over the whole image: the exact intensity-centroid angle over the
radius-15 disk, and BRIEF sampled at the pattern rotated by the
keypoint's own angle and rounded. They are the references that the
production path is held to: `extract_patches`, `ic_angle_from_patches`,
`blur_patches` and `binned_brief` (the rotation quantized to 32 bins),
which is what the extractor runs.

The JAX version forms these as one-hot matmuls in bfloat16 (the MXU's
fast path); here they are gathers, which give the same values as long
as the operands pass through bfloat16 at the same points: the patches
are read from a bf16 copy of the image (level 0 is a raw, non-integer
f32 image, so the cast changes its values), and the BRIEF samples are
read from bf16-cast blurred patches (integers <= 255, exact).

Descriptors are (N, 8) int32 tensors holding the JAX package's uint32
bit patterns (torch's uint32 coverage is thin; bit ops and popcounts
need no sign).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch.ops.image import conv1d_axis, gaussian_kernel1d
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import device_constant

HALF_PATCH = 15
N_BITS = 256
N_ANGLE_BINS = 32
_PATCH = 2 * HALF_PATCH + 1  # 31
BLUR_PAD = 3  # 7x7 gaussian half-width


@functools.lru_cache()
def _circular_offsets(radius: int = HALF_PATCH) -> np.ndarray:
    """(P, 2) integer (dy, dx) offsets of the circular patch (the disk the
    reference's u_max table walks), in the JAX package's order."""
    ys, xs = np.mgrid[-radius: radius + 1, -radius: radius + 1]
    m = ys**2 + xs**2 <= radius**2
    return np.stack([ys[m], xs[m]], axis=-1).astype(np.int64)


@functools.lru_cache()
def brief_pattern(seed: int = 1234, n_bits: int = N_BITS, radius: int = 13) -> np.ndarray:
    """(n_bits, 4) float32 (x1, y1, x2, y2) Gaussian sampling pairs, norm
    clamped to `radius` (the same deterministic pattern as the JAX
    package, so descriptors compare across the two)."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, 31 / 5.0, size=(n_bits, 2, 2))
    norm = np.linalg.norm(pts, axis=-1, keepdims=True)
    scale = np.minimum(1.0, radius / np.maximum(norm, 1e-9))
    pts = pts * scale
    return pts.reshape(n_bits, 4).astype(np.float32)


@functools.lru_cache()
def _moment_weights() -> np.ndarray:
    """(961, 2) per-pixel (dx*disk, dy*disk) intensity-centroid weights."""
    r = HALF_PATCH
    ys, xs = np.mgrid[-r: r + 1, -r: r + 1]
    disk = (ys**2 + xs**2 <= r**2).astype(np.float32)
    return np.stack([(xs * disk).reshape(-1), (ys * disk).reshape(-1)], -1).astype(np.float32)


@functools.lru_cache()
def _binned_sample_index(n_bins: int = N_ANGLE_BINS) -> np.ndarray:
    """(n_bins, 512) flat patch index of each BRIEF sample point under
    each quantized steering rotation (rotate, then round, then clip —
    the rule of the JAX one-hot sampling matrix)."""
    pat = brief_pattern().reshape(N_BITS * 2, 2)
    out = np.zeros((n_bins, N_BITS * 2), np.int64)
    for b in range(n_bins):
        th = 2.0 * np.pi * b / n_bins
        ca, sa = np.cos(th), np.sin(th)
        rx = np.round(pat[:, 0] * ca - pat[:, 1] * sa).astype(np.int64)
        ry = np.round(pat[:, 0] * sa + pat[:, 1] * ca).astype(np.int64)
        rx = np.clip(rx, -HALF_PATCH, HALF_PATCH)
        ry = np.clip(ry, -HALF_PATCH, HALF_PATCH)
        out[b] = (ry + HALF_PATCH) * _PATCH + (rx + HALF_PATCH)
    return out


_offsets_table = device_constant(_circular_offsets)
_pattern_table = device_constant(brief_pattern)
_moment_table = device_constant(_moment_weights)
_sample_index_table = device_constant(_binned_sample_index)


def ic_angle(img: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle at the rounded keypoint coords.

    img: (H, W) float32, uv: (N, 2) [x, y] (level-local pixels), valid:
    (N,) bool. Returns (N,) float32 radians in [-pi, pi], 0 where not
    valid. The disk is clamped at the image border."""
    offs = _offsets_table(device=img.device)  # (P, 2) dy, dx
    h, w = img.shape
    x0 = torch.round(uv[:, 0]).to(torch.int64)
    y0 = torch.round(uv[:, 1]).to(torch.int64)
    ys = (y0[:, None] + offs[None, :, 0]).clamp(0, h - 1)  # (N, P)
    xs = (x0[:, None] + offs[None, :, 1]).clamp(0, w - 1)
    patch = img[ys, xs]
    m01 = torch.sum(patch * offs[None, :, 0].to(img.dtype), dim=1)
    m10 = torch.sum(patch * offs[None, :, 1].to(img.dtype), dim=1)
    return torch.where(valid, torch.atan2(m01, m10), torch.zeros_like(m01))


def steered_brief(img_blurred: torch.Tensor, uv: torch.Tensor, angle: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
    """Rotation-steered BRIEF-256 on a blurred (H, W) image: each sample
    pair of the pattern rotated by the keypoint's angle, rounded
    (cvRound, half to even here as in JAX) and clamped to the image.
    uv (N, 2) [x, y], angle (N,) radians -> (N, 8) int32 words."""
    pat = _pattern_table(device=img_blurred.device)  # (256, 4)
    h, w = img_blurred.shape
    ca = torch.cos(angle)[:, None]
    sa = torch.sin(angle)[:, None]
    x0 = torch.round(uv[:, 0]).to(torch.int64)[:, None]
    y0 = torch.round(uv[:, 1]).to(torch.int64)[:, None]
    vals = []
    for k in (0, 1):
        px, py = pat[None, :, 2 * k], pat[None, :, 2 * k + 1]
        rx = torch.round(px * ca - py * sa).to(torch.int64)
        ry = torch.round(px * sa + py * ca).to(torch.int64)
        vals.append(img_blurred[(y0 + ry).clamp(0, h - 1), (x0 + rx).clamp(0, w - 1)])
    return pack_bits(vals[0] < vals[1], valid)


def extract_patches(img: torch.Tensor, uv: torch.Tensor, half: int = HALF_PATCH) -> torch.Tensor:
    """(2*half+1)^2 patches of the bf16-rounded image at rounded keypoint
    coords, clamped at the borders. img (H, W), uv (N, 2) -> (N, P, P)."""
    h, w = img.shape
    offs = torch.arange(-half, half + 1, device=img.device)
    x0 = torch.round(uv[:, 0]).to(torch.int64)
    y0 = torch.round(uv[:, 1]).to(torch.int64)
    ys = (y0[:, None] + offs[None, :]).clamp(0, h - 1)
    xs = (x0[:, None] + offs[None, :]).clamp(0, w - 1)
    imgb = img.to(torch.bfloat16).to(torch.float32)
    return imgb[ys[:, :, None], xs[:, None, :]]


def ic_angle_from_patches(patches: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle from (N, 31, 31) raw patches."""
    w = _moment_table(device=patches.device)
    flat = patches.reshape(patches.shape[0], -1).to(torch.bfloat16).to(torch.float32)
    m = flat @ w  # (N, 2) [m10, m01]
    return torch.where(valid, torch.atan2(m[:, 1], m[:, 0]), torch.zeros_like(m[:, 0]))


def blur_patches(patches: torch.Tensor) -> torch.Tensor:
    """Valid-mode 7x7 sigma-2 Gaussian on (N, 37, 37) patches -> (N, 31, 31),
    rounded like the reference's CV_8U blur output."""
    k = gaussian_kernel1d(7, 2.0)
    out = conv1d_axis(patches, k, axis=1)
    return torch.round(conv1d_axis(out, k, axis=2))


def quantize_angle(angle: torch.Tensor, n_bins: int = N_ANGLE_BINS) -> torch.Tensor:
    """Nearest steering bin (int64 in [0, n_bins))."""
    step = 2.0 * np.pi / n_bins
    return torch.remainder(torch.round(angle / step).to(torch.int32), n_bins).to(torch.int64)


def pack_bits(bits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(N, 256) 0/1 -> (N, 8) int32 words holding uint32 bit patterns
    (bit b of word w = bit w*32+b)."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(bits.reshape(bits.shape[0], 8, 32).to(torch.int64) << shifts, dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    return torch.where(valid[:, None], words, torch.zeros_like(words))


def binned_brief(patches: torch.Tensor, angle: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF-256 from (N, 31, 31) blurred patches with the
    rotation quantized to N_ANGLE_BINS bins -> (N, 8) int32."""
    n = patches.shape[0]
    idx = _sample_index_table(device=patches.device)  # (bins, 512)
    flat = patches.reshape(n, _PATCH * _PATCH).to(torch.bfloat16).to(torch.float32)
    sel = torch.gather(flat, 1, idx[quantize_angle(angle)])  # (N, 512)
    bits = sel[:, 0::2] < sel[:, 1::2]
    return pack_bits(bits, valid)
