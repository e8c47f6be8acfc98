"""Pinhole camera model on tensors: the intrinsics matrix, projection,
back-projection, distortion and undistortion (counterpart of the JAX
package's `geometry/camera.py`)."""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import device_constant


@device_constant
def _pinhole(fx: float, fy: float, cx: float, cy: float, dtype: torch.dtype) -> torch.Tensor:
    k = [[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]]
    return torch.from_numpy(np.array(k)).to(dtype)


def intrinsics_matrix(cam: CameraConfig, dtype=torch.float32, device=None) -> torch.Tensor:
    """The 3x3 pinhole matrix K, built once per device and shared (never
    written into)."""
    return _pinhole(cam.fx, cam.fy, cam.cx, cam.cy, dtype, device=device)


def project(pts_cam: torch.Tensor, cam: CameraConfig):
    """Camera-frame points (..., 3) -> (uv (..., 2), z (...,)).
    Callers gate on z > 0 themselves."""
    z = pts_cam[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * pts_cam[..., 0] / z_safe + cam.cx
    v = cam.fy * pts_cam[..., 1] / z_safe + cam.cy
    return torch.stack([u, v], dim=-1), z


def backproject(uv: torch.Tensor, depth: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Pixel coords (..., 2) + depth (...,) -> camera-frame points (..., 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def in_image(uv: torch.Tensor, cam: CameraConfig, border: float = 0.0) -> torch.Tensor:
    """(..., 2) -> bool mask of points inside the image bounds."""
    u, v = uv[..., 0], uv[..., 1]
    return (u >= border) & (u < cam.width - border) & (v >= border) & (v < cam.height - border)


def distort(uv_norm: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Apply radial/tangential distortion to normalized coords (..., 2)."""
    x, y = uv_norm[..., 0], uv_norm[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_points(uv: torch.Tensor, cam: CameraConfig, iters: int = 5) -> torch.Tensor:
    """Fixed-point undistortion of pixel coords (..., 2); no-op when all
    distortion coefficients are zero."""
    if cam.k1 == 0.0 and cam.k2 == 0.0 and cam.p1 == 0.0 and cam.p2 == 0.0 and cam.k3 == 0.0:
        return uv
    xn = (uv[..., 0] - cam.cx) / cam.fx
    yn = (uv[..., 1] - cam.cy) / cam.fy
    x, y = xn, yn
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 * r2 * r2
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        x = (xn - dx) / radial
        y = (yn - dy) / radial
    return torch.stack([x * cam.fx + cam.cx, y * cam.fy + cam.cy], dim=-1)


def stereo_right_u(uv: torch.Tensor, depth: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Virtual right-camera u from RGB-D depth: u - bf/z, else -1."""
    has = depth > 1e-6
    z_safe = torch.where(has, depth, torch.ones_like(depth))
    return torch.where(has, uv[..., 0] - cam.depth_bf / z_safe, torch.full_like(depth, -1.0))
