"""Depth-to-color registration and image undistortion for live cameras
(counterpart of the JAX package's `ops/register.py`).

The reference's live executable re-registers the depth sensor's image into
the color camera's frame on the host per frame (perfect/Examples/RGB-D/
my_rgbd.cc: TY SDK `doRegister`/undistortion before TrackRGBD). Here both
are tensor programs on the device: registration is a forward warp with a
scatter-min on z (the nearest surface wins occlusions; a minimum does not
depend on the order of the writes, so deterministic mode needs no sort),
and undistortion is one bilinear gather over an inverse map.

A numpy input goes to `device` (default: the card, raising without one);
a tensor input stays on its own device.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig
from orb_slam2_ssd_semantic_tpu_torch.geometry import camera as cam_ops
from orb_slam2_ssd_semantic_tpu_torch.ops.image import bilinear_sample
from orb_slam2_ssd_semantic_tpu_torch.utils import precision


def _tensor(a, device) -> torch.Tensor:
    if torch.is_tensor(a):
        return a
    return torch.as_tensor(np.ascontiguousarray(a)).to(device_mod.resolve(device))


def _pixel_grid(h: int, w: int, device):
    """(v, u) float32 pixel coordinates of an (h, w) image."""
    return torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")


@precision.scoped
def register_depth_to_color(depth, T_cd, cam_d: CameraConfig, cam_c: CameraConfig,
                            out_h: int, out_w: int, device=None) -> torch.Tensor:
    """Forward-warp the depth image (Hd, Wd) in metres (0 = invalid) into
    the color camera's (out_h, out_w) pixel grid: every depth pixel
    backprojects through cam_d, moves through T_cd (4, 4, depth camera ->
    color camera) and projects through cam_c to its rounded pixel; where
    several land on one pixel the smallest z wins. 0 where no depth
    landed."""
    depth = _tensor(depth, device).to(torch.float32)
    dev = depth.device
    T_cd = torch.as_tensor(T_cd, dtype=torch.float32).to(dev)
    hd, wd = depth.shape
    v, u = _pixel_grid(hd, wd, dev)
    uv = torch.stack([u.reshape(-1), v.reshape(-1)], dim=-1)
    z = depth.reshape(-1)
    p_d = cam_ops.backproject(uv, z, cam_d)
    p_c = p_d @ T_cd[:3, :3].T + T_cd[:3, 3]
    zc = p_c[:, 2]
    ok = (z > 0) & (zc > 1e-6)
    zc_safe = torch.clamp(zc, min=1e-6)
    uc = torch.round(cam_c.fx * p_c[:, 0] / zc_safe + cam_c.cx).to(torch.int64)
    vc = torch.round(cam_c.fy * p_c[:, 1] / zc_safe + cam_c.cy).to(torch.int64)
    ok &= (uc >= 0) & (uc < out_w) & (vc >= 0) & (vc < out_h)
    # Invalid rays land in a spare cell past the image.
    flat = torch.where(ok, vc * out_w + uc, torch.full_like(uc, out_h * out_w))
    inf = torch.tensor(float("inf"), device=dev)
    out = torch.full((out_h * out_w + 1,), float("inf"), device=dev)
    out.scatter_reduce_(0, flat, torch.where(ok, zc, inf), "amin", include_self=True)
    out = out[:-1].reshape(out_h, out_w)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


@precision.scoped
def undistort_image(img, cam: CameraConfig, device=None) -> torch.Tensor:
    """Undistort an (H, W) or (H, W, C) image by inverse mapping: each
    rectified pixel's normalized ray goes through `camera.distort` (the
    reference's cv::undistort role in my_rgbd.cc) and the raw image is
    sampled there bilinearly (0 outside). Returns float32."""
    img = _tensor(img, device)
    h, w = img.shape[0], img.shape[1]
    v, u = _pixel_grid(h, w, img.device)
    # As XLA compiles the JAX module: products with the f32 reciprocals for
    # the divisions by constants, and a fused multiply-add (one rounding,
    # here through float64) back to pixels. With no distortion the map is
    # then bit-equal to JAX's.
    xn = (u - cam.cx) * float(np.float32(1.0) / np.float32(cam.fx))
    yn = (v - cam.cy) * float(np.float32(1.0) / np.float32(cam.fy))
    uvd = cam_ops.distort(torch.stack([xn.reshape(-1), yn.reshape(-1)], dim=-1), cam)
    f = torch.tensor([cam.fx, cam.fy], dtype=torch.float32, device=img.device).double()
    c = torch.tensor([cam.cx, cam.cy], dtype=torch.float32, device=img.device).double()
    src = (uvd.double() * f + c).to(torch.float32)
    img = img.to(torch.float32)
    if img.dim() == 2:
        return bilinear_sample(img, src)[0].reshape(h, w)
    return torch.stack([bilinear_sample(img[..., c], src)[0].reshape(h, w)
                        for c in range(img.shape[-1])], dim=-1)
