"""The benchmark's renderer: a frozen copy of the port's on-card
ray-caster (`io/device_render.py`), so that a later change to the port's
renderer does not move the yardstick. A CPU test holds it equal to the
port's at a small size.

One change: `noise_seed` keys the depth noise (the port keys it by the
texture seed alone), so that a run's `--seed` draws the noise while the
room's texture stays the configuration's.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _hash2(ix: torch.Tensor, iy: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """Integer lattice hash -> [0, 1) float32, in uint32 wrap arithmetic
    (int64 tensors masked to 32 bits; negative inputs wrap to their
    uint32 image). `seed` may be a per-pixel tensor."""
    ix, iy, seed = (x.to(torch.int64) & _M32 for x in (ix, iy, seed))
    h = ((ix * 374761393) & _M32) + ((iy * 668265263) & _M32) + ((seed * 144665461) & _M32)
    h = h & _M32
    h = ((h ^ (h >> 13)) * 1274126177) & _M32
    h = h ^ (h >> 16)
    return (h & 0xFFFFFF).to(torch.float32) / float(0x1000000)


def _value_noise(x, y, scale: float, seed):
    fx = x / scale
    fy = y / scale
    ix = torch.floor(fx).to(torch.int32)
    iy = torch.floor(fy).to(torch.int32)
    tx = fx - ix
    ty = fy - iy
    v00 = _hash2(ix, iy, seed)
    v10 = _hash2(ix + 1, iy, seed)
    v01 = _hash2(ix, iy + 1, seed)
    v11 = _hash2(ix + 1, iy + 1, seed)
    return v00 * (1 - tx) * (1 - ty) + v10 * tx * (1 - ty) + v01 * (1 - tx) * ty + v11 * tx * ty


def _texture(u, v, s):
    """Gray texture in [0, 255]; `s` is the per-pixel face seed."""
    def cells_at(pitch, ds):
        return _hash2(torch.floor(u / pitch).to(torch.int32),
                      torch.floor(v / pitch).to(torch.int32), s + ds)

    t = 0.34 * cells_at(0.25, 0) + 0.22 * cells_at(0.08, 4) + 0.12 * cells_at(0.03, 5)
    t = t + 0.22 * _value_noise(u, v, 0.40, s + 1)
    t = t + 0.10 * _value_noise(u, v, 0.10, s + 2)
    return 30.0 + 200.0 * t


def _render_once(T_wc, du, dv, cam, size_v, boxes_arr, seed: int,
                 box_gray_arr=None, n_static=None):
    """Point-sampled renders of F poses T_wc (F, 4, 4) at P sub-pixel
    offsets du, dv (P,) in a room of extent `size_v` (3,): (gray (F, P, H,
    W), depth (F, P, H, W)). Walls and boxes are batched (slab method over
    each frame's boxes, boxes_arr (F, B, 2, 3))."""
    h, w = cam.height, cam.width
    n = T_wc.shape[0]
    dev = T_wc.device
    f32 = torch.float32
    u = torch.arange(w, dtype=f32, device=dev)[None, None, :] + du[:, None, None]
    v = torch.arange(h, dtype=f32, device=dev)[None, :, None] + dv[:, None, None]
    dx = ((u - cam.cx) / cam.fx).expand(-1, h, w)
    dy = ((v - cam.cy) / cam.fy).expand(-1, h, w)
    dz = torch.ones_like(dx)
    E = (None,) * 3  # the (P, H, W) pixel dims
    R = T_wc[:, :3, :3][(...,) + E]  # (F, 3, 3, 1, 1, 1)
    o = T_wc[:, :3, 3].T  # (3, F)
    # (3, F, P, H, W)
    dirs = torch.stack([R[:, i, 0] * dx + R[:, i, 1] * dy + R[:, i, 2] * dz for i in range(3)])
    denom = torch.where(torch.abs(dirs) < 1e-9, torch.full_like(dirs, 1e-9), dirs)

    # Room walls, seen from inside: 6 faces (axis a, side s); t = (bound -
    # o_a) / d_a, in bounds on the other two coordinates.
    bound = torch.stack([torch.zeros(3, dtype=f32, device=dev), size_v], dim=1)  # (3, 2)
    t_wall = (bound[:, :, None][(...,) + E]
              - o[:, None][(...,) + E]) / denom[:, None]  # (3, 2, F, P, H, W)
    # (3 coordinates, 3 axes, 2 sides, F, P, H, W)
    hitw = o[:, None, None][(...,) + E] + t_wall[None] * dirs[:, None, None]
    inb = (hitw >= -1e-4) & (hitw <= size_v[(slice(None),) + (None,) * 6] + 1e-4)
    not_self = ~torch.eye(3, dtype=torch.bool, device=dev)  # (coord, axis)
    ok_w = (t_wall > 1e-6) & torch.all(inb | ~not_self[(...,) + (None,) * 5], dim=0)
    t_w = torch.where(ok_w, t_wall, torch.full_like(t_wall, float("inf"))).reshape(6, *dirs.shape[1:])
    wall_face = torch.argmin(t_w, dim=0)  # the first of equal values, as in XLA
    t_wall_best = torch.amin(t_w, dim=0)
    wall_axis = wall_face // 2

    # Boxes, seen from outside: slab method over (B,).
    bmin = boxes_arr[:, :, 0]  # (F, B, 3)
    bmax = boxes_arr[:, :, 1]
    o_b = o[None][(...,) + E]  # (1, 3, F, 1, 1, 1)
    t1 = (bmin.permute(1, 2, 0)[(...,) + E] - o_b) / denom[None]  # (B, 3, F, P, H, W)
    t2 = (bmax.permute(1, 2, 0)[(...,) + E] - o_b) / denom[None]
    tlo = torch.minimum(t1, t2)
    thi = torch.maximum(t1, t2)
    tnear = torch.amax(tlo, dim=1)  # (B, F, P, H, W)
    tfar = torch.amin(thi, dim=1)
    enter_axis = torch.argmax(tlo, dim=1)
    hit_ok = (tnear > 1e-6) & (tnear <= tfar)
    t_b = torch.where(hit_ok, tnear, torch.full_like(tnear, float("inf")))
    bi = torch.argmin(t_b, dim=0)  # (F, P, H, W)
    t_box_best = torch.amin(t_b, dim=0)
    box_axis = torch.gather(enter_axis, 0, bi[None])[0]

    box_wins = t_box_best < t_wall_best
    t_best = torch.where(box_wins, t_box_best, t_wall_best)
    finite = torch.isfinite(t_best)
    face_best = torch.where(box_wins, 6 + bi * 3 + box_axis, wall_face)
    face_best = torch.where(finite, face_best, torch.full_like(face_best, -1))
    axis_best = torch.where(box_wins, box_axis, wall_axis)

    # Texture: one evaluation with per-pixel plane coordinates and seed.
    hit = o[(...,) + E] + t_best[None] * dirs  # (3, F, P, H, W)
    uc = torch.where(axis_best == 0, hit[1], hit[0])
    vc = torch.where(axis_best <= 1, hit[2], hit[1])
    if n_static is not None and boxes_arr.shape[1] > n_static:
        # Moving boxes (index >= n_static) carry their texture with them,
        # anchored at their own min corner, so that flow and the tracker
        # see them move; static boxes keep the world-anchored texture.
        sel = bi.reshape(n, -1, 1).expand(-1, -1, 3)
        bmin_sel = torch.gather(bmin, 1, sel).reshape(*bi.shape, 3)  # (F, P, H, W, 3)
        moving = box_wins & (bi >= n_static)
        off_u = torch.where(axis_best == 0, bmin_sel[..., 1], bmin_sel[..., 0])
        off_v = torch.where(axis_best <= 1, bmin_sel[..., 2], bmin_sel[..., 1])
        uc = torch.where(moving, uc - off_u, uc)
        vc = torch.where(moving, vc - off_v, vc)
    s = torch.where(face_best >= 0, seed * 7 + face_best, torch.zeros_like(face_best))
    gray = _texture(uc, vc, s)
    if box_gray_arr is not None:
        flat = box_gray_arr[bi]
        gray = torch.where(box_wins & (flat >= 0), flat, gray)
    depth = torch.where(finite, t_best, torch.zeros_like(t_best))
    return gray, depth


def _chunk_frames(device: torch.device, n_boxes: int, rays_per_frame: int) -> int:
    """Frames per `_render_once` call. Its largest intermediates are
    about six live (B, 3, F, P, H, W) float32 stacks (the slab times and
    the wall hits); they get a quarter of the card's free memory, or
    1 GiB on the CPU."""
    per_frame = 6 * 3 * max(n_boxes, 6) * rays_per_frame * 4
    if device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0] // 4
    else:
        budget = 1 << 30
    return max(1, budget // per_frame)


def _noise_key(T_wc: np.ndarray) -> int:
    """The integer the JAX version folds into its key: from the camera
    position, in f32 as it computes it."""
    x = np.abs(np.float32(T_wc[0, 3]) * np.float32(1e4)) + np.abs(
        np.float32(T_wc[2, 3]) * np.float32(1e2))
    return int(np.int32(x))


def render_frames(poses_wc, cam, size, boxes, seed: int = 17, ss: int = 3,
                  depth_noise: float = 0.0, box_gray=None, moving_boxes=None, moving_gray=None,
                  device=None, noise_seed: int | None = None):
    """Render N frames on `device` (the port's takes its own device
    default).

    poses_wc: (N, 4, 4) camera-to-world, numpy or tensor. Returns (grays
    (N, H, W) uint8, depths (N, H, W) uint16 millimetres), the compact
    dtypes the scan tracker consumes. `ss` supersamples the gray channel
    (box filter; anti-aliasing keeps FAST corners viewpoint-stable); depth
    takes the centre ray, like a depth camera. `depth_noise`: Kinect-like
    multiplicative Gaussian depth noise, sigma = depth_noise * z.
    `box_gray`: optional per-box flat gray levels (-1 = textured).
    `moving_boxes`: optional (N, M, 2, 3) per-frame boxes of MOVING
    objects (the walkers of TUM fr3_walking), textured with their own
    anchor so the pattern moves with them; `moving_gray`: their flat
    levels, as `box_gray`. `noise_seed` (default `seed`; under 2**31)
    keys the depth noise."""
    device = torch.device(device)
    poses_np = (poses_wc.detach().cpu().numpy() if torch.is_tensor(poses_wc)
                else np.asarray(poses_wc)).astype(np.float32)
    poses = torch.as_tensor(poses_np).to(device)
    boxes_arr = torch.tensor(np.asarray(boxes, np.float32), device=device)  # (B, 2, 3)
    size_v = torch.tensor(np.asarray(size, np.float32), device=device)
    n_static = boxes_arr.shape[0]
    mb = None
    if moving_boxes is not None:
        mb = torch.as_tensor(np.asarray(moving_boxes, np.float32)).to(device)  # (N, M, 2, 3)
    box_gray_arr = None
    if box_gray is not None or moving_gray is not None:
        g_static = tuple(box_gray) if box_gray is not None else (-1.0,) * n_static
        g_moving = ()
        if mb is not None:
            g_moving = tuple(moving_gray) if moving_gray is not None else (-1.0,) * mb.shape[1]
        box_gray_arr = torch.tensor(g_static + g_moving, dtype=torch.float32, device=device)

    offs = np.asarray([((ix + 0.5) / ss - 0.5, (iy + 0.5) / ss - 0.5)
                       for iy in range(ss) for ix in range(ss)] + [(0.0, 0.0)], np.float32)
    du = torch.as_tensor(offs[:, 0]).to(device)
    dv = torch.as_tensor(offs[:, 1]).to(device)
    n = poses.shape[0]
    n_boxes = n_static + (0 if mb is None else mb.shape[1])
    chunk = _chunk_frames(device, n_boxes, du.shape[0] * cam.height * cam.width)
    grays, depths = [], []
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        all_boxes = boxes_arr.expand(hi - lo, -1, -1, -1)
        if mb is not None:
            all_boxes = torch.cat([all_boxes, mb[lo:hi]], dim=1)
        g, d = _render_once(poses[lo:hi], du, dv, cam, size_v, all_boxes, seed, box_gray_arr,
                            n_static=n_static)
        gray = g[:, :-1].mean(dim=1)
        depth = d[:, -1]  # the centre ray
        if depth_noise > 0.0:
            z = torch.empty_like(depth)
            for j in range(hi - lo):
                key = (((seed if noise_seed is None else noise_seed) << 32)
                       | (_noise_key(poses_np[lo + j]) & 0xFFFFFFFF))
                gen = torch.Generator(device=device).manual_seed(key)
                z[j] = torch.randn(depth.shape[1:], generator=gen, device=device)
            depth = depth * (1.0 + depth_noise * z)
        grays.append(torch.clamp(gray, 0, 255).to(torch.uint8))
        depths.append(torch.clamp(depth * 1000.0, 0, 65535).to(torch.int32))
    # Stacked as int32 and converted once: uint16 has few CUDA kernels.
    return torch.cat(grays), torch.cat(depths).to(torch.uint16)
