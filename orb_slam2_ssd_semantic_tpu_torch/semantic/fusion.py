"""2D-detection -> 3D-cluster fusion (counterpart of the JAX package's
`semantic/fusion.py`). Two schemes, mirroring the reference:

1. `fuse_depth_window` — Merge2d3d (perfect/src/Merge2d3d.cc:30-131): for
   each detection above the probability gate, the mean depth over the
   central 30-70% of the box, then the pixels within +-0.2 m of it over
   the central 20-80%, back-projected to world and reduced to centroid and
   extents. The detections are a leading dimension of every mask (the JAX
   version `vmap`s over them).
2. `segment_objects` / `fuse_segmentation` — MergeSG
   (perfect/src/MergeSG.cc): plane removal by a normal/offset histogram,
   connected components by iterated 4-neighbour label min-propagation,
   then greedy matching of detection boxes to cluster ROIs by the
   reference's IoU x average diagonal / centre distance.

Copied from the JAX version as it is: `jnp.roll`'s wrap-around at the
image edge (normals and label propagation), and the `labels % B` hashing
of clusters into B + 1 bins with its collisions. The bin sums are
`index_add_` and the bin extremes `scatter_reduce_` ("amin"/"amax"), which
have deterministic CUDA versions (the entry points run under
`torch.use_deterministic_algorithms`). Both return fixed-capacity
candidate clusters for `object_db.add_objects`.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch.config import CameraConfig, SemanticConfig
from orb_slam2_ssd_semantic_tpu_torch.geometry import se3
from orb_slam2_ssd_semantic_tpu_torch.semantic.detector import Detections
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import f32_reciprocal


def _grid(h: int, w: int, device):
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return ys, xs


def _camera_cloud(depth_img: torch.Tensor, cam: CameraConfig) -> torch.Tensor:
    """Organized camera-frame cloud (H, W, 3). The division by the focal
    length is a product with its f32 reciprocal, as XLA compiles it in the
    JAX version: the normals' signs and bins follow these last bits."""
    h, w = depth_img.shape
    ys, xs = _grid(h, w, depth_img.device)
    zc = depth_img
    xc = (xs - cam.cx) * f32_reciprocal(cam.fx) * zc
    yc = (ys - cam.cy) * f32_reciprocal(cam.fy) * zc
    return torch.stack([xc, yc, zc], -1)  # (H, W, 3)


def _world_cloud(depth_img: torch.Tensor, T_cw: torch.Tensor, cam: CameraConfig):
    h, w = depth_img.shape
    T_wc = se3.se3_inverse(T_cw)
    return se3.transform_points(T_wc, _camera_cloud(depth_img, cam).reshape(-1, 3)).reshape(h, w, 3)


def fuse_depth_window(det: Detections, depth_img: torch.Tensor, T_cw: torch.Tensor,
                      cam: CameraConfig, cfg: SemanticConfig = SemanticConfig()):
    """Per-detection 3D clusters via the depth-window rule.

    Returns (centroids (D, 3) world, sizes (D, 3), probs (D,), classes (D,),
    valid (D,))."""
    h, w = depth_img.shape
    ys, xs = _grid(h, w, depth_img.device)
    x1, y1, x2, y2 = (v[:, None, None] for v in det.boxes.unbind(-1))
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)
    has_depth = depth_img > 1e-3

    def window(lo: float, hi: float):
        return ((xs >= x1 + lo * bw) & (xs <= x1 + hi * bw)
                & (ys >= y1 + lo * bh) & (ys <= y1 + hi * bh))

    # Central 30-70% window for the depth estimate (Merge2d3d.cc:55-78).
    in_mid = window(0.3, 0.7) & has_depth
    n_mid = torch.clamp(in_mid.sum((1, 2)).to(torch.float32), min=1.0)
    d_mean = (depth_img * in_mid).sum((1, 2)) / n_mid
    # Collection region: central 20-80%, depth within +-window
    # (Merge2d3d.cc:79-97).
    in_box = (window(0.2, 0.8)
              & (torch.abs(depth_img - d_mean[:, None, None]) < cfg.fusion_depth_window)
              & has_depth)
    n = in_box.sum((1, 2))
    sel = in_box.to(torch.float32).reshape(in_box.shape[0], -1)  # (D, H*W)
    pts_w = _world_cloud(depth_img, T_cw, cam).reshape(-1, 3)
    n_safe = torch.clamp(n.to(torch.float32), min=1.0)
    centroid = (sel @ pts_w) / n_safe[:, None]
    # Extents via selected min/max (Merge2d3d.cc:114-131).
    big = 1e9
    picked = in_box.reshape(in_box.shape[0], -1, 1)
    mins = torch.where(picked, pts_w, big).amin(1)
    maxs = torch.where(picked, pts_w, -big).amax(1)
    size = torch.clamp(maxs - mins, min=0.0)
    good = det.valid & (det.scores > cfg.fusion_prob_threshold) & (n > 50)
    return centroid, size, det.scores, det.classes, good


def fuse_detections(det: Detections, depth_img: torch.Tensor, T_cw: torch.Tensor,
                    cam: CameraConfig, cfg: SemanticConfig = SemanticConfig()):
    """The keyframe fusion entry: dispatches on `cfg.fusion_scheme` —
    "depth_window" (Merge2d3d) or "merge_sg" (the scheme the reference
    compiles in, MapDrawer.cc:79)."""
    if cfg.fusion_scheme == "merge_sg":
        return fuse_segmentation(det, depth_img, T_cw, cam, cfg)
    return fuse_depth_window(det, depth_img, T_cw, cam, cfg)


def estimate_normals(depth_img: torch.Tensor, cam: CameraConfig):
    """Organized surface normals: the cross product of the organized
    cloud's horizontal and vertical central differences (wrapping at the
    image edge, as `jnp.roll` does), oriented toward the camera
    (MergeSG::estimateNormal, MergeSG.cc:322-336).

    Returns (normals (H, W, 3) unit, valid (H, W))."""
    P = _camera_cloud(depth_img, cam)
    dx = torch.roll(P, -1, 1) - torch.roll(P, 1, 1)
    dy = torch.roll(P, -1, 0) - torch.roll(P, 1, 0)
    n = torch.linalg.cross(dy, dx, dim=-1)
    nn = torch.linalg.vector_norm(n, dim=-1)
    valid = ((depth_img > 1e-3) & (torch.abs(dx[..., 2]) < 0.1)
             & (torch.abs(dy[..., 2]) < 0.1) & (nn > 1e-9))
    n = n / torch.clamp(nn, min=1e-9)[..., None]
    flip = torch.sum(n * P, -1) > 0
    n = torch.where(flip[..., None], -n, n)
    return n, valid


# 26 quantization directions for plane-normal binning: all sign/axis
# combinations of {-1,0,1}^3 minus the origin, normalized.
_DIRS = np.array(
    [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
     if (i, j, k) != (0, 0, 0)],
    np.float32,
)
_DIRS /= np.linalg.norm(_DIRS, axis=1, keepdims=True)
_N_DIRS = len(_DIRS)  # 26
_D_BINS = 128  # plane-offset bins
_D_RANGE = 8.0  # meters


def _bin_count(bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """int32 counts of `bins` (any shape) over [0, n_bins)."""
    flat = bins.reshape(-1).to(torch.int64)
    return torch.zeros(n_bins, dtype=torch.int32, device=bins.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))


def segment_planes(depth_img: torch.Tensor, cam: CameraConfig,
                   cfg: SemanticConfig = SemanticConfig()):
    """Organized multi-plane segmentation (MergeSG::segmentPlanes,
    MergeSG.cc:338-365): every pixel votes its local plane (quantized
    normal direction x plane offset d = n.p) into a (26, 128) accumulator;
    bins with >= seg_min_plane_inliers supporters are planes, and their
    pixels are masked out.

    Returns (plane_mask (H, W) bool, normals, normal_valid)."""
    normals, nvalid = estimate_normals(depth_img, cam)
    P = _camera_cloud(depth_img, cam)
    dirs = torch.as_tensor(_DIRS).to(depth_img.device)  # (26, 3)
    dots = normals @ dirs.T  # (H, W, 26)
    dbin = torch.argmax(dots, dim=-1)
    ang_ok = torch.amax(dots, dim=-1) > 0.9
    off = torch.sum(normals * P, -1)  # signed plane offset
    obin = torch.clamp(((off / _D_RANGE + 1.0) * 0.5 * _D_BINS).to(torch.int32), 0, _D_BINS - 1)
    ok = nvalid & ang_ok
    flat_bin = torch.where(ok, dbin * _D_BINS + obin, _N_DIRS * _D_BINS)
    hist = _bin_count(flat_bin, _N_DIRS * _D_BINS + 1)
    is_plane_bin = hist >= cfg.seg_min_plane_inliers
    plane_mask = ok & is_plane_bin[flat_bin]
    return plane_mask, normals, nvalid


def segment_objects(depth_img: torch.Tensor, cam: CameraConfig = CameraConfig(),
                    cfg: SemanticConfig = SemanticConfig(), n_iters: int = 64):
    """Object-candidate segmentation on the organized depth image
    (MergeSG::segment, MergeSG.cc:295-408): plane removal
    (`segment_planes`), connected components over the remaining
    depth-continuous pixels (`n_iters` rounds of 4-neighbour label
    min-propagation, wrapping at the edges), and a cluster-size gate over
    4096 hashed label bins.

    Returns labels (H, W) int32 with -1 = background/plane."""
    h, w = depth_img.shape
    plane_mask, _, _ = segment_planes(depth_img, cam, cfg)
    valid = (depth_img > 1e-3) & ~plane_mask
    idx = (torch.arange(h * w, dtype=torch.int32, device=depth_img.device).reshape(h, w) + 1) \
        * valid
    shifts = ((0, 1), (0, -1), (1, 0), (-1, 0))
    # The neighbour's depth gate does not change between rounds.
    linked = [valid & (torch.abs(torch.roll(depth_img, s, (0, 1)) - depth_img) < 0.05)
              for s in shifts]
    lab = idx
    for _ in range(n_iters):
        out = lab
        for s, ok_d in zip(shifts, linked):
            nb = torch.roll(lab, s, (0, 1))
            ok = ok_d & (nb > 0)
            out = torch.where(ok & (nb < out), nb, out)
        lab = torch.where(valid, out, 0)
    labels = lab
    # Size gate over a hashed label space.
    B = 4096
    hid = torch.where(valid, labels % B, B)
    n = _bin_count(hid, B + 1)
    too_small = n < cfg.seg_min_cluster_size // 4
    keep = ~too_small[torch.clamp(hid, 0, B).to(torch.int64)]
    return torch.where(valid & keep, labels - 1, -1)


def fuse_segmentation(det: Detections, depth_img: torch.Tensor, T_cw: torch.Tensor,
                      cam: CameraConfig, cfg: SemanticConfig = SemanticConfig()):
    """MergeSG fusion: plane-free euclidean clusters, each back-projected
    to its 2D ROI, greedily matched to detection boxes by the reference's
    score IoU x avgDiagonal / centerDistance
    (MergeSG::findMaxIntersectionRelationships + getMatch,
    MergeSG.cc:164-233, 270-290); a matched cluster is marked used, so two
    detections cannot claim one (MergeSG.cc:231). The detections go in
    order, as the JAX version's `lax.scan`, with no host sync."""
    h, w = depth_img.shape
    dev = depth_img.device
    labels = segment_objects(depth_img, cam, cfg)
    ys, xs = _grid(h, w, dev)
    pts_w = _world_cloud(depth_img, T_cw, cam)

    # Per-cluster stats over a hashed label space: pixel ROI and world
    # extents (MergeSG.cc:241-267, 452-463).
    B = 1024
    hid = torch.where(labels >= 0, labels % B, B).reshape(-1).to(torch.int64)
    big = 1e9

    def smin(v):
        return torch.full((B + 1,), big, device=dev).scatter_reduce_(
            0, hid, v.reshape(-1), "amin", include_self=True)

    def smax(v):
        return torch.full((B + 1,), -big, device=dev).scatter_reduce_(
            0, hid, v.reshape(-1), "amax", include_self=True)

    def ssum(v):
        return torch.zeros((B + 1,), device=dev).index_add_(0, hid, v.reshape(-1))

    sel = (labels >= 0).to(torch.float32)
    cnt = ssum(sel)
    xs_b, ys_b = xs.expand(h, w), ys.expand(h, w)
    rx1, rx2 = smin(xs_b), smax(xs_b)
    ry1, ry2 = smin(ys_b), smax(ys_b)
    wmin = torch.stack([smin(pts_w[..., i]) for i in range(3)], -1)  # (B+1, 3)
    wmax = torch.stack([smax(pts_w[..., i]) for i in range(3)], -1)
    wsum = torch.stack([ssum(pts_w[..., i] * sel) for i in range(3)], -1)
    bins = torch.arange(B + 1, device=dev)
    cluster_ok = (cnt >= cfg.seg_min_cluster_size // 4) & (bins < B)

    def match_score(box, used):
        """(B+1,) reference match score of this detection vs every cluster."""
        x1, y1, x2, y2 = box.unbind()
        ix1 = torch.maximum(x1, rx1)
        iy1 = torch.maximum(y1, ry1)
        ix2 = torch.minimum(x2, rx2)
        iy2 = torch.minimum(y2, ry2)
        inter = torch.clamp(ix2 - ix1, min=0.0) * torch.clamp(iy2 - iy1, min=0.0)
        area_b = torch.clamp((x2 - x1) * (y2 - y1), min=1.0)
        area_r = torch.clamp((rx2 - rx1) * (ry2 - ry1), min=0.0)
        iou = inter / torch.clamp(area_b + area_r - inter, min=1.0)
        diag_b = torch.sqrt((x2 - x1) ** 2 + (y2 - y1) ** 2)
        diag_r = torch.sqrt(torch.clamp(rx2 - rx1, min=0.0) ** 2
                            + torch.clamp(ry2 - ry1, min=0.0) ** 2)
        cbx, cby = (x1 + x2) / 2, (y1 + y2) / 2
        crx, cry = (rx1 + rx2) / 2, (ry1 + ry2) / 2
        dist = torch.sqrt((cbx - crx) ** 2 + (cby - cry) ** 2)
        score = iou * 0.5 * (diag_b + diag_r) / torch.clamp(dist, min=1.0)
        return torch.where(cluster_ok & ~used, score, -1.0)

    used = torch.zeros((B + 1,), dtype=torch.bool, device=dev)
    js, goods = [], []
    for d in range(det.boxes.shape[0]):
        s = match_score(det.boxes[d], used)
        j = torch.argmax(s)
        good = det.valid[d] & (det.scores[d] > cfg.fusion_prob_threshold) & (torch.amax(s) > 0.0)
        used = used | ((bins == j) & good)
        js.append(j)
        goods.append(good)
    j = torch.stack(js)
    n_safe = torch.clamp(cnt[j], min=1.0)
    centroids = wsum[j] / n_safe[:, None]
    sizes = torch.clamp(wmax[j] - wmin[j], min=0.0)
    return centroids, sizes, det.scores, det.classes, torch.stack(goods)
