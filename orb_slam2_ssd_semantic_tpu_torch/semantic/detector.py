"""Detection pipeline: preprocessing, the SSDLite forward, decode + NMS
(counterpart of the JAX package's `semantic/detector.py`; the reference's
Detector/RunDetect pair, perfect/src/Detector.cc:27-75,
RunDetect.cc:29-61).

Results land in fixed-capacity `Detections` with validity masks: the top
`max_detections` anchors by best class score, greedy class-aware NMS over
them, then the score gate. Nothing here waits on the device: the NMS loop
runs on tensors, with no `.item()` and no boolean indexing.
"""

from __future__ import annotations

import copy
import warnings
from typing import NamedTuple

import numpy as np
import torch

from orb_slam2_ssd_semantic_tpu_torch import device as device_mod
from orb_slam2_ssd_semantic_tpu_torch.config import SemanticConfig
from orb_slam2_ssd_semantic_tpu_torch.ops.image import resize_linear
from orb_slam2_ssd_semantic_tpu_torch.semantic.ssdlite import (
    decode_boxes,
    init_ssdlite,
    load_params,
    ssd_anchors,
)
from orb_slam2_ssd_semantic_tpu_torch.utils import precision
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import top_k


class Detections(NamedTuple):
    """Fixed-capacity per-image detections (Detector.h:14-20 Object)."""

    boxes: torch.Tensor  # (D, 4) [x1, y1, x2, y2] in source pixels
    scores: torch.Tensor  # (D,)
    classes: torch.Tensor  # (D,) int32 (VOC index, 0 = background)
    valid: torch.Tensor  # (D,) bool


def preprocess(rgb: torch.Tensor, size: int = 300) -> torch.Tensor:
    """(..., H, W, 3) uint8/float -> (..., size, size, 3) normalized like
    the reference (mean/std 127.5, Detector.cc:38-41). The resize is
    `jax.image.resize(..., "linear")`, which widens its kernel when it
    shrinks (antialiasing): `ops/image.resize_linear` on each channel."""
    x = rgb.to(torch.float32).movedim(-1, -3)
    img = resize_linear(x, size, size).movedim(-3, -1)
    return (img - 127.5) / 127.5


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(..., D, 4) -> (..., D, D) pairwise IoU."""
    a, b = boxes[..., :, None, :], boxes[..., None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms_fixed(boxes, scores, classes, top_k: int, iou_th: float):
    """Greedy class-aware NMS over a fixed `top_k` candidate set (leading
    dims are a batch): in score order (a stable sort, as `jnp.argsort`),
    box i is kept iff no KEPT higher-scored box of its class overlaps it
    above `iou_th`. Returns the sorted (boxes, scores, classes, keep)."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    scores = torch.gather(scores, -1, order)
    classes = torch.gather(classes, -1, order)
    iou = _iou_matrix(boxes)
    same = classes[..., :, None] == classes[..., None, :]
    ar = torch.arange(top_k, device=boxes.device)
    higher = ar[:, None] > ar[None, :]
    suppressed_by = (iou > iou_th) & same & higher
    keep = torch.ones(scores.shape, dtype=torch.bool, device=boxes.device)
    for i in range(top_k):
        sup = torch.any(suppressed_by[..., i, :] & keep, dim=-1)
        keep[..., i] = keep[..., i] & ~sup
    return boxes, scores, classes, keep


class Detector:
    """Owns the model's weights (and a bf16 copy for `detect_batch`) on
    `device` (default: the card, raising without one).

    `params`: a `state_dict` of `SSDLite` (for example from
    `ssdlite.params_from_flax`). Without it the trained checkpoint is
    resolved like the reference's always-loaded ncnn model
    (Detector.cc:22-23): `checkpoint_path="auto"` takes
    `ssdlite_synthetic_c{num_classes}.npz`, then `ssdlite_synthetic.npz`;
    with none found it warns and keeps the seeded init."""

    def __init__(self, cfg: SemanticConfig = SemanticConfig(), params=None, seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.device = device_mod.resolve(device)
        self.model = init_ssdlite(cfg.num_classes, seed, self.device)
        if params is not None:
            self.model.load_state_dict({k: torch.as_tensor(v).to(self.device)
                                        for k, v in params.items()})
        else:
            ckpt = None
            if cfg.checkpoint_path == "auto":
                from orb_slam2_ssd_semantic_tpu_torch.io.artifacts import (
                    find_checkpoint,
                    warn_missing,
                )

                ckpt = (find_checkpoint(f"ssdlite_synthetic_c{cfg.num_classes}.npz")
                        or find_checkpoint("ssdlite_synthetic.npz"))
                if ckpt is None:
                    warn_missing("ssdlite_synthetic*.npz", "random SSD weights")
            elif cfg.checkpoint_path:
                ckpt = cfg.checkpoint_path
            if ckpt:
                try:
                    load_params(ckpt, self.model)
                except (KeyError, ValueError) as e:  # e.g. another class count
                    warnings.warn(f"could not load SSD checkpoint {ckpt} into a "
                                  f"{cfg.num_classes}-class model ({e}); using random weights",
                                  stacklevel=2)
        self.model_bf16 = copy.deepcopy(self.model).to(torch.bfloat16)
        self.anchors = torch.as_tensor(ssd_anchors(cfg.det_input_size)).to(self.device)

    def _to_device(self, a) -> torch.Tensor:
        if torch.is_tensor(a):
            return a.to(self.device)
        return torch.as_tensor(np.ascontiguousarray(a)).to(self.device)

    def postprocess(self, loc: torch.Tensor, conf: torch.Tensor, h: int, w: int) -> Detections:
        """f32 decode, softmax, top-k and NMS of raw outputs loc (..., A, 4)
        and conf (..., A, C) of an (h, w) image."""
        cfg = self.cfg
        boxes = decode_boxes(loc, self.anchors)
        probs = torch.softmax(conf, dim=-1)
        cls_prob = probs[..., 1:]  # drop background
        best_cls = torch.argmax(cls_prob, dim=-1) + 1
        best_score = torch.amax(cls_prob, dim=-1)
        D = cfg.max_detections
        top_scores, top_idx = top_k(best_score, D)
        scale = torch.tensor([w, h, w, h], dtype=torch.float32, device=loc.device)
        b = torch.gather(boxes, -2, top_idx[..., None].expand(*top_idx.shape, 4)) * scale
        c = torch.gather(best_cls, -1, top_idx)
        b, s, c, keep = nms_fixed(b, top_scores, c, D, cfg.det_nms_iou)
        valid = keep & (s >= cfg.det_score_threshold)
        return Detections(b, s, c.to(torch.int32), valid)

    @precision.scoped
    @torch.no_grad()
    def raw(self, rgb, bf16: bool = False):
        """The network's raw outputs (loc, conf) for (H, W, 3) or a batch
        (B, H, W, 3): f32 weights, or the bf16 copy with bf16 activations
        (cast back to f32)."""
        x = preprocess(self._to_device(rgb), self.cfg.det_input_size)
        batched = x.ndim == 4
        x = x if batched else x[None]
        if bf16:
            loc, conf = self.model_bf16(x.to(torch.bfloat16))
            loc, conf = loc.to(torch.float32), conf.to(torch.float32)
        else:
            loc, conf = self.model(x)
        return (loc, conf) if batched else (loc[0], conf[0])

    @precision.scoped
    @torch.no_grad()
    def __call__(self, rgb) -> Detections:
        """The f32 single-image path: (H, W, 3) uint8 -> Detections."""
        h, w = rgb.shape[:2]
        loc, conf = self.raw(rgb)
        return self.postprocess(loc, conf, h, w)

    @precision.scoped
    @torch.no_grad()
    def detect_batch(self, rgbs) -> list:
        """The whole queue through ONE forward (the RunDetect consumer
        processes its queue per wake, RunDetect.cc:44): the conv stack in
        bf16 from the bf16 copy of the weights, decode, softmax, top-k and
        NMS in f32. All images must share one (H, W). A detection whose
        score sits at `det_score_threshold` can flip validity between
        this path and the f32 `__call__`."""
        if len(rgbs) == 0:
            return []
        shapes = {tuple(r.shape[:2]) for r in rgbs}
        if len(shapes) != 1:
            raise ValueError(f"detect_batch requires uniform image shapes, got {shapes}")
        h, w = next(iter(shapes))
        batch = torch.stack([self._to_device(r) for r in rgbs])
        loc, conf = self.raw(batch, bf16=True)
        dd = self.postprocess(loc, conf, h, w)
        return [Detections(*(x[i] for x in dd)) for i in range(batch.shape[0])]
