"""SSD training: anchor matching, multibox loss and an Adam train step
(counterpart of the JAX package's `semantic/train.py`).

The reference ships only ncnn inference with a pretrained
mobilenetv2-ssdlite binary that is absent from its snapshot
(perfect/src/Detector.cc:22-23 hardcodes the model paths), so the engine
trains its own detector with the standard SSD recipe (Liu et al.,
ECCV'16): IoU anchor matching (each target's best anchor forced
positive, plus anchors with IoU > 0.5), smooth-L1 box regression on the
encoded offsets, and cross-entropy classification with 3:1 hard-negative
mining.

As in JAX, the gradient covers every array of the model, the BatchNorm
running statistics included (JAX's `value_and_grad` differentiates the
whole Flax variables dict, and its BatchNorm layers run on their running
averages), so Adam updates all 404 arrays of SSDLite: `trainable` turns
the buffers into leaves, and `ssdlite.BatchNorm` then computes Flax's
arithmetic, which takes a gradient in the statistics.

Two of JAX's scatters and a sort are written so that their result does
not depend on the device's order of work:
- `match_anchors`' forced matches: a padded GT has IoU -1 with every
  anchor, so its best anchor is anchor 0, and two GTs can share a best
  anchor; XLA's CPU scatter keeps the last write, and so does
  `utils/tensor_ops.last_write_wins`;
- the hard-negative ranking is a stable sort (positives at -inf last, as
  `jnp.argsort` orders them), its inverse permutation a second sort.

The matching and the loss take any leading batch dims (JAX maps them over
the batch with `vmap`).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from orb_slam2_ssd_semantic_tpu_torch.semantic.ssdlite import ssd_anchors
from orb_slam2_ssd_semantic_tpu_torch.utils import precision
from orb_slam2_ssd_semantic_tpu_torch.utils.tensor_ops import last_write_wins

VARIANCES = (0.1, 0.2)


def _xyxy_to_cxcywh(b: torch.Tensor) -> torch.Tensor:
    wh = torch.clamp(b[..., 2:] - b[..., :2], min=1e-6)
    return torch.cat([b[..., :2] + wh / 2, wh], dim=-1)


def encode_boxes(gt_cxcywh: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """Inverse of ssdlite.decode_boxes: gt (..., A, 4) cxcywh -> loc targets."""
    d_xy = (gt_cxcywh[..., :2] - anchors[..., :2]) / (VARIANCES[0] * anchors[..., 2:])
    d_wh = torch.log(gt_cxcywh[..., 2:] / anchors[..., 2:]) / VARIANCES[1]
    return torch.cat([d_xy, d_wh], dim=-1)


def _iou_anchors_gt(anchors_xyxy: torch.Tensor, gt_xyxy: torch.Tensor) -> torch.Tensor:
    """(A, 4) x (..., G, 4) -> (..., A, G) IoU."""
    lt = torch.maximum(anchors_xyxy[:, None, :2], gt_xyxy[..., None, :, :2])
    rb = torch.minimum(anchors_xyxy[:, None, 2:], gt_xyxy[..., None, :, 2:])
    inter = torch.clamp(rb - lt, min=0.0).prod(-1)
    area_a = (anchors_xyxy[:, 2:] - anchors_xyxy[:, :2]).prod(-1)
    area_g = (gt_xyxy[..., 2:] - gt_xyxy[..., :2]).prod(-1)
    return inter / torch.clamp(area_a[:, None] + area_g[..., None, :] - inter, min=1e-9)


class AnchorTargets(NamedTuple):
    loc: torch.Tensor  # (..., A, 4) regression targets (defined where pos)
    cls: torch.Tensor  # (..., A) int64 class id (0 = background)
    pos: torch.Tensor  # (..., A) bool positive-anchor mask


def match_anchors(
    anchors: torch.Tensor,  # (A, 4) cxcywh in [0, 1]
    gt_boxes: torch.Tensor,  # (..., G, 4) xyxy in [0, 1], padded
    gt_cls: torch.Tensor,  # (..., G) int >= 1, padded
    gt_valid: torch.Tensor,  # (..., G) bool
    iou_threshold: float = 0.5,
) -> AnchorTargets:
    """SSD matching: every GT claims its best anchor; anchors with
    IoU > threshold to some GT are also positive. Where several GTs claim
    one anchor (padded GTs all claim anchor 0), the last GT's claim holds,
    invalid or not, as XLA's CPU scatter leaves JAX's `.at[].set()`."""
    A = anchors.shape[0]
    lead, G = gt_valid.shape[:-1], gt_valid.shape[-1]
    anchors_xyxy = torch.cat([anchors[:, :2] - anchors[:, 2:] / 2,
                              anchors[:, :2] + anchors[:, 2:] / 2], dim=-1)
    iou = torch.where(gt_valid[..., None, :], _iou_anchors_gt(anchors_xyxy, gt_boxes),
                      torch.full((), -1.0, device=anchors.device))
    best_gt = torch.argmax(iou, dim=-1)  # (..., A)
    best_iou = torch.amax(iou, dim=-1)
    best_anchor = torch.argmax(iou, dim=-2).reshape(-1, G)  # (B, G)
    B = best_anchor.shape[0]
    dev = anchors.device
    flat = (torch.arange(B, device=dev)[:, None] * A + best_anchor).reshape(-1)
    g_idx = torch.arange(G, device=dev).repeat(B).to(torch.float32)
    won, hit = last_write_wins(flat, torch.ones_like(flat, dtype=torch.bool), g_idx, B * A)
    forced_gt = won.to(torch.int64).reshape(*lead, A)
    forced = hit.reshape(*lead, A) & torch.gather(gt_valid, -1, forced_gt)
    assigned = torch.where(forced, forced_gt, best_gt)
    pos = forced | (best_iou > iou_threshold)
    gt_for_anchor = torch.gather(gt_boxes, -2, assigned[..., None].expand(*assigned.shape, 4))
    loc_t = encode_boxes(_xyxy_to_cxcywh(gt_for_anchor), anchors)
    cls_t = torch.where(pos, torch.gather(gt_cls.to(torch.int64), -1, assigned),
                        torch.zeros((), dtype=torch.int64, device=dev))
    return AnchorTargets(loc=loc_t, cls=cls_t, pos=pos)


def multibox_loss(
    loc_pred: torch.Tensor,  # (..., A, 4)
    conf_pred: torch.Tensor,  # (..., A, C) logits
    targets: AnchorTargets,
    neg_pos_ratio: float = 3.0,
):
    """Smooth-L1 on positives + CE with hard-negative mining (3:1).
    Returns (loss, (loss_loc, loss_cls)), each of the leading shape."""
    pos = targets.pos
    n_pos = torch.clamp(pos.to(torch.float32).sum(-1), min=1.0)

    diff = torch.abs(loc_pred - targets.loc)
    smooth_l1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    zero = torch.zeros((), dtype=loc_pred.dtype, device=loc_pred.device)
    loss_loc = torch.where(pos[..., None], smooth_l1, zero).sum((-2, -1)) / n_pos

    logp = F.log_softmax(conf_pred, dim=-1)
    ce = -torch.gather(logp, -1, targets.cls[..., None])[..., 0]
    # Hard-negative mining: rank background anchors by loss, keep 3x pos.
    # The ranking takes no gradient.
    neg_ce = torch.where(pos, torch.full((), float("-inf"), device=ce.device), ce.detach())
    order = torch.argsort(-neg_ce, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1)
    neg = (~pos) & (rank < neg_pos_ratio * n_pos[..., None])
    loss_cls = torch.where(pos | neg, ce, zero).sum(-1) / n_pos
    return loss_loc + loss_cls, (loss_loc, loss_cls)


def trainable(model: torch.nn.Module) -> dict:
    """Every array of `model` by its `state_dict` name (parameters and
    buffers; 404 for SSDLite), the buffers turned into leaves that take
    gradients, as JAX differentiates the whole variables dict."""
    for b in model.buffers():
        b.requires_grad_(True)
    return dict(model.state_dict(keep_vars=True))


def adam(model: torch.nn.Module, lr: float = 1e-3) -> torch.optim.Adam:
    """`optax.adam(lr)` over every array of `model`: the same moments,
    bias corrections and epsilon outside the square root."""
    return torch.optim.Adam(list(trainable(model).values()), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def _as_device(a, dev) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.to(dev)
    return torch.as_tensor(np.ascontiguousarray(a)).to(dev)


def loss_fn(model, anchors, images, gt_boxes, gt_cls, gt_valid) -> torch.Tensor:
    """The batch mean of the per-image multibox losses."""
    loc, conf = model(images)  # (B, A, 4), (B, A, C)
    loss, _ = multibox_loss(loc, conf, match_anchors(anchors, gt_boxes, gt_cls, gt_valid))
    return loss.mean()


@contextlib.contextmanager
def _without_cudnn():
    saved = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = saved


@precision.scoped
def value_and_grad(model, images, gt_boxes, gt_cls, gt_valid, input_size: int = 300):
    """(loss, {name: gradient}) of `loss_fn` over every array of `model`
    (`jax.value_and_grad` over the variables dict). Inputs may be numpy
    arrays or tensors; they go to the model's device.

    The convolutions run without cuDNN: under the precision scope
    (deterministic algorithms, no TF32) its f32 algorithms left 12 of the
    404 gradients more than 1e-4 of their norm from the same step in
    float64 on an H100 (2.6e-3 at worst), PyTorch's own CUDA convolutions
    none (2.2e-5 at worst): `train_precision_probe.py`. Serving keeps
    cuDNN."""
    leaves = trainable(model)
    dev = next(iter(leaves.values())).device
    anchors = torch.as_tensor(ssd_anchors(input_size)).to(dev)
    for t in leaves.values():
        t.grad = None
    batch = [_as_device(a, dev) for a in (images, gt_boxes, gt_cls, gt_valid)]
    with _without_cudnn():
        loss = loss_fn(model, anchors, *batch)
        loss.backward()
    return loss.detach(), {k: t.grad for k, t in leaves.items()}


def make_train_step(model, opt: torch.optim.Optimizer, input_size: int = 300):
    """Returns step(images, gt_boxes, gt_cls, gt_valid) -> loss: one
    forward, loss, backward and optimizer update of `model` in place
    (`opt` built over `trainable(model)`, e.g. by `adam`), under the
    precision scope (no TF32, deterministic kernels)."""

    def step(images, gt_boxes, gt_cls, gt_valid):
        loss, _ = value_and_grad(model, images, gt_boxes, gt_cls, gt_valid, input_size)
        with precision.highest_precision(), torch.no_grad():
            opt.step()
        return loss

    return step


def synthetic_detection_batch_device(
    gen: torch.Generator,
    batch: int,
    size: int = 300,
    n_classes: int = 3,
    max_boxes: int = 3,
):
    """Device-side twin of `synthetic_detection_batch`: the whole batch is
    drawn from `gen` on its device, so training ships no images to the
    card. The draws are those of a `torch.Generator` (JAX's twin splits a
    `PRNGKey`): the same distribution, another stream."""
    dev = gen.device
    imgs = torch.randn((batch, size, size, 3), generator=gen, device=dev) * 0.08
    wh = torch.rand((batch, max_boxes, 2), generator=gen, device=dev) * 0.3 + 0.2
    xy = torch.rand((batch, max_boxes, 2), generator=gen, device=dev) * (1.0 - wh)
    cls = torch.randint(1, n_classes + 1, (batch, max_boxes), generator=gen, device=dev)
    nbox = torch.randint(1, max_boxes + 1, (batch,), generator=gen, device=dev)
    valid = torch.arange(max_boxes, device=dev)[None, :] < nbox[:, None]
    boxes = torch.cat([xy, xy + wh], dim=-1)  # (B, G, 4) xyxy in [0, 1]

    grid = (torch.arange(size, dtype=torch.float32, device=dev) + 0.5) / size
    inx = (grid >= boxes[..., 0:1]) & (grid < boxes[..., 2:3])  # (B, G, S)
    iny = (grid >= boxes[..., 1:2]) & (grid < boxes[..., 3:4])
    level = -0.8 + 1.6 * cls.to(torch.float32) / n_classes  # (B, G)
    noise = torch.randn((batch, size, size, 3), generator=gen, device=dev) * 0.05
    for g in range(max_boxes):
        m = iny[:, g, :, None] & inx[:, g, None, :] & valid[:, g, None, None]
        imgs = torch.where(m[..., None], level[:, g, None, None, None] + noise, imgs)
    return imgs, boxes, (cls * valid).to(torch.int32), valid


def synthetic_detection_batch(
    rng: np.random.Generator,
    batch: int,
    size: int = 300,
    n_classes: int = 3,
    max_boxes: int = 3,
):
    """Simple synthetic detection task: solid-intensity rectangles on a
    noisy background; the class is the intensity band. Returns
    (images (B,S,S,3) in [-1,1]-ish preprocessed range, boxes (B,G,4)
    xyxy in [0,1], cls (B,G), valid (B,G))."""
    imgs = rng.normal(0.0, 0.08, (batch, size, size, 3)).astype(np.float32)
    boxes = np.zeros((batch, max_boxes, 4), np.float32)
    cls = np.zeros((batch, max_boxes), np.int32)
    valid = np.zeros((batch, max_boxes), bool)
    for b in range(batch):
        n = rng.integers(1, max_boxes + 1)
        for g in range(n):
            w, h = rng.uniform(0.2, 0.5, 2)
            x1 = rng.uniform(0.0, 1.0 - w)
            y1 = rng.uniform(0.0, 1.0 - h)
            c = int(rng.integers(1, n_classes + 1))
            px = [int(x1 * size), int(y1 * size),
                  int((x1 + w) * size), int((y1 + h) * size)]
            level = -0.8 + 1.6 * c / n_classes
            imgs[b, px[1]:px[3], px[0]:px[2], :] = level + rng.normal(
                0.0, 0.05, (px[3] - px[1], px[2] - px[0], 3))
            boxes[b, g] = [x1, y1, x1 + w, y1 + h]
            cls[b, g] = c
            valid[b, g] = True
    return imgs, boxes, cls, valid
