"""MobileNetV2-SSDLite object detector in `torch.nn` (counterpart of the
JAX package's Flax `semantic/ssdlite.py`; the reference runs
mobilenetv2-ssdlite, VOC-20, through ncnn: perfect/src/Detector.cc:16-75,
300x300 input, mean/std 127.5).

The network is the Flax one layer for layer: a MobileNetV2 backbone of
inverted residual blocks, four extra feature maps, and depthwise-separable
SSDLite heads over 6 scales, 3000 anchors. Its submodules carry Flax's
auto-generated names (`MobileNetV2Backbone_0`, `InvertedResidual_3`,
`Conv_1`, `BatchNorm_1`, `SSDLiteHead_7`), so a Flax checkpoint maps onto
this module's `state_dict` key for key (`params_from_flax`): the Flax
layouts are HWIO kernels and NHWC activations, here OIHW and NCHW.

Two details of XLA that a one-to-one copy must keep:
- SAME padding: XLA pads `total = max((out - 1) * s + k - in, 0)` with
  `total // 2` before and the rest after. At stride 2 that is (0, 1) on
  an even input (300 -> 150) and (1, 1) on an odd one (75 -> 38), so
  `Conv.forward` pads explicitly; `nn.Conv2d(padding=1)` would shift half
  of the stride-2 convs by a pixel.
- BatchNorm runs on its running statistics with Flax's epsilon, 1e-5, as
  a module of its own (folding it into the convs is later speed work).

The public functions keep the Flax model's layout: `SSDLite` takes
(B, 300, 300, 3) and returns loc (B, A, 4) and conf (B, A, C) in the
anchor order of `ssd_anchors` (row, column, then the 6 anchors of a
cell).
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

VOC_CLASSES = (
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor",
)  # Detector.cc:52-57

BN_EPS = 1e-5  # flax.linen.BatchNorm's default


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv(nn.Conv2d):
    """`flax.linen.Conv` with padding "SAME": XLA's split of the padding."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1, groups: int = 1,
                 bias: bool = False):
        super().__init__(in_ch, out_ch, k, stride=stride, padding=0, groups=groups, bias=bias)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        if k > 1 or s > 1:
            top, bottom = _same_pad(x.shape[-2], k, s)
            left, right = _same_pad(x.shape[-1], k, s)
            x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, 1, self.groups)


class BatchNorm(nn.Module):
    """`flax.linen.BatchNorm(use_running_average=True)`: scale, bias and the
    running mean and variance, and nothing else (no batch counter).

    Training (`semantic/train.py`) differentiates the running statistics
    too, as JAX's `value_and_grad` over the whole Flax variables dict
    does; `F.batch_norm` takes no gradient there, so when a statistic
    requires one the layer computes Flax's arithmetic,
    `(x - mean) * (scale * rsqrt(var + eps)) + bias`, instead."""

    def __init__(self, ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def forward(self, x):
        if torch.is_grad_enabled() and (self.running_mean.requires_grad
                                        or self.running_var.requires_grad):
            mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
            return ((x - self.running_mean[:, None, None]) * mul[:, None, None]
                    + self.bias[:, None, None])
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, eps=BN_EPS)


class InvertedResidual(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, stride: int, expand: int):
        super().__init__()
        self.use_res = stride == 1 and in_ch == out_ch
        hid = in_ch * expand
        layers = []
        if expand != 1:
            layers.append((Conv(in_ch, hid, 1), True))
        layers.append((Conv(hid, hid, 3, stride, groups=hid), True))
        layers.append((Conv(hid, out_ch, 1), False))
        self._relu = []
        for i, (conv, relu) in enumerate(layers):
            self.add_module(f"Conv_{i}", conv)
            self.add_module(f"BatchNorm_{i}", BatchNorm(conv.out_channels))
            self._relu.append(relu)

    def forward(self, x):
        h = x
        for i, relu in enumerate(self._relu):
            h = getattr(self, f"BatchNorm_{i}")(getattr(self, f"Conv_{i}")(h))
            if relu:
                h = F.relu6(h)
        return h + x if self.use_res else h


# (expand, out, repeats, stride) of MobileNetV2.
_MBV2 = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2), (6, 96, 3, 1),
         (6, 160, 3, 2), (6, 320, 1, 1))
_TAP_STAGE = 5  # SSD taps the stride-16 EXPANSION of this stage's first block


class MobileNetV2Backbone(nn.Module):
    """Standard MobileNetV2 trunk; returns the two SSD tap points
    (expansion of block 13 at stride 16, and the final 1280-ch map at
    stride 32). The tap block is built inline, as in the Flax module:
    its convs are `Conv_1..3` of this scope, the last one `Conv_4`."""

    def __init__(self, width: float = 1.0):
        super().__init__()

        def c(ch):
            return max(8, int(ch * width + 4) // 8 * 8)

        self.Conv_0 = Conv(3, c(32), 3, 2)
        self.BatchNorm_0 = BatchNorm(c(32))
        self._plan = []  # ("ir", name) or ("tap", None)
        in_ch, n_ir = c(32), 0
        for ei, (e, ch, r, s) in enumerate(_MBV2):
            for i in range(r):
                stride = s if i == 0 else 1
                if ei == _TAP_STAGE and i == 0:
                    hid = in_ch * e
                    self.Conv_1 = Conv(in_ch, hid, 1)
                    self.BatchNorm_1 = BatchNorm(hid)
                    self.Conv_2 = Conv(hid, hid, 3, stride, groups=hid)
                    self.BatchNorm_2 = BatchNorm(hid)
                    self.Conv_3 = Conv(hid, c(ch), 1)
                    self.BatchNorm_3 = BatchNorm(c(ch))
                    self._plan.append(("tap", None))
                else:
                    name = f"InvertedResidual_{n_ir}"
                    self.add_module(name, InvertedResidual(in_ch, c(ch), stride, e))
                    self._plan.append(("ir", name))
                    n_ir += 1
                in_ch = c(ch)
        self.Conv_4 = Conv(in_ch, c(1280), 1)
        self.BatchNorm_4 = BatchNorm(c(1280))
        self.out_channels = (self.Conv_1.out_channels, c(1280))

    def forward(self, x):
        h = F.relu6(self.BatchNorm_0(self.Conv_0(x)))
        tap1 = None
        for kind, name in self._plan:
            if kind == "tap":
                tap1 = F.relu6(self.BatchNorm_1(self.Conv_1(h)))
                d = F.relu6(self.BatchNorm_2(self.Conv_2(tap1)))
                h = self.BatchNorm_3(self.Conv_3(d))
            else:
                h = getattr(self, name)(h)
        h = F.relu6(self.BatchNorm_4(self.Conv_4(h)))
        return tap1, h


class SSDLiteExtra(nn.Module):
    """Extra feature map: 1x1 reduce + depthwise-separable stride-2."""

    def __init__(self, in_ch: int, mid: int, out: int):
        super().__init__()
        self.Conv_0 = Conv(in_ch, mid, 1)
        self.BatchNorm_0 = BatchNorm(mid)
        self.Conv_1 = Conv(mid, mid, 3, 2, groups=mid)
        self.BatchNorm_1 = BatchNorm(mid)
        self.Conv_2 = Conv(mid, out, 1)
        self.BatchNorm_2 = BatchNorm(out)

    def forward(self, x):
        h = F.relu6(self.BatchNorm_0(self.Conv_0(x)))
        h = F.relu6(self.BatchNorm_1(self.Conv_1(h)))
        return F.relu6(self.BatchNorm_2(self.Conv_2(h)))


class SSDLiteHead(nn.Module):
    """Depthwise-separable predictor (the 'Lite' in SSDLite); only the
    last conv has a bias."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.Conv_0 = Conv(in_ch, in_ch, 3, groups=in_ch)
        self.BatchNorm_0 = BatchNorm(in_ch)
        self.Conv_1 = Conv(in_ch, out_ch, 1, bias=True)

    def forward(self, x):
        return self.Conv_1(F.relu6(self.BatchNorm_0(self.Conv_0(x))))


_EXTRAS = ((256, 512), (128, 256), (128, 256), (64, 128))


class SSDLite(nn.Module):
    """The heads interleave per feature map: `SSDLiteHead_{2k}` predicts
    the locations, `SSDLiteHead_{2k+1}` the class scores (Flax's creation
    order)."""

    def __init__(self, num_classes: int = 21, anchors_per_cell: Sequence[int] = (6,) * 6):
        super().__init__()
        self.num_classes = num_classes
        self.MobileNetV2Backbone_0 = MobileNetV2Backbone()
        chans = list(self.MobileNetV2Backbone_0.out_channels)
        for i, (mid, out) in enumerate(_EXTRAS):
            self.add_module(f"SSDLiteExtra_{i}", SSDLiteExtra(chans[-1], mid, out))
            chans.append(out)
        for k, (ch, a) in enumerate(zip(chans, anchors_per_cell)):
            self.add_module(f"SSDLiteHead_{2 * k}", SSDLiteHead(ch, a * 4))
            self.add_module(f"SSDLiteHead_{2 * k + 1}", SSDLiteHead(ch, a * num_classes))

    def forward(self, x):
        """x: (B, 300, 300, 3) normalized, NHWC. Returns (loc (B, A, 4),
        conf (B, A, C)) over all anchors."""
        tap1, tap2 = self.MobileNetV2Backbone_0(x.permute(0, 3, 1, 2))
        feats = [tap1, tap2]
        h = tap2
        for i in range(len(_EXTRAS)):
            h = getattr(self, f"SSDLiteExtra_{i}")(h)
            feats.append(h)
        b = x.shape[0]
        locs, confs = [], []
        for k, f in enumerate(feats):
            loc = getattr(self, f"SSDLiteHead_{2 * k}")(f).permute(0, 2, 3, 1)
            conf = getattr(self, f"SSDLiteHead_{2 * k + 1}")(f).permute(0, 2, 3, 1)
            locs.append(loc.reshape(b, -1, 4))
            confs.append(conf.reshape(b, -1, self.num_classes))
        return torch.cat(locs, 1), torch.cat(confs, 1)


# ---- anchors & decoding ---------------------------------------------------


def feature_map_sizes(input_size: int = 300):
    return [19, 10, 5, 3, 2, 1]


@functools.lru_cache()
def ssd_anchors(input_size: int = 300) -> np.ndarray:
    """(A, 4) anchors as (cx, cy, w, h) in [0, 1], SSD300 scale recipe
    (s_min 0.2, s_max 0.95; ratios 1, 2, 1/2, 3, 1/3 + extra sqrt)."""
    sizes = feature_map_sizes(input_size)
    m = len(sizes)
    s_min, s_max = 0.2, 0.95
    scales = [s_min + (s_max - s_min) * k / (m - 1) for k in range(m)] + [1.0]
    anchors = []
    for k, fm in enumerate(sizes):
        s = scales[k]
        s_next = np.sqrt(s * scales[k + 1])
        ratios = [1.0, 2.0, 0.5, 3.0, 1.0 / 3.0]
        for i in range(fm):
            for j in range(fm):
                cx = (j + 0.5) / fm
                cy = (i + 0.5) / fm
                anchors.append([cx, cy, s_next, s_next])
                for r in ratios:
                    sr = np.sqrt(r)
                    anchors.append([cx, cy, s * sr, s / sr])
    return np.asarray(anchors, dtype=np.float32)


def decode_boxes(loc: torch.Tensor, anchors: torch.Tensor, variances=(0.1, 0.2)) -> torch.Tensor:
    """SSD box decode: loc (..., A, 4) -> (x1, y1, x2, y2) in [0, 1]."""
    cxcy = anchors[..., :2] + loc[..., :2] * variances[0] * anchors[..., 2:]
    wh = anchors[..., 2:] * torch.exp(loc[..., 2:] * variances[1])
    mins = cxcy - wh / 2
    maxs = cxcy + wh / 2
    return torch.clamp(torch.cat([mins, maxs], dim=-1), 0.0, 1.0)


# ---- weights --------------------------------------------------------------

_FLAX_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "bias"): None,  # "bias" of a conv or a BatchNorm
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flax_key_to_torch(key: str) -> str:
    parts = [p.strip("[]'") for p in key.split("/")]
    collection, path, leaf = parts[0], parts[1:-1], parts[-1]
    if (collection, leaf) not in _FLAX_LEAF:
        raise KeyError(f"not an SSDLite variable: {key}")
    return ".".join(path + [_FLAX_LEAF[(collection, leaf)] or leaf])


def params_from_flax(flat: dict, model: SSDLite | None = None) -> dict:
    """A flat Flax variable dict, as the JAX package's `save_params`
    writes it (keys such as `['params']/['SSDLiteHead_11']/['Conv_1']/
    ['kernel']` and `['batch_stats']/.../['mean']`), as this module's
    `state_dict`: conv kernels HWIO -> OIHW (a depthwise (3, 3, 1, C)
    becomes (C, 1, 3, 3)), BatchNorm scale -> weight, mean/var -> the
    running buffers. Raises on a key this model lacks, a tensor of
    another shape, or a parameter or buffer the dict does not fill.
    `model` gives the expected keys and shapes (by default an SSDLite
    with the class count of the dict's first class head)."""
    if model is None:
        conf_bias = flat["['params']/['SSDLiteHead_1']/['Conv_1']/['bias']"]
        model = SSDLite(num_classes=np.asarray(conf_bias).shape[0] // 6)
    expected = model.state_dict()
    out = {}
    for key, arr in flat.items():
        name = _flax_key_to_torch(key)
        t = torch.tensor(np.asarray(arr), dtype=torch.float32)
        if t.ndim == 4:
            t = t.permute(3, 2, 0, 1).contiguous()
        if name not in expected:
            raise KeyError(f"{key} -> {name}: no such tensor in the model")
        if tuple(t.shape) != tuple(expected[name].shape):
            raise ValueError(f"{key}: shape {tuple(t.shape)}, the model's {name} is "
                             f"{tuple(expected[name].shape)}")
        out[name] = t
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"the Flax variables leave {len(missing)} tensors unset: {missing[:5]}")
    return out


def _flax_key(collection: str, name: str) -> str:
    *path, leaf = name.split(".")
    flax_leaf = {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
    if leaf == "weight":
        flax_leaf = "scale" if path[-1].startswith("BatchNorm") else "kernel"
    return "/".join(f"['{p}']" for p in [collection, *path, flax_leaf])


def params_to_flax(model: SSDLite) -> dict:
    """The inverse of `params_from_flax`: the model's tensors as a flat
    Flax variable dict of numpy arrays (kernels in HWIO)."""
    out = {}
    for name, t in model.state_dict().items():
        collection = "batch_stats" if name.endswith(("running_mean", "running_var")) else "params"
        a = t.detach().to(torch.float32).cpu()
        if a.ndim == 4:
            a = a.permute(2, 3, 1, 0)
        out[_flax_key(collection, name)] = a.contiguous().numpy()
    return out


def load_params(path: str, model: SSDLite) -> SSDLite:
    """Load a flat .npz checkpoint in the JAX package's format into `model`
    (in place; returns it). Raises on missing, extra or misshapen arrays."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    sd = params_from_flax(flat, model)
    dev = next(model.parameters()).device
    model.load_state_dict({k: v.to(dev) for k, v in sd.items()}, strict=True)
    return model


def save_params(path: str, model: SSDLite) -> None:
    """Save `model` as a flat .npz that the JAX package's `load_params`
    reads."""
    np.savez(path, **params_to_flax(model))


def init_ssdlite(num_classes: int = 21, seed: int = 0, device=None) -> SSDLite:
    """A seeded SSDLite in `eval()` mode, with Flax's initializers: conv
    kernels `lecun_normal` (a normal truncated at 2 sigma, scaled so its
    standard deviation is sqrt(1 / fan_in)), zero biases, BatchNorm scale
    1, bias 0, mean 0, var 1. The draws come from a CPU generator in the
    order of `state_dict`, so the CPU and the card get the same weights.
    `device=None` puts the model on the card (raises without one)."""
    from orb_slam2_ssd_semantic_tpu_torch import device as device_mod

    dev = device_mod.resolve(device)
    model = SSDLite(num_classes=num_classes)
    gen = torch.Generator().manual_seed(seed)
    # flax variance_scaling: the truncated normal on [-2, 2] has standard
    # deviation 0.87962566103423978; divide it out.
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                fan_in = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
                std = math.sqrt(1.0 / fan_in) / trunc_std
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
    return model.to(dev).eval()
