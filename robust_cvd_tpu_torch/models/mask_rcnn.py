"""Mask R-CNN R50-FPN (PyTorch, NCHW, inference).

Port of robust_cvd_tpu/models/mask_rcnn.py, the JAX package's
re-implementation of detectron2's `COCO-InstanceSegmentation/
mask_rcnn_R_50_FPN_3x` (reference dynamic_mask_generation.py:34-41,
107-239) with static shapes:

  - proposals and detections are fixed top-k counts; every sort is
    stable, so that among equal scores (the -inf of suppressed entries
    above all) the lower index comes first, as jax.lax.top_k orders them;
  - NMS is the fixed-point iteration of the vectorised suppression
    operator over a dense IoU matrix, bounded at k trips;
  - ROIAlign is one gather pass over a vertically stacked atlas of the
    P2..P5 maps, each box sampling at its level's row origin and stride;
  - the mask paste resamples every detection's 28x28 mask over the whole
    image as two matrix products a detection (zero-padded bilinear is
    separable);
  - every detection slot exists (MAX_DETECTIONS), and an invalid one has
    score 0.

Convolutions and linear layers compute in `dtype` (bfloat16 on the card,
as the JAX package runs; float32 for the CPU tests) with float32 weights
cast per call; FrozenBN folds its statistics in float32; box math, ROIAlign
and the paste are float32. At float32, run under
`device.float32_precision(False)` so that TF32 enters neither the matrix
products nor the convolutions; `paste_masks` always computes in full
float32.

Module names are detectron2's state-dict keys
(`backbone.bottom_up.res2.0.conv1.weight`, `....conv1.norm.running_var`,
`roi_heads.box_head.fc1.weight`, `roi_heads.box_predictor.cls_score.bias`,
...), so a model-zoo pickle loads with `load_checkpoint` as it is. Like the
JAX package, a bottleneck's stride sits in its 3x3 convolution (conv2).
"""

from __future__ import annotations

import math
import pickle
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import float32_precision
from ..utils.spans import span

# COCO "dynamic object" categories: person + vehicle + animal
# (reference dynamic_mask_generation.py:41), as [lo, hi) class ranges.
_DYNAMIC_RANGES = ((0, 8), (13, 23))
DYNAMIC_OBJECT_CATEGORIES = tuple(c for lo, hi in _DYNAMIC_RANGES for c in range(lo, hi))

# Detectron2 R50-FPN defaults (configs/mask_rcnn_R_50_FPN_3x.yaml lineage).
PIXEL_MEAN_BGR = (103.530, 116.280, 123.675)
ANCHOR_SIZES = (32, 64, 128, 256, 512)  # one size per level P2..P6
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
RPN_PRE_NMS_TOPK = 1000  # test-time, per level
RPN_POST_NMS_TOPK = 1000  # test-time, across levels
RPN_NMS_THRESH = 0.7
ROI_SCORE_THRESH = 0.5  # reference confidence_threshold
ROI_NMS_THRESH = 0.5
MAX_DETECTIONS = 100
BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)  # ROI head; RPN uses (1,1,1,1)
SCALE_CLAMP = math.log(1000.0 / 16)
BN_EPS = 1e-5  # detectron2 FrozenBatchNorm2d
# NMS trips between two convergence checks: a trip past the fixed point
# changes nothing, so checking every few trips gives the same result with
# fewer host syncs
NMS_CHECK_EVERY = 8


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------


class FrozenBN(nn.Module):
    """Detectron2's FrozenBatchNorm2d: a per-channel affine from fixed
    statistics, folded in float32 (scale = weight / sqrt(var + eps), then
    bias - mean * scale, the order of the JAX package's converter) and
    applied in the input's dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(channels))
        self.register_buffer("bias", torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        scale = self.weight / torch.sqrt(self.running_var + BN_EPS)
        return scale, self.bias - self.running_mean * scale

    def forward(self, x):
        scale, bias = self.folded()
        return x * scale.to(x.dtype)[:, None, None] + bias.to(x.dtype)[:, None, None]


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in `self.dtype` (float32 weights cast per
    call), with detectron2's optional `norm` child."""

    dtype = torch.float32

    def __init__(self, *args, norm: nn.Module | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm

    def forward(self, x):
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        y = self._conv_forward(x.to(dt), self.weight.to(dt), bias)
        return y if self.norm is None else self.norm(y)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d that computes in `self.dtype`."""

    dtype = torch.float32

    def forward(self, x):
        dt = self.dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), self.bias.to(dt), self.stride)


class Linear(nn.Linear):
    """nn.Linear that computes in `self.dtype`."""

    dtype = torch.float32

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def _conv_bn(cin: int, cout: int, k: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=False, norm=FrozenBN(cout))


class Bottleneck(nn.Module):
    """ResNet-50 bottleneck (groups=1) with FrozenBN; the stride is in the
    3x3 convolution, as in the JAX package."""

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = _conv_bn(cin, planes, 1)
        self.conv2 = _conv_bn(planes, planes, 3, stride)
        self.conv3 = _conv_bn(planes, planes * 4, 1)
        self.shortcut = _conv_bn(cin, planes * 4, 1, stride) if downsample else None

    def forward(self, x):
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        y = self.conv3(y)
        identity = x if self.shortcut is None else self.shortcut(x)
        return F.relu(y + identity)


class BasicStem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = _conv_bn(3, 64, 7, 2)

    def forward(self, x):
        return F.max_pool2d(F.relu(self.conv1(x)), 3, stride=2, padding=1)


class ResNet(nn.Module):
    """The bottom-up ResNet-50: stem, res2..res5; returns C2..C5."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3)):
        super().__init__()
        self.stem = BasicStem()
        cin = 64
        for stage, (blocks, planes) in enumerate(zip(layers, (64, 128, 256, 512))):
            stride = 1 if stage == 0 else 2
            self.add_module(f"res{stage + 2}", nn.Sequential(*[
                Bottleneck(cin if b == 0 else planes * 4, planes,
                           stride if b == 0 else 1, downsample=(b == 0))
                for b in range(blocks)
            ]))
            cin = planes * 4

    def forward(self, x):
        y = self.stem(x)
        feats = []
        for stage in (2, 3, 4, 5):
            y = getattr(self, f"res{stage}")(y)
            feats.append(y)
        return feats


class ResNet50FPN(nn.Module):
    """ResNet-50 + FPN returning [P2, P3, P4, P5, P6] at 256 channels:
    1x1 laterals, a nearest repeat-and-crop top-down path, 3x3 outputs,
    and P6 a stride-2 subsample of P5."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3), fpn_channels: int = 256,
                 dtype=torch.bfloat16):
        super().__init__()
        self.bottom_up = ResNet(layers)
        for lvl, c in zip((2, 3, 4, 5), (256, 512, 1024, 2048)):
            self.add_module(f"fpn_lateral{lvl}", Conv2d(c, fpn_channels, 1))
            self.add_module(f"fpn_output{lvl}", Conv2d(fpn_channels, fpn_channels, 3, padding=1))
        _set_dtype(self, dtype)

    def forward(self, x):
        feats = self.bottom_up(x)
        laterals = [getattr(self, f"fpn_lateral{i + 2}")(c) for i, c in enumerate(feats)]
        tops = [laterals[3]]
        for i in (2, 1, 0):
            h, w = laterals[i].shape[-2:]
            up = tops[0].repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
            tops.insert(0, laterals[i] + up[..., :h, :w])
        outs = [getattr(self, f"fpn_output{i + 2}")(t) for i, t in enumerate(tops)]
        return outs + [outs[3][..., ::2, ::2]]


class RPNHead(nn.Module):
    """Shared 3x3 conv + objectness / anchor-delta heads (A = 3 anchors);
    float32 (obj (B, A, H, W), deltas (B, 4A, H, W)) per level."""

    def __init__(self, num_anchors: int = len(ANCHOR_RATIOS), dtype=torch.bfloat16):
        super().__init__()
        self.conv = Conv2d(256, 256, 3, padding=1)
        self.objectness_logits = Conv2d(256, num_anchors, 1)
        self.anchor_deltas = Conv2d(256, num_anchors * 4, 1)
        _set_dtype(self, dtype)

    def forward(self, feats):
        out = []
        for f in feats:
            t = F.relu(self.conv(f))
            out.append((self.objectness_logits(t).float(), self.anchor_deltas(t).float()))
        return out


class BoxHead(nn.Module):
    """detectron2's 2-FC box head: (R, 256, 7, 7) -> (R, 1024) features,
    fc1 on torch's (C, 7, 7) flatten."""

    def __init__(self, dtype=torch.bfloat16):
        super().__init__()
        self.fc1 = Linear(256 * 7 * 7, 1024)
        self.fc2 = Linear(1024, 1024)
        _set_dtype(self, dtype)

    def forward(self, x):
        y = F.relu(self.fc1(x.flatten(1)))
        return F.relu(self.fc2(y))


class BoxPredictor(nn.Module):
    """Class scores (80 + background) and per-class box deltas, float32."""

    def __init__(self, num_classes: int = 80, dtype=torch.bfloat16):
        super().__init__()
        self.cls_score = Linear(1024, num_classes + 1)
        self.bbox_pred = Linear(1024, num_classes * 4)
        _set_dtype(self, dtype)

    def forward(self, x):
        return self.cls_score(x).float(), self.bbox_pred(x).float()


class MaskHead(nn.Module):
    """4x conv + 2x deconv + per-class 28x28 mask predictor:
    (R, 256, 14, 14) -> float32 logits (R, 80, 28, 28)."""

    def __init__(self, num_classes: int = 80, dtype=torch.bfloat16):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"mask_fcn{i}", Conv2d(256, 256, 3, padding=1))
        self.deconv = ConvTranspose2d(256, 256, 2, stride=2)
        self.predictor = Conv2d(256, num_classes, 1)
        _set_dtype(self, dtype)

    def forward(self, x):
        y = x
        for i in range(1, 5):
            y = F.relu(getattr(self, f"mask_fcn{i}")(y))
        y = F.relu(self.deconv(y))
        return self.predictor(y).float()


def _set_dtype(module: nn.Module, dtype) -> None:
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
            m.dtype = dtype


# --------------------------------------------------------------------------
# Box math (float32, detectron2 Box2BoxTransform conventions)
# --------------------------------------------------------------------------


def decode_boxes(anchors, deltas, weights=(1.0, 1.0, 1.0, 1.0)):
    """anchors (..., 4) xyxy + deltas (..., 4) -> boxes (..., 4) xyxy."""
    wx, wy, ww, wh = weights
    ax0, ay0, ax1, ay1 = anchors.unbind(-1)
    dx, dy, dw, dh = deltas.unbind(-1)
    aw = ax1 - ax0
    ah = ay1 - ay0
    acx = ax0 + 0.5 * aw
    acy = ay0 + 0.5 * ah
    cx = dx / wx * aw + acx
    cy = dy / wy * ah + acy
    w = torch.exp(torch.clamp(dw / ww, max=SCALE_CLAMP)) * aw
    h = torch.exp(torch.clamp(dh / wh, max=SCALE_CLAMP)) * ah
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def clip_boxes(boxes, hw):
    h, w = hw
    x0, y0, x1, y1 = boxes.unbind(-1)
    return torch.stack([x0.clamp(0.0, w), y0.clamp(0.0, h), x1.clamp(0.0, w),
                        y1.clamp(0.0, h)], dim=-1)


def pairwise_iou(a, b):
    """(..., K, 4) x (..., M, 4) -> (..., K, M) IoU."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    x0 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y0 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x1 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y1 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = (x1 - x0).clamp(min=0) * (y1 - y0).clamp(min=0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-9)


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lower
    index first among equal values (jax.lax.top_k's order; torch.topk
    leaves it unspecified)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def nms_keep(boxes, scores, iou_thresh: float, valid=None):
    """Greedy NMS as the fixed point of the vectorised suppression
    operator, over leading batch axes: boxes (..., K, 4), scores (..., K)
    -> a bool keep mask (..., K) aligned with the inputs.

    Greedy NMS is the unique solution of `keep[i] = valid[i] and no kept j
    earlier in score order overlaps i`. Iterating keep <- F(keep) with
    F(keep)[i] = v[i] & ~any_j(sup[j, i] & keep[j]) (sup: strictly
    upper-triangular IoU > t in score order) reaches it in at most the
    suppression chain's depth, and at most K trips. Convergence is read
    back every NMS_CHECK_EVERY trips (one host sync each,
    `nms_keep.syncs`)."""
    k = boxes.shape[-2]
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    iou = pairwise_iou(b, b)
    if valid is None:
        v = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    else:
        v = torch.gather(valid, -1, order)
    upper = torch.ones(k, k, dtype=torch.bool, device=boxes.device).triu(1)
    sup = (iou > iou_thresh) & upper & v[..., :, None]
    keep, trips = v, 0
    while trips < k:
        for _ in range(min(NMS_CHECK_EVERY, k - trips)):
            prev = keep
            keep = v & ~(sup & keep[..., :, None]).any(dim=-2)
            trips += 1
        nms_keep.syncs += 1
        if torch.equal(keep, prev):
            break
    return torch.empty_like(keep).scatter_(-1, order, keep)


nms_keep.syncs = 0


def batched_nms(boxes, scores, idxs, iou_thresh: float, valid=None):
    """Category-independent NMS via the coordinate-offset trick: each
    category's boxes move by idx * (max(boxes) + 1), the max over each
    leading batch entry."""
    offset = boxes.amax(dim=(-2, -1), keepdim=True) + 1.0
    return nms_keep(boxes + idxs.float()[..., None] * offset, scores, iou_thresh, valid=valid)


# --------------------------------------------------------------------------
# ROIAlign (aligned=True, sampling_ratio=2)
# --------------------------------------------------------------------------


def _lerp_taps(gather, inside, xs, ys):
    """Zero-padded bilinear interpolation at continuous coords xs, ys
    (...): `gather(yi, xi)` reads the features (..., C) at integer coords
    (clamped into the map), `inside(yi, xi)` says which coords are in it;
    the out-of-map taps get weight 0. One product-sum a tap, accumulated in
    place."""
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = xs - x0
    fy = ys - y0
    x0i = x0.long()
    y0i = y0.long()
    out = None
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            yi, xi = y0i + dy, x0i + dx
            w = (wy * wx * inside(yi, xi))[..., None]
            v = gather(yi, xi)
            out = v.mul_(w) if out is None else out.addcmul_(v, w)
    return out


def _sample_grid(b, out_size: int, sampling: int):
    """Sample centres (..., n, n) in x and y of level-local boxes b
    (..., 4), n = out_size * sampling."""
    x0, y0, x1, y1 = b.unbind(-1)
    bw = (x1 - x0).clamp(min=1e-6)
    bh = (y1 - y0).clamp(min=1e-6)
    n = out_size * sampling
    gi = (torch.arange(n, dtype=torch.float32, device=b.device) + 0.5) / n
    xs = x0[..., None] + gi * bw[..., None]
    ys = y0[..., None] + gi * bh[..., None]
    return xs[..., None, :].expand(*xs.shape[:-1], n, n), ys[..., :, None].expand(*ys.shape, n)


def _bin_mean(samples, out_size: int, sampling: int):
    """(..., n, n, C) samples -> (..., C, out, out) bin averages."""
    lead, c = samples.shape[:-3], samples.shape[-1]
    s = samples.reshape(*lead, out_size * sampling * out_size, sampling, c).sum(-2)
    s = s.reshape(*lead, out_size, sampling, out_size, c).sum(-3) / (sampling * sampling)
    return s.movedim(-1, -3)


def roi_align_level(feat, boxes, out_size: int, stride: float, sampling: int = 2):
    """feat (C, H, W), boxes (R, 4) image-space xyxy -> (R, C, out, out).

    detectron2 ROIAlignV2: aligned (half-pixel offset), a bin grid of
    `sampling`^2 samples averaged per bin, zero outside the map."""
    c, h, w = feat.shape
    fm = feat.float().permute(1, 2, 0)  # (H, W, C)

    def gather(yi, xi):
        return fm[yi.clamp(0, h - 1), xi.clamp(0, w - 1)]

    def inside(yi, xi):
        return (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)

    xs, ys = _sample_grid(boxes / stride - 0.5, out_size, sampling)
    return _bin_mean(_lerp_taps(gather, inside, xs, ys), out_size, sampling)


def assign_levels(boxes, k_min: int = 2, k_max: int = 5):
    """FPN level per box (..., 4): floor(4 + log2(sqrt(area)/224)), clamped."""
    area = (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * (
        boxes[..., 3] - boxes[..., 1]).clamp(min=0)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224.0 + 1e-9))
    return lvl.clamp(k_min, k_max).long()


def _per_level(li, values):
    """values[li] for a level index tensor and four Python numbers, with no
    host-to-device copy."""
    out = torch.full_like(li, values[3])
    for i in (2, 1, 0):
        out = torch.where(li == i, values[i], out)
    return out


def roi_align_fpn(feats, boxes, out_size: int, sampling: int = 2):
    """Multi-level ROIAlign as one gather pass: feats [P2..P5, ...] of
    (B, C, H_l, W_l) and boxes (B, R, 4) -> (B, R, C, out, out) float32.

    P2..P5 are stacked into a vertical atlas (zero-padded to a common
    width) and each box samples at its assigned level's row origin with
    its level's stride; taps outside the box's level read 0."""
    maps = [f.float().permute(0, 2, 3, 1) for f in feats[:4]]  # (B, H, W, C)
    hs = [m.shape[1] for m in maps]
    ws = [m.shape[2] for m in maps]
    bsz, wmax, c = maps[0].shape[0], max(ws), maps[0].shape[-1]
    atlas = torch.cat([F.pad(m, (0, 0, 0, wmax - m.shape[2])) for m in maps], dim=1)
    rows = atlas.shape[1]
    atlas = atlas.reshape(-1, c)  # (B * rows * wmax, C)
    y_off = [0, hs[0], hs[0] + hs[1], hs[0] + hs[1] + hs[2]]
    li = assign_levels(boxes) - 2  # (B, R)
    hb = _per_level(li, hs)[..., None, None]
    wb = _per_level(li, ws)[..., None, None]
    yo = _per_level(li, y_off)[..., None, None]
    yo = yo + torch.arange(bsz, device=boxes.device)[:, None, None, None] * rows
    stride = 4.0 * (2.0 ** li.float())

    def gather(yi, xi):
        yc = torch.minimum(yi.clamp(min=0), hb - 1) + yo
        xc = torch.minimum(xi.clamp(min=0), wb - 1)
        idx = yc * wmax + xc
        return atlas.index_select(0, idx.reshape(-1)).reshape(*idx.shape, c)

    def inside(yi, xi):
        return (yi >= 0) & (yi < hb) & (xi >= 0) & (xi < wb)

    xs, ys = _sample_grid(boxes / stride[..., None] - 0.5, out_size, sampling)
    return _bin_mean(_lerp_taps(gather, inside, xs, ys), out_size, sampling)


# --------------------------------------------------------------------------
# Anchors + full model
# --------------------------------------------------------------------------


@lru_cache(maxsize=64)
def level_anchors(hw: Tuple[int, int], stride: int, size: float, device="cpu"):
    """(H*W*A, 4) xyxy anchors of one level: the A ratio shapes of `size`
    centred at (x * stride, y * stride) (detectron2's grid, offset 0), in
    row-major (y, x) order with A innermost. Cached: a frame of the same
    size copies nothing to the device."""
    h, w = hw
    ws, hs = [], []
    for ratio in ANCHOR_RATIOS:
        aw = math.sqrt(size * size / ratio)
        ws.append(aw)
        hs.append(aw * ratio)
    wt = torch.tensor(ws, dtype=torch.float32)
    ht = torch.tensor(hs, dtype=torch.float32)
    base = torch.stack([-wt / 2, -ht / 2, wt / 2, ht / 2], dim=-1).to(device)  # (A, 4)
    sx = torch.arange(w, dtype=torch.float32, device=device) * stride
    sy = torch.arange(h, dtype=torch.float32, device=device) * stride
    gx, gy = torch.meshgrid(sx, sy, indexing="xy")
    shift = torch.stack([gx, gy, gx, gy], dim=-1).reshape(h * w, 1, 4)
    return (shift + base[None]).reshape(-1, 4)


class _Node(nn.Module):
    """A container, so that state-dict keys nest as detectron2's do."""


class MaskRCNN(nn.Module):
    """The inference graph: images (B, 3, H, W) RGB in [0, 1] -> dict of
    boxes (B, D, 4), scores (B, D), classes (B, D) and masks
    (B, D, 28, 28) probabilities, D = MAX_DETECTIONS; an invalid slot has
    score 0."""

    def __init__(self, num_classes: int = 80, dtype=torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.backbone = ResNet50FPN(dtype=dtype)
        self.proposal_generator = _Node()
        self.proposal_generator.rpn_head = RPNHead(dtype=dtype)
        self.roi_heads = _Node()
        self.roi_heads.box_head = BoxHead(dtype=dtype)
        self.roi_heads.box_predictor = BoxPredictor(num_classes, dtype=dtype)
        self.roi_heads.mask_head = MaskHead(num_classes, dtype=dtype)
        self.register_buffer("pixel_mean", torch.tensor(PIXEL_MEAN_BGR), persistent=False)

    def features(self, images) -> List[torch.Tensor]:
        """[P2..P6] of RGB images in [0, 1]: BGR, times 255, less the pixel
        mean (no division by a std)."""
        with span("mask_rcnn.backbone"):
            x = images.flip(1) * 255.0 - self.pixel_mean[:, None, None]
            return self.backbone(x.to(self.dtype))

    def proposals(self, feats, hw) -> torch.Tensor:
        """(B, R, 4) proposals: per level the top RPN_PRE_NMS_TOPK scores,
        decoded, clipped and suppressed at RPN_NMS_THRESH (all levels in
        one batched NMS, shorter levels padded with invalid entries, which
        change no decision), then the top RPN_POST_NMS_TOPK over all
        levels, suppressed entries at -inf."""
        with span("mask_rcnn.rpn"):
            rpn_out = self.proposal_generator.rpn_head(feats)
            bsz = feats[0].shape[0]
            a = len(ANCHOR_RATIOS)
            level_boxes, level_scores, ks = [], [], []
            for i, (obj, deltas) in enumerate(rpn_out):
                fh, fw = obj.shape[-2:]
                anchors = level_anchors((fh, fw), 4 * 2 ** i, ANCHOR_SIZES[i], obj.device)
                scores = obj.permute(0, 2, 3, 1).reshape(bsz, -1)
                d = deltas.permute(0, 2, 3, 1).reshape(bsz, fh * fw * a, 4)
                k = min(RPN_PRE_NMS_TOPK, scores.shape[1])
                top_scores, top_idx = top_k(scores, k)
                top_d = torch.gather(d, 1, top_idx[..., None].expand(bsz, k, 4))
                boxes = clip_boxes(decode_boxes(anchors[top_idx], top_d), hw)
                level_boxes.append(boxes)
                level_scores.append(top_scores)
                ks.append(k)
            kmax = max(ks)
            pad = [kmax - k for k in ks]
            keep = nms_keep(
                torch.stack([F.pad(b, (0, 0, 0, p)) for b, p in zip(level_boxes, pad)], 1),
                torch.stack([F.pad(s, (0, p), value=-math.inf)
                             for s, p in zip(level_scores, pad)], 1),
                RPN_NMS_THRESH,
                valid=torch.stack([torch.arange(kmax, device=feats[0].device) < k
                                   for k in ks])[None].expand(bsz, -1, -1),
            )
            boxes = torch.cat(level_boxes, 1)
            scores = torch.cat([torch.where(keep[:, i, :k], s, -math.inf)
                                for i, (s, k) in enumerate(zip(level_scores, ks))], 1)
            _, idx = top_k(scores, min(RPN_POST_NMS_TOPK, scores.shape[1]))
            return torch.gather(boxes, 1, idx[..., None].expand(*idx.shape, 4))

    def box_outputs(self, feats, proposals):
        """Class logits (B, R, 81) and box deltas (B, R, 320) of the
        proposals."""
        bsz, r = proposals.shape[:2]
        with span("mask_rcnn.roi_align"):
            pooled = roi_align_fpn(feats, proposals, 7).reshape(bsz * r, -1, 7, 7)
        with span("mask_rcnn.heads"):
            heads = self.roi_heads
            cls_logits, deltas = heads.box_predictor(heads.box_head(pooled))
        return cls_logits.reshape(bsz, r, -1), deltas.reshape(bsz, r, -1)

    def detect(self, feats, proposals, hw):
        """Boxes (B, D, 4), scores (B, D) and classes (B, D): per-class
        decoding, the score threshold, the top 1000 candidates, batched NMS
        at ROI_NMS_THRESH and the top MAX_DETECTIONS."""
        cls_logits, box_deltas = self.box_outputs(feats, proposals)
        with span("mask_rcnn.detect"):
            bsz, r = proposals.shape[:2]
            nc = self.num_classes
            probs = torch.softmax(cls_logits, dim=-1)[..., :-1]  # drop background
            det_boxes = clip_boxes(decode_boxes(proposals[:, :, None, :],
                                                box_deltas.reshape(bsz, r, nc, 4),
                                                weights=BBOX_REG_WEIGHTS), hw)
            flat_boxes = det_boxes.reshape(bsz, -1, 4)
            flat_scores = probs.reshape(bsz, -1)
            flat_cls = torch.arange(nc, device=probs.device).repeat(r)
            valid = flat_scores > ROI_SCORE_THRESH
            cand_scores, cand_idx = top_k(torch.where(valid, flat_scores, -math.inf),
                                          min(1000, flat_scores.shape[1]))
            cand_boxes = torch.gather(flat_boxes, 1, cand_idx[..., None].expand(
                *cand_idx.shape, 4))
            cand_cls = flat_cls[cand_idx]
            keep = batched_nms(cand_boxes, cand_scores, cand_cls, ROI_NMS_THRESH,
                               valid=torch.isfinite(cand_scores))
            final_scores, fidx = top_k(torch.where(keep, cand_scores, -math.inf),
                                       MAX_DETECTIONS)
            final_boxes = torch.gather(cand_boxes, 1, fidx[..., None].expand(*fidx.shape, 4))
            final_cls = torch.gather(cand_cls, 1, fidx)
            final_scores = torch.where(torch.isfinite(final_scores), final_scores, 0.0)
        return final_boxes, final_scores, final_cls

    def mask_probs(self, feats, boxes, classes):
        """(B, D, 28, 28) mask probabilities of each box's class."""
        bsz, d = boxes.shape[:2]
        with span("mask_rcnn.roi_align"):
            pooled = roi_align_fpn(feats, boxes, 14).reshape(bsz * d, -1, 14, 14)
        with span("mask_rcnn.heads"):
            logits = self.roi_heads.mask_head(pooled)  # (B*D, 80, 28, 28)
            sel = torch.gather(logits, 1, classes.reshape(-1, 1, 1, 1).expand(-1, 1, 28, 28))
        return torch.sigmoid(sel).reshape(bsz, d, 28, 28)

    def forward(self, images) -> Dict[str, torch.Tensor]:
        hw = tuple(images.shape[-2:])
        feats = self.features(images)
        proposals = self.proposals(feats, hw)
        boxes, scores, classes = self.detect(feats, proposals, hw)
        masks = self.mask_probs(feats, boxes, classes)
        return {"boxes": boxes, "scores": scores, "classes": classes, "masks": masks}


def paste_masks(masks, boxes, hw: Tuple[int, int], threshold: float = 0.5):
    """(..., D, 28, 28) masks + (..., D, 4) boxes -> (..., D, H, W) bool
    over the whole image grid, in float32 without TF32.

    Zero-padded bilinear is separable: value(x, y) = sum_k sum_l
    hat(my - k) hat(mx - l) m[k, l] with hat(t) = max(0, 1 - |t|), so the
    paste is two matrix products a detection, (H, 28) @ (28, 28) @ (28, W);
    a pixel is set where the value exceeds `threshold` inside the box."""
    h, w = hw
    ms = masks.shape[-1]
    dev = masks.device
    x = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    y = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    x0, y0, x1, y1 = (t[..., None] for t in boxes.float().unbind(-1))
    bw = (x1 - x0).clamp(min=1e-6)
    bh = (y1 - y0).clamp(min=1e-6)
    mx = (x - x0) / bw * ms - 0.5  # (..., D, W)
    my = (y - y0) / bh * ms - 0.5  # (..., D, H)
    k = torch.arange(ms, dtype=torch.float32, device=dev)
    wy = (1.0 - (my[..., None] - k).abs()).clamp(min=0.0)  # (..., D, H, ms)
    wx = (1.0 - (mx[..., None] - k).abs()).clamp(min=0.0)  # (..., D, W, ms)
    with float32_precision(torch.backends.cudnn.allow_tf32):
        vals = (wy @ masks.float()) @ wx.transpose(-1, -2)
    inside = ((x >= x0) & (x <= x1))[..., None, :] & ((y >= y0) & (y <= y1))[..., :, None]
    return (vals > threshold) & inside


def dynamic_mask_from_detections(det: Dict, hw: Tuple[int, int],
                                 score_thresh: float = ROI_SCORE_THRESH):
    """Union of the pasted masks of the dynamic COCO categories ->
    (..., H, W) bool, True = DYNAMIC (the caller dilates and inverts, as
    the reference does, dynamic_mask_generation.py:156-182)."""
    cls = det["classes"]
    dyn = torch.zeros_like(cls, dtype=torch.bool)
    for lo, hi in _DYNAMIC_RANGES:
        dyn |= (cls >= lo) & (cls < hi)
    sel = dyn & (det["scores"] > score_thresh)
    with span("mask_rcnn.paste"):
        pasted = paste_masks(det["masks"], det["boxes"], hw)
        return (pasted & sel[..., None, None]).any(dim=-3)


# --------------------------------------------------------------------------
# Weights
# --------------------------------------------------------------------------


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A detectron2 model-zoo checkpoint: a pickle of numpy arrays,
    {"model": {key: ndarray}, "__author__": ...}, read with latin1 (the
    zoo's files come from Python 2); its "model" entry as float32 tensors."""
    with open(path, "rb") as f:
        blob = pickle.load(f, encoding="latin1")
    sd = blob.get("model", blob) if isinstance(blob, dict) else blob
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def load_weights_(net: MaskRCNN, sd: Dict[str, torch.Tensor]) -> MaskRCNN:
    """Loads the module's keys from `sd`: a missing key raises KeyError,
    keys of no module parameter (a zoo pickle's extras) are left out."""
    net.load_state_dict({k: sd[k] for k in net.state_dict()})
    return net


def seeded_init_(net: MaskRCNN, seed: int) -> MaskRCNN:
    """Random weights from a seed, for runs without a checkpoint:
    He-normal convolutions and linear layers with zero biases, identity
    FrozenBN statistics with the last norm of each bottleneck scaled to
    0.2 (keeps 16 residual blocks from blowing up), the stem scaled by
    1/64 (pixels come in at detectron2's 0-255 scale), and the RPN's and
    box predictor's layers by 0.01, so that features stay near 1 and
    proposals and detections near their anchors."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in net.named_modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * (2.0 / fan_in) ** 0.5)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, FrozenBN):
                m.weight.fill_(0.2 if name.endswith("conv3.norm") else 1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        net.backbone.bottom_up.stem.conv1.weight.mul_(1 / 64)
        rpn = net.proposal_generator.rpn_head
        rpn.objectness_logits.weight.mul_(0.01)
        rpn.anchor_deltas.weight.mul_(0.01)
        pred = net.roi_heads.box_predictor
        pred.cls_score.weight.mul_(0.01)
        pred.bbox_pred.weight.mul_(0.01)
    return net


def state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """Flax MaskRCNN params (numpy trees) -> this module's state_dict.

    The inverse of robust_cvd_tpu/models/torch_port.py::
    convert_mask_rcnn_r50fpn: convolution kernels HWIO -> OIHW, the
    ConvTranspose kernel (kh, kw, out, in) -> (in, out, kh, kw), dense
    kernels transposed, fc1's (7, 7, C) flatten back to torch's (C, 7, 7).
    A folded FrozenBN (scale, bias) becomes weight = scale, bias, mean 0
    and var = 1 - eps, which folds back to the same scale and bias."""
    sd: Dict[str, torch.Tensor] = {}

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    def put_conv(key, node):
        sd[key + ".weight"] = t(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
        if "bias" in node:
            sd[key + ".bias"] = t(node["bias"])

    def put_bn(key, node):
        c = np.asarray(node["scale"]).shape[0]
        sd[key + ".weight"] = t(node["scale"])
        sd[key + ".bias"] = t(node["bias"])
        sd[key + ".running_mean"] = torch.zeros(c)
        sd[key + ".running_var"] = torch.full((c,), 1.0 - np.float32(BN_EPS))

    def put_dense(key, node, spatial=None):
        k = np.asarray(node["kernel"])
        if spatial is not None:
            c, h, w = spatial
            k = k.reshape(h, w, c, -1).transpose(3, 2, 0, 1).reshape(-1, c * h * w)
        else:
            k = k.T
        sd[key + ".weight"] = t(k)
        sd[key + ".bias"] = t(node["bias"])

    bb, pb = "backbone.bottom_up", params["backbone"]
    put_conv(f"{bb}.stem.conv1", pb["stem_conv1"])
    put_bn(f"{bb}.stem.conv1.norm", pb["stem_bn1"])
    for stage, blocks in zip((2, 3, 4, 5), (3, 4, 6, 3)):
        for b in range(blocks):
            node, dst = pb[f"res{stage}_{b}"], f"{bb}.res{stage}.{b}"
            for i in (1, 2, 3):
                put_conv(f"{dst}.conv{i}", node[f"conv{i}"])
                put_bn(f"{dst}.conv{i}.norm", node[f"bn{i}"])
            if "downsample_conv" in node:
                put_conv(f"{dst}.shortcut", node["downsample_conv"])
                put_bn(f"{dst}.shortcut.norm", node["downsample_bn"])
    for lvl in (2, 3, 4, 5):
        put_conv(f"backbone.fpn_lateral{lvl}", pb[f"fpn_lateral{lvl}"])
        put_conv(f"backbone.fpn_output{lvl}", pb[f"fpn_output{lvl}"])
    for name in ("conv", "objectness_logits", "anchor_deltas"):
        put_conv(f"proposal_generator.rpn_head.{name}", params["rpn"][name])
    bh = params["box_head"]
    put_dense("roi_heads.box_head.fc1", bh["fc1"], spatial=(256, 7, 7))
    put_dense("roi_heads.box_head.fc2", bh["fc2"])
    put_dense("roi_heads.box_predictor.cls_score", bh["cls_score"])
    put_dense("roi_heads.box_predictor.bbox_pred", bh["bbox_pred"])
    mh = params["mask_head"]
    for i in range(1, 5):
        put_conv(f"roi_heads.mask_head.mask_fcn{i}", mh[f"mask_fcn{i}"])
    sd["roi_heads.mask_head.deconv.weight"] = t(
        np.transpose(np.asarray(mh["deconv"]["kernel"]), (3, 2, 0, 1)))
    sd["roi_heads.mask_head.deconv.bias"] = t(mh["deconv"]["bias"])
    put_conv("roi_heads.mask_head.predictor", mh["predictor"])
    return sd
