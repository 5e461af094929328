"""MiDaS-v2.1 monocular depth network (PyTorch, NCHW).

Port of robust_cvd_tpu/models/midas.py, itself a re-implementation of the
reference's MiDaS stack (reference monodepth/midas_v2/midas_net.py:13-75,
blocks.py:12-160, midas_v2_model.py:16-67): ResNeXt-101 32x8d backbone +
RefineNet-style fusion decoder + disparity head.

Module names follow the original checkpoint's state-dict keys
(`pretrained.layer1.0`, ..., `scratch.refinenet4.resConfUnit1.conv1`,
`scratch.output_conv.0`), so a real `midas_v21-f6b98070.pt` loads with
`load_state_dict`. The grouped 3x3 convolutions are plain `groups=32`
convolutions: the JAX package's merge/block_dense/im2col lowerings are
TPU workarounds for the same function.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import constant
from .depth_model import DepthModel, depth_apply  # noqa: F401 (cvd_bench's tests import it here)
from .layers import BatchNorm2d, FeatureFusionBlock, output_head

# ImageNet normalization (reference midas_v2_model.py:41-42).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB (..., 3) -> ImageNet-normalized (reference
    midas_v2_model.py:50-52)."""
    mean = constant(IMAGENET_MEAN, images.device, images.dtype)
    std = constant(IMAGENET_STD, images.device, images.dtype)
    return (images - mean) / std


class Bottleneck(nn.Module):
    """torchvision ResNeXt bottleneck (groups=32, width/group=8): 1x1
    reduce -> grouped 3x3 (stride here) -> 1x1 expand, BN after each,
    projection shortcut on the first block of a stage."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 groups: int = 32, base_width: int = 8):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        out = planes * 4
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = nn.Conv2d(
            width, width, 3, stride=stride, padding=1, groups=groups, bias=False
        )
        self.bn2 = BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = BatchNorm2d(out)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out, 1, stride=stride, bias=False),
                BatchNorm2d(out),
            )

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + identity)


class MidasNet(nn.Module):
    """Full MiDaS-v2: (B, 3, H, W) normalized RGB -> (B, H, W) disparity.
    `normalize` is the input normalisation its weights were trained with.

    backbone_layers (3, 4, 23, 3) is ResNeXt-101; smaller depths give the
    same structure for tests."""

    normalize = staticmethod(normalize_images)

    def __init__(self, features: int = 256,
                 backbone_layers: Sequence[int] = (3, 4, 23, 3)):
        super().__init__()

        def stage(inplanes, planes, blocks, stride):
            mods = [Bottleneck(inplanes, planes, stride)]
            mods += [Bottleneck(planes * 4, planes) for _ in range(1, blocks)]
            return nn.Sequential(*mods)

        l1, l2, l3, l4 = backbone_layers
        self.pretrained = nn.Module()
        self.pretrained.layer1 = nn.Sequential(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False),
            BatchNorm2d(64),
            nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1),
            stage(64, 64, l1, 1),
        )
        self.pretrained.layer2 = stage(256, 128, l2, 2)
        self.pretrained.layer3 = stage(512, 256, l3, 2)
        self.pretrained.layer4 = stage(1024, 512, l4, 2)

        self.scratch = nn.Module()
        for k, cin in zip(range(1, 5), (256, 512, 1024, 2048)):
            setattr(self.scratch, f"layer{k}_rn",
                    nn.Conv2d(cin, features, 3, padding=1, bias=False))
        for k in range(1, 5):
            setattr(self.scratch, f"refinenet{k}", FeatureFusionBlock(features))
        self.scratch.output_conv = output_head(features, 128, align_corners=False)

    def forward(self, x):
        p, s = self.pretrained, self.scratch
        l1 = p.layer1(x)
        l2 = p.layer2(l1)
        l3 = p.layer3(l2)
        l4 = p.layer4(l3)
        p4 = s.refinenet4(s.layer4_rn(l4))
        p3 = s.refinenet3(p4, s.layer3_rn(l3))
        p2 = s.refinenet2(p3, s.layer2_rn(l2))
        p1 = s.refinenet1(p2, s.layer1_rn(l1))
        return s.output_conv(p1)[:, 0]


def seeded_init_(net: MidasNet, seed: int) -> MidasNet:
    """Random weights from a seed, for runs without a checkpoint: He-normal
    convolutions, identity BatchNorm statistics with the last BN of each
    bottleneck scaled to 0.2 (keeps 33 residual blocks from blowing up),
    and an output head biased to disparity ~2, so that depth stays finite
    and positive."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in net.named_modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=g) * (2.0 / fan_in) ** 0.5
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(0.2 if name.endswith("bn3") else 1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        head = net.scratch.output_conv[4]
        head.weight.mul_(0.01)
        head.bias.fill_(2.0)
    return net


def state_dict_from_jax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """Flax MidasNet variables (numpy trees) -> this module's state_dict.

    The inverse of robust_cvd_tpu/models/torch_port.py::convert_midas_v2:
    convolution kernels HWIO -> OIHW (grouped kernels are stored grouped by
    both, (3, 3, C/32, F) -> (F, C/32, 3, 3)); BatchNorm scale/bias/mean/var
    -> weight/bias/running_mean/running_var. refinenet4's unused
    resConfUnit1 has no Flax counterpart and is filled with zeros."""
    sd: Dict[str, torch.Tensor] = {}

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    def put_conv(key, node):
        sd[key + ".weight"] = t(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
        if "bias" in node:
            sd[key + ".bias"] = t(node["bias"])

    def put_bn(key, pnode, snode):
        sd[key + ".weight"] = t(pnode["scale"])
        sd[key + ".bias"] = t(pnode["bias"])
        sd[key + ".running_mean"] = t(snode["mean"])
        sd[key + ".running_var"] = t(snode["var"])
        sd[key + ".num_batches_tracked"] = torch.tensor(0)

    pp, ps = params["pretrained"], batch_stats["pretrained"]
    put_conv("pretrained.layer1.0", pp["conv1"])
    put_bn("pretrained.layer1.1", pp["bn1"], ps["bn1"])
    for stage in range(1, 5):
        prefix = "pretrained.layer1.4" if stage == 1 else f"pretrained.layer{stage}"
        b = 0
        while f"layer{stage}_{b}" in pp:
            src_p, src_s = pp[f"layer{stage}_{b}"], ps[f"layer{stage}_{b}"]
            dst = f"{prefix}.{b}"
            for c in ("conv1", "conv2", "conv3"):
                put_conv(f"{dst}.{c}", src_p[c])
            for bn in ("bn1", "bn2", "bn3"):
                put_bn(f"{dst}.{bn}", src_p[bn], src_s[bn])
            if "downsample_conv" in src_p:
                put_conv(f"{dst}.downsample.0", src_p["downsample_conv"])
                put_bn(f"{dst}.downsample.1", src_p["downsample_bn"],
                       src_s["downsample_bn"])
            b += 1

    for k in range(1, 5):
        put_conv(f"scratch.layer{k}_rn", params[f"layer{k}_rn"])
    for k in range(1, 5):
        node = params[f"refinenet{k}"]
        for c in ("conv1", "conv2"):
            prefix = f"scratch.refinenet{k}"
            put_conv(f"{prefix}.resConfUnit2.{c}", node["resConfUnit2"][c])
            if "resConfUnit1" in node:
                put_conv(f"{prefix}.resConfUnit1.{c}", node["resConfUnit1"][c])
            else:
                w = sd[f"{prefix}.resConfUnit2.{c}.weight"]
                sd[f"{prefix}.resConfUnit1.{c}.weight"] = torch.zeros_like(w)
                sd[f"{prefix}.resConfUnit1.{c}.bias"] = torch.zeros(w.shape[0])

    put_conv("scratch.output_conv.0", params["output_conv1"])
    put_conv("scratch.output_conv.2", params["output_conv2"])
    put_conv("scratch.output_conv.4", params["output_conv3"])
    return sd


class MidasV2Adapter(DepthModel):
    """MiDaS v2.1 (reference monodepth/midas_v2_model.py class attributes),
    registered as `midas2`; it has no matrix products to speak of."""

    align = 32
    learning_rate = 1e-6
    lambda_view_baseline = 1e-4
    checkpoint = "midas_v21-f6b98070.pt"
    checkpoint_env = "MIDAS_CHECKPOINT"

    @staticmethod
    def new_net() -> nn.Module:
        return MidasNet()
