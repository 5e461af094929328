"""Plain MiDaS-v2 (Ranftl et al., TPAMI 2020): ResNeXt-101 32x8d encoder,
RefineNet-style fusion decoder with 256 features, disparity head.

A frozen copy of the benchmark's reference, after the reference code's
monodepth/midas_v2 (midas_net.py, blocks.py). Module names are the
original checkpoint's state-dict keys. BatchNorm follows the fine-tune's
train mode: a train-mode forward normalises with the batch's biased
statistics (the running statistics are read only in eval mode, and three
steps never read them). Float32; the caller sets the precision.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Bottleneck(nn.Module):
    """ResNeXt bottleneck (groups 32, width 8 a group)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        width = int(planes * (8 / 64.0)) * 32
        out = planes * 4
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1, groups=32, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = None
        if stride != 1 or inplanes != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(inplanes, out, 1, stride=stride, bias=False), nn.BatchNorm2d(out))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        return F.relu(self.bn3(self.conv3(y)) + identity)


class ResidualConvUnit(nn.Module):
    """The skip adds relu(x): the reference's in-place ReLU rewrites x
    before the sum."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        x = F.relu(x)
        return self.conv2(F.relu(self.conv1(x))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return F.interpolate(self.resConfUnit2(x), scale_factor=2, mode="bilinear",
                             align_corners=True)


class Upsample2x(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


class MidasNet(nn.Module):
    """(B, 3, H, W) normalised RGB -> (B, H, W) disparity."""

    def __init__(self, features: int = 256, backbone_layers: Sequence[int] = (3, 4, 23, 3)):
        super().__init__()

        def stage(inplanes, planes, blocks, stride):
            mods = [Bottleneck(inplanes, planes, stride)]
            mods += [Bottleneck(planes * 4, planes) for _ in range(1, blocks)]
            return nn.Sequential(*mods)

        l1, l2, l3, l4 = backbone_layers
        self.pretrained = nn.Module()
        self.pretrained.layer1 = nn.Sequential(
            nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False), nn.BatchNorm2d(64), nn.ReLU(),
            nn.MaxPool2d(3, stride=2, padding=1), stage(64, 64, l1, 1))
        self.pretrained.layer2 = stage(256, 128, l2, 2)
        self.pretrained.layer3 = stage(512, 256, l3, 2)
        self.pretrained.layer4 = stage(1024, 512, l4, 2)
        self.scratch = nn.Module()
        for k, cin in zip(range(1, 5), (256, 512, 1024, 2048)):
            setattr(self.scratch, f"layer{k}_rn", nn.Conv2d(cin, features, 3, padding=1, bias=False))
        for k in range(1, 5):
            setattr(self.scratch, f"refinenet{k}", FeatureFusionBlock(features))
        self.scratch.output_conv = nn.Sequential(
            nn.Conv2d(features, 128, 3, padding=1), Upsample2x(),
            nn.Conv2d(128, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU())

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


def normalize(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB (..., H, W, 3) -> ImageNet-normalised (..., 3, H, W)."""
    mean = images.new_tensor(IMAGENET_MEAN)
    std = images.new_tensor(IMAGENET_STD)
    x = (images - mean) / std
    return x.movedim(-1, -3).contiguous()


def depth(net: MidasNet, images: torch.Tensor) -> torch.Tensor:
    """Depth (B, H, W) = 1 / (disparity + 1e-7) of images (B, H, W, 3)."""
    return 1.0 / (net(normalize(images)) + 1e-7)
