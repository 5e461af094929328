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

BatchNorm follows Flax's semantics (the JAX package's network): eval mode
normalises with the running statistics (eps 1e-5); train mode normalises
with the batch's biased statistics and leaves the running statistics alone
until `commit_batch_stats` applies Flax's update, running = 0.9 running +
0.1 batch, with the BIASED batch variance (torch's own BatchNorm2d would
fold in the unbiased one) and only where the step's guard flag is set.
Within `per_slice_batch_stats(net, g)` a train-mode batch of g equal
slices normalises each slice with its own statistics (the per-pair eval,
which the JAX package runs one pair at a time). Within
`global_batch_stats(net, mesh)` train mode takes its statistics over the
batches of every rank of a data mesh (parallel/mesh.py), as the JAX
package's jit does over a sharded batch.
"""

from __future__ import annotations

import re
from contextlib import contextmanager
from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import constant, float32_precision
from .layers import upsample2x

# ImageNet normalization (reference midas_v2_model.py:41-42).
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """[0,1] RGB (..., 3) -> ImageNet-normalized (reference
    midas_v2_model.py:50-52)."""
    mean = constant(IMAGENET_MEAN, images.device, images.dtype)
    std = constant(IMAGENET_STD, images.device, images.dtype)
    return (images - mean) / std


BN_MOMENTUM = 0.9  # Flax's convention: running = 0.9 * running + 0.1 * batch


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (same state-dict keys) with Flax's train mode.

    In train mode the forward normalises with the batch mean and biased
    variance and records them in `batch_stats`; the running buffers change
    only through `commit_batch_stats`. Flax computes the variance as
    E[x^2] - E[x]^2 clipped at 0, torch's kernel by a two-pass/Welford sum:
    the same biased variance up to rounding. The batch statistics come out
    of the fused batch_norm call itself (scratch running buffers at momentum
    1 receive the batch mean and the unbiased variance, which is rescaled
    by (n - 1) / n), so train mode adds no pass over the activations."""

    batch_stats = None
    # > 1: train mode normalises each of this many equal slices of the batch
    # with its own statistics and records none (see per_slice_batch_stats)
    stat_slices = 1
    # a parallel.mesh.Mesh: train mode takes the global batch's statistics
    # (see global_batch_stats)
    mesh = None

    def forward(self, x):
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            )
        if self.stat_slices > 1:
            # (G*K, C, H, W) -> (K, G*C, H, W): slice g's channels become
            # channels of their own, so one fused call gives each slice its
            # own statistics
            g = self.stat_slices
            n, c, h, w = x.shape
            xs = x.reshape(g, n // g, c, h, w).transpose(0, 1).reshape(n // g, g * c, h, w)
            y = F.batch_norm(xs, None, None, self.weight.repeat(g), self.bias.repeat(g),
                             True, 0.0, self.eps)
            return y.reshape(n // g, g, c, h, w).transpose(0, 1).reshape(n, c, h, w)
        if self.mesh is not None:
            return self._global_forward(x)
        mean = x.new_zeros(self.num_features)
        var = x.new_zeros(self.num_features)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // self.num_features
        self.batch_stats = (mean, var * ((n - 1) / n))
        return y

    def _global_forward(self, x):
        """Train mode over the mesh's global batch: one differentiable
        all-reduce of the per-channel sums of x and x^2 and the element
        count, then Flax's statistics, mean E[x] and biased variance
        max(E[x^2] - E[x]^2, 0). The backward sums each rank's gradient of
        the statistics over the ranks, so the gradients are those of the
        global batch's loss."""
        c = self.num_features
        sums = torch.cat([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3)),
                          x.new_full((1,), x.numel() // c)])
        sums = self.mesh.all_reduce_sum(sums)
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c : 2 * c] / sums[-1] - mean * mean, min=0.0)
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        self.batch_stats = (mean.detach(), var.detach())
        return y


def batch_norms(net: nn.Module) -> list:
    return [m for m in net.modules() if isinstance(m, BatchNorm2d)]


@contextmanager
def per_slice_batch_stats(net: nn.Module, slices: int):
    """Within the block, a train-mode forward of a batch of `slices` equal
    slices normalises each slice with its own batch statistics, as if each
    went through the net alone, and records no statistics to commit."""
    layers = batch_norms(net)
    for m in layers:
        m.stat_slices = slices
    try:
        yield
    finally:
        for m in layers:
            m.stat_slices = 1
            m.batch_stats = None


@contextmanager
def global_batch_stats(net: nn.Module, mesh):
    """Within the block, a train-mode forward takes its BatchNorm statistics
    over the batches of every rank of `mesh` (nothing changes for None)."""
    layers = batch_norms(net) if mesh is not None else []
    for m in layers:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in layers:
            m.mesh = None


def commit_batch_stats(net: nn.Module, ok: torch.Tensor) -> None:
    """Fold the last train-mode forward's batch statistics into the
    running statistics (Flax's update) where the device bool `ok` is set,
    and keep them bitwise where it is not (the step's non-finite guard,
    robust_cvd_tpu/training/fine_tune.py:307). One concatenated update, so
    the cost does not grow with the number of layers; no host sync."""
    layers = [m for m in batch_norms(net) if m.batch_stats is not None]
    if not layers:
        return
    with torch.no_grad():
        running = [m.running_mean for m in layers] + [m.running_var for m in layers]
        batch = [m.batch_stats[0] for m in layers] + [m.batch_stats[1] for m in layers]
        old = torch.cat(running)
        new = BN_MOMENTUM * old + (1 - BN_MOMENTUM) * torch.cat(batch)
        upd = torch.where(ok, new, old)
        torch._foreach_copy_(running, list(upd.split([t.numel() for t in running])))
    for m in layers:
        m.batch_stats = None


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


class ResidualConvUnit(nn.Module):
    """reference blocks.py:88-128: relu, 3x3, relu, 3x3, plus the skip.

    With `relu_skip` (MiDaS v2) the skip adds relu(x), not x: the
    reference's inplace ReLU rewrites x before `out + x` runs, and the
    released checkpoints were trained that way (robust_cvd_tpu/models/
    midas.py::ResidualConvUnit). DPT's unit (isl-org/DPT dpt/blocks.py
    ResidualConvUnit_custom, whose ReLU is not in place) adds x."""

    def __init__(self, features: int, relu_skip: bool = True):
        super().__init__()
        self.relu_skip = relu_skip
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        y = F.relu(x)
        return self.conv2(F.relu(self.conv1(y))) + (y if self.relu_skip else x)


class FeatureFusionBlock(nn.Module):
    """reference blocks.py:131-160: optional skip-add through an RCU, an
    RCU, then 2x bilinear upsample with align_corners=True. refinenet4 gets
    no skip, so its resConfUnit1 is dead weight the checkpoint carries.

    DPT's block (dpt/blocks.py FeatureFusionBlock_custom) is the same with
    units that add x (`relu_skip=False`) and a 1x1 convolution with bias
    after the upsample (`out_conv=True`)."""

    def __init__(self, features: int, relu_skip: bool = True, out_conv: bool = False):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features, relu_skip)
        self.resConfUnit2 = ResidualConvUnit(features, relu_skip)
        self.out_conv = nn.Conv2d(features, features, 1) if out_conv else None

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = upsample2x(self.resConfUnit2(x), align_corners=True)
        return x if self.out_conv is None else self.out_conv(x)


class _Upsample2x(nn.Module):
    """The output head's 2x upsample: align_corners=False in MiDaS v2
    (reference blocks.py:54-85), True in DPT (dpt/models.py's head)."""

    def __init__(self, align_corners: bool = False):
        super().__init__()
        self.align_corners = align_corners

    def forward(self, x):
        return upsample2x(x, align_corners=self.align_corners)


def output_head(features: int, mid: int, align_corners: bool) -> nn.Sequential:
    """The disparity head `scratch.output_conv`: 3x3 to `mid`, 2x bilinear
    upsample, 3x3 to 32, ReLU, 1x1 to 1, ReLU (non-negative disparity).
    MiDaS v2: mid 128, align_corners False; DPT: mid features // 2, True."""
    return nn.Sequential(
        nn.Conv2d(features, mid, 3, padding=1),
        _Upsample2x(align_corners),
        nn.Conv2d(mid, 32, 3, padding=1),
        nn.ReLU(),
        nn.Conv2d(32, 1, 1),
        nn.ReLU(),
    )


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


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A midas_v21 checkpoint's state dict, without DataParallel prefixes."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


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


def disparity_to_depth(disparity: torch.Tensor, epsilon: float = 1e-7) -> torch.Tensor:
    """(reference midas_v2_model.py:60-62)."""
    return 1.0 / (disparity + epsilon)


def depth_apply(net: nn.Module, images: torch.Tensor) -> torch.Tensor:
    """Whole-batch inference: normalize + forward + disparity -> depth.
    images: (B, H, W, 3) in [0, 1], the JAX package's layout -> depth
    (B, H, W). The normalisation is the net's own (`net.normalize`)."""
    x = net.normalize(images).permute(0, 3, 1, 2).contiguous()
    return disparity_to_depth(net(x))


class MidasV2Adapter:
    """Model adapter: requirements + the network + batched whole-clip
    inference (reference monodepth/midas_v2_model.py class attributes and
    estimate_depth). Registered as `midas2` (models/registry.py).

    Every adapter names its checkpoint file under `<clip>/models/` and the
    environment variable that may point at it instead, how to build its
    net and read its checkpoint, and whether its net runs float32 matrix
    products in TF32 (`matmul_tf32`; MiDaS v2 has none to speak of, its
    convolutions take cuDNN's setting). The input normalisation is the
    net's (`net.normalize`), so a net never meets another model's."""

    align = 32
    learning_rate = 1e-6
    lambda_view_baseline = 1e-4
    checkpoint = "midas_v21-f6b98070.pt"
    checkpoint_env = "MIDAS_CHECKPOINT"
    matmul_tf32 = False
    read_checkpoint = staticmethod(load_checkpoint)

    def __init__(self, net: nn.Module | None = None):
        self.net = self.new_net() if net is None else net

    @staticmethod
    def new_net() -> nn.Module:
        return MidasNet()

    @classmethod
    def from_checkpoint(cls, path: str):
        net = cls.new_net()
        net.load_state_dict(cls.read_checkpoint(path))
        return cls(net)

    def estimate_depth(self, images: torch.Tensor, scales=None) -> torch.Tensor:
        """images: (B, H, W, 3) in [0, 1] on the net's device -> depth
        (B, H, W), in eval mode (running BatchNorm statistics) without
        gradients, matrix products in TF32 where `matmul_tf32`; `scales`
        divides the disparity first."""
        training = self.net.training
        self.net.eval()
        try:
            with torch.no_grad(), float32_precision(torch.backends.cudnn.allow_tf32,
                                                    self.matmul_tf32):
                disparity = self.net(self.net.normalize(images).permute(0, 3, 1, 2).contiguous())
                return disparity_to_depth(disparity if scales is None else disparity / scales)
        finally:
            self.net.train(training)
