"""RAFT optical flow (PyTorch, NCHW).

Port of robust_cvd_tpu/models/raft.py, itself a re-implementation of the
reference's vendored RAFT (raft/core/raft.py:13-116, corr.py:9-56,
update.py:8-156, extractor.py:8-198): feature and context encoders, the
all-pairs correlation pyramid with a radius-4 bilinear lookup, the
SepConvGRU update block and the convex 8x upsampling.

Module names are the upstream checkpoint's state-dict keys
(`fnet.layer1.0.conv1`, `cnet.layer2.0.norm3` with its alias
`cnet.layer2.0.downsample.1`, `update_block.mask.0`, ...), so
`raft-things.pth` loads as it is.

Precision follows the JAX package's `dtype` switch (bfloat16 by default,
as the JAX package runs): convolutions run in `dtype`; instance-norm and
BatchNorm statistics, lookup weights, coordinates, the flow head's output
and the upsampling mask are float32; the pyramid is stored in `dtype`
with float32 accumulation. At float32, run under
`device.float32_precision(False)` so that TF32 enters neither the matrix
products nor the convolutions.

What the JAX package lowered for the TPU and this port does not copy:
the lookup's hat-selector matmuls (here a 10x10 gather per query and
level, then the same two linear interpolations), the per-channel unrolled
convex upsample, and `nn.scan` over the iterations (a Python loop; the
upsampling mask is only computed in the last iteration, the only one whose
mask is used).
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """nn.InstanceNorm2d(affine=False) of (B, C, H, W): per sample and
    channel over H, W, biased variance, statistics in float32 whatever
    the compute dtype."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    var, mean = torch.var_mean(xf, dim=(-2, -1), keepdim=True, correction=0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d (same state-dict keys) that computes in `self.dtype`."""

    dtype = torch.float32

    def forward(self, x):
        dt = self.dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d in eval mode (running statistics, eps 1e-5) whatever
    the module's mode, computed in its statistics' dtype (float32) and
    returned in the input's (Flax's BatchNorm promotes to its float32
    statistics)."""

    def forward(self, x):
        return F.batch_norm(
            x.to(self.running_mean.dtype), self.running_mean, self.running_var, self.weight,
            self.bias, False, 0.0, self.eps,
        ).to(x.dtype)


class InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


def _norm(kind: str, planes: int) -> nn.Module:
    return BatchNorm2d(planes) if kind == "batch" else InstanceNorm()


class ResidualBlock(nn.Module):
    """reference extractor.py:8-60. With stride 2 the shortcut is a 1x1
    conv plus `norm3`, registered both as `norm3` and as `downsample.1`
    like upstream (the checkpoint carries both keys)."""

    def __init__(self, in_planes: int, planes: int, norm: str, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm, planes)
        self.norm2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm, planes)
            self.downsample = nn.Sequential(
                Conv2d(in_planes, planes, 1, stride=stride), self.norm3
            )

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    """reference extractor.py:126-198: 7x7/2 stem, three stages of two
    residual blocks (64, 96/2, 128/2), 1x1 output conv; stride 8. fnet
    uses instance norm, cnet BatchNorm with running statistics."""

    def __init__(self, output_dim: int = 256, norm: str = "instance"):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, 64)
        dims = ((64, 1), (96, 2), (128, 2))
        cin = 64
        for i, (dim, stride) in enumerate(dims, start=1):
            setattr(self, f"layer{i}", nn.Sequential(
                ResidualBlock(cin, dim, norm, stride), ResidualBlock(dim, dim, norm, 1)
            ))
            cin = dim
        self.conv2 = Conv2d(128, output_dim, 1)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.layer3(self.layer2(self.layer1(y)))
        return self.conv2(y)


def build_corr_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4) -> List[torch.Tensor]:
    """All-pairs correlation pyramid (reference corr.py:14-24, 49-56).

    fmap1, fmap2: (B, D, H, W). Returns a list of (B, H*W, h_i, w_i) with
    (h_i, w_i) = (H, W) floor-halved i times. Average-pooling the volume
    over the second image equals correlating against the 2x2-pooled second
    feature map (pooling is linear), so each level is one batched matrix
    product. Pooling runs in float32 with floor semantics; a level that
    floors to an empty map stays empty (48x64 input: 6x8 -> 3x4 -> 1x2 ->
    0x1) and its lookup yields zeros. Products accumulate in float32 and
    are stored in the features' dtype. The 1/sqrt(D) scale is folded into
    fmap1: for RAFT's D = 256 it is 1/16, a power of two, so the fold is
    exact and the bf16 product is rounded once, as in the JAX package."""
    B, D, H, W = fmap1.shape
    f1 = fmap1.flatten(2).transpose(1, 2) * (1.0 / float(np.sqrt(D)))  # (B, Q, D)
    f2 = fmap2
    pyramid = []
    for i in range(num_levels):
        h2, w2 = f2.shape[-2:]
        corr = torch.matmul(f1, f2.flatten(2))  # (B, Q, h2*w2)
        pyramid.append(corr.reshape(B, H * W, h2, w2))
        if i + 1 < num_levels:
            if h2 // 2 == 0 or w2 // 2 == 0:
                f2 = f2.new_zeros((B, D, h2 // 2, w2 // 2))
            else:
                f2 = F.avg_pool2d(f2.float(), 2).to(f2.dtype)
    return pyramid


def lookup_corr(pyramid: List[torch.Tensor], coords: torch.Tensor,
                radius: int = 4, dtype=torch.bfloat16) -> torch.Tensor:
    """Bilinear lookup of the pyramid around `coords` (reference
    corr.py:26-47). coords: (B, 2, H, W) float32 pixel (x, y) in image 2
    at 1/8 resolution. Returns (B, levels * (2r+1)^2, H, W) float32.

    Channels are x-offset-major: channel a*K + b of a level is the sample
    at offset (dx, dy) = (a - r, b - r) (the reference adds the first
    meshgrid output to x; robust_cvd_tpu/models/raft.py:209-214). Samples
    outside the map are zero, grid_sample's zero padding.

    The offsets are whole pixels, so every sample of a query shares the
    bilinear fractions: the query gathers the (K+1)x(K+1) integer patch
    around floor(coords) (zero outside the map), interpolates along y,
    rounds to `dtype` (the JAX package's bf16 intermediate), then along x.
    Weights are float32 rounded to `dtype` like the JAX package's hats."""
    B, _, H, W = coords.shape
    r = radius
    K = 2 * r + 1
    Q = H * W
    offs = torch.arange(-r, r + 2, device=coords.device)  # K + 1 taps
    out = []
    for i, corr in enumerate(pyramid):
        h2, w2 = corr.shape[-2:]
        if h2 == 0 or w2 == 0:
            out.append(coords.new_zeros((B, Q, K * K)))
            continue
        c = coords.flatten(2).transpose(1, 2) / (2.0 ** i)  # (B, Q, 2)
        c0 = torch.floor(c)
        w1 = c - c0
        w0 = (1.0 - w1).to(dtype).float()[..., None, None]
        w1 = w1.to(dtype).float()[..., None, None]
        x0 = c0[..., 0].long()
        y0 = c0[..., 1].long()
        rows = y0[..., None] + offs  # (B, Q, K+1)
        cols = x0[..., None] + offs
        ok = ((rows >= 0) & (rows < h2))[..., :, None] & (
            (cols >= 0) & (cols < w2))[..., None, :]
        idx = rows.clamp(0, h2 - 1)[..., :, None] * w2 + cols.clamp(0, w2 - 1)[..., None, :]
        patch = torch.gather(corr.reshape(B, Q, h2 * w2), 2, idx.reshape(B, Q, -1))
        patch = patch.reshape(B, Q, K + 1, K + 1).float() * ok
        rowed = w0[..., 1, :, :] * patch[:, :, :-1] + w1[..., 1, :, :] * patch[:, :, 1:]
        rowed = rowed.to(dtype).float()
        win = w0[..., 0, :, :] * rowed[..., :-1] + w1[..., 0, :, :] * rowed[..., 1:]  # (B, Q, K_y, K_x)
        out.append(win.transpose(-1, -2).reshape(B, Q, K * K))
    return torch.cat(out, -1).transpose(1, 2).reshape(B, -1, H, W)


class BasicMotionEncoder(nn.Module):
    """reference update.py:97-116."""

    def __init__(self, corr_planes: int = 4 * 81):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, 256, 1)
        self.convc2 = Conv2d(256, 192, 3, padding=1)
        self.convf1 = Conv2d(2, 128, 7, padding=3)
        self.convf2 = Conv2d(128, 64, 3, padding=1)
        self.conv = Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        flow = flow.to(self.conv.dtype)
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], 1)))
        return torch.cat([out, flow], 1)


class SepConvGRU(nn.Module):
    """reference update.py:37-77: a horizontal 1x5 GRU, then a vertical 5x1."""

    def __init__(self, hidden: int = 128, input_dim: int = 128 + 128):
        super().__init__()
        for s, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for g in "zrq":
                setattr(self, f"conv{g}{s}", Conv2d(hidden + input_dim, hidden, k, padding=p))

    def forward(self, h, x):
        x = x.to(h.dtype)
        for s in "12":
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz{s}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{s}")(hx))
            q = torch.tanh(getattr(self, f"convq{s}")(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden: int = 256):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden, 3, padding=1)
        self.conv2 = Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x))).float()


class BasicUpdateBlock(nn.Module):
    """reference update.py:137-156 (the mask scaled by 0.25)."""

    def __init__(self, hidden: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder()
        self.gru = SepConvGRU(hidden, 128 + hidden)
        self.flow_head = FlowHead(hidden, 256)
        self.mask = nn.Sequential(
            Conv2d(128, 256, 3, padding=1), nn.ReLU(), Conv2d(256, 64 * 9, 1)
        )

    def forward(self, net, inp, corr, flow, with_mask: bool = True):
        motion = self.encoder(flow, corr.to(self.encoder.convc1.dtype))
        net = self.gru(net, torch.cat([inp, motion], 1))
        delta = self.flow_head(net)
        mask = (0.25 * self.mask(net)).float() if with_mask else None
        return net, mask, delta


def upsample_flow_convex(flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Convex-combination 8x upsampling (reference raft.py:49-60).

    flow: (B, 2, h, w); mask: (B, 576, h, w), channels ordered (9, 8, 8)
    with neighbour k = dy*3 + dx. Returns (B, 2, 8h, 8w)."""
    B, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(B, 1, 9, 8, 8, h, w), dim=2)
    neigh = F.unfold(8.0 * flow, (3, 3), padding=1).reshape(B, 2, 9, 1, 1, h, w)
    up = (mask * neigh).sum(2)  # (B, 2, 8, 8, h, w)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(B, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    """Full RAFT: images (B, 3, H, W) in [0, 255] -> flow (B, 2, H, W)
    float32 from image 1 to image 2. H, W are multiples of 8 (the flow
    stage aligns to 64). Always in inference mode: cnet's BatchNorm uses
    its running statistics, as the JAX package's call (train=False)."""

    def __init__(self, iters: int = 20, dtype=torch.bfloat16, corr_levels: int = 4,
                 corr_radius: int = 4, hidden_dim: int = 128, context_dim: int = 128):
        super().__init__()
        self.iters = iters
        self.corr_levels = corr_levels
        self.corr_radius = corr_radius
        self.hidden_dim = hidden_dim
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch")
        self.update_block = BasicUpdateBlock(hidden_dim)
        self.set_dtype(dtype)

    def set_dtype(self, dtype) -> "RAFT":
        """The compute dtype of every convolution (weights stay float32)."""
        self.dtype = dtype
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.dtype = dtype
        return self

    def forward(self, image1: torch.Tensor, image2: torch.Tensor) -> torch.Tensor:
        img1 = 2.0 * (image1.float() / 255.0) - 1.0
        img2 = 2.0 * (image2.float() / 255.0) - 1.0
        # both images through one fnet call (reference raft.py:90); instance
        # norm is per sample, so this equals two calls
        fmap1, fmap2 = self.fnet(torch.cat([img1, img2], 0)).chunk(2, 0)
        pyramid = build_corr_pyramid(fmap1, fmap2, self.corr_levels)
        cnet = self.cnet(img1)
        net = torch.tanh(cnet[:, : self.hidden_dim])
        inp = F.relu(cnet[:, self.hidden_dim :])

        B, _, h, w = fmap1.shape
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=fmap1.device),
            torch.arange(w, dtype=torch.float32, device=fmap1.device),
            indexing="ij",
        )
        coords0 = torch.stack([xs, ys])[None].expand(B, 2, h, w)
        coords1 = coords0
        mask = None
        for it in range(self.iters):
            with record_function("raft.lookup_corr"):
                corr = lookup_corr(pyramid, coords1, self.corr_radius, self.dtype)
            net, mask, delta = self.update_block(
                net, inp, corr, coords1 - coords0, with_mask=it == self.iters - 1
            )
            coords1 = coords1 + delta
        return upsample_flow_convex(coords1 - coords0, mask)


def load_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A raft-things checkpoint's state dict, without DataParallel's
    `module.` prefixes."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()}


def state_dict_from_jax(params: dict, batch_stats: dict) -> Dict[str, torch.Tensor]:
    """Flax RAFT variables (numpy trees) -> this module's state_dict.

    The inverse of robust_cvd_tpu/models/torch_port.py::convert_raft:
    kernels HWIO -> OIHW, BatchNorm scale/bias/mean/var ->
    weight/bias/running_mean/running_var (cnet only; a downsample norm
    under both of its keys), the scanned update block's
    update_block/block/... -> update_block...."""
    sd: Dict[str, torch.Tensor] = {}

    def t(a):
        return torch.from_numpy(np.array(a, np.float32))

    def put_conv(key, node):
        sd[key + ".weight"] = t(np.transpose(np.asarray(node["kernel"]), (3, 2, 0, 1)))
        sd[key + ".bias"] = t(node["bias"])

    def put_bn(keys, pnode, snode):
        for key in keys:
            sd[key + ".weight"] = t(pnode["scale"])
            sd[key + ".bias"] = t(pnode["bias"])
            sd[key + ".running_mean"] = t(snode["mean"])
            sd[key + ".running_var"] = t(snode["var"])
            sd[key + ".num_batches_tracked"] = torch.tensor(0)

    for enc in ("fnet", "cnet"):
        p, s = params[enc], batch_stats.get(enc, {})
        put_conv(f"{enc}.conv1", p["conv1"])
        if "norm1" in p:
            put_bn([f"{enc}.norm1"], p["norm1"]["bn"], s["norm1"]["bn"])
        for i in range(1, 4):
            for j in range(2):
                src_p, dst = p[f"layer{i}_{j}"], f"{enc}.layer{i}.{j}"
                src_s = s.get(f"layer{i}_{j}", {})
                put_conv(f"{dst}.conv1", src_p["conv1"])
                put_conv(f"{dst}.conv2", src_p["conv2"])
                for n in ("norm1", "norm2"):
                    if n in src_p:
                        put_bn([f"{dst}.{n}"], src_p[n]["bn"], src_s[n]["bn"])
                if "downsample_conv" in src_p:
                    put_conv(f"{dst}.downsample.0", src_p["downsample_conv"])
                    if "norm3" in src_p:
                        put_bn([f"{dst}.norm3", f"{dst}.downsample.1"],
                               src_p["norm3"]["bn"], src_s["norm3"]["bn"])
        put_conv(f"{enc}.conv2", p["conv2"])

    ub = params["update_block"]["block"]
    for c in ("convc1", "convc2", "convf1", "convf2", "conv"):
        put_conv(f"update_block.encoder.{c}", ub["encoder"][c])
    for c in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        put_conv(f"update_block.gru.{c}", ub["gru"][c])
    put_conv("update_block.flow_head.conv1", ub["flow_head"]["conv1"])
    put_conv("update_block.flow_head.conv2", ub["flow_head"]["conv2"])
    put_conv("update_block.mask.0", ub["mask_conv1"])
    put_conv("update_block.mask.2", ub["mask_conv2"])
    return sd


def seeded_init_(net: RAFT, seed: int) -> RAFT:
    """Random weights from a seed, for runs without a checkpoint:
    He-normal convolutions with zero biases, identity BatchNorm statistics,
    and a flow head scaled by 0.01 so that each iteration moves the flow by
    a fraction of a pixel and the output stays finite."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * (2.0 / fan_in) ** 0.5)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        net.update_block.flow_head.conv2.weight.mul_(0.01)
    return net
