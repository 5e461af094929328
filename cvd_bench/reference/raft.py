"""Plain RAFT (Teed & Deng, ECCV 2020), the raft-things architecture of
princeton-vl/RAFT (core/raft.py, corr.py, update.py, extractor.py):
feature (256-d, instance norm) and context (128 + 128, BatchNorm at its
running statistics) encoders at 1/8 resolution, the all-pairs correlation
pyramid (4 levels) with a radius-4 bilinear lookup (zero
padding), the SepConvGRU update block, 20 iterations and the convex 8x
upsampling. Module names are the upstream checkpoint's state-dict keys.

Float32 throughout, or, with `quant="fp8"`, every convolution's input and
weight and both correlation features rounded to float8 e4m3 with a scale a
tensor (the control of a bfloat16 program).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a scale that maps its largest
    magnitude to 448, returned in x's type."""
    s = x.detach().abs().amax().clamp(min=1e-12) / FP8_MAX
    return ((x / s).to(torch.float8_e4m3fn).to(x.dtype)) * s


class Conv2d(nn.Conv2d):
    quant: Optional[str] = None

    def forward(self, x):
        if self.quant == "fp8":
            return self._conv_forward(fp8(x), fp8(self.weight), self.bias)
        return super().forward(x)


def instance_norm(x, eps=1e-5):
    var, mean = torch.var_mean(x, dim=(-2, -1), keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + eps)


class InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


class BatchNormEval(nn.BatchNorm2d):
    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            False, 0.0, self.eps)


def _norm(kind, planes):
    return BatchNormEval(planes) if kind == "batch" else InstanceNorm()


class ResidualBlock(nn.Module):
    def __init__(self, cin, planes, norm, stride=1):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, padding=1, stride=stride)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.norm1 = _norm(norm, planes)
        self.norm2 = _norm(norm, planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = _norm(norm, planes)
            self.downsample = nn.Sequential(Conv2d(cin, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim, norm):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = _norm(norm, 64)
        cin = 64
        for i, (dim, stride) in enumerate(((64, 1), (96, 2), (128, 2)), start=1):
            setattr(self, f"layer{i}", nn.Sequential(ResidualBlock(cin, dim, norm, stride),
                                                     ResidualBlock(dim, dim, norm, 1)))
            cin = dim
        self.conv2 = Conv2d(128, output_dim, 1)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(y))))


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_planes):
        super().__init__()
        self.convc1 = Conv2d(corr_planes, 256, 1)
        self.convc2 = Conv2d(256, 192, 3, padding=1)
        self.convf1 = Conv2d(2, 128, 7, padding=3)
        self.convf2 = Conv2d(128, 64, 3, padding=1)
        self.conv = Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        return torch.cat([F.relu(self.conv(torch.cat([c, f], 1))), flow], 1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden, input_dim):
        super().__init__()
        for s, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for g in "zrq":
                setattr(self, f"conv{g}{s}", Conv2d(hidden + input_dim, hidden, k, padding=p))

    def forward(self, h, x):
        for s in "12":
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz{s}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{s}")(hx))
            q = torch.tanh(getattr(self, f"convq{s}")(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, cin, hidden):
        super().__init__()
        self.conv1 = Conv2d(cin, hidden, 3, padding=1)
        self.conv2 = Conv2d(hidden, 2, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, hidden, corr_planes):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_planes)
        self.gru = SepConvGRU(hidden, 128 + hidden)
        self.flow_head = FlowHead(hidden, 256)
        self.mask = nn.Sequential(Conv2d(128, 256, 3, padding=1), nn.ReLU(),
                                  Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow):
        net = self.gru(net, torch.cat([inp, self.encoder(flow, corr)], 1))
        return net, 0.25 * self.mask(net), self.flow_head(net)


def corr_pyramid(fmap1, fmap2, levels, quant=None):
    """[(B*H*W, 1, h_i, w_i)]: the all-pairs volume over sqrt(D), pooled
    2x2 over image 2 at each further level."""
    b, d, h, w = fmap1.shape
    if quant == "fp8":
        fmap1, fmap2 = fp8(fmap1), fp8(fmap2)
    corr = torch.einsum("bdq,bdk->bqk", fmap1.flatten(2), fmap2.flatten(2)) / d ** 0.5
    corr = corr.reshape(b * h * w, 1, h, w)
    out = [corr]
    for _ in range(levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        out.append(corr)
    return out


def sample_zero(img, x, y):
    """Bilinear samples of img (N, h, w) at (x, y) (N, S), taps outside
    the map reading 0 (grid_sample's zero padding, align_corners=True)."""
    n, h, w = img.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    flat = img.reshape(n, h * w)
    out = torch.zeros_like(x)
    for dx, dy, wt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                       (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        xi, yi = (x0 + dx).long(), (y0 + dy).long()
        ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1))
        out = out + wt * torch.gather(flat, 1, idx) * ok
    return out


def lookup(pyramid, coords, radius):
    """(B, levels*(2r+1)^2, H, W): bilinear samples around coords/2^i, the
    x offset major (upstream's meshgrid order), zero outside the map."""
    b, _, h, w = coords.shape
    r = radius
    d = torch.arange(-r, r + 1, dtype=coords.dtype, device=coords.device)
    ox, oy = torch.meshgrid(d, d, indexing="ij")  # channel a*K + b: (dx, dy) = (a - r, b - r)
    centre = coords.permute(0, 2, 3, 1).reshape(b * h * w, 1, 2)
    out = []
    for i, corr in enumerate(pyramid):
        pts_x = centre[..., 0] / 2 ** i + ox.reshape(1, -1)
        pts_y = centre[..., 1] / 2 ** i + oy.reshape(1, -1)
        s = sample_zero(corr[:, 0], pts_x, pts_y)
        out.append(s.reshape(b, h, w, -1))
    return torch.cat(out, -1).permute(0, 3, 1, 2).contiguous()


def upsample_convex(flow, mask):
    b, _, h, w = flow.shape
    mask = torch.softmax(mask.reshape(b, 1, 9, 8, 8, h, w), dim=2)
    neigh = F.unfold(8.0 * flow, (3, 3), padding=1).reshape(b, 2, 9, 1, 1, h, w)
    up = (mask * neigh).sum(2)
    return up.permute(0, 1, 4, 2, 5, 3).reshape(b, 2, 8 * h, 8 * w)


class RAFT(nn.Module):
    """images (B, 3, H, W) in [0, 255] -> flow (B, 2, H, W), image 1 to 2."""

    def __init__(self, iters=20, corr_levels=4, corr_radius=4, hidden_dim=128, context_dim=128,
                 feature_dim=256):
        super().__init__()
        self.iters, self.levels, self.radius, self.hidden = iters, corr_levels, corr_radius, hidden_dim
        self.fnet = BasicEncoder(feature_dim, "instance")
        self.cnet = BasicEncoder(hidden_dim + context_dim, "batch")
        self.update_block = BasicUpdateBlock(hidden_dim, corr_levels * (2 * corr_radius + 1) ** 2)
        self.quant = None

    def set_quant(self, quant):
        self.quant = quant
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.quant = quant
        return self

    def forward(self, image1, image2):
        img1 = 2 * (image1 / 255.0) - 1
        img2 = 2 * (image2 / 255.0) - 1
        fmap1, fmap2 = self.fnet(torch.cat([img1, img2], 0)).chunk(2, 0)
        pyramid = corr_pyramid(fmap1, fmap2, self.levels, self.quant)
        cnet = self.cnet(img1)
        net = torch.tanh(cnet[:, : self.hidden])
        inp = F.relu(cnet[:, self.hidden :])
        b, _, h, w = fmap1.shape
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=img1.device),
                                torch.arange(w, dtype=torch.float32, device=img1.device),
                                indexing="ij")
        coords0 = torch.stack([xs, ys])[None].expand(b, 2, h, w)
        coords1 = coords0
        for _ in range(self.iters):
            corr = lookup(pyramid, coords1, self.radius)
            net, mask, delta = self.update_block(net, inp, corr, coords1 - coords0)
            coords1 = coords1 + delta
        return upsample_convex(coords1 - coords0, mask)
