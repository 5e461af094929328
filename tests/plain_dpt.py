"""A plain DPT depth network for the tests: DPTDepthModel(backbone=
"vitl16_384", readout "project", non_negative=True) written after
isl-org/DPT (dpt/models.py, dpt/vit.py, dpt/blocks.py) and timm's
VisionTransformer, independent of the port. It imports neither the port
nor JAX.

Module names are the checkpoint's state-dict keys, so one state dict loads
into this net and into the port's models/dpt.py::DPTDepthNet. The defaults
are DPT-Large's widths; the tests use smaller ones.

Departures from the published code:
- attention is written out, softmax(q k^T * scale) v, where timm's newer
  releases call F.scaled_dot_product_attention (the same function);
- the tokens are laid out on the frame's grid directly (reshape), where
  dpt/vit.py's forward_vit runs Transpose and a fixed-size Unflatten and
  then re-flattens for other sizes (the same layout);
- blocks are run up to the last hooked one, and the final LayerNorm and
  the classifier head are not run: DPT computes them and discards the
  result;
- no dropout and no drop-path (DPT's are 0 in eval and in this fine-tune).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = ((q @ k.transpose(-2, -1)) * self.scale).softmax(dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, mlp)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        x = x + self.mlp(self.norm2(x))
        return x


class PatchEmbed(nn.Module):
    def __init__(self, patch, dim):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, kernel_size=patch, stride=patch)


class ViT(nn.Module):
    def __init__(self, dim, heads, depth, mlp, patch, grid, classes):
        super().__init__()
        self.patch = patch
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1, dim))
        self.patch_embed = PatchEmbed(patch, dim)
        self.blocks = nn.ModuleList([Block(dim, heads, mlp) for _ in range(depth)])
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, classes)


class ProjectReadout(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, x):
        readout = x[:, 0].unsqueeze(1).expand_as(x[:, 1:])
        return self.project(torch.cat((x[:, 1:], readout), -1))


class ResidualConvUnit(nn.Module):
    """dpt/blocks.py ResidualConvUnit_custom with nn.ReLU(False), no BN."""

    def __init__(self, features):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, 1, 1, bias=True)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=True)

    def forward(self, x):
        out = self.conv2(F.relu(self.conv1(F.relu(x))))
        return out + x


class FusionBlock(nn.Module):
    """dpt/blocks.py FeatureFusionBlock_custom(deconv=False, bn=False,
    expand=False, align_corners=True)."""

    def __init__(self, features):
        super().__init__()
        self.out_conv = nn.Conv2d(features, features, 1, 1, 0, bias=True)
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)

    def forward(self, *xs):
        out = xs[0]
        if len(xs) == 2:
            out = out + self.resConfUnit1(xs[1])
        out = self.resConfUnit2(out)
        out = F.interpolate(out, scale_factor=2, mode="bilinear", align_corners=True)
        return self.out_conv(out)


class Interpolate(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)


class DPT(nn.Module):
    """(B, 3, H, W) normalised RGB -> (B, H, W) disparity."""

    def __init__(self, hidden=1024, heads=16, blocks=24, mlp=4096, patch=16, pos_grid=24,
                 hooks=(5, 11, 17, 23), widths=(256, 512, 1024, 1024), features=256,
                 classes=1000):
        super().__init__()
        self.hooks = list(hooks)
        self.pretrained = nn.Module()
        self.pretrained.model = ViT(hidden, heads, blocks, mlp, patch, pos_grid, classes)
        ident = nn.Identity
        self.pretrained.act_postprocess1 = nn.Sequential(
            ProjectReadout(hidden), ident(), ident(), nn.Conv2d(hidden, widths[0], 1),
            nn.ConvTranspose2d(widths[0], widths[0], kernel_size=4, stride=4))
        self.pretrained.act_postprocess2 = nn.Sequential(
            ProjectReadout(hidden), ident(), ident(), nn.Conv2d(hidden, widths[1], 1),
            nn.ConvTranspose2d(widths[1], widths[1], kernel_size=2, stride=2))
        self.pretrained.act_postprocess3 = nn.Sequential(
            ProjectReadout(hidden), ident(), ident(), nn.Conv2d(hidden, widths[2], 1))
        self.pretrained.act_postprocess4 = nn.Sequential(
            ProjectReadout(hidden), ident(), ident(), nn.Conv2d(hidden, widths[3], 1),
            nn.Conv2d(widths[3], widths[3], kernel_size=3, stride=2, padding=1))
        self.scratch = nn.Module()
        for k in range(4):
            setattr(self.scratch, f"layer{k + 1}_rn",
                    nn.Conv2d(widths[k], features, 3, 1, 1, bias=False))
            setattr(self.scratch, f"refinenet{k + 1}", FusionBlock(features))
        self.scratch.output_conv = nn.Sequential(
            nn.Conv2d(features, features // 2, 3, 1, 1), Interpolate(),
            nn.Conv2d(features // 2, 32, 3, 1, 1), nn.ReLU(), nn.Conv2d(32, 1, 1, 1, 0),
            nn.ReLU())

    def forward(self, x):
        vit = self.pretrained.model
        b, _, h, w = x.shape
        gh, gw = h // vit.patch, w // vit.patch
        pos_tok, pos_grid = vit.pos_embed[:, :1], vit.pos_embed[0, 1:]
        g = int(math.sqrt(len(pos_grid)))
        pos_grid = pos_grid.reshape(1, g, g, -1).permute(0, 3, 1, 2)
        pos_grid = F.interpolate(pos_grid, size=(gh, gw), mode="bilinear", align_corners=False)
        pos = torch.cat([pos_tok, pos_grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], 1)
        t = vit.patch_embed.proj(x).flatten(2).transpose(1, 2)
        t = torch.cat((vit.cls_token.expand(b, -1, -1), t), 1) + pos
        outs = []
        for i in range(max(self.hooks) + 1):
            t = vit.blocks[i](t)
            if i in self.hooks:
                outs.append(t)
        layers = []
        for k, t in enumerate(outs):
            post = getattr(self.pretrained, f"act_postprocess{k + 1}")
            y = post[0](t).transpose(1, 2)
            y = y.reshape(b, y.shape[1], gh, gw)
            for m in list(post)[3:]:
                y = m(y)
            layers.append(getattr(self.scratch, f"layer{k + 1}_rn")(y))
        s = self.scratch
        p = s.refinenet4(layers[3])
        p = s.refinenet3(p, layers[2])
        p = s.refinenet2(p, layers[1])
        p = s.refinenet1(p, layers[0])
        return s.output_conv(p).squeeze(1)


def normalize(images):
    """[0, 1] RGB (B, H, W, 3) -> (B, 3, H, W), MiDaS v3's mean and std 0.5."""
    mean = images.new_tensor([0.5, 0.5, 0.5])
    std = images.new_tensor([0.5, 0.5, 0.5])
    return ((images - mean) / std).permute(0, 3, 1, 2)


def depth(net, images):
    """Depth (B, H, W) = 1 / (disparity + 1e-7) of images (B, H, W, 3)."""
    return 1.0 / (net(normalize(images)) + 1e-7)


@torch.no_grad()
def seeded_state_dict(net, seed):
    """Weights for a random net whose depth stays finite and positive, by
    sorted key from one generator: convolutions He-normal, linear weights,
    the position grid and the class token normal with std 0.02, LayerNorm
    scales 1 + N(0, 0.1), biases N(0, 0.01); the head's last convolution
    scaled by 0.01 with bias 2."""
    g = torch.Generator().manual_seed(seed)
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    for k in sorted(sd):
        v = sd[k]
        r = torch.randn(v.shape, generator=g, dtype=torch.float64).to(v.dtype)
        if k.endswith(".bias"):
            v.copy_(0.01 * r)
        elif v.dim() == 4:
            v.copy_(r * math.sqrt(2.0 / v[0].numel()))
        elif ".norm" in k:
            v.copy_(1.0 + 0.1 * r)
        else:
            v.copy_(0.02 * r)
    sd["scratch.output_conv.4.weight"].mul_(0.01)
    sd["scratch.output_conv.4.bias"].fill_(2.0)
    return sd
