"""A plain SwinV2-L/24-384 depth network for the tests: MiDaS v3.1's
DPTDepthModel(backbone="swin2l24_384", non_negative=True), written after
isl-org/MiDaS (midas/backbones/swin2.py, swin_common.py: the hooks on the
last block of each stage, the maps without readout; midas/dpt_depth.py)
and timm 0.6.x's swin_transformer_v2.py (window_partition,
window_reverse, WindowAttention, SwinTransformerBlock, PatchMerging,
BasicLayer, PatchEmbed), independent of the port. It imports neither the
port nor JAX; the fusion blocks and the head are tests/plain_dpt.py's
(MiDaS v3.1 builds them as DPT-Large's).

Module names are the checkpoint's state-dict keys, so one state dict loads
into this net and into the port's models/swin2.py::Swin2DepthNet. The
defaults are SwinV2-L's widths; the tests use smaller ones. Float32 or
float64, in the caller's precision.

Departures from the published code:
- the buffers relative_coords_table, relative_position_index and
  attn_mask are not persistent (recomputed, as the port's);
- the encoder's final norm and classifier head are not run (MiDaS runs the
  norm and discards it; the head is not called);
- no dropout and no drop-path (timm's drop_path_rate 0.1 is stochastic
  depth for pre-training; the fine-tune here is deterministic);
- the refinenets' `size` argument is scale_factor=2 (the same where each
  level is half the next, as at 384);
- the frame is squashed to the net's side bicubically (MiDaS's transform,
  cv2.INTER_CUBIC) and the disparity resized back bilinearly, where
  MiDaS's run.py resizes it bicubically (bicubic overshoot would make
  negative disparity).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

import plain_dpt


def window_partition(x, window_size):
    B, H, W, C = x.shape
    x = x.view(B, H // window_size, window_size, W // window_size, window_size, C)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window_size, window_size, C)


def window_reverse(windows, window_size, img_size):
    H, W = img_size
    B = int(windows.shape[0] / (H * W / window_size / window_size))
    x = windows.view(B, H // window_size, W // window_size, window_size, window_size, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, H, W, -1)


class WindowAttention(nn.Module):
    def __init__(self, dim, window_size, num_heads, pretrained_window_size):
        super().__init__()
        self.dim = dim
        self.window_size = window_size
        self.num_heads = num_heads
        self.logit_scale = nn.Parameter(torch.log(10 * torch.ones((num_heads, 1, 1))))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, 512, bias=True), nn.ReLU(inplace=True),
                                     nn.Linear(512, num_heads, bias=False))
        relative_coords_h = torch.arange(-(window_size[0] - 1), window_size[0],
                                         dtype=torch.float32)
        relative_coords_w = torch.arange(-(window_size[1] - 1), window_size[1],
                                         dtype=torch.float32)
        relative_coords_table = torch.stack(torch.meshgrid(
            [relative_coords_h, relative_coords_w], indexing="ij")).permute(
            1, 2, 0).contiguous().unsqueeze(0)
        if pretrained_window_size[0] > 0:
            relative_coords_table[:, :, :, 0] /= (pretrained_window_size[0] - 1)
            relative_coords_table[:, :, :, 1] /= (pretrained_window_size[1] - 1)
        else:
            relative_coords_table[:, :, :, 0] /= (window_size[0] - 1)
            relative_coords_table[:, :, :, 1] /= (window_size[1] - 1)
        relative_coords_table *= 8
        relative_coords_table = torch.sign(relative_coords_table) * torch.log2(
            torch.abs(relative_coords_table) + 1.0) / math.log2(8)
        self.register_buffer("relative_coords_table", relative_coords_table, persistent=False)
        coords_h = torch.arange(window_size[0])
        coords_w = torch.arange(window_size[1])
        coords = torch.stack(torch.meshgrid([coords_h, coords_w], indexing="ij"))
        coords_flatten = torch.flatten(coords, 1)
        relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
        relative_coords = relative_coords.permute(1, 2, 0).contiguous()
        relative_coords[:, :, 0] += window_size[0] - 1
        relative_coords[:, :, 1] += window_size[1] - 1
        relative_coords[:, :, 0] *= 2 * window_size[1] - 1
        self.register_buffer("relative_position_index", relative_coords.sum(-1),
                             persistent=False)
        self.qkv = nn.Linear(dim, dim * 3, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = nn.Linear(dim, dim)
        self.bias = True  # False: a planted fault, the bias left out

    def forward(self, x, mask=None):
        B_, N, C = x.shape
        qkv_bias = torch.cat((self.q_bias, torch.zeros_like(self.v_bias, requires_grad=False),
                              self.v_bias))
        qkv = F.linear(input=x, weight=self.qkv.weight, bias=qkv_bias)
        qkv = qkv.reshape(B_, N, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = F.normalize(q, dim=-1) @ F.normalize(k, dim=-1).transpose(-2, -1)
        logit_scale = torch.clamp(self.logit_scale, max=math.log(1.0 / 0.01)).exp()
        attn = attn * logit_scale
        table = self.cpb_mlp(self.relative_coords_table.to(x.dtype)).view(-1, self.num_heads)
        bias = table[self.relative_position_index.view(-1)].view(
            self.window_size[0] * self.window_size[1], self.window_size[0] * self.window_size[1],
            -1)
        bias = 16 * torch.sigmoid(bias.permute(2, 0, 1).contiguous())
        if self.bias:
            attn = attn + bias.unsqueeze(0)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.view(B_ // nW, nW, self.num_heads, N, N) + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, self.num_heads, N, N)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(x)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class SwinTransformerBlock(nn.Module):
    def __init__(self, dim, input_resolution, num_heads, window_size, shift_size, mlp_ratio,
                 pretrained_window_size):
        super().__init__()
        self.input_resolution = input_resolution
        self.window_size = window_size
        self.shift_size = shift_size
        if min(self.input_resolution) <= self.window_size:
            self.shift_size = 0
            self.window_size = min(self.input_resolution)
        self.attn = WindowAttention(dim, (self.window_size, self.window_size), num_heads,
                                    (pretrained_window_size, pretrained_window_size))
        self.norm1 = nn.LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.norm2 = nn.LayerNorm(dim)
        self.shift = True  # False: a planted fault, the roll left out
        if self.shift_size > 0:
            H, W = self.input_resolution
            img_mask = torch.zeros((1, H, W, 1))
            cnt = 0
            for h in (slice(0, -self.window_size), slice(-self.window_size, -self.shift_size),
                      slice(-self.shift_size, None)):
                for w in (slice(0, -self.window_size),
                          slice(-self.window_size, -self.shift_size),
                          slice(-self.shift_size, None)):
                    img_mask[:, h, w, :] = cnt
                    cnt += 1
            mask_windows = window_partition(img_mask, self.window_size)
            mask_windows = mask_windows.view(-1, self.window_size * self.window_size)
            attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
            attn_mask = attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(
                attn_mask == 0, float(0.0))
        else:
            attn_mask = None
        self.register_buffer("attn_mask", attn_mask, persistent=False)
        self.use_mask = True  # False: a planted fault, the mask left out

    def forward(self, x):
        H, W = self.input_resolution
        B, L, C = x.shape
        shortcut = x
        x = x.view(B, H, W, C)
        shift = self.shift_size > 0 and self.shift
        shifted_x = torch.roll(x, shifts=(-self.shift_size, -self.shift_size),
                               dims=(1, 2)) if shift else x
        x_windows = window_partition(shifted_x, self.window_size)
        x_windows = x_windows.view(-1, self.window_size * self.window_size, C)
        mask = self.attn_mask if self.use_mask else None
        attn_windows = self.attn(x_windows, mask=None if mask is None else mask.to(x.dtype))
        attn_windows = attn_windows.view(-1, self.window_size, self.window_size, C)
        shifted_x = window_reverse(attn_windows, self.window_size, self.input_resolution)
        x = torch.roll(shifted_x, shifts=(self.shift_size, self.shift_size),
                       dims=(1, 2)) if shift else shifted_x
        x = x.view(B, H * W, C)
        x = shortcut + self.norm1(x)
        return x + self.norm2(self.mlp(x))


class PatchMerging(nn.Module):
    def __init__(self, input_resolution, dim):
        super().__init__()
        self.input_resolution = input_resolution
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim)

    def forward(self, x):
        H, W = self.input_resolution
        B, L, C = x.shape
        x = x.view(B, H, W, C)
        x0 = x[:, 0::2, 0::2, :]
        x1 = x[:, 1::2, 0::2, :]
        x2 = x[:, 0::2, 1::2, :]
        x3 = x[:, 1::2, 1::2, :]
        x = torch.cat([x0, x1, x2, x3], -1)
        x = x.view(B, -1, 4 * C)
        return self.norm(self.reduction(x))


class BasicLayer(nn.Module):
    def __init__(self, dim, input_resolution, depth, num_heads, window_size, mlp_ratio,
                 downsample, pretrained_window_size):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, input_resolution, num_heads, window_size,
                                 0 if (i % 2 == 0) else window_size // 2, mlp_ratio,
                                 pretrained_window_size) for i in range(depth)])
        self.downsample = PatchMerging(input_resolution, dim) if downsample else None


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, embed_dim):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, kernel_size=patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim)


class SwinTransformerV2(nn.Module):
    def __init__(self, img_size, patch_size, embed_dim, depths, num_heads, window_size,
                 mlp_ratio, pretrained_window_sizes, num_classes):
        super().__init__()
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        grid = img_size // patch_size
        self.layers = nn.ModuleList()
        for i in range(len(depths)):
            res = grid // (2 ** i)
            self.layers.append(BasicLayer(
                int(embed_dim * 2 ** i), (res, res), depths[i], num_heads[i], window_size,
                mlp_ratio, i < len(depths) - 1, pretrained_window_sizes[i]))
        self.num_features = int(embed_dim * 2 ** (len(depths) - 1))
        self.norm = nn.LayerNorm(self.num_features)
        self.head = nn.Linear(self.num_features, num_classes)


class DPTSwin2(plain_dpt.DPT):
    """(B, 3, H, W) normalised RGB -> (B, H, W) disparity."""

    def __init__(self, image=384, patch=4, embed=192, depths=(2, 2, 18, 2),
                 heads=(6, 12, 24, 48), window=24, pretrained_windows=(12, 12, 12, 6),
                 mlp_ratio=4, hooks=(1, 1, 17, 1), features=256, classes=1000):
        widths = [embed * 2 ** i for i in range(4)]
        super().__init__(hidden=8, heads=1, blocks=0, mlp=8, patch=patch, pos_grid=1,
                         hooks=hooks, widths=widths, features=features, classes=classes)
        for k in range(1, 5):
            delattr(self.pretrained, f"act_postprocess{k}")
        self.image = image
        self.pretrained.model = SwinTransformerV2(image, patch, embed, depths, heads, window,
                                                  mlp_ratio, pretrained_windows, classes)

    def forward(self, x):
        h, w = x.shape[-2:]
        x = F.interpolate(x, size=(self.image, self.image), mode="bicubic", align_corners=False)
        model = self.pretrained.model
        b = x.shape[0]
        t = model.patch_embed.proj(x).flatten(2).transpose(1, 2)
        t = model.patch_embed.norm(t)
        acts = []
        for i, layer in enumerate(model.layers):
            for j, blk in enumerate(layer.blocks):
                t = blk(t)
                if j == self.hooks[i]:
                    acts.append(t)
            if layer.downsample is not None:
                t = layer.downsample(t)
        layers = []
        for i, a in enumerate(acts):
            r = self.image // model.patch_embed.proj.stride[0] // 2 ** i
            y = a.transpose(1, 2).unflatten(2, (r, r))
            layers.append(getattr(self.scratch, f"layer{i + 1}_rn")(y))
        s = self.scratch
        p = s.refinenet4(layers[3])
        p = s.refinenet3(p, layers[2])
        p = s.refinenet2(p, layers[1])
        p = s.refinenet1(p, layers[0])
        d = s.output_conv(p)
        return F.interpolate(d, size=(h, w), mode="bilinear", align_corners=False).squeeze(1)


normalize = plain_dpt.normalize
depth = plain_dpt.depth


def timm_mask_regions(resolution, window, shift):
    """timm's img_mask per window, (nW, w^2): the codes its attn_mask
    compares."""
    img_mask = torch.zeros((1, resolution, resolution, 1))
    cnt = 0
    for h in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for w in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img_mask[:, h, w, :] = cnt
            cnt += 1
    return window_partition(img_mask, window).view(-1, window * window)


@torch.no_grad()
def seeded_state_dict(net, seed):
    """plain_dpt.seeded_state_dict's weights, then each temperature
    log(10) + N(0, 0.3) and the continuous position bias's MLP with
    weights N(0, 1) (first layer, biases N(0, 0.5)) and N(0, 2 / sqrt(512))
    (second): at timm's initialisation the bias is 16 sigmoid(~0), a
    constant the softmax cannot see."""
    sd = plain_dpt.seeded_state_dict(net, seed)
    g = torch.Generator().manual_seed(seed + 1)

    def draw(k):
        return torch.randn(sd[k].shape, generator=g, dtype=torch.float64).to(sd[k].dtype)

    for k in sorted(sd):
        if k.endswith("logit_scale"):
            sd[k].copy_(np.log(10.0) + 0.3 * draw(k))
        elif k.endswith("cpb_mlp.0.weight"):
            sd[k].copy_(draw(k))
        elif k.endswith("cpb_mlp.0.bias"):
            sd[k].copy_(0.5 * draw(k))
        elif k.endswith("cpb_mlp.2.weight"):
            sd[k].copy_(2.0 / math.sqrt(sd[k].shape[1]) * draw(k))
    return sd
