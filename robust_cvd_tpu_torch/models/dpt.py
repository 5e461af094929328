"""DPT-Large, the MiDaS v3.0 depth network (PyTorch, NCHW).

Ranftl, Bochkovskiy and Koltun, "Vision Transformers for Dense
Prediction", ICCV 2021 (arXiv:2103.13413); code isl-org/DPT
(dpt/models.py::DPTDepthModel, dpt/vit.py::_make_pretrained_vitl16_384,
dpt/blocks.py). MiDaS v3.0 builds it as DPTDepthModel(backbone=
"vitl16_384", non_negative=True), checkpoint dpt_large-midas-2f21e586.pt,
and feeds it RGB normalised with mean 0.5 and std 0.5.

- Encoder: timm's vit_large_patch16_384. A 16x16 patch embedding and a
  class token, plus the 24x24 position grid resized bilinearly
  (align_corners=False) to the frame's token grid; 24 pre-LayerNorm blocks
  (eps 1e-6) of 16-head attention, softmax(q k^T / 8) v read straight out
  of the qkv projection (ops/attention.py::vit_attention: the Hopper
  kernels on the card, the written-out softmax on the CPU), and an
  exact-erf GELU MLP of 4096.
- Reassembly: the outputs of blocks 5, 11, 17 and 23 (0-based), each with
  the "project" readout GELU(Linear([tokens, class token])), laid out on
  the token grid, then a 1x1 convolution to 256/512/1024/1024 and a 4x4
  stride-4 or 2x2 stride-2 transposed convolution, nothing, or a 3x3
  stride-2 convolution: 1/4 to 1/32 of the frame.
- Decoder: MiDaS v2's scratch convolutions, fusion blocks and head
  (models/layers.py) with DPT's differences: the residual units add x (not
  relu(x)), each fusion block ends in a 1x1 convolution, and the head's
  upsample has align_corners=True. The output is disparity.

Module names follow the checkpoint's state-dict keys
(`pretrained.model.blocks.0.attn.qkv`, `pretrained.act_postprocess1.0.
project.0`, `scratch.refinenet4.out_conv`, ...), so a real checkpoint loads
with `load_state_dict`. The timm classifier `head` and the final `norm`
take no part in depth and are kept so that it does. Blocks after the last
hooked one are not run (none at the published hooks).

The net has no BatchNorm, so the fine-tune's batch-statistics contexts
leave it alone. Its adapter runs the net's float32 matrix products in TF32
where TF32 is allowed (`matmul_tf32`); the plain references in float32.

The decoder (`DPT`) takes its backbone as MiDaS's `pretrained` module: the
four maps and the resizes of the frame in and of the disparity out.
`ViTBackbone` is the ViT encoder and its reassembly, the frame at its own
size; it takes any encoder of the same width (the `encoder` argument of
DPTDepthNet): models/beit.py puts BEiT-L under it. models/swin2.py puts
SwinV2-L's stage maps under the decoder with no reassembly. The four depth
models are MiDaS v2 (models/midas.py), DPT-Large, BEiT-L/16-512 and
SwinV2-L/24-384.

Spans (utils/spans.py): `dpt.embed`, `dpt.encoder` (attrs `tokens` a
frame and `frames`), `dpt.reassemble` and `dpt.decoder` (fusion and head).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import vit_attention
from ..utils.spans import span
from .depth_model import DepthModel
from .layers import FeatureFusionBlock, output_head

LN_EPS = 1e-6  # timm's ViT LayerNorm


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class Attention(nn.Module):
    """timm Attention: one qkv projection with bias, heads of dim // heads,
    scale 1 / sqrt(head width), an output projection."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        y = vit_attention(self.qkv(x).reshape(b, n, 3, self.heads, c // self.heads))
        return self.proj(y.reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """x + Attn(LN1(x)), then x + MLP(LN2(x))."""

    def __init__(self, dim: int, heads: int, mlp: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class VisionTransformer(nn.Module):
    """timm's VisionTransformer as DPT uses it: the tokens of any frame
    whose sides are multiples of the patch (dpt/vit.py::forward_flex)."""

    def __init__(self, dim: int, heads: int, blocks: int, mlp: int, patch: int, pos_grid: int,
                 classes: int):
        super().__init__()
        self.patch = patch
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + pos_grid * pos_grid, dim))
        self.patch_embed = PatchEmbed(patch, dim)
        self.blocks = nn.ModuleList(Block(dim, heads, mlp) for _ in range(blocks))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, classes)

    def resized_pos_embed(self, gh: int, gw: int) -> torch.Tensor:
        """(1, 1 + gh * gw, dim): the class token's position and the grid's,
        resized bilinearly with align_corners=False (dpt/vit.py::
        _resize_pos_embed)."""
        tok, grid = self.pos_embed[:, :1], self.pos_embed[0, 1:]
        g = int(math.isqrt(grid.shape[0]))
        grid = grid.reshape(1, g, g, -1).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(gh, gw), mode="bilinear", align_corners=False)
        return torch.cat([tok, grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], 1)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> tokens (B, 1 + H/p * W/p, dim), class token first."""
        b, _, h, w = x.shape
        t = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        t = torch.cat([self.cls_token.expand(b, -1, -1), t], 1)
        return t + self.resized_pos_embed(h // self.patch, w // self.patch)

    def hooked(self, x: torch.Tensor, hooks: Sequence[int]) -> list:
        """The tokens after each hooked block, (B, N, dim) each; the blocks
        after the last hook are not run. The encoder contract of
        DPTDepthNet (models/beit.py::BeitEncoder fills it in too)."""
        with span("dpt.embed"):
            t = self.embed(x)
        with span("dpt.encoder", tokens=t.shape[1], frames=x.shape[0]):
            out = []
            for i, blk in enumerate(self.blocks[: hooks[-1] + 1]):
                t = blk(t)
                if i in hooks:
                    out.append(t)
        return out


class ProjectReadout(nn.Module):
    """dpt/vit.py::ProjectReadout: each patch token concatenated with the
    class token, then Linear(2 dim -> dim) and GELU; the class token
    dropped."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, x):
        readout = x[:, :1].expand(-1, x.shape[1] - 1, -1)
        return self.project(torch.cat([x[:, 1:], readout], -1))


def _reassemble(dim: int, width: int, level: int) -> nn.Sequential:
    """dpt/vit.py's act_postprocess<level>: the readout, the reference's
    Transpose and Unflatten (no weights; here the grid is laid out in
    ViTBackbone.maps), a 1x1 convolution to `width`, then the resampling
    to 1/4, 1/8, 1/16 or 1/32 of the frame."""
    mods = [ProjectReadout(dim), nn.Identity(), nn.Identity(), nn.Conv2d(dim, width, 1)]
    if level == 1:
        mods.append(nn.ConvTranspose2d(width, width, 4, stride=4))
    elif level == 2:
        mods.append(nn.ConvTranspose2d(width, width, 2, stride=2))
    elif level == 4:
        mods.append(nn.Conv2d(width, width, 3, stride=2, padding=1))
    return nn.Sequential(*mods)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB (..., 3) -> MiDaS v3's input, mean 0.5 and std 0.5."""
    return (images - 0.5) / 0.5


class ViTBackbone(nn.Module):
    """MiDaS's `pretrained` for a plain ViT encoder: `model`, the encoder of
    width `hidden` with a `patch` and `hooked(x, hooks)`, the tokens after
    each hooked block (DPT-Large's VisionTransformer, models/beit.py::
    BeitEncoder), and `act_postprocess1..4`, the reassembly of those tokens
    into maps of `widths` channels at 1/4 to 1/32 of the frame. It takes the
    frame at its own size (sides multiples of the patch), so `squash` and
    `restore` leave it as it is."""

    def __init__(self, model: nn.Module, hidden: int,
                 widths: Sequence[int] = (256, 512, 1024, 1024)):
        super().__init__()
        self.model = model
        self.widths = tuple(widths)
        for level, width in enumerate(widths, 1):
            setattr(self, f"act_postprocess{level}", _reassemble(hidden, width, level))

    def squash(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def restore(self, d: torch.Tensor, size) -> torch.Tensor:
        return d

    def maps(self, x: torch.Tensor, hooks: Sequence[int]) -> list:
        """The four reassembled maps (B, widths[l], h, w) of the frame x."""
        b, _, h, w = x.shape
        patch = self.model.patch
        if h % patch or w % patch:
            raise ValueError(f"DPT needs sides that are multiples of {patch}, got {h}x{w}")
        gh, gw = h // patch, w // patch
        hooked = self.model.hooked(x, hooks)
        with span("dpt.reassemble"):
            layers = []
            for level, t in enumerate(hooked, 1):
                post = getattr(self, f"act_postprocess{level}")
                y = post[0](t)
                y = y.transpose(1, 2).reshape(b, y.shape[-1], gh, gw)
                for m in post[3:]:
                    y = m(y)
                layers.append(y)
        return layers


class DPT(nn.Module):
    """DPT's decoder on a backbone: (B, 3, H, W) normalised RGB -> (B, H, W)
    disparity. `pretrained` is MiDaS's backbone module: `widths`, the
    channels of the four maps that `maps(x, hooks)` returns at 1/4 to 1/32
    of its input, and `squash` and `restore`, the resizes of the frame to
    that input and of the disparity back to the frame's size (ViTBackbone,
    or models/swin2.py::Swin2Backbone, whose stage maps need no
    reassembly). `normalize` is the input normalisation its weights were
    trained with."""

    normalize = staticmethod(normalize_images)

    def __init__(self, pretrained: nn.Module, hooks: Sequence[int], features: int = 256):
        super().__init__()
        self.hooks = tuple(hooks)
        self.pretrained = pretrained
        self.scratch = nn.Module()
        for k, cin in enumerate(pretrained.widths, 1):
            setattr(self.scratch, f"layer{k}_rn",
                    nn.Conv2d(cin, features, 3, padding=1, bias=False))
        for k in range(1, 5):
            setattr(self.scratch, f"refinenet{k}",
                    FeatureFusionBlock(features, relu_skip=False, out_conv=True))
        self.scratch.output_conv = output_head(features, features // 2, align_corners=True)

    def forward(self, x):
        p = self.pretrained
        return p.restore(self.decode(p.maps(p.squash(x), self.hooks)), x.shape[-2:])

    def decode(self, layers):
        """The scratch convolutions, fusion and head on the four maps."""
        s = self.scratch
        with span("dpt.decoder"):
            l1, l2, l3, l4 = (getattr(s, f"layer{k}_rn")(y) for k, y in enumerate(layers, 1))
            p4 = s.refinenet4(l4)
            p3 = s.refinenet3(p4, l3)
            p2 = s.refinenet2(p3, l2)
            p1 = s.refinenet1(p2, l1)
            return s.output_conv(p1)[:, 0]


class DPTDepthNet(DPT):
    """DPT on a plain ViT encoder: H and W must be multiples of the patch.
    The defaults are DPT-Large's published widths; smaller ones give the
    same structure for tests. `encoder` (at `pretrained.model`) is
    DPT-Large's VisionTransformer of these widths, or another encoder of
    width `hidden` (BEiT, models/beit.py); the reassembly and the decoder
    are the same."""

    def __init__(self, hidden: int = 1024, heads: int = 16, blocks: int = 24, mlp: int = 4096,
                 patch: int = 16, pos_grid: int = 24, hooks: Sequence[int] = (5, 11, 17, 23),
                 widths: Sequence[int] = (256, 512, 1024, 1024), features: int = 256,
                 classes: int = 1000, encoder: nn.Module | None = None):
        model = encoder if encoder is not None else VisionTransformer(
            hidden, heads, blocks, mlp, patch, pos_grid, classes)
        super().__init__(ViTBackbone(model, hidden, widths), hooks, features)


class DPTLargeAdapter(DepthModel):
    """DPT-Large, MiDaS v3.0 (registered as `dpt_large`, models/registry.py),
    with TF32 matrix products. The reference gives DPT no fine-tune
    settings of its own, so `align`, the learning rate and the view
    baseline are assumed equal to midas2's."""

    align = 32
    learning_rate = 1e-6
    lambda_view_baseline = 1e-4
    checkpoint = "dpt_large-midas-2f21e586.pt"
    checkpoint_env = "DPT_CHECKPOINT"
    matmul_tf32 = True

    @staticmethod
    def new_net() -> nn.Module:
        return DPTDepthNet()
