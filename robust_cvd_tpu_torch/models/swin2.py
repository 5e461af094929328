"""SwinV2-L/24-384 under DPT's decoder, MiDaS v3.1's `dpt_swin2_large_384`
depth network (PyTorch, NCHW).

Birkl, Wofk and Müller, "MiDaS v3.1 - A Model Zoo for Robust Monocular
Relative Depth Estimation" (arXiv:2307.14460); code isl-org/MiDaS
(midas/dpt_depth.py::DPTDepthModel(backbone="swin2l24_384",
non_negative=True), midas/backbones/swin2.py::_make_pretrained_swin2l24_384,
midas/backbones/swin_common.py::_make_swin_backbone). The encoder is timm's
swinv2_large_window12to24_192to384_22kft1k (Liu et al., "Swin Transformer
V2", CVPR 2022, arXiv:2111.09883) with timm 0.6.x's SwinV2 code, the
version MiDaS v3.1 pins: checkpoint dpt_swin2_large_384.pt, RGB normalised
with mean 0.5 and std 0.5, frames squashed to 384x384.

- Patch embedding: a 4x4 stride-4 convolution 3 -> 192 and a LayerNorm, a
  96x96 token map; no absolute position embedding.
- Four stages of (2, 2, 18, 2) blocks at 96, 48, 24 and 12 tokens a side,
  widths 192 << s, heads (6, 12, 24, 48), all 32 wide; window 24 (the
  whole map where it is not larger: 12 in stage 3), pretrained windows
  (12, 12, 12, 6). A block: the map rolled by (-shift, -shift) on odd
  blocks (shift 12, none where the map is at most the window), windows of
  w x w tokens, then res-post-norm: x + LN1(Attn(x)), x + LN2(MLP(x)),
  LayerNorm eps 1e-5, an exact-erf GELU MLP of 4x.
- Attention, scaled cosine: softmax(tau_h q^ k^T + 16 sigmoid(T_h)[idx] +
  M) v with q^, k^ L2-normalised over the head, tau_h = exp(min(
  logit_scale_h, ln 100)), T = cpb_mlp(coords), Linear(2, 512), ReLU,
  Linear(512, H) over the (2w - 1)^2 log-spaced relative coordinates
  (`relative_coords_table`), idx Swin's relative position index (no class
  token) and M = -100 between tokens of different shift regions
  (`region_codes`). The qkv projection's bias is [q_bias, 0, v_bias].
  tau_h q^ and k^ are ordinary torch ops; the tables are made once a
  forward for the 24 blocks (ordinary ops: autograd takes the MLPs'
  backward); the gather, the mask and the table's gradient are inside the
  attention (ops/attention.py::window_attention: the Hopper kernels' d =
  32 instantiation on the card, the written-out softmax on the CPU).
- PatchMerging V2 after stages 0-2: the 2x2 neighbours concatenated in the
  order (0, 0), (1, 0), (0, 1), (1, 1), Linear(4C, 2C, bias=False), then a
  LayerNorm.
- Hooks: the last block of each stage (MiDaS's hooks [1, 1, 17, 1]), before
  the merge, laid out as maps of 192/384/768/1536 channels at 1/4 to 1/32
  of the frame: no readout and no resampling. DPT's decoder takes them
  (models/dpt.py::DPT with Swin2Backbone as its `pretrained`): 3x3
  convolutions to 256, DPT-Large's fusion blocks and head, 384x384 out.

The net squashes its input to 384x384 on entry (bicubic, align_corners
False: MiDaS's cv2.INTER_CUBIC, a = -0.75) and resizes the disparity back
to the frame's size on exit bilinearly (align_corners False). MiDaS's
run.py resizes bicubically; bicubic overshoot would give negative
disparity, and so negative depth in the fine-tune's loss, so the port
departs from it there. So the depth-model contract holds at any frame
size.

Module names follow timm's SwinTransformerV2 under MiDaS's
`pretrained.model.` (`layers.S.blocks.J.attn.cpb_mlp.0`, `layers.S.
downsample.reduction`, ...); the unused final `norm` and classifier `head`
are kept so that a checkpoint loads. `relative_coords_table`,
`relative_position_index` and `attn_mask` are recomputed, not stored;
whether timm 0.6.x stores them is not verified here, and the adapter drops
such keys. timm's stochastic depth (drop-path 0.1) is not applied: the
fine-tune is deterministic, as it is for the other depth models.

Spans (utils/spans.py): `swin2.resize` (in and out), `swin2.embed`,
`swin2.cpb` (the 24 tables), `swin2.stage` (attrs `stage`, `tokens` a
frame, `windows` in the batch, `heads`, `window`, `shift`), `swin2.merge`,
then DPT's `dpt.decoder`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import window_attention
from ..utils.spans import span
from . import dpt
from .depth_model import DepthModel
from .dpt import Mlp

LN_EPS = 1e-5  # timm's SwinV2 LayerNorm
NET_SIDE = 384  # the published input, squashed to
LOGIT_MAX = math.log(1.0 / 0.01)  # the temperature's clamp, ln 100
CPB_HIDDEN = 512
BIAS_SCALE = 16.0  # 16 sigmoid(T)


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B nW, w, w, C), the windows of each image in order."""
    b, h, ww, c = x.shape
    x = x.view(b, h // w, w, ww // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, c)


def window_reverse(windows: torch.Tensor, w: int, h: int, ww: int) -> torch.Tensor:
    """(B nW, w, w, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    x = windows.view(-1, h // w, ww // w, w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, h, ww, c)


def region_codes(resolution: int, window: int, shift: int) -> torch.Tensor:
    """The shift regions of timm's attn_mask on a rolled (r, r) map: (nW,
    w^2) int32 codes of each window's tokens; tokens of different codes are
    masked (-100) from each other."""
    img = torch.zeros((1, resolution, resolution, 1), dtype=torch.int32)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    code = 0
    for hs in cuts:
        for ws in cuts:
            img[:, hs, ws, :] = code
            code += 1
    return window_partition(img, window).reshape(-1, window * window).contiguous()


def relative_coords_table(window: int, pretrained: int) -> torch.Tensor:
    """((2w - 1)^2, 2) float32: each relative offset (dy, dx) over
    (pretrained window - 1), times 8, as sign(c) log2(|c| + 1) / 3."""
    r = torch.arange(-(window - 1), window, dtype=torch.float32)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)
    t = t / (pretrained - 1) * 8
    return torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)


class WindowAttention(nn.Module):
    """timm 0.6.x's SwinV2 WindowAttention: q and v biases, scaled cosine
    attention, the continuous position bias."""

    def __init__(self, dim: int, heads: int, window: int, pretrained: int):
        super().__init__()
        self.heads = heads
        self.window = window
        self.logit_scale = nn.Parameter(torch.log(10 * torch.ones((heads, 1, 1))))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, CPB_HIDDEN), nn.ReLU(),
                                     nn.Linear(CPB_HIDDEN, heads, bias=False))
        self.register_buffer("relative_coords_table", relative_coords_table(window, pretrained),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = nn.Linear(dim, dim)

    def table(self) -> torch.Tensor:
        """16 sigmoid(cpb_mlp(coords)) as (H, (2w - 1)^2)."""
        t = self.cpb_mlp(self.relative_coords_table)
        return (BIAS_SCALE * torch.sigmoid(t)).t().contiguous()

    def forward(self, x, table: torch.Tensor, region: torch.Tensor | None):
        """x: (B nW, w^2, C) windows; `table` this block's (H, R)."""
        b, n, c = x.shape
        bias = torch.cat([self.q_bias, torch.zeros_like(self.v_bias), self.v_bias])
        qkv = F.linear(x, self.qkv.weight, bias).reshape(b, n, 3, self.heads, c // self.heads)
        q, k, v = qkv.unbind(2)
        tau = torch.clamp(self.logit_scale, max=LOGIT_MAX).exp().view(1, 1, self.heads, 1)
        qkv = torch.stack([F.normalize(q, dim=-1) * tau, F.normalize(k, dim=-1), v], 2)
        y = window_attention(qkv, table, (self.window, self.window), region)
        return self.proj(y.reshape(b, n, c))


class SwinBlock(nn.Module):
    """A res-post-norm block on an (r, r) map: window w = min(window, r),
    shift 0 where r <= window."""

    def __init__(self, dim: int, resolution: int, heads: int, window: int, shifted: bool,
                 pretrained: int, mlp_ratio: int):
        super().__init__()
        self.resolution = resolution
        self.window = min(window, resolution)
        self.shift = window // 2 if shifted and resolution > window else 0
        self.attn = WindowAttention(dim, heads, self.window, pretrained)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp_ratio * dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        codes = region_codes(resolution, self.window, self.shift) if self.shift else None
        self.register_buffer("region", codes, persistent=False)

    def forward(self, x, table):
        b, n, c = x.shape
        r, w, s = self.resolution, self.window, self.shift
        h = x.view(b, r, r, c)
        if s:
            h = torch.roll(h, shifts=(-s, -s), dims=(1, 2))
        a = self.attn(window_partition(h, w).view(-1, w * w, c), table, self.region)
        h = window_reverse(a.view(-1, w, w, c), w, r, r)
        if s:
            h = torch.roll(h, shifts=(s, s), dims=(1, 2))
        x = x + self.norm1(h.reshape(b, n, c))
        return x + self.norm2(self.mlp(x))


class PatchMerging(nn.Module):
    """timm 0.6.x's SwinV2 PatchMerging: 2x2 neighbours, a linear
    reduction, then the norm."""

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=LN_EPS)

    def forward(self, x, r: int):
        b, _, c = x.shape
        x = x.view(b, r, r, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1)
        return self.norm(self.reduction(x.view(b, -1, 4 * c)))


class BasicLayer(nn.Module):
    def __init__(self, dim: int, resolution: int, depth: int, heads: int, window: int,
                 pretrained: int, mlp_ratio: int, merge: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, resolution, heads, window, j % 2 == 1, pretrained, mlp_ratio)
            for j in range(depth))
        self.downsample = PatchMerging(dim) if merge else None


class Swin2Encoder(nn.Module):
    """timm's SwinTransformerV2 as MiDaS v3.1 runs it on `image` x `image`
    frames: `levels` the stage widths, `hooked(x, hooks)` the maps (B, C_s,
    r_s, r_s) after block hooks[s] of each stage."""

    def __init__(self, image: int = NET_SIDE, patch: int = 4, embed: int = 192,
                 depths: Sequence[int] = (2, 2, 18, 2), heads: Sequence[int] = (6, 12, 24, 48),
                 window: int = 24, pretrained_windows: Sequence[int] = (12, 12, 12, 6),
                 mlp_ratio: int = 4, classes: int = 1000):
        super().__init__()
        self.patch = patch
        self.image = image
        stages = len(depths)
        self.levels = tuple(embed << s for s in range(stages))
        self.resolutions = tuple((image // patch) >> s for s in range(stages))
        self.patch_embed = PatchEmbed(patch, embed)
        self.layers = nn.ModuleList(
            BasicLayer(self.levels[s], self.resolutions[s], depths[s], heads[s], window,
                       pretrained_windows[s], mlp_ratio, s < stages - 1)
            for s in range(stages))
        self.norm = nn.LayerNorm(self.levels[-1], eps=LN_EPS)
        self.head = nn.Linear(self.levels[-1], classes)

    def tables(self) -> list:
        """Every block's (H, R) table, stage by stage."""
        return [[blk.attn.table() for blk in layer.blocks] for layer in self.layers]

    def hooked(self, x: torch.Tensor, hooks: Sequence[int]) -> list:
        """The maps after block hooks[s] of each stage, (B, C_s, r_s, r_s)."""
        b = x.shape[0]
        with span("swin2.embed"):
            t = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
            t = self.patch_embed.norm(t)
        with span("swin2.cpb"):
            tables = self.tables()
        out = []
        for s, (layer, r) in enumerate(zip(self.layers, self.resolutions)):
            first = layer.blocks[0]
            w = first.window
            shift = max(blk.shift for blk in layer.blocks)
            with span("swin2.stage", stage=s, tokens=r * r, windows=b * (r // w) ** 2,
                      heads=first.attn.heads, window=w, shift=shift):
                for j, (blk, table) in enumerate(zip(layer.blocks, tables[s])):
                    t = blk(t, table)
                    if j == hooks[s]:
                        out.append(t.transpose(1, 2).reshape(b, -1, r, r))
            if layer.downsample is not None:
                with span("swin2.merge"):
                    t = layer.downsample(t, r)
        return out


class Swin2Backbone(nn.Module):
    """MiDaS's `pretrained` for Swin V2 (models/dpt.py::DPT's backbone):
    `model` the encoder, whose stage maps go to DPT's scratch convolutions
    as they are (no reassembly); the frame squashed to the encoder's side
    on entry and the disparity resized back on exit."""

    def __init__(self, model: Swin2Encoder):
        super().__init__()
        self.model = model
        self.widths = model.levels

    def squash(self, x: torch.Tensor) -> torch.Tensor:
        """The frame at the published side, bicubically (MiDaS's transform)."""
        with span("swin2.resize"):
            return F.interpolate(x, size=(self.model.image, self.model.image), mode="bicubic",
                                 align_corners=False)

    def restore(self, d: torch.Tensor, size) -> torch.Tensor:
        """The disparity (B, side, side) at the frame's `size`, bilinearly
        (see the note)."""
        with span("swin2.resize"):
            return F.interpolate(d[:, None], size=tuple(size), mode="bilinear",
                                 align_corners=False)[:, 0]

    def maps(self, x: torch.Tensor, hooks: Sequence[int]) -> list:
        return self.model.hooked(x, hooks)


def Swin2DepthNet(image: int = NET_SIDE, patch: int = 4, embed: int = 192,
                  depths: Sequence[int] = (2, 2, 18, 2), heads: Sequence[int] = (6, 12, 24, 48),
                  window: int = 24, pretrained_windows: Sequence[int] = (12, 12, 12, 6),
                  mlp_ratio: int = 4, hooks: Sequence[int] = (1, 1, 17, 1), features: int = 256,
                  classes: int = 1000) -> dpt.DPT:
    """MiDaS v3.1's DPTDepthModel(backbone="swin2l24_384"): DPT's decoder on
    a Swin V2 encoder, (B, 3, H, W) normalised RGB -> (B, H, W) disparity of
    any frame size, through the squash to `image` and back (see the note).
    The defaults are the published widths; smaller ones give the same
    structure for tests."""
    encoder = Swin2Encoder(image, patch, embed, depths, heads, window, pretrained_windows,
                           mlp_ratio, classes)
    return dpt.DPT(Swin2Backbone(encoder), hooks, features)


class DPTSwin2LargeAdapter(DepthModel):
    """SwinV2-L/24-384, MiDaS v3.1 (registered as `dpt_swin2_large_384`,
    models/registry.py), with TF32 matrix products. The reference gives it
    no fine-tune settings, so the learning rate and the view baseline are
    assumed equal to dpt_large's; frames are resized to multiples of 32
    for the pipeline, and the net squashes them to 384x384 itself."""

    align = 32
    learning_rate = 1e-6
    lambda_view_baseline = 1e-4
    checkpoint = "dpt_swin2_large_384.pt"
    checkpoint_env = "DPT_SWIN2_CHECKPOINT"
    matmul_tf32 = True

    @staticmethod
    def new_net() -> nn.Module:
        return Swin2DepthNet()

    @staticmethod
    def read_checkpoint(path: str) -> dict[str, torch.Tensor]:
        """DepthModel's reader, less any stored relative_coords_table,
        relative_position_index or attn_mask (recomputed)."""
        sd = DepthModel.read_checkpoint(path)
        drop = (".relative_coords_table", ".relative_position_index", ".attn_mask")
        return {k: v for k, v in sd.items() if not k.endswith(drop)}
