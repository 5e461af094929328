"""BEiT-L/16-512 under DPT's decoder, MiDaS v3.1's `dpt_beit_large_512`
depth network (PyTorch, NCHW).

Birkl, Wofk and Müller, "MiDaS v3.1 - A Model Zoo for Robust Monocular
Relative Depth Estimation" (arXiv:2307.14460); code isl-org/MiDaS
(midas/dpt_depth.py::DPTDepthModel(backbone="beitl16_512",
non_negative=True), midas/backbones/beit.py). The encoder is timm's
beit_large_patch16_512 (Bao, Dong, Piao and Wei, "BEiT: BERT Pre-Training
of Image Transformers", ICLR 2022, arXiv:2106.08254): checkpoint
dpt_beit_large_512.pt, RGB normalised with mean 0.5 and std 0.5.

- Tokens: a 16x16 patch embedding of any frame whose sides are multiples
  of 16 (midas/backbones/beit.py::patch_embed_forward) and a class token;
  no position embedding.
- 24 pre-LayerNorm blocks (eps 1e-6) with LayerScale:
  x + gamma_1 * Attn(LN1 x), then x + gamma_2 * MLP(LN2 x), an exact-erf
  GELU MLP of 4096. The qkv projection's bias is [q_bias, 0, v_bias]
  (no k bias: a buffer of zeros). The attention is softmax(q k^T / 8 +
  B) v with B each block's relative-position bias:
- B (midas/backbones/beit.py::_get_rel_pos_bias): each block's table is
  published for the 32x32 grid of 512x512, (63 * 63 + 3, 16); its first
  63 * 63 entries are resized bilinearly (align_corners=False) to
  (2 Wh - 1) x (2 Ww - 1) for the frame's Wh x Ww grid and the three class
  entries appended; B[h, i, j] = table[idx(i, j), h] with timm's
  gen_relative_position_index (ops/attention.py::relative_position_index).
  The resize is an ordinary torch op (its backward is autograd's), once a
  forward for all blocks; the gather, the bias and the table's gradient
  are inside the attention (ops/attention.py::vit_attention: the Hopper
  kernels' bias path on the card, the written-out softmax on the CPU).
- Reassembly, decoder and head: DPT-Large's (models/dpt.py), hooked after
  blocks 5, 11, 17 and 23 with the "project" readout, widths
  256/512/1024/1024, features 256, as MiDaS v3.1's _make_beit_backbone
  builds them.

Module names follow timm's Beit under MiDaS's `pretrained.model.`
(`blocks.N.attn.relative_position_bias_table`, `blocks.N.gamma_1`, ...);
the unused fc_norm and classifier head are kept so that a checkpoint
loads. Whether MiDaS's timm version stores `relative_position_index` as a
persistent buffer was not verified here: the adapter drops such keys
(the index is recomputed for every grid).

Spans (utils/spans.py): `beit.embed`, `beit.relpos` (the tables' resize),
`beit.encoder` (attrs `tokens` a frame, `frames` and `grid`), then DPT's
`dpt.reassemble` and `dpt.decoder`.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import vit_attention
from ..utils.spans import span
from .depth_model import DepthModel
from .dpt import LN_EPS, DPTDepthNet, Mlp, PatchEmbed

TABLE_GRID = 32  # the published tables' token grid, 512 / 16
INIT_VALUES = 1e-5  # timm's LayerScale initialisation for BEiT-L


def resize_table(table: torch.Tensor, table_grid: int, grid) -> torch.Tensor:
    """_get_rel_pos_bias's table for a (Wh, Ww) grid: (..., (2g - 1)^2 + 3,
    H) published for a g x g grid -> (..., (2 Wh - 1)(2 Ww - 1) + 3, H); the
    leading axes are batched (one resize for all blocks)."""
    wh, ww = grid
    old, new = 2 * table_grid - 1, (2 * wh - 1, 2 * ww - 1)
    lead, heads = table.shape[:-2], table.shape[-1]
    sub = table[..., : old * old, :].reshape(-1, old, old, heads).permute(0, 3, 1, 2)
    sub = F.interpolate(sub, size=new, mode="bilinear", align_corners=False)
    sub = sub.permute(0, 2, 3, 1).reshape(*lead, new[0] * new[1], heads)
    return torch.cat([sub, table[..., old * old :, :]], -2)


class Attention(nn.Module):
    """timm's Beit Attention: a qkv projection with q and v biases only,
    heads of dim // heads, scale 1 / sqrt(head width), the relative-position
    bias, an output projection."""

    def __init__(self, dim: int, heads: int, table_grid: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("k_bias", torch.zeros(dim), persistent=False)
        self.v_bias = nn.Parameter(torch.zeros(dim))
        side = 2 * table_grid - 1
        self.relative_position_bias_table = nn.Parameter(torch.zeros(side * side + 3, heads))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, table: torch.Tensor, grid):
        """`table`: this block's resized table as (H, R)."""
        b, n, c = x.shape
        bias = torch.cat([self.q_bias, self.k_bias, self.v_bias])
        qkv = F.linear(x, self.qkv.weight, bias).reshape(b, n, 3, self.heads, c // self.heads)
        return self.proj(vit_attention(qkv, table, grid).reshape(b, n, c))


class Block(nn.Module):
    """x + gamma_1 Attn(LN1(x)), then x + gamma_2 MLP(LN2(x))."""

    def __init__(self, dim: int, heads: int, mlp: int, table_grid: int, init_values: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads, table_grid)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, mlp)
        self.gamma_1 = nn.Parameter(torch.full((dim,), init_values))
        self.gamma_2 = nn.Parameter(torch.full((dim,), init_values))

    def forward(self, x, table, grid):
        x = x + self.gamma_1 * self.attn(self.norm1(x), table, grid)
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class BeitEncoder(nn.Module):
    """timm's Beit as MiDaS v3.1 runs it, an encoder for DPTDepthNet: the
    tokens of any frame whose sides are multiples of the patch."""

    def __init__(self, dim: int = 1024, heads: int = 16, blocks: int = 24, mlp: int = 4096,
                 patch: int = 16, table_grid: int = TABLE_GRID, classes: int = 1000,
                 init_values: float = INIT_VALUES):
        super().__init__()
        self.patch = patch
        self.table_grid = table_grid
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.patch_embed = PatchEmbed(patch, dim)
        self.blocks = nn.ModuleList(Block(dim, heads, mlp, table_grid, init_values)
                                    for _ in range(blocks))
        self.fc_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, classes)

    def tables(self, grid, count: int) -> list:
        """The first `count` blocks' tables resized to `grid`, each (H, R)."""
        stacked = torch.stack([blk.attn.relative_position_bias_table
                               for blk in self.blocks[:count]])
        return list(resize_table(stacked, self.table_grid, grid).transpose(1, 2).contiguous())

    def hooked(self, x: torch.Tensor, hooks: Sequence[int]) -> list:
        """The tokens after each hooked block (DPTDepthNet's encoder
        contract); the blocks after the last hook are not run."""
        b, _, h, w = x.shape
        grid = (h // self.patch, w // self.patch)
        with span("beit.embed"):
            t = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
            t = torch.cat([self.cls_token.expand(b, -1, -1), t], 1)
        with span("beit.relpos"):
            tables = self.tables(grid, hooks[-1] + 1)
        with span("beit.encoder", tokens=t.shape[1], frames=b, grid=list(grid)):
            out = []
            for i, (blk, table) in enumerate(zip(self.blocks, tables)):
                t = blk(t, table, grid)
                if i in hooks:
                    out.append(t)
        return out


def BeitDepthNet(hidden: int = 1024, heads: int = 16, blocks: int = 24, mlp: int = 4096,
                 patch: int = 16, table_grid: int = TABLE_GRID,
                 hooks: Sequence[int] = (5, 11, 17, 23),
                 widths: Sequence[int] = (256, 512, 1024, 1024), features: int = 256,
                 classes: int = 1000, init_values: float = INIT_VALUES) -> DPTDepthNet:
    """MiDaS v3.1's DPTDepthModel(backbone="beitl16_512"): DPT's reassembly
    and decoder on a BEiT encoder. The defaults are the published widths;
    smaller ones give the same structure for tests."""
    encoder = BeitEncoder(hidden, heads, blocks, mlp, patch, table_grid, classes, init_values)
    return DPTDepthNet(hidden=hidden, hooks=hooks, widths=widths, features=features,
                       encoder=encoder)


class DPTBeitLargeAdapter(DepthModel):
    """BEiT-L/16-512, MiDaS v3.1 (registered as `dpt_beit_large_512`,
    models/registry.py), with TF32 matrix products. The reference gives it
    no fine-tune settings, so the learning rate and the view baseline are
    assumed equal to dpt_large's; MiDaS v3.1 resizes to multiples of 32."""

    align = 32
    learning_rate = 1e-6
    lambda_view_baseline = 1e-4
    checkpoint = "dpt_beit_large_512.pt"
    checkpoint_env = "DPT_BEIT_CHECKPOINT"
    matmul_tf32 = True

    @staticmethod
    def new_net() -> nn.Module:
        return BeitDepthNet()

    @staticmethod
    def read_checkpoint(path: str) -> dict[str, torch.Tensor]:
        """DepthModel's reader, less any stored relative_position_index
        (recomputed for every grid)."""
        sd = DepthModel.read_checkpoint(path)
        return {k: v for k, v in sd.items() if not k.endswith(".relative_position_index")}
