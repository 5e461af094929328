"""A plain BEiT-L/16-512 depth network for the tests: MiDaS v3.1's
DPTDepthModel(backbone="beitl16_512", non_negative=True), written after
isl-org/MiDaS (midas/backbones/beit.py: _get_rel_pos_bias,
attention_forward, block_forward, patch_embed_forward,
beit_forward_features; midas/dpt_depth.py) and timm's Beit
(gen_relative_position_index, Attention, Block), independent of the port.
It imports neither the port nor JAX; the reassembly and the decoder are
tests/plain_dpt.py's (MiDaS v3.1 builds them as DPT-Large's).

Module names are the checkpoint's state-dict keys, so one state dict loads
into this net and into the port's models/beit.py::BeitDepthNet. The
defaults are BEiT-L's widths; the tests use smaller ones.

Departures from the published code:
- the relative-position bias is gathered and added to the scaled scores
  and the softmax written out (timm's newer releases pass the bias to
  F.scaled_dot_product_attention as a mask: the same function);
- the tokens are laid out on the frame's grid directly (reshape), as in
  plain_dpt.py;
- blocks run up to the last hooked one; the classifier's fc_norm and head
  are not run (MiDaS discards them);
- no dropout and no drop-path (0 in MiDaS's eval and in this fine-tune);
- the refinenets' `size` argument of MiDaS v3.1 (upsample to the next
  level's size) is scale_factor=2 here: the same where each level is half
  the next, as at every frame size that is a multiple of 32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

import plain_dpt


def gen_relative_position_index(window_size):
    """timm's gen_relative_position_index: (Wh Ww + 1, Wh Ww + 1)."""
    num_relative_distance = (2 * window_size[0] - 1) * (2 * window_size[1] - 1) + 3
    window_area = window_size[0] * window_size[1]
    coords = torch.stack(torch.meshgrid(
        [torch.arange(window_size[0]), torch.arange(window_size[1])], indexing="ij"))
    coords_flatten = torch.flatten(coords, 1)
    relative_coords = coords_flatten[:, :, None] - coords_flatten[:, None, :]
    relative_coords = relative_coords.permute(1, 2, 0).contiguous()
    relative_coords[:, :, 0] += window_size[0] - 1
    relative_coords[:, :, 1] += window_size[1] - 1
    relative_coords[:, :, 0] *= 2 * window_size[1] - 1
    index = torch.zeros(size=(window_area + 1,) * 2, dtype=relative_coords.dtype)
    index[1:, 1:] = relative_coords.sum(-1)
    index[0, 0:] = num_relative_distance - 3
    index[0:, 0] = num_relative_distance - 2
    index[0, 0] = num_relative_distance - 1
    return index


class Attention(nn.Module):
    def __init__(self, dim, heads, window_size):
        super().__init__()
        self.num_heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = nn.Linear(dim, dim * 3, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("k_bias", torch.zeros(dim), persistent=False)
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.window_size = window_size
        self.num_relative_distance = (2 * window_size[0] - 1) * (2 * window_size[1] - 1) + 3
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(self.num_relative_distance, heads))
        self.proj = nn.Linear(dim, dim)

    def _get_rel_pos_bias(self, window_size):
        """MiDaS v3.1's: the table resized to the frame's grid, gathered."""
        old_height = 2 * self.window_size[0] - 1
        old_width = 2 * self.window_size[1] - 1
        new_height = 2 * window_size[0] - 1
        new_width = 2 * window_size[1] - 1
        old_table = self.relative_position_bias_table
        old_num = self.num_relative_distance
        new_num = new_height * new_width + 3
        old_sub = old_table[: old_num - 3]
        old_sub = old_sub.reshape(1, old_width, old_height, -1).permute(0, 3, 1, 2)
        new_sub = F.interpolate(old_sub, size=(new_height, new_width), mode="bilinear")
        new_sub = new_sub.permute(0, 2, 3, 1).reshape(new_num - 3, -1)
        new_table = torch.cat([new_sub, old_table[old_num - 3:]])
        index = gen_relative_position_index(window_size).to(new_table.device)
        n = window_size[0] * window_size[1] + 1
        bias = new_table[index.view(-1)].view(n, n, -1)
        return bias.permute(2, 0, 1).contiguous().unsqueeze(0)

    def forward(self, x, resolution):
        b, n, c = x.shape
        qkv_bias = torch.cat((self.q_bias, self.k_bias, self.v_bias))
        qkv = F.linear(input=x, weight=self.qkv.weight, bias=qkv_bias)
        qkv = qkv.reshape(b, n, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = attn + self._get_rel_pos_bias((resolution[0] // 16, resolution[1] // 16))
        attn = attn.softmax(dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, -1))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp, window_size, init_values):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = plain_dpt.Mlp(dim, mlp)
        self.gamma_1 = nn.Parameter(init_values * torch.ones(dim))
        self.gamma_2 = nn.Parameter(init_values * torch.ones(dim))

    def forward(self, x, resolution):
        x = x + self.gamma_1 * self.attn(self.norm1(x), resolution)
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class Beit(nn.Module):
    def __init__(self, dim, heads, depth, mlp, patch, grid, classes, init_values):
        super().__init__()
        self.patch = patch
        self.patch_embed = plain_dpt.PatchEmbed(patch, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.blocks = nn.ModuleList([Block(dim, heads, mlp, (grid, grid), init_values)
                                     for _ in range(depth)])
        self.fc_norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, classes)


class DPTBeit(plain_dpt.DPT):
    """(B, 3, H, W) normalised RGB -> (B, H, W) disparity."""

    def __init__(self, hidden=1024, heads=16, blocks=24, mlp=4096, patch=16, table_grid=32,
                 hooks=(5, 11, 17, 23), widths=(256, 512, 1024, 1024), features=256,
                 classes=1000, init_values=1e-5):
        super().__init__(hidden=hidden, heads=1, blocks=0, mlp=mlp, patch=patch, pos_grid=1,
                         hooks=hooks, widths=widths, features=features, classes=classes)
        self.pretrained.model = Beit(hidden, heads, blocks, mlp, patch, table_grid, classes,
                                     init_values)

    def forward(self, x):
        beit = self.pretrained.model
        b, _, h, w = x.shape
        gh, gw = h // beit.patch, w // beit.patch
        t = beit.patch_embed.proj(x).flatten(2).transpose(1, 2)
        t = torch.cat((beit.cls_token.expand(b, -1, -1), t), dim=1)
        outs = []
        for i in range(max(self.hooks) + 1):
            t = beit.blocks[i](t, (h, w))
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


normalize = plain_dpt.normalize
depth = plain_dpt.depth


@torch.no_grad()
def seeded_state_dict(net, seed):
    """plain_dpt.seeded_state_dict's weights, then LayerScale's gammas
    1 + N(0, 0.3) and the relative-position tables N(0, 0.5): at timm's
    1e-5 the blocks are near the identity and a test could not see the
    attention or the bias."""
    sd = plain_dpt.seeded_state_dict(net, seed)
    g = torch.Generator().manual_seed(seed + 1)
    for k in sorted(sd):
        if k.endswith(("gamma_1", "gamma_2")):
            sd[k].copy_(1.0 + 0.3 * torch.randn(sd[k].shape, generator=g, dtype=torch.float64))
        elif k.endswith("relative_position_bias_table"):
            sd[k].copy_(0.5 * torch.randn(sd[k].shape, generator=g, dtype=torch.float64))
    return sd

