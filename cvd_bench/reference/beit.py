"""Plain BEiT-L/16-512 under DPT's decoder, MiDaS v3.1's
dpt_beit_large_512 (Birkl, Wofk and Mueller, arXiv:2307.14460;
DPTDepthModel(backbone="beitl16_512", non_negative=True)): timm's
beit_large_patch16_512 encoder (Bao et al., ICLR 2022, arXiv:2106.08254)
with a relative-position bias and LayerScale, hooked after blocks 5, 11,
17 and 23, reassembled and decoded as DPT-Large; and its plain fine-tune
train steps.

A frozen copy of the benchmark's reference, written after isl-org/MiDaS
(midas/backbones/beit.py: _get_rel_pos_bias, attention_forward,
block_forward, patch_embed_forward, beit_forward_features) and timm's Beit
(gen_relative_position_index). The reassembly, the decoder and the head are
reference/dpt.py's classes (MiDaS v3.1's _make_beit_backbone builds them as
DPT-Large's); the steps are reference/dpt.py's loop with this net. Module
names are the checkpoint's state-dict keys. Float32; the caller sets the
precision (reference/train.py::precision). It imports neither the program
nor JAX.

Departures from the published code:
- the bias is gathered (an (H, N, N) tensor a block) and added to the
  scaled scores, and the softmax written out, where timm's newer releases
  pass it to F.scaled_dot_product_attention as a mask (the same function);
- the tokens are laid out on the frame's grid directly (reshape), as in
  reference/dpt.py;
- blocks run up to the last hooked one, and the classifier's fc_norm and
  head are not run (MiDaS discards them);
- no dropout and no drop-path (0 in MiDaS's eval and in this fine-tune);
- the refinenets' `size` argument (upsample to the next level's size) is
  scale_factor=2: the same where each level is half the next, as at every
  frame a multiple of 32;
- `bias=False` (a planted fault of the cell's control) leaves the bias out.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import dpt as ref_dpt
from . import losses
from .train import precision


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
        self.bias = True

    def _get_rel_pos_bias(self, window_size):
        old_height = 2 * self.window_size[0] - 1
        old_width = 2 * self.window_size[1] - 1
        new_height = 2 * window_size[0] - 1
        new_width = 2 * window_size[1] - 1
        old_table = self.relative_position_bias_table
        old_num = self.num_relative_distance
        new_num = new_height * new_width + 3
        old_sub = old_table[: old_num - 3]
        old_sub = old_sub.reshape(1, old_width, old_height, -1).permute(0, 3, 1, 2)
        new_sub = F.interpolate(old_sub, size=(new_height, new_width), mode="bilinear",
                                align_corners=False)
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
        if self.bias:
            attn = attn + self._get_rel_pos_bias((resolution[0] // 16, resolution[1] // 16))
        attn = attn.softmax(dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, -1))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp, window_size, init_values):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = ref_dpt.Mlp(dim, mlp)
        self.gamma_1 = nn.Parameter(init_values * torch.ones(dim))
        self.gamma_2 = nn.Parameter(init_values * torch.ones(dim))

    def forward(self, x, resolution):
        x = x + self.gamma_1 * self.attn(self.norm1(x), resolution)
        return x + self.gamma_2 * self.mlp(self.norm2(x))


class Beit(nn.Module):
    def __init__(self, dim, heads, depth, mlp, patch, grid, classes, init_values):
        super().__init__()
        self.patch = patch
        self.patch_embed = ref_dpt.PatchEmbed(patch, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.blocks = nn.ModuleList([Block(dim, heads, mlp, (grid, grid), init_values)
                                     for _ in range(depth)])
        self.fc_norm = nn.LayerNorm(dim, eps=1e-6)
        self.head = nn.Linear(dim, classes)


class DPTBeit(ref_dpt.DPT):
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


NET_KEYS = ("hidden", "heads", "blocks", "mlp", "patch", "table_grid", "hooks", "widths",
            "features", "classes", "init_values")


def build(model: Dict, bias: bool = True) -> DPTBeit:
    """The net of a configuration's `model` entry; `bias=False` leaves the
    relative-position bias out (a planted fault)."""
    net = DPTBeit(**{k: model[k] for k in NET_KEYS})
    for m in net.modules():
        if isinstance(m, Attention):
            m.bias = bias
    return net


normalize = ref_dpt.normalize
depth = ref_dpt.depth


def steps(model: Dict, seed: int, images, pairs, flows, masks, pose, batches: List[List[int]],
          loss_opt: Dict, lr: float, kind: str = "float32", eval_batch: int = 4,
          half_batch: bool = False, bias: bool = True) -> Dict:
    """reference/dpt.py::steps with this net (seeded by
    weights_beit.seed_beit_): the initial depth of the frames the batches
    use, then per step the forward, the depth-transform scales, the joint
    loss, the backward and an Adam step with bias correction, skipped where
    the loss or a gradient is not finite. Returns each step's loss, each
    parameter's gradient norm at the first step and its change after the
    last, by state-dict name. `half_batch` and `bias=False` plant faults."""
    from .. import weights_beit

    losses.check_supported(loss_opt)
    device = images.device
    with torch.device(device):
        net = build(model, bias)
    weights_beit.seed_beit_(net, seed)
    ext, intr, scales, warp = pose
    frames_used = sorted({int(f) for b in batches for q in b for f in pairs[q].tolist()})

    with precision(kind, device):
        net.eval()
        depth0 = {}
        with torch.no_grad():
            for s in range(0, len(frames_used), eval_batch):
                ids = frames_used[s : s + eval_batch]
                for f, d in zip(ids, depth(net, images[ids]).float()):
                    depth0[f] = d

        params = dict(net.named_parameters())
        init = {k: p.detach().clone() for k, p in params.items()}
        mu = {k: torch.zeros_like(p) for k, p in params.items()}
        nu = {k: torch.zeros_like(p) for k, p in params.items()}
        b1, b2, eps = 0.9, 0.999, 1e-8
        count = 0
        out_losses, grad1 = [], None
        net.train()
        for ids in batches:
            if half_batch:
                ids = ids[: max(1, len(ids) // 2)]
            fr = pairs[ids]  # (B, 2)
            b = fr.shape[0]
            d = depth(net, images[fr.reshape(-1)]).float().reshape(b, 2, *images.shape[1:3])
            d = d * scales[fr]
            d0 = torch.stack([torch.stack([depth0[int(f)] for f in row]) for row in fr.tolist()])
            loss = losses.joint(None, d0, d, ext[fr], intr[fr], warp[fr], flows[ids], masks[ids],
                                loss_opt)
            net.zero_grad(set_to_none=False)
            loss.backward()
            grads = {k: torch.zeros_like(p) if p.grad is None else p.grad.detach().float()
                     for k, p in params.items()}
            ok = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all())
                                                    for g in grads.values())
            out_losses.append(float(loss.detach()))
            if grad1 is None:
                grad1 = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
            if not ok:
                continue
            count += 1
            with torch.no_grad():
                for k, p in params.items():
                    g = grads[k]
                    mu[k].mul_(b1).add_((1 - b1) * g)
                    nu[k].mul_(b2).add_((1 - b2) * g * g)
                    mhat = mu[k] / (1 - b1 ** count)
                    vhat = nu[k] / (1 - b2 ** count)
                    p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
        change = {k: float(torch.linalg.vector_norm(p.detach() - init[k])) for k, p in params.items()}
    return {"losses": out_losses, "grad_norms": grad1, "change_norms": change}
