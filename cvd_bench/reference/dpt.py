"""Plain DPT-Large (Ranftl, Bochkovskiy and Koltun, ICCV 2021,
arXiv:2103.13413), the MiDaS v3.0 depth model: DPTDepthModel(backbone=
"vitl16_384", readout "project", non_negative=True), a ViT-L/16 encoder
hooked after blocks 5, 11, 17 and 23, reassembled to four scales, and a
fusion decoder with a disparity head; and its plain fine-tune train steps.

A frozen copy of the benchmark's reference, written after isl-org/DPT
(dpt/models.py, dpt/vit.py, dpt/blocks.py) and timm's VisionTransformer.
Module names are the checkpoint's state-dict keys. Float32; the caller sets
the precision (reference/train.py::precision: full float32, or bf16
autocast for the control). It imports neither the program nor JAX.

Departures from the published code:
- attention is written out, softmax(q k^T / 8) v, where timm's newer
  releases call F.scaled_dot_product_attention (the same function);
- the tokens are laid out on the frame's grid directly (reshape), where
  dpt/vit.py's forward_vit runs Transpose and a fixed-size Unflatten and
  then re-flattens for other sizes (the same layout);
- blocks run up to the last hooked one (the last block at DPT-Large's
  hooks), and the final LayerNorm and the classifier head are not run:
  DPT computes them and discards the result;
- no dropout and no drop-path (0 in DPT's eval and in this fine-tune);
- the fine-tune steps are reference/train.py::steps with this net and
  MiDaS v3's input normalisation (mean 0.5, std 0.5); DPT has no
  BatchNorm, so its train-mode and eval-mode forwards are the same.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import losses
from .train import precision

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


NET_KEYS = ("hidden", "heads", "blocks", "mlp", "patch", "pos_grid", "hooks", "widths",
            "features", "classes")


def build(model: Dict) -> DPT:
    """The net of a configuration's `model` entry."""
    return DPT(**{k: model[k] for k in NET_KEYS})


def normalize(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB (..., H, W, 3) -> (..., 3, H, W), mean 0.5 and std 0.5."""
    mean = images.new_tensor([0.5, 0.5, 0.5])
    std = images.new_tensor([0.5, 0.5, 0.5])
    return ((images - mean) / std).movedim(-1, -3).contiguous()


def depth(net: DPT, images: torch.Tensor) -> torch.Tensor:
    """Depth (B, H, W) = 1 / (disparity + 1e-7) of images (B, H, W, 3)."""
    return 1.0 / (net(normalize(images)) + 1e-7)


def steps(model: Dict, seed: int, images, pairs, flows, masks, pose, batches: List[List[int]],
          loss_opt: Dict, lr: float, kind: str = "float32", eval_batch: int = 4,
          half_batch: bool = False) -> Dict:
    """reference/train.py::steps with the DPT net (seeded by
    weights_dpt.seed_dpt_): the initial depth of the frames the batches
    use, then per step the forward, the depth-transform scales, the joint
    loss, the backward and an Adam step with bias correction, skipped where
    the loss or a gradient is not finite. Returns each step's loss, each
    parameter's gradient norm at the first step and its change after the
    last, by state-dict name. `half_batch` plants a fault: each step takes
    the first half of its batch only."""
    from .. import weights_dpt

    losses.check_supported(loss_opt)
    device = images.device
    with torch.device(device):
        net = build(model)
    weights_dpt.seed_dpt_(net, seed)
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
