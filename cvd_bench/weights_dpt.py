"""Seeded DPT-Large weights made on the device, the same for the program
and the reference: both nets carry MiDaS v3.0's state-dict keys, and every
tensor is drawn by key in sorted order from one generator on the device,
all convolution weights in one call first.

- Convolutions (the patch embedding and the transposed ones included):
  He-normal, std sqrt(2 / weight[0].numel());
- linear weights and the position embedding: normal with std 0.02,
  truncated at two standard deviations (timm's ViT initialisation); the
  class token 1e-6;
- LayerNorm at identity; biases 0;
- the head's last convolution scaled by 0.002 with bias 2, so that the
  depth of a random net stays finite, positive and near 0.5, as
  weights.seed_midas_'s 0.01 keeps MiDaS v2's. DPT's decoder has no
  BatchNorm: its features double in spread through each fusion block (std
  ~40 into the head), and at 0.01 the disparity spans 0.3-3, where the
  camera path of clip.py puts points of a 32-frame pair across the other
  camera's plane (a joint loss of 1e11-1e13 on 2 of 3 seeds tried); at
  0.002 it spans about 1.7-2.3 (MiDaS v2's seeded net 1.1-2.3).
"""

from __future__ import annotations

import torch
import torch.nn as nn

STD = 0.02
HEAD_SCALE = 0.002


@torch.no_grad()
def seed_dpt_(net: nn.Module, seed: int) -> nn.Module:
    """Fill `net` (a DPT on its device) from `seed`."""
    sd = net.state_dict()
    device = next(net.parameters()).device
    g = torch.Generator(device=device).manual_seed(seed)
    keys = sorted(sd)
    convs = [k for k in keys if k.endswith(".weight") and sd[k].dim() == 4]
    sizes = [sd[k].numel() for k in convs]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    for k, chunk in zip(convs, flat.split(sizes)):
        w = sd[k]
        w.copy_(chunk.view_as(w) * (2.0 / w[0].numel()) ** 0.5)
    for k in keys:
        v = sd[k]
        if k in convs:
            continue
        if k.endswith(".bias"):
            v.zero_()
        elif k.endswith("cls_token"):
            v.fill_(1e-6)
        elif k.endswith("pos_embed") or v.dim() == 2:
            nn.init.trunc_normal_(v, std=STD, a=-2 * STD, b=2 * STD, generator=g)
        else:  # LayerNorm scale
            v.fill_(1.0)
    sd["scratch.output_conv.4.weight"].mul_(HEAD_SCALE)
    sd["scratch.output_conv.4.bias"].fill_(2.0)
    return net
