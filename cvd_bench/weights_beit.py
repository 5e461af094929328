"""Seeded BEiT-L/16-512 depth-net weights made on the device, the same for
the program and the reference: both nets carry MiDaS v3.1's state-dict
keys, and every tensor is drawn by key in sorted order from one generator
on the device, all convolution weights in one call first, as
weights_dpt.py draws DPT-Large's.

- Convolutions (the patch embedding and the transposed ones included):
  He-normal, std sqrt(2 / weight[0].numel());
- linear weights: normal with std 0.02, truncated at two standard
  deviations (timm's initialisation); the class token 1e-6;
- LayerNorm at identity; biases 0, the attention's q and v biases too;
- LayerScale's gamma_1 and gamma_2: 1 + N(0, 0.1) a channel. timm starts
  BEiT-L at 1e-5, where every block is nearly the identity: no comparison
  could see the attention, and the tables' gradients (scaled by gamma_1)
  would fall under the check's negligible-leaf cut;
- the relative-position tables: N(0, 3). Seeded scores q.k/8 have a spread
  of about 0.4, so the bias shapes each row's softmax (a row's largest
  biases, about 11, lead it), as a trained BEiT's local attention does.
  At 1 the tables' gradients were 4e-4 to 2e-2 of the median leaf's on
  the card, so the check's cut (1e-3) dropped some of them, and leaving
  the bias out moved the loss by 2e-4 to 9e-4 only; at 3, 2.7e-3 to 0.29
  over 12 seeds, and the loss moves by 1.5e-3 to 4.8e-2 (PERF.md §2).
  timm's std 0.02 would hide the bias altogether;
- the head's last convolution scaled by 0.002 with bias 2, as DPT-Large's
  (weights_dpt.py: a decoder without BatchNorm).
"""

from __future__ import annotations

import torch
import torch.nn as nn

STD = 0.02
HEAD_SCALE = 0.002
GAMMA_SPREAD = 0.1
TABLE_STD = 3.0


@torch.no_grad()
def seed_beit_(net: nn.Module, seed: int) -> nn.Module:
    """Fill `net` (a BEiT depth net on its device) from `seed`."""
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
        if k.endswith((".bias", ".q_bias", ".v_bias")):
            v.zero_()
        elif k.endswith("cls_token"):
            v.fill_(1e-6)
        elif k.endswith((".gamma_1", ".gamma_2")):
            v.copy_(1.0 + GAMMA_SPREAD * torch.randn(v.shape, generator=g, device=device))
        elif k.endswith("relative_position_bias_table"):
            v.copy_(TABLE_STD * torch.randn(v.shape, generator=g, device=device))
        elif v.dim() == 2:
            nn.init.trunc_normal_(v, std=STD, a=-2 * STD, b=2 * STD, generator=g)
        else:  # LayerNorm scale
            v.fill_(1.0)
    sd["scratch.output_conv.4.weight"].mul_(HEAD_SCALE)
    sd["scratch.output_conv.4.bias"].fill_(2.0)
    return net
