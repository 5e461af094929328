"""Seeded SwinV2-L/24-384 depth-net weights made on the device, the same
for the program and the reference: both nets carry MiDaS v3.1's state-dict
keys, and every tensor is drawn by key in sorted order from one generator
on the device, all convolution weights in one call first, as
weights_dpt.py draws DPT-Large's.

- Convolutions (the patch embedding included): He-normal, std sqrt(2 /
  weight[0].numel());
- linear weights: normal with std 0.02, truncated at two standard
  deviations (timm's initialisation);
- LayerNorm at identity; biases 0, the attention's q and v biases too;
- each head's temperature `logit_scale`: log(10) + N(0, 0.3), around
  timm's log(10);
- the continuous position bias's MLPs: the first layer's weights N(0, 1)
  and biases N(0, 0.5), the second's weights N(0, 2 / sqrt(512)). The
  coordinates lie within +-1.4, so T spreads about +-1.5 and 16
  sigmoid(T) from about 3 to 13 across a row, as a trained Swin V2's
  local attention has it. At timm's std 0.02 T is about 0, and 16
  sigmoid(T) about 8 everywhere: a constant the softmax cannot see, whose
  gradient would fall under the check's negligible-leaf cut;
- the head's last convolution scaled by 0.002 with bias 2, as DPT-Large's
  (weights_dpt.py: a decoder without BatchNorm).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

STD = 0.02
HEAD_SCALE = 0.002
LOGIT_SPREAD = 0.3
CPB_BIAS_STD = 0.5
CPB_OUT_GAIN = 2.0


@torch.no_grad()
def seed_swin2_(net: nn.Module, seed: int) -> nn.Module:
    """Fill `net` (a Swin V2 depth net on its device) from `seed`."""
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

    def normal(v, std):
        return std * torch.randn(v.shape, generator=g, device=device)

    for k in keys:
        v = sd[k]
        if k in convs:
            continue
        if k.endswith("logit_scale"):
            v.copy_(math.log(10.0) + normal(v, LOGIT_SPREAD))
        elif k.endswith("cpb_mlp.0.weight"):
            v.copy_(normal(v, 1.0))
        elif k.endswith("cpb_mlp.0.bias"):
            v.copy_(normal(v, CPB_BIAS_STD))
        elif k.endswith("cpb_mlp.2.weight"):
            v.copy_(normal(v, CPB_OUT_GAIN / math.sqrt(v.shape[1])))
        elif k.endswith((".bias", ".q_bias", ".v_bias")):
            v.zero_()
        elif v.dim() == 2:
            nn.init.trunc_normal_(v, std=STD, a=-2 * STD, b=2 * STD, generator=g)
        else:  # LayerNorm scale
            v.fill_(1.0)
    sd["scratch.output_conv.4.weight"].mul_(HEAD_SCALE)
    sd["scratch.output_conv.4.bias"].fill_(2.0)
    return net
