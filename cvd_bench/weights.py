"""Seeded weights made on the device, the same for the program and the
reference: both nets carry the checkpoint's state-dict keys, and every
tensor is drawn by key in sorted order from one generator on the device,
in one call for all convolution weights.

MiDaS-v2: He-normal convolutions, zero conv biases, BatchNorm at identity
with the last BN of each bottleneck scaled to 0.2, running mean 0 and
variance 1, and the output head scaled by 0.01 with bias 2, so that the
depth of a random net stays finite and positive through 33 residual
blocks.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def _draw_convs_(sd, seed: int, device) -> list:
    """He-normal convolution weights of state dict `sd` from one draw on
    `device`; returns their keys."""
    keys = sorted(k for k, v in sd.items() if k.endswith(".weight") and v.dim() == 4)
    sizes = [sd[k].numel() for k in keys]
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    for k, chunk in zip(keys, flat.split(sizes)):
        w = sd[k]
        w.copy_(chunk.view_as(w) * (2.0 / w[0].numel()) ** 0.5)
    return keys


@torch.no_grad()
def seed_midas_(net: nn.Module, seed: int) -> nn.Module:
    """Fill `net` (a MiDaS-v2 on its device) from `seed`."""
    sd = net.state_dict()
    keys = _draw_convs_(sd, seed, next(net.parameters()).device)
    for k, v in sd.items():
        if k in keys:
            continue
        if k.endswith("running_mean") or k.endswith(".bias"):
            v.zero_()
        elif k.endswith("running_var"):
            v.fill_(1.0)
        elif k.endswith(".weight"):  # BatchNorm scale
            v.fill_(0.2 if ".bn3." in k else 1.0)
    sd["scratch.output_conv.4.weight"].mul_(0.01)
    sd["scratch.output_conv.4.bias"].fill_(2.0)
    return net


@torch.no_grad()
def seed_raft_(net: nn.Module, seed: int) -> nn.Module:
    """Fill `net` (a RAFT on its device) from `seed`: He-normal
    convolutions with zero biases, BatchNorm at identity, and the flow
    head's last convolution scaled by 0.01 so that an iteration moves the
    flow by a fraction of a pixel."""
    sd = net.state_dict()
    keys = _draw_convs_(sd, seed, next(net.parameters()).device)
    for k, v in sd.items():
        if k in keys:
            continue
        if k.endswith("running_mean") or k.endswith(".bias"):
            v.zero_()
        elif k.endswith("running_var") or k.endswith(".weight"):
            v.fill_(1.0)
    sd["update_block.flow_head.conv2.weight"].mul_(0.01)
    return net
