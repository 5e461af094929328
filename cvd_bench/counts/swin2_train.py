"""Floating-point operations of one SwinV2-L/24-384 fine-tune train step,
counted once on the frozen plain reference (reference/swin2.py,
reference/losses.py) on the meta device: the forward of the batch's
frames, the joint loss and the backward. torch.utils.flop_counter counts
the matrix products (the encoder's linear layers, the continuous position
bias's MLPs and the written-out window attention) and the convolutions,
forward and backward, which are nearly all of the step's operations; the
bias's and the mask's additions to the scores, the normalisations, the
rolls and the resizes are not counted (no products). The net has no
grouped convolution, so the counter's own backward formulas hold.

`attention_flops` is the window attention's share in closed form: per
block, window and frame, q k^T and (softmax) v are 2 N^2 C each forward (N
tokens a window, C the stage's width over all heads), and each has two
products of the same size backward: 12 N^2 C a window, block and frame,
summed over the blocks (stages: window min(24, side), side 96 / 2^s)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import losses, swin2


def stages(model: dict) -> list:
    """(side, window, windows a frame, width, blocks) of each stage."""
    out = []
    for s, depth in enumerate(model["depths"]):
        side = model["image"] // model["patch"] >> s
        w = min(model["window"], side)
        out.append((side, w, (side // w) ** 2, model["embed"] << s, depth))
    return out


def tokens(model: dict) -> int:
    """Tokens a frame at stage 0."""
    return stages(model)[0][0] ** 2


def windows(model: dict, frames: int) -> int:
    """Windows a train step at stage 0 (the batch's frames' windows)."""
    return stages(model)[0][2] * frames


def train_step_flops(model: dict, frames: int, h: int, w: int, loss_opt: dict) -> int:
    b = frames // 2
    with torch.device("meta"):
        net = swin2.build(model)
        images = torch.zeros((b, 2, h, w, 3))
        ext = torch.zeros((b, 2, 3, 4))
        intr = torch.ones((b, 2, 4))
        warp = torch.zeros((b, 2, h, w, 2))
        flows = torch.zeros((b, 2, h, w, 2))
        masks = torch.ones((b, 2, h, w))
        d0 = torch.ones((b, 2, h, w))
        counter = FlopCounterMode(display=False)
        with counter:
            d = swin2.depth(net, images.reshape(-1, h, w, 3)).reshape(b, 2, h, w)
            loss = losses.joint(None, d0, d, ext, intr, warp, flows, masks, loss_opt)
            loss.backward()
    return int(counter.get_total_flops())


def attention_flops(model: dict, frames: int) -> int:
    """The window attention products of a train step's forward and
    backward."""
    return sum(12 * (w * w) ** 2 * width * nw * depth * frames
               for _, w, nw, width, depth in stages(model))
