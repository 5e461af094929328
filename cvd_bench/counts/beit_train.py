"""Floating-point operations of one BEiT-L/16-512 fine-tune train step,
counted once on the frozen plain reference (reference/beit.py,
reference/losses.py) on the meta device: the forward of the batch's
frames, the joint loss and the backward. torch.utils.flop_counter counts
the matrix products (the encoder's linear layers and its written-out
attention) and the convolutions (transposed ones too), forward and
backward, which are nearly all of the step's operations; the bias's
addition to the scores and its gradient's sums are not counted (no
products: 0.2 G additions a block forward at 512x896, against the
attention's 158 GFLOP a block and step). The net has no grouped
convolution, so the counter's own backward formulas hold.

`attention_flops` is the attention's share in closed form: per hooked-up
block and frame, q k^T and (softmax) v are 2 T^2 D each forward (T tokens,
D the width over all heads), and each has two products of the same size
backward: 12 T^2 D a block and frame."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import beit, losses


def tokens(model: dict, h: int, w: int) -> int:
    """Tokens a frame: the class token and one a patch."""
    return 1 + (h // model["patch"]) * (w // model["patch"])


def train_step_flops(model: dict, frames: int, h: int, w: int, loss_opt: dict) -> int:
    b = frames // 2
    with torch.device("meta"):
        net = beit.build(model)
        images = torch.zeros((b, 2, h, w, 3))
        ext = torch.zeros((b, 2, 3, 4))
        intr = torch.ones((b, 2, 4))
        warp = torch.zeros((b, 2, h, w, 2))
        flows = torch.zeros((b, 2, h, w, 2))
        masks = torch.ones((b, 2, h, w))
        d0 = torch.ones((b, 2, h, w))
        counter = FlopCounterMode(display=False)
        with counter:
            d = beit.depth(net, images.reshape(-1, h, w, 3)).reshape(b, 2, h, w)
            loss = losses.joint(None, d0, d, ext, intr, warp, flows, masks, loss_opt)
            loss.backward()
    return int(counter.get_total_flops())


def attention_flops(model: dict, frames: int, h: int, w: int) -> int:
    """The attention products of a train step's forward and backward."""
    t = tokens(model, h, w)
    blocks = max(model["hooks"]) + 1
    return 12 * t * t * model["hidden"] * blocks * frames
