"""Floating-point operations of one fine-tune train step, counted once on
the frozen plain reference (reference/midas.py, reference/losses.py) on
the meta device: the train-mode forward of the batch's frames, the joint
loss and the backward. torch.utils.flop_counter counts the convolutions
and matrix products (forward, and the backward's input and weight
gradients), which are nearly all of the step's operations. The
counter's own backward formula counts a grouped convolution's weight
gradient as if the convolution were dense (groups times too many: 32 in
ResNeXt's 3x3 convolutions), so the backward is counted here by
`conv_backward_flops`."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

aten = torch.ops.aten


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                        transposed, _output_padding, _groups, output_mask, out_shape=None) -> int:
    """2 x MACs for each gradient asked for (input, weight) of a
    convolution that is not transposed: MACs = B * C_out * H_out * W_out *
    (C_in / groups) * kh * kw, the forward's."""
    if transposed:
        raise ValueError("no transposed convolution in this count")
    macs = 1
    for d in grad_out_shape:
        macs *= d
    for d in w_shape[1:]:
        macs *= d
    return 2 * macs * (int(output_mask[0]) + int(output_mask[1]))

from ..reference import losses, midas


def train_step_flops(model: dict, frames: int, h: int, w: int, loss_opt: dict) -> int:
    b = frames // 2
    with torch.device("meta"):
        net = midas.MidasNet(model["features"], model["backbone_layers"])
        images = torch.zeros((b, 2, h, w, 3))
        ext = torch.zeros((b, 2, 3, 4))
        intr = torch.ones((b, 2, 4))
        warp = torch.zeros((b, 2, h, w, 2))
        flows = torch.zeros((b, 2, h, w, 2))
        masks = torch.ones((b, 2, h, w))
        d0 = torch.ones((b, 2, h, w))
        counter = FlopCounterMode(
            display=False, custom_mapping={aten.convolution_backward: conv_backward_flops})
        with counter:
            d = midas.depth(net, images.reshape(-1, h, w, 3)).reshape(b, 2, h, w)
            loss = losses.joint(None, d0, d, ext, intr, warp, flows, masks, loss_opt)
            loss.backward()
    return int(counter.get_total_flops())
