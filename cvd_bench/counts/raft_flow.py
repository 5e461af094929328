"""Floating-point operations of one frame pair of the flow chunk, counted
once on the frozen plain reference on the meta device: RAFT at the flow
size (both encoders, the correlation volume, 20 update iterations, the
upsampling) by torch.utils.flop_counter (convolutions and matrix
products), plus the registration's matching product (1024 x 1024 x 225)
and RANSAC's 256 x 1024 projections, which are small beside RAFT."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import raft


def pair_flops(cfg: dict) -> int:
    r = cfg["raft"]
    h, w = cfg["clip"]["flow_hw"]
    with torch.device("meta"):
        net = raft.RAFT(r["iters"], r["corr_levels"], r["corr_radius"], r["hidden_dim"],
                        r["context_dim"], r["feature_dim"])
        im = torch.zeros((1, 3, h, w))
        counter = FlopCounterMode(display=False)
        with counter, torch.no_grad():
            net(im, im)
    matching = 2 * 1024 * 1024 * 225
    ransac = 256 * 1024 * 2 * 9
    return int(counter.get_total_flops()) + matching + ransac
