"""The benchmark's inputs, made from the seed: a panning clip, its frame
pairs, their exact flows and masks, and a solved camera path.

A seeded texture pans by a fixed number of pixels a frame, so the flow
between frames i and j is exactly (i - j) * shift px in x at the clip's
resolution. Every seed gives the same sizes and pairs; only the values
change.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def panning_frames(n: int, h: int, w: int, shift: int, seed: int) -> np.ndarray:
    """(n, h, w, 3) float32 in [0, 1]: frame i is columns [i*shift,
    i*shift + w) of one seeded, 3x3-box-blurred noise texture."""
    rng = np.random.default_rng(seed)
    noise = rng.uniform(0.0, 1.0, (h + 2, w + shift * (n - 1) + 2, 3)).astype(np.float32)
    texture = sum(
        noise[dy : dy + h, dx : dx + noise.shape[1] - 2] for dy in range(3) for dx in range(3)
    ) / 9.0
    return np.stack([texture[:, i * shift : i * shift + w] for i in range(n)])


def hierarchical2_pairs(n: int) -> List[Tuple[int, int]]:
    """The two-way hierarchical2 pairs of an n-frame clip, sorted:
    power-of-2 distances, starts every half distance (the reference's
    utils/frame_sampling.py, mode hierarchical2)."""
    pairs = set()
    for level in range(0, int(math.floor(math.log2(n - 1))) + 1):
        dist = 1 << level
        step = 1 << max(0, level - 1)
        for start in range(0, n, step):
            for sign in (-1, 1):
                end = start + sign * dist
                if 0 <= end < n:
                    pairs.add((start, end))
    return sorted(pairs)


def training_pairs(n: int) -> List[Tuple[int, int]]:
    """The pairs (i, j) with i < j that training uses."""
    return [(i, j) for i, j in hierarchical2_pairs(n) if i < j]


def exact_flows(pairs, h: int, w: int, shift: int, device):
    """Flows (P, 2, h, w, 2) of each pair both ways (i -> j, j -> i) and
    their in-bounds masks (P, 2, h, w) float, on `device`."""
    import torch

    dx = torch.tensor([[(i - j) * shift, (j - i) * shift] for i, j in pairs],
                      dtype=torch.float32, device=device)  # (P, 2)
    p = dx.shape[0]
    flows = torch.zeros((p, 2, h, w, 2), device=device)
    flows[..., 0] = dx[:, :, None, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)
    target = torch.floor(xs + dx[..., None] + 0.5)  # (P, 2, w): the nearest pixel
    masks = ((target >= 0) & (target < w)).float()[:, :, None, :].expand(p, 2, h, w)
    return flows, masks.contiguous()


def camera_path(n: int, h: int, w: int, seed: int, device, hfov_deg: float = 60.0):
    """A solved camera path for the panning clip, as the pose state a train
    step reads: extrinsics (n, 3, 4) camera-to-world with small seeded
    rotations and a sideways track, pixel intrinsics (n, 4), depth-transform
    scale maps near 1 (n, h, w) and spatial warp maps near 0 (n, h, w, 2),
    both smooth (bilinear from a 4x4 grid)."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(seed)
    angles = 0.01 * torch.randn((n, 3), generator=g, device=device)
    ax, ay, az = angles.unbind(1)
    c, s = torch.cos, torch.sin
    one, zero = torch.ones_like(ax), torch.zeros_like(ax)
    rx = torch.stack([one, zero, zero, zero, c(ax), -s(ax), zero, s(ax), c(ax)], 1).view(n, 3, 3)
    ry = torch.stack([c(ay), zero, s(ay), zero, one, zero, -s(ay), zero, c(ay)], 1).view(n, 3, 3)
    rz = torch.stack([c(az), -s(az), zero, s(az), c(az), zero, zero, zero, one], 1).view(n, 3, 3)
    rot = rz @ ry @ rx
    pos = torch.stack([torch.arange(n, device=device, dtype=torch.float32) * 0.02, zero, zero], 1)
    pos = pos + 0.002 * torch.randn((n, 3), generator=g, device=device)
    extrinsics = torch.cat([rot, pos[:, :, None]], 2)
    f = w / 2.0 / math.tan(math.radians(hfov_deg) / 2.0)
    intrinsics = torch.tensor([f, f, (w - 1) / 2.0, (h - 1) / 2.0], device=device).expand(n, 4)
    coarse = torch.randn((n, 3, 4, 4), generator=g, device=device)
    smooth = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=True)
    scales = 1.0 + 0.05 * smooth[:, 0]
    warp = 0.002 * smooth[:, 1:].permute(0, 2, 3, 1)
    return extrinsics.contiguous(), intrinsics.contiguous(), scales.contiguous(), warp.contiguous()
