"""Shared NN building blocks (PyTorch, NCHW).

Port of robust_cvd_tpu/models/layers.py. The JAX package lowers the
align-corners resize to hat-matrix contractions for the TPU's matrix unit;
here both conventions are `F.interpolate`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) to out_hw in one of torch's two
    conventions.

    align_corners=False is jax.image.resize(..., "bilinear"), which
    antialiases when it shrinks (a triangle filter widened by the scale,
    weights renormalised at the borders): F.interpolate's antialias=True
    computes the same filter, and it leaves an enlarged axis alone, so it is
    asked for whenever an axis shrinks."""
    h, w = x.shape[-2:]
    oh, ow = out_hw
    if (oh, ow) == (h, w):
        return x
    antialias = not align_corners and (oh < h or ow < w)
    return F.interpolate(x, size=(oh, ow), mode="bilinear",
                         align_corners=align_corners, antialias=antialias)


def upsample2x(x: torch.Tensor, align_corners: bool) -> torch.Tensor:
    """2x bilinear upsample of (B, C, H, W). align_corners=False is the
    half-pixel convention of jax.image.resize, which does not antialias
    when it enlarges, so no antialias is needed here."""
    return F.interpolate(
        x, scale_factor=2, mode="bilinear", align_corners=align_corners
    )
