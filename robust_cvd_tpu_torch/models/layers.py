"""Shared NN building blocks (PyTorch, NCHW).

Port of robust_cvd_tpu/models/layers.py. The JAX package lowers the
align-corners resize to hat-matrix contractions for the TPU's matrix unit;
here both conventions are `F.interpolate`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2x(x: torch.Tensor, align_corners: bool) -> torch.Tensor:
    """2x bilinear upsample of (B, C, H, W). align_corners=False is the
    half-pixel convention of jax.image.resize, which does not antialias
    when it enlarges, so no antialias is needed here."""
    return F.interpolate(
        x, scale_factor=2, mode="bilinear", align_corners=align_corners
    )
