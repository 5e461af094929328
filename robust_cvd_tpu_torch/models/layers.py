"""Shared NN building blocks (PyTorch, NCHW).

Port of robust_cvd_tpu/models/layers.py. The JAX package lowers the
align-corners resize to hat-matrix contractions for the TPU's matrix unit;
here both conventions are `F.interpolate`.

BatchNorm follows Flax's semantics (the JAX package's network): eval mode
normalises with the running statistics (eps 1e-5); train mode normalises
with the batch's biased statistics and leaves the running statistics alone
until `commit_batch_stats` applies Flax's update, running = 0.9 running +
0.1 batch, with the BIASED batch variance (torch's own BatchNorm2d would
fold in the unbiased one) and only where the step's guard flag is set.
Within `per_slice_batch_stats(net, g)` a train-mode batch of g equal
slices normalises each slice with its own statistics (the per-pair eval,
which the JAX package runs one pair at a time). Within
`global_batch_stats(net, mesh)` train mode takes its statistics over the
batches of every rank of a data mesh (parallel/mesh.py), as the JAX
package's jit does over a sharded batch.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn as nn
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


BN_MOMENTUM = 0.9  # Flax's convention: running = 0.9 * running + 0.1 * batch


class BatchNorm2d(nn.BatchNorm2d):
    """nn.BatchNorm2d (same state-dict keys) with Flax's train mode.

    In train mode the forward normalises with the batch mean and biased
    variance and records them in `batch_stats`; the running buffers change
    only through `commit_batch_stats`. Flax computes the variance as
    E[x^2] - E[x]^2 clipped at 0, torch's kernel by a two-pass/Welford sum:
    the same biased variance up to rounding. The batch statistics come out
    of the fused batch_norm call itself (scratch running buffers at momentum
    1 receive the batch mean and the unbiased variance, which is rescaled
    by (n - 1) / n), so train mode adds no pass over the activations."""

    batch_stats = None
    # > 1: train mode normalises each of this many equal slices of the batch
    # with its own statistics and records none (see per_slice_batch_stats)
    stat_slices = 1
    # a parallel.mesh.Mesh: train mode takes the global batch's statistics
    # (see global_batch_stats)
    mesh = None

    def forward(self, x):
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias,
                False, 0.0, self.eps,
            )
        if self.stat_slices > 1:
            # (G*K, C, H, W) -> (K, G*C, H, W): slice g's channels become
            # channels of their own, so one fused call gives each slice its
            # own statistics
            g = self.stat_slices
            n, c, h, w = x.shape
            xs = x.reshape(g, n // g, c, h, w).transpose(0, 1).reshape(n // g, g * c, h, w)
            y = F.batch_norm(xs, None, None, self.weight.repeat(g), self.bias.repeat(g),
                             True, 0.0, self.eps)
            return y.reshape(n // g, g, c, h, w).transpose(0, 1).reshape(n, c, h, w)
        if self.mesh is not None:
            return self._global_forward(x)
        mean = x.new_zeros(self.num_features)
        var = x.new_zeros(self.num_features)
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        n = x.numel() // self.num_features
        self.batch_stats = (mean, var * ((n - 1) / n))
        return y

    def _global_forward(self, x):
        """Train mode over the mesh's global batch: one differentiable
        all-reduce of the per-channel sums of x and x^2 and the element
        count, then Flax's statistics, mean E[x] and biased variance
        max(E[x^2] - E[x]^2, 0). The backward sums each rank's gradient of
        the statistics over the ranks, so the gradients are those of the
        global batch's loss."""
        c = self.num_features
        sums = torch.cat([x.sum((0, 2, 3)), (x * x).sum((0, 2, 3)),
                          x.new_full((1,), x.numel() // c)])
        sums = self.mesh.all_reduce_sum(sums)
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c : 2 * c] / sums[-1] - mean * mean, min=0.0)
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = (x - mean[:, None, None]) * scale[:, None, None] + self.bias[:, None, None]
        self.batch_stats = (mean.detach(), var.detach())
        return y


def batch_norms(net: nn.Module) -> list:
    return [m for m in net.modules() if isinstance(m, BatchNorm2d)]


@contextmanager
def per_slice_batch_stats(net: nn.Module, slices: int):
    """Within the block, a train-mode forward of a batch of `slices` equal
    slices normalises each slice with its own batch statistics, as if each
    went through the net alone, and records no statistics to commit."""
    layers = batch_norms(net)
    for m in layers:
        m.stat_slices = slices
    try:
        yield
    finally:
        for m in layers:
            m.stat_slices = 1
            m.batch_stats = None


@contextmanager
def global_batch_stats(net: nn.Module, mesh):
    """Within the block, a train-mode forward takes its BatchNorm statistics
    over the batches of every rank of `mesh` (nothing changes for None)."""
    layers = batch_norms(net) if mesh is not None else []
    for m in layers:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in layers:
            m.mesh = None


def commit_batch_stats(net: nn.Module, ok: torch.Tensor) -> None:
    """Fold the last train-mode forward's batch statistics into the
    running statistics (Flax's update) where the device bool `ok` is set,
    and keep them bitwise where it is not (the step's non-finite guard,
    robust_cvd_tpu/training/fine_tune.py:307). One concatenated update, so
    the cost does not grow with the number of layers; no host sync."""
    layers = [m for m in batch_norms(net) if m.batch_stats is not None]
    if not layers:
        return
    with torch.no_grad():
        running = [m.running_mean for m in layers] + [m.running_var for m in layers]
        batch = [m.batch_stats[0] for m in layers] + [m.batch_stats[1] for m in layers]
        old = torch.cat(running)
        new = BN_MOMENTUM * old + (1 - BN_MOMENTUM) * torch.cat(batch)
        upd = torch.where(ok, new, old)
        torch._foreach_copy_(running, list(upd.split([t.numel() for t in running])))
    for m in layers:
        m.batch_stats = None


class ResidualConvUnit(nn.Module):
    """reference blocks.py:88-128: relu, 3x3, relu, 3x3, plus the skip.

    With `relu_skip` (MiDaS v2) the skip adds relu(x), not x: the
    reference's inplace ReLU rewrites x before `out + x` runs, and the
    released checkpoints were trained that way (robust_cvd_tpu/models/
    midas.py::ResidualConvUnit). DPT's unit (isl-org/DPT dpt/blocks.py
    ResidualConvUnit_custom, whose ReLU is not in place) adds x."""

    def __init__(self, features: int, relu_skip: bool = True):
        super().__init__()
        self.relu_skip = relu_skip
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        y = F.relu(x)
        return self.conv2(F.relu(self.conv1(y))) + (y if self.relu_skip else x)


class FeatureFusionBlock(nn.Module):
    """reference blocks.py:131-160: optional skip-add through an RCU, an
    RCU, then 2x bilinear upsample with align_corners=True. refinenet4 gets
    no skip, so its resConfUnit1 is dead weight the checkpoint carries.

    DPT's block (dpt/blocks.py FeatureFusionBlock_custom) is the same with
    units that add x (`relu_skip=False`) and a 1x1 convolution with bias
    after the upsample (`out_conv=True`)."""

    def __init__(self, features: int, relu_skip: bool = True, out_conv: bool = False):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features, relu_skip)
        self.resConfUnit2 = ResidualConvUnit(features, relu_skip)
        self.out_conv = nn.Conv2d(features, features, 1) if out_conv else None

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = upsample2x(self.resConfUnit2(x), align_corners=True)
        return x if self.out_conv is None else self.out_conv(x)


class _Upsample2x(nn.Module):
    """The output head's 2x upsample: align_corners=False in MiDaS v2
    (reference blocks.py:54-85), True in DPT (dpt/models.py's head)."""

    def __init__(self, align_corners: bool = False):
        super().__init__()
        self.align_corners = align_corners

    def forward(self, x):
        return upsample2x(x, align_corners=self.align_corners)


def output_head(features: int, mid: int, align_corners: bool) -> nn.Sequential:
    """The disparity head `scratch.output_conv`: 3x3 to `mid`, 2x bilinear
    upsample, 3x3 to 32, ReLU, 1x1 to 1, ReLU (non-negative disparity).
    MiDaS v2: mid 128, align_corners False; DPT: mid features // 2, True."""
    return nn.Sequential(
        nn.Conv2d(features, mid, 3, padding=1),
        _Upsample2x(align_corners),
        nn.Conv2d(mid, 32, 3, padding=1),
        nn.ReLU(),
        nn.Conv2d(32, 1, 1),
        nn.ReLU(),
    )
