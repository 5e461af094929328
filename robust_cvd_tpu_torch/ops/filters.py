"""Depth-map filters (PyTorch, batched over frames).

Port of robust_cvd_tpu/ops/filters.py (reference lib/Processor.cpp):

  - flow_guided_filter (.cpp:315-590): each pixel is tracked through the
    forward and backward flow chains within +-frame_radius frames; every
    visited frame's world point is sampled and expressed as z-depth in the
    reference frame's camera, weighted by exp(-3 * depth_ratio), and the
    output is the weighted mean (or weighted median). One chain step is one
    batch of tensor ops over all frames and pixels, as the JAX package's
    lax.scan step; far connections add one single-hop sample per far pair.
  - bilateral_filter (.cpp:183-313): a (2*frame_radius+1) temporal x
    (2*spatial_radius+1)^2 spatial window with gaussian depth-range weights
    (and optional colour-range weights).
  - clip_max_depth (.cpp:592-619).

Plain PyTorch on (N, H, W) tensors of any device; no TPU kernel of the JAX
package lies under these functions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import geometry


class FilterCameras(NamedTuple):
    """Per-frame camera data that puts samples in a common frame.

    position: (N, 3); forward: (N, 3) camera forward (-Z axis in world);
    intrinsics: (N, 4) pixel (fx, fy, cx, cy)."""

    position: torch.Tensor
    forward: torch.Tensor
    intrinsics: torch.Tensor


def _in_bounds(loc: torch.Tensor, h: int, w: int) -> torch.Tensor:
    x, y = loc[..., 0], loc[..., 1]
    return (x >= -0.5) & (x < w - 0.5) & (y >= -0.5) & (y < h - 0.5)


def _weighted_median(zs: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """Per-pixel weighted median over dim 0: the first sorted sample whose
    cumulative weight reaches half the total (a stable sort, as jnp.argsort)."""
    order = torch.argsort(zs, dim=0, stable=True)
    z_sorted = torch.gather(zs, 0, order)
    cum = torch.cumsum(torch.gather(wgt, 0, order), dim=0)
    half = cum[-1] / 2.0
    pick = torch.argmax((cum >= half[None]).to(torch.uint8), dim=0)
    return torch.gather(z_sorted, 0, pick[None])[0]


def flow_guided_filter(depth: torch.Tensor, *args, median: bool = False, **kwargs) -> torch.Tensor:
    """Flow-guided spatio-temporal depth filter (spatial_radius = 0, the
    pipeline default: reference Processor.h:66, pose_optimization.py:292):
    the weighted mean (or weighted median) of flow_guided_samples, which
    takes the same arguments. Returns the filtered (N, H, W)."""
    zs, wgt = flow_guided_samples(depth, *args, **kwargs)
    if median:
        return _weighted_median(zs, wgt)
    wsum = wgt.sum(0)
    out = (zs * wgt).sum(0) / wsum.clamp_min(1e-12)
    return torch.where(wsum > 0, out, torch.zeros_like(out))


def flow_guided_samples(
    depth: torch.Tensor,
    world_points: torch.Tensor,
    cams: FilterCameras,
    flows_fwd: torch.Tensor,
    masks_fwd: torch.Tensor,
    flows_bwd: torch.Tensor,
    masks_bwd: torch.Tensor,
    frame_radius: int = 4,
    far_flows: Optional[torch.Tensor] = None,
    far_masks: Optional[torch.Tensor] = None,
    far_tgt: Optional[torch.Tensor] = None,
    far_valid: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The flow-guided filter's samples of every pixel and their weights.

    depth:        (N, H, W) transformed depth maps
    world_points: (N, H, W, 3) world-space positions of every pixel
    flows_fwd:    (N, H, W, 2) flow i -> i+1 (last frame unused)
    masks_fwd:    (N, H, W)    bool
    flows_bwd:    (N, H, W, 2) flow i -> i-1 (first frame unused)
    masks_bwd:    (N, H, W)    bool

    Far connections (reference Processor.cpp:414-426, 521-545): padded
    per-frame stacks of the pairs (i, far_tgt[i, f]) outside the window,
    one single-hop sample each:
    far_flows (N, F, H, W, 2), far_masks (N, F, H, W) bool,
    far_tgt (N, F) int, far_valid (N, F) bool. Each far pair counts on its
    own, the JAX package's deterministic superset of the reference's
    order-dependent `break`.

    Returns (zs, wgt), each (K, N, H, W): the z-depth of each sample in its
    pixel's camera (the pixel's own first) and exp(-3 * depth ratio), zero
    where the sample is invalid."""
    n, h, w = depth.shape
    dev = depth.device
    pix = geometry.pixel_grid((h, w), dev)  # (H, W, 2)
    frames = torch.arange(n, device=dev)

    def zdepth(sampled_world: torch.Tensor, lead: int) -> torch.Tensor:
        """z-depth in each frame's reference camera; the frame is dim 0 and
        `lead` more dims precede the pixel's (H, W)."""
        shape = (n,) + (1,) * (lead + 2) + (3,)
        pos = cams.position.reshape(shape)
        fwd = cams.forward.reshape(shape)
        return ((sampled_world - pos) * fwd).sum(-1)

    def chain(direction: int):
        flows = flows_fwd if direction > 0 else flows_bwd
        masks = masks_fwd if direction > 0 else masks_bwd
        flat_flow = flows.reshape(-1, 2)
        flat_mask = masks.reshape(-1)
        loc = pix.expand(n, h, w, 2)
        valid = torch.ones((n, h, w), dtype=torch.bool, device=dev)
        zs, vs = [], []
        for k in range(frame_radius):
            # chain step k: the flow to apply lives on frame i + direction*k
            src = frames + direction * k
            src_c = src.clamp(0, n - 1)
            ix = torch.round(loc[..., 0]).long().clamp(0, w - 1)
            iy = torch.round(loc[..., 1]).long().clamp(0, h - 1)
            idx = (src_c[:, None, None] * h + iy) * w + ix
            ok = flat_mask[idx]
            loc = loc + flat_flow[idx]
            tgt = src + direction
            in_seq = (tgt >= 0) & (tgt < n)
            valid = valid & ok & _in_bounds(loc, h, w) & in_seq[:, None, None]
            # the target frame's world points at the tracked location
            sampled = geometry.grid_sample(world_points[tgt.clamp(0, n - 1)], loc)
            zs.append(zdepth(sampled, 0))
            vs.append(valid)
        return zs, vs

    z_fwd, v_fwd = chain(+1)
    z_bwd, v_bwd = chain(-1)
    ref_z = zdepth(world_points, 0)  # the pixel's own sample, always valid

    zs = torch.stack([ref_z] + z_fwd + z_bwd)  # (K, N, H, W)
    own = torch.ones((n, h, w), dtype=torch.bool, device=dev)
    vs = torch.stack([own] + v_fwd + v_bwd).to(depth.dtype)

    if far_flows is not None and far_flows.shape[1] > 0:
        # a single hop from the integer pixel grid, where the reference's
        # int(x + 0.5) rounding is exact (Processor.cpp:523-535)
        loc = pix[None, None] + far_flows  # (N, F, H, W, 2)
        ok = far_masks & _in_bounds(loc, h, w) & far_valid[:, :, None, None]
        sampled = geometry.grid_sample(world_points[far_tgt.long().clamp(0, n - 1)], loc)
        z_far = zdepth(sampled, 1)  # (N, F, H, W)
        zs = torch.cat([zs, z_far.transpose(0, 1)])
        vs = torch.cat([vs, ok.transpose(0, 1).to(depth.dtype)])

    ratio = torch.maximum(zs, ref_z[None]) / torch.minimum(zs, ref_z[None]).clamp_min(1e-12)
    return zs, torch.exp(-ratio * 3.0) * vs


def bilateral_filter(
    depth: torch.Tensor,
    spatial_radius: int = 2,
    frame_radius: int = 0,
    depth_sigma: float = 0.3,
    color: Optional[torch.Tensor] = None,
    color_sigma: float = 0.0,
    median: bool = False,
) -> torch.Tensor:
    """Spatio-temporal bilateral depth filter (reference
    Processor.cpp:183-313). depth: (N, H, W); color: (N, H, W, 3)."""
    n, h, w = depth.shape
    dev, dt_ = depth.device, depth.dtype
    inv_2ds2 = 1.0 / (2.0 * depth_sigma * depth_sigma)
    use_color = color is not None and color_sigma > 0
    inv_2cs2 = 1.0 / (2.0 * color_sigma * color_sigma) if use_color else 0.0
    frames = torch.arange(n, device=dev)

    taps, weights = [], []
    for dt in range(-frame_radius, frame_radius + 1):
        shifted_t = torch.roll(depth, -dt, dims=0)
        valid_t = torch.ones((n, 1, 1), dtype=dt_, device=dev)
        if dt != 0:
            idx = frames + dt
            valid_t = ((idx >= 0) & (idx < n)).to(dt_)[:, None, None]
        for dy in range(-spatial_radius, spatial_radius + 1):
            for dx in range(-spatial_radius, spatial_radius + 1):
                s = torch.roll(shifted_t, (-dy, -dx), dims=(1, 2))
                wgt = torch.exp(-torch.square(s - depth) * inv_2ds2) * valid_t
                if use_color:
                    c = torch.roll(torch.roll(color, -dt, dims=0), (-dy, -dx), dims=(1, 2))
                    cd = torch.square(c - color).sum(-1)
                    wgt = wgt * torch.exp(-cd * inv_2cs2)
                # zero the wrapped borders
                ym = torch.zeros(h, dtype=dt_, device=dev)
                ym[max(0, -dy) : h - max(0, dy)] = 1.0
                xm = torch.zeros(w, dtype=dt_, device=dev)
                xm[max(0, -dx) : w - max(0, dx)] = 1.0
                taps.append(s)
                weights.append(wgt * ym[None, :, None] * xm[None, None, :])

    zs = torch.stack(taps)
    ws = torch.stack(weights)
    if median:
        return _weighted_median(zs, ws)
    return (zs * ws).sum(0) / ws.sum(0).clamp_min(1e-12)


def clip_max_depth(depth: torch.Tensor, max_depth: float = 1000.0) -> torch.Tensor:
    """(reference Processor.cpp:592-619)."""
    return depth.clamp_max(max_depth)
