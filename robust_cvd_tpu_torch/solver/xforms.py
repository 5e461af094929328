"""Depth-map and image-warp transforms as tensorized spline grids (PyTorch).

Port of robust_cvd_tpu/solver/xforms.py (reference
lib/DepthMapTransform.{h,cpp}, lib/ValueTransform.h). A whole clip's
transforms are one tensor: depth grids are (N, gz, gy, gx) multiplicative
scale handles, spatial warps are (N, gy, gx, 2) NDC displacement handles.
Evaluation is a gather of precomputed (indices, weights) taps.

Domain conventions (reference lib/DepthMapTransform.cpp:739-948):
  - Grid handles span the full NDC square: grid coord = (ndc + 1) * (g - 1) / 2,
    clamped into [0, g-1). NDC y is +1 at the image top.
  - The depth-wise axis (gz > 1) is indexed by source DISPARITY, linearly
    between [1/depth_max, 1/depth_min].
  - Cubic interpolation = Catmull-Rom (.cpp:671-678) with border taps
    clamped (weights accumulate onto the clamped handle).
  - Depth-grid deformation cost: per grid edge, (a - b) / min(|a|, |b|)
    (.cpp:631-667). Spatial deformation cost: the handle values themselves.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class GridSpec(NamedTuple):
    """Static description of a grid transform."""

    gx: int = 1
    gy: int = 1
    gz: int = 1
    cubic: bool = False
    # Disparity domain for the depth-wise axis (only used when gz > 1).
    disp_min: float = 0.0
    disp_max: float = 0.0

    @property
    def spatial(self) -> bool:
        return self.gx > 1 or self.gy > 1

    @property
    def depthwise(self) -> bool:
        return self.gz > 1

    @property
    def num_handles(self) -> int:
        return self.gx * self.gy * self.gz


def init_depth_grid(num_frames: int, spec: GridSpec, device=None) -> torch.Tensor:
    """Scale handles initialized to 1 (identity transform)."""
    return torch.ones((num_frames, spec.gz, spec.gy, spec.gx), dtype=torch.float32,
                      device=device)


def init_spatial_grid(num_frames: int, gy: int, gx: int, device=None) -> torch.Tensor:
    """Warp handles initialized to 0 (identity warp)."""
    return torch.zeros((num_frames, gy, gx, 2), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Interpolation taps: they depend only on sample locations and SOURCE depth,
# constant during a solve, so they are computed once per solver stage.
# ---------------------------------------------------------------------------


def _axis_coord(v: torch.Tensor, g: int):
    """NDC coordinate -> (integer cell, fractional offset) on a g-handle axis."""
    upper = float(np.float32(np.nextafter(g - 1, 0.0)))
    scaled = torch.clamp((v + 1.0) * (g - 1) / 2.0, 0.0, upper)
    idx = torch.clamp(scaled.long(), 0, max(g - 2, 0))
    return idx, scaled - idx


def _depth_axis_coord(src_depth: torch.Tensor, spec: GridSpec):
    interval = (spec.disp_max - spec.disp_min) / (spec.gz - 1)
    disp = 1.0 / src_depth.clamp_min(1e-12)
    upper = float(np.float32(np.nextafter(spec.gz - 1, 0.0)))
    scaled = torch.clamp((disp - spec.disp_min) / interval, 0.0, upper)
    idx = torch.clamp(scaled.long(), 0, max(spec.gz - 2, 0))
    return idx, scaled - idx


def _catmull_rom(t: torch.Tensor) -> torch.Tensor:
    """Cubic Hermite spline weights for the 4 taps around a cell
    (reference lib/DepthMapTransform.cpp:671-678)."""
    t2 = t * t
    t3 = t2 * t
    return torch.stack(
        [
            -0.5 * t3 + t2 - 0.5 * t,
            1.5 * t3 - 2.5 * t2 + 1.0,
            -1.5 * t3 + 2.0 * t2 + 0.5 * t,
            0.5 * t3 - 0.5 * t2,
        ],
        dim=-1,
    )


def _linear_taps(idx, rel, g: int):
    """2-tap linear interpolation (indices (..., 2), weights (..., 2))."""
    taps = torch.stack([idx, torch.clamp(idx + 1, max=g - 1)], dim=-1)
    w = torch.stack([1.0 - rel, rel], dim=-1)
    return taps, w


def _cubic_taps(idx, rel, g: int):
    """4-tap Catmull-Rom with border clamping (duplicated indices receive
    their weights twice, like the reference's clamped handles)."""
    offs = torch.arange(-1, 3, device=idx.device)
    taps = torch.clamp(idx[..., None] + offs, 0, g - 1)
    return taps, _catmull_rom(rel)


def grid_gather(
    spec: GridSpec, loc_ndc: torch.Tensor, src_depth: torch.Tensor | None = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat handle indices + weights for sample locations.

    loc_ndc: (..., 2) NDC coordinates; src_depth: (...,) required if gz > 1.
    Returns (idx (..., K) int64 into the flattened (gz*gy*gx) grid,
             w (..., K) float32), K = product of the taps per active axis.
    """
    tap = _cubic_taps if spec.cubic else _linear_taps
    batch = loc_ndc.shape[:-1]
    dev = loc_ndc.device

    def unit():
        return (
            torch.zeros(batch + (1,), dtype=torch.long, device=dev),
            torch.ones(batch + (1,), dtype=torch.float32, device=dev),
        )

    if spec.spatial:
        ix, rx = _axis_coord(loc_ndc[..., 0], spec.gx)
        iy, ry = _axis_coord(loc_ndc[..., 1], spec.gy)
        tx, wx = tap(ix, rx, spec.gx)
        ty, wy = tap(iy, ry, spec.gy)
    else:
        tx, wx = unit()
        ty, wy = tx, wx

    if spec.depthwise:
        if src_depth is None:
            raise ValueError("a depth-wise grid needs the source depth")
        iz, rz = _depth_axis_coord(src_depth, spec)
        tz, wz = tap(iz, rz, spec.gz)
    else:
        tz, wz = unit()

    idx = (
        tz[..., :, None, None] * (spec.gy * spec.gx)
        + ty[..., None, :, None] * spec.gx
        + tx[..., None, None, :]
    )
    w = wz[..., :, None, None] * wy[..., None, :, None] * wx[..., None, None, :]
    return idx.reshape(batch + (-1,)), w.reshape(batch + (-1,))


def eval_depth_scale(grid: torch.Tensor, idx: torch.Tensor, w: torch.Tensor):
    """Interpolated scale factor at precomputed taps.
    grid: (gz, gy, gx) one frame's handles; idx/w: (..., K)."""
    return (grid.reshape(-1)[idx] * w).sum(-1)


def eval_spatial_warp(grid: torch.Tensor, idx: torch.Tensor, w: torch.Tensor):
    """Interpolated NDC displacement (..., 2) at precomputed taps.
    grid: (gy, gx, 2) one frame's handles."""
    return (grid.reshape(-1, 2)[idx] * w[..., None]).sum(-2)


def _pixel_ndc(shape, device) -> torch.Tensor:
    h, w = shape
    x = -1.0 + torch.arange(w, dtype=torch.float32, device=device) * (2.0 / (w - 1.0))
    y = 1.0 - torch.arange(h, dtype=torch.float32, device=device) * (2.0 / (h - 1.0))
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def depth_param_map(grid: torch.Tensor, spec: GridSpec, shape, src_depth=None):
    """Per-pixel scale factors (H, W) of one frame's grid (gz, gy, gx)
    (reference GridDepthXform::paramMap, .cpp:950-994)."""
    idx, w = grid_gather(spec, _pixel_ndc(shape, grid.device), src_depth)
    return eval_depth_scale(grid, idx, w)


def apply_depth_grid(grid: torch.Tensor, spec: GridSpec, depth: torch.Tensor) -> torch.Tensor:
    """A depth map (H, W) transformed by one frame's grid (gz, gy, gx)."""
    return depth * depth_param_map(grid, spec, depth.shape, depth)


def spatial_warp_map(grid: torch.Tensor, cubic: bool, shape):
    """NDC warp field (H, W, 2) of one frame's grid (gy, gx, 2)
    (reference SpatialXform::warp, .cpp:428-456)."""
    gy, gx = grid.shape[:2]
    spec = GridSpec(gx=gx, gy=gy, gz=1, cubic=cubic)
    idx, w = grid_gather(spec, _pixel_ndc(shape, grid.device))
    return eval_spatial_warp(grid, idx, w)


# ---------------------------------------------------------------------------
# Deformation (smoothness) residuals.
# ---------------------------------------------------------------------------


def _edges(grid: torch.Tensor, fn):
    """fn(a, b) over the x-, then y-, then z-edges of (..., gz, gy, gx),
    flattened to (..., E)."""
    parts = []
    if grid.shape[-1] > 1:
        parts.append(fn(grid[..., :, :, 1:], grid[..., :, :, :-1]))
    if grid.shape[-2] > 1:
        parts.append(fn(grid[..., :, 1:, :], grid[..., :, :-1, :]))
    if grid.shape[-3] > 1:
        parts.append(fn(grid[..., 1:, :, :], grid[..., :-1, :, :]))
    batch = grid.shape[:-3]
    if not parts:
        return grid.new_zeros(batch + (0,))
    return torch.cat([p.reshape(batch + (-1,)) for p in parts], dim=-1)


def depth_deform_residuals(grid: torch.Tensor) -> torch.Tensor:
    """Relative differences (a - b) / min(|a|, |b|) along all grid edges
    (reference computeGridDeformationCost, .cpp:631-667). grid:
    (..., gz, gy, gx) -> (..., E)."""

    def rel(a, b):
        return (a - b) / torch.minimum(a.abs(), b.abs()).clamp_min(1e-12)

    return _edges(grid, rel)


def shift_deform_residuals(grid: torch.Tensor) -> torch.Tensor:
    """Absolute differences along all grid edges for ScaleShift's additive
    handles (see robust_cvd_tpu/solver/xforms.py for why not relative)."""
    return _edges(grid, lambda a, b: a - b)


def spatial_deform_residuals(grid: torch.Tensor) -> torch.Tensor:
    """Spatial deformation cost = the warp handles themselves
    (reference paramsToResiduals, .cpp:59-70). grid: (..., gy, gx, 2)."""
    return grid.reshape(grid.shape[:-3] + (-1,))


def adaptive_deform_weights(
    dynamic_mask: np.ndarray, spec: GridSpec, base_weight: float,
    adaptive_weight: float, device=None,
) -> torch.Tensor:
    """Per-edge deformation-cost multipliers from dynamic masks (reference
    AdaptiveDeformationCost, lib/PoseOptimizer.cpp:559-656): each handle
    accumulates bilinear mass from dynamic (mask < 127; white is static) vs
    static pixels; handle weight = dyn / (dyn + static); an x/y edge is
    scaled by base + max(w_a, w_b) * adaptive, a z edge by
    base + w * adaptive. Edge order matches depth_deform_residuals.

    dynamic_mask: (N, h, w) uint8/bool. Returns (N, E) float32."""
    mask = np.asarray(dynamic_mask)
    if mask.dtype != bool:
        mask = mask >= 127  # True = static
    n, dh, dw = mask.shape
    gx, gy, gz = spec.gx, spec.gy, spec.gz

    ys = np.arange(dh) * (gy - 1) / dh if gy > 1 else np.zeros(dh)
    xs = np.arange(dw) * (gx - 1) / dw if gx > 1 else np.zeros(dw)
    iy = np.minimum(ys.astype(int), max(gy - 2, 0))
    ix = np.minimum(xs.astype(int), max(gx - 2, 0))
    ry = (ys - iy)[:, None]
    rx = (xs - ix)[None, :]
    IY = np.broadcast_to(iy[:, None], (dh, dw))
    IX = np.broadcast_to(ix[None, :], (dh, dw))
    corners = [
        (IY, IX, (1 - rx) * (1 - ry)),
        (IY, np.minimum(IX + 1, gx - 1), rx * (1 - ry)),
        (np.minimum(IY + 1, gy - 1), IX, (1 - rx) * ry),
        (np.minimum(IY + 1, gy - 1), np.minimum(IX + 1, gx - 1), rx * ry),
    ]

    weights = np.zeros((n, gy, gx), np.float64)
    for f in range(n):
        dyn = np.zeros((gy, gx))
        sta = np.zeros((gy, gx))
        is_static = mask[f].ravel()
        for (cy, cx, w) in corners:
            wm = np.broadcast_to(w, (dh, dw)).ravel()
            flat = cy.ravel() * gx + cx.ravel()
            np.add.at(sta.ravel(), flat[is_static], wm[is_static])
            np.add.at(dyn.ravel(), flat[~is_static], wm[~is_static])
        weights[f] = dyn / np.maximum(dyn + sta, 1e-12)

    parts = []
    w3 = np.broadcast_to(weights[:, None], (n, gz, gy, gx))
    if gx > 1:
        parts.append(base_weight + np.maximum(w3[..., 1:], w3[..., :-1]) * adaptive_weight)
    if gy > 1:
        parts.append(base_weight + np.maximum(w3[:, :, 1:], w3[:, :, :-1]) * adaptive_weight)
    if gz > 1:
        parts.append(base_weight + w3[:, 1:] * adaptive_weight)
    out = (
        np.concatenate([p.reshape(n, -1) for p in parts], axis=1)
        if parts else np.empty((n, 0))
    )
    return torch.as_tensor(out.astype(np.float32), device=device)


# ---------------------------------------------------------------------------
# Coarse-to-fine grid subdivision.
# ---------------------------------------------------------------------------


def split_grid(grid: torch.Tensor, new_spec: GridSpec) -> torch.Tensor:
    """Resample depth-grid handles onto a finer grid (bilinear), keeping the
    represented transform at the new handle locations
    (reference Processor::gridXformSplit, Processor.cpp:888-985).
    grid: (N, gz, gy, gx) -> (N, gz', gy', gx')."""
    _, gz, gy, gx = grid.shape

    def interp_axis(arr, axis, old_g, new_g):
        if old_g == new_g:
            return arr
        if new_g == 1:
            rel, idx = np.zeros(1), np.zeros(1, np.int64)
        else:
            pos = (
                np.arange(new_g) * (old_g - 1) / (new_g - 1)
                if old_g > 1 else np.zeros(new_g)
            )
            idx = np.clip(pos.astype(np.int32), 0, max(old_g - 2, 0)).astype(np.int64)
            rel = pos - idx
        i0 = torch.as_tensor(idx, device=arr.device)
        i1 = torch.as_tensor(np.minimum(idx + 1, old_g - 1), device=arr.device)
        a0 = arr.index_select(axis, i0)
        a1 = arr.index_select(axis, i1)
        shape = [1] * arr.ndim
        shape[axis] = new_g
        r = torch.as_tensor(rel, dtype=arr.dtype, device=arr.device).reshape(shape)
        return a0 * (1 - r) + a1 * r

    out = interp_axis(grid, 3, gx, new_spec.gx)
    out = interp_axis(out, 2, gy, new_spec.gy)
    return interp_axis(out, 1, gz, new_spec.gz)
