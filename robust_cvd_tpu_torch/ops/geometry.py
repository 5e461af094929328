"""Differentiable projection geometry (PyTorch).

Port of robust_cvd_tpu/ops/geometry.py (reference utils/geometry.py):
pixel (x, y) with a top-left origin; the camera looks down -Z; the v axis
is flipped between pixels and camera space; intrinsics are (fx, fy, cx, cy)
in pixels. Channels-last (..., H, W, C) like the JAX package, and every
function broadcasts over leading batch dims.

The rotations are written as broadcast multiply-adds, so they run in full
float32 on every device (the JAX package's einsums run at
Precision.HIGHEST); no matrix product, and so no TF32, is involved.

`grid_sample` is the one bilinear sampler of the loss stack. Its
data-gradient is autograd of the gather (a 4-tap scatter-add). The JAX
package's segsum/matmul/mxu variants are TPU lowerings of the same
function and are not ported; neither are the non-perspective projections
(ROADMAP.md).
"""

from __future__ import annotations

import torch


def pixel_grid(shape, device=None) -> torch.Tensor:
    """(H, W, 2) grid of pixel centres (x, y), x in [0, W-1], y in [0, H-1]."""
    h, w = shape
    y, x = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([x, y], dim=-1)


def pixels_to_rays(pixels: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) + intrinsics (..., 4) -> rays (..., 3) with z = -1:
    u = (x - cx) / fx, v = -(y - cy) / fy."""
    uv = (pixels - intrinsics[..., 2:4]) / intrinsics[..., 0:2]
    u = uv[..., 0]
    return torch.stack([u, -uv[..., 1], -torch.ones_like(u)], dim=-1)


def project(points: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Camera-space points (..., 3) -> pixels (..., 2)."""
    rays = points[..., :2] / -points[..., 2:3]
    uv = rays * intrinsics[..., 0:2]
    c = intrinsics[..., 2:4]
    return torch.stack([uv[..., 0] + c[..., 0], -uv[..., 1] + c[..., 1]], dim=-1)


def pixels_to_points(
    intrinsics: torch.Tensor, depths: torch.Tensor, pixels: torch.Tensor
) -> torch.Tensor:
    """Pixels (..., 2) + depth (...) -> camera-space points (..., 3)."""
    return pixels_to_rays(pixels, intrinsics) * depths[..., None]


def points_cam_to_world(points: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    """Camera points (..., 3), extrinsics (..., 3, 4) [R|t] -> world: R p + t."""
    rot = extrinsics[..., :3]
    return (rot * points[..., None, :]).sum(-1) + extrinsics[..., 3]


def world_to_points_cam(points: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    """World points (..., 3), extrinsics (..., 3, 4) [R|t] -> camera: R^T (p - t)."""
    rot = extrinsics[..., :3]
    return (rot * (points - extrinsics[..., 3])[..., :, None]).sum(-2)


def reproject_points(
    points_cam_ref: torch.Tensor,
    extrinsics_ref: torch.Tensor,
    extrinsics_tgt: torch.Tensor,
) -> torch.Tensor:
    """Reference-camera points -> target-camera points (both (..., 3, 4))."""
    world = points_cam_to_world(points_cam_ref, extrinsics_ref)
    return world_to_points_cam(world, extrinsics_tgt)


def depth_to_points(depths: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Depth maps (..., H, W) + intrinsics (..., 4) -> points (..., H, W, 3)."""
    pixels = pixel_grid(depths.shape[-2:], depths.device)
    return pixels_to_points(intrinsics[..., None, None, :], depths, pixels)


def grid_sample(data: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample `data` (L..., H, W, C) at pixel coordinates
    `uv` (L..., S..., 2) -> (L..., S..., C), where L... are batch dims shared
    by both (none for a single map).

    Border padding: coordinates are clamped to [0, W-1] x [0, H-1] and the
    top-left tap to [0, W-2] x [0, H-2] (H, W >= 2), exactly the tap
    placement of robust_cvd_tpu/ops/geometry.py::grid_sample."""
    h, w, c = data.shape[-3:]
    lead = data.shape[:-3]
    nb = lead.numel()
    if uv.shape[: len(lead)] != lead:
        raise ValueError(f"uv {tuple(uv.shape)} does not share data's batch dims {tuple(lead)}")
    out_shape = uv.shape[:-1]
    uv = uv.reshape(nb, -1, 2)
    x = uv[..., 0].clamp(0.0, w - 1.0)
    y = uv[..., 1].clamp(0.0, h - 1.0)
    x0 = x.floor().clamp(0, w - 2)
    y0 = y.floor().clamp(0, h - 2)
    rx = (x - x0)[..., None]
    ry = (y - y0)[..., None]
    flat = data.reshape(nb, h * w, c)
    b = torch.arange(nb, device=data.device)[:, None]
    i00 = (y0 * w + x0).long()

    def tap(offset):
        return flat[b, i00 + offset]

    top = tap(0) * (1 - rx) + tap(1) * rx
    bot = tap(w) * (1 - rx) + tap(w + 1) * rx
    return (top * (1 - ry) + bot * ry).reshape(*out_shape, c)


def warping_field(
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    depths: torch.Tensor,
    extrinsics_tgt: torch.Tensor,
    intrinsics_tgt: torch.Tensor,
) -> torch.Tensor:
    """Pixel coordinates (..., H, W, 2) in the target frame of every
    reference pixel; depths (..., H, W), extrinsics (..., 3, 4),
    intrinsics (..., 4)."""
    points_cam = depth_to_points(depths, intrinsics)
    points_tgt = reproject_points(
        points_cam,
        extrinsics[..., None, None, :, :],
        extrinsics_tgt[..., None, None, :, :],
    )
    return project(points_tgt, intrinsics_tgt[..., None, None, :])


def intrinsics_px(vfov: torch.Tensor, hfov: torch.Tensor, shape) -> torch.Tensor:
    """Field-of-view angles -> pixel (fx, fy, cx, cy), principal point at
    the centre."""
    h, w = shape
    fx = w / 2.0 / torch.tan(hfov / 2.0)
    fy = h / 2.0 / torch.tan(vfov / 2.0)
    cx = torch.full_like(fx, (w - 1) / 2.0)
    cy = torch.full_like(fy, (h - 1) / 2.0)
    return torch.stack([fx, fy, cx, cy], dim=-1)
