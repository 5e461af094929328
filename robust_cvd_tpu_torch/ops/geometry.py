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
function and are not ported.

The non-perspective projections (equirectangular and cylindrical crops,
dispatched on video.dat's projection code) follow the JAX package: depth
is the radial distance along the viewing ray there, the planar -z for
perspective.
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


# ---------------------------------------------------------------------------
# Non-perspective projections (robust_cvd_tpu/ops/geometry.py:350-463).
#
# The reference's DepthPhoto names Equirectangular and Cylindrical in its
# Intrinsics enum and documents the lat-lon crop (lib/DepthPhoto.h:62-92:
# angular extents from vFov/hFov, centred at centerLat/centerLon). Camera
# looks down -z, +y up, +x right; longitude is positive toward +x, latitude
# toward +y; lon = lat = 0 is the forward axis. Angles may be Python floats
# or tensors.
# ---------------------------------------------------------------------------


def _angle(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _latlon_to_dir(lon: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    """(lon, lat) angles -> unit direction; (0, 0) -> (0, 0, -1)."""
    cl = torch.cos(lat)
    return torch.stack([cl * torch.sin(lon), torch.sin(lat), -cl * torch.cos(lon)], dim=-1)


def pixels_to_points_equirect(
    pixels: torch.Tensor, dist: torch.Tensor, shape, vfov, hfov,
    center_lat=0.0, center_lon=0.0,
) -> torch.Tensor:
    """Equirectangular crop: pixel x and y linear in lon and lat across hFov
    and vFov, centred at (centerLon, centerLat); `dist` is radial."""
    h, w = shape
    lon = _angle(center_lon, pixels) + (pixels[..., 0] - (w - 1) / 2.0) * (_angle(hfov, pixels) / w)
    lat = _angle(center_lat, pixels) - (pixels[..., 1] - (h - 1) / 2.0) * (_angle(vfov, pixels) / h)
    return _latlon_to_dir(lon, lat) * dist[..., None]


def project_equirect(points: torch.Tensor, shape, vfov, hfov,
                     center_lat=0.0, center_lon=0.0) -> torch.Tensor:
    """Camera-space points -> equirectangular pixel (x, y); the inverse of
    `pixels_to_points_equirect` up to the radial distance."""
    h, w = shape
    lon = torch.atan2(points[..., 0], -points[..., 2])
    lat = torch.atan2(points[..., 1], torch.hypot(points[..., 0], points[..., 2]))
    x = (lon - _angle(center_lon, points)) * (w / _angle(hfov, points)) + (w - 1) / 2.0
    y = (_angle(center_lat, points) - lat) * (h / _angle(vfov, points)) + (h - 1) / 2.0
    return torch.stack([x, y], dim=-1)


def pixels_to_points_cylindrical(
    pixels: torch.Tensor, dist: torch.Tensor, shape, vfov, hfov,
    center_lat=0.0, center_lon=0.0,
) -> torch.Tensor:
    """Cylindrical crop: x linear in lon; y linear in height on the unit
    cylinder (spanning 2 tan(vFov/2), offset tan(centerLat)); `dist` is
    radial along the normalized viewing ray."""
    h, w = shape
    lon = _angle(center_lon, pixels) + (pixels[..., 0] - (w - 1) / 2.0) * (_angle(hfov, pixels) / w)
    height = torch.tan(_angle(center_lat, pixels)) - (pixels[..., 1] - (h - 1) / 2.0) * (
        2.0 * torch.tan(_angle(vfov, pixels) / 2.0) / h
    )
    d = torch.stack([torch.sin(lon), height, -torch.cos(lon)], dim=-1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return d * dist[..., None]


def project_cylindrical(points: torch.Tensor, shape, vfov, hfov,
                        center_lat=0.0, center_lon=0.0) -> torch.Tensor:
    """Camera-space points -> cylindrical pixel (x, y)."""
    h, w = shape
    lon = torch.atan2(points[..., 0], -points[..., 2])
    height = points[..., 1] / torch.hypot(points[..., 0], points[..., 2])
    x = (lon - _angle(center_lon, points)) * (w / _angle(hfov, points)) + (w - 1) / 2.0
    y = (torch.tan(_angle(center_lat, points)) - height) * (
        h / (2.0 * torch.tan(_angle(vfov, points) / 2.0))
    ) + (h - 1) / 2.0
    return torch.stack([x, y], dim=-1)


# io.video_dat.FrameIntrinsics.projection codes (reference
# lib/DepthPhoto.h:68-73 enum order)
PROJECTION_PERSPECTIVE = 0
PROJECTION_EQUIRECTANGULAR = 1
PROJECTION_CYLINDRICAL = 2


def pixels_to_points_proj(projection: int, pixels, depth, shape, vfov, hfov,
                          center_lat=0.0, center_lon=0.0) -> torch.Tensor:
    """Unprojection by projection code; depth is planar -z for perspective
    and radial otherwise."""
    if projection == PROJECTION_EQUIRECTANGULAR:
        return pixels_to_points_equirect(pixels, depth, shape, vfov, hfov, center_lat, center_lon)
    if projection == PROJECTION_CYLINDRICAL:
        return pixels_to_points_cylindrical(pixels, depth, shape, vfov, hfov, center_lat, center_lon)
    intr = intrinsics_px(_angle(vfov, pixels), _angle(hfov, pixels), shape)
    return pixels_to_points(intr, depth, pixels)


def project_proj(projection: int, points, shape, vfov, hfov,
                 center_lat=0.0, center_lon=0.0) -> torch.Tensor:
    """Camera-space points -> pixels by projection code."""
    if projection == PROJECTION_EQUIRECTANGULAR:
        return project_equirect(points, shape, vfov, hfov, center_lat, center_lon)
    if projection == PROJECTION_CYLINDRICAL:
        return project_cylindrical(points, shape, vfov, hfov, center_lat, center_lon)
    return project(points, intrinsics_px(_angle(vfov, points), _angle(hfov, points), shape))
