"""Visualization utilities: depth colormaps, flow color wheel, warp checks.

Port of robust_cvd_tpu/utils/visualization.py (reference
utils/visualization.py depth colormap and scene-flow visualization,
utils/flowlib.py Middlebury flow color wheel; matplotlib's built-in maps
stand in for utils/colormaps.py's tables). Host numpy, as in the JAX
package; `warp_by_flow` samples with the port's `ops/geometry.py`.
"""

from __future__ import annotations

import os
from os.path import join as pjoin

import numpy as np


def visualize_depth(depth: np.ndarray, depth_min=None, depth_max=None,
                    cmap: str = "magma") -> np.ndarray:
    """Depth map -> (H, W, 3) uint8 via inverse-depth colormap
    (reference utils/visualization.py visualize_depth)."""
    import matplotlib

    depth = np.asarray(depth, np.float32)
    valid = np.isfinite(depth) & (depth > 0)
    inv = np.zeros_like(depth)
    inv[valid] = 1.0 / depth[valid]
    if depth_min is None:
        depth_min = np.percentile(depth[valid], 5) if valid.any() else 1.0
    if depth_max is None:
        depth_max = np.percentile(depth[valid], 95) if valid.any() else 10.0
    lo, hi = 1.0 / max(depth_max, 1e-6), 1.0 / max(depth_min, 1e-6)
    t = np.clip((inv - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    rgba = matplotlib.colormaps[cmap](t)
    out = (rgba[..., :3] * 255 + 0.5).astype(np.uint8)
    out[~valid] = 0
    return out


def visualize_depth_dir(src_dir: str, dst_dir: str) -> None:
    """Colormap every .raw disparity image in a depth dir
    (reference depth_fine_tuning.py:283-288)."""
    from ..io import raw

    os.makedirs(dst_dir, exist_ok=True)
    from ..io.store import save_png_color

    for name in sorted(os.listdir(src_dir)):
        if not name.endswith(".raw"):
            continue
        disp = raw.load_raw_float32_image(pjoin(src_dir, name))
        depth = raw.disparity_to_depth(disp)
        img = visualize_depth(depth)
        save_png_color(pjoin(dst_dir, name.replace(".raw", ".png")), img)


# -- Middlebury flow color wheel (reference utils/flowlib.py) -----------------


def _make_color_wheel() -> np.ndarray:
    """Standard Middlebury 55-color wheel."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[0:RY, 0] = 255
    wheel[0:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col : col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col : col + YG, 1] = 255
    col += YG
    wheel[col : col + GC, 1] = 255
    wheel[col : col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col : col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col : col + CB, 2] = 255
    col += CB
    wheel[col : col + BM, 2] = 255
    wheel[col : col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col : col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col : col + MR, 0] = 255
    return wheel


_WHEEL = _make_color_wheel()


def flow_to_image(flow: np.ndarray, max_flow=None) -> np.ndarray:
    """Flow (H, W, 2) -> Middlebury color coding (H, W, 3) uint8."""
    u = np.asarray(flow[..., 0], np.float64)
    v = np.asarray(flow[..., 1], np.float64)
    rad = np.sqrt(u * u + v * v)
    maxrad = max_flow if max_flow is not None else max(rad.max(), 1e-6)
    u, v = u / maxrad, v / maxrad
    rad = np.sqrt(u * u + v * v)

    ncols = _WHEEL.shape[0]
    a = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (a + 1.0) / 2.0 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = fk - k0

    img = np.zeros(u.shape + (3,), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] *= 0.75
        img[..., c] = np.floor(255.0 * col)
    return img


def visualize_scene_flow(scene_flow: np.ndarray) -> np.ndarray:
    """(H, W, 3) 3D scene-flow field -> uint8 RGB: normalized to [-1, 1] by
    the max-abs component, then mapped to [0, 255] with zero at mid-gray
    (reference utils/visualization.py:15-50)."""
    sf = np.asarray(scene_flow, np.float32)
    mag = np.max(np.abs(sf)) + 1e-6
    return np.uint8((sf / mag + 1.0) / 2.0 * 255.0)


def apply_mask(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Dim masked-out pixels (reference utils/visualization.py apply_mask)."""
    m = (np.asarray(mask) > 0).astype(np.float32)
    if image.dtype == np.uint8:
        return (image * (0.3 + 0.7 * m[..., None])).astype(np.uint8)
    return image * (0.3 + 0.7 * m[..., None])


def warp_by_flow(color: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Backward-warp `color` (H, W, C) by `flow` (H, W, 2) (reference
    flow.py:21-31), on the CPU."""
    import torch

    from ..ops.geometry import grid_sample, pixel_grid

    H, W = flow.shape[:2]
    pix = pixel_grid((H, W)) + torch.as_tensor(np.asarray(flow, np.float32))
    return grid_sample(torch.as_tensor(np.asarray(color, np.float32)), pix).numpy()
