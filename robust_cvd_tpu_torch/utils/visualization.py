"""Visualization utilities: depth colormaps, flow color wheel, warp checks.

Port of robust_cvd_tpu/utils/visualization.py (reference
utils/visualization.py depth colormap and scene-flow visualization,
utils/flowlib.py Middlebury flow color wheel). The JAX package colours
depth with matplotlib's "magma" map; the port keeps that map's 256 entries
as a table (_MAGMA), so it needs no matplotlib (the GPU machine has none)
and writes the same PNGs; another map name still goes through matplotlib.
Host numpy, as in the JAX package; `warp_by_flow` samples with the port's
`ops/geometry.py`.
"""

from __future__ import annotations

import os
from os.path import join as pjoin

import numpy as np


# matplotlib's "magma" colormap (CC0; Nathaniel J. Smith, Stefan van der
# Walt), 256 RGB entries, each rounded to 8 bits as int(value * 255 + 0.5)
_MAGMA = np.frombuffer(bytes.fromhex(
    "00000401000501010601010802010902020b02020d03030f030312040414050416060518"
    "06051a07061c08071e0907200a08220b09240c09260d0a290e0b2b100b2d110c2f120d31"
    "130d34140e36150e38160f3b180f3d19103f1a10421c10441d11471e114920114b21114e"
    "22115024125325125527125829115a2a115c2c115f2d11612f1163311165331067341069"
    "36106b38106c390f6e3b0f703d0f713f0f72400f74420f75440f76451077471078491078"
    "4a10794c117a4e117b4f127b51127c52137c54137d56147d57157e59157e5a167e5c167f"
    "5d177f5f187f601880621980641a80651a80671b80681c816a1c816b1d816d1d816e1e81"
    "701f81721f817320817521817621817822817922827b23827c23827e2482802582812581"
    "8326818426818627818827818928818b29818c29818e2a81902a81912b81932b80942c80"
    "962c80982d80992d809b2e7f9c2e7f9e2f7fa02f7fa1307ea3307ea5317ea6317da8327d"
    "aa337dab337cad347cae347bb0357bb2357bb3367ab5367ab73779b83779ba3878bc3978"
    "bd3977bf3a77c03a76c23b75c43c75c53c74c73d73c83e73ca3e72cc3f71cd4071cf4070"
    "d0416fd2426fd3436ed5446dd6456cd8456cd9466bdb476adc4869de4968df4a68e04c67"
    "e24d66e34e65e44f64e55064e75263e85362e95462ea5661eb5760ec5860ed5a5fee5b5e"
    "ef5d5ef05f5ef1605df2625df2645cf3655cf4675cf4695cf56b5cf66c5cf66e5cf7705c"
    "f7725cf8745cf8765cf9785df9795df97b5dfa7d5efa7f5efa815ffb835ffb8560fb8761"
    "fc8961fc8a62fc8c63fc8e64fc9065fd9266fd9467fd9668fd9869fd9a6afd9b6bfe9d6c"
    "fe9f6dfea16efea36ffea571fea772fea973feaa74feac76feae77feb078feb27afeb47b"
    "feb67cfeb77efeb97ffebb81febd82febf84fec185fec287fec488fec68afec88cfeca8d"
    "fecc8ffecd90fecf92fed194fed395fed597fed799fed89afdda9cfddc9efddea0fde0a1"
    "fde2a3fde3a5fde5a7fde7a9fde9aafdebacfcecaefceeb0fcf0b2fcf2b4fcf4b6fcf6b8"
    "fcf7b9fcf9bbfcfbbdfcfdbf"
), np.uint8).reshape(256, 3)


def _colormap_u8(t: np.ndarray, cmap: str) -> np.ndarray:
    """t in [0, 1] -> (..., 3) uint8 through a 256-entry map, indexed as
    matplotlib's Colormap indexes float32 input: int(t * 256), 1 -> 255."""
    if cmap != "magma":
        import matplotlib

        return (matplotlib.colormaps[cmap](t)[..., :3] * 255 + 0.5).astype(np.uint8)
    x = np.asarray(t, np.float32) * np.float32(256)
    bad = np.isnan(x)
    idx = np.clip(np.where(bad, 0, x), 0, 255).astype(np.int64)
    out = _MAGMA[idx]
    out[bad] = 0
    return out


def visualize_depth(depth: np.ndarray, depth_min=None, depth_max=None,
                    cmap: str = "magma") -> np.ndarray:
    """Depth map -> (H, W, 3) uint8 via inverse-depth colormap
    (reference utils/visualization.py visualize_depth)."""
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
    out = _colormap_u8(t, cmap)
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
