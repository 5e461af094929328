"""Dynamic-object mask generation.

Port of robust_cvd_tpu/pipeline/masks.py. The reference runs Detectron2
Mask R-CNN (dynamic_mask_generation.py: person/vehicle/animal classes,
conf 0.5, dilate 5 px, INVERTED so white = static). Without segmentation
weights the generator is geometric motion segmentation, host numpy as in
the JAX package: pixels whose optical flow violates the dominant rigid
motion (a RANSAC homography or fundamental matrix per consecutive pair)
are dynamic.

Output contract of the reference: `dynamic_mask/frame_%06d.png`, uint8,
WHITE (255) = static, dynamic regions dilated by `dilate` px.

Not ported: the Mask R-CNN generator (`compute_dynamic_masks_rcnn` raises
NotImplementedError; Mask R-CNN comes with a later slice).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from os.path import join as pjoin
from typing import Optional

import numpy as np

from ..io.store import VideoStore, frame_name, save_png_gray
from ..ops.epipolar import find_fundamental_ransac, sampson_distance
from ..ops.homography import _apply_h_np, find_homography_ransac


def motion_segmentation_mask(
    flow: np.ndarray,
    sample_stride: int = 4,
    epipolar_thresh: float = 2.0,
    dynamic_thresh: float = 4.0,
) -> Optional[np.ndarray]:
    """Dynamic mask (bool, True = DYNAMIC) from one dense flow field.

    A homography H and a fundamental matrix F are fit to subsampled
    correspondences (the rigid background dominates). Low-parallax scenes
    are degenerate for F (a 7-dof F can explain almost any motion,
    independently moving objects included), so H wins unless F has
    decisively more inliers. Pixels far from the winning model are dynamic;
    None when neither model can be fit."""
    h, w = flow.shape[:2]
    ys, xs = np.mgrid[0:h:sample_stride, 0:w:sample_stride]
    p0 = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float64)
    p1 = p0 + flow[ys.ravel(), xs.ravel()].astype(np.float64)

    gy, gx = np.mgrid[0:h, 0:w]
    q0 = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float64)
    q1 = q0 + flow.reshape(-1, 2).astype(np.float64)

    H = find_homography_ransac(p0, p1, thresh=epipolar_thresh)
    F = find_fundamental_ransac(p0, p1, thresh=epipolar_thresh)

    def inliers_h():
        d = np.linalg.norm(_apply_h_np(H[None], p0[None])[0] - p1, axis=-1)
        return (d < epipolar_thresh).sum()

    def inliers_f():
        d = sampson_distance(F[None], p0[None], p1[None])[0]
        return (d < epipolar_thresh).sum()

    use_h = H is not None and (F is None or inliers_h() >= 0.9 * inliers_f())
    if use_h:
        d = np.linalg.norm(_apply_h_np(H[None], q0[None])[0] - q1, axis=-1)
    elif F is not None:
        d = sampson_distance(F[None], q0[None], q1[None])[0]
    else:
        return None
    return d.reshape(h, w) > dynamic_thresh


def _dilate(mask: np.ndarray, radius: int) -> np.ndarray:
    from scipy import ndimage

    if radius <= 0:
        return mask
    yy, xx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    disk = (xx * xx + yy * yy) <= radius * radius
    return ndimage.binary_dilation(mask, structure=disk)


def compute_dynamic_masks(
    store: VideoStore,
    dilate: int = 5,
    epipolar_thresh: float = 2.0,
    dynamic_thresh: float = 4.0,
) -> bool:
    """`dynamic_mask/` for the whole clip from consecutive flows.

    Skips existing frames, like every stage. A frame's mask is the union of
    its forward and backward consecutive flows' masks, where they exist.
    Frames are segmented in a thread pool (numpy's SVD and einsum release
    the interpreter lock; each frame's result is the same as in a loop).
    Returns whether any mask exists afterwards."""
    out_dir = pjoin(store.base_dir, "dynamic_mask")
    n = store.num_frames
    os.makedirs(out_dir, exist_ok=True)
    missing = [i for i in range(n) if not os.path.exists(pjoin(out_dir, frame_name(i, ".png")))]
    if not missing:
        return n > 0
    flows = {}
    for i in missing:
        flows[i] = []
        for j in (i + 1, i - 1):
            if 0 <= j < n:
                try:
                    flows[i].append(store.load_flow(i, j))
                except FileNotFoundError:
                    continue
    hw = store.load_color_down().shape[1:3]

    def frame_mask(i):
        dyn = None
        for flow in flows[i]:
            m = motion_segmentation_mask(
                flow, epipolar_thresh=epipolar_thresh, dynamic_thresh=dynamic_thresh
            )
            if m is not None:
                dyn = m if dyn is None else (dyn | m)
        if dyn is None:
            dyn = np.zeros(hw, bool)
        return _dilate(dyn, dilate)

    with ThreadPoolExecutor(min(len(missing), os.cpu_count() or 1)) as pool:
        for i, dyn in zip(missing, pool.map(frame_mask, missing)):
            # invert: white = static (reference dynamic_mask_generation.py:156-182)
            save_png_gray(pjoin(out_dir, frame_name(i, ".png")), (~dyn).astype(np.uint8) * 255)
    return True


def compute_dynamic_masks_rcnn(store: VideoStore, weights_path: str, **kwargs) -> bool:
    raise NotImplementedError(
        "Mask R-CNN dynamic masks (--mask_rcnn_weights) are not ported yet "
        "(Mask R-CNN slice)"
    )
