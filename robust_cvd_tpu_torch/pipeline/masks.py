"""Dynamic-object mask generation.

Port of robust_cvd_tpu/pipeline/masks.py. The reference runs Detectron2
Mask R-CNN (dynamic_mask_generation.py: person/vehicle/animal classes,
conf 0.5, dilate 5 px, INVERTED so white = static). Without segmentation
weights the generator is geometric motion segmentation, host numpy as in
the JAX package: pixels whose optical flow violates the dominant rigid
motion (a RANSAC homography or fundamental matrix per consecutive pair)
are dynamic.

With a detectron2 `mask_rcnn_R_50_FPN_3x` checkpoint the generator is the
reference's: `compute_dynamic_masks_rcnn` runs models/mask_rcnn.py at
detectron2's test size (bfloat16 on the card) and unites the masks of the
dynamic COCO classes.

Output contract of the reference: `dynamic_mask/frame_%06d.png`, uint8,
WHITE (255) = static, dynamic regions dilated by `dilate` px.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from os.path import join as pjoin
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..io.store import VideoStore, frame_name, save_png_gray
from ..ops.epipolar import find_fundamental_ransac, sampson_distance
from ..ops.homography import _apply_h_np, find_homography_ransac
from ..parallel import mesh as pmesh

# Frames a Mask R-CNN forward pass takes. The JAX package runs 2 (FB); on
# an H100 at 800x1344 in bf16, 4 took 23.8 ms a frame in steady state
# against 29.6 ms at 2 and 22.2 ms at 8 (PERF.md, slice 8).
RCNN_FRAMES_PER_PASS = 4


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


def rcnn_test_size(hw, test_size: int = 800, max_size: int = 1333):
    """detectron2's ResizeShortestEdge(test_size, max_size) of a frame
    (h, w): the resized (th, tw) and its size padded to a multiple of 32."""
    hf, wf = hw
    scale = test_size / min(hf, wf)
    if scale * max(hf, wf) > max_size:
        scale = max_size / max(hf, wf)
    th, tw = int(round(hf * scale)), int(round(wf * scale))
    return (th, tw), (-(-th // 32) * 32, -(-tw // 32) * 32)


def rcnn_input(images, test_size: int = 800, max_size: int = 1333):
    """The network input of frames (B, H, W, 3) in [0, 1] (a float32
    tensor): (B, 3, ph, pw) resized to the test size and zero-padded to
    32, with the resized size (th, tw)."""
    from ..models.layers import resize_bilinear

    (th, tw), (ph, pw) = rcnn_test_size(images.shape[1:3], test_size, max_size)
    x = images.permute(0, 3, 1, 2)
    padded = torch.zeros((x.shape[0], 3, ph, pw), dtype=torch.float32, device=x.device)
    padded[:, :, :th, :tw] = resize_bilinear(x, (th, tw), align_corners=False)
    return padded, (th, tw)


def rcnn_frames(net, images, out_hw, test_size: int = 800, max_size: int = 1333,
                score_thresh: float = 0.5):
    """Dynamic masks (B, h, w) bool, True = DYNAMIC, of frames (B, H, W, 3)
    in [0, 1] (a float32 tensor on the net's device): the forward pass on
    rcnn_input, the masks pasted at the padded size and cropped, then
    downsampled to `out_hw` (antialiased, as jax.image.resize shrinks) and
    thresholded at 0.25."""
    from ..models.layers import resize_bilinear
    from ..models.mask_rcnn import dynamic_mask_from_detections

    x, (th, tw) = rcnn_input(images, test_size, max_size)
    det = net(x)
    m = dynamic_mask_from_detections(det, tuple(x.shape[-2:]), score_thresh)[:, :th, :tw]
    small = resize_bilinear(m.float()[:, None], out_hw, align_corners=False)[:, 0]
    return small > 0.25


def compute_dynamic_masks_rcnn(
    store: VideoStore, weights_path: str, dilate: int = 5,
    score_thresh: float = 0.5, test_size: int = 800, max_size: int = 1333,
    stats: dict | None = None, device="cuda",
) -> bool:
    """Semantic dynamic masks with Mask R-CNN (reference
    dynamic_mask_generation.py:107-239: the person/vehicle/animal union,
    dilated, inverted so that white = static) from a detectron2
    `mask_rcnn_R_50_FPN_3x` checkpoint pickle.

    Frames come from color_full (color_down where there is none) at the
    reference's test size (ResizeShortestEdge(test_size, max_size), padded
    to 32); the masks are downsampled to color_down's size, the result
    tree's. RCNN_FRAMES_PER_PASS frames a forward pass (the JAX package's
    single-device branch runs 2). On a data mesh (parallel/mesh.py), where
    at least as many frames are missing as there are ranks (the JAX
    package's rule), each rank takes its contiguous share of them and
    writes its own PNGs; otherwise every rank but 0 leaves it to rank 0.
    The net computes in bfloat16 on the card, as the JAX package runs, and
    in float32 on the CPU. Skips frames already on disk. `stats` gets load_convert_s,
    weights_h2d_s, first_dispatch_s (the first pass) and steady_infer_s
    (the rest). A bad checkpoint raises."""
    from ..models.mask_rcnn import MaskRCNN, load_checkpoint, load_weights_

    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    if stats is None:
        stats = {}
    t0 = time.perf_counter()
    net = load_weights_(MaskRCNN(dtype=dtype).eval(), load_checkpoint(weights_path))
    stats["load_convert_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    net.to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats["weights_h2d_s"] = time.perf_counter() - t0

    down = store.load_color_down()  # (N, h, w, 3) in [0, 1]
    n, h, w = down.shape[:3]
    try:
        images = store.load_color_full()  # the reference's input resolution
    except (FileNotFoundError, ValueError):
        images = down

    out_dir = pjoin(store.base_dir, "dynamic_mask")
    os.makedirs(out_dir, exist_ok=True)
    missing = [i for i in range(n) if not os.path.exists(pjoin(out_dir, frame_name(i, ".png")))]
    mesh = pmesh.pipeline_mesh()
    pmesh.barrier(mesh)  # every rank has looked before any writes
    if mesh is not None:
        if len(missing) >= mesh.size:
            missing = mesh.share(missing)
        elif mesh.rank > 0:
            missing = []
    for s in range(0, len(missing), RCNN_FRAMES_PER_PASS):
        t0 = time.perf_counter()
        chunk = missing[s : s + RCNN_FRAMES_PER_PASS]
        with torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(images[chunk], np.float32)).to(device)
            dyns = rcnn_frames(net, x, (h, w), test_size, max_size, score_thresh).cpu().numpy()
        for k, i in enumerate(chunk):
            dyn = _dilate(dyns[k], dilate)
            save_png_gray(pjoin(out_dir, frame_name(i, ".png")), (~dyn).astype(np.uint8) * 255)
        key = "first_dispatch_s" if s == 0 else "steady_infer_s"
        stats[key] = stats.get(key, 0.0) + time.perf_counter() - t0
    pmesh.barrier(mesh)
    return n > 0
