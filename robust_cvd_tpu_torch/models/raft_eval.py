"""RAFT optical-flow evaluation harness (EPE / px-accuracy / KITTI Fl-all).

Port of robust_cvd_tpu/models/raft_eval.py, the counterpart of the
reference's vendored upstream evaluation (raft/evaluate.py:80-160
validate_chairs / validate_sintel / validate_kitti): batched metrics, the
upstream InputPadder as a pad-to-multiple-of-8 inside the evaluator, and
readers of the standard Sintel / KITTI layouts, skipped where the dataset
is absent (none ships here).

Images are (B, H, W, 3) in [0, 255] and flows (B, H, W, 2), the JAX
package's layout; the RAFT module carries its own weights and iteration
count.
"""

from __future__ import annotations

import os
from os.path import join as pjoin
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def flow_metrics(
    flow_pred: torch.Tensor,
    flow_gt: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Per-image flow metrics over (B, H, W, 2) flows and an optional
    (B, H, W) 0/1 validity: epe, 1px, 3px, 5px and fl_all (KITTI outliers:
    epe > 3 px and > 5% of the GT magnitude, reference
    raft/evaluate.py:139-160) as valid means per image (B,), and n, the
    valid pixels per image. An all-invalid image counts as 0 (upstream
    would give NaN)."""
    epe = torch.sqrt(((flow_pred - flow_gt) ** 2).sum(-1))
    mag = torch.sqrt((flow_gt ** 2).sum(-1))
    valid = torch.ones_like(epe) if valid is None else valid.to(epe.dtype)
    n = torch.clamp(valid.sum((1, 2)), min=1.0)

    def vmean(x):
        return (x.to(epe.dtype) * valid).sum((1, 2)) / n

    outlier = (epe > 3.0) & (epe / torch.clamp(mag, min=1e-9) > 0.05)
    return {
        "epe": vmean(epe),
        "1px": vmean(epe < 1.0),
        "3px": vmean(epe < 3.0),
        "5px": vmean(epe < 5.0),
        "fl_all": vmean(outlier),
        "n": valid.sum((1, 2)),
    }


def pad_to_multiple(x: torch.Tensor, mult: int = 8) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Edge-pad (B, H, W, C) at the bottom and right to multiples of `mult`
    (the upstream InputPadder, raft/utils/utils.py). Returns (padded,
    (ph, pw))."""
    h, w = x.shape[1:3]
    ph, pw = (-h) % mult, (-w) % mult
    if ph == 0 and pw == 0:
        return x, (0, 0)
    padded = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate")
    return padded.permute(0, 2, 3, 1), (ph, pw)


def make_flow_fn(raft) -> Callable:
    """(im1, im2) (B, H, W, 3) in [0, 255] -> flow (B, H, W, 2), padded to
    multiples of 8 and cropped back, on the RAFT module's device."""
    device = next(raft.parameters()).device

    def fn(im1, im2):
        h, w = im1.shape[1:3]
        p1, _ = pad_to_multiple(im1.to(device))
        p2, _ = pad_to_multiple(im2.to(device))
        with torch.no_grad():
            flow = raft(p1.permute(0, 3, 1, 2), p2.permute(0, 3, 1, 2))
        return flow.permute(0, 2, 3, 1)[:, :h, :w]

    return fn


def evaluate_pairs(
    flow_fn: Callable,
    pairs: Iterable[Tuple[np.ndarray, np.ndarray, np.ndarray, Optional[np.ndarray]]],
    batch: int = 4,
) -> Dict[str, float]:
    """Evaluate a stream of (im1, im2, flow_gt, valid or None) samples
    (float [0, 255] HWC images) in batches of one resolution.

    Aggregation as upstream (reference raft/evaluate.py): epe, 1px, 3px
    and 5px are means over IMAGES of per-image valid means (validate_kitti
    averages per-image means; on Sintel every image has the same pixel
    count, so this is the pixel mean), fl_all is over all valid PIXELS."""
    img_sums: Dict[str, float] = {}
    images = 0
    fl_px_sum = 0.0
    px_count = 0.0
    buf: List = []

    def flush():
        nonlocal images, fl_px_sum, px_count
        if not buf:
            return
        im1, im2, gt = (torch.from_numpy(np.stack([b[k] for b in buf]).astype(np.float32))
                        for k in range(3))
        valid = None
        if buf[0][3] is not None:
            valid = torch.from_numpy(np.stack([b[3] for b in buf]).astype(np.float32))
        pred = flow_fn(im1, im2).cpu()
        m = {k: v.double().numpy() for k, v in flow_metrics(pred, gt, valid).items()}
        n = m.pop("n")
        fl_px_sum += float(np.sum(m.pop("fl_all") * n))
        px_count += float(np.sum(n))
        for k, v in m.items():
            img_sums[k] = img_sums.get(k, 0.0) + float(np.sum(v))
        images += len(buf)
        buf.clear()

    for sample in pairs:
        buf.append(sample)
        if len(buf) == batch:
            flush()
    flush()
    if images == 0:
        return {}
    out = {k: v / images for k, v in img_sums.items()}
    out["fl_all"] = fl_px_sum / max(px_count, 1.0)
    return out


# -- dataset readers (standard layouts; skipped when absent) -----------------


def read_flo(path: str) -> np.ndarray:
    """Middlebury .flo format: magic f32 202021.25, w:i32, h:i32, data."""
    with open(path, "rb") as f:
        magic = np.frombuffer(f.read(4), np.float32)[0]
        if abs(magic - 202021.25) > 1e-3:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2)


def decode_kitti_flow(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI 16-bit flow encoding: (u, v) = (I - 2^15) / 64, valid = ch 3."""
    img = np.asarray(img, np.float64)
    flow = (img[..., :2] - 2 ** 15) / 64.0
    valid = img[..., 2] > 0
    return flow.astype(np.float32), valid.astype(np.float32)


def read_kitti_flow_png(path: str) -> Tuple[np.ndarray, np.ndarray]:
    import imageio.v2 as imageio

    return decode_kitti_flow(imageio.imread(path))


def _load_image(path: str) -> np.ndarray:
    import imageio.v2 as imageio

    return np.asarray(imageio.imread(path), np.float32)


def sintel_samples(root: str, dstype: str = "clean"):
    """MPI-Sintel training split: root/training/{clean,final}/<scene>/
    frame_%04d.png + root/training/flow/<scene>/frame_%04d.flo."""
    img_root = pjoin(root, "training", dstype)
    flow_root = pjoin(root, "training", "flow")
    for scene in sorted(os.listdir(img_root)):
        frames = sorted(os.listdir(pjoin(img_root, scene)))
        for a, b in zip(frames[:-1], frames[1:]):
            flo = pjoin(flow_root, scene, os.path.splitext(a)[0] + ".flo")
            if not os.path.exists(flo):
                continue
            yield (
                _load_image(pjoin(img_root, scene, a)),
                _load_image(pjoin(img_root, scene, b)),
                read_flo(flo),
                None,
            )


def kitti_samples(root: str):
    """KITTI-2015 training split: root/training/image_2/%06d_1{0,1}.png +
    root/training/flow_occ/%06d_10.png."""
    img_root = pjoin(root, "training", "image_2")
    flow_root = pjoin(root, "training", "flow_occ")
    for name in sorted(os.listdir(flow_root)):
        base = name[:-7]  # strip "_10.png"
        flow, valid = read_kitti_flow_png(pjoin(flow_root, name))
        yield (
            _load_image(pjoin(img_root, f"{base}_10.png")),
            _load_image(pjoin(img_root, f"{base}_11.png")),
            flow,
            valid,
        )


def validate(raft, dataset_root: str, dataset: str = "sintel", batch: int = 2) -> Dict[str, float]:
    """An upstream-style validation where the dataset directory exists
    (reference raft/evaluate.py validate_*); {} where it does not."""
    if not os.path.isdir(dataset_root):
        return {}
    flow_fn = make_flow_fn(raft)
    if dataset == "sintel":
        results = {}
        for dstype in ("clean", "final"):
            m = evaluate_pairs(flow_fn, sintel_samples(dataset_root, dstype), batch)
            if m:
                results[dstype] = m
                print(
                    f"Validation ({dstype}) EPE: {m['epe']:.4f}, "
                    f"1px: {m['1px']:.4f}, 3px: {m['3px']:.4f}, 5px: {m['5px']:.4f}"
                )
        return results
    if dataset == "kitti":
        m = evaluate_pairs(flow_fn, kitti_samples(dataset_root), batch)
        if m:
            print(f"Validation KITTI: EPE {m['epe']:.4f}, Fl-all {m['fl_all']:.4f}")
        return m
    raise ValueError(f"unknown dataset {dataset!r}")
