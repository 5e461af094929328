"""Flow-constraint construction: dense flow -> sparse solver constraints.

Port of robust_cvd_tpu/solver/constraints.py (behavioural parity with
reference lib/FlowConstraints.cpp). The corner response runs on the device
(ops/corner.py, the Hopper kernel on a CUDA tensor); the sequential greedy
disk-suppression sampling runs on the host in C++ (native/).

Data flow per pair (i, j) (reference .cpp:401-465):
  1. corner strength = min eigenvalue of the 3x3-blocked structure tensor of
     the grayscale frame (cv::cornerMinEigenVal with Sobel-3 derivatives).
  2. candidates = pixels passing the flow consistency mask whose flow target
     lands in-bounds.
  3. sort by corner strength, greedily keep subject to a
     `match_separation`-px disk separation.
  4. store locations normalized to [0,1] x [0,inv_aspect].

Triplets (i-1, i, i+1) chain backward + forward flow from the center frame
(reference .cpp:467-550). The static flag is recomputed from dynamic-mask
distance transforms (reference .cpp:573-660).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .. import native
from ..ops.corner import corner_min_eigenval  # noqa: F401  (re-exported)
from .residuals import ConstraintData, TripletData


class PairConstraints(NamedTuple):
    """Per-pair sparse correspondences in normalized [0,1]x[0,inv_aspect]."""

    loc0: np.ndarray  # (C, 2)
    loc1: np.ndarray  # (C, 2)
    is_static: np.ndarray  # (C,) bool


class TripletConstraints(NamedTuple):
    loc: np.ndarray  # (C, 3, 2)
    is_static: np.ndarray  # (C,) bool


def rgb_to_gray(color: np.ndarray) -> np.ndarray:
    """(..., 3) RGB in [0,1] -> grayscale, ITU-R BT.601 (OpenCV weights)."""
    return (
        0.299 * color[..., 0] + 0.587 * color[..., 1] + 0.114 * color[..., 2]
    ).astype(np.float32)


def build_pair_constraints(
    corner: np.ndarray, flow: np.ndarray, mask: np.ndarray,
    inv_aspect: float, match_separation: int = 10,
) -> PairConstraints:
    """One pair's constraints (reference lib/FlowConstraints.cpp:401-465).
    corner: (H, W) corner strength of frame i; flow: (H, W, 2) i->j flow in
    pixels; mask: (H, W) bool flow-consistency mask."""
    h, w = corner.shape
    xy, f1 = native.build_pair_candidates(corner, flow, mask, match_separation)
    scale = np.array([1.0 / w, inv_aspect / h], np.float32)
    return PairConstraints(
        loc0=xy.astype(np.float32) * scale,
        loc1=f1 * scale,
        is_static=np.ones(len(xy), bool),
    )


def build_triplet_constraints(
    corner: np.ndarray, flow10: np.ndarray, mask10: np.ndarray,
    flow12: np.ndarray, mask12: np.ndarray, inv_aspect: float,
    match_separation: int = 10,
) -> TripletConstraints:
    """One triplet's constraints, chained backward + forward from the center
    frame (reference lib/FlowConstraints.cpp:467-550). Priority is the
    corner response at the center pixel (robust_cvd_tpu's note on the
    reference's `cornerPtr[ix0]` applies)."""
    h, w = corner.shape
    xy, f0, f2 = native.build_triplet_candidates(
        corner, flow10, mask10, flow12, mask12, match_separation
    )
    scale = np.array([1.0 / w, inv_aspect / h], np.float32)
    loc = np.stack([f0, xy.astype(np.float32), f2], axis=1) * scale
    return TripletConstraints(
        loc=loc.astype(np.float32), is_static=np.ones(len(xy), bool)
    )


# ---------------------------------------------------------------------------
# Static flags from dynamic masks.
# ---------------------------------------------------------------------------


def dynamic_distance(dynamic_mask: np.ndarray | None, shape) -> np.ndarray:
    """Euclidean distance to the nearest dynamic pixel. dynamic_mask:
    (H, W) uint8/bool where WHITE (>=127 / True) = static. None -> all
    static."""
    if dynamic_mask is None:
        return np.full(shape, np.finfo(np.float32).max, np.float32)
    from scipy import ndimage

    static = np.asarray(dynamic_mask)
    if static.dtype != bool:
        static = static >= 127
    return ndimage.distance_transform_edt(static).astype(np.float32)


def set_static_flags(
    pair_keys: List[Tuple[int, int]],
    pairs: Dict[Tuple[int, int], PairConstraints],
    triplet_keys: List[int],
    triplets: Dict[int, TripletConstraints],
    dyn_dist: np.ndarray | None,
    min_dynamic_distance: float = 8.0,
) -> None:
    """Recompute isStatic from dynamic-mask distances, in place (reference
    lib/FlowConstraints.cpp:573-660). dyn_dist: (N, H, W) distance
    transforms, or None (all static). Multiplying BOTH normalized
    coordinates by the mask width recovers pixels, because y is stored
    pre-multiplied by inv_aspect (reference .cpp:617-623)."""
    if dyn_dist is None:
        for pc in pairs.values():
            pc.is_static[:] = True
        for tc in triplets.values():
            tc.is_static[:] = True
        return

    w = dyn_dist.shape[2]
    masks = dyn_dist > min_dynamic_distance

    def lookup(mask, loc):
        x = np.clip((loc[:, 0] * w).astype(np.int32), 0, mask.shape[1] - 1)
        y = np.clip((loc[:, 1] * w).astype(np.int32), 0, mask.shape[0] - 1)
        return mask[y, x]

    for (i, j) in pair_keys:
        pc = pairs[(i, j)]
        pc.is_static[:] = lookup(masks[i], pc.loc0) & lookup(masks[j], pc.loc1)
    for t in triplet_keys:
        tc = triplets[t]
        tc.is_static[:] = (
            lookup(masks[t - 1], tc.loc[:, 0])
            & lookup(masks[t], tc.loc[:, 1])
            & lookup(masks[t + 1], tc.loc[:, 2])
        )


# ---------------------------------------------------------------------------
# Flattening to solver tensors.
# ---------------------------------------------------------------------------


def _sample_source_depth(depth: np.ndarray, loc: np.ndarray, inv_aspect: float):
    """Nearest-pixel source depth at normalized loc
    (reference Observation ctor, lib/PoseOptimizer.cpp:113-115)."""
    h, w = depth.shape
    x = np.clip((loc[:, 0] * w).astype(np.int32), 0, w - 1)
    y = np.clip((loc[:, 1] / inv_aspect * h).astype(np.int32), 0, h - 1)
    return depth[y, x]


def loc_to_ndc(loc: np.ndarray, inv_aspect: float) -> np.ndarray:
    """[0,1]x[0,inv_aspect] -> NDC [-1,1]^2, y up
    (reference Observation ctor, lib/PoseOptimizer.cpp:105-106)."""
    return np.stack(
        [-1.0 + 2.0 * loc[:, 0], 1.0 - 2.0 * loc[:, 1] / inv_aspect], axis=-1
    ).astype(np.float32)


def _padded_count(counts, pad_to: int | None) -> int:
    # rounded up to 128 so that the solver tensors have the JAX package's
    # shapes (a TPU lane width there)
    c = pad_to or max(counts)
    return ((c + 127) // 128) * 128


def flatten_pairs(
    pair_keys: List[Tuple[int, int]],
    pairs: Dict[Tuple[int, int], PairConstraints],
    source_depth: np.ndarray,
    inv_aspect: float,
    pad_to: int | None = None,
    device="cpu",
) -> ConstraintData:
    """All pairs -> pair-blocked (P, C) ConstraintData on `device`, with NDC
    locations, sampled source depths and weights (0 for padding / dynamic /
    invalid-depth constraints, which the reference skips at problem build,
    lib/PoseOptimizer.cpp:1177-1193). Each pair is padded to the largest
    per-pair count (or `pad_to`)."""
    keys = [k for k in pair_keys if len(pairs[k].loc0) > 0]
    if not keys:
        raise RuntimeError(
            "no usable flow constraints: every sampled pair's consistency "
            "mask is empty. The optical flow is too inconsistent to drive "
            "pose optimization — check flow quality (flow_mask/ coverage, "
            "flow_list.json mask ratios)."
        )
    P = len(keys)
    C = _padded_count([len(pairs[k].loc0) for k in keys], pad_to)
    pair = np.zeros((P, 2), np.int64)
    l0 = np.zeros((P, C, 2), np.float32)
    l1 = np.zeros((P, C, 2), np.float32)
    d0 = np.ones((P, C), np.float32)
    d1 = np.ones((P, C), np.float32)
    wgt = np.zeros((P, C), np.float32)

    for p, (i, j) in enumerate(keys):
        pc = pairs[(i, j)]
        n = min(len(pc.loc0), C)
        dep0 = _sample_source_depth(source_depth[i], pc.loc0[:n], inv_aspect)
        dep1 = _sample_source_depth(source_depth[j], pc.loc1[:n], inv_aspect)
        valid = (
            pc.is_static[:n]
            & np.isfinite(dep0) & (dep0 > 0)
            & np.isfinite(dep1) & (dep1 > 0)
        )
        pair[p] = (i, j)
        l0[p, :n] = loc_to_ndc(pc.loc0[:n], inv_aspect)
        l1[p, :n] = loc_to_ndc(pc.loc1[:n], inv_aspect)
        d0[p, :n] = np.where(valid, dep0, 1.0)
        d1[p, :n] = np.where(valid, dep1, 1.0)
        wgt[p, :n] = valid.astype(np.float32)

    def t(a):
        return torch.as_tensor(a, device=device)

    return ConstraintData(
        pair=t(pair), loc0=t(l0), loc1=t(l1), depth0=t(d0), depth1=t(d1),
        weight=t(wgt),
    )


def flatten_triplets(
    triplet_keys: List[int],
    triplets: Dict[int, TripletConstraints],
    source_depth: np.ndarray,
    inv_aspect: float,
    smooth_static_weight: float,
    smooth_dynamic_weight: float,
    pad_to: int | None = None,
    device="cpu",
) -> TripletData | None:
    keys = [t for t in triplet_keys if len(triplets[t].loc) > 0]
    if not keys:
        return None
    T = len(keys)
    C = _padded_count([len(triplets[t].loc) for t in keys], pad_to)
    frame = np.zeros((T,), np.int64)
    locs = np.zeros((T, C, 3, 2), np.float32)
    deps = np.ones((T, C, 3), np.float32)
    wgts = np.zeros((T, C), np.float32)

    for p, t in enumerate(keys):
        tc = triplets[t]
        n = min(len(tc.loc), C)
        dep = np.stack(
            [
                _sample_source_depth(source_depth[t + k - 1], tc.loc[:n, k], inv_aspect)
                for k in range(3)
            ],
            axis=1,
        )
        valid = np.all(np.isfinite(dep) & (dep > 0), axis=1)
        w = np.where(tc.is_static[:n], smooth_static_weight, smooth_dynamic_weight)
        frame[p] = t
        locs[p, :n] = np.stack(
            [loc_to_ndc(tc.loc[:n, k], inv_aspect) for k in range(3)], axis=1
        )
        deps[p, :n] = np.where(valid[:, None], dep, 1.0)
        wgts[p, :n] = np.where(valid, w, 0.0)

    def tt(a):
        return torch.as_tensor(a, device=device)

    return TripletData(frame=tt(frame), loc=tt(locs), depth=tt(deps), weight=tt(wgts))
