"""Epipolar geometry: fundamental/essential matrices, Sampson distance,
RANSAC-based dynamic-constraint classification.

A copy of robust_cvd_tpu/ops/epipolar.py, which is host numpy (reference
utils/epipolar_geometry.py and the `Ransac` dynamic-constraints mode of
pose_optimization.py:173-174): fit F per frame pair to the flow
correspondences with a seeded RANSAC (the rigid background dominates) and
mark correspondences whose Sampson distance exceeds the threshold as
dynamic. The refit on all inliers skips the full U of its SVD (the same
F bit for bit; `homography._full_u`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .homography import _full_u


def cross_matrix(t: np.ndarray) -> np.ndarray:
    return np.array(
        [[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], t.dtype
    )


def essential_from_poses(R_rel: np.ndarray, t_rel: np.ndarray) -> np.ndarray:
    """E = [t]_x R (reference epipolar_geometry.py:98-108)."""
    return cross_matrix(t_rel) @ R_rel


def fundamental_from_essential(E, K0, K1) -> np.ndarray:
    """F = K1^-T E K0^-1 (reference :110-123)."""
    return np.linalg.inv(K1).T @ E @ np.linalg.inv(K0)


def _to_homo(pts):
    return np.concatenate([pts, np.ones(pts.shape[:-1] + (1,))], axis=-1)


def sampson_distance(F: np.ndarray, pts0: np.ndarray, pts1: np.ndarray) -> np.ndarray:
    """First-order geometric epipolar distance (px). F: (..., 3, 3);
    pts: (..., K, 2)."""
    x0 = _to_homo(pts0)
    x1 = _to_homo(pts1)
    Fx0 = np.einsum("...ij,...kj->...ki", F, x0)
    Ftx1 = np.einsum("...ji,...kj->...ki", F, x1)
    num = np.einsum("...ki,...ki->...k", x1, Fx0) ** 2
    den = (
        Fx0[..., 0] ** 2 + Fx0[..., 1] ** 2 + Ftx1[..., 0] ** 2 + Ftx1[..., 1] ** 2
    )
    return np.sqrt(num / np.maximum(den, 1e-12))


def _eight_point(pts0: np.ndarray, pts1: np.ndarray) -> np.ndarray:
    """Normalized 8-point algorithm, batched over a leading hypothesis axis.
    pts: (..., K>=8, 2) -> F (..., 3, 3)."""

    def normalize(p):
        mean = p.mean(axis=-2, keepdims=True)
        d = np.linalg.norm(p - mean, axis=-1).mean(axis=-1)
        s = np.sqrt(2.0) / np.maximum(d, 1e-12)
        return (p - mean) * s[..., None, None], mean, s

    p0, m0, s0 = normalize(pts0)
    p1, m1, s1 = normalize(pts1)

    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    ones = np.ones_like(x0)
    A = np.stack(
        [x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, ones], axis=-1
    )
    _, _, vt = np.linalg.svd(A, full_matrices=_full_u(A))
    F = vt[..., -1, :].reshape(A.shape[:-2] + (3, 3))
    # enforce rank 2
    u, s, v = np.linalg.svd(F)
    s = s.copy()
    s[..., 2] = 0.0
    F = u @ (s[..., :, None] * v)

    def T_of(mean, scale):
        shape = mean.shape[:-2]
        T = np.zeros(shape + (3, 3))
        T[..., 0, 0] = scale
        T[..., 1, 1] = scale
        T[..., 2, 2] = 1.0
        T[..., 0, 2] = -scale * mean[..., 0, 0]
        T[..., 1, 2] = -scale * mean[..., 0, 1]
        return T

    T0 = T_of(m0, s0)
    T1 = T_of(m1, s1)
    return np.swapaxes(T1, -1, -2) @ F @ T0


def find_fundamental_ransac(
    pts0: np.ndarray, pts1: np.ndarray, thresh: float = 2.0,
    iters: int = 256, seed: int = 0,
) -> Optional[np.ndarray]:
    n = len(pts0)
    if n < 8:
        return None
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, n, (iters, 8))
    Fs = _eight_point(pts0[sel], pts1[sel])
    d = sampson_distance(Fs, np.broadcast_to(pts0, (iters, n, 2)),
                         np.broadcast_to(pts1, (iters, n, 2)))
    inliers = d < thresh
    counts = inliers.sum(axis=1)
    best = int(np.argmax(counts))
    if counts[best] < 8:
        return None
    mask = inliers[best]
    return _eight_point(pts0[mask], pts1[mask])


def set_static_flags_from_ransac(
    pair_keys: List[Tuple[int, int]],
    pairs: Dict,
    image_size: Tuple[int, int],
    inv_aspect: float,
    epipolar_dist_thresh: float = 2.0,
) -> None:
    """Classify constraints as static iff they fit the dominant rigid
    epipolar geometry (the `Ransac` dynamic_constraints mode,
    reference pose_optimization.py:173-174). In place on the constraint
    dicts from solver/constraints.py."""
    h, w = image_size
    scale = np.array([w, w], np.float64)  # loc * w recovers pixels (both axes)
    for key in pair_keys:
        pc = pairs[key]
        if len(pc.loc0) < 8:
            pc.is_static[:] = True
            continue
        p0 = pc.loc0 * scale
        p1 = pc.loc1 * scale
        F = find_fundamental_ransac(p0, p1, epipolar_dist_thresh)
        if F is None:
            pc.is_static[:] = True
            continue
        d = sampson_distance(F[None], p0[None], p1[None])[0]
        pc.is_static[:] = d < epipolar_dist_thresh
