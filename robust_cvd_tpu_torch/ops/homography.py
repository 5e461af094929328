"""Homography pre-registration for optical flow (PyTorch).

Port of the batched registration of robust_cvd_tpu/ops/homography.py, the
JAX package's stand-in for the reference's SURF + BruteForce-KNN + Lowe
ratio + RANSAC findHomography pre-alignment (reference
optical_flow_homography.py:67-173): a global homography factors out large
camera motion, RAFT explains the residual, and the flow is un-warped
through H^-1 afterwards (:204-227).

Keypoints come from the corner response (`ops/corner.py`: the Hopper
kernel on a CUDA tensor, its plain version on the CPU), one call over both
frame stacks of a chunk; descriptors are unit-norm 15x15 gray patches,
matched by one batched product; the homography is a DLT-RANSAC over a
fixed table of 256 four-point hypotheses, all solved at once, then a
weighted refit on the winner's inliers.

Not ported: the TPU's one-hot patch extraction (a gather here, as on the
JAX package's CPU path). The numpy host helpers (detect_keypoints,
patch_descriptors, match_ratio, find_homography_ransac) come with their
only users, the mask and epipolar stages.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import float32_precision
from .corner import corner_min_eigenval
from .geometry import grid_sample, pixel_grid

_PATCH_RADIUS = 7
_RANSAC_ITERS = 256
_RANSAC_THRESH = 4.0
_LOWE_RATIO = 0.75


def _topk_stable(x: torch.Tensor, k: int):
    """The k largest along the last axis, ties in index order (the lower
    index first, as jax.lax.top_k; torch.topk promises no order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _nms_topk(resp: torch.Tensor, k: int, border: int = 8):
    """(B, H, W) corner response -> the k strongest keypoints after a 3x3
    non-max suppression (ties kept) and an 8-pixel border. Returns xs, ys
    (B, K) float32 and valid (B, K)."""
    B, H, W = resp.shape
    pooled = F.max_pool2d(resp[:, None], 3, stride=1, padding=1)[:, 0]  # -inf padding
    resp = torch.where(resp >= pooled, resp, torch.zeros_like(resp))
    ys_i = torch.arange(H, device=resp.device)[:, None]
    xs_i = torch.arange(W, device=resp.device)[None, :]
    inb = (ys_i >= border) & (ys_i < H - border) & (xs_i >= border) & (xs_i < W - border)
    resp = torch.where(inb, resp, torch.zeros_like(resp))
    vals, idx = _topk_stable(resp.reshape(B, -1), k)
    return (idx % W).float(), (idx // W).float(), vals > 1e-8


def _patch_descriptors_b(gray: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """(B, H, W) + keypoints (B, K) -> unit-norm, zero-mean 15x15 patches
    (B, K, 225) around each keypoint, edge-padded."""
    r = _PATCH_RADIUS
    size = 2 * r + 1
    B, H, W = gray.shape
    pad = F.pad(gray[:, None], (r, r, r, r), mode="replicate")[:, 0]
    wp = W + 2 * r
    off = torch.arange(size, device=gray.device)
    offs = (off[:, None] * wp + off[None, :]).reshape(-1)  # (P,)
    # top-left corner in padded coordinates: (y - r) + r
    corner = ys.long() * wp + xs.long()  # (B, K)
    idx = (corner[..., None] + offs).reshape(B, -1)
    patches = torch.gather(pad.reshape(B, -1), 1, idx).reshape(B, -1, size * size)
    patches = patches - patches.mean(-1, keepdim=True)
    n = torch.sqrt((patches * patches).sum(-1, keepdim=True))
    return patches / torch.clamp(n, min=1e-8)


def _norm_pts(pts: torch.Tensor, w: torch.Tensor):
    """Hartley normalisation: weighted shift to the centroid and scale to
    RMS sqrt(2). pts (..., K, 2), w (..., K) -> (normalised pts,
    T (..., 3, 3))."""
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1e-6)
    mean = (pts * w[..., None]).sum(-2, keepdim=True) / wsum[..., None]
    centered = pts - mean
    rms = torch.sqrt(((centered ** 2).sum(-1) * w).sum(-1, keepdim=True) / wsum)
    s = float(np.sqrt(2.0)) / torch.clamp(rms, min=1e-6)  # (..., 1)
    pn = centered * s[..., None]
    z = torch.zeros_like(s)
    one = torch.ones_like(s)
    T = torch.stack([
        torch.cat([s, z, -s * mean[..., 0, 0:1]], -1),
        torch.cat([z, s, -s * mean[..., 0, 1:2]], -1),
        torch.cat([z, z, one], -1),
    ], dim=-2)
    return pn, T


def _dlt_rows(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """The DLT's two rows per correspondence: (..., K, 2) x2 -> (..., 2K, 9)."""
    x, y = pa[..., 0], pa[..., 1]
    u, v = pb[..., 0], pb[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    r1 = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y, -u], -1)
    r2 = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y, -v], -1)
    return torch.cat([r1, r2], dim=-2)


def _denormalise(Hn: torch.Tensor, Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """H = Tb^-1 Hn Ta, scaled to H[2, 2] = 1 where it is not ~0."""
    H = torch.linalg.solve_ex(Tb, Hn @ Ta)[0]
    scale = H[..., 2:3, 2:3]
    return H / torch.where(scale.abs() > 1e-12, scale, torch.ones_like(scale))


def _dlt_weighted(ptsA: torch.Tensor, ptsB: torch.Tensor, w: torch.Tensor):
    """Weighted DLT: the eigenvector of the smallest eigenvalue of A^T A
    (9x9 eigh, ascending as in JAX; its sign cancels in the H[2, 2]
    normalisation), Hartley-normalised. ptsA/ptsB (..., K, 2), w (..., K)
    -> H (..., 3, 3) mapping A -> B."""
    pa, Ta = _norm_pts(ptsA, w)
    pb, Tb = _norm_pts(ptsB, w)
    A = _dlt_rows(pa, pb) * torch.cat([w, w], -1)[..., None]
    M = A.transpose(-1, -2) @ A
    _, vecs = torch.linalg.eigh(M)
    Hn = vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3))
    return _denormalise(Hn, Ta, Tb)


def _dlt4(ptsA: torch.Tensor, ptsB: torch.Tensor) -> torch.Tensor:
    """Exact 4-point homography by an 8x8 solve with h33 = 1, Hartley-
    normalised. ptsA/ptsB (..., 4, 2) -> H (..., 3, 3) A -> B. A singular
    system gives NaN, as JAX's LU does by dividing by its zero pivot
    (torch.linalg.solve would raise); such a hypothesis scores no
    inliers."""
    w = torch.ones(ptsA.shape[:-1], dtype=ptsA.dtype, device=ptsA.device)
    pa, Ta = _norm_pts(ptsA, w)
    pb, Tb = _norm_pts(ptsB, w)
    A = _dlt_rows(pa, pb)  # (..., 8, 9)
    h8, info = torch.linalg.solve_ex(A[..., :8], -A[..., 8:9])
    h8 = torch.where((info == 0)[..., None, None], h8, torch.full_like(h8, float("nan")))[..., 0]
    h = torch.cat([h8, torch.ones_like(h8[..., :1])], -1)
    return _denormalise(h.reshape(h.shape[:-1] + (3, 3)), Ta, Tb)


def _apply_h(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) x (..., K, 2) -> (..., K, 2), with the JAX package's
    guard on a ~0 third coordinate. Broadcast multiply-adds: full float32
    on every device."""
    x, y = pts[..., 0, None], pts[..., 1, None]  # (..., K, 1)
    Hr = H[..., None, :, :]  # (..., 1, 3, 3)
    out = Hr[..., 0] * x + Hr[..., 1] * y + Hr[..., 2]  # (..., K, 3)
    z = out[..., 2:]
    return out[..., :2] / torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))


def _register_batch(im1: torch.Tensor, im2: torch.Tensor, sel: torch.Tensor,
                    max_keypoints: int):
    """(B, H, W, 3) x2 + hypothesis table (S, 4) -> (H_BA (B, 3, 3),
    im2 registered into im1's frame (B, H, W, 3))."""
    B, H, W, _ = im1.shape
    rgb = torch.stack([im1, im2])
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]  # BT.601
    resp = corner_min_eigenval(gray.reshape(2 * B, H, W)).reshape(2, B, H, W)
    x1, y1, v1 = _nms_topk(resp[0], max_keypoints)
    x2, y2, v2 = _nms_topk(resp[1], max_keypoints)
    d1 = _patch_descriptors_b(gray[0], x1, y1)
    d2 = _patch_descriptors_b(gray[1], x2, y2)

    # Lowe-ratio matching frame2 -> frame1 as the JAX package does it on
    # every backend: descriptors rounded to bf16, products summed in
    # float32 (exact products, float32 sums; a bf16 matmul would round
    # its output too)
    sim = d2.bfloat16().float() @ d1.bfloat16().float().transpose(1, 2)  # (B, K2, K1)
    sim = torch.where(v1[:, None, :], sim, torch.full_like(sim, float("-inf")))
    top2, idx2 = _topk_stable(sim, 2)
    best = idx2[..., 0]
    dd1 = torch.sqrt(torch.clamp(2.0 - 2.0 * top2[..., 0], min=0.0))
    dd2 = torch.sqrt(torch.clamp(2.0 - 2.0 * top2[..., 1], min=0.0))
    w = ((dd1 < _LOWE_RATIO * dd2) & v2).float()  # (B, K)

    ptsA = torch.stack([x2, y2], -1)  # frame2 keypoints (B, K, 2)
    ptsB = torch.gather(torch.stack([x1, y1], -1), 1, best[..., None].expand(-1, -1, 2))

    # RANSAC: S fixed hypothesis quadruples, all solved at once
    selA, selB, selw = ptsA[:, sel], ptsB[:, sel], w[:, sel]  # (B, S, 4, ...)
    hyp_ok = (selw > 0).all(-1)  # (B, S)
    Hs = _dlt4(selA, selB)  # (B, S, 3, 3)
    proj = _apply_h(Hs, ptsA[:, None])  # (B, S, K, 2)
    err = torch.sqrt(((proj - ptsB[:, None]) ** 2).sum(-1))
    inl = (err < _RANSAC_THRESH) & (w[:, None] > 0)  # (B, S, K)
    counts = torch.where(hyp_ok, inl.sum(-1), torch.full_like(hyp_ok, -1, dtype=torch.long))
    best_hyp = torch.argmax(counts, dim=1)  # the first of equal counts, as jnp.argmax
    best_inl = inl[torch.arange(B, device=inl.device), best_hyp].float()  # (B, K)

    # weighted refit on the winning inlier set; identity below 8 inliers
    H_fit = _dlt_weighted(ptsA, ptsB, best_inl)
    ok = (best_inl.sum(-1) >= 8) & torch.isfinite(H_fit).all(-1).all(-1)
    eye = torch.eye(3, dtype=H_fit.dtype, device=H_fit.device).expand(B, 3, 3)
    H_BA = torch.where(ok[:, None, None], H_fit, eye)

    # inverse-warp im2 through H_BA (cv2.warpPerspective semantics) with
    # border-clamped bilinear sampling
    Hinv = torch.linalg.inv_ex(H_BA)[0]
    pix = pixel_grid((H, W), im1.device).reshape(1, -1, 2)
    src = _apply_h(Hinv, pix.expand(B, -1, -1)).reshape(B, H, W, 2)
    return H_BA, grid_sample(im2, src)


def _hypothesis_table(max_keypoints: int, seed: int = 0) -> np.ndarray:
    """4 distinct indices per hypothesis from the strongest-first prefix of
    the keypoints (the JAX package's numpy table, the same draws)."""
    rng = np.random.default_rng(seed)
    pool = min(max_keypoints, 96)
    order = np.argsort(rng.random((_RANSAC_ITERS, pool)), axis=1)
    return order[:, :4].astype(np.int32)


def register_pairs(im1, im2, max_keypoints: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched pre-registration: frames2 -> frames1 homographies H_BA
    (B, 3, 3) and frames2 registered into frames1's frame (B, H, W, 3).
    Inputs (B, H, W, 3) RGB in [0, 1], tensors (it runs on their device)
    or numpy arrays (on the CPU). Matrix products in full float32."""
    im1 = torch.as_tensor(im1, dtype=torch.float32)
    im2 = torch.as_tensor(im2, dtype=torch.float32, device=im1.device)
    sel = torch.as_tensor(_hypothesis_table(max_keypoints), device=im1.device).long()
    with torch.no_grad(), float32_precision(cudnn_tf32=False):
        return _register_batch(im1, im2, sel, max_keypoints)


def register_pair(img1: np.ndarray, img2: np.ndarray, max_keypoints: int = 1024):
    """H_BA (frame2 -> frame1 coordinates) and frame2 registered into
    frame1's frame, for one pair (reference getimage, :139-173), as
    numpy; the identity on degenerate matches (reference :151-163)."""
    Hs, regs = register_pairs(np.asarray(img1)[None], np.asarray(img2)[None], max_keypoints)
    return Hs[0].cpu().numpy(), regs[0].cpu().numpy()


def unwarp_flow(flow_reg: np.ndarray, H_BA: np.ndarray) -> np.ndarray:
    """Flow computed against the registered frame2 -> the true frame1 ->
    frame2 flow, through H_BA^-1 (reference :204-227). numpy, (H, W, 2)."""
    h, w = flow_reg.shape[:2]
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32),
                         indexing="ij")
    pix = np.stack([xs, ys], -1)
    matched = (pix + flow_reg).reshape(-1, 2)
    ph = np.concatenate([matched, np.ones((len(matched), 1), matched.dtype)], -1)
    out = ph @ np.linalg.inv(H_BA).T
    z = out[:, 2:]
    unwarped = out[:, :2] / np.where(np.abs(z) > 1e-12, z, 1e-12)
    return (unwarped.reshape(h, w, 2) - pix).astype(np.float32)
