"""Test-time fine-tuning losses (PyTorch, channels-last).

Port of robust_cvd_tpu/training/losses.py (reference loss/*.py): the
consistency loss (reprojection, disparity and depth-ratio terms), the
scene-flow loss (static and temporal), disparity smoothness, contrast and
the parameter loss, with Barron's robust distances, summed per sample by
`pair_losses` and over the batch by `joint_loss` into the same total and
the same `parts` keys. Bilinear
sampling is ops/geometry.py::grid_sample in pixel coordinates with a
border clamp, as in the JAX package.

Data layout (a batch of pair samples; N = 2, or 6 with temporal smoothness,
order [ref, tgt, ref-1, ref+1, tgt-1, tgt+1]):
  depths        (B, N, H, W)
  images        (B, N, H, W, 3)
  extrinsics    (B, N, 3, 4)
  intrinsics    (B, N, 4)        pixel (fx, fy, cx, cy)
  warp          (B, N, H, W, 2)  NDC spatial-transform displacement
  flows         (B, 2, H, W, 2)  ref->tgt and tgt->ref, pixels
  masks         (B, 2, H, W)
  flows_n       (B, 4, H, W, 2)  ref->ref-1, ref->ref+1, tgt->tgt-1, tgt->tgt+1
  masks_n       (B, 4, H, W)
  valid_n       (B, 2)
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import LossParams
from ..ops import geometry


class LossMeta(NamedTuple):
    extrinsics: torch.Tensor
    intrinsics: torch.Tensor
    flows: torch.Tensor
    masks: torch.Tensor
    warp: Optional[torch.Tensor] = None
    flows_n: Optional[torch.Tensor] = None
    masks_n: Optional[torch.Tensor] = None
    valid_n: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# Robust distances (reference loss/distance.py + loss/general.py).
# ---------------------------------------------------------------------------


def barron_loss(x, alpha: float, scale: float, eps: float = 1e-6):
    """Barron's general robust loss rho(x, alpha, c) with a fixed alpha."""
    sq = torch.square(x / scale)
    if alpha == 2.0:
        return 0.5 * sq
    if alpha == 0.0:
        return torch.log1p(0.5 * sq)
    if alpha == -math.inf:
        return 1.0 - torch.exp(-0.5 * sq)
    b = abs(alpha - 2.0) + eps
    d = alpha + eps if alpha >= 0 else alpha - eps
    return (b / d) * (torch.pow(sq / b + 1.0, 0.5 * d) - 1.0)


def make_distance(kind: str, opt: LossParams):
    scale = opt.distance_scale
    if kind == "l1":
        return lambda x: torch.abs(x / scale)
    if kind == "l2":
        return lambda x: barron_loss(x, 2.0, scale)
    if kind == "smooth_l1":
        return lambda x: barron_loss(x, 1.0, scale)
    if kind == "cauchy":
        return lambda x: barron_loss(x, 0.0, scale)
    if kind == "general":
        return lambda x: barron_loss(x, opt.distance_alpha, scale)
    raise ValueError(kind)


def weighted_mean(x, w, eps: float = 1e-6):
    """Per-batch weighted mean (reference utils/loss.py:62-80). x, w: (B, ...)."""
    b = x.shape[0]
    wsum = torch.clamp(w.reshape(b, -1).sum(1), min=eps)
    return (x * w).reshape(b, -1).sum(1) / wsum


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _points_and_pixels(depths, intrinsics, warp):
    """Depths (B, N, H, W) -> camera points (B, N, H, W, 3) and the (possibly
    warped) pixel grid (B, N, H, W, 2)."""
    b, n, h, w = depths.shape
    pixels = geometry.pixel_grid((h, w), depths.device).expand(b, n, h, w, 2)
    if warp is not None:
        pixels = pixels + warp * depths.new_tensor([w / 2.0, h / 2.0])
    points = geometry.pixels_to_points(intrinsics[..., None, None, :], depths, pixels)
    return points, pixels


def _mean_of(terms):
    return torch.stack(terms, -1).mean(-1)


def _log_ratio(a, b):
    """log(min(a, b) / max(a, b, 1e-12)) of two depth magnitudes."""
    return torch.log(
        torch.minimum(a, b) / torch.clamp(torch.maximum(a, b), min=1e-12)
    )


# ---------------------------------------------------------------------------
# Consistency loss.
# ---------------------------------------------------------------------------


def consistency_loss(
    depths, meta: LossMeta, opt: LossParams
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    dist = make_distance(opt.distance_type_static, opt)
    points, pixels = _points_and_pixels(depths, meta.intrinsics, meta.warp)

    reproj_losses, disp_losses, ratio_losses = [], [], []
    for k in (0, 1):
        o = 1 - k
        mask = meta.masks[:, k]
        intr_tgt = meta.intrinsics[:, o]
        pts_in_tgt = geometry.reproject_points(
            points[:, k],
            meta.extrinsics[:, k][:, None, None],
            meta.extrinsics[:, o][:, None, None],
        )
        matched = pixels[:, k] + meta.flows[:, k]

        if opt.lambda_static_reprojection > 0:
            pix_tgt = geometry.project(pts_in_tgt, intr_tgt[:, None, None])
            reproj_losses.append(weighted_mean(dist(_norm(pix_tgt - matched)), mask))

        if opt.lambda_static_disparity > 0 or opt.lambda_static_depth_ratio > 0:
            # only the z channel of the warped target points is used
            warped_tgt_z = geometry.grid_sample(points[:, o][..., 2:], matched)[..., 0]

        if opt.lambda_static_disparity > 0:
            f = meta.intrinsics[:, k, :2].mean(1)
            disp_diff = 1.0 / pts_in_tgt[..., 2] - 1.0 / warped_tgt_z
            disp_losses.append(f * weighted_mean(dist(disp_diff), mask))

        if opt.lambda_static_depth_ratio > 0:
            ratio = opt.lambda_static_depth_ratio * _log_ratio(
                torch.abs(warped_tgt_z), torch.abs(pts_in_tgt[..., 2])
            )
            ratio_losses.append(weighted_mean(dist(ratio), mask))

    batch_losses = {}
    total = 0.0
    if opt.lambda_static_reprojection > 0:
        r = opt.lambda_static_reprojection * _mean_of(reproj_losses)
        batch_losses["reproj"] = r
        total = total + r
    if opt.lambda_static_disparity > 0:
        d = opt.lambda_static_disparity * _mean_of(disp_losses)
        batch_losses["disp"] = d
        total = total + d
    if opt.lambda_static_depth_ratio > 0:
        dr = _mean_of(ratio_losses)
        batch_losses["depth_ratio"] = dr
        total = total + dr
    return torch.mean(total), batch_losses


# ---------------------------------------------------------------------------
# Scene-flow loss (static + temporal smoothness).
# ---------------------------------------------------------------------------


def scene_flow_loss(
    depths, meta: LossMeta, opt: LossParams
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    dist_static = make_distance(opt.distance_type_static, opt)
    dist_smooth = make_distance(opt.distance_type_smooth, opt)
    points, pixels = _points_and_pixels(depths, meta.intrinsics, meta.warp)

    def to_world(pts, ext):
        return geometry.points_cam_to_world(pts, ext[:, None, None])

    batch_losses = {}
    total = 0.0

    if opt.lambda_scene_flow_static > 0:
        static_losses = []
        for k in (0, 1):
            o = 1 - k
            world_ref = to_world(points[:, k], meta.extrinsics[:, k])
            matched = pixels[:, k] + meta.flows[:, k]
            pts_trg = geometry.grid_sample(points[:, o], matched)
            world_trg = to_world(pts_trg, meta.extrinsics[:, o])
            w = meta.masks[:, k] * torch.abs(1.0 / points[:, k][..., 2])
            static_losses.append(weighted_mean(dist_static(_norm(world_ref - world_trg)), w))
        s = opt.lambda_scene_flow_static * _mean_of(static_losses)
        batch_losses["static"] = s
        total = total + s

    use_smooth = (
        opt.lambda_smooth_disparity > 0
        or opt.lambda_smooth_reprojection > 0
        or opt.lambda_smooth_depth_ratio > 0
    )
    if use_smooth:
        reproj_l, disp_l, ratio_l = [], [], []
        for k in (0, 1):
            bw, fw = 2 + 2 * k, 3 + 2 * k  # neighbour slots on the N axis
            nbw, nfw = 2 * k, 2 * k + 1  # slots on the flows_n axis
            ext_ref = meta.extrinsics[:, k]
            intr_ref = meta.intrinsics[:, k]
            world_ref = to_world(points[:, k], ext_ref)
            pts_bw = geometry.grid_sample(points[:, bw], pixels[:, k] + meta.flows_n[:, nbw])
            pts_fw = geometry.grid_sample(points[:, fw], pixels[:, k] + meta.flows_n[:, nfw])
            world_bw = to_world(pts_bw, meta.extrinsics[:, bw])
            world_fw = to_world(pts_fw, meta.extrinsics[:, fw])

            residual = (world_fw - world_ref) + (world_bw - world_ref)
            pts_s = geometry.world_to_points_cam(world_ref + residual, ext_ref[:, None, None])

            valid = meta.valid_n[:, k][:, None, None]
            mask = valid * meta.masks_n[:, nbw] * meta.masks_n[:, nfw]

            if opt.lambda_smooth_reprojection > 0:
                pix_s = geometry.project(pts_s, intr_ref[:, None, None])
                reproj_l.append(weighted_mean(dist_smooth(_norm(pix_s - pixels[:, k])), mask))
            if opt.lambda_smooth_disparity > 0:
                f = intr_ref[:, :2].mean(1)
                dd = 1.0 / pts_s[..., 2] - 1.0 / points[:, k][..., 2]
                disp_l.append(f * weighted_mean(dist_smooth(dd), mask))
            if opt.lambda_smooth_depth_ratio > 0:
                ratio = opt.lambda_smooth_depth_ratio * _log_ratio(
                    torch.abs(points[:, k][..., 2]), torch.abs(pts_s[..., 2])
                )
                ratio_l.append(weighted_mean(dist_smooth(ratio), mask))

        if opt.lambda_smooth_reprojection > 0:
            r = opt.lambda_smooth_reprojection * _mean_of(reproj_l)
            batch_losses["smooth_reproj"] = r
            total = total + r
        if opt.lambda_smooth_disparity > 0:
            d = opt.lambda_smooth_disparity * _mean_of(disp_l)
            batch_losses["smooth_disparity"] = d
            total = total + d
        if opt.lambda_smooth_depth_ratio > 0:
            dr = _mean_of(ratio_l)
            batch_losses["smooth_depth_ratio"] = dr
            total = total + dr

    if not batch_losses:
        return depths.new_zeros(()), batch_losses
    return torch.mean(total), batch_losses


# ---------------------------------------------------------------------------
# Spatial smoothness, contrast and parameter losses.
# ---------------------------------------------------------------------------


def disparity_smooth_loss(images, depths, opt: LossParams):
    """(reference loss/disparity_smooth_loss.py:15-57).
    images (B, N, H, W, 3); depths (B, N, H, W)."""
    disp = 1.0 / depths
    gdx = torch.abs(disp[..., :, :-1] - disp[..., :, 1:])
    gdy = torch.abs(disp[..., :-1, :] - disp[..., 1:, :])
    gix = torch.abs(images[..., :, :-1, :] - images[..., :, 1:, :]).mean(-1)
    giy = torch.abs(images[..., :-1, :, :] - images[..., 1:, :, :]).mean(-1)
    gdx = gdx * torch.exp(-gix / opt.sigma_color_grad)
    gdy = gdy * torch.exp(-giy / opt.sigma_color_grad)
    b = depths.shape[0]
    per_batch = gdx.reshape(b, -1).mean(1) + gdy.reshape(b, -1).mean(1)
    per_batch = per_batch * opt.lambda_disparity_smooth
    return per_batch.mean(), {"disparity_smooth": per_batch}


def _contrast_terms(depths_orig, depths, opt: LossParams):
    """The horizontal and vertical hinge terms of the contrast loss,
    (B*N, H, W) each. Shapes (B, N, H, W)."""
    h, w = depths.shape[-2:]
    x_orig = depths_orig.reshape(-1, h, w)
    x_pred = depths.reshape(-1, h, w)

    def ratios(x):
        eps = 1e-10
        right = F.pad(x, (0, 1))[:, :, 1:]
        bottom = F.pad(x, (0, 0, 0, 1))[:, 1:, :]
        rh = torch.maximum(right, x) / (torch.minimum(right, x) + eps)
        rv = torch.maximum(bottom, x) / (torch.minimum(bottom, x) + eps)
        # the last column / row has no neighbour: its ratio is 0
        rh = torch.cat([rh[:, :, :-1], torch.zeros_like(rh[:, :, -1:])], 2)
        rv = torch.cat([rv[:, :-1, :], torch.zeros_like(rv[:, -1:, :])], 1)
        return rh, rv

    rh_p, rv_p = ratios(x_pred)
    rh_o, rv_o = ratios(x_orig)
    thresh = opt.lambda_contrast_thresh
    zero = depths.new_zeros(())
    lh = torch.maximum(torch.square(thresh - rh_p), zero) * (rh_o > thresh)
    lv = torch.maximum(torch.square(thresh - rv_p), zero) * (rv_o > thresh)
    return lh, lv


def contrast_loss(depths_orig, depths, opt: LossParams):
    """(reference loss/contrast_loss.py:8-79). Shapes (B, N, H, W)."""
    lh, lv = _contrast_terms(depths_orig, depths, opt)
    n = lh.shape[0]
    return opt.lambda_contrast_loss * (lh.sum() / n + lv.sum() / n)


def parameter_loss(params, params_init, opt: LossParams):
    """L1 drift from the initial weights (reference loss/parameter_loss.py),
    over the flat parameter buffers. |x| is written as where(x >= 0, x, -x)
    so that its derivative at 0 is 1, as jnp.abs's is (torch.abs's is 0),
    which matters at the first step, where every parameter sits exactly at
    its initial value."""
    d = params - params_init
    return opt.lambda_parameter * torch.where(d >= 0, d, -d).sum()


# ---------------------------------------------------------------------------
# Joint loss.
# ---------------------------------------------------------------------------


def _flow_losses(opt: LossParams) -> list:
    """The enabled flow-driven losses, in joint_loss's order."""
    fns = []
    if (
        opt.lambda_static_disparity > 0
        or opt.lambda_static_reprojection > 0
        or opt.lambda_static_depth_ratio > 0
    ):
        fns.append(consistency_loss)
    if (
        opt.lambda_scene_flow_static > 0
        or opt.lambda_smooth_reprojection > 0
        or opt.lambda_smooth_disparity > 0
        or opt.lambda_smooth_depth_ratio > 0
    ):
        fns.append(scene_flow_loss)
    return fns


def pair_losses(
    opt: LossParams,
    images,
    depths_orig,
    depths,
    meta: LossMeta,
    params=None,
    params_init=None,
):
    """The enabled losses (reference loss/joint_loss.py:18-103) of each
    sample of the batch on its own: totals (B,) and parts {name: (B,)},
    what `joint_loss` gives a batch of that one sample (the per-pair eval,
    reference depth_fine_tuning.py:756-817)."""
    b, n = depths.shape[:2]
    total = depths.new_zeros((b,))
    parts: Dict[str, torch.Tensor] = {}

    if opt.lambda_parameter > 0:
        p = parameter_loss(params, params_init, opt)
        total = total + p
        parts["parameter_loss"] = p.expand(b)

    for fn in _flow_losses(opt):
        _, bl = fn(depths, meta, opt)
        if bl:
            total = total + sum(bl.values())
            parts.update(bl)

    if opt.lambda_disparity_smooth > 0:
        _, bl = disparity_smooth_loss(images, depths, opt)
        total = total + bl["disparity_smooth"]
        parts.update(bl)

    if opt.lambda_contrast_loss > 0:
        lh, lv = _contrast_terms(depths_orig, depths, opt)
        c = opt.lambda_contrast_loss * (
            lh.reshape(b, -1).sum(1) / n + lv.reshape(b, -1).sum(1) / n
        )
        total = total + c
        parts["contrast"] = c

    return total, parts


def joint_loss(
    opt: LossParams,
    images,
    depths_orig,
    depths,
    meta: LossMeta,
    params=None,
    params_init=None,
):
    """Sum of the enabled losses over the batch: the mean of `pair_losses`'
    totals, with its parts; the parameter and contrast losses are one value
    for the batch, shape (1,)."""
    total, parts = pair_losses(
        opt, images, depths_orig, depths, meta, params, params_init
    )
    if "parameter_loss" in parts:
        parts["parameter_loss"] = parts["parameter_loss"][:1]
    if "contrast" in parts:
        parts["contrast"] = parts["contrast"].mean()[None]
    return total.mean(), parts
