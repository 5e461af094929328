"""Plain fine-tune losses of a batch of frame pairs (the reference code's
loss/consistency_loss.py, loss/contrast_loss.py, loss/joint_loss.py),
channels-last, with the bilinear sampler written out.

Geometry: pixel (x, y) from the top-left; the camera looks down -z; the v
axis flips between pixels and camera space; intrinsics are pixel (fx, fy,
cx, cy); extrinsics camera-to-world [R|t]. The sampler clamps coordinates
to the image and its top-left tap to [0, W-2] x [0, H-2].

Only the terms a configuration of this benchmark turns on are written:
the consistency loss's reprojection, disparity and depth-ratio terms with
the l1 distance, and the contrast loss; `check_supported` refuses others.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

SUPPORTED_ZERO = ("lambda_scene_flow_static", "lambda_smooth_disparity",
                  "lambda_smooth_depth_ratio", "lambda_smooth_reprojection",
                  "lambda_parameter", "lambda_disparity_smooth")


def check_supported(opt: Dict[str, float]) -> None:
    on = [k for k in SUPPORTED_ZERO if opt.get(k, 0.0) > 0]
    if on or opt.get("distance_type_static", "l1") != "l1":
        raise ValueError(f"the reference loss does not cover {on or opt['distance_type_static']}")


def pixel_grid(h: int, w: int, device) -> torch.Tensor:
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([x, y], -1)


def unproject(intr, depth, pix):
    """Camera points (..., 3) of pixels (..., 2) at depth (...)."""
    u = (pix[..., 0] - intr[..., 2]) / intr[..., 0]
    v = -(pix[..., 1] - intr[..., 3]) / intr[..., 1]
    return torch.stack([u * depth, v * depth, -depth], -1)


def project(pts, intr):
    x = pts[..., 0] / -pts[..., 2] * intr[..., 0] + intr[..., 2]
    y = -(pts[..., 1] / -pts[..., 2]) * intr[..., 1] + intr[..., 3]
    return torch.stack([x, y], -1)


def cam_to_world(pts, ext):
    return torch.einsum("...ij,...j->...i", ext[..., :3], pts) + ext[..., 3]


def world_to_cam(pts, ext):
    return torch.einsum("...ji,...j->...i", ext[..., :3], pts - ext[..., 3])


def bilinear(data, uv):
    """Sample data (B, H, W, C) at pixel coordinates uv (B, H, W, 2)."""
    b, h, w, c = data.shape
    x = uv[..., 0].clamp(0.0, w - 1.0)
    y = uv[..., 1].clamp(0.0, h - 1.0)
    x0 = x.floor().clamp(0, w - 2)
    y0 = y.floor().clamp(0, h - 2)
    rx, ry = (x - x0)[..., None], (y - y0)[..., None]
    flat = data.reshape(b, h * w, c)
    idx = (y0 * w + x0).long().reshape(b, -1)

    def tap(off):
        return torch.gather(flat, 1, (idx + off)[..., None].expand(-1, -1, c)).reshape(uv.shape[:-1] + (c,))

    top = tap(0) * (1 - rx) + tap(1) * rx
    bottom = tap(w) * (1 - rx) + tap(w + 1) * rx
    return top * (1 - ry) + bottom * ry


def weighted_mean(x, wgt):
    b = x.shape[0]
    return (x * wgt).reshape(b, -1).sum(1) / wgt.reshape(b, -1).sum(1).clamp(min=1e-6)


def consistency(depths, ext, intr, warp, flows, masks, opt):
    """Per-pair consistency terms {name: (B,)}. depths (B, 2, H, W)."""
    b, _, h, w = depths.shape
    pix = pixel_grid(h, w, depths.device).expand(b, 2, h, w, 2)
    pix = pix + warp * depths.new_tensor([w / 2.0, h / 2.0])
    pts = unproject(intr[:, :, None, None], depths, pix)
    reproj, disp, ratio = [], [], []
    for k in (0, 1):
        o = 1 - k
        in_tgt = world_to_cam(cam_to_world(pts[:, k], ext[:, k, None, None]), ext[:, o, None, None])
        matched = pix[:, k] + flows[:, k]
        mask = masks[:, k]
        if opt["lambda_static_reprojection"] > 0:
            err = torch.linalg.vector_norm(project(in_tgt, intr[:, o, None, None]) - matched, dim=-1)
            reproj.append(weighted_mean(torch.abs(err / opt["distance_scale"]), mask))
        if opt["lambda_static_disparity"] > 0 or opt["lambda_static_depth_ratio"] > 0:
            warped_z = bilinear(pts[:, o][..., 2:].contiguous(), matched)[..., 0]
        if opt["lambda_static_disparity"] > 0:
            f = intr[:, k, :2].mean(1)
            dd = 1.0 / in_tgt[..., 2] - 1.0 / warped_z
            disp.append(f * weighted_mean(torch.abs(dd / opt["distance_scale"]), mask))
        if opt["lambda_static_depth_ratio"] > 0:
            a, c = torch.abs(warped_z), torch.abs(in_tgt[..., 2])
            r = opt["lambda_static_depth_ratio"] * torch.log(
                torch.minimum(a, c) / torch.maximum(a, c).clamp(min=1e-12))
            ratio.append(weighted_mean(torch.abs(r / opt["distance_scale"]), mask))
    out = {}
    if reproj:
        out["reproj"] = opt["lambda_static_reprojection"] * torch.stack(reproj, -1).mean(-1)
    if disp:
        out["disp"] = opt["lambda_static_disparity"] * torch.stack(disp, -1).mean(-1)
    if ratio:
        out["depth_ratio"] = torch.stack(ratio, -1).mean(-1)
    return out


def contrast(depths_orig, depths, opt):
    """Per-pair contrast loss (B,): hinge on neighbour depth ratios where
    the initial depth has an edge. Shapes (B, 2, H, W)."""
    b, n, h, w = depths.shape
    eps = 1e-10

    def ratios(x):
        x = x.reshape(-1, h, w)
        right = F.pad(x, (0, 1))[:, :, 1:]
        bottom = F.pad(x, (0, 0, 0, 1))[:, 1:, :]
        rh = torch.maximum(right, x) / (torch.minimum(right, x) + eps)
        rv = torch.maximum(bottom, x) / (torch.minimum(bottom, x) + eps)
        rh = torch.cat([rh[:, :, :-1], torch.zeros_like(rh[:, :, -1:])], 2)
        rv = torch.cat([rv[:, :-1, :], torch.zeros_like(rv[:, -1:, :])], 1)
        return rh, rv

    t = opt["lambda_contrast_thresh"]
    rh_p, rv_p = ratios(depths)
    rh_o, rv_o = ratios(depths_orig)
    lh = torch.clamp(torch.square(t - rh_p), min=0.0) * (rh_o > t)
    lv = torch.clamp(torch.square(t - rv_p), min=0.0) * (rv_o > t)
    return opt["lambda_contrast_loss"] * (lh.reshape(b, -1).sum(1) / n + lv.reshape(b, -1).sum(1) / n)


def joint(images_unused, depths_orig, depths, ext, intr, warp, flows, masks, opt):
    """The batch's loss: the mean over its pairs of the summed terms."""
    total = depths.new_zeros(depths.shape[0])
    for v in consistency(depths, ext, intr, warp, flows, masks, opt).values():
        total = total + v
    if opt["lambda_contrast_loss"] > 0:
        total = total + contrast(depths_orig, depths, opt)
    return total.mean()
