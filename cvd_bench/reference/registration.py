"""Plain homography pre-registration of a batch of frame pairs and the
un-warp of the flow afterwards (the reference code's
optical_flow_homography.py: a global homography factors out the camera's
motion, RAFT explains the rest, the flow is un-warped through H^-1 and
resized to color_down).

Keypoints: the minimum eigenvalue of the 3x3 box-summed structure tensor
of Sobel gradients (reflect-101 borders), a 3x3 non-max suppression, an
8-pixel border and the 1024 strongest (ties in index order). Descriptors:
zero-mean, unit-norm 15x15 gray patches (edge padding). Matching frame 2
to frame 1 by products of the descriptors rounded to bfloat16 and summed
in float32, with Lowe's ratio 0.75. RANSAC over a fixed table of 256
four-point hypotheses from the 96 strongest keypoints (numpy generator,
seed 0), inliers within 4 px, then a weighted DLT refit on the winner's
inliers (identity below 8 inliers). Frame 2 is warped into frame 1 with
border-clamped bilinear sampling. Float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

PATCH_RADIUS = 7
RANSAC_ITERS = 256
RANSAC_THRESH = 4.0
LOWE_RATIO = 0.75
MAX_KEYPOINTS = 1024
BORDER = 8


def corner_response(gray):
    """(N, H, W) -> min eigenvalue of the 3x3 structure tensor."""
    pad = F.pad(gray[:, None], (1, 1, 1, 1), mode="reflect")
    sx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=gray.device)
    k = torch.stack([sx, sx.t()])[:, None]
    d = F.conv2d(pad, k)
    dx, dy = d[:, 0], d[:, 1]
    box = torch.ones((3, 1, 3, 3), device=gray.device)
    prods = torch.stack([dx * dx, dx * dy, dy * dy], 1)
    a, b, c = F.conv2d(F.pad(prods, (1, 1, 1, 1), mode="reflect"), box, groups=3).unbind(1)
    return 0.5 * ((a + c) - torch.sqrt((a - c) ** 2 + 4.0 * b * b))


def topk_stable(x, k):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def keypoints(resp, k):
    bsz, h, w = resp.shape
    pooled = F.max_pool2d(resp[:, None], 3, stride=1, padding=1)[:, 0]
    resp = torch.where(resp >= pooled, resp, torch.zeros_like(resp))
    ys = torch.arange(h, device=resp.device)[:, None]
    xs = torch.arange(w, device=resp.device)[None, :]
    inside = (ys >= BORDER) & (ys < h - BORDER) & (xs >= BORDER) & (xs < w - BORDER)
    resp = torch.where(inside, resp, torch.zeros_like(resp))
    vals, idx = topk_stable(resp.reshape(bsz, -1), k)
    return (idx % w).float(), (idx // w).float(), vals > 1e-8


def descriptors(gray, xs, ys):
    r = PATCH_RADIUS
    size = 2 * r + 1
    pad = F.pad(gray[:, None], (r, r, r, r), mode="replicate")[:, 0]
    out = []
    for b in range(gray.shape[0]):
        x, y = xs[b].long(), ys[b].long()
        dy, dx = torch.meshgrid(torch.arange(size, device=gray.device),
                                torch.arange(size, device=gray.device), indexing="ij")
        p = pad[b][y[:, None] + dy.reshape(-1), x[:, None] + dx.reshape(-1)]
        p = p - p.mean(-1, keepdim=True)
        out.append(p / torch.sqrt((p * p).sum(-1, keepdim=True)).clamp(min=1e-8))
    return torch.stack(out)


def hartley(pts, w):
    wsum = w.sum(-1, keepdim=True).clamp(min=1e-6)
    mean = (pts * w[..., None]).sum(-2, keepdim=True) / wsum[..., None]
    c = pts - mean
    rms = torch.sqrt(((c ** 2).sum(-1) * w).sum(-1, keepdim=True) / wsum)
    s = (2.0 ** 0.5) / rms.clamp(min=1e-6)
    T = torch.zeros(pts.shape[:-2] + (3, 3), dtype=pts.dtype, device=pts.device)
    T[..., 0, 0] = s[..., 0]
    T[..., 1, 1] = s[..., 0]
    T[..., 0, 2] = -s[..., 0] * mean[..., 0, 0]
    T[..., 1, 2] = -s[..., 0] * mean[..., 0, 1]
    T[..., 2, 2] = 1.0
    return c * s[..., None], T


def dlt_rows(pa, pb):
    x, y, u, v = pa[..., 0], pa[..., 1], pb[..., 0], pb[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], -1)
    return torch.cat([r1, r2], -2)


def denormalise(hn, ta, tb):
    h = torch.linalg.solve_ex(tb, hn @ ta)[0]
    s = h[..., 2:3, 2:3]
    return h / torch.where(s.abs() > 1e-12, s, torch.ones_like(s))


def dlt4(pa, pb):
    w = torch.ones(pa.shape[:-1], dtype=pa.dtype, device=pa.device)
    na, ta = hartley(pa, w)
    nb, tb = hartley(pb, w)
    a = dlt_rows(na, nb)
    h8, info = torch.linalg.solve_ex(a[..., :8], -a[..., 8:9])
    h8 = torch.where((info == 0)[..., None, None], h8, torch.full_like(h8, float("nan")))[..., 0]
    h = torch.cat([h8, torch.ones_like(h8[..., :1])], -1)
    return denormalise(h.reshape(h.shape[:-1] + (3, 3)), ta, tb)


def dlt_weighted(pa, pb, w):
    na, ta = hartley(pa, w)
    nb, tb = hartley(pb, w)
    a = dlt_rows(na, nb) * torch.cat([w, w], -1)[..., None]
    _, vecs = torch.linalg.eigh(a.transpose(-1, -2) @ a)
    return denormalise(vecs[..., :, 0].reshape(vecs.shape[:-2] + (3, 3)), ta, tb)


def apply_h(h, pts):
    out = torch.einsum("...ij,...kj->...ki", h[..., :, :2], pts) + h[..., None, :, 2]
    z = out[..., 2:]
    return out[..., :2] / torch.where(z.abs() > 1e-12, z, torch.full_like(z, 1e-12))


def hypotheses():
    rng = np.random.default_rng(0)
    order = np.argsort(rng.random((RANSAC_ITERS, min(MAX_KEYPOINTS, 96))), axis=1)
    return order[:, :4].astype(np.int64)


def bilinear_clamped(img, uv):
    """Sample img (B, H, W, C) at pixel uv (B, H, W, 2), clamped to the
    border, the top-left tap within [0, W-2] x [0, H-2]."""
    b, h, w, c = img.shape
    x = uv[..., 0].clamp(0.0, w - 1.0)
    y = uv[..., 1].clamp(0.0, h - 1.0)
    x0 = x.floor().clamp(0, w - 2)
    y0 = y.floor().clamp(0, h - 2)
    rx, ry = (x - x0)[..., None], (y - y0)[..., None]
    flat = img.reshape(b, h * w, c)
    idx = (y0 * w + x0).long().reshape(b, -1)

    def tap(off):
        return torch.gather(flat, 1, (idx + off)[..., None].expand(-1, -1, c)).reshape(uv.shape[:-1] + (c,))

    return (tap(0) * (1 - rx) + tap(1) * rx) * (1 - ry) + (tap(w) * (1 - rx) + tap(w + 1) * rx) * ry


def pixel_grid(h, w, device):
    y, x = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([x, y], -1)


def register(im1, im2):
    """(B, H, W, 3) x2 in [0, 1] -> (H_BA (B, 3, 3) mapping frame 2 to
    frame 1, frame 2 warped into frame 1 (B, H, W, 3))."""
    bsz, h, w, _ = im1.shape
    rgb = torch.stack([im1, im2])
    gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    resp = corner_response(gray.reshape(2 * bsz, h, w)).reshape(2, bsz, h, w)
    x1, y1, v1 = keypoints(resp[0], MAX_KEYPOINTS)
    x2, y2, v2 = keypoints(resp[1], MAX_KEYPOINTS)
    d1 = descriptors(gray[0], x1, y1)
    d2 = descriptors(gray[1], x2, y2)
    sim = d2.bfloat16().float() @ d1.bfloat16().float().transpose(1, 2)
    sim = torch.where(v1[:, None, :], sim, torch.full_like(sim, float("-inf")))
    top2, idx2 = topk_stable(sim, 2)
    dd1 = torch.sqrt((2.0 - 2.0 * top2[..., 0]).clamp(min=0.0))
    dd2 = torch.sqrt((2.0 - 2.0 * top2[..., 1]).clamp(min=0.0))
    wgt = ((dd1 < LOWE_RATIO * dd2) & v2).float()
    pa = torch.stack([x2, y2], -1)
    pb = torch.gather(torch.stack([x1, y1], -1), 1, idx2[..., 0:1].expand(-1, -1, 2))
    sel = torch.as_tensor(hypotheses(), device=im1.device)
    ok_hyp = (wgt[:, sel] > 0).all(-1)
    hs = dlt4(pa[:, sel], pb[:, sel])
    err = torch.linalg.vector_norm(apply_h(hs, pa[:, None].expand(-1, RANSAC_ITERS, -1, -1))
                                   - pb[:, None], dim=-1)
    inl = (err < RANSAC_THRESH) & (wgt[:, None] > 0)
    counts = torch.where(ok_hyp, inl.sum(-1), torch.full_like(inl.sum(-1), -1))
    best = inl[torch.arange(bsz, device=im1.device), counts.argmax(1)].float()
    hfit = dlt_weighted(pa, pb, best)
    ok = (best.sum(-1) >= 8) & torch.isfinite(hfit).all(-1).all(-1)
    eye = torch.eye(3, device=im1.device).expand(bsz, 3, 3)
    h_ba = torch.where(ok[:, None, None], hfit, eye)
    pix = pixel_grid(h, w, im1.device).reshape(1, -1, 2).expand(bsz, -1, -1)
    src = apply_h(torch.linalg.inv_ex(h_ba)[0], pix).reshape(bsz, h, w, 2)
    return h_ba, bilinear_clamped(im2, src)


def unwarp_and_resize(flows, h_ba, out_hw):
    """Flows (B, h, w, 2) between frame 1 and the registered frame 2 ->
    flows of the true pairs at out_hw: each matched point mapped through
    H^-1, then an antialiased bilinear resize with the vectors rescaled."""
    b, h, w, _ = flows.shape
    pix = pixel_grid(h, w, flows.device)
    matched = (pix + flows).reshape(b, -1, 2)
    flows = apply_h(torch.linalg.inv_ex(h_ba)[0], matched).reshape(b, h, w, 2) - pix
    oh, ow = out_hw
    out = F.interpolate(flows.permute(0, 3, 1, 2), size=(oh, ow), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1) * flows.new_tensor([ow / w, oh / h])
