"""Quality harness (PyTorch): warp photo-consistency and golden scenes.

Port of robust_cvd_tpu/quality.py, plus the static gate of bench.py
(`quality_gate`, as `static_quality_gate` here). The quality metric is
warp photo-consistency: how well frame i's colours are reproduced by
warping frame j through frame i's depth and the camera poses. On an
analytic golden scene (a slanted textured plane, exact ray-plane depth) the
ground truth scores near zero, corrupted depth scores worse, and each gate
measures how much of that gap the pose/deformation solver closes:

  - static_quality_gate: per-frame depth scale corruption, exact pair
    constraints, the default solve;
  - dynamic_solver_gate: a moving object (dynamic masks, adaptive
    deformation cost), scene-flow triplets, a per-frame image distortion
    and the deferred bicubic spatial solve, plus a dedicated warp-recovery
    solve through `_solve_step` with fixed poses and depth transforms;
  - contaminated_constraint_gate: constraints that track the moving object,
    solved with and without the dynamic-constraint exclusion
    (set_static_flags + prune_static_flag).

Every gate takes `tiny` (6 frames at 48x64 instead of 8 at 96x128, with
smaller solver caps) and `device` ("cuda" unless the caller asks for
"cpu"): the scenes, the scoring and the solves run there; the constraint
sampling draws from numpy's default_rng on the host in the JAX package's
order, so both packages sample the same constraints.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .device import float32_precision, resolve_device
from .ops import geometry


class PhotoConsistency(NamedTuple):
    l1: torch.Tensor  # mean absolute colour error over valid pixels
    rmse: torch.Tensor
    valid_ratio: torch.Tensor  # share of pixels that land in bounds


def pair_photo_consistency(
    image_i: torch.Tensor,  # (..., H, W, C)
    image_j: torch.Tensor,
    depth_i: torch.Tensor,  # (..., H, W)
    ext_i: torch.Tensor,  # (..., 3, 4) camera-to-world
    ext_j: torch.Tensor,
    intr_i: torch.Tensor,  # (..., 4) px (fx, fy, cx, cy)
    intr_j: torch.Tensor,
    mask_i: Optional[torch.Tensor] = None,  # (..., H, W) weight in [0, 1]
) -> PhotoConsistency:
    """Warp frame j into frame i through depth_i; the masked photometric
    error, per leading index (one pair, or a batch of pairs)."""
    h, w = depth_i.shape[-2:]
    uv = geometry.warping_field(ext_i, intr_i, depth_i, ext_j, intr_j)
    warped = geometry.grid_sample(image_j, uv)
    inb = (
        (uv[..., 0] >= 0.0) & (uv[..., 0] <= w - 1.0)
        & (uv[..., 1] >= 0.0) & (uv[..., 1] <= h - 1.0)
    ).float()
    wgt = inb if mask_i is None else inb * mask_i
    diff = (warped - image_i).abs().mean(-1)
    sq = ((warped - image_i) ** 2).mean(-1)
    denom = wgt.sum((-2, -1)).clamp_min(1.0)
    return PhotoConsistency(
        l1=(diff * wgt).sum((-2, -1)) / denom,
        rmse=torch.sqrt((sq * wgt).sum((-2, -1)) / denom),
        valid_ratio=wgt.mean((-2, -1)),
    )


def clip_photo_consistency(
    images: torch.Tensor,  # (N, H, W, C)
    depth: torch.Tensor,  # (N, H, W)
    extrinsics: torch.Tensor,  # (N, 3, 4)
    intrinsics: torch.Tensor,  # (N, 4)
    pairs: Sequence[Tuple[int, int]],
    masks: Optional[torch.Tensor] = None,  # (P, H, W)
) -> PhotoConsistency:
    """Mean photo-consistency over frame pairs, all pairs in one batched
    computation."""
    idx = torch.as_tensor(np.asarray(pairs, np.int64), device=images.device)
    i, j = idx[:, 0], idx[:, 1]
    res = pair_photo_consistency(
        images[i], images[j], depth[i], extrinsics[i], extrinsics[j],
        intrinsics[i], intrinsics[j], masks,
    )
    return PhotoConsistency(*[v.mean() for v in res])


# ---------------------------------------------------------------------------
# Golden scene: slanted textured plane, translating camera, analytic depth.
# ---------------------------------------------------------------------------


class GoldenScene(NamedTuple):
    images: torch.Tensor  # (N, H, W, 3)
    depth: torch.Tensor  # (N, H, W) ground truth
    extrinsics: torch.Tensor  # (N, 3, 4)
    intrinsics: torch.Tensor  # (N, 4)
    pairs: list


def _texture(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Smooth procedural RGB texture (C-infinity, so resampling error is tiny)."""
    r = 0.5 + 0.25 * torch.sin(3.1 * x) * torch.cos(2.3 * y) + 0.15 * torch.sin(7.7 * (x + y))
    g = 0.5 + 0.25 * torch.cos(2.1 * x + 1.0) * torch.sin(3.7 * y) + 0.15 * torch.cos(5.3 * (x - y))
    b = 0.5 + 0.25 * torch.sin(4.3 * x * 0.7 + 2.0) * torch.sin(2.9 * y + 1.0)
    return torch.stack([r, g, b], -1)


def _world_rays(ext: torch.Tensor, intr: torch.Tensor, shape) -> torch.Tensor:
    """World-space ray directions (N, H, W, 3) of every pixel (z = -1 in
    the camera)."""
    rays = geometry.pixels_to_rays(
        geometry.pixel_grid(shape, ext.device), intr[:, None, None, :]
    )
    return (ext[:, None, None, :, :3] * rays[..., None, :]).sum(-1)


def golden_scene(
    num_frames: int = 8,
    shape: Tuple[int, int] = (96, 128),
    focal: float = 0.5,  # tan(vfov / 2)
    plane_depth: float = 3.0,
    slant: Tuple[float, float] = (0.15, 0.1),
    baseline: float = 0.08,
    yaw_per_frame: float = 0.0,
    device="cpu",
) -> GoldenScene:
    """Cameras at (i * baseline, 0, 0), yawed by i * yaw_per_frame about +Y,
    looking down -Z; the plane z_w = -(plane_depth + a x_w + b y_w).
    Per-pixel ray-plane intersection gives exact depth (the camera-frame z
    distance); the images sample the analytic texture at the hit point."""
    h, w = shape
    a, b = slant
    vfov = 2.0 * np.arctan(focal)
    hfov = 2.0 * np.arctan(focal * w / h)
    intr = geometry.intrinsics_px(
        torch.full((num_frames,), vfov, device=device),
        torch.full((num_frames,), hfov, device=device),
        shape,
    )
    steps = torch.arange(num_frames, dtype=torch.float32, device=device)
    zero = torch.zeros_like(steps)
    positions = torch.stack([steps * baseline, zero, zero], -1)
    yaw = steps * yaw_per_frame
    c, s = torch.cos(yaw), torch.sin(yaw)
    one = torch.ones_like(yaw)
    rot = torch.stack([
        torch.stack([c, zero, s], -1),
        torch.stack([zero, one, zero], -1),
        torch.stack([-s, zero, c], -1),
    ], -2)  # (N, 3, 3) camera-to-world yaw about +Y
    ext = torch.cat([rot, positions[:, :, None]], 2)

    d = _world_rays(ext, intr, shape)
    # plane: z_w + plane_depth + a x_w + b y_w = 0 along p + t d
    denom = d[..., 2] + a * d[..., 0] + b * d[..., 1]
    denom = torch.where(denom.abs() < 1e-3,
                        torch.where(denom < 0, -1e-3, 1e-3), denom)
    pos = positions[:, None, None]
    t = -(pos[..., 2] + plane_depth + a * pos[..., 0] + b * pos[..., 1]) / denom
    hit = pos + t[..., None] * d
    pairs = [(i, i + 1) for i in range(num_frames - 1)] + [
        (i, i + 2) for i in range(num_frames - 2)
    ]
    return GoldenScene(images=_texture(hit[..., 0], hit[..., 1]), depth=t,
                       extrinsics=ext, intrinsics=intr, pairs=pairs)


# ---------------------------------------------------------------------------
# Dynamic golden scene: the static plane plus a translating textured object
# with per-frame dynamic masks (reference cost families
# lib/PoseOptimizer.cpp:321-423, 536-656, 874-887).
# ---------------------------------------------------------------------------


class DynamicGoldenScene(NamedTuple):
    images: torch.Tensor  # (N, H, W, 3)
    depth: torch.Tensor  # (N, H, W) ground truth (object depth where visible)
    extrinsics: torch.Tensor  # (N, 3, 4)
    intrinsics: torch.Tensor  # (N, 4)
    pairs: list
    static_mask: torch.Tensor  # (N, H, W) bool, True = static


def golden_scene_dynamic(
    num_frames: int = 8,
    shape: Tuple[int, int] = (96, 128),
    focal: float = 0.5,
    plane_depth: float = 3.0,
    slant: Tuple[float, float] = (0.15, 0.1),
    baseline: float = 0.08,
    obj_depth: float = 1.8,
    obj_half: Tuple[float, float] = (0.28, 0.22),
    obj_vel: float = 0.12,
    device="cpu",
) -> DynamicGoldenScene:
    """The golden_scene rig plus a fronto-parallel textured square at world
    z = -obj_depth whose centre moves +x by obj_vel a frame, its texture
    moving with it; static_mask is False exactly on the object's pixels."""
    base = golden_scene(num_frames=num_frames, shape=shape, focal=focal,
                        plane_depth=plane_depth, slant=slant, baseline=baseline,
                        device=device)
    hw, hh = obj_half
    cx0, cy = -0.15, 0.05  # the centre starts left of the path's centre

    d = _world_rays(base.extrinsics, base.intrinsics, shape)
    pos = base.extrinsics[:, None, None, :, 3]
    dz = torch.where(d[..., 2].abs() < 1e-6, -1e-6, d[..., 2])
    t_o = -(pos[..., 2] + obj_depth) / dz
    hit = pos + t_o[..., None] * d
    fidx = torch.arange(num_frames, dtype=torch.float32, device=base.depth.device)
    cx = (cx0 + fidx * obj_vel)[:, None, None]
    inside = ((hit[..., 0] - cx).abs() < hw) & ((hit[..., 1] - cy).abs() < hh) & (t_o > 0.0)
    tex = _texture((hit[..., 0] - cx) * 6.0 + 9.0, hit[..., 1] * 6.0 + 4.0)
    occ = inside & (t_o < base.depth)  # the object occludes the plane
    return DynamicGoldenScene(
        images=torch.where(occ[..., None], tex, base.images),
        depth=torch.where(occ, t_o, base.depth),
        extrinsics=base.extrinsics,
        intrinsics=base.intrinsics,
        pairs=base.pairs,
        static_mask=~occ,
    )


# ---------------------------------------------------------------------------
# Gates.
# ---------------------------------------------------------------------------


def _scene_size(tiny: bool):
    return (6, (48, 64)) if tiny else (8, (96, 128))


def _gate_opt(tiny: bool, **kw):
    from .config import PoseOptParams

    return PoseOptParams(
        num_steps=2 if tiny else 3,
        ctf_long=3 if tiny else 5,
        ctf_short=2 if tiny else 3,
        lm_max_outer=6 if tiny else 12,
        lm_cg_iters=12 if tiny else 24,
        graduate_deformation_regularization=True,
        **kw,
    )


def _median(depth: np.ndarray) -> np.ndarray:
    return np.median(depth.reshape(depth.shape[0], -1), 1).astype(np.float32)


def _solved_geometry(solved, corrupted: torch.Tensor, aspect: float):
    """(corrected depth, extrinsics, intrinsics) of a solve: the corrupted
    depth times the solved scale maps, and the solved cameras."""
    from .camera import pose_params_to_camera, quat_to_matrix
    from .solver import xforms
    from .solver.xforms import GridSpec

    h, w = corrupted.shape[1:]
    gz, gy, gx = solved.depth_grid.shape[1:]
    spec = GridSpec(gx=gx, gy=gy, gz=gz)
    scales = torch.stack([
        xforms.depth_param_map(g, spec, (h, w), d)
        for g, d in zip(solved.depth_grid, corrupted)
    ])
    cam = pose_params_to_camera(solved.pose, solved.focal, aspect)
    ext = torch.cat([quat_to_matrix(cam.quaternion), cam.position[:, :, None]], 2)
    return corrupted * scales, ext, geometry.intrinsics_px(cam.vfov, cam.hfov, (h, w))


def _static_pair_masks(scene: DynamicGoldenScene) -> torch.Tensor:
    """(P, H, W) eval masks: static in i AND, warped by the truth, static in j."""
    idx = torch.as_tensor(np.asarray(scene.pairs, np.int64), device=scene.depth.device)
    i, j = idx[:, 0], idx[:, 1]
    uv = geometry.warping_field(
        scene.extrinsics[i], scene.intrinsics[i], scene.depth[i],
        scene.extrinsics[j], scene.intrinsics[j],
    )
    static = scene.static_mask.float()
    sj = geometry.grid_sample(static[j][..., None], uv)[..., 0]
    return static[i] * (sj > 0.99)


def _gap_closed(solved: float, gt: float, bad: float) -> float:
    return round(float(1.0 - (solved - gt) / max(bad - gt, 1e-9)), 4)


def static_quality_gate(tiny: bool = False, device="cuda") -> dict:
    """Golden-scene photo-consistency (bench.py::quality_gate): the ground
    truth's error, the error with per-frame depth scales drawn from
    default_rng(0) in 0.7-1.4, and the error after the default pose solve
    from 64 exact constraints a pair; `quality_gap_closed` is the share of
    the gap the solve closes."""
    from .solver import pose_opt
    from .solver.pose_opt import PoseOptInputs
    from .solver.residuals import ConstraintData

    device = resolve_device(device)
    num_frames, shape = _scene_size(tiny)
    scene = golden_scene(num_frames=num_frames, shape=shape, device=device)
    n = scene.images.shape[0]
    h, w = shape
    aspect = w / h
    rng = np.random.default_rng(0)
    frame_scale = rng.uniform(0.7, 1.4, n).astype(np.float32)
    corrupted = scene.depth * torch.as_tensor(1.0 / frame_scale, device=device)[:, None, None]

    pairs = scene.pairs
    pair = np.asarray(pairs, np.int64)
    p_count, c_count = len(pairs), 64
    xs = rng.uniform(3, w - 4, (p_count, c_count)).astype(np.float32)
    ys = rng.uniform(3, h - 4, (p_count, c_count)).astype(np.float32)
    depth_np = scene.depth.cpu().numpy()
    depth_gt0 = np.stack([
        depth_np[i][np.round(ys[p]).astype(int), np.round(xs[p]).astype(int)]
        for p, (i, _) in enumerate(pairs)
    ])

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    i_t, j_t = t(pair[:, 0]), t(pair[:, 1])
    pts = geometry.pixels_to_points(
        scene.intrinsics[i_t][:, None, :], t(depth_gt0), t(np.stack([xs, ys], -1))
    )
    pts_j = geometry.reproject_points(
        pts, scene.extrinsics[i_t][:, None], scene.extrinsics[j_t][:, None]
    )
    loc1_px = geometry.project(pts_j, scene.intrinsics[j_t][:, None, :]).cpu().numpy()
    depth_gt1 = (-pts_j[..., 2]).cpu().numpy()

    def to_ndc(x, y):
        return np.stack([x / (w - 1) * 2 - 1, -(y / (h - 1) * 2 - 1)], -1).astype(np.float32)

    data = ConstraintData(
        pair=t(pair),
        loc0=t(to_ndc(xs, ys)),
        loc1=t(to_ndc(loc1_px[..., 0], loc1_px[..., 1])),
        depth0=t(depth_gt0 / frame_scale[pair[:, 0], None]),
        depth1=t(depth_gt1 / frame_scale[pair[:, 1], None]),
        weight=torch.ones((p_count, c_count), device=device),
    )
    inputs = PoseOptInputs(
        data=data, median_depth=t(_median(corrupted.cpu().numpy())),
        aspect=aspect, num_frames=n,
    )
    solved = pose_opt.run(_gate_opt(tiny), inputs)
    corrected, ext, intr = _solved_geometry(solved, corrupted, aspect)

    def m(depth, e=None, i=None):
        return float(clip_photo_consistency(
            scene.images, depth,
            scene.extrinsics if e is None else e,
            scene.intrinsics if i is None else i,
            scene.pairs,
        ).l1)

    gt, bad = m(scene.depth), m(corrupted)
    solved_err = m(corrected, ext, intr)
    return {
        "photo_consistency_gt_l1": round(gt, 6),
        "photo_consistency_corrupted_l1": round(bad, 6),
        "photo_consistency_solved_l1": round(solved_err, 6),
        "quality_gap_closed": _gap_closed(solved_err, gt, bad),
    }


def dynamic_solver_gate(tiny: bool = False, rng_seed: int = 0, device="cuda") -> dict:
    """Gate of the DYNAMIC solver machinery (robust_cvd_tpu/quality.py
    ::dynamic_solver_gate): a moving textured object (dynamic masks ->
    AdaptiveDeformationCost), scene-flow triplets and a per-frame bilinear
    NDC distortion of every observation, solved with adaptive deformation,
    triplet smoothness and the deferred spatial solve; scored on static
    pixels against the ground truth and against the floor the distortion
    leaves (GT depth and poses scored with the distortion in), plus a
    dedicated solve with poses and depth transforms fixed whose bicubic
    spatial grid must recover the (frame-centred) distortion."""
    from .config import PoseOptParams
    from .solver import pose_opt, xforms
    from .solver.pose_opt import PoseOptInputs, _solve_step
    from .solver.residuals import ConstraintData, SolverParams, TripletData

    device = resolve_device(device)
    num_frames, shape = _scene_size(tiny)
    scene = golden_scene_dynamic(num_frames=num_frames, shape=shape, device=device)
    n = scene.images.shape[0]
    h, w = shape
    aspect = w / h
    rng = np.random.default_rng(rng_seed)
    frame_scale = rng.uniform(0.7, 1.4, n).astype(np.float32)
    corrupted = scene.depth * torch.as_tensor(1.0 / frame_scale, device=device)[:, None, None]
    static = scene.static_mask.cpu().numpy()
    depth_np = scene.depth.cpu().numpy()

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    # per-frame corner handles of the distortion: the joint gate uses a mild
    # amplitude, the dedicated warp-recovery solve a strong one (see the
    # JAX package for why the field is per frame)
    corners = rng.uniform(-1.0, 1.0, (n, 2, 2, 2)).astype(np.float32)
    corners_t = t(corners)
    joint_amp, warp_amp = 0.006, 0.02

    def distort(loc, frames, amp, table=corners):
        """loc (..., 2) NDC and frame indices broadcastable to loc's leading
        shape -> (loc + amp * w_frame(loc), amp * w_frame(loc)), bilinear in
        (x, y); numpy or torch as `table`."""
        u = (loc[..., 0] + 1.0) / 2.0
        v = (1.0 - loc[..., 1]) / 2.0  # NDC y is up; corner row 0 = top
        cf = table[frames] * amp
        disp = (
            cf[..., 0, 0, :] * ((1 - u) * (1 - v))[..., None]
            + cf[..., 0, 1, :] * (u * (1 - v))[..., None]
            + cf[..., 1, 0, :] * ((1 - u) * v)[..., None]
            + cf[..., 1, 1, :] * (u * v)[..., None]
        )
        return loc + disp, disp

    def to_ndc(x, y):
        return np.stack([x / (w - 1) * 2 - 1, -(y / (h - 1) * 2 - 1)], -1).astype(np.float32)

    def sample_static_px(count, frames, margin=2):
        """Pixels static (with a margin) in every frame of `frames`."""
        ok_mask = np.ones((h, w), bool)
        for f in frames:
            m = static[f]
            for _ in range(margin):  # erode by a min-filter
                m = (m[:-2, 1:-1] & m[2:, 1:-1] & m[1:-1, :-2] & m[1:-1, 2:]
                     & m[1:-1, 1:-1])
                m = np.pad(m, 1, constant_values=False)
            ok_mask &= m
        ys, xs = np.nonzero(ok_mask[3 : h - 3, 3 : w - 3])
        idx = rng.choice(len(ys), size=count, replace=len(ys) < count)
        return xs[idx] + 3.0, ys[idx] + 3.0

    def gt_project(f_from, f_to, x, y):
        """GT reprojection of pixels (x, y) of f_from into f_to: (pixels
        (C, 2), depth in f_from (C,), depth in f_to (C,))."""
        d0 = depth_np[f_from][np.round(y).astype(int), np.round(x).astype(int)]
        pts = geometry.pixels_to_points(
            scene.intrinsics[f_from][None, :], t(d0),
            t(np.stack([x, y], -1).astype(np.float32)),
        )
        pts_j = geometry.reproject_points(
            pts, scene.extrinsics[f_from][None], scene.extrinsics[f_to][None]
        )
        pix_j = geometry.project(pts_j, scene.intrinsics[f_to][None, :]).cpu().numpy()
        return pix_j, d0, (-pts_j[..., 2]).cpu().numpy()

    # ---- pair constraints (static, distorted observations) ---------------
    pairs = scene.pairs
    pair = np.asarray(pairs, np.int64)
    p_count, c_count = len(pairs), 32 if tiny else 64
    loc0 = np.zeros((p_count, c_count, 2), np.float32)
    loc1 = np.zeros((p_count, c_count, 2), np.float32)
    depth0 = np.zeros((p_count, c_count), np.float32)
    depth1 = np.zeros((p_count, c_count), np.float32)
    for p, (i, j) in enumerate(pairs):
        xs, ys = sample_static_px(c_count, (i, j))
        pix_j, d0, d1 = gt_project(i, j, xs, ys)
        loc0[p] = to_ndc(xs, ys)
        loc1[p] = to_ndc(pix_j[:, 0], pix_j[:, 1])
        depth0[p] = d0 / frame_scale[i]
        depth1[p] = d1 / frame_scale[j]
    loc0_d, _ = distort(loc0, pair[:, 0][:, None], joint_amp)
    loc1_d, _ = distort(loc1, pair[:, 1][:, None], joint_amp)
    data = ConstraintData(
        pair=t(pair), loc0=t(loc0_d), loc1=t(loc1_d), depth0=t(depth0), depth1=t(depth1),
        weight=torch.ones((p_count, c_count), device=device),
    )

    # ---- triplet constraints (scene-flow smoothness) ----------------------
    centers = list(range(1, n - 1))
    t_count, ct = len(centers), 24 if tiny else 48
    tloc = np.zeros((t_count, ct, 3, 2), np.float32)
    tdepth = np.zeros((t_count, ct, 3), np.float32)
    for k, f in enumerate(centers):
        xs, ys = sample_static_px(ct, (f - 1, f, f + 1))
        pix_b, d_c, d_b = gt_project(f, f - 1, xs, ys)
        pix_f, _, d_f = gt_project(f, f + 1, xs, ys)
        tloc[k, :, 0] = to_ndc(pix_b[:, 0], pix_b[:, 1])
        tloc[k, :, 1] = to_ndc(xs, ys)
        tloc[k, :, 2] = to_ndc(pix_f[:, 0], pix_f[:, 1])
        tdepth[k, :, 0] = d_b / frame_scale[f - 1]
        tdepth[k, :, 1] = d_c / frame_scale[f]
        tdepth[k, :, 2] = d_f / frame_scale[f + 1]
    cent = np.asarray(centers, np.int64)
    tframes = np.stack([cent - 1, cent, cent + 1], -1)
    tloc_d, _ = distort(tloc, tframes[:, None, :], joint_amp)
    triplets = TripletData(
        frame=t(cent), loc=t(tloc_d), depth=t(tdepth),
        weight=torch.ones((t_count, ct), device=device),
    )

    inputs = PoseOptInputs(
        data=data,
        median_depth=t(_median(corrupted.cpu().numpy())),
        aspect=aspect,
        num_frames=n,
        triplets=triplets,
        dynamic_mask=(static * 255).astype(np.uint8),  # white = static
    )
    opt = _gate_opt(
        tiny, smooth_static_weight=0.5, adaptive_deformation_cost=1.0,
        deferred_spatial_opt=True, dso_long=4, dso_short=3,
    )
    solved = pose_opt.run(opt, inputs)
    corrected, ext, intr = _solved_geometry(solved, corrupted, aspect)

    masks = _static_pair_masks(scene)

    def m(depth, e=None, i=None):
        return float(clip_photo_consistency(
            scene.images, depth,
            scene.extrinsics if e is None else e,
            scene.intrinsics if i is None else i,
            scene.pairs, masks=masks,
        ).l1)

    gt, bad = m(scene.depth), m(corrupted)
    solved_err = m(corrected, ext, intr)

    # ---- the irreducible floor: GT depth and poses, scored with the
    # relative distortion w_j(q) - w_i(p) the solver can never remove
    idx = t(pair)
    i_t, j_t = idx[:, 0], idx[:, 1]
    uv = geometry.warping_field(
        scene.extrinsics[i_t], scene.intrinsics[i_t], scene.depth[i_t],
        scene.extrinsics[j_t], scene.intrinsics[j_t],
    )  # (P, H, W, 2) pixels in frame j
    pix_ndc_grid = np.stack(
        np.meshgrid(np.linspace(-1, 1, w), np.linspace(1, -1, h)), -1
    ).astype(np.float32)
    uv_ndc = torch.stack(
        [uv[..., 0] / (w - 1) * 2 - 1, -(uv[..., 1] / (h - 1) * 2 - 1)], -1
    )
    frames_i = i_t[:, None, None].expand(-1, h, w)
    frames_j = j_t[:, None, None].expand(-1, h, w)
    _, w_i = distort(t(pix_ndc_grid), frames_i, joint_amp, corners_t)
    _, w_j = distort(uv_ndc, frames_j, joint_amp, corners_t)
    dw = w_j - w_i
    uv2 = uv + torch.stack([dw[..., 0] * (w - 1) / 2, -dw[..., 1] * (h - 1) / 2], -1)
    warped = geometry.grid_sample(scene.images[j_t], uv2)
    inb = (
        (uv2[..., 0] >= 0.0) & (uv2[..., 0] <= w - 1.0)
        & (uv2[..., 1] >= 0.0) & (uv2[..., 1] <= h - 1.0)
    ).float()
    wgt = inb * masks
    diff = (warped - scene.images[i_t]).abs().mean(-1)
    floor = float(((diff * wgt).sum((1, 2)) / wgt.sum((1, 2)).clamp_min(1.0)).mean())

    # ---- dedicated spatial-warp recovery solve: GT poses and depths, the
    # distortion the only corruption, poses and depth transforms fixed; the
    # deferred bicubic stage must learn about -w (reference
    # lib/PoseOptimizer.cpp:874-887)
    depth0_gt = depth0 * frame_scale[pair[:, 0], None]
    depth1_gt = depth1 * frame_scale[pair[:, 1], None]
    loc0_w, _ = distort(loc0, pair[:, 0][:, None], warp_amp)
    loc1_w, _ = distort(loc1, pair[:, 1][:, None], warp_amp)
    data_w = data._replace(loc0=t(loc0_w), loc1=t(loc1_w),
                           depth0=t(depth0_gt), depth1=t(depth1_gt))
    inputs_w = PoseOptInputs(data=data_w, median_depth=t(_median(depth_np)),
                             aspect=aspect, num_frames=n)
    pose_gt = np.zeros((n, 6), np.float32)
    pose_gt[:, :3] = scene.extrinsics[:, :, 3].cpu().numpy()
    dso_rows, dso_cols = (3, 4) if aspect >= 1.0 else (4, 3)
    # solver focal = tan(vfov / 2); intrinsics_px has fy = H / 2 / tan(vfov / 2)
    vfocal = float(h / 2.0 / scene.intrinsics[0, 1].item())
    params_w = SolverParams(
        pose=t(pose_gt),
        focal=torch.full((n,), vfocal, device=device),
        depth_grid=torch.ones((n, 1, 1, 1), device=device),
        spatial_grid=xforms.init_spatial_grid(n, dso_rows, dso_cols, device),
    )
    opt_w = PoseOptParams(
        fix_poses=True, fix_depth_transforms=True,
        lm_max_outer=8 if tiny else 15, lm_cg_iters=16 if tiny else 32,
    )
    with float32_precision(cudnn_tf32=False):
        solved_w = _solve_step(
            opt_w, inputs_w, params_w,
            depth_deform_weight=opt_w.deformation_regularization_final,
            spatial_cubic=True,
        )

    _, w_gt = distort(
        np.broadcast_to(pix_ndc_grid, (n, h, w, 2)), np.arange(n)[:, None, None], warp_amp
    )
    warp_maps = torch.stack([
        xforms.spatial_warp_map(g, cubic=True, shape=(h, w)) for g in solved_w.spatial_grid
    ]).cpu().numpy()
    # a frame-shared warp is a gauge direction (it cancels in the pairwise
    # residuals), so the frame-centred fields are compared
    target = -w_gt
    target_c = target - target.mean(axis=0, keepdims=True)
    solved_c = warp_maps - warp_maps.mean(axis=0, keepdims=True)
    resid = float(np.mean(np.abs(solved_c - target_c)))
    w_mag = float(np.mean(np.abs(target_c)))
    return {
        "photo_consistency_gt_l1_dynamic": round(gt, 6),
        "photo_consistency_corrupted_l1_dynamic": round(bad, 6),
        "photo_consistency_solved_l1_dynamic": round(solved_err, 6),
        "photo_consistency_floor_l1_dynamic": round(floor, 6),
        "quality_gap_closed_dynamic": _gap_closed(solved_err, gt, bad),
        "quality_gap_closed_dynamic_vs_floor": round(
            float(1.0 - max(solved_err - floor, 0.0) / max(bad - floor, 1e-9)), 4
        ),
        "spatial_warp_recovery": round(1.0 - resid / max(w_mag, 1e-9), 4),
    }


def contaminated_constraint_gate(tiny: bool = False, rng_seed: int = 0,
                                 device="cuda") -> dict:
    """Gate of DYNAMIC-CONSTRAINT EXCLUSION (robust_cvd_tpu/quality.py
    ::contaminated_constraint_gate): a quarter of each pair's constraints
    track the moving object's texture, as real flow would. The same solve
    runs through the production exclusion path (set_static_flags from the
    dynamic masks' distance transforms, prune_static_flag, zero weights in
    flatten_pairs; reference lib/FlowConstraints.cpp:573-748,
    PoseOptimizer.cpp:1177-1193) and once more without it: the gap closed
    with exclusion should stay near the clean gate's, without it far
    below."""
    from .solver import constraints as C
    from .solver import pose_opt
    from .solver.pose_opt import PoseOptInputs

    device = resolve_device(device)
    num_frames, shape = _scene_size(tiny)
    scene = golden_scene_dynamic(num_frames=num_frames, shape=shape, device=device)
    n = scene.images.shape[0]
    h, w = shape
    aspect = w / h
    inv_aspect = h / w
    obj_vel = 0.12  # golden_scene_dynamic's default, world units a frame
    rng = np.random.default_rng(rng_seed)
    frame_scale = rng.uniform(0.7, 1.4, n).astype(np.float32)
    corrupted = scene.depth * torch.as_tensor(1.0 / frame_scale, device=device)[:, None, None]
    corrupted_np = corrupted.cpu().numpy()
    static = scene.static_mask.cpu().numpy()
    ext_np = scene.extrinsics.cpu().numpy()
    depth_np = scene.depth.cpu().numpy()

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    def project(f_to, pts_w):
        """World points -> (pixels (C, 2), camera depth (C,)) in frame f_to
        (the rig's rotations are the identity)."""
        cam = pts_w - ext_np[f_to][:, 3]
        pix = geometry.project(t(cam.astype(np.float32)), scene.intrinsics[f_to][None, :])
        return pix.cpu().numpy(), -cam[:, 2]

    def hit_points(f, xs, ys):
        """World hit points and depth of pixels (xs, ys) of frame f from the
        rendered depth (the object's hit on the object)."""
        d = depth_np[f, np.round(ys).astype(int), np.round(xs).astype(int)]
        pts = geometry.pixels_to_points(
            scene.intrinsics[f][None, :], t(d), t(np.stack([xs, ys], -1).astype(np.float32))
        )
        return pts.cpu().numpy() + ext_np[f][:, 3], d

    def sample_px(f, count, on_object):
        mask = ~static[f] if on_object else static[f]
        ys, xs = np.nonzero(mask[3 : h - 3, 3 : w - 3])
        if len(ys) == 0:
            return np.zeros(0), np.zeros(0)
        idx = rng.choice(len(ys), size=count, replace=len(ys) < count)
        return (xs[idx] + 3).astype(np.float64), (ys[idx] + 3).astype(np.float64)

    # ---- pair constraints with a contaminated share -----------------------
    c_per = 32 if tiny else 64
    n_dyn = c_per // 4  # a quarter track the moving object
    pair_keys = list(scene.pairs)
    pair_dict = {}
    for (i, j) in pair_keys:
        xs, ys = sample_px(i, c_per - n_dyn, on_object=False)
        pix_j, _ = project(j, hit_points(i, xs, ys)[0])
        xo, yo = sample_px(i, n_dyn, on_object=True)
        pts_o, _ = hit_points(i, xo, yo)
        pix_oj, _ = project(j, pts_o + np.array([obj_vel * (j - i), 0.0, 0.0]))
        loc0_px = np.concatenate([np.stack([xs, ys], -1), np.stack([xo, yo], -1)])
        loc1_px = np.concatenate([pix_j, pix_oj])
        ok = (
            (loc1_px[:, 0] >= 0) & (loc1_px[:, 0] <= w - 1)
            & (loc1_px[:, 1] >= 0) & (loc1_px[:, 1] <= h - 1)
        )
        # normalized [0, 1] x [0, inv_aspect]: both coordinates over W
        pair_dict[(i, j)] = C.PairConstraints(
            loc0=(loc0_px[ok] / w).astype(np.float32),
            loc1=(loc1_px[ok] / w).astype(np.float32),
            is_static=np.ones(int(ok.sum()), bool),
        )

    med = t(_median(corrupted_np))
    opt = _gate_opt(tiny)
    masks = _static_pair_masks(scene)

    def score(depth, e=None, i=None):
        return float(clip_photo_consistency(
            scene.images, depth,
            scene.extrinsics if e is None else e,
            scene.intrinsics if i is None else i,
            pair_keys, masks=masks,
        ).l1)

    def solve(exclude: bool) -> float:
        pd = {
            k: C.PairConstraints(loc0=pc.loc0.copy(), loc1=pc.loc1.copy(),
                                 is_static=pc.is_static.copy())
            for k, pc in pair_dict.items()
        }
        if exclude:
            dyn_dist = np.stack([
                C.dynamic_distance((static[f] * 255).astype(np.uint8), (h, w))
                for f in range(n)
            ])
            C.set_static_flags(pair_keys, pd, [], {}, dyn_dist, min_dynamic_distance=4.0)
            C.prune_static_flag(n, pair_keys, pd, [], {}, (h, w), distance=4)
        data = C.flatten_pairs(pair_keys, pd, corrupted_np, inv_aspect, device=device)
        inputs = PoseOptInputs(data=data, median_depth=med, aspect=aspect, num_frames=n)
        solved = pose_opt.run(opt, inputs)
        return score(*_solved_geometry(solved, corrupted, aspect))

    gt, bad = score(scene.depth), score(corrupted)
    err_on = solve(exclude=True)
    err_off = solve(exclude=False)
    return {
        "quality_gap_closed_contaminated": _gap_closed(err_on, gt, bad),
        "quality_gap_closed_contaminated_no_exclusion": _gap_closed(err_off, gt, bad),
    }


def all_gates(tiny: bool = False, device="cuda") -> dict:
    """The four gate values that chip_smoke.py and the tests hold to the
    JAX package's, with every number of the three gate functions."""
    out = dict(static_quality_gate(tiny, device=device))
    out.update(dynamic_solver_gate(tiny, device=device))
    out.update(contaminated_constraint_gate(tiny, device=device))
    return out
