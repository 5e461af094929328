"""Residual blocks for the joint pose/deformation solve (PyTorch).

Port of robust_cvd_tpu/solver/residuals.py, mathematical parity with the
reference Ceres cost functors (lib/PoseOptimizer.cpp:60-656). All
constraints are evaluated as one batched tensor program; Jacobian products
come from torch.func.jvp / vjp inside the matrix-free LM solver (lm.py).

Constraint layout: PAIR-BLOCKED dense tensors (P pairs x C samples per
pair, padded with weight 0), so per-constraint parameter lookups collapse
to per-pair gathers.

Coordinate conventions (reference lib/PoseOptimizer.cpp:89-221):
  - Observation locations are NDC in [-1, 1]^2 (y up).
  - A camera-space point is (ndc_x + warp_x, ndc_y + warp_y, depth).
  - cameraToWorld: dir = (x * fx, y * fy, -1) rotated by the pose angle-axis;
    world = position + dir * depth, with fy = focal = tan(vFov/2),
    fx = fy * aspect.
  - worldToCamera: rotate (p - position) by the inverse rotation; depth = -z;
    ndc = (x / depth / fx, y / depth / fy).

Precision: every contraction here must run in full float32 on the card
(the JAX package uses Precision.HIGHEST); callers run the solver under
device.float32_precision.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import PoseOptParams
from . import xforms
from .xforms import GridSpec


class SolverParams(NamedTuple):
    """The optimized parameters of one solver stage.

    pose:         (N, 6)  [x, y, z, r1, r2, r3] position + angle-axis
    focal:        (N,)    tan(vFov / 2) per frame
    depth_grid:   (N, gz, gy, gx) multiplicative scale handles
    spatial_grid: (N, sy, sx, 2)  NDC warp handles
    depth_shift:  optional (N, gz, gy, gx) additive handles, present only for
                  the ScaleShift value transform (reference
                  lib/ValueTransform.h:57-94: dst = src * p0 + p1)
    """

    pose: torch.Tensor
    focal: torch.Tensor
    depth_grid: torch.Tensor
    spatial_grid: torch.Tensor
    depth_shift: torch.Tensor | None = None


class ConstraintData(NamedTuple):
    """Pair-blocked constraints.

    pair:          (P, 2) int64 (frame_i, frame_j)
    loc0/loc1:     (P, C, 2) NDC observation locations
    depth0/depth1: (P, C) source depths sampled at the observations
    weight:        (P, C) 1.0 for valid static constraints, 0.0 for padding /
                   dynamic / invalid-depth ones (lib/PoseOptimizer.cpp:1177-1193)
    """

    pair: torch.Tensor
    loc0: torch.Tensor
    loc1: torch.Tensor
    depth0: torch.Tensor
    depth1: torch.Tensor
    weight: torch.Tensor


class TripletData(NamedTuple):
    """Pair-blocked triplet constraints for scene-flow smoothness.

    frame: (T,) int64 center frame; loc: (T, C, 3, 2); depth: (T, C, 3);
    weight: (T, C) resolved static/dynamic smoothness weight, 0 for padding.
    """

    frame: torch.Tensor
    loc: torch.Tensor
    depth: torch.Tensor
    weight: torch.Tensor


class SceneConfig(NamedTuple):
    """Static configuration of a solver stage."""

    aspect: float
    depth_spec: GridSpec
    spatial_spec: GridSpec
    static_loss_type: str = "ReproDisparity"
    smooth_loss_type: str = "ReproDisparityLaplacian"
    intr_opt: str = "PerFrame"
    fixed_vfocal: float = 0.3461538376301239
    static_spatial_weight: float = 1.0
    static_depth_weight: float = 1.0


_EPS = 1e-6


def _rotate(aa: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation. aa (..., 3) angle-axis; p (..., C, 3) points
    (aa broadcast over C); first-order near zero."""
    theta2 = (aa * aa).sum(-1, keepdim=True)  # (..., 1)
    theta = torch.sqrt(theta2 + 1e-24)
    axis = (aa / theta)[..., None, :]  # (..., 1, 3)
    c = torch.cos(theta)[..., None]
    s = torch.sin(theta)[..., None]
    d = (axis * p).sum(-1, keepdim=True)
    cross = torch.linalg.cross(axis.expand(p.shape), p, dim=-1)
    rotated = c * p + s * cross + (1.0 - c) * d * axis
    small = p + torch.linalg.cross(aa[..., None, :].expand(p.shape), p, dim=-1)
    return torch.where(theta2[..., None] < 1e-16, small, rotated)


def dense_tap_weights(
    spec: GridSpec, loc: torch.Tensor, src_depth: torch.Tensor | None = None
) -> torch.Tensor:
    """Interpolation taps as DENSE per-handle weights: loc (..., 2)
    [src_depth (...,)] -> W (..., G), such that interp(grid) ==
    einsum('...g,g->...', W, grid_flat). Constant during a solve."""
    idx, w = xforms.grid_gather(spec, loc, src_depth)
    out = w.new_zeros(w.shape[:-1] + (spec.num_handles,))
    return out.scatter_add_(-1, idx, w)


def _eval_depth_scale_rows(grid_rows, spec: GridSpec, loc, src_depth, W=None):
    """Interpolated scale for pair-blocked samples. grid_rows: (P, G);
    loc: (P, C, 2); src_depth: (P, C); W: optional dense taps (P, C, G).
    Returns (P, C)."""
    if W is not None:
        return torch.einsum("pcg,pg->pc", W, grid_rows)
    didx, dw = xforms.grid_gather(spec, loc, src_depth)  # (P, C, K)
    p, c, k = didx.shape
    vals = torch.gather(grid_rows, 1, didx.reshape(p, c * k))
    return (vals.reshape(p, c, k) * dw).sum(-1)


def _eval_warp_rows(sgrid_rows, spec: GridSpec, loc, W=None):
    """Interpolated NDC warp for pair-blocked samples. sgrid_rows:
    (P, S, 2); loc: (P, C, 2); W: optional dense taps (P, C, S).
    Returns (P, C, 2)."""
    if W is not None:
        return torch.einsum("pcs,psd->pcd", W, sgrid_rows)
    sidx, sw = xforms.grid_gather(spec, loc)  # (P, C, K)
    p, c, k = sidx.shape
    flat = sgrid_rows.reshape(p, -1)
    x = torch.gather(flat, 1, (sidx * 2).reshape(p, c * k))
    y = torch.gather(flat, 1, (sidx * 2 + 1).reshape(p, c * k))
    wx = (x.reshape(p, c, k) * sw).sum(-1)
    wy = (y.reshape(p, c, k) * sw).sum(-1)
    return torch.stack([wx, wy], dim=-1)


class DenseTaps(NamedTuple):
    """Per-stage dense interpolation weights (see dense_tap_weights)."""

    d0: torch.Tensor  # (P, C, Gd) depth taps at loc0
    d1: torch.Tensor  # (P, C, Gd) depth taps at loc1
    s0: torch.Tensor  # (P, C, Gs) spatial taps at loc0
    s1: torch.Tensor  # (P, C, Gs) spatial taps at loc1
    scale_reg: torch.Tensor | None  # (N, G_locs, Gd) taps at the scale-reg grid


def build_dense_taps(
    cfg: SceneConfig, data: ConstraintData, median_depth: torch.Tensor,
    scale_grid_locs: torch.Tensor,
) -> DenseTaps:
    n = median_depth.shape[0]
    g = scale_grid_locs.shape[0]
    locs = scale_grid_locs[None].expand(n, g, 2)
    med = median_depth[:, None].expand(n, g)
    return DenseTaps(
        d0=dense_tap_weights(cfg.depth_spec, data.loc0, data.depth0),
        d1=dense_tap_weights(cfg.depth_spec, data.loc1, data.depth1),
        s0=dense_tap_weights(cfg.spatial_spec, data.loc0),
        s1=dense_tap_weights(cfg.spatial_spec, data.loc1),
        scale_reg=dense_tap_weights(cfg.depth_spec, locs, med),
    )


def observation_to_camera(
    params: SolverParams, cfg: SceneConfig, frames: torch.Tensor,
    loc: torch.Tensor, src_depth: torch.Tensor, dW=None, sW=None,
) -> torch.Tensor:
    """Batched obsToCamera (reference lib/PoseOptimizer.cpp:159-171).
    frames (P,), loc (P, C, 2), src_depth (P, C) -> camera points (P, C, 3)."""
    n = params.depth_grid.shape[0]
    dgrid_rows = params.depth_grid.reshape(n, -1)[frames]
    depth = src_depth * _eval_depth_scale_rows(
        dgrid_rows, cfg.depth_spec, loc, src_depth, dW
    )
    if params.depth_shift is not None:
        # ScaleShift: dst = src * p0 + p1; the shift handles share the
        # scale handles' taps (reference lib/ValueTransform.h:77-94)
        shift_rows = params.depth_shift.reshape(n, -1)[frames]
        depth = depth + _eval_depth_scale_rows(
            shift_rows, cfg.depth_spec, loc, src_depth, dW
        )
    sgrid_rows = params.spatial_grid.reshape(n, -1, 2)[frames]
    warp = _eval_warp_rows(sgrid_rows, cfg.spatial_spec, loc, sW)
    return torch.cat([loc + warp, depth[..., None]], dim=-1)


def _focal_xy(params: SolverParams, cfg: SceneConfig, frames: torch.Tensor):
    """Per-pair (fx, fy): fy = vertical focal, fx = fy * aspect."""
    if cfg.intr_opt == "Shared":
        fy = params.focal[0].expand(frames.shape)
    elif cfg.intr_opt == "PerFrame":
        fy = params.focal[frames]
    else:  # Fixed
        fy = torch.full(
            frames.shape, cfg.fixed_vfocal, dtype=torch.float32,
            device=frames.device,
        )
    return fy * cfg.aspect, fy


def camera_to_world(point_cam, fx, fy, pose):
    """Batched cameraToWorld (reference lib/PoseOptimizer.cpp:174-192).
    point_cam (P, C, 3); fx/fy (P,); pose (P, 6) -> world (P, C, 3)."""
    dir_cam = torch.stack(
        [
            point_cam[..., 0] * fx[:, None],
            point_cam[..., 1] * fy[:, None],
            -torch.ones_like(point_cam[..., 0]),
        ],
        dim=-1,
    )
    dir_world = _rotate(pose[:, 3:6], dir_cam)
    return pose[:, None, 0:3] + dir_world * point_cam[..., 2:3]


def world_to_camera(point_world, fx, fy, pose):
    """Batched worldToCamera (reference lib/PoseOptimizer.cpp:195-221)."""
    point_cam = _rotate(-pose[:, 3:6], point_world - pose[:, None, 0:3])
    depth = -point_cam[..., 2]
    safe = torch.where(depth.abs() > _EPS, depth, torch.sign(depth) * _EPS + _EPS)
    return torch.stack(
        [
            point_cam[..., 0] / safe / fx[:, None],
            point_cam[..., 1] / safe / fy[:, None],
            depth,
        ],
        dim=-1,
    )


def static_scene_residuals(
    params: SolverParams, cfg: SceneConfig, data: ConstraintData, taps=None
) -> torch.Tensor:
    """StaticSceneCost over all pair constraints -> (P, C, 3) raw residuals
    (reference lib/PoseOptimizer.cpp:223-319). Weights are NOT applied here.
    `taps`: optional DenseTaps in place of the interpolation gathers."""
    fi, fj = data.pair[:, 0], data.pair[:, 1]
    fx0, fy0 = _focal_xy(params, cfg, fi)
    fx1, fy1 = _focal_xy(params, cfg, fj)
    t = taps if taps is not None else DenseTaps(None, None, None, None, None)
    p0 = observation_to_camera(params, cfg, fi, data.loc0, data.depth0, t.d0, t.s0)
    p1 = observation_to_camera(params, cfg, fj, data.loc1, data.depth1, t.d1, t.s1)

    world0 = camera_to_world(p0, fx0, fy0, params.pose[fi])
    pose1 = params.pose[fj]
    if cfg.static_loss_type == "Euclidean":
        return camera_to_world(p1, fx1, fy1, pose1) - world0

    p01 = world_to_camera(world0, fx1, fy1, pose1)
    rx = (p01[..., 0] - p1[..., 0]) * cfg.static_spatial_weight
    ry = (p01[..., 1] - p1[..., 1]) * cfg.static_spatial_weight
    z01, z1 = p01[..., 2], p1[..., 2]
    if cfg.static_loss_type == "ReproDisparity":
        rz = 1.0 / z01.clamp_min(_EPS) - 1.0 / z1.clamp_min(_EPS)
    elif cfg.static_loss_type == "ReproDepthRatio":
        mx, mn = torch.maximum(z01, z1), torch.minimum(z01, z1)
        rz = mx / torch.where(mn.abs() > _EPS, mn, torch.full_like(mn, _EPS)) - 1.0
    elif cfg.static_loss_type == "ReproLogDepth":
        mx, mn = torch.maximum(z01, z1), torch.minimum(z01, z1)
        rz = torch.log((mn / mx.clamp_min(_EPS)).clamp_min(_EPS))
    else:
        raise ValueError(cfg.static_loss_type)
    return torch.stack([rx, ry, rz * cfg.static_depth_weight], dim=-1)


def smoothness_residuals(
    params: SolverParams, cfg: SceneConfig, data: TripletData
) -> torch.Tensor:
    """SceneFlowSmoothnessLoss over triplets -> (T, C, 3)
    (reference lib/PoseOptimizer.cpp:321-423)."""
    frames = [data.frame - 1, data.frame, data.frame + 1]
    pts, fxs, fys = [], [], []
    for k, f in enumerate(frames):
        fx, fy = _focal_xy(params, cfg, f)
        pts.append(observation_to_camera(
            params, cfg, f, data.loc[:, :, k], data.depth[:, :, k]
        ))
        fxs.append(fx)
        fys.append(fy)
    poses = [params.pose[f] for f in frames]
    w0 = camera_to_world(pts[0], fxs[0], fys[0], poses[0])
    w2 = camera_to_world(pts[2], fxs[2], fys[2], poses[2])

    if cfg.smooth_loss_type == "EuclideanLaplacian":
        w1 = camera_to_world(pts[1], fxs[1], fys[1], poses[1])
        return w0 + w2 - 2.0 * w1

    p01 = world_to_camera(w0, fxs[1], fys[1], poses[1])
    p21 = world_to_camera(w2, fxs[1], fys[1], poses[1])
    p1 = pts[1]
    rx = (p01[..., 0] + p21[..., 0] - 2.0 * p1[..., 0]) / fys[1][:, None]
    ry = (p01[..., 1] + p21[..., 1] - 2.0 * p1[..., 1]) / fys[1][:, None]
    if cfg.smooth_loss_type == "ReproDisparityLaplacian":
        rz = (
            1.0 / p01[..., 2].clamp_min(_EPS)
            + 1.0 / p21[..., 2].clamp_min(_EPS)
            - 2.0 / p1[..., 2].clamp_min(_EPS)
        )
    else:
        base = p1[..., 2]
        other = p01[..., 2] + p21[..., 2] - p1[..., 2]
        mx, mn = torch.maximum(base, other), torch.minimum(base, other)
        if cfg.smooth_loss_type == "ReproDepthRatioConsistency":
            rz = mx / torch.where(mn.abs() > _EPS, mn, torch.full_like(mn, _EPS)) - 1.0
        elif cfg.smooth_loss_type == "ReproLogDepthConsistency":
            rz = torch.log((mn / mx.clamp_min(_EPS)).clamp_min(_EPS))
        else:
            raise ValueError(cfg.smooth_loss_type)
    return torch.stack([rx, ry, rz], dim=-1)


def scale_reg_residuals(
    params: SolverParams, cfg: SceneConfig, median_depth: torch.Tensor,
    grid_locs: torch.Tensor, W=None,
) -> torch.Tensor:
    """TargetDisparityCost on a per-frame grid of sample points -> (N, G)
    (reference lib/PoseOptimizer.cpp:488-517, 1341-1415): pins the
    transformed median depth to disparity 1.0, which fixes the global scale.
    median_depth: (N,) per-frame median SOURCE depth; grid_locs: (G, 2) NDC."""
    n = params.depth_grid.shape[0]
    g = grid_locs.shape[0]
    locs = grid_locs[None].expand(n, g, 2)
    med = median_depth[:, None].expand(n, g)
    rows = params.depth_grid.reshape(n, -1)
    if W is not None:
        scale = torch.einsum("ngk,nk->ng", W, rows)
    else:
        scale = _eval_depth_scale_rows(rows, cfg.depth_spec, locs, med)
    depth = med * scale
    if params.depth_shift is not None:
        srows = params.depth_shift.reshape(n, -1)
        if W is not None:
            depth = depth + torch.einsum("ngk,nk->ng", W, srows)
        else:
            depth = depth + _eval_depth_scale_rows(srows, cfg.depth_spec, locs, med)
    return 1.0 / depth.clamp_min(_EPS) - 1.0


def position_reg_residuals(params: SolverParams) -> torch.Tensor:
    """Second-difference Laplacian over camera positions -> (N-2, 3)
    (reference ParameterRegularizationCost, lib/PoseOptimizer.cpp:464-483)."""
    p = params.pose[:, 0:3]
    return p[:-2] - 2.0 * p[1:-1] + p[2:]


def focal_reg_residuals(params: SolverParams, cfg: SceneConfig) -> torch.Tensor:
    """(focal - target) per frame (reference TargetFocalCost,
    lib/PoseOptimizer.cpp:520-533)."""
    return params.focal - cfg.fixed_vfocal


class StageAux(NamedTuple):
    """Inputs to one solver stage that stay fixed during it.

    adaptive_weights: (N, E) per-edge AdaptiveDeformationCost terms
    (reference lib/PoseOptimizer.cpp:559-656); None selects the uniform
    DeformationCost path.

    per_frame: whether this rank adds the per-frame residuals (the scale,
    deformation, focal and position regularizers). In a solve sharded over
    the constraints (parallel/mesh.py::shard_pose_inputs) `data` and
    `triplets` are this rank's share and only rank 0 adds the per-frame
    parts, so that the sum over the ranks counts each residual once."""

    data: ConstraintData
    median_depth: torch.Tensor
    scale_grid_locs: torch.Tensor
    triplets: TripletData | None = None
    adaptive_weights: torch.Tensor | None = None
    taps: DenseTaps | None = None
    per_frame: bool = True


def _sqrt_weight(w: float) -> float:
    return float(np.sqrt(w)) if w > 0 else 0.0


def build_residual_fn(
    cfg: SceneConfig, opt: PoseOptParams, depth_deform_weight: float,
    use_triplets: bool = False, use_adaptive: bool = False,
):
    """The full weighted residual vector of one stage:
    `fn(params, irls_weight, aux) -> flat residuals`, where `irls_weight`
    (P, C) carries the frozen per-constraint robustification weights (sqrt
    of the Cauchy IRLS weight), recomputed between LM outer iterations."""
    sqrt_scale_reg = _sqrt_weight(opt.scale_regularization)
    sqrt_focal_reg = _sqrt_weight(opt.focal_regularization)
    sqrt_pos_reg = _sqrt_weight(opt.position_regularization)

    def fn(params: SolverParams, irls_weight: torch.Tensor, aux: StageAux):
        r_static = static_scene_residuals(params, cfg, aux.data, aux.taps)
        w = (aux.data.weight * irls_weight)[..., None]
        parts = [(r_static * w).reshape(-1)]

        if use_triplets:
            r_sm = smoothness_residuals(params, cfg, aux.triplets)
            parts.append((r_sm * torch.sqrt(aux.triplets.weight)[..., None]).reshape(-1))
        if not aux.per_frame:
            return torch.cat(parts)

        if sqrt_scale_reg > 0.0 and not opt.fix_depth_transforms:
            r_scale = scale_reg_residuals(
                params, cfg, aux.median_depth, aux.scale_grid_locs,
                aux.taps.scale_reg if aux.taps is not None else None,
            )
            parts.append((r_scale * sqrt_scale_reg).reshape(-1))

        if depth_deform_weight > 0.0:
            r_def = xforms.depth_deform_residuals(params.depth_grid)
            if use_adaptive:
                # reference multiplier: baseWeight + w_edge * adaptiveWeight
                r_def = r_def * (depth_deform_weight + aux.adaptive_weights)
            else:
                r_def = r_def * depth_deform_weight
            parts.append(r_def.reshape(-1))
            if params.depth_shift is not None:
                r_sh = xforms.shift_deform_residuals(params.depth_shift)
                parts.append((r_sh * depth_deform_weight).reshape(-1))

        if opt.spatial_deformation_regularization > 0.0:
            r_sp = xforms.spatial_deform_residuals(params.spatial_grid)
            parts.append((r_sp * opt.spatial_deformation_regularization).reshape(-1))

        if sqrt_focal_reg > 0.0 and cfg.intr_opt != "Fixed":
            parts.append(focal_reg_residuals(params, cfg) * sqrt_focal_reg)

        if sqrt_pos_reg > 0.0:
            parts.append((position_reg_residuals(params) * sqrt_pos_reg).reshape(-1))
        return torch.cat(parts)

    return fn


def cauchy_irls_weight(r_static: torch.Tensor, robustness: float) -> torch.Tensor:
    """sqrt of the Cauchy IRLS weight per constraint: Ceres
    CauchyLoss(a) rho(s) = a^2 log(1 + s / a^2) on the squared residual norm
    s, whose IRLS weight is rho'(s) = 1 / (1 + s / a^2)."""
    s = (r_static * r_static).sum(-1)
    return 1.0 / torch.sqrt(1.0 + s / (robustness * robustness))


# ---------------------------------------------------------------------------
# Exact diag(J^T J) for Jacobi preconditioning (solver/lm.py).
# ---------------------------------------------------------------------------


def _per_sample_grads(res_fn, inputs, slots: int):
    """Jacobians of a batched residual in which sample m reads only rows
    [slots*m, slots*(m+1)) of each input: res_fn(*inputs) -> (M, 3).
    Returns, per input of shape (slots*M, *f), the tensor (M, 3, slots, *f)
    of d r_m[c] / d input[slots*m + k]. One forward and three backward
    passes: a cotangent that selects component c in every sample yields each
    sample's own Jacobian row, because no two samples share an input row."""
    r, vjp_fn = torch.func.vjp(res_fn, *inputs)
    m = r.shape[0]
    rows = []
    for c in range(3):
        u = torch.zeros_like(r)
        u[:, c] = 1.0
        rows.append(vjp_fn(u))
    return [
        torch.stack([row[i] for row in rows], 1)  # (slots*M, 3, *f)
        .reshape((m, slots, 3) + inputs[i].shape[1:])
        .transpose(1, 2)
        for i in range(len(inputs))
    ]


def build_diag_fn(
    cfg: SceneConfig, opt: PoseOptParams, depth_deform_weight: float,
    use_triplets: bool = False, use_adaptive: bool = False,
    pose_blocks: bool = False,
):
    """Exact diagonal of the Gauss-Newton matrix J^T J for the stage built
    by `build_residual_fn` with the same arguments.

    Grid handles enter each residual only through interpolated SCALARS
    (scale/shift/warp = <taps, handles>), so every constraint is evaluated
    as a mini-problem on one-handle grids holding those scalars, and
    (dr/dhandle_g)^2 = (dr/dscalar)^2 * tap_g^2 is contracted with the
    squared dense taps (rank-1 chain rule). The mini-problems of all samples
    run as one batched problem (_per_sample_grads), where the JAX package
    vmaps a per-sample jacrev.

    Returns `fn(params, irls_weight, aux) -> SolverParams` of diagonals
    (requires aux.taps); with pose_blocks=True `fn` returns
    `(diag, blocks (N, 6, 6))`, adding the exact per-frame 6x6 pose blocks
    of J^T J (block Jacobi: cross-frame couplings dropped). Callers add the
    LM damping themselves.
    """
    sqrt_scale_reg = _sqrt_weight(opt.scale_regularization)
    sqrt_focal_reg = _sqrt_weight(opt.focal_regularization)
    sqrt_pos_reg = _sqrt_weight(opt.position_regularization)
    shared_intr = cfg.intr_opt == "Shared"
    # A shared focal is one variable read by every frame; the mini-problems
    # give each slot its own copy and add the slots' derivatives.
    mini_cfg = cfg._replace(intr_opt="PerFrame") if shared_intr else cfg
    one_handle = mini_cfg._replace(
        depth_spec=GridSpec(gx=1, gy=1, gz=1), spatial_spec=GridSpec(gx=1, gy=1)
    )

    def fn(params: SolverParams, irls_weight: torch.Tensor, aux: StageAux):
        if aux.taps is None:
            raise ValueError("the exact diagonal needs dense taps")
        n = params.pose.shape[0]
        data, taps = aux.data, aux.taps
        dev, dt = params.pose.device, params.pose.dtype
        gd = taps.d0.shape[-1]
        gs = taps.s0.shape[-1]
        dshape = params.depth_grid.shape[1:]
        has_shift = params.depth_shift is not None

        d_pose = torch.zeros_like(params.pose)
        b_pose = torch.zeros((n, 6, 6), dtype=dt, device=dev) if pose_blocks else None
        d_focal = torch.zeros_like(params.focal)
        d_dgrid = torch.zeros((n, gd), dtype=dt, device=dev)
        d_sgrid = torch.zeros((n, gs, 2), dtype=dt, device=dev)
        d_shift = torch.zeros((n, gd), dtype=dt, device=dev) if has_shift else None

        drows = params.depth_grid.reshape(n, -1)
        srows3 = params.spatial_grid.reshape(n, -1, 2)
        shrows = params.depth_shift.reshape(n, -1) if has_shift else None

        def slot_focal(frames):
            if shared_intr:
                return params.focal[0].expand(frames.shape)
            return params.focal[frames]

        def mini(pose, focal, s, warp, shift=None):
            k = pose.shape[0]
            return SolverParams(
                pose=pose, focal=focal, depth_grid=s.reshape(k, 1, 1, 1),
                spatial_grid=warp.reshape(k, 1, 1, 2),
                depth_shift=None if shift is None else shift.reshape(k, 1, 1, 1),
            )

        def per_sample(xs, feat, batch):
            """Per-slot values, each (B1, B2, *feat) or per pair (B1, *feat)
            -> (slots * B1 * B2, *feat), row slots*m + k holding slot k of
            sample m."""
            xs = [
                x[:, None].expand(batch + feat) if x.dim() == 1 + len(feat) else x
                for x in xs
            ]
            return torch.stack(xs, 2).reshape((-1,) + feat)

        def focal_sq(g_focal):
            """(M, 3, slots) focal derivatives -> per-slot squares; a shared
            focal collects the slots' sum on slot 0."""
            if shared_intr:
                tot = g_focal.sum(-1, keepdim=True)
                return torch.cat([tot, torch.zeros_like(g_focal[..., 1:])], -1) ** 2
            return g_focal ** 2

        # ---- static scene: per-sample 2-frame mini-problems ----------------
        fi, fj = data.pair[:, 0], data.pair[:, 1]
        p, c = data.weight.shape
        m = p * c
        s0 = torch.einsum("pcg,pg->pc", taps.d0, drows[fi])
        s1 = torch.einsum("pcg,pg->pc", taps.d1, drows[fj])
        w0 = torch.einsum("pcs,psd->pcd", taps.s0, srows3[fi])
        w1 = torch.einsum("pcs,psd->pcd", taps.s1, srows3[fj])

        inputs = [
            per_sample([params.pose[fi], params.pose[fj]], (6,), (p, c)),
            per_sample([slot_focal(fi), slot_focal(fj)], (), (p, c)),
            per_sample([s0, s1], (), (p, c)),
            per_sample([w0, w1], (2,), (p, c)),
        ]
        if has_shift:
            inputs.append(per_sample([
                torch.einsum("pcg,pg->pc", taps.d0, shrows[fi]),
                torch.einsum("pcg,pg->pc", taps.d1, shrows[fj]),
            ], (), (p, c)))
        ar = torch.arange(m, device=dev)
        ones = torch.ones((m, 1, 1), dtype=dt, device=dev)
        mdata = ConstraintData(
            pair=torch.stack([2 * ar, 2 * ar + 1], -1),
            loc0=data.loc0.reshape(m, 1, 2), loc1=data.loc1.reshape(m, 1, 2),
            depth0=data.depth0.reshape(m, 1), depth1=data.depth1.reshape(m, 1),
            weight=torch.ones((m, 1), dtype=dt, device=dev),
        )
        mtaps = DenseTaps(d0=ones, d1=ones, s0=ones, s1=ones, scale_reg=None)

        def pair_res(*x):
            return static_scene_residuals(mini(*x), mini_cfg, mdata, mtaps)[:, 0]

        grads = [
            g.reshape((p, c) + g.shape[1:])
            for g in _per_sample_grads(pair_res, inputs, 2)
        ]
        w2 = ((data.weight * irls_weight) ** 2)[..., None]  # (P, C, 1)

        def acc_taps(acc, sq_slot, taps_pair):
            """sq_slot (P, C, 2) per-slot squared scalar derivatives;
            contract with squared taps and add per frame."""
            for k, (frames_k, taps_k) in enumerate(taps_pair):
                acc = acc.index_add(0, frames_k, torch.einsum(
                    "pc,pcg->pg", sq_slot[..., k], taps_k ** 2
                ))
            return acc

        # pose: (P, C, 3, 2, 6)
        sq_pose = (grads[0] ** 2 * w2[..., None, None]).sum((1, 2))
        d_pose = d_pose.index_add(0, fi, sq_pose[:, 0]).index_add(0, fj, sq_pose[:, 1])
        if pose_blocks:
            for k, fk in ((0, fi), (1, fj)):
                gk = grads[0][:, :, :, k, :]
                b_pose = b_pose.index_add(0, fk, torch.einsum(
                    "pcra,pcrb,pc->pab", gk, gk, w2[..., 0]
                ))
        # focal: (P, C, 3, 2)
        sq_focal = (focal_sq(grads[1]) * w2[..., None]).sum((1, 2))
        if shared_intr:
            d_focal[0] += sq_focal[:, 0].sum()
        elif cfg.intr_opt == "PerFrame":
            d_focal = d_focal.index_add(0, fi, sq_focal[:, 0]).index_add(0, fj, sq_focal[:, 1])
        # depth scale: (P, C, 3, 2) -> rank-1 tap contraction
        sq_s = (grads[2] ** 2 * w2[..., None]).sum(2)
        d_dgrid = acc_taps(d_dgrid, sq_s, [(fi, taps.d0), (fj, taps.d1)])
        # warp: (P, C, 3, 2, 2) -> per slot/channel
        sq_w = (grads[3] ** 2 * w2[..., None, None]).sum(2)
        d_sgrid = torch.stack([
            acc_taps(d_sgrid[:, :, ch], sq_w[..., ch], [(fi, taps.s0), (fj, taps.s1)])
            for ch in range(2)
        ], -1)
        if has_shift:
            sq_sh = (grads[4] ** 2 * w2[..., None]).sum(2)
            d_shift = acc_taps(d_shift, sq_sh, [(fi, taps.d0), (fj, taps.d1)])

        # ---- scene-flow smoothness: per-sample 3-frame mini-problems -------
        if use_triplets and aux.triplets is not None:
            trip = aux.triplets
            f3 = torch.stack([trip.frame - 1, trip.frame, trip.frame + 1], 1)
            t, ct = trip.weight.shape
            mt = t * ct
            t_dtaps, t_staps, t_s, t_w, t_sh = [], [], [], [], []
            for k in range(3):
                fk = f3[:, k]
                dW = dense_tap_weights(cfg.depth_spec, trip.loc[:, :, k], trip.depth[:, :, k])
                sW = dense_tap_weights(cfg.spatial_spec, trip.loc[:, :, k])
                t_dtaps.append(dW)
                t_staps.append(sW)
                t_s.append(torch.einsum("pcg,pg->pc", dW, drows[fk]))
                t_w.append(torch.einsum("pcs,psd->pcd", sW, srows3[fk]))
                if has_shift:
                    t_sh.append(torch.einsum("pcg,pg->pc", dW, shrows[fk]))

            tin = [
                per_sample([params.pose[f3[:, k]] for k in range(3)], (6,), (t, ct)),
                per_sample([slot_focal(f3[:, k]) for k in range(3)], (), (t, ct)),
                per_sample(t_s, (), (t, ct)),
                per_sample(t_w, (2,), (t, ct)),
            ]
            if has_shift:
                tin.append(per_sample(t_sh, (), (t, ct)))
            tdata = TripletData(
                frame=3 * torch.arange(mt, device=dev) + 1,
                loc=trip.loc.reshape(mt, 1, 3, 2),
                depth=trip.depth.reshape(mt, 1, 3),
                weight=torch.ones((mt, 1), dtype=dt, device=dev),
            )

            def trip_res(*x):
                return smoothness_residuals(mini(*x), one_handle, tdata)[:, 0]

            tgrads = [
                g.reshape((t, ct) + g.shape[1:])
                for g in _per_sample_grads(trip_res, tin, 3)
            ]
            tw2 = trip.weight[..., None]  # the residual folds sqrt(weight)
            sq_pose_t = (tgrads[0] ** 2 * tw2[..., None, None]).sum((1, 2))
            sq_focal_t = (focal_sq(tgrads[1]) * tw2[..., None]).sum((1, 2))
            sq_s_t = (tgrads[2] ** 2 * tw2[..., None]).sum(2)
            sq_w_t = (tgrads[3] ** 2 * tw2[..., None, None]).sum(2)
            sq_sh_t = (tgrads[4] ** 2 * tw2[..., None]).sum(2) if has_shift else None
            for k in range(3):
                fk = f3[:, k]
                d_pose = d_pose.index_add(0, fk, sq_pose_t[:, k])
                if pose_blocks:
                    gk = tgrads[0][:, :, :, k, :]
                    b_pose = b_pose.index_add(0, fk, torch.einsum(
                        "pcra,pcrb,pc->pab", gk, gk, trip.weight
                    ))
                if shared_intr:
                    if k == 0:
                        d_focal[0] += sq_focal_t[:, 0].sum()
                elif cfg.intr_opt == "PerFrame":
                    d_focal = d_focal.index_add(0, fk, sq_focal_t[:, k])
                d_dgrid = d_dgrid.index_add(0, fk, torch.einsum(
                    "pc,pcg->pg", sq_s_t[..., k], t_dtaps[k] ** 2
                ))
                d_sgrid = torch.stack([
                    d_sgrid[:, :, ch].index_add(0, fk, torch.einsum(
                        "pc,pcg->pg", sq_w_t[..., k, ch], t_staps[k] ** 2
                    ))
                    for ch in range(2)
                ], -1)
                if has_shift:
                    d_shift = d_shift.index_add(0, fk, torch.einsum(
                        "pc,pcg->pg", sq_sh_t[..., k], t_dtaps[k] ** 2
                    ))

        # ---- the per-frame parts, on one rank of a sharded solve ------------
        per_frame = aux.per_frame

        # ---- scale regularizer: rank-1 tap contraction ---------------------
        if per_frame and sqrt_scale_reg > 0.0 and not opt.fix_depth_transforms:
            W = taps.scale_reg  # (N, G, Gd)
            med = aux.median_depth
            depth = med[:, None] * torch.einsum("ngk,nk->ng", W, drows)
            if has_shift:
                depth = depth + torch.einsum("ngk,nk->ng", W, shrows)
            # r = sqrt_scale * (1/max(depth, eps) - 1):
            # dr/ddepth = -sqrt_scale / depth^2, 0 in the clamped region
            dr_ddepth = torch.where(
                depth > _EPS, -sqrt_scale_reg / depth.clamp_min(_EPS) ** 2,
                torch.zeros_like(depth),
            )
            d_dgrid = d_dgrid + torch.einsum(
                "ng,ngk->nk", (dr_ddepth * med[:, None]) ** 2, W ** 2
            )
            if has_shift:
                d_shift = d_shift + torch.einsum("ng,ngk->nk", dr_ddepth ** 2, W ** 2)

        # ---- deformation regularizers: per-frame Jacobians -----------------
        if per_frame and depth_deform_weight > 0.0:
            def frame_def(row, wmul):
                return xforms.depth_deform_residuals(row.reshape(dshape)) * wmul

            e = xforms.depth_deform_residuals(params.depth_grid[0]).shape[-1]
            if use_adaptive:
                wmul = depth_deform_weight + aux.adaptive_weights
            else:
                wmul = torch.full((n, e), depth_deform_weight, dtype=dt, device=dev)
            if e > 0:  # a 1x1x1 grid has no edges
                jd = torch.func.vmap(torch.func.jacrev(frame_def))(drows, wmul)
                d_dgrid = d_dgrid + (jd ** 2).sum(1)
            if has_shift and e > 0:
                def frame_shdef(row):
                    return xforms.shift_deform_residuals(row.reshape(dshape)) * depth_deform_weight

                js = torch.func.vmap(torch.func.jacrev(frame_shdef))(shrows)
                d_shift = d_shift + (js ** 2).sum(1)

        if per_frame and opt.spatial_deformation_regularization > 0.0:
            # residual == the handles themselves * weight: constant diagonal
            d_sgrid = d_sgrid + opt.spatial_deformation_regularization ** 2

        # ---- focal / position regularizers ---------------------------------
        if per_frame and sqrt_focal_reg > 0.0 and cfg.intr_opt != "Fixed":
            d_focal = d_focal + sqrt_focal_reg ** 2

        if per_frame and sqrt_pos_reg > 0.0:
            jp = torch.func.jacrev(
                lambda pose: position_reg_residuals(params._replace(pose=pose)) * sqrt_pos_reg
            )(params.pose)  # (N-2, 3, N, 6)
            d_pose = d_pose + (jp ** 2).sum((0, 1))
            if pose_blocks:
                b_pose = b_pose + torch.einsum("rcna,rcnb->nab", jp, jp)

        diag = SolverParams(
            pose=d_pose,
            focal=d_focal,
            depth_grid=d_dgrid.reshape(params.depth_grid.shape),
            spatial_grid=d_sgrid.reshape(params.spatial_grid.shape),
            depth_shift=d_shift.reshape(params.depth_shift.shape) if has_shift else None,
        )
        return (diag, b_pose) if pose_blocks else diag

    return fn
