"""Pose / deformation optimization driver (PyTorch).

Port of robust_cvd_tpu/solver/pose_opt.py, which drives the LM solver the
way the reference drives Ceres (lib/PoseOptimizer.cpp:788-990
`poseOptimization` + :992-1147 `normalizeDepth`, invoked through
pose_optimization.py:177-240):

  1. Reset transforms: Global(Scale) depth xform, Identity spatial xform.
  2. normalize_depth: per-frame scale init pinning the median source depth
     to disparity 1.0 (first frame's transform copied to all frames).
  3. num_steps LM solves with coarse-to-fine depth-grid subdivision
     1x1 -> ctf_long x ctf_short and log-annealed deformation regularization.
  4. Optional deferred spatial optimization: a final solve with a bicubic
     warp grid.

The solver runs on the device of its inputs, in full float32 (no TF32).
Every LM solve can be recorded in a `log` list: one dict per solve with
its stage, grid, start and final cost, outer steps, CG iterations, host
syncs and, with Hutchinson probes, a digest of the probes' generator
state after the solve (`probes`).

Inputs from parallel/mesh.py::shard_pose_inputs carry their mesh: every
rank solves each step on its share of the constraints, rank 0 alone adds
the per-frame residuals (StageAux.per_frame), and each LM solve sums the
ranks' products through the mesh's all-reduce (solver/lm.py), so every
rank ends with the same SolverParams. Depth normalization reads only
per-frame data and runs whole on every rank, with no all-reduce. On a
mesh the log also holds each solve's all-reduces, their host seconds
(`Mesh.stats`) and a digest of the solved SolverParams (`params_digest`)
for comparing the ranks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import PoseOptParams
from ..device import float32_precision
from . import lm, residuals, xforms
from .lm import LMConfig
from .residuals import ConstraintData, SceneConfig, SolverParams, StageAux, TripletData
from .xforms import GridSpec


class PoseOptInputs(NamedTuple):
    """Inputs to a pose optimization (constant across LM stages)."""

    data: ConstraintData
    median_depth: torch.Tensor  # (N,) per-frame median source depth
    aspect: float
    num_frames: int
    triplets: TripletData | None = None
    # (N, h, w) dynamic masks (white/True = static) for
    # AdaptiveDeformationCost (reference lib/PoseOptimizer.cpp:559-656)
    dynamic_mask: object = None
    # the data mesh whose ranks share the constraints (shard_pose_inputs);
    # None: `data` and `triplets` are the whole problem
    mesh: object = None


def scale_reg_grid_locs(opt: PoseOptParams, aspect: float, device=None) -> torch.Tensor:
    """NDC sample locations for the scale regularizer
    (reference lib/PoseOptimizer.cpp:1341-1352, 1382-1385)."""
    gx = opt.scale_regularization_grid_size
    gy = int(round(gx / aspect))
    if aspect <= 1.0:
        gx, gy = gy, gx
    X, Y = np.meshgrid(np.linspace(-1.0, 1.0, gx), np.linspace(-1.0, 1.0, gy))
    locs = np.stack([X.ravel(), Y.ravel()], axis=-1).astype(np.float32)
    return torch.as_tensor(locs, device=device)


def ctf_grid_schedule(opt: PoseOptParams, aspect: float) -> list:
    """Depth-grid size per solver step (reference .cpp:795-871)."""
    ctf_rows, ctf_cols = opt.ctf_long, opt.ctf_short
    if aspect >= 1.0:
        ctf_rows, ctf_cols = ctf_cols, ctf_rows
    init = (1, 1)  # Global transform
    sizes = [init]
    if opt.coarse_to_fine and opt.num_steps > 1:
        for step in range(opt.num_steps - 1):
            it = (step + 1) / (opt.num_steps - 1)
            gx = int(init[0] + (ctf_cols - init[0]) * it + 0.5)
            gy = int(init[1] + (ctf_rows - init[1]) * it + 0.5)
            sizes.append((gx, gy))
    else:
        sizes += [init] * (opt.num_steps - 1)
    return sizes[: opt.num_steps]


def _identity_transforms(n: int, with_shift: bool, device):
    """(depth_grid, spatial_grid, depth_shift) of Global(Scale[Shift]) /
    Identity transforms."""
    return (
        torch.ones((n, 1, 1, 1), dtype=torch.float32, device=device),
        torch.zeros((n, 1, 1, 2), dtype=torch.float32, device=device),
        torch.zeros((n, 1, 1, 1), dtype=torch.float32, device=device)
        if with_shift else None,
    )


def default_solver_params(
    num_frames: int, focal: torch.Tensor, value_xform: str = "Scale"
) -> SolverParams:
    """Fresh Global(Scale)/Identity transforms (reference
    pose_optimization.py:195-207 Reset* ops). value_xform "ScaleShift" adds
    additive handles (reference lib/ValueTransform.h:57-94)."""
    dgrid, sgrid, shift = _identity_transforms(
        num_frames, value_xform == "ScaleShift", focal.device
    )
    return SolverParams(
        pose=torch.zeros((num_frames, 6), dtype=torch.float32, device=focal.device),
        focal=focal, depth_grid=dgrid, spatial_grid=sgrid, depth_shift=shift,
    )


def _lm_config(opt: PoseOptParams) -> LMConfig:
    # --opt.max_iterations (Ceres' per-solve cap, lib/PoseOptimizer.h:56)
    # bounds the LM outer iterations
    return LMConfig(
        max_outer=min(opt.lm_max_outer, opt.max_iterations),
        cg_iters=opt.lm_cg_iters,
        lam_init=opt.lm_lambda_init,
        rtol=opt.lm_rtol,
        robustness=opt.robustness,
        precond_probes=opt.lm_precond_probes,
    )


def _v_focal(opt: PoseOptParams, aspect: float) -> float:
    return opt.focal_long / aspect if aspect >= 1.0 else opt.focal_long


def params_digest(p: SolverParams) -> str:
    """sha256 of the bytes of every present tensor of `p`: equal digests
    mean bitwise equal parameters."""
    h = hashlib.sha256()
    for t in lm._leaves(p):
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _lm_solve(inputs: PoseOptInputs, log, stage: str, params: SolverParams, *args,
              sharded: bool = True, **kw):
    """lm.solve(*args, **kw), recorded in `log`; `sharded`: summed over the
    ranks of inputs.mesh (each rank's residuals cover its share)."""
    mesh = inputs.mesh
    coll0 = 0.0 if mesh is None else mesh.stats["collective_s"]
    reduce_sum = mesh.all_reduce_sum_ if mesh is not None and sharded else None
    out = lm.solve(*args, all_reduce=reduce_sum, **kw)
    if log is not None:
        entry = {
            "stage": stage,
            "grid": tuple(params.depth_grid.shape[1:]),
            "cost0": out.cost0,
            "cost": out.cost,
            "outer": out.iterations,
            "cg": out.cg_iterations,
            "syncs": out.syncs,
        }
        if out.probe_state is not None:
            entry["probes"] = hashlib.sha256(out.probe_state.numpy().tobytes()).hexdigest()
        if mesh is not None:
            entry["digest"] = params_digest(out.params)
            entry["all_reduces"] = out.all_reduces
            entry["all_reduce_s"] = mesh.stats["collective_s"] - coll0
        log.append(entry)
    return out


def _normalize_res_fn(cfg: SceneConfig, sqrt_scale: float, deform_w: float):
    def wres(p: SolverParams, w, aux: StageAux):
        parts = [
            (
                residuals.scale_reg_residuals(
                    p, cfg, aux.median_depth, aux.scale_grid_locs,
                    aux.taps.scale_reg if aux.taps is not None else None,
                )
                * sqrt_scale
            ).reshape(-1)
        ]
        if deform_w > 0.0:
            parts.append(
                (xforms.depth_deform_residuals(p.depth_grid) * deform_w).reshape(-1)
            )
        return torch.cat(parts)

    return wres


def _robust_fn(cfg: SceneConfig):
    def robust(p: SolverParams, aux: StageAux):
        return residuals.static_scene_residuals(p, cfg, aux.data, aux.taps)

    return robust


def _project_nonneg(p: SolverParams) -> SolverParams:
    return p._replace(depth_grid=p.depth_grid.clamp_min(0.0))


def _make_cfg(opt: PoseOptParams, inputs: PoseOptInputs, params: SolverParams,
              spatial_cubic: bool = False) -> SceneConfig:
    gz, gy, gx = params.depth_grid.shape[1:]
    sy, sx = params.spatial_grid.shape[1:3]
    return SceneConfig(
        aspect=inputs.aspect,
        depth_spec=GridSpec(gx=gx, gy=gy, gz=gz),
        spatial_spec=GridSpec(gx=sx, gy=sy, cubic=spatial_cubic),
        static_loss_type=opt.static_loss_type,
        smooth_loss_type=opt.smooth_loss_type,
        intr_opt=opt.intr_opt,
        fixed_vfocal=_v_focal(opt, inputs.aspect),
        static_spatial_weight=opt.static_spatial_weight,
        static_depth_weight=opt.static_depth_weight,
    )


def _aux(opt: PoseOptParams, inputs: PoseOptInputs, use_triplets: bool,
         cfg: SceneConfig, sharded: bool = True) -> StageAux:
    device = inputs.median_depth.device
    locs = scale_reg_grid_locs(opt, inputs.aspect, device)
    taps = residuals.build_dense_taps(cfg, inputs.data, inputs.median_depth, locs)
    adaptive = None
    if opt.adaptive_deformation_cost > 0.0 and inputs.dynamic_mask is not None:
        # the adaptive TERM only; the residual fn adds the stage's
        # depth_deform_weight as the base
        adaptive = xforms.adaptive_deform_weights(
            inputs.dynamic_mask, cfg.depth_spec, base_weight=0.0,
            adaptive_weight=opt.adaptive_deformation_cost, device=device,
        )
    return StageAux(
        data=inputs.data,
        median_depth=inputs.median_depth,
        scale_grid_locs=locs,
        triplets=inputs.triplets if use_triplets else None,
        taps=taps,
        adaptive_weights=adaptive,
        per_frame=not sharded or inputs.mesh is None or inputs.mesh.rank == 0,
    )


def normalize_depth(
    opt: PoseOptParams, inputs: PoseOptInputs, params: SolverParams, log=None,
) -> SolverParams:
    """Depth normalization (reference lib/PoseOptimizer.cpp:992-1147): only
    the scale regularizer constrains each frame's transform — pinning each
    frame's median source depth to disparity 1 — then the FIRST frame's
    transform is copied to all frames. Scale handles are bounded below by 0.
    Its residuals are per frame only, so on a mesh every rank solves it
    whole, with no all-reduce.
    """
    cfg = _make_cfg(opt, inputs, params)
    wres = _normalize_res_fn(
        cfg, math.sqrt(max(opt.scale_regularization, 0.0)),
        opt.deformation_regularization_initial,
    )
    mask = lm.make_mask(params, fix_poses=True, fix_focal=True, fix_spatial=True)
    out = _lm_solve(
        inputs, log, "normalize", params,
        wres, None, params, mask, _lm_config(opt),
        aux=_aux(opt, inputs, use_triplets=False, cfg=cfg, sharded=False),
        project_fn=_project_nonneg, sharded=False,
    )
    solved = out.params
    if opt.normalize_depth_from_first_frame:
        solved = solved._replace(
            depth_grid=solved.depth_grid[0:1].expand(solved.depth_grid.shape).clone()
        )
        if solved.depth_shift is not None:
            solved = solved._replace(
                depth_shift=solved.depth_shift[0:1].expand(solved.depth_shift.shape).clone()
            )
    return solved


def _solve_step(
    opt: PoseOptParams, inputs: PoseOptInputs, params: SolverParams,
    depth_deform_weight: float, spatial_cubic: bool = False, log=None,
    stage: str = "step",
) -> SolverParams:
    """One poseOptimizationStep (reference .cpp:890-990) as an LM solve."""
    cfg = _make_cfg(opt, inputs, params, spatial_cubic)
    use_smooth = (
        opt.smooth_static_weight > 0.0 or opt.smooth_dynamic_weight > 0.0
    ) and inputs.triplets is not None
    use_adaptive = (
        opt.adaptive_deformation_cost > 0.0 and inputs.dynamic_mask is not None
    )
    res_fn = residuals.build_residual_fn(
        cfg, opt, depth_deform_weight=depth_deform_weight,
        use_triplets=use_smooth, use_adaptive=use_adaptive,
    )
    diag_fn = (
        residuals.build_diag_fn(
            cfg, opt, depth_deform_weight=depth_deform_weight,
            use_triplets=use_smooth, use_adaptive=use_adaptive,
            pose_blocks=opt.lm_precond_pose_blocks,
        )
        if opt.lm_precond_exact
        else None
    )
    fix_spatial = opt.fix_spatial_transforms or (
        params.spatial_grid.shape[1] == 1 and params.spatial_grid.shape[2] == 1
    )
    mask = lm.make_mask(
        params,
        fix_poses=opt.fix_poses,
        fix_focal=(opt.intr_opt == "Fixed") or opt.fix_poses,
        fix_depth=opt.fix_depth_transforms,
        fix_spatial=fix_spatial,
    )
    out = _lm_solve(
        inputs, log, stage, params,
        res_fn, _robust_fn(cfg), params, mask, _lm_config(opt),
        aux=_aux(opt, inputs, use_smooth, cfg=cfg), diag_fn=diag_fn,
    )
    return out.params


def optimize_poses(
    opt: PoseOptParams, inputs: PoseOptInputs, params: SolverParams, log=None,
) -> SolverParams:
    """Full multi-step optimization (reference .cpp:788-888)."""
    sizes = ctf_grid_schedule(opt, inputs.aspect)
    device = params.pose.device
    if opt.deferred_spatial_opt:
        params = params._replace(
            spatial_grid=xforms.init_spatial_grid(inputs.num_frames, 1, 1, device)
        )

    for step in range(opt.num_steps):
        step_iter = step / (opt.num_steps - 1) if opt.num_steps > 1 else 0.0
        if opt.graduate_deformation_regularization:
            lo = math.log(opt.deformation_regularization_initial)
            hi = math.log(opt.deformation_regularization_final)
            deform = math.exp(lo + (hi - lo) * step_iter)
        else:
            deform = opt.deformation_regularization_final

        params = _solve_step(opt, inputs, params, deform, log=log, stage=f"step{step}")

        if opt.coarse_to_fine and step < opt.num_steps - 1:
            gx, gy = sizes[step + 1]
            spec = GridSpec(gx=gx, gy=gy, gz=params.depth_grid.shape[1])
            params = params._replace(depth_grid=xforms.split_grid(params.depth_grid, spec))
            if params.depth_shift is not None:
                params = params._replace(
                    depth_shift=xforms.split_grid(params.depth_shift, spec)
                )

    if opt.deferred_spatial_opt:
        dso_rows, dso_cols = opt.dso_long, opt.dso_short
        if inputs.aspect >= 1.0:
            dso_rows, dso_cols = dso_cols, dso_rows
        params = params._replace(
            spatial_grid=xforms.init_spatial_grid(
                inputs.num_frames, dso_rows, dso_cols, device
            )
        )
        params = _solve_step(
            opt, inputs, params, opt.deformation_regularization_final,
            spatial_cubic=True, log=log, stage="spatial",
        )
    return params


def _warm_run(
    opt: PoseOptParams, inputs: PoseOptInputs, initial: SolverParams, log=None,
) -> SolverParams:
    """One refinement solve at the previous solution's grid resolution,
    without the exact-diagonal preconditioner (see the JAX package)."""
    warm = dataclasses.replace(
        opt,
        lm_max_outer=opt.lm_warm_max_outer,
        lm_cg_iters=min(opt.lm_cg_iters, opt.lm_warm_cg_iters),
        lm_precond_exact=False,
    )
    sy, sx = initial.spatial_grid.shape[1:3]
    return _solve_step(
        warm, inputs, initial, opt.deformation_regularization_final,
        spatial_cubic=sx > 2 or sy > 2, log=log, stage="warm",
    )


def run(
    opt: PoseOptParams,
    inputs: PoseOptInputs,
    focal: torch.Tensor | None = None,
    initial: SolverParams | None = None,
    log: list | None = None,
) -> SolverParams:
    """normalize + optimize from fresh transforms — one
    `PoseOptimizer.optimize_poses()` call (reference
    pose_optimization.py:177-240). With `opt.warm_start` and a previous
    solution, refines that solution at its final grid resolution instead.
    Runs on the device of `inputs`."""
    with float32_precision(cudnn_tf32=False):
        if initial is not None and opt.warm_start:
            return _warm_run(opt, inputs, initial, log)
        n = inputs.num_frames
        device = inputs.median_depth.device
        with_shift = opt.value_xform == "ScaleShift"
        if initial is None:
            if focal is None:
                focal = torch.full(
                    (n,), _v_focal(opt, inputs.aspect), dtype=torch.float32,
                    device=device,
                )
            initial = default_solver_params(n, focal, opt.value_xform)
        else:
            # reset transforms, keep poses/focal (the reference resets
            # each epoch)
            dgrid, sgrid, shift = _identity_transforms(n, with_shift, device)
            initial = initial._replace(
                depth_grid=dgrid, spatial_grid=sgrid, depth_shift=shift
            )

        params = normalize_depth(opt, inputs, initial, log)
        params = optimize_poses(opt, inputs, params, log)

        if opt.use_global_scale:
            gs_opt = dataclasses.replace(
                opt, fix_poses=True, num_steps=1, coarse_to_fine=False
            )
            dgrid, sgrid, shift = _identity_transforms(
                n, params.depth_shift is not None, device
            )
            params = params._replace(
                depth_grid=dgrid, spatial_grid=sgrid, depth_shift=shift
            )
            params = normalize_depth(gs_opt, inputs, params, log)
            params = optimize_poses(gs_opt, inputs, params, log)
        return params
