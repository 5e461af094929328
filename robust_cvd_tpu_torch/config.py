"""Configuration — one set of dataclasses for all pipeline parameters.

A copy of robust_cvd_tpu/config.py: the dataclasses with identical
defaults (reference lib/PoseOptimizer.h:54-108, loss/loss_params.py,
depth_fine_tuning.py:52-117, params.py:29-264) and the command-line parser
with the same flags, dotted `--opt.*` names, defaults and validation, so
command lines carry over between the two packages.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field

from .utils.frame_range import FrameRange
from .utils.frame_sampling import SamplePairsMode

STATIC_LOSS_TYPES = ("Euclidean", "ReproDisparity", "ReproDepthRatio", "ReproLogDepth")
SMOOTH_LOSS_TYPES = (
    "EuclideanLaplacian",
    "ReproDisparityLaplacian",
    "ReproDepthRatioConsistency",
    "ReproLogDepthConsistency",
)
INTR_OPT_MODES = ("Fixed", "Shared", "PerFrame")
DYNAMIC_CONSTRAINT_MODES = ("None", "Mask", "Ransac")
DIST_NAMES = ("l1", "l2", "smooth_l1", "cauchy", "general")


@dataclass(frozen=True)
class PoseOptParams:
    """Pose/deformation solver parameters.

    Defaults match reference lib/PoseOptimizer.h:54-108. `max_iterations`
    (Ceres' per-solve iteration cap, reference PoseOptimizer.cpp:954-961)
    caps this solver's LM outer iterations: the effective cap is
    min(lm_max_outer, max_iterations) for cold solves and
    min(lm_warm_max_outer, max_iterations) for warm ones (pose_opt.py).
    `num_threads` is accepted for CLI compatibility but has no analog: the
    solve runs on the GPU, not in the reference's 12 CPU threads; a
    non-default value prints a warning at parse time.
    """

    max_iterations: int = 1000
    num_threads: int = 12
    num_steps: int = 4
    robustness: float = 0.5

    static_loss_type: str = "ReproDisparity"
    static_spatial_weight: float = 1.0
    static_depth_weight: float = 1.0

    smooth_loss_type: str = "ReproDisparityLaplacian"
    smooth_static_weight: float = 0.0
    smooth_dynamic_weight: float = 0.0

    position_regularization: float = 0.0
    scale_regularization: float = 1.0
    scale_regularization_grid_size: int = 10
    deformation_regularization_initial: float = 1.0
    deformation_regularization_final: float = 0.1
    adaptive_deformation_cost: float = 0.0
    spatial_deformation_regularization: float = 1.0
    graduate_deformation_regularization: bool = False
    focal_regularization: float = 1.0

    coarse_to_fine: bool = True
    ctf_long: int = 17
    ctf_short: int = 10

    deferred_spatial_opt: bool = False
    dso_long: int = 4
    dso_short: int = 3

    # tan(fov/2) on the long image side; iPhone-7 default
    # (reference lib/PoseOptimizer.h:92-94).
    focal_long: float = 0.3461538376301239
    intr_opt: str = "PerFrame"

    fix_poses: bool = False
    fix_depth_transforms: bool = False
    fix_spatial_transforms: bool = False
    normalize_depth_from_first_frame: bool = True

    use_global_scale: bool = False
    epipolar_dist_thresh: float = 2.0
    dynamic_constraints: str = "Mask"
    # Depth value transform: Scale (reference pipeline default) or
    # ScaleShift (reference lib/ValueTransform.h:57-94).
    value_xform: str = "Scale"

    # LM solver knobs (no reference equivalent — Ceres internals). The
    # values match robust_cvd_tpu/config.py; the measurements that chose
    # them were taken on the JAX package (see the comments there).
    lm_lambda_init: float = 1e-3
    lm_max_outer: int = 50
    # CG cap, used with the pose-block-Jacobi preconditioner below
    lm_cg_iters: int = 16
    lm_rtol: float = 1e-6
    # Hutchinson probes per outer step for a diag(J^T J) estimate where the
    # exact diagonal is off (warm re-solves, or lm_precond_exact false);
    # 0 = plain CG there (solver/lm.py)
    lm_precond_probes: int = 0
    # exact diag(J^T J) Jacobi preconditioning of cold solves
    # (solver/residuals.py build_diag_fn); warm re-solves turn it off
    lm_precond_exact: bool = True
    # also solve the exact per-frame 6x6 pose blocks of J^T J in the
    # preconditioner (block Jacobi)
    lm_precond_pose_blocks: bool = True
    # warm-start epoch re-solves from the previous solution at its final
    # grid resolution instead of reset + normalize + coarse-to-fine
    warm_start: bool = True
    lm_warm_max_outer: int = 10
    lm_warm_cg_iters: int = 16


@dataclass(frozen=True)
class LossParams:
    """Fine-tuning loss weights (defaults: reference loss/loss_params.py)."""

    distance_type_static: str = "l1"
    distance_alpha: float = 1.0
    distance_scale: float = 1.0
    distance_type_smooth: str = "l1"
    lambda_static_disparity: float = 0.0
    lambda_static_depth_ratio: float = 100.0
    lambda_static_reprojection: float = 1.0
    lambda_scene_flow_static: float = 0.0
    lambda_smooth_disparity: float = 0.0
    lambda_smooth_depth_ratio: float = 0.0
    lambda_smooth_reprojection: float = 0.0
    lambda_parameter: float = 0.0
    lambda_disparity_smooth: float = 0.0
    sigma_color_grad: float = 1.0
    lambda_contrast_thresh: float = 1.05
    lambda_contrast_loss: float = 1.0


@dataclass(frozen=True)
class FineTuneParams:
    """Test-time fine-tuning (defaults: reference depth_fine_tuning.py:52-117)."""

    optimizer: str = "Adam"
    # keep Adam's first moment in bf16; off, as the reference trains with
    # f32 torch Adam
    optimizer_mu_bf16: bool = False
    val_epoch_freq: int = -1
    learning_rate: float = 0.0  # <= 0: use the model adapter's default
    batch_size: int = 2
    num_epochs: int = 10
    pose_opt_freq: int = 1
    log_dir: str = ""
    display_freq: int = 100
    print_freq: int = 1
    save_epoch_freq: int = 1
    save_eval_images: bool = False
    save_depth_xform_maps: bool = False
    save_checkpoints: bool = False
    save_tensorboard: bool = True
    tensorboard_log_path: str = ""
    save_scene_flow_vis: bool = False
    save_intermediate_depth_streams_freq: int = 0
    save_depth_visualization: bool = False


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level run config (reference params.py:29-264 CLI surface)."""

    op: str = "all"  # all | extract_frames
    path: str = ""
    video_file: str = ""
    recon: str = "i3d"
    scaling: str = "depth"

    # video stage
    size: int = 384
    short_side_target: bool = False
    align: int = 32  # <= 0: use the model adapter's requirement

    # flow stage
    flow_ops: tuple = ("hierarchical2",)
    min_mask_ratio: float = 0.2
    vis_flow: bool = False
    flow_model: str = "raft"

    # model
    model_type: str = "midas2"
    # path to a detectron2 mask_rcnn_R_50_FPN checkpoint (.pkl); when set
    # and present, dynamic masks come from the Flax Mask R-CNN
    # (models/mask_rcnn.py) instead of geometric motion segmentation
    mask_rcnn_weights: str = ""
    frame_range: str = ""
    exp_tag: str = "short"

    # post filter
    post_filter: bool = False
    filter_radius: int = 4

    # Parsed-but-unused in the REFERENCE as well: params.py:215-217 defines
    # them for the commented-out make-video path (process.py:242-340) and no
    # reference code ever reads them. Kept for CLI compatibility.
    save_static: bool = False
    save_finetuning: bool = False
    save_vis: bool = False

    opt: PoseOptParams = field(default_factory=PoseOptParams)
    loss: LossParams = field(default_factory=LossParams)
    ft: FineTuneParams = field(default_factory=FineTuneParams)

    def resolved_frame_range(self, num_frames: int) -> FrameRange:
        return FrameRange(self.frame_range).resolve(num_frames)


def _add_dataclass_args(parser, dc_type, prefix=""):
    for f in dataclasses.fields(dc_type):
        if dataclasses.is_dataclass(f.type) or f.name in ("opt", "loss", "ft"):
            continue
        name = f"--{prefix}{f.name}"
        default = f.default if f.default is not dataclasses.MISSING else None
        if default is None and f.default_factory is not dataclasses.MISSING:  # type: ignore
            default = f.default_factory()  # type: ignore
        if isinstance(default, bool):
            parser.add_argument(name, type=_str2bool, default=default)
        elif isinstance(default, tuple):
            parser.add_argument(name, nargs="*", default=list(default))
        elif isinstance(default, int):
            parser.add_argument(name, type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(name, type=float, default=default)
        else:
            parser.add_argument(name, type=str, default=default)


def _str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="robust_cvd_tpu_torch",
        description="Robust Consistent Video Depth on PyTorch and CUDA",
    )
    _add_dataclass_args(parser, PipelineConfig)
    _add_dataclass_args(parser, PoseOptParams, prefix="opt.")
    _add_dataclass_args(parser, LossParams, prefix="")
    _add_dataclass_args(parser, FineTuneParams, prefix="")
    return parser


def parse_config(argv=None) -> PipelineConfig:
    parser = build_parser()
    ns = vars(parser.parse_args(argv))

    def pick(dc_type, prefix=""):
        kwargs = {}
        for f in dataclasses.fields(dc_type):
            key = f"{prefix}{f.name}"
            if key in ns:
                val = ns[key]
                if isinstance(getattr(dc_type(), f.name, None), tuple) and isinstance(
                    val, list
                ):
                    val = tuple(val)
                kwargs[f.name] = val
        return dc_type(**kwargs)

    cfg = PipelineConfig(
        **{
            f.name: ns[f.name]
            for f in dataclasses.fields(PipelineConfig)
            if f.name in ns and f.name not in ("opt", "loss", "ft")
        }
    )
    cfg = dataclasses.replace(
        cfg,
        flow_ops=tuple(cfg.flow_ops),
        opt=pick(PoseOptParams, "opt."),
        loss=pick(LossParams),
        ft=pick(FineTuneParams),
    )
    for mode in cfg.flow_ops:
        SamplePairsMode(mode)  # validate
    if cfg.recon not in ("i3d", "colmap"):
        # the reference parses "hd_depth" too (params.py:46-47) but has no
        # code path for it
        raise SystemExit(
            f"--recon must be i3d or colmap, got {cfg.recon!r} "
            "(hd_depth has no implementation in the reference either)"
        )
    if cfg.scaling not in ("extrinsics", "depth"):
        raise SystemExit(
            f"--scaling must be extrinsics or depth, got {cfg.scaling!r}"
        )
    if cfg.flow_model != "raft":
        # reference params.py:90: choices=["raft"]
        raise SystemExit(f"--flow_model must be raft, got {cfg.flow_model!r}")
    if cfg.opt.num_threads != PoseOptParams().num_threads:
        print(
            f"warning: --opt.num_threads {cfg.opt.num_threads} has no "
            "effect: the solve runs on the GPU, not in the reference's "
            "multi-threaded CPU solve (lib/PoseOptimizer.h:57)"
        )
    if cfg.opt.value_xform not in ("Scale", "ScaleShift"):
        raise SystemExit(
            f"--opt.value_xform must be Scale or ScaleShift, got "
            f"{cfg.opt.value_xform!r}"
        )
    if cfg.opt.static_loss_type not in STATIC_LOSS_TYPES:
        raise SystemExit(
            f"--opt.static_loss_type must be one of {STATIC_LOSS_TYPES}"
        )
    if cfg.opt.dynamic_constraints not in DYNAMIC_CONSTRAINT_MODES:
        raise SystemExit(
            f"--opt.dynamic_constraints must be one of {DYNAMIC_CONSTRAINT_MODES}"
        )
    return cfg


def non_default_params(cfg: PipelineConfig) -> list:
    """Lines describing every config value that differs from its default
    (reference PRINT_PARAM_IF_NEQ, lib/core/ParamsBase.h:25-28: the C++
    side prints only changed params at startup, so runs are reproducible
    from the log)."""

    def walk(obj, default, prefix=""):
        lines = []
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            d = getattr(default, f.name)
            if dataclasses.is_dataclass(v):
                lines += walk(v, d, f"{prefix}{f.name}.")
            elif v != d:
                lines.append(f"{prefix}{f.name} = {v!r} (default {d!r})")
        return lines

    return walk(cfg, PipelineConfig(path=cfg.path))


def echo_non_default(cfg: PipelineConfig) -> None:
    lines = non_default_params(cfg)
    if lines:
        print("Non-default parameters:")
        for ln in lines:
            print(f"  {ln}")
