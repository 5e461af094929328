"""Experiment tag naming.

A copy of make_loss_str and make_tag of robust_cvd_tpu/utils/experiment.py
(tag grammar of reference loss/loss_params.py:114-144 and
depth_fine_tuning.py:194-204), so that both packages name experiment
directories alike.
"""

from __future__ import annotations

from ..config import LossParams, PipelineConfig


def make_loss_str(loss: LossParams, exp_tag: str = "short") -> str:
    if exp_tag == "short":
        return (
            f"StD{loss.lambda_static_depth_ratio}"
            f"_StR{loss.lambda_static_reprojection}"
            f"_SmD{loss.lambda_smooth_depth_ratio}"
            f"_SmR{loss.lambda_smooth_reprojection}"
        )
    dist = loss.distance_type_static
    dist_str = dist
    if dist == "general":
        dist_str += f"-a{loss.distance_alpha}"
    if loss.distance_scale != 1:
        dist_str += f"-c{loss.distance_scale}"
    return (
        f"B{loss.lambda_static_disparity}"
        f"_R{loss.lambda_static_reprojection}"
        f"_St{loss.lambda_scene_flow_static}"
        f"_Sp{loss.lambda_disparity_smooth}"
        f"_{dist_str}"
        f"_PL1-{loss.lambda_parameter}"
    )


def make_tag(cfg: PipelineConfig) -> str:
    """(reference depth_fine_tuning.py:194-204)."""
    if cfg.exp_tag == "short":
        return make_loss_str(cfg.loss, "short")
    lr = cfg.ft.learning_rate
    return (
        make_loss_str(cfg.loss, "full")
        + f"_LR{lr}"
        + f"_BS{cfg.ft.batch_size}"
        + f"_O{cfg.ft.optimizer.lower()}"
        + f"_S{cfg.scaling}"
    )
