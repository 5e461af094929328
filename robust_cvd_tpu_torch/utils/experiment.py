"""Experiment tag naming and stage tracing.

Port of robust_cvd_tpu/utils/experiment.py: make_loss_str and make_tag
(tag grammar of reference loss/loss_params.py:114-144 and
depth_fine_tuning.py:194-204), so that both packages name experiment
directories alike, and StageTracer, whose stages are spans of
utils/spans.py.
"""

from __future__ import annotations

import contextlib
import json
from typing import Dict, List

import torch

from ..config import LossParams, PipelineConfig
from .spans import span


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


class StageTracer:
    """Per-stage wall-clock spans (the reference prints perf_counter times,
    depth_fine_tuning.py:228-602), saved as a JSON timeline. Each stage is
    also a span of utils/spans.py, the parent of the spans inside it.

    `device` is where the stages run: on a CUDA device a span synchronizes
    it before it stops the clock, so a stage's seconds hold the device work
    it queued."""

    def __init__(self, device=None):
        self.spans: List[Dict] = []
        self.device = torch.device(device) if device is not None else None

    @contextlib.contextmanager
    def span(self, name: str, **meta):
        sp = span(name, **meta)
        try:
            with sp:
                try:
                    yield
                finally:
                    if self.device is not None and self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
        finally:
            self.spans.append({"name": name, "sec": sp.seconds, **meta})

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s["name"]] = out.get(s["name"], 0.0) + s["sec"]
        return out

    def save(self, path):
        with open(path, "w") as f:
            json.dump({"spans": self.spans, "summary": self.summary()}, f, indent=1)
