"""Pipeline orchestrator: the `DatasetProcessor`.

Port of robust_cvd_tpu/pipeline/process.py (reference process.py:52-240).
Ported so far: the experiment directory, the MiDaS and RAFT models (from
their checkpoints, on the processor's device) and the fine-tune stage
(`fine_tune(store, depth)`: pose constraints, the cold solve, the epochs of
training with depth refreshes and warm re-solves, the fine-tuned depth
stream and video.dat). The flow stage itself is
`pipeline/flow.py::FlowStage`; the whole pipeline (`pipeline()`: frame
extraction, the stages in order, stage tracing) comes with the
orchestration slice and raises NotImplementedError.
"""

from __future__ import annotations

import os
import time
from os.path import join as pjoin

import numpy as np

from ..config import PipelineConfig
from ..device import resolve_device
from ..io.store import VideoStore
from .pose import PoseOptimizer

FLOW_MAX_SIZE = 1024  # reference flow.py:40-42
FLOW_ALIGN = 64


class DatasetProcessor:
    def __init__(self, cfg: PipelineConfig, models: dict | None = None,
                 device="cuda"):
        """models: optional dict with 'depth' (a MidasV2Adapter) and 'flow'
        (a RAFT) entries, loaded from their checkpoints otherwise. `device`
        is where every stage runs ("cuda" unless the caller asks for
        "cpu")."""
        self.cfg = cfg
        self.models = models or {}
        self.device = resolve_device(device)

    def out_dir(self, num_frames: int) -> str:
        """R{range}_{flow_ops}_{model} (reference process.py:82-89)."""
        rng = self.cfg.resolved_frame_range(num_frames)
        return pjoin(
            self.cfg.path,
            f"R{rng.to_string().replace(',', '_')}_"
            f"{'_'.join(self.cfg.flow_ops)}_{self.cfg.model_type}",
        )

    def _depth_model(self):
        if "depth" not in self.models:
            from ..models import midas

            ckpt = pjoin(self.cfg.path, "models", "midas_v21-f6b98070.pt")
            if not os.path.exists(ckpt):
                ckpt = os.environ.get("MIDAS_CHECKPOINT", "")
            if not ckpt or not os.path.exists(ckpt):
                raise FileNotFoundError(
                    "MiDaS checkpoint not found; set MIDAS_CHECKPOINT or place "
                    "models/midas_v21-f6b98070.pt under --path"
                )
            net = midas.MidasNet()
            net.load_state_dict(midas.load_checkpoint(ckpt))
            self.models["depth"] = midas.MidasV2Adapter(net)
        return self.models["depth"]

    def _flow_model(self):
        """RAFT (bf16, 20 iterations) with <path>/models/raft-things.pth or
        RAFT_CHECKPOINT, on the processor's device."""
        if "flow" not in self.models:
            from ..models import raft

            ckpt = pjoin(self.cfg.path, "models", "raft-things.pth")
            if not os.path.exists(ckpt):
                ckpt = os.environ.get("RAFT_CHECKPOINT", "")
            if not ckpt or not os.path.exists(ckpt):
                raise FileNotFoundError(
                    "RAFT checkpoint not found; set RAFT_CHECKPOINT or place "
                    "models/raft-things.pth under --path"
                )
            net = raft.RAFT()
            net.load_state_dict(raft.load_checkpoint(ckpt))
            self.models["flow"] = net.to(self.device).eval()
        return self.models["flow"]

    def _flow_model_pair(self):
        """(RAFT module, weights to load into it or None): the arguments
        FlowStage takes after the store."""
        m = self._flow_model()
        return (m[0], m[1]) if isinstance(m, tuple) else (m, None)

    def pipeline(self):
        raise NotImplementedError(
            "the whole pipeline (frames, stages in order, tracing) is not ported yet "
            "(orchestration slice)"
        )

    def fine_tune(self, store: VideoStore, depth: np.ndarray):
        """Constraints, cold solve and test-time training on `store`, from
        the initial depth (N, h, w); returns the FineTuner."""
        from ..training.fine_tune import FineTuner, build_clip_data
        from ..utils.experiment import make_tag

        t_setup = time.perf_counter()
        cfg = self.cfg
        if cfg.recon == "colmap":
            raise NotImplementedError(
                "recon=colmap fixed poses are not ported yet (importers slice)"
            )
        pose = PoseOptimizer(cfg, store, f"depth_{cfg.model_type}", device=self.device)
        flow_list = store.load_flow_list()
        for (i, j, _r) in flow_list:
            store.load_flow(i, j)
            store.load_flow_mask(i, j)
        use_temporal = (
            cfg.loss.lambda_smooth_disparity > 0
            or cfg.loss.lambda_smooth_reprojection > 0
            or cfg.loss.lambda_smooth_depth_ratio > 0
        )
        clip = build_clip_data(
            store.load_color_down(), depth, flow_list, store.flows,
            {k: np.asarray(v, np.float32) for k, v in store.flow_masks.items()},
            cfg.min_mask_ratio, use_temporal, device=self.device,
        )
        inputs = pose._make_inputs()
        adapter = self._depth_model()

        # experiment dir R{range}_{ops}_{model}/<tag> (reference
        # depth_fine_tuning.py:213-215)
        ft_dir = pjoin(self.out_dir(store.num_frames), make_tag(cfg))
        os.makedirs(ft_dir, exist_ok=True)
        tuner = FineTuner(
            cfg, adapter, clip, inputs, pose=pose, out_dir=ft_dir, device=self.device,
        )
        tuner.stats["setup_s"] = time.perf_counter() - t_setup
        tuner.run()
        return tuner
