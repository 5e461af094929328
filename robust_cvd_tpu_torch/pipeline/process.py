"""Pipeline orchestrator: the `DatasetProcessor`.

Port of robust_cvd_tpu/pipeline/process.py (reference process.py:52-240):
extract -> downscale (three resolutions) -> initial depth -> flow (masks,
pair stats) -> dynamic masks -> fine-tune, each stage timed by a
StageTracer into `stage_timings.json`. Stages are idempotent: each checks
for its outputs and skips (the reference's resumability contract,
process.py:150-152). The models come from their checkpoints under
`<path>/models/` and every stage runs on the processor's device.

With recon=colmap the fine-tune takes its poses fixed from a COLMAP
reconstruction (`_colmap_fixed_poses`) and runs no pose solve.

Not ported: Mask R-CNN dynamic masks (--mask_rcnn_weights raises
NotImplementedError before the mask stage).
"""

from __future__ import annotations

import os
import time
import traceback
from os.path import join as pjoin

import numpy as np
import torch

from ..config import PipelineConfig, echo_non_default
from ..device import resolve_device
from ..io.store import VideoStore
from ..utils.experiment import StageTracer
from .depth import compute_initial_depth
from .flow import FlowStage
from .pose import PoseOptimizer
from .video import VideoStage

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

    def pipeline(self) -> VideoStore:
        """Every stage in order on `cfg.path`; returns the clip's store and
        keeps the StageTracer (`tracer`) and the FineTuner (`tuner`)."""
        cfg = self.cfg
        if cfg.mask_rcnn_weights and os.path.exists(cfg.mask_rcnn_weights) and (
                cfg.opt.dynamic_constraints == "Mask"):
            # raised here, not in the mask stage, whose handler would take
            # it for a failed mask run and go on without masks
            raise NotImplementedError(
                "Mask R-CNN dynamic masks (--mask_rcnn_weights) are not ported yet "
                "(Mask R-CNN slice)"
            )
        echo_non_default(cfg)  # PRINT_PARAM_IF_NEQ (core/ParamsBase.h:25-28)
        tracer = self.tracer = StageTracer(device=self.device)
        video = VideoStage(cfg.path, cfg.video_file)
        with tracer.span("extract_frames"):
            meta = video.extract_frames()

        with tracer.span("downscale_frames"):
            # --short_side_target applies to the training resolutions only
            # (reference process.py:104-112)
            video.downscale_frames(
                "color_down", cfg.size, ".raw", cfg.align,
                short_side_target=cfg.short_side_target,
            )
            video.downscale_frames(
                "color_down_png", cfg.size, ".png", cfg.align,
                short_side_target=cfg.short_side_target,
            )
            video.downscale_frames("color_flow", FLOW_MAX_SIZE, ".png", FLOW_ALIGN)

        store = VideoStore.open(cfg.path)
        store.print_info()  # reference DepthVideo::printInfo

        with tracer.span("load_models"):
            depth_model = self._depth_model()
            self._flow_model_pair()

        with tracer.span("compute_initial_depth"):
            depth_stats: dict = {}
            depth = compute_initial_depth(
                store, depth_model, cfg.model_type, stats=depth_stats, device=self.device
            )
        for name, sec in depth_stats.items():
            tracer.spans.append({"name": f"compute_initial_depth/{name}", "sec": sec})

        flow_stage = FlowStage(store, *self._flow_model_pair(), device=self.device)
        index_pairs = flow_stage.sample_index_pairs(cfg.flow_ops, meta.num_frames)
        with tracer.span("compute_flow", pairs=len(index_pairs)):
            flow_stage.compute_flow(index_pairs)
        for name, sec in flow_stage.stats.items():
            tracer.spans.append({"name": f"compute_flow/{name}", "sec": sec})
        with tracer.span("compute_flow_masks"):
            flow_stage.compute_flow_masks(index_pairs)
        flow_stage.compute_flow_pair_stats(index_pairs)
        if cfg.vis_flow:
            with tracer.span("visualize_flow"):
                flow_stage.visualize_flow(index_pairs)

        # dynamic masks (the reference runs Mask R-CNN here, process.py:
        # 147-165): geometric motion segmentation from the flow; external
        # dynamic_mask/ frames take precedence
        if cfg.opt.dynamic_constraints == "Mask":
            from .masks import compute_dynamic_masks

            with tracer.span("compute_dynamic_mask"):
                if cfg.mask_rcnn_weights:
                    print(f"--mask_rcnn_weights {cfg.mask_rcnn_weights!r} not found; "
                          "falling back to motion segmentation")
                try:
                    compute_dynamic_masks(store)
                except Exception as e:  # mask failures do not abort the pipeline
                    traceback.print_exc()
                    print(f"dynamic mask generation failed ({e!r}); continuing")

        with tracer.span("fine_tune"):
            tuner = self.tuner = self.fine_tune(store, depth)

        out = self.out_dir(store.num_frames)
        os.makedirs(out, exist_ok=True)
        for name, sec in tuner.stats.items():
            tracer.spans.append({"name": f"fine_tune/{name}", "sec": sec})
        tracer.save(pjoin(out, "stage_timings.json"))
        return store

    def process(self):
        """`op=extract_frames` extracts the frames only; otherwise the whole
        pipeline (reference process.py:237-240)."""
        if self.cfg.op == "extract_frames":
            VideoStage(self.cfg.path, self.cfg.video_file).extract_frames()
            return None
        return self.pipeline()

    def fine_tune(self, store: VideoStore, depth: np.ndarray):
        """Constraints, cold solve and test-time training on `store`, from
        the initial depth (N, h, w); returns the FineTuner."""
        from ..training.fine_tune import FineTuner, build_clip_data
        from ..utils.experiment import make_tag

        t_setup = time.perf_counter()
        cfg = self.cfg
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
        images = store.load_color_down()
        pose_state_override, ref_disp = None, None
        if cfg.recon == "colmap":
            pose_state_override, ref_disp = self._colmap_fixed_poses(store, images.shape[1:3])
        clip = build_clip_data(
            images, depth, flow_list, store.flows,
            {k: np.asarray(v, np.float32) for k, v in store.flow_masks.items()},
            cfg.min_mask_ratio, use_temporal, ref_disp=ref_disp, device=self.device,
        )
        inputs = pose._make_inputs()
        adapter = self._depth_model()

        # experiment dir R{range}_{ops}_{model}/<tag> (reference
        # depth_fine_tuning.py:213-215)
        ft_dir = pjoin(self.out_dir(store.num_frames), make_tag(cfg))
        os.makedirs(ft_dir, exist_ok=True)
        tuner = FineTuner(
            cfg, adapter, clip, inputs, pose=pose, out_dir=ft_dir,
            pose_state_override=pose_state_override, device=self.device,
        )
        tuner.stats["setup_s"] = time.perf_counter() - t_setup
        tuner.run()
        return tuner

    def _colmap_fixed_poses(self, store: VideoStore, shape):
        """recon=colmap inputs (reference depth_fine_tuning.py:296-318,
        494-511): the fixed extrinsics and pixel intrinsics of the COLMAP
        metadata npz as a PoseState on the device (unit scale maps, no
        warp), and with scaling=depth the reference disparity of
        <path>/depth_colmap_dense/depth/*.raw, nearest-resized to the
        training resolution `shape` (the reference hardcodes 224 x 384).

        scaling=extrinsics reads metadata_scaled.npz from the range dir
        (poses pre-scaled by the COLMAP calibration chain, io/colmap.py);
        scaling=depth reads <path>/colmap_dense/metadata.npz."""
        from ..io import raw as raw_io
        from ..training.fine_tune import PoseState

        cfg = self.cfg
        if cfg.scaling == "extrinsics":
            meta_file = pjoin(self.out_dir(store.num_frames), "metadata_scaled.npz")
        else:
            meta_file = pjoin(cfg.path, "colmap_dense", "metadata.npz")
        if not os.path.exists(meta_file):
            raise FileNotFoundError(
                f"--recon colmap needs {meta_file} (run the COLMAP import "
                "chain, io/colmap.py / io/importers.py, first)"
            )
        with np.load(meta_file) as meta:
            ext = np.asarray(meta["extrinsics"], np.float32)  # (N, 3, 4)
            intr = np.asarray(meta["intrinsics"], np.float32)  # (N, 4) px
        n = store.num_frames
        if ext.shape[0] != n:
            raise ValueError(f"metadata npz has {ext.shape[0]} frames, clip has {n}")
        h, w = shape
        ps = PoseState(
            extrinsics=torch.from_numpy(ext).to(self.device),
            intrinsics=torch.from_numpy(intr).to(self.device),
            scales=torch.ones((n, h, w), device=self.device),
            warp=torch.zeros((n, h, w, 2), device=self.device),
        )
        ref_disp = None
        if cfg.scaling == "depth":
            ref_disp = np.empty((n, h, w), np.float32)
            for i in range(n):
                d = raw_io.load_raw_float32_image(
                    pjoin(cfg.path, "depth_colmap_dense", "depth", f"frame_{i:06d}.raw")
                )
                ys = (np.arange(h) * d.shape[0] // h).clip(0, d.shape[0] - 1)
                xs = (np.arange(w) * d.shape[1] // w).clip(0, d.shape[1] - 1)
                ref_disp[i] = d[ys[:, None], xs[None, :]]
        return ps, ref_disp
