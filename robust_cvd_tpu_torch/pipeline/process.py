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

The dynamic-mask stage runs Mask R-CNN where --mask_rcnn_weights names an
existing detectron2 checkpoint (its stats become compute_dynamic_mask/<name>
spans, and a failure raises), and motion segmentation otherwise.

On a data mesh (parallel/mesh.py, e.g. under torchrun) every rank runs the
pipeline on the processor's device, which must be the mesh's: the initial
depth, flow, Mask R-CNN and fine-tune stages share their work over the
ranks; frame extraction, the downscales, motion segmentation, the
constraint build and its flow_constraints.dat, and stage_timings.json
are rank 0's, with barriers around them. Every rank then reads the
constraints and solves on its share of them (the solver sums over the
ranks). Every rank writes the same result tree as one process would,
together.
"""

from __future__ import annotations

import os
import traceback
from os.path import join as pjoin

import numpy as np
import torch

from ..config import PipelineConfig, echo_non_default
from ..device import resolve_device
from ..io.store import VideoStore
from ..parallel import mesh as pmesh
from ..utils.experiment import StageTracer
from ..utils.spans import span
from .depth import compute_initial_depth
from .flow import FlowStage
from .pose import PoseOptimizer
from .video import VideoStage

FLOW_MAX_SIZE = 1024  # reference flow.py:40-42
FLOW_ALIGN = 64


class DatasetProcessor:
    def __init__(self, cfg: PipelineConfig, models: dict | None = None,
                 device="cuda"):
        """models: optional dict with 'depth' (a depth-model adapter, e.g.
        MidasV2Adapter) and 'flow' (a RAFT) entries, loaded from their
        checkpoints otherwise. `device` is where every stage runs ("cuda"
        unless the caller asks for "cpu")."""
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
        """The adapter that cfg.model_type names (models/registry.py), its
        net loaded from <path>/models/<its checkpoint> or the file its
        environment variable names."""
        if "depth" not in self.models:
            from ..models.registry import get_depth_model

            adapter = get_depth_model(self.cfg.model_type)
            ckpt = pjoin(self.cfg.path, "models", adapter.checkpoint)
            if not os.path.exists(ckpt):
                ckpt = os.environ.get(adapter.checkpoint_env, "")
            if not ckpt or not os.path.exists(ckpt):
                raise FileNotFoundError(
                    f"{self.cfg.model_type} checkpoint not found; set "
                    f"{adapter.checkpoint_env} or place models/{adapter.checkpoint} under --path"
                )
            self.models["depth"] = adapter.from_checkpoint(ckpt)
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
        mesh = self._mesh()
        writer = pmesh.is_writer(mesh)
        if writer:
            echo_non_default(cfg)  # PRINT_PARAM_IF_NEQ (core/ParamsBase.h:25-28)
        tracer = self.tracer = StageTracer(device=self.device)
        video = VideoStage(cfg.path, cfg.video_file)
        with tracer.span("extract_frames"):
            if writer:
                meta = video.extract_frames()
            pmesh.barrier(mesh)
            if not writer:
                meta = video.extract_frames()  # reads the frames.txt rank 0 wrote

        with tracer.span("downscale_frames"):
            # --short_side_target applies to the training resolutions only
            # (reference process.py:104-112)
            if writer:
                video.downscale_frames(
                    "color_down", cfg.size, ".raw", cfg.align,
                    short_side_target=cfg.short_side_target,
                )
                video.downscale_frames(
                    "color_down_png", cfg.size, ".png", cfg.align,
                    short_side_target=cfg.short_side_target,
                )
                video.downscale_frames("color_flow", FLOW_MAX_SIZE, ".png", FLOW_ALIGN)
            pmesh.barrier(mesh)

        store = VideoStore.open(cfg.path)
        if writer:
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
        if cfg.vis_flow and writer:
            with tracer.span("visualize_flow"):
                flow_stage.visualize_flow(index_pairs)

        # dynamic masks (the reference runs Mask R-CNN here, process.py:
        # 147-165): Mask R-CNN with existing --mask_rcnn_weights, geometric
        # motion segmentation from the flow otherwise; external
        # dynamic_mask/ frames take precedence. Unlike the JAX package, a
        # Mask R-CNN failure (an unreadable checkpoint, a missing key, a
        # CUDA error) raises out of the pipeline: the "continuing" handler
        # wraps motion segmentation only.
        if cfg.opt.dynamic_constraints == "Mask":
            from .masks import compute_dynamic_masks, compute_dynamic_masks_rcnn

            mask_stats: dict = {}
            with tracer.span("compute_dynamic_mask"):
                if cfg.mask_rcnn_weights and os.path.exists(cfg.mask_rcnn_weights):
                    compute_dynamic_masks_rcnn(store, cfg.mask_rcnn_weights, stats=mask_stats,
                                               device=self.device)
                else:
                    if writer and cfg.mask_rcnn_weights:
                        print(f"--mask_rcnn_weights {cfg.mask_rcnn_weights!r} not found; "
                              "falling back to motion segmentation")
                    try:
                        if writer:  # host numpy, off the mesh as in the JAX package
                            compute_dynamic_masks(store)
                    except Exception as e:  # mask failures do not abort the pipeline
                        traceback.print_exc()
                        print(f"dynamic mask generation failed ({e!r}); continuing")
                    pmesh.barrier(mesh)
            for name, sec in mask_stats.items():
                tracer.spans.append({"name": f"compute_dynamic_mask/{name}", "sec": sec})

        with tracer.span("fine_tune"):
            tuner = self.tuner = self.fine_tune(store, depth)

        out = self.out_dir(store.num_frames)
        for name, sec in tuner.stats.items():
            tracer.spans.append({"name": f"fine_tune/{name}", "sec": sec})
        if writer:
            os.makedirs(out, exist_ok=True)
            tracer.save(pjoin(out, "stage_timings.json"))
        pmesh.barrier(mesh)
        return store

    def _mesh(self):
        """pipeline_mesh(), which must compute on the processor's device."""
        mesh = pmesh.pipeline_mesh()
        if mesh is not None and mesh.device != self.device:
            raise ValueError(f"the mesh computes on {mesh.device}, the processor on "
                             f"{self.device}")
        return mesh

    def process(self):
        """`op=extract_frames` extracts the frames only; otherwise the whole
        pipeline (reference process.py:237-240)."""
        if self.cfg.op == "extract_frames":
            mesh = self._mesh()
            if pmesh.is_writer(mesh):
                VideoStage(self.cfg.path, self.cfg.video_file).extract_frames()
            pmesh.barrier(mesh)
            return None
        return self.pipeline()

    def fine_tune(self, store: VideoStore, depth: np.ndarray):
        """Constraints, cold solve and test-time training on `store`, from
        the initial depth (N, h, w); returns the FineTuner. On a mesh, rank
        0 builds the constraints and writes flow_constraints.dat, the other
        ranks read them from it, and every rank solves on its share of them
        (shard_pose_inputs) and trains; rank 0 writes. The tuner's build
        is the span `fine_tune.setup`, its seconds `stats["setup_s"]`."""
        with span("fine_tune.setup") as setup:
            tuner = self._tuner(store, depth)
        tuner.stats["setup_s"] = setup.seconds
        tuner.run()
        return tuner

    def _tuner(self, store: VideoStore, depth: np.ndarray):
        """The FineTuner of `store` and the initial depth: the pose
        optimizer and its constraints, the clip on the device, the depth
        model and the experiment dir."""
        from ..training.fine_tune import FineTuner, build_clip_data
        from ..utils.experiment import make_tag

        cfg = self.cfg
        mesh = self._mesh()
        writer = pmesh.is_writer(mesh)
        stream = f"depth_{cfg.model_type}"
        if writer:
            pose = PoseOptimizer(cfg, store, stream, device=self.device)
        pmesh.barrier(mesh)
        if not writer:  # rank 0's flow_constraints.dat
            pose = PoseOptimizer(cfg, store, stream, device=self.device)
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
        if mesh is not None:
            # the solve sharded over the constraints, as the JAX package's
            # (its pipeline/pose.py: shard_pose_inputs where a mesh exists)
            inputs = pmesh.shard_pose_inputs(inputs, mesh)
        adapter = self._depth_model()

        # experiment dir R{range}_{ops}_{model}/<tag> (reference
        # depth_fine_tuning.py:213-215)
        ft_dir = pjoin(self.out_dir(store.num_frames), make_tag(cfg))
        os.makedirs(ft_dir, exist_ok=True)
        return FineTuner(
            cfg, adapter, clip, inputs, pose=pose if writer else None, out_dir=ft_dir, mesh=mesh,
            pose_state_override=pose_state_override, device=self.device,
        )

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
