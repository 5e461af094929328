"""DepthVideoProcessor equivalent: the op dispatcher over a VideoStore.

Port of robust_cvd_tpu/pipeline/processor.py, the API-parity facade for the
reference's processor (lib/Processor.{h,cpp}): ops Copy, BilateralFilter,
FlowGuidedFilter, ClipMaxDepth, ComputeConstraints, ComputeTracks,
GridXformSplit, ResetPoses, ResetDepthXforms, ResetSpatialXforms,
NormalizeDepth, OptimizePoses and ResetNormalizeOptimize, each mapped onto
the port's subsystems: the filters of ops/filters.py, the track table of
solver/tracks.py over the corner kernel's response, and the port's
PoseOptimizer and solver.

The filters run on `device` ("cuda" unless the caller asks for "cpu"); the
stores stay numpy on the host. `solve_log` gathers the solver ops' LM
solves (start and final cost, steps), which the JAX facade does not keep.
"""

from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional

import numpy as np
import torch

from ..camera import CameraState, quat_to_matrix
from ..config import PoseOptParams
from ..device import resolve_device
from ..io.store import VideoStore
from ..ops import filters, geometry
from ..solver import pose_opt, tracks, xforms
from ..solver.residuals import SolverParams
from ..solver.xforms import GridSpec


class Op(Enum):
    NONE = "none"
    COPY = "copy"
    BILATERAL_FILTER = "bilateral_filter"
    FLOW_GUIDED_FILTER = "flow_guided_filter"
    CLIP_MAX_DEPTH = "clip_max_depth"
    COMPUTE_CONSTRAINTS = "compute_constraints"
    COMPUTE_TRACKS = "compute_tracks"
    GRID_XFORM_SPLIT = "grid_xform_split"
    RESET_POSES = "reset_poses"
    RESET_DEPTH_XFORMS = "reset_depth_xforms"
    RESET_SPATIAL_XFORMS = "reset_spatial_xforms"
    NORMALIZE_DEPTH = "normalize_depth"
    OPTIMIZE_POSES = "optimize_poses"
    RESET_NORMALIZE_OPTIMIZE = "reset_normalize_optimize"


@dataclasses.dataclass
class ProcessorParams:
    """(reference lib/Processor.h:60-90)."""

    op: Op = Op.NONE
    depth_stream: str = ""
    source_depth_stream: str = ""
    spatial_radius: int = 0
    frame_radius: int = 2
    depth_sigma: float = 0.3
    color_sigma: float = 0.0
    median: bool = False
    far_connections: bool = False
    max_depth: float = 1000.0
    match_separation: int = 10
    track_spawn_distance: int = 20
    track_prune_distance: int = 5
    min_dynamic_distance: int = 3
    min_track_length: int = 4
    # GridXformSplit target (gx, gy[, gz]); the reference passes the new
    # descriptor through Params (Processor.cpp:888-985)
    grid_size: tuple = ()
    pose_optimizer: PoseOptParams = dataclasses.field(default_factory=PoseOptParams)


class Processor:
    def __init__(self, store: VideoStore, device="cuda"):
        self.store = store
        self.device = resolve_device(device)
        self.solver_params: Optional[SolverParams] = None
        self.solve_log: list = []  # one entry per LM solve of the solver ops
        self._pose = None

    # -- dispatch ------------------------------------------------------------

    def process(self, p: ProcessorParams):
        """All 13 ops (reference lib/Processor.cpp:115-144)."""
        handler = {
            Op.COPY: self.copy,
            Op.BILATERAL_FILTER: self.bilateral_filter,
            Op.FLOW_GUIDED_FILTER: self.flow_guided_filter,
            Op.CLIP_MAX_DEPTH: self.clip_max_depth,
            Op.COMPUTE_CONSTRAINTS: self.compute_constraints,
            Op.COMPUTE_TRACKS: self.compute_tracks,
            Op.GRID_XFORM_SPLIT: self.grid_xform_split_op,
            Op.RESET_POSES: self.reset_poses,
            Op.RESET_DEPTH_XFORMS: self.reset_depth_xforms,
            Op.RESET_SPATIAL_XFORMS: self.reset_spatial_xforms,
            Op.NORMALIZE_DEPTH: self.normalize_depth,
            Op.OPTIMIZE_POSES: self.optimize_poses,
            Op.RESET_NORMALIZE_OPTIMIZE: self.reset_normalize_optimize,
        }.get(p.op)
        if handler is None:
            raise ValueError(f"unsupported op {p.op}")
        return handler(p)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # -- ops -----------------------------------------------------------------

    def copy(self, p: ProcessorParams):
        """(reference Processor.cpp:152-181)."""
        self.store.duplicate_depth_stream(p.source_depth_stream, p.depth_stream)

    def bilateral_filter(self, p: ProcessorParams):
        depth = self._to_device(self.store.load_depth_stream(p.source_depth_stream))
        color = self._to_device(self.store.load_color_down()) if p.color_sigma > 0 else None
        out = filters.bilateral_filter(
            depth, p.spatial_radius, p.frame_radius, p.depth_sigma,
            color, p.color_sigma, p.median,
        )
        self.store.save_depth_stream(p.depth_stream, out.cpu().numpy())

    def flow_guided_filter(self, p: ProcessorParams):
        """(reference Processor.cpp:315-590 + pose_optimization.py:292-326)."""
        depth = self.store.load_depth_stream(p.source_depth_stream)
        out = self.flow_guided_filter_array(depth, p)
        self.store.save_depth_stream(p.depth_stream, out.cpu().numpy())

    def flow_guided_filter_array(self, depth, p: ProcessorParams) -> torch.Tensor:
        """Filter an in-memory (N, H, W) depth stack with the store's
        consecutive flows and camera state; returns it on the device."""
        args, kwargs = self.flow_guided_filter_inputs(depth, p)
        return filters.flow_guided_filter(*args, **kwargs)

    def flow_guided_filter_inputs(self, depth, p: ProcessorParams):
        """The arguments of filters.flow_guided_filter for `depth`, on the
        device: (args, kwargs)."""
        store = self.store
        depth = torch.as_tensor(np.asarray(depth, np.float32), device=self.device)
        n, h, w = depth.shape
        cams = self._filter_cameras((h, w))
        pts_cam = geometry.depth_to_points(depth, cams.intrinsics)
        world = geometry.points_cam_to_world(pts_cam, self._extrinsics()[:, None, None])

        flows_fwd = np.zeros((n, h, w, 2), np.float32)
        masks_fwd = np.zeros((n, h, w), bool)
        flows_bwd = np.zeros((n, h, w, 2), np.float32)
        masks_bwd = np.zeros((n, h, w), bool)
        for i in range(n - 1):
            try:
                flows_fwd[i] = store.load_flow(i, i + 1)
                masks_fwd[i] = store.load_flow_mask(i, i + 1)
                flows_bwd[i + 1] = store.load_flow(i + 1, i)
                masks_bwd[i + 1] = store.load_flow_mask(i + 1, i)
            except FileNotFoundError:
                continue

        far = {}
        if p.far_connections:
            far = self._far_connection_tensors((n, h, w), p.frame_radius)

        args = (depth, world, cams, self._to_device(flows_fwd), self._to_device(masks_fwd),
                self._to_device(flows_bwd), self._to_device(masks_bwd))
        return args, dict(frame_radius=p.frame_radius, median=p.median, **far)

    def _far_connection_tensors(self, shape, frame_radius: int):
        """Padded per-frame far-pair stacks for the flow-guided filter
        (reference Processor.cpp:414-426: pairs (i, fi) on disk with fi
        outside the +-frameRadius window around i)."""
        store = self.store
        n, h, w = shape
        by_frame = {i: [] for i in range(n)}
        for (i, j, _) in store.load_flow_list():
            if 0 <= i < n and 0 <= j < n and abs(j - i) > frame_radius:
                by_frame[i].append(j)
        f_max = max((len(v) for v in by_frame.values()), default=0)
        if f_max == 0:
            return {}
        far_flows = np.zeros((n, f_max, h, w, 2), np.float32)
        far_masks = np.zeros((n, f_max, h, w), bool)
        far_tgt = np.zeros((n, f_max), np.int64)
        far_valid = np.zeros((n, f_max), bool)
        for i, tgts in by_frame.items():
            for f, j in enumerate(tgts):
                try:
                    far_flows[i, f] = store.load_flow(i, j)
                    far_masks[i, f] = store.load_flow_mask(i, j)
                except FileNotFoundError:
                    continue
                far_tgt[i, f] = j
                far_valid[i, f] = True
        return dict(
            far_flows=self._to_device(far_flows),
            far_masks=self._to_device(far_masks),
            far_tgt=self._to_device(far_tgt),
            far_valid=self._to_device(far_valid),
        )

    def clip_max_depth(self, p: ProcessorParams):
        depth = self._to_device(self.store.load_depth_stream(p.source_depth_stream or p.depth_stream))
        self.store.save_depth_stream(
            p.depth_stream, filters.clip_max_depth(depth, p.max_depth).cpu().numpy()
        )

    def compute_tracks(self, p: ProcessorParams) -> tracks.TrackTable:
        """Corner response of every color_down frame (one corner-kernel
        launch on the card), then the host track bookkeeping."""
        from ..ops.corner import corner_min_eigenval
        from ..solver import constraints as C

        store = self.store
        gray = torch.from_numpy(C.rgb_to_gray(store.load_color_down()))
        corner = corner_min_eigenval(gray.to(self.device)).cpu().numpy()
        n = store.num_frames
        flows_fwd, masks_fwd = {}, {}
        for i in range(n - 1):
            try:
                flows_fwd[i] = store.load_flow(i, i + 1)
                masks_fwd[i] = store.load_flow_mask(i, i + 1)
            except FileNotFoundError:
                continue
        dyn = store.load_dynamic_mask()
        dyn_dist = None
        if dyn is not None:
            dyn_dist = np.stack([C.dynamic_distance(m, m.shape) for m in dyn])
        return tracks.compute_tracks(
            corner, flows_fwd, masks_fwd, store.inv_aspect, dyn_dist,
            p.track_spawn_distance, p.track_prune_distance,
            p.min_dynamic_distance, p.min_track_length,
        )

    def reset_poses(self, p: ProcessorParams):
        """(reference Processor.cpp:987-1003)."""
        self.store.camera = CameraState.default(
            self.store.num_frames, self.store.aspect, p.pose_optimizer.focal_long,
            device=self.device,
        )

    def grid_xform_split(self, grid: torch.Tensor, new_spec: GridSpec) -> torch.Tensor:
        """(reference Processor.cpp:888-985), for solver use."""
        return xforms.split_grid(grid, new_spec)

    def grid_xform_split_op(self, p: ProcessorParams):
        """GridXformSplit over the held solver state."""
        if self.solver_params is None:
            raise ValueError("GridXformSplit requires solver state (run "
                             "NormalizeDepth/OptimizePoses or set solver_params)")
        if len(p.grid_size) < 2:
            raise ValueError("GridXformSplit needs grid_size=(gx, gy[, gz])")
        gx, gy = p.grid_size[:2]
        gz = p.grid_size[2] if len(p.grid_size) > 2 else self.solver_params.depth_grid.shape[1]
        self.solver_params = self.solver_params._replace(
            depth_grid=xforms.split_grid(
                self.solver_params.depth_grid, GridSpec(gx=gx, gy=gy, gz=gz)
            )
        )
        return self.solver_params

    # -- constraint and solver ops (reference Processor.cpp:621-629, 1005-1034)

    def _pose_wrapper(self, p: ProcessorParams):
        """A PoseOptimizer bound to this store (it builds or loads the
        constraint set as Op.ComputeConstraints does)."""
        from ..config import PipelineConfig
        from .pose import PoseOptimizer

        if self._pose is None:
            stream = p.source_depth_stream or p.depth_stream
            if not stream:
                raise ValueError("constraint/solver ops need a depth stream name")
            cfg = PipelineConfig(path=self.store.base_dir, opt=p.pose_optimizer)
            self._pose = PoseOptimizer(cfg, self.store, stream, device=self.device)
            self._pose.solver_params = self.solver_params
        return self._pose

    def _set_solver_params(self, sp: SolverParams) -> SolverParams:
        self.solver_params = sp
        if self._pose is not None:
            self._pose.solver_params = sp
        return sp

    def compute_constraints(self, p: ProcessorParams):
        """(reference Processor.cpp:621-629)."""
        return self._pose_wrapper(p)

    def reset_depth_xforms(self, p: ProcessorParams):
        """Fresh Global(Scale) depth transforms (reference Processor.cpp:1005-1008)."""
        sp = self._ensure_solver_params(p)
        return self._set_solver_params(
            sp._replace(depth_grid=torch.ones_like(sp.depth_grid[:, :1, :1, :1]))
        )

    def reset_spatial_xforms(self, p: ProcessorParams):
        """Identity spatial transforms (reference Processor.cpp:1010-1013)."""
        sp = self._ensure_solver_params(p)
        return self._set_solver_params(
            sp._replace(spatial_grid=torch.zeros_like(sp.spatial_grid[:, :1, :1, :]))
        )

    def normalize_depth(self, p: ProcessorParams):
        """(reference Processor.cpp:1015-1019)."""
        pose = self._pose_wrapper(p)
        inputs = pose._make_inputs()
        sp = self._ensure_solver_params(p)
        return self._set_solver_params(
            pose_opt.normalize_depth(p.pose_optimizer, inputs, sp, log=self.solve_log)
        )

    def optimize_poses(self, p: ProcessorParams):
        """(reference Processor.cpp:1021-1025)."""
        pose = self._pose_wrapper(p)
        inputs = pose._make_inputs()
        sp = self._ensure_solver_params(p)
        return self._set_solver_params(
            pose_opt.optimize_poses(p.pose_optimizer, inputs, sp, log=self.solve_log)
        )

    def reset_normalize_optimize(self, p: ProcessorParams):
        """ResetPoses + ResetDepthXforms + ResetSpatialXforms + Normalize +
        Optimize (reference Processor.cpp:1027-1034)."""
        self.reset_poses(p)
        self.solver_params = None
        self._ensure_solver_params(p)
        self.normalize_depth(p)
        return self.optimize_poses(p)

    def _ensure_solver_params(self, p: ProcessorParams) -> SolverParams:
        if self.solver_params is None:
            focal = torch.full(
                (self.store.num_frames,),
                pose_opt._v_focal(p.pose_optimizer, self.store.aspect),
                dtype=torch.float32, device=self.device,
            )
            self.solver_params = pose_opt.default_solver_params(self.store.num_frames, focal)
        return self.solver_params

    # -- helpers -------------------------------------------------------------

    def _camera(self) -> CameraState:
        cam = self.store.camera
        if cam is None:
            cam = CameraState.default(self.store.num_frames, self.store.aspect)
        return CameraState(*[t.to(self.device) for t in cam])

    def _extrinsics(self) -> torch.Tensor:
        cam = self._camera()
        return torch.cat([quat_to_matrix(cam.quaternion), cam.position[:, :, None]], dim=2)

    def _filter_cameras(self, shape) -> filters.FilterCameras:
        cam = self._camera()
        rot = quat_to_matrix(cam.quaternion)
        # the camera looks down -Z: forward = R @ (0, 0, -1)
        return filters.FilterCameras(
            position=cam.position, forward=-rot[:, :, 2],
            intrinsics=geometry.intrinsics_px(cam.vfov, cam.hfov, shape),
        )
