"""Pose-optimization stage: store -> constraints -> solver.

Port of robust_cvd_tpu/pipeline/pose.py (reference
pose_optimization.py:98-326): builds flow constraints from the result
folder (through the corner kernel on the card), caches them in
`flow_constraints.dat`, sets static flags and runs the LM solver.

Static flags come from the dynamic masks (dynamic_constraints="Mask") or
from a RANSAC fundamental matrix per pair ("Ransac", ops/epipolar.py).
A `depth_gt/` directory (with an optional `poses.txt`) and a COLMAP
reconstruction (`colmap_dense/metadata.npz` with `depth_colmap_dense/`)
are imported as extra depth streams ahead of the estimated one
(io/importers.py); their cameras seed `optimize_poses`. `filter_depth`
(the post filter) runs the flow-guided filter of pipeline/processor.py on
the newest stream. Depth streams are read and written as whole clips
through the IO engine (io/store.py::read_f32_frames, write_f32_frames).
"""

from __future__ import annotations

import dataclasses
import os
from os.path import join as pjoin
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import resolve_device
from ..io.store import VideoStore, read_f32_frames, write_f32_frames
from ..solver import constraints as C
from ..solver import pose_opt
from ..solver.pose_opt import PoseOptInputs
from ..solver.residuals import SolverParams


class DepthStreamRef(NamedTuple):
    """One registered depth stream: a name and an absolute directory holding
    `depth/frame_%06d.raw` disparity files (reference DepthVideo's stream
    list, lib/DepthVideo.cpp:409-580)."""

    name: str
    dir: str


class PoseOptimizer:
    """(reference pose_optimization.py PoseOptimizer). Constraints are built
    in the constructor; `device` is where the corner response and the solve
    run ("cuda" unless the caller asks for "cpu")."""

    MATCH_SEPARATION = 10  # px (reference lib/FlowConstraints.h default)

    def __init__(self, cfg: PipelineConfig, store: VideoStore, depth_stream: str,
                 device="cuda"):
        self.cfg = cfg
        self.store = store
        self.depth_stream = depth_stream
        self.device = resolve_device(device)
        self.solver_params: Optional[SolverParams] = None
        self.solve_log: list = []
        self.initial_camera = None  # imported GT / COLMAP cameras, if any
        self.enabled_frames = None
        # imported streams first; the estimated stream <base>/<name>/depth
        # after them; the newest stream is the one the fine-tuner writes
        self.streams: List[DepthStreamRef] = []
        self._import_external_streams()
        self.streams.append(DepthStreamRef(depth_stream, pjoin(store.base_dir, depth_stream)))
        self._build_constraints()

    def _import_external_streams(self):
        """Register GT depth/pose and COLMAP reconstruction streams ahead of
        the estimated stream (reference pose_optimization.py:119-159: the
        LAST stream is the optimized one). GT poses.txt or the COLMAP
        cameras become `initial_camera` (COLMAP's win where both exist) and
        seed the estimated stream (copy_poses, :152-158)."""
        from ..io import importers

        base = self.store.base_dir
        n = self.store.num_frames

        gt_dir = pjoin(base, "depth_gt")
        if os.path.isdir(gt_dir):
            self.streams.append(DepthStreamRef("depth_gt", gt_dir))
            poses_file = pjoin(gt_dir, "poses.txt")
            if os.path.exists(poses_file):
                self.initial_camera, self.enabled_frames = importers.import_poses(
                    poses_file, n
                )

        colmap_meta = pjoin(base, "colmap_dense", "metadata.npz")
        colmap_depth = pjoin(base, "depth_colmap_dense")
        if os.path.exists(colmap_meta) and os.path.isdir(colmap_depth):
            imported = pjoin(base, "depth_colmap_dense_imported")
            if not os.path.isdir(pjoin(imported, "depth")):
                src = pjoin(colmap_depth, "depth")
                importers.import_colmap_depth(
                    src if os.path.isdir(src) else colmap_depth,
                    pjoin(imported, "depth"), base,
                )
            self.streams.append(DepthStreamRef("colmap_dense", imported))
            self.initial_camera, self.enabled_frames = importers.import_colmap_recon(
                base, colmap_meta, pjoin(imported, "depth"), n
            )

    def _load_stream_depth(self, ref: DepthStreamRef) -> np.ndarray:
        """(N, h, w) depth of a registered stream's disparity .raw files."""
        from ..io import raw

        return raw.disparity_to_depth(read_f32_frames(self._frame_paths(ref.dir)))

    def _frame_paths(self, stream_dir: str) -> List[str]:
        return [pjoin(stream_dir, "depth", f"frame_{i:06d}.raw")
                for i in range(self.store.num_frames)]

    # -- depth-stream registry (reference pose_optimization.py:242-326) -----

    def save_depth_to_last_stream(self, depth: np.ndarray) -> None:
        """Write (N, h, w) depth as disparity .raw files into the newest
        stream (the reference's save_depth into self.depth_dir), with their
        colour maps beside them when ft.save_depth_visualization is set."""
        from ..io import raw

        d = pjoin(self.streams[-1].dir, "depth")
        os.makedirs(d, exist_ok=True)
        write_f32_frames(self._frame_paths(self.streams[-1].dir), raw.depth_to_disparity(depth))
        if self.cfg.ft.save_depth_visualization:
            from ..utils.visualization import visualize_depth_dir

            visualize_depth_dir(d, d)

    def duplicate_last_depth_stream(self, name: str, dir: str) -> DepthStreamRef:
        """Copy the newest stream's .raw files into `dir`, register the new
        stream and save (reference pose_optimization.py:262-290; poses and
        transforms are shared solver state, so only pixels are copied)."""
        import shutil

        src = self.streams[-1]
        dst = DepthStreamRef(name, dir)
        os.makedirs(pjoin(dst.dir, "depth"), exist_ok=True)
        for i in range(self.store.num_frames):
            shutil.copyfile(
                pjoin(src.dir, "depth", f"frame_{i:06d}.raw"),
                pjoin(dst.dir, "depth", f"frame_{i:06d}.raw"),
            )
        self.streams.append(dst)
        self.save()
        return dst

    def filter_depth(self, radius: int) -> DepthStreamRef:
        """Flow-guided spatio-temporal filter of the newest stream into a
        `<last>_filtered` stream, on this optimizer's device, then save
        (reference pose_optimization.py:292-326: Copy op + FlowGuidedFilter
        op + saveDepth + save)."""
        from ..io import raw
        from .processor import Op, Processor, ProcessorParams

        src = self.streams[-1]
        name = src.name + "_filtered"
        dst = self.duplicate_last_depth_stream(name, pjoin(src.dir, name))

        depth = self._load_stream_depth(dst)
        if self.store.camera is None and self.solver_params is not None:
            from ..camera import pose_params_to_camera

            self.store.camera = pose_params_to_camera(
                self.solver_params.pose, self.solver_params.focal, self.store.aspect
            )
        filtered = Processor(self.store, device=self.device).flow_guided_filter_array(
            depth, ProcessorParams(op=Op.FLOW_GUIDED_FILTER, frame_radius=radius)
        ).cpu().numpy()
        write_f32_frames(self._frame_paths(dst.dir), raw.depth_to_disparity(filtered))
        self.save()
        return dst

    def save(self):
        """Camera state from the solver into the store, then `video.dat`
        (reference pose_optimization.py:240 depth_video.save()). Nothing to
        save before the first solve."""
        from ..camera import pose_params_to_camera

        if self.solver_params is None:
            return
        self.store.camera = pose_params_to_camera(
            self.solver_params.pose, self.solver_params.focal, self.store.aspect
        )
        self.write_video_dat()

    def write_video_dat(self):
        """The clip state in the reference's binary container
        (lib/DepthVideo.cpp:300-385), with every registered stream; the
        streams share poses and transforms (copy_poses,
        pose_optimization.py:242-260)."""
        from ..io import video_dat as vd

        store = self.store
        sp = self.solver_params
        cam = store.camera
        n = store.num_frames

        def host(t, dtype):
            return t.detach().cpu().numpy().astype(dtype)

        gz, gy, gx = sp.depth_grid.shape[1:]
        vx = "Scale" if sp.depth_shift is None else "ScaleShift"
        if (gx, gy, gz) == (1, 1, 1):
            ddesc = vd.XformDesc(type="Depth", depth_type="Global", value_xform=vx)
        else:
            ddesc = vd.XformDesc(
                type="Depth", depth_type="Grid", value_xform=vx, grid_size=(gx, gy, gz)
            )
        sy, sx = sp.spatial_grid.shape[1:3]
        if (sx, sy) == (1, 1):
            sdesc = vd.XformDesc(type="Spatial", spatial_type="Identity")
        else:
            sdesc = vd.XformDesc(
                type="Spatial", spatial_type="BicubicGrid", grid_size=(sx, sy, 0)
            )

        dh, dw = store.load_color_down().shape[1:3]
        vfov, hfov = host(cam.vfov, float), host(cam.hfov, float)
        position, quaternion = host(cam.position, float), host(cam.quaternion, float)
        depth_grid = host(sp.depth_grid, np.float64).reshape(n, -1)
        depth_shift = (
            None if sp.depth_shift is None
            else host(sp.depth_shift, np.float64).reshape(n, -1)
        )
        spatial_grid = host(sp.spatial_grid, np.float64).reshape(n, -1)
        frames = [
            vd.DepthFrameInfo(
                vfov=float(vfov[i]),
                hfov=float(hfov[i]),
                position=tuple(position[i]),
                quaternion=tuple(quaternion[i]),
                enabled=True,
                # ScaleShift interleaves [scale, shift] per handle
                depth_params=(
                    depth_grid[i] if depth_shift is None
                    else np.stack([depth_grid[i], depth_shift[i]], -1).reshape(-1)
                ),
                spatial_params=spatial_grid[i] if (sx, sy) != (1, 1) else np.zeros(0),
            )
            for i in range(n)
        ]
        depth_streams = [
            vd.DepthStreamInfo(
                ref.name, os.path.relpath(ref.dir, store.base_dir),
                ddesc, sdesc, dw, dh, frames,
            )
            for ref in self.streams
        ]
        meta = store.meta
        container = vd.VideoDat(
            pts=list(meta.pts),
            color_streams=[
                vd.ColorStreamInfo("full", "color_full", ".png", 21, meta.width, meta.height),
                vd.ColorStreamInfo("down", "color_down", ".raw", 21, dw, dh),
            ],
            depth_streams=depth_streams,
            duration=meta.pts[-1] if meta.pts else 0.0,
            width=meta.width,
            height=meta.height,
        )
        vd.save_video_dat(pjoin(store.base_dir, "video.dat"), container)

    # -- constraint construction (reference lib/FlowConstraints.cpp) --------

    def _build_constraints(self):
        store = self.store
        opt = self.cfg.opt
        flow_list = store.load_flow_list()
        # FrameRange windows the constraint set (reference
        # pose_optimization.py:167, FlowConstraints.cpp:49-84)
        frame_set = set(self.cfg.resolved_frame_range(store.num_frames).frames())
        pair_keys = sorted(
            {(i, j) for (i, j, _) in flow_list if i in frame_set and j in frame_set}
        )
        triplet_keys = [
            t
            for t in sorted(frame_set)
            if (t - 1) in frame_set
            and (t + 1) in frame_set
            and self._has_flow(t, t - 1)
            and self._has_flow(t, t + 1)
        ]

        pairs, triplets = self._load_constraint_cache(pair_keys, triplet_keys)
        if pairs is None:
            pairs, triplets = self._compute_constraints(pair_keys, triplet_keys)
            self._save_constraint_cache(pairs, triplets)

        # static flags (reference pose_optimization.py:170-175); "None"
        # leaves everything static
        if opt.dynamic_constraints == "Mask":
            dyn = store.load_dynamic_mask()
            dyn_dist = (
                np.stack([C.dynamic_distance(m, m.shape) for m in dyn])
                if dyn is not None
                else None
            )
            C.set_static_flags(
                pair_keys, pairs, triplet_keys, triplets, dyn_dist,
                min_dynamic_distance=8.0,
            )
        elif opt.dynamic_constraints == "Ransac":
            from ..ops.epipolar import set_static_flags_from_ransac

            h, w = store.load_color_down().shape[1:3]
            set_static_flags_from_ransac(
                pair_keys, pairs, (h, w), store.inv_aspect, opt.epipolar_dist_thresh,
            )

        self.pair_keys = pair_keys
        self.pairs = pairs
        self.triplet_keys = triplet_keys
        self.triplets = triplets

    def _has_flow(self, i, j):
        return os.path.exists(
            pjoin(self.store.base_dir, "flow", f"flow_{i:06d}_{j:06d}.raw")
        )

    def _compute_constraints(self, pair_keys, triplet_keys):
        store = self.store
        gray = torch.from_numpy(C.rgb_to_gray(store.load_color_down()))
        corner = C.corner_min_eigenval(gray.to(self.device)).cpu().numpy()

        inv_aspect = store.inv_aspect
        pairs: Dict[Tuple[int, int], C.PairConstraints] = {}
        for (i, j) in pair_keys:
            pairs[(i, j)] = C.build_pair_constraints(
                corner[i], store.load_flow(i, j), store.load_flow_mask(i, j),
                inv_aspect, match_separation=self.MATCH_SEPARATION,
            )
        triplets: Dict[int, C.TripletConstraints] = {}
        for t in triplet_keys:
            triplets[t] = C.build_triplet_constraints(
                corner[t],
                store.load_flow(t, t - 1), store.load_flow_mask(t, t - 1),
                store.load_flow(t, t + 1), store.load_flow_mask(t, t + 1),
                inv_aspect, match_separation=self.MATCH_SEPARATION,
            )
        return pairs, triplets

    # -- flow_constraints.dat cache (reference FlowConstraints.cpp:86-93:
    # load if the file exists and params match, else compute and save) ------

    @property
    def _cache_path(self) -> str:
        return pjoin(self.store.base_dir, "flow_constraints.dat")

    def _load_constraint_cache(self, pair_keys, triplet_keys):
        from ..io.flow_constraints_dat import load_flow_constraints_dat

        if not os.path.exists(self._cache_path):
            return None, None
        try:
            ms, cpairs, ctrips = load_flow_constraints_dat(self._cache_path)
        except (ValueError, OSError) as e:
            print(f"ignoring unreadable flow_constraints.dat ({e})")
            return None, None
        # params-match check (reference FlowConstraints.cpp:144-149); the
        # cached key set must cover this run's window
        if ms != self.MATCH_SEPARATION:
            return None, None
        if not (set(cpairs) >= set(pair_keys) and set(ctrips) >= set(triplet_keys)):
            return None, None
        pairs = {
            k: C.PairConstraints(
                loc0=np.ascontiguousarray(cpairs[k][:, 0]),
                loc1=np.ascontiguousarray(cpairs[k][:, 1]),
                is_static=np.ones(len(cpairs[k]), bool),
            )
            for k in pair_keys
        }
        triplets = {
            t: C.TripletConstraints(
                loc=np.ascontiguousarray(ctrips[t]),
                is_static=np.ones(len(ctrips[t]), bool),
            )
            for t in triplet_keys
        }
        return pairs, triplets

    def _save_constraint_cache(self, pairs, triplets):
        from ..io.flow_constraints_dat import save_flow_constraints_dat

        save_flow_constraints_dat(
            self._cache_path,
            self.MATCH_SEPARATION,
            {k: np.stack([pc.loc0, pc.loc1], axis=1) for k, pc in pairs.items()},
            {t: tc.loc for t, tc in triplets.items()},
        )

    # -- static-flag maintenance (reference lib/FlowConstraints.h:187-189) ---

    def reset_static_flag(self):
        """Mark every constraint static (reference FlowConstraints.cpp:552-571)."""
        for pc in self.pairs.values():
            pc.is_static[:] = True
        for tc in self.triplets.values():
            tc.is_static[:] = True

    def prune_static_flag(self, prune_distance: int = 10):
        """Contaminate the neighbourhoods of dynamic constraints at
        color_down's resolution (reference FlowConstraints.cpp:662-748)."""
        h, w = self.store.load_color_down().shape[1:3]
        C.prune_static_flag(
            self.store.num_frames, self.pair_keys, self.pairs,
            self.triplet_keys, self.triplets, (h, w), prune_distance,
        )

    # -- optimization (reference pose_optimization.py:177-240) ---------------

    def _make_inputs(self) -> PoseOptInputs:
        depth = self.store.load_depth_stream(self.depth_stream)
        opt = self.cfg.opt
        inv_aspect = self.store.inv_aspect
        data = C.flatten_pairs(
            self.pair_keys, self.pairs, depth, inv_aspect, device=self.device
        )
        triplets = None
        if opt.smooth_static_weight > 0 or opt.smooth_dynamic_weight > 0:
            triplets = C.flatten_triplets(
                self.triplet_keys, self.triplets, depth, inv_aspect,
                opt.smooth_static_weight, opt.smooth_dynamic_weight,
                device=self.device,
            )
        median = np.median(depth.reshape(depth.shape[0], -1), axis=1)
        dyn = self.store.load_dynamic_mask() if opt.adaptive_deformation_cost > 0 else None
        return PoseOptInputs(
            data=data,
            median_depth=torch.as_tensor(median.astype(np.float32), device=self.device),
            aspect=self.store.aspect,
            num_frames=self.store.num_frames,
            triplets=triplets,
            dynamic_mask=dyn,
        )

    def optimize_poses(self) -> SolverParams:
        """One solve: cold (normalize + the full coarse-to-fine schedule) the
        first time, warm afterwards when opt.warm_start. Each LM solve is
        appended to `solve_log`. Before the first solve, imported cameras
        seed the poses and focals of a full cold solve (reference
        pose_optimization.py:152-158)."""
        inputs = self._make_inputs()
        initial, opt = self.solver_params, self.cfg.opt
        if initial is None and self.initial_camera is not None:
            from ..camera import CameraState, camera_to_pose_params

            cam = CameraState(*[t.to(self.device) for t in self.initial_camera])
            pose, focal = camera_to_pose_params(cam)
            initial = pose_opt.default_solver_params(
                self.store.num_frames, focal, opt.value_xform
            )._replace(pose=pose)
            opt = dataclasses.replace(opt, warm_start=False)
        self.solver_params = pose_opt.run(opt, inputs, initial=initial, log=self.solve_log)
        self.last_inputs = inputs
        return self.solver_params
