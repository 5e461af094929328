"""Pose-optimization stage: store -> constraints -> solver.

Port of robust_cvd_tpu/pipeline/pose.py (reference
pose_optimization.py:98-326): builds flow constraints from the result
folder (through the corner kernel on the card), caches them in
`flow_constraints.dat`, sets static flags and runs the LM solver.

Static flags come from the dynamic masks (dynamic_constraints="Mask") or
from a RANSAC fundamental matrix per pair ("Ransac", ops/epipolar.py).

Not ported yet, and raising NotImplementedError rather than doing nothing:
the GT-depth / COLMAP importers (importers slice) and `filter_depth` (the
slice that ports the remaining processors; ROADMAP.md).
"""

from __future__ import annotations

import os
from os.path import join as pjoin
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import PipelineConfig
from ..device import resolve_device
from ..io.store import VideoStore
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
        self._check_external_streams()
        # stream 0 lives at <base>/<name>/depth; the newest stream is the one
        # the fine-tuner writes
        self.streams: List[DepthStreamRef] = [
            DepthStreamRef(depth_stream, pjoin(store.base_dir, depth_stream))
        ]
        self._build_constraints()

    def _check_external_streams(self):
        """GT depth/poses and COLMAP reconstructions are imported as extra
        streams by the JAX package (reference pose_optimization.py:119-159);
        the port has no importers yet."""
        base = self.store.base_dir
        if os.path.isdir(pjoin(base, "depth_gt")) or os.path.exists(
            pjoin(base, "colmap_dense", "metadata.npz")
        ):
            raise NotImplementedError(
                "importing GT depth / COLMAP streams is not ported yet "
                "(importers slice)"
            )

    # -- depth-stream registry (reference pose_optimization.py:242-326) -----

    def save_depth_to_last_stream(self, depth: np.ndarray) -> None:
        """Write (N, h, w) depth as disparity .raw files into the newest
        stream (the reference's save_depth into self.depth_dir), with their
        colour maps beside them when ft.save_depth_visualization is set."""
        from ..io import raw

        d = pjoin(self.streams[-1].dir, "depth")
        os.makedirs(d, exist_ok=True)
        for i in range(self.store.num_frames):
            raw.save_raw_float32_image(
                pjoin(d, f"frame_{i:06d}.raw"), raw.depth_to_disparity(depth[i])
            )
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

    def filter_depth(self, radius: int):
        raise NotImplementedError(
            "the flow-guided depth filter is not ported yet (processor slice)"
        )

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
        appended to `solve_log`."""
        inputs = self._make_inputs()
        self.solver_params = pose_opt.run(
            self.cfg.opt, inputs, initial=self.solver_params, log=self.solve_log
        )
        self.last_inputs = inputs
        return self.solver_params
