"""Importers: ground-truth poses, COLMAP reconstructions, track CSVs.

Port of robust_cvd_tpu/io/importers.py (reference lib/Importer.cpp:
importPoses:439-478, importColmapRecon:290-389, importTracks:480-533,
loadScale:240-288). The reference imports into the C++ DepthVideo; here
the importers return the port's CameraState (float32 tensors on the CPU)
and plain arrays.
"""

from __future__ import annotations

import csv
import os
from os.path import join as pjoin
from typing import List, Tuple

import numpy as np
import torch

from ..camera import CameraState, matrix_to_quat


def _camera_state(position, quat, vfov, hfov) -> CameraState:
    return CameraState(
        position=torch.from_numpy(position),
        quaternion=torch.from_numpy(quat),
        vfov=torch.from_numpy(vfov),
        hfov=torch.from_numpy(hfov),
    )


def import_poses(path, num_frames: int) -> Tuple[CameraState, np.ndarray]:
    """`poses.txt`: the frame count, then per frame `x y z qx qy qz qw hFov
    vFov`, whitespace-separated (reference Importer.cpp:439-478). Returns
    (CameraState, enabled (N,)); frames past the file's count keep the
    identity camera and are disabled."""
    with open(path) as f:
        tokens = f.read().split()
    n = int(tokens[0])
    if n > num_frames:
        raise ValueError("poses file has more frames than the video")
    vals = np.asarray(tokens[1 : 1 + 9 * n], np.float32).reshape(n, 9)

    position = np.zeros((num_frames, 3), np.float32)
    quat = np.tile(np.asarray([0, 0, 0, 1], np.float32), (num_frames, 1))
    hfov = np.zeros(num_frames, np.float32)
    vfov = np.zeros(num_frames, np.float32)
    enabled = np.zeros(num_frames, bool)
    position[:n] = vals[:, 0:3]
    quat[:n] = vals[:, 3:7]
    hfov[:n] = vals[:, 7]
    vfov[:n] = vals[:, 8]
    enabled[:n] = True
    return _camera_state(position, quat, vfov, hfov), enabled


def load_scale(base_dir: str) -> float:
    """Mean column-1 value of `scales.csv` (reference Importer.cpp:240-288);
    1 without the file or without a readable row."""
    path = pjoin(base_dir, "scales.csv")
    if not os.path.exists(path):
        return 1.0
    vals = []
    with open(path) as f:
        for row in csv.reader(f):
            if len(row) >= 2:
                try:
                    vals.append(float(row[1]))
                except ValueError:
                    continue
    return float(np.mean(vals)) if vals else 1.0


# COLMAP's camera looks down +Z with y down, the port's down -Z with y up
_FLIP_YZ = np.diag([1.0, -1.0, -1.0])


def import_colmap_recon(
    base_dir: str,
    colmap_file: str,
    depth_dir: str,
    num_frames: int,
) -> Tuple[CameraState, np.ndarray]:
    """COLMAP `metadata.npz` with `extrinsics` (M, 3, 4) world-to-camera
    and `intrinsics` (M, 4) pixel (fx, fy, cx, cy), one per depth file in
    `depth_dir` in frame order (reference Importer.cpp:290-389). Camera
    positions are scaled by scales.csv's mean scale; the field of view
    assumes the principal point at the centre. Returns (CameraState,
    enabled (N,)) with the frames COLMAP did not reconstruct disabled."""
    frame_indices = sorted(
        int(name[6:12])
        for name in os.listdir(depth_dir)
        if name.startswith("frame_") and len(name) >= 12
    )
    scale = load_scale(base_dir)

    meta = np.load(colmap_file)
    extr = np.asarray(meta["extrinsics"], np.float64)
    intr = np.asarray(meta["intrinsics"], np.float64)
    if extr.shape[0] != len(frame_indices):
        raise ValueError("metadata.npz frame count != depth files present")

    position = np.zeros((num_frames, 3), np.float32)
    quat = np.tile(np.asarray([0, 0, 0, 1], np.float32), (num_frames, 1))
    vfov = np.full(num_frames, 0.7, np.float32)
    hfov = np.full(num_frames, 0.7, np.float32)
    enabled = np.zeros(num_frames, bool)
    idx = np.asarray(frame_indices, np.int64)
    if len(idx):
        rot = extr[:, :, :3]
        # world-to-camera -> camera-to-world, then COLMAP's axes to ours
        c2w = np.transpose(rot, (0, 2, 1)) @ _FLIP_YZ
        pos = -np.einsum("kba,kb->ka", rot, extr[:, :, 3])
        quat[idx] = matrix_to_quat(torch.from_numpy(c2w.astype(np.float32))).numpy()
        position[idx] = pos * scale
        fx, fy, cx, cy = intr.T
        hfov[idx] = 2.0 * np.arctan(np.maximum(cx, 1e-6) / np.maximum(fx, 1e-6))
        vfov[idx] = 2.0 * np.arctan(np.maximum(cy, 1e-6) / np.maximum(fy, 1e-6))
        enabled[idx] = True
    return _camera_state(position, quat, vfov, hfov), enabled


def import_colmap_depth(src_dir: str, dst_dir: str, base_dir: str) -> None:
    """Copy COLMAP's .raw depth maps from `src_dir` into `dst_dir`, scaled
    by the calibration scale (reference Importer.cpp:391-437)."""
    from . import raw

    scale = load_scale(base_dir)
    os.makedirs(dst_dir, exist_ok=True)
    for name in sorted(os.listdir(src_dir)):
        if not name.endswith(".raw"):
            continue
        depth = raw.load_raw_float32_image(pjoin(src_dir, name))
        raw.save_raw_float32_image(pjoin(dst_dir, name), depth * scale)


def import_tracks(path) -> List[List[Tuple[int, float, float]]]:
    """Track CSV: one track a line as `frame,x,y` triplets (reference
    Importer.cpp:480-533). Returns the tracks, each a list of (frame, x, y)
    observations."""
    tracks = []
    with open(path) as f:
        for row in csv.reader(f):
            row = [c for c in row if c.strip() != ""]
            if not row:
                continue
            obs = [
                (int(row[k]), float(row[k + 1]), float(row[k + 2]))
                for k in range(0, len(row) - 2, 3)
            ]
            if obs:
                tracks.append(obs)
    return tracks
