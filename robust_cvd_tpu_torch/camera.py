"""Camera model: extrinsics, intrinsics and rotation utilities (PyTorch).

Port of robust_cvd_tpu/camera.py. Conventions (parity with the reference,
lib/DepthPhoto.h:20-112):
  - Right-handed coordinates; camera looks down **-Z**, up is +Y.
  - Extrinsics = (position (3,), orientation quaternion (4,) as [x, y, z, w]),
    camera-to-world: p_world = position + R(q) @ p_cam.
  - Intrinsics = (vFov, hFov), full field-of-view angles in radians; the
    solver parameterizes focal = tan(vFov / 2)
    (reference lib/PoseOptimizer.cpp:748-783).
  - The solver's orientation is the angle-axis of R(q) itself (see
    robust_cvd_tpu/camera.py for why the reference's front-vector flip is
    the identity here).

The rotation helpers are batched over leading axes: (..., 3) angle-axis,
(..., 4) quaternions, (..., 3, 3) matrices.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CameraState(NamedTuple):
    """Per-frame camera parameters for a whole clip.

    position:    (N, 3) world-space camera centers
    quaternion:  (N, 4) orientation as [x, y, z, w]
    vfov:        (N,)   vertical field of view (radians)
    hfov:        (N,)   horizontal field of view (radians)
    """

    position: torch.Tensor
    quaternion: torch.Tensor
    vfov: torch.Tensor
    hfov: torch.Tensor

    @staticmethod
    def default(num_frames: int, aspect: float,
                focal_long: float = 0.3461538376301239, device=None) -> "CameraState":
        """Cameras at the origin with the identity orientation and the
        iPhone-7 focal; `focal_long` is tan(fov / 2) on the long image side
        (reference lib/PoseOptimizer.h:92-94)."""
        v_focal = focal_long / aspect if aspect >= 1.0 else focal_long
        vfov = 2.0 * np.arctan(v_focal)
        hfov = 2.0 * np.arctan(v_focal * aspect)
        return CameraState(
            position=torch.zeros((num_frames, 3), device=device),
            quaternion=torch.tensor([0.0, 0.0, 0.0, 1.0], device=device).repeat(num_frames, 1),
            vfov=torch.full((num_frames,), float(vfov), device=device),
            hfov=torch.full((num_frames,), float(hfov), device=device),
        )


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[x, y, z, w] quaternions (..., 4) -> rotation matrices (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    n = x * x + y * y + z * z + w * w
    s = torch.where(n > 0, 2.0 / n, torch.zeros_like(n))
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    rows = [
        torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], -1),
        torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], -1),
        torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], -1),
    ]
    return torch.stack(rows, -2)


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> [x, y, z, w] quaternions (..., 4),
    w >= 0. Shepperd's method without branches: four candidates, the one
    seeded by the largest diagonal combination is kept."""
    m00, m11, m22 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    one = torch.ones_like(tr)
    cands = torch.stack([
        torch.stack([m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                     m[..., 1, 0] - m[..., 0, 1], one + tr], -1),
        torch.stack([one + m00 - m11 - m22, m[..., 0, 1] + m[..., 1, 0],
                     m[..., 0, 2] + m[..., 2, 0], m[..., 2, 1] - m[..., 1, 2]], -1),
        torch.stack([m[..., 0, 1] + m[..., 1, 0], one - m00 + m11 - m22,
                     m[..., 1, 2] + m[..., 2, 1], m[..., 0, 2] - m[..., 2, 0]], -1),
        torch.stack([m[..., 0, 2] + m[..., 2, 0], m[..., 1, 2] + m[..., 2, 1],
                     one - m00 - m11 + m22, m[..., 1, 0] - m[..., 0, 1]], -1),
    ], -2)  # (..., 4 candidates, 4)
    idx = torch.stack([tr, m00, m11, m22], -1).argmax(-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 3:4] < 0, -q, q)


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Angle-axis (..., 3) -> rotation matrices (..., 3, 3), Rodrigues,
    first-order near zero."""
    theta2 = (aa * aa).sum(-1)
    theta = torch.sqrt(theta2.clamp_min(1e-24))
    axis = aa / theta[..., None]
    c = torch.cos(theta)[..., None, None]
    s = torch.sin(theta)[..., None, None]

    def skew(v):
        zero = torch.zeros_like(v[..., 0])
        return torch.stack(
            [
                torch.stack([zero, -v[..., 2], v[..., 1]], -1),
                torch.stack([v[..., 2], zero, -v[..., 0]], -1),
                torch.stack([-v[..., 1], v[..., 0], zero], -1),
            ],
            -2,
        )

    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    # K @ K == outer(axis, axis) - I for a unit axis
    kk = axis[..., :, None] * axis[..., None, :] - eye
    rot = eye + s * skew(axis) + (1.0 - c) * kk
    return torch.where((theta2 < 1e-16)[..., None, None], eye + skew(aa), rot)


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """[x, y, z, w] quaternions (..., 4) -> angle-axis (..., 3)."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    v = q[..., :3]
    sin_half = torch.linalg.vector_norm(v, dim=-1)
    angle = 2.0 * torch.atan2(sin_half, q[..., 3])
    scale = torch.where(
        sin_half > 1e-12, angle / sin_half.clamp_min(1e-24), torch.full_like(angle, 2.0)
    )
    return v * scale[..., None]


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> angle-axis (..., 3), angle in [0, pi]."""
    return quat_to_axis_angle(matrix_to_quat(m))


def axis_angle_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """Angle-axis (..., 3) -> [x, y, z, w] quaternions (..., 4)."""
    theta2 = (aa * aa).sum(-1)
    theta = torch.sqrt(theta2.clamp_min(1e-24))
    half = 0.5 * theta
    sinc_half = torch.where(
        theta2 < 1e-16, torch.full_like(theta, 0.5), torch.sin(half) / theta
    )
    return torch.cat([aa * sinc_half[..., None], torch.cos(half)[..., None]], -1)


def rotate_point_axis_angle(aa: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate points p (..., 3) by angle-axis vectors aa (broadcastable to
    p) with the Rodrigues formula (ceres::AngleAxisRotatePoint), first
    order p + aa x p near zero."""
    aa = aa.expand_as(p)
    theta2 = (aa * aa).sum(-1, keepdim=True)
    theta = torch.sqrt(theta2 + 1e-24)
    axis = aa / theta
    c, s = torch.cos(theta), torch.sin(theta)
    d = (axis * p).sum(-1, keepdim=True)
    rotated = c * p + s * torch.linalg.cross(axis, p) + (1.0 - c) * d * axis
    small = p + torch.linalg.cross(aa, p)
    return torch.where(theta2 < 1e-16, small, rotated)


def world_to_camera_matrix(position: torch.Tensor, quaternion: torch.Tensor) -> torch.Tensor:
    """4x4 world->camera ("modelview") matrices (..., 4, 4) from positions
    (..., 3) and quaternions (..., 4) (reference lib/DepthPhoto.cpp:63-80)."""
    rt = quat_to_matrix(quaternion).transpose(-1, -2)
    t = -(rt * position[..., None, :]).sum(-1)
    top = torch.cat([rt, t[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)


def pose_params_to_camera(
    pose: torch.Tensor, focal: torch.Tensor, aspect: float
) -> CameraState:
    """Solver parameters (pose (N, 6) [position, angle-axis], focal (N,)
    tan(vFov/2)) -> CameraState with refreshed FOVs."""
    return CameraState(
        position=pose[:, :3],
        quaternion=axis_angle_to_quat(pose[:, 3:6]),
        vfov=2.0 * torch.atan(focal),
        hfov=2.0 * torch.atan(focal * aspect),
    )


def camera_to_pose_params(cam: CameraState) -> tuple:
    """CameraState -> (pose (N, 6), focal (N,))."""
    pose = torch.cat([cam.position, quat_to_axis_angle(cam.quaternion)], -1)
    return pose, torch.tan(cam.vfov / 2.0)
