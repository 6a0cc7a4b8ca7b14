"""SE(3) pose utilities.

PyTorch counterpart of ``lsi_tpu/geometry/transforms.py``, with the same
conventions: camera frame x right, y down, z forward; a pose is a
(..., 4, 4) float32 matrix mapping source-camera points to the target
camera, ``X_t = R @ X_s + t``.

The small matrix products are written as broadcast multiply-sums rather
than ``torch.matmul`` so they stay full float32 whatever the process's
TF32 settings are (the reference runs them at ``precision="highest"``).
"""

from __future__ import annotations

import math

import torch


def _as_f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., i, j) @ (..., j, k) in exact float32 (never TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def matvec_f32(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched (..., i, j) @ (..., j) in exact float32 (never TF32)."""
    return (a * v[..., None, :]).sum(-1)


def make_pose(rotation, translation) -> torch.Tensor:
    """Assemble (..., 4, 4) pose from (..., 3, 3) R and (..., 3) t."""
    rotation = _as_f32(rotation)
    translation = _as_f32(translation, rotation.device)
    batch = torch.broadcast_shapes(rotation.shape[:-2], translation.shape[:-1])
    rotation = rotation.expand(batch + (3, 3))
    translation = translation.expand(batch + (3,))
    top = torch.cat([rotation, translation[..., :, None]], dim=-1)
    bottom = torch.zeros(batch + (1, 4), dtype=torch.float32,
                         device=rotation.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def identity_pose(batch_shape=()) -> torch.Tensor:
    eye = torch.eye(4, dtype=torch.float32)
    return eye.expand(tuple(batch_shape) + (4, 4)).clone()


def translation_pose(translation) -> torch.Tensor:
    """Pure-translation pose; e.g. a rectified stereo baseline is
    ``translation_pose([-baseline, 0, 0])`` (left -> right camera)."""
    translation = _as_f32(translation)
    eye = torch.eye(3, dtype=torch.float32, device=translation.device)
    return make_pose(eye.expand(translation.shape[:-1] + (3, 3)), translation)


def invert_pose(pose: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse: (R, t) -> (R^T, -R^T t)."""
    rot_inv = pose[..., :3, :3].transpose(-1, -2)
    return make_pose(rot_inv, -matvec_f32(rot_inv, pose[..., :3, 3]))


def compose_poses(pose_ab: torch.Tensor, pose_bc: torch.Tensor) -> torch.Tensor:
    """Pose mapping frame a -> c given a -> b and b -> c: ``T_bc @ T_ab``."""
    return matmul_f32(pose_bc, pose_ab)


def relative_pose(world_from_a: torch.Tensor,
                  world_from_b: torch.Tensor) -> torch.Tensor:
    """T mapping a-frame points to b-frame given both camera-to-world poses."""
    return compose_poses(world_from_a, invert_pose(world_from_b))


def euler_to_rotation(angles) -> torch.Tensor:
    """(..., 3) XYZ-intrinsic Euler angles (radians) -> (..., 3, 3) R.

    R = Rz @ Ry @ Rx (x applied first)."""
    angles = _as_f32(angles)
    ax, ay, az = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = torch.cos(ax), torch.sin(ax)
    cy, sy = torch.cos(ay), torch.sin(ay)
    cz, sz = torch.cos(az), torch.sin(az)
    one = torch.ones_like(cx)
    zero = torch.zeros_like(cx)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
    ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
    rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
    return matmul_f32(matmul_f32(rz, ry), rx)


def pose_from_euler(angles, translation) -> torch.Tensor:
    return make_pose(euler_to_rotation(angles), _as_f32(translation))


def camera_trajectory(num_views: int,
                      max_translation=(0.15, 0.0, 0.0),
                      max_rotation=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """(num_views, 4, 4) smooth camera sweep for video synthesis.

    Sinusoidal sweep in [-1, 1] of the given max translation (meters) and
    rotation (radians).
    """
    phase = torch.linspace(0.0, 2.0 * math.pi, num_views, dtype=torch.float32)
    alpha = torch.sin(phase)[:, None]
    trans = alpha * _as_f32(max_translation)[None, :]
    rots = alpha * _as_f32(max_rotation)[None, :]
    return pose_from_euler(rots, trans)
