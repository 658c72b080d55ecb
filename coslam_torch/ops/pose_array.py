"""Per-frame quaternion + translation pose table: rows [qw, qx, qy, qz,
tx, ty, tz].

Counterpart of coslam_tpu/ops/pose_array.py (the reference's PoseArray,
an alternative differentiable pose parameterization), as pure functions
of an [N, 7] tensor. The loop does not use it.
"""

from __future__ import annotations

import torch

from .pose import matrix_to_quaternion, quaternion_to_matrix


def init_pose_array(n_frames: int, device=None,
                    dtype=torch.float32) -> torch.Tensor:
    """Identity poses: quaternion (1, 0, 0, 0), zero translation."""
    arr = torch.zeros((n_frames, 7), dtype=dtype, device=device)
    arr[:, 0] = 1.0
    return arr


def set_pose(pose_array: torch.Tensor, frame_id,
             c2w: torch.Tensor) -> torch.Tensor:
    """A copy of pose_array with the 4x4 transform c2w in slot
    frame_id."""
    vec = torch.cat([matrix_to_quaternion(c2w[:3, :3]), c2w[:3, 3]])
    out = pose_array.clone()
    out[frame_id] = vec
    return out


def get_transform(pose_array: torch.Tensor, frame_id) -> torch.Tensor:
    """Slot(s) frame_id -> [..., 4, 4] transform, differentiable in
    pose_array."""
    vec = pose_array[frame_id]
    top = torch.cat([quaternion_to_matrix(vec[..., :4]),
                     vec[..., 4:, None]], -1)                # [..., 3, 4]
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=top.dtype,
                         device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], -2)
