"""SE(3) / rotation parameterizations in PyTorch.

Counterpart of coslam_tpu/ops/pose.py: the axis-angle and quaternion
paths of ``get_pose_representation``, the continuous 6D rotation (Zhou
et al.) and the closed-form SE(3) inverse, with the same small-angle guards
(the exponential map is Taylor-safe at theta -> 0, and so is the log
map's theta / sin(theta/2)).
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def axis_angle_to_matrix(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map. w [..., 3] -> R [..., 3, 3]."""
    theta_sq = (w * w).sum(-1)
    theta = torch.sqrt(theta_sq.clamp_min(_EPS * _EPS))
    small = theta_sq < _EPS
    wx, wy, wz = w.unbind(-1)
    zeros = torch.zeros_like(wx)
    K = torch.stack([torch.stack([zeros, -wz, wy], -1),
                     torch.stack([wz, zeros, -wx], -1),
                     torch.stack([-wy, wx, zeros], -1)], -2)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(theta)) / theta_sq.clamp_min(_EPS * _EPS))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    # K @ K == w w^T - theta^2 I
    KK = w[..., :, None] * w[..., None, :] - theta_sq[..., None, None] * eye
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> unit quaternion (w, x, y, z), w >= 0, by
    the branch-free best-pivot selection of the JAX version."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw_sq = 1.0 + m00 + m11 + m22
    qx_sq = 1.0 + m00 - m11 - m22
    qy_sq = 1.0 - m00 + m11 - m22
    qz_sq = 1.0 - m00 - m11 + m22

    def cand(sq, comps):
        return torch.stack(comps, -1) / (2.0 * torch.sqrt(
            sq.clamp_min(1e-12)))[..., None]

    cands = torch.stack([
        cand(qw_sq, [qw_sq, m21 - m12, m02 - m20, m10 - m01]),
        cand(qx_sq, [m21 - m12, qx_sq, m01 + m10, m02 + m20]),
        cand(qy_sq, [m02 - m20, m01 + m10, qy_sq, m12 + m21]),
        cand(qz_sq, [m10 - m01, m02 + m20, m12 + m21, qz_sq])], -2)
    best = torch.stack([qw_sq, qx_sq, qy_sq, qz_sq], -1).argmax(-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) [..., 4] -> rotation [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> axis-angle [..., 3]."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = q[..., 0].clamp(-1.0, 1.0)
    xyz = q[..., 1:]
    norm = torch.linalg.norm(xyz, dim=-1)
    theta = 2.0 * torch.atan2(norm, w)
    # theta / sin(theta/2), Taylor form 2 + theta^2/12 near 0.
    scale = torch.where(norm < 1e-8, 2.0 + theta * theta / 12.0,
                        theta / norm.clamp_min(1e-12))
    return xyz * scale[..., None]


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> axis-angle [..., 3] (log map)."""
    return quaternion_to_axis_angle(matrix_to_quaternion(R))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rotation representation [..., 6] -> [..., 3, 3]:
    Gram-Schmidt of the two 3-vectors, which become the first two
    columns."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / a1.norm(dim=-1, keepdim=True)
    b2 = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    b2 = b2 / b2.norm(dim=-1, keepdim=True)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def matrix_to_rotation_6d(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> 6D representation (its first two columns)."""
    return torch.cat([R[..., :, 0], R[..., :, 1]], -1)


def _compose_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([torch.cat([R, t[..., :, None]], -1), bottom], -2)


def at_to_transform_matrix(rot: torch.Tensor,
                           trans: torch.Tensor) -> torch.Tensor:
    """(axis-angle [..., 3], translation [..., 3]) -> SE(3) [..., 4, 4]."""
    return _compose_se3(axis_angle_to_matrix(rot), trans)


def qt_to_transform_matrix(rot: torch.Tensor,
                           trans: torch.Tensor) -> torch.Tensor:
    """(quaternion [..., 4], translation [..., 3]) -> SE(3) [..., 4, 4]."""
    return _compose_se3(quaternion_to_matrix(rot), trans)


def six_t_to_transform_matrix(rot: torch.Tensor,
                              trans: torch.Tensor) -> torch.Tensor:
    """(6D rotation [..., 6], translation [..., 3]) -> SE(3) [..., 4, 4]."""
    return _compose_se3(rotation_6d_to_matrix(rot), trans)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of SE(3) matrices [..., 4, 4]: (R^T, -R^T t)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _compose_se3(Rt, -(Rt @ T[..., :3, 3, None])[..., 0])


def get_pose_representation(rot_rep: str):
    """(matrix_to_tensor, matrix_from_tensor) for 'axis_angle' | 'quat'."""
    if rot_rep == "axis_angle":
        return matrix_to_axis_angle, at_to_transform_matrix
    if rot_rep == "quat":
        return matrix_to_quaternion, qt_to_transform_matrix
    raise NotImplementedError(f"Unknown rotation representation: {rot_rep}")
