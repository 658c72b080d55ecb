"""Absolute trajectory error (ATE), TUM protocol.

The port's own copy of what it uses of coslam_tpu/eval/ate.py (numpy):
closest-timestamp association, Horn's closed-form SE(3) alignment and
the RMSE/mean/median statistics, and the 4x4-pose conversion with
non-finite ground truth masked. Plots are left out.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> quaternion (w, x, y, z), numerically robust."""
    from scipy.spatial.transform import Rotation

    q = Rotation.from_matrix(R).as_quat()  # (x, y, z, w)
    return np.concatenate([q[3:], q[:3]])


def get_tensor_from_camera(RT: np.ndarray, Tquad: bool = False) -> np.ndarray:
    """4x4 (or 3x4) pose -> [quat, trans] or [trans, quad]."""
    R, T = RT[:3, :3], RT[:3, 3]
    quad = rotmat_to_quat(R)
    if Tquad:
        return np.concatenate([T, quad], 0)
    return np.concatenate([quad, T], 0)


def associate(first_list: Dict, second_list: Dict, offset: float = 0.0,
              max_difference: float = 0.02):
    """Greedy closest-timestamp association."""
    first_keys = list(first_list.keys())
    second_keys = list(second_list.keys())
    potential = sorted(
        (abs(a - (b + offset)), a, b)
        for a in first_keys for b in second_keys
        if abs(a - (b + offset)) < max_difference)
    matches = []
    fset, sset = set(first_keys), set(second_keys)
    for diff, a, b in potential:
        if a in fset and b in sset:
            fset.remove(a)
            sset.remove(b)
            matches.append((a, b))
    matches.sort()
    return matches


def align(model: np.ndarray, data: np.ndarray):
    """Horn closed-form SE(3) alignment of two 3xN trajectories.

    Returns (rot 3x3, trans 3x1, per-point translational error [N]).
    """
    model_zc = model - model.mean(1, keepdims=True)
    data_zc = data - data.mean(1, keepdims=True)

    W = model_zc @ data_zc.T
    U, d, Vh = np.linalg.svd(W.T)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vh) < 0:
        S[2, 2] = -1
    rot = U @ S @ Vh
    trans = data.mean(1, keepdims=True) - rot @ model.mean(1, keepdims=True)

    aligned = rot @ model + trans
    err = aligned - data
    trans_error = np.sqrt(np.sum(err * err, axis=0))
    return rot, trans, trans_error


def evaluate_ate(first_list: Dict, second_list: Dict, offset: float = 0.0,
                 scale: float = 1.0, max_difference: float = 0.02) -> Dict:
    """ATE statistics between GT (first) and estimated (second)
    {stamp: [tx, ty, tz, ...]} dicts."""
    matches = associate(first_list, second_list, offset, max_difference)
    if len(matches) < 2 and len(first_list) > 5:
        raise ValueError("Couldn't find matching timestamp pairs between "
                         "groundtruth and estimated trajectory!")

    first_xyz = np.array([[float(v) for v in first_list[a][0:3]]
                          for a, b in matches]).T
    second_xyz = np.array([[float(v) * scale for v in second_list[b][0:3]]
                           for a, b in matches]).T

    rot, trans, trans_error = align(second_xyz, first_xyz)
    # Unaligned error: both trajectories share the first-frame anchor.
    raw_error = np.linalg.norm(second_xyz - first_xyz, axis=0)

    return {
        "compared_pose_pairs": len(trans_error),
        "absolute_translational_error.rmse":
            float(np.sqrt(np.dot(trans_error, trans_error) / len(trans_error))),
        "absolute_translational_error.mean": float(np.mean(trans_error)),
        "absolute_translational_error.median": float(np.median(trans_error)),
        "absolute_translational_error.std": float(np.std(trans_error)),
        "absolute_translational_error.min": float(np.min(trans_error)),
        "absolute_translational_error.max": float(np.max(trans_error)),
        "absolute_translational_error.rmse_noalign":
            float(np.sqrt(np.dot(raw_error, raw_error) / len(raw_error))),
    }


def convert_poses(c2w_list: Dict[int, np.ndarray], N: int, scale: float,
                  gt: bool = True):
    """4x4 pose dict -> ([N, 7] trans+quat array, validity mask), masking
    nan/inf GT poses."""
    poses = []
    mask = np.ones(N, bool)
    for idx in range(N):
        c2w = np.array(c2w_list[idx], np.float64, copy=True)
        if gt and (np.any(np.isinf(c2w)) or np.any(np.isnan(c2w))):
            mask[idx] = False
            continue
        c2w[:3, 3] /= scale
        poses.append(get_tensor_from_camera(c2w, Tquad=True))
    return np.stack(poses), mask
