"""Camera ray generation (pinhole; OpenGL or OpenCV convention).

The port's own copy of coslam_tpu/ops/rays.py (numpy): rays are generated
once per camera model and reused for every frame.
"""

from __future__ import annotations

import re

import numpy as np


def alphanum_key_sort(s: str):
    """Natural sort key: 'frame23a' -> ['frame', 23, 'a']."""
    return [int(x) if x.isdigit() else x for x in re.split("([0-9]+)", s)]


def as_intrinsics_matrix(intrinsics) -> np.ndarray:
    """[fx, fy, cx, cy] -> 3x3 K matrix."""
    K = np.eye(3)
    K[0, 0], K[1, 1] = intrinsics[0], intrinsics[1]
    K[0, 2], K[1, 2] = intrinsics[2], intrinsics[3]
    return K


def get_camera_rays(H: int, W: int, fx: float, fy=None, cx=None, cy=None,
                    convention: str = "OpenGL") -> np.ndarray:
    """Per-pixel view directions [H, W, 3] in the camera frame.

    OpenGL: x right, y up, -z forward (reference default).
    OpenCV: x right, y down, +z forward.
    """
    if cx is None:
        cx, cy = 0.5 * W, 0.5 * H
    if fy is None:
        fy = fx

    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")

    if convention == "OpenGL":
        dirs = np.stack([(i - cx) / fx, -(j - cy) / fy, -np.ones_like(i)], axis=-1)
    elif convention == "OpenCV":
        dirs = np.stack([(i - cx) / fx, (j - cy) / fy, np.ones_like(i)], axis=-1)
    else:
        raise NotImplementedError(convention)
    return dirs
