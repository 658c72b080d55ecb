"""Camera-frustum and scene-bound visualization (matplotlib, headless).

The port's own copy of coslam_tpu/tools/vis_cameras.py. It replaces the
reference's interactive open3d viewers (reference: tools/vis_cameras.py,
evaluation/datasets/vis_cameras.py) with static 3D matplotlib renders
suitable for headless runs.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def frustum_corners(c2w: np.ndarray, scale: float = 0.1,
                    aspect: float = 4 / 3) -> np.ndarray:
    """5 points (apex + 4 image-plane corners) of an OpenGL camera frustum."""
    w = scale * aspect
    h = scale
    pts_cam = np.array([
        [0, 0, 0],
        [-w, -h, -2 * scale], [w, -h, -2 * scale],
        [w, h, -2 * scale], [-w, h, -2 * scale],
    ])
    return pts_cam @ c2w[:3, :3].T + c2w[:3, 3]


def plot_cameras(poses: List[np.ndarray], bounds: Optional[np.ndarray] = None,
                 gt_poses: Optional[List[np.ndarray]] = None,
                 save_path: str = "cameras.png", every: int = 1,
                 scale: float = 0.1):
    """Draw camera frusta (+ optional GT trajectory and scene-bound box)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(9, 9))
    ax = fig.add_subplot(111, projection="3d")

    def draw_set(pose_list, color, label):
        first = True
        for p in pose_list[::every]:
            c = frustum_corners(np.asarray(p), scale)
            edges = [(0, 1), (0, 2), (0, 3), (0, 4),
                     (1, 2), (2, 3), (3, 4), (4, 1)]
            for a, b in edges:
                ax.plot(*zip(c[a], c[b]), color=color, linewidth=0.5,
                        label=label if first and (a, b) == (0, 1) else None)
            first = False
        centers = np.array([np.asarray(p)[:3, 3] for p in pose_list])
        ax.plot(centers[:, 0], centers[:, 1], centers[:, 2], color=color,
                linewidth=1.0)

    draw_set(poses, "tab:blue", "estimated")
    if gt_poses is not None:
        draw_set(gt_poses, "black", "ground truth")

    if bounds is not None:
        b = np.asarray(bounds)  # [3, 2]
        corners = np.array([[b[0, i], b[1, j], b[2, k]]
                            for i in (0, 1) for j in (0, 1) for k in (0, 1)])
        box_edges = [(0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 7),
                     (5, 1), (5, 4), (5, 7), (6, 2), (6, 4), (6, 7)]
        for a, bb in box_edges:
            ax.plot(*zip(corners[a], corners[bb]), color="tab:red",
                    linewidth=0.8)

    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("z")
    ax.legend()
    fig.savefig(save_path, dpi=110)
    plt.close(fig)
    return save_path

