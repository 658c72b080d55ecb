"""Mesh culling for reconstruction evaluation.

The port's own copy of coslam_tpu/eval/cull.py, the reference culling
protocol (evaluation/cull_mesh.py): remove mesh triangles never observed
by the trajectory, with three strategies —

  frustum            (iMAP/NICE-SLAM style)
  frustum+occlusion  (NeuralRGBD/GO-Surf style)
  frustum+occlusion+virtual cameras (Co-SLAM protocol)

Depth occlusion tests use the native double-sided z-buffer rasterizer
instead of pyrender. Also saves the unseen point cloud consumed by the
2D depth-L1 evaluation.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np

from ..mesh.io import TriMesh, load_ply
from ..mesh.raster import render_depth


def cull_by_bounds(points, scene_bounds, eps=0.02):
    """reference evaluation/cull_mesh.py:92-100"""
    return (np.all(points >= (scene_bounds[0] - eps), axis=1)
            & np.all(points <= (scene_bounds[1] + eps), axis=1))


def render_depth_maps_doublesided(mesh: TriMesh, poses, fx, fy, cx, cy,
                                  H, W, near=0.01, far=10.0) -> List[np.ndarray]:
    """Depth maps from OpenGL c2w poses; our rasterizer draws both faces
    already, so a single pass suffices (reference renders twice with
    flipped winding, evaluation/cull_mesh.py:77-89)."""
    maps = []
    for pose in poses:
        cv = np.asarray(pose, np.float64).copy()
        cv[:3, 1] *= -1
        cv[:3, 2] *= -1
        w2c = np.linalg.inv(cv).astype(np.float32)
        maps.append(render_depth(mesh.vertices, mesh.faces, w2c, fx, fy,
                                 cx, cy, H, W, near=near, far=far))
    return maps


def cull_from_one_pose(points, pose, fx, fy, cx, cy, H, W,
                       remove_occlusion=True, rendered_depth=None, eps=0.03):
    """reference evaluation/cull_mesh.py:103-138"""
    c2w = np.asarray(pose, np.float64).copy()
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    w2c = np.linalg.inv(c2w)
    cam = points @ w2c[:3, :3].T + w2c[:3, 3]
    pz = cam[:, 2] + 1e-8
    px = fx * cam[:, 0] / pz + cx
    py = fy * cam[:, 1] / pz + cy

    in_frustum = (0 <= px) & (px <= W - 1) & (0 <= py) & (py <= H - 1) & (pz > 0)
    u = np.clip(px, 0, W - 1).astype(np.int32)
    v = np.clip(py, 0, H - 1).astype(np.int32)

    obs = in_frustum
    if remove_occlusion:
        assert rendered_depth is not None
        obs = in_frustum & (pz < (rendered_depth[v, u] + eps))
    return in_frustum.astype(np.int32), obs.astype(np.int32)


def load_virt_cam_poses(path: str) -> List[np.ndarray]:
    poses = []
    for f in sorted(glob.glob(os.path.join(path, "*.txt"))):
        poses.append(np.loadtxt(f).reshape(4, 4))
    return poses


def cull_one_mesh(cfg: Dict, c2w_list: List[np.ndarray], mesh_path: str,
                  save_path: str, save_unseen: bool = False,
                  remove_occlusion: bool = True,
                  virtual_cameras: bool = False,
                  virt_cam_path: Optional[str] = None,
                  scene_bounds: Optional[np.ndarray] = None,
                  th_obs: int = 0, eps: float = 0.03) -> TriMesh:
    """reference evaluation/cull_mesh.py:177-267"""
    mesh = load_ply(mesh_path)
    vertices, triangles = mesh.vertices, mesh.faces
    colors = mesh.vertex_colors

    if scene_bounds is not None:
        inside = cull_by_bounds(vertices, scene_bounds)
        tri_inside = (inside[triangles[:, 0]] | inside[triangles[:, 1]]
                      | inside[triangles[:, 2]])
        triangles = triangles[tri_inside]

    fx, fy = cfg["cam"]["fx"], cfg["cam"]["fy"]
    cx, cy = cfg["cam"]["cx"], cfg["cam"]["cy"]
    H, W = cfg["cam"]["H"], cfg["cam"]["W"]

    c2w_list = list(c2w_list)
    if virtual_cameras:
        virt_cam_starts = len(c2w_list)
        if virt_cam_path is None:
            virt_cam_path = os.path.join(cfg["data"]["datadir"],
                                         "virtual_cameras")
        c2w_list = c2w_list + load_virt_cam_poses(virt_cam_path)
    else:
        virt_cam_starts = -1

    depth_maps = None
    if remove_occlusion:
        depth_maps = render_depth_maps_doublesided(
            TriMesh(vertices, mesh.faces), c2w_list, fx, fy, cx, cy, H, W,
            near=0.01, far=10.0)

    in_frustum_mask = np.zeros(len(vertices))
    obs_mask = np.zeros(len(vertices))
    for i, pose in enumerate(c2w_list):
        rd = depth_maps[i] if depth_maps is not None else None
        inf, obs = cull_from_one_pose(vertices, pose, fx, fy, cx, cy, H, W,
                                      remove_occlusion=remove_occlusion,
                                      rendered_depth=rd, eps=eps)
        obs_mask += obs
        if virt_cam_starts < 0 or i < virt_cam_starts:
            in_frustum_mask += inf

    tri_in = ((in_frustum_mask[triangles[:, 0]] > th_obs)
              | (in_frustum_mask[triangles[:, 1]] > th_obs)
              | (in_frustum_mask[triangles[:, 2]] > th_obs))
    if remove_occlusion:
        tri_obs = ((obs_mask[triangles[:, 0]] > th_obs)
                   | (obs_mask[triangles[:, 1]] > th_obs)
                   | (obs_mask[triangles[:, 2]] > th_obs))
        valid = tri_in & tri_obs
    else:
        valid = tri_in

    culled = TriMesh(vertices, triangles[valid], colors)
    culled.remove_unreferenced_vertices()
    culled.export(save_path)

    if save_unseen:
        unseen = TriMesh(vertices, triangles[~valid])
        save_dir = os.path.dirname(save_path)
        scene_name = os.path.basename(save_path).split("_")[0]
        unseen.export(os.path.join(save_dir, f"{scene_name}_unseen.ply"))
        used = np.unique(triangles[~valid])
        np.save(os.path.join(save_dir, f"{scene_name}_pc_unseen.npy"),
                vertices[used])
    return culled
