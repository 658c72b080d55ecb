"""In-memory synthetic RGB-D sequences for runs without recorded data.

The frames come from coslam_tpu/data/synth.py's analytic scene and scan
trajectory (numpy only); nothing is written to disk, so no image codec
is needed. :func:`room0_config` carries the model widths and recipe of
configs/Replica/room0.yaml (with replica.yaml) onto that scene, and
:func:`room0_vm_config` those of configs/Replica/room0_vm.yaml, and
:func:`room0_xor_config` room0's with the XOR-hash grid.
"""

from __future__ import annotations

from typing import Dict

from coslam_tpu.data.synth import (AnalyticScene, make_scan_trajectory,
                                   make_synthetic_config, render_frame)
from coslam_tpu.ops.rays import get_camera_rays


def room0_config(output: str, H: int = 480, W: int = 640,
                 n_frames: int = 15, exp_name: str = "room0_synth") -> Dict:
    """The analytic scene's config with room0's model and recipe: hash
    grid 16 levels x 2 at hash_size 16 and resolution 400, trunc 0.1, TV
    lattice of smooth_pts 32, 1024 tracking rays with 20-pixel edges,
    2048 mapping rays, first frame 200 iterations, final mesh at 2 cm."""
    cfg = make_synthetic_config("", output, H=H, W=W, n_frames=n_frames,
                                exp_name=exp_name)
    cfg["grid"].update(hash_size=16, voxel_sdf=400)
    cfg["training"].update(trunc=0.1, smooth_pts=32)
    cfg["mapping"].update(sample=2048, min_pixels_cur=100, first_iters=200)
    cfg["tracking"].update(sample=1024, ignore_edge_W=20, ignore_edge_H=20)
    cfg["mesh"].update(voxel_final=0.02)
    return cfg


def room0_vm_config(output: str, H: int = 480, W: int = 640,
                    n_frames: int = 15,
                    exp_name: str = "room0_vm_synth") -> Dict:
    """room0_config with what configs/Replica/room0_vm.yaml changes: the
    TensoVM grid with a 3-level pyramid (resolutions 32/100/311 at
    voxel_sdf 400) and 16 uniform + 11 depth-guided samples per ray."""
    cfg = room0_config(output, H, W, n_frames, exp_name)
    cfg["grid"].update(enc="TensoVM", triplane_levels=3)
    cfg["training"].update(n_samples_d=16, n_range_d=11)
    return cfg


def room0_xor_config(output: str, H: int = 480, W: int = 640,
                     n_frames: int = 15,
                     exp_name: str = "room0_xor_synth",
                     grad_impl: str = "pallas") -> Dict:
    """room0_config with ``grid.grad_impl: pallas``: the same model at the
    same width, but the grid is tiny-cuda-nn's XOR hash (the reference
    Co-SLAM's), 16 levels x 2 at hash_size 16 and resolution 400, levels
    0-4 dense and 5-15 hashed at 2^16 rows each, 834,097 rows, with the
    deterministic table gradient of the Pallas K4. ``grad_impl`` scatter
    or onehot keeps the grid and takes the atomic table gradient."""
    cfg = room0_config(output, H, W, n_frames, exp_name)
    cfg["grid"]["grad_impl"] = grad_impl
    return cfg


class SyntheticFrames:
    """RGB-D sequence of the analytic scene held in memory: the dataset
    interface CoSLAM reads (frames as dicts, poses, sizes)."""

    def __init__(self, cfg: Dict, n_frames: int):
        cam = cfg["cam"]
        self.H, self.W = cam["H"], cam["W"]
        self.num_frames = n_frames
        self.poses = make_scan_trajectory(n_frames)
        self.num_rays_to_save = int(self.H * self.W
                                    * cfg["mapping"]["n_pixels"])
        self.direction = get_camera_rays(self.H, self.W, cam["fx"], cam["fy"],
                                         cam["cx"], cam["cy"])
        scene = AnalyticScene()
        self.frames = [render_frame(scene, c2w, self.H, self.W, cam["fx"],
                                    cam["fy"], cam["cx"], cam["cy"])
                       for c2w in self.poses]

    def __len__(self):
        return self.num_frames

    def __getitem__(self, i: int) -> Dict:
        rgb, depth = self.frames[i]
        return {"frame_id": i, "c2w": self.poses[i], "rgb": rgb,
                "depth": depth, "direction": self.direction}
