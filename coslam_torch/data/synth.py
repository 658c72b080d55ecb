"""In-memory synthetic RGB-D sequences for runs without recorded data.

The port's own copy of what it uses of coslam_tpu/data/synth.py (numpy
only): the analytic scene (an exact-SDF room with three textured
objects), its sphere-traced renderer, the room-coverage scan trajectory
and the analytic scene's base config; the same arithmetic in the same
order, so the frames are the same bits. Nothing is written to disk, so no
image codec is needed. :func:`room0_config` carries the model widths and
recipe of configs/Replica/room0.yaml (with replica.yaml) onto that scene,
:func:`room0_vm_config` those of configs/Replica/room0_vm.yaml, and
:func:`room0_xor_config` room0's with the XOR-hash grid.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..ops.rays import get_camera_rays

_ROOM_HALF = 2.0  # wall positions: |x|,|y|,|z| = 2


class AnalyticScene:
    """Closed room (walls at +-2) containing a sphere, a rounded box and
    a capped cylinder. ``sdf`` is an exact signed distance (positive in
    free space), which sphere tracing relies on."""

    # Metric AABB enclosing all surfaces.
    bound = np.array([[-2.2, 2.2], [-2.2, 2.2], [-2.2, 2.2]], np.float32)

    sphere_c = np.array([0.7, -1.35, 0.55], np.float32)
    sphere_r = 0.6
    box_c = np.array([-1.1, -1.5, -0.6], np.float32)
    box_half = np.array([0.45, 0.5, 0.45], np.float32)
    box_round = 0.04
    cyl_c = np.array([0.9, -1.3, -1.0], np.float32)
    cyl_r = 0.35
    cyl_h = 0.7

    def _parts(self, p: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Component SDFs at p [..., 3] -> (room, sphere, box, cylinder)."""
        room = _ROOM_HALF - np.abs(p).max(axis=-1)

        sph = np.linalg.norm(p - self.sphere_c, axis=-1) - self.sphere_r

        q = np.abs(p - self.box_c) - (self.box_half - self.box_round)
        box = (np.linalg.norm(np.maximum(q, 0.0), axis=-1)
               + np.minimum(q.max(axis=-1), 0.0) - self.box_round)

        pc = p - self.cyl_c
        dxz = np.sqrt(pc[..., 0] ** 2 + pc[..., 2] ** 2) - self.cyl_r
        dy = np.abs(pc[..., 1]) - self.cyl_h
        cyl = (np.minimum(np.maximum(dxz, dy), 0.0)
               + np.sqrt(np.maximum(dxz, 0.0) ** 2
                         + np.maximum(dy, 0.0) ** 2))
        return room, sph, box, cyl

    def sdf(self, p: np.ndarray) -> np.ndarray:
        """Exact SDF at p [..., 3]: positive in free space."""
        room, sph, box, cyl = self._parts(np.asarray(p, np.float32))
        return np.minimum(np.minimum(room, sph), np.minimum(box, cyl))

    def normal(self, p: np.ndarray, eps: float = 1e-3) -> np.ndarray:
        """Finite-difference SDF gradient, normalized."""
        p = np.asarray(p, np.float32)
        n = np.stack(
            [self.sdf(p + e) - self.sdf(p - e)
             for e in (np.array([eps, 0, 0]), np.array([0, eps, 0]),
                       np.array([0, 0, eps]))], axis=-1)
        return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                              1e-12)

    def albedo(self, p: np.ndarray) -> np.ndarray:
        """Textured per-component albedo [..., 3] in [0, 1]: an aperiodic
        mix of sinusoids on the walls (a periodic pattern would make
        photometric tracking translation-ambiguous) and banded objects."""
        p = np.asarray(p, np.float32)
        room, sph, box, cyl = self._parts(p)
        which = np.argmin(np.stack([room, sph, box, cyl], axis=-1), axis=-1)

        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        tex = (0.5 + 0.26 * np.sin(4.7 * px + 1.3) * np.sin(3.9 * py + 0.7)
               + 0.16 * np.sin(2.9 * pz + 1.1 * px)
               + 0.10 * np.sin(6.53 * (px + py + pz))
               + 0.08 * np.sin(23.7 * px + 17.3 * pz + 5.1 * py)
               + 0.06 * np.sin(12.9 * py + 19.1 * pz + 2.0))
        tex = np.clip(tex, 0.05, 1.0)[..., None]
        face = np.argmax(np.abs(p), axis=-1)
        neg = np.take_along_axis(p, face[..., None], -1)[..., 0] < 0
        hues = np.asarray([[0.85, 0.50, 0.45], [0.50, 0.75, 0.55],
                           [0.80, 0.80, 0.58], [0.55, 0.55, 0.62],
                           [0.48, 0.58, 0.80], [0.75, 0.58, 0.75]])
        wall = hues[face * 2 + neg] * (0.40 + 0.60 * tex)
        bands = 0.5 + 0.5 * np.sin(12.0 * p[..., 1])
        sphere = np.stack([0.75 + 0.2 * bands, 0.25 + 0.2 * bands,
                           0.20 + 0.1 * bands], axis=-1)
        stripes = 0.5 + 0.5 * np.sin(9.0 * (p[..., 0] + p[..., 2]))
        boxc = np.stack([0.20 + 0.15 * stripes, 0.65 + 0.25 * stripes,
                         0.25 + 0.1 * stripes], axis=-1)
        ang = np.arctan2(p[..., 2] - self.cyl_c[2], p[..., 0] - self.cyl_c[0])
        spin = 0.5 + 0.5 * np.sin(6.0 * ang)
        cylc = np.stack([0.20 + 0.1 * spin, 0.30 + 0.2 * spin,
                         0.70 + 0.25 * spin], axis=-1)

        out = np.select([which[..., None] == 0, which[..., None] == 1,
                         which[..., None] == 2, which[..., None] == 3],
                        [wall, sphere, boxc, cylc])
        return out.astype(np.float32)

    def shade(self, p: np.ndarray) -> np.ndarray:
        """Lambert shading with a fixed light; rgb [..., 3] in [0, 1]."""
        light = np.array([0.45, 0.80, 0.35], np.float32)
        light = light / np.linalg.norm(light)
        lam = np.maximum((self.normal(p) * light).sum(-1), 0.0)
        rgb = self.albedo(p) * (0.55 + 0.45 * lam)[..., None]
        return np.clip(rgb, 0.0, 1.0).astype(np.float32)


def render_frame(scene: AnalyticScene, c2w: np.ndarray, H: int, W: int,
                 fx: float, fy: float, cx: float, cy: float,
                 max_steps: int = 96, far: float = 12.0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Sphere-trace one frame -> (rgb [H,W,3] in [0,1], depth [H,W]).

    Depth is the OpenGL z-depth (the ray parameter t of p = o + d*t with
    the unnormalized d of ``get_camera_rays``, whose z component is -1).
    """
    c2w = np.asarray(c2w, np.float32)
    dirs = get_camera_rays(H, W, fx, fy, cx, cy).reshape(-1, 3)
    d = (dirs @ c2w[:3, :3].T).astype(np.float32)
    o = c2w[:3, 3].astype(np.float32)
    dn = np.linalg.norm(d, axis=-1)

    n = d.shape[0]
    t = np.zeros(n, np.float32)
    active = np.arange(n)
    for _ in range(max_steps):
        p = o + d[active] * t[active, None]
        s = scene.sdf(p)
        t[active] += 0.95 * s / dn[active]
        keep = (np.abs(s) > 1e-4) & (t[active] < far)
        active = active[keep]
        if active.size == 0:
            break
    # Undamped polish: SDF is exact, two Newton steps land on the surface.
    for _ in range(2):
        p = o + d * t[:, None]
        t += scene.sdf(p) / dn
    t = np.clip(t, 0.0, far)
    rgb = scene.shade(o + d * t[:, None]).reshape(H, W, 3)
    return rgb, t.reshape(H, W).astype(np.float32)


def _look_at(eye: np.ndarray, target: np.ndarray,
             up=np.array([0.0, 1.0, 0.0])) -> np.ndarray:
    """OpenGL c2w: camera -z looks from eye toward target."""
    z = eye - target
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


def make_scan_trajectory(n: int, deg_per_frame: float = 1.5) -> np.ndarray:
    """[n, 4, 4] room-coverage scan: the camera drifts on a slow inner
    orbit, looking across the room at a slowly wandering point, at a
    constant angular velocity of ``deg_per_frame``."""
    poses = []
    for i in range(n):
        th = np.deg2rad(deg_per_frame) * i
        eye = np.array([1.15 * np.cos(th),
                        0.25 + 0.25 * np.sin(0.9 * th + 0.3),
                        1.15 * np.sin(th)])
        target = np.array([0.45 * np.cos(0.63 * th + 2.0),
                           -0.75 + 0.55 * np.sin(0.41 * th),
                           0.45 * np.sin(0.63 * th + 2.0)])
        poses.append(_look_at(eye, target))
    return np.stack(poses).astype(np.float32)


def make_synthetic_config(datadir: str, output: str, H: int = 40,
                          W: int = 52, n_frames: int = 8,
                          exp_name: str = "synth") -> Dict:
    """Full Co-SLAM config for the analytic scene (same schema as
    configs/Replica/replica.yaml, sized for small images and CPU tests)."""
    return _base_synth_config(datadir, output, H, W, n_frames, exp_name)


def _base_synth_config(datadir: str, output: str, H: int, W: int,
                       n_frames: int, exp_name: str) -> Dict:
    fx = 0.8 * W
    return {
        "dataset": "replica",
        "data": {"datadir": datadir, "output": output, "exp_name": exp_name,
                 "trainskip": 1, "downsample": 1, "sc_factor": 1,
                 "translation": 0, "num_workers": 0, "n_frames": n_frames},
        "cam": {"H": H, "W": W, "fx": fx, "fy": fx, "cx": (W - 1) / 2.0,
                "cy": (H - 1) / 2.0, "png_depth_scale": 6553.5,
                "crop_edge": 0, "near": 0, "far": 8, "depth_trunc": 100.0},
        "mapping": {
            "sample": 512, "first_mesh": False, "iters": 10,
            "cur_frame_iters": 0, "lr_embed": 0.01, "lr_decoder": 0.01,
            "lr_rot": 0.001, "lr_trans": 0.001, "keyframe_every": 5,
            "map_every": 5, "n_pixels": 0.05, "first_iters": 200,
            "optim_cur": True, "min_pixels_cur": 20, "map_accum_step": 1,
            "pose_accum_step": 5, "map_wait_step": 0, "filter_depth": False,
            "bound": [[-2.5, 2.5], [-2.5, 2.5], [-2.5, 2.5]],
            "marching_cubes_bound": [[-2.2, 2.2], [-2.2, 2.2], [-2.2, 2.2]],
        },
        "tracking": {
            "iter": 10, "sample": 512, "pc_samples": 1024,
            "lr_rot": 0.001, "lr_trans": 0.001, "ignore_edge_W": 4,
            "ignore_edge_H": 4, "iter_point": 0, "wait_iters": 100,
            "const_speed": True, "best": True,
            # The Huber photometric tracking kernel; 0 recovers plain MSE.
            "robust_delta": 0.1,
        },
        "grid": {"enc": "HashGrid", "tcnn_encoding": True, "hash_size": 13,
                 "voxel_color": 0.08, "voxel_sdf": 0.04, "oneGrid": True},
        "pos": {"enc": "OneBlob", "n_bins": 16},
        "decoder": {"geo_feat_dim": 15, "hidden_dim": 32, "num_layers": 2,
                    "num_layers_color": 2, "hidden_dim_color": 32,
                    "tcnn_network": False},
        "training": {
            "rgb_weight": 5.0, "depth_weight": 0.1, "sdf_weight": 1000,
            "fs_weight": 10, "eikonal_weight": 0, "smooth_weight": 1e-6,
            "smooth_pts": 8, "smooth_vox": 0.1, "smooth_margin": 0.05,
            "n_samples_d": 32, "range_d": 0.1, "n_range_d": 11,
            "n_importance": 0, "perturb": 1, "white_bkgd": False,
            "trunc": 0.08, "rot_rep": "axis_angle", "rgb_missing": 0.05,
        },
        "mesh": {"resolution": 128, "render_color": False, "vis": 0,
                 "voxel_eval": 0.08, "voxel_final": 0.08,
                 "visualisation": False},
    }


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
