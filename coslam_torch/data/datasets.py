"""RGB-D dataset loaders (host-side numpy).

The port's own copy of the loaders of coslam_tpu/data/datasets.py: the
same on-disk formats (Replica, ScanNet, NeuralRGBD synthetic, TUM, Azure,
iPhone, RealSense, KITTI), the same camera model (intrinsics divided by
``data.downsample`` once, ``cam.crop_edge`` applied per format) and the
same frames. ``cv2`` and ``scipy`` are imported where a frame or a pose
file is read.

Every ``__getitem__`` returns ``{"frame_id", "c2w", "rgb", "depth",
"direction"}`` with rgb [H,W,3] float32 in [0,1], depth [H,W] float32
metric, direction [H,W,3] OpenGL camera rays shared across frames.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional

import numpy as np

from ..ops.rays import alphanum_key_sort, as_intrinsics_matrix, get_camera_rays


def get_dataset(config: Dict):
    """Dispatch on config['dataset']."""
    classes = {
        "replica": ReplicaDataset,
        "scannet": ScannetDataset,
        "synthetic": RGBDataset,
        "tum": TUMDataset,
        "azure": AzureDataset,
        "iphone": iPhoneDataset,
        "realsense": RealsenseDataset,
        "kitti": KITTIDataset,
    }
    name = config["dataset"]
    if name not in classes:
        raise ValueError(f"unknown dataset type: {name!r}")
    return classes[name](config, config["data"]["datadir"])


def _numeric_key(path: str) -> int:
    return int(os.path.splitext(os.path.basename(path))[0])


def _opengl(c2w: np.ndarray) -> np.ndarray:
    """Flip y/z columns: OpenCV/world-file convention -> OpenGL."""
    c2w = np.array(c2w, np.float32)
    c2w[:3, 1] *= -1
    c2w[:3, 2] *= -1
    return c2w


class BaseDataset:
    """Common camera model. ``num_rays_to_save`` is the keyframe ray
    budget ``(H-2*crop)*(W-2*crop) * mapping.n_pixels``."""

    def __init__(self, cfg: Dict):
        self.config = cfg
        self.png_depth_scale = cfg["cam"]["png_depth_scale"]
        ds = int(cfg["data"].get("downsample", 1))
        self.downsample_factor = ds
        self.trainskip = int(cfg["data"].get("trainskip", 1))
        self.sc_factor = float(cfg["data"].get("sc_factor", 1.0))
        self.translation = float(cfg["data"].get("translation", 0.0))
        self.H = cfg["cam"]["H"] // ds
        self.W = cfg["cam"]["W"] // ds
        self.fx = cfg["cam"]["fx"] / ds
        self.fy = cfg["cam"]["fy"] / ds
        self.cx = cfg["cam"]["cx"] / ds
        self.cy = cfg["cam"]["cy"] / ds
        self.distortion = (np.array(cfg["cam"]["distortion"])
                           if "distortion" in cfg["cam"] else None)
        self.crop_size = cfg["cam"].get("crop_edge", 0)
        self.ignore_w = cfg["tracking"]["ignore_edge_W"]
        self.ignore_h = cfg["tracking"]["ignore_edge_H"]

        self.total_pixels = ((self.H - self.crop_size * 2)
                             * (self.W - self.crop_size * 2))
        self.num_rays_to_save = int(self.total_pixels
                                    * cfg["mapping"]["n_pixels"])
        self.rays_d: Optional[np.ndarray] = None

    def _apply_crop_edge(self):
        """Shrink the camera model by cam.crop_edge on each side (the
        formats whose frames are edge-cropped)."""
        edge = self.config["cam"].get("crop_edge", 0)
        if edge > 0:
            self.H -= edge * 2
            self.W -= edge * 2
            self.cx -= edge
            self.cy -= edge

    def _load_image_pair(self, color_path: str, depth_path: str,
                         crop_edge: Optional[int] = None):
        """imread -> RGB float [0,1] + metric depth, with downsample
        resize and edge crop."""
        import cv2

        color = cv2.imread(color_path)
        if color is None:
            raise ValueError(
                f"could not decode color frame {color_path!r} "
                "(missing, truncated, or not an image)")
        if depth_path.endswith(".exr"):
            raise NotImplementedError("EXR depth not supported")
        depth = cv2.imread(depth_path, cv2.IMREAD_UNCHANGED)
        if depth is None:
            raise ValueError(
                f"could not decode depth frame {depth_path!r} "
                "(missing, truncated, or not an image)")
        if self.distortion is not None:
            K = as_intrinsics_matrix([self.config["cam"]["fx"],
                                      self.config["cam"]["fy"],
                                      self.config["cam"]["cx"],
                                      self.config["cam"]["cy"]])
            color = cv2.undistort(color, K, self.distortion)
        color = cv2.cvtColor(color, cv2.COLOR_BGR2RGB) / 255.0
        depth = depth.astype(np.float32) / self.png_depth_scale * self.sc_factor

        H, W = depth.shape
        if color.shape[:2] != (H, W):
            color = cv2.resize(color, (W, H))
        if self.downsample_factor > 1:
            H, W = H // self.downsample_factor, W // self.downsample_factor
            color = cv2.resize(color, (W, H), interpolation=cv2.INTER_AREA)
            depth = cv2.resize(depth, (W, H), interpolation=cv2.INTER_NEAREST)

        edge = (self.config["cam"].get("crop_edge", 0)
                if crop_edge is None else crop_edge)
        if edge > 0:
            color = color[edge:-edge, edge:-edge]
            depth = depth[edge:-edge, edge:-edge]
        return color.astype(np.float32), depth

    def _directions(self) -> np.ndarray:
        if self.rays_d is None:
            self.rays_d = get_camera_rays(self.H, self.W, self.fx, self.fy,
                                          self.cx, self.cy)
        return self.rays_d

    def _train_ids(self, n: int) -> List[int]:
        return list(range(0, n, max(self.trainskip, 1)))

    def _make_batch(self, frame_id: int, c2w: np.ndarray, color_path: str,
                    depth_path: str, crop_edge: Optional[int] = None) -> Dict:
        rgb, depth = self._load_image_pair(color_path, depth_path, crop_edge)
        if tuple(depth.shape) != (self.H, self.W):
            raise ValueError(
                f"frame {depth_path!r} decodes to {tuple(depth.shape)} but "
                f"the camera model expects ({self.H}, {self.W}) — cam.H/W/"
                "crop_edge/downsample in the config do not match the data "
                "on disk")
        return {"frame_id": frame_id, "c2w": np.asarray(c2w, np.float32),
                "rgb": rgb, "depth": depth, "direction": self._directions()}

    def _validate_frames(self, basedir: str, min_poses: Optional[int] = None):
        """Fail fast on broken scene directories: zero frames, missing
        depth partners, or too few poses."""
        n_img = len(self.img_files)
        if n_img == 0:
            raise ValueError(
                f"no frames found in {basedir!r} for dataset type "
                f"{self.config.get('dataset')!r} — wrong datadir or layout?")
        n_depth = len(self.depth_paths)
        if n_depth < n_img:
            raise ValueError(
                f"{basedir!r}: found {n_img} color frames but only "
                f"{n_depth} depth frames — incomplete capture?")
        n_poses = len(self.poses) if min_poses is None else min_poses
        if n_poses < n_img:
            raise ValueError(
                f"{basedir!r}: found {n_img} frames but only {n_poses} "
                f"poses — trajectory file is truncated")

    def __len__(self):
        return self.num_frames

    def __getitem__(self, index: int) -> Dict:
        i = self.frame_ids[index]
        return self._make_batch(i, self.poses[i], self.img_files[i],
                                self.depth_paths[i], crop_edge=self._crop)

    # Edge crop of the frames: None = cam.crop_edge, 0 = none.
    _crop: Optional[int] = None


class ReplicaDataset(BaseDataset):
    """results/frame*.jpg + results/depth*.png + traj.txt (16 floats/line)."""

    _crop = 0

    def __init__(self, cfg: Dict, basedir: str):
        super().__init__(cfg)
        self.basedir = basedir
        self.img_files = sorted(glob.glob(f"{basedir}/results/frame*.jpg"))
        self.depth_paths = sorted(glob.glob(f"{basedir}/results/depth*.png"))
        with open(os.path.join(basedir, "traj.txt")) as f:
            lines = f.readlines()
        self.poses = []
        self._validate_frames(basedir, min_poses=len(lines))
        for i in range(len(self.img_files)):
            c2w = np.array(list(map(float, lines[i].split()))).reshape(4, 4)
            c2w = _opengl(c2w)
            c2w[:3, 3] *= self.sc_factor
            self.poses.append(c2w)
        self.frame_ids = self._train_ids(len(self.img_files))
        self.num_frames = len(self.frame_ids)


class ScannetDataset(BaseDataset):
    """color/*.jpg + depth/*.png + pose/*.txt, numeric filenames, with
    cam.crop_edge."""

    def __init__(self, cfg: Dict, basedir: str):
        super().__init__(cfg)
        self.basedir = basedir
        self.img_files = sorted(
            glob.glob(os.path.join(basedir, "color", "*.jpg"))
            + glob.glob(os.path.join(basedir, "color", "*.png")),
            key=_numeric_key)
        self.depth_paths = sorted(
            glob.glob(os.path.join(basedir, "depth", "*.png")),
            key=_numeric_key)
        pose_paths = sorted(glob.glob(os.path.join(basedir, "pose", "*.txt")),
                            key=_numeric_key)
        self.poses = [_opengl(np.loadtxt(p).reshape(4, 4))
                      for p in pose_paths]
        self._validate_frames(basedir)
        self.frame_ids = self._train_ids(len(self.img_files))
        self.num_frames = len(self.frame_ids)
        self._apply_crop_edge()


def _parse_trajectory_log(path: str) -> List[np.ndarray]:
    """Open3D .log trajectory: 5 lines per pose (meta + 4 matrix rows)."""
    with open(path) as f:
        content = f.readlines()
    poses = []
    for i in range(0, len(content) - 4, 5):
        mat = np.array(list(map(float,
                                "".join(content[i + 1:i + 5]).split())))
        poses.append(mat.reshape(4, 4))
    return poses


class AzureDataset(BaseDataset):
    """color/*.jpg + depth/*.png + scene/trajectory.log (or a 'pose' .log
    file)."""

    def __init__(self, cfg: Dict, basedir: str):
        super().__init__(cfg)
        self.basedir = basedir
        self.img_files = sorted(
            glob.glob(os.path.join(basedir, "color", "*.jpg"))
            + glob.glob(os.path.join(basedir, "color", "*.png")))
        self.depth_paths = sorted(
            glob.glob(os.path.join(basedir, "depth", "*.png")))
        self.frame_ids = self._train_ids(len(self.img_files))
        self.num_frames = len(self.frame_ids)

        log_path = os.path.join(basedir, "scene", "trajectory.log")
        if not os.path.exists(log_path):
            log_path = os.path.join(basedir, "pose")
        if os.path.exists(log_path):
            self.poses = [_opengl(p) for p in _parse_trajectory_log(log_path)]
        else:
            # No trajectory: fixed placeholder pose.
            self.poses = [np.eye(4, dtype=np.float32) + 1e-5
                          for _ in range(len(self.img_files))]
        self._validate_frames(basedir)
        self._apply_crop_edge()


class RGBDataset(BaseDataset):
    """NeuralRGBD synthetic scenes: images/*.png + depth_filtered/*.png +
    poses.txt (4 lines per matrix; NaN rows mark invalid frames, which
    are dropped); ``trainskip`` strides the kept frames."""

    _crop = 0

    def __init__(self, cfg: Dict, basedir: str):
        super().__init__(cfg)
        self.basedir = basedir
        self.img_files = [
            os.path.join(basedir, "images", f)
            for f in sorted(os.listdir(os.path.join(basedir, "images")),
                            key=alphanum_key_sort) if f.endswith("png")]
        ddir = ("depth_filtered"
                if os.path.isdir(os.path.join(basedir, "depth_filtered"))
                else "depth")
        self.depth_paths = [
            os.path.join(basedir, ddir, f)
            for f in sorted(os.listdir(os.path.join(basedir, ddir)),
                            key=alphanum_key_sort) if f.endswith("png")]
        self.poses, valid = self._load_poses(
            os.path.join(basedir, "poses.txt"))
        self._validate_frames(basedir)
        self.frame_ids = [i for i in self._train_ids(len(self.img_files))
                          if valid[i]]
        self.num_frames = len(self.frame_ids)
        if self.num_frames == 0:
            raise ValueError(
                f"{basedir!r}: every pose in poses.txt is NaN/inf — "
                "no usable frames")

    @staticmethod
    def _load_poses(path: str):
        with open(path) as f:
            lines = f.readlines()
        poses, valid = [], []
        for i in range(0, len(lines) - 3, 4):
            block = lines[i:i + 4]
            if any("nan" in ln.lower() for ln in block):
                poses.append(np.eye(4, dtype=np.float32))
                valid.append(False)
            else:
                mat = np.array([[float(x) for x in ln.split()]
                                for ln in block], np.float32)
                poses.append(mat)
                valid.append(np.all(np.isfinite(mat)))
        return poses, valid


class KITTIDataset(BaseDataset):
    """KITTI odometry-style: image_2/*.png + depth/*.png (uint16/256 m) +
    poses.txt with one 3x4 row-major matrix per line (or pose/*.txt)."""

    def __init__(self, cfg: Dict, basedir: str):
        super().__init__(cfg)
        self.basedir = basedir
        img_dir = ("image_2" if os.path.isdir(os.path.join(basedir, "image_2"))
                   else "image_0")
        self.img_files = sorted(
            glob.glob(os.path.join(basedir, img_dir, "*.png"))
            + glob.glob(os.path.join(basedir, img_dir, "*.jpg")))
        self.depth_paths = sorted(
            glob.glob(os.path.join(basedir, "depth", "*.png")))
        self.poses = []
        pose_file = os.path.join(basedir, "poses.txt")
        if os.path.exists(pose_file):
            for row in np.loadtxt(pose_file).reshape(-1, 12):
                c2w = np.eye(4, dtype=np.float32)
                c2w[:3, :4] = row.reshape(3, 4)
                self.poses.append(_opengl(c2w))
        else:
            pose_paths = sorted(
                glob.glob(os.path.join(basedir, "pose", "*.txt")),
                key=_numeric_key)
            self.poses = [_opengl(np.loadtxt(p).reshape(4, 4))
                          for p in pose_paths]
        self._validate_frames(basedir)
        self.frame_ids = self._train_ids(len(self.img_files))
        self.num_frames = len(self.frame_ids)
        self._apply_crop_edge()


class TUMDataset(BaseDataset):
    """TUM RGB-D: rgb.txt / depth.txt / groundtruth.txt association at
    frame_rate=32 with max_dt=0.08."""

    def __init__(self, cfg: Dict, basedir: str, frame_rate: int = 32):
        super().__init__(cfg)
        self.basedir = basedir
        self.img_files, self.depth_paths, self.poses = self._loadtum(
            basedir, frame_rate)
        if not self.img_files:
            raise ValueError(
                f"{basedir!r}: timestamp association produced no frames — "
                "rgb.txt / depth.txt / groundtruth.txt timestamps never "
                "match within 0.08 s (wrong files or clock offset?)")
        self.frame_ids = self._train_ids(len(self.img_files))
        self.num_frames = len(self.frame_ids)

        # Optional resize to cam.crop_size.
        self.resize_hw = cfg["cam"].get("crop_size")
        if self.resize_hw is not None:
            sy = self.resize_hw[0] / self.H
            sx = self.resize_hw[1] / self.W
            self.fx, self.fy = self.fx * sx, self.fy * sy
            self.cx, self.cy = self.cx * sx, self.cy * sy
            self.H, self.W = self.resize_hw
        self._apply_crop_edge()

    @staticmethod
    def _parse_list(path: str) -> np.ndarray:
        return np.loadtxt(path, delimiter=" ", dtype=str, ndmin=2)

    @staticmethod
    def _associate(t_img, t_depth, t_pose, max_dt=0.08):
        assoc = []
        for i, t in enumerate(t_img):
            j = np.argmin(np.abs(t_depth - t))
            k = np.argmin(np.abs(t_pose - t))
            if abs(t_depth[j] - t) < max_dt and abs(t_pose[k] - t) < max_dt:
                assoc.append((i, j, k))
        return assoc

    def _loadtum(self, datapath: str, frame_rate: int):
        from scipy.spatial.transform import Rotation

        pose_list = os.path.join(datapath, "groundtruth.txt")
        if not os.path.isfile(pose_list):
            pose_list = os.path.join(datapath, "pose.txt")
        image_data = self._parse_list(os.path.join(datapath, "rgb.txt"))
        depth_data = self._parse_list(os.path.join(datapath, "depth.txt"))
        pose_data = self._parse_list(pose_list)
        pose_vecs = pose_data[:, 1:].astype(np.float64)

        t_img = image_data[:, 0].astype(np.float64)
        t_depth = depth_data[:, 0].astype(np.float64)
        t_pose = pose_data[:, 0].astype(np.float64)
        assoc = self._associate(t_img, t_depth, t_pose)

        if not assoc:
            return [], [], []
        # Temporal subsampling to ~frame_rate Hz.
        indices = [0]
        for i in range(1, len(assoc)):
            t0 = t_img[assoc[indices[-1]][0]]
            t1 = t_img[assoc[i][0]]
            if t1 - t0 > 1.0 / frame_rate:
                indices.append(i)

        images, depths, poses = [], [], []
        for ix in indices:
            i, j, k = assoc[ix]
            images.append(os.path.join(datapath, image_data[i, 1]))
            depths.append(os.path.join(datapath, depth_data[j, 1]))
            c2w = np.eye(4)
            c2w[:3, :3] = Rotation.from_quat(pose_vecs[k][3:]).as_matrix()
            c2w[:3, 3] = pose_vecs[k][:3]
            poses.append(_opengl(c2w))
        return images, depths, poses

    def __getitem__(self, index: int) -> Dict:
        import cv2

        i = self.frame_ids[index]
        if self.resize_hw is None:
            return super().__getitem__(index)
        # Resize path: load uncropped, resize, then edge-crop.
        rgb, depth = self._load_image_pair(self.img_files[i],
                                           self.depth_paths[i], crop_edge=0)
        h, w = self.resize_hw
        rgb = cv2.resize(rgb, (w, h), interpolation=cv2.INTER_LINEAR)
        depth = cv2.resize(depth, (w, h), interpolation=cv2.INTER_NEAREST)
        edge = self.config["cam"].get("crop_edge", 0)
        if edge > 0:
            rgb = rgb[edge:-edge, edge:-edge]
            depth = depth[edge:-edge, edge:-edge]
        return {"frame_id": i, "c2w": np.asarray(self.poses[i], np.float32),
                "rgb": rgb, "depth": depth, "direction": self._directions()}


class RealsenseDataset(BaseDataset):
    """color/*.jpg + depth/*.png + align_mat.txt + scene/trajectory.log."""

    def __init__(self, cfg: Dict, basedir: str):
        super().__init__(cfg)
        self.basedir = basedir
        self.img_files = sorted(
            glob.glob(os.path.join(basedir, "color", "*.jpg"))
            + glob.glob(os.path.join(basedir, "color", "*.png")))
        self.depth_paths = sorted(
            glob.glob(os.path.join(basedir, "depth", "*.png")))
        self.frame_ids = self._train_ids(len(self.img_files))
        self.num_frames = len(self.frame_ids)

        align_path = os.path.join(basedir, "align_mat.txt")
        align = (np.loadtxt(align_path) if os.path.exists(align_path)
                 else np.eye(4))
        log_path = os.path.join(basedir, "scene", "trajectory.log")
        if os.path.exists(log_path):
            self.poses = [_opengl(align @ p)
                          for p in _parse_trajectory_log(log_path)]
        else:
            self.poses = [np.asarray(align, np.float32)
                          for _ in range(len(self.img_files))]
        self._validate_frames(basedir)
        self._apply_crop_edge()


class iPhoneDataset(BaseDataset):
    """StrayScanner-style: rgb.mp4 (pre-extracted to images/) + depth/ +
    odometry.csv quaternion poses."""

    _crop = 0

    def __init__(self, cfg: Dict, basedir: str):
        super().__init__(cfg)
        self.basedir = basedir
        img_dir = os.path.join(basedir, "images")
        if not os.path.isdir(img_dir):
            os.makedirs(img_dir)
            self._extract_video(os.path.join(basedir, "rgb.mp4"), img_dir)
        self.img_files = [os.path.join(img_dir, f)
                          for f in sorted(os.listdir(img_dir),
                                          key=alphanum_key_sort)
                          if f.endswith("png")]
        self.depth_paths = [
            os.path.join(basedir, "depth", f)
            for f in sorted(os.listdir(os.path.join(basedir, "depth")),
                            key=alphanum_key_sort) if f.endswith("png")]
        self.poses = self._load_odometry(os.path.join(basedir,
                                                      "odometry.csv"))
        self._validate_frames(basedir)
        self.frame_ids = self._train_ids(len(self.img_files))
        self.num_frames = len(self.frame_ids)

    @staticmethod
    def _extract_video(video_path: str, out_dir: str):
        import cv2

        cap = cv2.VideoCapture(video_path)
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) - 1
        for fc in range(n):
            ok, img = cap.read()
            if not ok:
                break
            cv2.imwrite(os.path.join(out_dir, f"{fc:06d}.png"), img)

    @staticmethod
    def _load_odometry(path: str) -> List[np.ndarray]:
        from scipy.spatial.transform import Rotation

        data = np.loadtxt(path, delimiter=",", skiprows=1)
        poses = []
        for row in data:
            vec = row[2:]  # x y z qx qy qz qw
            c2w = np.eye(4)
            c2w[:3, :3] = Rotation.from_quat(vec[3:7]).as_matrix()
            c2w[:3, 3] = vec[:3]
            poses.append(_opengl(c2w))
        return poses
