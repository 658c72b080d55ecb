"""Co-SLAM sequential loop on PyTorch tensors.

Counterpart of coslam_tpu/runtime/slam.py:CoSLAM.run (the sequential
loop): first-frame mapping, tracking of every frame from the
constant-speed prediction, BA every ``mapping.map_every`` frames, a
keyframe every ``mapping.keyframe_every`` frames, then the final mesh and
the ATE. Everything runs on tensors on ``device``; the host reads one
packed [pose, loss, psnr] array per tracked frame and one per BA call.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..models.scene_rep import JointEncoding
from .keyframe import KeyFrameDatabase
from .mapping import BundleAdjust, make_first_frame_step
from .optim import make_map_optimizer
from .tracking import make_tracking_step, predict_current_pose


def _check_supported_loop(config: Dict) -> None:
    unsupported = {
        "tracking.iter_point > 0": config["tracking"]["iter_point"] > 0,
        "mapping.cur_frame_iters > 0":
            config["mapping"]["cur_frame_iters"] > 0,
        "tracking.sample_info_frac > 0":
            float(config["tracking"].get("sample_info_frac", 0) or 0) > 0,
        "parallel.dp > 1":
            int((config.get("parallel") or {}).get("dp", 1) or 1) > 1,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


class CoSLAM:
    def __init__(self, config: Dict, dataset=None, device="cuda"):
        _check_supported_loop(config)
        self.config = config
        if dataset is None:
            from ..data.datasets import get_dataset
            dataset = get_dataset(config)
        self.dataset = dataset
        self.device = torch.device(device)
        self.bounding_box = np.array(config["mapping"]["bound"], np.float32)
        self.marching_cube_bound = np.array(
            config["mapping"]["marching_cubes_bound"], np.float32)

        n = dataset.num_frames
        self.est_c2w = np.zeros((n, 4, 4), np.float32)
        self.pose_gt = {i: np.asarray(p, np.float32)
                        for i, p in enumerate(dataset.poses)}

        seed = int(config.get("seed", 0))
        self._seed = seed
        # One generator on the device for every draw of the run (ray
        # indices, perturbations, lattices, keyframe subsets), one on the
        # CPU for the parameter init (device-independent values).
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.model = JointEncoding(config, self.bounding_box, self.device)
        self.params = self.model.init_params(
            torch.Generator().manual_seed(seed))
        self.map_opt = make_map_optimizer(config, self.params)

        num_kf = int(n // config["mapping"]["keyframe_every"] + 1)
        self.kf_db = KeyFrameDatabase(config, num_kf, dataset.num_rays_to_save,
                                      self.device)
        self.kf_poses = torch.eye(4, device=self.device).repeat(num_kf, 1, 1)
        self._track_step = make_tracking_step(self.model, config)
        self._first_step = make_first_frame_step(self.model, config,
                                                 self.map_opt)
        self._ba = BundleAdjust(self.model, config, self.map_opt, num_kf)
        self.timings = {"first_frame": [], "tracking": [], "mapping": [],
                        "mesh": []}
        self.losses = {"first_frame": [], "tracking": [], "mapping": []}
        self.final_mesh = None

    # -- frames -----------------------------------------------------------------

    def _frame_block(self, batch: Dict) -> torch.Tensor:
        """[H*W, 7] = [direction, rgb, depth] on the device."""
        block = np.concatenate(
            [np.asarray(batch["direction"]).reshape(-1, 3),
             np.asarray(batch["rgb"]).reshape(-1, 3),
             np.asarray(batch["depth"]).reshape(-1, 1)], axis=1)
        return torch.from_numpy(block.astype(np.float32)).to(self.device)

    def _sample_tracking_rays(self, batch: Dict) -> torch.Tensor:
        """``tracking.sample`` pixels of the edge-cropped image without
        replacement, drawn from a numpy stream keyed by (seed, frame id)
        as in the JAX package -> [S, 7] on the device."""
        iH = self.config["tracking"]["ignore_edge_H"]
        iW = self.config["tracking"]["ignore_edge_W"]
        S = self.config["tracking"]["sample"]
        direction = batch["direction"]
        H, W = direction.shape[:2]
        cw = W - 2 * iW
        rng = np.random.default_rng((self._seed, int(batch["frame_id"])))
        idx = rng.choice((H - 2 * iH) * cw, size=S, replace=False)
        r, c = idx // cw + iH, idx % cw + iW
        rays = np.concatenate([direction[r, c], np.asarray(batch["rgb"])[r, c],
                               np.asarray(batch["depth"])[r, c, None]], 1)
        return torch.from_numpy(rays.astype(np.float32)).to(self.device)

    # -- phases -----------------------------------------------------------------

    def first_frame_mapping(self, batch: Dict) -> float:
        t0 = time.perf_counter()
        c2w = np.asarray(batch["c2w"], np.float32)
        self.est_c2w[0] = c2w
        frame_rays = self._frame_block(batch)
        loss, _ = self._first_step(self.params,
                                   torch.from_numpy(c2w).to(self.device),
                                   frame_rays, self.generator)
        self.add_keyframe(batch, frame_rays)
        loss = float(loss)  # waits for the device
        self.timings["first_frame"].append(time.perf_counter() - t0)
        self.losses["first_frame"].append(loss)
        return loss

    def tracking_render(self, batch: Dict, frame_id: int) -> float:
        t0 = time.perf_counter()
        prev = self.est_c2w[frame_id - 1]
        prev_prev = self.est_c2w[frame_id - 2] if frame_id >= 2 else None
        c2w_init = torch.from_numpy(predict_current_pose(
            prev, prev_prev, self.config["tracking"]["const_speed"])
        ).to(self.device)
        c2w, losses, psnrs = self._track_step(
            self.params, c2w_init, self._sample_tracking_rays(batch),
            self.generator)
        finite = torch.isfinite(c2w).all()
        # A non-finite pose would poison every later frame through the
        # prediction and BA: keep the motion-model prediction instead.
        c2w = torch.where(finite, c2w, c2w_init)
        packed = torch.cat([c2w.reshape(-1), losses[-1:], psnrs[-1:],
                            finite.float()[None]]).cpu().numpy()
        self.est_c2w[frame_id] = packed[:16].reshape(4, 4)
        if packed[18] == 0.0:
            print(f"tracking produced a non-finite pose at frame {frame_id}; "
                  "keeping the motion-model prediction")
        self.timings["tracking"].append(time.perf_counter() - t0)
        self.losses["tracking"].append(float(packed[16]))
        return float(packed[16])

    def global_BA(self, batch: Dict, cur_frame_id: int) -> float:
        t0 = time.perf_counter()
        cur_pose = torch.from_numpy(self.est_c2w[cur_frame_id]).to(self.device)
        kf_poses, new_cur, loss = self._ba(
            self.params, self.kf_db, self.kf_poses, cur_pose,
            self._frame_block(batch), self.generator)
        self.kf_poses = kf_poses
        count = self.kf_db.count
        packed = torch.cat([kf_poses[:count].reshape(-1), new_cur.reshape(-1),
                            loss[None]]).cpu().numpy()
        if count >= 2:
            kf_np = packed[:count * 16].reshape(count, 4, 4)
            for slot in range(1, count):
                self.est_c2w[int(self.kf_db.frame_ids[slot])] = kf_np[slot]
            if self.config["mapping"]["optim_cur"]:
                self.est_c2w[cur_frame_id] = \
                    packed[count * 16:count * 16 + 16].reshape(4, 4)
        self.timings["mapping"].append(time.perf_counter() - t0)
        self.losses["mapping"].append(float(packed[-1]))
        return float(packed[-1])

    def add_keyframe(self, batch: Dict,
                     frame_rays: Optional[torch.Tensor] = None) -> None:
        if frame_rays is None:
            frame_rays = self._frame_block(batch)
        fid = int(batch["frame_id"])
        slot = self.kf_db.add_keyframe(
            frame_rays, fid, self.generator,
            filter_depth=self.config["mapping"]["filter_depth"])
        self.kf_poses[slot] = torch.from_numpy(self.est_c2w[fid]).to(
            self.device)

    def save_mesh(self, i: int, voxel_size: float = 0.05):
        from ..mesh.extract import extract_mesh

        t0 = time.perf_counter()
        out = os.path.join(self.config["data"]["output"],
                           self.config["data"]["exp_name"])
        os.makedirs(out, exist_ok=True)
        mesh = extract_mesh(self.model, self.params, self.config,
                            self.bounding_box,
                            marching_cube_bound=self.marching_cube_bound,
                            color_func=self.model.query_color,
                            voxel_size=voxel_size,
                            mesh_savepath=os.path.join(
                                out, f"mesh_track{i}.ply"))
        self.timings["mesh"].append(time.perf_counter() - t0)
        return mesh

    def evaluate_ate(self, n_frames: int) -> Dict:
        """ATE of the first n_frames tracked poses against the ground truth
        (coslam_tpu.eval.ate without its plot); appends to output.txt."""
        from ..eval.ate import convert_poses, evaluate_ate

        est = {i: self.est_c2w[i] for i in range(n_frames)}
        gt_arr, mask = convert_poses(self.pose_gt, n_frames, 1.0)
        est_arr, _ = convert_poses(est, n_frames, 1.0, gt=False)
        est_arr = est_arr[mask[:len(est_arr)]]
        results = evaluate_ate({k: v for k, v in enumerate(gt_arr)},
                               {k: v for k, v in enumerate(est_arr)})
        results["Name"] = n_frames - 1
        out = os.path.join(self.config["data"]["output"],
                           self.config["data"]["exp_name"])
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "output.txt"), "a") as f:
            print(results, file=f)
        return results

    # -- main loop --------------------------------------------------------------

    def run(self, n_frames: Optional[int] = None, verbose: bool = True,
            eval_ate: bool = True, mesh: bool = True):
        """Process the first n_frames frames (all by default); returns the
        ATE statistics (None with eval_ate=False)."""
        cfg = self.config
        total = self.dataset.num_frames if n_frames is None else min(
            n_frames, self.dataset.num_frames)
        map_every = cfg["mapping"]["map_every"]
        kf_every = cfg["mapping"]["keyframe_every"]
        mesh_every = int(cfg["mesh"].get("vis", 0) or 0)
        for i in range(total):
            batch = self.dataset[i]
            if i == 0:
                loss = self.first_frame_mapping(batch)
                if cfg["mapping"].get("first_mesh"):
                    self.save_mesh(0, voxel_size=cfg["mesh"]["voxel_eval"])
                if verbose:
                    print(f"frame 0: first-frame mapping loss {loss:.5f}")
                continue
            loss = self.tracking_render(batch, i)
            if verbose:
                err = np.abs(self.est_c2w[i][:3] - self.pose_gt[i][:3]).mean()
                print(f"it: {i}, loss: {loss:.5f}, pose L1 vs gt: {err:.5f}")
            if i % map_every == 0:
                self.global_BA(batch, i)
            if i % kf_every == 0:
                self.add_keyframe(batch)
            # Periodic mesh + ATE on the mesh.vis cadence, in the loop
            # (the JAX package moves it to a worker thread).
            if mesh_every and i % mesh_every == 0:
                self.save_mesh(i, voxel_size=cfg["mesh"]["voxel_eval"])
                if eval_ate:
                    self.evaluate_ate(i + 1)
        if mesh:
            self.final_mesh = self.save_mesh(
                total - 1, voxel_size=cfg["mesh"]["voxel_final"])
        results = self.evaluate_ate(total) if eval_ate else None
        if verbose and results is not None:
            print(f"ATE RMSE {results['absolute_translational_error.rmse']}")
        return results
