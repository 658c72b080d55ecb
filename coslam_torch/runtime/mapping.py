"""Mapping: first-frame map initialization and global bundle adjustment.

Counterpart of coslam_tpu/runtime/mapping.py (make_first_frame_step and
make_ba_step). The JAX scans become Python loops of eager steps; the map
optimizer is a persistent ``torch.optim.Adam`` (its moments live across
frames, like the reference's map optimizer), the pose optimizer is fresh
for each BA call. Random draws (ray indices, the stratified
perturbation, the smoothness sample) come from an explicit generator.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops import losses as L
from ..ops import pose as P
from .optim import make_pose_optimizer


def make_first_frame_step(model, config: Dict, map_opt: torch.optim.Adam):
    """Returns run(params, c2w [4, 4], frame_rays [H*W, 7], generator)
    -> (last loss, last psnr): ``mapping.first_iters`` map-only steps on
    one frame at a fixed pose, each on ``mapping.sample`` rays drawn with
    replacement."""
    sample = int(config["mapping"]["sample"])
    n_iters = int(config["mapping"]["first_iters"])
    weights = config["training"]
    perturb = weights["perturb"] > 0

    def run(params, c2w, frame_rays, generator):
        dev = frame_rays.device
        Rm, tv = c2w[:3, :3], c2w[:3, 3]
        loss = psnr = None
        map_opt.zero_grad(set_to_none=True)
        for _ in range(n_iters):
            idx = torch.randint(0, frame_rays.shape[0], (sample,),
                                generator=generator, device=dev)
            rays = frame_rays[idx]
            rays_d = rays[:, :3] @ Rm.T
            t = (torch.rand((sample, model.n_z_samples), generator=generator,
                            device=dev) if perturb else None)
            ret = model.forward(params, tv.expand_as(rays_d), rays_d,
                                rays[:, 3:6], rays[:, 6:7], t=t)
            loss = L.total_loss(ret, weights)
            loss.backward()
            map_opt.step()
            map_opt.zero_grad(set_to_none=True)
            psnr = ret["psnr"]
        return loss.detach(), psnr.detach()

    return run


def build_poses(rot: torch.Tensor, trans: torch.Tensor, poses0: torch.Tensor,
                frozen: torch.Tensor, mat_from_tensor) -> torch.Tensor:
    """Pose matrices [K+1, 4, 4] from the tangents, with the frozen slots
    (the first keyframe; the current frame unless optim_cur) held at
    poses0, so their gradients vanish."""
    return torch.where(frozen[:, None, None], poses0,
                       mat_from_tensor(rot, trans))


class BundleAdjust:
    """Global BA over the keyframe reservoir plus the current frame.

    ``__call__(params, kf_db, kf_poses [num_kf, 4, 4], cur_pose [4, 4],
    cur_rays [H*W, 7], generator) -> (kf_poses, cur_pose, last loss)``
    runs ``mapping.iters`` iterations. Each draws ``mapping.sample``
    keyframe rays and the current-frame quota
    max(sample // kf_count, min_pixels_cur) exactly (no padded block),
    steps the map every ``map_accum_step`` iterations after
    ``map_wait_step``, and, with at least two keyframes, steps the poses
    every ``pose_accum_step`` iterations on the gradients accumulated
    since the last pose step. The first keyframe stays frozen."""

    def __init__(self, model, config: Dict, map_opt: torch.optim.Adam,
                 num_kf: int):
        mcfg = config["mapping"]
        self.model = model
        self.map_opt = map_opt
        self.num_kf = num_kf
        self.sample = int(mcfg["sample"])
        self.iters = int(mcfg["iters"])
        self.min_pixels_cur = int(mcfg["min_pixels_cur"])
        self.map_accum = int(mcfg["map_accum_step"])
        self.map_wait = int(mcfg["map_wait_step"])
        self.pose_accum = int(mcfg["pose_accum_step"])
        self.optim_cur = bool(mcfg["optim_cur"])
        self.lr_rot, self.lr_trans = mcfg["lr_rot"], mcfg["lr_trans"]
        self.weights = config["training"]
        self.smooth_weight = float(self.weights["smooth_weight"])
        self.perturb = self.weights["perturb"] > 0
        self.mat_to_tensor, self.mat_from_tensor = \
            P.get_pose_representation(config["training"]["rot_rep"])

    def loss(self, params: Dict, poses: torch.Tensor, ray_data: torch.Tensor,
             ray_ids: torch.Tensor, smooth_sample: Optional[torch.Tensor],
             t: Optional[torch.Tensor]) -> torch.Tensor:
        """BA loss of rays ray_data [N, 7] seen from poses[ray_ids], plus
        the smoothness TV on the lattice smooth_sample (the model's
        smoothness_sample: points for the hash grid, axes for TensoVM)."""
        pose_rows = poses[ray_ids]                          # [N, 4, 4]
        rays_d = (pose_rows[:, :3, :3] @ ray_data[:, :3, None])[..., 0]
        ret = self.model.forward(params, pose_rows[:, :3, 3], rays_d,
                                 ray_data[:, 3:6], ray_data[:, 6:7], t=t)
        smooth = None
        if smooth_sample is not None:
            smooth = self.model.smoothness(params, smooth_sample,
                                           self.weights["smooth_pts"])
        return L.total_loss(ret, self.weights, smooth_loss=smooth,
                            smooth_weight=self.smooth_weight)

    def frozen_mask(self, device) -> torch.Tensor:
        frozen = torch.zeros(self.num_kf + 1, dtype=torch.bool, device=device)
        frozen[0] = True
        frozen[self.num_kf] = not self.optim_cur
        return frozen

    def __call__(self, params: Dict, kf_db, kf_poses: torch.Tensor,
                 cur_pose: torch.Tensor, cur_rays: torch.Tensor,
                 generator: torch.Generator):
        K = self.num_kf
        dev = cur_rays.device
        kf_count = kf_db.count
        poses0 = torch.cat([kf_poses, cur_pose[None]])
        pose_enable = kf_count >= 2  # no pose optimization with < 2 KFs
        rot = self.mat_to_tensor(poses0[:, :3, :3]).detach().clone()
        trans = poses0[:, :3, 3].clone()
        if pose_enable:
            rot.requires_grad_(True)
            trans.requires_grad_(True)
            pose_opt = make_pose_optimizer(rot, trans, self.lr_rot,
                                           self.lr_trans)
        frozen = self.frozen_mask(dev)
        quota = min(max(self.sample // max(kf_count, 1), self.min_pixels_cur),
                    self.sample)
        cur_ids = torch.full((quota,), K, dtype=torch.int64, device=dev)
        g = self.weights
        self.map_opt.zero_grad(set_to_none=True)
        loss = None
        for i in range(self.iters):
            kf_ray, kf_ids = kf_db.sample_global_rays(self.sample, generator)
            cur_idx = torch.randint(0, cur_rays.shape[0], (quota,),
                                    generator=generator, device=dev)
            ray_data = torch.cat([kf_ray, cur_rays[cur_idx]])
            ray_ids = torch.cat([kf_ids, cur_ids])
            smooth = (self.model.smoothness_sample(
                generator, g["smooth_pts"], g["smooth_vox"],
                g["smooth_margin"]) if self.smooth_weight > 0 else None)
            t = (torch.rand((ray_data.shape[0], self.model.n_z_samples),
                            generator=generator, device=dev)
                 if self.perturb else None)
            poses = build_poses(rot, trans, poses0, frozen,
                                self.mat_from_tensor)
            loss = self.loss(params, poses, ray_data, ray_ids, smooth, t)
            loss.backward()
            if (i + 1) % self.map_accum == 0 and (i + 1) > self.map_wait:
                self.map_opt.step()
                self.map_opt.zero_grad(set_to_none=True)
            if pose_enable and (i + 1) % self.pose_accum == 0:
                pose_opt.step()
                pose_opt.zero_grad(set_to_none=True)
        if not pose_enable:
            return kf_poses, cur_pose, loss.detach()
        with torch.no_grad():
            final = build_poses(rot, trans, poses0, frozen,
                                self.mat_from_tensor)
        return (final[:K], final[K] if self.optim_cur else cur_pose,
                loss.detach())
