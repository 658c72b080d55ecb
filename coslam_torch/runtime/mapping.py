"""Mapping: first-frame map initialization, the current-frame step and
global bundle adjustment.

Counterpart of coslam_tpu/runtime/mapping.py (make_first_frame_step,
make_current_frame_step and make_ba_step). The JAX scans become Python
loops of eager steps; the map
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
from ..parallel.sharding import dp_forward, shard_devices
from .optim import detached, make_pose_optimizer
from .spans import NO_SPANS


def make_first_frame_step(model, config: Dict, map_opt: torch.optim.Adam,
                          devices=None, spans=None):
    """Returns run(params, c2w [4, 4], frame_rays [H*W, 7], generator)
    -> (last loss, last psnr): ``mapping.first_iters`` map-only steps on
    one frame at a fixed pose, each on ``mapping.sample`` rays drawn with
    replacement. ``devices`` (two or more: ``parallel.dp``): each
    iteration's rays split over them (parallel/sharding.py), the
    parameters on the first. ``spans`` (runtime/spans.Spans): each
    iteration's phases are spans ``first_frame.forward`` (the draws, the
    forward and the loss; the importance fine pass inside it is a span
    ``first_frame.fine``), ``first_frame.backward`` and
    ``first_frame.update`` (the map's Adam step)."""
    devices = shard_devices(devices)
    span = (spans or NO_SPANS).span
    sample = int(config["mapping"]["sample"])
    n_iters = int(config["mapping"]["first_iters"])
    weights = config["training"]

    def run(params, c2w, frame_rays, generator):
        dev = frame_rays.device
        Rm, tv = c2w[:3, :3], c2w[:3, 3]
        loss = psnr = None
        map_opt.zero_grad(set_to_none=True)
        for _ in range(n_iters):
            with span("first_frame.forward"):
                idx = torch.randint(0, frame_rays.shape[0], (sample,),
                                    generator=generator, device=dev)
                rays = frame_rays[idx]
                rays_d = rays[:, :3] @ Rm.T
                t, u = model.ray_draws(generator, sample, dev)
                ret = dp_forward(model, params, devices,
                                 tv.expand_as(rays_d), rays_d, rays[:, 3:6],
                                 rays[:, 6:7], t=t, u=u)
                loss = L.total_loss(ret, weights)
            with span("first_frame.backward"):
                loss.backward()
            with span("first_frame.update"):
                map_opt.step()
                map_opt.zero_grad(set_to_none=True)
            psnr = ret["psnr"]
        return loss.detach(), psnr.detach()

    return run


def make_current_frame_step(model, config: Dict, cur_opt: torch.optim.Adam,
                            devices=None):
    """Returns run(params, c2w [4, 4], frame_rays [H*W, 7], generator,
    draws=None) -> last loss: ``mapping.cur_frame_iters`` grid-only
    steps on the current frame at its tracked pose (coslam_tpu's
    make_current_frame_step; mapping.cur_frame_iters > 0). Each draws
    ``mapping.sample`` pixels with replacement from the whole frame; the
    loss is total_loss without the smoothness term; ``cur_opt`` (the
    grid's own Adam, optim.make_cur_map_optimizer) steps the grid, and the
    decoder stays fixed. ``draws``: an optional list, one (pixel indices
    [sample], perturbation [sample, n_z] or None[, importance draw
    [sample, n_importance]]) an iteration, in place of the
    generator's. ``devices``: as :func:`make_first_frame_step`'s."""
    devices = shard_devices(devices)
    sample = int(config["mapping"]["sample"])
    n_iters = int(config["mapping"]["cur_frame_iters"])
    weights = config["training"]

    def run(params, c2w, frame_rays, generator, draws=None):
        dev = frame_rays.device
        Rm, tv = c2w[:3, :3], c2w[:3, 3]
        # Gradients for the grid only: the decoder (and a color grid)
        # enter as constants.
        p = {**detached(params), "grid": params["grid"]}
        loss = None
        cur_opt.zero_grad(set_to_none=True)
        for it in range(n_iters):
            if draws is not None:
                idx, t, *u = draws[it]
                u = u[0] if u else None
            else:
                idx = torch.randint(0, frame_rays.shape[0], (sample,),
                                    generator=generator, device=dev)
                t, u = model.ray_draws(generator, sample, dev)
            rays = frame_rays[idx]
            rays_d = rays[:, :3] @ Rm.T
            ret = dp_forward(model, p, devices, tv.expand_as(rays_d), rays_d,
                             rays[:, 3:6], rays[:, 6:7], t=t, u=u)
            loss = L.total_loss(ret, weights)
            loss.backward()
            cur_opt.step()
            cur_opt.zero_grad(set_to_none=True)
        return loss.detach()

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
    cur_rays [H*W, 7], generator, kf_aligns=None, cur_align=None) ->
    (kf_poses, cur_pose, last loss, kf_aligns, cur_align)`` runs
    ``mapping.iters`` iterations. Each draws ``mapping.sample`` keyframe
    rays and the current-frame quota max(sample // kf_count,
    min_pixels_cur) exactly (no padded block), steps the map every
    ``map_accum_step`` iterations after ``map_wait_step``, and, with at
    least two keyframes, steps the poses every ``pose_accum_step``
    iterations on the gradients accumulated since the last pose step. The
    first keyframe stays frozen. Given the exposure parameters
    (training.frame_align; None otherwise, returned as None), the table
    [num_kf + 1, 4] (the keyframes' kf_aligns [num_kf, 4], then the
    current frame's cur_align [4]) joins the pose optimizer at
    mapping.lr_align (default 1e-3): each ray takes its frame's row, row 0
    stays at the first keyframe's value (the gauge, as that keyframe's
    pose is), and the new values come back only with at least two
    keyframes.

    ``devices`` (two or more: ``parallel.dp``): each iteration's rays (the
    keyframe sample, then the current-frame quota, split unevenly by
    torch.tensor_split where the quota does not divide: nothing is
    padded) over them, the parameters and the smoothness term on the
    first (parallel/sharding.py).

    ``spans`` (runtime/spans.Spans): each iteration's phases are spans
    ``mapping.forward`` (the keyframe and current-frame rays, the TV
    lattice, the draws, the poses and the loss; the importance fine pass
    inside it is a span ``mapping.fine``), ``mapping.backward`` and
    ``mapping.update`` (the map's and the poses' optimizer steps)."""

    def __init__(self, model, config: Dict, map_opt: torch.optim.Adam,
                 num_kf: int, devices=None, spans=None):
        mcfg = config["mapping"]
        self.model = model
        self.devices = shard_devices(devices)
        self.span = (spans or NO_SPANS).span
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
        self.lr_align = float(mcfg.get("lr_align", 1e-3))
        self.weights = config["training"]
        self.smooth_weight = float(self.weights["smooth_weight"])
        self.mat_to_tensor, self.mat_from_tensor = \
            P.get_pose_representation(config["training"]["rot_rep"])

    def loss(self, params: Dict, poses: torch.Tensor, ray_data: torch.Tensor,
             ray_ids: torch.Tensor, smooth_sample: Optional[torch.Tensor],
             t: Optional[torch.Tensor], u: Optional[torch.Tensor] = None,
             aligns: Optional[torch.Tensor] = None) -> torch.Tensor:
        """BA loss of rays ray_data [N, 7] seen from poses[ray_ids] (with
        the exposure parameters aligns[ray_ids] when given), plus the
        smoothness TV on the lattice smooth_sample (the model's
        smoothness_sample: points for the hash grids, axes for the
        factorized ones)."""
        pose_rows = poses[ray_ids]                          # [N, 4, 4]
        rays_d = (pose_rows[:, :3, :3] @ ray_data[:, :3, None])[..., 0]
        ret = dp_forward(
            self.model, params, self.devices, pose_rows[:, :3, 3], rays_d,
            ray_data[:, 3:6], ray_data[:, 6:7], t=t, u=u,
            align=None if aligns is None else aligns[ray_ids])
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
                 generator: torch.Generator,
                 kf_aligns: Optional[torch.Tensor] = None,
                 cur_align: Optional[torch.Tensor] = None):
        K = self.num_kf
        dev = cur_rays.device
        kf_count = kf_db.count
        poses0 = torch.cat([kf_poses, cur_pose[None]])
        pose_enable = kf_count >= 2  # no pose optimization with < 2 KFs
        rot = self.mat_to_tensor(poses0[:, :3, :3]).detach().clone()
        trans = poses0[:, :3, 3].clone()
        use_align = kf_aligns is not None
        align = aligns0 = None
        if use_align:
            aligns0 = torch.cat([kf_aligns, cur_align[None]])
            align = aligns0.clone()
            gauge = torch.arange(K + 1, device=dev)[:, None] == 0
        if pose_enable:
            for v in (rot, trans, align):
                if v is not None:
                    v.requires_grad_(True)
            pose_opt = make_pose_optimizer(rot, trans, self.lr_rot,
                                           self.lr_trans, align,
                                           self.lr_align)
        frozen = self.frozen_mask(dev)
        quota = min(max(self.sample // max(kf_count, 1), self.min_pixels_cur),
                    self.sample)
        cur_ids = torch.full((quota,), K, dtype=torch.int64, device=dev)
        g = self.weights
        self.map_opt.zero_grad(set_to_none=True)
        loss = None
        span = self.span
        for i in range(self.iters):
            with span("mapping.forward"):
                kf_ray, kf_ids = kf_db.sample_global_rays(self.sample,
                                                          generator)
                cur_idx = torch.randint(0, cur_rays.shape[0], (quota,),
                                        generator=generator, device=dev)
                ray_data = torch.cat([kf_ray, cur_rays[cur_idx]])
                ray_ids = torch.cat([kf_ids, cur_ids])
                smooth = (self.model.smoothness_sample(
                    generator, g["smooth_pts"], g["smooth_vox"],
                    g["smooth_margin"]) if self.smooth_weight > 0 else None)
                t, u = self.model.ray_draws(generator, ray_data.shape[0],
                                            dev)
                poses = build_poses(rot, trans, poses0, frozen,
                                    self.mat_from_tensor)
                aligns = (torch.where(gauge, aligns0, align) if use_align
                          else None)
                loss = self.loss(params, poses, ray_data, ray_ids, smooth, t,
                                 u, aligns)
            with span("mapping.backward"):
                loss.backward()
            with span("mapping.update"):
                if (i + 1) % self.map_accum == 0 and (i + 1) > self.map_wait:
                    self.map_opt.step()
                    self.map_opt.zero_grad(set_to_none=True)
                if pose_enable and (i + 1) % self.pose_accum == 0:
                    pose_opt.step()
                    pose_opt.zero_grad(set_to_none=True)
        if not pose_enable:
            return kf_poses, cur_pose, loss.detach(), kf_aligns, cur_align
        with torch.no_grad():
            final = build_poses(rot, trans, poses0, frozen,
                                self.mat_from_tensor)
            if use_align:
                fa = torch.where(gauge, aligns0, align)
                kf_aligns, cur_align = fa[:K], fa[K]
            return (final[:K], final[K] if self.optim_cur else cur_pose,
                    loss.detach(), kf_aligns, cur_align)
