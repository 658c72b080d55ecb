"""Camera tracking: a fixed number of Adam steps on the frame's pose.

Counterpart of coslam_tpu/runtime/tracking.py (make_tracking_step and
make_tracking_pc_step). The JAX ``lax.scan`` becomes a Python loop of
eager steps; the best-pose carry, the stall counter and the early-stop
mask stay on the device as ``torch.where`` selects, so the loop issues
no host read.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops import losses as L
from ..ops import pose as P
from ..parallel.sharding import (add_stats, dp_forward, on_device, replicate,
                                 shard_devices, split_rays)
from .optim import detached, make_pose_optimizer
from .spans import NO_SPANS


def make_tracking_step(model, config: Dict, devices=None, spans=None):
    """Returns step(params, c2w_init [4, 4], rays [S, 7], generator,
    align=None) -> (c2w [4, 4], losses [iter], psnrs [iter], align), all
    on the device. ``align`` [4] (training.frame_align: the frame's
    initial exposure parameters, else None) is optimized with the pose
    (Adam at tracking.lr_align, else mapping.lr_align, else 0.01) and
    returned chosen with it; None stays None.

    The map is frozen (the parameters are detached), so the encode
    backward computes dx only. With ``tracking.best`` the returned pose
    is the lowest-loss pose EVALUATED in some iteration, otherwise the
    pose evaluated in the last executed iteration — not the pose after
    the last update. ``generator`` draws the stratified perturbation and
    the importance samples (unused when ``training.perturb`` is 0).

    ``devices`` (two or more: ``parallel.dp``): the rays are split over
    them (parallel/sharding.py); the frozen map is copied to each once a
    call, the draws are made on the rays' device for the whole batch.

    ``spans`` (runtime/spans.Spans): each iteration's phases are spans
    ``tracking.forward`` (the draws, the pose, the forward and the loss),
    ``tracking.backward`` (zero_grad and the backward) and
    ``tracking.update`` (the best-pose selects, the Adam step and the
    early-stop copy)."""
    devices = shard_devices(devices)
    span = (spans or NO_SPANS).span
    tcfg = config["tracking"]
    n_iter = int(tcfg["iter"])
    use_best = bool(tcfg["best"])
    wait_iters = int(tcfg["wait_iters"])
    weights = config["training"]
    robust = float(tcfg.get("robust_delta", 0.0) or 0.0) or None
    prior_t = float(tcfg.get("prior_trans", 0.0) or 0.0)
    prior_r = float(tcfg.get("prior_rot", 0.0) or 0.0)
    lr_align = float(tcfg.get("lr_align",
                              config["mapping"].get("lr_align", 0.01)))
    mat_to_tensor, mat_from_tensor = P.get_pose_representation(
        config["training"]["rot_rep"])

    def step(params, c2w_init, rays, generator=None, align=None):
        params = detached(params)
        replicas = replicate(params, devices) if devices else None
        rot0 = mat_to_tensor(c2w_init[:3, :3])[None]
        trans0 = c2w_init[:3, 3][None]
        state = [rot0.clone(), trans0.clone()]
        if align is not None:
            state.append(align.detach().clone())
        for v in state:
            v.requires_grad_(True)
        rot, trans = state[:2]
        align = state[2] if align is not None else None
        opt = make_pose_optimizer(rot, trans, tcfg["lr_rot"],
                                  tcfg["lr_trans"], align, lr_align)
        dirs, target_rgb, target_d = rays[:, :3], rays[:, 3:6], rays[:, 6:7]
        dev = rays.device

        best_loss = torch.tensor(float("inf"), device=dev)
        best = [v.detach().clone() for v in state]
        last = [v.detach().clone() for v in state]
        stall = torch.zeros((), dtype=torch.int64, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
        losses, psnrs = [], []
        for _ in range(n_iter):
            with span("tracking.forward"):
                t, u = model.ray_draws(generator, rays.shape[0], dev)
                c2w = mat_from_tensor(rot, trans)[0]
                rays_d = dirs @ c2w[:3, :3].T
                rays_o = c2w[:3, 3].expand_as(rays_d)
                ret = dp_forward(model, params, devices, rays_o, rays_d,
                                 target_rgb, target_d, replicas, t=t, u=u,
                                 rgb_kernel=robust, align=align)
                loss = L.total_loss(ret, weights)
                if prior_t > 0.0:
                    loss = loss + prior_t * ((trans - trans0) ** 2).sum()
                if prior_r > 0.0:
                    loss = loss + prior_r * ((rot - rot0) ** 2).sum()
            with span("tracking.backward"):
                opt.zero_grad(set_to_none=True)
                loss.backward()

            with span("tracking.update"):
                with torch.no_grad():
                    loss_d = loss.detach()
                    improved = loss_d < best_loss
                    take = improved & ~done
                    best = [torch.where(take, v, b)
                            for v, b in zip(state, best)]
                    best_loss = torch.where(take, loss_d, best_loss)
                    stall = torch.where(done, stall,
                                        torch.where(improved, 0, stall + 1))
                    last = [torch.where(done, b, v)
                            for v, b in zip(state, last)]
                    old = [v.clone() for v in state]
                opt.step()
                with torch.no_grad():
                    # After the early stop the pose stays where it was.
                    for v, o in zip(state, old):
                        v.copy_(torch.where(done, o, v))
                    done = done | (stall > wait_iters)
                losses.append(loss_d)
                psnrs.append(ret["psnr"].detach())

        with torch.no_grad():
            chosen = best if use_best else last
            c2w = mat_from_tensor(chosen[0], chosen[1])[0]
        return (c2w, torch.stack(losses), torch.stack(psnrs),
                chosen[2] if align is not None else None)

    return step


def make_tracking_pc_step(model, config: Dict, devices=None):
    """Point-cloud tracking (tracking.iter_point > 0; coslam_tpu's
    make_tracking_pc_step): returns step(params, c2w_init [4, 4], rays
    [S, 7]) -> (c2w [4, 4], last loss). Each of max(iter_point, 1) Adam
    steps back-projects the rays' depths from the current pose, queries
    SDF and color there and minimizes 5 mse(rgb) + 1000 mse(sdf) over the
    rays with depth in (0, 5) m; the pose returned is the best evaluated
    (tracking.best) or the last evaluated. The map is frozen. ``devices``:
    the points split over them, as :func:`make_tracking_step`'s rays."""
    devices = shard_devices(devices)
    tcfg = config["tracking"]
    n_iter = max(int(tcfg["iter_point"]), 1)
    use_best = bool(tcfg["best"])
    mat_to_tensor, mat_from_tensor = P.get_pose_representation(
        config["training"]["rot_rep"])

    def stats(params, pts, target_rgb, valid):
        out = model.query_color_sdf(params, model.normalize_coords(pts))
        rgb_sum, rgb_n = L.masked_sum(
            (torch.sigmoid(out[:, :3]) - target_rgb) ** 2, valid[:, None])
        sdf_sum, sdf_n = L.masked_sum(out[:, -1] ** 2, valid)
        return {"rgb_sum": rgb_sum, "rgb_n": rgb_n, "sdf_sum": sdf_sum,
                "sdf_n": sdf_n}

    def step(params, c2w_init, rays):
        params = detached(params)
        replicas = replicate(params, devices) if devices else None
        rot = mat_to_tensor(c2w_init[:3, :3])[None].clone().requires_grad_()
        trans = c2w_init[:3, 3][None].clone().requires_grad_()
        opt = make_pose_optimizer(rot, trans, tcfg["lr_rot"],
                                  tcfg["lr_trans"])
        dirs, target_rgb, target_d = rays[:, :3], rays[:, 3:6], rays[:, 6:7]
        # A fixed 5 m bound, as the JAX step's (not cam.depth_trunc).
        valid = ((target_d[:, 0] > 0.0) & (target_d[:, 0] < 5.0)).float()
        best_loss = torch.tensor(float("inf"), device=rays.device)
        best = last = (rot.detach().clone(), trans.detach().clone())
        loss_d = None
        for _ in range(n_iter):
            c2w = mat_from_tensor(rot, trans)[0]
            pts = c2w[:3, 3][None] + target_d * (dirs @ c2w[:3, :3].T)
            if devices:
                shards = []
                for dev, rep, *block in zip(
                        devices, replicas, *(split_rays(x, devices)
                                             for x in (pts, target_rgb,
                                                       valid))):
                    with on_device(dev):
                        shards.append(stats(rep, *block))
                s = add_stats(shards, rays.device)
            else:
                s = stats(params, pts, target_rgb, valid)
            rgb_l = s["rgb_sum"] / s["rgb_n"].clamp_min(1.0)
            sdf_l = s["sdf_sum"] / s["sdf_n"].clamp_min(1.0)
            loss = 5.0 * rgb_l + 1000.0 * sdf_l
            opt.zero_grad(set_to_none=True)
            loss.backward()
            with torch.no_grad():
                loss_d = loss.detach()
                improved = loss_d < best_loss
                best = tuple(torch.where(improved, v, b)
                             for v, b in zip((rot, trans), best))
                best_loss = torch.minimum(loss_d, best_loss)
                last = (rot.detach().clone(), trans.detach().clone())
            opt.step()
        with torch.no_grad():
            chosen = best if use_best else last
            return mat_from_tensor(*chosen)[0], loss_d

    return step


def predict_current_pose(est_prev, est_prev_prev=None, constant_speed=True,
                         gap_ratio: float = 1.0):
    """Constant-speed motion model (coslam_tpu.runtime.tracking
    .predict_current_pose): apply the last inter-frame delta to the
    previous pose, or copy it when there is no history. ``gap_ratio``
    rescales that delta for frames spaced unevenly (ActiveCoSLAM tracks
    an info-gain subsequence): the rotation vector and the translation
    are scaled together (scipy's rotation-vector map). At 1 the delta is
    applied as it is."""
    if est_prev_prev is None or not constant_speed:
        return np.array(est_prev, np.float32)
    delta = est_prev @ np.linalg.inv(est_prev_prev.astype(np.float64))
    if gap_ratio != 1.0:
        from scipy.spatial.transform import Rotation

        rotvec = Rotation.from_matrix(delta[:3, :3]).as_rotvec()
        scaled = np.eye(4)
        scaled[:3, :3] = Rotation.from_rotvec(gap_ratio * rotvec).as_matrix()
        scaled[:3, 3] = gap_ratio * delta[:3, 3]
        delta = scaled
    return (delta @ est_prev).astype(np.float32)
