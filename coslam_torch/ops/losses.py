"""Loss functions for SDF volume rendering in PyTorch.

Counterpart of coslam_tpu/ops/losses.py: every loss takes an optional
validity mask, and padded or masked rays add to no sum or count. A masked
mean is a sum over a count (:func:`masked_sum`); the model's loss terms
keep the two apart (:func:`sdf_loss_stats`), so the sums and counts of
several ray shards add up to those of the whole batch
(parallel/sharding.py).
"""

from __future__ import annotations

import math

import torch


def mse2psnr(x: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(x + 1e-6) / math.log(10.0)


def masked_sum(x: torch.Tensor, mask: torch.Tensor):
    """(sum of x over the elements where mask == 1, their count); mask
    broadcasts to x. Both add across ray shards."""
    mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
    return (x * mask).sum(), mask.sum()


def masked_mean(x: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean of x over elements where mask == 1 (mask broadcasts to x)."""
    if mask is None:
        return x.mean()
    total, count = masked_sum(x, mask)
    return total / count.clamp_min(1.0)


def _residual(prediction: torch.Tensor, target: torch.Tensor,
              loss_type: str) -> torch.Tensor:
    if loss_type == "l2":
        return (prediction - target) ** 2
    if loss_type == "l1":
        return (prediction - target).abs()
    raise ValueError(f"Unsupported loss type {loss_type}")


def compute_loss(prediction: torch.Tensor, target: torch.Tensor,
                 loss_type: str = "l2", mask=None) -> torch.Tensor:
    return masked_mean(_residual(prediction, target, loss_type), mask)


def huber(prediction: torch.Tensor, target: torch.Tensor,
          delta: float) -> torch.Tensor:
    """Elementwise Huber scaled to match l2 below delta: r^2, then
    delta(2|r| - delta)."""
    a = (prediction - target).abs()
    q = a.clamp_max(delta)
    return q * (2.0 * a - q)


def huber_loss(prediction: torch.Tensor, target: torch.Tensor, delta: float,
               mask=None) -> torch.Tensor:
    """Mean of :func:`huber` over the mask."""
    return masked_mean(huber(prediction, target, delta), mask)


def sdf_mask_counts(z_vals: torch.Tensor, target_d: torch.Tensor,
                    truncation: float, ray_mask=None):
    """(front_mask, sdf_mask, num_fs, num_sdf): the free-space and
    truncation-band masks of z_vals [B, S] against target_d [B, 1] and
    their counts."""
    front_mask = (z_vals < (target_d - truncation)).to(z_vals.dtype)
    back_mask = (z_vals > (target_d + truncation)).to(z_vals.dtype)
    depth_mask = (target_d > 0.0).to(z_vals.dtype)
    sdf_mask = (1.0 - front_mask) * (1.0 - back_mask) * depth_mask
    if ray_mask is not None:
        rm = ray_mask.reshape(-1, 1).to(z_vals.dtype)
        front_mask = front_mask * rm
        sdf_mask = sdf_mask * rm
    return front_mask, sdf_mask, front_mask.sum(), sdf_mask.sum()


def _band_weights(num_fs: torch.Tensor, num_sdf: torch.Tensor):
    num = (num_fs + num_sdf).clamp_min(1.0)
    return 1.0 - num_fs / num, 1.0 - num_sdf / num


def get_masks(z_vals: torch.Tensor, target_d: torch.Tensor,
              truncation: float, ray_mask=None):
    """(front_mask, sdf_mask, fs_weight, sdf_weight) for z_vals [B, S]
    and target_d [B, 1]; the weights are 1 - count / total."""
    front_mask, sdf_mask, num_fs, num_sdf = sdf_mask_counts(
        z_vals, target_d, truncation, ray_mask)
    return (front_mask, sdf_mask, *_band_weights(num_fs, num_sdf))


def sdf_loss_stats(z_vals: torch.Tensor, target_d: torch.Tensor,
                   predicted_sdf: torch.Tensor, truncation: float,
                   ray_mask: torch.Tensor, loss_type: str = "l2") -> dict:
    """get_sdf_loss's terms as sums and counts that add across ray
    shards: ``fs_sum`` and ``sdf_sum`` over ``z_n`` samples, and the band
    counts ``num_fs`` and ``num_sdf`` that weight them
    (:func:`sdf_losses`)."""
    front_mask, sdf_mask, num_fs, num_sdf = sdf_mask_counts(
        z_vals, target_d, truncation, ray_mask)
    denom = ray_mask.reshape(-1, 1).to(z_vals.dtype)
    fs_sum, z_n = masked_sum(_residual(predicted_sdf * front_mask,
                                       front_mask, loss_type), denom)
    sdf_sum, _ = masked_sum(_residual(
        (z_vals + predicted_sdf * truncation) * sdf_mask,
        target_d * sdf_mask, loss_type), denom)
    return {"fs_sum": fs_sum, "sdf_sum": sdf_sum, "z_n": z_n,
            "num_fs": num_fs, "num_sdf": num_sdf}


def sdf_losses(stats: dict):
    """(fs_loss, sdf_loss) from :func:`sdf_loss_stats`' sums and counts."""
    fs_weight, sdf_weight = _band_weights(stats["num_fs"], stats["num_sdf"])
    z_n = stats["z_n"].clamp_min(1.0)
    return (stats["fs_sum"] / z_n * fs_weight,
            stats["sdf_sum"] / z_n * sdf_weight)


def get_sdf_loss(z_vals: torch.Tensor, target_d: torch.Tensor,
                 predicted_sdf: torch.Tensor, truncation: float,
                 loss_type: str = "l2", ray_mask=None):
    """Free-space and truncation-region SDF losses, averaged over the full
    sample grid of the (unmasked) rays: :func:`sdf_losses` of one shard."""
    if ray_mask is None:
        ray_mask = z_vals.new_ones(z_vals.shape[0])
    return sdf_losses(sdf_loss_stats(z_vals, target_d, predicted_sdf,
                                     truncation, ray_mask, loss_type))


def smoothness_tv(embedded: torch.Tensor, sample_points: int) -> torch.Tensor:
    """Total variation of grid features [g, g, g, C], / sample_points^3."""
    tv_x = ((embedded[1:] - embedded[:-1]) ** 2).sum()
    tv_y = ((embedded[:, 1:] - embedded[:, :-1]) ** 2).sum()
    tv_z = ((embedded[:, :, 1:] - embedded[:, :, :-1]) ** 2).sum()
    return (tv_x + tv_y + tv_z) / (sample_points ** 3)


def total_loss(ret: dict, weights: dict, rgb=True, sdf=True, depth=True,
               fs=True, smooth_loss=None, smooth_weight: float = 0.0):
    """Weighted sum of the per-term losses."""
    loss = 0.0
    if rgb:
        loss += weights["rgb_weight"] * ret["rgb_loss"]
    if depth:
        loss += weights["depth_weight"] * ret["depth_loss"]
    if sdf:
        loss += weights["sdf_weight"] * ret["sdf_loss"]
    if fs:
        loss += weights["fs_weight"] * ret["fs_loss"]
    if smooth_loss is not None and smooth_weight > 0:
        loss += smooth_weight * smooth_loss
    return loss
