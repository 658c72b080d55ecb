"""SDF volume-rendering primitives in PyTorch.

Counterpart of coslam_tpu/ops/render.py (``sdf2weights``, ``raw2outputs``,
``stratified_z_vals`` and ``sample_pdf``). The stratified perturbation
draw ``t`` and the importance draw ``u`` are arguments, so the caller
owns the random stream.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


_LINSPACE: Dict[Tuple, torch.Tensor] = {}


def linspace(start: float, stop: float, num: int,
             device=None) -> torch.Tensor:
    """num evenly spaced f32 values from start to stop, with the bits of
    the JAX package's ``jnp.linspace`` of constants under jit: XLA turns
    the division by (num - 1) into a product with its f32 reciprocal r and
    folds stop's term into i * (stop * r), so value i < num - 1 is
    start * (1 - i r) + i (stop r), and the last is stop. torch.linspace
    rounds some values differently, and a depth-guided sample that sits
    on the SDF loss's truncation boundary (TUM's trunc is two of its
    sample spacings) then falls on the other side of it. The values are
    made once in f32 numpy and uploaded once per (start, stop, num,
    device); callers must not write into the tensor returned."""
    device = torch.device("cpu" if device is None else device)
    key = (float(start), float(stop), int(num), device)
    vals = _LINSPACE.get(key)
    if vals is None:
        f32 = np.float32
        if num == 1:
            host = np.array([start], f32)
        else:
            i = np.arange(num - 1, dtype=f32)
            r = f32(1.0) / f32(num - 1)
            host = np.append(f32(start) * (f32(1.0) - i * r)
                             + i * (f32(stop) * r), f32(stop)).astype(f32)
        # Uploaded from pageable host memory: done when .to() returns, so
        # a thread on another CUDA stream may read it (the pipelined
        # runtime's tracker and mapper); no lock.
        vals = _LINSPACE[key] = torch.from_numpy(host).to(device)
    return vals


def sdf2weights(sdf: torch.Tensor, z_vals: torch.Tensor, truncation: float,
                sc_factor: float = 1.0) -> torch.Tensor:
    """Sigmoid-bell weights masked past the FIRST sign change of the SDF
    (+ sc_factor * truncation) and normalized per ray. sdf, z_vals
    [N_rays, N_samples]."""
    weights = torch.sigmoid(sdf / truncation) * torch.sigmoid(-sdf / truncation)
    crossing = ((sdf[:, 1:] * sdf[:, :-1]) < 0.0).to(z_vals.dtype)
    # argmax returns the first maximal element: the first crossing, or
    # index 0 when there is none (as in the reference).
    inds = crossing.argmax(dim=1)
    z_min = torch.gather(z_vals, 1, inds[:, None])
    mask = (z_vals < z_min + sc_factor * truncation).to(z_vals.dtype)
    weights = weights * mask
    return weights / (weights.sum(-1, keepdim=True) + 1e-8)


def raw2outputs(raw: torch.Tensor, z_vals: torch.Tensor, truncation: float,
                sc_factor: float = 1.0, white_bkgd: bool = False):
    """raw [N, S, 4] (rgb logits + sdf) -> (rgb [N, 3], disp [N], acc [N],
    weights [N, S], depth [N], depth_var [N])."""
    rgb = torch.sigmoid(raw[..., :3])
    weights = sdf2weights(raw[..., 3], z_vals, truncation, sc_factor)
    rgb_map = (weights[..., None] * rgb).sum(-2)
    depth_map = (weights * z_vals).sum(-1)
    depth_var = (weights * (z_vals - depth_map[..., None]) ** 2).sum(-1)
    acc_map = weights.sum(-1)
    disp_map = 1.0 / torch.clamp(depth_map / acc_map, min=1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return rgb_map, disp_map, acc_map, weights, depth_map, depth_var


def stratified_z_vals(n_rays: int, target_d: Optional[torch.Tensor],
                      near: float, far: float, range_d: float, n_range_d: int,
                      n_samples_d: int, t: Optional[torch.Tensor] = None,
                      device=None) -> torch.Tensor:
    """Uniform near..far samples plus depth-guided samples around
    target_d [N, 1] (rays with depth <= 0 fall back to near..far), sorted.
    ``t`` [N, n_total] in [0, 1) perturbs each sample inside its stratum;
    None keeps the strata's ends."""
    device = target_d.device if target_d is not None else device
    lin = lambda a, b, n: linspace(a, b, n, device)  # noqa: E731
    if target_d is not None:
        z_samples = lin(-range_d, range_d, n_range_d)[None, :] + target_d
        invalid = (target_d[:, 0] <= 0.0)[:, None]
        z_samples = torch.where(invalid, lin(near, far, n_range_d)[None, :],
                                z_samples)
        if n_samples_d > 0:
            z_uniform = lin(near, far, n_samples_d)[None, :].expand(
                n_rays, n_samples_d)
            z_vals = torch.cat([z_uniform, z_samples], -1).sort(-1).values
        else:
            z_vals = z_samples
    else:
        z_vals = lin(near, far, n_samples_d)[None, :].expand(n_rays,
                                                             n_samples_d)
    if t is not None:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], -1)
        lower = torch.cat([z_vals[..., :1], mids], -1)
        z_vals = lower + (upper - lower) * t
    return z_vals


def importance_u(n_rays: int, n_importance: int, device=None
                 ) -> torch.Tensor:
    """The deterministic importance draw (``training.perturb`` 0): the
    n_importance stratum centres of [0, 1], the same for every ray."""
    u = linspace(0.5 / n_importance, 1.0 - 0.5 / n_importance,
                 n_importance, device)
    return u.expand(n_rays, n_importance)


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Hierarchical importance sampling by CDF inversion: bins [Bs, M + 1]
    (the z midpoints), weights [Bs, M] (the interior rendering weights),
    u [Bs, n_importance] uniform draws in [0, 1) (or importance_u) ->
    samples [Bs, n_importance]."""
    weights = weights + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]), pdf.cumsum(-1)], -1)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = (inds - 1).clamp(min=0)
    above = inds.clamp(max=cdf.shape[-1] - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)
