"""Ray data parallelism over several devices, in one process.

Counterpart of coslam_tpu/parallel/sharding.py. The ray batch of every
hot loop (tracking, point-cloud tracking, first-frame mapping, the
current-frame step, BA) is embarrassingly parallel, so ``parallel.dp =
N`` splits it into N contiguous blocks, one a device, in the order of
JAX's ``P('dp')`` (:func:`split_rays`). The parameters live on the first
device, the master; each shard reads a differentiable copy of them
(:func:`replicate`, the in-process pattern of ``nn.DataParallel``'s
replicate, with no second process and no ``torch.distributed``), whose
backward sums the shards' gradients onto the master in device order, and
the optimizers step once, on the master.

The step computes the gradient of the same full-batch loss as with one
device. Every random draw is made once, on the master, for the full
batch, then split. The loss terms are means over the whole batch (and
the free-space and SDF terms weighted by counts over the whole batch):
each shard returns its sums and counts (the model's ``loss_stats``),
which add on the master before any division
(:func:`sharded_forward`), so a per-shard mean never enters. The
smoothness term is computed once, on the master, by the caller.

A dp=N step is not bit-equal to the one-device step (its sums add in
another order); under ``torch.use_deterministic_algorithms(True)`` two
runs at the same N agree bit for bit.
"""

from __future__ import annotations

import contextlib
from functools import reduce
from typing import Dict, List, Optional, Sequence

import torch


def make_devices(n: int, device="cuda") -> List[torch.device]:
    """The devices of ``parallel.dp = n``: ``device`` itself for n <= 1;
    else the first n CUDA devices (cuda:0 ... cuda:n-1), or n times the
    CPU for ``device="cpu"`` (the tests' route). Raises ValueError when
    fewer CUDA devices are visible."""
    device = torch.device(device)
    if n <= 1:
        return [device]
    if device.type == "cpu":
        return [device] * n
    visible = torch.cuda.device_count()
    if n > visible:
        raise ValueError(f"parallel.dp={n} but only {visible} devices "
                         "visible")
    return [torch.device("cuda", i) for i in range(n)]


def check_divisible(config: Dict, dp: int) -> None:
    """Raise ValueError unless tracking.sample and mapping.sample divide
    by dp (the JAX package's rule: its ray blocks split evenly)."""
    for section in ("tracking", "mapping"):
        name, size = f"{section}.sample", int(config[section]["sample"])
        if size % dp:
            raise ValueError(
                f"{name}={size} not divisible by parallel.dp={dp}")


def on_device(device: torch.device):
    """The context that makes ``device`` the current CUDA device (the
    kernels launch on the current device's context); nothing on the
    CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def split_rays(x: Optional[torch.Tensor],
               devices: Sequence[torch.device]) -> list:
    """Dim 0 of x in len(devices) contiguous blocks (torch.tensor_split:
    the first n % k blocks one row longer), block k moved to devices[k];
    None gives a None a device."""
    if x is None:
        return [None] * len(devices)
    return [b.to(d) for b, d in zip(torch.tensor_split(x, len(devices)),
                                    devices)]


class _Replicate(torch.autograd.Function):
    """tensors -> one copy of each on every device (the tensor itself, as
    a view, where it already lies there). The backward sums each tensor's
    copies' gradients on its own device, in device order, so the sum
    order does not follow the autograd engine's thread schedule."""

    @staticmethod
    def forward(ctx, devices, *tensors):
        ctx.set_materialize_grads(False)
        ctx.homes = [t.device for t in tensors]
        return tuple(t.view_as(t) if t.device == d else t.to(d)
                     for d in devices for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        n = len(ctx.homes)
        out = []
        for j, home in enumerate(ctx.homes):
            parts = [g.to(home) for g in grads[j::n] if g is not None]
            out.append(reduce(torch.add, parts) if parts else None)
        return (None, *out)


def _flatten(tree, leaves: list):
    """The tensors of a tree of dicts and lists, in order, and a function
    that rebuilds the tree from a list of that length."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        i = len(leaves) - 1
        return lambda new: new[i]
    if isinstance(tree, dict):
        parts = {k: _flatten(v, leaves) for k, v in tree.items()}
        return lambda new: {k: f(new) for k, f in parts.items()}
    parts = [_flatten(v, leaves) for v in tree]
    return lambda new: [f(new) for f in parts]


def replicate(params, devices: Sequence[torch.device]) -> list:
    """One copy of the parameter tree a device. The tensors that ask for
    a gradient are copied through :class:`_Replicate` (their gradients
    come back summed onto the master); the others are plain copies (a
    frozen map: tracking copies it once a step)."""
    leaves: list = []
    rebuild = _flatten(params, leaves)
    grad = ([i for i, p in enumerate(leaves) if p.requires_grad]
            if torch.is_grad_enabled() else [])
    copies = [[None if i in grad else p.detach().to(d)
               for i, p in enumerate(leaves)] for d in devices]
    if grad:
        outs = _Replicate.apply(list(devices), *[leaves[i] for i in grad])
        for k in range(len(devices)):
            for j, i in enumerate(grad):
                copies[k][i] = outs[k * len(grad) + j]
    return [rebuild(c) for c in copies]


def sharded_forward(model, replicas: list, devices: Sequence[torch.device],
                    rays_o: torch.Tensor, rays_d: torch.Tensor,
                    target_rgb: torch.Tensor, target_d: torch.Tensor, *,
                    t: Optional[torch.Tensor] = None,
                    u: Optional[torch.Tensor] = None,
                    align: Optional[torch.Tensor] = None,
                    rgb_kernel: Optional[float] = None) -> Dict:
    """``model.forward`` of the whole batch, the rays split over the
    devices: each shard renders its block with its replica of the
    parameters and returns its loss sums and counts, which are added on
    the master (the inputs' device) before ``model.losses_from_stats``
    divides. ``align``: one exposure [4] (copied to every shard) or one a
    ray [N, 4] (split). Returns the losses and the rendered maps (in ray
    order, on the master)."""
    master = rays_o.device
    blocks = [split_rays(x, devices)
              for x in (rays_o, rays_d, target_rgb, target_d, t, u)]
    if align is not None and align.dim() == 1:
        aligns = [r[0] for r in replicate([align], devices)]
    else:
        aligns = split_rays(align, devices)
    maps, stats = [], []
    for k, dev in enumerate(devices):
        with on_device(dev):
            m, s = model.loss_stats(
                replicas[k], *(b[k] for b in blocks[:4]), t=blocks[4][k],
                u=blocks[5][k], rgb_kernel=rgb_kernel, align=aligns[k])
        maps.append(m)
        stats.append(s)
    total = add_stats(stats, master)
    ret = {key: torch.cat([m[key].to(master) for m in maps])
           for key in maps[0]}
    ret.update(model.losses_from_stats(total))
    return ret


def add_stats(stats: list, device: torch.device) -> Dict:
    """Per-shard dicts of sums and counts added on ``device``, key by
    key, in shard order."""
    return {key: reduce(torch.add, [s[key].to(device) for s in stats])
            for key in stats[0]}


def shard_devices(devices) -> Optional[List[torch.device]]:
    """The devices to shard over: the list when it holds two or more, else
    None (the one-device path)."""
    if devices is None or len(devices) < 2:
        return None
    return list(devices)


def dp_forward(model, params, devices, rays_o: torch.Tensor,
               rays_d: torch.Tensor, target_rgb: torch.Tensor,
               target_d: torch.Tensor, replicas: Optional[list] = None,
               **kwargs) -> Dict:
    """``model.forward`` on one device (``devices`` None), else
    :func:`sharded_forward` over ``devices`` with ``replicas`` (made here
    from ``params`` when not given)."""
    if devices is None:
        return model.forward(params, rays_o, rays_d, target_rgb, target_d,
                             **kwargs)
    if replicas is None:
        replicas = replicate(params, devices)
    return sharded_forward(model, replicas, devices, rays_o, rays_d,
                           target_rgb, target_d, **kwargs)

