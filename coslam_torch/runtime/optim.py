"""Optimizers: torch.optim.Adam with the reference's parameter groups.

Counterpart of coslam_tpu/runtime/optim.py. torch's Adam applies
``weight_decay`` as coupled L2 (added to the gradient before the
moments), which is what the JAX package builds with
``optax.add_decayed_weights`` before ``scale_by_adam``.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def grid_leaves(grid) -> List[torch.Tensor]:
    """The grid's tensors: the hash table, or a dict grid's values
    (TensoVM's lines and planes) in sorted-key order, the order of JAX's
    tree leaves."""
    if isinstance(grid, dict):
        return [grid[k] for k in sorted(grid)]
    return [grid]


def map_param_list(params: Dict) -> List[torch.Tensor]:
    return [*grid_leaves(params["grid"]), *params["decoder"]["sdf_net"],
            *params["decoder"]["color_net"]]


def detached(params: Dict) -> Dict:
    """The same tensors without autograd (a frozen map for tracking: the
    encode backward then computes dx only)."""
    grid = params["grid"]
    return {"grid": ({k: v.detach() for k, v in grid.items()}
                     if isinstance(grid, dict) else grid.detach()),
            "decoder": {k: [w.detach() for w in v]
                        for k, v in params["decoder"].items()}}


def make_map_optimizer(config: Dict, params: Dict) -> torch.optim.Adam:
    """Grid (every grid tensor, TensoVM's planes and lines alike, at
    lr_embed): betas (0.9, 0.99), eps 1e-15; decoder: betas (0.9, 0.99),
    eps 1e-8, weight_decay 1e-6. The grid's eps matters: with the default
    1e-8 the first steps on near-zero table rows differ. Marks the
    parameters trainable."""
    m = config["mapping"]
    for p in map_param_list(params):
        p.requires_grad_(True)
    dec = [*params["decoder"]["sdf_net"], *params["decoder"]["color_net"]]
    return torch.optim.Adam([
        {"params": grid_leaves(params["grid"]), "lr": m["lr_embed"],
         "eps": 1e-15},
        {"params": dec, "lr": m["lr_decoder"], "eps": 1e-8,
         "weight_decay": 1e-6},
    ], betas=(0.9, 0.99))


def make_pose_optimizer(rot: torch.Tensor, trans: torch.Tensor,
                        lr_rot: float, lr_trans: float) -> torch.optim.Adam:
    """Adam over the pose tangents: betas (0.9, 0.999), eps 1e-8."""
    return torch.optim.Adam([{"params": [rot], "lr": lr_rot},
                             {"params": [trans], "lr": lr_trans}],
                            betas=(0.9, 0.999), eps=1e-8)
