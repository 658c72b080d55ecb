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
    (TensoVM's lines and planes, TriPlaneHybrid's dense and planes) in
    sorted-key order, the order of JAX's tree leaves."""
    if isinstance(grid, dict):
        return [grid[k] for k in sorted(grid)]
    return [grid]


def decoder_leaves(dec: Dict) -> List[torch.Tensor]:
    """The decoder's tensors in the order of JAX's tree leaves (sorted
    keys): each MLP's weight list (``color_net``, ``sdf_net``) and each
    linear head's ``b`` then ``w`` (ActiveCoSLAM's ``feature_linear``,
    ``sdf_linear`` and ``uncertainty_linear``)."""
    out = []
    for k in sorted(dec):
        v = dec[k]
        out += [v[j] for j in sorted(v)] if isinstance(v, dict) else list(v)
    return out


def _decoder_list(dec: Dict) -> List[torch.Tensor]:
    """The decoder's tensors: sdf_net's, color_net's, then the linear
    heads' (ActiveCoSLAM's decoder) in decoder_leaves' order."""
    heads = [v[j] for k, v in sorted(dec.items()) if isinstance(v, dict)
             for j in sorted(v)]
    return [*dec["sdf_net"], *dec["color_net"], *heads]


def map_param_list(params: Dict) -> List[torch.Tensor]:
    """The grid's tensors, the decoder's (_decoder_list), then the color
    grid's (``oneGrid: false``)."""
    return [*grid_leaves(params["grid"]), *_decoder_list(params["decoder"]),
            *grid_leaves(params.get("grid_color", {}))]


def detach_grid(grid):
    """A grid (a table or a dict of tables) without autograd."""
    if isinstance(grid, dict):
        return {k: v.detach() for k, v in grid.items()}
    return grid.detach()


def detached(params: Dict) -> Dict:
    """The same tensors without autograd (a frozen map for tracking: the
    encode backward then computes dx only)."""
    out = {"grid": detach_grid(params["grid"]),
           "decoder": {k: ({j: w.detach() for j, w in v.items()}
                           if isinstance(v, dict) else [w.detach() for w in v])
                       for k, v in params["decoder"].items()}}
    if "grid_color" in params:
        out["grid_color"] = detach_grid(params["grid_color"])
    return out


def make_map_optimizer(config: Dict, params: Dict) -> torch.optim.Adam:
    """Grid (every grid tensor, TensoVM's planes and lines alike, at
    lr_embed): betas (0.9, 0.99), eps 1e-15; decoder: betas (0.9, 0.99),
    eps 1e-8, weight_decay 1e-6 (every decoder tensor, the heads of
    ActiveCoSLAM's decoder too); the color grid (``oneGrid: false``) as
    the grid at mapping.lr_embed_color (default lr_embed). The grid's eps
    matters: with the default 1e-8 the first steps on near-zero table rows
    differ. Marks the parameters trainable."""
    m = config["mapping"]
    for p in map_param_list(params):
        p.requires_grad_(True)
    dec = _decoder_list(params["decoder"])
    groups = [
        {"params": grid_leaves(params["grid"]), "lr": m["lr_embed"],
         "eps": 1e-15},
        {"params": dec, "lr": m["lr_decoder"], "eps": 1e-8,
         "weight_decay": 1e-6},
    ]
    if "grid_color" in params:
        groups.append({"params": grid_leaves(params["grid_color"]),
                       "lr": m.get("lr_embed_color", m["lr_embed"]),
                       "eps": 1e-15})
    return torch.optim.Adam(groups, betas=(0.9, 0.99))


def make_cur_map_optimizer(config: Dict, params: Dict) -> torch.optim.Adam:
    """The current-frame step's own optimizer (mapping.cur_frame_iters >
    0; coslam_tpu/runtime/slam.py builds it as _adam_l2(lr_embed, 0.9,
    0.99, 1e-15)): Adam over the grid's tensors only, betas (0.9, 0.99),
    eps 1e-15, no weight decay. Its moments persist across frames; like
    the JAX package, the checkpoint does not carry them."""
    return torch.optim.Adam(grid_leaves(params["grid"]),
                            lr=config["mapping"]["lr_embed"],
                            betas=(0.9, 0.99), eps=1e-15)


def make_pose_optimizer(rot: torch.Tensor, trans: torch.Tensor,
                        lr_rot: float, lr_trans: float,
                        align: torch.Tensor = None,
                        lr_align: float = None) -> torch.optim.Adam:
    """Adam over the pose tangents: betas (0.9, 0.999), eps 1e-8; with
    ``align`` (training.frame_align: the exposure parameters,
    ops/frame_align.py), an ``align`` group at lr_align with the same
    betas and eps."""
    groups = [{"params": [rot], "lr": lr_rot},
              {"params": [trans], "lr": lr_trans}]
    if align is not None:
        groups.append({"params": [align], "lr": lr_align})
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
