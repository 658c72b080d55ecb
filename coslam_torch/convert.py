"""Parameters between the JAX package and the port.

The JAX parameter dict ``{"grid": ..., "decoder": {"sdf_net": [w...],
"color_net": [w...]}}`` (coslam_tpu/models/scene_rep.py:init_params),
whose grid is one table [T, F] or a dict of tables (TensoVM's
``{"planes", "lines"}``), becomes the port's dict of tensors with the
same structure and layouts (weights stay [in, out]), and back. Both
directions go through numpy, so neither side needs the other framework.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _map_grid(fn, grid):
    """fn over the grid's tables, keeping a dict grid's keys."""
    if isinstance(grid, dict):
        return {k: fn(v) for k, v in grid.items()}
    return fn(grid)


def check_grid(grid, spec) -> None:
    """Raise unless a hash table [T, F] has its spec's shape. The packed
    and XOR layouts of one configuration differ in rows (room0: 835,977
    packed, 834,097 XOR), so a table is never taken for the other's.
    Dict grids (TensoVM) are not checked here."""
    if isinstance(grid, dict):
        return
    want = (spec.total_entries, spec.n_features)
    if tuple(grid.shape) != want:
        raise ValueError(f"grid table {tuple(grid.shape)} does not match "
                         f"the {type(spec).__name__} {want}")


def params_from_numpy(params: Dict, device="cpu", spec=None) -> Dict:
    """JAX params as numpy arrays (np.asarray of each leaf) -> tensors;
    with ``spec`` (the model's grid_spec) the grid table's shape is
    checked against it first."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    if spec is not None:
        check_grid(params["grid"], spec)
    return {"grid": _map_grid(t, params["grid"]),
            "decoder": {k: [t(w) for w in params["decoder"][k]]
                        for k in ("sdf_net", "color_net")}}


def params_to_numpy(params: Dict) -> Dict:
    """The port's params -> numpy arrays in the JAX dict layout."""
    def a(x):
        return x.detach().cpu().numpy()

    return {"grid": _map_grid(a, params["grid"]),
            "decoder": {k: [a(w) for w in params["decoder"][k]]
                        for k in ("sdf_net", "color_net")}}
