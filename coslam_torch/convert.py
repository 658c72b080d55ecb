"""Parameters between the JAX package and the port.

The JAX parameter dict ``{"grid": ..., "decoder": {"sdf_net": [w...],
"color_net": [w...]}}`` (coslam_tpu/models/scene_rep.py:init_params), and
``"grid_color"`` beside them under ``oneGrid: false``, whose grids are one
table [T, F] or a dict of tables (TensoVM's ``{"planes", "lines"}``,
TriPlaneHybrid's ``{"dense", "planes"}``), becomes the port's dict of
tensors with the same structure and layouts (weights stay [in, out]), and
back; ActiveCoSLAM's decoder (coslam_tpu/active/decoder.py) adds the
linear heads ``feature_linear``, ``sdf_linear`` and
``uncertainty_linear``, each ``{"w": [in, out], "b": [out]}``. Both
directions go through numpy, so neither side needs the other framework.
The map optimizer's state crosses too: optax's Adam state as a flat
leaf list (a checkpoint's ``opt_state``) to ``torch.optim.Adam``'s
per-parameter state, and back.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .runtime.optim import decoder_leaves, grid_leaves


# The grids of a parameter dict: the SDF grid and, under oneGrid: false,
# the color grid.
GRID_KEYS = ("grid", "grid_color")


def _map_grid(fn, grid):
    """fn over the grid's tables, keeping a dict grid's keys."""
    if isinstance(grid, dict):
        return {k: fn(v) for k, v in grid.items()}
    return fn(grid)


def check_grid(grid, spec) -> None:
    """Raise unless a hash table [T, F] has its spec's shape. The packed
    and XOR layouts of one configuration differ in rows (room0: 835,977
    packed, 834,097 XOR), so a table is never taken for the other's.
    Dict grids (TensoVM, TriPlaneHybrid) are not checked here."""
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
    out = {k: _map_grid(t, params[k]) for k in GRID_KEYS if k in params}
    out["decoder"] = _map_decoder(t, params["decoder"])
    return out


def params_to_numpy(params: Dict) -> Dict:
    """The port's params -> numpy arrays in the JAX dict layout."""
    def a(x):
        return x.detach().cpu().numpy()

    out = {k: _map_grid(a, params[k]) for k in GRID_KEYS if k in params}
    out["decoder"] = _map_decoder(a, params["decoder"])
    return out


# The linear heads of ActiveCoSLAM's decoder (ColorSDFNetV3).
HEAD_KEYS = ("feature_linear", "sdf_linear", "uncertainty_linear")


def _map_decoder(fn, dec: Dict) -> Dict:
    """fn over the decoder's MLP weights and, where there are any, its
    linear heads' ``w`` and ``b``."""
    out = {k: [fn(w) for w in dec[k]] for k in ("sdf_net", "color_net")}
    out.update({k: {"w": fn(dec[k]["w"]), "b": fn(dec[k]["b"])}
                for k in HEAD_KEYS if k in dec})
    return out


# ---------------------------------------------------------------------------
# Map optimizer state: optax's multi_transform Adam <-> torch.optim.Adam
# ---------------------------------------------------------------------------

# The JAX map optimizer (coslam_tpu/runtime/optim.py:make_map_optimizer)
# is optax.multi_transform over the labels "decoder", "grid" and, under
# oneGrid: false, "grid_color" (the top-level keys); its state flattens
# label by label in sorted order, each as the Adam count, then mu over the
# label's leaves, then nu over them (the weight-decay and scale transforms
# hold no arrays). The leaves of a label come in the sorted-key flatten
# order of the parameters: color_net before sdf_net, a dict grid's tables
# in sorted-key order. tests/test_torch_integration.py holds this order to
# jax.tree_util.tree_flatten of a live optax state.
MAP_OPT_LABELS = ("decoder", "grid", "grid_color")


def map_opt_labels(params: Dict) -> List[str]:
    """The labels of ``params``, in sorted order: the color grid's only
    when the parameters hold one."""
    return [label for label in MAP_OPT_LABELS
            if label == "decoder" or label in params]


def label_leaves(params: Dict, label: str) -> List:
    """The tensors of one optax label, in JAX's flatten order."""
    if label == "decoder":
        return decoder_leaves(params["decoder"])
    return grid_leaves(params[label])


def adam_state_to_jax(opt: torch.optim.Optimizer, params: Dict) -> List:
    """The state of ``opt`` (the port's map optimizer over ``params``) as
    the flat leaf list of the JAX map optimizer's state: per label, an
    int32 count (torch's ``step``, which counts the same updates and
    enters the bias correction the same way), then ``exp_avg`` (mu) and
    ``exp_avg_sq`` (nu) of its tensors. Tensors stay on their device;
    a tensor without state (no step taken yet) gives count 0 and zeros."""
    out = []
    for label in map_opt_labels(params):
        ps = label_leaves(params, label)
        st = [opt.state.get(p, {}) for p in ps]
        out.append(np.int32(int(st[0]["step"]) if st[0] else 0))
        for key in ("exp_avg", "exp_avg_sq"):
            out += [s[key] if s else torch.zeros_like(p)
                    for p, s in zip(ps, st)]
    return out


def adam_state_from_jax(opt: torch.optim.Optimizer, params: Dict,
                        leaves: List) -> None:
    """Set the state of ``opt`` (the port's map optimizer over ``params``)
    from the JAX map optimizer's state leaves (``adam_state_to_jax``'s
    layout, as a checkpoint stores them)."""
    i = 0
    for label in map_opt_labels(params):
        ps = label_leaves(params, label)
        count = int(np.asarray(leaves[i]))
        mu = leaves[i + 1:i + 1 + len(ps)]
        nu = leaves[i + 1 + len(ps):i + 1 + 2 * len(ps)]
        i += 1 + 2 * len(ps)
        for p, m, v in zip(ps, mu, nu):
            group = next(g for g in opt.param_groups
                         if any(q is p for q in g["params"]))
            on_device = group.get("capturable") or group.get("fused")
            opt.state[p] = {
                "step": torch.tensor(float(count), dtype=torch.float32,
                                     device=p.device if on_device else "cpu"),
                "exp_avg": _tensor_like(m, p),
                "exp_avg_sq": _tensor_like(v, p)}
    if i != len(leaves):
        raise ValueError(f"optimizer state has {len(leaves)} leaves, the "
                         f"model's layout {i}")


def _tensor_like(a, p: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                        else a)
    if tuple(t.shape) != tuple(p.shape):
        raise ValueError(f"optimizer state {tuple(t.shape)} does not match "
                         f"its parameter {tuple(p.shape)}")
    return t.to(device=p.device, dtype=p.dtype).clone()
