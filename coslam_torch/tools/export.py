"""Model export: the scene network as a serialized ``torch.export``
program.

Counterpart of coslam_tpu/tools/export.py (which serializes the query
path as StableHLO through jax.export; the reference's decoder ONNX smoke
test, model/decoder.py:182-226, plays that part for the torch stack):
the full query path (parametric encoding, coordinate encoding and
decoders), ``forward(x [batch, 3]) = JointEncoding.query_color_sdf``,
goes through ``torch.export.export`` at a fixed batch and
``torch.export.save`` writes a ``.pt2``, which ``roundtrip_check`` loads
back (``torch.export.load(...).module()``) and runs.

- ``--device cuda`` (the default) exports the kernel route: the hash
  grid's encode is kernel A, which runs through ctypes and which
  torch.export cannot trace, so the program names the operator
  ``torch.ops.coslam_torch.grid_encode_fwd`` (ops/hash_packed.py). Loading
  such a program needs ``import coslam_torch`` first, which registers
  the operator; only the hash grid has one (another grid raises here).
- ``--device cpu`` exports the plain route: the encode's plain PyTorch
  ops, a program that needs nothing of this package (the part the JAX
  tool's ``--platform cpu`` plays).

CLI:
    python -m coslam_torch.tools.export --config configs/Tum/tum.yaml \
        [--ckpt out/checkpoint.npz] [--out model.pt2] [--batch 4096]

Without --ckpt, parameters drawn from seed 0 are exported (the
reference's smoke test also runs on random weights).
"""

from __future__ import annotations

import argparse
import os

import torch

from ..parallel.sharding import _flatten


class QueryModule(torch.nn.Module):
    """``forward(x [N, 3]) -> [N, 4]``: the model's query_color_sdf with
    the parameters held as buffers (constants of the program)."""

    def __init__(self, model, params):
        super().__init__()
        leaves: list = []
        self._rebuild = _flatten(params, leaves)
        self._model = model
        self._n = len(leaves)
        for i, p in enumerate(leaves):
            self.register_buffer(f"p{i}", p.detach().contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = self._rebuild([getattr(self, f"p{i}")
                                for i in range(self._n)])
        return self._model.query_color_sdf(params, x)


def export_query_fn(model, params, batch: int = 4096, device="cuda"):
    """The exported program of query_color_sdf(params, x [batch, 3]) on
    ``device``."""
    from ..ops import hash_packed as HP

    device = torch.device(device)
    if device.type == "cuda" and not isinstance(model.grid_spec,
                                                HP.PackedGridSpec):
        raise ValueError("--device cuda exports the hash grid's kernel "
                         "operator only; export this grid with --device cpu")
    module = QueryModule(model, params).to(device).eval()
    x = torch.zeros((batch, 3), device=device)
    with torch.no_grad():
        return torch.export.export(module, (x,), strict=False)


def roundtrip_check(path: str, batch: int = 4096, device="cuda"):
    """Load the saved program and run it on a fixed grid of points;
    returns its output [batch, 4]."""
    program = torch.export.load(path).module()
    x = torch.linspace(0.1, 0.9, batch * 3, device=device).reshape(batch, 3)
    with torch.no_grad():
        return program(x)


def main(argv=None):
    p = argparse.ArgumentParser(description="export scene network")
    p.add_argument("--config", required=True)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--out", default="model.pt2")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--device", default="cuda",
                   help="cuda: the kernel route (needs import coslam_torch "
                        "to load); cpu: the plain route, a portable "
                        "program")
    args = p.parse_args(argv)

    from ..config import load_config
    from .render_view import load_params, make_model

    cfg = load_config(args.config)
    model = make_model(cfg, args.device)
    if args.ckpt:
        params, _ = load_params(model, args.ckpt, args.device)
    else:
        params = model.init_params(torch.Generator().manual_seed(0))
    program = export_query_fn(model, params, args.batch, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.export.save(program, args.out)
    out = roundtrip_check(args.out, args.batch, args.device)
    print(f"exported {os.path.getsize(args.out) / 1e6:.2f} MB to "
          f"{args.out}; roundtrip output {tuple(out.shape)} "
          f"finite={bool(torch.isfinite(out).all())}")
    return out


if __name__ == "__main__":
    main()
