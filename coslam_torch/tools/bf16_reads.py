"""quality_bench with the grid tables read in bf16, as on the TPU.

On a TPU the JAX package's encoders read the grid's tables as bf16 (the
packed hash grid's gather, TensoVM's planes and lines:
coslam_tpu/ops/encodings.py:_grid_apply_fn, coslam_tpu/ops/tensovm.py)
while its parameters and their gradients stay f32; the port reads f32.
This runs coslam_torch.tools.quality_bench with every encode's table
values rounded to bf16 (nearest even) on the way in: the forward and dx
see the rounded values, and the table gradient reaches the f32 table
unchanged. With ``--matmuls``, the decoder's matrix products also take
bf16-rounded inputs with f32 sums: what the TPU's default precision does
to the JAX package's f32 products, for which it sets no ``precision``.
It tells these differences apart from the rest when the port's quality
rows are compared with the JAX package's; no other TPU arithmetic is
imitated.

Run: python -m coslam_torch.tools.bf16_reads [--matmuls]
     <quality_bench arguments>
"""

from __future__ import annotations

import json
import sys

import torch


def bf16_read(t: torch.Tensor) -> torch.Tensor:
    """t with bf16-rounded values and the identity as its gradient."""
    return t + (t.to(torch.bfloat16).float() - t).detach()


def mlp_apply_bf16(ws, x: torch.Tensor) -> torch.Tensor:
    """models/decoder.py:mlp_apply with bf16-rounded matmul inputs."""
    for w in ws[:-1]:
        x = torch.relu(bf16_read(x) @ bf16_read(w))
    return bf16_read(x) @ bf16_read(ws[-1])


def main(argv=None):
    from ..models import decoder as D
    from ..ops import hash_packed as HP
    from ..ops import tensovm as VM
    from . import quality_bench

    argv = list(sys.argv[1:] if argv is None else argv)
    matmuls = "--matmuls" in argv
    if matmuls:
        argv.remove("--matmuls")
    hp, vm, mlp = HP.encode, VM.encode, D.mlp_apply
    HP.encode = lambda spec, table, x: hp(spec, bf16_read(table), x)
    VM.encode = lambda spec, p, x: vm(
        spec, {k: bf16_read(v) for k, v in p.items()}, x)
    if matmuls:
        # Every product rounded, whatever decoder.dtype asks for.
        D.mlp_apply = lambda ws, x, bf16=False: mlp_apply_bf16(ws, x)
    try:
        res = quality_bench.main(argv)
    finally:
        HP.encode, VM.encode, D.mlp_apply = hp, vm, mlp
    res["table_reads"] = "bf16"
    if matmuls:
        res["matmul_inputs"] = "bf16"
    out = quality_bench._parser().parse_args(argv).out
    if out:
        with open(out, "w") as f:
            json.dump(res, f, indent=2)
    return res


if __name__ == "__main__":
    main()
