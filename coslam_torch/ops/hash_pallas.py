"""XOR-hash grid encode and its table gradient (PyTorch port).

Counterpart of coslam_tpu/ops/hash_pallas.py and of the XOR-hash paths of
coslam_tpu/ops/encodings.py (``grid.grad_impl`` ``pallas``, ``scatter``
and ``onehot``, which all compute ``hashgrid_encode`` and its gradient).
The CUDA kernels are in coslam_torch/csrc/xor_grid_encode.cu:

- :func:`xor_grid_encode_fwd`: kernel E, the encode forward (XLA's
  ``hashgrid_encode`` on the TPU);
- :func:`xor_grid_encode_bwd`: kernel G, dx and the table gradient's
  update streams: row idx int32 [M] and values [M, F] (corner weight x
  cotangent), M = L * 8 * N in the level-major [L, 8, N] order of the JAX
  backward;

and the streams are summed into the table by the row accumulate
(ops/serial_scatter.py): kernel H, deterministic, for ``pallas`` (the
TPU's K4 adds in a fixed order by design), kernel F, atomic, for
``scatter`` and ``onehot`` (XLA's scatter-add is atomic on a GPU; the
one-hot product is a TPU formulation, and its bf16 rounding of w * g is
not copied: the port sums f32).

Dispatch is by the tensors' device: CPU tensors take the plain versions,
CUDA tensors the kernels or the call raises.
"""

from __future__ import annotations

import torch

from . import _kernels
from . import encodings as E
from . import serial_scatter as SS


def scatter_add(idx: torch.Tensor, vals: torch.Tensor, n_rows: int,
                deterministic: bool) -> torch.Tensor:
    """[n_rows, W] with out[r] = the sum of vals[m] where idx[m] == r;
    negative idx add into row 0, idx >= n_rows are dropped
    (scatter_add_pallas's semantics, over a table of any size in one
    pass)."""
    return SS.row_accum(idx, vals, n_rows, deterministic)[:n_rows]


# ---------------------------------------------------------------------------
# Plain version of kernel G (the forward's is encodings.hashgrid_encode)
# ---------------------------------------------------------------------------

def _clip_grad(x: torch.Tensor) -> torch.Tensor:
    """d clip(x, 0, 1) / dx as jax.vjp gives it through jnp.clip
    (minimum(maximum(x, 0), 1)): 1 inside, 0 outside, and 0.5 at exactly
    0 or 1, where the max or min splits its tie."""
    inside = ((x > 0.0) & (x < 1.0)).to(x.dtype)
    return inside + 0.5 * ((x == 0.0) | (x == 1.0)).to(x.dtype)


def xor_grid_encode_bwd_ref(spec: E.HashGridSpec, table: torch.Tensor,
                            x: torch.Tensor, g: torch.Tensor,
                            need_streams: bool, need_dx: bool):
    """Plain version of kernel G. Returns (idx [M] int32, vals [M, F])
    or (None, None), and dx [N, 3] or None: the vjp of hashgrid_encode in
    x at a fixed table, with the clip's tie rule."""
    n = x.shape[0]
    L, F = spec.n_levels, spec.n_features
    cell, w = E._cells_and_weights(spec, x)
    rows = E._corner_indices(spec, cell)                       # [L, 8, N]
    weight = E._corner_weights(w)                              # [L, 8, N]
    gl = g.reshape(n, L, F).permute(1, 2, 0)                   # [L, F, N]
    idx = vals = dx = None
    if need_streams:
        idx = rows.reshape(-1).to(torch.int32)
        vals = (weight[:, :, None] * gl[:, None]).permute(0, 1, 3, 2
                                                          ).reshape(-1, F)
    if need_dx:
        feats = table.T.index_select(1, rows.reshape(-1)).view(F, *rows.shape)
        s = (feats * gl.permute(1, 0, 2)[:, :, None]).sum(0)   # [L, 8, N]
        bits = E._corner_bits(x.device)[None, :, :, None] == 1  # [1, 8, 3, 1]
        cw = torch.where(bits, w[:, None], 1.0 - w[:, None])    # [L, 8, 3, N]
        sign = torch.where(bits, 1.0, -1.0)
        others = torch.stack([cw[:, :, 1] * cw[:, :, 2],
                              cw[:, :, 0] * cw[:, :, 2],
                              cw[:, :, 0] * cw[:, :, 1]], dim=2)
        dw = (sign * others * s[:, :, None]).sum(1)            # [L, 3, N]
        res = torch.tensor(spec.resolutions, dtype=x.dtype,
                           device=x.device)[:, None, None]
        dx = (dw * res).sum(0).T * _clip_grad(x)
    return idx, vals, dx


# ---------------------------------------------------------------------------
# Kernel wrappers: CPU tensors -> plain version, CUDA tensors -> kernel
# ---------------------------------------------------------------------------

def _check_cuda(spec: E.HashGridSpec, table: torch.Tensor, x: torch.Tensor,
                *more: torch.Tensor) -> None:
    _kernels.check_tensors("xor grid encode", x.device, table=table, x=x,
                           **{f"arg{i}": m for i, m in enumerate(more)})
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"xor grid encode: x must be [N, 3], got "
                         f"{tuple(x.shape)}")
    if tuple(table.shape) != (spec.total_entries, spec.n_features):
        raise ValueError(f"xor grid encode: table {tuple(table.shape)} does "
                         f"not match the spec ({spec.total_entries}, "
                         f"{spec.n_features})")
    if spec.n_levels * 8 * x.shape[0] >= 2 ** 31:
        raise ValueError("xor grid encode: more than 2^31 updates")


def xor_grid_encode_fwd(spec: E.HashGridSpec, table: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """Encode forward: x [N, 3] (normalized) -> [N, L*F].

    On the card, kernel E: a warp walks one level across 32 consecutive
    points (the samples of a ray share coarse cells), reads each corner
    row as a float2, and two corners as one float4 where their rows form
    an aligned pair (a dense level's z pair, a hashed level's x pair), and
    the block writes its tile's output rows whole."""
    if _kernels.on_cpu(table, x):
        return E.hashgrid_encode(spec, table, x)
    _check_cuda(spec, table, x)
    out = torch.empty((x.shape[0], spec.out_dim), device=x.device,
                      dtype=torch.float32)
    _kernels.check(_kernels.library().xor_grid_encode_fwd(
        x.data_ptr(), table.data_ptr(), out.data_ptr(), x.shape[0],
        spec.n_features, _kernels.level_table(spec, x.device).data_ptr(),
        spec.n_levels, 2 ** spec.log2_hashmap_size - 1,
        _kernels.stream(x.device)), "xor_grid_encode_fwd")
    xor_grid_encode_fwd.launches += 1
    return out


def xor_grid_encode_bwd(spec: E.HashGridSpec, table: torch.Tensor,
                        x: torch.Tensor, g: torch.Tensor, need_streams: bool,
                        need_dx: bool):
    """Encode backward: (idx [M] int32, vals [M, F]) or (None, None), and
    dx [N, 3] or None."""
    if _kernels.on_cpu(table, x, g):
        return xor_grid_encode_bwd_ref(spec, table, x, g, need_streams,
                                       need_dx)
    if not (need_streams or need_dx):
        return None, None, None
    _check_cuda(spec, table, x, g)
    if tuple(g.shape) != (x.shape[0], spec.out_dim):
        raise ValueError(f"xor grid encode: g {tuple(g.shape)} is not "
                         f"[{x.shape[0]}, {spec.out_dim}]")
    m = spec.n_levels * 8 * x.shape[0]
    idx = vals = dx = None
    if need_streams:
        idx = torch.empty(m, dtype=torch.int32, device=x.device)
        vals = torch.empty((m, spec.n_features), dtype=torch.float32,
                           device=x.device)
    if need_dx:
        dx = torch.zeros_like(x)
    _kernels.check(_kernels.library().xor_grid_encode_bwd(
        x.data_ptr(), table.data_ptr(), g.data_ptr(), _kernels.ptr(idx),
        _kernels.ptr(vals), _kernels.ptr(dx), x.shape[0], spec.n_features,
        _kernels.level_table(spec, x.device).data_ptr(), spec.n_levels,
        2 ** spec.log2_hashmap_size - 1, _kernels.stream(x.device)),
        "xor_grid_encode_bwd")
    xor_grid_encode_bwd.launches += 1
    return idx, vals, dx


# Launch counts of the two kernels (the CPU path never adds to them).
xor_grid_encode_fwd.launches = 0
xor_grid_encode_bwd.launches = 0


class XorGridEncode(torch.autograd.Function):
    """XOR-hash grid encode: kernel E forward; kernel G, then the row
    accumulate, backward. What is asked of G follows
    ``ctx.needs_input_grad``: tracking (table detached) dx only, the
    smoothness lattice (constant points) the table only, BA both. Saving
    (table, x) is all the backward needs, so the JAX package's
    rematerialization of legacy grad_impls has no counterpart."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, x: torch.Tensor,
                spec: E.HashGridSpec, deterministic: bool) -> torch.Tensor:
        ctx.spec, ctx.deterministic = spec, deterministic
        ctx.save_for_backward(table, x)
        return xor_grid_encode_fwd(spec, table, x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        table, x = ctx.saved_tensors
        need_table, need_dx = ctx.needs_input_grad[:2]
        idx, vals, dx = xor_grid_encode_bwd(ctx.spec, table, x, g.contiguous(),
                                            need_table, need_dx)
        dtable = (scatter_add(idx, vals, ctx.spec.total_entries,
                              ctx.deterministic) if need_table else None)
        return dtable, dx, None, None


def encode(spec: E.HashGridSpec, table: torch.Tensor, x: torch.Tensor,
           deterministic: bool) -> torch.Tensor:
    """Differentiable XOR-hash grid encode of normalized points x [N, 3];
    ``deterministic`` picks kernel H (else F) for the table gradient."""
    return XorGridEncode.apply(table, x.contiguous(), spec, deterministic)
