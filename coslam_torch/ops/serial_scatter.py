"""The generic row accumulate: ``out[idx[m], :] += vals[m, :]``.

Counterpart of coslam_tpu/ops/serial_scatter.py (``row_accum_mat`` /
``row_accum``, the Pallas ``_row_kernel``) and of the accumulate of
coslam_tpu/ops/hash_pallas.py (``scatter_add_pallas``): idx [M] and vals
[M, W] f32 give an f32 accumulator [rows + 1, W]; idx is clipped to
[0, rows], so row ``rows`` is the slack row that the caller drops.

On the card it runs in one of two modes:

- atomic (kernel F, ``row_accum_atomic``): kernel P of
  coslam_torch/csrc/probe_accum.cu with its clip rule, one thread per
  update and a row of the widest vector atomics that divide W (float2 for
  the grids' 2 features); the order in which a row's updates add changes
  from run to run;
- deterministic (kernel H, ``row_accum_segmented``,
  coslam_torch/csrc/row_accum.cu): the updates are
  stably sorted by row (``torch.sort(stable=True)`` gives the
  permutation), then one thread per row sums its run in sorted order, that
  is in increasing m, from 0.0: the order in which the TPU's serial loop
  adds, so the result is the same bits on every run and equals a serial
  ``np.add.at``.

CPU tensors take the plain version in both modes: ``index_add_``, which
on the CPU adds in increasing m (the serial order of the deterministic
mode). CUDA tensors take the kernels or the call raises.
"""

from __future__ import annotations

import torch

from . import _kernels
from . import probe_accum as PA


def row_accum_ref(idx: torch.Tensor, vals: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """Plain version of both kernels: [rows + 1, W] f32, idx clipped to
    [0, rows]."""
    out = torch.zeros((rows + 1, vals.shape[1]), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(0, idx.long().clamp(0, rows), vals.float())


def _check_cuda(idx: torch.Tensor, vals: torch.Tensor, rows: int) -> None:
    _kernels.check_tensors("row accumulate", vals.device, vals=vals)
    if idx.device != vals.device:
        raise ValueError(f"row accumulate: idx is on {idx.device}, vals on "
                         f"{vals.device}")
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("row accumulate: idx must be contiguous int32, got "
                         f"{idx.dtype}")
    if vals.dim() != 2 or idx.shape != vals.shape[:1]:
        raise ValueError(f"row accumulate: idx {tuple(idx.shape)} and vals "
                         f"{tuple(vals.shape)} are not [M] and [M, W]")
    if not 0 <= rows < 2 ** 31 - 1:
        raise ValueError(f"row accumulate: rows {rows} out of int32 range")


def row_accum(idx: torch.Tensor, vals: torch.Tensor, rows: int,
              deterministic: bool) -> torch.Tensor:
    """out [rows + 1, W] f32 with out[clip(idx[m], 0, rows)] += vals[m]:
    kernel H (every row summed in increasing m) when ``deterministic``,
    kernel F (f32 atomics) otherwise."""
    if _kernels.on_cpu(idx, vals):
        return row_accum_ref(idx, vals, rows)
    _check_cuda(idx, vals, rows)
    m, width = vals.shape
    if not deterministic:
        out = PA.launch_accum("row_accum_atomic", idx, vals, width, m,
                              rows + 1, width, PA.widest_vec(width), 1, 256,
                              False, True, clip=True)
        row_accum_atomic.launches += 1
        return out
    # The permutation: clip the keys first (a stable sort of the raw keys
    # would put a -1 before an earlier 0 in row 0's run), then sort.
    lib, stream = _kernels.library(), _kernels.stream(vals.device)
    keys = torch.empty_like(idx)
    _kernels.check(lib.row_accum_keys(idx.data_ptr(), keys.data_ptr(), m,
                                      rows, stream), "row_accum_keys")
    keys, perm = torch.sort(keys, stable=True)
    out = torch.empty((rows + 1, width), dtype=torch.float32,
                      device=vals.device)
    _kernels.check(lib.row_accum_segmented(
        keys.data_ptr(), perm.data_ptr(), vals.data_ptr(), out.data_ptr(), m,
        rows, width, stream), "row_accum_segmented")
    row_accum_segmented.launches += 1
    return out


def row_accum_atomic(idx: torch.Tensor, vals: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """Kernel F: the atomic mode of :func:`row_accum`."""
    return row_accum(idx, vals, rows, deterministic=False)


def row_accum_segmented(idx: torch.Tensor, vals: torch.Tensor,
                        rows: int) -> torch.Tensor:
    """Kernel H: the deterministic mode of :func:`row_accum`."""
    return row_accum(idx, vals, rows, deterministic=True)


# Launch counts of the two kernels (the CPU path never adds to them).
row_accum_atomic.launches = 0
row_accum_segmented.launches = 0
