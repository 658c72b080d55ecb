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
  coslam_torch/csrc/row_accum.cu): a stable LSD radix sort of the clipped
  row keys over only the bits ``rows`` needs (:func:`sort_plan`), with the
  update's index m as payload; one pass over the sorted keys for every
  row's start; then a walk that sums every row's run in sorted order, that
  is in increasing m, from 0.0 (one thread per short run, one warp per
  long one): the order in which the TPU's serial loop adds, so the result
  is the same bits on every run and equals a serial ``np.add.at``.

CPU tensors take the plain version in both modes: ``index_add_``, which
on the CPU adds in increasing m (the serial order of the deterministic
mode). CUDA tensors take the kernels or the call raises.
"""

from __future__ import annotations

from dataclasses import dataclass

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


# Kernel H's radix sort: at most 7 bits a pass (128 digits, so that a
# digit's run in a tile is ~32 keys and its writes fill whole sectors, and
# a tile's digit counts and look-back stay small) over tiles of SORT_TILE
# keys (one published count per tile and digit).
SORT_MAX_DIGIT_BITS = 7
SORT_TILE = 4096


@dataclass(frozen=True)
class SortPlan:
    """The digits of kernel H's stable LSD radix sort of keys in
    [0, rows]: ``passes`` passes of ``digit_bits`` bits each."""

    digit_bits: int
    passes: int

    @property
    def radix(self) -> int:
        return 1 << self.digit_bits


def sort_plan(rows: int) -> SortPlan:
    """The bits that keys in [0, rows] need (at least 1), in the fewest
    passes of at most SORT_MAX_DIGIT_BITS bits, split as evenly as they
    go: 834,097 rows (room0_xor) take 20 bits, 3 passes of 7."""
    bits = max(int(rows).bit_length(), 1)
    passes = -(-bits // SORT_MAX_DIGIT_BITS)
    return SortPlan(-(-bits // passes), passes)


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
    if not 0 <= rows < 2 ** 31 - 1 or idx.shape[0] >= 2 ** 31:
        raise ValueError(f"row accumulate: rows {rows} or {idx.shape[0]} "
                         "updates out of int32 range")
    if vals.shape[1] == 2 and vals.data_ptr() % 16:    # 16-byte copies
        raise ValueError("row accumulate: 2-wide vals must be 16-byte "
                         "aligned")


class SegmentedPlan:
    """Kernel H's three phases and their scratch: the sort's two key
    buffers and two payload buffers (the value rows themselves when W = 2,
    else the update's index m), the tiles' published digit counts and
    ticket, the digit counts of every pass, the run starts, and the count
    and list of the runs that the walk gives a warp each. Each phase is
    one call into the library, so the wrapper and the smoke's per-phase
    timing run the same code."""

    def __init__(self, idx: torch.Tensor, vals: torch.Tensor, rows: int):
        self.idx, self.vals, self.rows = idx, vals, rows
        self.m, self.width = m, width = vals.shape
        self.plan = plan = sort_plan(rows)
        self.carry = width == 2         # the sort moves the value rows
        tiles = -(-m // SORT_TILE)
        # The key buffers padded to a multiple of 4 entries, so that each
        # starts 16-byte aligned (the run starts read them 4 at a time).
        pad = -(-m // 4) * 4
        sizes = (pad, pad, tiles * plan.radix + 1, plan.passes * plan.radix,
                 rows + 2, rows + 2)
        (keys_a, keys_b, self.status, self.digit_total, self.start,
         self.long_rows) = torch.split(
             torch.empty(sum(sizes), dtype=torch.int32, device=vals.device),
             sizes)
        self.keys_a, self.keys_b = keys_a[:m], keys_b[:m]
        # The payload buffers likewise (the sort copies them 16 bytes at a
        # time).
        pays = (torch.empty((2, pad, 2), dtype=torch.float32,
                            device=vals.device) if self.carry else
                torch.empty((2, pad), dtype=torch.int32, device=vals.device))
        self.pay_a, self.pay_b = pays[:, :m]
        # The passes alternate between the buffers, starting with a.
        odd = plan.passes % 2 == 1
        self.keys = self.keys_a if odd else self.keys_b
        self.pay = self.pay_a if odd else self.pay_b

    def _call(self, name: str, *args) -> None:
        _kernels.check(getattr(_kernels.library(), name)(
            *args, _kernels.stream(self.vals.device)), name)

    def sort(self) -> None:
        """keys, pay: the clipped keys stably sorted, and each one's value
        row (W = 2) or m."""
        p = self.plan
        self._call("row_accum_sort", self.idx.data_ptr(),
                   self.vals.data_ptr() if self.carry else None,
                   self.keys_a.data_ptr(), self.pay_a.data_ptr(),
                   self.keys_b.data_ptr(), self.pay_b.data_ptr(),
                   self.status.data_ptr(), self.status.numel(),
                   self.digit_total.data_ptr(), self.m, self.rows,
                   p.digit_bits, p.passes)

    def starts(self) -> None:
        """start[r]: row r's first position in the sorted keys, r in
        [0, rows + 1]."""
        self._call("row_accum_starts", self.keys.data_ptr(),
                   self.start.data_ptr(), self.m, self.rows)

    def walk(self, out: torch.Tensor) -> None:
        """out [rows + 1, W]: every row's run summed in sorted order."""
        perm, vals = ((None, self.pay) if self.carry
                      else (self.pay.data_ptr(), self.vals))
        self._call("row_accum_walk", self.start.data_ptr(), perm,
                   vals.data_ptr(), out.data_ptr(), self.long_rows.data_ptr(),
                   self.m, self.rows, self.width)


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
    h = SegmentedPlan(idx, vals, rows)
    out = torch.empty((rows + 1, width), dtype=torch.float32,
                      device=vals.device)
    h.sort()
    h.starts()
    h.walk(out)
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
