"""The generic row accumulate: ``out[idx[m], :] += vals[m, :]``.

Counterpart of coslam_tpu/ops/serial_scatter.py (``row_accum_mat`` /
``row_accum``, the Pallas ``_row_kernel``) and of the accumulate of
coslam_tpu/ops/hash_pallas.py (``scatter_add_pallas``): idx [M] and vals
[M, W] f32 give an f32 accumulator [rows + 1, W]; idx is clipped to
[0, rows], so row ``rows`` is the slack row that the caller drops.

On the card it runs in one of two modes:

- atomic (kernel F, ``row_accum_atomic``): kernel P of
  coslam_torch/csrc/probe_accum.cu with its clip rule, a warp taking 32
  consecutive updates (one a lane, so the loads are coalesced); the lanes
  whose clipped row equals the previous lane's form a run, whose rows are
  summed by warp shuffles before its first lane adds one row of the widest
  vector atomics that divide W (float2 for the grids' 2 features), and a
  warp without a run adds one row an update
  (:func:`.probe_accum.warp_runs` counts the rows). On ray-ordered points
  that removes the same-address atomics of a ray's samples that share a
  coarse cell. The order in which a row's updates add changes from run to
  run;
- deterministic (kernel H, ``row_accum_segmented``,
  coslam_torch/csrc/row_accum.cu): a stable LSD radix sort of the clipped
  row keys over only the bits ``rows`` needs (:func:`sort_plan`), with the
  update's index m as payload; one pass over the sorted keys for every
  row's start; then a walk that sums every row's run in sorted order, that
  is in increasing m, from 0.0 (one thread per short run, one warp per
  long one): the order in which the TPU's serial loop adds, so the result
  is the same bits on every run and equals a serial ``np.add.at``.

Kernels B, D and U have a serial mode of their own (hash_packed.py,
tensovm.py, triplane.py): the updates are produced inside a segmented
radix sort (coslam_torch/csrc/serial_sort.cuh, driven by
:class:`SerialSort`) over the disjoint row segments of
:func:`segment_plan`, so no update stream is written; every non-empty
row's run bounds in the sorted output (row_accum.cu's row_accum_bounds)
and kernel H's walk sum it.

CPU tensors take the plain version in both modes: ``index_add_``, which
on the CPU adds in increasing m (the serial order of the deterministic
mode). CUDA tensors take the kernels or the call raises.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
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


# The serial modes' segmented sort (serial_sort.cuh): at most 9 bits a
# pass over each segment's local keys (the digit counts the histogram
# keeps: serial_sort.cuh's kMaxRadix), tiles of SERIAL_TILE updates that
# never straddle a segment.
SERIAL_MAX_DIGIT_BITS = 9
SERIAL_TILE = 4096


@dataclass(frozen=True)
class SegmentPlan:
    """The serial sort's segments: segment s holds rows [lo[s], hi[s]) of
    the table and count[s] updates, which the producer numbers in an order
    that keeps the plain order of every row's updates; the local keys (row
    - lo) of every segment sort in one pass a digit, of ``pass_bits[k]``
    bits in pass k, the lowest digit first."""

    lo: Tuple[int, ...]
    hi: Tuple[int, ...]
    count: Tuple[int, ...]
    pass_bits: Tuple[int, ...]

    @property
    def passes(self) -> int:
        return len(self.pass_bits)

    @property
    def packed_bits(self) -> int:
        """pass_bits with pass k's width in bits 4k to 4k + 3, as the
        kernels take it."""
        return sum(b << 4 * k for k, b in enumerate(self.pass_bits))

    @property
    def bits(self) -> Tuple[int, ...]:
        """The bits of each segment's largest local key (at least 1)."""
        return tuple(max(hi - lo - 1, 1).bit_length()
                     for lo, hi in zip(self.lo, self.hi))

    @property
    def m(self) -> int:
        return sum(self.count)

    @property
    def tiles(self) -> Tuple[int, ...]:
        return tuple(-(-c // SERIAL_TILE) for c in self.count)

    def table(self) -> np.ndarray:
        """int32 [4, n + 1]: each segment's first row, update count, first
        tile and first position in the sorted output (entry n of the last
        two: the totals), as serial_sort.cuh reads it."""
        n = len(self.lo)
        tab = np.zeros((4, n + 1), np.int64)
        tab[0, :n], tab[1, :n] = self.lo, self.count
        tab[2, 1:] = np.cumsum(self.tiles)
        tab[3, 1:] = np.cumsum(self.count)
        return tab.astype(np.int32)


def segment_plan(segments: Sequence[Tuple[int, int, int]]) -> SegmentPlan:
    """The plan of segments [(lo, hi, updates)]: the bits of the largest
    local key over all segments in the fewest passes of at most
    SERIAL_MAX_DIGIT_BITS bits, split as evenly as they go, the narrower
    digits first (a room0 level of 65,936 rows: 17 bits, 8 then 9; the
    Dense grid's 401^3 level: 26 bits, 8, 9 and 9). The narrower first
    digit was the faster split on an H100 for B, U and D alike: its pass
    also computes the updates, and fewer digits give longer runs to
    write."""
    lo, hi, count = (tuple(int(v) for v in col) for col in zip(*segments))
    if any(h <= l for l, h in zip(lo, hi)) or any(c % 2 for c in count):
        raise ValueError(f"segment plan: empty segment or odd update count "
                         f"in {segments}")
    bits = max(max(h - l - 1, 1).bit_length() for l, h in zip(lo, hi))
    passes = -(-bits // SERIAL_MAX_DIGIT_BITS)
    return SegmentPlan(lo, hi, count, tuple(
        bits // passes + (k >= passes - bits % passes)
        for k in range(passes)))


def serial_sort_ref(plan: SegmentPlan, keys: np.ndarray,
                    vals: np.ndarray):
    """Plain version of the serial sort (serial_sort.cuh) on the host:
    keys int [M] (global rows) and vals [M, W] in the producer's order (a
    stream reordered by a module's serial_order) -> (sorted global rows,
    their values), computed as the kernels compute them: each segment's
    digit counts, then pass by pass each tile's digits ranked in update
    order, placed at the segment's start plus the earlier digits' totals
    plus the counts of the segment's earlier tiles (the look-back). It
    equals a stable sort of the keys, which is what the tests hold it
    to."""
    tab = plan.table().astype(np.int64)
    n = len(plan.lo)
    lo, count, base = tab[0, :n], tab[1, :n], tab[3]
    shifts = np.concatenate([[0], np.cumsum(plan.pass_bits)[:-1]])
    radix = 1 << SERIAL_MAX_DIGIT_BITS

    def digit(k, p):
        return (k >> shifts[p]) & ((1 << plan.pass_bits[p]) - 1)

    src_k = np.asarray(keys, np.int64) - np.repeat(lo, count)
    src_v = np.asarray(vals)
    for p in range(plan.passes):
        last = p == plan.passes - 1
        dst_k, dst_v = np.empty_like(src_k), np.empty_like(src_v)
        for s in range(n):
            seg = src_k[base[s]:base[s + 1]]
            totals = np.bincount(digit(seg, p), minlength=radix)
            start = base[s] + np.concatenate([[0], np.cumsum(totals)[:-1]])
            before = np.zeros(radix, np.int64)
            for i0 in range(0, count[s], SERIAL_TILE):
                at = base[s] + i0
                k = src_k[at:at + min(SERIAL_TILE, count[s] - i0)]
                d = digit(k, p)
                order = np.argsort(d, kind="stable")
                tile_counts = np.bincount(d, minlength=radix)
                tile_start = np.concatenate([[0],
                                             np.cumsum(tile_counts)[:-1]])
                ds = d[order]
                dst = (start[ds] + before[ds] + np.arange(len(k))
                       - tile_start[ds])
                dst_k[dst] = k[order] + (lo[s] if last else 0)
                dst_v[dst] = src_v[at:at + len(k)][order]
                before += tile_counts
        src_k, src_v = dst_k, dst_v
    return src_k, src_v


class SerialSort:
    """The serial modes' route on the card for one segment plan and shape,
    and its scratch. :meth:`run`: the producer's segmented sort (one call
    into the library: the cotangent staged level-major into ``gt``, the
    histogram and the passes) into the sorted global rows ``keys`` and
    their values ``pay``; every non-empty row's run bounds (``start``,
    ``end``); kernel H's walk over the runs."""

    def __init__(self, plan: SegmentPlan, rows: int, gt_floats: int,
                 device: torch.device):
        if plan.m >= 2 ** 31 or rows >= 2 ** 31 - 1:
            raise ValueError(f"serial sort: {plan.m} updates into {rows} "
                             "rows are out of int32 range")
        self.plan, self.rows, self.device = plan, rows, device
        self.m = m = plan.m
        self.table_host = np.ascontiguousarray(plan.table())
        self.table = torch.from_numpy(self.table_host).to(device)
        tmp = min(plan.passes - 1, 2)           # the intermediate buffers
        pad = -(-m // 4) * 4                    # 16-byte aligned parts
        self.status_len = sum(plan.tiles) * (1 << SERIAL_MAX_DIGIT_BITS) + 1
        sizes = (*[pad] * (1 + tmp), -(-self.status_len // 4) * 4,
                 len(plan.lo) * plan.passes << SERIAL_MAX_DIGIT_BITS,
                 rows + 1, rows + 1, rows + 2)
        parts = torch.split(torch.empty(sum(sizes), dtype=torch.int32,
                                        device=device), sizes)
        self.keys = parts[0][:m]
        self.keys_tmp = list(parts[1:1 + tmp]) + [None] * (2 - tmp)
        (self.status, self.hist, self.start, self.end,
         self.long_rows) = parts[1 + tmp:]
        fsizes = (*[2 * pad] * (1 + tmp), -(-gt_floats // 4) * 4)
        fparts = torch.split(torch.empty(sum(fsizes), dtype=torch.float32,
                                         device=device), fsizes)
        self.pay = fparts[0][:2 * m].view(m, 2)
        self.pay_tmp = list(fparts[1:1 + tmp]) + [None] * (2 - tmp)
        self.gt = fparts[-1]

    def run(self, entry: str, *producer_args) -> torch.Tensor:
        """out [rows + 1, 2]: the library's sort entry point `entry` with
        its producer's arguments (then serial_sort.cuh:SortArgs and the
        stream), the run bounds and the walk."""
        lib, p = _kernels.library(), self.plan
        stream = _kernels.stream(self.device)
        _kernels.check(getattr(lib, entry)(
            *producer_args, self.table.data_ptr(),
            self.table_host.ctypes.data, len(p.lo),
            _kernels.ptr(self.keys_tmp[0]), _kernels.ptr(self.pay_tmp[0]),
            _kernels.ptr(self.keys_tmp[1]), _kernels.ptr(self.pay_tmp[1]),
            self.keys.data_ptr(), self.pay.data_ptr(),
            self.status.data_ptr(), self.status_len, self.hist.data_ptr(),
            p.packed_bits, p.passes, stream), entry)
        _kernels.check(lib.row_accum_bounds(
            self.keys.data_ptr(), self.start.data_ptr(), self.end.data_ptr(),
            self.m, self.rows, stream), "row_accum_bounds")
        out = torch.empty((self.rows + 1, 2), dtype=torch.float32,
                          device=self.device)
        _kernels.check(lib.row_accum_walk_runs(
            self.start.data_ptr(), self.end.data_ptr(), self.pay.data_ptr(),
            out.data_ptr(), self.long_rows.data_ptr(), self.m, self.rows,
            stream), "row_accum_walk_runs")
        return out


@functools.lru_cache(maxsize=4)
def serial_sort(plan: SegmentPlan, rows: int, gt_floats: int,
                device: torch.device) -> SerialSort:
    """The SerialSort of a plan over [rows + 1, 2] with a cotangent of
    gt_floats floats, kept for the last few shapes so that the calls of one
    shape reuse its scratch (a room0 BA call at one keyframe sorts 22.5 M
    updates: 270 MB of output and as much again for the intermediate pass).
    Calls on one stream only: a call's buffers are read by its own walk
    before the next call writes them."""
    return SerialSort(plan, rows, gt_floats, device)


def serial_sum(plan: SegmentedPlan) -> torch.Tensor:
    """out [rows + 1, 2]: kernel H's sort, run starts and walk over the
    plan's stream, every row summed in increasing m from 0.0."""
    out = torch.empty((plan.rows + 1, plan.width), dtype=torch.float32,
                      device=plan.vals.device)
    plan.sort()
    plan.starts()
    plan.walk(out)
    return out


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
        _kernels.count_launch(row_accum_atomic, _kernels.stream(vals.device))
        return out
    out = serial_sum(SegmentedPlan(idx, vals, rows))
    _kernels.count_launch(row_accum_segmented, _kernels.stream(vals.device))
    return out


def row_accum_atomic(idx: torch.Tensor, vals: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """Kernel F: the atomic mode of :func:`row_accum`."""
    return row_accum(idx, vals, rows, deterministic=False)


def row_accum_segmented(idx: torch.Tensor, vals: torch.Tensor,
                        rows: int) -> torch.Tensor:
    """Kernel H: the deterministic mode of :func:`row_accum`."""
    return row_accum(idx, vals, rows, deterministic=True)


# Launch counts of the kernels (_kernels.counted).
_kernels.counted(row_accum_atomic, row_accum_segmented)
