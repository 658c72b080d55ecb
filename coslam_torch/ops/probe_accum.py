"""The scatter-accumulate probes' kernels: W-wide f32 rows added into an
accumulator at element offset ``idx[m] * stride``.

Counterparts of the Pallas probes of tools/bench/ (K5-K12), each a
variant of the serial row read-modify-write of K3/K4 that measured the
TPU; on the card they are four kernels of coslam_torch/csrc/
probe_accum.cu:

- P :func:`probe_accum`: f32 values as W streams ``[W, M]`` or as rows
  ``[M, W]``; the pair form (K2's shape, ``stride = F``, ``W = 2F``) adds
  rows idx and idx + 1 of an ``[rows, F]`` table;
- Q :func:`probe_accum_bf16x2`: the same with int32 words of two bf16
  each (element 2p in the low half, as JAX's bitcast of
  ``stack([a, b], -1)`` lays them out);
- R :func:`probe_accum_pair_merged`: per pair, one row at idx1 and, where
  take2, one at idx2, after the torch pre-pass :func:`merge_pairs`;
- S :func:`probe_accum_run_merge`: each run of equal adjacent idx summed
  in registers and added once (flush-on-change).

P's kernel with its clip rule is also kernel F, the atomic row
accumulate of the main path (:mod:`.serial_scatter`), through
:func:`launch_accum`.

Every kernel skips an update whose row would not lie inside the output
(idx < 0 or idx > ``out_rows - W // stride``): K12's sentinel rule; the
other probes clip idx into their slack row first, in torch, as their JAX
callers did in XLA. P and Q take the probes' launch settings: ``vec``
(1, 2 or 4: scalar, float2 or float4 atomics; it must divide W and
stride), threads per block and ``upt``, the updates each thread adds in
turn; R and S add with the widest vector atomics that divide W, 256
threads per block, and S takes ``span``, the updates each thread walks.

The plain versions are ``index_add_`` on the rows that lie inside the
output, in update order (on the CPU that is the serial order of the
TPU's loop, so K5, K8-K10 and K12 match bit for bit), with a torch unpack
for bf16. CPU tensors take them; CUDA tensors take the kernels or the
call raises.
"""

from __future__ import annotations

import torch

from . import _kernels


# -- helpers shared with the probes --------------------------------------------

def pack_bf16x2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 words of (bf16(a), bf16(b)), a in the low half: JAX's
    ``bitcast_convert_type(stack([a.astype(bf16), b.astype(bf16)], -1),
    int32)``."""
    pair = torch.stack([a.to(torch.bfloat16), b.to(torch.bfloat16)], -1)
    return pair.contiguous().view(torch.int32).squeeze(-1)


def _bits_to_f32(bits: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> the f32 with those bits."""
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def unpack_bf16x2(words: torch.Tensor) -> torch.Tensor:
    """[..., P] int32 words -> [..., 2P] f32: element 2p is the low half
    shifted up, 2p + 1 the high half masked (the shift is taken in int64,
    so it does not overflow)."""
    w = words.long()
    lo = _bits_to_f32((w << 16) & 0xFFFFFFFF)
    hi = _bits_to_f32(w & 0xFFFF0000)
    return torch.stack([lo, hi], -1).reshape(*words.shape[:-1], -1)


def merge_pairs(idx: torch.Tensor, streams: torch.Tensor):
    """The pre-pass of kernel R (``_bench_cell_merge.run_merged``): each
    adjacent pair (2i, 2i+1) of updates that hits one row is merged into
    the first. idx [M] (M even), streams f32 [W, M] -> (idx1, take2, idx2
    int32 [M/2], v1, v2 f32 [W, M/2])."""
    i1, i2 = idx[0::2], idx[1::2]
    same = i1 == i2
    odd = streams[:, 1::2]
    v1 = streams[:, 0::2] + torch.where(same, odd, 0.0)
    v2 = torch.where(same, 0.0, odd)
    return (i1.contiguous(), (~same).to(torch.int32), i2.contiguous(),
            v1.contiguous(), v2.contiguous())


def run_merge_outside(idx: torch.Tensor, vals: torch.Tensor, rows: int,
                      rounds: int = 5):
    """``_bench_run_merge.run_merge_outside`` in torch: a segmented suffix
    scan of ``rounds`` rounds puts each run's total (runs of up to
    2^rounds equal adjacent idx) in its first entry and gives every other
    entry the sentinel ``rows + 1``. idx [M] int32, vals f32 [M, W] ->
    (idx int32 [M], vals f32 [M, W])."""
    idx = idx.clamp(0, rows)
    v = vals
    link = torch.zeros_like(idx, dtype=torch.bool)
    link[:-1] = idx[1:] == idx[:-1]
    for r in range(rounds):
        s = 2 ** r
        v_up = torch.zeros_like(v)
        v_up[:-s] = v[s:]
        link_up = torch.zeros_like(link)
        link_up[:-s] = link[s:]
        v = v + torch.where(link[:, None], v_up, 0.0)
        link = link & link_up
    first = torch.ones_like(link)
    first[1:] = idx[1:] != idx[:-1]
    return torch.where(first, idx, rows + 1).to(torch.int32), v


def adjacent_runs(idx: torch.Tensor, span: int | None = None) -> int:
    """Rows of atomics kernel S issues on idx: the runs of equal adjacent
    entries, with a run that crosses a boundary of ``span`` updates (the
    thread's span) counted once per piece; without ``span``, the runs."""
    start = torch.ones_like(idx, dtype=torch.bool)
    start[1:] = idx[1:] != idx[:-1]
    if span is not None:
        start[::span] = True
    return int(start.sum())


# -- plain versions ------------------------------------------------------------

def _max_idx(out_rows: int, width: int, stride: int) -> int:
    return out_rows - width // stride


def probe_accum_ref(idx: torch.Tensor, rows: torch.Tensor, out_rows: int,
                    stride: int | None = None) -> torch.Tensor:
    """Plain version of P: rows f32 [M, W] -> [out_rows, stride]; the
    row of update m goes to element offset idx[m] * stride, updates whose
    row is not inside the output skipped, every row added in update
    order."""
    m, width = rows.shape
    stride = width if stride is None else stride
    if width % stride:
        raise ValueError(f"probe accumulate: width {width} is not a "
                         f"multiple of the stride {stride}")
    k = width // stride
    keep = (idx >= 0) & (idx <= _max_idx(out_rows, width, stride))
    idx, rows = idx[keep].long(), rows[keep].float()
    flat = (idx[:, None] + torch.arange(k, device=idx.device)).reshape(-1)
    out = torch.zeros((out_rows, stride), dtype=torch.float32,
                      device=rows.device)
    return out.index_add_(0, flat, rows.reshape(-1, stride))


def pair_merged_ref(idx1, take2, idx2, v1, v2, out_rows: int
                    ) -> torch.Tensor:
    """Plain version of R: per pair, v1's row at idx1, then, where take2,
    v2's at idx2, in pair order; v1, v2 f32 [W, n] -> [out_rows, W]."""
    width = v1.shape[0]
    hi = _max_idx(out_rows, width, width)
    idx = torch.stack([idx1.long(), torch.where(take2 != 0, idx2.long(),
                                                out_rows)], 1)
    idx = torch.where((idx >= 0) & (idx <= hi), idx, out_rows).reshape(-1)
    rows = torch.stack([v1.T, v2.T], 1).reshape(-1, width).float()
    out = torch.zeros((out_rows + 1, width), dtype=torch.float32,
                      device=v1.device)
    return out.index_add_(0, idx, rows)[:out_rows]


# -- kernels -------------------------------------------------------------------

_THREADS = 256  # R and S: threads per block


def widest_vec(width: int) -> int:
    """The widest vector atomic (float4, float2, scalar) dividing W."""
    return next(v for v in (4, 2, 1) if width % v == 0)


def _check_cuda(what: str, width: int, stride: int, vec: int, threads: int,
                **tensors) -> None:
    """Raise unless every tensor is contiguous on one CUDA device and the
    launch settings fit the row."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}; the kernel "
                             "needs every tensor on one CUDA device (CPU "
                             "tensors take the plain version)")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if vec not in (1, 2, 4) or width % vec or stride % vec:
        raise ValueError(f"{what}: vec {vec} must be 1, 2 or 4 and divide "
                         f"the width {width} and the stride {stride}")
    if not 32 <= threads <= 1024:
        raise ValueError(f"{what}: {threads} threads per block")


def _check_dtypes(what: str, dtype: torch.dtype, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be {dtype}, got {t.dtype}")


def launch_accum(what, idx, vals, width, m, out_rows, stride, vec, upt,
                 threads, bf16, rows, clip=False):
    """Launch kernel P (Q where ``bf16``) into a zeroed [out_rows, stride]
    f32 output and return it; idx outside the output is skipped, or, with
    ``clip``, clipped into [0, out_rows - W // stride]. Counts no launch:
    each caller counts its own."""
    stride = width if stride is None else stride
    if width % stride:
        raise ValueError(f"{what}: width {width} is not a multiple of the "
                         f"stride {stride}")
    _check_cuda(what, width, stride, vec, threads, idx=idx, vals=vals)
    _check_dtypes(what, torch.int32, idx=idx)
    if idx.shape != (m,):
        raise ValueError(f"{what}: idx {tuple(idx.shape)} for {m} updates")
    out = torch.zeros((out_rows, stride), dtype=torch.float32,
                      device=vals.device)
    _kernels.check(_kernels.library().probe_accum(
        idx.data_ptr(), vals.data_ptr(), out.data_ptr(), m, width, stride,
        _max_idx(out_rows, width, stride), vec, int(bf16), int(rows), upt,
        int(clip), threads, _kernels.stream(vals.device)), what)
    return out


def probe_accum(idx: torch.Tensor, vals: torch.Tensor, out_rows: int,
                stride: int | None = None, rows: bool = False, vec: int = 1,
                upt: int = 1, threads: int = 256) -> torch.Tensor:
    """Kernel P: out [out_rows, stride] f32 with the row of update m added
    at element offset idx[m] * stride. vals f32 [W, M] (streams) or
    [M, W] (``rows``); stride defaults to W."""
    width, m = vals.shape[::-1] if rows else vals.shape
    if _kernels.on_cpu(idx, vals):
        return probe_accum_ref(idx, vals if rows else vals.T, out_rows,
                               stride)
    _check_dtypes("probe_accum", torch.float32, vals=vals)
    out = launch_accum("probe_accum", idx, vals, width, m, out_rows, stride,
                       vec, upt, threads, False, rows)
    probe_accum.launches += 1
    return out


def probe_accum_bf16x2(idx: torch.Tensor, words: torch.Tensor,
                       out_rows: int, stride: int | None = None,
                       vec: int = 1, upt: int = 1,
                       threads: int = 256) -> torch.Tensor:
    """Kernel Q: kernel P with the values as W/2 streams of int32 words of
    two bf16, [W/2, M]."""
    n_words, m = words.shape
    if _kernels.on_cpu(idx, words):
        return probe_accum_ref(idx, unpack_bf16x2(words.T), out_rows, stride)
    _check_dtypes("probe_accum_bf16x2", torch.int32, words=words)
    out = launch_accum("probe_accum_bf16x2", idx, words, 2 * n_words, m,
                       out_rows, stride, vec, upt, threads, True, False)
    probe_accum_bf16x2.launches += 1
    return out


def probe_accum_pair_merged(idx1: torch.Tensor, take2: torch.Tensor,
                            idx2: torch.Tensor, v1: torch.Tensor,
                            v2: torch.Tensor, out_rows: int) -> torch.Tensor:
    """Kernel R: out [out_rows, W] f32; pair i adds v1[:, i] at row
    idx1[i] and, where take2[i], v2[:, i] at row idx2[i]. v1, v2 f32
    [W, n] streams (from :func:`merge_pairs`)."""
    if _kernels.on_cpu(idx1, take2, idx2, v1, v2):
        return pair_merged_ref(idx1, take2, idx2, v1, v2, out_rows)
    what = "probe_accum_pair_merged"
    width, n = v1.shape
    vec = widest_vec(width)
    _check_cuda(what, width, width, vec, _THREADS, idx1=idx1, take2=take2,
                idx2=idx2, v1=v1, v2=v2)
    _check_dtypes(what, torch.int32, idx1=idx1, take2=take2, idx2=idx2)
    _check_dtypes(what, torch.float32, v1=v1, v2=v2)
    if not idx1.shape == take2.shape == idx2.shape == (n,) or \
            v2.shape != v1.shape:
        raise ValueError(f"{what}: idx1, take2, idx2 [n] and v1, v2 [W, n] "
                         "expected")
    out = torch.zeros((out_rows, width), dtype=torch.float32,
                      device=v1.device)
    _kernels.check(_kernels.library().probe_accum_pair_merged(
        idx1.data_ptr(), take2.data_ptr(), idx2.data_ptr(), v1.data_ptr(),
        v2.data_ptr(), out.data_ptr(), n, width,
        _max_idx(out_rows, width, width), vec, _THREADS,
        _kernels.stream(v1.device)), what)
    probe_accum_pair_merged.launches += 1
    return out


def probe_accum_run_merge(idx: torch.Tensor, vals: torch.Tensor,
                          out_rows: int, span: int = 16) -> torch.Tensor:
    """Kernel S: out [out_rows, W] f32 with out[idx[m]] += vals[m] (vals
    f32 rows [M, W], W <= 16); each thread walks ``span`` updates and adds
    every run of equal adjacent idx once, summed in update order."""
    if _kernels.on_cpu(idx, vals):
        return probe_accum_ref(idx, vals, out_rows)
    what = "probe_accum_run_merge"
    m, width = vals.shape
    vec = widest_vec(width)
    _check_cuda(what, width, width, vec, _THREADS, idx=idx, vals=vals)
    _check_dtypes(what, torch.int32, idx=idx)
    _check_dtypes(what, torch.float32, vals=vals)
    if idx.shape != (m,) or width > 16 or span < 1:
        raise ValueError(f"{what}: idx [M], vals [M, W <= 16] and span >= 1 "
                         "expected")
    out = torch.zeros((out_rows, width), dtype=torch.float32,
                      device=vals.device)
    _kernels.check(_kernels.library().probe_accum_run_merge(
        idx.data_ptr(), vals.data_ptr(), out.data_ptr(), m, width,
        _max_idx(out_rows, width, width), vec, span, _THREADS,
        _kernels.stream(vals.device)), what)
    probe_accum_run_merge.launches += 1
    return out


# Launch counts of the four kernels (the CPU path never adds to them).
probe_accum.launches = 0
probe_accum_bf16x2.launches = 0
probe_accum_pair_merged.launches = 0
probe_accum_run_merge.launches = 0
