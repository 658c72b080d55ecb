"""The scatter-accumulate probes' kernels: W-wide f32 rows added into an
accumulator at element offset ``idx[m] * stride``.

Counterparts of the Pallas probes of tools/bench/ (K5-K12), each a
variant of the serial row read-modify-write of K3/K4 that measured the
TPU; on the card they are the kernels P, Q, R, S and V of
coslam_torch/csrc/probe_accum.cu:

- P :func:`probe_accum`: f32 values as W streams ``[W, M]`` or as rows
  ``[M, W]``; the pair form (K2's shape, ``stride = F``, ``W = 2F``) adds
  rows idx and idx + 1 of an ``[rows, F]`` table;
- Q :func:`probe_accum_bf16x2`: the same with int32 words of two bf16
  each (element 2p in the low half, as JAX's bitcast of
  ``stack([a, b], -1)`` lays them out), through P's kernels with a loader
  that unpacks them;
- R :func:`probe_accum_pair_merged`: per pair, one row at idx1 and, where
  take2, one at idx2, after the torch pre-pass :func:`merge_pairs`; and
  :func:`probe_accum_cell_merged`, the same kernel on the raw updates
  with that pre-pass fused in (one launch for the JAX probe's whole
  ``run_merged``);
- S :func:`probe_accum_run_merge` (K11): out[clip(idx)] += vals, P's
  kernel with its clip rule on rows, each run of equal adjacent idx inside
  a warp summed before one row of atomics (K11's flush on change);
- V :func:`probe_accum_run_skip` (K12): the segmented suffix scan of
  :func:`run_merge_outside` and the skip of its sentinels in one launch.

P's kernel with its clip rule is also kernel F, the atomic row
accumulate of the main path (:mod:`.serial_scatter`), through
:func:`launch_accum`, as S is. P's warps take 32 consecutive updates a step and
sum each run of equal idx inside the warp before one row of atomics
(:func:`warp_runs` counts those rows); with scalar atomics (``vec`` 1)
and a W that divides 32, a warp's lanes lie across the row, so each warp
instruction adds 32 / W whole rows and runs are merged within those. Q
takes the same two kernels. R's lanes take a pair each, and its warps
merge runs across the pairs' rows likewise.

P, Q and R skip an update whose row would not lie inside the output
(idx < 0 or idx > ``out_rows - W // stride``): K12's sentinel rule; the
probes clip idx into their slack row first, in torch, as their JAX
callers did in XLA. S and V clip idx into ``[0, out_rows - 1]``
themselves, as K11's and K12's callers (``merge_accum``,
``run_merge_outside``) do. P and Q take the probes' launch settings:
``vec`` (1, 2 or 4: scalar, float2 or float4 atomics; it must divide W
and stride), threads per block (a multiple of 32) and ``upt``, the
updates each thread adds in turn, one warp-width apart; R, S and V add
with the widest vector atomics that divide W, and V's blocks take
``TILE`` updates each.

The plain versions are ``index_add_`` on the rows that lie inside the
output, in update order (on the CPU that is the serial order of the
TPU's loop, so K5, K8-K10 and K12 match bit for bit), with a torch unpack
for bf16, and V's with the scan before it. CPU tensors take them; CUDA
tensors take the kernels or the call raises.
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


WARP = 32   # P: the updates a warp takes a step (R: the pairs)


def warp_runs(idx: torch.Tensor, max_idx: int, clip: bool = False,
              take2: torch.Tensor | None = None,
              idx2: torch.Tensor | None = None) -> int:
    """Rows of atomics kernel P issues on idx in its vector forms: an
    update adds (its run's row) where its row lies in [0, max_idx] (with
    ``clip``, every update, idx clipped into that range) and it does not
    continue a run of equal idx inside its warp's step of WARP updates
    (updates [32 k, 32 k + 32)), so a run that crosses a step boundary
    costs one row a piece. Kernel F is ``clip`` with max_idx the slack
    row.

    With ``take2`` and ``idx2``, kernel R's (idx is idx1; the fused form
    is :func:`merge_pairs`' output): pair i holds its rows in range in the
    order idx1[i], then idx2[i] where take2[i] (two on one row summed into
    one), and the rows of a warp's WARP pairs lie in the order a_0, b_0,
    a_1, b_1, ...: a pair's first row continues the run of the previous
    pair's last row where they are equal, and a run goes on past a pair
    only where the pair holds one row. Every pair's second row heads a
    run."""
    def kept(j):
        return torch.where((j >= 0) & (j <= max_idx), j, -1)

    if take2 is not None:
        a, b = kept(idx), torch.where(take2 != 0, kept(idx2), -1)
        b = torch.where(b == a, -1, b)
        first = torch.where(a >= 0, a, b)
        second = torch.where(a >= 0, b, -1)
        last = torch.where(second >= 0, second, first)
        joins = torch.zeros_like(first, dtype=torch.bool)
        joins[1:] = (first[1:] >= 0) & (first[1:] == last[:-1])
        joins[::WARP] = False
        return int(((first >= 0) & ~joins).sum() + (second >= 0).sum())
    key = idx.clamp(0, max_idx) if clip else kept(idx)
    start = torch.ones_like(key, dtype=torch.bool)
    start[1:] = key[1:] != key[:-1]
    start[::WARP] = True
    return int((start & (key >= 0)).sum())


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


def run_merge_ref(idx: torch.Tensor, vals: torch.Tensor, out_rows: int
                  ) -> torch.Tensor:
    """Plain version of S: idx clipped into [0, out_rows - 1], then P's
    plain version on the rows vals f32 [M, W]."""
    return probe_accum_ref(idx.clamp(0, out_rows - 1), vals, out_rows)


def run_skip_ref(idx: torch.Tensor, vals: torch.Tensor, out_rows: int,
                 rounds: int = 5) -> torch.Tensor:
    """Plain version of V: :func:`run_merge_outside` into rows
    ``out_rows - 1``, then P's plain version, which skips its sentinels
    (idx ``out_rows``)."""
    s_idx, s_vals = run_merge_outside(idx, vals, out_rows - 1, rounds)
    return probe_accum_ref(s_idx, s_vals, out_rows)


def _even_updates(what: str, idx: torch.Tensor) -> int:
    """The pairs of idx [M]; raises unless M is even (the pre-pass
    slices idx[0::2] and idx[1::2])."""
    if idx.dim() != 1 or idx.shape[0] % 2:
        raise ValueError(f"{what}: idx {tuple(idx.shape)}: the pair merge "
                         "takes an even number of updates")
    return idx.shape[0] // 2


def cell_merged_ref(idx: torch.Tensor, streams: torch.Tensor,
                    out_rows: int) -> torch.Tensor:
    """Plain version of R's fused form: :func:`merge_pairs`, then
    :func:`pair_merged_ref`. idx [M] (M even), streams f32 [W, M]."""
    _even_updates("probe_accum_cell_merged", idx)
    return pair_merged_ref(*merge_pairs(idx, streams), out_rows)


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

_THREADS = 256  # R and S: threads per block (a multiple of 32)
TILE = 128      # V: updates a block
MAX_ROUNDS = 5  # V: the 31 rows a block stages past its tile reach 5 rounds


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
    """Launch kernel P (Q where ``bf16``: P's kernels with the words
    unpacked as they are loaded) into a zeroed [out_rows, stride] f32
    output and return it; idx outside the output is skipped, or, with
    ``clip``, clipped into [0, out_rows - W // stride]. Counts no launch:
    each caller counts its own."""
    stride = width if stride is None else stride
    if width % stride:
        raise ValueError(f"{what}: width {width} is not a multiple of the "
                         f"stride {stride}")
    _check_cuda(what, width, stride, vec, threads, idx=idx, vals=vals)
    _check_dtypes(what, torch.int32, idx=idx)
    if threads % WARP:
        raise ValueError(f"{what}: {threads} threads per block; the warps "
                         "take whole steps, so a multiple of 32")
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
    [M, W] (``rows``); stride defaults to W. With ``vec`` 1 and a W that
    divides 32 a warp's lanes lie across the rows; otherwise a lane takes
    one update."""
    width, m = vals.shape[::-1] if rows else vals.shape
    if _kernels.on_cpu(idx, vals):
        return probe_accum_ref(idx, vals if rows else vals.T, out_rows,
                               stride)
    _check_dtypes("probe_accum", torch.float32, vals=vals)
    out = launch_accum("probe_accum", idx, vals, width, m, out_rows, stride,
                       vec, upt, threads, False, rows)
    _kernels.count_launch(probe_accum, _kernels.stream(vals.device))
    return out


def probe_accum_bf16x2(idx: torch.Tensor, words: torch.Tensor,
                       out_rows: int, stride: int | None = None,
                       vec: int = 1, upt: int = 1,
                       threads: int = 256) -> torch.Tensor:
    """Kernel Q: kernel P with the values as W/2 streams of int32 words of
    two bf16, [W/2, M], each unpacked as it is loaded; ``vec``, ``upt``
    and ``threads`` mean what they mean for P."""
    n_words, m = words.shape
    if _kernels.on_cpu(idx, words):
        return probe_accum_ref(idx, unpack_bf16x2(words.T), out_rows, stride)
    _check_dtypes("probe_accum_bf16x2", torch.int32, words=words)
    out = launch_accum("probe_accum_bf16x2", idx, words, 2 * n_words, m,
                       out_rows, stride, vec, upt, threads, True, False)
    _kernels.count_launch(probe_accum_bf16x2, _kernels.stream(words.device))
    return out


def probe_accum_pair_merged(idx1: torch.Tensor, take2: torch.Tensor,
                            idx2: torch.Tensor, v1: torch.Tensor,
                            v2: torch.Tensor, out_rows: int) -> torch.Tensor:
    """Kernel R: out [out_rows, W] f32; pair i adds v1[:, i] at row
    idx1[i] and, where take2[i], v2[:, i] at row idx2[i]. v1, v2 f32
    [W, n] streams (from :func:`merge_pairs`; :func:`probe_accum_cell_merged`
    takes the raw updates)."""
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
    _kernels.count_launch(probe_accum_pair_merged, _kernels.stream(v1.device))
    return out


def probe_accum_cell_merged(idx: torch.Tensor, streams: torch.Tensor,
                            out_rows: int) -> torch.Tensor:
    """Kernel R on the raw updates, the pre-pass fused in: out [out_rows,
    W] f32 with each adjacent pair of updates (2i, 2i + 1) on one row
    added as one row, v[2i] + v[2i + 1], and the others row by row; rows
    outside the output skipped. idx int32 [M] (M even), streams f32 [W,
    M]: the JAX probe's whole ``run_merged`` in one launch."""
    what = "probe_accum_cell_merged"
    n = _even_updates(what, idx)
    if _kernels.on_cpu(idx, streams):
        return cell_merged_ref(idx, streams, out_rows)
    width, m = streams.shape
    vec = widest_vec(width)
    _check_cuda(what, width, width, vec, _THREADS, idx=idx, streams=streams)
    _check_dtypes(what, torch.int32, idx=idx)
    _check_dtypes(what, torch.float32, streams=streams)
    if m != 2 * n:
        raise ValueError(f"{what}: streams [W, {m}] for {2 * n} updates")
    out = torch.zeros((out_rows, width), dtype=torch.float32,
                      device=streams.device)
    _kernels.check(_kernels.library().probe_accum_cell_merged(
        idx.data_ptr(), streams.data_ptr(), out.data_ptr(), n, width,
        _max_idx(out_rows, width, width), vec, _THREADS,
        _kernels.stream(streams.device)), what)
    _kernels.count_launch(probe_accum_cell_merged,
                          _kernels.stream(streams.device))
    return out


def probe_accum_run_merge(idx: torch.Tensor, vals: torch.Tensor,
                          out_rows: int) -> torch.Tensor:
    """Kernel S: out [out_rows, W] f32 with out[clip(idx[m], 0,
    out_rows - 1)] += vals[m] (vals f32 rows [M, W]): kernel P with its
    clip rule and the widest vector atomic dividing W, one update a
    thread, whose warps add every run of equal adjacent idx once."""
    if _kernels.on_cpu(idx, vals):
        return run_merge_ref(idx, vals, out_rows)
    what = "probe_accum_run_merge"
    _check_dtypes(what, torch.float32, vals=vals)
    m, width = vals.shape
    out = launch_accum(what, idx, vals, width, m, out_rows, width,
                       widest_vec(width), 1, _THREADS, False, True,
                       clip=True)
    _kernels.count_launch(probe_accum_run_merge, _kernels.stream(vals.device))
    return out


def probe_accum_run_skip(idx: torch.Tensor, vals: torch.Tensor,
                         out_rows: int, rounds: int = MAX_ROUNDS
                         ) -> torch.Tensor:
    """Kernel V: :func:`run_merge_outside` with ``rounds`` rounds (at most
    5) into rows ``out_rows - 1``, then each run's first entry's scanned
    row added at its idx (vals f32 rows [M, W], W <= 16): out [out_rows,
    W] f32. A run longer than 2^rounds adds its first 2^rounds rows. A
    block takes ``TILE`` updates."""
    what = "probe_accum_run_skip"
    if not 0 <= rounds <= MAX_ROUNDS:
        raise ValueError(f"{what}: {rounds} rounds; the kernel stages rows "
                         f"for at most {MAX_ROUNDS}")
    if _kernels.on_cpu(idx, vals):
        return run_skip_ref(idx, vals, out_rows, rounds)
    m, width = vals.shape
    vec = widest_vec(width)
    _check_dtypes(what, torch.int32, idx=idx)
    _check_dtypes(what, torch.float32, vals=vals)
    if idx.shape != (m,) or width > 16 or out_rows < 1:
        raise ValueError(f"{what}: idx [M], vals [M, W <= 16] and at least "
                         "one output row expected")
    _check_cuda(what, width, width, vec, _THREADS, idx=idx, vals=vals)
    out = torch.zeros((out_rows, width), dtype=torch.float32,
                      device=vals.device)
    _kernels.check(_kernels.library().probe_accum_run_skip(
        idx.data_ptr(), vals.data_ptr(), out.data_ptr(), m, width,
        out_rows - 1, vec, rounds, TILE, _kernels.stream(vals.device)), what)
    _kernels.count_launch(probe_accum_run_skip, _kernels.stream(vals.device))
    return out


# Launch counts of the kernels (_kernels.counted).
_kernels.counted(probe_accum, probe_accum_bf16x2, probe_accum_pair_merged,
                 probe_accum_cell_merged, probe_accum_run_merge,
                 probe_accum_run_skip)
