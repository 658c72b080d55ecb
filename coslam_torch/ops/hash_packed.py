"""Packed z-linear multiresolution hash encoding (PyTorch port).

Counterpart of coslam_tpu/ops/hash_packed.py. The level layout is the
same: a dense prefix of levels stored as (res+1)^3 z-minor cubes, then
hashed levels addressed ``((x*P1) ^ (y*P2)) & (2^S - 1) + z`` with
2^S + res + 1 rows each, all in one logical [T, F] table. Every cell's
z-corner pair (z, z+1) is therefore the row pair (e, e+1).

The TPU needed a packed bf16 window mirror, a cell mirror, level groups
and serial scatter kernels to make that pair cheap; on the GPU the two
CUDA kernels in coslam_torch/csrc/grid_encode.cu read and atomically
update the row pair of the logical f32 table directly:

- :func:`grid_encode_fwd`: kernel A, the encode forward;
- :func:`grid_encode_bwd`: kernel B, the table gradient and/or dx. Each
  corner adds its row pair (e, e + 1) with one float4 atomic (e even) or
  two float2 atomics (e odd); a point's dx is summed over its levels
  inside the block and stored once, so dx needs no zero fill;
- :func:`grid_encode_bwd_serial`: kernel B's serial mode, K2 and K3 in
  the TPU kernels' serial order, which :func:`grid_encode_bwd` takes for
  the table gradient when ``torch.are_deterministic_algorithms_enabled()``:
  the updates are produced inside a radix sort of each level
  (:func:`serial_segments`, in the order of :func:`serial_order`, which
  keeps the plain order of every row's updates) and kernel H's walk sums
  each row in that order, so dtable is the same bits on every run.

Dispatch is by the tensors' device: CPU tensors take the plain PyTorch
versions (:func:`grid_encode_fwd_ref`, :func:`grid_encode_bwd_ref`),
CUDA tensors take the kernels or the call raises. :class:`GridEncode`
is the autograd Function around both; it asks the backward kernel only
for the gradients autograd needs, so one Function serves mapping (table
and dx), tracking (dx only: the table is detached) and the smoothness
lattice (table only: the points are constants).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import torch

from . import _kernels
from . import serial_scatter as SS

# Instant-NGP spatial-hash primes, used for the x/y axes.
_P1 = 2654435761
_P2 = 805459861


@dataclass(frozen=True)
class PackedGridSpec:
    """Static layout of a packed z-linear multiresolution grid (the
    fields of coslam_tpu's PackedGridSpec that address the logical
    table; the TPU's window-storage fields have no counterpart)."""

    n_levels: int
    n_features: int
    base_resolution: int
    log2_hashmap_size: int
    desired_resolution: int
    resolutions: Tuple[int, ...]      # per-level grid resolution
    hashed: Tuple[bool, ...]          # per-level dense vs hashed
    offsets: Tuple[int, ...]          # per-level start row in the table
    sizes: Tuple[int, ...]            # per-level rows
    total_entries: int                # rows total

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def make_packed_spec(desired_resolution: int, log2_hashmap_size: int = 19,
                     n_levels: int = 16, n_features: int = 2,
                     base_resolution: int = 16,
                     dense_only: bool = False) -> PackedGridSpec:
    """per_level_scale = exp2(log2(desired/base)/(L-1)); a level stores
    densely when its full (res+1)^3 grid fits the 2^S hash budget
    (coslam_tpu.ops.hash_packed.make_packed_spec)."""
    if n_levels > 1:
        growth = math.exp2(
            math.log2(desired_resolution / base_resolution) / (n_levels - 1))
    else:
        growth = 1.0
    max_hash = 2 ** log2_hashmap_size
    resolutions, hashed, offsets, sizes = [], [], [], []
    off = 0
    for lvl in range(n_levels):
        res = max(int(math.floor(base_resolution * growth ** lvl)), 1)
        n_dense = (res + 1) ** 3
        use_hash = (not dense_only) and (n_dense > max_hash)
        # Hashed levels need +res+1 rows so base + z never wraps.
        size = (max_hash + res + 1) if use_hash else n_dense
        resolutions.append(res)
        hashed.append(use_hash)
        offsets.append(off)
        sizes.append(size)
        off += size
    return PackedGridSpec(
        n_levels=n_levels, n_features=n_features,
        base_resolution=base_resolution,
        log2_hashmap_size=log2_hashmap_size,
        desired_resolution=desired_resolution,
        resolutions=tuple(resolutions), hashed=tuple(hashed),
        offsets=tuple(offsets), sizes=tuple(sizes), total_entries=off)


def init_packed(spec: PackedGridSpec, generator: torch.Generator,
                device=None) -> torch.Tensor:
    """Uniform(-1e-4, 1e-4) table init (tiny-cuda-nn default), drawn on
    the generator's device and moved to ``device``."""
    u = torch.rand((spec.total_entries, spec.n_features), generator=generator,
                   device=generator.device)
    return ((u * 2.0 - 1.0) * 1e-4).to(device or generator.device)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the oracle for the kernels)
# ---------------------------------------------------------------------------

# The plain versions keep the point axis innermost ([L, 3, N], [F, L, 4, N]
# as in the JAX package): CPU broadcasts over short inner axes are slow.

def _cells_and_weights(spec: PackedGridSpec, x: torch.Tensor):
    """x [N, 3] -> (cell int64 [L, 3, N], w [L, 3, N]); x is clipped to
    [0, 1] and cell to [0, res - 1]."""
    res = torch.tensor(spec.resolutions, dtype=x.dtype, device=x.device)
    pos = res[:, None, None] * x.clamp(0.0, 1.0).T[None]
    resi = torch.tensor(spec.resolutions, device=x.device)[:, None, None]
    cell = torch.minimum(pos.floor().long().clamp_min(0), resi - 1)
    return cell, pos - cell.to(x.dtype)


def _corner_entries(spec: PackedGridSpec, cell: torch.Tensor) -> torch.Tensor:
    """Logical rows of corner (xc, yc, z) for the 4 xy corners
    [L, 4, N]; corner (xc, yc, z+1) is the next row. The dense levels are
    a prefix of the level list. The hash is taken in int64 and masked:
    the same bits as the uint32 wrap of the JAX and CUDA versions,
    because the mask keeps fewer than 32 bits."""
    dev = cell.device
    nd = spec.hashed.index(True) if any(spec.hashed) else spec.n_levels
    resi = torch.tensor(spec.resolutions, device=dev)[:, None]
    cx, cy, cz = cell.unbind(1)                           # [L, N]
    xs = (cx, torch.minimum(cx + 1, resi))                # corner c: (c>>1, c&1)
    ys = (cy, torch.minimum(cy + 1, resi))
    parts = []
    if nd:
        r1 = resi[:nd] + 1
        xr = [x[:nd] * r1 for x in xs]
        parts.append(torch.stack([(xr[c >> 1] + ys[c & 1][:nd]) * r1
                                  for c in range(4)], dim=1))
    if nd < spec.n_levels:
        mask = 2 ** spec.log2_hashmap_size - 1
        hx = [x[nd:] * _P1 for x in xs]
        hy = [y[nd:] * _P2 for y in ys]
        parts.append(torch.stack([(hx[c >> 1] ^ hy[c & 1]) & mask
                                  for c in range(4)], dim=1))
    offs = torch.tensor(spec.offsets, device=dev)[:, None]
    base = parts[0] if len(parts) == 1 else torch.cat(parts)
    return base + (cz + offs)[:, None]


def _xy_weights(w: torch.Tensor) -> torch.Tensor:
    """Trilinear xy-corner weights [L, 4, N] from w [L, 3, N]."""
    wx, wy = w[:, 0], w[:, 1]
    return torch.stack([(1 - wx) * (1 - wy), (1 - wx) * wy,
                        wx * (1 - wy), wx * wy], dim=1)


def _pairs(table_t: torch.Tensor, e: torch.Tensor):
    """Rows e and e + 1 of the table, from its transpose [F, T] ->
    (p0, p1) [F, *e.shape]."""
    return tuple(table_t.index_select(1, i.reshape(-1)).view(-1, *e.shape)
                 for i in (e, e + 1))


def grid_encode_fwd_ref(spec: PackedGridSpec, table: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel A: x [N, 3], table [T, F] -> [N, L*F],
    column l*F + f (the JAX _combine order)."""
    cell, w = _cells_and_weights(spec, x)
    p0, p1 = _pairs(table.T, _corner_entries(spec, cell))  # [F, L, 4, N]
    wz = w[:, 2, None]                                      # [L, 1, N]
    enc = ((p0 * (1 - wz) + p1 * wz) * _xy_weights(w)).sum(2)  # [F, L, N]
    return enc.permute(2, 1, 0).reshape(x.shape[0], -1)


def grid_encode_bwd_ref(spec: PackedGridSpec, table: torch.Tensor,
                        x: torch.Tensor, g: torch.Tensor, need_dtable: bool,
                        need_dx: bool):
    """Plain version of kernel B: the table gradient by explicit
    ``index_add_`` (rows e and e+1 of every xy corner) and the dx chain
    of the JAX custom VJP, zeroed where x lies outside [0, 1].
    Returns (dtable [T, F] or None, dx [N, 3] or None)."""
    n = x.shape[0]
    L, F = spec.n_levels, spec.n_features
    cell, w = _cells_and_weights(spec, x)
    e = _corner_entries(spec, cell)                          # [L, 4, N]
    wxy = _xy_weights(w)                                     # [L, 4, N]
    wz = w[:, 2, None]                                       # [L, 1, N]
    gl = g.reshape(n, L, F).permute(2, 1, 0)[:, :, None]     # [F, L, 1, N]
    dtable = dx = None
    if need_dtable:
        gw = gl * wxy                                        # [F, L, 4, N]
        v1 = gw * wz
        dtable_t = torch.zeros((F, table.shape[0]), dtype=table.dtype,
                               device=table.device)
        dtable_t.index_add_(1, e.reshape(-1), (gw * (1 - wz)).reshape(F, -1))
        dtable_t.index_add_(1, (e + 1).reshape(-1), v1.reshape(F, -1))
        dtable = dtable_t.T.contiguous()
    if need_dx:
        p0, p1 = _pairs(table.T, e)
        featz = p0 * (1 - wz) + p1 * wz
        dwxy = (featz * gl).sum(0)                           # [L, 4, N]
        dwz = (((p1 - p0) * gl).sum(0) * wxy).sum(1)         # [L, N]
        wx, wy = w[:, 0], w[:, 1]
        dwx = (-dwxy[:, 0] * (1 - wy) - dwxy[:, 1] * wy
               + dwxy[:, 2] * (1 - wy) + dwxy[:, 3] * wy)
        dwy = (-dwxy[:, 0] * (1 - wx) + dwxy[:, 1] * (1 - wx)
               - dwxy[:, 2] * wx + dwxy[:, 3] * wx)
        res = torch.tensor(spec.resolutions, dtype=x.dtype,
                           device=x.device)[:, None]
        dx = torch.stack([(dwx * res).sum(0), (dwy * res).sum(0),
                          (dwz * res).sum(0)], dim=-1)
        dx = dx * ((x >= 0.0) & (x <= 1.0)).to(x.dtype)
    return dtable, dx


def grid_encode_bwd_streams_ref(spec: PackedGridSpec, table: torch.Tensor,
                                x: torch.Tensor, g: torch.Tensor):
    """The table gradient's updates in the order grid_encode_bwd_ref adds
    them: every v0 = (g wxy)(1 - wz) at row e over [L, corner, N], then
    every v1 = (g wxy) wz at row e + 1 -> (rows int32 [M], values [M, F]),
    M = 2 L 4 N. serial_scatter.row_accum_ref of them is
    grid_encode_bwd_ref's dtable bit for bit on the CPU; kernel B's serial
    mode writes the same stream on the card."""
    del table  # the updates do not read it
    n, L, F = x.shape[0], spec.n_levels, spec.n_features
    cell, w = _cells_and_weights(spec, x)
    e = _corner_entries(spec, cell)                          # [L, 4, N]
    wz = w[:, 2, None]
    gw = g.reshape(n, L, F).permute(2, 1, 0)[:, :, None] * _xy_weights(w)
    idx = torch.cat([e.reshape(-1), (e + 1).reshape(-1)]).to(torch.int32)
    vals = torch.cat([(gw * (1 - wz)).reshape(F, -1),
                      (gw * wz).reshape(F, -1)], 1).T.contiguous()
    return idx, vals


def serial_segments(spec: PackedGridSpec, n: int) -> SS.SegmentPlan:
    """The serial mode's segments at n points: one a level (its rows; a
    corner pair (e, e + 1) never leaves its level), 2 x 4 x n updates
    each."""
    return SS.segment_plan([(lo, lo + size, 8 * n) for lo, size in
                            zip(spec.offsets, spec.sizes)])


def serial_order(spec: PackedGridSpec, n: int) -> torch.Tensor:
    """int64 [M]: the index in grid_encode_bwd_streams_ref's stream of
    every update in the serial sort's order: level l, then half (v0, v1),
    then corner c, then point. Each row's updates keep their stream
    order, so a stable sort of the reordered stream by row is the stable
    sort of the stream, element for element."""
    L = spec.n_levels
    level = torch.arange(L)[:, None, None, None]
    half = torch.arange(2)[None, :, None, None]
    corner = torch.arange(4)[None, None, :, None]
    return (half * (L * 4 * n) + (level * 4 + corner) * n
            + torch.arange(n)).reshape(-1)


# ---------------------------------------------------------------------------
# Kernel wrappers: CPU tensors -> plain version, CUDA tensors -> kernel
# ---------------------------------------------------------------------------

def _check_cuda(spec: PackedGridSpec, table: torch.Tensor, x: torch.Tensor,
                *more: torch.Tensor) -> None:
    _kernels.check_tensors("grid encode", x.device, table=table, x=x,
                           **{f"arg{i}": m for i, m in enumerate(more)})
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"grid encode: x must be [N, 3], got {tuple(x.shape)}")
    if tuple(table.shape) != (spec.total_entries, spec.n_features):
        raise ValueError(f"grid encode: table {tuple(table.shape)} does not "
                         f"match the spec ({spec.total_entries}, "
                         f"{spec.n_features})")


def grid_encode_fwd(spec: PackedGridSpec, table: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Encode forward: x [N, 3] (normalized) -> [N, L*F]."""
    if _kernels.on_cpu(table, x):
        return grid_encode_fwd_ref(spec, table, x)
    _check_cuda(spec, table, x)
    n = x.shape[0]
    out = x.new_empty((n, spec.out_dim))
    if n == 0:
        return out
    stream = _kernels.stream(x.device)
    _kernels.check(_kernels.library().grid_encode_fwd(
        x.data_ptr(), table.data_ptr(), out.data_ptr(), n, spec.n_features,
        _kernels.level_table(spec, x.device).data_ptr(), spec.n_levels,
        2 ** spec.log2_hashmap_size - 1, stream), "grid_encode_fwd")
    _kernels.count_launch(grid_encode_fwd, stream)
    return out


def grid_encode_bwd(spec: PackedGridSpec, table: torch.Tensor,
                    x: torch.Tensor, g: torch.Tensor, need_dtable: bool,
                    need_dx: bool):
    """Encode backward: (dtable [T, F] or None, dx [N, 3] or None)."""
    if _kernels.on_cpu(table, x, g):
        return grid_encode_bwd_ref(spec, table, x, g, need_dtable, need_dx)
    if not (need_dtable or need_dx):
        return None, None
    if need_dtable and torch.are_deterministic_algorithms_enabled():
        return grid_encode_bwd_serial(spec, table, x, g, need_dx)
    _check_cuda(spec, table, x, g)
    dtable = torch.zeros_like(table) if need_dtable else None
    dx = torch.empty_like(x) if need_dx else None     # every entry written
    stream = _kernels.stream(x.device)
    code = _kernels.library().grid_encode_bwd(
        x.data_ptr(), table.data_ptr(), g.data_ptr(), _kernels.ptr(dtable),
        _kernels.ptr(dx), x.shape[0], spec.n_features,
        _kernels.level_table(spec, x.device).data_ptr(), spec.n_levels,
        2 ** spec.log2_hashmap_size - 1, stream)
    _kernels.check(code, "grid_encode_bwd")
    _kernels.count_launch(grid_encode_bwd, stream,
                          "table" if need_dtable else "dx")
    return dtable, dx


def grid_encode_bwd_serial(spec: PackedGridSpec, table: torch.Tensor,
                           x: torch.Tensor, g: torch.Tensor, need_dx: bool):
    """Kernel B's serial mode: (dtable [T, F], dx [N, 3] or None). The
    table gradient's M = 2 L 4 N updates are produced inside a radix sort
    of each level's local rows (:func:`serial_segments`, in the order of
    :func:`serial_order`; :class:`serial_scatter.SerialSort`, its scratch
    reused across calls of one shape), and kernel H's walk sums every
    row's run in plain-stream order from 0.0: the serial order of the
    TPU's K2 and K3, so dtable is the same bits on every run and, up to
    each value's rounding, grid_encode_bwd_ref's. dx: kernel B's launch
    without the table gradient, as in :func:`grid_encode_bwd`. CUDA
    tensors only: it raises on a CPU tensor (whose plain version is
    already serial)."""
    _check_cuda(spec, table, x, g)
    if tuple(g.shape) != (x.shape[0], spec.out_dim):
        raise ValueError(f"grid encode: g {tuple(g.shape)} is not "
                         f"[{x.shape[0]}, {spec.out_dim}]")
    n, rows = x.shape[0], spec.total_entries
    dx = torch.empty_like(x) if need_dx else None      # every entry written
    if n == 0:
        return torch.zeros_like(table), dx
    plan = serial_segments(spec, n)
    sorter = SS.serial_sort(plan, rows, spec.out_dim * n, x.device)
    lib = _kernels.library()
    levels = _kernels.level_table(spec, x.device).data_ptr()
    mask = 2 ** spec.log2_hashmap_size - 1
    if need_dx:
        _kernels.check(lib.grid_encode_bwd(
            x.data_ptr(), table.data_ptr(), g.data_ptr(), None, dx.data_ptr(),
            n, spec.n_features, levels, spec.n_levels, mask,
            _kernels.stream(x.device)), "grid_encode_bwd")
    dtable = sorter.run("grid_encode_bwd_sort", x.data_ptr(), g.data_ptr(),
                        sorter.gt.data_ptr(), n, spec.n_features, levels,
                        spec.n_levels, mask)[:rows]
    _kernels.count_launch(grid_encode_bwd_serial, _kernels.stream(x.device),
                          "table")
    return dtable, dx


# Launch counts of the kernels, in all and by (stream, "table" | "dx")
# (_kernels.counted).
_kernels.counted(grid_encode_fwd, grid_encode_bwd, grid_encode_bwd_serial)


class GridEncode(torch.autograd.Function):
    """Hash-grid encode with the kernel backward; the gradients asked of
    the backward kernel follow ``ctx.needs_input_grad``."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, x: torch.Tensor,
                spec: PackedGridSpec) -> torch.Tensor:
        ctx.spec = spec
        ctx.save_for_backward(table, x)
        return grid_encode_fwd(spec, table, x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        table, x = ctx.saved_tensors
        dtable, dx = grid_encode_bwd(ctx.spec, table, x, g.contiguous(),
                                     ctx.needs_input_grad[0],
                                     ctx.needs_input_grad[1])
        return dtable, dx, None


def spec_ints(spec: PackedGridSpec) -> List[int]:
    """A spec as the flat integer list the custom op takes: the six
    scalars, then resolutions, hashed, offsets and sizes (L each)."""
    return [spec.n_levels, spec.n_features, spec.base_resolution,
            spec.log2_hashmap_size, spec.desired_resolution,
            spec.total_entries, *spec.resolutions,
            *(int(h) for h in spec.hashed), *spec.offsets, *spec.sizes]


def spec_from_ints(ints: List[int]) -> PackedGridSpec:
    """Inverse of :func:`spec_ints`."""
    n = ints[0]
    lv = [tuple(ints[6 + k * n:6 + (k + 1) * n]) for k in range(4)]
    return PackedGridSpec(ints[0], ints[1], ints[2], ints[3], ints[4],
                          lv[0], tuple(bool(h) for h in lv[1]), lv[2], lv[3],
                          ints[5])


@torch.library.custom_op("coslam_torch::grid_encode_fwd", mutates_args=())
def grid_encode_fwd_op(table: torch.Tensor, x: torch.Tensor,
                       spec: List[int]) -> torch.Tensor:
    """Kernel A's wrapper (:func:`grid_encode_fwd`) as the PyTorch
    operator ``torch.ops.coslam_torch.grid_encode_fwd``, which a traced
    program (tools/export.py) names, since torch.export cannot trace a
    launch through ctypes. ``import coslam_torch`` registers it."""
    return grid_encode_fwd(spec_from_ints(spec), table, x)


@grid_encode_fwd_op.register_fake
def _(table: torch.Tensor, x: torch.Tensor, spec: List[int]) -> torch.Tensor:
    return x.new_empty((x.shape[0], spec[0] * spec[1]))


def encode(spec: PackedGridSpec, table: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """Hash-grid encode of normalized points x [N, 3]: through
    :class:`GridEncode` where a gradient is asked for; else, on the card,
    through the custom op (the same wrapper, which a traced program can
    name) and, on the CPU, through the plain version."""
    x = x.contiguous()
    if torch.is_grad_enabled() and (table.requires_grad or x.requires_grad):
        return GridEncode.apply(table, x, spec)
    if _kernels.on_cpu(table, x):
        return grid_encode_fwd_ref(spec, table, x)
    return grid_encode_fwd_op(table, x, spec_ints(spec))
