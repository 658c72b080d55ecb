"""TriPlane multiresolution encoding (PyTorch port).

Counterpart of coslam_tpu/ops/triplane.py: a pyramid of dense (r+1)^2
feature planes, three sections per level (the xy, xz and yz planes), all
in one logical [T, F] table. feature_l(x) is the sum over the level's
three sections of the bilinear interpolation of the plane at x's
projection; the levels are concatenated (out_dim = L * F). The same spec
is TensoVM's plane layout (ops/tensovm.py): the tri-plane is TensoVM
with unit lines.

The TPU gathered each section's two u-corner row pairs from a bf16
window mirror (XLA) and added the table gradient with the Pallas pair
scatter (K2, hash_packed._pair_scatter_kernel, through
_scatter_table_grad). On the GPU the kernels of
coslam_torch/csrc/tensovm_encode.cu read and atomically update the corner
row pairs of the logical f32 table directly: T a kernel of its own, U
kernel D with unit lines (no line table):

- :func:`triplane_encode_fwd`: kernel T, the encode forward, a warp one
  level of 32 points, compiled for the main path's 4 levels;
- :func:`triplane_encode_bwd`: kernel U, the table gradient and/or dx,
  a warp's runs of equal cell rows summed before its atomics;
- :func:`triplane_encode_bwd_serial`: kernel U's serial mode (K2 in its
  serial order), which :func:`triplane_encode_bwd` takes for the table
  gradient when ``torch.are_deterministic_algorithms_enabled()``: U
  writes every update as a (row, value) stream in the plain version's
  order (:func:`triplane_encode_bwd_streams_ref`) and kernel H's sort and
  walk sum each row in that order, so both are the same bits on every
  run.

CPU tensors take the plain versions (:func:`triplane_encode_fwd_ref`,
:func:`triplane_encode_bwd_ref`); CUDA tensors take the kernels or the
call raises. The separable-lattice encode of the smoothness term
(:func:`triplane_lattice_encode`) is plain PyTorch, as it is plain XLA in
the JAX package. The JAX spec's packed-storage fields (``row_offsets``,
``n_rows``, ``total_rows``) address the TPU's window mirror and have no
counterpart here.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from . import _kernels
from . import serial_scatter as SS

# Projection axes per plane section: (u axis, v axis).
_PLANES = ((0, 1), (0, 2), (1, 2))

# The top plane resolution is capped at isqrt(98304) - 2 = 311. The 98,304
# rows are the TPU scatter kernel's VMEM accumulator budget
# (coslam_tpu/ops/hash_packed.py:_MAX_GROUP_ROWS), a constant of that
# machine, but the cap fixes the table shapes, and parameters and
# checkpoints must cross between the two packages: keep it.
_R_CAP = math.isqrt(96 * 1024) - 2


@dataclass(frozen=True)
class TriPlaneSpec:
    """Static layout. ``n_levels`` counts sections (3 per pyramid level),
    as in the JAX spec."""

    pyr_levels: int
    n_levels: int                    # sections = 3 * pyr_levels
    n_features: int
    resolutions: Tuple[int, ...]     # per section (repeated per plane)
    offsets: Tuple[int, ...]         # per section start row
    sizes: Tuple[int, ...]           # per section rows, (r + 1)^2
    total_entries: int

    @property
    def out_dim(self) -> int:
        return self.pyr_levels * self.n_features


def make_triplane_spec(desired_resolution: int, n_levels: int = 4,
                       n_features: int = 2,
                       base_resolution: int = 32) -> TriPlaneSpec:
    """Geometric pyramid base..min(desired, 311) over ``n_levels`` levels
    (coslam_tpu.ops.triplane.make_triplane_spec)."""
    desired = max(base_resolution, min(int(desired_resolution), _R_CAP))
    if n_levels > 1:
        growth = math.exp2(
            math.log2(desired / base_resolution) / (n_levels - 1))
    else:
        growth = 1.0
    resolutions, offsets, sizes = [], [], []
    off = 0
    for lvl in range(n_levels):
        res = max(int(round(base_resolution * growth ** lvl)), 1)
        size = (res + 1) ** 2
        for _ in range(3):
            resolutions.append(res)
            offsets.append(off)
            sizes.append(size)
            off += size
    return TriPlaneSpec(
        pyr_levels=n_levels, n_levels=n_levels * 3, n_features=n_features,
        resolutions=tuple(resolutions), offsets=tuple(offsets),
        sizes=tuple(sizes), total_entries=off)


def cell_project(spec: TriPlaneSpec, x: torch.Tensor):
    """x [N, 3] -> (cu, cv int64 [S, N], wu, wv [S, N]): the bilinear cell
    of every (section, point) and the in-cell weights; x is clipped to
    [0, 1] and the cell to [0, r - 1] (coslam_tpu.ops.triplane._project,
    in the cell form of plane_quad._cell_project). Corner (iu, iv) of the
    cell is row offsets[s] + (cu + iu) * (r + 1) + cv + iv."""
    xt = x.clamp(0.0, 1.0).T                                   # [3, N]
    S = spec.n_levels
    res = torch.tensor(spec.resolutions, dtype=x.dtype, device=x.device)
    resi = torch.tensor(spec.resolutions, device=x.device)[:, None]
    ua = [_PLANES[s % 3][0] for s in range(S)]
    va = [_PLANES[s % 3][1] for s in range(S)]
    u = res[:, None] * xt[ua]                                  # [S, N]
    v = res[:, None] * xt[va]
    cu = torch.minimum(u.floor().long().clamp_min(0), resi - 1)
    cv = torch.minimum(v.floor().long().clamp_min(0), resi - 1)
    return cu, cv, u - cu.to(x.dtype), v - cv.to(x.dtype)



def init_triplane(spec: TriPlaneSpec, generator: torch.Generator,
                  device=None) -> torch.Tensor:
    """U(-1e-4, 1e-4) [T, F] (the hash table's scale), drawn on the
    generator's device and moved to ``device``."""
    u = torch.rand((spec.total_entries, spec.n_features), generator=generator,
                   device=generator.device)
    return ((u * 2.0 - 1.0) * 1e-4).to(device or generator.device)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the oracle for the kernels)
# ---------------------------------------------------------------------------

# Point axis innermost ([S, N], [F, S, N]) as in the JAX package.

def _corners(spec: TriPlaneSpec, x: torch.Tensor):
    """x [N, 3] -> (e00, e10 int64 [S, N], wu, wv [S, N]): the rows of
    cell corners (cu, cv) and (cu + 1, cv); the v corners are the next
    rows (coslam_tpu.ops.triplane._project, whose second u corner
    min(cu + 1, r) is cu + 1 because cu <= r - 1)."""
    cu, cv, wu, wv = cell_project(spec, x)
    r1 = torch.tensor(spec.resolutions, device=x.device)[:, None] + 1
    offs = torch.tensor(spec.offsets, device=x.device)[:, None]
    e00 = offs + cu * r1 + cv
    return e00, e00 + r1, wu, wv


def _rows(table: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Rows e [S, N] of a [T, F] table -> [F, S, N]."""
    return table.T.index_select(1, e.reshape(-1)).view(table.shape[1],
                                                       *e.shape)


def _section_grad(spec: TriPlaneSpec, g: torch.Tensor) -> torch.Tensor:
    """g [N, L*F] -> [F, S, N]: a level's cotangent on each of its three
    sections (they were summed)."""
    n = g.shape[0]
    return g.reshape(n, spec.pyr_levels, spec.n_features).permute(
        2, 1, 0).repeat_interleave(3, dim=1)


def triplane_encode_fwd_ref(spec: TriPlaneSpec, table: torch.Tensor,
                            x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel T: x [N, 3] -> [N, L*F], column l*F + f
    (coslam_tpu.ops.triplane.triplane_encode_fwd_only: per section the v,
    then the u interpolation, the three sections of a level summed)."""
    e00, e10, wu, wv = _corners(spec, x)
    featv0 = _rows(table, e00) * (1 - wv) + _rows(table, e00 + 1) * wv
    featv1 = _rows(table, e10) * (1 - wv) + _rows(table, e10 + 1) * wv
    feats = featv0 * (1 - wu) + featv1 * wu                    # [F, S, N]
    F, _, n = feats.shape
    per_level = feats.view(F, spec.pyr_levels, 3, n).sum(2)
    return per_level.permute(2, 1, 0).reshape(n, spec.out_dim)


def _updates(spec: TriPlaneSpec, x: torch.Tensor, g: torch.Tensor):
    """The table gradient's updates in K2's form, [(rows [S, N], values
    [F, S, N])] for the corners (u0, v0), (u0, v1), (u1, v0), (u1, v1):
    (g wu_k) (1 - wv) and (g wu_k) wv (make_triplane_encode's v0, v1)."""
    e00, e10, wu, wv = _corners(spec, x)
    gs = _section_grad(spec, g)
    out = []
    for e, w in ((e00, 1 - wu), (e10, wu)):
        gw = gs * w
        out += [(e, gw * (1 - wv)), (e + 1, gw * wv)]
    return out


def triplane_encode_bwd_ref(spec: TriPlaneSpec, table: torch.Tensor,
                            x: torch.Tensor, g: torch.Tensor,
                            need_dtable: bool, need_dx: bool):
    """Plain version of kernel U: the gradients of sum(encode * g).
    dtable: the pair updates of make_triplane_encode's backward (K2's
    streams), added by ``index_add_`` corner by corner; dx: that
    backward's chain (featv and the v-differences of the two u corners
    times r), zeroed where x lies outside [0, 1]. Returns (dtable [T, F],
    dx [N, 3]), None where not asked for."""
    n, F = x.shape[0], spec.n_features
    dtable = dx = None
    if need_dtable:
        dt = torch.zeros((F, table.shape[0]), dtype=table.dtype,
                         device=table.device)
        for e, v in _updates(spec, x, g):
            dt.index_add_(1, e.reshape(-1), v.reshape(F, -1))
        dtable = dt.T.contiguous()
    if need_dx:
        e00, e10, wu, wv = _corners(spec, x)
        gs = _section_grad(spec, g)
        p00, p01 = _rows(table, e00), _rows(table, e00 + 1)
        p10, p11 = _rows(table, e10), _rows(table, e10 + 1)
        featv0 = p00 * (1 - wv) + p01 * wv
        featv1 = p10 * (1 - wv) + p11 * wv
        res = torch.tensor(spec.resolutions, dtype=x.dtype,
                           device=x.device)[:, None]
        du = ((featv1 * gs).sum(0) - (featv0 * gs).sum(0)) * res   # [S, N]
        dv = (((p01 - p00) * gs).sum(0) * (1 - wu)
              + ((p11 - p10) * gs).sum(0) * wu) * res
        dxt = torch.zeros((3, n), dtype=x.dtype, device=x.device)
        for s_mod, (a, b) in enumerate(_PLANES):
            dxt[a] += du[s_mod::3].sum(0)
            dxt[b] += dv[s_mod::3].sum(0)
        dx = dxt.T * ((x >= 0.0) & (x <= 1.0)).to(x.dtype)
    return dtable, dx


def triplane_encode_bwd_streams_ref(spec: TriPlaneSpec, table: torch.Tensor,
                                    x: torch.Tensor, g: torch.Tensor):
    """The table gradient's updates in the order triplane_encode_bwd_ref
    adds them: corners (u0, v0), (u0, v1), (u1, v0), (u1, v1), each over
    [S, N] -> (rows int32 [M], values [M, F]), M = 4 S N.
    serial_scatter.row_accum_ref of them is triplane_encode_bwd_ref's
    dtable bit for bit on the CPU; kernel U's serial mode writes the same
    stream on the card."""
    del table  # the updates do not read it
    F = spec.n_features
    ups = _updates(spec, x, g)
    idx = torch.cat([e.reshape(-1) for e, _ in ups]).to(torch.int32)
    vals = torch.cat([v.reshape(F, -1) for _, v in ups], 1)
    return idx, vals.T.contiguous()


WARP = 32   # U: the points a warp takes at one level


def row_pair_adds(spec: TriPlaneSpec, x: torch.Tensor) -> int:
    """Row-pair adds (each one float4 atomic or two float2) of kernel U's
    table gradient at points x [N, 3], from the plain version's cell rows:
    per section, two for every point that does not continue a run of equal
    corner rows e00 inside its warp's WARP points (points [32 k, 32 k + 32):
    U's tiles are whole warps). Without the merge it would be 2 S N."""
    e00 = _corners(spec, x)[0]                                  # [S, N]
    start = torch.ones_like(e00, dtype=torch.bool)
    start[:, 1:] = e00[:, 1:] != e00[:, :-1]
    start[:, ::WARP] = True
    return 2 * int(start.sum())


def serial_segments(spec: TriPlaneSpec, n: int) -> SS.SegmentPlan:
    """U's serial mode's segments at n points: one a plane section (its
    (r + 1)^2 rows), 4 n updates each."""
    return SS.segment_plan([(lo, lo + size, 4 * n) for lo, size in
                            zip(spec.offsets, spec.sizes)])


def serial_order(spec: TriPlaneSpec, n: int) -> torch.Tensor:
    """int64 [M]: the index in triplane_encode_bwd_streams_ref's stream of
    every update in the serial sort's order: section s, then corner k, then
    point (the stream's m = (k S + s) n + point), which keeps every row's
    stream order."""
    S = spec.n_levels
    sec = torch.arange(S)[:, None, None]
    corner = torch.arange(4)[None, :, None]
    return ((corner * S + sec) * n + torch.arange(n)).reshape(-1)


# ---------------------------------------------------------------------------
# Kernel wrappers: CPU tensors -> plain version, CUDA tensors -> kernel
# ---------------------------------------------------------------------------

def _line_offsets(spec: TriPlaneSpec):
    """Start row of every section's line block in TensoVM's flat line
    table (one (r + 1)-row block per section)."""
    offs, off = [], 0
    for r in spec.resolutions:
        offs.append(off)
        off += r + 1
    return tuple(offs)


@functools.lru_cache(maxsize=None)
def _level_table(spec: TriPlaneSpec, device: torch.device) -> torch.Tensor:
    """int32 [3, L] (resolution, plane row and line row of the level's
    first section) on the kernel's device: kernels C and D read all
    three, T and U (unit lines) the first two."""
    sec0 = range(0, spec.n_levels, 3)
    lines = _line_offsets(spec)
    arr = np.array([[spec.resolutions[s] for s in sec0],
                    [spec.offsets[s] for s in sec0],
                    [lines[s] for s in sec0]], np.int32)
    # Uploaded from pageable host memory: done when .to() returns, so a
    # thread on another CUDA stream may read it (the pipelined runtime's
    # tracker and mapper); no lock.
    return torch.from_numpy(arr).to(device)


def _check_cuda(spec: TriPlaneSpec, table, x, g=None) -> None:
    more = {} if g is None else {"g": g}
    _kernels.check_tensors("triplane encode", x.device, table=table, x=x,
                           **more)
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"triplane encode: x must be [N, 3], got "
                         f"{tuple(x.shape)}")
    if tuple(table.shape) != (spec.total_entries, spec.n_features):
        raise ValueError(f"triplane encode: table {tuple(table.shape)} does "
                         f"not match the spec ({spec.total_entries}, "
                         f"{spec.n_features})")
    if g is not None and tuple(g.shape) != (x.shape[0], spec.out_dim):
        raise ValueError(f"triplane encode: g {tuple(g.shape)} is not "
                         f"[{x.shape[0]}, {spec.out_dim}]")


def triplane_encode_fwd(spec: TriPlaneSpec, table: torch.Tensor,
                        x: torch.Tensor) -> torch.Tensor:
    """Encode forward: x [N, 3] (normalized) -> [N, L*F]. On the card,
    kernel T: a block takes tiles of 32 points, a warp one level of a
    tile; x and the outputs staged in shared memory."""
    if _kernels.on_cpu(table, x):
        return triplane_encode_fwd_ref(spec, table, x)
    _check_cuda(spec, table, x)
    n = x.shape[0]
    out = x.new_empty((n, spec.out_dim))
    if n == 0:
        return out
    _kernels.check(_kernels.library().triplane_encode_fwd(
        x.data_ptr(), table.data_ptr(), out.data_ptr(), n, spec.n_features,
        _level_table(spec, x.device).data_ptr(), spec.pyr_levels,
        _kernels.stream(x.device)), "triplane_encode_fwd")
    _kernels.count_launch(triplane_encode_fwd, _kernels.stream(x.device))
    return out


def triplane_encode_bwd(spec: TriPlaneSpec, table: torch.Tensor,
                        x: torch.Tensor, g: torch.Tensor, need_dtable: bool,
                        need_dx: bool):
    """Encode backward: (dtable [T, F] or None, dx [N, 3] or None). On
    the card, kernel U: a warp takes one level of 32 consecutive points;
    per section, the lanes whose corner row equals the previous lane's
    form a run (the samples of a ray in one coarse cell), each run's two
    u-corner row pairs are summed by warp shuffles, and its first lane
    adds each pair with one float4 atomic (first row even) or two float2
    (:func:`row_pair_adds` counts them); dx is summed over a point's levels
    in the block and stored once (no zero fill)."""
    if _kernels.on_cpu(table, x, g):
        return triplane_encode_bwd_ref(spec, table, x, g, need_dtable,
                                       need_dx)
    if not (need_dtable or need_dx):
        return None, None
    if need_dtable and torch.are_deterministic_algorithms_enabled():
        return triplane_encode_bwd_serial(spec, table, x, g, need_dx)
    _check_cuda(spec, table, x, g)
    dtable = torch.zeros_like(table) if need_dtable else None
    dx = torch.empty_like(x) if need_dx else None      # every entry written
    _kernels.check(_kernels.library().triplane_encode_bwd(
        x.data_ptr(), table.data_ptr(), g.data_ptr(), _kernels.ptr(dtable),
        _kernels.ptr(dx), x.shape[0], spec.n_features,
        _level_table(spec, x.device).data_ptr(), spec.pyr_levels,
        _kernels.stream(x.device)), "triplane_encode_bwd")
    _kernels.count_launch(triplane_encode_bwd, _kernels.stream(x.device))
    return dtable, dx


def triplane_encode_bwd_serial(spec: TriPlaneSpec, table: torch.Tensor,
                               x: torch.Tensor, g: torch.Tensor,
                               need_dx: bool):
    """Kernel U's serial mode: (dtable [T, F], dx [N, 3] or None). The
    table gradient's M = 4 S N updates are produced inside a radix sort of
    each plane section's local rows (:func:`serial_segments`, in the order
    of :func:`serial_order`; :class:`serial_scatter.SerialSort`), and
    kernel H's walk sums every row's run in plain-stream order
    from 0.0: K2's serial order, so dtable is the same bits on every run
    and triplane_encode_bwd_ref's on the host. dx: kernel U's launch
    without the table gradient, as in :func:`triplane_encode_bwd`. CUDA
    tensors only."""
    _check_cuda(spec, table, x, g)
    n, rows = x.shape[0], spec.total_entries
    dx = torch.empty_like(x) if need_dx else None      # every entry written
    if n == 0:
        return torch.zeros_like(table), dx
    sorter = SS.serial_sort(serial_segments(spec, n), rows, spec.out_dim * n,
                            x.device)
    lib = _kernels.library()
    levels = _level_table(spec, x.device).data_ptr()
    if need_dx:
        _kernels.check(lib.triplane_encode_bwd(
            x.data_ptr(), table.data_ptr(), g.data_ptr(), None,
            dx.data_ptr(), n, spec.n_features, levels, spec.pyr_levels,
            _kernels.stream(x.device)), "triplane_encode_bwd")
    dtable = sorter.run("triplane_encode_bwd_sort", x.data_ptr(),
                        table.data_ptr(), g.data_ptr(), sorter.gt.data_ptr(),
                        n, spec.n_features, levels, spec.pyr_levels)[:rows]
    _kernels.count_launch(triplane_encode_bwd_serial,
                          _kernels.stream(x.device))
    return dtable, dx


# Launch counts of the kernels (_kernels.counted).
_kernels.counted(triplane_encode_fwd, triplane_encode_bwd,
                 triplane_encode_bwd_serial)


class TriPlaneEncode(torch.autograd.Function):
    """Tri-plane encode with the kernel backward; the gradients asked of
    kernel U follow ``ctx.needs_input_grad`` (tracking: dx only; the
    map's fixed-pose iterations: the table only)."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, x: torch.Tensor,
                spec: TriPlaneSpec) -> torch.Tensor:
        ctx.spec = spec
        ctx.save_for_backward(table, x)
        return triplane_encode_fwd(spec, table, x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        table, x = ctx.saved_tensors
        return (*triplane_encode_bwd(ctx.spec, table, x, g.contiguous(),
                                     *ctx.needs_input_grad[:2]), None)


def encode(spec: TriPlaneSpec, table: torch.Tensor,
           x: torch.Tensor) -> torch.Tensor:
    """Differentiable tri-plane encode of normalized points x [N, 3]."""
    return TriPlaneEncode.apply(table, x.contiguous(), spec)


# ---------------------------------------------------------------------------
# Separable lattice (the BA smoothness term): plain PyTorch
# ---------------------------------------------------------------------------

def _plane_grid_feats(spec: TriPlaneSpec, table: torch.Tensor,
                      axes: torch.Tensor) -> List[torch.Tensor]:
    """Bilinear plane features on the separable lattice axes[0] x axes[1]
    x axes[2] (axes [3, g] normalized): each section at its g^2 unique
    projections. Returns a list over sections of [g_u, g_v, F]
    (coslam_tpu.ops.triplane._plane_grid_feats)."""
    ax = axes.clamp(0.0, 1.0)
    feats = []
    for s in range(spec.n_levels):
        ua, va = _PLANES[s % 3]
        r = spec.resolutions[s]
        u, v = ax[ua] * r, ax[va] * r                          # [g]
        cu = u.floor().long().clamp(0, r - 1)
        cv = v.floor().long().clamp(0, r - 1)
        wu = (u - cu)[:, None, None]                           # [g, 1, 1]
        wv = (v - cv)[None, :, None]                           # [1, g, 1]
        r1 = r + 1
        e00 = spec.offsets[s] + cu[:, None] * r1 + cv[None, :]  # [g, g]
        p00, p01 = table[e00], table[e00 + 1]
        p10, p11 = table[e00 + r1], table[e00 + r1 + 1]
        feats.append((p00 * (1 - wu) + p10 * wu) * (1 - wv)
                     + (p01 * (1 - wu) + p11 * wu) * wv)       # [g, g, F]
    return feats


def _broadcast_plane(s_mod: int, pf: torch.Tensor) -> torch.Tensor:
    """[g_u, g_v, F] plane grid -> a view broadcastable to [g, g, g, F]."""
    if s_mod == 0:                                             # (x, y)
        return pf[:, :, None, :]
    if s_mod == 1:                                             # (x, z)
        return pf[:, None, :, :]
    return pf[None, :, :, :]                                   # (y, z)


def triplane_lattice_encode(spec: TriPlaneSpec, table: torch.Tensor,
                            axes: torch.Tensor) -> torch.Tensor:
    """Tri-plane encoding of the separable lattice of axes [3, g] ->
    [g, g, g, L*F], the pointwise encoding of its meshgrid up to the sum
    order (coslam_tpu.ops.triplane.triplane_lattice_encode)."""
    g = axes.shape[1]
    feats = _plane_grid_feats(spec, table, axes)
    levels = []
    for lvl in range(spec.pyr_levels):
        acc = 0.0
        for s_mod in range(3):
            acc = acc + _broadcast_plane(s_mod, feats[3 * lvl + s_mod])
        levels.append(acc.expand(g, g, g, spec.n_features))
    return torch.cat(levels, dim=-1)
