"""TensoVM encoding: tri-plane pyramids times 1-D line factors (PyTorch port).

Counterpart of coslam_tpu/ops/tensovm.py with the plane semantics of
coslam_tpu/ops/plane_quad.py. Per pyramid level l and feature channel,

    feature_l(x) = sum over sections s of the level of
        bilinear(P_s, u, v) * linear(V_s, w)

where section s projects x onto plane axes (u, v) = _PLANES[s % 3] and
its line factor V_s runs along the axis the plane drops,
``_LINE_AXES[s % 3]``. Planes live in one logical [Tp, F] table (the
TriPlaneSpec layout), lines in one [Tl, F] table of (r + 1)-row blocks,
three per level. The parameters are the dict ``{"planes": [Tp, F],
"lines": [Tl, F]}`` of the JAX package.

The TPU computed the plane features from a bf16 quad-window mirror, the
plane-table gradient through a cell-row accumulator (the Pallas
serial_scatter._row_kernel via plane_quad.cell_scatter_grad) or two-hot
matmuls, and the lines as two-hot matmuls. On the GPU the two CUDA
kernels in coslam_torch/csrc/tensovm_encode.cu read the corner rows of
the logical f32 tables directly:

- :func:`tensovm_encode_fwd`: kernel C, the encode forward;
- :func:`tensovm_encode_bwd`: kernel D, dplanes, dlines and/or dx.

CPU tensors take the plain versions (:func:`tensovm_encode_fwd_ref`,
:func:`tensovm_encode_bwd_ref`); CUDA tensors take the kernels or the
call raises. :class:`TensoVMEncode` asks kernel D only for what autograd
needs. The BA smoothness term is the analytic separable TV of
:func:`make_tensovm_lattice_tv`, plain tensor contractions as in the
JAX package (which runs it outside any Pallas kernel too).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _kernels
from .triplane import _PLANES, TriPlaneSpec, cell_project, make_triplane_spec

# Line axis per plane section: the coordinate axis plane (u, v) drops.
_LINE_AXES = (2, 1, 0)   # planes (0,1), (0,2), (1,2)


def make_tensovm_spec(desired_resolution: int, n_levels: int = 4,
                      n_features: int = 2,
                      base_resolution: int = 32) -> TriPlaneSpec:
    """The plane layout is a TriPlaneSpec; the line tables derive their
    layout from ``spec.resolutions`` (one (r+1)-row block per section)."""
    return make_triplane_spec(desired_resolution, n_levels=n_levels,
                              n_features=n_features,
                              base_resolution=base_resolution)


def line_total_rows(spec: TriPlaneSpec) -> int:
    return sum(r + 1 for r in spec.resolutions)


def _line_offsets(spec: TriPlaneSpec):
    """Start row of every section's line block in the flat line table."""
    offs, off = [], 0
    for r in spec.resolutions:
        offs.append(off)
        off += r + 1
    return tuple(offs)


def init_tensovm(spec: TriPlaneSpec, generator: torch.Generator,
                 device=None):
    """{'planes': U(-1e-4, 1e-4) [Tp, F], 'lines': ones [Tl, F]}, drawn on
    the generator's device and moved to ``device``. With unit lines the
    encoding starts equal to the additive tri-plane."""
    u = torch.rand((spec.total_entries, spec.n_features), generator=generator,
                   device=generator.device)
    device = device or generator.device
    return {"planes": ((u * 2.0 - 1.0) * 1e-4).to(device),
            "lines": torch.ones((line_total_rows(spec), spec.n_features),
                                device=device)}


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path, and the oracle for the kernels)
# ---------------------------------------------------------------------------

# Point axis innermost ([S, N], [F, S, N]) as in the JAX package.

def _line_project(spec: TriPlaneSpec, x: torch.Tensor):
    """x [N, 3] -> (i0 int64 [S, N], f [S, N]): the line segment of every
    (section, point) and the weight of its upper row; the line coordinate
    is clip(x) * r, the segment clipped to [0, r - 1]
    (coslam_tpu.ops.tensovm.line_eval_fwd_only)."""
    xt = x.clamp(0.0, 1.0).T
    S = spec.n_levels
    res = torch.tensor(spec.resolutions, dtype=x.dtype, device=x.device)
    resi = torch.tensor(spec.resolutions, device=x.device)[:, None]
    w = xt[[_LINE_AXES[s % 3] for s in range(S)]] * res[:, None]
    i0 = torch.minimum(w.floor().long().clamp_min(0), resi - 1)
    return i0, w - i0.to(x.dtype)


def _rows(table: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Rows e [S, N] of a [T, F] table -> [F, S, N]."""
    return table.T.index_select(1, e.reshape(-1)).view(-1, *e.shape)


class _Geometry:
    """Everything the plain forward and backward read at x: cells,
    weights, corner and line rows, and the gathered values."""

    def __init__(self, spec: TriPlaneSpec, planes, lines, x):
        dev = x.device
        self.cu, self.cv, self.wu, self.wv = cell_project(spec, x)
        r1 = torch.tensor(spec.resolutions, device=dev)[:, None] + 1
        offs = torch.tensor(spec.offsets, device=dev)[:, None]
        self.e00 = offs + self.cu * r1 + self.cv               # [S, N]
        self.e10 = self.e00 + r1
        self.p00 = _rows(planes, self.e00)                     # [F, S, N]
        self.p01 = _rows(planes, self.e00 + 1)
        self.p10 = _rows(planes, self.e10)
        self.p11 = _rows(planes, self.e10 + 1)
        i0, self.f = _line_project(spec, x)
        self.l_row = torch.tensor(_line_offsets(spec),
                                  device=dev)[:, None] + i0
        self.l0 = _rows(lines, self.l_row)
        self.l1 = _rows(lines, self.l_row + 1)
        wu, wv = self.wu, self.wv
        self.featv0 = self.p00 * (1 - wv) + self.p01 * wv       # [F, S, N]
        self.featv1 = self.p10 * (1 - wv) + self.p11 * wv
        self.plane = self.featv0 * (1 - wu) + self.featv1 * wu
        self.line = self.l0 * (1 - self.f) + self.l1 * self.f


def tensovm_encode_fwd_ref(spec: TriPlaneSpec, planes: torch.Tensor,
                           lines: torch.Tensor,
                           x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel C: x [N, 3] -> [N, L*F], column l*F + f
    (coslam_tpu.ops.tensovm.tensovm_encode_fwd_only: the plane section
    features times the line values, summed over a level's sections)."""
    geo = _Geometry(spec, planes, lines, x)
    prod = geo.plane * geo.line                                  # [F, S, N]
    F, _, n = prod.shape
    per_level = prod.view(F, spec.pyr_levels, 3, n).sum(2)
    return per_level.permute(2, 1, 0).reshape(n, -1)


def tensovm_encode_bwd_ref(spec: TriPlaneSpec, planes: torch.Tensor,
                           lines: torch.Tensor, x: torch.Tensor,
                           g: torch.Tensor, need_dplanes: bool,
                           need_dlines: bool, need_dx: bool):
    """Plain version of kernel D: the gradients of sum(encode * g).

    dplanes: the 4 corner rows of every (section, point) cell get
    ``g * line * w_corner`` (what plane_quad.quad_table_grad sums on both
    its routes); dlines: rows i0 and i0 + 1 get ``g * plane * (1-f, f)``;
    dx: the plane terms of plane_quad's custom VJP and the line term
    ``g * plane * (V[i0+1] - V[i0])`` times r, which is autodiff of the
    gather oracle (also at integer coordinates, where the TPU's two-hot
    derivative gives 0), zeroed where x lies outside [0, 1].
    Returns (dplanes [Tp, F], dlines [Tl, F], dx [N, 3]), None where not
    asked for."""
    n = x.shape[0]
    L, F = spec.pyr_levels, spec.n_features
    geo = _Geometry(spec, planes, lines, x)
    gs = g.reshape(n, L, F).permute(2, 1, 0).repeat_interleave(3, dim=1)
    gp = gs * geo.line                  # d out / d plane feature [F, S, N]
    gq = gs * geo.plane                 # d out / d line value
    wu, wv, f = geo.wu, geo.wv, geo.f
    dplanes = dlines = dx = None
    if need_dplanes:
        dp = torch.zeros((F, planes.shape[0]), dtype=planes.dtype,
                         device=planes.device)
        for e, w in ((geo.e00, (1 - wu) * (1 - wv)),
                     (geo.e00 + 1, (1 - wu) * wv),
                     (geo.e10, wu * (1 - wv)), (geo.e10 + 1, wu * wv)):
            dp.index_add_(1, e.reshape(-1), (gp * w).reshape(F, -1))
        dplanes = dp.T.contiguous()
    if need_dlines:
        dl = torch.zeros((F, lines.shape[0]), dtype=lines.dtype,
                         device=lines.device)
        dl.index_add_(1, geo.l_row.reshape(-1), (gq * (1 - f)).reshape(F, -1))
        dl.index_add_(1, (geo.l_row + 1).reshape(-1), (gq * f).reshape(F, -1))
        dlines = dl.T.contiguous()
    if need_dx:
        res = torch.tensor(spec.resolutions, dtype=x.dtype,
                           device=x.device)[:, None]
        du = (gp * (geo.featv1 - geo.featv0)).sum(0) * res       # [S, N]
        dv = (gp * ((geo.p01 - geo.p00) * (1 - wu)
                    + (geo.p11 - geo.p10) * wu)).sum(0) * res
        dw = (gq * (geo.l1 - geo.l0)).sum(0) * res
        S = spec.n_levels
        axis = lambda axes: torch.tensor(axes, device=x.device)  # noqa: E731
        dxt = torch.zeros((3, n), dtype=x.dtype, device=x.device)
        dxt.index_add_(0, axis([_PLANES[s % 3][0] for s in range(S)]), du)
        dxt.index_add_(0, axis([_PLANES[s % 3][1] for s in range(S)]), dv)
        dxt.index_add_(0, axis([_LINE_AXES[s % 3] for s in range(S)]), dw)
        dx = dxt.T * ((x >= 0.0) & (x <= 1.0)).to(x.dtype)
    return dplanes, dlines, dx


# ---------------------------------------------------------------------------
# Kernel wrappers: CPU tensors -> plain version, CUDA tensors -> kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _level_table(spec: TriPlaneSpec, device: torch.device) -> torch.Tensor:
    """int32 [3, L] (resolution, plane row and line row of the level's
    first section) on the kernel's device."""
    sec0 = range(0, spec.n_levels, 3)
    lines = _line_offsets(spec)
    arr = np.array([[spec.resolutions[s] for s in sec0],
                    [spec.offsets[s] for s in sec0],
                    [lines[s] for s in sec0]], np.int32)
    return torch.from_numpy(arr).to(device)


def _check_cuda(spec: TriPlaneSpec, planes, lines, x, *more) -> None:
    _kernels.check_tensors("tensovm encode", x.device,
                           planes=planes, lines=lines, x=x,
                           **{f"arg{i}": m for i, m in enumerate(more)})
    if x.dim() != 2 or x.shape[1] != 3:
        raise ValueError(f"tensovm encode: x must be [N, 3], got "
                         f"{tuple(x.shape)}")
    F = spec.n_features
    for name, t, rows in (("planes", planes, spec.total_entries),
                          ("lines", lines, line_total_rows(spec))):
        if tuple(t.shape) != (rows, F):
            raise ValueError(f"tensovm encode: {name} {tuple(t.shape)} does "
                             f"not match the spec ({rows}, {F})")


def tensovm_encode_fwd(spec: TriPlaneSpec, planes: torch.Tensor,
                       lines: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Encode forward: x [N, 3] (normalized) -> [N, L*F]."""
    if _kernels.on_cpu(planes, lines, x):
        return tensovm_encode_fwd_ref(spec, planes, lines, x)
    _check_cuda(spec, planes, lines, x)
    out = torch.empty((x.shape[0], spec.out_dim), device=x.device,
                      dtype=torch.float32)
    code = _kernels.library().tensovm_encode_fwd(
        x.data_ptr(), planes.data_ptr(), lines.data_ptr(), out.data_ptr(),
        x.shape[0], spec.n_features, _level_table(spec, x.device).data_ptr(),
        spec.pyr_levels, _kernels.stream(x.device))
    _kernels.check(code, "tensovm_encode_fwd")
    tensovm_encode_fwd.launches += 1
    return out


def tensovm_encode_bwd(spec: TriPlaneSpec, planes: torch.Tensor,
                       lines: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                       need_dplanes: bool, need_dlines: bool, need_dx: bool):
    """Encode backward: (dplanes, dlines, dx), None where not asked for.

    On the card, kernel D: the plane and line rows read and the plane
    gradient added as row pairs (float4/float2), the line gradient summed
    per block in shared memory after the lanes of a warp that share a row
    are summed, and dx summed over a point's levels in the block and
    stored once (so it is allocated without a zero fill)."""
    if _kernels.on_cpu(planes, lines, x, g):
        return tensovm_encode_bwd_ref(spec, planes, lines, x, g, need_dplanes,
                                      need_dlines, need_dx)
    if not (need_dplanes or need_dlines or need_dx):
        return None, None, None
    _check_cuda(spec, planes, lines, x, g)
    if tuple(g.shape) != (x.shape[0], spec.out_dim):
        raise ValueError(f"tensovm encode: g {tuple(g.shape)} is not "
                         f"[{x.shape[0]}, {spec.out_dim}]")
    dplanes = torch.zeros_like(planes) if need_dplanes else None
    dlines = torch.zeros_like(lines) if need_dlines else None
    dx = torch.empty_like(x) if need_dx else None   # every entry written
    code = _kernels.library().tensovm_encode_bwd(
        x.data_ptr(), planes.data_ptr(), lines.data_ptr(), g.data_ptr(),
        _kernels.ptr(dplanes), _kernels.ptr(dlines), _kernels.ptr(dx),
        x.shape[0], spec.n_features, _level_table(spec, x.device).data_ptr(),
        spec.pyr_levels, lines.shape[0], _kernels.stream(x.device))
    _kernels.check(code, "tensovm_encode_bwd")
    tensovm_encode_bwd.launches += 1
    return dplanes, dlines, dx


# Launch counts of the two kernels (the CPU path never adds to them).
tensovm_encode_fwd.launches = 0
tensovm_encode_bwd.launches = 0


class TensoVMEncode(torch.autograd.Function):
    """TensoVM encode with the kernel backward; the gradients asked of
    kernel D follow ``ctx.needs_input_grad``: tracking (map detached)
    gets dx only, mapping at a fixed pose dplanes and dlines, BA with pose
    optimization all three."""

    @staticmethod
    def forward(ctx, planes: torch.Tensor, lines: torch.Tensor,
                x: torch.Tensor, spec: TriPlaneSpec) -> torch.Tensor:
        ctx.spec = spec
        ctx.save_for_backward(planes, lines, x)
        return tensovm_encode_fwd(spec, planes, lines, x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        planes, lines, x = ctx.saved_tensors
        return (*tensovm_encode_bwd(ctx.spec, planes, lines, x, g.contiguous(),
                                    *ctx.needs_input_grad[:3]), None)


def encode(spec: TriPlaneSpec, params, x: torch.Tensor) -> torch.Tensor:
    """Differentiable TensoVM encode of normalized points x [N, 3];
    params = {'planes', 'lines'}."""
    return TensoVMEncode.apply(params["planes"], params["lines"],
                               x.contiguous(), spec)


# ---------------------------------------------------------------------------
# Analytic separable TV: the smoothness term in O(g^2) instead of O(g^3)
# ---------------------------------------------------------------------------

def _two_hot(w: torch.Tensor, r1: int) -> torch.Tensor:
    """Linear-interpolation matrix [.., N] -> [.., N, r1]."""
    j = torch.arange(r1, dtype=w.dtype, device=w.device)
    return (1.0 - (w[..., None] - j).abs()).clamp_min(0.0)


def _lattice_line_vals(spec: TriPlaneSpec, lines: torch.Tensor,
                       axes: torch.Tensor):
    """Per-section line values on the lattice axes: a list over sections
    of [g, F] (coslam_tpu.ops.tensovm._lattice_line_vals)."""
    ax = axes.clamp(0.0, 1.0)
    offs = _line_offsets(spec)
    vals = []
    for s in range(spec.n_levels):
        r = spec.resolutions[s]
        tab = lines[offs[s]:offs[s] + r + 1]
        w = ax[_LINE_AXES[s % 3]] * r                         # [g]
        i0 = w.floor().long().clamp(0, r - 1)
        f = (w - i0)[:, None]
        vals.append(tab[i0] * (1 - f) + tab[i0 + 1] * f)       # [g, F]
    return vals


def _plane_grid_twohot(spec: TriPlaneSpec, planes: torch.Tensor,
                       axes: torch.Tensor) -> torch.Tensor:
    """Bilinear plane grids on the separable lattice as contractions
    U_s @ table_s @ V_s^T with U/V the per-axis interpolation matrices
    (coslam_tpu.ops.tensovm._plane_grid_twohot). Returns [S, g, g, F]."""
    ax = axes.clamp(0.0, 1.0)
    out = []
    for lvl in range(spec.pyr_levels):
        r = spec.resolutions[3 * lvl]
        r1 = r + 1
        tabs, us, vs = [], [], []
        for s_mod in range(3):
            s = 3 * lvl + s_mod
            ua, va = _PLANES[s_mod]
            us.append(_two_hot(ax[ua] * r, r1))                 # [g, r1]
            vs.append(_two_hot(ax[va] * r, r1))
            tabs.append(planes[spec.offsets[s]:spec.offsets[s]
                               + spec.sizes[s]].reshape(r1, r1, -1))
        out.append(torch.einsum("sgu,suvf,shv->sghf", torch.stack(us),
                                torch.stack(tabs), torch.stack(vs)))
    return torch.cat(out, dim=0)


def _tv_dir(dA, dB, C, lA, lB, dl):
    """One axis direction of the factorized TV sum: the difference
    d[i, m, n] = dA[i, m] lA[n] + dB[i, n] lB[m] + C[m, n] dl[i] squared
    and summed as six O(g^2) terms (coslam_tpu.ops.tensovm._tv_dir)."""
    es = torch.einsum
    t11 = es("imf,imf->f", dA, dA) * es("nf,nf->f", lA, lA)
    t22 = es("inf,inf->f", dB, dB) * es("mf,mf->f", lB, lB)
    t33 = es("mnf,mnf->f", C, C) * es("if,if->f", dl, dl)
    t12 = es("if,if->f", es("imf,mf->if", dA, lB), es("inf,nf->if", dB, lA))
    t13 = es("if,imf,mf->f", dl, dA, es("mnf,nf->mf", C, lA))
    t23 = es("if,inf,nf->f", dl, dB, es("mnf,mf->nf", C, lB))
    return (t11 + t22 + t33 + 2.0 * (t12 + t13 + t23)).sum()


def make_tensovm_lattice_tv(spec: TriPlaneSpec):
    """tv(params, axes [3, g], sample_points) -> scalar: losses
    .smoothness_tv of the encoding on the lattice axes[0] x axes[1] x
    axes[2], computed from the factorization without the g^3 feature
    volume (coslam_tpu.ops.tensovm.make_tensovm_lattice_tv). The level
    feature on the lattice is A0[i,j] b0[k] + A1[i,k] b1[j] +
    A2[j,k] b2[i] (sections 3l+0/1/2, lines along z/y/x)."""

    def tv(params, axes, sample_points):
        pf = _plane_grid_twohot(spec, params["planes"], axes)  # [S,g,g,F]
        lv = _lattice_line_vals(spec, params["lines"], axes)
        total = 0.0
        for lvl in range(spec.pyr_levels):
            A0, A1, A2 = pf[3 * lvl], pf[3 * lvl + 1], pf[3 * lvl + 2]
            b0, b1, b2 = lv[3 * lvl], lv[3 * lvl + 1], lv[3 * lvl + 2]
            dx0, dx1 = A0[1:] - A0[:-1], A1[1:] - A1[:-1]
            dy0 = (A0[:, 1:] - A0[:, :-1]).transpose(0, 1)
            dy2 = A2[1:] - A2[:-1]
            dz1 = (A1[:, 1:] - A1[:, :-1]).transpose(0, 1)
            dz2 = (A2[:, 1:] - A2[:, :-1]).transpose(0, 1)
            total = total + _tv_dir(dx0, dx1, A2, b0, b1, b2[1:] - b2[:-1])
            total = total + _tv_dir(dy0, dy2, A1, b0, b2, b1[1:] - b1[:-1])
            total = total + _tv_dir(dz1, dz2, A0, b1, b2, b0[1:] - b0[:-1])
        return total / (sample_points ** 3)

    return tv
