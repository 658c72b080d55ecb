"""Input encodings of the port: the hash grids, TensoVM, the tri-planes,
OneBlob, frequency, spherical harmonics and identity.

Counterpart of coslam_tpu/ops/encodings.py; every name its make_encoder
routes is routed here. The hash grid comes in two layouts, picked
by ``grad_impl`` as in the JAX package: the packed z-linear layout
(``auto``/``packed``, ops/hash_packed.py) and the XOR-hash layout of
Instant-NGP and tiny-cuda-nn (``pallas``/``scatter``/``onehot``), whose
static layout and plain forward live here and whose kernels and autograd
Function live in ops/hash_pallas.py. TensoVM lives in ops/tensovm.py,
the tri-plane in ops/triplane.py; TriPlaneHybrid concatenates a
3-level dense packed grid and a tri-plane pyramid.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from . import hash_packed as HP
from . import tensovm as VM
from . import triplane as TP

# Instant-NGP spatial-hash primes of the XOR hash, for x, y and z.
_PRIMES = (1, 2654435761, 805459861)

# The XOR grid's table-gradient modes: K4 ('pallas') sums every row in a
# fixed order; XLA's scatter-add ('scatter') and the one-hot product
# ('onehot') are atomic on a GPU.
XOR_GRAD_IMPLS = {"pallas": True, "scatter": False, "onehot": False}


@dataclass(frozen=True)
class HashGridSpec:
    """Static layout of the XOR-hash multiresolution grid (the fields of
    coslam_tpu.ops.encodings.HashGridSpec): dense levels hold (res+1)^3
    rows, hashed levels exactly 2^S, all in one [T, F] table."""

    n_levels: int
    n_features: int
    base_resolution: int
    log2_hashmap_size: int
    desired_resolution: int
    resolutions: Tuple[int, ...]      # per-level grid resolution
    offsets: Tuple[int, ...]          # per-level start row in the table
    hashed: Tuple[bool, ...]          # per-level dense vs hashed
    total_entries: int                # rows total

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def make_hashgrid_spec(desired_resolution: int, log2_hashmap_size: int = 19,
                       n_levels: int = 16, n_features: int = 2,
                       base_resolution: int = 16,
                       dense_only: bool = False) -> HashGridSpec:
    """per_level_scale = exp2(log2(desired/base)/(L-1)); a level is dense
    when (res+1)^3 fits the 2^S budget, or always with dense_only
    (coslam_tpu.ops.encodings.make_hashgrid_spec)."""
    if n_levels > 1:
        growth = math.exp2(
            math.log2(desired_resolution / base_resolution) / (n_levels - 1))
    else:
        growth = 1.0
    max_hash = 2 ** log2_hashmap_size
    resolutions, offsets, hashed = [], [], []
    off = 0
    for lvl in range(n_levels):
        res = max(int(math.floor(base_resolution * growth ** lvl)), 1)
        n_dense = (res + 1) ** 3
        use_hash = (not dense_only) and (n_dense > max_hash)
        resolutions.append(res)
        offsets.append(off)
        hashed.append(use_hash)
        off += max_hash if use_hash else n_dense
    return HashGridSpec(
        n_levels=n_levels, n_features=n_features,
        base_resolution=base_resolution,
        log2_hashmap_size=log2_hashmap_size,
        desired_resolution=desired_resolution,
        resolutions=tuple(resolutions), offsets=tuple(offsets),
        hashed=tuple(hashed), total_entries=off)


def init_hashgrid(spec: HashGridSpec, generator: torch.Generator,
                  device=None) -> torch.Tensor:
    """Uniform(-1e-4, 1e-4) table init (tiny-cuda-nn default), drawn on
    the generator's device and moved to ``device``."""
    u = torch.rand((spec.total_entries, spec.n_features), generator=generator,
                   device=generator.device)
    return ((u * 2.0 - 1.0) * 1e-4).to(device or generator.device)


# The plain versions keep the point axis innermost ([L, 8, N] as in the
# JAX forward): CPU broadcasts over short inner axes are slow. Corner c is
# (c >> 2, (c >> 1) & 1, c & 1) on (x, y, z).

def _corner_bits(device) -> torch.Tensor:
    return torch.tensor([[(c >> 2) & 1, (c >> 1) & 1, c & 1]
                         for c in range(8)], device=device)       # [8, 3]


def _cells_and_weights(spec: HashGridSpec, x: torch.Tensor):
    """x [N, 3] -> (cell int64 [L, 3, N], w [L, 3, N]): pos = res *
    clip(x, 0, 1), cell = floor(pos), w = pos - cell. No clamp of the cell
    to res - 1 (the packed layout's rule): at x = 1 the cell is res, w is
    0 and both corners clamp to res."""
    res = torch.tensor(spec.resolutions, dtype=x.dtype, device=x.device)
    pos = res[:, None, None] * x.clamp(0.0, 1.0).T[None]
    cell = pos.floor()
    return cell.long(), pos - cell


def _corner_indices(spec: HashGridSpec, cell: torch.Tensor) -> torch.Tensor:
    """Table rows of the 8 corners [L, 8, N] of cell [L, 3, N], corners
    clamped to [0, res] (coslam_tpu.ops.encodings._corner_indices, point
    axis innermost). Dense levels: (x (r+1) + y) (r+1) + z; hashed levels:
    (x ^ y P1 ^ z P2) & (2^S - 1), taken in int64 and masked: the same bits
    as the uint32 wrap of the JAX and CUDA versions, because the mask
    keeps fewer than 32 bits."""
    dev = cell.device
    resi = torch.tensor(spec.resolutions, device=dev)[:, None, None, None]
    coords = torch.minimum(cell[:, None] + _corner_bits(dev)[None, :, :, None],
                           resi)                                   # [L, 8, 3, N]
    cx, cy, cz = coords.unbind(2)
    r1 = resi[..., 0] + 1
    dense = (cx * r1 + cy) * r1 + cz
    hashed = ((cx * _PRIMES[0]) ^ (cy * _PRIMES[1]) ^ (cz * _PRIMES[2])
              ) & (2 ** spec.log2_hashmap_size - 1)
    is_hashed = torch.tensor(spec.hashed, device=dev)[:, None, None]
    offs = torch.tensor(spec.offsets, device=dev)[:, None, None]
    return torch.where(is_hashed, hashed, dense) + offs


def _corner_weights(w: torch.Tensor) -> torch.Tensor:
    """Trilinear corner weights [L, 8, N] from w [L, 3, N]: cw_x cw_y cw_z
    in that order, each cw a select of w or 1 - w (so no fused
    multiply-add can move a bit)."""
    bits = _corner_bits(w.device)[None, :, :, None] == 1           # [1, 8, 3, 1]
    cw = torch.where(bits, w[:, None], 1.0 - w[:, None])           # [L, 8, 3, N]
    return cw[:, :, 0] * cw[:, :, 1] * cw[:, :, 2]


def _hash_corners_and_weights(spec: HashGridSpec, x: torch.Tensor):
    """(corner rows [L, 8, N], weights [L, 8, N]) of x [N, 3]: the
    level-major update order of the table gradient
    (coslam_tpu.ops.encodings._hash_corners_and_weights, transposed as
    coslam_tpu.ops.hash_pallas's backward lays its streams out)."""
    cell, w = _cells_and_weights(spec, x)
    return _corner_indices(spec, cell), _corner_weights(w)


def hashgrid_encode(spec: HashGridSpec, table: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """Plain XOR-hash grid encode (coslam_tpu.ops.encodings
    .hashgrid_encode in f32): x [N, 3] -> [N, L*F], column l*F + f."""
    idx, weight = _hash_corners_and_weights(spec, x)
    feats = table.T.index_select(1, idx.reshape(-1)).view(-1, *idx.shape)
    out = (feats * weight).sum(2)                                  # [F, L, N]
    return out.permute(2, 1, 0).reshape(x.shape[0], -1)


def _quartic_cdf(u: torch.Tensor) -> torch.Tensor:
    """CDF of the quartic kernel 15/16 (1-u^2)^2 on [-1, 1] (tiny-cuda-nn's
    OneBlob surrogate for the Gaussian CDF)."""
    uc = u.clamp(-1.0, 1.0)
    cdf = 0.5 + (15.0 / 16.0) * (uc - (2.0 / 3.0) * uc ** 3
                                 + (1.0 / 5.0) * uc ** 5)
    return torch.where(u < -1.0, torch.zeros_like(cdf),
                       torch.where(u > 1.0, torch.ones_like(cdf), cdf))


def oneblob_encode(x: torch.Tensor, n_bins: int = 16) -> torch.Tensor:
    """OneBlob: each scalar of x [N, D] in [0, 1] becomes the mass a
    quartic kernel (sigma = 1/n_bins) centred at it puts in each of
    n_bins bins. Returns [N, D * n_bins], bins minor."""
    edges = torch.arange(n_bins + 1, dtype=x.dtype, device=x.device) / n_bins
    u = (edges - x[..., None]) * n_bins                  # [N, D, B+1]
    cdf = _quartic_cdf(u)
    return (cdf[..., 1:] - cdf[..., :-1]).reshape(x.shape[0], -1)


def freq_encode(x: torch.Tensor, n_frequencies: int = 12) -> torch.Tensor:
    """NeRF frequency encoding [sin, cos](2^k pi x): x [N, D] ->
    [N, D * n_frequencies * 2], per coordinate the sines then the cosines
    (coslam_tpu.ops.encodings.freq_encode)."""
    freqs = (2.0 ** torch.arange(n_frequencies, dtype=x.dtype,
                                 device=x.device)) * math.pi
    ang = x[..., None] * freqs                            # [N, D, K]
    return torch.cat([ang.sin(), ang.cos()], -1).reshape(x.shape[0], -1)


def sh_encode(d: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real spherical-harmonics basis of the directions d [N, 3]
    (normalized here) up to ``degree`` (<= 4): [N, degree**2], the bands
    and constants of coslam_tpu.ops.encodings.sh_encode."""
    if degree > 4:
        raise NotImplementedError("SH degree > 4")
    d = d / d.norm(dim=-1, keepdim=True).clamp_min(1e-8)
    x, y, z = d.unbind(-1)
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree > 1:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree > 2:
        xy, yz, xz = x * y, y * z, x * z
        x2, y2, z2 = x * x, y * y, z * z
        out += [1.0925484305920792 * xy, -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525251999,
                -1.0925484305920792 * xz, 0.54627421529603959 * (x2 - y2)]
    if degree > 3:
        out += [0.59004358992664352 * y * (-3.0 * x2 + y2),
                2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * z2),
                0.3731763325901154 * z * (5.0 * z2 - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * z2),
                1.4453057213202769 * z * (x2 - y2),
                0.59004358992664352 * x * (-x2 + 3.0 * y2)]
    return torch.stack(out, -1)


def make_encoder(encoding: str, input_dim: int = 3, degree: int = 4,
                 n_bins: int = 16, n_frequencies: int = 12,
                 n_levels: int = 16, level_dim: int = 2,
                 base_resolution: int = 16, log2_hashmap_size: int = 19,
                 desired_resolution: int = 512, grad_impl: str = "auto"):
    """(init_fn(generator, device) -> params | None, apply_fn(params, x),
    out_dim, spec), routed by case-insensitive substring as
    coslam_tpu.ops.encodings.make_encoder, in its order: 'HashGrid' and
    'Dense' (4 dense levels) or 'Tiled'; 'TensoVM' (params {'planes',
    'lines'}), 'TriPlaneHybrid' (params {'dense', 'planes'}: 3 dense
    packed levels from resolution 16 to min(resolution, 44) and a
    tri-plane pyramid; spec (dense spec, plane spec)) and 'TriPlane'
    (one plane table), each pyramid at most 8 levels of ``level_dim``
    features; then 'SphericalHarmonics', 'OneBlob', 'Frequency' and
    'Identity'. The grids' grad_impl routes as the JAX package's
    _grid_apply_fn: 'auto'/'packed' to the packed layout,
    'pallas'/'scatter'/'onehot' to the XOR hash, whose table gradient is
    deterministic for 'pallas' and atomic otherwise."""
    name = encoding.lower()
    dense = "dense" in name
    if dense or "hash" in name or "tiled" in name:
        kw = dict(n_levels=4 if dense else n_levels, n_features=level_dim,
                  base_resolution=base_resolution, dense_only=dense)
        if grad_impl in ("auto", "packed"):
            spec = HP.make_packed_spec(desired_resolution, log2_hashmap_size,
                                       **kw)
            return (lambda gen, device: HP.init_packed(spec, gen, device),
                    lambda p, x: HP.encode(spec, p, x), spec.out_dim, spec)
        if grad_impl not in XOR_GRAD_IMPLS:
            raise ValueError(f"unknown grid.grad_impl {grad_impl!r}")
        from . import hash_pallas

        spec = make_hashgrid_spec(desired_resolution, log2_hashmap_size, **kw)
        det = XOR_GRAD_IMPLS[grad_impl]
        return (lambda gen, device: init_hashgrid(spec, gen, device),
                lambda p, x: hash_pallas.encode(spec, p, x, det),
                spec.out_dim, spec)
    pyramid = dict(n_levels=min(n_levels, 8), n_features=level_dim)
    if "vm" in name:
        spec = VM.make_tensovm_spec(desired_resolution, **pyramid)
        return (lambda gen, device: VM.init_tensovm(spec, gen, device),
                lambda p, x: VM.encode(spec, p, x), spec.out_dim, spec)
    if "hybrid" in name:
        # The dense top level is capped at 44 (45^3 rows), the JAX
        # package's choice for its scatter kernel's accumulator.
        dspec = HP.make_packed_spec(min(desired_resolution, 44),
                                    log2_hashmap_size, n_levels=3,
                                    n_features=level_dim, base_resolution=16,
                                    dense_only=True)
        pspec = TP.make_triplane_spec(desired_resolution, **pyramid)

        def hybrid_init(gen, device):
            return {"dense": HP.init_packed(dspec, gen, device),
                    "planes": TP.init_triplane(pspec, gen, device)}

        def hybrid_apply(p, x):
            return torch.cat([HP.encode(dspec, p["dense"], x),
                              TP.encode(pspec, p["planes"], x)], -1)

        return (hybrid_init, hybrid_apply, dspec.out_dim + pspec.out_dim,
                (dspec, pspec))
    if "plane" in name:
        spec = TP.make_triplane_spec(desired_resolution, **pyramid)
        return (lambda gen, device: TP.init_triplane(spec, gen, device),
                lambda p, x: TP.encode(spec, p, x), spec.out_dim, spec)
    if "spherical" in name:
        return (lambda gen, device: None, lambda p, x: sh_encode(x, degree),
                degree ** 2, None)
    if "blob" in name:
        return (lambda gen, device: None,
                lambda p, x: oneblob_encode(x, n_bins),
                input_dim * n_bins, None)
    if "freq" in name:
        return (lambda gen, device: None,
                lambda p, x: freq_encode(x, n_frequencies),
                input_dim * n_frequencies * 2, None)
    if "identity" in name:
        return (lambda gen, device: None, lambda p, x: x, input_dim, None)
    raise ValueError(f"Unknown encoding: {encoding}")
