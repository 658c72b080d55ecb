"""Input encodings of the port: the packed hash grid, TensoVM and OneBlob.

Counterpart of coslam_tpu/ops/encodings.py for the names the ported
paths use (``HashGrid`` or ``TensoVM`` for the grid, ``OneBlob`` for
coordinates). The other encodings wait for later slices and raise here.
"""

from __future__ import annotations

import torch

from . import hash_packed as HP
from . import tensovm as VM


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


def make_encoder(encoding: str, input_dim: int = 3, n_bins: int = 16,
                 n_levels: int = 16, level_dim: int = 2,
                 base_resolution: int = 16, log2_hashmap_size: int = 19,
                 desired_resolution: int = 512):
    """(init_fn(generator, device) -> params | None, apply_fn(params, x),
    out_dim, spec) for 'HashGrid' (the packed layout), 'TensoVM' (params
    {'planes', 'lines'}, at most 8 pyramid levels of ``level_dim``
    features) or 'OneBlob' (coslam_tpu.ops.encodings.make_encoder for
    those names)."""
    name = encoding.lower()
    if "hash" in name or "tiled" in name:
        spec = HP.make_packed_spec(
            desired_resolution, log2_hashmap_size, n_levels=n_levels,
            n_features=level_dim, base_resolution=base_resolution)
        return (lambda gen, device: HP.init_packed(spec, gen, device),
                lambda p, x: HP.encode(spec, p, x), spec.out_dim, spec)
    if "vm" in name:
        spec = VM.make_tensovm_spec(desired_resolution,
                                    n_levels=min(n_levels, 8),
                                    n_features=level_dim)
        return (lambda gen, device: VM.init_tensovm(spec, gen, device),
                lambda p, x: VM.encode(spec, p, x), spec.out_dim, spec)
    if "blob" in name:
        return (lambda gen, device: None,
                lambda p, x: oneblob_encode(x, n_bins),
                input_dim * n_bins, None)
    raise NotImplementedError(
        f"encoding {encoding!r} is not ported yet (HashGrid, TensoVM and "
        "OneBlob are)")
