"""Tri-plane pyramid layout shared by the factorized encodings (PyTorch port).

Counterpart of coslam_tpu/ops/triplane.py for what TensoVM needs: the
spec (a pyramid of dense (r+1)^2 planes, three sections per level, all in
one logical [T, F] table) and the projection of a point onto a section's
bilinear cell. The JAX spec's packed-storage fields (``row_offsets``,
``n_rows``, ``total_rows``) address the TPU's window mirror and have no
counterpart here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

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

