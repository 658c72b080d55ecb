"""The yardstick: the chip's peaks, the encode kernels' bytes and
operations at a call's shapes, and the operations of a tracking step and a
BA call counted from the configuration's shapes.

Bytes count each input byte read once and each output byte written once
(the byte model of the program's smoke test): the points, the cotangent,
the features written, and the table rows that the call's points can
reach, each counted once: eight rows a point and level (both rows of four
corner pairs), at most the level's rows. Every count comes from the
configuration's shapes (the points of each step's encode calls), never
from the program's calls, so it holds however the steps are launched.
The work is that of the function computed (a trilinear hash-grid encode
and its gradient), not of whatever kernel implements it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from . import reference

_HERE = os.path.dirname(os.path.abspath(__file__))


def peaks() -> Dict:
    with open(os.path.join(_HERE, "peaks.json")) as f:
        return json.load(f)


def level_rows(spec: reference.GridSpec) -> List[int]:
    """The table rows of each level."""
    ends = spec.offsets[1:] + (spec.total_entries,)
    return [b - a for a, b in zip(spec.offsets, ends)]


def reach_rows(spec: reference.GridSpec, n: int) -> int:
    """The table rows n points can reach: eight a point and level, at
    most the level's rows."""
    return sum(min(8 * n, r) for r in level_rows(spec))


def encode_fwd_work(spec: reference.GridSpec, n: int, rows: int):
    """(bytes, flops) of the encode forward of n points reaching ``rows``
    table rows: x read, the L*F features written, the rows read; per
    point and level 8 corners x F features, a product and a sum each, and
    the weights."""
    L, F = spec.n_levels, spec.n_features
    nbytes = 4 * (3 * n + L * F * n + F * rows)
    flops = n * L * (8 * F * 2 + 30)
    return nbytes, flops


def encode_bwd_work(spec: reference.GridSpec, n: int, rows: int,
                    need_dtable: bool, need_dx: bool):
    """(bytes, flops) of the encode backward: x and the cotangent read;
    the table gradient's rows written (table mode), the rows read and dx
    written (dx mode)."""
    L, F = spec.n_levels, spec.n_features
    nbytes = 4 * (3 * n + L * F * n)
    flops = n * L * 30
    if need_dtable:
        nbytes += 4 * F * rows
        flops += n * L * 8 * F * 2
    if need_dx:
        nbytes += 4 * (F * rows + 3 * n)
        flops += n * L * 8 * F * 4
    return nbytes, flops


def _mlp_flops(cfg: Dict, spec: reference.GridSpec) -> int:
    """Forward multiply-adds x 2 of the two MLPs for one point."""
    dec = cfg["decoder"]
    d_in = spec.n_levels * spec.n_features + 3 * int(cfg["pos"]["n_bins"])
    h, g = dec["hidden_dim"], dec["geo_feat_dim"]
    hc = dec["hidden_dim_color"]
    sdf = [d_in] + [h] * (dec["num_layers"] - 1) + [1 + g]
    col = ([3 * int(cfg["pos"]["n_bins"]) + g]
           + [hc] * (dec["num_layers_color"] - 1) + [3])
    return 2 * sum(a * b for dims in (sdf, col)
                   for a, b in zip(dims[:-1], dims[1:]))


def point_flops(cfg: Dict, spec: reference.GridSpec, param_grads: bool
                ) -> int:
    """Operations for one sample point through the encode and the MLPs,
    forward and backward: the backward's input gradient costs a forward,
    the parameters' gradient another."""
    mlp = _mlp_flops(cfg, spec)
    enc_f = encode_fwd_work(spec, 1, 0)[1]
    enc_b = encode_bwd_work(spec, 1, 0, param_grads, True)[1]
    return mlp * (3 if param_grads else 2) + enc_f + enc_b


def samples_per_ray(cfg: Dict) -> int:
    tr = cfg["training"]
    return tr["n_samples_d"] + tr["n_range_d"] + int(tr["n_importance"])


def tracking_flops(cfg: Dict, spec: reference.GridSpec) -> int:
    """One tracking step: iter x sample rays x their samples, the map
    frozen (no parameter gradients)."""
    t = cfg["tracking"]
    return (int(t["iter"]) * int(t["sample"]) * samples_per_ray(cfg)
            * point_flops(cfg, spec, False))


def ba_rays(cfg: Dict, kf_count: int) -> int:
    """The rays of a BA iteration with kf_count keyframes: the sample
    and the current frame's quota."""
    m = cfg["mapping"]
    sample = int(m["sample"])
    return sample + min(max(sample // max(kf_count, 1),
                            int(m["min_pixels_cur"])), sample)


def lattice_points(cfg: Dict) -> int:
    """The smoothness lattice's points a BA iteration encodes (0 without
    the smoothness term)."""
    tr = cfg["training"]
    if float(tr["smooth_weight"]) <= 0:
        return 0
    return (int(tr["smooth_pts"]) - 1) ** 3


def ba_flops(cfg: Dict, spec: reference.GridSpec, kf_count: int) -> int:
    """One BA call with kf_count keyframes: iters x (sample + the current
    frame's quota) rays x their samples with parameter gradients, and the
    smoothness lattice's encode forward and table gradient."""
    per_iter = (ba_rays(cfg, kf_count) * samples_per_ray(cfg)
                * point_flops(cfg, spec, True))
    per_iter += lattice_points(cfg) * (
        encode_fwd_work(spec, 1, 0)[1]
        + encode_bwd_work(spec, 1, 0, True, False)[1])
    return int(cfg["mapping"]["iters"]) * per_iter


def kf_count_at(cfg: Dict, k: int) -> int:
    """The keyframes the BA call of frame k sees: frames 0,
    keyframe_every, ... below k."""
    return (k - 1) // int(cfg["mapping"]["keyframe_every"]) + 1


def pass_points(cfg: Dict, rays: int) -> List[int]:
    """The points of each encode call of a forward over ``rays`` rays:
    the coarse pass's samples, and with an importance fine pass its new
    samples, encoded by a call of their own (the coarse samples' outputs
    are reused)."""
    tr = cfg["training"]
    calls = [rays * (int(tr["n_samples_d"]) + int(tr["n_range_d"]))]
    if int(tr["n_importance"]) > 0:
        calls.append(rays * int(tr["n_importance"]))
    return calls


def frame_encode_calls(cfg: Dict, k: int) -> List[Tuple]:
    """The encode calls of frame k's steps, as ("fwd", points) and
    ("bwd", points, table gradient?, dx?): each tracking iteration
    encodes its rays' samples (a call a pass, ``pass_points``) and takes
    dx alone (the map is frozen); each iteration of a BA call (on frames
    map_every, 2 map_every, ...) encodes its rays' samples, with the
    table gradient and dx (the poses move from two keyframes on), and the
    smoothness lattice, whose points are constants (the table gradient
    alone)."""
    t, m = cfg["tracking"], cfg["mapping"]
    calls = []
    for n in pass_points(cfg, int(t["sample"])):
        calls += [("fwd", n), ("bwd", n, False, True)]
    calls *= int(t["iter"])
    if k > 0 and k % int(m["map_every"]) == 0:
        kf = kf_count_at(cfg, k)
        it = []
        for nb in pass_points(cfg, ba_rays(cfg, kf)):
            it += [("fwd", nb), ("bwd", nb, True, kf >= 2)]
        g3 = lattice_points(cfg)
        if g3:
            it += [("fwd", g3), ("bwd", g3, True, False)]
        calls += it * int(m["iters"])
    return calls


def least_seconds(nbytes: int, flops: int, peak: Optional[Dict] = None
                  ) -> float:
    """The least time the chip could take: bytes over the HBM rate or
    float32 operations over the float32 rate, whichever is longer."""
    p = peak or peaks()
    return max(nbytes / p["hbm_bytes_per_s"], flops / p["fp32_flops_per_s"])


def encode_roofline(run, kind: str) -> Optional[float]:
    """An encode kernel's share of its roofline over a run's traced
    stretch, in %: the least time of the encode calls ("fwd": A, "bwd":
    B) of the stretch's frames, at the configuration's shapes, summed,
    over the kernel's device time summed over its launches in the
    stretch. None without a stretch or a launch."""
    st = run.stretch
    if st is None:
        return None
    dev_s = sum(st["encode_s"][kind])
    if dev_s <= 0:
        return None
    peak = peaks()
    spec = run.grid
    least = 0.0
    for k in range(st["first"], st["first"] + st["frames"]):
        for c in frame_encode_calls(run.cfg, k):
            if c[0] != kind:
                continue
            rows = reach_rows(spec, c[1])
            if kind == "fwd":
                nb, fl = encode_fwd_work(spec, c[1], rows)
            else:
                nb, fl = encode_bwd_work(spec, c[1], rows, c[2], c[3])
            least += least_seconds(nb, fl, peak)
    return 100.0 * least / dev_s
