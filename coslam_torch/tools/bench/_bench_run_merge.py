"""Run-merging in the row accumulate, on realistic ray-ordered streams,
on the card.

Counterpart of tools/bench/_bench_run_merge.py (K11 `_merge_kernel`, K12
`_skip_kernel`): the cell-index streams of 2,304 rays x 27 samples
projected onto one plane section at r in {140, 311} (r^2 rows, W = 8;
``make_stream`` as the JAX probe makes them), where consecutive samples
of a ray often land in one cell. "shipped" is the port's row accumulate
(kernel F, atomic; kernel H, deterministic); "merge" is kernel S (kernel
P with its clip rule, as F: each run of equal adjacent idx inside a warp
summed by shuffles and added once); "skip" is kernel V (the segmented
suffix scan and the skip of its sentinels in one launch); "skip (scan +
P)" is the route V replaced, the torch scan (``run_merge_outside``) and
kernel P, which skips the sentinels; "plain" is S's plain version
(index_add_). Every variant is held to shipped F within the sum-order
bound and raises beyond it. Prints the adjacent-duplicate fraction and
run lengths, each variant's largest difference from shipped F, ms
(CUDA events around back-to-back calls, the host's cost included), M
upd/s and speedup; S's and V's ms on the card alone (a CUDA graph of the
calls, their zero fill included); the bound, index_add_ into a zeroed
buffer (events and graph) and torch.zeros + index_add_ (graph: the same
work as S and V with their zero fill); and, from a host model of the
kernels (``probe_accum.warp_runs``, the stream's runs), the rows of
atomics S and V should issue against one per update.

    python -m coslam_torch.tools.bench._bench_run_merge [--quick]
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import probe_accum as PA
from ...ops import serial_scatter as SS
from ..kernel_times import graph_ms
from . import _common as C

W = 8          # 4 corners x F=2, the cell-scatter width
RS = (140, 311)
SMALL_RAYS = 64


def make_stream(r: int, n_rays=2304, n_uniform=16, n_range=11,
                bound_m=6.0, range_d_m=0.1, seed=0):
    """Project depth-guided ray samples onto one plane section at
    resolution r, exactly as ops/plane_quad._cell_project does, and
    return the flattened ray-ordered cell-index stream + value matrix."""
    rng = np.random.default_rng(seed)
    # Rays: origin near one face, direction into the box.
    o = rng.uniform(0.2, 0.8, (n_rays, 1, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depth = rng.uniform(0.5, 3.0, (n_rays, 1)).astype(np.float32)
    zu = np.sort(rng.uniform(0.05, 4.0, (n_rays, n_uniform)), axis=1)
    zr = depth + np.sort(
        rng.uniform(-range_d_m, range_d_m, (n_rays, n_range)), axis=1)
    # merge-sorted like render_rays
    z = np.sort(np.concatenate([zu, zr], axis=1), axis=1)   # [R, S]
    pts = o + z[..., None] * d[:, None, :] / bound_m        # normalized
    pts = np.clip(pts, 0.0, 1.0).reshape(-1, 3)
    u = np.clip((pts[:, 0] * r).astype(np.int64), 0, r - 1)
    v = np.clip((pts[:, 1] * r).astype(np.int64), 0, r - 1)
    idx = (u * r + v).astype(np.int32)
    vals = rng.normal(size=(idx.shape[0], W)).astype(np.float32)
    return idx, vals


def skip_scan_p(idx, vals, rows: int):
    """The route kernel V replaced: the suffix scan in torch, then kernel
    P skipping the sentinel rows + 1."""
    s_idx, s_vals = PA.run_merge_outside(idx, vals, rows)
    return PA.probe_accum(s_idx, s_vals, rows + 1, rows=True, vec=4)


def run(device, quick: bool = False, small: bool = False,
        timed: bool = True) -> dict:
    """Every variant at both resolutions once against shipped F (and
    timed); prints the lines, returns {r: results}."""
    out = {}
    for r in RS:
        idx_np, vals_np = make_stream(r, n_rays=SMALL_RAYS if small
                                      else 2304)
        rows = r * r
        m = idx_np.shape[0]
        dup = float(np.mean(idx_np[1:] == idx_np[:-1]))
        runs = np.diff(np.flatnonzero(
            np.concatenate([[True], idx_np[1:] != idx_np[:-1], [True]])))
        print(f"r={r}: M={m}, adjacent-dup={dup:.3f}, "
              f"mean run={runs.mean():.2f}, "
              f"p95 run={np.percentile(runs, 95):.0f}, "
              f"max run={runs.max()}", flush=True)
        idx, vals = C.tensor(idx_np, device), C.tensor(vals_np, device)
        calls = {"shipped F": lambda: SS.row_accum(idx, vals, rows, False),
                 "shipped H": lambda: SS.row_accum(idx, vals, rows, True)}
        calls["merge"] = lambda: PA.probe_accum_run_merge(idx, vals,
                                                          rows + 1)
        calls["skip"] = lambda: PA.probe_accum_run_skip(idx, vals, rows + 1)
        calls["skip (scan + P)"] = lambda: skip_scan_p(idx, vals, rows)
        calls["plain"] = lambda: PA.run_merge_ref(idx, vals, rows + 1)
        base = calls["shipped F"]()
        res = C.run_variants(calls, base,
                             C.sum_order_tol(idx, vals, rows + 1), timed,
                             quick)
        line = []
        for label, x in res.items():
            text = C.describe(label, x, m)
            if timed and label != "shipped F":
                text += f" ({res['shipped F']['ms'] / x['ms']:.2f}x)"
            line.append(text)
        print("  " + "   ".join(line), flush=True)
        library = {}
        if timed:
            for label in ("merge", "skip"):
                res[label]["graph_ms"] = graph_ms(calls[label])
            buf = torch.zeros_like(base)
            add = lambda: buf.index_add_(0, idx, vals)  # noqa: E731
            library = {"library_ms": C.time_ms(add, quick),
                       "library_graph_ms": graph_ms(add),
                       "library_zeroed_ms": graph_ms(
                           lambda: torch.zeros_like(base).index_add_(
                               0, idx, vals))}
            print("  graph " + ", ".join(
                f"{label} {x['graph_ms']:.4f} ms"
                for label, x in res.items() if "graph_ms" in x)
                + f"; index_add_ {library['library_graph_ms']:.4f} ms, "
                f"torch.zeros + index_add_ "
                f"{library['library_zeroed_ms']:.4f} ms", flush=True)
        bounds = {"the accumulate": C.accum_bound(m, W, base.numel())}
        print(C.bound_line(bounds, library.get("library_ms")), flush=True)
        flushes = PA.warp_runs(idx, rows, clip=True)
        print(f"  rows of atomics (host model): S {flushes}, V {len(runs)}, "
              f"of {m} updates (S saves {100 * (1 - flushes / m):.1f} %)",
              flush=True)
        out[r] = {"adjacent_dup": dup, "flushes": flushes,
                  "skip_rows": len(runs), "m": m, **res, "bounds": bounds,
                  **library}
    return out


def main(argv=None) -> dict:
    args = C.parse(argv, __doc__)
    device = C.cuda_device()
    print(C.card_line(), flush=True)
    return run(device, quick=args.quick)


if __name__ == "__main__":
    main()
