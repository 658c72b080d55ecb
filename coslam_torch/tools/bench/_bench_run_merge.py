"""Run-merging in the row accumulate, on realistic ray-ordered streams,
on the card.

Counterpart of tools/bench/_bench_run_merge.py (K11 `_merge_kernel`, K12
`_skip_kernel`): the cell-index streams of 2,304 rays x 27 samples
projected onto one plane section at r in {140, 311} (r^2 rows, W = 8;
``make_stream`` as the JAX probe makes them), where consecutive samples
of a ray often land in one cell. "shipped" is the port's row accumulate
(kernel F, atomic; kernel H, deterministic); "merge" is kernel S
(flush-on-change over each thread's span of updates); "skip" is the
torch segmented suffix scan (``run_merge_outside``) and kernel P, which
skips the sentinel entries; "plain" is S's plain version (index_add_).
Every variant is held to shipped F within the sum-order bound and raises
beyond it. Prints the adjacent-duplicate fraction and
run lengths, each variant's largest difference from shipped F, ms,
M upd/s and speedup, the bound and index_add_'s time on the same
updates, and the rows of atomics S issues against shipped's one per
update.

    python -m coslam_torch.tools.bench._bench_run_merge [--quick]
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import probe_accum as PA
from ...ops import serial_scatter as SS
from . import _common as C

W = 8          # 4 corners x F=2, the cell-scatter width
RS = (140, 311)
SPANS = (4, 16, 64)
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


def skip_accum(idx, vals, rows: int):
    """The suffix scan, then kernel P skipping the sentinel rows + 1."""
    s_idx, s_vals = PA.run_merge_outside(idx, vals, rows)
    return PA.probe_accum(s_idx, s_vals, rows + 1, rows=True, vec=4)


def run(device, quick: bool = False, small: bool = False,
        timed: bool = True) -> dict:
    """Every variant at both resolutions once against shipped F (and
    timed); prints the lines, returns {r: results}."""
    spans = SPANS[1:2] if quick else SPANS
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
        for span in spans:
            calls[f"merge span={span}"] = (
                lambda span=span: PA.probe_accum_run_merge(
                    idx, vals, rows + 1, span=span))
        calls["skip"] = lambda: skip_accum(idx, vals, rows)
        calls["plain"] = lambda: PA.probe_accum_ref(idx, vals, rows + 1)
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
        buf = torch.zeros_like(base)
        library = (C.time_ms(lambda: buf.index_add_(0, idx, vals), quick)
                   if timed else None)
        bounds = {"the accumulate": C.accum_bound(m, W, base.numel())}
        print(C.bound_line(bounds, library), flush=True)
        flushes = {span: PA.adjacent_runs(idx, span) for span in spans}
        print("  S rows of atomics: "
              + ", ".join(f"span {s}: {f} of {m} ({100 * (1 - f / m):.1f} % "
                          "saved)" for s, f in flushes.items()), flush=True)
        out[r] = {"adjacent_dup": dup, "flushes": flushes, "m": m, **res,
                  "bounds": bounds, "library_ms": library}
    return out


def main(argv=None) -> dict:
    args = C.parse(argv, __doc__)
    device = C.cuda_device()
    print(C.card_line(), flush=True)
    return run(device, quick=args.quick)


if __name__ == "__main__":
    main()
