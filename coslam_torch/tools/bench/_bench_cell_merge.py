"""Predicated pair-merge for the cell row accumulate, on the card.

Counterpart of tools/bench/_bench_cell_merge.py (K5 `_kernel_base`, K6
`_kernel_merged`): 524,288 updates of W = 8 (4 corners x F = 2) into
98,304 rows (+ the slack row), on a "random" index stream and on a
"runs" stream of 1-5 long runs of equal indices (the JAX probe's numpy
streams). "base" is kernel P on 8 f32 streams, one row per update;
"merged" is the torch pre-pass that merges each adjacent pair (2i, 2i+1)
hitting one row, then kernel R (one row per pair, a second predicated on
take2), also timed alone; all with float4 atomics; and the plain
versions of P and R. Every variant is held to the plain version within
the sum-order bound and raises beyond it. Prints the adjacent-pair
duplicate fraction, ms, M upd/s and the speedup, after holding merged to
base at rtol 1e-4, atol 1e-3 as the JAX probe does;
then the bound of the accumulate and of R on its merged inputs, and the
time of index_add_ on the same updates.

    python -m coslam_torch.tools.bench._bench_cell_merge [--quick]
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import probe_accum as PA
from . import _common as C

ROWS, N, WIDTH = 96 * 1024, 512 * 1024, 8
SMALL = (512, 4096)


def streams(rows: int, n: int):
    """The probe's index streams, as it makes them: ("random", "runs")."""
    rng = np.random.default_rng(0)
    reps = rng.integers(1, 6, size=n)                  # 1..5
    base_ids = rng.integers(0, rows, size=n)
    run_idx = np.repeat(base_ids, reps)[:n].astype(np.int32)
    return {"random": base_ids.astype(np.int32), "runs": run_idx}


def merged(idx, vals, rows: int):
    """The pre-pass, then kernel R."""
    return PA.probe_accum_pair_merged(*PA.merge_pairs(idx, vals), rows + 1)


def run(device, quick: bool = False, small: bool = False,
        timed: bool = True) -> dict:
    """base and merged on both streams, against the plain version and
    each other (and timed); prints the lines, returns {stream: results}."""
    rows, n = SMALL if small else (ROWS, N)
    vals = C.normal_streams(np.random.default_rng(1), WIDTH, n, device)
    out = {}
    for name, ids_np in streams(rows, n).items():
        dup = float(np.mean(ids_np[0::2] == ids_np[1::2]))
        idx = C.tensor(ids_np, device)
        ref = PA.probe_accum_ref(idx, vals.T, rows + 1)
        pairs = PA.merge_pairs(idx, vals)
        res = C.run_variants(
            {"base": lambda: PA.probe_accum(idx, vals, rows + 1, vec=4),
             "merged": lambda: merged(idx, vals, rows),
             "R alone": lambda: PA.probe_accum_pair_merged(*pairs,
                                                           rows + 1),
             "plain": lambda: PA.probe_accum_ref(idx, vals.T, rows + 1),
             "plain R": lambda: PA.pair_merged_ref(*pairs, rows + 1)},
            ref, C.sum_order_tol(idx, vals.T, rows + 1), timed, quick)
        torch.testing.assert_close(res["merged"]["out"], res["base"]["out"],
                                   rtol=1e-4, atol=1e-3)
        line = (f"{name}: dup_pair_frac={dup:.2f}  "
                + "  ".join(C.describe(k, r, n) for k, r in res.items()))
        if timed:
            line += (f"  speedup {res['base']['ms'] / res['merged']['ms']:.2f}x"
                     f" (R alone {res['base']['ms'] / res['R alone']['ms']:.2f}x)")
        print(line, flush=True)
        n2, taken = n // 2, int(pairs[1].sum())
        n_out = (rows + 1) * WIDTH
        bounds = {"the accumulate": C.accum_bound(n, WIDTH, n_out),
                  "R's inputs": C.bound(12 * n2 + 4 * WIDTH * (n2 + taken)
                                        + 4 * n_out, WIDTH * (n2 + taken))}
        buf = torch.zeros_like(ref)
        library = (C.time_ms(lambda: buf.index_add_(0, idx, vals.T), quick)
                   if timed else None)
        print(C.bound_line(bounds, library), flush=True)
        out[name] = {"dup_pair_frac": dup, **res, "bounds": bounds,
                     "library_ms": library}
    return out


def main(argv=None) -> dict:
    args = C.parse(argv, __doc__)
    device = C.cuda_device()
    print(C.card_line(), flush=True)
    return run(device, quick=args.quick)


if __name__ == "__main__":
    main()
