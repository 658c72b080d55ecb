"""Pair-scatter launch tuning at Replica and TUM scale, on the card.

Counterpart of tools/bench/_bench_chunk_tune.py (K7, the pair-scatter
closure `kernel`): M in {401,408; 1,859,584} updates of the pair form
(F = 2) into 65,700 rows (+ 2 slack rows), idx clipped to [0, 65,700]
as the JAX probe does. The TPU's (chunk, unroll) sweep, which set its
per-grid-step overhead, becomes kernel P's (threads per block,
updates per thread), which set the per-launch and per-thread overhead
here; float2 atomics. Every setting is held to the plain version within
the sum-order bound and raises beyond it. Prints ms, M upd/s and the
largest difference for each setting and for the plain version, and the
bound at each M.

    python -m coslam_torch.tools.bench._bench_chunk_tune [--quick]
"""

from __future__ import annotations

import numpy as np

from ...ops import probe_accum as PA
from . import _common as C

ROWS = 65_700
MS = (401_408, 1_859_584)
THREADS, UPT = (128, 256, 512), (1, 2, 4, 8, 16)
QUICK = ((256, 4),)
SMALL = (300, (1024, 2048))


def run(device, quick: bool = False, small: bool = False,
        timed: bool = True) -> dict:
    """Every setting at each M once against the plain version (and
    timed); prints the lines, returns {(m, threads, upt): result}."""
    rows, ms = SMALL if small else (ROWS, MS)
    settings = QUICK if quick else [(t, u) for t in THREADS for u in UPT]
    out = {}
    for m in ms[-1:] if quick else ms:
        rng = np.random.default_rng(0)
        idx = C.tensor(rng.integers(0, rows - 2, m).astype(np.int32), device)
        idx = idx.clamp(0, rows)
        streams = C.normal_streams(rng, 4, m, device)
        ref = PA.probe_accum_ref(idx, streams.T, rows + 2, stride=2)
        calls = {(m, t, u): (lambda t=t, u=u: PA.probe_accum(
                     idx, streams, rows + 2, stride=2, vec=2, upt=u,
                     threads=t))
                 for t, u in settings}
        calls[(m, "plain", 0)] = lambda: PA.probe_accum_ref(
            idx, streams.T, rows + 2, stride=2)
        res = C.run_variants(
            calls, ref, C.sum_order_tol(idx, streams.T, rows + 2, stride=2),
            timed, quick)
        for (m_, t, u), r in res.items():
            what = (f"threads={t:3d} upt={u:2d}:" if u else "plain:")
            print(C.describe(f"M={m_ / 1e6:5.2f}M {what}", r, m_), flush=True)
        print(C.bound_line({f"M={m}": C.accum_bound(m, 4, (rows + 2) * 2)}),
              flush=True)
        out.update(res)
    return out


def main(argv=None) -> dict:
    args = C.parse(argv, __doc__)
    device = C.cuda_device()
    print(C.card_line(), flush=True)
    return run(device, quick=args.quick)


if __name__ == "__main__":
    main()
