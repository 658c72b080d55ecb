"""Pair-scatter variants at BA scale, on the card.

Counterpart of tools/bench/_bench_scatter_variants.py (K10
`_kernel_tuned` and `_kernel_packed_bf16`): 6,340,608 updates of the pair
form (F = 2: rows idx and idx + 1 of a [65,536 + 2, 2] table, idx in
[0, 65,534)) with kernel P on 4 f32 streams: "shipped", the counterpart
of the shipped pair scatter (one thread per update, scalar atomics, as
kernel B adds K2's rows), and "tuned" settings of (threads per block,
updates per thread) with float2 atomics; kernel Q on 2 streams of packed
bf16 words; and the plain versions of both. Every variant is held to
the plain version of its own values within the sum-order bound and raises
beyond it. Prints ms, M upd/s, and each variant's largest difference from
"shipped" over the first 65,536 rows (the JAX probe's err; bf16 against
the f32 result), and the bound of the f32 and the bf16 form (no single
PyTorch call adds pairs of rows).

    python -m coslam_torch.tools.bench._bench_scatter_variants [--quick]
"""

from __future__ import annotations

import numpy as np

from ...ops import probe_accum as PA
from . import _common as C
from ._bench_row_rates import pack_streams

N_ROWS = 64 * 1024
M = -(-6_340_608 // 16384) * 16384
TUNED = ((256, 1), (256, 4), (512, 4), (512, 8), (128, 16))
PACKED = ((256, 1), (512, 8))
SMALL = (256, 8192)


def variants(idx, streams, words, n_rows: int, quick: bool) -> dict:
    """{label: call}; each returns the [n_rows + 2, 2] table."""
    out_rows = n_rows + 2
    tuned = TUNED[1:2] if quick else TUNED
    packed = PACKED[:1] if quick else PACKED
    res = {"shipped": lambda: PA.probe_accum(idx, streams, out_rows,
                                             stride=2)}
    for t, u in tuned:
        res[f"tuned t={t} u={u}"] = (
            lambda t=t, u=u: PA.probe_accum(idx, streams, out_rows, stride=2,
                                            vec=2, upt=u, threads=t))
    for t, u in packed:
        res[f"packed-bf16 t={t} u={u}"] = (
            lambda t=t, u=u: PA.probe_accum_bf16x2(
                idx, words, out_rows, stride=2, vec=2, upt=u, threads=t))
    res["plain"] = lambda: PA.probe_accum_ref(idx, streams.T, out_rows,
                                              stride=2)
    res["plain bf16"] = lambda: PA.probe_accum_ref(
        idx, PA.unpack_bf16x2(words.T.contiguous()), out_rows, stride=2)
    return res


def run(device, quick: bool = False, small: bool = False,
        timed: bool = True) -> dict:
    """Every variant once against the plain version (and timed), then its
    err against "shipped"; "shipped" against the plain version. Prints the
    lines, returns {label: result}."""
    n_rows, m = SMALL if small else (N_ROWS, M)
    out_rows = n_rows + 2
    rng = np.random.default_rng(0)
    idx = C.tensor(rng.integers(0, n_rows - 2, m).astype(np.int32), device)
    streams = C.normal_streams(rng, 4, m, device)
    words = pack_streams(streams)
    calls = variants(idx, streams, words, n_rows, quick)
    unpacked = PA.unpack_bf16x2(words.T.contiguous())
    as_bf16 = (PA.probe_accum_ref(idx, unpacked, out_rows, stride=2),
               C.sum_order_tol(idx, unpacked, out_rows, stride=2))
    plain = PA.probe_accum_ref(idx, streams.T, out_rows, stride=2)
    res = C.run_variants(
        calls, plain, C.sum_order_tol(idx, streams.T, out_rows, stride=2),
        timed, quick, held_to={k: as_bf16 for k in calls if "bf16" in k})
    shipped = res["shipped"]["out"]
    for label, r in res.items():
        if label != "shipped":
            r["err"] = C.max_err(r["out"][:n_rows], shipped[:n_rows])
    for label, r in res.items():
        what = {"shipped": "err vs plain"}.get(label, "err vs shipped")
        print(C.describe(label, r, m).replace("err", what), flush=True)
    n_out = (n_rows + 2) * 2
    bounds = {"f32": C.accum_bound(m, 4, n_out),
              "packed-bf16": C.accum_bound(m, 4, n_out, 2)}
    print(C.bound_line(bounds), flush=True)
    return {**res, "bounds": bounds}


def main(argv=None) -> dict:
    args = C.parse(argv, __doc__)
    device = C.cuda_device()
    print(C.card_line(), flush=True)
    return run(device, quick=args.quick)


if __name__ == "__main__":
    main()
