"""Row-accumulate rate against row width and value layout, on the card.

Counterpart of tools/bench/_bench_row_rates.py (K8 `_kernel_vec`, K9
`_kernel_f32` and `_kernel_pk`): 1,048,576 updates into 65,536 rows
(+ the slack row), W in {4, 8, 16}, with kernel P on W f32 streams
(scalar, float2 and float4 atomics), kernel Q on W/2 streams of packed
bf16 words and kernel P on [M, W] rows (float4 atomics). Every variant
is held to the plain version within the sum-order bound (the bf16 ones
to the plain sum of the unpacked values) and raises beyond it. Prints, per
width, each variant's ms, M upd/s and largest difference from the plain
version (whose own time is printed as "plain", and "plain bf16" with its
unpack), the bf16 variant's largest difference from the f32 result
relative to its largest entry (the JAX probe's err), the bound of the
f32 and the bf16 form, and the time of index_add_ on the same updates.

    python -m coslam_torch.tools.bench._bench_row_rates [--quick]
"""

from __future__ import annotations

import numpy as np
import torch

from ...ops import probe_accum as PA
from . import _common as C

ROWS, M, WIDTHS = 65_536, 1_048_576, (4, 8, 16)
SMALL = (256, 4096)


def pack_streams(streams: torch.Tensor) -> torch.Tensor:
    """[W, M] f32 -> [W/2, M] int32 words of bf16 pairs (stream 2p low)."""
    return torch.stack([PA.pack_bf16x2(streams[2 * p], streams[2 * p + 1])
                        for p in range(streams.shape[0] // 2)])


def variants(idx, streams, words, rows: int, quick: bool) -> dict:
    """{label: call} of the probe's variants at one width."""
    rows2d = streams.T.contiguous()
    out_rows = rows + 1
    f32 = {f"f32 vec{v}": (lambda v=v: PA.probe_accum(idx, streams, out_rows,
                                                        vec=v))
           for v in ((1, 4) if quick else (1, 2, 4))}
    return {**f32,
            "packed-bf16 vec4": lambda: PA.probe_accum_bf16x2(
                idx, words, out_rows, vec=4),
            "plain": lambda: PA.probe_accum_ref(idx, streams.T, out_rows),
            "plain bf16": lambda: PA.probe_accum_ref(
                idx, PA.unpack_bf16x2(words.T.contiguous()), out_rows),
            "[M, W] rows vec4": lambda: PA.probe_accum(
                idx, rows2d, out_rows, rows=True, vec=4)}


def run(device, quick: bool = False, small: bool = False,
        timed: bool = True) -> dict:
    """Every variant at each width once against the plain version (and
    timed); prints the lines and returns {width: {label: result}}."""
    rows, m = SMALL if small else (ROWS, M)
    rng = np.random.default_rng(0)
    idx = C.tensor(rng.integers(0, rows, m).astype(np.int32), device)
    out = {}
    for width in ((8,) if quick else WIDTHS):
        streams = C.normal_streams(rng, width, m, device)
        words = pack_streams(streams)
        ref = PA.probe_accum_ref(idx, streams.T, rows + 1)
        unpacked = PA.unpack_bf16x2(words.T.contiguous())
        # The bf16 variants against the plain sum of the unpacked values.
        as_bf16 = (PA.probe_accum_ref(idx, unpacked, rows + 1),
                   C.sum_order_tol(idx, unpacked, rows + 1))
        res = C.run_variants(
            variants(idx, streams, words, rows, quick), ref,
            C.sum_order_tol(idx, streams.T, rows + 1), timed, quick,
            held_to={"packed-bf16 vec4": as_bf16, "plain bf16": as_bf16})
        f32 = res["f32 vec1"]["out"]
        bf16 = res["packed-bf16 vec4"]
        bf16["rel_err_vs_f32"] = C.max_err(bf16["out"], f32) / max(
            float(f32.abs().max()), 1e-9)
        print(f"width {width:2d}: "
              + "  ".join(C.describe(k, r, m) for k, r in res.items())
              + f"  (packed-bf16 vs f32 {bf16['rel_err_vs_f32']:.1e} rel)",
              flush=True)
        n_out = (rows + 1) * width
        bounds = {"f32": C.accum_bound(m, width, n_out),
                  "packed-bf16": C.accum_bound(m, width, n_out, 2)}
        buf = torch.zeros_like(ref)
        library = (C.time_ms(lambda: buf.index_add_(0, idx, streams.T), quick)
                   if timed else None)
        print(C.bound_line(bounds, library), flush=True)
        out[width] = {**res, "bounds": bounds, "library_ms": library}
    return out


def main(argv=None) -> dict:
    args = C.parse(argv, __doc__)
    device = C.cuda_device()
    print(C.card_line(), flush=True)
    return run(device, quick=args.quick)


if __name__ == "__main__":
    main()
