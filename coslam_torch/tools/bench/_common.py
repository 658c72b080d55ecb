"""What the probes share: the card, CUDA-event timing, rates, inputs, and
the sum-order bound every variant is held to."""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

from ...ops import probe_accum as PA

# H100 SXM: HBM3 bytes per second, f32 operations per second outside the
# tensor cores (NVIDIA's data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take for work that moves n_bytes and
    does n_ops f32 operations, and which of the two sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def accum_bound(m: int, width: int, out_numel: int,
                value_bytes: int = 4) -> dict:
    """Bound of a row accumulate: m int32 indices and m x width values
    (``value_bytes`` each) read once, the f32 output written once, one
    add per value (and one unpack per value for bf16)."""
    return bound(4 * m + value_bytes * width * m + 4 * out_numel,
                 m * width * (1 if value_bytes == 4 else 2))


def bound_line(bounds: dict, library_ms=None) -> str:
    """``bound X ms (bytes)`` per entry, and index_add_'s time if taken."""
    text = "  bound " + ", ".join(
        f"{k} {b['bound_ms']:.4f} ms ({b['bound_by']})"
        for k, b in bounds.items())
    if library_ms is not None:
        text += f"; index_add_ {library_ms:.4f} ms"
    return text


def cuda_device() -> torch.device:
    """The first CUDA device; raises without one (a probe times the card
    and has no CPU mode)."""
    if not torch.cuda.is_available():
        raise SystemExit("this probe times the card and needs an NVIDIA "
                         "CUDA device")
    return torch.device("cuda", 0)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def parse(argv, doc: str) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=doc.splitlines()[0])
    parser.add_argument("--quick", action="store_true",
                        help="one setting per kernel (the smoke run's)")
    return parser.parse_args(argv)


def time_ms(fn, quick: bool = False) -> float:
    """ms per call of fn: CUDA events around back-to-back calls (20, or 5
    with ``quick``), divided by the count; the median of 5 (3) such
    batches after warm-up."""
    batches, per_batch = (3, 5) if quick else (5, 20)
    for _ in range(3):
        fn()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    return float(np.median(times))


def rate(m: int, ms: float) -> float:
    """Million updates per second."""
    return m / ms / 1e3


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def normal_streams(rng: np.random.Generator, n_streams: int, m: int,
                   device) -> torch.Tensor:
    """f32 [n_streams, m] unit normals."""
    return tensor(rng.standard_normal((n_streams, m), np.float32), device)


def sum_order_tol(idx: torch.Tensor, rows2d: torch.Tensor, out_rows: int,
                  stride: int | None = None) -> torch.Tensor:
    """Per output entry, the most two f32 sums of the same updates can
    differ, whatever order each adds them in (atomics, runs or pairs
    summed first, a scan): each lies within (n - 1) u sum |v| of the exact
    sum of the entry's n updates (u = 2^-24; 1 % more for the second-order
    term), so two lie within twice that. idx [M] and rows2d f32 [M, W] as
    ``probe_accum_ref`` takes them; an entry with one update or none must
    match exactly."""
    n = PA.probe_accum_ref(idx, torch.ones_like(rows2d), out_rows, stride)
    mass = PA.probe_accum_ref(idx, rows2d.abs(), out_rows, stride)
    return 2.02 * (n - 1).clamp(min=0) * 2.0 ** -24 * mass


def assert_within(label: str, got: torch.Tensor, ref: torch.Tensor,
                  tol: torch.Tensor) -> float:
    """Raise AssertionError unless |got - ref| <= tol at every entry (a NaN
    fails); returns the largest difference."""
    diff = (got.float() - ref.float()).abs()
    over = ~(diff <= tol)
    if bool(over.any()):
        raise AssertionError(
            f"{label}: {int(over.sum())} of {diff.numel()} entries differ "
            f"from the reference beyond the sum-order bound, by up to "
            f"{float((diff - tol)[over].max()):.3g}")
    return float(diff.max()) if diff.numel() else 0.0


def run_variants(variants: dict, ref: torch.Tensor, tol: torch.Tensor,
                 timed: bool, quick: bool = False,
                 held_to: dict | None = None) -> dict:
    """Each zero-argument callable of ``variants`` once, held to ``ref``
    within ``tol`` (per entry, from :func:`sum_order_tol`), or to
    ``held_to[label] = (ref, tol)`` where given: any entry beyond raises.
    Returns {label: {"out", "err" (the largest difference), "ms" (per
    call, when ``timed``)}}."""
    res = {}
    for label, fn in variants.items():
        out = fn()
        want, want_tol = (held_to or {}).get(label, (ref, tol))
        res[label] = {"out": out,
                      "err": assert_within(label, out, want, want_tol),
                      "ms": time_ms(fn, quick) if timed else None}
    return res


def describe(label: str, r: dict, m: int, err: bool = True) -> str:
    """``label X ms (Y M upd/s, err Z)``; no time where none was taken."""
    parts = []
    if r["ms"] is not None:
        parts.append(f"{r['ms']:.4f} ms ({rate(m, r['ms']):.0f}M upd/s"
                     + (f", err {r['err']:.1e})" if err else ")"))
    elif err:
        parts.append(f"err {r['err']:.1e}")
    return f"{label} {' '.join(parts)}"
