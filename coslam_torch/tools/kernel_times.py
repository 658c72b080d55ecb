"""Kernels B and H at the BA 1-keyframe case, on uniform and ray-ordered
points.

    python -m coslam_torch.tools.kernel_times --points FILE [--out FILE]
        [--profile]

Times kernel B (``hash_packed.grid_encode_bwd`` at the room0 spec, the
table gradient alone, as the BA 1-keyframe call asks) and kernel H
(``serial_scatter.row_accum``, deterministic, on kernel G's update streams
at the room0_xor spec) with ``index_add_`` on the same streams, at two
sets of points of one size: uniform points in the unit cube (seeded),
and the ray-ordered points of the room0 slice's first BA call, the
samples of one ray adjacent (``record_ba_points``; ``chip_smoke.py``
records them and saves them with ``numpy.save``, and ``--points`` loads
such a file). Each time is taken twice: CUDA events around 20
back-to-back calls, the median of 5 batches (``time_ms``, the host's cost
per call included), and a CUDA graph of 20 calls (``graph_ms``, the
card's time alone); where kernel H runs in phases, each phase is timed
alone as well.

The script calls only what earlier checkouts of the port also have
(``grid_encode_bwd``, ``xor_grid_encode_bwd``, ``row_accum``), so it also
times an earlier checkout's kernels in the same machine: run it by path
with that checkout's root first on ``PYTHONPATH``. It prints one JSON
line and writes it to ``--out`` when given. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch


def time_ms(fn, batches: int = 5, per_batch: int = 20,
            warmup: int = 5) -> float:
    """ms per call of fn: CUDA events around `per_batch` back-to-back
    calls, so the queue stays fed, divided by the count; the median of
    `batches` such batches after warm-up."""
    for _ in range(warmup):
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


def graph_ms(fn, batches: int = 5, per_batch: int = 20) -> float:
    """ms per call of fn on the card alone: `per_batch` calls captured in
    one CUDA graph (after warm-up on a side stream), replayed between CUDA
    events; the median of `batches` replays. No host work runs between
    the calls, so this is the card's time for what fn launches (its
    output's allocation and zero fill included)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_batch):
            fn()
    graph.replay()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_batch)
    del graph
    return float(np.median(times))


def both_ms(fn) -> dict:
    return {"ms": time_ms(fn), "graph_ms": graph_ms(fn)}


def h_phases(idx, vals, rows: int) -> dict:
    """Kernel H's three phases (sort, run starts, walk) on one stream, each
    timed alone: {phase: both_ms of its call}."""
    from coslam_torch.ops import serial_scatter as SS

    h = SS.SegmentedPlan(idx, vals, rows)
    out = torch.empty((rows + 1, vals.shape[1]), device=vals.device)
    calls = {"sort": h.sort, "starts": h.starts,
             "walk": lambda: h.walk(out)}
    for call in calls.values():
        call()
    return {name: both_ms(call) for name, call in calls.items()}


def kernel_breakdown(fn, calls: int = 5) -> list:
    """[(kernel, launches per call, device us per call)] of what fn
    launches, from a torch.profiler trace of `calls` calls
    (profile_slice.trace_stats; the trace file goes under output/ and is
    removed)."""
    import os

    from torch.profiler import ProfilerActivity, profile

    from coslam_torch.tools.profile_slice import trace_stats

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    os.makedirs("output", exist_ok=True)
    stats = trace_stats(prof, os.path.join("output", "kernel_times.json"),
                        top=20)
    return [(name, n / calls, us / calls) for name, n, us in stats["top"]]


def record_ba_points(cfg: dict, data, device) -> torch.Tensor:
    """The normalized points [N, 3] that the first iteration of the
    slice's first BA call encodes (CoSLAM.run over frames 0 to
    map_every, no mesh): rays x samples, the samples of one ray adjacent,
    some outside [0, 1] where a ray leaves the scene's bounds."""
    from coslam_torch.runtime.slam import CoSLAM

    slam = CoSLAM(cfg, data, device=device)
    seen = []
    normalize, ba = slam.model.normalize_coords, slam.global_BA

    def record(x):
        y = normalize(x)
        if not seen:
            seen.append(y.detach().clone())
        return y

    def global_ba(*args):
        slam.model.normalize_coords = record
        out = ba(*args)
        slam.model.normalize_coords = normalize
        return out

    slam.global_BA = global_ba
    slam.run(n_frames=cfg["mapping"]["map_every"] + 1, verbose=False,
             eval_ate=False, mesh=False)
    return seen[0].contiguous()


def time_b_and_h(device, points: dict, profiled: bool = False) -> dict:
    """{set name: {"B": times, "H": times, "index_add_": times}} for
    every [N, 3] point set in `points` (unit-normal tables, seed 0, and
    cotangents, seed 1, as in chip_smoke.py); with `profiled`, also each
    kernel that B and H launch, with its device time per call."""
    from coslam_torch.ops import encodings as E
    from coslam_torch.ops import hash_packed as HP
    from coslam_torch.ops import hash_pallas as XP
    from coslam_torch.ops import serial_scatter as SS

    hspec = HP.make_packed_spec(400, 16)
    xspec = E.make_hashgrid_spec(400, 16)
    rng = np.random.default_rng(0)

    def tensor(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    htable = tensor(rng.standard_normal((hspec.total_entries, 2)))
    xtable = tensor(rng.standard_normal((xspec.total_entries, 2)))
    out = {}
    for name, x in points.items():
        g = tensor(np.random.default_rng(1).standard_normal(
            (x.shape[0], hspec.out_dim)))
        idx, vals, _ = XP.xor_grid_encode_bwd(xspec, xtable, x, g, True,
                                              False)
        rows = xspec.total_entries
        buf = torch.zeros((rows + 1, 2), device=device)
        out[name] = {
            "points": int(x.shape[0]), "updates": int(idx.shape[0]),
            "B": both_ms(lambda: HP.grid_encode_bwd(hspec, htable, x, g, True,
                                                    False)),
            "H": both_ms(lambda: SS.row_accum(idx, vals, rows, True)),
            "index_add_": both_ms(lambda: buf.index_add_(0, idx, vals))}
        if hasattr(SS, "SegmentedPlan"):    # H's phases, where H has them
            out[name]["H_phases"] = h_phases(idx, vals, rows)
        if profiled:
            out[name]["profile"] = {
                "B": kernel_breakdown(lambda: HP.grid_encode_bwd(
                    hspec, htable, x, g, True, False)),
                "H": kernel_breakdown(lambda: SS.row_accum(idx, vals, rows,
                                                           True))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", required=True,
                    help="ray-ordered points [N, 3] (numpy .npy)")
    ap.add_argument("--out", help="also write the JSON line here")
    ap.add_argument("--profile", action="store_true",
                    help="also each kernel's device time (torch.profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    device = torch.device("cuda", 0)
    ray = torch.from_numpy(np.load(args.points).astype(np.float32)).to(device)
    uniform = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, ray.shape).astype(np.float32)).to(device)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    import coslam_torch

    rec = {"card": card, "package": coslam_torch.__file__,
           **time_b_and_h(device, {"uniform": uniform, "ray": ray},
                          args.profile)}
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
