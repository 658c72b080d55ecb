"""Kernels B and H, and E, A, C and D, at the BA 1-keyframe case, on
uniform and ray-ordered points.

    python -m coslam_torch.tools.kernel_times [--points FILE]
        [--xor-points FILE --vm-points FILE] [--hybrid FILE] [--host-us]
        [--serial [--record]] [--probes] [--out FILE] [--profile]

Times kernel B (``hash_packed.grid_encode_bwd`` at the room0 spec, the
table gradient alone, as the BA 1-keyframe call asks) and kernels F and H
(``serial_scatter.row_accum``, atomic and deterministic, on kernel G's
update streams at the room0_xor spec) with ``index_add_`` on the same
streams, at two sets of points of one size: uniform points in the unit
cube (seeded), and the ray-ordered points of the room0 slice's first BA call, the
samples of one ray adjacent (``record_ba_points``; ``chip_smoke.py``
records them and saves them with ``numpy.save``, and ``--points`` loads
such a file; without it B, F and H are not timed). Each time is taken
twice: CUDA events around 20 back-to-back calls, the median of 5 batches
(``time_ms``, the host's cost per call included), and a CUDA graph of 20
calls (``graph_ms``, the card's time alone); where kernel H runs in
phases, each phase is timed alone as well.

With ``--xor-points`` and ``--vm-points`` (the ray-ordered points of the
room0_xor and room0_vm slices' first BA calls, which ``chip_smoke.py``
saves as ``output/ba_points_xor.npy`` and ``output/ba_points_vm.npy``) it
also times kernel E (``hash_pallas.xor_grid_encode_fwd`` at the room0_xor
spec) and kernel A (``hash_packed.grid_encode_fwd`` at the room0 spec,
the same point count) at the BA 1-keyframe case on uniform and
ray-ordered points, A also at the packed Dense grid (``grid.enc: Dense``:
4 dense levels, 67.2 M rows) on uniform points; kernel C
(``tensovm.tensovm_encode_fwd`` at the room0_vm spec) at that slice's BA
1-keyframe case on uniform and ray-ordered points; and kernel D
(``tensovm.tensovm_encode_bwd``) at every case of that slice that asks for
a gradient (``main_path_cases``), uniform, and at the BA 1-keyframe case
on the ray-ordered points; beside each time of E, A, C and D its L2 figure
(``l2_rate``, ``e_l2_sectors``, ``a_l2_sectors``, ``c_l2_sectors``,
``d_l2_sectors``). A and C are held to their plain versions on every set
of points before they are timed.

With ``--hybrid`` (the ray-ordered points of the room0_hybrid slice's
first BA call, ``output/ba_points_hybrid.npy`` from ``chip_smoke.py``) it
times kernels T and U, U also in its serial mode, at every case of that
slice and on those points, T beside its L2 figure (``t_l2_sectors``) and
the time of the library route for its function (``t_library``: one
``grid_sample`` and a sum), and A and B at the hybrid's dense levels
(``time_t_and_u``).

With ``--serial`` it times the serial modes of kernels B, U and D (the
table gradient in the TPU kernels' serial order) at the BA 1-keyframe
case of room0, room0_hybrid and room0_vm, on uniform points and on each
slice's ray-ordered points (``--points``, ``--hybrid`` and
``--vm-points``, or, with ``--record``, recorded first by
``record_points`` and saved under output/), each with every launch's
device time in launch order (``phase_times``, torch.profiler): the
phases of whichever route the checkout has (``time_serial``).

With ``--probes`` it times kernel P in every form the probes launch, at
their shapes, on the card alone, kernel Q (packed bf16) at K9's and K10's,
K6's route and kernel R alone, kernel S (P's clip form) at K11's and V at
K12's (``time_p``).

With ``--host-us`` it also measures the host's cost of the A and C
wrappers (``wrapper_host_us``): microseconds per call of the whole
wrapper and of each part of its card path, over 10,000 calls each.

The script calls only what earlier checkouts of the port also have
(``grid_encode_fwd``, ``grid_encode_bwd``, ``xor_grid_encode_fwd``,
``xor_grid_encode_bwd``, ``tensovm_encode_fwd``, ``tensovm_encode_bwd``,
``row_accum``, the probes' wrappers and ``_bench_cell_merge.merged``,
the serial modes' wrappers and the plain versions), so it
also
times an earlier checkout's kernels in the same machine: run it by path
with that checkout's root first on ``PYTHONPATH``. It prints one JSON
line and writes it to ``--out`` when given. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

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


PHASE_RANGE = "phase_times_call"


def trace_phases(events: list) -> dict | None:
    """The phases of the calls in a chrome trace's ``traceEvents``, each
    call inside a record_function range named PHASE_RANGE: {"phases":
    [[kernel or memset, median us over the calls], ...], "span_us": the
    median time from a call's first launch's start to its last one's end,
    "calls": the calls counted}. A device event belongs to the call whose
    range on the host holds the launch that issued it (the trace's
    correlation id); calls whose launch count is not the most common
    non-zero one are left out. None where no call has a device event."""
    from collections import Counter

    from coslam_torch.tools.profile_slice import _DEVICE_CATS

    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("name") == PHASE_RANGE
                    and e.get("cat") == "user_annotation")
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    per_call = [[] for _ in ranges]
    for e in sorted((e for e in events if e.get("cat") in _DEVICE_CATS),
                    key=lambda e: e["ts"]):
        t = launched.get(e.get("args", {}).get("correlation"))
        for c, (lo, hi) in enumerate(ranges):
            if t is not None and lo <= t <= hi:
                per_call[c].append(e)
    counts = Counter(len(c) for c in per_call if c)
    if not counts:
        return None
    n = counts.most_common(1)[0][0]
    per_call = [c for c in per_call if len(c) == n]

    def short(name):
        name = name.replace("(anonymous namespace)::", "")
        return "memset" if name.startswith("Memset") else name.split("(")[0]

    phases = [[short(per_call[0][j]["name"]),
               float(np.median([c[j]["dur"] for c in per_call]))]
              for j in range(n)]
    span = float(np.median([c[-1]["ts"] + c[-1]["dur"] - c[0]["ts"]
                            for c in per_call]))
    return {"phases": phases, "span_us": span, "calls": len(per_call)}


def phase_times(fn, calls: int = 5, tries: int = 3) -> dict:
    """The card's time of every launch fn makes, in launch order
    (``trace_phases``), read from a torch.profiler trace of `calls` calls.
    A trace that holds no device event for the calls (CUPTI recorded
    none) is taken again, up to `tries` traces; after that the phases are
    not measured: {"phases": None, "span_us": None, "calls": 0}. Works on
    any checkout's wrappers."""
    import os

    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    os.makedirs("output", exist_ok=True)
    path = os.path.join("output", "phase_times.json")
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                with record_function(PHASE_RANGE):
                    fn()
                torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        found = trace_phases(events)
        if found is not None:
            return found
    return {"phases": None, "span_us": None, "calls": 0}


def time_serial(device, points: dict) -> dict:
    """{"B" | "U" | "D": {"uniform" | "ray": times}}: the serial modes of
    kernel B (room0's packed grid, unit-normal table), U (room0_hybrid's
    planes, 0.1 x noise) and D (room0_vm's planes 0.1 x noise and lines 1
    + 0.1 x noise) at the BA 1-keyframe case (the table gradient alone),
    on uniform points (seed 2) and on the slice's ray-ordered points
    (``points``: {"B", "U", "D"} -> [N, 3]); cotangents seed 1. Each entry:
    events and graph ms (``both_ms``) and every launch's device time
    (``phase_times``)."""
    from coslam_torch.data.synth import room0_hybrid_config
    from coslam_torch.models.scene_rep import JointEncoding
    from coslam_torch.ops import hash_packed as HP
    from coslam_torch.ops import tensovm as VM
    from coslam_torch.ops import triplane as TP

    rng = np.random.default_rng(0)

    def tensor(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    hspec = HP.make_packed_spec(400, 16)
    cfg = room0_hybrid_config("output", 48, 64, 15)
    pspec = JointEncoding(cfg, cfg["mapping"]["bound"], device).grid_spec[1]
    vspec = VM.make_tensovm_spec(400, 3)
    htable = tensor(rng.standard_normal((hspec.total_entries, 2)))
    ptable = tensor(0.1 * rng.standard_normal((pspec.total_entries, 2)))
    planes = tensor(0.1 * rng.standard_normal((vspec.total_entries, 2)))
    lines = tensor(1.0 + 0.1 * rng.standard_normal(
        (VM.line_total_rows(vspec), 2)))
    calls = {
        "B": (hspec, lambda x, g: HP.grid_encode_bwd_serial(
            hspec, htable, x, g, False)),
        "U": (pspec, lambda x, g: TP.triplane_encode_bwd_serial(
            pspec, ptable, x, g, False)),
        "D": (vspec, lambda x, g: VM.tensovm_encode_bwd_serial(
            vspec, planes, lines, x, g, False))}
    out = {}
    for name, (spec, call) in calls.items():
        ray = points[name]
        n = ray.shape[0]
        g = tensor(np.random.default_rng(1).standard_normal(
            (n, spec.out_dim)))
        sets = {"uniform": tensor(np.random.default_rng(2).uniform(
            0, 1, (n, 3))), "ray": ray}
        out[name] = {}
        for label, x in sets.items():
            fn = lambda: call(x, g)  # noqa: E731
            out[name][label] = {"points": n, **both_ms(fn),
                                **phase_times(fn)}
            torch.cuda.synchronize()
    return out


def record_points(device, out_dir: str = "output") -> dict:
    """Render the smoke's 15-frame 480x640 scene and record the ray-ordered
    points of the first BA call of room0, room0_vm and room0_hybrid
    (``record_ba_points``), saved as chip_smoke.py saves them
    (ba_points.npy, ba_points_vm.npy, ba_points_hybrid.npy under
    `out_dir`): {"B", "D", "U"} -> [N, 3]."""
    import os

    from coslam_torch.data.synth import (SyntheticFrames, room0_config,
                                         room0_hybrid_config, room0_vm_config)

    os.makedirs(out_dir, exist_ok=True)
    data = SyntheticFrames(room0_config(out_dir, 480, 640, 15), 15)
    out = {}
    for key, name, cfg_fn in (("B", "", room0_config),
                              ("D", "_vm", room0_vm_config),
                              ("U", "_hybrid", room0_hybrid_config)):
        ray = record_ba_points(cfg_fn(out_dir, 480, 640, 15,
                                      exp_name=f"kernel_times{name}_rays"),
                               data, device)
        np.save(os.path.join(out_dir, f"ba_points{name}.npy"),
                ray.cpu().numpy())
        out[key] = ray
    return out


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


def main_path_cases(cfg: dict, frames: int) -> list:
    """(label, points, need_table, need_dx) of every encode call the
    slice makes, from its config: points are rays x samples per ray.
    Only a BA call with >= 2 keyframes optimizes poses, so only it and
    tracking ask for dx; a BA call's current-frame quota is
    max(sample // kf_count, min_pixels_cur), with the keyframe count
    before that frame's keyframe is added; the hash grid's smoothness
    lattice is encoded as constant points, and so is TriPlaneHybrid's
    dense part (TensoVM's and TriPlane's analytic TV encodes none, and
    the hybrid's planes take the plain lattice encode); the mesh only
    queries. With training.n_importance > 0 each step's case is followed
    by its fine pass's (label + " fine"): the same rays x n_importance
    points, asking for the same gradients."""
    from coslam_torch.mesh.extract import CHUNK
    from coslam_torch.models.scene_rep import is_factorized

    tr, mc = cfg["training"], cfg["mapping"]
    z = tr["n_samples_d"] + tr["n_range_d"]
    n_imp = int(tr.get("n_importance", 0))
    S = mc["sample"]
    cases = []

    def step(label, rays, need_table, need_dx):
        cases.append((label, rays * z, need_table, need_dx))
        if n_imp > 0:
            cases.append((f"{label} fine", rays * n_imp, need_table,
                          need_dx))

    step("first frame", S, True, False)
    step("tracking", cfg["tracking"]["sample"], False, True)
    kf_counts = sorted({(i - 1) // mc["keyframe_every"] + 1
                        for i in range(1, frames) if i % mc["map_every"] == 0})
    for kf in kf_counts:
        quota = min(max(S // kf, mc["min_pixels_cur"]), S)
        step(f"BA {kf} kf", S + quota, True, kf >= 2)
    if (not is_factorized(cfg)
            or "hybrid" in str(cfg["grid"]["enc"]).lower()):
        cases.append(("lattice", (tr["smooth_pts"] - 1) ** 3, True, False))
    cases.append(("mesh chunk", CHUNK, False, False))
    return cases


# The L2 figure of E, A, C and D. Their tables stay in the 50 MB L2, so
# what they pay for is scattered 32-byte sector accesses there, which the
# DRAM-byte bound does not count. l2_rate measures the card's rate for such
# accesses in the same run (a plain gather from an L2-resident table: a
# rate that gather reaches, not the L2's peak), and e_l2_sectors,
# a_l2_sectors, c_l2_sectors and d_l2_sectors count the sector accesses a
# call's work needs from L2 on this run's points: per (point, level) the
# distinct sectors of the rows it reads (no reuse between points counted:
# that is L1's part), each output or streamed input sector once, and each
# atomic instruction of D's plane gradient as one sector access (an atomic
# costs L2 more than a read, so this is a floor).

SECTOR = 32


def l2_rate(device, rows: int = 834_097, m: int = 1 << 20) -> dict:
    """Sector accesses per ms of ``table.index_select(0, idx)``: m random
    8-byte rows of a [rows, 2] f32 table (room0_xor's size, 6.7 MB) by an
    int32 index, every operand L2-resident (index 4 MB, output 8 MB); each
    gathered row is one sector, the index and output streams m * 12 / 32
    more. Timed as a CUDA graph of 20 calls."""
    g = torch.Generator(device=device).manual_seed(0)
    table = torch.randn((rows, 2), device=device, generator=g)
    idx = torch.randint(0, rows, (m,), device=device, generator=g,
                        dtype=torch.int32)
    out = torch.empty((m, 2), device=device)
    ms = graph_ms(lambda: torch.index_select(table, 0, idx, out=out))
    sectors = m + m * 12 // SECTOR
    return {"ms": ms, "sectors": sectors, "sectors_per_ms": sectors / ms}


def _distinct(rows: torch.Tensor, dim: int) -> torch.Tensor:
    """The count of distinct values along `dim`, summed over the rest."""
    srt = rows.sort(dim).values
    return int((srt.diff(dim=dim) != 0).sum()) + srt.numel() // srt.shape[dim]


def e_l2_sectors(spec, x: torch.Tensor) -> int:
    """Kernel E's sector accesses on points x: the distinct sectors of each
    (point, level)'s 8 corner rows, x read and the output written."""
    from coslam_torch.ops import encodings as E

    n = x.shape[0]
    rows, _ = E._hash_corners_and_weights(spec, x)              # [L, 8, N]
    row_bytes = 4 * spec.n_features
    reads = _distinct(rows * row_bytes // SECTOR, 1)
    return reads + (12 * n + 4 * n * spec.out_dim) // SECTOR


def a_l2_sectors(spec, x: torch.Tensor) -> int:
    """Kernel A's sector accesses on points x, counted as E's: per (point,
    level) the distinct sectors of its 4 xy corners' row pairs (e, e + 1)
    of the packed table, x read and the output written (the yardstick
    beside E: the same points and widths, another layout)."""
    from coslam_torch.ops import hash_packed as HP

    n = x.shape[0]
    cell, _ = HP._cells_and_weights(spec, x)
    e = HP._corner_entries(spec, cell)                          # [L, 4, N]
    rows = torch.cat([e, e + 1], 1)
    reads = _distinct(rows * (4 * spec.n_features) // SECTOR, 1)
    return reads + (12 * n + 4 * n * spec.out_dim) // SECTOR


def c_l2_sectors(spec, x: torch.Tensor) -> int:
    """Kernel C's sector accesses on points x: per (point, section) the
    distinct sectors of its 4 plane rows and 2 line rows, counted as
    d_l2_sectors counts D's reads, x read and the output written (the
    count of D's call without the table gradient and dx, whose g read is
    as long as C's output)."""
    return d_l2_sectors(spec, x, False, False)


def d_l2_sectors(spec, x: torch.Tensor, need_table: bool,
                 need_dx: bool) -> int:
    """Kernel D's sector accesses on points x: per (point, section) the
    distinct sectors of its 4 plane rows and 2 line rows, the plane
    gradient's atomic instructions (a row pair starting at an even row
    takes one, else two) when the table gradient is asked for, x and g
    read and dx written."""
    from coslam_torch.ops import tensovm as VM

    n = x.shape[0]
    geo = VM._Geometry(spec, torch.zeros((spec.total_entries, 2),
                                         device=x.device),
                       torch.zeros((VM.line_total_rows(spec), 2),
                                   device=x.device), x)
    row_bytes = 4 * spec.n_features
    plane = torch.stack([geo.e00, geo.e00 + 1, geo.e10, geo.e10 + 1])
    reads = _distinct(plane * row_bytes // SECTOR, 0)
    lines = torch.stack([geo.l_row, geo.l_row + 1])
    reads += _distinct(lines * row_bytes // SECTOR, 0)
    atomics = 0
    if need_table:
        pairs = torch.stack([geo.e00, geo.e10])
        atomics = int((2 - (pairs % 2 == 0).long()).sum())
    streams = 12 * n + 4 * n * spec.out_dim + 12 * n * need_dx
    return reads + atomics + streams // SECTOR


def t_l2_sectors(spec, x: torch.Tensor) -> int:
    """Kernel T's sector accesses on points x: d_l2_sectors' count with
    unit lines, per (point, section) the distinct sectors of its 4 plane
    rows, x read and the output written."""
    from coslam_torch.ops import triplane as TP

    n = x.shape[0]
    e00, e10, _, _ = TP._corners(spec, x)                       # [S, N]
    plane = torch.stack([e00, e00 + 1, e10, e10 + 1])
    reads = _distinct(plane * (4 * spec.n_features) // SECTOR, 0)
    return reads + (12 * n + 4 * n * spec.out_dim) // SECTOR


def t_library(spec, table: torch.Tensor):
    """The library route for kernel T's function: fn(x) -> [N, L F], one
    ``grid_sample`` over the 3 L sections (each a zero-padded [F, R, R]
    image, R = the finest r + 1, built here once: rows u, columns v) at
    per-level scaled grids, then a sum over each level's 3 sections. The
    grid is built from x inside fn, so a timing of fn runs from x to the
    output. align_corners=True puts pixel i at -1 + 2 i / (R - 1), so
    u = r clip(x) maps to 2 u / (R - 1) - 1; the zero padding is never
    weighted (u <= r)."""
    import torch.nn.functional as Fn
    from coslam_torch.ops import triplane as TP

    S, F, L = spec.n_levels, spec.n_features, spec.pyr_levels
    R = max(spec.resolutions) + 1
    images = table.new_zeros((S, F, R, R))
    for s in range(S):
        r1 = spec.resolutions[s] + 1
        sec = table[spec.offsets[s]:spec.offsets[s] + r1 * r1]
        images[s, :, :r1, :r1] = sec.T.reshape(F, r1, r1)
    scale = torch.tensor(spec.resolutions, dtype=table.dtype,
                         device=table.device)[:, None] * (2.0 / (R - 1))
    # grid_sample's x is the width (v), its y the height (u).
    axes = torch.tensor([[TP._PLANES[s % 3][1] for s in range(S)],
                         [TP._PLANES[s % 3][0] for s in range(S)]],
                        device=table.device)

    def fn(x):
        xt = x.clamp(0.0, 1.0).T                                # [3, N]
        grid = torch.stack([xt.index_select(0, axes[0]),
                            xt.index_select(0, axes[1])], -1) * scale[
                                ..., None]
        out = Fn.grid_sample(images, (grid - 1.0)[:, None], mode="bilinear",
                             padding_mode="zeros", align_corners=True)
        n = x.shape[0]
        return out.view(L, 3, F, n).sum(1).permute(2, 0, 1).reshape(n, L * F)
    return fn


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
    """{set name: {"B": times, "F": times, "H": times, "index_add_":
    times, "index_put_det_ms": H's library call, index_put_(accumulate=
    True) under torch.use_deterministic_algorithms(True)}} for
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
            "F": both_ms(lambda: SS.row_accum(idx, vals, rows, False)),
            "H": both_ms(lambda: SS.row_accum(idx, vals, rows, True)),
            "index_add_": both_ms(lambda: buf.index_add_(0, idx, vals))}
        # H's library call: the deterministic index_put_(accumulate=True)
        # (a sort, then a sum of each row's run), CUDA events only.
        keys = idx.long()
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            out[name]["index_put_det_ms"] = time_ms(
                lambda: buf.index_put_((keys,), vals, accumulate=True))
        finally:
            torch.use_deterministic_algorithms(was)
        if hasattr(SS, "SegmentedPlan"):    # H's phases, where H has them
            out[name]["H_phases"] = h_phases(idx, vals, rows)
        if profiled:
            out[name]["profile"] = {
                "B": kernel_breakdown(lambda: HP.grid_encode_bwd(
                    hspec, htable, x, g, True, False)),
                "H": kernel_breakdown(lambda: SS.row_accum(idx, vals, rows,
                                                           True))}
    return out


def time_p(device) -> dict:
    """{setting: {"ms" (CUDA graph of the calls), "index_add_" where one
    call computes the same (for the pair forms, on each update's two rows
    laid out as index_add_ takes them)}}: kernel P at each probe's main
    shape, every
    form the probes launch (tools/bench: K5's 8 streams on its random and
    runs streams, float4; K7's pair form at 1,859,584 updates, 256 threads,
    4 updates a thread; K8's [M, W] rows at W = 4, 8 and 16, float4; K9's
    streams at W = 4, 8 and 16, scalar and float4; K10's pair form, scalar
    (its "shipped") and float2 at 256 threads and 4 updates a thread);
    K6 on K5's streams, the route (``_bench_cell_merge.merged``, the
    probe's run_merged) and kernel R alone on the torch pre-pass's output;
    kernel Q (packed bf16) at K9's shapes, scalar and float4, and at K10's
    pair form, scalar and float2 (256 threads, 4 updates a thread, and the
    probe's 512 and 8); kernel S at K11's and V at K12's (the run-merge
    probe's ray-ordered streams at r = 140 and 311, W = 8). Each is held to
    its plain version within the sum-order bound first (Q to the plain
    sum of its unpacked values, V to the plain sum of the suffix scan's
    first entries)."""
    from coslam_torch.ops import probe_accum as PA
    from coslam_torch.tools.bench import _bench_cell_merge as CM
    from coslam_torch.tools.bench import _bench_chunk_tune as CT
    from coslam_torch.tools.bench import _bench_row_rates as RR
    from coslam_torch.tools.bench import _bench_run_merge as RM
    from coslam_torch.tools.bench import _bench_scatter_variants as SV
    from coslam_torch.tools.bench import _common as C

    rng = np.random.default_rng(0)
    out = {}

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def timed(label, idx, rows2d, out_rows, stride, call, library=None):
        ref = PA.probe_accum_ref(idx, rows2d, out_rows, stride)
        C.assert_within(label, call(), ref,
                        C.sum_order_tol(idx, rows2d, out_rows, stride))
        out[label] = {"updates": int(idx.shape[0]), "ms": graph_ms(call)}
        if library is not None:
            lib_idx, lib_rows = (library if isinstance(library, tuple)
                                 else (idx, library))
            buf = torch.zeros_like(ref)
            out[label]["index_add_"] = graph_ms(
                lambda: buf.index_add_(0, lib_idx, lib_rows))

    def pair_rows(idx, pair):
        """A pair form's updates as index_add_ takes them: each update's
        two rows (idx, idx + 1) in turn, [2M] indices and [2M, 2] rows."""
        flat = (idx.long()[:, None]
                + torch.arange(2, device=idx.device)).reshape(-1)
        return flat, pair.T.reshape(-1, 2)

    def unpacked(words):
        return PA.unpack_bf16x2(words.T.contiguous())

    vals = tensor(rng.standard_normal((CM.WIDTH, CM.N)).astype(np.float32))
    for name, ids in CM.streams(CM.ROWS, CM.N).items():
        idx = tensor(ids)
        timed(f"K5 {name} W=8 float4", idx, vals.T, CM.ROWS + 1, None,
              lambda: PA.probe_accum(idx, vals, CM.ROWS + 1, vec=4), vals.T)
        timed(f"K6 {name} route", idx, vals.T, CM.ROWS + 1, None,
              lambda: CM.merged(idx, vals, CM.ROWS), vals.T)
        pairs = PA.merge_pairs(idx, vals)
        timed(f"K6 {name} R alone", idx, vals.T, CM.ROWS + 1, None,
              lambda: PA.probe_accum_pair_merged(*pairs, CM.ROWS + 1))
    (threads, upt), = CT.QUICK
    m = CT.MS[-1]
    idx = tensor(rng.integers(0, CT.ROWS - 2, m).astype(np.int32))
    pair = tensor(rng.standard_normal((4, m)).astype(np.float32))
    timed(f"K7 pair float2 t={threads} u={upt}", idx, pair.T, CT.ROWS + 2, 2,
          lambda: PA.probe_accum(idx, pair, CT.ROWS + 2, stride=2, vec=2,
                                 upt=upt, threads=threads),
          pair_rows(idx, pair))
    idx = tensor(rng.integers(0, RR.ROWS, RR.M).astype(np.int32))
    for width in RR.WIDTHS:
        streams = tensor(rng.standard_normal((width, RR.M)).astype(np.float32))
        rows2d = streams.T.contiguous()
        timed(f"K8 rows W={width} float4", idx, rows2d, RR.ROWS + 1, None,
              lambda: PA.probe_accum(idx, rows2d, RR.ROWS + 1, rows=True,
                                     vec=4), rows2d)
        words = RR.pack_streams(streams)
        for vec in (1, 4):
            timed(f"K9 streams W={width} vec{vec}", idx, streams.T,
                  RR.ROWS + 1, None,
                  lambda vec=vec: PA.probe_accum(idx, streams, RR.ROWS + 1,
                                                 vec=vec), streams.T)
            timed(f"K9 Q W={width} vec{vec}", idx, unpacked(words),
                  RR.ROWS + 1, None,
                  lambda vec=vec: PA.probe_accum_bf16x2(
                      idx, words, RR.ROWS + 1, vec=vec))
    idx = tensor(rng.integers(0, SV.N_ROWS - 2, SV.M).astype(np.int32))
    pair = tensor(rng.standard_normal((4, SV.M)).astype(np.float32))
    for vec, upt in ((1, 1), (2, 4)):
        timed(f"K10 pair vec{vec} t=256 u={upt}", idx, pair.T, SV.N_ROWS + 2,
              2, lambda vec=vec, upt=upt: PA.probe_accum(
                  idx, pair, SV.N_ROWS + 2, stride=2, vec=vec, upt=upt),
              pair_rows(idx, pair))
    words = RR.pack_streams(pair)
    for vec, threads, upt in ((1, 256, 1), (2, 256, 4), (2, 512, 8)):
        timed(f"K10 Q pair vec{vec} t={threads} u={upt}", idx,
              unpacked(words), SV.N_ROWS + 2, 2,
              lambda vec=vec, threads=threads, upt=upt: PA.probe_accum_bf16x2(
                  idx, words, SV.N_ROWS + 2, stride=2, vec=vec, upt=upt,
                  threads=threads))
    for r in RM.RS:
        ids, rows2d = (tensor(a) for a in RM.make_stream(r))
        timed(f"K11 run merge r={r} W={RM.W}", ids, rows2d, r * r + 1, None,
              lambda: PA.probe_accum_run_merge(ids, rows2d, r * r + 1),
              rows2d)
        s_idx, s_vals = PA.run_merge_outside(ids, rows2d, r * r)
        timed(f"K12 run skip r={r} W={RM.W}", s_idx, s_vals, r * r + 1, None,
              lambda: PA.probe_accum_run_skip(ids, rows2d, r * r + 1))
    return out


def packed_dense_spec(device):
    """The packed grid of room0 with ``grid.enc: Dense`` and the default
    ``grad_impl`` (4 dense levels, resolutions 16/46/136/400, 67,161,290
    rows), as the model builds it."""
    from coslam_torch.data.synth import room0_config
    from coslam_torch.models.scene_rep import JointEncoding

    cfg = room0_config("output", 48, 64, 1)
    cfg["grid"]["enc"] = "Dense"
    return JointEncoding(cfg, cfg["mapping"]["bound"], device).grid_spec


def time_e_and_d(device, xor_ray: torch.Tensor, vm_ray: torch.Tensor,
                 l2: dict) -> dict:
    """{"E": {set: times}, "A": {set: times}, "C": {set: times}, "D":
    {case: times}}: kernel E and kernel A at the BA 1-keyframe point count
    of room0_xor on uniform points (seed 2) and on `xor_ray`, A also at the
    packed Dense grid on the uniform points; kernel C at room0_vm's BA
    1-keyframe case on uniform points and on `vm_ray`; kernel D at every
    case of room0_vm that asks for a gradient (uniform points, seed 2) and
    at its BA 1-keyframe case on `vm_ray`. Tables as in chip_smoke.py (E
    and A unit normal, seed 0; C and D planes 0.1 x noise, lines 1 + 0.1 x
    noise, seed 0), cotangents unit normal, seed 1. Every time carries its
    L2 figure ``l2_ms`` (sector accesses over ``l2``'s rate); A and C are
    first held to their plain versions within the forward tolerance of
    chip_smoke.py."""
    from coslam_torch.data.synth import room0_vm_config
    from coslam_torch.ops import encodings as E
    from coslam_torch.ops import hash_packed as HP
    from coslam_torch.ops import hash_pallas as XP
    from coslam_torch.ops import tensovm as VM

    def tensor(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    def uniform(n):
        return tensor(np.random.default_rng(2).uniform(0, 1, (n, 3)))

    def l2_ms(sectors):
        return {"l2_sectors": sectors,
                "l2_ms": sectors / l2["sectors_per_ms"]}

    xspec = E.make_hashgrid_spec(400, 16)
    hspec = HP.make_packed_spec(400, 16)
    rng = np.random.default_rng(0)
    xtable = tensor(rng.standard_normal((xspec.total_entries, 2)))
    htable = tensor(np.random.default_rng(0).standard_normal(
        (hspec.total_entries, 2)))
    out = {"E": {}, "A": {}, "C": {}, "D": {}}

    def held(name, got, ref):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"{name}: {m}")

    def time_a(name, spec, table, x):
        held(f"A {name}", HP.grid_encode_fwd(spec, table, x),
              HP.grid_encode_fwd_ref(spec, table, x))
        out["A"][name] = {
            "points": int(x.shape[0]),
            **both_ms(lambda: HP.grid_encode_fwd(spec, table, x)),
            **l2_ms(a_l2_sectors(spec, x))}

    for name, x in (("uniform", uniform(xor_ray.shape[0])), ("ray", xor_ray)):
        out["E"][name] = {
            "points": int(x.shape[0]),
            **both_ms(lambda: XP.xor_grid_encode_fwd(xspec, xtable, x)),
            **l2_ms(e_l2_sectors(xspec, x))}
        time_a(name, hspec, htable, x)
    dspec = packed_dense_spec(device)
    dtable = torch.randn((dspec.total_entries, 2), device=device,
                         generator=torch.Generator(device).manual_seed(0))
    time_a("dense", dspec, dtable, uniform(xor_ray.shape[0]))
    del dtable

    vspec = VM.make_tensovm_spec(400, 3)
    rng = np.random.default_rng(0)
    planes = tensor(0.1 * rng.standard_normal((vspec.total_entries, 2)))
    lines = tensor(1.0 + 0.1 * rng.standard_normal(
        (VM.line_total_rows(vspec), 2)))
    for name, x in (("uniform", uniform(vm_ray.shape[0])), ("ray", vm_ray)):
        held(f"C {name}", VM.tensovm_encode_fwd(vspec, planes, lines, x),
              VM.tensovm_encode_fwd_ref(vspec, planes, lines, x))
        out["C"][name] = {
            "points": int(x.shape[0]),
            **both_ms(lambda: VM.tensovm_encode_fwd(vspec, planes, lines, x)),
            **l2_ms(c_l2_sectors(vspec, x))}
    cases = [(label, n, table, dx, None) for label, n, table, dx
             in main_path_cases(room0_vm_config("output"), 15) if table or dx]
    cases.append(("BA 1 kf ray-ordered", vm_ray.shape[0], True, False,
                  vm_ray))
    for label, n, need_table, need_dx, x in cases:
        x = uniform(n) if x is None else x
        g = tensor(np.random.default_rng(1).standard_normal(
            (n, vspec.out_dim)))
        out["D"][label] = {
            "points": n, "need_table": need_table, "need_dx": need_dx,
            **both_ms(lambda: VM.tensovm_encode_bwd(
                vspec, planes, lines, x, g, need_table, need_table, need_dx)),
            **l2_ms(d_l2_sectors(vspec, x, need_table, need_dx))}
    return out


def _host_us(fn, calls: int) -> float:
    """Host microseconds per call of fn over `calls` calls, no sync."""
    fn()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    return (time.perf_counter_ns() - t0) / calls / 1e3


def wrapper_host_us(device, calls: int = 10_000, n: int = 1024) -> dict:
    """{"A": {part: us}, "C": {part: us}}: the host's microseconds per call
    of the kernel A and C wrappers (``grid_encode_fwd`` at the room0 spec,
    ``tensovm_encode_fwd`` at room0_vm's) on `n` points, each timed over
    `calls` calls with time.perf_counter_ns and no sync (the kernels take a
    few us at this size, so the queue never backs up and the whole call is
    the host's time): "call", the whole wrapper, and each part of its card
    path: the CPU test (``_kernels.on_cpu``), the tensor checks
    (``_check_cuda``), the level table lookup, the output's
    ``torch.empty``, the stream query (``_kernels.stream``), the ctypes
    call with no point (``n_points`` 0: the binding without a launch), and
    the return code check (``_kernels.check``); "launch", the ctypes call
    with the points, which enqueues the kernel."""
    from coslam_torch.ops import _kernels as K
    from coslam_torch.ops import hash_packed as HP
    from coslam_torch.ops import tensovm as VM

    hspec = HP.make_packed_spec(400, 16)
    vspec = VM.make_tensovm_spec(400, 3)
    x = torch.rand((n, 3), device=device)
    table = torch.zeros((hspec.total_entries, 2), device=device)
    planes = torch.zeros((vspec.total_entries, 2), device=device)
    lines = torch.ones((VM.line_total_rows(vspec), 2), device=device)
    lib = K.library()
    out = {}
    for name, mod, wrapper, tensors, spec in (
            ("A", HP, HP.grid_encode_fwd, (table, x), hspec),
            ("C", VM, VM.tensovm_encode_fwd, (planes, lines, x), vspec)):
        level_table = K.level_table if name == "A" else mod._level_table
        levels = level_table(spec, device)
        parts = {"call": lambda: wrapper(spec, *tensors),
                 "on_cpu": lambda: K.on_cpu(*tensors),
                 "_check_cuda": lambda: mod._check_cuda(spec, *tensors),
                 "level table": lambda: level_table(spec, device),
                 "torch.empty": lambda: torch.empty(
                     (n, spec.out_dim), device=device, dtype=torch.float32),
                 "stream": lambda: K.stream(device)}
        res = torch.empty((n, spec.out_dim), device=device)
        ptrs = [t.data_ptr() for t in tensors] + [res.data_ptr()]
        if name == "A":
            fn = lib.grid_encode_fwd
            args = lambda m: (ptrs[1], ptrs[0], ptrs[2], m, 2,  # noqa: E731
                              levels.data_ptr(), hspec.n_levels,
                              2 ** hspec.log2_hashmap_size - 1)
        else:
            fn = lib.tensovm_encode_fwd
            args = lambda m: (  # noqa: E731
                ptrs[2], ptrs[0], ptrs[1], ptrs[3], m, 2, levels.data_ptr(),
                vspec.pyr_levels)
        parts["ctypes, no point"] = lambda: fn(*args(0), None)
        parts["launch"] = lambda: fn(*args(n), K.stream(device))
        parts["check"] = lambda: K.check(0, "host_us")
        out[name] = {k: _host_us(f, calls) for k, f in parts.items()}
        torch.cuda.synchronize()
    return out


# The grid_sample route normalizes its coordinates to [-1, 1] and back:
# two more roundings, which move a sample by up to ~R 2^-23 (R = 312) of a
# cell, where neighbouring rows of a 0.1 x noise table differ by up to
# ~0.5; so 1e-4 absolute over a level's three sections.
LIBRARY_TOL = dict(rtol=1e-5, atol=1e-4)


def time_t_and_u(device, ray: torch.Tensor, l2: dict) -> dict:
    """{"T": {case: times}, "U": {case: times}, "U_serial": {case: times},
    "A": {set: times}, "B": {set: times}} at room0_hybrid's grid: kernel T
    (``triplane.triplane_encode_fwd``) and U (``triplane_encode_bwd``, and
    its serial mode where the case asks for the table gradient) at every
    case of the slice that encodes through them (``main_path_cases``
    without the lattice, uniform points, seed 2) and at the BA 1-keyframe
    case on `ray` (room0_hybrid's ray-ordered points); T beside its L2
    figure (``t_l2_sectors`` over ``l2``'s rate) and the library route's
    graph time (``t_library``, held to the plain version within
    LIBRARY_TOL first); kernels A and B at the hybrid's dense spec (3
    dense levels, 115,721 rows) at the BA 1-keyframe case, uniform and on
    `ray`. Plane table 0.1 x noise, dense table unit normal (seed 0),
    cotangents unit normal (seed 1); T is held to its plain version
    first."""
    from coslam_torch.data.synth import room0_hybrid_config
    from coslam_torch.models.scene_rep import JointEncoding
    from coslam_torch.ops import hash_packed as HP
    from coslam_torch.ops import triplane as TP

    cfg = room0_hybrid_config("output", 48, 64, 15)
    dspec, pspec = JointEncoding(cfg, cfg["mapping"]["bound"],
                                 device).grid_spec
    rng = np.random.default_rng(0)

    def tensor(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    planes = tensor(0.1 * rng.standard_normal((pspec.total_entries, 2)))
    dense = tensor(rng.standard_normal((dspec.total_entries, 2)))
    library = t_library(pspec, planes)
    out = {"T": {}, "U": {}, "U_serial": {}, "A": {}, "B": {}}
    cases = [c for c in main_path_cases(cfg, 15) if c[0] != "lattice"]
    ba1 = [c for c in cases if c[0] == "BA 1 kf"][0]
    runs = [(label, n, dt, dx, None) for label, n, dt, dx in cases]
    runs.append(("BA 1 kf ray-ordered", ray.shape[0], True, False, ray))
    for label, n, need_dt, need_dx, x in runs:
        if x is None:
            x = tensor(np.random.default_rng(2).uniform(0, 1, (n, 3)))
        g = tensor(np.random.default_rng(1).standard_normal(
            (n, pspec.out_dim)))
        ref = TP.triplane_encode_fwd_ref(pspec, planes, x)
        torch.testing.assert_close(TP.triplane_encode_fwd(pspec, planes, x),
                                   ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(library(x), ref, **LIBRARY_TOL)
        sectors = t_l2_sectors(pspec, x)
        out["T"][label] = {
            "points": n, **both_ms(
                lambda: TP.triplane_encode_fwd(pspec, planes, x)),
            "l2_sectors": sectors, "l2_ms": sectors / l2["sectors_per_ms"],
            "library_ms": graph_ms(lambda: library(x))}
        if need_dt or need_dx:
            out["U"][label] = both_ms(lambda: TP.triplane_encode_bwd(
                pspec, planes, x, g, need_dt, need_dx))
        if need_dt:
            out["U_serial"][label] = both_ms(
                lambda: TP.triplane_encode_bwd_serial(pspec, planes, x, g,
                                                      need_dx))
        if label in (ba1[0], "BA 1 kf ray-ordered"):
            gd = tensor(np.random.default_rng(1).standard_normal(
                (n, dspec.out_dim)))
            out["A"][label] = both_ms(
                lambda: HP.grid_encode_fwd(dspec, dense, x))
            out["B"][label] = both_ms(lambda: HP.grid_encode_bwd(
                dspec, dense, x, gd, True, False))
        torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points",
                    help="ray-ordered points [N, 3] (numpy .npy; times B, H)")
    ap.add_argument("--xor-points",
                    help="room0_xor's ray-ordered points (times E, A, C, D)")
    ap.add_argument("--vm-points",
                    help="room0_vm's ray-ordered points (with --xor-points)")
    ap.add_argument("--hybrid",
                    help="room0_hybrid's ray-ordered points (times T, U and "
                         "A, B at its dense levels)")
    ap.add_argument("--serial", action="store_true",
                    help="time the serial modes of B, U and D in phases "
                         "(with --points, --vm-points and --hybrid, or "
                         "--record)")
    ap.add_argument("--record", action="store_true",
                    help="record the ray-ordered points of room0, room0_vm "
                         "and room0_hybrid first (saved under output/)")
    ap.add_argument("--probes", action="store_true",
                    help="also kernel P in every form at the probes' shapes")
    ap.add_argument("--host-us", action="store_true",
                    help="also the host's us per call of the A and C wrappers")
    ap.add_argument("--out", help="also write the JSON line here")
    ap.add_argument("--profile", action="store_true",
                    help="also each kernel's device time (torch.profiler)")
    args = ap.parse_args(argv)
    if bool(args.xor_points) != bool(args.vm_points) and not args.serial:
        ap.error("--xor-points and --vm-points go together")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    device = torch.device("cuda", 0)

    def load(path):
        return torch.from_numpy(np.load(path).astype(np.float32)).to(device)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    import coslam_torch

    rec = {"card": card, "package": coslam_torch.__file__}
    if args.points:
        ray = load(args.points)
        uniform = torch.from_numpy(np.random.default_rng(2).uniform(
            0, 1, ray.shape).astype(np.float32)).to(device)
        rec.update(time_b_and_h(device, {"uniform": uniform, "ray": ray},
                                args.profile))
    if args.serial:
        if args.record:
            pts = record_points(device)
        elif args.points and args.vm_points and args.hybrid:
            pts = {"B": load(args.points), "D": load(args.vm_points),
                   "U": load(args.hybrid)}
        else:
            ap.error("--serial needs --record or --points, --vm-points and "
                     "--hybrid")
        rec["serial"] = time_serial(device, pts)
    if args.probes:
        rec["probes"] = time_p(device)
    if args.host_us:
        rec["host_us"] = wrapper_host_us(device)
    if args.xor_points or args.hybrid:
        rec["l2_gather"] = l2_rate(device)
    if args.xor_points:
        rec.update(time_e_and_d(device, load(args.xor_points),
                                load(args.vm_points), rec["l2_gather"]))
    if args.hybrid:
        rec["hybrid"] = time_t_and_u(device, load(args.hybrid),
                                     rec["l2_gather"])
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
