"""Kernels B and H, and E and D, at the BA 1-keyframe case, on uniform
and ray-ordered points.

    python -m coslam_torch.tools.kernel_times --points FILE
        [--xor-points FILE] [--vm-points FILE] [--out FILE] [--profile]

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

With ``--xor-points`` and ``--vm-points`` (the ray-ordered points of the
room0_xor and room0_vm slices' first BA calls, which ``chip_smoke.py``
saves as ``output/ba_points_xor.npy`` and ``output/ba_points_vm.npy``) it
also times kernel E (``hash_pallas.xor_grid_encode_fwd`` at the room0_xor
spec) and kernel A (``hash_packed.grid_encode_fwd`` at the room0 spec,
the same point count) at the BA 1-keyframe case on uniform and
ray-ordered points, and kernel D (``tensovm.tensovm_encode_bwd`` at the
room0_vm spec) at every case of that slice that asks for a gradient
(``main_path_cases``), uniform, and at the BA 1-keyframe case on the
ray-ordered points; beside each time of E and D its L2 figure
(``l2_rate``, ``e_l2_sectors``, ``d_l2_sectors``).

The script calls only what earlier checkouts of the port also have
(``grid_encode_fwd``, ``grid_encode_bwd``, ``xor_grid_encode_fwd``,
``xor_grid_encode_bwd``, ``tensovm_encode_bwd``, ``row_accum``), so it also
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


def main_path_cases(cfg: dict, frames: int) -> list:
    """(label, points, need_table, need_dx) of every encode call the
    slice makes, from its config: points are rays x samples per ray.
    Only a BA call with >= 2 keyframes optimizes poses, so only it and
    tracking ask for dx; a BA call's current-frame quota is
    max(sample // kf_count, min_pixels_cur), with the keyframe count
    before that frame's keyframe is added; the hash grid's smoothness
    lattice is encoded as constant points (TensoVM's analytic TV encodes
    none); the mesh only queries."""
    from coslam_torch.mesh.extract import CHUNK
    from coslam_torch.models.scene_rep import is_tensovm

    tr, mc = cfg["training"], cfg["mapping"]
    z = tr["n_samples_d"] + tr["n_range_d"]
    S = mc["sample"]
    cases = [("first frame", S * z, True, False),
             ("tracking", cfg["tracking"]["sample"] * z, False, True)]
    kf_counts = sorted({(i - 1) // mc["keyframe_every"] + 1
                        for i in range(1, frames) if i % mc["map_every"] == 0})
    for kf in kf_counts:
        quota = min(max(S // kf, mc["min_pixels_cur"]), S)
        cases.append((f"BA {kf} kf", (S + quota) * z, True, kf >= 2))
    if not is_tensovm(cfg):
        cases.append(("lattice", (tr["smooth_pts"] - 1) ** 3, True, False))
    cases.append(("mesh chunk", CHUNK, False, False))
    return cases


# The L2 figure of E and D. Their tables stay in the 50 MB L2, so what they
# pay for is scattered 32-byte sector accesses there, which the DRAM-byte
# bound does not count. l2_rate measures the card's rate for such accesses
# in the same run (a plain gather from an L2-resident table), and
# e_l2_sectors / d_l2_sectors count the sector accesses a call's work
# needs from L2 on this run's points: per (point, level) the distinct
# sectors of the rows it reads (no reuse between points counted: that is
# L1's part), each output or streamed input sector once, and each atomic
# instruction of D's plane gradient as one sector access (an atomic costs
# L2 more than a read, so this is a floor).

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


def time_e_and_d(device, xor_ray: torch.Tensor, vm_ray: torch.Tensor,
                 l2: dict) -> dict:
    """{"E": {set: times}, "A": {set: times}, "D": {case: times}}: kernel
    E and kernel A at the BA 1-keyframe point count of room0_xor on
    uniform points (seed 2) and on `xor_ray`; kernel D at every case of
    room0_vm that asks for a gradient (uniform points, seed 2) and at its
    BA 1-keyframe case on `vm_ray`. Tables as in chip_smoke.py (E and A
    unit normal, seed 0; D planes 0.1 x noise, lines 1 + 0.1 x noise,
    seed 0), cotangents unit normal, seed 1. Every E and D time carries
    its L2 figure ``l2_ms`` (sector accesses over ``l2``'s rate), and so
    does A's."""
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
    out = {"E": {}, "A": {}, "D": {}}
    for name, x in (("uniform", uniform(xor_ray.shape[0])), ("ray", xor_ray)):
        out["E"][name] = {
            "points": int(x.shape[0]),
            **both_ms(lambda: XP.xor_grid_encode_fwd(xspec, xtable, x)),
            **l2_ms(e_l2_sectors(xspec, x))}
        out["A"][name] = {
            **both_ms(lambda: HP.grid_encode_fwd(hspec, htable, x)),
            **l2_ms(a_l2_sectors(hspec, x))}

    vspec = VM.make_tensovm_spec(400, 3)
    rng = np.random.default_rng(0)
    planes = tensor(0.1 * rng.standard_normal((vspec.total_entries, 2)))
    lines = tensor(1.0 + 0.1 * rng.standard_normal(
        (VM.line_total_rows(vspec), 2)))
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", required=True,
                    help="ray-ordered points [N, 3] (numpy .npy)")
    ap.add_argument("--xor-points",
                    help="room0_xor's ray-ordered points (times E, A, D)")
    ap.add_argument("--vm-points",
                    help="room0_vm's ray-ordered points (with --xor-points)")
    ap.add_argument("--out", help="also write the JSON line here")
    ap.add_argument("--profile", action="store_true",
                    help="also each kernel's device time (torch.profiler)")
    args = ap.parse_args(argv)
    if bool(args.xor_points) != bool(args.vm_points):
        ap.error("--xor-points and --vm-points go together")
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA card")
    device = torch.device("cuda", 0)

    def load(path):
        return torch.from_numpy(np.load(path).astype(np.float32)).to(device)

    ray = load(args.points)
    uniform = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 1, ray.shape).astype(np.float32)).to(device)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    import coslam_torch

    rec = {"card": card, "package": coslam_torch.__file__,
           **time_b_and_h(device, {"uniform": uniform, "ray": ray},
                          args.profile)}
    if args.xor_points:
        rec["l2_gather"] = l2_rate(device)
        rec.update(time_e_and_d(device, load(args.xor_points),
                                load(args.vm_points), rec["l2_gather"]))
    line = json.dumps(rec)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
