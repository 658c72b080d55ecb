"""Where the slice's time goes: per-phase walls and a device profile.

    python -m coslam_torch.tools.profile_slice [--device cuda|cpu]
        [--vm | --xor | --hybrid | --tum | --pipelined] [--deterministic]
        [--small] [--out DIR]

Drives the same CoSLAM as chip_smoke.py (room0's model and recipe, with
``--vm`` room0_vm's TensoVM model and recipe, with ``--xor``
room0_xor's XOR-hash grid with grad_impl pallas, with ``--hybrid``
room0_hybrid's TriPlaneHybrid grid, or with ``--tum`` the TUM reference
recipe at fr1_desk's width (data/synth.py:tum_config: 85 + 128
importance samples per ray, 20 BA iterations), on the in-memory
analytic scene, 480 x 640, 11 frames): first-frame mapping,
tracking of frames 1-9, a keyframe at frame 5, then BA calls on frame 10
with 2 keyframes, then the final mesh. It reports

- the wall of first-frame mapping, of each tracking step after the
  warm-up on frames 1-4, of three BA calls (the first one carries the
  BA's warm-up), and of the mesh's phases (SDF and color queries, host
  marching cubes, PLY export);
- for one tracking step and one BA call under torch.profiler: the wall,
  the device busy time (the union of kernel, memcpy and memset intervals
  in the trace), its share of the wall, the kernel launch count and the
  kernels that take the most device time; and, under each of the
  program's ranges (runtime/spans.py: ``coslam.tracking.forward`` and
  so on), the ranges' count and host time, the launches and the device's
  idle seconds (:func:`range_stats`).

``--pipelined`` instead profiles room0's whole 15-frame run twice under
torch.profiler, the pipelined runtime (runtime/pipeline.py) and then the
sequential loop (after one unprofiled sequential run that warms the
card up): for each, the wall, the device busy time and share, the
launches and the frame-time report of runtime/latency.attribute_tails;
for the pipelined run also each stream's busy time, named by the
thread that launched on it (the tracker's or the mapper's), and the
time both streams were busy at once (their busy overlap), and the
mapper's lag behind the tracker after each BA.

``--deterministic`` runs the slice under
``torch.use_deterministic_algorithms(True)`` (with
``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless the environment sets it), so
every table gradient takes its serial-order route (kernels B's, D's and
U's serial modes, H).

The profiler's own overhead lengthens the profiled walls; the unprofiled
walls are the ones to compare with. The summary goes to stdout and to
DIR/profile_slice.json. ``--small`` cuts the frames to 7 of 48 x 64, the
grid, the rays, the iterations (2 a tracking step and a BA call), the TV
lattice and the mesh resolution, for a check on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Callable, Dict

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..data.synth import (SyntheticFrames, room0_config,
                          room0_hybrid_config, room0_vm_config,
                          room0_xor_config, tum_config)
from ..mesh import extract as E
from ..ops import _kernels
from ..ops import hash_packed as HP
from ..ops import hash_pallas as XP
from ..ops import serial_scatter as SS
from ..ops import tensovm as VM
from ..ops import triplane as TP
from ..runtime.slam import CoSLAM
from ..runtime.spans import RANGE_PREFIX

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def trace_stats(prof, path: str, top: int = 12) -> Dict:
    """Device busy time, launch count and top kernels of a profile, and
    what lies under each of the program's ranges (:func:`range_stats`),
    read from its exported chrome trace (removed afterwards)."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    dev = [e for e in events if e.get("cat") in _DEVICE_CATS]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    by_name: Dict[str, list] = {}
    for e in kernels:
        row = by_name.setdefault(e["name"][:60], [0, 0.0])
        row[0] += 1
        row[1] += e["dur"]
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"launches": len(kernels),
            "device_busy_us": _busy_us((e["ts"], e["ts"] + e["dur"])
                                       for e in dev),
            "kernel_us": sum(e["dur"] for e in kernels),
            "top": [(k, n, us) for k, (n, us) in ranked],
            "ranges": range_stats(events)}


def range_stats(events, prefix: str = RANGE_PREFIX) -> Dict:
    """What lies under each of the program's ranges in a chrome trace's
    ``traceEvents`` (the ``user_annotation`` ranges whose names start
    with ``prefix``; keys are the names without it, "none" for what
    lies in no range): {"ranges": name -> [count, host us], "launches":
    name -> kernels whose launch (the host call of the kernel's
    correlation id) lies in the range, "idle_us": name -> the device's
    idle us, each gap between the union of kernel, memcpy and memset
    intervals within the ranges' extent put down to the range that holds
    its midpoint}. A launch goes to the innermost range open on its own
    thread, else (autograd launches the backward's kernels from a thread
    of its own while the caller's range stays open) to the innermost on
    any thread. An idle gap has no thread: it goes to the innermost
    range on any thread, so the idle split holds for a profile whose
    ranges come from one thread at a time, as the steps profiled here
    do. {} without a range."""
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len(prefix):],
                     e.get("tid"))
                    for e in events if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(prefix))
    if not ranges:
        return {}

    def innermost(t, tid=None) -> str:
        # Sorted by start, the last range that holds t is the innermost.
        mine = anyone = "none"
        for lo, hi, n, on in ranges:
            if lo > t:
                break
            if t <= hi:
                anyone = n
                if on == tid:
                    mine = n
        return mine if mine != "none" else anyone

    out: Dict = {"ranges": {}, "launches": {}, "idle_us": {}}
    for lo, hi, n, _ in ranges:
        row = out["ranges"].setdefault(n, [0, 0.0])
        row[0] += 1
        row[1] += hi - lo
    launched = {e["args"]["correlation"]: (e["ts"], e.get("tid"))
                for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    for e in events:
        if e.get("cat") == "kernel":
            at = launched.get(e.get("args", {}).get("correlation"))
            n = "none" if at is None else innermost(*at)
            out["launches"][n] = out["launches"].get(n, 0) + 1
    busy = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in _DEVICE_CATS)
    cur, hi = ranges[0][0], max(r[1] for r in ranges)
    for s, e in busy + [(hi, hi)]:
        if s > cur:
            gap_end = min(s, hi)
            n = innermost(0.5 * (cur + gap_end))
            out["idle_us"][n] = out["idle_us"].get(n, 0.0) + gap_end - cur
        cur = max(cur, e)
        if cur >= hi:
            break
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    grid = ap.add_mutually_exclusive_group()
    grid.add_argument("--vm", action="store_true",
                      help="room0_vm's TensoVM grid, not room0's hash grid")
    grid.add_argument("--xor", action="store_true",
                      help="room0_xor's XOR-hash grid (grad_impl pallas)")
    grid.add_argument("--hybrid", action="store_true",
                      help="room0_hybrid's TriPlaneHybrid grid (kernels A "
                           "and B on its dense levels, T and U on its "
                           "planes)")
    grid.add_argument("--tum", action="store_true",
                      help="the TUM recipe (tum_config: the hash grid at "
                           "fr1_desk's width, the importance fine pass)")
    grid.add_argument("--pipelined", action="store_true",
                      help="room0's run through the pipelined runtime "
                           "beside the sequential loop: each stream's busy "
                           "time and their overlap")
    ap.add_argument("--deterministic", action="store_true",
                    help="under torch.use_deterministic_algorithms(True)")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=os.path.join("output", "profile_slice"))
    args = ap.parse_args(argv)
    was = torch.are_deterministic_algorithms_enabled()
    if args.deterministic:
        # cuBLAS reads it when it starts, which is after this point.
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    try:
        return (_profile_pipelined if args.pipelined else _profile)(args)
    finally:
        torch.use_deterministic_algorithms(was)


def _start(dev: torch.device, out: str) -> Dict:
    """The card's name and power limit, and the kernels built (on CUDA)."""
    os.makedirs(out, exist_ok=True)
    res: Dict = {}
    if dev.type == "cuda":
        res["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        res["torch"] = f"{torch.__version__}, CUDA {torch.version.cuda}"
        print(res["card"], res["torch"], flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        _kernels.build()
        _kernels.library()
    return res


def _small(cfg: Dict) -> None:
    """--small's cuts of a config, for a check on the CPU."""
    cfg["grid"].update(hash_size=12, voxel_sdf=64)
    cfg["training"]["smooth_pts"] = 8
    cfg["mapping"].update(first_iters=5, sample=64, iters=2)
    cfg["tracking"].update(sample=32, iter=2)
    cfg["mesh"]["voxel_final"] = 0.2


def _profile(args) -> Dict:
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    res = _start(dev, args.out)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    # Frames 1-4 warm tracking up, frame 5 becomes the second keyframe.
    nf, H, W = (7, 48, 64) if args.small else (11, 480, 640)
    make_cfg, encode_fns = (
        (room0_vm_config, (VM.tensovm_encode_fwd, VM.tensovm_encode_bwd,
                           VM.tensovm_encode_bwd_serial))
        if args.vm else
        (room0_xor_config, (XP.xor_grid_encode_fwd, XP.xor_grid_encode_bwd,
                            SS.row_accum_segmented))
        if args.xor else
        (room0_hybrid_config, (HP.grid_encode_fwd, HP.grid_encode_bwd,
                               HP.grid_encode_bwd_serial,
                               TP.triplane_encode_fwd, TP.triplane_encode_bwd,
                               TP.triplane_encode_bwd_serial))
        if args.hybrid else
        (tum_config, (HP.grid_encode_fwd, HP.grid_encode_bwd,
                      HP.grid_encode_bwd_serial))
        if args.tum else
        (room0_config, (HP.grid_encode_fwd, HP.grid_encode_bwd,
                        HP.grid_encode_bwd_serial)))
    cfg = make_cfg(os.path.join(args.out, "run"), H, W, nf,
                   exp_name="profile_slice")
    if args.small:
        _small(cfg)
    data = SyntheticFrames(cfg, nf)
    slam = CoSLAM(cfg, data, device=dev)

    def wall_s(fn: Callable) -> float:
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return time.perf_counter() - t0

    def profiled(name: str, fn: Callable) -> None:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        with profile(activities=acts) as prof:
            wall_us = 1e6 * wall_s(fn)
        st = trace_stats(prof, os.path.join(args.out, f"{name}.trace.json"))
        st["wall_us_profiled"] = wall_us
        st["busy_share_of_profiled_wall"] = st["device_busy_us"] / wall_us
        res[name] = st

    res["first_frame_s"] = wall_s(lambda: slam.first_frame_mapping(data[0]))
    for i in range(1, 5):
        slam.tracking_render(data[i], i)
    res["tracking_step_ms"] = [
        1e3 * wall_s(lambda i=i: slam.tracking_render(data[i], i))
        for i in range(5, nf - 1)]
    profiled("tracking_step",
             lambda: slam.tracking_render(data[nf - 1], nf - 1))
    slam.add_keyframe(data[5])
    res["ba_call_ms"] = [1e3 * wall_s(lambda: slam.global_BA(data[nf - 1],
                                                              nf - 1))
                         for _ in range(3)]
    profiled("ba_call", lambda: slam.global_BA(data[nf - 1], nf - 1))

    # The mesh's phases on the host clock, through the module's own names.
    phases: Dict[str, float] = {}

    def timed(name: str, fn: Callable) -> Callable:
        def wrapped(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            phases[name] = phases.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapped

    saved = E._chunked_query, E.marching_cubes, E.TriMesh.export
    E._chunked_query = timed("queries", saved[0])
    E.marching_cubes = timed("marching_cubes", saved[1])
    E.TriMesh.export = timed("export", saved[2])
    try:
        t0 = time.perf_counter()
        mesh = slam.save_mesh(nf - 1, voxel_size=cfg["mesh"]["voxel_final"])
        res["mesh_s"] = time.perf_counter() - t0
    finally:
        E._chunked_query, E.marching_cubes, E.TriMesh.export = saved
    res["mesh_phases_s"] = phases
    res["mesh_vertices"] = len(mesh.vertices)
    res["encode_launches"] = {fn.__name__: fn.launches for fn in encode_fns}
    res["deterministic"] = torch.are_deterministic_algorithms_enabled()
    res["tracking_step_ms_median"] = float(np.median(res["tracking_step_ms"]))
    with open(os.path.join(args.out, "profile_slice.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1), flush=True)
    return res


def _stream_stats(events, a_launches: Dict[str, int]) -> Dict:
    """Each CUDA stream's busy time in a trace and the busy overlap of the
    tracker's and the mapper's streams. A stream is named by the thread
    whose count of kernel A's launches on its stream (``a_launches``,
    from the wrapper's count by stream) equals the trace's count of
    grid_encode_fwd_kernel on it; else by its number."""
    spans: Dict[str, list] = {}
    a_kernels: Dict[str, int] = {}
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        stream = e.get("args", {}).get("stream")
        spans.setdefault(stream, []).append((e["ts"], e["ts"] + e["dur"]))
        if "grid_encode_fwd_kernel" in e.get("name", ""):
            a_kernels[stream] = a_kernels.get(stream, 0) + 1
    unique = len(set(a_launches.values())) == len(a_launches)
    out: Dict = {"streams": {}}
    named: Dict[str, list] = {}
    for stream, sp in spans.items():
        label = next((name for name, n in a_launches.items()
                      if unique and n and a_kernels.get(stream) == n),
                     f"stream {stream}")
        out["streams"][label] = {"stream": stream, "busy_us": _busy_us(sp),
                                 "device_events": len(sp),
                                 "a_kernels": a_kernels.get(stream, 0)}
        named[label] = sp
    # Where the trace's thread ids do not name the streams, the two
    # busiest streams are taken for the two threads'.
    pair = (["tracker", "mapper"] if "tracker" in named and "mapper" in named
            else sorted(named, key=lambda k: -out["streams"][k]["busy_us"]
                        )[:2])
    out["overlap_of"] = pair
    out["overlap_us"] = (sum(_busy_us(named[k]) for k in pair)
                         - _busy_us(named[pair[0]] + named[pair[1]])
                         if len(pair) == 2 else None)
    return out


def _profile_pipelined(args) -> Dict:
    """--pipelined: the module docstring."""
    from ..runtime.latency import attribute_tails
    from ..runtime.pipeline import PipelinedCoSLAM

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    res = _start(dev, args.out)
    nf, H, W = (7, 48, 64) if args.small else (15, 480, 640)
    cfg = room0_config(os.path.join(args.out, "run"), H, W, nf,
                       exp_name="profile_pipelined")
    if args.small:
        _small(cfg)
    data = SyntheticFrames(cfg, nf)
    CoSLAM(cfg, data, device=dev).run(verbose=False, eval_ate=False,
                                      mesh=False)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    for name, cls in (("pipelined", PipelinedCoSLAM), ("sequential", CoSLAM)):
        slam = cls(cfg, data, device=dev)
        HP.grid_encode_fwd.by_stream.clear()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            slam.run(verbose=False, eval_ate=False, mesh=False)
            if cuda:
                torch.cuda.synchronize(dev)
            wall_us = 1e6 * (time.perf_counter() - t0)
        path = os.path.join(args.out, f"{name}.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(path)
        dev_events = [(e["ts"], e["ts"] + e["dur"]) for e in events
                      if e.get("cat") in _DEVICE_CATS]
        st = {"wall_us_profiled": wall_us,
              "device_busy_us": _busy_us(dev_events),
              "launches": sum(e.get("cat") == "kernel" for e in events),
              "frames": attribute_tails(slam.frame_walls,
                                        slam.frame_events),
              "tracking_ms_median": 1e3 * float(np.median(
                  slam.timings["tracking"])),
              "ba_ms_median": 1e3 * float(np.median(
                  slam.timings["mapping"]))}
        st["busy_share_of_profiled_wall"] = st["device_busy_us"] / wall_us
        if name == "pipelined":
            st.update(_stream_stats(events, {
                thread: HP.grid_encode_fwd.by_stream.get((handle, ""), 0)
                for thread, handle in slam.thread_streams.items()}))
            st["mapper_lag_frames"] = slam.mapper_lag
        res[name] = st
    with open(os.path.join(args.out, "profile_pipelined.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1), flush=True)
    return res


if __name__ == "__main__":
    main()
