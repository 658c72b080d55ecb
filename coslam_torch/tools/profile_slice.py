"""Where the slice's time goes: per-phase walls and a device profile.

    python -m coslam_torch.tools.profile_slice [--device cuda|cpu]
        [--vm | --xor] [--small] [--out DIR]

Drives the same CoSLAM as chip_smoke.py (room0's model and recipe, with
``--vm`` room0_vm's TensoVM model and recipe, or with ``--xor``
room0_xor's XOR-hash grid with grad_impl pallas, on the in-memory
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
  kernels that take the most device time.

The profiler's own overhead lengthens the profiled walls; the unprofiled
walls are the ones to compare with. The summary goes to stdout and to
DIR/profile_slice.json. ``--small`` cuts the frames to 7 of 48 x 64, the
grid, the rays, the TV lattice and the mesh resolution, for a check on
the CPU.
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

from ..data.synth import (SyntheticFrames, room0_config, room0_vm_config,
                          room0_xor_config)
from ..mesh import extract as E
from ..ops import _kernels
from ..ops import hash_packed as HP
from ..ops import hash_pallas as XP
from ..ops import serial_scatter as SS
from ..ops import tensovm as VM
from ..runtime.slam import CoSLAM

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
    """Device busy time, launch count and top kernels of a profile, read
    from its exported chrome trace (removed afterwards)."""
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
            "top": [(k, n, us) for k, (n, us) in ranked]}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    grid = ap.add_mutually_exclusive_group()
    grid.add_argument("--vm", action="store_true",
                      help="room0_vm's TensoVM grid, not room0's hash grid")
    grid.add_argument("--xor", action="store_true",
                      help="room0_xor's XOR-hash grid (grad_impl pallas)")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--out", default=os.path.join("output", "profile_slice"))
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    os.makedirs(args.out, exist_ok=True)
    res: Dict = {}

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    if cuda:
        res["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        res["torch"] = f"{torch.__version__}, CUDA {torch.version.cuda}"
        print(res["card"], res["torch"], flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        _kernels.build()
        _kernels.library()

    # Frames 1-4 warm tracking up, frame 5 becomes the second keyframe.
    nf, H, W = (7, 48, 64) if args.small else (11, 480, 640)
    make_cfg, encode_fns = (
        (room0_vm_config, (VM.tensovm_encode_fwd, VM.tensovm_encode_bwd))
        if args.vm else
        (room0_xor_config, (XP.xor_grid_encode_fwd, XP.xor_grid_encode_bwd,
                            SS.row_accum_segmented))
        if args.xor else
        (room0_config, (HP.grid_encode_fwd, HP.grid_encode_bwd)))
    cfg = make_cfg(os.path.join(args.out, "run"), H, W, nf,
                   exp_name="profile_slice")
    if args.small:
        cfg["grid"].update(hash_size=12, voxel_sdf=64)
        cfg["training"]["smooth_pts"] = 8
        cfg["mapping"].update(first_iters=5, sample=64)
        cfg["tracking"].update(sample=32)
        cfg["mesh"]["voxel_final"] = 0.2
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
    res["tracking_step_ms_median"] = float(np.median(res["tracking_step_ms"]))
    with open(os.path.join(args.out, "profile_slice.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1), flush=True)
    return res


if __name__ == "__main__":
    main()
