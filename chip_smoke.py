#!/usr/bin/env python3
"""Smoke run of coslam_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Run from the repository root. Phases, each printing its own lines:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile the CUDA kernels from coslam_torch/csrc with nvcc;
3. kernels: the hash-grid kernels A and B at the room0 spec and the
   TensoVM kernels C and D at the room0_vm spec, each against its plain
   PyTorch version at every shape its slice gives it (main_path_cases),
   with the tolerances below, and both timed with CUDA events;
4. slices: the sequential SLAM loop (CoSLAM.run) at room0's model width
   and recipe (hash grid), then at room0_vm's (TensoVM), on one 15-frame
   480x640 analytic synthetic scene, each checked for finite losses,
   keyframes 0, 5 and 10, ATE RMSE < 10 cm, a mesh, and launches of its
   two kernels on the path (every count set to 0 just before the slice
   and read just after it).

The last three lines are the card's name and power limit as nvidia-smi
prints them, the kernels' JSON record and
``{"ok": true, "device": {...}}``. Any failure raises: the script then
exits non-zero before those lines. Without a CUDA device it exits
non-zero at once.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

from coslam_torch.data.synth import (SyntheticFrames, room0_config,
                                     room0_vm_config)

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances against the plain version. Forward: the same products in
# the same order (FMA contraction moves the last bit). Backward: f32
# atomics add in an order that changes from run to run, so each table
# entry (dtable, dplanes, dlines) carries the sum-order error of its many
# contributions. A dx entry sums 16 levels x 4 corners x 2 features
# (TensoVM: 3 levels x 3 sections x 2 features, plane and line terms) of
# terms scaled by the resolution (up to 399) with unit-normal cotangent,
# so its terms reach hundreds and an entry near zero keeps an absolute
# error near 1e-4: hence atol 1e-3 on dx.
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
TABLE_TOL = dict(rtol=1e-4, atol=1e-5)
DX_TOL = dict(rtol=1e-4, atol=1e-3)

N_FRAMES = 15
H, W = 480, 640


def _phase(name: str):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def _time_ms(fn, batches: int = 5, per_batch: int = 20,
             warmup: int = 5) -> float:
    """ms per call of fn: CUDA events around `per_batch` back-to-back
    calls, so the queue stays fed, divided by the count; the median of
    `batches` such batches after warm-up."""
    import torch

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


def _tensor(device, a):
    import torch

    return torch.from_numpy(a.astype(np.float32)).to(device)


class HashKernels:
    """Kernels A and B at the room0 spec: unit-normal table."""

    source = "coslam_torch/csrc/grid_encode.cu"
    # The pallas_call of each TPU kernel a kernel replaces; the backward
    # replaces two (the hashed and the dense table gradient).
    record = {"grid_encode_fwd": {
                  "replaces": "coslam_tpu/ops/hash_packed.py:323"},
              "grid_encode_bwd": {
                  "replaces": "coslam_tpu/ops/hash_packed.py:411",
                  "also_replaces": ["coslam_tpu/ops/serial_scatter.py:77"]}}

    def __init__(self, device, rng):
        from coslam_torch.ops import hash_packed as HP

        self.m = HP
        self.fwd_fn, self.bwd_fn = HP.grid_encode_fwd, HP.grid_encode_bwd
        self.spec = HP.make_packed_spec(400, 16)
        self.table = _tensor(device, rng.standard_normal(
            (self.spec.total_entries, self.spec.n_features)))

    def fwd(self, x, plain=False):
        fn = self.m.grid_encode_fwd_ref if plain else self.m.grid_encode_fwd
        return fn(self.spec, self.table, x)

    def bwd(self, x, g, need_table, need_dx, plain=False):
        fn = self.m.grid_encode_bwd_ref if plain else self.m.grid_encode_bwd
        return dict(zip(("dtable", "dx"), fn(self.spec, self.table, x, g,
                                             need_table, need_dx)))


class TensoVMKernels:
    """Kernels C and D at the room0_vm spec: planes 0.1 x noise, lines
    1 + 0.1 x noise; mapping asks for dplanes and dlines together."""

    source = "coslam_torch/csrc/tensovm_encode.cu"
    # Kernel C has no pallas_call to replace: it computes what XLA
    # computed on the TPU, tensovm_encode_fwd_only (gather_quads, the
    # forward of make_line_eval, _vm_combine). Kernel D's plane-table
    # gradient replaces K3 for its caller plane_quad.cell_scatter_grad.
    record = {"tensovm_encode_fwd": {
                  "replaces": "coslam_tpu/ops/tensovm.py:321",
                  "pallas_call": False,
                  "computes": ["coslam_tpu/ops/plane_quad.py:108",
                               "coslam_tpu/ops/tensovm.py:136",
                               "coslam_tpu/ops/tensovm.py:287"]},
              "tensovm_encode_bwd": {
                  "replaces": "coslam_tpu/ops/serial_scatter.py:77",
                  "caller": "coslam_tpu/ops/plane_quad.py:160"}}

    def __init__(self, device, rng):
        from coslam_torch.ops import tensovm as VM

        self.m = VM
        self.fwd_fn, self.bwd_fn = VM.tensovm_encode_fwd, VM.tensovm_encode_bwd
        self.spec = VM.make_tensovm_spec(400, 3)
        F = self.spec.n_features
        self.planes = _tensor(device, 0.1 * rng.standard_normal(
            (self.spec.total_entries, F)))
        self.lines = _tensor(device, 1.0 + 0.1 * rng.standard_normal(
            (VM.line_total_rows(self.spec), F)))

    def fwd(self, x, plain=False):
        fn = (self.m.tensovm_encode_fwd_ref if plain
              else self.m.tensovm_encode_fwd)
        return fn(self.spec, self.planes, self.lines, x)

    def bwd(self, x, g, need_table, need_dx, plain=False):
        fn = (self.m.tensovm_encode_bwd_ref if plain
              else self.m.tensovm_encode_bwd)
        return dict(zip(("dplanes", "dlines", "dx"),
                        fn(self.spec, self.planes, self.lines, x, g,
                           need_table, need_table, need_dx)))


def check_kernels(device, kernels, cases: list) -> dict:
    """The forward and backward kernel of `kernels` against their plain
    versions on each case of `cases`. Returns {kernel name:
    {"max_abs_err", "ms", "plain_ms"}}, the times at the case with the
    most points that runs the backward."""
    import torch

    rng = np.random.default_rng(1)
    fwd, bwd = kernels.fwd_fn.__name__, kernels.bwd_fn.__name__
    out = {fwd: {"max_abs_err": 0.0}, bwd: {"max_abs_err": 0.0}}

    def err(name, a, b, tol, what):
        torch.testing.assert_close(a, b, **tol, msg=lambda m: f"{what}: {m}")
        e = float((a - b).abs().max())
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)
        return f"{what} err {e:.3g}"

    timed = max((c for c in cases if c[2] or c[3]), key=lambda c: c[1])
    for label, n, need_table, need_dx in cases:
        x = _tensor(device, rng.uniform(0, 1, (n, 3)))
        g = _tensor(device, rng.standard_normal((n, kernels.spec.out_dim)))
        line = [f"{label} N={n}",
                err(fwd, kernels.fwd(x), kernels.fwd(x, plain=True), FWD_TOL,
                    "fwd")]
        times = {"fwd": _time_ms(lambda: kernels.fwd(x)),
                 "fwd_plain": _time_ms(lambda: kernels.fwd(x, plain=True))}
        if need_table or need_dx:
            got = kernels.bwd(x, g, need_table, need_dx)
            ref = kernels.bwd(x, g, need_table, need_dx, plain=True)
            torch.cuda.synchronize()
            for what, a in got.items():
                assert (a is None) == (ref[what] is None), what
                if a is not None:
                    line.append(err(bwd, a, ref[what],
                                    DX_TOL if what == "dx" else TABLE_TOL,
                                    what))
            times.update(
                bwd=_time_ms(lambda: kernels.bwd(x, g, need_table, need_dx)),
                bwd_plain=_time_ms(lambda: kernels.bwd(
                    x, g, need_table, need_dx, plain=True)))
        line += [f"{k} {v:.4f} ms" for k, v in times.items()]
        print("  " + ", ".join(line), flush=True)
        if label == timed[0]:
            out[fwd].update(ms=times["fwd"], plain_ms=times["fwd_plain"])
            out[bwd].update(ms=times["bwd"], plain_ms=times["bwd_plain"])
    return out


def run_slice(device, cfg: dict, data, wrappers, own) -> dict:
    """CoSLAM.run on the synthetic frames `data`; returns the launch
    counts of every kernel wrapper in `wrappers` over the run (each set
    to 0 just before it), after checking what the run produced, that the
    slice's own kernels `own` were launched on the path, and printing its
    summary."""
    import torch

    from coslam_torch.runtime.slam import CoSLAM

    frames = data.num_frames
    slam = CoSLAM(cfg, data, device=device)

    for fn in wrappers:
        fn.launches = 0
    t0 = time.perf_counter()
    res = slam.run(verbose=False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in wrappers}

    losses = [v for vals in slam.losses.values() for v in vals]
    assert losses and all(math.isfinite(v) for v in losses), slam.losses
    assert slam.kf_db.count == 3, slam.kf_db.count
    assert list(slam.kf_db.frame_ids[:3]) == [0, 5, 10], slam.kf_db.frame_ids
    ate = res["absolute_translational_error.rmse"]
    assert math.isfinite(ate) and ate < 0.10, ate
    n_vert = len(slam.final_mesh.vertices)
    assert n_vert > 100, n_vert
    mcfg, tcfg = cfg["mapping"], cfg["tracking"]
    n_track = (frames - 1) * tcfg["iter"]
    n_ba = len(slam.timings["mapping"]) * mcfg["iters"]
    if device.type == "cuda":
        for fn in own:
            n = launches[fn.__name__]
            assert n >= n_track + n_ba, (fn.__name__, n, n_track + n_ba)
    t = slam.timings
    summary = {
        "wall_s": wall,
        "first_frame_s": t["first_frame"][0],
        "tracking_ms_median": 1e3 * float(np.median(t["tracking"])),
        "ba_ms_median": 1e3 * float(np.median(t["mapping"])),
        "mesh_s": t["mesh"][-1],
        "ate_rmse_m": ate,
        "mesh_vertices": n_vert,
        "keyframes": slam.kf_db.count,
        "tracking_steps": n_track,
        "ba_iterations": n_ba,
        "launches": launches,
    }
    print("  " + json.dumps(summary), flush=True)
    return launches


def main() -> int:
    import torch

    t = _phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA "
              "card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"  {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"  nvidia-smi: {smi}", flush=True)

    from coslam_torch.ops import _kernels

    t = _phase("build")
    _kernels.build(verbose=True)
    _kernels.library()
    print(f"  build {time.perf_counter() - t:.1f} s", flush=True)

    out = os.path.join(REPO, "output")
    slices = [(room0_config(out, H, W, N_FRAMES, exp_name="chip_smoke"),
               HashKernels(device, np.random.default_rng(0))),
              (room0_vm_config(out, H, W, N_FRAMES, exp_name="chip_smoke_vm"),
               TensoVMKernels(device, np.random.default_rng(0)))]
    wrappers = [fn for _, k in slices for fn in (k.fwd_fn, k.bwd_fn)]

    kernels = {}
    for cfg, k in slices:
        _phase(f"kernels against the plain versions: {k.source}")
        kernels.update(check_kernels(device, k,
                                     main_path_cases(cfg, N_FRAMES)))

    t = time.perf_counter()
    data = SyntheticFrames(slices[0][0], N_FRAMES)
    print(f"  rendered {N_FRAMES} frames {H}x{W} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    records = []
    for cfg, k in slices:
        t = _phase(f"slice: CoSLAM.run at {cfg['data']['exp_name']} "
                   f"({cfg['grid']['enc']})")
        own = [k.fwd_fn, k.bwd_fn]
        counts = run_slice(device, cfg, data, wrappers, own)
        print(f"  slice {time.perf_counter() - t:.1f} s", flush=True)
        for fn in own:
            kname = fn.__name__
            records.append({
                "name": kname, "route": "cuda", "source": k.source,
                "replaces": k.record[kname]["replaces"],
                "launches": counts[kname], **kernels[kname],
                **{key: v for key, v in k.record[kname].items()
                   if key != "replaces"}})
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
