#!/usr/bin/env python3
"""Smoke run of coslam_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Run from the repository root. Phases, each printing its own lines:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile the CUDA kernels from coslam_torch/csrc with nvcc;
   render the 15-frame scene, and record the ray-ordered points of the
   first BA call of the room0, room0_xor, room0_vm and room0_hybrid
   slices (coslam_torch.tools.kernel_times.record_ba_points: 4,096 rays x
   43 samples, or x 27 for TensoVM, a ray's samples adjacent; saved to
   output/ba_points.npy, ba_points_xor.npy, ba_points_vm.npy and
   ba_points_hybrid.npy for kernel_times' --points, --xor-points,
   --vm-points and --hybrid); measure the
   card's L2 sector rate with a plain gather (kernel_times.l2_rate);
3. kernels: the hash-grid kernels A and B at the room0 spec, the
   TensoVM kernels C and D at the room0_vm spec and the XOR-hash kernels
   E and G at the room0_xor spec, each against its plain PyTorch version
   at every shape its slice gives it (main_path_cases, uniform points),
   with the tolerances below, and timed with CUDA events and under a
   CUDA graph; each pair also on the ray-ordered points of its slice's
   first BA call (the table gradient held to each entry's sum-order
   bound), timed beside the uniform case; A, C, E and D with their L2
   figure (their sector accesses over the measured rate); E and G, and A
   and B, also at the Dense grid (grid.enc: Dense, 4 dense levels, 67 M
   rows: XOR under grad_impl pallas, packed under the default) at the BA
   1-keyframe case; the tri-plane kernels T and U at room0_hybrid's planes
   at every case of that slice but the lattice, T beside the library
   route for its function (one grid_sample and a sum, within
   kernel_times.LIBRARY_TOL), and A and B at its 3
   dense levels at every case, each also on that slice's ray-ordered
   points and each table gradient within its sum-order bound; A and B at
   the TUM recipe's grid (tum_config: resolution 325, 822,884 rows) at
   every case of the TUM slice, each step's coarse case (85 samples a
   ray) and its importance fine pass's (128 a ray), each table gradient
   within its sum-order bound; then the
   row accumulate,
   kernels F (atomic: kernel P's CUDA kernel with its clip rule) and H
   (deterministic), on kernel G's update streams of every case that asks
   for the table gradient (up to 22.5 M updates) and of the room0
   slice's ray-ordered points, against the plain version, H also
   bit-identical over two calls
   and bit for bit equal to a serial np.add.at on the host at every case,
   F and H and index_add_ also under a CUDA graph, and H's three phases
   (sort, run starts, walk) each timed alone; then
   the probes' kernels P (scalar and float4 atomics; the scalar pair
   form at K10's shape), Q (packed bf16, at every vector width; its
   scalar pair form at K10's shape), R (both forms: the pairs after the
   torch pre-pass, and the raw updates with the pre-pass fused in), S (P
   with its clip rule) and V (coslam_torch/csrc/probe_accum.cu) at each
   probe's main shape against their plain versions (V also bit for bit
   on a stream where each row takes one run), P also at K5's shape on its
   random and runs streams beside index_add_, and P's pair form and skip
   rule, timed on the card alone by CUDA graphs of the calls; then the
   warp merge of P, Q, R, F and U on inputs built to break it: P in every
   form, Q at every vector width (streams, the pair form, the clip rule),
   R in both forms and F on streams of one row, runs of 31, 32, 33 and
   63 across the warps' steps, a run that ends the stream, runs outside
   the rows at both ends, and single updates outside the rows inside runs,
   M = 100,003 (R: 100,002) and W = 1-16, and U on
   the BA 1-keyframe count of points in one cell of every level (timed),
   each within the sum-order bound of its plain version; then the serial
   modes of B, D
   and U (K2 and K3 in the TPU kernels' serial order) at the BA 1-keyframe
   case and on the ray-ordered points: the same bits over two calls and
   a CUDA graph replay, within the sum-order bound of the plain version,
   the largest ulp distance from the host's plain version, the route's
   sorted output equal to a stable sort on the host of the plain
   version's update stream, and their times (and each launch's, from
   torch.profiler) beside the atomic mode's and deterministic
   index_put_(accumulate=True)'s on the plain version's stream;
4. probes: the five scatter-accumulate probes of
   coslam_torch/tools/bench (their entry points, --quick: one setting
   per kernel, at the probes' own shapes; each holds every variant to
   its plain version within the sum-order bound and raises beyond it),
   with the launch counts of P, Q, R (both forms), S and V set to 0 just
   before and read just after;
5. slices: the sequential SLAM loop (CoSLAM.run) at room0's model width
   and recipe (hash grid), at room0_vm's (TensoVM), at room0_xor's
   (the XOR hash with grad_impl pallas, kernel H) and at room0_hybrid's
   (TriPlaneHybrid: A and B on the dense levels, T and U on the planes;
   after the scatter run below), on one 15-frame
   480x640 analytic synthetic scene, each checked for finite losses,
   keyframes 0, 5 and 10, ATE RMSE < 10 cm and a mesh; then room0_xor with
   grad_impl scatter (kernel F) from the first frame to the first BA call
   (6 frames, no mesh); then the TUM slice: the TUM reference recipe at
   fr1_desk's width (tum_config: 64 + 21 samples and 128 importance
   samples a ray, 20 BA iterations, 4 loader threads, mesh.vis 5) on the
   same 15 frames written in TUM layout under output/ (write_tum_format)
   and read back through get_dataset, TUMDataset and the loop's
   prefetcher: ATE < 10 cm, its periodic meshes at frames 5 and 10 written
   by the loop's mesh worker, each periodic mesh and ATE file not empty,
   a final mesh, and A and B launched twice (coarse and fine) in every
   tracking and BA iteration. Every slice checks the launches of its
   kernels on the path (every count set to 0 just before the slice and
   read just after it), and that the mesh came from the port's own native
   marching cubes; A's and B's launches in the kernels' record are room0's
   plus the TUM slice's (and phase 8's);
6. resume, under torch.use_deterministic_algorithms(True) (with
   CUBLAS_WORKSPACE_CONFIG set at the top of this script): room0 for 15
   frames, room0_vm and room0_hybrid for 10, each writing a checkpoint
   every 5 frames,
   then a fresh CoSLAM loaded from the last periodic checkpoint and run
   to the end, its poses and every parameter tensor equal to the
   straight run's bit for bit; the serial modes launched in every
   table-gradient iteration and the atomic B and D only for tracking's
   dx (launch counts over the straight run, set to 0 just before it);
7. the current-frame step: room0 for 6 frames with cur_frame_iters 2,
   kernels A and B launched in each of its iterations, ATE < 10 cm; then
   the TUM extras: 6 frames of the TUM slice's files with
   training.frame_align, tracking.iter_point 5 (40,960 rays) and
   decoder.dtype bfloat16 (first_iters 200): finite losses, the exposure
   parameters moved from their initial value (the gauge row not), and
   kernel A launched in every point-cloud iteration;
8. the pipelined runtime and ActiveCoSLAM: PipelinedCoSLAM.run at room0
   on the 15 frames (pipelined_config), the tracker and the mapper each
   on its own non-default CUDA stream: every frame 1-14 tracked, BA once
   at each map_every frame, keyframes 0, 5 and 10, ATE < 10 cm, the two
   streams distinct, kernel A launched from both threads and kernel B's
   table gradient from the mapper's only (the launches counted by
   stream); it prints runtime/latency.attribute_tails of the frames and
   the mapper's lag beside the sequential room0 slice's tracking median
   and frame report from the same call. Then ActiveCoSLAM.run at the TUM
   recipe on the TUM slice's files (active_config: ACTIVE_SETTINGS): the
   train set grown past init_image, a keyframe chosen by information
   gain, ATE over the processed frames < 10 cm, test() with uncert_map >
   0, and the holdout info gain (pre, post) through kernel A against A's
   plain version on the same parameters and pixels (INFO_GAIN_RTOL).
   A's and B's launches in the kernels' record are room0's plus the TUM
   slice's, the pipelined run's and the active run's;
9. quality: kernels A and B at the replica quality recipe's packed grid
   (hash_size 13, resolution 125: 2 dense and 14 hashed levels), C and D
   at the rgbd recipe's TensoVM grid and at the ScanNet recipe's (the
   apartment's 9.2 m bound), each against its plain version at the shapes
   that recipe's run gives it (first frame, tracking, the BA calls with
   1, 2 and the most keyframes, the lattice, a mesh chunk), as in phase 3
   (uniform points; each table-gradient entry within its sum-order
   bound, as phase 3's ray-ordered case: the ScanNet grid's coarse plane
   rows take ~200 points each, and an entry that cancels to near 0 there
   fails TABLE_TOL's rtol); the
   sphere tracer on the card against the numpy tracer (three apartment
   frames, 1e-4); then coslam_torch.tools.quality_bench through the
   in-memory route: the replica protocol (room, 60 frames, 120x160,
   Co-SLAM culling with virtual cameras, 50 eval views; finite metrics,
   ATE < 10 cm, depth-L1 < 3 cm), the rgbd protocol (30 frames;
   finite metrics, ATE < 10 cm) and the replica protocol again with
   --enc TriPlaneHybrid (60 frames; ATE < 10 cm, depth-L1 < 3 cm), with
   every launch count set to 0 just before each run and read just after
   (A and B, C and D, and A, B, T and U launched), the phase within
   QUALITY_WALL_S; then the replica row again with --pipelined (its
   bounds; A and B launched), within QUALITY_PIPELINED_WALL_S;
10. tools, on the room0 frames and phase 6's room0 checkpoint, within
   TOOLS_WALL_S: parallel.dp on one card (run_dp_one_card: room0's
   tracking step and one BA iteration with their rays split over
   [cuda:0, cuda:0] against dp = 1 on the same generator state, A and B
   launched once more a shard an iteration; CoSLAM at parallel.dp 2
   refused with one card visible, and with two or more room0 at
   --devices 2 and the pipelined mapper on cuda:1; it prints which ran);
   coslam_torch.tools.render_view at 480 x 640 --frame --compare (A
   launched in every chunk, the image equal to A's plain version's);
   tools.tsdf_fusion of the 15 frames at 2 cm on the card (the mesh's
   accuracy and completion, the card's volume against the CPU's);
   tools.export --device cuda (the loaded program names kernel A's
   operator, launches it and matches A's plain version); and the live
   view (mesh.visualisation: 3 frames, 3 PNGs). A's and B's launches in
   the kernels' record include this phase's.

Every kernel's record carries its time (for P-V, whose calls are short
enough that the host's cost per call would show, the card's time from a
CUDA graph of the calls, and ``call_ms`` with the host's cost), its plain
version's, the time of one PyTorch call for the same function where
there is one (``library_ms``; index_add_ for the row accumulates; for S
and V also ``library_zeroed_ms``, torch.zeros + index_add_ in one graph,
the same work as theirs with their zero fill) and its bound: the
larger of the bytes it must move (each input read once, each output
written once; table rows counted as those this run's points touch) over
3.35 TB/s and its f32 operations over 67 TFLOP/s (H100 SXM).

The rows of atomics that the warp merges of F, P (at K5's shape), R
and S should issue, and U's row-pair adds, are not read from the
kernels: they
come from host models of the merge (``probe_accum.warp_runs``,
``triplane.row_pair_adds``), worked out from the indices, and are printed
on a line of their own before the last three, apart from the kernels'
record. The last three lines are the card's name and power limit as
nvidia-smi prints them, the kernels' JSON record and
``{"ok": true, "device": {...}}``. Any failure raises: the script then
exits non-zero before those lines. Without a CUDA device it exits
non-zero at once.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time

# cuBLAS reads this when it starts: with it, matrix products are
# deterministic under torch.use_deterministic_algorithms(True), which the
# resume phase turns on.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402

from coslam_torch.data.synth import (  # noqa: E402
    AnalyticScene, SyntheticFrames, make_scan_trajectory, room0_config,
    room0_hybrid_config, room0_vm_config, room0_xor_config, tum_config,
    write_tum_format)
from coslam_torch.tools.bench._common import accum_bound, bound  # noqa: E402
from coslam_torch.tools.kernel_times import (  # noqa: E402
    LIBRARY_TOL, a_l2_sectors, c_l2_sectors, d_l2_sectors, e_l2_sectors,
    h_phases, l2_rate, main_path_cases, packed_dense_spec, phase_times,
    record_ba_points, t_l2_sectors, t_library)
from coslam_torch.tools.kernel_times import (  # noqa: E402
    graph_ms as _graph_ms, time_ms as _time_ms)

REPO = os.path.dirname(os.path.abspath(__file__))

# {kernel name: {count: value}}: the rows of atomics a kernel's warp merge
# should issue and the L2 figures of the encodes (their sector accesses,
# and those over the gather rate measured in the run), from a host model
# worked out from the indices (not a reading of the kernel); printed apart
# from the kernels' record.
HOST_MODEL: dict = {}


def _host_model(name: str, **counts) -> None:
    HOST_MODEL.setdefault(name, {}).update(counts)

# Tolerances against the plain version. Forward: the same products in
# the same order (FMA contraction moves the last bit). Backward: f32
# atomics add in an order that changes from run to run, so each table
# entry (dtable, dplanes, dlines) carries the sum-order error of its many
# contributions. A dx entry sums 16 levels x 4 corners x 2 features
# (TensoVM: 3 levels x 3 sections x 2 features, plane and line terms) of
# terms scaled by the resolution (up to 399) with unit-normal cotangent,
# so its terms reach hundreds and an entry near zero keeps an absolute
# error near 1e-4: hence atol 1e-3 on dx.
# On the ray-ordered points B's dtable and D's dplanes and dlines are held
# to the sum-order bound of each entry instead (table_tol): the samples of
# a ray share coarse rows, whose thousands of contributions can cancel to
# near 0.
# Kernel G's update streams are exact: the same selects and correctly
# rounded products as the plain version. The row accumulates F and H and
# the probes' kernels P-V are held to their plain versions (index_add_,
# itself atomic on the card) within the sum-order bound of
# coslam_torch/tools/bench/_common.sum_order_tol, which no order of f32
# adds can exceed; H also to a serial np.add.at bit for bit.
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
TABLE_TOL = dict(rtol=1e-4, atol=1e-5)
DX_TOL = dict(rtol=1e-4, atol=1e-3)
EXACT = dict(rtol=0.0, atol=0.0)
TOLS = {"dx": DX_TOL, "idx": EXACT, "vals": EXACT}

N_FRAMES = 15
H, W = 480, 640


def _phase(name: str):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def _nonzero_rows(t) -> int:
    return int((t != 0).any(1).sum())


def _tensor(device, a):
    import torch

    return torch.from_numpy(a.astype(np.float32)).to(device)


class HashKernels:
    """Kernels A and B at the room0 spec (make_packed_spec(400, 16),
    835,977 rows), or at another packed spec (the Dense grid's):
    unit-normal table."""

    source = "coslam_torch/csrc/grid_encode.cu"
    graph = True     # time the backward under a CUDA graph too
    # The pallas_call of each TPU kernel a kernel replaces; the backward
    # replaces two (the hashed and the dense table gradient).
    record = {"grid_encode_fwd": {
                  "replaces": "coslam_tpu/ops/hash_packed.py:323"},
              "grid_encode_bwd": {
                  "replaces": "coslam_tpu/ops/hash_packed.py:411",
                  "also_replaces": ["coslam_tpu/ops/serial_scatter.py:77"]},
              "grid_encode_bwd_serial": {
                  "replaces": "coslam_tpu/ops/hash_packed.py:411",
                  "also_replaces": ["coslam_tpu/ops/serial_scatter.py:77"],
                  "mode": "serial order (K2, K3): B's updates produced "
                          "inside a radix sort of each level, then kernel "
                          "H's run starts and walk"}}

    def __init__(self, device, rng, spec=None):
        from coslam_torch.ops import hash_packed as HP

        self.m = HP
        self.fwd_fn, self.bwd_fn = HP.grid_encode_fwd, HP.grid_encode_bwd
        self.spec = spec or HP.make_packed_spec(400, 16)
        self.table = _tensor(device, rng.standard_normal(
            (self.spec.total_entries, self.spec.n_features)))

    def fwd(self, x, plain=False):
        fn = self.m.grid_encode_fwd_ref if plain else self.m.grid_encode_fwd
        return fn(self.spec, self.table, x)

    def bwd(self, x, g, need_table, need_dx, plain=False):
        fn = self.m.grid_encode_bwd_ref if plain else self.m.grid_encode_bwd
        return dict(zip(("dtable", "dx"), fn(self.spec, self.table, x, g,
                                             need_table, need_dx)))

    def touched_bytes(self, x, g) -> int:
        """Bytes of the table rows x reads: the rows its table gradient
        reaches (a row whose gradient sums to exactly 0 aside)."""
        dt = self.m.grid_encode_bwd_ref(self.spec, self.table, x, g, True,
                                        False)[0]
        return 4 * self.spec.n_features * _nonzero_rows(dt)

    def table_tol(self, x, g) -> dict:
        """{"dtable": the sum-order bound of each entry} on points x:
        per entry, the most two f32 sums of its contributions can differ
        (``_common.sum_order_tol``), for cases whose coarse rows take
        thousands of contributions, as the samples of a ray do."""
        import torch

        from coslam_torch.tools.bench import _common as C

        HP, spec = self.m, self.spec
        n, L, F = x.shape[0], spec.n_levels, spec.n_features
        cell, w = HP._cells_and_weights(spec, x)
        e = HP._corner_entries(spec, cell)                      # [L, 4, N]
        wz = w[:, 2, None]
        gw = g.reshape(n, L, F).permute(2, 1, 0)[:, :, None] * HP._xy_weights(w)
        idx = torch.cat([e.reshape(-1), (e + 1).reshape(-1)]).to(torch.int32)
        vals = torch.cat([(gw * (1 - wz)).reshape(F, -1),
                          (gw * wz).reshape(F, -1)], 1).T.contiguous()
        return {"dtable": C.sum_order_tol(idx, vals, spec.total_entries)}

    def serial(self, x, g):
        """Kernel B's serial mode: {"dtable"}."""
        return {"dtable": self.m.grid_encode_bwd_serial(
            self.spec, self.table, x, g, False)[0]}

    def cpu_plain(self, x, g):
        """The plain version's table gradient on the host, whose
        index_add_ adds in increasing m: the serial mode's order."""
        return {"dtable": self.m.grid_encode_bwd_ref(
            self.spec, self.table.cpu(), x.cpu(), g.cpu(), True, False)[0]}

    def serial_sorted(self, x, g):
        """((keys, vals): the sorted output of the serial mode's last call
        at x's size, global rows and values; (idx, vals): the plain
        version's update stream on the host)."""
        from coslam_torch.ops import serial_scatter as SS

        sorter = SS.serial_sort(self.m.serial_segments(self.spec, x.shape[0]),
                                self.spec.total_entries,
                                self.spec.out_dim * x.shape[0], x.device)
        return ((sorter.keys, sorter.pay), self.m.grid_encode_bwd_streams_ref(
            self.spec, self.table.cpu(), x.cpu(), g.cpu()))

    def l2_sectors(self, x, need_table, need_dx):
        """(kernel A's L2 sector accesses, None): the L2 figure is kept for
        A only."""
        return a_l2_sectors(self.spec, x), None

    def work(self, n, touched, need_table, need_dx):
        """(bytes, ops) of the forward and of the backward: per (point,
        level) 8 corners x F multiply-adds and ~26 operations for the cell
        and weights; the backward's table term the same, its dx three
        times the corner terms."""
        L, F = self.spec.n_levels, self.spec.n_features
        fwd = (12 * n + touched + 4 * n * L * F, n * L * (16 * F + 26))
        bwd = (12 * n + 4 * n * L * F + (touched + 12 * n) * need_dx
               + 4 * self.table.numel() * need_table,
               n * L * (26 + 16 * F * (need_table + 3 * need_dx)))
        return fwd, bwd


class TensoVMKernels:
    """Kernels C and D at the room0_vm spec (or another TensoVM spec):
    planes 0.1 x noise, lines 1 + 0.1 x noise; mapping asks for dplanes
    and dlines together."""

    source = "coslam_torch/csrc/tensovm_encode.cu"
    graph = True
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
                  "caller": "coslam_tpu/ops/plane_quad.py:160"},
              "tensovm_encode_bwd_serial": {
                  "replaces": "coslam_tpu/ops/serial_scatter.py:77",
                  "caller": "coslam_tpu/ops/plane_quad.py:160",
                  "mode": "serial order (K3): D's updates produced "
                          "inside a radix sort of each plane section and "
                          "the lines, then kernel H's run starts and walk"}}

    def __init__(self, device, rng, spec=None):
        from coslam_torch.ops import tensovm as VM

        self.m = VM
        self.fwd_fn, self.bwd_fn = VM.tensovm_encode_fwd, VM.tensovm_encode_bwd
        self.spec = spec or VM.make_tensovm_spec(400, 3)
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

    def touched_bytes(self, x, g) -> int:
        dp, dl, _ = self.m.tensovm_encode_bwd_ref(
            self.spec, self.planes, self.lines, x, g, True, True, False)
        return 4 * self.spec.n_features * (_nonzero_rows(dp)
                                           + _nonzero_rows(dl))

    def table_tol(self, x, g) -> dict:
        """{"dplanes", "dlines": the bound of each entry} on points x, for
        the ray-ordered case, whose coarse rows take thousands of
        contributions: the sum-order bound (``_common.sum_order_tol``)
        over the update streams of tensovm_encode_bwd_ref (4 plane
        corners and 2 line rows per (point, section)), plus 12 u (u =
        2^-24) times the sum of each update's magnitude bound, because the
        kernel's updates are not the plain version's bit for bit: FMA
        contraction changes the roundings of the line interpolation (up to
        2.5 u apart) and of the plane's two-level one (up to 5 u), and the
        two products that follow each round on their own (up to 2 u more
        each), so an update may differ by about 9 u of its magnitude (4.6 u
        seen on the card on single-update entries). That magnitude bound is
        the update with |g| and the interpolations of |planes| and |lines|,
        which no cancellation in the interpolation can exceed."""
        import torch

        from coslam_torch.tools.bench import _common as C

        VM, spec = self.m, self.spec
        n, L, F = x.shape[0], spec.pyr_levels, spec.n_features

        def updates(planes, lines, g):
            geo = VM._Geometry(spec, planes, lines, x)
            gs = g.reshape(n, L, F).permute(2, 1, 0).repeat_interleave(3, 1)
            gp, gq = gs * geo.line, gs * geo.plane
            wu, wv, f = geo.wu, geo.wv, geo.f
            return {"dplanes": [(geo.e00, gp * (1 - wu) * (1 - wv)),
                                (geo.e00 + 1, gp * (1 - wu) * wv),
                                (geo.e10, gp * wu * (1 - wv)),
                                (geo.e10 + 1, gp * wu * wv)],
                    "dlines": [(geo.l_row, gq * (1 - f)),
                               (geo.l_row + 1, gq * f)]}

        def streams(pairs):
            idx = torch.cat([e.reshape(-1) for e, _ in pairs]).to(torch.int32)
            vals = torch.cat([v.reshape(F, -1) for _, v in pairs], 1).T
            return idx, vals.contiguous()

        exact = updates(self.planes, self.lines, g)
        mags = updates(self.planes.abs(), self.lines.abs(), g.abs())
        rows = {"dplanes": spec.total_entries, "dlines": self.lines.shape[0]}
        out = {}
        for what, pairs in exact.items():
            idx, vals = streams(pairs)
            mag_idx, mag = streams(mags[what])
            slack = torch.zeros((rows[what], F), device=x.device)
            slack.index_add_(0, mag_idx.long(), mag)
            out[what] = (C.sum_order_tol(idx, vals, rows[what])
                         + 12 * 2.0 ** -24 * slack)
        return out

    def serial(self, x, g):
        """Kernel D's serial mode: {"dplanes", "dlines"}."""
        dp, dl, _ = self.m.tensovm_encode_bwd_serial(
            self.spec, self.planes, self.lines, x, g, False)
        return {"dplanes": dp, "dlines": dl}

    def cpu_plain(self, x, g):
        dp, dl, _ = self.m.tensovm_encode_bwd_ref(
            self.spec, self.planes.cpu(), self.lines.cpu(), x.cpu(), g.cpu(),
            True, True, False)
        return {"dplanes": dp, "dlines": dl}

    def serial_sorted(self, x, g):
        from coslam_torch.ops import serial_scatter as SS

        sorter = SS.serial_sort(
            self.m.serial_segments(self.spec, x.shape[0]),
            self.spec.total_entries + self.lines.shape[0],
            self.spec.out_dim * x.shape[0], x.device)
        return ((sorter.keys, sorter.pay),
                self.m.tensovm_encode_bwd_streams_ref(
                    self.spec, self.planes.cpu(), self.lines.cpu(), x.cpu(),
                    g.cpu()))

    def l2_sectors(self, x, need_table, need_dx):
        """(kernel C's, kernel D's L2 sector accesses)."""
        return (c_l2_sectors(self.spec, x),
                d_l2_sectors(self.spec, x, need_table, need_dx))

    def work(self, n, touched, need_table, need_dx):
        """Per (point, section): 4 plane corners and 2 line entries x F
        multiply-adds, the product, ~20 for cells and weights; dx three
        times the corner terms."""
        S, F = self.spec.n_levels, self.spec.n_features
        out = 4 * n * self.spec.out_dim
        fwd = (12 * n + touched + out, n * S * (13 * F + 20))
        bwd = (12 * n + out + (touched + 12 * n) * need_dx
               + 4 * (self.planes.numel() + self.lines.numel()) * need_table,
               n * S * (20 + 13 * F * (need_table + 3 * need_dx)))
        return fwd, bwd


class TriPlaneKernels:
    """Kernels T and U at the room0_hybrid plane spec (the TriPlaneHybrid
    grid's tri-plane pyramid, 32/68/146/311, 374,409 rows) or another
    tri-plane spec: table 0.1 x noise. U's updates are the plain version's
    products bit for bit (single roundings, no sum to contract), so its
    table gradient is held to each entry's sum-order bound alone."""

    source = "coslam_torch/csrc/tensovm_encode.cu"
    graph = True
    # Kernel T has no pallas_call to replace: it computes what XLA computed
    # on the TPU (_gather_pairs on the window mirror and _combine). Kernel
    # U's table gradient replaces K2 for its tri-plane caller.
    record = {"triplane_encode_fwd": {
                  "replaces": "coslam_tpu/ops/triplane.py:245",
                  "pallas_call": False,
                  "computes": ["coslam_tpu/ops/hash_packed.py:236",
                               "coslam_tpu/ops/triplane.py:142"]},
              "triplane_encode_bwd": {
                  "replaces": "coslam_tpu/ops/hash_packed.py:411",
                  "caller": "coslam_tpu/ops/triplane.py:289"},
              "triplane_encode_bwd_serial": {
                  "replaces": "coslam_tpu/ops/hash_packed.py:411",
                  "caller": "coslam_tpu/ops/triplane.py:289",
                  "mode": "serial order (K2): U's updates produced "
                          "inside a radix sort of each plane section, then "
                          "kernel H's run starts and walk"}}

    def __init__(self, device, rng, spec=None):
        from coslam_torch.ops import triplane as TP

        self.m = TP
        self.fwd_fn, self.bwd_fn = TP.triplane_encode_fwd, TP.triplane_encode_bwd
        self.spec = spec or TP.make_triplane_spec(400, 4)
        self.table = _tensor(device, 0.1 * rng.standard_normal(
            (self.spec.total_entries, self.spec.n_features)))

    def fwd(self, x, plain=False):
        fn = (self.m.triplane_encode_fwd_ref if plain
              else self.m.triplane_encode_fwd)
        return fn(self.spec, self.table, x)

    def bwd(self, x, g, need_table, need_dx, plain=False):
        fn = (self.m.triplane_encode_bwd_ref if plain
              else self.m.triplane_encode_bwd)
        return dict(zip(("dtable", "dx"), fn(self.spec, self.table, x, g,
                                             need_table, need_dx)))

    def touched_bytes(self, x, g) -> int:
        dt = self.m.triplane_encode_bwd_ref(self.spec, self.table, x, g, True,
                                            False)[0]
        return 4 * self.spec.n_features * _nonzero_rows(dt)

    def table_tol(self, x, g) -> dict:
        from coslam_torch.tools.bench import _common as C

        idx, vals = self.m.triplane_encode_bwd_streams_ref(self.spec,
                                                           self.table, x, g)
        rows = self.spec.total_entries
        return {"dtable": C.sum_order_tol(idx, vals, rows)}

    def serial(self, x, g):
        """Kernel U's serial mode: {"dtable"}."""
        return {"dtable": self.m.triplane_encode_bwd_serial(
            self.spec, self.table, x, g, False)[0]}

    def cpu_plain(self, x, g):
        return {"dtable": self.m.triplane_encode_bwd_ref(
            self.spec, self.table.cpu(), x.cpu(), g.cpu(), True, False)[0]}

    def serial_sorted(self, x, g):
        from coslam_torch.ops import serial_scatter as SS

        sorter = SS.serial_sort(self.m.serial_segments(self.spec, x.shape[0]),
                                self.spec.total_entries,
                                self.spec.out_dim * x.shape[0], x.device)
        return ((sorter.keys, sorter.pay),
                self.m.triplane_encode_bwd_streams_ref(
                    self.spec, self.table.cpu(), x.cpu(), g.cpu()))

    def l2_sectors(self, x, need_table, need_dx):
        """T's L2 figure (``t_l2_sectors``); none kept for U."""
        return t_l2_sectors(self.spec, x), None

    def fwd_library(self):
        """The library route for T's function (``t_library``: one
        grid_sample and a sum over each level's sections), its images
        built once."""
        if not hasattr(self, "_library"):
            self._library = t_library(self.spec, self.table)
        return self._library

    def row_atomics(self, x, key: str = "") -> dict:
        """U's row-pair adds at points x (``triplane.row_pair_adds``: a
        warp's runs of equal cell rows merged) and the 2 S N it would add
        without the merge."""
        return {key + "row_pair_adds": self.m.row_pair_adds(self.spec, x),
                key + "row_pair_adds_unmerged": 2 * self.spec.n_levels
                * x.shape[0]}

    def work(self, n, touched, need_table, need_dx):
        """Per (point, section): the v, then the u interpolation of F
        features (9 F operations) and ~14 for the cell and weights; the
        table gradient 8 F products, dx three times the interpolation."""
        S, F = self.spec.n_levels, self.spec.n_features
        out = 4 * n * self.spec.out_dim
        fwd = (12 * n + touched + out, n * S * (9 * F + 14))
        bwd = (12 * n + out + (touched + 12 * n) * need_dx
               + 4 * self.table.numel() * need_table,
               n * S * (14 + 8 * F * need_table + 27 * F * need_dx))
        return fwd, bwd


class XorKernels:
    """Kernels E and G at the room0_xor spec (make_hashgrid_spec(400, 16),
    834,097 rows), or at another XOR spec (the Dense grid's): unit-normal
    table. G's outputs are the update streams (idx, vals) and dx."""

    source = "coslam_torch/csrc/xor_grid_encode.cu"
    graph = True
    # Neither replaces a pallas_call: on the TPU the forward was XLA
    # (hashgrid_encode), and so were the backward's dx (jax.vjp) and the
    # streams it hands to K4.
    record = {"xor_grid_encode_fwd": {
                  "replaces": "coslam_tpu/ops/encodings.py:140",
                  "pallas_call": False},
              "xor_grid_encode_bwd": {
                  "replaces": "coslam_tpu/ops/hash_pallas.py:170",
                  "pallas_call": False,
                  "computes": ["coslam_tpu/ops/encodings.py:198"]}}

    def __init__(self, device, rng, spec=None):
        from coslam_torch.ops import encodings as E
        from coslam_torch.ops import hash_pallas as XP

        self.E, self.m = E, XP
        self.fwd_fn, self.bwd_fn = XP.xor_grid_encode_fwd, XP.xor_grid_encode_bwd
        self.spec = spec or E.make_hashgrid_spec(400, 16)
        self.table = _tensor(device, rng.standard_normal(
            (self.spec.total_entries, self.spec.n_features)))

    def fwd(self, x, plain=False):
        fn = self.E.hashgrid_encode if plain else self.m.xor_grid_encode_fwd
        return fn(self.spec, self.table, x)

    def bwd(self, x, g, need_table, need_dx, plain=False):
        fn = (self.m.xor_grid_encode_bwd_ref if plain
              else self.m.xor_grid_encode_bwd)
        return dict(zip(("idx", "vals", "dx"), fn(self.spec, self.table, x, g,
                                                  need_table, need_dx)))

    def touched_bytes(self, x, g) -> int:
        import torch

        idx = self.m.xor_grid_encode_bwd_ref(self.spec, self.table, x, g,
                                             True, False)[0]
        return 4 * self.spec.n_features * int(torch.unique(idx).numel())

    def table_tol(self, x, g) -> dict:
        return {}    # G's streams are exact on any points

    def l2_sectors(self, x, need_table, need_dx):
        """(kernel E's L2 sector accesses, None): the L2 figure is kept
        for E only."""
        return e_l2_sectors(self.spec, x), None

    def work(self, n, touched, need_table, need_dx):
        """As the packed grid's, but the backward writes the update
        streams (idx and F values per corner) instead of a table."""
        L, F = self.spec.n_levels, self.spec.n_features
        fwd = (12 * n + touched + 4 * n * L * F, n * L * (16 * F + 26))
        bwd = (12 * n + 4 * n * L * F + (touched + 12 * n) * need_dx
               + 4 * n * L * 8 * (1 + F) * need_table,
               n * L * (26 + 16 * F * (need_table + 3 * need_dx)))
        return fwd, bwd


# The row accumulate: kernels F and H replace K4 and K3's generic form. F
# is kernel P's CUDA kernel with its clip rule, so its source is P's.
ACCUM_SOURCES = {"row_accum_atomic": "coslam_torch/csrc/probe_accum.cu",
                 "row_accum_segmented": "coslam_torch/csrc/row_accum.cu"}
ACCUM_RECORD = {"replaces": "coslam_tpu/ops/hash_pallas.py:84",
                "also_replaces": ["coslam_tpu/ops/serial_scatter.py:77"]}


# The probes' kernels: P, Q, R (two wrappers: its pairs form and its
# fused form), S and V replace K5-K12, the pallas_calls of the
# scatter-accumulate probes under tools/bench/.
PROBE_SOURCE = "coslam_torch/csrc/probe_accum.cu"
PROBE_RECORD = {
    "probe_accum": {
        "replaces": "tools/bench/_bench_row_rates.py:126",
        "also_replaces": ["tools/bench/_bench_row_rates.py:109",
                          "tools/bench/_bench_cell_merge.py:101",
                          "tools/bench/_bench_chunk_tune.py:81",
                          "tools/bench/_bench_scatter_variants.py:86"]},
    "probe_accum_bf16x2": {
        "replaces": "tools/bench/_bench_row_rates.py:126",
        "also_replaces": ["tools/bench/_bench_scatter_variants.py:86"]},
    "probe_accum_pair_merged": {
        "replaces": "tools/bench/_bench_cell_merge.py:124"},
    "probe_accum_cell_merged": {
        "replaces": "tools/bench/_bench_cell_merge.py:124"},
    "probe_accum_run_merge": {
        "replaces": "tools/bench/_bench_run_merge.py:123"},
    "probe_accum_run_skip": {
        "replaces": "tools/bench/_bench_run_merge.py:196"},
}


def _itensor(device, a):
    import torch

    return torch.from_numpy(np.asarray(a, np.int32)).to(device)


RAY_CASE = "BA 1 kf ray-ordered"


def check_kernels(device, kernels, cases: list, ray=None, l2=None,
                  sum_order: bool = False) -> dict:
    """The forward and backward kernel of `kernels` against their plain
    versions on each case of `cases` (uniform points). Returns {kernel
    name: {"max_abs_err", "ms", "plain_ms", "library_ms", bound}}, the times
    and the bound at the case with the most points that runs the backward
    (no single PyTorch call computes an encode or its backward). With
    `ray` (the ray-ordered points of the slice's first BA call), one more
    case, that call's forward and table gradient on them, the gradient
    held to the sum-order bound of each entry (``kernels.table_tol``: a
    coarse row there sums thousands of contributions) and both timed
    beside the uniform case (``ray_ms``). Kernels with ``graph = True``
    also time every call on the card alone (a CUDA graph of 20 calls:
    ``graph_ms``, ``ray_graph_ms``). With `sum_order`, every case's table
    gradient is held to that bound too (grids whose coarse rows take
    hundreds of uniform points each). With `l2` (``l2_rate``'s record), the
    L2 figure of the kernels that have one (``kernels.l2_sectors``: A, C,
    E, D, T), their sector accesses over that rate (``l2_ms``,
    ``ray_l2_ms``), goes to ``HOST_MODEL``, as does the count of kernels
    with a host model of their atomics (``kernels.row_atomics``: U) at
    both cases."""
    import torch

    from coslam_torch.tools.bench import _common as C

    rng = np.random.default_rng(1)
    fwd, bwd = kernels.fwd_fn.__name__, kernels.bwd_fn.__name__
    out = {fwd: {"max_abs_err": 0.0}, bwd: {"max_abs_err": 0.0}}

    def err(name, a, b, tol, what):
        torch.testing.assert_close(a, b, **tol, msg=lambda m: f"{what}: {m}")
        e = float((a - b).abs().max())
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)
        return f"{what} err {e:.3g}"

    timed = max((c for c in cases if c[2] or c[3]), key=lambda c: c[1])
    runs = [(*c, None) for c in cases]
    if ray is not None:
        runs.append((RAY_CASE, ray.shape[0], True, False, ray))
    for label, n, need_table, need_dx, x in runs:
        if x is None:
            x = _tensor(device, rng.uniform(0, 1, (n, 3)))
        g = _tensor(device, rng.standard_normal((n, kernels.spec.out_dim)))
        line = [f"{label} N={n}",
                err(fwd, kernels.fwd(x), kernels.fwd(x, plain=True), FWD_TOL,
                    "fwd")]
        times = {"fwd": _time_ms(lambda: kernels.fwd(x))}
        if kernels.graph:
            times["fwd_graph"] = _graph_ms(lambda: kernels.fwd(x))
        times["fwd_plain"] = _time_ms(lambda: kernels.fwd(x, plain=True))
        if need_table or need_dx:
            got = kernels.bwd(x, g, need_table, need_dx)
            ref = kernels.bwd(x, g, need_table, need_dx, plain=True)
            torch.cuda.synchronize()
            bounds = (kernels.table_tol(x, g) if need_table
                      and (label == RAY_CASE or sum_order) else {})
            for what, a in got.items():
                assert (a is None) == (ref[what] is None), what
                if what in bounds:
                    e = C.assert_within(f"{label} {what}", a, ref[what],
                                        bounds[what])
                    out[bwd]["max_abs_err"] = max(out[bwd]["max_abs_err"], e)
                    line.append(f"{what} err {e:.3g} (sum-order bound)")
                elif a is not None:
                    line.append(err(bwd, a, ref[what],
                                    TOLS.get(what, TABLE_TOL), what))
            call = lambda: kernels.bwd(x, g, need_table, need_dx)  # noqa: E731
            times["bwd"] = _time_ms(call)
            if kernels.graph:
                times["bwd_graph"] = _graph_ms(call)
            times["bwd_plain"] = _time_ms(lambda: kernels.bwd(
                x, g, need_table, need_dx, plain=True))
        key = {timed[0]: "", RAY_CASE: "ray_"}.get(label)
        if key is not None and hasattr(kernels, "fwd_library"):
            library = kernels.fwd_library()
            got_lib, ref = library(x), kernels.fwd(x, plain=True)
            torch.testing.assert_close(got_lib, ref, **LIBRARY_TOL)
            line.append("library route err {:.3g}".format(float(
                (got_lib - ref).abs().max())))
            times["fwd_library"] = _graph_ms(lambda: library(x))
            out[fwd][key + "library_ms"] = times["fwd_library"]
        if key is not None and l2 is not None:
            for name, sectors in zip((fwd, bwd), kernels.l2_sectors(
                    x, need_table, need_dx)):
                if sectors is not None:
                    figure = sectors / l2["sectors_per_ms"]
                    _host_model(name, **{key + "l2_sectors": sectors,
                                         key + "l2_ms": figure})
                    times[name[-3:] + "_l2 (model)"] = figure
        line += [f"{k} {v:.4f} ms" for k, v in times.items()]
        print("  " + ", ".join(line), flush=True)
        if key is not None and need_table and hasattr(kernels,
                                                      "row_atomics"):
            _host_model(bwd, **kernels.row_atomics(x, key))
        if label == timed[0]:
            work = kernels.work(n, kernels.touched_bytes(x, g), need_table,
                                need_dx)
            out[fwd].update(ms=times["fwd"], plain_ms=times["fwd_plain"],
                            library_ms=times.get("fwd_library"),
                            **bound(*work[0]))
            out[bwd].update(ms=times["bwd"], plain_ms=times["bwd_plain"],
                            library_ms=None, **bound(*work[1]))
        if key is not None:
            for name in (fwd, bwd):
                step = name[-3:]
                if step in times:
                    out[name][key + "ms"] = times[step]
                if step + "_graph" in times:
                    out[name][key + "graph_ms"] = times[step + "_graph"]
    return out


def check_accumulate(device, xk: XorKernels, cases: list, ray) -> dict:
    """Kernels F and H against the plain row accumulate (row_accum_ref),
    within the sum-order bound (``_common.sum_order_tol``), on the update
    streams kernel G gives at every case of `cases` that asks for the
    table gradient (M = N x 16 levels x 8 corners) and on the ray-ordered
    points `ray` of the slice's first BA call; H twice, bit for bit, and,
    on every 1 in M // 200,000 update of each case, bit for bit against a
    serial np.add.at on the host. Returns {kernel name: {"max_abs_err",
    "ms", "plain_ms", ...}}, the times at the case with the most updates
    (events, and ``graph_ms`` from a CUDA graph of 20 calls), and at the
    ray-ordered case (``ray_ms``, ``ray_graph_ms``); H's per-phase times
    at both (``phases``, ``ray_phases``). F's rows of atomics at both
    (``probe_accum.warp_runs``, of the stream's updates) go to
    ``HOST_MODEL``."""
    import torch

    from coslam_torch.ops import probe_accum as PA
    from coslam_torch.ops import serial_scatter as SS
    from coslam_torch.tools.bench import _common as C

    rng = np.random.default_rng(2)
    rows = xk.spec.total_entries
    fns = {False: SS.row_accum_atomic, True: SS.row_accum_segmented}
    out = {fn.__name__: {"max_abs_err": 0.0} for fn in fns.values()}
    runs = [(label, n, None) for label, n, need_table, _ in cases
            if need_table]
    timed = max(runs, key=lambda c: c[1])[0]
    runs.append((RAY_CASE, ray.shape[0], ray))
    for label, n, x in runs:
        if x is None:
            x = _tensor(device, rng.uniform(0, 1, (n, 3)))
        g = _tensor(device, rng.standard_normal((n, xk.spec.out_dim)))
        idx, vals, _ = xk.m.xor_grid_encode_bwd(xk.spec, xk.table, x, g,
                                                True, False)
        ref = SS.row_accum_ref(idx, vals, rows)
        tol = C.sum_order_tol(idx.clamp(0, rows), vals, rows + 1)
        measure = label in (timed, RAY_CASE)
        key = "" if label == timed else "ray_"
        line = [f"{label} M={idx.shape[0]}"]
        for det, fn in fns.items():
            call = lambda: SS.row_accum(idx, vals, rows, det)  # noqa: E731
            got = call()
            if det:
                again = call()
                torch.cuda.synchronize()
                assert torch.equal(got, again), f"{label}: H not bit-identical"
            e = C.assert_within(f"{label} {fn.__name__}", got, ref, tol)
            rec = out[fn.__name__]
            rec["max_abs_err"] = max(rec["max_abs_err"], e)
            ms = _time_ms(call)
            line.append(f"{fn.__name__} err {e:.3g}, {ms:.4f} ms")
            if measure:
                rec[key + "ms"] = ms
                rec[key + "graph_ms"] = _graph_ms(call)
                line.append(f"graph {rec[key + 'graph_ms']:.4f} ms")
        plain_ms = _time_ms(lambda: SS.row_accum_ref(idx, vals, rows))
        line.append(f"plain {plain_ms:.4f} ms")
        if measure:
            buf = torch.zeros_like(ref)
            library = lambda: buf.index_add_(0, idx, vals)  # noqa: E731
            lib_ms, lib_graph_ms = _time_ms(library), _graph_ms(library)
            line.append(f"index_add_ {lib_ms:.4f} ms, graph {lib_graph_ms:.4f}")
            phases = h_phases(idx, vals, rows)
            out["row_accum_segmented"][key + "phases"] = phases
            line.append("H phases " + ", ".join(
                f"{k} {v['ms']:.4f} (graph {v['graph_ms']:.4f})"
                for k, v in phases.items()))
            for rec in out.values():
                rec.update({key + "library_ms": lib_ms,
                            key + "library_graph_ms": lib_graph_ms})
            if label == timed:
                m, width = vals.shape
                for rec in out.values():
                    rec.update(plain_ms=plain_ms,
                               **accum_bound(m, width, ref.numel()))
        if measure:
            counts = {key + "updates": idx.shape[0],
                      key + "adjacent_dup": float(
                          (idx[1:] == idx[:-1]).float().mean()),
                      key + "row_atomics": PA.warp_runs(idx, rows,
                                                        clip=True)}
            _host_model("row_accum_atomic", **counts)
            line.append("F (host model) {} rows of atomics".format(
                counts[key + "row_atomics"]))
        step = max(idx.shape[0] // 200_000, 1)
        sub_idx, sub_vals = idx[::step].contiguous(), vals[::step].contiguous()
        host = np.zeros((rows + 1, vals.shape[1]), np.float32)
        np.add.at(host, sub_idx.cpu().numpy(), sub_vals.cpu().numpy())
        got = SS.row_accum(sub_idx, sub_vals, rows, True)
        np.testing.assert_array_equal(got.cpu().numpy(), host)
        line.append(f"H == np.add.at on {sub_idx.shape[0]} updates")
        print("  " + ", ".join(line), flush=True)
    return out


def check_probes(device) -> dict:
    """Kernels P-S and V against their plain versions at each probe's main
    shape, each within the sum-order bound of the plain version
    (``_common.sum_order_tol``: twice the worst-case error of an f32 sum
    of an entry's updates in any order): P (streams, float4 and scalar
    atomics) and Q (packed bf16, scalar, float2 and float4) at the
    row-rate probe's W = 8 (1,048,576 updates into 65,537 rows); P's and
    Q's scalar pair form at K10's shape (6,340,608 updates); P's pair form
    at the chunk probe's TUM scale (1,859,584 updates, 65,702 rows,
    float2, 256 threads, 4 updates per thread, as its --quick run launches
    it); R in both forms (the pairs after the torch pre-pass, and the raw
    updates with the pre-pass fused in) on the cell-merge probe's "runs"
    and "random" streams (524,288 updates, W = 8); S, V and P's skip rule
    (after the suffix scan) on the run-merge probe's r = 311 stream (62,208
    updates, W = 8), V also bit for bit on a stream where each row takes a
    single run of 1-40 (its one scanned total added onto 0.0). Returns
    {kernel name: record}, timed at those shapes: ``ms`` and
    ``library_ms`` from CUDA graphs of the calls (``_graph_ms``: the
    card's time, no host cost; for S and V also ``library_zeroed_ms``,
    torch.zeros + index_add_ in one graph), ``call_ms`` with the host's
    (``_time_ms``), ``plain_ms`` likewise (the plain versions wait on the
    card and cannot be captured). P also at K5's shape (the cell-merge
    probe's random and runs streams, 524,288 updates, 8 streams, float4):
    its graph time beside index_add_'s (``k5``; its rows of atomics go to
    ``HOST_MODEL``, as do R's on the runs stream)."""
    import torch

    from coslam_torch.ops import probe_accum as PA
    from coslam_torch.tools.bench import _bench_cell_merge as CM
    from coslam_torch.tools.bench import _bench_chunk_tune as CT
    from coslam_torch.tools.bench import _bench_row_rates as RR
    from coslam_torch.tools.bench import _bench_run_merge as RM
    from coslam_torch.tools.bench import _bench_scatter_variants as SV
    from coslam_torch.tools.bench import _common as C

    rng = np.random.default_rng(3)
    out = {}

    def check(fn, got, ref, tol, label):
        torch.cuda.synchronize()
        e = C.assert_within(label, got, ref, tol)
        rec = out.setdefault(fn.__name__, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], e)
        return f"{label} err {e:.3g}"

    def timed(fn, call, plain, library, bounds, **extra):
        rec = out[fn.__name__]
        rec.update(ms=_graph_ms(call), call_ms=_time_ms(call),
                   plain_ms=_time_ms(plain),
                   library_ms=None if library is None else _graph_ms(library),
                   **bounds, **extra)
        return ", ".join(f"{k} {rec[k]:.4f}" for k in (
            "ms", "call_ms", "plain_ms", "library_ms", "library_zeroed_ms",
            "bound_ms") if rec.get(k) is not None)

    # P and Q: the row-rate probe at W = 8.
    rows, m, w = RR.ROWS, RR.M, 8
    idx = _itensor(device, rng.integers(0, rows, m))
    streams = _tensor(device, rng.standard_normal((w, m)))
    words = RR.pack_streams(streams)
    ref = PA.probe_accum_ref(idx, streams.T, rows + 1)
    tol = C.sum_order_tol(idx, streams.T, rows + 1)
    line = [check(PA.probe_accum, PA.probe_accum(idx, streams, rows + 1,
                                                 vec=v), ref, tol, f"P vec{v}")
            for v in (1, 4)]
    vec1_ms = _graph_ms(lambda: PA.probe_accum(idx, streams, rows + 1))
    buf = torch.zeros_like(ref)
    line.append("P " + timed(
        PA.probe_accum, lambda: PA.probe_accum(idx, streams, rows + 1, vec=4),
        lambda: PA.probe_accum_ref(idx, streams.T, rows + 1),
        lambda: buf.index_add_(0, idx, streams.T),
        accum_bound(m, w, ref.numel()), ms_vec1=vec1_ms,
        setting="row rates W=8 streams, float4 (ms) and scalar, the lanes "
                "across the rows (ms_vec1); K10's scalar pair form "
                "(ms_pair_vec1)"))
    unpacked = PA.unpack_bf16x2(words.T.contiguous())
    q_ref = PA.probe_accum_ref(idx, unpacked, rows + 1)
    q_tol = C.sum_order_tol(idx, unpacked, rows + 1)
    line += [check(PA.probe_accum_bf16x2, PA.probe_accum_bf16x2(
        idx, words, rows + 1, vec=v), q_ref, q_tol, f"Q vec{v}")
        for v in (1, 2, 4)]
    q_ms = {f"ms_vec{v}": _graph_ms(
        lambda v=v: PA.probe_accum_bf16x2(idx, words, rows + 1, vec=v))
        for v in (1, 2)}
    line.append("Q " + timed(
        PA.probe_accum_bf16x2,
        lambda: PA.probe_accum_bf16x2(idx, words, rows + 1, vec=4),
        lambda: PA.probe_accum_ref(idx, PA.unpack_bf16x2(
            words.T.contiguous()), rows + 1), None,
        accum_bound(m, w, ref.numel(), 2), **q_ms,
        setting="row rates W=8, 4 word streams, float4 (ms), scalar: the "
                "lanes across the rows (ms_vec1), float2 (ms_vec2); K10's "
                "scalar pair form (ms_pair_vec1)"))
    print(f"  row rates M={m} W={w}: " + ", ".join(line), flush=True)

    # P at K5's shape (the cell-merge probe's 8 streams, float4) on its
    # random and runs streams: the card's time beside index_add_'s, and
    # P's rows of atomics.
    vals = _tensor(device, rng.standard_normal((CM.WIDTH, CM.N)))
    k5 = out["probe_accum"]["k5"] = {}
    for name, ids in CM.streams(CM.ROWS, CM.N).items():
        idx = _itensor(device, ids)
        call = lambda: PA.probe_accum(idx, vals, CM.ROWS + 1,  # noqa: E731
                                      vec=4)
        ref = PA.probe_accum_ref(idx, vals.T, CM.ROWS + 1)
        err = check(PA.probe_accum, call(), ref,
                    C.sum_order_tol(idx, vals.T, CM.ROWS + 1), f"P K5 {name}")
        buf = torch.zeros_like(ref)
        k5[name] = {"ms": _graph_ms(call), "library_ms": _graph_ms(
                        lambda: buf.index_add_(0, idx, vals.T)),
                    **accum_bound(CM.N, CM.WIDTH, ref.numel())}
        rows_k5 = PA.warp_runs(idx, CM.ROWS)
        _host_model("probe_accum", **{f"k5_{name}_updates": CM.N,
                                      f"k5_{name}_row_atomics": rows_k5})
        print(f"  K5 {name} M={CM.N} W={CM.WIDTH}: {err}, graph "
              f"{k5[name]['ms']:.4f} ms, index_add_ graph "
              f"{k5[name]['library_ms']:.4f} ms, (host model) {rows_k5} "
              "rows of atomics", flush=True)

    # P's scalar pair form: the scatter-variants probe's "shipped" form
    # (K10: 6,340,608 updates, scalar atomics, one update a thread).
    rows, m = SV.N_ROWS, SV.M
    idx = _itensor(device, rng.integers(0, rows - 2, m))
    pair = _tensor(device, rng.standard_normal((4, m)))
    call = lambda: PA.probe_accum(idx, pair, rows + 2,  # noqa: E731
                                  stride=2)
    err = check(PA.probe_accum, call(),
                PA.probe_accum_ref(idx, pair.T, rows + 2, stride=2),
                C.sum_order_tol(idx, pair.T, rows + 2, stride=2),
                "P pair vec1")
    out["probe_accum"]["ms_pair_vec1"] = _graph_ms(call)
    words = RR.pack_streams(pair)
    unpacked = PA.unpack_bf16x2(words.T.contiguous())
    q_call = lambda: PA.probe_accum_bf16x2(idx, words,  # noqa: E731
                                           rows + 2, stride=2)
    q_err = check(PA.probe_accum_bf16x2, q_call(),
                  PA.probe_accum_ref(idx, unpacked, rows + 2, stride=2),
                  C.sum_order_tol(idx, unpacked, rows + 2, stride=2),
                  "Q pair vec1")
    out["probe_accum_bf16x2"]["ms_pair_vec1"] = _graph_ms(q_call)
    print(f"  K10 pair form M={m}, scalar atomics: {err}, graph "
          f"{out['probe_accum']['ms_pair_vec1']:.4f} ms; {q_err}, graph "
          f"{out['probe_accum_bf16x2']['ms_pair_vec1']:.4f} ms", flush=True)

    # P's pair form: the chunk probe at its larger scale, as --quick runs it.
    rows, m = CT.ROWS, CT.MS[-1]
    (threads, upt), = CT.QUICK
    idx = _itensor(device, rng.integers(0, rows - 2, m))
    pair = _tensor(device, rng.standard_normal((4, m)))
    print("  pair form M={}: {}".format(m, check(
        PA.probe_accum, PA.probe_accum(idx, pair, rows + 2, stride=2, vec=2,
                                       upt=upt, threads=threads),
        PA.probe_accum_ref(idx, pair.T, rows + 2, stride=2),
        C.sum_order_tol(idx, pair.T, rows + 2, stride=2), "P pair")),
        flush=True)

    # R, both forms: the cell-merge probe's streams, timed on its runs
    # stream.
    rows, n = CM.ROWS, CM.N
    vals = _tensor(device, rng.standard_normal((CM.WIDTH, n)))
    n2, n_out = n // 2, (rows + 1) * CM.WIDTH
    for name, ids in CM.streams(rows, n).items():
        idx = _itensor(device, ids)
        merged = PA.merge_pairs(idx, vals)
        taken = int(merged[1].sum())
        ref = PA.probe_accum_ref(idx, vals.T, rows + 1)
        tol = C.sum_order_tol(idx, vals.T, rows + 1)
        line = [check(PA.probe_accum_pair_merged, PA.probe_accum_pair_merged(
                    *merged, rows + 1), ref, tol, "R pairs vec4"),
                check(PA.probe_accum_cell_merged, PA.probe_accum_cell_merged(
                    idx, vals, rows + 1), ref, tol, "R fused vec4")]
        if name == "runs":
            buf = torch.zeros_like(ref)
            library = lambda: buf.index_add_(0, idx, vals.T)  # noqa: E731
            line.append("R pairs " + timed(
                PA.probe_accum_pair_merged,
                lambda: PA.probe_accum_pair_merged(*merged, rows + 1),
                lambda: PA.pair_merged_ref(*merged, rows + 1), None,
                bound(12 * n2 + 4 * CM.WIDTH * (n2 + taken) + 4 * n_out,
                      CM.WIDTH * (n2 + taken)),
                setting="cell merge runs stream, after the pre-pass, float4",
                pairs_taken=taken))
            line.append("R fused " + timed(
                PA.probe_accum_cell_merged,
                lambda: PA.probe_accum_cell_merged(idx, vals, rows + 1),
                lambda: PA.cell_merged_ref(idx, vals, rows + 1), library,
                accum_bound(n, CM.WIDTH, n_out),
                setting="cell merge runs stream, the pre-pass fused in, "
                        "float4"))
            row_atomics = PA.warp_runs(merged[0], rows, take2=merged[1],
                                       idx2=merged[2])
            for fn in (PA.probe_accum_pair_merged,
                       PA.probe_accum_cell_merged):
                _host_model(fn.__name__, updates=n, row_atomics=row_atomics)
            line.append(f"(host model) {row_atomics} rows of atomics")
        print(f"  cell merge {name} N={n} ({n2 - taken} of {n2} pairs "
              "merged): " + ", ".join(line), flush=True)

    # S, V and P's skip rule: the run-merge probe at r = 311.
    r = RM.RS[-1]
    rows = r * r
    ids, vals_np = RM.make_stream(r)
    idx, vals = _itensor(device, ids), _tensor(device, vals_np)
    m, w = vals.shape
    ref = PA.run_merge_ref(idx, vals, rows + 1)
    tol = C.sum_order_tol(idx, vals, rows + 1)
    s_idx, s_vals = PA.run_merge_outside(idx, vals, rows)
    line = [check(PA.probe_accum_run_merge, PA.probe_accum_run_merge(
        idx, vals, rows + 1), ref, tol, "S"),
        check(PA.probe_accum_run_skip, PA.probe_accum_run_skip(
            idx, vals, rows + 1), PA.run_skip_ref(idx, vals, rows + 1),
            C.sum_order_tol(s_idx, s_vals, rows + 1), "V"),
        check(PA.probe_accum, PA.probe_accum(s_idx, s_vals, rows + 1,
                                             rows=True, vec=4), ref, tol,
              "P skip")]
    heads = rng.permutation(rows)[:3000]
    single = _itensor(device, np.repeat(heads, rng.integers(1, 41, 3000)))
    single_vals = _tensor(device, rng.standard_normal((single.shape[0], w)))
    got = PA.probe_accum_run_skip(single, single_vals, rows + 1)
    want = PA.run_skip_ref(single, single_vals, rows + 1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        "V differs from its plain version on single runs"
    line.append(f"V == plain bit for bit on {single.shape[0]} updates in "
                "single runs")
    buf = torch.zeros_like(ref)
    library = lambda: buf.index_add_(0, idx, vals)  # noqa: E731
    zeroed = lambda: torch.zeros_like(ref).index_add_(  # noqa: E731
        0, idx, vals)
    line.append("S " + timed(
        PA.probe_accum_run_merge,
        lambda: PA.probe_accum_run_merge(idx, vals, rows + 1),
        lambda: PA.run_merge_ref(idx, vals, rows + 1), library,
        accum_bound(m, w, ref.numel()),
        setting="run merge r=311, kernel P with its clip rule, rows, float4",
        library_zeroed_ms=_graph_ms(zeroed)))
    n_runs = 1 + int((idx[1:] != idx[:-1]).sum())
    _host_model("probe_accum_run_merge", updates=m,
                row_atomics=PA.warp_runs(idx, rows, clip=True))
    _host_model("probe_accum_run_skip", updates=m, row_atomics=n_runs)
    line.append("V " + timed(
        PA.probe_accum_run_skip,
        lambda: PA.probe_accum_run_skip(idx, vals, rows + 1),
        lambda: PA.run_skip_ref(idx, vals, rows + 1), library,
        bound(4 * m + 4 * w * m + 4 * ref.numel(),
              (PA.MAX_ROUNDS + 1) * m * w),
        setting=f"run skip r=311, {PA.MAX_ROUNDS} rounds, tile {PA.TILE}, "
                "float4",
        library_zeroed_ms=_graph_ms(zeroed)))
    print(f"  run merge r={r} M={m}: " + ", ".join(line), flush=True)
    return out


def check_warp_runs(device, tk: TriPlaneKernels, n_points: int) -> dict:
    """Kernels P, Q, R, F and U on inputs built to catch a faulty warp
    merge (each warp sums its runs of equal rows before its atomics), each
    held to its plain version within the sum-order bound: P in every form
    (streams and rows at every vector width that divides W, with 1 and 4
    updates a thread, the pair form, the skip rule and the clip rule), Q
    at every even W likewise (streams, the pair form, the clip rule), R in
    both forms (M = 100,002: its pairs) and F, on each of
    ``_common.WARP_EDGE_STREAMS`` at M = 100,003 (the last step short) for
    W = 1, 2, 4, 6, 8 and 16 (scalar atomics: the lanes across the rows,
    at W = 6 one update a lane); U, dtable and dx, on
    `n_points` points that lie in one cell of every plane level (each
    warp one run a section), timed there (events and graph; its row-pair
    adds go to ``HOST_MODEL``). Returns {kernel name: {"max_abs_err"} and U's
    ``one_cell`` record}."""
    import torch

    from coslam_torch.ops import probe_accum as PA
    from coslam_torch.ops import serial_scatter as SS
    from coslam_torch.tools.bench import _bench_row_rates as RR
    from coslam_torch.tools.bench import _common as C

    rng = np.random.default_rng(4)
    m, rows = 100_003, 5000
    out = {name: {"max_abs_err": 0.0} for name in (
        "probe_accum", "probe_accum_bf16x2", "probe_accum_pair_merged",
        "probe_accum_cell_merged", "row_accum_atomic", tk.bwd_fn.__name__)}

    def held(name, label, got, ref, tol):
        e = C.assert_within(label, got, ref, tol)
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], e)

    def check_q(stream, idx, streams, width, rows) -> int:
        """Q at every vec, 1 and 4 updates a thread, the pair form and the
        clip rule; returns the calls."""
        words = RR.pack_streams(streams)
        unpacked = PA.unpack_bf16x2(words.T.contiguous())
        ref = PA.probe_accum_ref(idx, unpacked, rows + 1)
        tol = C.sum_order_tol(idx, unpacked, rows + 1)
        calls = 0
        for vec in (v for v in (1, 2, 4) if width % v == 0):
            for upt, threads in ((1, 256), (4, 128)):
                held("probe_accum_bf16x2", f"Q {stream} W={width} vec{vec} "
                     f"upt={upt}", PA.probe_accum_bf16x2(
                         idx, words, rows + 1, vec=vec, upt=upt,
                         threads=threads), ref, tol)
                calls += 1
        stride = width // 2
        held("probe_accum_bf16x2", f"Q {stream} W={width} pair form",
             PA.probe_accum_bf16x2(idx, words, rows + 1, stride=stride,
                                   vec=PA.widest_vec(stride)),
             PA.probe_accum_ref(idx, unpacked, rows + 1, stride),
             C.sum_order_tol(idx, unpacked, rows + 1, stride))
        clipped = idx.clamp(0, rows)
        held("probe_accum_bf16x2", f"Q {stream} W={width} clip rule",
             PA.launch_accum("probe_accum_bf16x2", idx, words, width,
                             idx.shape[0], rows + 1, width, 1, 1, 256, True,
                             False, clip=True),
             PA.probe_accum_ref(clipped, unpacked, rows + 1),
             C.sum_order_tol(clipped, unpacked, rows + 1))
        return calls + 2

    for stream in C.WARP_EDGE_STREAMS:
        idx = _itensor(device, C.warp_edge_stream(stream, m, rows))
        clipped = idx.clamp(0, rows)
        calls = 0
        for width in (1, 2, 4, 6, 8, 16):
            vals = _tensor(device, rng.standard_normal((m, width)))
            streams = vals.T.contiguous()
            ref = PA.probe_accum_ref(idx, vals, rows + 1)
            tol = C.sum_order_tol(idx, vals, rows + 1)
            for vec in sorted({1, PA.widest_vec(width)}):
                for upt, threads in ((1, 256), (4, 128)):
                    for layout, v in (("streams", streams), ("rows", vals)):
                        held("probe_accum", f"P {stream} W={width} {layout} "
                             f"vec{vec} upt={upt}", PA.probe_accum(
                                 idx, v, rows + 1, rows=layout == "rows",
                                 vec=vec, upt=upt, threads=threads), ref, tol)
                        calls += 1
            if width % 2 == 0:
                stride = width // 2
                held("probe_accum", f"P {stream} W={width} pair form",
                     PA.probe_accum(idx, streams, rows + 1, stride=stride,
                                    vec=PA.widest_vec(stride)),
                     PA.probe_accum_ref(idx, vals, rows + 1, stride),
                     C.sum_order_tol(idx, vals, rows + 1, stride))
                calls += 1
            ref = SS.row_accum_ref(idx, vals, rows)
            tol = C.sum_order_tol(clipped, vals, rows + 1)
            held("probe_accum", f"P {stream} W={width} clip rule, streams",
                 PA.launch_accum("probe_accum", idx, streams, width, m,
                                 rows + 1, width, PA.widest_vec(width), 1,
                                 256, False, False, clip=True), ref, tol)
            held("row_accum_atomic", f"F {stream} W={width}",
                 SS.row_accum_atomic(idx, vals, rows), ref, tol)
            calls += 2
            if width % 2 == 0:
                calls += check_q(stream, idx, streams, width, rows)
            # R on the first M - 1 updates (an even count).
            even, ev = idx[:-1], streams[:, :-1].contiguous()
            ref = PA.probe_accum_ref(even, ev.T, rows + 1)
            tol = C.sum_order_tol(even, ev.T, rows + 1)
            held("probe_accum_cell_merged", f"R fused {stream} W={width}",
                 PA.probe_accum_cell_merged(even, ev, rows + 1), ref, tol)
            held("probe_accum_pair_merged", f"R pairs {stream} W={width}",
                 PA.probe_accum_pair_merged(*PA.merge_pairs(even, ev),
                                            rows + 1), ref, tol)
            calls += 2
        print(f"  {stream} M={m}: {calls} calls of P, Q, R and F within the "
              f"sum-order bound; (host model) P {PA.warp_runs(idx, rows)} "
              f"rows of atomics (skip rule), F "
              f"{PA.warp_runs(idx, rows, clip=True)}",
              flush=True)

    # U: points in one cell of every level (a random corner, then within
    # 1e-6 of it; redrawn until no cell boundary of any level falls in
    # between).
    spec = tk.spec
    while True:
        x = _tensor(device, C.one_cell_points(n_points, rng))
        e00 = tk.m._corners(spec, x)[0]
        if bool((e00 == e00[:, :1]).all()):
            break
    g = _tensor(device, rng.standard_normal((n_points, spec.out_dim)))
    got, ref = tk.bwd(x, g, True, True), tk.bwd(x, g, True, True, plain=True)
    held(tk.bwd_fn.__name__, "U one cell dtable", got["dtable"],
         ref["dtable"], tk.table_tol(x, g)["dtable"])
    torch.testing.assert_close(got["dx"], ref["dx"], **DX_TOL)
    call = lambda: tk.bwd(x, g, True, False)  # noqa: E731
    rec = out[tk.bwd_fn.__name__]["one_cell"] = {
        "points": n_points, "ms": _time_ms(call), "graph_ms": _graph_ms(call)}
    counts = tk.row_atomics(x, "one_cell_")
    _host_model(tk.bwd_fn.__name__, **counts)
    print("  U one cell N={points}: dtable within the sum-order bound, dx "
          "as the plain version's, {ms:.4f} ms, graph {graph_ms:.4f} ms, "
          "(host model) {one_cell_row_pair_adds} row-pair adds "
          "({one_cell_row_pair_adds_unmerged} unmerged)".format(**rec,
                                                                **counts),
          flush=True)
    return out


def run_probes(wrappers) -> dict:
    """The probes' entry points (--quick) with the launch counts of
    `wrappers` set to 0 just before and read just after; each must have
    launched."""
    import importlib

    for fn in wrappers:
        fn.launches = 0
    for name in ("_bench_row_rates", "_bench_scatter_variants",
                 "_bench_chunk_tune", "_bench_cell_merge",
                 "_bench_run_merge"):
        print(f"  -- python -m coslam_torch.tools.bench.{name} --quick",
              flush=True)
        importlib.import_module(f"coslam_torch.tools.bench.{name}").main(
            ["--quick"])
    launches = {fn.__name__: fn.launches for fn in wrappers}
    print(f"  launches {json.dumps(launches)}", flush=True)
    assert all(launches.values()), launches
    return launches


def run_slice(device, cfg: dict, data, wrappers, own, table_own=(),
              n_frames=None) -> dict:
    """CoSLAM.run on the frames `data` (the first `n_frames` only, without
    the final mesh, when given); returns the launch counts of every
    kernel wrapper in `wrappers` over the run (each set to 0 just before
    it), after checking what the run produced, that the slice's own
    kernels were launched on the path (`own` in every tracking and BA
    iteration, twice with an importance fine pass; `table_own` in every
    iteration that asks for the table gradient: first frame and BA),
    that each periodic mesh (mesh.vis) was written by the loop's mesh
    worker and, with the ATE files, is not empty, and printing its
    summary."""
    import torch

    from coslam_torch.runtime.latency import attribute_tails
    from coslam_torch.runtime.slam import CoSLAM

    frames = data.num_frames if n_frames is None else n_frames
    mesh = n_frames is None
    slam = CoSLAM(cfg, data, device=device)
    mesh_threads, save_mesh = {}, slam.save_mesh

    def recorded(i, *args, **kwargs):
        mesh_threads.setdefault(i, []).append(
            threading.current_thread().name)
        return save_mesh(i, *args, **kwargs)

    slam.save_mesh = recorded
    for fn in wrappers:
        fn.launches = 0
    t0 = time.perf_counter()
    res = slam.run(n_frames=n_frames, verbose=False, mesh=mesh)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in wrappers}

    mcfg, tcfg = cfg["mapping"], cfg["tracking"]
    losses = [v for vals in slam.losses.values() for v in vals]
    assert losses and all(math.isfinite(v) for v in losses), slam.losses
    kf_ids = list(range(0, frames, mcfg["keyframe_every"]))
    assert slam.kf_db.count == len(kf_ids), slam.kf_db.count
    assert list(slam.kf_db.frame_ids[:len(kf_ids)]) == kf_ids, \
        slam.kf_db.frame_ids
    ate = res["absolute_translational_error.rmse"]
    assert math.isfinite(ate) and ate < 0.10, ate
    n_vert = len(slam.final_mesh.vertices) if mesh else 0
    assert n_vert > 100 or not mesh, n_vert
    if mesh:
        from coslam_torch.mesh import mcubes

        assert mcubes.library.cache_info().currsize == 1, "no native mesh"
        lib = os.path.abspath(mcubes.library()._name)
        assert os.path.dirname(lib) == str(mcubes.BUILD_DIR), lib
    vis = int(cfg["mesh"].get("vis", 0) or 0)
    out = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"])
    periodic = list(range(vis, frames, vis)) if vis else []
    for i in periodic:
        assert "mesh-eval" in mesh_threads.get(i, []), (i, mesh_threads)
        path = os.path.join(out, f"mesh_track{i}.ply")
        assert os.path.getsize(path) > 0, path
    if periodic:
        for name in ("output.txt", "output_relative.txt"):
            with open(os.path.join(out, name)) as f:
                assert len(f.read().splitlines()) == len(periodic) + 1, name
    n_track = (frames - 1) * tcfg["iter"]
    n_ba = len(slam.timings["mapping"]) * mcfg["iters"]
    assert n_ba > 0, "no BA call"
    passes = 2 if cfg["training"]["n_importance"] > 0 else 1
    floors = {fn: passes * (n_track + n_ba) for fn in own}
    floors.update({fn: mcfg["first_iters"] + n_ba for fn in table_own})
    if device.type == "cuda":
        for fn, floor in floors.items():
            n = launches[fn.__name__]
            assert n >= floor, (fn.__name__, n, floor)
    t = slam.timings
    summary = {
        "wall_s": wall,
        "first_frame_s": t["first_frame"][0],
        "tracking_ms_median": 1e3 * float(np.median(t["tracking"])),
        "ba_ms_median": 1e3 * float(np.median(t["mapping"])),
        "mesh_s": t["mesh"][-1] if mesh else None,
        "ate_rmse_m": ate,
        "mesh_vertices": n_vert,
        "keyframes": slam.kf_db.count,
        "tracking_steps": n_track,
        "ba_iterations": n_ba,
        "periodic_meshes": {i: mesh_threads[i] for i in periodic},
        "frames": attribute_tails(slam.frame_walls, slam.frame_events),
        "launches": launches,
    }
    print("  " + json.dumps(summary), flush=True)
    SLICE_SUMMARIES[cfg["data"]["exp_name"]] = summary
    return launches


# exp_name -> the summary run_slice printed.
SLICE_SUMMARIES = {}


def _ulps(a, b) -> int:
    """The largest distance between a and b in units in the last place
    (f32 bit patterns mapped to a monotonic integer line)."""
    def line(t):
        i = t.detach().cpu().numpy().astype(np.float32).view(np.int32)
        i = i.astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int(np.abs(line(a) - line(b)).max()) if a.numel() else 0


def _graph_call(fn):
    """fn's result from a replay of a CUDA graph that captured one call
    (after warm-up on a side stream)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    out = {k: v.clone() for k, v in out.items()}
    del graph
    return out


def check_serial(device, kernels, case, ray) -> dict:
    """The serial mode of kernel B, D or U (``kernels.serial``: K2 and K3
    in the TPU kernels' serial order) at `case` (the BA 1-keyframe case,
    uniform points) and on the ray-ordered points `ray`: the same bits over
    two calls and from a CUDA graph's replay; within the sum-order bound of
    the plain version on the card (``kernels.table_tol``), with the largest
    ulp distance from the plain version on the host (whose index_add_ adds
    in the serial mode's order); and the route's sorted output (global
    rows and values) equal, bit for bit, to a stable sort on the host
    (np.argsort, kind "stable") of the plain version's update stream.
    Times, at both: the mode (events, graph) and each of its launches
    (``phase_times``), the atomic mode beside it, the plain version and
    deterministic ``index_put_(accumulate=True)`` on the plain version's
    stream (the library call). Returns the record."""
    import torch

    from coslam_torch.tools.bench import _common as C

    rng = np.random.default_rng(3)
    rec = {"max_abs_err": 0.0, "max_ulp": 0}
    label, n = case[0], case[1]
    for key, lab, x in (("", label, None), ("ray_", RAY_CASE, ray)):
        if x is None:
            x = _tensor(device, rng.uniform(0, 1, (n, 3)))
        g = _tensor(device, rng.standard_normal((x.shape[0],
                                                 kernels.spec.out_dim)))
        call = lambda: kernels.serial(x, g)  # noqa: E731
        got, again = call(), call()
        torch.cuda.synchronize()
        for what in got:
            assert torch.equal(got[what], again[what]), \
                f"{lab} {what}: the serial mode changed its bits"
        replay = _graph_call(call)
        for what in got:
            assert torch.equal(got[what], replay[what]), \
                f"{lab} {what}: the graph replay changed the bits"
        ref = kernels.bwd(x, g, True, False, plain=True)
        bounds = kernels.table_tol(x, g)
        host = kernels.cpu_plain(x, g)
        line = [f"{lab} N={x.shape[0]}: two calls and a graph replay equal"]
        for what, a in got.items():
            e = C.assert_within(f"{lab} serial {what}", a, ref[what],
                                bounds[what])
            u = _ulps(a, host[what])
            rec["max_abs_err"] = max(rec["max_abs_err"], e)
            rec["max_ulp"] = max(rec["max_ulp"], u)
            line.append(f"{what} err {e:.3g} (sum-order bound), "
                        f"{u} ulp from the host's plain version")
        # The sorted output of this call against the host's stable sort of
        # the plain version's stream.
        call()
        (keys, pay), (idx, vals) = kernels.serial_sorted(x, g)
        order = np.argsort(idx.numpy(), kind="stable")
        np.testing.assert_array_equal(keys.cpu().numpy(), idx.numpy()[order])
        np.testing.assert_array_equal(pay.cpu().numpy(), vals.numpy()[order])
        line.append(f"sorted output == the host's stable sort of the "
                    f"{idx.shape[0]} updates")
        times = {"ms": _time_ms(call), "graph_ms": _graph_ms(call),
                 "atomic_ms": _time_ms(lambda: kernels.bwd(x, g, True,
                                                           False)),
                 "plain_ms": _time_ms(lambda: kernels.bwd(x, g, True, False,
                                                          plain=True))}
        keys_l, vals_d = idx.to(device).long(), vals.to(device)
        buf = torch.zeros((sum(t.shape[0] for t in got.values()) + 1, 2),
                          device=device)
        with _deterministic():
            times["library_ms"] = _time_ms(lambda: buf.index_put_(
                (keys_l,), vals_d, accumulate=True))
        line += [f"{k} {v:.4f}" for k, v in times.items()]
        phases = phase_times(call)
        line.append("phases not measured (no device event in the "
                    "profiler's traces)" if phases["phases"] is None else
                    "phases (us) " + ", ".join(
                        f"{name} {us:.1f}" for name, us in phases["phases"]))
        print("  " + ", ".join(line), flush=True)
        rec.update({key + k: v for k, v in times.items()})
        rec[key + "phases_us"] = phases["phases"]
        if key == "":
            work = kernels.work(x.shape[0], kernels.touched_bytes(x, g), True,
                                False)
            rec.update(bound(*work[1]))
    return rec


@contextlib.contextmanager
def _deterministic():
    """torch.use_deterministic_algorithms(True) for a with block."""
    import torch

    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def run_resume(device, cfg: dict, data, n_frames: int, ckpt_every: int,
               serial: list, atomic: list, wrappers) -> dict:
    """Crash-resume on the card under torch.use_deterministic_algorithms
    (True): a straight run of n_frames writing a checkpoint every
    ckpt_every frames, then a fresh CoSLAM loaded from the last periodic
    checkpoint and run to the end; est_c2w and every parameter tensor
    must equal the straight run's bit for bit. The launch counts of
    `wrappers` over the straight run (each set to 0 just before it) are
    returned; each serial mode of `serial` must be launched in every
    table-gradient iteration (first frame, BA) of both runs, and each
    atomic backward of `atomic` only for tracking's dx (one a tracking
    iteration)."""
    import torch

    from coslam_torch.runtime.checkpoint import param_leaves
    from coslam_torch.runtime.slam import CoSLAM

    mcfg, tcfg = cfg["mapping"], cfg["tracking"]
    last = (n_frames - 1) // ckpt_every * ckpt_every
    assert 0 < last < n_frames - 1, (n_frames, ckpt_every)
    with _deterministic():
        slam_a = CoSLAM(cfg, data, device=device)
        for fn in wrappers:
            fn.launches = 0
        t0 = time.perf_counter()
        res = slam_a.run(n_frames=n_frames, verbose=False, mesh=False,
                         ckpt_every=ckpt_every)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in wrappers}
        n_track = (n_frames - 1) * tcfg["iter"]
        n_ba = len(slam_a.timings["mapping"]) * mcfg["iters"]
        for fn in serial:
            assert launches[fn.__name__] >= mcfg["first_iters"] + n_ba, \
                launches
        for fn in atomic:
            assert launches[fn.__name__] == n_track, launches

        cfg_b = copy.deepcopy(cfg)
        cfg_b["data"]["exp_name"] += "_resumed"
        slam_b = CoSLAM(cfg_b, data, device=device)
        path = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"],
                            f"checkpoint{last}.npz")
        assert slam_b.load_checkpoint(path) == last
        for fn in (*serial, *atomic):
            fn.launches = 0
        slam_b.run(n_frames=n_frames, verbose=False, mesh=False,
                   start_frame=last)
        torch.cuda.synchronize()
        n_ba_b = len(slam_b.timings["mapping"]) * mcfg["iters"]
        assert n_ba_b > 0
        for fn in serial:
            assert fn.launches >= n_ba_b, (fn.__name__, fn.launches)
        for fn in atomic:
            assert fn.launches == (n_frames - last) * tcfg["iter"], \
                (fn.__name__, fn.launches)
    assert np.array_equal(slam_b.est_c2w, slam_a.est_c2w), \
        "the resumed run's poses differ from the straight run's"
    for a, b in zip(param_leaves(slam_a.params), param_leaves(slam_b.params),
                    strict=True):
        assert torch.equal(a, b), "the resumed run's map differs"
    ate = res["absolute_translational_error.rmse"]
    assert math.isfinite(ate) and ate < 0.10, ate
    t = slam_a.timings
    print("  " + json.dumps({
        "deterministic": True, "wall_s": wall,
        "tracking_ms_median": 1e3 * float(np.median(t["tracking"])),
        "ba_ms_median": 1e3 * float(np.median(t["mapping"])),
        "ate_rmse_m": ate, "resumed_from": last,
        "resumed_equal_bit_for_bit": True, "launches": launches}),
        flush=True)
    return launches


def run_current_frame(device, cfg: dict, data, n_frames: int, fwd,
                      bwd) -> None:
    """The loop with mapping.cur_frame_iters > 0: every current-frame call
    must launch the grid's forward `fwd` and backward `bwd` kernels in
    each of its iterations; ATE < 10 cm."""
    import torch

    from coslam_torch.runtime.slam import CoSLAM

    iters = cfg["mapping"]["cur_frame_iters"]
    slam = CoSLAM(cfg, data, device=device)
    step, calls = slam._cur_step, []

    def counted(*args):
        before = fwd.launches, bwd.launches
        loss = step(*args)
        calls.append((fwd.launches - before[0], bwd.launches - before[1]))
        return loss

    slam._cur_step = counted
    res = slam.run(n_frames=n_frames, verbose=False, mesh=False)
    torch.cuda.synchronize()
    assert calls and len(calls) == len(slam.timings["mapping"]), calls
    assert all(a >= iters and b >= iters for a, b in calls), calls
    ate = res["absolute_translational_error.rmse"]
    assert math.isfinite(ate) and ate < 0.10, ate
    print("  " + json.dumps({"cur_frame_iters": iters,
                             "calls_launches_fwd_bwd": calls,
                             "ate_rmse_m": ate}), flush=True)


def tum_frames(cfg: dict, n_frames: int):
    """The TUM slice's frames: the 15-frame scan of the analytic scene
    written in TUM layout under cfg's data.datadir (the port's
    write_tum_format: PNGs, rgb.txt, depth.txt, groundtruth.txt), then
    read back through the port's normal dataset route (get_dataset:
    TUMDataset); the run's output directory is emptied first."""
    from coslam_torch.data.datasets import TUMDataset, get_dataset

    cam = cfg["cam"]
    write_tum_format(cfg["data"]["datadir"], AnalyticScene(),
                     make_scan_trajectory(n_frames), cam["H"], cam["W"],
                     cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                     png_depth_scale=cam["png_depth_scale"])
    shutil.rmtree(os.path.join(cfg["data"]["output"],
                               cfg["data"]["exp_name"]), ignore_errors=True)
    data = get_dataset(cfg)
    assert isinstance(data, TUMDataset), type(data)
    assert data.num_frames == n_frames, data.num_frames
    return data


def run_tum_extras(device, cfg: dict, data, n_frames: int, fwd) -> None:
    """The TUM recipe's other options: training.frame_align,
    tracking.iter_point (point-cloud tracking before each tracking step)
    and decoder.dtype bfloat16. Losses finite, the exposure parameters
    moved from their initial value, and kernel A (`fwd`) launched in every
    point-cloud iteration."""
    import torch

    from coslam_torch.runtime.slam import CoSLAM

    slam = CoSLAM(cfg, data, device=device)
    assert slam.model.decoder.bf16
    step, calls = slam._track_pc_step, []
    n_pc = cfg["tracking"]["iter_point"]

    def counted(*args):
        before = fwd.launches
        out = step(*args)
        calls.append(fwd.launches - before)
        return out

    slam._track_pc_step = counted
    res = slam.run(n_frames=n_frames, verbose=False, mesh=False)
    if device.type == "cuda":
        torch.cuda.synchronize()
    losses = [v for vals in slam.losses.values() for v in vals]
    assert losses and all(math.isfinite(v) for v in losses), slam.losses
    assert len(calls) == n_frames - 1, calls
    if device.type == "cuda":
        assert all(n >= n_pc for n in calls), calls
    init = torch.tensor([1.0, 1.0, 1.0, 0.0], device=device)
    kf = slam.kf_aligns[:slam.kf_db.count]
    assert torch.isfinite(kf).all() and torch.isfinite(slam.cur_align).all()
    assert not torch.equal(slam.cur_align, init), slam.cur_align
    assert torch.equal(kf[0], init), kf
    assert not torch.equal(kf[-1], init), kf
    ate = res["absolute_translational_error.rmse"]
    assert math.isfinite(ate), ate
    print("  " + json.dumps({
        "frame_align": True, "iter_point": n_pc, "decoder_dtype": "bfloat16",
        "pc_calls_launches_fwd": calls,
        "cur_align": slam.cur_align.tolist(), "kf_aligns": kf.tolist(),
        "tracking_ms_median": 1e3 * float(np.median(
            slam.timings["tracking"])),
        "ate_rmse_m": ate}), flush=True)


# The active phase's settings (configs/Active/active_tum.yaml's active
# section, cut to 15 frames: init_image and check_info_gain_every 10 -> 5,
# choose_k 10 -> 2, downsample_rate 2 -> 4).
ACTIVE_SETTINGS = {"isActive": True, "init_image": 5,
                   "check_info_gain_every": 5, "choose_k": 2, "w": 0.01,
                   "downsample_rate": 4, "beta_min": 0.01}
# The holdout info gain through kernel A against its plain version, each
# of pre and post: f32 sums over 19,200 rays x 213 samples, where a sample
# whose SDF sits within f32 noise of 0 may flip a ray's first-crossing
# mask and move that ray's share (about 1/19,200 of the sum) at most.
INFO_GAIN_RTOL = 1e-3


def pipelined_config(out: str) -> dict:
    """The pipelined phase's config: room0_config as the room0 slice runs
    it."""
    return room0_config(out, H, W, N_FRAMES, exp_name="chip_smoke_pipelined")


def active_config(out: str) -> dict:
    """The active phase's config: tum_config with ACTIVE_SETTINGS."""
    cfg = tum_config(out, H, W, N_FRAMES, exp_name="chip_smoke_active")
    cfg["active"] = dict(ACTIVE_SETTINGS)
    return cfg


def run_pipelined(device, cfg: dict, data, fwd, bwd, sequential: dict
                  ) -> dict:
    """PipelinedCoSLAM.run on the 15 frames: every frame 1-14 tracked, BA
    once at each map_every frame, keyframes 0, 5 and 10, ATE < 10 cm; the
    tracker and the mapper on two distinct non-default streams; kernel A
    (`fwd`) launched on both, kernel B (`bwd`) with the table gradient on
    the mapper's only (the tracker's B computes dx: the map is frozen
    there), each at least once a tracking or BA iteration. Prints
    runtime/latency.attribute_tails of the frames beside the sequential
    room0 slice's (`sequential`: its summary from run_slice). Returns the
    launch counts of A and B over the run."""
    import torch

    from coslam_torch.runtime.latency import attribute_tails
    from coslam_torch.runtime.pipeline import PipelinedCoSLAM

    mcfg, tcfg = cfg["mapping"], cfg["tracking"]
    slam = PipelinedCoSLAM(cfg, data, device=device)
    ba_frames, global_ba = [], slam.global_BA

    def recorded(batch, i):
        ba_frames.append(i)
        return global_ba(batch, i)

    slam.global_BA = recorded
    for fn in (fwd, bwd):
        fn.launches = 0
        fn.by_stream.clear()
    t0 = time.perf_counter()
    res = slam.run(verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in (fwd, bwd)}

    assert slam.tracking_idx == N_FRAMES - 1, slam.tracking_idx
    assert all(np.any(slam.est_c2w[i]) for i in range(N_FRAMES))
    assert ba_frames == list(range(mcfg["map_every"], N_FRAMES,
                                   mcfg["map_every"])), ba_frames
    kf_ids = list(range(0, N_FRAMES, mcfg["keyframe_every"]))
    assert list(slam.kf_db.frame_ids[:slam.kf_db.count]) == kf_ids, \
        slam.kf_db.frame_ids
    ate = res["absolute_translational_error.rmse"]
    assert math.isfinite(ate) and ate < 0.10, ate
    streams = slam.thread_streams
    default = torch.cuda.default_stream(device).cuda_stream
    assert set(streams) == {"tracker", "mapper"}, streams
    assert len(set(streams.values())) == 2, streams
    assert default not in streams.values(), (streams, default)

    def on(fn, thread, tag=""):
        return fn.by_stream.get((streams[thread], tag), 0)

    by_thread = {f"{fn.__name__}[{tag or 'all'}]": {
        t: on(fn, t, tag) for t in streams}
        for fn, tag in ((fwd, ""), (bwd, "table"), (bwd, "dx"))}
    n_track = (N_FRAMES - 1) * tcfg["iter"]
    n_ba = len(ba_frames) * mcfg["iters"]
    assert on(fwd, "tracker") >= n_track, by_thread
    assert on(fwd, "mapper") >= mcfg["first_iters"] + n_ba, by_thread
    assert on(bwd, "tracker", "dx") >= n_track, by_thread
    assert on(bwd, "tracker", "table") == 0, by_thread
    assert on(bwd, "mapper", "table") >= mcfg["first_iters"] + n_ba, \
        by_thread
    report = attribute_tails(slam.frame_walls, slam.frame_events)
    print("  " + json.dumps({
        "wall_s": wall, "ate_rmse_m": ate, "frames": report,
        "tracking_ms_median": 1e3 * float(np.median(
            slam.timings["tracking"])),
        "ba_ms_median": 1e3 * float(np.median(slam.timings["mapping"])),
        "mapper_lag_frames": slam.mapper_lag,
        "sequential_room0": {k: sequential[k] for k in (
            "tracking_ms_median", "ba_ms_median", "frames", "wall_s")},
        "ba_frames": ba_frames, "launches_by_thread": by_thread,
        "streams_distinct_non_default": True}), flush=True)
    return launches


@contextlib.contextmanager
def _kernel_a_plain():
    """Kernel A's wrapper swapped for its plain version, on the same card
    tensors, for a with block."""
    from coslam_torch.ops import hash_packed as HP

    kernel = HP.grid_encode_fwd
    HP.grid_encode_fwd = lambda spec, table, x: HP.grid_encode_fwd_ref(
        spec, table, x)
    try:
        yield
    finally:
        HP.grid_encode_fwd = kernel


def run_active(device, cfg: dict, data, fwd, bwd) -> dict:
    """ActiveCoSLAM.run on the TUM slice's frames (the TUM recipe with
    ACTIVE_SETTINGS): the train set grown past init_image, at least one
    keyframe chosen by information gain, ATE over the processed frames <
    10 cm, test() with uncert_map > 0, kernels A and B launched; then the
    holdout info gain (pre, post) of the last window's first frame through
    kernel A against the same function through A's plain version, on the
    same parameters and pixels, within INFO_GAIN_RTOL. Returns the launch
    counts of A and B over the run."""
    import torch

    from coslam_torch.active.slam import ActiveCoSLAM, info_gain

    a = cfg["active"]
    slam = ActiveCoSLAM(cfg, data, device=device)
    chosen, grow = [], slam._grow_train_set

    def recorded(train_ds, holdout, verbose):
        before = set(slam._pending_kf)
        out = grow(train_ds, holdout, verbose)
        chosen.extend(sorted(slam._pending_kf - before))
        return out

    slam._grow_train_set = recorded
    for fn in (fwd, bwd):
        fn.launches = 0
    t0 = time.perf_counter()
    res = slam.run(verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in (fwd, bwd)}
    assert all(launches.values()), launches
    assert slam.train_set_size > a["init_image"], slam.train_set_size
    kf_ids = [int(f) for f in slam.kf_db.frame_ids[:slam.kf_db.count]]
    info_kfs = sorted(set(chosen) & set(kf_ids))
    assert info_kfs, (chosen, kf_ids)
    ate = res["absolute_translational_error.rmse"]
    assert math.isfinite(ate) and ate < 0.10, ate
    ret = slam.test(data[5], 5)
    assert (ret["uncert_map"] > 0).all() and math.isfinite(
        float(ret["rgb_loss"]))

    first = N_FRAMES - a["check_info_gain_every"]
    batch = data[first]
    idx = slam.holdout_pixels(batch["frame_id"])
    rays = torch.from_numpy(slam._frame_rays_flat(batch)[idx]).to(device)
    c2w = torch.from_numpy(np.asarray(batch["c2w"], np.float32)).to(device)
    before = fwd.launches
    got = torch.stack(info_gain(slam.model, slam.params, rays, c2w))
    assert fwd.launches > before, "the info gain did not launch kernel A"
    before = fwd.launches
    with _kernel_a_plain():
        ref = torch.stack(info_gain(slam.model, slam.params, rays, c2w))
    assert fwd.launches == before, "the plain info gain launched kernel A"
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=INFO_GAIN_RTOL, atol=0)
    rel = np.abs(got - ref) / np.abs(ref)
    print("  " + json.dumps({
        "wall_s": wall, "ate_rmse_m": ate,
        "processed_frames": int(sum(np.any(p) for p in slam.est_c2w)),
        "train_set_size": slam.train_set_size, "keyframes": kf_ids,
        "info_gain_keyframes": info_kfs, "chosen": chosen,
        "tracking_ms_median": 1e3 * float(np.median(
            slam.timings["tracking"])),
        "ba_ms_median": 1e3 * float(np.median(slam.timings["mapping"])),
        "test_uncert_map_min": float(ret["uncert_map"].min()),
        "info_gain_pre_post": got.tolist(),
        "info_gain_rel_diff_plain": rel.tolist(),
        "info_gain_rays": int(rays.shape[0]), "launches": launches}),
        flush=True)
    return launches


# The quality phase: the harness of coslam_torch.tools.quality_bench on
# the card, through the in-memory route (no image codec), at the JAX
# verify recipe's sizes; its bounds (60 frames of the replica protocol:
# ATE < 10 cm, depth-L1 < 3 cm; 30 frames of the rgbd protocol: ATE < 10
# cm) and the phase's wall budget.
QUALITY_RUNS = [
    ("replica", ["--protocol", "replica", "--scene", "room", "--frames",
                 "60"], {"ate_rmse_cm": 10.0, "depth_l1_cm": 3.0}),
    ("rgbd", ["--protocol", "rgbd", "--frames", "30"],
     {"ate_rmse_cm": 10.0}),
    ("replica_hybrid", ["--protocol", "replica", "--scene", "room",
                        "--frames", "60", "--enc", "TriPlaneHybrid"],
     {"ate_rmse_cm": 10.0, "depth_l1_cm": 3.0}),
]
QUALITY_WALL_S = 180.0
# The replica row again through the pipelined runtime (--pipelined), with
# that row's bounds and a wall budget of its own.
QUALITY_PIPELINED = [
    ("replica_pipelined", QUALITY_RUNS[0][1] + ["--pipelined"],
     QUALITY_RUNS[0][2])]
QUALITY_PIPELINED_WALL_S = 120.0


def quality_specs(device):
    """(label, kernels class, spec, config, frames) of the quality rows'
    grids, as the model builds them: the replica recipe's packed grid
    (hash_size 13, voxel_sdf 0.04 on the 5 m bound: resolution 125, two
    dense and 14 hashed levels), the rgbd recipe's TensoVM (voxel_sdf
    0.01) and the ScanNet recipe's TensoVM on the apartment's bound."""
    from coslam_torch.models.scene_rep import JointEncoding
    from coslam_torch.tools.quality_bench import recipe_config

    out = []
    for label, kernels, hw, frames in (("replica", HashKernels, (120, 160), 60),
                                       ("rgbd", TensoVMKernels, (120, 160), 30),
                                       ("scannet", TensoVMKernels, (480, 640),
                                        800)):
        cfg = recipe_config(label, "", "", *hw, frames)
        spec = JointEncoding(cfg, cfg["mapping"]["bound"], device).grid_spec
        out.append((label, kernels, spec, cfg, frames))
    return out


def check_device_tracer(device) -> float:
    """The sphere tracer on the card against the numpy tracer on three
    120x160 frames of the apartment walkthrough (0, 99 and 198 of 200):
    depth and rgb 1e-4. Returns the largest difference."""
    from coslam_torch.data import synth as S

    scene = S.AnalyticApartment()
    cam = (120, 160, 128.0, 128.0, 79.5, 59.5)
    worst = 0.0
    for c2w in S.make_walkthrough_trajectory(200, seed=0)[::99]:
        got = S.DeviceRenderer(scene, *cam, device=device)(c2w)
        want = S.render_frame(scene, c2w, *cam)
        for a, b, what in zip(got, want, ("rgb", "depth")):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                       err_msg=what)
            worst = max(worst, float(np.abs(a - b).max()))
    return worst


def run_quality(device, wrappers, own, runs=QUALITY_RUNS) -> dict:
    """quality_bench.main on the card for each of `runs` (--frames_in
    memory, 120x160, Co-SLAM culling, 50 eval views), each checked for
    finite metrics, its bounds, its runtime (--pipelined: the pipelined
    one) and the launches of its grid's kernels (`own[label]`: every
    count set to 0 just before the run, read just after; each must have
    launched). Returns {label: launches}."""
    import torch

    from coslam_torch.tools import quality_bench

    launches = {}
    for label, flags, bounds in runs:
        out = os.path.join(REPO, "output", f"chip_smoke_quality_{label}.json")
        argv = flags + ["--hw", "120x160", "--frames_in", "memory",
                        "--culling", "coslam", "--eval_views", "50",
                        "--device", "cuda", "--workdir",
                        os.path.join(REPO, "output", "chip_smoke_quality"),
                        "--out", out]
        for fn in wrappers:
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = quality_bench.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches for fn in wrappers}
        for key in ("ate_rmse_cm", "acc_cm", "comp_cm", "comp_ratio_pct",
                    "depth_l1_cm"):
            assert math.isfinite(res[key]), (label, key, res[key])
        for key, bound in bounds.items():
            assert res[key] < bound, (label, key, res[key], bound)
        assert res["pipelined"] is ("--pipelined" in flags), res["pipelined"]
        for fn in own[label]:
            assert counts[fn.__name__] > 0, (label, fn.__name__, counts)
        launches[label] = counts
        print("  " + json.dumps({
            "run": label, "wall_s": wall, "launches": counts,
            **{k: res[k] for k in (
                "ate_rmse_cm", "acc_cm", "comp_cm", "comp_ratio_pct",
                "depth_l1_cm", "virtual_cameras", "runtime_s",
                "tracking_ms", "mapping_ms", "device", "pipelined")}}),
            flush=True)
    return launches


# Phase 10: ray data parallelism on one card, the tools and the loop's
# live view, on the room0 frames and phase 6's room0 checkpoint.
# dp against dp = 1 on the same generator state: the tracking step's
# pose after 10 Adam steps within 1e-5 (each step moves a component by
# about lr whatever the gradient's size, so only the gradient's sign
# matters), BA's loss within rtol 1e-5 and its table gradient within
# twice each entry's sum-order bound (the shards' sums add in another
# order) plus TABLE_GRAD_ULPS ulps of the entry's mass: the cotangents
# themselves come from the decoder's products, whose sum order may change
# with a shard's row count (up to 8.2 ulps of the mass on the CPU, at
# 48 x 64).
TABLE_GRAD_ULPS = 64.0
TSDF_VOXEL = 0.02
# (frames fused for the card-against-CPU comparison, the share of voxels
# that may differ: a projection within f32 rounding of a pixel's .5 edge)
TSDF_CPU_FRAMES, TSDF_TIE_SHARE = (0, 5, 10), 1e-3
TOOLS_WALL_S = 150.0


def _room0_checkpoint(out: str) -> str:
    """Phase 6's room0 checkpoint: the straight deterministic run's
    final one."""
    path = os.path.join(out, "chip_smoke_det", f"checkpoint{N_FRAMES - 1}.npz")
    assert os.path.exists(path), path
    return path


def _record_table_grads(HP, calls: list):
    """A with block in which every backward of the hash-grid encode that
    computes the table gradient records its (spec, table, x, g) in
    ``calls``."""
    cls = HP.GridEncode
    backward = cls.backward

    def recording(ctx, g):
        if ctx.needs_input_grad[0]:
            table, x = ctx.saved_tensors
            calls.append((ctx.spec, table.detach(), x.detach(),
                          g.detach().contiguous()))
        return backward(ctx, g)

    @contextlib.contextmanager
    def swap():
        cls.backward = staticmethod(recording)
        try:
            yield
        finally:
            cls.backward = staticmethod(backward)

    return swap()


def _table_grad_tol(HP, calls: list):
    """Per table entry: twice the sum-order bound of its contributions
    over every recorded (x, g) (the trilinear weights are >= 0, so the
    plain backward on |g| sums the magnitudes) plus TABLE_GRAD_ULPS ulps
    of their mass."""
    import torch

    n = mass = None
    for spec, table, x, g in calls:
        cnt = HP.grid_encode_bwd_ref(spec, table, x, torch.ones_like(g),
                                     True, False)[0]
        mag = HP.grid_encode_bwd_ref(spec, table, x, g.abs(), True, False)[0]
        n = cnt if n is None else n + cnt
        mass = mag if mass is None else mass + mag
    return ((4.04 * (n - 1).clamp(min=0) + TABLE_GRAD_ULPS) * 2.0 ** -24
            * mass)


def run_dp_one_card(device, cfg: dict, data, ckpt: str, fwd, bwd) -> dict:
    """parallel.dp on one card: room0's tracking step (1024 rays x 10
    iterations) and one BA iteration (mapping.iters 1, the map and the
    poses stepped) with devices [cuda:0, cuda:0], each against dp = 1 on
    the same map, rays and generator state; A and B launched once a shard
    an iteration more than at dp = 1; CoSLAM at parallel.dp 2 refused on
    one card (ValueError), and with two cards or more room0 for 15 frames
    at --devices 2 and the pipelined runtime with its mapper on cuda:1.
    Returns A's and B's launches over the dp steps."""
    import torch

    from coslam_torch import convert
    from coslam_torch.ops import hash_packed as HP
    from coslam_torch.runtime.mapping import BundleAdjust
    from coslam_torch.runtime.optim import make_map_optimizer
    from coslam_torch.runtime.slam import CoSLAM
    from coslam_torch.runtime.tracking import make_tracking_step

    two = [device, device]
    slam = CoSLAM(cfg, data, device=device)
    slam.load_checkpoint(ckpt)
    model, tcfg = slam.model, cfg["tracking"]
    batch = data[5]
    rays = slam._sample_tracking_rays(batch).to(device)
    init = torch.from_numpy(slam._predict(5)).to(device)
    launches = {fwd.__name__: 0, bwd.__name__: 0}
    track = {}
    for name, devices in (("dp1", None), ("dp2", two)):
        before = fwd.launches, bwd.launches
        gen = torch.Generator(device=device).manual_seed(21)
        c2w, losses, _, _ = make_tracking_step(model, cfg, devices)(
            slam.params, init, rays, gen)
        torch.cuda.synchronize()
        track[name] = (c2w.cpu().numpy(), losses.cpu().numpy(),
                       fwd.launches - before[0], bwd.launches - before[1])
    (c1, l1, a1, b1), (c2, l2, a2, b2) = track["dp1"], track["dp2"]
    np.testing.assert_allclose(c2, c1, atol=1e-5, rtol=0)
    np.testing.assert_allclose(l2, l1, rtol=1e-4)
    assert (a1, b1) == (tcfg["iter"], tcfg["iter"]), (a1, b1)
    assert (a2, b2) == (2 * tcfg["iter"], 2 * tcfg["iter"]), (a2, b2)
    launches[fwd.__name__] += a2
    launches[bwd.__name__] += b2

    ba_cfg = copy.deepcopy(cfg)
    ba_cfg["mapping"].update(iters=1, map_accum_step=1, pose_accum_step=1)
    frame = slam._frame_block(batch)
    cur_pose = torch.from_numpy(slam.est_c2w[5]).to(device)
    ba = {}
    for name, devices in (("dp1", None), ("dp2", two)):
        params = convert.params_from_numpy(
            convert.params_to_numpy(slam.params), device)
        opt = make_map_optimizer(ba_cfg, params)
        grads, step = {}, opt.step

        def recording(*args, _p=params, _g=grads, _s=step, **kwargs):
            _g["grid"] = _p["grid"].grad.detach().clone()
            return _s(*args, **kwargs)

        opt.step = recording
        calls = []
        before = fwd.launches, bwd.launches
        with _record_table_grads(HP, calls):
            kf_poses, new_cur, loss, _, _ = BundleAdjust(
                model, ba_cfg, opt, slam.kf_db.num_kf, devices)(
                params, slam.kf_db, slam.kf_poses, cur_pose, frame,
                torch.Generator(device=device).manual_seed(22))
        torch.cuda.synchronize()
        ba[name] = (grads["grid"], calls, float(loss),
                    kf_poses.cpu().numpy(), fwd.launches - before[0],
                    bwd.launches - before[1])
    (g1, calls1, loss1, k1, a1, b1) = ba["dp1"]
    (g2, calls2, loss2, k2, a2, b2) = ba["dp2"]
    np.testing.assert_allclose(loss2, loss1, rtol=1e-5)
    np.testing.assert_allclose(k2, k1, atol=1e-5, rtol=0)
    assert len(calls2) == len(calls1) + 1, (len(calls1), len(calls2))
    tol = _table_grad_tol(HP, calls1)
    over = ~((g2 - g1).abs() <= tol)
    assert not bool(over.any()), (
        f"BA's table gradient at dp 2: {int(over.sum())} entries beyond "
        f"the bound, up to {float(((g2 - g1).abs() / tol)[over].max()):.3g} "
        "times it")
    assert (a2 - a1, b2 - b1) == (1, 1), (a1, a2, b1, b2)
    launches[fwd.__name__] += a2
    launches[bwd.__name__] += b2

    visible = torch.cuda.device_count()
    dp_cfg = copy.deepcopy(cfg)
    dp_cfg["parallel"] = {"dp": 2}
    dp_cfg["data"]["exp_name"] = "chip_smoke_dp2"
    multi = None
    if visible < 2:
        try:
            CoSLAM(dp_cfg, data, device="cuda")
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("parallel.dp 2 was not refused on one card")
        assert "parallel.dp=2 but only 1 devices visible" in refused, refused
    else:
        refused = None
        from coslam_torch.runtime.pipeline import PipelinedCoSLAM

        res = CoSLAM(dp_cfg, data, device="cuda").run(verbose=False,
                                                      mesh=False)
        ate = res["absolute_translational_error.rmse"]
        assert math.isfinite(ate) and ate < 0.10, ate
        pipe_cfg = copy.deepcopy(cfg)
        pipe_cfg["data"]["exp_name"] = "chip_smoke_pipelined_2cards"
        pipe = PipelinedCoSLAM(pipe_cfg, data, device="cuda")
        assert pipe.map_devices == [torch.device("cuda", 1)], pipe.map_devices
        pres = pipe.run(verbose=False, mesh=False)
        pate = pres["absolute_translational_error.rmse"]
        assert math.isfinite(pate) and pate < 0.10, pate
        multi = {"dp2_ate_rmse_m": ate, "pipelined_mapper_on_cuda1_ate_m":
                 pate}
    gmax = float(g1.abs().max())
    print("  " + json.dumps({
        "dp_on_one_card": {
            "tracking_pose_max_abs_diff": float(np.abs(c2 - c1).max()),
            "tracking_launches_dp1_dp2": [track["dp1"][2:], track["dp2"][2:]],
            "ba_loss_dp1_dp2": [loss1, loss2],
            "ba_table_grad_max_abs_diff": float((g2 - g1).abs().max()),
            "ba_table_grad_max_abs": gmax,
            "ba_table_grad_largest_tol": float(tol.max()),
            "ba_pose_max_abs_diff": float(np.abs(k2 - k1).max()),
            "ba_launches_dp1_dp2": [[a1, b1], [a2, b2]]},
        "visible_cards": visible,
        "ran": ("dp 2 refused on one card: " + refused if multi is None
                else "two cards: room0 at --devices 2 and the pipelined "
                     "mapper on cuda:1"),
        "multi_card": multi}), flush=True)
    return launches


def _write_room0_replica(cfg: dict, datadir: str, device):
    """room0's 15 frames (the scan trajectory) written in Replica layout
    under datadir, and cfg pointing at them, saved as YAML beside -> the
    YAML's path."""
    import yaml

    from coslam_torch.data.synth import write_replica_format

    cam = cfg["cam"]
    write_replica_format(datadir, AnalyticScene(),
                         make_scan_trajectory(N_FRAMES), cam["H"], cam["W"],
                         cam["fx"], cam["fy"], cam["cx"], cam["cy"],
                         device=device)
    cfg["data"]["datadir"] = datadir
    path = datadir.rstrip("/") + ".yaml"
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def run_render_view(device, cfg_path: str, ckpt: str, fwd) -> int:
    """tools/render_view at 480 x 640 from the room0 checkpoint, --frame 5
    --compare: finite PSNR and depth-L1; kernel A launched once in every
    chunk; the image equal to the same render through A's plain version
    (FWD_TOL). Returns A's launches in the CLI's render."""
    import torch

    from coslam_torch.config import load_config
    from coslam_torch.tools import render_view as RV

    cfg = load_config(cfg_path)
    chunk = 2 ** 14
    n_chunks = -(-H * W // chunk)
    passes = 2 if cfg["training"]["n_importance"] > 0 else 1
    before = fwd.launches
    t0 = time.perf_counter()
    res = RV.main(["--config", cfg_path, "--ckpt", ckpt, "--frame", "5",
                   "--compare", "--device", str(device), "--out",
                   os.path.join(REPO, "output", "render_00005.png")])
    wall = time.perf_counter() - t0
    launched = fwd.launches - before
    assert launched == passes * n_chunks, (launched, n_chunks)
    assert math.isfinite(res["psnr"]) and math.isfinite(res["depth_l1"])
    cfg["training"]["perturb"] = 0.0
    model = RV.make_model(cfg, device)
    params, est = RV.load_params(model, ckpt, device)
    cam = cfg["cam"]
    args = (est[5], H, W, cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    rgb, depth = RV.render_image(model, params, *args, chunk=chunk,
                                 device=device)
    before = fwd.launches
    with _kernel_a_plain():
        rgb_p, depth_p = RV.render_image(model, params, *args, chunk=chunk,
                                         device=device)
    assert fwd.launches == before, "the plain render launched kernel A"
    np.testing.assert_allclose(rgb, rgb_p, **FWD_TOL)
    np.testing.assert_allclose(depth, depth_p, **FWD_TOL)
    torch.cuda.synchronize()
    print("  " + json.dumps({
        "render_view": {"psnr": res["psnr"], "depth_l1": res["depth_l1"],
                        "wall_s": wall, "chunks": n_chunks,
                        "kernel_a_launches": launched,
                        "rgb_max_abs_diff_plain": float(np.abs(
                            rgb - rgb_p).max()),
                        "depth_max_abs_diff_plain": float(np.abs(
                            depth - depth_p).max())}}), flush=True)
    return launched


def run_tsdf(device, cfg: dict, data) -> None:
    """tools/tsdf_fusion of the 15 room0 frames at their GT poses on the
    card at 2 cm: the mesh's accuracy < one voxel and its completion over
    the observed region < two (tests/test_tsdf_fusion.py's bounds), the
    seconds a frame; the card's volume of TSDF_CPU_FRAMES against the
    CPU's: off rounding ties the same cells observed and the values
    within 1e-6, at most TSDF_TIE_SHARE of the voxels differing in all."""
    import torch

    from coslam_torch.eval.recon import accuracy, completion
    from coslam_torch.mesh.io import TriMesh
    from coslam_torch.mesh.mcubes import marching_cubes
    from coslam_torch.tools import tsdf_fusion as TF

    cam = cfg["cam"]
    trunc = 4 * TSDF_VOXEL
    frames = [data[i] for i in range(N_FRAMES)]
    depths = [np.asarray(f["depth"], np.float32) for f in frames]
    rgbs = [np.asarray(f["rgb"], np.float32) for f in frames]
    poses = [np.asarray(f["c2w"], np.float64) for f in frames]
    bounds = np.asarray(cfg["mapping"]["bound"], np.float32)
    intr = (cam["fx"], cam["fy"], cam["cx"], cam["cy"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vol, color, axes = TF.fuse_frames(depths, poses, *intr, bounds,
                                      TSDF_VOXEL, trunc, rgbs=rgbs,
                                      depth_trunc=cam["depth_trunc"],
                                      device=device)
    fuse_s = time.perf_counter() - t0
    mesh = TF.tsdf_mesh(vol, axes, trunc, color)
    assert len(mesh.vertices) > 1000, len(mesh.vertices)
    scene = AnalyticScene()
    lo, hi = bounds[:, 0], bounds[:, 1]
    n = int(round(float((hi - lo).max()) / TSDF_VOXEL)) + 1
    ax = [np.linspace(lo[k], hi[k], n).astype(np.float32) for k in range(3)]
    grid = np.stack(np.meshgrid(*ax, indexing="ij"), -1)
    sdf = scene.sdf(grid.reshape(-1, 3)).reshape(grid.shape[:3])
    v, f = marching_cubes(sdf.astype(np.float32), 0.0, truncation=3.0)
    gt = TriMesh(v * ((hi - lo) / (n - 1)) + lo, f)
    rng = np.random.default_rng(0)
    rec_pc = mesh.sample_surface(200000, rng)
    gt_pc = gt.sample_surface(200000, rng)
    acc = accuracy(gt_pc, rec_pc)
    idx = np.clip(np.round((gt_pc - np.array([a[0] for a in axes]))
                           / TSDF_VOXEL).astype(int), 0,
                  np.array(vol.shape) - 1)
    seen = np.abs(vol[idx[:, 0], idx[:, 1], idx[:, 2]]) < 0.99 * trunc
    comp = completion(gt_pc[seen], rec_pc)
    assert acc < TSDF_VOXEL, acc
    assert comp < 2 * TSDF_VOXEL, comp

    sub = list(TSDF_CPU_FRAMES)
    got = TF.fuse_frames([depths[i] for i in sub], [poses[i] for i in sub],
                         *intr, bounds, TSDF_VOXEL, trunc,
                         depth_trunc=cam["depth_trunc"], device=device)[0]
    t1 = time.perf_counter()
    want = TF.fuse_frames([depths[i] for i in sub], [poses[i] for i in sub],
                          *intr, bounds, TSDF_VOXEL, trunc,
                          depth_trunc=cam["depth_trunc"], device="cpu")[0]
    cpu_s = time.perf_counter() - t1
    obs, c_obs = got != np.float32(trunc), want != np.float32(trunc)
    differ = (obs != c_obs) | (np.abs(got - want) > 1e-6)
    assert differ.mean() <= TSDF_TIE_SHARE, differ.mean()
    print("  " + json.dumps({"tsdf_fusion": {
        "voxel_m": TSDF_VOXEL, "volume": list(vol.shape),
        "frames": N_FRAMES, "card_ms_per_frame": 1e3 * fuse_s / N_FRAMES,
        "cpu_ms_per_frame": 1e3 * cpu_s / len(sub),
        "accuracy_m": acc, "completion_observed_m": comp,
        "mesh_vertices": len(mesh.vertices),
        "card_vs_cpu_voxels_differing": int(differ.sum()),
        "card_vs_cpu_max_abs_diff": float(np.abs(got - want).max())}}),
        flush=True)


def run_export(device, cfg_path: str, ckpt: str, fwd) -> int:
    """tools/export --device cuda of the room0 checkpoint: the loaded
    program names kernel A's operator and launches A (counted), and its
    output equals query_color_sdf through A's plain version (FWD_TOL).
    Returns A's launches in the export's round trip and the check."""
    import torch

    from coslam_torch.config import load_config
    from coslam_torch.tools import export as EX
    from coslam_torch.tools import render_view as RV

    path = os.path.join(REPO, "output", "chip_smoke_query.pt2")
    batch = 4096
    before = fwd.launches
    out = EX.main(["--config", cfg_path, "--ckpt", ckpt, "--batch",
                   str(batch), "--device", str(device), "--out", path])
    in_main = fwd.launches - before
    assert in_main >= 1, "the exported program did not launch kernel A"
    program = torch.export.load(path)
    names = {str(node.target) for node in program.graph.nodes
             if node.op == "call_function"}
    assert "coslam_torch.grid_encode_fwd.default" in names, sorted(names)
    x = torch.linspace(0.1, 0.9, batch * 3, device=device).reshape(batch, 3)
    before = fwd.launches
    with torch.no_grad():
        got = program.module()(x)
    assert fwd.launches == before + 1, fwd.launches - before
    cfg = load_config(cfg_path)
    model = RV.make_model(cfg, device)
    params, _ = RV.load_params(model, ckpt, device)
    with torch.no_grad(), _kernel_a_plain():
        want = model.query_color_sdf(params, x)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **FWD_TOL)
    assert torch.equal(got, out)
    print("  " + json.dumps({"export": {
        "bytes": os.path.getsize(path), "batch": batch,
        "kernel_a_launches": in_main + 1,
        "max_abs_diff_plain": float((got - want).abs().max())}}),
        flush=True)
    return in_main + 1


def run_live_view(device, cfg: dict, data, fwd, bwd) -> dict:
    """mesh.visualisation on 3 room0 frames: vis/rgbd_00000.png ...
    rgbd_00002.png written, each [rgb | depth] wide. Returns A's and B's
    launches over the run."""
    import torch

    from coslam_torch.runtime.slam import CoSLAM

    cfg = copy.deepcopy(cfg)
    cfg["data"]["exp_name"] = "chip_smoke_live_view"
    cfg["mesh"].update(visualisation=True, vis=0)
    out = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"])
    shutil.rmtree(out, ignore_errors=True)
    before = fwd.launches, bwd.launches
    CoSLAM(cfg, data, device=device).run(n_frames=3, verbose=False,
                                         eval_ate=False, mesh=False)
    torch.cuda.synchronize()
    import cv2

    pngs = sorted(os.listdir(os.path.join(out, "vis")))
    assert pngs == [f"rgbd_{i:05d}.png" for i in range(3)], pngs
    shape = cv2.imread(os.path.join(out, "vis", pngs[0])).shape
    assert shape == (H, 2 * W, 3), shape
    launches = {fwd.__name__: fwd.launches - before[0],
                bwd.__name__: bwd.launches - before[1]}
    assert all(launches.values()), launches
    print("  " + json.dumps({"live_view": {"pngs": pngs,
                                           "launches": launches}}),
          flush=True)
    return launches


def run_tools_phase(device, data, hk) -> dict:
    """Phase 10: run_dp_one_card, then the tools on room0 (render_view,
    tsdf_fusion, export) and the live view. Returns A's and B's launches
    over the phase's main-path runs."""
    out = os.path.join(REPO, "output")
    cfg = room0_config(out, H, W, N_FRAMES, exp_name="chip_smoke_tools")
    ckpt = _room0_checkpoint(out)
    launches = run_dp_one_card(device, cfg, data, ckpt, hk.fwd_fn, hk.bwd_fn)
    cfg_path = _write_room0_replica(copy.deepcopy(cfg),
                                    os.path.join(out, "chip_smoke_rv_data"),
                                    device)
    launches[hk.fwd_fn.__name__] += run_render_view(device, cfg_path, ckpt,
                                                    hk.fwd_fn)
    run_tsdf(device, cfg, data)
    launches[hk.fwd_fn.__name__] += run_export(device, cfg_path, ckpt,
                                               hk.fwd_fn)
    for name, n in run_live_view(device, cfg, data, hk.fwd_fn,
                                 hk.bwd_fn).items():
        launches[name] += n
    return launches


def main() -> int:
    import torch

    t_start = time.perf_counter()
    t = _phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA "
              "card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"  {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"  nvidia-smi: {smi}", flush=True)

    from coslam_torch.ops import _kernels

    t = _phase("build")
    _kernels.build(verbose=True)
    _kernels.library()
    print(f"  build {time.perf_counter() - t:.1f} s", flush=True)

    from coslam_torch.ops import serial_scatter as SS

    out = os.path.join(REPO, "output")
    rng = np.random.default_rng
    hk, vk, xk = (HashKernels(device, rng(0)), TensoVMKernels(device, rng(0)),
                  XorKernels(device, rng(0)))
    tk = TriPlaneKernels(device, rng(0))
    accum = (SS.row_accum_atomic, SS.row_accum_segmented)
    room0_cfg = room0_config(out, H, W, N_FRAMES)
    xor_cfg = room0_xor_config(out, H, W, N_FRAMES, exp_name="chip_smoke_xor")

    t = time.perf_counter()
    data = SyntheticFrames(room0_cfg, N_FRAMES)
    print(f"  rendered {N_FRAMES} frames {H}x{W} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    vm_cfg = room0_vm_config(out, H, W, N_FRAMES)
    hybrid_cfg = room0_hybrid_config(out, H, W, N_FRAMES)
    os.makedirs(out, exist_ok=True)
    rays = {}   # slice -> the ray-ordered points of its first BA call
    for name, cfg_fn, cfg in (("", room0_config, room0_cfg),
                              ("_xor", room0_xor_config, xor_cfg),
                              ("_vm", room0_vm_config, vm_cfg),
                              ("_hybrid", room0_hybrid_config, hybrid_cfg)):
        _phase(f"ray-ordered points: the room0{name} slice's first BA call")
        ray = record_ba_points(cfg_fn(out, H, W, N_FRAMES,
                                      exp_name=f"chip_smoke{name}_rays"),
                               data, device)
        ba_case = [c for c in main_path_cases(cfg, N_FRAMES)
                   if c[0] == "BA 1 kf"]
        assert ray.shape == (ba_case[0][1], 3), (ray.shape, ba_case)
        path = f"output/ba_points{name}.npy"
        np.save(os.path.join(REPO, path), ray.cpu().numpy())
        outside = int(((ray < 0) | (ray > 1)).any(1).sum())
        print(f"  {ray.shape[0]} points ({outside} outside [0, 1]), saved "
              f"to {path}", flush=True)
        rays[name] = ray

    _phase("L2 rate: a plain gather over an L2-resident table")
    l2 = l2_rate(device)
    print(f"  {l2['sectors']} sector accesses in {l2['ms']:.4f} ms: "
          f"{l2['sectors_per_ms']:.4g} per ms", flush=True)

    measured = {}   # kernel name -> its record, launches aside
    for k, cfg, ray in ((hk, room0_cfg, rays[""]), (vk, vm_cfg, rays["_vm"]),
                        (xk, xor_cfg, rays["_xor"])):
        _phase(f"kernels against the plain versions: {k.source}")
        for name, rec in check_kernels(
                device, k, main_path_cases(cfg, N_FRAMES), ray, l2).items():
            measured[name] = {"source": k.source, **k.record[name], **rec}

    # The Dense grid (grid.enc: Dense, 67 M rows at room0's resolution) at
    # the BA 1-keyframe case: 4 dense XOR levels under grad_impl pallas
    # through E and G, 4 dense packed levels under the default grad_impl
    # through A and B.
    from coslam_torch.models.scene_rep import JointEncoding

    dense_cfg = room0_xor_config(out, H, W, N_FRAMES)
    dense_cfg["grid"]["enc"] = "Dense"
    dense_spec = JointEncoding(dense_cfg, dense_cfg["mapping"]["bound"],
                               device).grid_spec
    packed_spec = packed_dense_spec(device)
    ba1 = [c for c in main_path_cases(xor_cfg, N_FRAMES) if c[0] == "BA 1 kf"]
    for kernels, spec in ((XorKernels, dense_spec),
                          (HashKernels, packed_spec)):
        assert spec.n_levels == 4 and not any(spec.hashed)
        dk = kernels(device, rng(0), spec)
        _phase(f"kernels against the plain versions: {dk.source}, the Dense "
               f"grid ({spec.total_entries} rows)")
        for name, rec in check_kernels(device, dk, ba1, None, l2).items():
            measured[name]["max_abs_err"] = max(
                measured[name]["max_abs_err"], rec.pop("max_abs_err"))
            measured[name]["dense"] = rec
        del dk

    # TriPlaneHybrid (room0_hybrid): the planes through T and U at every
    # case of the slice but the lattice (the planes' lattice is the plain
    # separable encode), each table gradient held to its sum-order bound;
    # the 3 dense levels (115,721 rows, no hashed level) through A and B
    # at every case.
    _phase(f"kernels against the plain versions: {tk.source}, the "
           f"tri-plane (T, U) at room0_hybrid's planes "
           f"({tk.spec.total_entries} rows)")
    hybrid_cases = main_path_cases(hybrid_cfg, N_FRAMES)
    for name, rec in check_kernels(
            device, tk, [c for c in hybrid_cases if c[0] != "lattice"],
            rays["_hybrid"], l2, sum_order=True).items():
        measured[name] = {"source": tk.source, **tk.record[name], **rec}
    hybrid_dense = JointEncoding(hybrid_cfg, hybrid_cfg["mapping"]["bound"],
                                 device).grid_spec[0]
    assert hybrid_dense.n_levels == 3 and not any(hybrid_dense.hashed)
    hd = HashKernels(device, rng(0), hybrid_dense)
    _phase(f"kernels against the plain versions: {hd.source}, "
           f"room0_hybrid's dense levels ({hybrid_dense.total_entries} rows)")
    for name, rec in check_kernels(device, hd, hybrid_cases, rays["_hybrid"],
                                   l2, sum_order=True).items():
        measured[name]["max_abs_err"] = max(
            measured[name]["max_abs_err"], rec.pop("max_abs_err"))
        measured[name]["hybrid_dense"] = rec
    del hd

    # The TUM recipe at fr1_desk's width (tum_config: resolution 325,
    # 822,884 rows) through A and B at every case of its slice: each step's
    # coarse case (85 samples a ray) and its fine pass's (128 a ray),
    # each table gradient within its sum-order bound.
    tum_cfg = tum_config(out, H, W, N_FRAMES, exp_name="chip_smoke_tum")
    tum_spec = JointEncoding(tum_cfg, tum_cfg["mapping"]["bound"],
                             device).grid_spec
    assert tum_spec.total_entries == 822_884, tum_spec.total_entries
    tum_cases = main_path_cases(tum_cfg, N_FRAMES)
    tk_tum = HashKernels(device, rng(0), tum_spec)
    _phase(f"kernels against the plain versions: {tk_tum.source}, the TUM "
           f"recipe's grid ({tum_spec.total_entries} rows)")
    for name, rec in check_kernels(device, tk_tum, tum_cases,
                                   sum_order=True).items():
        measured[name]["max_abs_err"] = max(
            measured[name]["max_abs_err"], rec.pop("max_abs_err"))
        measured[name]["tum"] = rec
    del tk_tum

    from coslam_torch.ops import hash_packed as HP
    from coslam_torch.ops import tensovm as VM
    from coslam_torch.ops import triplane as TP

    for k, cfg, ray, serial in ((hk, room0_cfg, rays[""],
                                 HP.grid_encode_bwd_serial),
                                (vk, vm_cfg, rays["_vm"],
                                 VM.tensovm_encode_bwd_serial),
                                (tk, hybrid_cfg, rays["_hybrid"],
                                 TP.triplane_encode_bwd_serial)):
        _phase(f"the serial mode against the plain version: {k.source}")
        ba1 = [c for c in main_path_cases(cfg, N_FRAMES)
               if c[0] == "BA 1 kf"][0]
        measured[serial.__name__] = {
            "source": k.source, **k.record[serial.__name__],
            **check_serial(device, k, ba1, ray)}

    _phase("kernels against the plain versions: the row accumulate, "
           + ", ".join(sorted(set(ACCUM_SOURCES.values()))))
    for name, rec in check_accumulate(
            device, xk, main_path_cases(xor_cfg, N_FRAMES), rays[""]).items():
        measured[name] = {"source": ACCUM_SOURCES[name], **ACCUM_RECORD,
                          **rec}
    _phase(f"kernels against the plain versions: {PROBE_SOURCE}")
    for name, rec in check_probes(device).items():
        measured[name] = {"source": PROBE_SOURCE, **PROBE_RECORD[name], **rec}
    _phase("the warp merge of P, Q, R, F and U: adversarial streams and "
           "points")
    ba1 = [c for c in hybrid_cases if c[0] == "BA 1 kf"][0]
    for name, rec in check_warp_runs(device, tk, ba1[1]).items():
        measured[name]["max_abs_err"] = max(measured[name]["max_abs_err"],
                                            rec.pop("max_abs_err"))
        measured[name].update(rec)

    from coslam_torch.ops import probe_accum as PA

    t = _phase("probes: coslam_torch.tools.bench at the probes' shapes")
    launches = run_probes([PA.probe_accum, PA.probe_accum_bf16x2,
                           PA.probe_accum_pair_merged,
                           PA.probe_accum_cell_merged,
                           PA.probe_accum_run_merge,
                           PA.probe_accum_run_skip])
    print(f"  probes {time.perf_counter() - t:.1f} s", flush=True)

    # (config, kernels that run in every tracking and BA iteration, kernels
    # that run in every table-gradient iteration, frames or None for all).
    slices = [
        (room0_config(out, H, W, N_FRAMES, exp_name="chip_smoke"),
         [hk.fwd_fn, hk.bwd_fn], [], None),
        (room0_vm_config(out, H, W, N_FRAMES, exp_name="chip_smoke_vm"),
         [vk.fwd_fn, vk.bwd_fn], [], None),
        (xor_cfg, [xk.fwd_fn, xk.bwd_fn], [SS.row_accum_segmented], None),
        (room0_xor_config(out, H, W, N_FRAMES, exp_name="chip_smoke_scatter",
                          grad_impl="scatter"),
         [xk.fwd_fn, xk.bwd_fn], [SS.row_accum_atomic], 6),
        (room0_hybrid_config(out, H, W, N_FRAMES,
                             exp_name="chip_smoke_hybrid"),
         [hk.fwd_fn, hk.bwd_fn, tk.fwd_fn, tk.bwd_fn], [], None)]
    wrappers = [hk.fwd_fn, hk.bwd_fn, vk.fwd_fn, vk.bwd_fn, xk.fwd_fn,
                xk.bwd_fn, tk.fwd_fn, tk.bwd_fn, *accum]

    for cfg, own, table_own, n_frames in slices:
        t = _phase(f"slice: CoSLAM.run at {cfg['data']['exp_name']} "
                   f"({cfg['grid']['enc']}, grad_impl "
                   f"{cfg['grid'].get('grad_impl', 'auto')}, "
                   f"{n_frames or N_FRAMES} frames)")
        counts = run_slice(device, cfg, data, wrappers, own, table_own,
                           n_frames)
        print(f"  slice {time.perf_counter() - t:.1f} s", flush=True)
        for fn in (*own, *table_own):
            launches.setdefault(fn.__name__, counts[fn.__name__])
    t = _phase(f"slice: CoSLAM.run at {tum_cfg['data']['exp_name']} (the "
               f"TUM recipe, {tum_cfg['grid']['enc']}, n_importance "
               f"{tum_cfg['training']['n_importance']}, {N_FRAMES} frames "
               "from TUM-layout files)")
    tum_data = tum_frames(tum_cfg, N_FRAMES)
    print(f"  wrote and opened {tum_data.num_frames} frames "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    counts = run_slice(device, tum_cfg, tum_data, wrappers,
                       [hk.fwd_fn, hk.bwd_fn])
    print(f"  slice {time.perf_counter() - t:.1f} s", flush=True)
    for fn in (hk.fwd_fn, hk.bwd_fn):
        launches[fn.__name__] += counts[fn.__name__]
    serial = (HP.grid_encode_bwd_serial, VM.tensovm_encode_bwd_serial,
              TP.triplane_encode_bwd_serial)
    for cfg, frames, own, atomic in (
            (room0_config(out, H, W, N_FRAMES, exp_name="chip_smoke_det"),
             N_FRAMES, [serial[0]], [hk.bwd_fn]),
            (room0_vm_config(out, H, W, N_FRAMES,
                             exp_name="chip_smoke_vm_det"), 10, [serial[1]],
             [vk.bwd_fn]),
            (room0_hybrid_config(out, H, W, N_FRAMES,
                                 exp_name="chip_smoke_hybrid_det"), 10,
             [serial[0], serial[2]], [hk.bwd_fn, tk.bwd_fn])):
        t = _phase(f"resume: {cfg['data']['exp_name']} ({cfg['grid']['enc']}"
                   f", {frames} frames) under "
                   "torch.use_deterministic_algorithms(True)")
        counts = run_resume(device, cfg, data, frames, 5, own, atomic,
                            [*wrappers, *serial])
        print(f"  resume {time.perf_counter() - t:.1f} s", flush=True)
        for fn in own:
            launches.setdefault(fn.__name__, counts[fn.__name__])

    t = _phase("current-frame step: room0, 6 frames, cur_frame_iters 2")
    cur_cfg = room0_config(out, H, W, N_FRAMES, exp_name="chip_smoke_cur")
    cur_cfg["mapping"]["cur_frame_iters"] = 2
    run_current_frame(device, cur_cfg, data, 6, hk.fwd_fn, hk.bwd_fn)
    print(f"  current frame {time.perf_counter() - t:.1f} s", flush=True)

    t = _phase("TUM extras: 6 frames with frame_align, iter_point 5 and the "
               "bf16 decoder")
    extras_cfg = tum_config(out, H, W, N_FRAMES,
                            exp_name="chip_smoke_tum_extras")
    extras_cfg["training"]["frame_align"] = True
    extras_cfg["tracking"]["iter_point"] = 5
    extras_cfg["decoder"]["dtype"] = "bfloat16"
    extras_cfg["mapping"].update(first_iters=200, first_mesh=False)
    extras_cfg["mesh"]["vis"] = 0
    run_tum_extras(device, extras_cfg, tum_data, 6, hk.fwd_fn)
    print(f"  extras {time.perf_counter() - t:.1f} s", flush=True)

    t = _phase(f"pipelined: PipelinedCoSLAM.run at room0, {N_FRAMES} "
               "frames, the tracker and the mapper on two CUDA streams")
    counts = run_pipelined(device, pipelined_config(out), data, hk.fwd_fn,
                           hk.bwd_fn, SLICE_SUMMARIES["chip_smoke"])
    print(f"  pipelined {time.perf_counter() - t:.1f} s", flush=True)
    for name, n in counts.items():
        launches[name] += n
    t = _phase(f"active: ActiveCoSLAM.run at the TUM recipe, {N_FRAMES} "
               f"frames from TUM-layout files, {ACTIVE_SETTINGS}")
    counts = run_active(device, active_config(out), tum_data, hk.fwd_fn,
                        hk.bwd_fn)
    print(f"  active {time.perf_counter() - t:.1f} s", flush=True)
    for name, n in counts.items():
        launches[name] += n

    t_quality = _phase("quality: the quality rows' grids, the device tracer "
                       "and coslam_torch.tools.quality_bench on the card")
    for label, kernels, spec, cfg, frames in quality_specs(device):
        qk = kernels(device, rng(0), spec)
        _phase(f"kernels against the plain versions: {qk.source}, the "
               f"{label} recipe's grid ({spec.total_entries} rows)")
        cases = main_path_cases(cfg, frames)
        ba = [c for c in cases if c[0].startswith("BA ")]
        cases = [c for c in cases if not c[0].startswith("BA ")
                 or c in (ba[0], ba[1], ba[-1])]
        for name, rec in check_kernels(device, qk, cases,
                                       sum_order=True).items():
            measured[name]["max_abs_err"] = max(
                measured[name]["max_abs_err"], rec.pop("max_abs_err"))
            measured[name].setdefault("quality", {})[label] = rec
        del qk
    print(f"  device tracer: largest difference "
          f"{check_device_tracer(device):.3g}", flush=True)
    quality = run_quality(device, wrappers, {
        "replica": [hk.fwd_fn, hk.bwd_fn], "rgbd": [vk.fwd_fn, vk.bwd_fn],
        "replica_hybrid": [hk.fwd_fn, hk.bwd_fn, tk.fwd_fn, tk.bwd_fn]})
    for label, counts in quality.items():
        for name, n in counts.items():
            if name in measured and n:
                measured[name].setdefault("quality_launches", {})[label] = n
    wall = time.perf_counter() - t_quality
    print(f"  quality {wall:.1f} s (budget {QUALITY_WALL_S:.0f} s)",
          flush=True)
    assert wall <= QUALITY_WALL_S, (wall, QUALITY_WALL_S)

    t = _phase("quality: coslam_torch.tools.quality_bench --pipelined, the "
               "replica row")
    quality = run_quality(device, wrappers,
                          {"replica_pipelined": [hk.fwd_fn, hk.bwd_fn]},
                          QUALITY_PIPELINED)
    for label, counts in quality.items():
        for name, n in counts.items():
            if name in measured and n:
                measured[name].setdefault("quality_launches", {})[label] = n
    wall = time.perf_counter() - t
    print(f"  quality pipelined {wall:.1f} s (budget "
          f"{QUALITY_PIPELINED_WALL_S:.0f} s)", flush=True)
    assert wall <= QUALITY_PIPELINED_WALL_S, (wall, QUALITY_PIPELINED_WALL_S)

    t = _phase("tools: parallel.dp on one card, render_view, tsdf_fusion, "
               "export and the live view on room0")
    for name, n in run_tools_phase(device, data, hk).items():
        launches[name] += n
    wall = time.perf_counter() - t
    print(f"  tools {wall:.1f} s (budget {TOOLS_WALL_S:.0f} s)", flush=True)
    assert wall <= TOOLS_WALL_S, (wall, TOOLS_WALL_S)

    first = ("source", "replaces", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")
    records = [{"name": name, "route": "cuda", "source": rec["source"],
                "replaces": rec["replaces"], "launches": launches[name],
                **{key: rec[key] for key in first[2:]},
                **{key: v for key, v in rec.items() if key not in first}}
               for name, rec in measured.items()]
    print(f"smoke wall {time.perf_counter() - t_start:.1f} s", flush=True)
    print("host model, not read from the kernels: the rows of atomics "
          "their warp merges should issue and the encodes' L2 figures, "
          "from the indices: "
          + json.dumps(HOST_MODEL))
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
