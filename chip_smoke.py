#!/usr/bin/env python3
"""Smoke run of coslam_torch on one NVIDIA card (H100).

    python3 chip_smoke.py

Run from the repository root. Phases, each printing its own lines:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: compile the CUDA kernels from coslam_torch/csrc with nvcc;
   render the 15-frame scene, and record the ray-ordered points of the
   first BA call of the room0, room0_xor and room0_vm slices
   (coslam_torch.tools.kernel_times.record_ba_points: 4,096 rays x 43
   samples, or x 27 for TensoVM, a ray's samples adjacent; saved to
   output/ba_points.npy, ba_points_xor.npy and ba_points_vm.npy for
   kernel_times' --points, --xor-points and --vm-points); measure the
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
   1-keyframe case; then the row accumulate,
   kernels F (atomic: kernel P's CUDA kernel with its clip rule) and H
   (deterministic), on kernel G's update streams of every case that asks
   for the table gradient (up to 22.5 M updates) and of the room0
   slice's ray-ordered points, against the plain version, H also
   bit-identical over two calls
   and bit for bit equal to a serial np.add.at on the host at every case,
   F and H and index_add_ also under a CUDA graph, and H's three phases
   (sort, run starts, walk) each timed alone; then the probes' kernels P
   (scalar and float4 atomics), Q, R and S
   (coslam_torch/csrc/probe_accum.cu) at each probe's main shape against
   their plain versions, and P's pair form and skip rule, timed on the
   card alone by CUDA graphs of the calls; then the serial modes of B and
   D (K2 and K3 in the TPU kernels' serial order) at the BA 1-keyframe
   case and on the ray-ordered points: the same bits over two calls and
   a CUDA graph replay, within the sum-order bound of the plain version,
   the largest ulp distance from the host's plain version, kernel H's
   walk over the kernel's own streams equal to np.add.at of them, and
   their times beside the atomic mode's and deterministic
   index_put_(accumulate=True)'s on the same streams;
4. probes: the five scatter-accumulate probes of
   coslam_torch/tools/bench (their entry points, --quick: one setting
   per kernel, at the probes' own shapes; each holds every variant to
   its plain version within the sum-order bound and raises beyond it),
   with the launch counts of P, Q, R and S set to 0 just before and read
   just after;
5. slices: the sequential SLAM loop (CoSLAM.run) at room0's model width
   and recipe (hash grid), at room0_vm's (TensoVM) and at room0_xor's
   (the XOR hash with grad_impl pallas, kernel H), on one 15-frame
   480x640 analytic synthetic scene, each checked for finite losses,
   keyframes 0, 5 and 10, ATE RMSE < 10 cm and a mesh; then room0_xor with
   grad_impl scatter (kernel F) from the first frame to the first BA call
   (6 frames, no mesh). Every slice checks the launches of its kernels on
   the path (every count set to 0 just before the slice and read just
   after it), and that the mesh came from the port's own native marching
   cubes;
6. resume, under torch.use_deterministic_algorithms(True) (with
   CUBLAS_WORKSPACE_CONFIG set at the top of this script): room0 for 15
   frames and room0_vm for 10, each writing a checkpoint every 5 frames,
   then a fresh CoSLAM loaded from the last periodic checkpoint and run
   to the end, its poses and every parameter tensor equal to the
   straight run's bit for bit; the serial modes launched in every
   table-gradient iteration and the atomic B and D only for tracking's
   dx (launch counts over the straight run, set to 0 just before it);
7. the current-frame step: room0 for 6 frames with cur_frame_iters 2,
   kernels A and B launched in each of its iterations, ATE < 10 cm;
8. quality: kernels A and B at the replica quality recipe's packed grid
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
   ATE < 10 cm, depth-L1 < 3 cm) and the rgbd protocol (30 frames;
   finite metrics, ATE < 10 cm), with every launch count set to 0 just
   before each run and read just after (A and B, C and D launched), the
   phase within QUALITY_WALL_S.

Every kernel's record carries its time (for P-S, whose calls are short
enough that the host's cost per call would show, the card's time from a
CUDA graph of the calls, and ``call_ms`` with the host's cost), its plain
version's, the time of one PyTorch call for the same function where
there is one (``library_ms``; index_add_ for the row accumulates) and
its bound: the
larger of the bytes it must move (each input read once, each output
written once; table rows counted as those this run's points touch) over
3.35 TB/s and its f32 operations over 67 TFLOP/s (H100 SXM).

The last three lines are the card's name and power limit as nvidia-smi
prints them, the kernels' JSON record and
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
import subprocess
import sys
import time

# cuBLAS reads this when it starts: with it, matrix products are
# deterministic under torch.use_deterministic_algorithms(True), which the
# resume phase turns on.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402

from coslam_torch.data.synth import (  # noqa: E402
    SyntheticFrames, room0_config, room0_vm_config, room0_xor_config)
from coslam_torch.tools.bench._common import accum_bound, bound  # noqa: E402
from coslam_torch.tools.kernel_times import (  # noqa: E402
    a_l2_sectors, c_l2_sectors, d_l2_sectors, e_l2_sectors, h_phases,
    l2_rate, main_path_cases, packed_dense_spec, record_ba_points)
from coslam_torch.tools.kernel_times import (  # noqa: E402
    graph_ms as _graph_ms, time_ms as _time_ms)

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
# On the ray-ordered points B's dtable and D's dplanes and dlines are held
# to the sum-order bound of each entry instead (table_tol): the samples of
# a ray share coarse rows, whose thousands of contributions can cancel to
# near 0.
# Kernel G's update streams are exact: the same selects and correctly
# rounded products as the plain version. The row accumulates F and H and
# the probes' kernels P-S are held to their plain versions (index_add_,
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
                  "mode": "serial order (K2, K3), kernel B's stream and "
                          "kernel H's sort and walk"}}

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

    def serial_stream(self, x):
        """(keys, vals, tables): the stream buffers the serial mode wrote
        at x's size, and each table's rows in the concatenated key range."""
        from coslam_torch.ops import serial_scatter as SS

        rows = self.spec.total_entries
        keys, vals, _ = SS.stream_scratch(
            2 * self.spec.n_levels * 4 * x.shape[0], rows, x.device)
        return keys, vals, {"dtable": (0, rows)}

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
                  "mode": "serial order (K3), kernel D's stream and "
                          "kernel H's sort and walk"}}

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

    def serial_stream(self, x):
        from coslam_torch.ops import serial_scatter as SS

        tp, tl = self.spec.total_entries, self.lines.shape[0]
        keys, vals, _ = SS.stream_scratch(
            6 * self.spec.n_levels * x.shape[0], tp + tl, x.device)
        return keys, vals, {"dplanes": (0, tp), "dlines": (tp, tp + tl)}

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


# The probes' kernels: P, Q, R and S replace K5-K12, the pallas_calls of
# the scatter-accumulate probes under tools/bench/.
PROBE_SOURCE = "coslam_torch/csrc/probe_accum.cu"
PROBE_RECORD = {
    "probe_accum": {
        "replaces": "tools/bench/_bench_row_rates.py:126",
        "also_replaces": ["tools/bench/_bench_row_rates.py:109",
                          "tools/bench/_bench_cell_merge.py:101",
                          "tools/bench/_bench_chunk_tune.py:81",
                          "tools/bench/_bench_scatter_variants.py:86",
                          "tools/bench/_bench_run_merge.py:196"]},
    "probe_accum_bf16x2": {
        "replaces": "tools/bench/_bench_row_rates.py:126",
        "also_replaces": ["tools/bench/_bench_scatter_variants.py:86"]},
    "probe_accum_pair_merged": {
        "replaces": "tools/bench/_bench_cell_merge.py:124"},
    "probe_accum_run_merge": {
        "replaces": "tools/bench/_bench_run_merge.py:123"},
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
    kernels that have an L2 figure (``kernels.l2_sectors``: A, C, E, D) get
    ``l2_ms`` and ``ray_l2_ms``: their sector accesses over that rate."""
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
        if key is not None and l2 is not None:
            for name, sectors in zip((fwd, bwd), kernels.l2_sectors(
                    x, need_table, need_dx)):
                if sectors is not None:
                    out[name][key + "l2_ms"] = sectors / l2["sectors_per_ms"]
                    times[name[-3:] + "_l2"] = out[name][key + "l2_ms"]
        line += [f"{k} {v:.4f} ms" for k, v in times.items()]
        print("  " + ", ".join(line), flush=True)
        if label == timed[0]:
            work = kernels.work(n, kernels.touched_bytes(x, g), need_table,
                                need_dx)
            out[fwd].update(ms=times["fwd"], plain_ms=times["fwd_plain"],
                            library_ms=None, **bound(*work[0]))
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
    at both (``phases``, ``ray_phases``)."""
    import torch

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
    """Kernels P-S against their plain versions at each probe's main
    shape, each within the sum-order bound of the plain version
    (``_common.sum_order_tol``: twice the worst-case error of an f32 sum
    of an entry's updates in any order): P (streams, float4 and scalar
    atomics) and Q (packed bf16, float4) at the row-rate probe's W = 8
    (1,048,576 updates into 65,537 rows); P's pair form at the chunk
    probe's TUM scale (1,859,584 updates, 65,702 rows, float2, 256
    threads, 4 updates per thread, as its --quick run launches it); R on
    the cell-merge probe's "runs" stream (524,288 updates, W = 8); S and
    P's skip rule (after the suffix scan) on the run-merge probe's r = 311
    stream (62,208 updates, W = 8). Returns {kernel name: record}, timed
    at those shapes: ``ms`` and ``library_ms`` from CUDA graphs of the
    calls (``_graph_ms``: the card's time, no host cost), ``call_ms`` with
    the host's (``_time_ms``), ``plain_ms`` likewise (the plain versions
    wait on the card and cannot be captured)."""
    import torch

    from coslam_torch.ops import probe_accum as PA
    from coslam_torch.tools.bench import _bench_cell_merge as CM
    from coslam_torch.tools.bench import _bench_chunk_tune as CT
    from coslam_torch.tools.bench import _bench_row_rates as RR
    from coslam_torch.tools.bench import _bench_run_merge as RM
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
            "ms", "call_ms", "plain_ms", "library_ms", "bound_ms")
            if rec[k] is not None)

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
        setting="row rates W=8 streams, float4 (ms) and scalar (ms_vec1)"))
    unpacked = PA.unpack_bf16x2(words.T.contiguous())
    q_ref = PA.probe_accum_ref(idx, unpacked, rows + 1)
    line.append(check(PA.probe_accum_bf16x2, PA.probe_accum_bf16x2(
        idx, words, rows + 1, vec=4), q_ref,
        C.sum_order_tol(idx, unpacked, rows + 1), "Q vec4"))
    line.append("Q " + timed(
        PA.probe_accum_bf16x2,
        lambda: PA.probe_accum_bf16x2(idx, words, rows + 1, vec=4),
        lambda: PA.probe_accum_ref(idx, PA.unpack_bf16x2(
            words.T.contiguous()), rows + 1), None,
        accum_bound(m, w, ref.numel(), 2),
        setting="row rates W=8, 4 word streams, float4"))
    print(f"  row rates M={m} W={w}: " + ", ".join(line), flush=True)

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

    # R: the cell-merge probe's runs stream.
    rows, n = CM.ROWS, CM.N
    idx = _itensor(device, CM.streams(rows, n)["runs"])
    vals = _tensor(device, rng.standard_normal((CM.WIDTH, n)))
    merged = PA.merge_pairs(idx, vals)
    taken = int(merged[1].sum())
    n2 = n // 2
    line = [check(PA.probe_accum_pair_merged, PA.probe_accum_pair_merged(
        *merged, rows + 1), PA.probe_accum_ref(idx, vals.T, rows + 1),
        C.sum_order_tol(idx, vals.T, rows + 1), "R vec4")]
    line.append("R " + timed(
        PA.probe_accum_pair_merged,
        lambda: PA.probe_accum_pair_merged(*merged, rows + 1),
        lambda: PA.pair_merged_ref(*merged, rows + 1), None,
        bound(12 * n2 + 4 * CM.WIDTH * (n2 + taken)
              + 4 * (rows + 1) * CM.WIDTH, CM.WIDTH * (n2 + taken)),
        setting="cell merge runs stream, after the pre-pass, float4",
        pairs_taken=taken))
    print(f"  cell merge runs N={n} ({n2 - taken} of {n2} pairs merged): "
          + ", ".join(line), flush=True)

    # S and P's skip rule: the run-merge probe at r = 311.
    r = RM.RS[-1]
    rows = r * r
    ids, vals_np = RM.make_stream(r)
    idx, vals = _itensor(device, ids), _tensor(device, vals_np)
    m, w = vals.shape
    ref = PA.probe_accum_ref(idx, vals, rows + 1)
    tol = C.sum_order_tol(idx, vals, rows + 1)
    s_idx, s_vals = PA.run_merge_outside(idx, vals, rows)
    line = [check(PA.probe_accum_run_merge, PA.probe_accum_run_merge(
        idx, vals, rows + 1, span=16), ref, tol, "S"),
        check(PA.probe_accum, PA.probe_accum(s_idx, s_vals, rows + 1,
                                             rows=True, vec=4), ref, tol,
              "P skip")]
    buf = torch.zeros_like(ref)
    line.append("S " + timed(
        PA.probe_accum_run_merge,
        lambda: PA.probe_accum_run_merge(idx, vals, rows + 1, span=16),
        lambda: PA.probe_accum_ref(idx, vals, rows + 1),
        lambda: buf.index_add_(0, idx, vals),
        accum_bound(m, w, ref.numel()),
        setting="run merge r=311, span 16, float4",
        row_atomics=PA.adjacent_runs(idx, 16), updates=m))
    print(f"  run merge r={r} M={m}: " + ", ".join(line), flush=True)
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
    """CoSLAM.run on the synthetic frames `data` (the first `n_frames`
    only, without the final mesh, when given); returns the launch counts
    of every kernel wrapper in `wrappers` over the run (each set to 0
    just before it), after checking what the run produced, that the
    slice's own kernels were launched on the path (`own` in every
    tracking and BA iteration, `table_own` in every iteration that asks
    for the table gradient: first frame and BA) and printing its
    summary."""
    import torch

    from coslam_torch.runtime.slam import CoSLAM

    frames = data.num_frames if n_frames is None else n_frames
    mesh = n_frames is None
    slam = CoSLAM(cfg, data, device=device)

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
    n_track = (frames - 1) * tcfg["iter"]
    n_ba = len(slam.timings["mapping"]) * mcfg["iters"]
    assert n_ba > 0, "no BA call"
    floors = {fn: n_track + n_ba for fn in own}
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
        "launches": launches,
    }
    print("  " + json.dumps(summary), flush=True)
    return launches


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
    """The serial mode of kernel B or D (``kernels.serial``: K2 and K3 in
    the TPU kernels' serial order) at `case` (the BA 1-keyframe case,
    uniform points) and on the ray-ordered points `ray`: the same bits over
    two calls and from a CUDA graph's replay; within the sum-order bound of
    the plain version on the card (``kernels.table_tol``), with the largest
    ulp distance from the plain version on the host (whose index_add_ adds
    in the serial mode's order); and H's walk over the kernel's own
    streams equal to a serial np.add.at of them, bit for bit. Times, at
    both: the mode (events, graph), the atomic mode beside it, the plain
    version and deterministic ``index_put_(accumulate=True)`` on the same
    streams (the library call). Returns the record."""
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
        # H's walk over the streams this call wrote, against np.add.at.
        kernels.serial(x, g)
        keys, vals, spans = kernels.serial_stream(x)
        keys_h, vals_h = keys.cpu().numpy(), vals.cpu().numpy()
        acc = np.zeros((max(hi for _, hi in spans.values()) + 1, 2),
                       np.float32)
        np.add.at(acc, keys_h, vals_h)
        for what, (lo, hi) in spans.items():
            np.testing.assert_array_equal(got[what].cpu().numpy(),
                                          acc[lo:hi])
        line.append(f"H's walk == np.add.at of the kernel's {keys.shape[0]} "
                    "updates")
        times = {"ms": _time_ms(call), "graph_ms": _graph_ms(call),
                 "atomic_ms": _time_ms(lambda: kernels.bwd(x, g, True,
                                                           False)),
                 "plain_ms": _time_ms(lambda: kernels.bwd(x, g, True, False,
                                                          plain=True))}
        keys_l = keys.long()
        buf = torch.zeros_like(torch.from_numpy(acc), device=device)
        with _deterministic():
            times["library_ms"] = _time_ms(lambda: buf.index_put_(
                (keys_l,), vals, accumulate=True))
        line += [f"{k} {v:.4f}" for k, v in times.items()]
        print("  " + ", ".join(line), flush=True)
        rec.update({key + k: v for k, v in times.items()})
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
               serial, atomic, wrappers) -> dict:
    """Crash-resume on the card under torch.use_deterministic_algorithms
    (True): a straight run of n_frames writing a checkpoint every
    ckpt_every frames, then a fresh CoSLAM loaded from the last periodic
    checkpoint and run to the end; est_c2w and every parameter tensor
    must equal the straight run's bit for bit. The launch counts of
    `wrappers` over the straight run (each set to 0 just before it) are
    returned; the serial mode `serial` must be launched in every
    table-gradient iteration (first frame, BA) of both runs, and the
    atomic `atomic` only for tracking's dx (one a tracking iteration)."""
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
        assert launches[serial.__name__] >= mcfg["first_iters"] + n_ba, \
            launches
        assert launches[atomic.__name__] == n_track, launches

        cfg_b = copy.deepcopy(cfg)
        cfg_b["data"]["exp_name"] += "_resumed"
        slam_b = CoSLAM(cfg_b, data, device=device)
        path = os.path.join(cfg["data"]["output"], cfg["data"]["exp_name"],
                            f"checkpoint{last}.npz")
        assert slam_b.load_checkpoint(path) == last
        serial.launches = atomic.launches = 0
        slam_b.run(n_frames=n_frames, verbose=False, mesh=False,
                   start_frame=last)
        torch.cuda.synchronize()
        n_ba_b = len(slam_b.timings["mapping"]) * mcfg["iters"]
        assert n_ba_b > 0 and serial.launches >= n_ba_b, serial.launches
        assert atomic.launches == (n_frames - last) * tcfg["iter"], \
            atomic.launches
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
]
QUALITY_WALL_S = 180.0


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


def run_quality(device, wrappers, own) -> dict:
    """quality_bench.main on the card for each of QUALITY_RUNS (--frames_in
    memory, 120x160, Co-SLAM culling, 50 eval views), each checked for
    finite metrics, its bounds and the launches of its grid's kernels
    (`own[label]`: every count set to 0 just before the run, read just
    after; each must have launched). Returns {label: launches}."""
    import torch

    from coslam_torch.tools import quality_bench

    launches = {}
    for label, flags, bounds in QUALITY_RUNS:
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
        for fn in own[label]:
            assert counts[fn.__name__] > 0, (label, fn.__name__, counts)
        launches[label] = counts
        print("  " + json.dumps({
            "run": label, "wall_s": wall, "launches": counts,
            **{k: res[k] for k in (
                "ate_rmse_cm", "acc_cm", "comp_cm", "comp_ratio_pct",
                "depth_l1_cm", "virtual_cameras", "runtime_s",
                "tracking_ms", "mapping_ms", "device")}}), flush=True)
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
    accum = (SS.row_accum_atomic, SS.row_accum_segmented)
    room0_cfg = room0_config(out, H, W, N_FRAMES)
    xor_cfg = room0_xor_config(out, H, W, N_FRAMES, exp_name="chip_smoke_xor")

    t = time.perf_counter()
    data = SyntheticFrames(room0_cfg, N_FRAMES)
    print(f"  rendered {N_FRAMES} frames {H}x{W} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    vm_cfg = room0_vm_config(out, H, W, N_FRAMES)
    os.makedirs(out, exist_ok=True)
    rays = {}   # slice -> the ray-ordered points of its first BA call
    for name, cfg_fn, cfg in (("", room0_config, room0_cfg),
                              ("_xor", room0_xor_config, xor_cfg),
                              ("_vm", room0_vm_config, vm_cfg)):
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

    from coslam_torch.ops import hash_packed as HP
    from coslam_torch.ops import tensovm as VM

    for k, cfg, ray, serial in ((hk, room0_cfg, rays[""],
                                 HP.grid_encode_bwd_serial),
                                (vk, vm_cfg, rays["_vm"],
                                 VM.tensovm_encode_bwd_serial)):
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

    from coslam_torch.ops import probe_accum as PA

    t = _phase("probes: coslam_torch.tools.bench at the probes' shapes")
    launches = run_probes([PA.probe_accum, PA.probe_accum_bf16x2,
                           PA.probe_accum_pair_merged,
                           PA.probe_accum_run_merge])
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
         [xk.fwd_fn, xk.bwd_fn], [SS.row_accum_atomic], 6)]
    wrappers = [hk.fwd_fn, hk.bwd_fn, vk.fwd_fn, vk.bwd_fn, xk.fwd_fn,
                xk.bwd_fn, *accum]

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
    serial = (HP.grid_encode_bwd_serial, VM.tensovm_encode_bwd_serial)
    for cfg, frames, own, atomic in (
            (room0_config(out, H, W, N_FRAMES, exp_name="chip_smoke_det"),
             N_FRAMES, serial[0], hk.bwd_fn),
            (room0_vm_config(out, H, W, N_FRAMES,
                             exp_name="chip_smoke_vm_det"), 10, serial[1],
             vk.bwd_fn)):
        t = _phase(f"resume: {cfg['data']['exp_name']} ({cfg['grid']['enc']}"
                   f", {frames} frames) under "
                   "torch.use_deterministic_algorithms(True)")
        counts = run_resume(device, cfg, data, frames, 5, own, atomic,
                            [*wrappers, *serial])
        print(f"  resume {time.perf_counter() - t:.1f} s", flush=True)
        launches[own.__name__] = counts[own.__name__]

    t = _phase("current-frame step: room0, 6 frames, cur_frame_iters 2")
    cur_cfg = room0_config(out, H, W, N_FRAMES, exp_name="chip_smoke_cur")
    cur_cfg["mapping"]["cur_frame_iters"] = 2
    run_current_frame(device, cur_cfg, data, 6, hk.fwd_fn, hk.bwd_fn)
    print(f"  current frame {time.perf_counter() - t:.1f} s", flush=True)

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
        "replica": [hk.fwd_fn, hk.bwd_fn], "rgbd": [vk.fwd_fn, vk.bwd_fn]})
    for label, counts in quality.items():
        for name, n in counts.items():
            if name in measured and n:
                measured[name].setdefault("quality_launches", {})[label] = n
    wall = time.perf_counter() - t_quality
    print(f"  quality {wall:.1f} s (budget {QUALITY_WALL_S:.0f} s)",
          flush=True)
    assert wall <= QUALITY_WALL_S, (wall, QUALITY_WALL_S)

    first = ("source", "replaces", "max_abs_err", "ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")
    records = [{"name": name, "route": "cuda", "source": rec["source"],
                "replaces": rec["replaces"], "launches": launches[name],
                **{key: rec[key] for key in first[2:]},
                **{key: v for key, v in rec.items() if key not in first}}
               for name, rec in measured.items()]
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
