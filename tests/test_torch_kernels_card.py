"""The CUDA kernels of coslam_torch against their plain PyTorch versions,
on the card: kernels A and B (hash grid), C and D (TensoVM), T and U (the
tri-plane; bottom of the file, with U's serial mode), E and G (XOR
hash grid; A, C, E and D also on ray-ordered points, E also at the Dense
grid's 4 levels; A and C also on a side stream, in a CUDA graph, and
refusing what they do not take), the row accumulate F (atomic) and H
(deterministic, also on adversarial streams), and the probes' kernels
P, Q, R (both forms), S and V (bottom of the file; P, Q, R and F also on
streams built to break their warp merge, U on points in one cell). This file imports no
jax, so it also runs on a machine with the card and without the JAX
package's dependencies:

    python -m pytest --noconftest -q tests/test_torch_kernels_card.py

Without a CUDA device every test skips. Tolerances: the forward is the
same arithmetic up to FMA contraction (rtol 1e-5); the backward adds with
f32 atomics in a run-dependent order (rtol 1e-4); dx sums terms scaled
by resolutions up to 399, so an entry near zero keeps an absolute error
near 1e-4 (atol 1e-3). Kernel G's update streams are exact (the same
selects and rounded products as the plain version), and kernel H adds
every row in increasing update order, so it equals a serial np.add.at bit
for bit and two calls give the same bits. Kernel F's rows are held to the
worst-case error of f32 summation in any order, (n - 1) u sum |v| with
u = 2^-24 over a row's n updates, around their exact float64 sum: an
atomic sum compared with another atomic sum at a fixed tolerance fails
now and then on rows of thousands of updates whose sum is near zero.
"""

import itertools

import numpy as np
import pytest
import torch

from coslam_torch.ops import encodings as E
from coslam_torch.ops import hash_packed as HP
from coslam_torch.ops import hash_pallas as XP
from coslam_torch.ops import probe_accum as PA
from coslam_torch.ops import serial_scatter as SS
from coslam_torch.ops import tensovm as VM
from coslam_torch.ops import triplane as TP
from coslam_torch.tools.bench._common import (WARP_EDGE_STREAMS,
                                              one_cell_points, ray_points)

torch.set_num_threads(1)

SPECS = {
    "mixed": dict(desired_resolution=64, log2_hashmap_size=13, n_levels=4,
                  base_resolution=16),
    "dense": dict(desired_resolution=24, log2_hashmap_size=16, n_levels=3,
                  base_resolution=12, dense_only=True),
    "room0": dict(desired_resolution=400, log2_hashmap_size=16),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(spec, n, seed, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((spec.total_entries, spec.n_features)),
              rng.uniform(-0.05, 1.05, (n, 3)),
              rng.standard_normal((n, spec.out_dim)))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("need", [(True, True), (False, True), (True, False)])
def test_kernels_match_plain_versions(cuda_device, name, need):
    spec = HP.make_packed_spec(**SPECS[name])
    table, x, g = _inputs(spec, 4099, 0, cuda_device)
    launches = HP.grid_encode_fwd.launches, HP.grid_encode_bwd.launches
    torch.testing.assert_close(HP.grid_encode_fwd(spec, table, x),
                               HP.grid_encode_fwd_ref(spec, table, x),
                               rtol=1e-5, atol=1e-5)
    got = HP.grid_encode_bwd(spec, table, x, g, *need)
    ref = HP.grid_encode_bwd_ref(spec, table, x, g, *need)
    torch.cuda.synchronize()
    for a, b, atol in zip(got, ref, (1e-5, 1e-3)):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=atol)
    assert (HP.grid_encode_fwd.launches, HP.grid_encode_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)


@pytest.mark.cuda
def test_autograd_function_on_card(cuda_device):
    """GridEncode on CUDA tensors: gradients through the kernels equal
    the plain backward's."""
    spec = HP.make_packed_spec(**SPECS["mixed"])
    table, x, g = _inputs(spec, 1031, 1, cuda_device)
    x = x.clamp(0.05, 0.95)
    t = table.clone().requires_grad_(True)
    xx = x.clone().requires_grad_(True)
    (HP.encode(spec, t, xx) * g).sum().backward()
    r_t, r_x = HP.grid_encode_bwd_ref(spec, table, x, g, True, True)
    torch.testing.assert_close(t.grad, r_t, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(xx.grad, r_x, rtol=1e-4, atol=1e-3)


VM_SPECS = {
    "small": dict(desired_resolution=96, n_levels=3, base_resolution=16),
    "room0_vm": dict(desired_resolution=400, n_levels=3),
}


def _vm_inputs(spec, n, seed, device):
    """Planes 0.1 x noise, lines 1 + 0.1 x noise, points in [-0.05, 1.05]
    (a few on grid lines), unit-normal cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.05, 1.05, (n, 3))
    r = spec.resolutions[-1]
    x[:16] = rng.integers(1, r, (16, 3)) / r
    arrays = (rng.standard_normal((spec.total_entries, spec.n_features)) * 0.1,
              1.0 + 0.1 * rng.standard_normal((VM.line_total_rows(spec),
                                               spec.n_features)),
              x, rng.standard_normal((n, spec.out_dim)))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(VM_SPECS))
@pytest.mark.parametrize("need", list(itertools.product((False, True),
                                                        repeat=3)))
def test_tensovm_kernels_match_plain_versions(cuda_device, name, need):
    """Kernels C and D against tensovm_encode_fwd_ref / _bwd_ref for every
    (need_dplanes, need_dlines, need_dx); None where nothing was asked."""
    spec = VM.make_tensovm_spec(**VM_SPECS[name])
    planes, lines, x, g = _vm_inputs(spec, 4099, 0, cuda_device)
    launches = VM.tensovm_encode_fwd.launches, VM.tensovm_encode_bwd.launches
    torch.testing.assert_close(VM.tensovm_encode_fwd(spec, planes, lines, x),
                               VM.tensovm_encode_fwd_ref(spec, planes, lines,
                                                         x),
                               rtol=1e-5, atol=1e-5)
    got = VM.tensovm_encode_bwd(spec, planes, lines, x, g, *need)
    ref = VM.tensovm_encode_bwd_ref(spec, planes, lines, x, g, *need)
    torch.cuda.synchronize()
    for a, b, atol in zip(got, ref, (1e-5, 1e-5, 1e-3)):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=atol)
    assert (VM.tensovm_encode_fwd.launches, VM.tensovm_encode_bwd.launches) == (
        launches[0] + 1, launches[1] + any(need))


@pytest.mark.cuda
def test_tensovm_autograd_function_on_card(cuda_device):
    """TensoVMEncode on CUDA tensors: gradients through kernel D equal the
    plain backward's."""
    spec = VM.make_tensovm_spec(**VM_SPECS["small"])
    planes, lines, x, g = _vm_inputs(spec, 1031, 1, cuda_device)
    x = x.clamp(0.05, 0.95)
    p = {"planes": planes.clone().requires_grad_(True),
         "lines": lines.clone().requires_grad_(True)}
    xx = x.clone().requires_grad_(True)
    (VM.encode(spec, p, xx) * g).sum().backward()
    r_p, r_l, r_x = VM.tensovm_encode_bwd_ref(spec, planes, lines, x, g,
                                              True, True, True)
    torch.testing.assert_close(p["planes"].grad, r_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(p["lines"].grad, r_l, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(xx.grad, r_x, rtol=1e-4, atol=1e-3)


XOR_SPECS = {
    "mixed": dict(desired_resolution=64, log2_hashmap_size=12, n_levels=4),
    "dense": dict(desired_resolution=24, log2_hashmap_size=16, n_levels=3,
                  base_resolution=12, dense_only=True),
    "room0": dict(desired_resolution=400, log2_hashmap_size=16),
}


def _xor_inputs(spec, n, seed, device):
    """Unit-normal table and cotangent; points in [-0.05, 1.05] with some
    at exactly 0 and 1 and on grid lines of the finest level."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.05, 1.05, (n, 3))
    x[:8] = rng.integers(0, 2, (8, 3))
    r = spec.resolutions[-1]
    x[8:24] = rng.integers(0, r + 1, (16, 3)) / r
    arrays = (rng.standard_normal((spec.total_entries, spec.n_features)), x,
              rng.standard_normal((n, spec.out_dim)))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(XOR_SPECS))
@pytest.mark.parametrize("need", [(True, True), (False, True), (True, False)])
def test_xor_kernels_match_plain_versions(cuda_device, name, need):
    """Kernels E and G against hashgrid_encode / xor_grid_encode_bwd_ref
    for every (need_streams, need_dx): streams exact, dx to rtol 1e-4."""
    spec = E.make_hashgrid_spec(**XOR_SPECS[name])
    table, x, g = _xor_inputs(spec, 4099, 0, cuda_device)
    launches = XP.xor_grid_encode_fwd.launches, XP.xor_grid_encode_bwd.launches
    torch.testing.assert_close(XP.xor_grid_encode_fwd(spec, table, x),
                               E.hashgrid_encode(spec, table, x),
                               rtol=1e-5, atol=1e-5)
    got = XP.xor_grid_encode_bwd(spec, table, x, g, *need)
    ref = XP.xor_grid_encode_bwd_ref(spec, table, x, g, *need)
    torch.cuda.synchronize()
    for a, b, tol in zip(got, ref, ({"rtol": 0, "atol": 0},) * 2
                         + ({"rtol": 1e-4, "atol": 1e-3},)):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, **tol)
    assert (XP.xor_grid_encode_fwd.launches,
            XP.xor_grid_encode_bwd.launches) == (launches[0] + 1,
                                                 launches[1] + 1)


def _accum_inputs(m, rows, width, seed, device):
    """idx over [-3, rows + 3) (negatives and slack-row indices), heavy on
    a few rows; unit-normal values."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-3, rows + 3, m)
    idx[: m // 4] = rng.integers(0, 4, m // 4)
    vals = rng.standard_normal((m, width)).astype(np.float32)
    return (torch.from_numpy(idx.astype(np.int32)).to(device),
            torch.from_numpy(vals).to(device), idx, vals)


def _assert_within_sum_order(got, idx, vals, rows):
    """got [rows + 1, W] within (n - 1) u sum |v| (u = 2^-24, with 1 %
    for the second-order term) of the exact sum of each row's n updates,
    whatever order they were added in."""
    keys = np.clip(idx, 0, rows)
    exact = np.zeros((rows + 1, vals.shape[1]))
    np.add.at(exact, keys, vals.astype(np.float64))
    mass = np.zeros_like(exact)
    np.add.at(mass, keys, np.abs(vals.astype(np.float64)))
    n = np.bincount(keys, minlength=rows + 1)[:, None]
    bound = 1.01 * np.maximum(n - 1, 0) * 2.0 ** -24 * mass
    err = np.abs(got.cpu().numpy().astype(np.float64) - exact)
    assert (err <= bound).all(), float((err - bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 3, 4, 16])
def test_row_accum_kernels_match_plain_versions(cuda_device, width):
    """F within the sum-order bound of the exact sum; H equal to a serial
    np.add.at on the host bit for bit, twice."""
    rows = 5000
    idx, vals, idx_np, vals_np = _accum_inputs(200_003, rows, width, 0,
                                               cuda_device)
    launches = SS.row_accum_atomic.launches, SS.row_accum_segmented.launches
    _assert_within_sum_order(SS.row_accum(idx, vals, rows, False), idx_np,
                             vals_np, rows)
    ref = np.zeros((rows + 1, width), np.float32)
    np.add.at(ref, np.clip(idx_np, 0, rows), vals_np)
    first = SS.row_accum(idx, vals, rows, True)
    second = SS.row_accum(idx, vals, rows, True)
    np.testing.assert_array_equal(first.cpu().numpy(), ref)
    assert torch.equal(first, second)
    assert (SS.row_accum_atomic.launches, SS.row_accum_segmented.launches) == (
        launches[0] + 1, launches[1] + 2)


@pytest.mark.cuda
def test_row_accum_empty_and_room0_streams(cuda_device):
    """No update: both modes give zeros. The streams of 20,000 points at
    the room0 spec (2.56 M updates): H equals np.add.at bit for bit, F is
    within the sum-order bound of the exact sum."""
    idx = torch.empty(0, dtype=torch.int32, device=cuda_device)
    vals = torch.empty((0, 2), device=cuda_device)
    for det in (False, True):
        assert torch.equal(SS.row_accum(idx, vals, 7, det),
                           torch.zeros((8, 2), device=cuda_device))
    spec = E.make_hashgrid_spec(**XOR_SPECS["room0"])
    table, x, g = _xor_inputs(spec, 20_000, 2, cuda_device)
    idx, vals, _ = XP.xor_grid_encode_bwd(spec, table, x, g, True, False)
    idx_np, vals_np = idx.cpu().numpy(), vals.cpu().numpy()
    ref = np.zeros((spec.total_entries + 1, 2), np.float32)
    np.add.at(ref, idx_np, vals_np)
    out = SS.row_accum(idx, vals, spec.total_entries, True)
    np.testing.assert_array_equal(out.cpu().numpy(), ref)
    _assert_within_sum_order(SS.row_accum(idx, vals, spec.total_entries,
                                          False), idx_np, vals_np,
                             spec.total_entries)


# Adversarial update streams for kernel H (the CPU twin of each is in
# tests/test_torch_row_accum.py). Their sizes pick out H's sort tile
# (4,096 keys), its warps' 512-key slices, its 64-update limit of a
# thread's run, and sorts of 1, 2, 3 and 4 passes.
ADVERSARIAL = ("one_row", "long_run", "tile_straddle", "out_of_range",
               "single", "rows0", "empty", "three_pass")


def adversarial_stream(name, width, seed=0):
    """(idx int32 [M], vals f32 [M, width], rows) of one named stream;
    values unit normal times 10^U(-3, 3), so that a change of order
    changes the bits of most sums."""
    rng = np.random.default_rng(seed)
    if name == "one_row":              # every update on one row
        rows, idx = 1000, np.full(20_000, 7)
    elif name == "long_run":           # one run longer than a tile, spread
        rows = 2000
        idx = rng.integers(0, rows, 15_000)
        idx[rng.random(idx.shape[0]) < 0.6] = 3
    elif name == "tile_straddle":      # runs of 4096, 512, 64 updates, +-1,
        rows = 50_000                  # after 100 others: across tiles
        lens = [4095, 4096, 4097, 511, 512, 513, 63, 64, 65]
        idx = np.concatenate([rng.integers(0, rows, 100), np.repeat(
            100 + 7 * np.arange(len(lens)), lens)])
    elif name == "out_of_range":       # below 0 and above rows
        rows = 300
        idx = rng.integers(-1000, rows + 1000, 12_000)
    elif name == "single":             # M = 1, into the slack row
        rows, idx = 5, np.array([9])
    elif name == "rows0":              # rows = 0: every update in row 0
        rows = 0
        idx = rng.integers(-5, 5, 3000)
    elif name == "empty":
        rows, idx = 10, np.zeros(0, np.int64)
    elif name == "three_pass":         # 22 bits: 4 passes of 6
        rows = 3_000_000
        idx = rng.integers(-10, rows + 10, 200_000)
    else:
        raise ValueError(name)
    vals = (rng.standard_normal((idx.shape[0], width))
            * 10.0 ** rng.uniform(-3, 3, (idx.shape[0], 1)))
    return idx.astype(np.int32), vals.astype(np.float32), rows


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 3])
@pytest.mark.parametrize("name", ADVERSARIAL)
def test_row_accum_segmented_adversarial_streams(cuda_device, name, width):
    """Kernel H on each adversarial stream: equal to a serial np.add.at bit
    for bit, and the same bits over two calls."""
    idx_np, vals_np, rows = adversarial_stream(name, width)
    idx = torch.from_numpy(idx_np).to(cuda_device)
    vals = torch.from_numpy(vals_np).to(cuda_device)
    first = SS.row_accum(idx, vals, rows, True)
    second = SS.row_accum(idx, vals, rows, True)
    torch.cuda.synchronize()
    ref = np.zeros((rows + 1, width), np.float32)
    np.add.at(ref, np.clip(idx_np, 0, rows), vals_np)
    np.testing.assert_array_equal(first.cpu().numpy(), ref)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [16, 5, 3])
@pytest.mark.parametrize("need", [(True, True), (False, True), (True, False)])
def test_grid_bwd_on_ray_ordered_points(cuda_device, levels, need):
    """Kernel B on ray-ordered points (coarse-level rows shared by the
    samples of a ray), with corner rows e both even (float4 atomic) and
    odd (two float2), points outside [0, 1], at L = 16 (dx summed by
    shuffles in a half-warp), L = 5 (in shared memory) and L = 3 with no
    hashed level (TriPlaneHybrid's dense part: 16/26/44): against
    grid_encode_bwd_ref."""
    if levels == 3:
        spec = HP.make_packed_spec(44, 16, n_levels=3, base_resolution=16,
                                   dense_only=True)
        assert not any(spec.hashed)
    else:
        spec = HP.make_packed_spec(400 if levels == 16 else 96, 16,
                                   n_levels=levels)
    x_np = ray_points(200, 43, levels)
    cell, _ = HP._cells_and_weights(spec, torch.from_numpy(x_np).float())
    e = HP._corner_entries(spec, cell)
    assert (e % 2 == 0).any() and (e % 2 == 1).any()
    assert ((x_np < 0) | (x_np > 1)).any()
    rng = np.random.default_rng(levels)
    table, x, g = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                   for a in (rng.standard_normal((spec.total_entries, 2)),
                             x_np, rng.standard_normal((x_np.shape[0],
                                                        spec.out_dim))))
    got = HP.grid_encode_bwd(spec, table, x, g, *need)
    ref = HP.grid_encode_bwd_ref(spec, table, x, g, *need)
    torch.cuda.synchronize()
    for a, b, atol in zip(got, ref, (1e-5, 1e-3)):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=atol)


@pytest.mark.cuda
def test_autograd_function_on_card_room0_rays(cuda_device):
    """GridEncode at the room0 spec (L = 16) on ray-ordered points, on
    CUDA tensors: gradients through kernels A and B equal the plain
    backward's."""
    spec = HP.make_packed_spec(**SPECS["room0"])
    x = torch.from_numpy(ray_points(100, 43, 3).astype(np.float32)).to(
        cuda_device)
    rng = np.random.default_rng(4)
    table, g = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                for a in (rng.standard_normal((spec.total_entries, 2)),
                          rng.standard_normal((x.shape[0], spec.out_dim))))
    t = table.clone().requires_grad_(True)
    xx = x.clone().requires_grad_(True)
    (HP.encode(spec, t, xx) * g).sum().backward()
    r_t, r_x = HP.grid_encode_bwd_ref(spec, table, x, g, True, True)
    torch.testing.assert_close(t.grad, r_t, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(xx.grad, r_x, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("deterministic", [True, False])
def test_xor_autograd_function_on_card(cuda_device, deterministic):
    """XorGridEncode on CUDA tensors against the same Function on the CPU
    (the plain versions): dtable bit for bit through kernel H, to rtol
    1e-4 through kernel F; dx to rtol 1e-4."""
    spec = E.make_hashgrid_spec(**XOR_SPECS["mixed"])
    table, x, g = _xor_inputs(spec, 1031, 1, cuda_device)
    grads = []
    for dev in (cuda_device, "cpu"):
        t = table.to(dev).clone().requires_grad_(True)
        xx = x.to(dev).clone().requires_grad_(True)
        (XP.encode(spec, t, xx, deterministic) * g.to(dev)).sum().backward()
        grads.append((t.grad.cpu(), xx.grad.cpu()))
    (t_card, x_card), (t_cpu, x_cpu) = grads
    if deterministic:
        assert torch.equal(t_card, t_cpu)
    torch.testing.assert_close(t_card, t_cpu, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(x_card, x_cpu, rtol=1e-4, atol=1e-3)


def _edge_points(x, r, rng):
    """x with its first 8 points at exactly 0 or 1 on every axis and the
    next 16 on grid lines of resolution r."""
    x[:8] = rng.integers(0, 2, (8, 3))
    x[8:24] = rng.integers(0, r + 1, (16, 3)) / r
    return x


# Kernel E's shapes: room0_xor's 16 levels (5 dense, 11 hashed) and the
# Dense grid's 4 dense levels (at a smaller resolution than room0's
# 67 M-row table).
E_SPECS = {"mixed16": dict(desired_resolution=400, log2_hashmap_size=16),
           "dense4": dict(desired_resolution=128, log2_hashmap_size=16,
                          n_levels=4, dense_only=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(E_SPECS))
def test_xor_fwd_on_ray_ordered_points(cuda_device, name):
    """Kernel E on ray-ordered points (the samples of a ray adjacent, so a
    warp's lanes share coarse cells), with points outside [0, 1], at
    exactly 0 and 1 and on grid lines, N = 8,600 (not a multiple of E's
    32- or 64-point tile), at L = 16 mixed and L = 4 dense: against
    hashgrid_encode; and on the first N - 1 and 1 points alone."""
    spec = E.make_hashgrid_spec(**E_SPECS[name])
    rng = np.random.default_rng(5)
    x_np = _edge_points(ray_points(200, 43, 6), spec.resolutions[-1], rng)
    assert x_np.shape[0] % 32 and ((x_np < 0) | (x_np > 1)).any()
    table, x = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                for a in (rng.standard_normal((spec.total_entries, 2)), x_np))
    launches = XP.xor_grid_encode_fwd.launches
    for n in (x.shape[0], x.shape[0] - 1, 1):
        xs = x[:n].contiguous()
        torch.testing.assert_close(XP.xor_grid_encode_fwd(spec, table, xs),
                                   E.hashgrid_encode(spec, table, xs),
                                   rtol=1e-5, atol=1e-5)
    assert XP.xor_grid_encode_fwd.launches == launches + 3


@pytest.mark.cuda
def test_xor_autograd_dense_on_card_rays(cuda_device):
    """XorGridEncode with the Dense grid's 4 levels on ray-ordered points:
    the forward through kernel E and the gradients through G and H equal
    the same Function's on the CPU (dtable bit for bit)."""
    spec = E.make_hashgrid_spec(**E_SPECS["dense4"])
    rng = np.random.default_rng(7)
    x_np = ray_points(60, 43, 8).astype(np.float32)
    table = rng.standard_normal((spec.total_entries, 2)).astype(np.float32)
    g = rng.standard_normal((x_np.shape[0], spec.out_dim)).astype(np.float32)
    outs = []
    for dev in (cuda_device, "cpu"):
        t = torch.from_numpy(table).to(dev).requires_grad_(True)
        xx = torch.from_numpy(x_np).to(dev).requires_grad_(True)
        y = XP.encode(spec, t, xx, True)
        (y * torch.from_numpy(g).to(dev)).sum().backward()
        outs.append((y.detach().cpu(), t.grad.cpu(), xx.grad.cpu()))
    (y_card, t_card, x_card), (y_cpu, t_cpu, x_cpu) = outs
    torch.testing.assert_close(y_card, y_cpu, rtol=1e-5, atol=1e-5)
    assert torch.equal(t_card, t_cpu)
    torch.testing.assert_close(x_card, x_cpu, rtol=1e-4, atol=1e-3)


def _vm_ray_inputs(spec, seed, device, rays=200):
    """room0_vm-like inputs on ray-ordered points (rays x 27 samples, some
    outside [0, 1], some at 0, 1 and on grid lines)."""
    rng = np.random.default_rng(seed)
    x = _edge_points(ray_points(rays, 27, seed + 1), spec.resolutions[-1],
                     rng)
    arrays = (rng.standard_normal((spec.total_entries, spec.n_features)) * 0.1,
              1.0 + 0.1 * rng.standard_normal((VM.line_total_rows(spec),
                                               spec.n_features)),
              x, rng.standard_normal((x.shape[0], spec.out_dim)))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("need", [(True, True, True), (False, True, True),
                                  (True, False, True), (True, True, False)])
def test_tensovm_bwd_on_ray_ordered_points(cuda_device, need):
    """Kernel D at the room0_vm spec on ray-ordered points (a warp's lanes
    share line rows and coarse plane rows), with each of need_dplanes,
    need_dlines and need_dx off in turn, points on grid lines, at 0 and 1
    and outside [0, 1], N = 5,400 (not a multiple of D's 64-point tile):
    against tensovm_encode_bwd_ref."""
    spec = VM.make_tensovm_spec(**VM_SPECS["room0_vm"])
    planes, lines, x, g = _vm_ray_inputs(spec, 9, cuda_device)
    assert x.shape[0] % 64 and bool(((x < 0) | (x > 1)).any())
    launches = VM.tensovm_encode_bwd.launches
    got = VM.tensovm_encode_bwd(spec, planes, lines, x, g, *need)
    ref = VM.tensovm_encode_bwd_ref(spec, planes, lines, x, g, *need)
    torch.cuda.synchronize()
    assert VM.tensovm_encode_bwd.launches == launches + 1
    for a, b, atol in zip(got, ref, (1e-5, 1e-5, 1e-3)):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-4, atol=atol)
    if need[2]:   # dx is zero exactly where x lies outside [0, 1]
        outside = (x < 0) | (x > 1)
        assert bool((got[2][outside] == 0).all())


@pytest.mark.cuda
def test_tensovm_autograd_function_on_card_rays(cuda_device):
    """TensoVMEncode at the room0_vm spec on ray-ordered points, on CUDA
    tensors: gradients through kernel D equal the plain backward's."""
    spec = VM.make_tensovm_spec(**VM_SPECS["room0_vm"])
    planes, lines, x, g = _vm_ray_inputs(spec, 11, cuda_device, rays=100)
    p = {"planes": planes.clone().requires_grad_(True),
         "lines": lines.clone().requires_grad_(True)}
    xx = x.clone().requires_grad_(True)
    (VM.encode(spec, p, xx) * g).sum().backward()
    r_p, r_l, r_x = VM.tensovm_encode_bwd_ref(spec, planes, lines, x, g,
                                              True, True, True)
    torch.testing.assert_close(p["planes"].grad, r_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(p["lines"].grad, r_l, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(xx.grad, r_x, rtol=1e-4, atol=1e-3)


# Kernel A's shapes: room0's 16 levels (5 dense, 11 hashed), 5 levels (3
# dense, 2 hashed) and a dense-only packed grid.
A_SPECS = {"room0": dict(desired_resolution=400, log2_hashmap_size=16),
           "L5": dict(desired_resolution=96, log2_hashmap_size=16,
                      n_levels=5),
           "dense": dict(desired_resolution=128, log2_hashmap_size=16,
                         n_levels=4, dense_only=True),
           # TriPlaneHybrid's dense part: 3 levels 16/26/44, none hashed.
           "hybrid_dense": dict(desired_resolution=44, log2_hashmap_size=16,
                                n_levels=3, base_resolution=16,
                                dense_only=True)}


def _a_inputs(name, device, seed=5):
    spec = HP.make_packed_spec(**A_SPECS[name])
    rng = np.random.default_rng(seed)
    x_np = _edge_points(ray_points(200, 43, seed + 1),
                        spec.resolutions[-1], rng)
    table, x = (torch.from_numpy(a.astype(np.float32)).to(device)
                for a in (rng.standard_normal((spec.total_entries, 2)), x_np))
    return spec, table, x


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(A_SPECS))
def test_grid_fwd_on_ray_ordered_points(cuda_device, name):
    """Kernel A on ray-ordered points (a warp's lanes share coarse cells),
    with points outside [0, 1], at exactly 0 and 1 and on grid lines, at
    room0's L = 16, at L = 5 and on two dense-only grids (L = 4, and the
    hybrid's L = 3): against
    grid_encode_fwd_ref at N = 8,600 (not a multiple of a 32-point group),
    N - 1 and 1; N = 0 gives an empty output without a launch."""
    spec, table, x = _a_inputs(name, cuda_device)
    assert x.shape[0] % 32 and bool(((x < 0) | (x > 1)).any())
    launches = HP.grid_encode_fwd.launches
    for n in (x.shape[0], x.shape[0] - 1, 1):
        xs = x[:n].contiguous()
        torch.testing.assert_close(HP.grid_encode_fwd(spec, table, xs),
                                   HP.grid_encode_fwd_ref(spec, table, xs),
                                   rtol=1e-5, atol=1e-5)
    empty = HP.grid_encode_fwd(spec, table, x[:0])
    assert empty.shape == (0, spec.out_dim)
    assert HP.grid_encode_fwd.launches == launches + 3


def _c_inputs(name, device, seed=12):
    spec = VM.make_tensovm_spec(**VM_SPECS[name])
    return (spec, *_vm_ray_inputs(spec, seed, device)[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(VM_SPECS))
def test_tensovm_fwd_on_ray_ordered_points(cuda_device, name):
    """Kernel C on ray-ordered points (a warp's lanes share line rows and
    coarse plane rows), with points outside [0, 1], at 0 and 1 and on grid
    lines, at room0_vm and a small spec: against tensovm_encode_fwd_ref at
    N = 5,400 (not a multiple of C's 64-point tile), N - 1 and 1; N = 0
    gives an empty output without a launch."""
    spec, planes, lines, x = _c_inputs(name, cuda_device)
    assert x.shape[0] % 64 and bool(((x < 0) | (x > 1)).any())
    launches = VM.tensovm_encode_fwd.launches
    for n in (x.shape[0], x.shape[0] - 1, 1):
        xs = x[:n].contiguous()
        torch.testing.assert_close(
            VM.tensovm_encode_fwd(spec, planes, lines, xs),
            VM.tensovm_encode_fwd_ref(spec, planes, lines, xs),
            rtol=1e-5, atol=1e-5)
    empty = VM.tensovm_encode_fwd(spec, planes, lines, x[:0])
    assert empty.shape == (0, spec.out_dim)
    assert VM.tensovm_encode_fwd.launches == launches + 3


def _fwd_calls(device):
    """(kernel A's call, kernel C's call, their plain versions) on
    ray-ordered points at room0 and room0_vm."""
    spec, table, x = _a_inputs("room0", device)
    vspec, planes, lines, vx = _c_inputs("room0_vm", device)
    return ((lambda: HP.grid_encode_fwd(spec, table, x),
             lambda: HP.grid_encode_fwd_ref(spec, table, x)),
            (lambda: VM.tensovm_encode_fwd(vspec, planes, lines, vx),
             lambda: VM.tensovm_encode_fwd_ref(vspec, planes, lines, vx)))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["A", "C"])
def test_fwd_on_a_side_stream_and_in_a_graph(cuda_device, kernel):
    """Kernels A and C launch on the caller's current stream: called on a
    side stream they agree with the plain version, and captured in a CUDA
    graph their launch is in the graph (the output, zeroed after capture,
    is written again by a replay)."""
    call, plain = dict(zip("AC", _fwd_calls(cuda_device)))[kernel]
    ref = plain()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = call()
    side.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_fwd_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """The A and C wrappers raise on a CPU/CUDA mix, a wrong dtype, a
    table of the wrong shape, x not [N, 3] and a non-contiguous x."""
    spec, table, x = _a_inputs("L5", cuda_device)
    vspec, planes, lines, vx = _c_inputs("small", cuda_device)
    bad = {
        "A": [(table.cpu(), x), (table, x.cpu()), (table.double(), x),
              (table[:-1], x), (table, x[:, :2].contiguous()),
              (table, torch.cat([x, x], 1)[:, ::2])],
        "C": [(planes.cpu(), lines, vx), (planes, lines, vx.cpu()),
              (planes, lines.double(), vx), (planes, lines[:-2], vx),
              (planes[:-1], lines, vx),
              (planes, lines, vx[:, :2].contiguous()),
              (planes, lines, torch.cat([vx, vx], 1)[:, ::2])]}
    for args in bad["A"]:
        with pytest.raises(ValueError):
            HP.grid_encode_fwd(spec, *args)
    for args in bad["C"]:
        with pytest.raises(ValueError):
            VM.tensovm_encode_fwd(vspec, *args)


# The probes' kernels P-S (coslam_torch/csrc/probe_accum.cu): each table
# within the sum-order bound of the exact sum of its rows' updates (the
# bound above, which cannot fail by chance on hot rows), and against the
# plain version at TABLE_TOL where no row is hot.
TABLE_TOL = dict(rtol=1e-4, atol=1e-5)


def _pieces(idx, rows2d, out_rows, stride):
    """(keys, values) of every stride-wide piece of every update whose row
    lies inside the [out_rows, stride] output (numpy)."""
    k = rows2d.shape[1] // stride
    keep = (idx >= 0) & (idx <= out_rows - k)
    keys = (idx[keep, None] + np.arange(k)).reshape(-1)
    return keys, rows2d[keep].reshape(-1, stride)


# (W, stride, vec, updates per thread, threads per block)
PROBE_SETTINGS = [(8, 8, 4, 1, 256), (8, 8, 1, 4, 128), (16, 16, 4, 8, 512),
                  (4, 2, 2, 1, 256), (4, 2, 1, 16, 128), (6, 6, 2, 2, 256),
                  (2, 2, 1, 1, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("setting", PROBE_SETTINGS, ids=str)
@pytest.mark.parametrize("rows_layout", [False, True])
def test_probe_accum_kernels_match_plain_versions(cuda_device, setting,
                                                  rows_layout):
    """Kernel P in both layouts and kernel Q (packed bf16, streams), at
    every vector width and launch shape, with out-of-range indices
    skipped: within the sum-order bound on hot rows; at TABLE_TOL to the
    plain version on uniform ones."""
    width, stride, vec, upt, threads = setting
    out_rows = 4001
    launches = PA.probe_accum.launches, PA.probe_accum_bf16x2.launches
    for hot in (True, False):
        idx, _, idx_np, _ = _accum_inputs(100_003, out_rows, 1, width,
                                          cuda_device)
        if not hot:
            idx_np = np.random.default_rng(width).integers(
                -3, out_rows + 3, idx_np.shape[0])
            idx = torch.from_numpy(idx_np.astype(np.int32)).to(cuda_device)
        streams = torch.randn(width, idx.shape[0], device=cuda_device)
        words = torch.stack([PA.pack_bf16x2(streams[2 * p], streams[2 * p + 1])
                             for p in range(width // 2)])
        calls = {"P": (streams.T, lambda: PA.probe_accum(
                     idx, streams.T.contiguous() if rows_layout else streams,
                     out_rows, stride, rows=rows_layout, vec=vec, upt=upt,
                     threads=threads)),
                 "Q": (PA.unpack_bf16x2(words.T.contiguous()),
                       lambda: PA.probe_accum_bf16x2(
                           idx, words, out_rows, stride, vec=vec, upt=upt,
                           threads=threads))}
        for rows2d, call in calls.values():
            got = call()
            torch.cuda.synchronize()
            keys, pieces = _pieces(idx_np, rows2d.cpu().numpy(), out_rows,
                                   stride)
            _assert_within_sum_order(got, keys, pieces, out_rows - 1)
            if not hot:
                torch.testing.assert_close(
                    got, PA.probe_accum_ref(idx, rows2d, out_rows, stride),
                    **TABLE_TOL)
    assert (PA.probe_accum.launches, PA.probe_accum_bf16x2.launches) == (
        launches[0] + 2, launches[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", WARP_EDGE_STREAMS)
def test_probe_accum_warp_merge_on_edge_streams(cuda_device, name, width):
    """Kernel P's warp merge (each run of equal rows in a warp's 32-update
    step summed before one row of atomics) on the streams of
    _common.WARP_EDGE_STREAMS at M = 10,007 (the last step short): P in
    every form (streams and rows at every vector width that divides W,
    with 1, 3 and 4 updates a thread and 256, 128 and 1024 threads; the
    pair form; the skip rule; the clip rule) and kernel F, each within
    the sum-order bound of the exact sum; one launch a call."""
    from coslam_torch.tools.bench import _common as C

    rows, m = 700, 10_007
    rng = np.random.default_rng(width)
    idx_np = C.warp_edge_stream(name, m, rows, seed=width)
    vals_np = rng.standard_normal((m, width)).astype(np.float32)
    idx = torch.from_numpy(idx_np).to(cuda_device)
    vals = torch.from_numpy(vals_np).to(cuda_device)
    streams = vals.T.contiguous()
    launches = PA.probe_accum.launches, SS.row_accum_atomic.launches
    keys, pieces = _pieces(idx_np, vals_np, rows + 1, width)
    calls = 0
    for vec in (v for v in (1, 2, 4) if width % v == 0):
        for upt, threads in ((1, 256), (3, 128), (4, 1024)):
            for layout in (streams, vals):
                got = PA.probe_accum(idx, layout, rows + 1,
                                     rows=layout is vals, vec=vec, upt=upt,
                                     threads=threads)
                _assert_within_sum_order(got, keys, pieces, rows)
                calls += 1
    if width % 2 == 0:
        stride = width // 2
        got = PA.probe_accum(idx, streams, rows + 1, stride,
                             vec=PA.widest_vec(stride))
        _assert_within_sum_order(got, *_pieces(idx_np, vals_np, rows + 1,
                                               stride), rows)
        calls += 1
    clipped = np.clip(idx_np, 0, rows)
    _assert_within_sum_order(SS.row_accum_atomic(idx, vals, rows), clipped,
                             vals_np, rows)
    _assert_within_sum_order(PA.launch_accum(
        "probe_accum", idx, streams, width, m, rows + 1, width,
        PA.widest_vec(width), 4, 128, False, False, clip=True), clipped,
        vals_np, rows)
    assert (PA.probe_accum.launches, SS.row_accum_atomic.launches) == (
        launches[0] + calls, launches[1] + 1)


def _offset_by_a_float(a: np.ndarray, device) -> torch.Tensor:
    """a on the card as a contiguous tensor that starts 4 bytes past its
    buffer's start, so its rows miss every 8- and 16-byte boundary."""
    buf = torch.empty(a.size + 1, device=device)
    t = buf[1:].view(a.shape)
    t.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 4, 8, 16, 32, 6, 12])
@pytest.mark.parametrize("name", WARP_EDGE_STREAMS)
def test_probe_accum_scalar_lanes(cuda_device, name, width):
    """Kernel P with scalar atomics (vec 1): where W divides 32 a warp's
    lanes lie across the rows (32 / W updates an instruction, the merge W
    lanes apart); at W = 6 and 12 one update a lane. On the streams of
    _common.WARP_EDGE_STREAMS at M = 10,007 (the last step short), values
    4 bytes past an aligned start: streams and rows with 1, 3 and 4 updates
    a thread and 256, 128 and 1024 threads (the skip rule), the stride
    W / 2 pair form in both layouts, and the clip rule in both layouts;
    each within the sum-order bound of the exact sum; one launch a
    call."""
    from coslam_torch.tools.bench import _common as C

    rows, m = 700, 10_007
    rng = np.random.default_rng(width + 100)
    idx_np = C.warp_edge_stream(name, m, rows, seed=width)
    vals_np = rng.standard_normal((m, width)).astype(np.float32)
    idx = torch.from_numpy(idx_np).to(cuda_device)
    vals = _offset_by_a_float(vals_np, cuda_device)
    streams = _offset_by_a_float(vals_np.T, cuda_device)
    launches = PA.probe_accum.launches
    keys, pieces = _pieces(idx_np, vals_np, rows + 1, width)
    calls = 0
    for upt, threads in ((1, 256), (3, 128), (4, 1024)):
        for layout in (streams, vals):
            got = PA.probe_accum(idx, layout, rows + 1, rows=layout is vals,
                                 vec=1, upt=upt, threads=threads)
            _assert_within_sum_order(got, keys, pieces, rows)
            calls += 1
    if width % 2 == 0:
        stride = width // 2
        for layout in (streams, vals):
            got = PA.probe_accum(idx, layout, rows + 1, stride,
                                 rows=layout is vals, vec=1)
            _assert_within_sum_order(got, *_pieces(idx_np, vals_np, rows + 1,
                                                   stride), rows)
            calls += 1
    clipped = np.clip(idx_np, 0, rows)
    for layout in (streams, vals):
        _assert_within_sum_order(PA.launch_accum(
            "probe_accum", idx, layout, width, m, rows + 1, width, 1, 3, 128,
            False, layout is vals, clip=True), clipped, vals_np, rows)
    assert PA.probe_accum.launches == launches + calls


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 6, 3])
def test_probe_pair_merged_kernel_matches_plain_version(cuda_device, width):
    """Kernel R after merge_pairs (float4, float2 and scalar atomics, by
    W), and its fused form on the raw updates, on the cell-merge probe's
    two streams: within the sum-order bound, and at TABLE_TOL to its plain
    version and to kernel P on the unmerged streams."""
    from coslam_torch.tools.bench import _bench_cell_merge as CM

    rows, n = 5000, 200_000
    for ids in CM.streams(rows, n).values():
        idx = torch.from_numpy(ids).to(cuda_device)
        vals = torch.randn(width, n, device=cuda_device)
        merged = PA.merge_pairs(idx, vals)
        launches = PA.probe_accum_pair_merged.launches
        got = PA.probe_accum_pair_merged(*merged, rows + 1)
        torch.cuda.synchronize()
        assert PA.probe_accum_pair_merged.launches == launches + 1
        _assert_within_sum_order(got, ids, vals.T.cpu().numpy(), rows)
        torch.testing.assert_close(got, PA.pair_merged_ref(*merged, rows + 1),
                                   **TABLE_TOL)
        torch.testing.assert_close(got, PA.probe_accum(idx, vals, rows + 1),
                                   **TABLE_TOL)
        launches = PA.probe_accum_cell_merged.launches
        fused = PA.probe_accum_cell_merged(idx, vals, rows + 1)
        torch.cuda.synchronize()
        assert PA.probe_accum_cell_merged.launches == launches + 1
        _assert_within_sum_order(fused, ids, vals.T.cpu().numpy(), rows)
        torch.testing.assert_close(fused, PA.cell_merged_ref(idx, vals,
                                                             rows + 1),
                                   **TABLE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 4, 8, 16])
@pytest.mark.parametrize("name", WARP_EDGE_STREAMS)
def test_probe_q_on_edge_streams(cuda_device, name, width):
    """Kernel Q (kernel P's two kernels, the words unpacked as they are
    loaded) at vec 1, 2 and 4 where they divide W, on the streams of
    _common.WARP_EDGE_STREAMS at M = 10,007 (the last step short): word
    streams with 1, 3 and 4 updates a thread and 256, 128 and 1024 threads
    (the skip rule), the stride W / 2 pair form at every vec dividing it,
    and the clip rule at every vec; each within the sum-order bound of the
    exact sum of the unpacked values; one launch a call."""
    from coslam_torch.tools.bench import _common as C

    rows, m = 700, 10_007
    rng = np.random.default_rng(width + 200)
    idx_np = C.warp_edge_stream(name, m, rows, seed=width)
    idx = torch.from_numpy(idx_np).to(cuda_device)
    streams = torch.from_numpy(rng.standard_normal((width, m)).astype(
        np.float32)).to(cuda_device)
    words = torch.stack([PA.pack_bf16x2(streams[2 * p], streams[2 * p + 1])
                         for p in range(width // 2)]).contiguous()
    unpacked = PA.unpack_bf16x2(words.T.contiguous()).cpu().numpy()
    keys, pieces = _pieces(idx_np, unpacked, rows + 1, width)
    launches = PA.probe_accum_bf16x2.launches
    calls = 0
    vecs = [v for v in (1, 2, 4) if width % v == 0]
    for vec in vecs:
        for upt, threads in ((1, 256), (3, 128), (4, 1024)):
            got = PA.probe_accum_bf16x2(idx, words, rows + 1, vec=vec,
                                        upt=upt, threads=threads)
            _assert_within_sum_order(got, keys, pieces, rows)
            calls += 1
    stride = width // 2
    for vec in (v for v in vecs if stride % v == 0):
        got = PA.probe_accum_bf16x2(idx, words, rows + 1, stride, vec=vec)
        _assert_within_sum_order(got, *_pieces(idx_np, unpacked, rows + 1,
                                               stride), rows)
        calls += 1
    clipped = np.clip(idx_np, 0, rows)
    for vec in vecs:
        _assert_within_sum_order(PA.launch_accum(
            "probe_accum_bf16x2", idx, words, width, m, rows + 1, width, vec,
            3, 128, True, False, clip=True), clipped, unpacked, rows)
    assert PA.probe_accum_bf16x2.launches == launches + calls


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 6, 3])
@pytest.mark.parametrize("name", WARP_EDGE_STREAMS)
def test_probe_r_both_forms_on_edge_streams(cuda_device, name, width):
    """Kernel R in both forms (the pairs after merge_pairs, and the raw
    updates with the pre-pass fused in; float4, float2 and scalar atomics
    by W) on the streams of _common.WARP_EDGE_STREAMS at M = 10,006
    (5,003 pairs, not a multiple of 32: the last warp short): runs across
    the warps of 32 pairs, a warp of one row, rows outside the output
    inside runs. The fused form also on idx and streams 4 bytes past an
    aligned start (its int2 and float2 loads give way to scalar ones); the
    pairs form also on arbitrary take2, idx2 equal to idx1 on 40 % of the
    pairs. Each within the sum-order bound of the exact sum; one launch a
    call."""
    from coslam_torch.tools.bench import _common as C

    rows, m = 700, 10_006
    rng = np.random.default_rng(width + 300)
    idx_np = C.warp_edge_stream(name, m, rows, seed=width)
    vals_np = rng.standard_normal((m, width)).astype(np.float32)
    idx = torch.from_numpy(idx_np).to(cuda_device)
    streams = torch.from_numpy(vals_np.T.copy()).to(cuda_device)
    keys, pieces = _pieces(idx_np, vals_np, rows + 1, width)
    launches = (PA.probe_accum_pair_merged.launches,
                PA.probe_accum_cell_merged.launches)
    merged = PA.merge_pairs(idx, streams)
    _assert_within_sum_order(PA.probe_accum_pair_merged(*merged, rows + 1),
                             keys, pieces, rows)
    _assert_within_sum_order(PA.probe_accum_cell_merged(idx, streams,
                                                        rows + 1),
                             keys, pieces, rows)
    buf = torch.empty(m + 1, dtype=torch.int32, device=cuda_device)
    off_idx = buf[1:]
    off_idx.copy_(idx)
    _assert_within_sum_order(PA.probe_accum_cell_merged(
        off_idx, _offset_by_a_float(vals_np.T, cuda_device), rows + 1),
        keys, pieces, rows)
    i1, _, i2, v1, _ = merged
    n = m // 2
    take2_np = rng.integers(0, 2, n).astype(np.int32)
    same = torch.from_numpy(rng.random(n) < 0.4).to(cuda_device)
    i2 = torch.where(same, i1, i2).to(torch.int32).contiguous()
    v2_np = rng.standard_normal((width, n)).astype(np.float32)
    got = PA.probe_accum_pair_merged(
        i1, torch.from_numpy(take2_np).to(cuda_device), i2, v1,
        torch.from_numpy(v2_np).to(cuda_device), rows + 1)
    pair_keys = np.stack([i1.cpu().numpy(), np.where(
        take2_np != 0, i2.cpu().numpy(), -1)], 1).reshape(-1)
    pair_rows = np.stack([v1.T.cpu().numpy(), v2_np.T], 1).reshape(-1, width)
    _assert_within_sum_order(got, *_pieces(pair_keys, pair_rows, rows + 1,
                                           width), rows)
    assert (PA.probe_accum_pair_merged.launches,
            PA.probe_accum_cell_merged.launches) == (launches[0] + 2,
                                                     launches[1] + 2)


def _check_run_skip(got, idx, vals, rows):
    """Kernel V's output [rows + 1, W] within the sum-order bound of the
    exact sum of its plain version's scanned first entries (the kernel
    scans bit for bit, then adds a row's first entries in any order), and
    at TABLE_TOL to the plain version."""
    s_idx, s_vals = PA.run_merge_outside(idx, vals, rows)
    keep = (s_idx <= rows).cpu().numpy()
    _assert_within_sum_order(got, s_idx.cpu().numpy()[keep],
                             s_vals.cpu().numpy()[keep], rows)
    torch.testing.assert_close(got, PA.run_skip_ref(idx, vals, rows + 1),
                               **TABLE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [140, 311])
@pytest.mark.parametrize("width", [8, 6, 3, 16])
def test_probe_run_merge_kernel_matches_plain_version(cuda_device, r, width):
    """Kernel S (kernel P with its clip rule; float4, float2 or scalar
    atomics, by W) on the run-merge probe's ray-ordered streams: within
    the sum-order bound and at TABLE_TOL to its plain version; kernel V and the route it
    replaced (suffix scan + kernel P) likewise."""
    from coslam_torch.tools.bench import _bench_run_merge as RM

    ids, _ = RM.make_stream(r)
    rows = r * r
    idx = torch.from_numpy(ids).to(cuda_device)
    vals = torch.randn(ids.shape[0], width, device=cuda_device)
    launches = (PA.probe_accum_run_merge.launches,
                PA.probe_accum_run_skip.launches)
    got = PA.probe_accum_run_merge(idx, vals, rows + 1)
    skip = PA.probe_accum_run_skip(idx, vals, rows + 1)
    torch.cuda.synchronize()
    assert (PA.probe_accum_run_merge.launches,
            PA.probe_accum_run_skip.launches) == (launches[0] + 1,
                                                  launches[1] + 1)
    _assert_within_sum_order(got, ids, vals.cpu().numpy(), rows)
    ref = PA.run_merge_ref(idx, vals, rows + 1)
    torch.testing.assert_close(got, ref, **TABLE_TOL)
    _check_run_skip(skip, idx, vals, rows)
    torch.testing.assert_close(skip, ref, **TABLE_TOL)
    s_idx, s_vals = PA.run_merge_outside(idx, vals, rows)
    route = PA.probe_accum(s_idx, s_vals, rows + 1, rows=True)
    torch.testing.assert_close(route, ref, **TABLE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, PA.TILE - 1, PA.TILE, PA.TILE + 1, 62_208])
@pytest.mark.parametrize("width", [3, 6, 8, 16])
def test_probe_run_merge_and_skip_at_tile_edges(cuda_device, m, width):
    """Kernels S and V on runs of 1-100 equal indices that cross S's warp
    steps and V's tile boundaries (and its 31-row halo), a few outside [0, rows]
    (clipped), at M around one tile and at the probe's M: within the
    sum-order bound and at TABLE_TOL to their plain versions, one launch a
    call."""
    rng = np.random.default_rng(width * 7 + m)
    rows = 50_000
    ids = np.repeat(rng.integers(-2, rows + 3, m),
                    rng.integers(1, 101, m))[:m].astype(np.int32)
    vals_np = rng.standard_normal((m, width)).astype(np.float32)
    idx = torch.from_numpy(ids).to(cuda_device)
    vals = torch.from_numpy(vals_np).to(cuda_device)
    launches = (PA.probe_accum_run_merge.launches,
                PA.probe_accum_run_skip.launches)
    got = PA.probe_accum_run_merge(idx, vals, rows + 1)
    skip = PA.probe_accum_run_skip(idx, vals, rows + 1)
    torch.cuda.synchronize()
    assert (PA.probe_accum_run_merge.launches,
            PA.probe_accum_run_skip.launches) == (launches[0] + 1,
                                                  launches[1] + 1)
    _assert_within_sum_order(got, ids, vals_np, rows)
    torch.testing.assert_close(got, PA.run_merge_ref(idx, vals, rows + 1),
                               **TABLE_TOL)
    _check_run_skip(skip, idx, vals, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [5, 3, 0])
def test_probe_run_skip_bit_for_bit_on_single_runs(cuda_device, rounds):
    """Kernel V equals its plain version bit for bit where every row takes
    a single run (each row's one scanned total added onto 0.0): runs of
    1-40 over distinct rows, so the scan's totals, the truncation at
    2^rounds included, show exactly."""
    rng = np.random.default_rng(rounds)
    rows, n_runs = 200_000, 3000
    heads = rng.permutation(rows)[:n_runs]
    ids = np.repeat(heads, rng.integers(1, 41, n_runs)).astype(np.int32)
    idx = torch.from_numpy(ids).to(cuda_device)
    vals = torch.randn(ids.shape[0], 8, device=cuda_device)
    got = PA.probe_accum_run_skip(idx, vals, rows + 1, rounds=rounds)
    want = PA.run_skip_ref(idx.cpu(), vals.cpu(), rows + 1, rounds)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
def test_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    idx = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    vals = torch.zeros((6, 8), device=cuda_device)
    with pytest.raises(ValueError):     # float4 atomics on 6-wide rows
        PA.probe_accum(idx, vals, 9, vec=4)
    with pytest.raises(ValueError):     # an int64 index
        PA.probe_accum(idx.long(), vals, 9)
    with pytest.raises(ValueError):     # a CPU index beside CUDA values
        PA.probe_accum(idx.cpu(), vals, 9)
    with pytest.raises(ValueError):     # S: an int64 index
        PA.probe_accum_run_merge(idx.long(), vals.T.contiguous(), 9)
    rows8 = torch.zeros((8, 8), device=cuda_device)
    for bad in (dict(vals=torch.zeros((8, 17), device=cuda_device)),
                dict(idx=idx.long()), dict(rounds=6)):
        args = dict(idx=idx, vals=rows8) | bad
        with pytest.raises(ValueError):  # V: W <= 16, int32, 5 rounds
            PA.probe_accum_run_skip(args.pop("idx"), args.pop("vals"), 9,
                                    **args)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["_bench_row_rates",
                                  "_bench_scatter_variants",
                                  "_bench_chunk_tune", "_bench_cell_merge",
                                  "_bench_run_merge"])
def test_probe_quick_runs_on_card(cuda_device, name):
    """Each probe's quick setting at its own shapes: it holds every
    variant to its plain version within the sum-order bound (the probe
    raises otherwise), times it and launches the kernels."""
    import importlib

    mod = importlib.import_module(f"coslam_torch.tools.bench.{name}")
    before = sum(f.launches for f in (PA.probe_accum, PA.probe_accum_bf16x2,
                                      PA.probe_accum_pair_merged,
                                      PA.probe_accum_run_merge,
                                      PA.probe_accum_run_skip))
    mod.main(["--quick"])
    after = sum(f.launches for f in (PA.probe_accum, PA.probe_accum_bf16x2,
                                     PA.probe_accum_pair_merged,
                                     PA.probe_accum_run_merge,
                                     PA.probe_accum_run_skip))
    assert after > before


# -- the serial modes of kernels B and D (K2 and K3 in serial order) ----------

def _serial_points(kind, n, seed):
    """Uniform points (a few outside [0, 1]) or ray-ordered ones."""
    if kind == "rays":
        return ray_points(n // 43, 43, seed)
    return np.random.default_rng(seed).uniform(-0.05, 1.05, (n, 3))


def _assert_sorted_output(module, spec, rows, x, stream):
    """The serial route's sorted output of its last call at x's size
    (global rows and values) equals a stable sort on the host of the plain
    version's update stream `stream` (host tensors), bit for bit."""
    sorter = SS.serial_sort(module.serial_segments(spec, x.shape[0]), rows,
                            spec.out_dim * x.shape[0], x.device)
    idx, vals = (t.numpy() for t in stream)
    order = np.argsort(idx, kind="stable")
    np.testing.assert_array_equal(sorter.keys.cpu().numpy(), idx[order])
    np.testing.assert_array_equal(sorter.pay.cpu().numpy(), vals[order])


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("kind", ["uniform", "rays"])
def test_grid_bwd_serial_mode(cuda_device, name, kind):
    """Kernel B's serial mode: the same bits over two calls, dtable within
    the sum-order bound of the plain version (and of its own streams'
    serial sum), dx as the plain version's; its sorted output is the
    host's stable sort of the plain version's stream."""
    from coslam_torch.tools.bench import _common as C

    spec = HP.make_packed_spec(**SPECS[name])
    rng = np.random.default_rng(5)
    x_np = _serial_points(kind, 8600, 5)
    table, x, g = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                   for a in (rng.standard_normal((spec.total_entries, 2)),
                             x_np, rng.standard_normal((x_np.shape[0],
                                                        spec.out_dim))))
    before = HP.grid_encode_bwd_serial.launches, HP.grid_encode_bwd.launches
    d1, dx1 = HP.grid_encode_bwd_serial(spec, table, x, g, True)
    d2, dx2 = HP.grid_encode_bwd_serial(spec, table, x, g, True)
    torch.cuda.synchronize()
    assert torch.equal(d1, d2) and torch.equal(dx1, dx2)
    assert (HP.grid_encode_bwd_serial.launches, HP.grid_encode_bwd.launches) \
        == (before[0] + 2, before[1])
    ref, ref_dx = HP.grid_encode_bwd_ref(spec, table, x, g, True, True)
    idx, vals = HP.grid_encode_bwd_streams_ref(spec, table, x, g)
    C.assert_within("dtable", d1, ref,
                    C.sum_order_tol(idx, vals, spec.total_entries))
    torch.testing.assert_close(dx1, ref_dx, rtol=1e-4, atol=1e-3)
    # The serial sum of the plain version's own streams, on the card.
    torch.testing.assert_close(
        d1, SS.row_accum_segmented(idx, vals, spec.total_entries)[:-1],
        rtol=0, atol=0)
    _assert_sorted_output(HP, spec, spec.total_entries, x,
                          HP.grid_encode_bwd_streams_ref(
                              spec, table.cpu(), x.cpu(), g.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(VM_SPECS))
@pytest.mark.parametrize("kind", ["uniform", "rays"])
def test_tensovm_bwd_serial_mode(cuda_device, name, kind):
    """Kernel D's serial mode: the same bits over two calls, dplanes and
    dlines within the sum-order bound of the plain version, dx as the
    plain version's; its sorted output is the host's stable sort of the
    plain version's stream."""
    from coslam_torch.tools.bench import _common as C

    spec = VM.make_tensovm_spec(**VM_SPECS[name])
    planes, lines, _, g = _vm_inputs(spec, 8600, 6, cuda_device)
    x_np = _serial_points(kind, 8600, 6)
    x = torch.from_numpy(x_np.astype(np.float32)).to(cuda_device)
    g = g[:x.shape[0]].contiguous()
    before = VM.tensovm_encode_bwd_serial.launches
    a = VM.tensovm_encode_bwd_serial(spec, planes, lines, x, g, True)
    b = VM.tensovm_encode_bwd_serial(spec, planes, lines, x, g, True)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert VM.tensovm_encode_bwd_serial.launches == before + 2
    ref = VM.tensovm_encode_bwd_ref(spec, planes, lines, x, g, True, True,
                                    True)
    idx, vals = VM.tensovm_encode_bwd_streams_ref(spec, planes, lines, x, g)
    tp = spec.total_entries
    tol = C.sum_order_tol(idx, vals, tp + lines.shape[0])
    C.assert_within("dplanes", a[0], ref[0], tol[:tp])
    C.assert_within("dlines", a[1], ref[1], tol[tp:])
    torch.testing.assert_close(a[2], ref[2], rtol=1e-4, atol=1e-3)
    _assert_sorted_output(VM, spec, tp + lines.shape[0], x,
                          VM.tensovm_encode_bwd_streams_ref(
                              spec, planes.cpu(), lines.cpu(), x.cpu(),
                              g.cpu()))


@pytest.mark.cuda
def test_deterministic_switch_takes_the_serial_modes(cuda_device):
    """Under torch.use_deterministic_algorithms(True) every table gradient
    takes its serial-order route (B's and D's serial modes, kernel H for
    the XOR grid's scatter route); dx alone keeps kernel B's and D's
    atomic-free default launch; with the switch off nothing changes."""
    spec = HP.make_packed_spec(**SPECS["mixed"])
    table, x, g = _inputs(spec, 999, 7, cuda_device)
    vspec = VM.make_tensovm_spec(**VM_SPECS["small"])
    planes, lines, vx, vg = _vm_inputs(vspec, 999, 7, cuda_device)
    xspec = E.make_hashgrid_spec(**XOR_SPECS["mixed"])
    xt = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (xspec.total_entries, 2)).astype(np.float32)).to(cuda_device)
    fns = (HP.grid_encode_bwd, HP.grid_encode_bwd_serial,
           VM.tensovm_encode_bwd, VM.tensovm_encode_bwd_serial,
           SS.row_accum_atomic, SS.row_accum_segmented)

    def counts(det):
        before = [f.launches for f in fns]
        torch.use_deterministic_algorithms(det)
        try:
            HP.grid_encode_bwd(spec, table, x, g, True, True)
            HP.grid_encode_bwd(spec, table, x, g, False, True)
            VM.tensovm_encode_bwd(vspec, planes, lines, vx, vg, True, True,
                                  True)
            t = xt.clone().requires_grad_(True)
            XP.encode(xspec, t, x, False).sum().backward()
        finally:
            torch.use_deterministic_algorithms(False)
        torch.cuda.synchronize()
        return [f.launches - b for f, b in zip(fns, before)]

    assert counts(True) == [1, 1, 0, 1, 0, 1]
    assert counts(False) == [2, 0, 1, 0, 1, 0]


# -- kernels T and U (the tri-plane) and U's serial mode (K2) ---------------

TP_SPECS = {
    "small": dict(desired_resolution=96, n_levels=3, base_resolution=16),
    "room0_hybrid": dict(desired_resolution=400, n_levels=4),
}


def _tp_inputs(spec, kind, n, seed, device):
    """Table 0.1 x noise, points uniform in [-0.05, 1.05] (16 on the cell
    edges of the finest level) or ray-ordered, unit-normal cotangent."""
    rng = np.random.default_rng(seed)
    x = _serial_points(kind, n, seed)
    r = spec.resolutions[-1]
    x[:16] = rng.integers(0, r + 1, (16, 3)) / r
    arrays = (0.1 * rng.standard_normal((spec.total_entries,
                                         spec.n_features)),
              x, rng.standard_normal((x.shape[0], spec.out_dim)))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TP_SPECS))
@pytest.mark.parametrize("kind", ["uniform", "rays"])
@pytest.mark.parametrize("need", [(True, True), (False, True), (True, False)])
def test_triplane_kernels_match_plain_versions(cuda_device, name, kind, need):
    """Kernels T and U against triplane_encode_fwd_ref / _bwd_ref, the
    table gradient within each entry's sum-order bound (the samples of a
    ray share coarse rows); one launch each."""
    from coslam_torch.tools.bench import _common as C

    spec = TP.make_triplane_spec(**TP_SPECS[name])
    table, x, g = _tp_inputs(spec, kind, 8600, 0, cuda_device)
    before = TP.triplane_encode_fwd.launches, TP.triplane_encode_bwd.launches
    torch.testing.assert_close(TP.triplane_encode_fwd(spec, table, x),
                               TP.triplane_encode_fwd_ref(spec, table, x),
                               rtol=1e-5, atol=1e-5)
    got = TP.triplane_encode_bwd(spec, table, x, g, *need)
    ref = TP.triplane_encode_bwd_ref(spec, table, x, g, *need)
    torch.cuda.synchronize()
    if need[0]:
        idx, vals = TP.triplane_encode_bwd_streams_ref(spec, table, x, g)
        C.assert_within("dtable", got[0], ref[0],
                        C.sum_order_tol(idx, vals, spec.total_entries))
    else:
        assert got[0] is None
    torch.testing.assert_close(got[1], ref[1], rtol=1e-4, atol=1e-3)
    assert (TP.triplane_encode_fwd.launches,
            TP.triplane_encode_bwd.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("enc", ["TriPlaneHybrid", "TriPlane"])
def test_triplane_fwd_at_slice_cases(cuda_device, enc):
    """Kernel T at every case of room0 with the
    TriPlaneHybrid and with the TriPlane grid (one pyramid, 32/68/146/311)
    that encodes through it (uniform points in [-0.05, 1.05], 16 on the
    finest level's cell edges, 8 with coordinates at exactly 0 and 1), at
    the BA 1-keyframe count on ray-ordered points and on points in one
    cell, and at N = 0, 1, 31, 33 and 1,025: within the forward tolerance
    of the plain version (the same products, FMA contraction moves the
    last bit: rtol 1e-5, atol 1e-5); one launch a call (none at N = 0)."""
    from coslam_torch.data.synth import room0_hybrid_config
    from coslam_torch.models.scene_rep import JointEncoding
    from coslam_torch.tools.kernel_times import main_path_cases

    cfg = room0_hybrid_config("output", 48, 64, 15)
    cfg["grid"]["enc"] = enc
    spec = JointEncoding(cfg, cfg["mapping"]["bound"], "cpu").grid_spec
    spec = spec[1] if enc == "TriPlaneHybrid" else spec
    assert spec == TP.make_triplane_spec(**TP_SPECS["room0_hybrid"])
    rng = np.random.default_rng(11)
    table = torch.from_numpy((0.1 * rng.standard_normal(
        (spec.total_entries, spec.n_features))).astype(np.float32)).to(
            cuda_device)
    sets = []
    for label, n, _, _ in main_path_cases(cfg, 15):
        if label == "lattice":
            continue
        x = rng.uniform(-0.05, 1.05, (n, 3))
        r = spec.resolutions[-1]
        x[:16] = rng.integers(0, r + 1, (16, 3)) / r
        x[16:24] = rng.integers(0, 2, (8, 3))
        sets.append((label, x))
    ba1 = [c for c in main_path_cases(cfg, 15) if c[0] == "BA 1 kf"][0][1]
    sets += [("rays", _serial_points("rays", ba1, 11)),
             ("one cell", one_cell_points(ba1, rng))]
    sets += [(f"N={n}", rng.uniform(0, 1, (n, 3))) for n in (0, 1, 31, 33,
                                                            1025)]
    for label, x_np in sets:
        x = torch.from_numpy(x_np.astype(np.float32)).to(cuda_device)
        before = TP.triplane_encode_fwd.launches
        got = TP.triplane_encode_fwd(spec, table, x)
        torch.cuda.synchronize()
        assert got.shape == (x.shape[0], spec.out_dim), label
        torch.testing.assert_close(
            got, TP.triplane_encode_fwd_ref(spec, table, x), rtol=1e-5,
            atol=1e-5, msg=lambda m: f"{label}: {m}")
        assert TP.triplane_encode_fwd.launches == before + (x.shape[0] > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 3, 5, 8, 12])
@pytest.mark.parametrize("kind", ["uniform", "rays"])
def test_triplane_fwd_other_level_counts(cuda_device, kind, levels):
    """Kernel T at pyramids of 1, 3, 5, 8 and 12 levels (resolutions 16 to
    96; the level count read at run time, not the compiled 4; blocks of 8,
    2, 1, 1 and 1 tiles of 32 points: 256, 192, 160, 256 and 384 threads),
    uniform and ray-ordered points, N not a multiple of a block: within the
    forward tolerance."""
    spec = TP.make_triplane_spec(96, levels, base_resolution=16)
    table, x, _ = _tp_inputs(spec, kind, 8600, 5, cuda_device)
    got = TP.triplane_encode_fwd(spec, table, x)
    torch.testing.assert_close(got,
                               TP.triplane_encode_fwd_ref(spec, table, x),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TP_SPECS))
@pytest.mark.parametrize("kind", ["rays", "one_cell"])
def test_triplane_bwd_merges_runs(cuda_device, name, kind):
    """Kernel U where its warps hold runs of equal cell rows, which it sums
    by shuffles before one add a run: ray-ordered points, and 8,600 points
    that all lie in one cell of every level (each warp one run a
    section); dtable within each entry's sum-order bound, dx as the plain
    version's."""
    from coslam_torch.tools.bench import _common as C

    spec = TP.make_triplane_spec(**TP_SPECS[name])
    rng = np.random.default_rng(8)
    if kind == "rays":
        x_np = _serial_points("rays", 8600, 8)
    else:
        x_np = one_cell_points(8600, rng)
    table, x, g = (torch.from_numpy(a.astype(np.float32)).to(cuda_device)
                   for a in (0.1 * rng.standard_normal(
                       (spec.total_entries, spec.n_features)), x_np,
                       rng.standard_normal((x_np.shape[0], spec.out_dim))))
    e00 = TP._corners(spec, x)[0]
    assert (kind == "one_cell") == bool((e00 == e00[:, :1]).all())
    before = TP.triplane_encode_bwd.launches
    got = TP.triplane_encode_bwd(spec, table, x, g, True, True)
    ref = TP.triplane_encode_bwd_ref(spec, table, x, g, True, True)
    torch.cuda.synchronize()
    assert TP.triplane_encode_bwd.launches == before + 1
    idx, vals = TP.triplane_encode_bwd_streams_ref(spec, table, x, g)
    C.assert_within("dtable", got[0], ref[0],
                    C.sum_order_tol(idx, vals, spec.total_entries))
    torch.testing.assert_close(got[1], ref[1], rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TP_SPECS))
@pytest.mark.parametrize("kind", ["uniform", "rays"])
def test_triplane_bwd_serial_mode(cuda_device, name, kind):
    """Kernel U's serial mode: the same bits over two calls, and the host's
    plain version's bits (its index_add_ adds in the stream's order, and
    U's updates are the plain version's products); dx as the plain
    version's; its sorted output is the host's stable sort of the plain
    version's stream."""
    spec = TP.make_triplane_spec(**TP_SPECS[name])
    table, x, g = _tp_inputs(spec, kind, 8600, 1, cuda_device)
    before = TP.triplane_encode_bwd_serial.launches
    a = TP.triplane_encode_bwd_serial(spec, table, x, g, True)
    b = TP.triplane_encode_bwd_serial(spec, table, x, g, True)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert TP.triplane_encode_bwd_serial.launches == before + 2
    host, host_dx = TP.triplane_encode_bwd_ref(spec, table.cpu(), x.cpu(),
                                               g.cpu(), True, True)
    assert torch.equal(a[0].cpu(), host)
    torch.testing.assert_close(a[1].cpu(), host_dx, rtol=1e-4, atol=1e-3)
    _assert_sorted_output(TP, spec, spec.total_entries, x,
                          TP.triplane_encode_bwd_streams_ref(
                              spec, table.cpu(), x.cpu(), g.cpu()))


@pytest.mark.cuda
def test_triplane_autograd_and_deterministic_switch(cuda_device):
    """TriPlaneEncode on CUDA tensors: gradients through kernel U equal the
    plain backward's; under the deterministic switch the table gradient
    takes U's serial mode and tracking's dx alone the atomic launch."""
    spec = TP.make_triplane_spec(**TP_SPECS["small"])
    table, x, g = _tp_inputs(spec, "uniform", 1031, 2, cuda_device)
    x = x.clamp(0.05, 0.95)
    t = table.clone().requires_grad_(True)
    xx = x.clone().requires_grad_(True)
    (TP.encode(spec, t, xx) * g).sum().backward()
    r_t, r_x = TP.triplane_encode_bwd_ref(spec, table, x, g, True, True)
    torch.testing.assert_close(t.grad, r_t, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(xx.grad, r_x, rtol=1e-4, atol=1e-3)
    fns = (TP.triplane_encode_bwd, TP.triplane_encode_bwd_serial)
    before = [f.launches for f in fns]
    torch.use_deterministic_algorithms(True)
    try:
        TP.triplane_encode_bwd(spec, table, x, g, True, True)
        TP.triplane_encode_bwd(spec, table, x, g, False, True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1]


@pytest.mark.cuda
def test_triplane_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    """A CPU/CUDA mix, a wrong dtype and a wrong shape raise before any
    launch."""
    spec = TP.make_triplane_spec(**TP_SPECS["small"])
    table, x, g = _tp_inputs(spec, "uniform", 64, 3, cuda_device)
    before = TP.triplane_encode_fwd.launches
    for bad in ((table.cpu(), x), (table.double(), x), (table[:-1], x),
                (table, x[:, :2].contiguous())):
        with pytest.raises(ValueError):
            TP.triplane_encode_fwd(spec, *bad)
    with pytest.raises(ValueError):
        TP.triplane_encode_bwd(spec, table, x, g[:, :2].contiguous(), True,
                               True)
    assert TP.triplane_encode_fwd.launches == before
