"""The CUDA kernels of coslam_torch against their plain PyTorch versions,
on the card: kernels A and B (hash grid), C and D (TensoVM), E and G (XOR
hash grid; E and D also on ray-ordered points, E also at the Dense grid's
4 levels), the row accumulate F (atomic) and H (deterministic, also on
adversarial streams), and the probes' kernels P, Q, R and S (bottom of
the file). This file imports no jax, so it also runs on a machine with
the card and without the JAX package's dependencies:

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


def _ray_points(n_rays, samples, seed):
    """Ray-ordered points: n_rays rays from inside the unit cube, the
    samples of one ray adjacent and spaced along it, running out of
    [0, 1] near their far end."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.2, 0.8, (n_rays, 1, 3))
    d = rng.standard_normal((n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0.0, 0.9, (n_rays, samples, 1)), axis=1)
    return (o + d * t).reshape(-1, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [16, 5])
@pytest.mark.parametrize("need", [(True, True), (False, True), (True, False)])
def test_grid_bwd_on_ray_ordered_points(cuda_device, levels, need):
    """Kernel B on ray-ordered points (coarse-level rows shared by the
    samples of a ray), with corner rows e both even (float4 atomic) and
    odd (two float2), points outside [0, 1], at L = 16 (dx summed by
    shuffles in a half-warp) and L = 5 (in shared memory): against
    grid_encode_bwd_ref."""
    spec = HP.make_packed_spec(400 if levels == 16 else 96, 16,
                               n_levels=levels)
    x_np = _ray_points(200, 43, levels)
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
    x = torch.from_numpy(_ray_points(100, 43, 3).astype(np.float32)).to(
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
    x_np = _edge_points(_ray_points(200, 43, 6), spec.resolutions[-1], rng)
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
    x_np = _ray_points(60, 43, 8).astype(np.float32)
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
    x = _edge_points(_ray_points(rays, 27, seed + 1), spec.resolutions[-1],
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
@pytest.mark.parametrize("width", [8, 6, 3])
def test_probe_pair_merged_kernel_matches_plain_version(cuda_device, width):
    """Kernel R after merge_pairs (float4, float2 and scalar atomics, by
    W), on the cell-merge probe's two streams: within the sum-order
    bound, and at TABLE_TOL to its plain version and to kernel P on the
    unmerged streams."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("r", [140, 311])
@pytest.mark.parametrize("width,span", [(8, 16), (8, 1), (6, 64), (3, 7),
                                        (16, 1000)])
def test_probe_run_merge_kernel_matches_plain_version(cuda_device, r, width,
                                                      span):
    """Kernel S (float4, float2 or scalar atomics, by W) on the run-merge
    probe's ray-ordered streams: within the sum-order bound and at
    TABLE_TOL to its plain version; and the skip route (suffix scan +
    kernel P) likewise."""
    from coslam_torch.tools.bench import _bench_run_merge as RM

    ids, _ = RM.make_stream(r)
    rows = r * r
    idx = torch.from_numpy(ids).to(cuda_device)
    vals = torch.randn(ids.shape[0], width, device=cuda_device)
    launches = PA.probe_accum_run_merge.launches
    got = PA.probe_accum_run_merge(idx, vals, rows + 1, span=span)
    torch.cuda.synchronize()
    assert PA.probe_accum_run_merge.launches == launches + 1
    _assert_within_sum_order(got, ids, vals.cpu().numpy(), rows)
    ref = PA.probe_accum_ref(idx, vals, rows + 1)
    torch.testing.assert_close(got, ref, **TABLE_TOL)
    s_idx, s_vals = PA.run_merge_outside(idx, vals, rows)
    skip = PA.probe_accum(s_idx, s_vals, rows + 1, rows=True)
    torch.testing.assert_close(skip, ref, **TABLE_TOL)


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
    with pytest.raises(ValueError):     # S keeps at most 16 in registers
        PA.probe_accum_run_merge(idx, torch.zeros((8, 17),
                                                  device=cuda_device), 9)


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
                                      PA.probe_accum_run_merge))
    mod.main(["--quick"])
    after = sum(f.launches for f in (PA.probe_accum, PA.probe_accum_bf16x2,
                                     PA.probe_accum_pair_merged,
                                     PA.probe_accum_run_merge))
    assert after > before
