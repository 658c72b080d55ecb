"""The CUDA kernels of coslam_torch against their plain PyTorch versions,
on the card: kernels A and B (hash grid) and C and D (TensoVM). This file
imports no jax, so it also runs on a machine with the card and without
the JAX package's dependencies:

    python -m pytest --noconftest -q tests/test_torch_kernels_card.py

Without a CUDA device every test skips. Tolerances: the forward is the
same arithmetic up to FMA contraction (rtol 1e-5); the backward adds with
f32 atomics in a run-dependent order (rtol 1e-4); dx sums terms scaled
by resolutions up to 399, so an entry near zero keeps an absolute error
near 1e-4 (atol 1e-3).
"""

import itertools

import numpy as np
import pytest
import torch

from coslam_torch.ops import hash_packed as HP
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
