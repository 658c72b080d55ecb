"""The port's TensoVM encoding against the JAX package.

The plain PyTorch forward and backward (the CPU path of
coslam_torch.ops.tensovm, and the oracle of kernels C and D) are held
against ``tensovm_encode_fwd_only`` and its autodiff, against
``make_tensovm_encode`` in Pallas interpret mode, and the plane-table
gradient against ``plane_quad.quad_table_grad`` on both of its routes:
``mm_rcut=0`` sends every section through the Pallas row-accumulate
kernel (serial_scatter._row_kernel, in interpret mode), ``mm_rcut=1024``
every section through the two-hot matmul. Inputs come from numpy seeds:
planes 0.1 x noise, lines 1 + 0.1 x noise, points in [-0.05, 1.05].

Tolerances are those of the JAX package's own tests
(tests/test_tensovm.py, tests/test_plane_quad.py): the forward is the same
arithmetic in another fusion (rtol 1e-5); table gradients are sums of
many products in another order (rtol 1e-4, atol 1e-5); dx sums terms
scaled by the resolution (up to 96 here) that cancel, so an entry near
zero keeps an absolute error near 1e-5 (rtol 1e-4, atol 1e-4).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu.ops import plane_quad as PQ
from coslam_tpu.ops import tensovm as JVM
from coslam_torch.ops import tensovm as VM

torch.set_num_threads(1)

SMALL = dict(desired_resolution=96, n_levels=3, base_resolution=16)
ROOM0_VM = dict(desired_resolution=400, n_levels=3)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
TABLE_TOL = dict(rtol=1e-4, atol=1e-5)
DX_TOL = dict(rtol=1e-4, atol=1e-4)


def _specs(args=SMALL):
    return JVM.make_tensovm_spec(**args), VM.make_tensovm_spec(**args)


def _inputs(spec, n, seed, lo=-0.05, hi=1.05):
    rng = np.random.default_rng(seed)
    planes = (0.1 * rng.standard_normal((spec.total_entries,
                                         spec.n_features))).astype(np.float32)
    lines = (1.0 + 0.1 * rng.standard_normal(
        (JVM.line_total_rows(spec), spec.n_features))).astype(np.float32)
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    g = rng.standard_normal((n, spec.out_dim)).astype(np.float32)
    return planes, lines, x, g


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_grads(js, planes, lines, x, g):
    """jax.grad of sum(tensovm_encode_fwd_only * g) -> (dplanes, dlines,
    dx)."""
    def f(p, z):
        return jnp.sum(JVM.tensovm_encode_fwd_only(js, p, z) * jnp.asarray(g))

    dp, dx = jax.jit(jax.grad(f, argnums=(0, 1)))(
        {"planes": jnp.asarray(planes), "lines": jnp.asarray(lines)},
        jnp.asarray(x))
    return np.asarray(dp["planes"]), np.asarray(dp["lines"]), np.asarray(dx)


@pytest.mark.parametrize("args", [SMALL, ROOM0_VM], ids=["small", "room0_vm"])
def test_spec_matches_jax(args):
    js, ts = _specs(args)
    for field in ("pyr_levels", "n_levels", "n_features", "resolutions",
                  "offsets", "sizes", "total_entries", "out_dim"):
        assert getattr(ts, field) == getattr(js, field), field
    assert VM.line_total_rows(ts) == JVM.line_total_rows(js)
    if args is ROOM0_VM:
        assert ts.resolutions == (32,) * 3 + (100,) * 3 + (311,) * 3
        assert ts.total_entries == 325_902
        assert VM.line_total_rows(ts) == 1_338 and ts.out_dim == 6


def test_forward_matches_jax():
    js, ts = _specs()
    planes, lines, x, _ = _inputs(js, 257, seed=0)
    out = VM.tensovm_encode_fwd_ref(ts, *_t(planes, lines, x)).numpy()
    p = {"planes": jnp.asarray(planes), "lines": jnp.asarray(lines)}
    np.testing.assert_allclose(
        out, JVM.tensovm_encode_fwd_only(js, p, jnp.asarray(x)), **FWD_TOL)
    enc = JVM.make_tensovm_encode(js, jnp.float32, interpret=True)
    np.testing.assert_allclose(out, enc(p, jnp.asarray(x)), **FWD_TOL)
    # The dispatching wrapper takes the plain version for CPU tensors.
    np.testing.assert_array_equal(
        VM.tensovm_encode_fwd(ts, *_t(planes, lines, x)).numpy(), out)


def test_backward_matches_jax():
    js, ts = _specs()
    # Interior points for dx: at the clip edges autodiff of a clip and
    # the in-range mask disagree by design.
    planes, lines, x, g = _inputs(js, 129, seed=1, lo=0.05, hi=0.95)
    got = VM.tensovm_encode_bwd_ref(ts, *_t(planes, lines, x, g),
                                    need_dplanes=True, need_dlines=True,
                                    need_dx=True)
    ref = _jax_grads(js, planes, lines, x, g)
    for a, b, tol in zip(got, ref, (TABLE_TOL, TABLE_TOL, DX_TOL)):
        np.testing.assert_allclose(a.numpy(), b, **tol)


@pytest.mark.parametrize("mm_rcut", [0, 1024])
def test_dplanes_matches_quad_table_grad(mm_rcut):
    """dplanes equals plane_quad.quad_table_grad with the plane-feature
    cotangent g * line: at mm_rcut=0 through the Pallas row-accumulate
    kernel (K3's plane caller), at 1024 through the two-hot matmuls."""
    js, ts = _specs()
    planes, lines, x, g = _inputs(js, 129, seed=2)
    n, L, F = x.shape[0], js.pyr_levels, js.n_features
    line_f = JVM.line_eval_fwd_only(js, jnp.asarray(lines), jnp.asarray(x))
    gs = jnp.repeat(jnp.asarray(g).reshape(n, L, F).transpose(2, 1, 0), 3,
                    axis=1) * line_f                          # [F, S, N]
    cu, cv, wu, wv = PQ._cell_project(js, jnp.asarray(x))
    ref = PQ.quad_table_grad(js, cu, cv, wu, wv, gs, interpret=True,
                             mm_rcut=mm_rcut)
    dp, _, _ = VM.tensovm_encode_bwd_ref(ts, *_t(planes, lines, x, g),
                                         need_dplanes=True, need_dlines=False,
                                         need_dx=False)
    np.testing.assert_allclose(dp.numpy(), ref, **TABLE_TOL)


@pytest.mark.parametrize("need", list(itertools.product((False, True),
                                                        repeat=3)))
def test_need_flags(need):
    """Each flag combination returns None where nothing was asked, and
    what was asked equals the all-gradients call."""
    _, ts = _specs()
    args = _t(*_inputs(ts, 33, seed=3))
    full = VM.tensovm_encode_bwd_ref(ts, *args, True, True, True)
    got = VM.tensovm_encode_bwd(ts, *args, *need)
    for asked, a, b in zip(need, got, full):
        if asked:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        else:
            assert a is None


def test_point_on_grid_lines():
    """Points whose coordinates are exact multiples of 1/16, so every
    coordinate of the r = 16 level lies on a cell or segment boundary:
    the forward and dx follow the gather oracle and its autodiff, whose
    line derivative there is V[i0 + 1] - V[i0]. The TPU's two-hot line
    VJP (make_line_eval, inside make_tensovm_encode) gives 0 there
    instead, so its dx differs."""
    js, ts = _specs()
    assert ts.resolutions[0] == 16
    planes, lines, _, g = _inputs(js, 4, seed=4)
    x = np.array([[0.5, 0.25, 0.75], [0.125, 0.5, 0.5],
                  [0.9375, 0.0625, 0.3125], [0.3, 0.6, 0.5]], np.float32)
    out = VM.tensovm_encode_fwd_ref(ts, *_t(planes, lines, x)).numpy()
    p = {"planes": jnp.asarray(planes), "lines": jnp.asarray(lines)}
    np.testing.assert_allclose(
        out, JVM.tensovm_encode_fwd_only(js, p, jnp.asarray(x)), **FWD_TOL)
    _, _, dx = VM.tensovm_encode_bwd_ref(ts, *_t(planes, lines, x, g),
                                         need_dplanes=False,
                                         need_dlines=False, need_dx=True)
    ref = _jax_grads(js, planes, lines, x, g)[2]
    np.testing.assert_allclose(dx.numpy(), ref, **DX_TOL)
    n, L, F = x.shape[0], js.pyr_levels, js.n_features
    gq = np.repeat(g.reshape(n, L, F).transpose(2, 1, 0), 3, axis=1) * \
        JVM.plane_sections_fwd_only(js, p["planes"], jnp.asarray(x))
    line_dx = [jax.grad(lambda z: jnp.sum(fn(p["lines"], z) * gq))(
        jnp.asarray(x)) for fn in (JVM.make_line_eval(js, jnp.float32),
                                   lambda v, z: JVM.line_eval_fwd_only(js, v,
                                                                       z))]
    assert not np.allclose(line_dx[0], line_dx[1], **DX_TOL)


def test_autograd_function_matches_autodiff():
    """TensoVMEncode (the kernel backward's Function, on the CPU the plain
    backward) against torch autodiff of the plain forward."""
    _, ts = _specs()
    planes, lines, x, g = _t(*_inputs(ts, 97, seed=5, lo=0.05, hi=0.95))

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (planes, lines, x)]
        (fn(*leaves) * g).sum().backward()
        return [t.grad for t in leaves]

    got = grads(lambda p, l, z: VM.encode(ts, {"planes": p, "lines": l}, z))
    ref = grads(lambda p, l, z: VM.tensovm_encode_fwd_ref(ts, p, l, z))
    for a, b, tol in zip(got, ref, (TABLE_TOL, TABLE_TOL, DX_TOL)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **tol)
    # A detached map (tracking) asks for dx only.
    zz = x.clone().requires_grad_(True)
    (VM.encode(ts, {"planes": planes, "lines": lines}, zz) * g).sum().backward()
    np.testing.assert_allclose(zz.grad.numpy(), ref[2].numpy(), **DX_TOL)


def test_lattice_tv_matches_jax():
    """The analytic separable TV against make_tensovm_lattice_tv, and
    against smoothness_tv of the plain encode on the lattice's points:
    value and gradients of planes and lines."""
    from coslam_tpu.ops import losses as JL
    from coslam_torch.ops import losses as TL

    js, ts = _specs()
    planes, lines, _, _ = _inputs(js, 1, seed=6)
    g, sp = 7, 8
    axes = np.random.default_rng(7).uniform(0.02, 0.98, (3, g)).astype(
        np.float32)
    j_val, j_grad = jax.jit(jax.value_and_grad(
        lambda p: JVM.make_tensovm_lattice_tv(js)(p, jnp.asarray(axes), sp)))(
        {"planes": jnp.asarray(planes), "lines": jnp.asarray(lines)})

    def value_and_grads(fn):
        p = {k: t.clone().requires_grad_(True)
             for k, t in zip(("planes", "lines"), _t(planes, lines))}
        val = fn(p)
        val.backward()
        return (float(val.detach()), p["planes"].grad.numpy(),
                p["lines"].grad.numpy())

    tax = torch.from_numpy(axes)
    tv = value_and_grads(lambda p: VM.make_tensovm_lattice_tv(ts)(p, tax, sp))
    pts = torch.stack(torch.meshgrid(*tax, indexing="ij"), -1).reshape(-1, 3)
    pointwise = value_and_grads(lambda p: TL.smoothness_tv(
        VM.tensovm_encode_fwd_ref(ts, p["planes"], p["lines"], pts
                                  ).reshape(g, g, g, -1), sp))
    for val, dp, dl in (tv, pointwise):
        np.testing.assert_allclose(val, float(j_val), rtol=1e-5)
        np.testing.assert_allclose(dp, j_grad["planes"], rtol=1e-4,
                                   atol=1e-7)
        np.testing.assert_allclose(dl, j_grad["lines"], rtol=1e-4,
                                   atol=1e-7)
    # The JAX package's own pointwise TV agrees with its analytic one.
    emb = JVM.tensovm_encode_fwd_only(
        js, {"planes": jnp.asarray(planes), "lines": jnp.asarray(lines)},
        jnp.asarray(pts.numpy()))
    np.testing.assert_allclose(
        float(JL.smoothness_tv(emb.reshape(g, g, g, -1), sp)), float(j_val),
        rtol=1e-5)


def test_convert_round_trips_dict_grid():
    """The JAX package's TensoVM params -> the port's tensors -> numpy,
    unchanged, with the dict grid's keys and shapes."""
    from coslam_tpu.data.synth import make_synthetic_config
    from coslam_tpu.models.scene_rep import JointEncoding as JModel
    from coslam_torch import convert

    cfg = make_synthetic_config("", "/tmp/unused", H=24, W=32)
    cfg["grid"].update(enc="TensoVM", triplane_levels=2)
    jm = JModel(cfg, np.array(cfg["mapping"]["bound"], np.float32))
    np_params = jax.tree_util.tree_map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    params = convert.params_from_numpy(np_params)
    assert set(params["grid"]) == {"planes", "lines"}
    back = convert.params_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    assert params["grid"]["planes"].shape == (jm.grid_spec.total_entries, 2)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernel or the call raises: here
    meta tensors raise instead of running the plain version."""
    _, ts = _specs()
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    args = (meta(ts.total_entries, 2), meta(VM.line_total_rows(ts), 2),
            meta(5, 3))
    with pytest.raises(ValueError):
        VM.tensovm_encode_fwd(ts, *args)
    with pytest.raises(ValueError):
        VM.tensovm_encode_bwd(ts, *args, meta(5, ts.out_dim), True, True, True)
    assert VM.tensovm_encode_fwd.launches == 0
    assert VM.tensovm_encode_bwd.launches == 0
