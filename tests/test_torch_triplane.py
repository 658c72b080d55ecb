"""The port's tri-plane encoding against the JAX package.

The plain PyTorch forward and backward (the CPU path of
coslam_torch.ops.triplane, and the oracle of kernels T and U) are held
against ``triplane_encode_fwd_only`` and its autodiff, and against
``make_triplane_encode`` in Pallas interpret mode, whose table gradient
is the Pallas pair scatter (K2, through hash_packed._scatter_table_grad);
the separable lattice and the unit-line TV against the JAX functions.
Inputs come from numpy seeds: the table 0.1 x noise, points in
[-0.05, 1.05] (outside [0, 1] too), unit-normal cotangents.

Tolerances. The forward is the same products in another fusion (rtol
1e-5, atol 1e-6). dx against the custom VJP of make_triplane_encode is the
same chain in the same order (rtol 1e-5, atol 1e-5: its entries are sums
of terms scaled by the resolution, up to 96 here, so 1e-5 is a few ulp of
the largest term). The table gradient is held to each entry's sum-order
bound (``_common.sum_order_tol``: the most two f32 sums of the entry's
updates can differ, whatever their order), because K2 adds the same
updates in the order of its stride interleave; its updates are the plain
version's products, one rounding each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu.ops import tensovm as JVM
from coslam_tpu.ops import triplane as JTP
from coslam_torch.ops import serial_scatter as SS
from coslam_torch.ops import tensovm as VM
from coslam_torch.ops import triplane as TP
from coslam_torch.tools.bench import _common as C

torch.set_num_threads(1)

SMALL = dict(desired_resolution=96, n_levels=3, base_resolution=16)
# room0_hybrid's plane pyramid (resolution 400, 4 levels).
ROOM0_HYBRID = dict(desired_resolution=400, n_levels=4)
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
DX_TOL = dict(rtol=1e-5, atol=1e-5)


def _specs(args=SMALL):
    return JTP.make_triplane_spec(**args), TP.make_triplane_spec(**args)


def _inputs(spec, n, seed, lo=-0.05, hi=1.05):
    rng = np.random.default_rng(seed)
    table = (0.1 * rng.standard_normal((spec.total_entries,
                                        spec.n_features))).astype(np.float32)
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    g = rng.standard_normal((n, spec.out_dim)).astype(np.float32)
    return table, x, g


def _edge_points(r: int) -> np.ndarray:
    """Points on the cell edges of the r-resolution level and at the clip
    bounds: coordinates k / r, 0, 1 and just outside."""
    return np.array([[0.5, 0.25, 0.75], [2 / r, 0.5, 5 / r],
                     [0.0, 1.0, 0.5], [1.0, 0.0, 1.0],
                     [-0.01, 1.01, 3 / r], [0.3, 0.6, 0.5]], np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _streams_tol(ts, x, g):
    idx, vals = TP.triplane_encode_bwd_streams_ref(ts, None, x, g)
    return C.sum_order_tol(idx, vals, ts.total_entries)


@pytest.mark.parametrize("args", [SMALL, ROOM0_HYBRID],
                         ids=["small", "room0_hybrid"])
def test_spec_matches_jax(args):
    js, ts = _specs(args)
    for field in ("pyr_levels", "n_levels", "n_features", "resolutions",
                  "offsets", "sizes", "total_entries", "out_dim"):
        assert getattr(ts, field) == getattr(js, field), field
    if args is ROOM0_HYBRID:
        assert ts.resolutions[::3] == (32, 68, 146, 311)
        assert ts.total_entries == 374_409 and ts.out_dim == 8


@pytest.mark.parametrize("points", ["uniform", "edges"])
def test_forward_matches_jax(points):
    js, ts = _specs()
    table, x, _ = _inputs(js, 257, seed=0)
    if points == "edges":
        x = _edge_points(ts.resolutions[0])
    out = TP.triplane_encode_fwd_ref(ts, *_t(table, x)).numpy()
    np.testing.assert_allclose(
        out, JTP.triplane_encode_fwd_only(js, jnp.asarray(table),
                                          jnp.asarray(x)), **FWD_TOL)
    enc = JTP.make_triplane_encode(js, jnp.float32, interpret=True)
    np.testing.assert_allclose(out, enc(jnp.asarray(table), jnp.asarray(x)),
                               **FWD_TOL)
    # The dispatching wrapper takes the plain version for CPU tensors.
    np.testing.assert_array_equal(
        TP.triplane_encode_fwd(ts, *_t(table, x)).numpy(), out)


@pytest.mark.parametrize("points", ["uniform", "edges", "rays"])
def test_backward_matches_pair_scatter(points):
    """dtable and dx against make_triplane_encode's custom VJP in
    interpret mode: the table gradient through K2's pair scatter, dx
    masked to 0 <= x <= 1, on points inside and outside [0, 1], on the
    cell edges, and on ray-ordered points (3 rays of 43 samples, whose
    runs of equal cell rows kernel U sums inside a warp on the card)."""
    js, ts = _specs()
    table, x, g = _inputs(js, 129, seed=1)
    if points == "edges":
        x = _edge_points(ts.resolutions[0])
        g = g[:x.shape[0]]
    elif points == "rays":
        x = C.ray_points(3, 43, 1).astype(np.float32)
    enc = JTP.make_triplane_encode(js, jnp.float32, interpret=True)
    ref_dt, ref_dx = jax.grad(
        lambda t, z: jnp.sum(enc(t, z) * jnp.asarray(g)), argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(x))
    dt, dx = TP.triplane_encode_bwd_ref(ts, *_t(table, x, g), True, True)
    tx, tg = _t(x, g)
    C.assert_within("dtable", dt, torch.from_numpy(np.array(ref_dt)),
                    _streams_tol(ts, tx, tg))
    np.testing.assert_allclose(dx.numpy(), ref_dx, **DX_TOL)


@pytest.mark.parametrize("points", ["uniform", "rays", "one_cell"])
def test_row_pair_adds_counts_u_heads(points):
    """Kernel U's row-pair adds (row_pair_adds) against a count section by
    section and point by point from the JAX spec's rows: two for each
    point that does not continue its predecessor's corner row inside its
    32-point warp; at 200 points (the last warp short)."""
    js, ts = _specs()
    n = 200
    x = {"uniform": lambda: _inputs(js, n, seed=4)[1],
         "rays": lambda: C.ray_points(5, 40, 4).astype(np.float32),
         "one_cell": lambda: C.one_cell_points(
             n, np.random.default_rng(4)).astype(np.float32)}[points]()
    xc = np.clip(x, 0.0, 1.0)
    planes = ((0, 1), (0, 2), (1, 2))
    count = 0
    for s in range(js.n_levels):
        r = js.resolutions[s]
        ua, va = planes[s % 3]
        prev = None
        for p in range(x.shape[0]):
            cu = min(max(int(np.floor(np.float32(r) * xc[p, ua])), 0), r - 1)
            cv = min(max(int(np.floor(np.float32(r) * xc[p, va])), 0), r - 1)
            e00 = js.offsets[s] + cu * (r + 1) + cv
            if p % 32 == 0 or e00 != prev:
                count += 2
            prev = e00
    assert TP.row_pair_adds(ts, torch.from_numpy(x)) == count
    unmerged = 2 * js.n_levels * x.shape[0]
    if points == "one_cell":
        assert count == 2 * js.n_levels * -(-x.shape[0] // 32)
    elif points == "rays":
        assert count < unmerged


def test_backward_matches_autodiff():
    """dtable against autodiff of the gather oracle, and dx on interior
    points (at the clip edges autodiff of a clip and the in-range mask
    disagree by design)."""
    js, ts = _specs()
    table, x, g = _inputs(js, 129, seed=2, lo=0.05, hi=0.95)
    ref_dt, ref_dx = jax.grad(
        lambda t, z: jnp.sum(JTP.triplane_encode_fwd_only(js, t, z)
                             * jnp.asarray(g)), argnums=(0, 1))(
        jnp.asarray(table), jnp.asarray(x))
    dt, dx = TP.triplane_encode_bwd_ref(ts, *_t(table, x, g), True, True)
    tx, tg = _t(x, g)
    C.assert_within("dtable", dt, torch.from_numpy(np.array(ref_dt)),
                    _streams_tol(ts, tx, tg))
    np.testing.assert_allclose(dx.numpy(), ref_dx, rtol=1e-4, atol=1e-4)


def test_streams_serial_sum_equals_add_at():
    """The serial mode's stream (the plain version's order): its row
    accumulate is the plain dtable bit for bit, and a serial np.add.at of
    it is too; every update lands on a row of the table."""
    _, ts = _specs()
    table, x, g = _t(*_inputs(ts, 301, seed=3))
    idx, vals = TP.triplane_encode_bwd_streams_ref(ts, table, x, g)
    assert idx.shape == (4 * ts.n_levels * 301,) and vals.shape[1] == 2
    assert int(idx.min()) >= 0 and int(idx.max()) < ts.total_entries
    dt, _ = TP.triplane_encode_bwd_ref(ts, table, x, g, True, False)
    acc = SS.row_accum_ref(idx, vals, ts.total_entries)[:ts.total_entries]
    np.testing.assert_array_equal(acc.numpy(), dt.numpy())
    host = np.zeros((ts.total_entries, 2), np.float32)
    np.add.at(host, idx.numpy(), vals.numpy())
    np.testing.assert_array_equal(host, dt.numpy())


@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True),
                                  (False, False)])
def test_need_flags(need):
    _, ts = _specs()
    args = _t(*_inputs(ts, 33, seed=4))
    full = TP.triplane_encode_bwd_ref(ts, *args, True, True)
    got = TP.triplane_encode_bwd(ts, *args, *need)
    for asked, a, b in zip(need, got, full):
        if asked:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        else:
            assert a is None


def test_autograd_function_matches_autodiff():
    """TriPlaneEncode (the kernel backward's Function, on the CPU the plain
    backward) against torch autodiff of the plain forward; a detached
    table (tracking) asks for dx only."""
    _, ts = _specs()
    table, x, g = _t(*_inputs(ts, 97, seed=5, lo=0.05, hi=0.95))

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (table, x)]
        (fn(*leaves) * g).sum().backward()
        return [t.grad for t in leaves]

    got = grads(lambda t, z: TP.encode(ts, t, z))
    ref = grads(lambda t, z: TP.triplane_encode_fwd_ref(ts, t, z))
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-4, atol=1e-4)
    zz = x.clone().requires_grad_(True)
    (TP.encode(ts, table, zz) * g).sum().backward()
    torch.testing.assert_close(zz.grad, got[1])


def test_init_triplane():
    _, ts = _specs()
    t = TP.init_triplane(ts, torch.Generator().manual_seed(0))
    assert t.shape == (ts.total_entries, 2) and t.dtype == torch.float32
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 1e-5


def test_lattice_encode_matches_jax():
    """triplane_lattice_encode and tensovm_lattice_encode against the JAX
    functions (value and table gradients), and against the pointwise
    plain encode of the lattice's points."""
    js, ts = _specs()
    table, _, _ = _inputs(js, 1, seed=6)
    lines = (1.0 + 0.1 * np.random.default_rng(7).standard_normal(
        (JVM.line_total_rows(js), 2))).astype(np.float32)
    g = 7
    axes = np.random.default_rng(8).uniform(-0.02, 1.02, (3, g)).astype(
        np.float32)
    w = np.random.default_rng(9).standard_normal(
        (g, g, g, ts.out_dim)).astype(np.float32)
    jt, jl, jax_axes = map(jnp.asarray, (table, lines, axes))
    j_tp, j_dt = jax.value_and_grad(lambda t: jnp.sum(
        JTP.triplane_lattice_encode(js, t, jax_axes) * w))(jt)
    j_vm, j_dvm = jax.value_and_grad(lambda p: jnp.sum(
        JVM.tensovm_lattice_encode(js, p, jax_axes) * w))(
        {"planes": jt, "lines": jl})

    tt, tl, tax = (t.requires_grad_(True) for t in _t(table, lines, axes))
    tp = TP.triplane_lattice_encode(ts, tt, tax)
    assert tp.shape == (g, g, g, ts.out_dim)
    (tp * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(
        tp.detach().numpy(),
        JTP.triplane_lattice_encode(js, jt, jax_axes), **FWD_TOL)
    np.testing.assert_allclose(tt.grad.numpy(), j_dt, rtol=1e-5, atol=1e-6)
    pts = torch.stack(torch.meshgrid(*tax.detach(), indexing="ij"),
                      -1).reshape(-1, 3)
    np.testing.assert_allclose(
        tp.detach().numpy(),
        TP.triplane_encode_fwd_ref(ts, tt.detach(), pts).reshape(
            g, g, g, -1).numpy(), **FWD_TOL)

    tt.grad = None
    vm = VM.make_tensovm_lattice(ts)({"planes": tt, "lines": tl}, tax)
    (vm * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(
        vm.detach().numpy(),
        JVM.tensovm_lattice_encode(js, {"planes": jt, "lines": jl},
                                   jax_axes), **FWD_TOL)
    np.testing.assert_allclose(tt.grad.numpy(), j_dvm["planes"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), j_dvm["lines"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float((vm.detach() * torch.from_numpy(w)).sum()),
                               float(j_vm), rtol=1e-5)


def test_unit_line_tv_matches_jax():
    """make_triplane_lattice_tv (TriPlane's smoothness term) against the
    JAX JointEncoding's unit-line TV (make_tensovm_lattice_tv on ones) and
    against smoothness_tv of the plain pointwise encode: value and table
    gradient."""
    from coslam_tpu.ops import losses as JL
    from coslam_torch.ops import losses as TL

    js, ts = _specs()
    table, _, _ = _inputs(js, 1, seed=10)
    g, sp = 7, 8
    axes = np.random.default_rng(11).uniform(0.02, 0.98, (3, g)).astype(
        np.float32)
    ones = jnp.ones((JVM.line_total_rows(js), 2), jnp.float32)
    j_val, j_grad = jax.value_and_grad(lambda t: JVM.make_tensovm_lattice_tv(
        js)({"planes": t, "lines": ones}, jnp.asarray(axes), sp))(
        jnp.asarray(table))
    j_pw = JL.smoothness_tv(JTP.triplane_encode_fwd_only(
        js, jnp.asarray(table), jnp.asarray(np.stack(np.meshgrid(
            *axes, indexing="ij"), -1).reshape(-1, 3))).reshape(
        g, g, g, -1), sp)
    np.testing.assert_allclose(float(j_pw), float(j_val), rtol=1e-5)

    tt = torch.from_numpy(table).requires_grad_(True)
    val = VM.make_triplane_lattice_tv(ts)(tt, torch.from_numpy(axes), sp)
    val.backward()
    np.testing.assert_allclose(float(val), float(j_val), rtol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), j_grad, rtol=1e-4, atol=1e-7)
    tt.grad = None
    pts = torch.from_numpy(np.stack(np.meshgrid(*axes, indexing="ij"),
                                    -1).reshape(-1, 3))
    pw = TL.smoothness_tv(TP.triplane_encode_fwd_ref(ts, tt, pts).reshape(
        g, g, g, -1), sp)
    pw.backward()
    np.testing.assert_allclose(float(pw), float(j_val), rtol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), j_grad, rtol=1e-4, atol=1e-7)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernel or the call raises: here
    meta tensors raise instead of running the plain version."""
    _, ts = _specs()
    meta = lambda *shape: torch.empty(shape, device="meta")  # noqa: E731
    table, x = meta(ts.total_entries, 2), meta(5, 3)
    with pytest.raises(ValueError):
        TP.triplane_encode_fwd(ts, table, x)
    with pytest.raises(ValueError):
        TP.triplane_encode_bwd(ts, table, x, meta(5, ts.out_dim), True, True)
    with pytest.raises(ValueError):
        TP.triplane_encode_bwd_serial(ts, table, x, meta(5, ts.out_dim),
                                      True)
    assert TP.triplane_encode_fwd.launches == 0
    assert TP.triplane_encode_bwd.launches == 0
    assert TP.triplane_encode_bwd_serial.launches == 0


def _brute_rows(js, x):
    """For every (point, section) of the JAX spec: its corner row e00 (the
    cell from r x clip(x) in f32, as the kernels take it)."""
    rows = np.zeros((js.n_levels, x.shape[0]), np.int64)
    for n, p in enumerate(np.clip(x, 0.0, 1.0)):
        for s in range(js.n_levels):
            r = js.resolutions[s]
            ua, va = ((0, 1), (0, 2), (1, 2))[s % 3]
            cu = min(int(np.floor(np.float32(r) * p[ua])), r - 1)
            cv = min(int(np.floor(np.float32(r) * p[va])), r - 1)
            rows[s, n] = js.offsets[s] + cu * (r + 1) + cv
    return rows


def _points(js, kind):
    if kind == "rays":
        return C.ray_points(3, 43, 6).astype(np.float32)
    if kind == "edges":
        return _edge_points(js.resolutions[-1])
    return _inputs(js, 50, 6)[1]


@pytest.mark.parametrize("points", ["uniform", "edges", "rays"])
def test_t_l2_sectors_counts_distinct_sectors(points):
    """kernel_times.t_l2_sectors against a count point by point from the
    JAX spec's sections: per (point, section) the distinct 32-byte sectors
    of its 4 corner rows (8 bytes each), then x read and the output
    written, 32 bytes a sector."""
    from coslam_torch.tools.kernel_times import t_l2_sectors

    js, ts = _specs()
    x = _points(js, points)
    count = 0
    rows = _brute_rows(js, x)
    for s in range(js.n_levels):
        r1 = js.resolutions[s] + 1
        for e in rows[s]:
            count += len({8 * row // 32 for row in (e, e + 1, e + r1,
                                                    e + r1 + 1)})
    n = x.shape[0]
    count += (12 * n + 4 * n * js.n_features * js.pyr_levels) // 32
    assert t_l2_sectors(ts, torch.from_numpy(x)) == count


@pytest.mark.parametrize("args, points", [
    (SMALL, "uniform"), (SMALL, "edges"), (SMALL, "rays"),
    (ROOM0_HYBRID, "uniform")], ids=["small-uniform", "small-edges",
                                     "small-rays", "room0_hybrid-uniform"])
def test_t_library_is_the_forward(args, points):
    """kernel_times.t_library (the library route for kernel T's function:
    the sections as zero-padded images, one grid_sample and a sum over
    each level's 3 sections) against the plain forward, within
    LIBRARY_TOL (the route rounds its coordinates into [-1, 1] and back)."""
    from coslam_torch.tools.kernel_times import LIBRARY_TOL, t_library

    js, ts = _specs(args)
    table = _inputs(js, 1, 4)[0]
    x = _points(js, points)
    table, x = _t(table, x)
    torch.testing.assert_close(t_library(ts, table)(x),
                               TP.triplane_encode_fwd_ref(ts, table, x),
                               **LIBRARY_TOL)


def test_forward_and_backward_at_no_points():
    """N = 0 (kernel T returns before any launch on the card; the JAX
    forward's reshape does not take 0 points): the plain forward gives
    [0, L F], the backward a zero table gradient and dx [0, 3]."""
    js, ts = _specs()
    table = _inputs(js, 1, 0)[0]
    x = np.zeros((0, 3), np.float32)
    out = TP.triplane_encode_fwd(ts, *_t(table, x))
    assert out.shape == (0, ts.out_dim)
    dt, dx = TP.triplane_encode_bwd(ts, *_t(table, x),
                                    torch.zeros(0, ts.out_dim), True, True)
    assert not dt.any() and dx.shape == (0, 3)
