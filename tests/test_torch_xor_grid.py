"""The port's XOR-hash grid (grid.grad_impl pallas / scatter / onehot)
against the JAX package.

The plain PyTorch versions (the CPU path of coslam_torch.ops.hash_pallas,
and the oracle of kernels E and G) are held against
``coslam_tpu.ops.encodings.hashgrid_encode``, its autodiff (``scatter``),
``make_hashgrid_encode_mxu`` (``onehot``) and
``make_hashgrid_encode_pallas_bwd`` in Pallas interpret mode (``pallas``,
reaching the TPU's K4 as the JAX package runs it on the CPU). Inputs come
from numpy seeds; everything is float32.

Tolerances: the forward is the same products summed in another order
(rtol 1e-5, atol 1e-6). The deterministic table gradient is compared bit
for bit with K4's: the update values are the same correctly rounded
products and every row is summed in the same order. The autodiff
(``scatter``) gradient is XLA's scatter-add, rtol 1e-5. The one-hot
product rounds w * g to bf16 on the JAX side, so it agrees to 1 % of the
largest entry (as tests/test_encodings.py holds it). dx sums terms scaled
by the resolution in another order (rtol 1e-4, atol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coslam_tpu.ops import encodings as JE
from coslam_tpu.ops import hash_pallas as JHP
from coslam_torch import convert
from coslam_torch.ops import encodings as TE
from coslam_torch.ops import hash_packed as TPK
from coslam_torch.ops import hash_pallas as THP

torch.set_num_threads(1)

SPECS = {
    "mixed": dict(desired_resolution=64, log2_hashmap_size=12, n_levels=4),
    "dense": dict(desired_resolution=24, log2_hashmap_size=16, n_levels=3,
                  base_resolution=12, dense_only=True),
    "room0": dict(desired_resolution=400, log2_hashmap_size=16),
}


def _specs(name):
    return (JE.make_hashgrid_spec(**SPECS[name]),
            TE.make_hashgrid_spec(**SPECS[name]))


def _inputs(spec, n, seed, lo=-0.05, hi=1.05):
    """Unit-normal table and cotangent; x uniform in [lo, hi], its first
    rows at exactly 0 and 1, the next on grid lines of the finest
    level."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((spec.total_entries, spec.n_features)
                                ).astype(np.float32)
    x = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    x[:6] = rng.integers(0, 2, (6, 3))
    r = spec.resolutions[-1]
    x[6:16] = rng.integers(0, r + 1, (10, 3)) / np.float32(r)
    g = rng.standard_normal((n, spec.out_dim)).astype(np.float32)
    return table, x, g


def _port_grads(spec, table, x, g, deterministic):
    tt = torch.from_numpy(table).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    (THP.encode(spec, tt, xt, deterministic) * torch.from_numpy(g)
     ).sum().backward()
    return tt.grad.numpy(), xt.grad.numpy()


def _jax_grads(encode, table, x, g):
    return jax.grad(lambda t, xx: jnp.sum(encode(t, xx) * jnp.asarray(g)),
                    argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))


_SPEC_FIELDS = ("n_levels", "n_features", "base_resolution",
                "log2_hashmap_size", "desired_resolution", "resolutions",
                "offsets", "hashed", "total_entries", "out_dim")


@pytest.mark.parametrize("name", sorted(SPECS))
def test_spec_matches_jax(name):
    js, ts = _specs(name)
    for field in _SPEC_FIELDS:
        assert getattr(ts, field) == getattr(js, field), field
    if name == "room0":
        # Levels 0-4 dense at 16/19/24/30/37, 5-15 hashed at 2^16 rows.
        assert ts.total_entries == 834_097
        assert ts.resolutions[:5] == (16, 19, 24, 30, 37)
        assert ts.resolutions[-1] == 399
        assert ts.hashed == (False,) * 5 + (True,) * 11
        assert TPK.make_packed_spec(400, 16).total_entries == 835_977


@pytest.mark.parametrize("name", ["mixed", "dense"])
def test_forward_matches_jax(name):
    js, ts = _specs(name)
    table, x, _ = _inputs(js, 257, seed=0)
    out = TE.hashgrid_encode(ts, torch.from_numpy(table),
                             torch.from_numpy(x)).numpy()
    ref = JE.hashgrid_encode(js, jnp.asarray(table), jnp.asarray(x))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    # The dispatching wrapper takes the plain version for CPU tensors.
    np.testing.assert_array_equal(
        THP.xor_grid_encode_fwd(ts, torch.from_numpy(table),
                                torch.from_numpy(x)).numpy(), out)


@pytest.mark.parametrize("name", ["mixed", "dense"])
def test_pallas_dtable_bit_exact_with_k4(name):
    """grad_impl pallas: dtable equals the interpret-mode K4 result bit
    for bit; dx the custom VJP's (jax.vjp of hashgrid_encode)."""
    js, ts = _specs(name)
    table, x, g = _inputs(js, 301, seed=1)
    jd_t, jd_x = _jax_grads(
        JHP.make_hashgrid_encode_pallas_bwd(js, None, interpret=True),
        table, x, g)
    d_t, d_x = _port_grads(ts, table, x, g, deterministic=True)
    np.testing.assert_array_equal(d_t, np.asarray(jd_t))
    np.testing.assert_allclose(d_x, jd_x, rtol=1e-4, atol=1e-4)


def test_streams_are_k4s_level_major_streams():
    """Kernel G's plain version gives K4's update streams: the rows of
    _hash_corners_and_weights transposed to [L, 8, N] and the values
    weight x g, bit for bit."""
    js, ts = _specs("mixed")
    table, x, g = _inputs(js, 97, seed=2)
    idx, vals, dx = THP.xor_grid_encode_bwd(
        ts, torch.from_numpy(table), torch.from_numpy(x), torch.from_numpy(g),
        need_streams=True, need_dx=False)
    assert dx is None and idx.dtype == torch.int32
    j_idx, j_w = JE._hash_corners_and_weights(js, jnp.asarray(x))  # [N, L, 8]
    np.testing.assert_array_equal(
        idx.numpy(), np.transpose(np.asarray(j_idx), (1, 2, 0)).reshape(-1))
    w_t = np.transpose(np.asarray(j_w), (1, 2, 0))                 # [L, 8, N]
    g_t = g.reshape(-1, js.n_levels, js.n_features).transpose(1, 2, 0)
    ref = (w_t[:, :, None] * g_t[:, None]).transpose(0, 1, 3, 2)
    np.testing.assert_array_equal(vals.numpy(), ref.reshape(-1, 2))


@pytest.mark.parametrize("name", ["mixed", "dense"])
def test_scatter_dtable_matches_autodiff(name):
    """grad_impl scatter: the atomic mode (the same plain sum on the CPU)
    against jax.grad of hashgrid_encode (XLA's scatter-add)."""
    js, ts = _specs(name)
    table, x, g = _inputs(js, 257, seed=3)
    jd_t, jd_x = _jax_grads(lambda t, xx: JE.hashgrid_encode(js, t, xx),
                            table, x, g)
    d_t, d_x = _port_grads(ts, table, x, g, deterministic=False)
    np.testing.assert_allclose(d_t, jd_t, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(d_x, jd_x, rtol=1e-4, atol=1e-4)


def test_onehot_dtable_matches_mxu():
    """grad_impl onehot: the JAX one-hot product rounds w * g to bf16;
    the port sums f32, so they agree to 1 % of the largest entry."""
    js, ts = _specs("mixed")
    table, x, g = _inputs(js, 257, seed=4)
    jd_t, _ = _jax_grads(JE.make_hashgrid_encode_mxu(js), table, x, g)
    d_t, _ = _port_grads(ts, table, x, g, deterministic=False)
    jd_t = np.asarray(jd_t)
    assert np.abs(d_t - jd_t).max() <= 0.01 * np.abs(jd_t).max()


def test_dx_tie_rule_and_bounds():
    """dx follows jax.vjp through jnp.clip: factor 0.5 at exactly 0 and 1
    (the tie of minimum/maximum), 0 outside [0, 1]; on grid lines and
    interior points the JAX value. At x = 1 both corners of that axis are
    row res (no cell clamp), so that component is 0 up to the sum's
    rounding."""
    assert float(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0))(0.0)) == 0.5
    assert float(jax.grad(lambda v: jnp.clip(v, 0.0, 1.0))(1.0)) == 0.5
    js, ts = _specs("mixed")
    table, x, g = _inputs(js, 64, seed=5)
    x[16:24] = [[0.0, 0.3, 1.0], [1.0, 0.0, 0.6], [-0.2, 0.5, 1.3],
                [0.4, 1.0, 0.0], [0.5, 0.5, 0.5], [1e-7, 1 - 6e-8, 0.25],
                [0.0, 0.0, 0.0], [1.0, 1.0, 1.0]]
    _, vjp = jax.vjp(lambda xx: JE.hashgrid_encode(js, jnp.asarray(table),
                                                   xx), jnp.asarray(x))
    (jd_x,) = vjp(jnp.asarray(g))
    _, _, d_x = THP.xor_grid_encode_bwd_ref(
        ts, torch.from_numpy(table), torch.from_numpy(x), torch.from_numpy(g),
        need_streams=False, need_dx=True)
    d_x = d_x.numpy()
    np.testing.assert_allclose(d_x, jd_x, rtol=1e-4, atol=1e-4)
    assert d_x[18, 0] == 0 and d_x[18, 2] == 0          # outside [0, 1]
    at_one = x == 1.0
    assert np.abs(d_x[at_one]).max() < 1e-3 * np.abs(d_x).max()
    # At 0 the cotangent passes at half weight: dx(0) is half the one-sided
    # limit taken at the same cell (cell 0, w = 0).
    x0 = x[16:17].copy()
    _, _, d_half = THP.xor_grid_encode_bwd_ref(
        ts, torch.from_numpy(table), torch.from_numpy(x0),
        torch.from_numpy(g[16:17]), need_streams=False, need_dx=True)
    x0[0, 0] = 1e-30
    _, _, d_full = THP.xor_grid_encode_bwd_ref(
        ts, torch.from_numpy(table), torch.from_numpy(x0),
        torch.from_numpy(g[16:17]), need_streams=False, need_dx=True)
    np.testing.assert_allclose(d_half[0, 0], 0.5 * d_full[0, 0], rtol=1e-6)


def test_no_cell_clamp_at_one():
    """At x = 1 the XOR forward keeps cell = res (w = 0) and clamps the
    corners, where the packed layout clamps the cell to res - 1 (w = 1)."""
    js, ts = _specs("mixed")
    x = torch.tensor([[1.0, 0.5, 1.0]])
    cell, w = TE._cells_and_weights(ts, x)
    res = torch.tensor(ts.resolutions)
    assert torch.equal(cell[:, 0, 0], res) and torch.equal(cell[:, 2, 0], res)
    assert bool((w[:, 0] == 0).all())
    pcell, pw = TPK._cells_and_weights(TPK.make_packed_spec(**SPECS["mixed"]),
                                       x)
    assert torch.equal(pcell[:, 0, 0], res - 1) and bool((pw[:, 0] == 1).all())
    rows = TE._corner_indices(ts, cell)                         # [L, 8, 1]
    assert torch.equal(rows[:, :4], rows[:, 4:])                # x bit ignored


def test_hash_wraps_uint32():
    """(x ^ y P1 ^ z P2) wraps 32 bits at the top of the 399 level and
    beyond: the int64-and-mask hash of the port gives the JAX rows."""
    for args in (SPECS["room0"], dict(desired_resolution=4096,
                                      log2_hashmap_size=19, n_levels=6)):
        js, ts = (JE.make_hashgrid_spec(**args),
                  TE.make_hashgrid_spec(**args))
        assert max(ts.resolutions) * 2654435761 >= 2 ** 32
        rng = np.random.default_rng(6)
        x = np.concatenate([rng.uniform(0.9, 1.0, (61, 3)),
                            np.ones((1, 3)), rng.uniform(0, 1, (64, 3))]
                           ).astype(np.float32)
        res = np.array(js.resolutions, np.float32)
        grid_i = np.floor(x[:, None, :] * res[None, :, None]).astype(np.int32)
        j_idx = np.asarray(JE._corner_indices(js, jnp.asarray(grid_i)))
        cell, _ = TE._cells_and_weights(ts, torch.from_numpy(x))
        t_idx = TE._corner_indices(ts, cell).numpy()            # [L, 8, N]
        np.testing.assert_array_equal(t_idx, j_idx.transpose(1, 2, 0))
        assert t_idx.max() < ts.total_entries


@pytest.mark.parametrize("frozen", ["table", "points"])
def test_xor_grid_encode_function_needs(frozen):
    """XorGridEncode asks kernel G for what autograd needs: a detached
    table (tracking) gives dx only, constant points (the smoothness
    lattice) the table gradient only; each equals JAX's autodiff."""
    js, ts = _specs("mixed")
    table, x, g = _inputs(js, 96, seed=7)
    tt = torch.from_numpy(table).requires_grad_(frozen == "points")
    xt = torch.from_numpy(x).requires_grad_(frozen == "table")
    asked = []
    real = THP.xor_grid_encode_bwd

    def spy(spec, table, x, g, need_streams, need_dx):
        asked.append((need_streams, need_dx))
        return real(spec, table, x, g, need_streams, need_dx)

    THP.xor_grid_encode_bwd = spy
    try:
        (THP.encode(ts, tt, xt, True) * torch.from_numpy(g)).sum().backward()
    finally:
        THP.xor_grid_encode_bwd = real
    jd_t, jd_x = _jax_grads(lambda t, xx: JE.hashgrid_encode(js, t, xx),
                            table, x, g)
    if frozen == "table":
        assert asked == [(False, True)] and tt.grad is None
        np.testing.assert_allclose(xt.grad.numpy(), jd_x, rtol=1e-4, atol=1e-4)
    else:
        assert asked == [(True, False)] and xt.grad is None
        np.testing.assert_allclose(tt.grad.numpy(), jd_t, rtol=1e-5, atol=1e-6)


def test_make_encoder_routes_grad_impl():
    """auto/packed -> the packed spec; pallas/scatter/onehot -> the XOR
    spec (pallas deterministic); Dense -> 4 dense XOR levels; room0's
    widths give 834,097 XOR rows against 835,977 packed."""
    kw = dict(log2_hashmap_size=16, desired_resolution=400)
    for impl in ("auto", "packed"):
        spec = TE.make_encoder("HashGrid", grad_impl=impl, **kw)[3]
        assert isinstance(spec, TPK.PackedGridSpec)
        assert spec.total_entries == 835_977
    for impl in ("pallas", "scatter", "onehot"):
        init, apply, out_dim, spec = TE.make_encoder("HashGrid",
                                                     grad_impl=impl, **kw)
        assert isinstance(spec, TE.HashGridSpec) and out_dim == 32
        assert spec.total_entries == 834_097
        table = init(torch.Generator().manual_seed(0), "cpu")
        assert table.shape == (834_097, 2) and float(table.abs().max()) <= 1e-4
        x = torch.rand(5, 3)
        np.testing.assert_array_equal(apply(table, x).numpy(),
                                      TE.hashgrid_encode(spec, table, x).numpy())
    assert TE.XOR_GRAD_IMPLS == {"pallas": True, "scatter": False,
                                 "onehot": False}
    dense = TE.make_encoder("Dense", grad_impl="pallas", **kw)[3]
    assert dense == TE.make_hashgrid_spec(400, 16, n_levels=4, dense_only=True)
    assert not any(dense.hashed)
    with pytest.raises(ValueError):
        TE.make_encoder("HashGrid", grad_impl="bogus", **kw)


def test_convert_checks_the_table_layout():
    """A packed room0 table is never taken for an XOR one, nor the
    reverse."""
    packed = TPK.make_packed_spec(400, 16)
    xor = TE.make_hashgrid_spec(400, 16)
    params = {"grid": np.zeros((834_097, 2), np.float32),
              "decoder": {"sdf_net": [np.ones((2, 2), np.float32)],
                          "color_net": [np.ones((2, 2), np.float32)]}}
    assert convert.params_from_numpy(params, spec=xor)["grid"].shape == (
        834_097, 2)
    with pytest.raises(ValueError):
        convert.params_from_numpy(params, spec=packed)
    params["grid"] = np.zeros((835_977, 2), np.float32)
    convert.check_grid(params["grid"], packed)
    with pytest.raises(ValueError):
        convert.params_from_numpy(params, spec=xor)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """A tensor off the CPU goes to the kernel or the call raises: here a
    meta tensor raises instead of running the plain version."""
    _, ts = _specs("mixed")
    x = torch.empty((5, 3), device="meta")
    table = torch.empty((ts.total_entries, ts.n_features), device="meta")
    with pytest.raises(ValueError):
        THP.xor_grid_encode_fwd(ts, table, x)
    with pytest.raises(ValueError):
        THP.xor_grid_encode_bwd(ts, table, x,
                                torch.empty((5, ts.out_dim), device="meta"),
                                need_streams=True, need_dx=True)
    assert THP.xor_grid_encode_fwd.launches == 0
    assert THP.xor_grid_encode_bwd.launches == 0
