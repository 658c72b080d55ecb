"""The probes' kernels (coslam_torch.ops.probe_accum, kernels P, Q, R, S)
against the JAX package's Pallas probes K5-K12 of tools/bench/.

Each probe module is loaded by path (nothing under tools/ is edited) and
its kernel body wrapped here in a pallas_call with the probe's own
BlockSpecs (1-D index and value streams as SMEM blocks of the chunk, a
2-D value block in VMEM, the accumulator one VMEM block), in interpret
mode, at a small size: chunk 256, 512-4,096 updates, 64-4,096 rows. The
same numpy-made inputs go through the port's plain version (the CPU path
of every wrapper).

Tolerance: none for K5, K8, K9 (f32 and packed bf16), K10 and K7's pair
form: both sides add every row's updates serially in update order from
0.0, and the port's pair form keeps that order across the two rows of a
pair. K6 and K12 are exact too (the pre-passes are the same f32 adds,
and both kernels add in pair or update order). K11 regroups: the TPU
kernel adds each run's sum, the plain version (index_add_) each update,
so rtol 1e-5, atol 1e-5.
"""

import importlib.util
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from coslam_tpu.ops.hash_packed import pair_scatter
from coslam_torch.ops import probe_accum as PA
from coslam_torch.tools.bench import (_bench_cell_merge, _bench_chunk_tune,
                                      _bench_row_rates, _bench_run_merge,
                                      _bench_scatter_variants)
from coslam_torch.tools.bench import _common as C

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 256
REGROUPED = dict(rtol=1e-5, atol=1e-5)
_PROBES = {}


def _probe(name):
    """tools/bench/<name>.py, loaded by path; the module sets JAX's
    persistent-cache options when imported, which are put back."""
    if name not in _PROBES:
        keys = ("jax_compilation_cache_dir",
                "jax_persistent_cache_min_compile_time_secs")
        saved = {k: getattr(jax.config, k) for k in keys}
        spec = importlib.util.spec_from_file_location(
            f"_jax_probe_{name}", os.path.join(REPO, "tools", "bench",
                                               f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        try:
            spec.loader.exec_module(mod)
        finally:
            for k, v in saved.items():
                jax.config.update(k, v)
        _PROBES[name] = mod
    return _PROBES[name]


def _interpret(body, out_shape, *inputs, scratch=(), chunk=CHUNK):
    """body over a grid of M / chunk steps with the probes' BlockSpecs:
    1-D inputs as SMEM blocks (chunk,), 2-D inputs as VMEM blocks
    (chunk, W), the [rows, W] accumulator as one VMEM block."""
    m = inputs[0].shape[0]
    specs = [pl.BlockSpec((chunk,), lambda i: (i,), memory_space=pltpu.SMEM)
             if a.ndim == 1 else
             pl.BlockSpec((chunk, a.shape[1]), lambda i: (i, 0),
                          memory_space=pltpu.VMEM) for a in inputs]
    out = pl.pallas_call(
        body, grid=(m // chunk,), in_specs=specs,
        out_specs=pl.BlockSpec(out_shape, lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        scratch_shapes=list(scratch), interpret=True,
    )(*[jnp.asarray(a) for a in inputs])
    return np.asarray(out)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _idx(m, rows, seed, runs=False):
    """int32 [m] over [0, rows); with ``runs``, in runs of 1-5 equal."""
    rng = np.random.default_rng(seed)
    if not runs:
        return rng.integers(0, rows, m).astype(np.int32)
    ids = np.repeat(rng.integers(0, rows, m), rng.integers(1, 6, m))
    return ids[:m].astype(np.int32)


def _streams(n, m, seed):
    return np.random.default_rng(seed).standard_normal((n, m), np.float32)


def _jax_pack(a, b):
    return np.asarray(jax.lax.bitcast_convert_type(
        jnp.stack([jnp.asarray(a).astype(jnp.bfloat16),
                   jnp.asarray(b).astype(jnp.bfloat16)], -1), jnp.int32))


def test_bf16_words_match_jax_bitcast():
    """pack_bf16x2 gives JAX's bitcast of stack([a, b], -1) bit for bit
    (a in the low half); unpack_bf16x2 gives back the bf16 values, and
    the shift is taken in int64 (words with the sign bit set included)."""
    a, b = _streams(2, 4096, 0) * 100
    a[:4] = [0.0, -0.0, 1e-40, -3.0e38]
    words = PA.pack_bf16x2(_t(a), _t(b))
    np.testing.assert_array_equal(words.numpy(), _jax_pack(a, b))
    assert (words < 0).any()
    back = PA.unpack_bf16x2(words[:, None]).numpy()
    for k, v in enumerate((a, b)):
        want = np.asarray(jnp.asarray(v).astype(jnp.bfloat16)
                          .astype(jnp.float32))
        np.testing.assert_array_equal(back[:, k].view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("runs", [False, True])
def test_k5_cell_base_equals_plain_p(runs):
    """K5 (_bench_cell_merge._kernel_base, W = 8 from 8 f32 streams)
    against kernel P's plain version on the streams, bit for bit."""
    mod = _probe("_bench_cell_merge")
    rows, m, w = 512, 2048, mod.WIDTH
    idx, vals = _idx(m, rows, 1, runs), _streams(w, m, 2)
    want = _interpret(partial(mod._kernel_base, CHUNK, w), (rows + 1, w),
                      idx, *vals)
    got = PA.probe_accum(_t(idx), _t(vals), rows + 1)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_run_merged_inputs(idx, vals):
    """The XLA pre-pass of _bench_cell_merge.run_merged (:116-121)."""
    i1, i2 = idx[0::2], idx[1::2]
    same = i1 == i2
    v1 = [v[0::2] + jnp.where(same, v[1::2], 0.0) for v in vals]
    v2 = [jnp.where(same, 0.0, v[1::2]) for v in vals]
    return i1, (~same).astype(jnp.int32), i2, v1, v2


@pytest.mark.parametrize("runs", [False, True])
def test_k6_cell_merged_equals_plain_r(runs):
    """K6 (_kernel_merged after the XLA pre-pass) against merge_pairs +
    kernel R's plain version: the pre-passes agree bit for bit, and so do
    the tables (both add pair by pair, the second row only where
    take2)."""
    mod = _probe("_bench_cell_merge")
    rows, m, w = 512, 4096, mod.WIDTH
    idx, vals = _idx(m, rows, 3, runs), _streams(w, m, 4)
    i1, take2, i2, v1, v2 = _jax_run_merged_inputs(
        jnp.asarray(idx), [jnp.asarray(v) for v in vals])
    want = _interpret(partial(mod._kernel_merged, CHUNK // 2, w),
                      (rows + 1, w), *map(np.asarray, (i1, take2, i2)),
                      *map(np.asarray, v1), *map(np.asarray, v2),
                      chunk=CHUNK // 2)
    ours = PA.merge_pairs(_t(idx), _t(vals))
    for a, b in zip(ours, (i1, take2, i2, jnp.stack(v1), jnp.stack(v2))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = PA.probe_accum_pair_merged(*ours, rows + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    if runs:  # most pairs of the runs stream merge
        assert float((ours[1] == 0).float().mean()) > 0.5


def test_k7_pair_form_equals_tuned_body_and_pair_scatter():
    """K7's closure (_bench_chunk_tune.scatter_with_chunk) cannot run in
    interpret mode; its body is _bench_scatter_variants._kernel_tuned
    line for line. Kernel P's pair form (stride F = 2, W = 4), on idx
    clipped into [0, rows] as K7 clips them, equals both that body and
    coslam_tpu's pair_scatter in interpret mode, bit for bit."""
    mod = _probe("_bench_scatter_variants")
    rows, m = 300, 2048
    idx = np.clip(np.random.default_rng(5).integers(-4, rows + 4, m), 0,
                  rows).astype(np.int32)
    vals = _streams(4, m, 6)
    want = _interpret(partial(mod._kernel_tuned, CHUNK, 8, 2), (rows + 2, 2),
                      idx, *vals)
    got = PA.probe_accum(_t(idx), _t(vals), rows + 2, stride=2).numpy()
    np.testing.assert_array_equal(got, want)
    shipped = pair_scatter(jnp.asarray(idx), [jnp.asarray(v) for v in vals],
                           rows, interpret=True)
    np.testing.assert_array_equal(got[:rows], np.asarray(shipped))


@pytest.mark.parametrize("width", [4, 8, 16])
def test_k8_vec_rows_equals_plain_p(width):
    """K8 (_bench_row_rates._kernel_vec, values as a [chunk, W] VMEM
    block) against kernel P's plain version on [M, W] rows."""
    mod = _probe("_bench_row_rates")
    rows, m = 64, 1024
    idx, rows2d = _idx(m, rows, width), _streams(width, m, 7).T.copy()
    want = _interpret(partial(mod._kernel_vec, CHUNK, width),
                      (rows + 1, width), idx, rows2d)
    got = PA.probe_accum(_t(idx), _t(rows2d), rows + 1, rows=True)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", [4, 8, 16])
def test_k9_f32_and_packed_bf16_equal_plain_p_and_q(width):
    """K9: _kernel_f32 (W f32 streams) against P's plain version and
    _kernel_pk (W/2 words of two bf16, unpacked by shift and mask) against
    Q's, each bit for bit."""
    mod = _probe("_bench_row_rates")
    rows, m = 64, 1024
    idx, vals = _idx(m, rows, 10 + width), _streams(width, m, 8)
    want = _interpret(partial(mod._kernel_f32, CHUNK, width),
                      (rows + 1, width), idx, *vals)
    got = PA.probe_accum(_t(idx), _t(vals), rows + 1)
    np.testing.assert_array_equal(got.numpy(), want)
    words = np.stack([_jax_pack(vals[2 * p], vals[2 * p + 1])
                      for p in range(width // 2)])
    want = _interpret(partial(mod._kernel_pk, CHUNK, width),
                      (rows + 1, width), idx, *words)
    got = PA.probe_accum_bf16x2(_t(idx), _t(words), rows + 1)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k10_tuned_and_packed_bf16_equal_plain_p_and_q():
    """K10: _kernel_tuned (pair form from 4 f32 streams) against P's pair
    form and _kernel_packed_bf16 (from 2 words, each the (f0, f1) bf16
    pair of one row) against Q's, bit for bit, on the probe's idx range
    [0, rows - 2)."""
    mod = _probe("_bench_scatter_variants")
    rows, m = 256, 2048
    idx = np.random.default_rng(11).integers(0, rows - 2, m).astype(np.int32)
    vals = _streams(4, m, 12)
    for unroll in (8, 16):
        want = _interpret(partial(mod._kernel_tuned, CHUNK, unroll, 2),
                          (rows + 2, 2), idx, *vals)
        got = PA.probe_accum(_t(idx), _t(vals), rows + 2, stride=2)
        np.testing.assert_array_equal(got.numpy(), want)
    words = np.stack([_jax_pack(vals[0], vals[1]),
                      _jax_pack(vals[2], vals[3])])
    want = _interpret(partial(mod._kernel_packed_bf16, CHUNK, 8),
                      (rows + 2, 2), idx, *words)
    got = PA.probe_accum_bf16x2(_t(idx), _t(words), rows + 2, stride=2)
    np.testing.assert_array_equal(got.numpy(), want)


def _ray_stream(r):
    """A ray-ordered stream of the run-merge probe at 64 rays."""
    return _bench_run_merge.make_stream(r, n_rays=64)


def test_make_stream_is_the_probes():
    """The port's copy of _bench_run_merge.make_stream gives the same
    streams bit for bit."""
    mod = _probe("_bench_run_merge")
    for r in (14, 140):
        for a, b in zip(_bench_run_merge.make_stream(r, n_rays=64),
                        mod.make_stream(r, n_rays=64)):
            np.testing.assert_array_equal(a, b)


def test_k11_flush_on_change_equals_plain_s():
    """K11 (_merge_kernel: each run of equal adjacent idx summed in
    scratch, one row add per run) against kernel S's plain version
    (index_add_ per update): the same sums regrouped, rtol/atol 1e-5."""
    mod = _probe("_bench_run_merge")
    r = 14
    idx, vals = _ray_stream(r)
    m = idx.shape[0] // CHUNK * CHUNK
    idx, vals = idx[:m], vals[:m]
    assert (idx[1:] == idx[:-1]).mean() > 0.3
    want = _interpret(partial(mod._merge_kernel, CHUNK, r * r),
                      (r * r + 1, 8), idx, vals,
                      scratch=(pltpu.VMEM((1, 8), jnp.float32),
                               pltpu.SMEM((1,), jnp.int32)))
    got = PA.probe_accum_run_merge(_t(idx), _t(vals), r * r + 1)
    np.testing.assert_allclose(got.numpy(), want, **REGROUPED)


def test_k12_skip_equals_suffix_scan_and_plain_p():
    """K12 (_skip_kernel after the XLA suffix scan run_merge_outside)
    against the port's run_merge_outside + kernel P's plain version with
    its skip rule: the scans agree bit for bit (sentinels included), and
    so do the tables."""
    mod = _probe("_bench_run_merge")
    r = 14
    rows = r * r
    idx, vals = _ray_stream(r)
    m = idx.shape[0] // CHUNK * CHUNK
    idx, vals = idx[:m], vals[:m]
    j_idx, j_vals = mod.run_merge_outside(jnp.asarray(idx),
                                          jnp.asarray(vals), rows)
    s_idx, s_vals = PA.run_merge_outside(_t(idx), _t(vals), rows)
    np.testing.assert_array_equal(s_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(s_vals.numpy(), np.asarray(j_vals))
    assert (s_idx.numpy() == rows + 1).any()
    want = _interpret(partial(mod._skip_kernel, CHUNK, rows), (rows + 1, 8),
                      np.asarray(j_idx), np.asarray(j_vals))
    got = PA.probe_accum(s_idx, s_vals, rows + 1, rows=True)
    np.testing.assert_array_equal(got.numpy(), want)


def test_skip_rule_and_pair_bounds():
    """An update whose row is not inside the output is skipped: negative
    idx and idx past the last row; in the pair form, idx whose second row
    would be past the end."""
    idx = _t(np.array([-1, 0, 3, 4, 5], np.int32))
    vals = _t(np.ones((4, 5), np.float32))
    out = PA.probe_accum(idx, vals, 5, stride=2).numpy()
    # Rows 0-1 (idx 0) and 3-4 (idx 3); idx 4 and 5 would reach row 5.
    np.testing.assert_array_equal(out[:, 0], [1, 1, 0, 1, 1])
    out = PA.probe_accum(idx, vals[:2], 5).numpy()
    np.testing.assert_array_equal(out[:, 0], [1, 0, 0, 1, 1])
    with pytest.raises(ValueError):
        PA.probe_accum(idx, vals[:3], 5, stride=2)


def test_adjacent_runs_counts_s_flushes():
    """Kernel S's rows of atomics: one per run, and one more for every
    run cut by a span boundary."""
    idx = _t(np.array([3, 3, 3, 1, 1, 2, 2, 2, 2, 5], np.int32))
    assert PA.adjacent_runs(idx) == 4
    assert PA.adjacent_runs(idx, span=4) == 6   # cut at 4 and at 8
    assert PA.adjacent_runs(idx, span=2) == 8


@pytest.mark.parametrize("module", [_bench_row_rates,
                                    _bench_scatter_variants,
                                    _bench_chunk_tune, _bench_cell_merge,
                                    _bench_run_merge],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_probe_runs_small_on_cpu(module, capsys):
    """Each probe's every variant at its small size on the CPU, through
    the plain versions: f32 variants equal the plain version (or shipped)
    exactly; untimed. Its main refuses to run without a card."""
    res = module.run(torch.device("cpu"), small=True, timed=False)
    flat = res.values() if module is not _bench_run_merge else []
    if module is _bench_row_rates:
        flat = [r for per_w in res.values() for r in per_w.values()]
    for r in flat:
        if isinstance(r, dict) and "err" in r:
            assert r["ms"] is None
            assert r["err"] == 0.0 or module is _bench_scatter_variants
    assert capsys.readouterr().out
    with pytest.raises(SystemExit):
        module.main(["--quick"])


def test_wrappers_never_take_the_plain_version_off_the_cpu():
    """Meta tensors (not on the CPU) go to the kernels' checks and raise;
    no launch is counted."""
    idx = torch.zeros(4, dtype=torch.int32, device="meta")
    vals = torch.empty((8, 4), device="meta")
    words = torch.empty((4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        PA.probe_accum(idx, vals, 9)
    with pytest.raises(ValueError):
        PA.probe_accum_bf16x2(idx, words, 9)
    with pytest.raises(ValueError):
        PA.probe_accum_pair_merged(idx, idx, idx, vals, vals, 9)
    with pytest.raises(ValueError):
        PA.probe_accum_run_merge(idx, vals.T, 9)
    assert (PA.probe_accum.launches, PA.probe_accum_bf16x2.launches,
            PA.probe_accum_pair_merged.launches,
            PA.probe_accum_run_merge.launches) == (0, 0, 0, 0)


@pytest.mark.parametrize("stride", [None, 2])
def test_sum_order_tol_holds_every_order_and_nothing_more(stride):
    """The probes' check: sums of one set of updates in reversed and in
    shuffled order, or with runs summed first, lie within the bound of
    the serial sum on hot rows (40 updates each); a change of twice the
    bound at one entry, a NaN, or any change to a row of a single update
    raises."""
    rng = np.random.default_rng(7)
    rows, m = 50, 2000
    idx = _t(rng.integers(0, rows - 1, m).astype(np.int32))
    idx[::7] = idx[1::7][:len(idx[::7])]   # some adjacent equal pairs
    idx[-1] = rows - 1                 # the last row gets one update
    vals = _t(rng.standard_normal((m, 4)).astype(np.float32) * 1e3)
    out_rows = rows + 1
    ref = PA.probe_accum_ref(idx, vals, out_rows, stride)
    tol = C.sum_order_tol(idx, vals, out_rows, stride)
    rev = PA.probe_accum_ref(idx.flip(0), vals.flip(0), out_rows, stride)
    perm = torch.from_numpy(rng.permutation(m))
    shuf = PA.probe_accum_ref(idx[perm], vals[perm], out_rows, stride)
    assert C.assert_within("reversed", rev, ref, tol) > 0
    C.assert_within("shuffled", shuf, ref, tol)
    if stride is None:
        # Adjacent equal pairs summed first (kernel R's pre-pass).
        merged = PA.pair_merged_ref(*PA.merge_pairs(idx, vals.T.contiguous()),
                                    out_rows)
        C.assert_within("pairs merged", merged, ref, tol)
    worst = int(torch.argmax(tol))
    for bad_at, delta in ((worst, 2.0 * float(tol.view(-1)[worst]) + 1e-3),
                          (worst, float("nan"))):
        bad = rev.clone().view(-1)
        bad[bad_at] += delta
        with pytest.raises(AssertionError, match="beyond the sum-order"):
            C.assert_within("bad", bad.view_as(ref), ref, tol)
    single = (tol.view(-1) == 0) & (ref.view(-1) != 0)
    assert single.any()
    bad = ref.clone().view(-1)
    bad[torch.nonzero(single)[0, 0]] *= 1 + 2.0 ** -20
    with pytest.raises(AssertionError):
        C.assert_within("single", bad.view_as(ref), ref, tol)


def test_probe_raises_when_a_variant_disagrees(monkeypatch):
    """A probe fails, not just prints, when one of its variants is wrong:
    a kernel P that drops one update makes the chunk probe raise."""
    real = PA.probe_accum

    def drops_one(idx, vals, *args, **kw):
        return real(idx[1:], vals[:, 1:].contiguous(), *args, **kw)

    monkeypatch.setattr(PA, "probe_accum", drops_one)
    with pytest.raises(AssertionError, match="beyond the sum-order"):
        _bench_chunk_tune.run(torch.device("cpu"), small=True, timed=False)
